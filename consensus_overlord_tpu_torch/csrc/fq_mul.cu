// Batched loose-limb BLS12-381 Fq multiply for Hopper (sm_90a).
//
// Replaces the TPU kernel consensus_overlord_tpu/ops/pallas_field.py
// `_mul_kernel` (reached through mul_transposed / PallasField.mul): a
// 39×39 schoolbook convolution to 77 positions, then FieldSpec._plan's
// fold/carry steps against the fold-row table.  Loose in, loose out,
// bit-identical to FieldSpec.mul_plain (and to the JAX FieldSpec.mul).
//
// What bounds it on the H100: per lane it reads 2·39 and writes 39 int32
// (468 bytes) and does 3,198 int32 multiply-adds (1,521 for the
// convolution, 1,677 for the folds) plus about 830 carry operations —
// some 15 operations per byte, close to the card's ratio of 32-bit ALU
// rate to memory rate, so bytes and multiply-adds set floors of the same
// size (about 1 µs each at B = 8192).  The design keeps the work where
// it is cheap: one thread per lane with the 80-position accumulator in
// registers (compile-time indices only), the fold rows in constant
// memory (a uniform operand of each multiply-add), and the row-major
// (B, 39) lanes staged through shared memory so global loads and stores
// stay coalesced.  At B = 8192 that is 8192 threads, about two warps per
// SM: the kernel is latency-bound at that size, far above either floor,
// and spreading one lane over several threads is the next step.

#include "fq_field.cuh"

#define MUL_BLOCK 64

__global__ void __launch_bounds__(MUL_BLOCK)
    fq_mul_kernel(int* out, const int* x, const int* y, int batch) {
  __shared__ int tile[MUL_BLOCK * FQ_N];
  const long lane0 = (long)blockIdx.x * MUL_BLOCK;
  const int lanes = min(MUL_BLOCK, batch - (int)lane0);
  const bool live = threadIdx.x < lanes;
  int a[FQ_N], b[FQ_N], r[FQ_N];

  tile_load(tile, x, lane0, lanes);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < FQ_N; ++j) a[j] = live ? tile[threadIdx.x * FQ_N + j] : 0;
  __syncthreads();
  tile_load(tile, y, lane0, lanes);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < FQ_N; ++j) b[j] = live ? tile[threadIdx.x * FQ_N + j] : 0;

  fq_mul_regs(r, a, b);

  __syncthreads();
  if (live) {
#pragma unroll
    for (int j = 0; j < FQ_N; ++j) tile[threadIdx.x * FQ_N + j] = r[j];
  }
  __syncthreads();
  tile_store(out, tile, lane0, lanes);
}

extern "C" int fq_mul_launch(void* out, const void* x, const void* y,
                             int batch, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (batch + MUL_BLOCK - 1) / MUL_BLOCK;
  fq_mul_kernel<<<blocks, MUL_BLOCK, 0, (cudaStream_t)stream>>>(
      (int*)out, (const int*)x, (const int*)y, batch);
  return (int)cudaGetLastError();
}
