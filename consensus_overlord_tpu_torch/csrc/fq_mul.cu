// Batched loose-limb BLS12-381 Fq multiply for Hopper (sm_90a).
//
// Replaces the TPU kernel consensus_overlord_tpu/ops/pallas_field.py
// `_mul_kernel` (reached through mul_transposed / PallasField.mul): a
// 39×39 schoolbook convolution to 77 positions, then FieldSpec._plan's
// fold/carry steps against the fold-row table.  Loose in, loose out,
// bit-identical to FieldSpec.mul_plain (and to the JAX FieldSpec.mul).
//
// What bounds it on the H100: per lane it reads 2·39 and writes 39 int32
// (468 bytes) and issues 3,198 integer multiply-adds (1,521 convolution,
// 1,677 fold) and 544 carry masks and shift-adds.  Hopper runs IMAD on
// its FMA pipe at 64 per clock per SM, the carries on the ALU pipe
// beside it, so the multiply-adds set the floor (about 1.6 µs at
// B = 8192, chip_smoke.py `bound`), bytes about 1.1 µs.  One thread per
// lane (the first design) gave 8192 threads at that size, two warps per
// SM, each running a 3,700-step dependent chain: latency-bound, over 20x
// above the floor.
//
// The design (fq_group.cuh): a lane group of G = 8 threads computes one
// lane, so B = 8192 runs 65,536 threads (16 warps per SM) and each
// thread owns 5 limbs and 10 product columns.  Its rows run in an order
// rotated by its position, so the convolution is 200 multiply-adds a
// thread with compile-time b positions and no zero terms but the padding
// row's; carries and folds move values between the group's threads by
// __shfl_sync.  The plan is fixed at build time (fq_plans.h), so each
// step unrolls over its live positions only.  Each thread reads and
// writes its own limbs of the (B, 39) rows directly: a warp's 4 lanes
// are 624 contiguous bytes.  G = 8 was the fastest of 4, 8 and 16 on the
// H100 (PERF.md).  52 registers, no spills (ptxas -v, printed by
// chip_smoke.py).

#include "fq_group.cuh"

#define MUL_THREADS 128
#define MUL_G 8  // threads per lane

__global__ void __launch_bounds__(MUL_THREADS)
    fq_mul_kernel(int* out, const int* x, const int* y, int batch) {
  using Gp = FqGroup<MUL_G>;
  constexpr int LANES = MUL_THREADS / MUL_G;
  __shared__ __align__(16) int scratch[LANES * Gp::stride(1)];
  FqLane<MUL_G> ln;
  fq_lane_init<MUL_G, 1>(ln, scratch);
  const long lane = (long)blockIdx.x * LANES + threadIdx.x / MUL_G;
  Fe<MUL_G> a[1], b[1], r[1];
  fq_load(a[0], x, lane, batch, ln.t);
  fq_load(b[0], y, lane, batch, ln.t);
  fq_mul_n<MUL_G, 1>(ln, r, a, b);
  fq_store(out, r[0], lane, batch, ln.t);
}

extern "C" int fq_mul_launch(void* out, const void* x, const void* y,
                             int batch, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  constexpr int LANES = MUL_THREADS / MUL_G;
  const int blocks = (batch + LANES - 1) / LANES;
  fq_mul_kernel<<<blocks, MUL_THREADS, 0, (cudaStream_t)stream>>>(
      (int*)out, (const int*)x, (const int*)y, batch);
  return (int)cudaGetLastError();
}
