// BLS12-381 Fq limb arithmetic shared by the port's CUDA kernels
// (fq_mul.cu, g1_point.cu).
//
// An element is 39 loose limbs of 10 bits in int32 (each limb <= 4095),
// the layout of consensus_overlord_tpu/ops/field.py.  Every operation
// ends in a reduction plan: a short list of carry / fold / pad steps
// that FieldSpec._plan computed in Python from exact per-position
// bounds, and that proves no intermediate leaves int32.  The plans, the
// fold rows (row k = 2^(10(39+k)) mod p in limbs) and the subtraction
// pad reach the kernels in constant memory (fq_set_tables); the kernels
// replay exactly those steps, so their outputs are bit-identical to the
// plain PyTorch versions and to the JAX package.
//
// Accumulators are fixed-width int arrays indexed only by unrolled
// compile-time positions, so they live in registers; the plan's step
// kind and argument are read at run time and only gate which unrolled
// positions take part.
#pragma once

#include <cuda_runtime.h>

#define FQ_N 39
#define FQ_BITS 10
#define FQ_MASK ((1 << FQ_BITS) - 1)
#define FQ_WIDE (2 * FQ_N - 1)  // positions of the product convolution
#define FQ_MAXW 80              // widest accumulator a plan may reach
#define FQ_FOLD_ROWS 47
#define FQ_MAX_STEPS 16

// Plan slots: the order of PLAN_NAMES in ops/kernels.py.
enum {
  FQ_PLAN_MUL,
  FQ_PLAN_ADD2,
  FQ_PLAN_SUB,
  FQ_PLAN_SMALL2,
  FQ_PLAN_SMALL3,
  FQ_PLAN_SMALL8,
  FQ_PLAN_SMALL12,
  FQ_NUM_PLANS
};
enum { FQ_STEP_PAD = 0, FQ_STEP_FOLD = 1, FQ_STEP_CARRY = 2 };

// Table layout in ints (mirrored by ops/kernels.py fq_tables).
#define FQ_TAB_FOLD 0
#define FQ_TAB_PAD (FQ_TAB_FOLD + FQ_FOLD_ROWS * FQ_N)
#define FQ_TAB_NSTEPS (FQ_TAB_PAD + FQ_N)
#define FQ_TAB_STEPS (FQ_TAB_NSTEPS + FQ_NUM_PLANS)
#define FQ_TAB_INTS (FQ_TAB_STEPS + FQ_NUM_PLANS * FQ_MAX_STEPS * 2)

__constant__ int c_fq[FQ_TAB_INTS];

// Replay plan `plan` on the accumulator v of `width` live positions.
// Invariant: positions >= width hold 0, so a carry that extends the
// width, or a pad step, finds zeros there.
__device__ __forceinline__ void fq_reduce(int (&v)[FQ_MAXW], int width,
                                          int plan) {
  const int nsteps = c_fq[FQ_TAB_NSTEPS + plan];
  for (int s = 0; s < nsteps; ++s) {
    const int kind = c_fq[FQ_TAB_STEPS + (plan * FQ_MAX_STEPS + s) * 2];
    const int arg = c_fq[FQ_TAB_STEPS + (plan * FQ_MAX_STEPS + s) * 2 + 1];
    if (kind == FQ_STEP_FOLD) {
      // lo += hi · fold[:arg]; the hi positions are consumed.
#pragma unroll
      for (int r = 0; r < FQ_MAXW - FQ_N; ++r) {
        if (r < arg) {
          const int h = v[FQ_N + r];
#pragma unroll
          for (int j = 0; j < FQ_N; ++j)
            v[j] += h * c_fq[FQ_TAB_FOLD + r * FQ_N + j];
          v[FQ_N + r] = 0;
        }
      }
      width = FQ_N;
    } else if (kind == FQ_STEP_CARRY) {
      // One parallel carry pass; arg = 1 extends the width by one
      // position to take the top carry, else the top carry is provably 0.
      width += arg;
#pragma unroll
      for (int i = FQ_MAXW - 1; i > 0; --i)
        if (i < width) v[i] = (v[i] & FQ_MASK) + (v[i - 1] >> FQ_BITS);
      v[0] &= FQ_MASK;
    } else {
      width += arg;  // pad: the new positions already hold zeros
    }
  }
}

// Loose × loose → loose: the 39×39 schoolbook convolution to 77
// positions, then the mul plan.  Everything in registers.
__device__ __forceinline__ void fq_mul_regs(int (&out)[FQ_N],
                                            const int (&a)[FQ_N],
                                            const int (&b)[FQ_N]) {
  int v[FQ_MAXW];
#pragma unroll
  for (int k = 0; k < FQ_MAXW; ++k) v[k] = 0;
#pragma unroll
  for (int i = 0; i < FQ_N; ++i) {
#pragma unroll
    for (int j = 0; j < FQ_N; ++j) v[i + j] += a[i] * b[j];
  }
  fq_reduce(v, FQ_WIDE, FQ_PLAN_MUL);
#pragma unroll
  for (int j = 0; j < FQ_N; ++j) out[j] = v[j];
}

// Field ops on thread-private arrays (local memory), one out-of-line
// copy each so a point formula of a dozen multiplies stays a small
// program.  `out` may alias an input: inputs are read before any write.
__device__ __noinline__ void fe_mul(int* out, const int* a, const int* b) {
  int x[FQ_N], y[FQ_N], r[FQ_N];
#pragma unroll
  for (int j = 0; j < FQ_N; ++j) {
    x[j] = a[j];
    y[j] = b[j];
  }
  fq_mul_regs(r, x, y);
#pragma unroll
  for (int j = 0; j < FQ_N; ++j) out[j] = r[j];
}

__device__ __noinline__ void fe_add(int* out, const int* a, const int* b) {
  int v[FQ_MAXW];
#pragma unroll
  for (int k = 0; k < FQ_MAXW; ++k) v[k] = k < FQ_N ? a[k] + b[k] : 0;
  fq_reduce(v, FQ_N, FQ_PLAN_ADD2);
#pragma unroll
  for (int j = 0; j < FQ_N; ++j) out[j] = v[j];
}

// a − b as a + (pad − b): pad is a multiple of p with every limb >=
// the loose bound, so each limb stays non-negative.
__device__ __noinline__ void fe_sub(int* out, const int* a, const int* b) {
  int v[FQ_MAXW];
#pragma unroll
  for (int k = 0; k < FQ_MAXW; ++k)
    v[k] = k < FQ_N ? a[k] + (c_fq[FQ_TAB_PAD + k] - b[k]) : 0;
  fq_reduce(v, FQ_N, FQ_PLAN_SUB);
#pragma unroll
  for (int j = 0; j < FQ_N; ++j) out[j] = v[j];
}

// a · k for a small constant k whose bound plan is `plan`.
__device__ __noinline__ void fe_small(int* out, const int* a, int k,
                                     int plan) {
  int v[FQ_MAXW];
#pragma unroll
  for (int i = 0; i < FQ_MAXW; ++i) v[i] = i < FQ_N ? a[i] * k : 0;
  fq_reduce(v, FQ_N, plan);
#pragma unroll
  for (int j = 0; j < FQ_N; ++j) out[j] = v[j];
}

// Lane tiles: global memory holds lanes row-major, (batch, 39) int32, so
// one thread's limbs are 156 bytes apart from its neighbour's.  A block
// moves its lanes' rows through shared memory with consecutive threads
// on consecutive words (coalesced), and each thread then reads its own
// row at a stride of 39 words — odd, so free of bank conflicts.
__device__ __forceinline__ void tile_load(int* tile, const int* src,
                                          long lane0, int lanes) {
  for (int i = threadIdx.x; i < lanes * FQ_N; i += blockDim.x)
    tile[i] = src[lane0 * FQ_N + i];
}

__device__ __forceinline__ void tile_store(int* dst, const int* tile,
                                           long lane0, int lanes) {
  for (int i = threadIdx.x; i < lanes * FQ_N; i += blockDim.x)
    dst[lane0 * FQ_N + i] = tile[i];
}

// C entries every library exports: table upload, its size, and error
// text for the codes the launch functions return.
extern "C" int fq_set_tables(const int* host_tab, int ints, int device) {
  if (ints != FQ_TAB_INTS) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(c_fq, host_tab, sizeof(int) * FQ_TAB_INTS);
}

extern "C" int fq_table_ints() { return FQ_TAB_INTS; }

extern "C" const char* fq_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
