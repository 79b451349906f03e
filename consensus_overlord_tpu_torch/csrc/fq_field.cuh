// BLS12-381 Fq limb arithmetic shared by the port's CUDA kernels
// (fq_mul.cu, g1_point.cu): the field tables, the build-time reduction
// plans, and the one-thread-per-lane helpers of g1_add_kernel.
//
// An element is 39 loose limbs of 10 bits in int32 (each limb <= 4095),
// the layout of consensus_overlord_tpu/ops/field.py.  Every operation
// ends in a reduction plan: a short list of carry / fold / pad steps
// that FieldSpec._plan computed in Python from exact per-position
// bounds, and that proves no intermediate leaves int32.  ops/kernels.py
// writes the plans into the generated header fq_plans.h as X-macros of
// FQ_STEP(kind, arg, width before, width after), so each step is a
// template instantiation that unrolls over its live positions only.
// The fold rows (row k = 2^(10(39+k)) mod p in limbs) and the
// subtraction pad stay data: fq_set_tables (fq_group.cuh) uploads them
// twice, to constant memory for kernels whose threads read one address
// at a time (one thread per lane), and to device memory for the
// lane-group kernels, whose threads read different positions.  The
// kernels replay exactly the planned steps, so their outputs are
// bit-identical to the plain PyTorch versions and to the JAX package.
#pragma once

#include <cuda_runtime.h>

#include "fq_plans.h"  // generated into _build/ by ops/kernels.py

#define FQ_N 39
#define FQ_BITS 10
#define FQ_MASK ((1 << FQ_BITS) - 1)
#define FQ_MAXW 80              // widest accumulator a plan may reach
#define FQ_FOLD_ROWS 47

static_assert(FQ_GEN_N == FQ_N && FQ_GEN_BITS == FQ_BITS,
              "fq_plans.h was generated for another limb layout");
static_assert(FQ_GEN_FOLD_ROWS <= FQ_FOLD_ROWS, "fold table too short");

enum { FQ_STEP_PAD = 0, FQ_STEP_FOLD = 1, FQ_STEP_CARRY = 2 };

// Table layout in ints (mirrored by ops/kernels.py fq_tables).
#define FQ_TAB_FOLD 0
#define FQ_TAB_PAD (FQ_TAB_FOLD + FQ_FOLD_ROWS * FQ_N)
#define FQ_TAB_INTS (FQ_TAB_PAD + FQ_N)

__constant__ int c_fq[FQ_TAB_INTS];
__device__ int g_fq[FQ_TAB_INTS];

// Replay plan P on the accumulator object s: one call of
// s.step<kind, arg, width before, width after>() per planned step.
#define FQ_STEP_CALL(kind, arg, wi, wo) \
  s.template step<FQ_STEP_##kind, arg, wi, wo>();
#define FQ_PLAN_CASE(NAME) \
  if constexpr (P == FQ_PLAN_##NAME) { FQ_PLAN_##NAME##_STEPS(FQ_STEP_CALL) }
template <int P, class S>
__device__ __forceinline__ void fq_run_plan(S& s) {
  FQ_PLANS(FQ_PLAN_CASE)
}

// -- one thread per lane (g1_add_kernel) -------------------------------------

// One thread's accumulator of FQ_MAXW positions, indexed only by
// compile-time positions so it lives in registers.  Invariant:
// positions >= the live width hold 0.
struct FqThreadAcc {
  int (&v)[FQ_MAXW];

  template <int K, int A, int WI, int WO>
  __device__ __forceinline__ void step() {
    if constexpr (K == FQ_STEP_FOLD) {
      // lo += hi · fold[:A]; the hi positions are consumed.
#pragma unroll
      for (int r = 0; r < A; ++r) {
        const int h = v[FQ_N + r];
#pragma unroll
        for (int j = 0; j < FQ_N; ++j)
          v[j] += h * c_fq[FQ_TAB_FOLD + r * FQ_N + j];
        v[FQ_N + r] = 0;
      }
    } else if constexpr (K == FQ_STEP_CARRY) {
      // One parallel carry pass over the WO live positions (WO = WI + 1
      // takes the top carry; else the top carry is provably 0).
#pragma unroll
      for (int i = WO - 1; i > 0; --i)
        v[i] = (v[i] & FQ_MASK) + (v[i - 1] >> FQ_BITS);
      v[0] &= FQ_MASK;
    }  // pad: the new positions already hold zeros
  }
};

template <int P>
__device__ __forceinline__ void fq_reduce(int (&v)[FQ_MAXW]) {
  FqThreadAcc s{v};
  fq_run_plan<P>(s);
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
  fq_reduce<FQ_PLAN_MUL>(v);
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
  fq_reduce<FQ_PLAN_ADD2>(v);
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
  fq_reduce<FQ_PLAN_SUB>(v);
#pragma unroll
  for (int j = 0; j < FQ_N; ++j) out[j] = v[j];
}

// a · k for a small constant k whose bound plan is P.
template <int P>
__device__ __noinline__ void fe_small(int* out, const int* a, int k) {
  int v[FQ_MAXW];
#pragma unroll
  for (int i = 0; i < FQ_MAXW; ++i) v[i] = i < FQ_N ? a[i] * k : 0;
  fq_reduce<P>(v);
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
