// Fq limbs, field tables and build-time reduction plans of one prime
// field, the base of the lane-group field core (fq_group.cuh) that every
// kernel of the port runs on (fq_mul.cu, g1_point.cu, pairing.cu,
// ed_point.cu, wp_point.cu).  A library is built once per field: the
// limb count comes from the generated header, so one source serves
// BLS12-381's Fq (39 limbs) and the 26-limb fields of Ed25519, secp256k1
// and SM2.
//
// An element is FQ_N loose limbs of 10 bits in int32 (each limb <= 4095),
// the layout of consensus_overlord_tpu/ops/field.py.  Every operation
// ends in a reduction plan: a short list of carry / fold / pad steps
// that FieldSpec._plan computed in Python from exact per-position
// bounds, and that proves no intermediate leaves int32.  ops/kernels.py
// writes the limb count and the plans into the generated header
// fq_plans.h (in the field's own build directory) as X-macros of
// FQ_STEP(kind, arg, width before, width after), so each step is a
// template instantiation that unrolls over its live positions only.
// The fold rows (row k = 2^(10(n+k)) mod p in limbs) and the
// subtraction pad stay data: fq_set_tables (fq_group.cuh) uploads them
// to device memory (g_fq) and lays the fold rows out there once more
// per lane-group size.  The kernels replay exactly the planned steps, so
// their outputs are bit-identical to the plain PyTorch versions and to
// the JAX package.
#pragma once

#include <cuda_runtime.h>

#include "fq_plans.h"  // generated into _build/ by ops/kernels.py

#define FQ_N FQ_GEN_N
#define FQ_BITS 10
#define FQ_MASK ((1 << FQ_BITS) - 1)
#define FQ_MAXW (2 * FQ_N + 2)  // widest accumulator a plan may reach
#define FQ_FOLD_ROWS (FQ_N + 8)

static_assert(FQ_GEN_BITS == FQ_BITS && FQ_N <= 39,
              "fq_plans.h was generated for another limb layout");
static_assert(FQ_GEN_FOLD_ROWS <= FQ_FOLD_ROWS, "fold table too short");

enum { FQ_STEP_PAD = 0, FQ_STEP_FOLD = 1, FQ_STEP_CARRY = 2 };

// Table layout in ints (mirrored by ops/kernels.py fq_tables).
#define FQ_TAB_FOLD 0
#define FQ_TAB_PAD (FQ_TAB_FOLD + FQ_FOLD_ROWS * FQ_N)
#define FQ_TAB_INTS (FQ_TAB_PAD + FQ_N)

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
