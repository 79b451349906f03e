// BLS12-381's Fq in 12 words of 32 bits, carried with the card's carry
// flag: the word core of csrc/g2_point.cu.  ops/g2_words.py holds the
// design (Montgomery sums without entering Montgomery form, the
// programs), generates the constants below into g2_words.h, and models
// every function here on Python integers with each value's range
// checked.
//
// An element is 12 little-endian words.  The ranges (ops/g2_words.py
// `bounds` proves them for every loose input): an entered value or a
// quotient step's output is below 2^381, a stage-1 product below 2^382, a
// product's 24-word accumulator below 2^768, a REDC output below 2^384,
// an output below 2p.  So no chain below carries out of its words: where
// a carry is dropped (the top of a product, a sum, a REDC), the model
// shows it is 0.
//
// Every carry chain is one asm block that starts without a carry in and
// ends with its carry captured in a register, so no carry flag lives
// between two asm statements, where the compiler could schedule other
// code.
#pragma once

#include <stdint.h>

#include "g2_words.h"  // FPW_* constants, written by ops/kernels.py

#define FPW_N 12
#define FPW_LIMBS 39
#define FPW_LIMB_BITS 10
static_assert(FPW_GEN_WORDS == FPW_N, "g2_words.h holds another word layout");

#define FPW_REP12(F) F(0) F(1) F(2) F(3) F(4) F(5) F(6) F(7) F(8) F(9) F(10) F(11)

// Operand lists: words J..J+12 (or 11) of an accumulator, a 12-word
// register array, and p, 2p, 4p as immediates.
#define FPW_D12(d, J)                                                        \
  "+r"(d[J]), "+r"(d[J + 1]), "+r"(d[J + 2]), "+r"(d[J + 3]),                \
      "+r"(d[J + 4]), "+r"(d[J + 5]), "+r"(d[J + 6]), "+r"(d[J + 7]),        \
      "+r"(d[J + 8]), "+r"(d[J + 9]), "+r"(d[J + 10]), "+r"(d[J + 11])
#define FPW_R12(a)                                                           \
  "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),          \
      "r"(a[6]), "r"(a[7]), "r"(a[8]), "r"(a[9]), "r"(a[10]), "r"(a[11])
#define FPW_N12(X)                                                           \
  "n"(X##_0), "n"(X##_1), "n"(X##_2), "n"(X##_3), "n"(X##_4), "n"(X##_5),    \
      "n"(X##_6), "n"(X##_7), "n"(X##_8), "n"(X##_9), "n"(X##_10),           \
      "n"(X##_11)

// A word row of a product, D += a·b·2^(32J), in two chains.  Low halves:
// %0..%12 = d[J..J+12], %13 = the carry pending for word J+12 (in) and
// J+13 (out), %14..%25 = a, %26 = b.  High halves: %0..%11 =
// d[J+1..J+12], %12 = the pending carry, %13..%24 = a, %25 = b.
#define FPW_ROW_LO                                                            \
  "mad.lo.cc.u32 %0, %26, %14, %0;\n\t"                                      \
  "madc.lo.cc.u32 %1, %26, %15, %1;\n\t"                                     \
  "madc.lo.cc.u32 %2, %26, %16, %2;\n\t"                                     \
  "madc.lo.cc.u32 %3, %26, %17, %3;\n\t"                                     \
  "madc.lo.cc.u32 %4, %26, %18, %4;\n\t"                                     \
  "madc.lo.cc.u32 %5, %26, %19, %5;\n\t"                                     \
  "madc.lo.cc.u32 %6, %26, %20, %6;\n\t"                                     \
  "madc.lo.cc.u32 %7, %26, %21, %7;\n\t"                                     \
  "madc.lo.cc.u32 %8, %26, %22, %8;\n\t"                                     \
  "madc.lo.cc.u32 %9, %26, %23, %9;\n\t"                                     \
  "madc.lo.cc.u32 %10, %26, %24, %10;\n\t"                                   \
  "madc.lo.cc.u32 %11, %26, %25, %11;\n\t"                                   \
  "addc.cc.u32 %12, %12, %13;\n\t"                                           \
  "addc.u32 %13, 0, 0;"
#define FPW_ROW_HI                                                            \
  "mad.hi.cc.u32 %0, %25, %13, %0;\n\t"                                      \
  "madc.hi.cc.u32 %1, %25, %14, %1;\n\t"                                     \
  "madc.hi.cc.u32 %2, %25, %15, %2;\n\t"                                     \
  "madc.hi.cc.u32 %3, %25, %16, %3;\n\t"                                     \
  "madc.hi.cc.u32 %4, %25, %17, %4;\n\t"                                     \
  "madc.hi.cc.u32 %5, %25, %18, %5;\n\t"                                     \
  "madc.hi.cc.u32 %6, %25, %19, %6;\n\t"                                     \
  "madc.hi.cc.u32 %7, %25, %20, %7;\n\t"                                     \
  "madc.hi.cc.u32 %8, %25, %21, %8;\n\t"                                     \
  "madc.hi.cc.u32 %9, %25, %22, %9;\n\t"                                     \
  "madc.hi.cc.u32 %10, %25, %23, %10;\n\t"                                   \
  "madc.hi.cc.u32 %11, %25, %24, %11;\n\t"                                   \
  "addc.u32 %12, %12, 0;"

// d += a·b·2^(32J); `pend` carries the row's carry out of word J+12 into
// word J+13, where the next row's low chain adds it.
template <int J>
__device__ __forceinline__ void fpw_row(uint32_t (&d)[2 * FPW_N],
                                        const uint32_t (&a)[FPW_N],
                                        uint32_t b, uint32_t& pend) {
  asm(FPW_ROW_LO : FPW_D12(d, J), "+r"(d[J + 12]), "+r"(pend)
      : FPW_R12(a), "r"(b));
  asm(FPW_ROW_HI : FPW_D12(d, J + 1), "+r"(pend) : FPW_R12(a), "r"(b));
}

// D += a·b over the whole 24-word accumulator (the sum stays below 2^768,
// so the last row's pending carry is 0).
__device__ __forceinline__ void fpw_mac(uint32_t (&d)[2 * FPW_N],
                                        const uint32_t (&a)[FPW_N],
                                        const uint32_t (&b)[FPW_N]) {
  uint32_t pend = 0;
#define FPW_MAC_ROW(J) fpw_row<J>(d, a, b[J], pend);
  FPW_REP12(FPW_MAC_ROW)
#undef FPW_MAC_ROW
}

// One REDC word step: d += m·p·2^(32I), m = d[I]·(−p⁻¹), which clears
// word I.
template <int I>
__device__ __forceinline__ void fpw_redc_step(uint32_t (&d)[2 * FPW_N],
                                              uint32_t& pend) {
  const uint32_t m = d[I] * FPW_PINV;
  asm(FPW_ROW_LO : FPW_D12(d, I), "+r"(d[I + 12]), "+r"(pend)
      : FPW_N12(FPW_P), "r"(m));
  asm(FPW_ROW_HI : FPW_D12(d, I + 1), "+r"(pend) : FPW_N12(FPW_P), "r"(m));
}

// r = D·R⁻¹ mod p (R = 2^384), below D/R + p: the 12 word steps, then
// the top half.
__device__ __forceinline__ void fpw_redc(uint32_t (&r)[FPW_N],
                                         uint32_t (&d)[2 * FPW_N]) {
  uint32_t pend = 0;
#define FPW_REDC_STEP(I) fpw_redc_step<I>(d, pend);
  FPW_REP12(FPW_REDC_STEP)
#undef FPW_REDC_STEP
#pragma unroll
  for (int k = 0; k < FPW_N; ++k) r[k] = d[FPW_N + k];
}

// b = N − b for N = 2p (which 1) or 4p (which 2); b ≤ N.
template <int which>
__device__ __forceinline__ void fpw_neg(uint32_t (&b)[FPW_N]) {
#define FPW_NEG_TEXT                                                          \
  "sub.cc.u32 %0, %12, %0;\n\t"                                              \
  "subc.cc.u32 %1, %13, %1;\n\t"                                             \
  "subc.cc.u32 %2, %14, %2;\n\t"                                             \
  "subc.cc.u32 %3, %15, %3;\n\t"                                             \
  "subc.cc.u32 %4, %16, %4;\n\t"                                             \
  "subc.cc.u32 %5, %17, %5;\n\t"                                             \
  "subc.cc.u32 %6, %18, %6;\n\t"                                             \
  "subc.cc.u32 %7, %19, %7;\n\t"                                             \
  "subc.cc.u32 %8, %20, %8;\n\t"                                             \
  "subc.cc.u32 %9, %21, %9;\n\t"                                             \
  "subc.cc.u32 %10, %22, %10;\n\t"                                           \
  "subc.u32 %11, %23, %11;"
  if constexpr (which == 1)
    asm(FPW_NEG_TEXT : FPW_D12(b, 0) : FPW_N12(FPW_2P));
  else
    asm(FPW_NEG_TEXT : FPW_D12(b, 0) : FPW_N12(FPW_4P));
#undef FPW_NEG_TEXT
}

// s += t (the sum stays below 2^384).
__device__ __forceinline__ void fpw_add(uint32_t (&s)[FPW_N],
                                        const uint32_t (&t)[FPW_N]) {
  asm("add.cc.u32 %0, %0, %12;\n\t"
      "addc.cc.u32 %1, %1, %13;\n\t"
      "addc.cc.u32 %2, %2, %14;\n\t"
      "addc.cc.u32 %3, %3, %15;\n\t"
      "addc.cc.u32 %4, %4, %16;\n\t"
      "addc.cc.u32 %5, %5, %17;\n\t"
      "addc.cc.u32 %6, %6, %18;\n\t"
      "addc.cc.u32 %7, %7, %19;\n\t"
      "addc.cc.u32 %8, %8, %20;\n\t"
      "addc.cc.u32 %9, %9, %21;\n\t"
      "addc.cc.u32 %10, %10, %22;\n\t"
      "addc.u32 %11, %11, %23;"
      : FPW_D12(s, 0)
      : FPW_R12(t));
}

// v = x·k in 13 words (k a small multiple).
__device__ __forceinline__ void fpw_small(uint32_t (&v)[FPW_N + 1],
                                          const uint32_t (&x)[FPW_N],
                                          uint32_t k) {
#pragma unroll
  for (int i = 0; i < FPW_N; ++i) v[i] = x[i] * k;
  v[FPW_N] = 0;
  asm("mad.hi.cc.u32 %0, %12, %24, %0;\n\t"
      "madc.hi.cc.u32 %1, %13, %24, %1;\n\t"
      "madc.hi.cc.u32 %2, %14, %24, %2;\n\t"
      "madc.hi.cc.u32 %3, %15, %24, %3;\n\t"
      "madc.hi.cc.u32 %4, %16, %24, %4;\n\t"
      "madc.hi.cc.u32 %5, %17, %24, %5;\n\t"
      "madc.hi.cc.u32 %6, %18, %24, %6;\n\t"
      "madc.hi.cc.u32 %7, %19, %24, %7;\n\t"
      "madc.hi.cc.u32 %8, %20, %24, %8;\n\t"
      "madc.hi.cc.u32 %9, %21, %24, %9;\n\t"
      "madc.hi.cc.u32 %10, %22, %24, %10;\n\t"
      "madc.hi.u32 %11, %23, %24, %11;"
      : FPW_D12(v, 1)
      : FPW_R12(x), "r"(k));
}

// r = v − q·p, q = ⌊(v >> 352) / (p_top + 1)⌋: below (p_top + q + 1)·2^352
// and never below 0, since q·p ≤ q·(p_top + 1)·2^352 ≤ v.
__device__ __forceinline__ void fpw_reduce13(uint32_t (&r)[FPW_N],
                                             uint32_t (&v)[FPW_N + 1]) {
  const uint64_t top = ((uint64_t)v[FPW_N] << 32) | v[FPW_N - 1];
  const uint32_t q = (uint32_t)(top / FPW_PTOP1);
  uint32_t qp[FPW_N + 1];
#define FPW_QP_LO(K) qp[K] = q * FPW_P_##K;
  FPW_REP12(FPW_QP_LO)
#undef FPW_QP_LO
  qp[FPW_N] = 0;
  asm("mad.hi.cc.u32 %0, %12, %13, %0;\n\t"
      "madc.hi.cc.u32 %1, %12, %14, %1;\n\t"
      "madc.hi.cc.u32 %2, %12, %15, %2;\n\t"
      "madc.hi.cc.u32 %3, %12, %16, %3;\n\t"
      "madc.hi.cc.u32 %4, %12, %17, %4;\n\t"
      "madc.hi.cc.u32 %5, %12, %18, %5;\n\t"
      "madc.hi.cc.u32 %6, %12, %19, %6;\n\t"
      "madc.hi.cc.u32 %7, %12, %20, %7;\n\t"
      "madc.hi.cc.u32 %8, %12, %21, %8;\n\t"
      "madc.hi.cc.u32 %9, %12, %22, %9;\n\t"
      "madc.hi.cc.u32 %10, %12, %23, %10;\n\t"
      "madc.hi.u32 %11, %12, %24, %11;"
      : FPW_D12(qp, 1)
      : "r"(q), FPW_N12(FPW_P));
  asm("sub.cc.u32 %0, %0, %13;\n\t"
      "subc.cc.u32 %1, %1, %14;\n\t"
      "subc.cc.u32 %2, %2, %15;\n\t"
      "subc.cc.u32 %3, %3, %16;\n\t"
      "subc.cc.u32 %4, %4, %17;\n\t"
      "subc.cc.u32 %5, %5, %18;\n\t"
      "subc.cc.u32 %6, %6, %19;\n\t"
      "subc.cc.u32 %7, %7, %20;\n\t"
      "subc.cc.u32 %8, %8, %21;\n\t"
      "subc.cc.u32 %9, %9, %22;\n\t"
      "subc.cc.u32 %10, %10, %23;\n\t"
      "subc.cc.u32 %11, %11, %24;\n\t"
      "subc.u32 %12, %12, %25;"
      : FPW_D12(v, 0), "+r"(v[FPW_N])
      : FPW_R12(qp), "r"(qp[FPW_N]));
#pragma unroll
  for (int k = 0; k < FPW_N; ++k) r[k] = v[k];
}

// Entry: the 39 loose limbs of `row` (each ≤ 4095, the value below
// 2^392) repacked into 13 words, then one quotient step.
__device__ __forceinline__ void fpw_entry(uint32_t (&x)[FPW_N],
                                          const int* row) {
  uint64_t w[FPW_N + 1];
#pragma unroll
  for (int k = 0; k <= FPW_N; ++k) w[k] = 0;
#pragma unroll
  for (int i = 0; i < FPW_LIMBS; ++i) {
    const int bit = FPW_LIMB_BITS * i;  // a limb < 2^12 at bit % 32 < 32
    w[bit / 32] += (uint64_t)(uint32_t)row[i] << (bit % 32);
  }
  uint32_t v[FPW_N + 1];
#pragma unroll
  for (int k = 0; k <= FPW_N; ++k) {
    if (k) w[k] += w[k - 1] >> 32;
    v[k] = (uint32_t)w[k];
  }
  fpw_reduce13(x, v);
}

// Exit: y (below 2^384) split into 39 limbs of 10 bits at `row`.
__device__ __forceinline__ void fpw_exit(int* row, const uint32_t (&y)[FPW_N]) {
#pragma unroll
  for (int i = 0; i < FPW_LIMBS; ++i) {
    const int bit = FPW_LIMB_BITS * i, w = bit / 32, s = bit % 32;
    uint32_t v = y[w] >> s;
    if (s > 32 - FPW_LIMB_BITS && w + 1 < FPW_N) v |= y[w + 1] << (32 - s);
    row[i] = (int)(v & ((1u << FPW_LIMB_BITS) - 1));
  }
}
