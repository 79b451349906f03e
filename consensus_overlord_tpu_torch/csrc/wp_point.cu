// Complete projective addition on a short-Weierstrass curve with a = −3
// (SM2's recommended curve) for Hopper (sm_90a), one kernel: Renes,
// Costello and Batina 2016, Algorithm 1, the general-a formula, valid
// for every input pair, so doubling is add(p, p).
//
// Replaces the group law inside the JAX package's XLA jit
// consensus_overlord_tpu/crypto/ecdsa_tpu.py `_verify_kernel("sm2")`
// (its scan of ops/weierstrass.py `GeneralCurveOps.add`), which has no
// Pallas twin.  It replays GeneralCurveOps.add op for op over SM2's
// 26-limb field: a·x as −(3x) (a small multiple, then a negation) and
// 3b·x as a product by the constant row of 3b, every field op ending in
// the same planned reduction (fq_plans.h), so its outputs are
// bit-identical to the plain version (ops/weierstrass.py SM2.add_plain)
// and to the JAX package's.
//
// What bounds it on the H100: a lane reads six and writes three (B, 26)
// int32 coordinates (936 bytes) and does 14 field multiplies (the 12 of
// the formula and two by 3b), each 676 convolution and about 780 fold
// multiply-adds, plus 21 add/sub/negation/small-multiple reductions:
// about 21,000 integer multiply-adds a lane, so the multiply-adds bound
// it (chip_smoke.py `bound`).
//
// The design is g1_point.cu's on the lane-group field core
// (fq_group.cuh): G = 8 threads a lane (WP_G; L = 4 limbs a thread), the
// coordinates as register slices, and the independent products as
// interleaved multiplies in three stages: X1X2, Y1Y2, Z1Z2 and the three
// cross sums; then 3b·Z1Z2 and 3b·(X1Z2 + X2Z1); then the six of the
// output.  3b is a (1, 26) row the wrapper passes.

#include "fq_group.cuh"

#define WP_THREADS 64
#define WP_G 8  // threads per lane

template <int G>
__device__ __forceinline__ Fe<G> mul_a(const FqLane<G>& ln, const Fe<G>& x) {
  return fq_neg(ln, fq_small<FQ_PLAN_SMALL3>(ln, x, 3));  // a = −3
}

__global__ void __launch_bounds__(WP_THREADS)
    wp_add_general_kernel(int* ox, int* oy, int* oz, const int* px,
                          const int* py, const int* pz, const int* qx,
                          const int* qy, const int* qz, const int* b3row,
                          int batch) {
  constexpr int G = WP_G;
  using F = Fe<G>;
  constexpr int LANES = WP_THREADS / G;
  constexpr int NP = 6;  // products one multiply interleaves: a stage
  __shared__ __align__(16) int scratch[LANES * FqGroup<G>::stride(NP)];
  FqLane<G> ln;
  fq_lane_init<G, NP>(ln, scratch);
  const long lane = (long)blockIdx.x * LANES + threadIdx.x / G;
  F x1, y1, z1, x2, y2, z2, b3;
  fq_load(x1, px, lane, batch, ln.t);
  fq_load(y1, py, lane, batch, ln.t);
  fq_load(z1, pz, lane, batch, ln.t);
  fq_load(x2, qx, lane, batch, ln.t);
  fq_load(y2, qy, lane, batch, ln.t);
  fq_load(z2, qz, lane, batch, ln.t);
  fq_load(b3, b3row, 0, 1, ln.t);

  F t0, t1, t2, t3, t4, t5;
  {  // x1x2, y1y2, z1z2, (x1+y1)(x2+y2), (x1+z1)(x2+z2), (y1+z1)(y2+z2)
    F a[6] = {x1, y1, z1, fq_add(ln, x1, y1), fq_add(ln, x1, z1),
              fq_add(ln, y1, z1)};
    F b[6] = {x2, y2, z2, fq_add(ln, x2, y2), fq_add(ln, x2, z2),
              fq_add(ln, y2, z2)};
    F r[6];
    fq_mul_n<G, NP>(ln, r, a, b);
    t0 = r[0], t1 = r[1], t2 = r[2];
    t3 = fq_sub(ln, r[3], fq_add(ln, t0, t1));  // x1y2 + x2y1
    t4 = fq_sub(ln, r[4], fq_add(ln, t0, t2));  // x1z2 + x2z1
    t5 = fq_sub(ln, r[5], fq_add(ln, t1, t2));  // y1z2 + y2z1
  }
  F b3_t2, b3_t4;
  {
    F a[2] = {t2, t4}, b[2] = {b3, b3}, r[2];
    fq_mul_n<G, 2>(ln, r, a, b);
    b3_t2 = r[0], b3_t4 = r[1];
  }
  F z3 = fq_add(ln, b3_t2, mul_a(ln, t4));
  const F x3 = fq_sub(ln, t1, z3);
  z3 = fq_add(ln, t1, z3);
  const F a_t2 = mul_a(ln, t2);
  t1 = fq_add(ln, fq_small<FQ_PLAN_SMALL3>(ln, t0, 3), a_t2);  // 3x1x2 + a·z1z2
  t2 = mul_a(ln, fq_sub(ln, t0, a_t2));  // a·(x1x2 − a·z1z2)
  t4 = fq_add(ln, b3_t4, t2);
  {
    F a[6] = {x3, t1, t3, t5, t5, t3};
    F b[6] = {z3, t4, x3, t4, z3, t1};
    F r[6];
    fq_mul_n<G, NP>(ln, r, a, b);
    fq_store(ox, fq_sub(ln, r[2], r[3]), lane, batch, ln.t);
    fq_store(oy, fq_add(ln, r[0], r[1]), lane, batch, ln.t);
    fq_store(oz, fq_add(ln, r[4], r[5]), lane, batch, ln.t);
  }
}

extern "C" int wp_add_general_launch(void* ox, void* oy, void* oz,
                                     const void* px, const void* py,
                                     const void* pz, const void* qx,
                                     const void* qy, const void* qz,
                                     const void* b3, int batch, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  constexpr int LANES = WP_THREADS / WP_G;
  const int blocks = (batch + LANES - 1) / LANES;
  wp_add_general_kernel<<<blocks, WP_THREADS, 0, (cudaStream_t)stream>>>(
      (int*)ox, (int*)oy, (int*)oz, (const int*)px, (const int*)py,
      (const int*)pz, (const int*)qx, (const int*)qy, (const int*)qz,
      (const int*)b3, batch);
  return (int)cudaGetLastError();
}
