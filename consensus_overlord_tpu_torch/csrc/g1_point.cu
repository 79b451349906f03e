// Fused group operations of an a = 0 short-Weierstrass curve for Hopper
// (sm_90a): the complete projective addition and the dedicated a=0
// doubling, each one kernel.  Built for BLS12-381's G1 (b = 4) and for
// secp256k1 (b = 7): the field's generated header (fq_plans.h) gives
// 3b as FQ_GEN_B3 and its reduction plan as FQ_GEN_B3_PLAN.
//
// Replaces the TPU kernel consensus_overlord_tpu/ops/pallas_point.py
// `_point_kernel` in both its forms: op="add" (body _g1_add_body,
// Renes–Costello–Batina 2016 Algorithm 7 with a = 0, b3 = 12) and
// op="dbl" (body _g1_dbl_body, Algorithm 9).  Each replays the straight
// line of ops/curve.py CurveOps.add / CurveOps.dbl op for op, with every
// field op ending in the same planned reduction (fq_plans.h), so the
// outputs are bit-identical to the generic formulas over the plain field
// (bls12381_groups.G1.add_plain / dbl_plain; for secp256k1,
// weierstrass.SECP.add_plain / dbl_plain).
//
// What bounds them on the H100: an add reads six and writes three (B, 39)
// int32 coordinates (1,404 bytes a lane) and does 12 field multiplies
// plus 20 add/sub/small-multiple reductions: about 39,900 integer
// multiply-adds and 9,600 carry masks and shift-adds a lane; a doubling
// 8 multiplies, 936 bytes, about 26,100 and 5,400.  At Hopper's 64
// IMADs per clock per SM the multiply-adds bound both (chip_smoke.py
// `bound`).
//
// Both run on the lane-group field core (fq_group.cuh): G threads per
// lane (ADD_G, DBL_G; 64 threads a block), the coordinates and every
// temporary as register slices of L limbs a thread, each field op inlined
// and replaying its own build-time plan, each thread reading and writing
// its own limbs of the (B, 39) rows directly.  The independent products
// of a stage run as one interleaved multiply, so their chains overlap and
// share the fold-row loads: the add's twelve in two stages of six
// (x1x2, y1y2, z1z2 and the three cross sums; then the six of the
// output), the doubling's eight in stages of four, two and two.  G = 16
// was the fastest of 8 and 16 for both on the H100, and for the add one
// multiply of six beat two of three (PERF.md): at B = 8192 the add takes
// 0.073 ms against a 0.0196 ms bound, the doubling 0.045 against 0.0128
// (NVIDIA H100 80GB HBM3, 700 W).  ptxas -v, printed by chip_smoke.py:
// g1_add_kernel 128 registers, g1_dbl_kernel 117, no spills.  Over
// secp256k1's 26 limbs (L = 2 at G = 16) the same bodies do about 45%
// of that work.

#include "fq_group.cuh"

#define ADD_THREADS 64
#define ADD_G 16  // threads per lane
#define DBL_THREADS 64
#define DBL_G 16  // threads per lane
// 3·b of the curve, and the plan whose bounds hold for a product by it.
#ifndef FQ_GEN_B3
#error "g1_point.cu is built only for a field whose header gives FQ_GEN_B3"
#endif
#define G1_B3 FQ_GEN_B3

__global__ void __launch_bounds__(ADD_THREADS)
    g1_add_kernel(int* ox, int* oy, int* oz, const int* px, const int* py,
                  const int* pz, const int* qx, const int* qy,
                  const int* qz, int batch) {
  constexpr int G = ADD_G;
  using F = Fe<G>;
  constexpr int LANES = ADD_THREADS / G;
  constexpr int NP = 6;  // products one multiply interleaves: a stage
  __shared__ __align__(16) int scratch[LANES * FqGroup<G>::stride(NP)];
  FqLane<G> ln;
  fq_lane_init<G, NP>(ln, scratch);
  const long lane = (long)blockIdx.x * LANES + threadIdx.x / G;
  F x1, y1, z1, x2, y2, z2;
  fq_load(x1, px, lane, batch, ln.t);
  fq_load(y1, py, lane, batch, ln.t);
  fq_load(z1, pz, lane, batch, ln.t);
  fq_load(x2, qx, lane, batch, ln.t);
  fq_load(y2, qy, lane, batch, ln.t);
  fq_load(z2, qz, lane, batch, ln.t);

  F t0, t1, t2, t3, t4, t5;
  {  // x1x2, y1y2, z1z2, (x1+y1)(x2+y2), (y1+z1)(y2+z2), (x1+z1)(x2+z2)
    F a[6] = {x1, y1, z1, fq_add(ln, x1, y1), fq_add(ln, y1, z1),
              fq_add(ln, x1, z1)};
    F b[6] = {x2, y2, z2, fq_add(ln, x2, y2), fq_add(ln, y2, z2),
              fq_add(ln, x2, z2)};
    F r[6];
    fq_mul_n<G, NP>(ln, r, a, b);
    t0 = r[0], t1 = r[1], t2 = r[2];
    t3 = fq_sub(ln, r[3], fq_add(ln, t0, t1));  // x1y2 + x2y1
    t4 = fq_sub(ln, r[4], fq_add(ln, t1, t2));  // y1z2 + y2z1
    t5 = fq_sub(ln, r[5], fq_add(ln, t0, t2));  // x1z2 + x2z1
  }
  const F three_t0 = fq_small<FQ_PLAN_SMALL3>(ln, t0, 3);
  const F b3_t2 = fq_small<FQ_GEN_B3_PLAN>(ln, t2, G1_B3);
  const F y3 = fq_small<FQ_GEN_B3_PLAN>(ln, t5, G1_B3);
  const F z3 = fq_add(ln, t1, b3_t2);
  t1 = fq_sub(ln, t1, b3_t2);
  {
    F a[6] = {t3, t4, t1, y3, z3, three_t0};
    F b[6] = {t1, y3, z3, three_t0, t4, t3};
    F r[6];
    fq_mul_n<G, NP>(ln, r, a, b);
    fq_store(ox, fq_sub(ln, r[0], r[1]), lane, batch, ln.t);
    fq_store(oy, fq_add(ln, r[2], r[3]), lane, batch, ln.t);
    fq_store(oz, fq_add(ln, r[4], r[5]), lane, batch, ln.t);
  }
}

__global__ void __launch_bounds__(DBL_THREADS)
    g1_dbl_kernel(int* ox, int* oy, int* oz, const int* px, const int* py,
                  const int* pz, int batch) {
  constexpr int G = DBL_G;
  using F = Fe<G>;
  constexpr int LANES = DBL_THREADS / G;
  constexpr int NP = 4;  // products one multiply interleaves
  __shared__ __align__(16) int scratch[LANES * FqGroup<G>::stride(NP)];
  FqLane<G> ln;
  fq_lane_init<G, NP>(ln, scratch);
  const long lane = (long)blockIdx.x * LANES + threadIdx.x / G;
  F x, y, z, t0, t1, zz, xy;
  fq_load(x, px, lane, batch, ln.t);
  fq_load(y, py, lane, batch, ln.t);
  fq_load(z, pz, lane, batch, ln.t);

  {  // Y², YZ, Z², XY
    F a[NP] = {y, y, z, x}, b[NP] = {y, z, z, y}, r[NP];
    fq_mul_n<G, NP>(ln, r, a, b);
    t0 = r[0], t1 = r[1], zz = r[2], xy = r[3];
  }
  F z3 = fq_small<FQ_PLAN_SMALL8>(ln, t0, 8);      // 8Y²
  F t2 = fq_small<FQ_GEN_B3_PLAN>(ln, zz, G1_B3);  // 3bZ²
  F x3;
  {
    F a[2] = {t2, t1}, b[2] = {z3, z3}, r[2];
    fq_mul_n<G, 2>(ln, r, a, b);
    x3 = r[0];  // 24bY²Z²
    z3 = r[1];  // 8Y³Z
  }
  F y3 = fq_add(ln, t0, t2);                                   // Y² + 3bZ²
  t0 = fq_sub(ln, t0, fq_small<FQ_PLAN_SMALL3>(ln, t2, 3));  // Y² − 9bZ²
  {
    F a[2] = {t0, t0}, b[2] = {y3, xy}, r[2];
    fq_mul_n<G, 2>(ln, r, a, b);
    y3 = fq_add(ln, r[0], x3);                   // (Y²−9bZ²)(Y²+3bZ²) + 24bY²Z²
    x3 = fq_small<FQ_PLAN_SMALL2>(ln, r[1], 2);  // 2XY(Y² − 9bZ²)
  }

  fq_store(ox, x3, lane, batch, ln.t);
  fq_store(oy, y3, lane, batch, ln.t);
  fq_store(oz, z3, lane, batch, ln.t);
}

extern "C" int g1_add_launch(void* ox, void* oy, void* oz, const void* px,
                             const void* py, const void* pz, const void* qx,
                             const void* qy, const void* qz, int batch,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  constexpr int LANES = ADD_THREADS / ADD_G;
  const int blocks = (batch + LANES - 1) / LANES;
  g1_add_kernel<<<blocks, ADD_THREADS, 0, (cudaStream_t)stream>>>(
      (int*)ox, (int*)oy, (int*)oz, (const int*)px, (const int*)py,
      (const int*)pz, (const int*)qx, (const int*)qy, (const int*)qz, batch);
  return (int)cudaGetLastError();
}

extern "C" int g1_dbl_launch(void* ox, void* oy, void* oz, const void* px,
                             const void* py, const void* pz, int batch,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  constexpr int LANES = DBL_THREADS / DBL_G;
  const int blocks = (batch + LANES - 1) / LANES;
  g1_dbl_kernel<<<blocks, DBL_THREADS, 0, (cudaStream_t)stream>>>(
      (int*)ox, (int*)oy, (int*)oz, (const int*)px, (const int*)py,
      (const int*)pz, batch);
  return (int)cudaGetLastError();
}
