// Fused BLS12-381 G1 group operations for Hopper (sm_90a): the complete
// projective addition and the dedicated a=0 doubling, each one kernel.
//
// Replaces the TPU kernel consensus_overlord_tpu/ops/pallas_point.py
// `_point_kernel` in both its forms: op="add" (body _g1_add_body,
// Renes–Costello–Batina 2016 Algorithm 7 with a = 0, b3 = 12) and
// op="dbl" (body _g1_dbl_body, Algorithm 9).  Each replays the straight
// line of ops/curve.py CurveOps.add / CurveOps.dbl op for op, with every
// field op ending in the same planned reduction (fq_plans.h), so the
// outputs are bit-identical to the generic formulas over the plain field
// (bls12381_groups.G1.add_plain / dbl_plain).
//
// What bounds them on the H100: an add reads six and writes three (B, 39)
// int32 coordinates (1,404 bytes a lane) and does 12 field multiplies
// plus 20 add/sub/small-multiple reductions: about 39,900 integer
// multiply-adds and 9,600 carry masks and shift-adds a lane; a doubling
// 8 multiplies, 936 bytes, about 26,100 and 5,400.  At Hopper's 64
// IMADs per clock per SM the multiply-adds bound both (chip_smoke.py
// `bound`).
//
// g1_add_kernel keeps the first design: one thread per lane, the
// coordinates and temporaries in thread-private arrays, each field op an
// out-of-line function whose accumulator sits in registers and whose
// fold rows are constant-memory operands, lanes staged through a
// shared-memory tile.  At B = 8192 that is two warps per SM:
// latency-bound.
//
// g1_dbl_kernel runs on the lane-group field core (fq_group.cuh): G = 16
// threads per lane (64 threads a block, 4 lanes), the three coordinates
// and every temporary as register slices of L = 3 limbs a thread, each
// field op inlined and replaying its own build-time plan.  The
// independent products of a stage run as one interleaved multiply (Y²,
// YZ, Z², XY; then two pairs), so their chains overlap and share the
// fold-row loads.  It reads and writes each thread's limbs of the
// (B, 39) rows directly.  G = 16 was the fastest of 4, 8 and 16 on the
// H100 (PERF.md).  117 registers, no spills (ptxas -v, printed by
// chip_smoke.py).

#include "fq_group.cuh"

#define PT_BLOCK 64
#define DBL_THREADS 64
#define DBL_G 16  // threads per lane
// 3·b for G1's b = 4.  The SMALL12 plan's bounds hold only for this value.
#define G1_B3 12

// Load one coordinate of the block's lanes into this thread's array.
__device__ __forceinline__ void stage_in(int* tile, const int* src,
                                         long lane0, int lanes, bool live,
                                         int* dst) {
  __syncthreads();  // the tile is free
  tile_load(tile, src, lane0, lanes);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < FQ_N; ++j)
    dst[j] = live ? tile[threadIdx.x * FQ_N + j] : 0;
}

// Store one coordinate of the block's lanes from this thread's array.
__device__ __forceinline__ void stage_out(int* tile, int* dst, long lane0,
                                          int lanes, bool live,
                                          const int* src) {
  __syncthreads();
  if (live) {
#pragma unroll
    for (int j = 0; j < FQ_N; ++j) tile[threadIdx.x * FQ_N + j] = src[j];
  }
  __syncthreads();
  tile_store(dst, tile, lane0, lanes);
}

__global__ void __launch_bounds__(PT_BLOCK)
    g1_add_kernel(int* ox, int* oy, int* oz, const int* px, const int* py,
                  const int* pz, const int* qx, const int* qy,
                  const int* qz, int batch) {
  __shared__ int tile[PT_BLOCK * FQ_N];
  const long lane0 = (long)blockIdx.x * PT_BLOCK;
  const int lanes = min(PT_BLOCK, batch - (int)lane0);
  const bool live = threadIdx.x < lanes;
  int x1[FQ_N], y1[FQ_N], z1[FQ_N], x2[FQ_N], y2[FQ_N], z2[FQ_N];
  int t0[FQ_N], t1[FQ_N], t2[FQ_N], t3[FQ_N], t4[FQ_N], t5[FQ_N];
  int u[FQ_N], w[FQ_N], three_t0[FQ_N], b3_t2[FQ_N];
  int x3[FQ_N], y3[FQ_N], z3[FQ_N];

  stage_in(tile, px, lane0, lanes, live, x1);
  stage_in(tile, py, lane0, lanes, live, y1);
  stage_in(tile, pz, lane0, lanes, live, z1);
  stage_in(tile, qx, lane0, lanes, live, x2);
  stage_in(tile, qy, lane0, lanes, live, y2);
  stage_in(tile, qz, lane0, lanes, live, z2);

  fe_mul(t0, x1, x2);
  fe_mul(t1, y1, y2);
  fe_mul(t2, z1, z2);
  fe_add(u, x1, y1);
  fe_add(w, x2, y2);
  fe_mul(t3, u, w);
  fe_add(u, t0, t1);
  fe_sub(t3, t3, u);  // x1y2 + x2y1
  fe_add(u, y1, z1);
  fe_add(w, y2, z2);
  fe_mul(t4, u, w);
  fe_add(u, t1, t2);
  fe_sub(t4, t4, u);  // y1z2 + y2z1
  fe_add(u, x1, z1);
  fe_add(w, x2, z2);
  fe_mul(t5, u, w);
  fe_add(u, t0, t2);
  fe_sub(t5, t5, u);  // x1z2 + x2z1
  fe_small<FQ_PLAN_SMALL3>(three_t0, t0, 3);
  fe_small<FQ_PLAN_SMALL12>(b3_t2, t2, G1_B3);
  fe_add(z3, t1, b3_t2);
  fe_sub(t1, t1, b3_t2);
  fe_small<FQ_PLAN_SMALL12>(y3, t5, G1_B3);
  fe_mul(u, t3, t1);
  fe_mul(w, t4, y3);
  fe_sub(x3, u, w);
  fe_mul(u, t1, z3);
  fe_mul(w, y3, three_t0);
  fe_add(y3, u, w);
  fe_mul(u, z3, t4);
  fe_mul(w, three_t0, t3);
  fe_add(z3, u, w);

  stage_out(tile, ox, lane0, lanes, live, x3);
  stage_out(tile, oy, lane0, lanes, live, y3);
  stage_out(tile, oz, lane0, lanes, live, z3);
}

__global__ void __launch_bounds__(DBL_THREADS)
    g1_dbl_kernel(int* ox, int* oy, int* oz, const int* px, const int* py,
                  const int* pz, int batch) {
  constexpr int G = DBL_G;
  using F = Fe<G>;
  constexpr int LANES = DBL_THREADS / G;
  constexpr int NP = 4;  // products one multiply interleaves
  __shared__ __align__(16) int scratch[LANES * NP * FqGroup<G>::LANE_INTS];
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
  F t2 = fq_small<FQ_PLAN_SMALL12>(ln, zz, G1_B3);  // 3bZ²
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
  const int blocks = (batch + PT_BLOCK - 1) / PT_BLOCK;
  g1_add_kernel<<<blocks, PT_BLOCK, 0, (cudaStream_t)stream>>>(
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
