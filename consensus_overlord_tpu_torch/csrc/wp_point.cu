// Complete projective addition on a short-Weierstrass curve with a = −3
// (SM2's recommended curve) for Hopper (sm_90a): Renes, Costello and
// Batina 2016, Algorithm 1, the general-a formula, valid for every input
// pair, so doubling is add(p, p).  Two kernels share one body,
// `wp_add_body`:
//
// * wp_add_general_kernel, one addition per lane (the table builds);
// * wp_dual_ladder_kernel, ops/weierstrass.py `dual_scalar_mul_bits`
//   (window 4) in one launch: u1·G + u2·Q per lane, each window four
//   doublings, then the add of G's row, then the add of Q's row.  The
//   accumulator stays in registers for all 6·windows adds.  A lane's
//   window digits come packed, one byte a window (G's digit in the high
//   nibble), four to an int32 word.  The 16-row G table, one for all
//   lanes, is staged once per block in shared memory; the per-lane Q
//   table (16, B, 26) × 3 stays in device memory and each window reads
//   the row of its digit.
//
// Replace the group law inside the JAX package's XLA jit
// consensus_overlord_tpu/crypto/ecdsa_tpu.py `_verify_kernel("sm2")`
// (its scan of ops/weierstrass.py `GeneralCurveOps.add`), which has no
// Pallas twin.  The body replays GeneralCurveOps.add op for op over
// SM2's 26-limb field: a·x as −(3x) (a small multiple, then a negation)
// and 3b·x as a product by the constant row of 3b, every field op ending
// in the same planned reduction (fq_plans.h), so the outputs are
// bit-identical to the plain versions (ops/weierstrass.py SM2.add_plain,
// dual_ladder_plain) and to the JAX package's.
//
// What bounds them on the H100: an add does 14 field multiplies (the 12
// of the formula and two by 3b), each 676 convolution and about 780 fold
// multiply-adds, plus 28 add/sub/negation/small-multiple reductions:
// about 21,000 integer multiply-adds a lane, against 936 bytes (an add)
// or, for a 64-window ladder, 312 bytes of Q rows a window: the
// multiply-adds bound both (chip_smoke.py `bound`).
//
// The design is the lane-group field core's (fq_group.cuh): WP_G threads
// a lane, the coordinates as register slices, the independent products
// WP_NP at a time in lockstep, each stage's operands made just before
// their chunk: X1X2, Y1Y2, Z1Z2 and the three cross sums; then 3b·Z1Z2
// and 3b·(X1Z2 + X2Z1); then the six of the output.  Both kernels run
// without a register cap: at 16 warps an SM (128 registers) they
// spilled and ran slower than at 8 (PERF.md §6, the sweep).  3b and
// 1 are (1, 26) rows the wrapper passes.

#include "fq_group.cuh"

#define WP_THREADS 256
#define WP_G 16  // threads per lane
#define WP_NP 1  // products in lockstep
#define WP_MIN_BLOCKS 1  // no register cap: PERF.md §6, the sweep
#define WP_TABLE 16  // rows of a window-4 table

using WpF = Fe<WP_G>;

__device__ __forceinline__ WpF mul_a(const FqLane<WP_G>& ln, const WpF& x) {
  return fq_neg(ln, fq_small<FQ_PLAN_SMALL3>(ln, x, 3));  // a = −3
}

// o = p + q.  o may be p or q: every read of p and q comes first.  Each
// stage's operands are made just before their products (fq_mul_staged).
__device__ __forceinline__ void wp_add_body(const FqLane<WP_G>& ln,
                                            WpF (&o)[3], const WpF (&p)[3],
                                            const WpF (&q)[3],
                                            const WpF& b3) {
  constexpr int G = WP_G;
  WpF r[6];
  // x1x2, y1y2, z1z2, (x1+y1)(x2+y2), (x1+z1)(x2+z2), (y1+z1)(y2+z2)
  fq_mul_staged<G, WP_NP, 6>(ln, r, [&](auto k, WpF& u, WpF& v) {
    constexpr int i = k.value;
    if constexpr (i < 3) {
      u = p[i];
      v = q[i];
    } else {
      constexpr int j = i == 5 ? 1 : 0, l = i == 3 ? 1 : 2;
      u = fq_add(ln, p[j], p[l]);
      v = fq_add(ln, q[j], q[l]);
    }
  });
  WpF t0 = r[0], t1 = r[1], t2 = r[2];
  const WpF t3 = fq_sub(ln, r[3], fq_add(ln, t0, t1));  // x1y2 + x2y1
  WpF t4 = fq_sub(ln, r[4], fq_add(ln, t0, t2));        // x1z2 + x2z1
  const WpF t5 = fq_sub(ln, r[5], fq_add(ln, t1, t2));  // y1z2 + y2z1
  WpF b3_t[2];  // 3b·z1z2, 3b·(x1z2 + x2z1)
  fq_mul_staged<G, WP_NP, 2>(ln, b3_t, [&](auto k, WpF& u, WpF& v) {
    u = k.value ? t4 : t2;
    v = b3;
  });
  WpF z3 = fq_add(ln, b3_t[0], mul_a(ln, t4));
  const WpF x3 = fq_sub(ln, t1, z3);
  z3 = fq_add(ln, t1, z3);
  const WpF a_t2 = mul_a(ln, t2);
  t1 = fq_add(ln, fq_small<FQ_PLAN_SMALL3>(ln, t0, 3), a_t2);  // 3x1x2 + a·z1z2
  t2 = mul_a(ln, fq_sub(ln, t0, a_t2));  // a·(x1x2 − a·z1z2)
  t4 = fq_add(ln, b3_t[1], t2);
  // x3·z3, t1·t4, t3·x3, t5·t4, t5·z3, t3·t1
  fq_mul_staged<G, WP_NP, 6>(ln, r, [&](auto k, WpF& u, WpF& v) {
    constexpr int i = k.value;
    u = i == 0 ? x3 : i == 1 ? t1 : (i == 2 || i == 5) ? t3 : t5;
    v = i == 0 || i == 4 ? z3 : i == 2 ? x3 : i == 5 ? t1 : t4;
  });
  o[0] = fq_sub(ln, r[2], r[3]);
  o[1] = fq_add(ln, r[0], r[1]);
  o[2] = fq_add(ln, r[4], r[5]);
}

#define WP_SCRATCH (WP_THREADS / WP_G * FqGroup<WP_G>::stride(WP_NP))

__global__ void __launch_bounds__(WP_THREADS, WP_MIN_BLOCKS)
    wp_add_general_kernel(int* ox, int* oy, int* oz, const int* px,
                          const int* py, const int* pz, const int* qx,
                          const int* qy, const int* qz, const int* b3row,
                          int batch) {
  __shared__ __align__(16) int scratch[WP_SCRATCH];
  FqLane<WP_G> ln;
  fq_lane_init<WP_G, WP_NP>(ln, scratch);
  const long lane = fq_lane_now<WP_THREADS, WP_G>();
  WpF p[3], q[3], b3;
  fq_load(p[0], px, lane, batch, ln.t);
  fq_load(p[1], py, lane, batch, ln.t);
  fq_load(p[2], pz, lane, batch, ln.t);
  fq_load(q[0], qx, lane, batch, ln.t);
  fq_load(q[1], qy, lane, batch, ln.t);
  fq_load(q[2], qz, lane, batch, ln.t);
  fq_load(b3, b3row, 0, 1, ln.t);
  WpF r[3];
  wp_add_body(ln, r, p, q, b3);
  int* const out[3] = {ox, oy, oz};
  fq_store_now<WP_THREADS>(out, r, batch);
}

// Step k of a window adds acc to itself (k < 4), G's row (k = 4) or the
// lane's Q row (k = 5): one body in the loop keeps the code one add long.
__global__ void __launch_bounds__(WP_THREADS, WP_MIN_BLOCKS)
    wp_dual_ladder_kernel(int* ox, int* oy, int* oz, const int* tqx,
                          const int* tqy, const int* tqz, const int* tgx,
                          const int* tgy, const int* tgz,
                          const unsigned* digits, const int* b3row,
                          const int* onerow, int batch, int windows) {
  __shared__ __align__(16) int scratch[WP_SCRATCH];
  __shared__ int gtab[3][WP_TABLE * FQ_N];
  for (int i = threadIdx.x; i < WP_TABLE * FQ_N; i += WP_THREADS) {
    gtab[0][i] = tgx[i];
    gtab[1][i] = tgy[i];
    gtab[2][i] = tgz[i];
  }
  __syncthreads();
  constexpr int L = FqGroup<WP_G>::L;
  FqLane<WP_G> ln;
  fq_lane_init<WP_G, WP_NP>(ln, scratch);
  const int words = (windows + 3) / 4;
  const long plane = (long)batch * FQ_N;  // one row of every lane
  WpF b3, x[3];
  fq_load(b3, b3row, 0, 1, ln.t);
  fq_load(x[1], onerow, 0, 1, ln.t);  // infinity (0 : 1 : 0)
#pragma unroll
  for (int s = 0; s < L; ++s) x[0].v[s] = x[2].v[s] = 0;
  unsigned word = 0;
#pragma unroll 1
  for (int j = 0; j < windows; ++j) {
    if ((j & 3) == 0) {
      const long lane = fq_lane_now<WP_THREADS, WP_G>();
      word = lane < batch ? digits[lane * words + (j >> 2)] : 0u;
    }
    const unsigned byte = (word >> (8 * (j & 3))) & 0xffu;
    const int dg = byte >> 4, dq = byte & 15u;
#pragma unroll 1
    for (int k = 0; k < 6; ++k) {
      WpF y[3];
      if (k < 4) {
        y[0] = x[0], y[1] = x[1], y[2] = x[2];
      } else if (k == 4) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
#pragma unroll
          for (int s = 0; s < L; ++s) {
            const int jj = ln.t * L + s;
            y[c].v[s] = jj < FQ_N ? gtab[c][dg * FQ_N + jj] : 0;
          }
        }
      } else {
        const long lane = fq_lane_now<WP_THREADS, WP_G>();
        fq_load(y[0], tqx + dq * plane, lane, batch, ln.t);
        fq_load(y[1], tqy + dq * plane, lane, batch, ln.t);
        fq_load(y[2], tqz + dq * plane, lane, batch, ln.t);
      }
      WpF r[3];
      wp_add_body(ln, r, x, y, b3);
      x[0] = r[0], x[1] = r[1], x[2] = r[2];
    }
  }
  int* const out[3] = {ox, oy, oz};
  fq_store_now<WP_THREADS>(out, x, batch);
}

static int wp_blocks(int batch) {
  constexpr int LANES = WP_THREADS / WP_G;
  return (batch + LANES - 1) / LANES;
}

extern "C" int wp_add_general_launch(void* ox, void* oy, void* oz,
                                     const void* px, const void* py,
                                     const void* pz, const void* qx,
                                     const void* qy, const void* qz,
                                     const void* b3, int batch, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  wp_add_general_kernel<<<wp_blocks(batch), WP_THREADS, 0,
                          (cudaStream_t)stream>>>(
      (int*)ox, (int*)oy, (int*)oz, (const int*)px, (const int*)py,
      (const int*)pz, (const int*)qx, (const int*)qy, (const int*)qz,
      (const int*)b3, batch);
  return (int)cudaGetLastError();
}

extern "C" int wp_dual_ladder_launch(void* ox, void* oy, void* oz,
                                     const void* tqx, const void* tqy,
                                     const void* tqz, const void* tgx,
                                     const void* tgy, const void* tgz,
                                     const void* digits, const void* b3,
                                     const void* one, int batch, int windows,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  wp_dual_ladder_kernel<<<wp_blocks(batch), WP_THREADS, 0,
                          (cudaStream_t)stream>>>(
      (int*)ox, (int*)oy, (int*)oz, (const int*)tqx, (const int*)tqy,
      (const int*)tqz, (const int*)tgx, (const int*)tgy, (const int*)tgz,
      (const unsigned*)digits, (const int*)b3, (const int*)one, batch,
      windows);
  return (int)cudaGetLastError();
}

// Blocks of each kernel (0: wp_add_general, 1: wp_dual_ladder) an SM
// holds at once, and the threads of a block: what chip_smoke.py reports
// as resident warps.
extern "C" int wp_point_occupancy(int ladder, int* threads, int* blocks) {
  *threads = WP_THREADS;
  if (ladder)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, wp_dual_ladder_kernel, WP_THREADS, 0);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, wp_add_general_kernel, WP_THREADS, 0);
}
