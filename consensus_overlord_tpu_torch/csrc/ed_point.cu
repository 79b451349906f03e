// Unified twisted-Edwards addition on edwards25519 for Hopper (sm_90a):
// the add-2008-hwcd-3 formula with a = −1 in extended coordinates
// (X : Y : Z : T), complete on this curve, so doubling is add(p, p) and
// every lane of a scalar-multiplication ladder runs the same straight
// line.  Two kernels share one body, `ed_add_body`:
//
// * ed_add_kernel, one addition per lane (the tree sum, mul8);
// * ed_ladder_kernel, the whole MSB-first ladder of ops/edwards.py
//   `scalar_mul_bits` in one launch: for each bit, acc2 = add(acc, acc),
//   then acc = bit ? add(acc2, p) : acc2.  Both adds run on every lane
//   and the choice is a predicated copy, as the plain version selects.
//   The accumulator stays in registers for all 2·nbits adds, p in
//   shared memory; the bits come packed, 32 to an int32 word, MSB
//   first.
//
// Replace the group law inside the JAX package's XLA jit
// consensus_overlord_tpu/crypto/ed25519_tpu.py `_ed_msm_is_identity`
// (its scan of ops/edwards.py `add`), which has no Pallas twin.  The body
// replays edwards.py `add` op for op over the 26-limb field of
// 2^255 − 19, every field op ending in the same planned reduction
// (fq_plans.h), so the outputs are bit-identical to the plain versions
// (ops/edwards.py add_plain, ladder_plain) and to the JAX package's.
//
// What bounds them on the H100: an add does 9 field multiplies (each 676
// convolution and about 780 fold multiply-adds) plus 9 add/sub
// reductions, about 13,400 integer multiply-adds a lane, against 1,248
// bytes a lane (ed_add) or 864 bytes for a whole 256-bit ladder: the
// multiply-adds bound both (chip_smoke.py `bound`).
//
// The design is the lane-group field core's (fq_group.cuh): G threads a
// lane, the coordinates as register slices, each thread reading and
// writing its own limbs of the (B, 26) rows.  The independent products
// run NP at a time in lockstep, each stage's operands made just before
// their chunk: (Y1−X1)(Y2−X2), (Y1+X1)(Y2+X2), T1·2d and 2Z1·Z2; then
// (T1·2d)·T2; then the four of the output.  A small NP keeps few values
// live, so that the ladder holds 16 warps an SM at 128 registers without
// spills (the warps, not the chains of one thread, hide the shuffle and
// shared-memory latency).  2d and 1 are (1, 26) rows the wrapper passes
// (ops/edwards.py's constants).

#include "fq_group.cuh"

// Each kernel's shape: threads a block, threads a lane (G), products in
// lockstep (NP), and the blocks __launch_bounds__ holds on an SM (1: no
// register cap).  The single add and the ladder differ: PERF.md §6 has
// the sweep that chose them (the first shape without spills that ran
// fastest, per kernel).
#define ED_ADD_THREADS 64
#define ED_ADD_G 8
#define ED_ADD_NP 4
#define ED_ADD_MIN_BLOCKS 1
#define ED_LADDER_THREADS 128
#define ED_LADDER_G 16
#define ED_LADDER_NP 1
#define ED_LADDER_MIN_BLOCKS 4  // 16 warps an SM at 128 registers

// o = p + q.  o may be p or q: every read of p and q comes first.  Each
// stage's operands are made just before their products (fq_mul_staged).
template <int G, int NP>
__device__ __forceinline__ void ed_add_body(const FqLane<G>& ln,
                                            Fe<G> (&o)[4], const Fe<G> (&p)[4],
                                            const Fe<G> (&q)[4],
                                            const Fe<G>& d2) {
  using F = Fe<G>;
  F r[4];
  fq_mul_staged<G, NP, 4>(ln, r, [&](auto k, F& u, F& v) {
    if constexpr (k.value == 0) {  // (Y1−X1)(Y2−X2)
      u = fq_sub(ln, p[1], p[0]);
      v = fq_sub(ln, q[1], q[0]);
    } else if constexpr (k.value == 1) {  // (Y1+X1)(Y2+X2)
      u = fq_add(ln, p[1], p[0]);
      v = fq_add(ln, q[1], q[0]);
    } else if constexpr (k.value == 2) {  // T1·2d
      u = p[3];
      v = d2;
    } else {  // 2Z1·Z2
      u = fq_add(ln, p[2], p[2]);
      v = q[2];
    }
  });
  const F a = r[0], b = r[1], d = r[3];
  F c;
  {
    const F u[1] = {r[2]}, v[1] = {q[3]};
    F t[1];
    fq_mul_n<G, 1>(ln, t, u, v);
    c = t[0];  // T1·2d·T2
  }
  const F e = fq_sub(ln, b, a);
  const F f = fq_sub(ln, d, c);
  const F g = fq_add(ln, d, c);
  const F h = fq_add(ln, b, a);
  fq_mul_staged<G, NP, 4>(ln, o, [&](auto k, F& u, F& v) {
    constexpr int i = k.value;  // E·F, G·H, F·G, E·H
    u = i == 1 ? g : i == 2 ? f : e;
    v = i == 0 ? f : i == 2 ? g : h;
  });
}

__global__ void __launch_bounds__(ED_ADD_THREADS, ED_ADD_MIN_BLOCKS)
    ed_add_kernel(int* ox, int* oy, int* oz, int* ot, const int* px,
                  const int* py, const int* pz, const int* pt,
                  const int* qx, const int* qy, const int* qz,
                  const int* qt, const int* d2row, int batch) {
  constexpr int G = ED_ADD_G, NP = ED_ADD_NP;
  using F = Fe<G>;
  __shared__ __align__(16) int
      scratch[ED_ADD_THREADS / G * FqGroup<G>::stride(NP)];
  FqLane<G> ln;
  fq_lane_init<G, NP>(ln, scratch);
  const long lane = fq_lane_now<ED_ADD_THREADS, G>();
  F p[4], q[4], d2;
  fq_load(p[0], px, lane, batch, ln.t);
  fq_load(p[1], py, lane, batch, ln.t);
  fq_load(p[2], pz, lane, batch, ln.t);
  fq_load(p[3], pt, lane, batch, ln.t);
  fq_load(q[0], qx, lane, batch, ln.t);
  fq_load(q[1], qy, lane, batch, ln.t);
  fq_load(q[2], qz, lane, batch, ln.t);
  fq_load(q[3], qt, lane, batch, ln.t);
  fq_load(d2, d2row, 0, 1, ln.t);
  F r[4];
  ed_add_body<G, NP>(ln, r, p, q, d2);
  int* const out[4] = {ox, oy, oz, ot};
  fq_store_now<ED_ADD_THREADS>(out, r, batch);
}

// Steps h = 0, 1, ... of the ladder alternate x + x (x = acc) and
// x + p (x = acc2); after an odd step acc = bit ? x + p : x.  One body
// in the loop keeps the code one add long; p waits in shared memory
// (each thread its own slots) so that only the accumulator is carried
// in registers.
__global__ void __launch_bounds__(ED_LADDER_THREADS, ED_LADDER_MIN_BLOCKS)
    ed_ladder_kernel(int* ox, int* oy, int* oz, int* ot, const int* px,
                     const int* py, const int* pz, const int* pt,
                     const unsigned* bits, const int* d2row,
                     const int* onerow, int batch, int nbits) {
  constexpr int G = ED_LADDER_G, NP = ED_LADDER_NP, T = ED_LADDER_THREADS;
  constexpr int L = FqGroup<G>::L;
  using F = Fe<G>;
  __shared__ __align__(16) int scratch[T / G * FqGroup<G>::stride(NP)];
  __shared__ int ps[4 * L][T];
  FqLane<G> ln;
  fq_lane_init<G, NP>(ln, scratch);
  const int words = (nbits + 31) / 32;
  {
    const long lane = fq_lane_now<T, G>();
    F p[4];
    fq_load(p[0], px, lane, batch, ln.t);
    fq_load(p[1], py, lane, batch, ln.t);
    fq_load(p[2], pz, lane, batch, ln.t);
    fq_load(p[3], pt, lane, batch, ln.t);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int s = 0; s < L; ++s) ps[k * L + s][threadIdx.x] = p[k].v[s];
    }
  }
  F d2, x[4];
  fq_load(d2, d2row, 0, 1, ln.t);
  fq_load(x[1], onerow, 0, 1, ln.t);  // the identity (0 : 1 : 1 : 0)
#pragma unroll
  for (int s = 0; s < L; ++s) x[0].v[s] = x[3].v[s] = 0;
  x[2] = x[1];
  unsigned word = 0;
#pragma unroll 1
  for (int h = 0; h < 2 * nbits; ++h) {
    const int i = h >> 1;
    F y[4];
    if (h & 1) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int s = 0; s < L; ++s) y[k].v[s] = ps[k * L + s][threadIdx.x];
      }
    } else {
      if ((i & 31) == 0) {
        const long lane = fq_lane_now<T, G>();
        word = lane < batch ? bits[lane * words + (i >> 5)] : 0u;
      }
      y[0] = x[0], y[1] = x[1], y[2] = x[2], y[3] = x[3];
    }
    F r[4];
    ed_add_body<G, NP>(ln, r, x, y, d2);
    const bool take = !(h & 1) || ((word >> (31 - (i & 31))) & 1u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int s = 0; s < L; ++s) x[k].v[s] = take ? r[k].v[s] : x[k].v[s];
    }
  }
  int* const out[4] = {ox, oy, oz, ot};
  fq_store_now<T>(out, x, batch);
}

static int ed_blocks(int batch, int lanes_per_block) {
  return (batch + lanes_per_block - 1) / lanes_per_block;
}

extern "C" int ed_add_launch(void* ox, void* oy, void* oz, void* ot,
                             const void* px, const void* py, const void* pz,
                             const void* pt, const void* qx, const void* qy,
                             const void* qz, const void* qt, const void* d2,
                             int batch, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = ed_blocks(batch, ED_ADD_THREADS / ED_ADD_G);
  ed_add_kernel<<<blocks, ED_ADD_THREADS, 0, (cudaStream_t)stream>>>(
      (int*)ox, (int*)oy, (int*)oz, (int*)ot, (const int*)px,
      (const int*)py, (const int*)pz, (const int*)pt, (const int*)qx,
      (const int*)qy, (const int*)qz, (const int*)qt, (const int*)d2,
      batch);
  return (int)cudaGetLastError();
}

extern "C" int ed_ladder_launch(void* ox, void* oy, void* oz, void* ot,
                                const void* px, const void* py,
                                const void* pz, const void* pt,
                                const void* bits, const void* d2,
                                const void* one, int batch, int nbits,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = ed_blocks(batch, ED_LADDER_THREADS / ED_LADDER_G);
  ed_ladder_kernel<<<blocks, ED_LADDER_THREADS, 0, (cudaStream_t)stream>>>(
      (int*)ox, (int*)oy, (int*)oz, (int*)ot, (const int*)px,
      (const int*)py, (const int*)pz, (const int*)pt,
      (const unsigned*)bits, (const int*)d2, (const int*)one, batch, nbits);
  return (int)cudaGetLastError();
}

// Blocks of each kernel (0: ed_add, 1: ed_ladder) an SM holds at once,
// and the threads of a block: what chip_smoke.py reports as resident
// warps.
extern "C" int ed_point_occupancy(int ladder, int* threads, int* blocks) {
  *threads = ladder ? ED_LADDER_THREADS : ED_ADD_THREADS;
  if (ladder)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, ed_ladder_kernel, ED_LADDER_THREADS, 0);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, ed_add_kernel, ED_ADD_THREADS, 0);
}
