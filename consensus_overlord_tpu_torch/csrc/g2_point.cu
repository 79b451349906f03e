// BLS12-381's G2 group law for Hopper (sm_90a): the complete projective
// addition and the dedicated a=0 doubling over Fq2 = Fq[u]/(u² + 1), each
// one kernel.  The twins of g1_point.cu on the same lane-group field core
// (fq_group.cuh), for the twist y² = x³ + 4(1 + u).
//
// Replace no Pallas kernel: the JAX package runs this group law inside
// its XLA jits (consensus_overlord_tpu/ops/curve.py CurveOps.add and
// CurveOps.dbl over ops/fq2.py Fq2Ops, in crypto/tpu_provider.py
// verify_round_fn, _g2_sum_rows, _g2_validate and _build_g2_tables).  In
// the port, without these kernels, every G2 add was 3 stacked fq_mul
// launches and some 340 PyTorch ops of Fq2 glue.
//
// g2_add_kernel is Renes–Costello–Batina 2016 Algorithm 7 with a = 0
// (12 Fq2 products), g2_dbl_kernel Algorithm 9 (8).  Each replays the
// straight line of ops/curve.py CurveOps.add / CurveOps.dbl op for op,
// with every Fq2 product the Karatsuba form of ops/fq2.py Fq2Ops.mul
// (three Fq products, (a0 + a1)(b0 + b1) among them, then a0b0 − a1b1
// and (a0 + a1)(b0 + b1) − (a0b0 + a1b1)), 3b = 12(1 + u) applied as
// Fq2Ops.mul_small_xi (12(a0 − a1), 12(a0 + a1)), and every Fq op ending
// in its planned reduction (fq_plans.h).  So the outputs are
// bit-identical to the plain versions (bls12381_groups.G2.add_plain /
// dbl_plain) and to the JAX package's.
//
// Layout: each coordinate is a contiguous (B, 2, 39) int32 tensor, so
// lane i's c0 is row 2i and its c1 row 2i + 1 of a (2B, 39) view.
//
// What bounds them on the H100: an add reads six and writes three
// coordinates (2,808 bytes a lane) and does 36 Fq products and 104
// add/sub/small-multiple reductions, about 123,000 integer multiply-adds
// a lane; a doubling 24 products, 56 reductions and 1,872 bytes, about
// 81,000.  The multiply-adds bound both (chip_smoke.py `bound`: 0.0604
// and 0.0397 ms at 8,192 lanes).
//
// The design is g1_point.cu's lane-group core (G threads a lane, each
// thread owning L limbs of every element), with one change that the G2
// state forces: the values that live across products (the inputs, a
// stage's products, the next stage's operands: up to 12 Fq2 elements, 72
// registers a thread at G = 16) wait in a thread-private stash in shared
// memory (Fq2Stash), and only the chunk in flight is in registers.  The
// independent Fq products of a stage (18 in each of the add's two
// stages; 12, 6 and 6 in the doubling's three) run NP at a time in
// lockstep, whole Fq2 products to a chunk, each chunk's operands read
// from the stash just before it and its Fq2 results written back just
// after; each output is stored as soon as its products are done.  Held
// in registers, the same bodies took 255 registers and spilled 568 bytes
// (the add) and 36 (the doubling); loaded from device memory for each
// chunk instead, 204 and 171 registers at 8 warps an SM and 1.5x slower
// (PERF.md §6, the sweep).  With the stash: 167 registers, no spill, 12
// warps an SM (the shared memory of the add's 64-thread block, 32 KB, and
// the registers both allow 6 blocks).

#include "fq_group.cuh"

// Each kernel's shape: threads a block, threads a lane (G), Fq products
// in lockstep (NP: whole Fq2 products, so a multiple of 3), and the
// blocks __launch_bounds__ holds on an SM (1: no register cap).  A
// sweep sed-edits them in copies of the package (PERF.md §6 has the
// sweep that chose them).
#define G2_ADD_THREADS 64
#define G2_ADD_G 16
#define G2_ADD_NP 6
#define G2_ADD_MIN_BLOCKS 1
#define G2_DBL_THREADS 64
#define G2_DBL_G 16
#define G2_DBL_NP 6
#define G2_DBL_MIN_BLOCKS 1
static_assert(G2_ADD_NP % 3 == 0 && G2_DBL_NP % 3 == 0,
              "a chunk holds whole Fq2 products");

// One Fq2 element: this thread's slices of both components.
template <int G>
struct Fe2 {
  Fe<G> c0, c1;
};

template <int G>
__device__ __forceinline__ Fe2<G> fq2_add(const FqLane<G>& ln,
                                          const Fe2<G>& a, const Fe2<G>& b) {
  return {fq_add(ln, a.c0, b.c0), fq_add(ln, a.c1, b.c1)};
}

template <int G>
__device__ __forceinline__ Fe2<G> fq2_sub(const FqLane<G>& ln,
                                          const Fe2<G>& a, const Fe2<G>& b) {
  return {fq_sub(ln, a.c0, b.c0), fq_sub(ln, a.c1, b.c1)};
}

// a · k for a small constant k whose bound plan is P.
template <int P, int G>
__device__ __forceinline__ Fe2<G> fq2_small(const FqLane<G>& ln,
                                            const Fe2<G>& a, int k) {
  return {fq_small<P>(ln, a.c0, k), fq_small<P>(ln, a.c1, k)};
}

// a · 12(1 + u) = 12(a0 − a1) + 12(a0 + a1)u: 3b of the twist
// (Fq2Ops.mul_small_xi(a, 12)).
template <int G>
__device__ __forceinline__ Fe2<G> fq2_mul_b3(const FqLane<G>& ln,
                                             const Fe2<G>& a) {
  return {fq_small<FQ_PLAN_SMALL12>(ln, fq_sub(ln, a.c0, a.c1), 12),
          fq_small<FQ_PLAN_SMALL12>(ln, fq_add(ln, a.c0, a.c1), 12)};
}

// The Fq operand pairs of Fq2 products O + M0 .. O + M − 1 of a chunk:
// a0·b0, a1·b1, (a0 + a1)(b0 + b1) each.
template <int G, int O, int M0, int M, class Ops>
__device__ __forceinline__ void fq2_operands(const FqLane<G>& ln, Ops& ops,
                                             Fe<G> (&x)[3 * M],
                                             Fe<G> (&y)[3 * M]) {
  if constexpr (M0 < M) {
    Fe2<G> a, b;
    ops(FqIndex<O + M0>{}, a, b);
    x[3 * M0] = a.c0;
    y[3 * M0] = b.c0;
    x[3 * M0 + 1] = a.c1;
    y[3 * M0 + 1] = b.c1;
    x[3 * M0 + 2] = fq_add(ln, a.c0, a.c1);
    y[3 * M0 + 2] = fq_add(ln, b.c0, b.c1);
    fq2_operands<G, O, M0 + 1, M>(ln, ops, x, y);
  }
}

// Products O + M0 .. O + M − 1 of a chunk from its Fq products z:
// a0b0 − a1b1 and (a0 + a1)(b0 + b1) − (a0b0 + a1b1), each to sink.
template <int G, int O, int M0, int M, class Sink>
__device__ __forceinline__ void fq2_sink(const FqLane<G>& ln, Sink& sink,
                                         const Fe<G> (&z)[3 * M]) {
  if constexpr (M0 < M) {
    const Fe2<G> r = {
        fq_sub(ln, z[3 * M0], z[3 * M0 + 1]),
        fq_sub(ln, z[3 * M0 + 2], fq_add(ln, z[3 * M0], z[3 * M0 + 1]))};
    sink(FqIndex<O + M0>{}, r);
    fq2_sink<G, O, M0 + 1, M>(ln, sink, z);
  }
}

// a_k · b_k for K independent Fq2 products, NP / 3 at a time as NP Fq
// products in lockstep.  ops(k, a, b) makes operand pair k (k an
// FqIndex<k>) just before its chunk; sink(k, r) takes product k just
// after it.
template <int G, int NP, int K, int O = 0, class Ops, class Sink>
__device__ __forceinline__ void fq2_mul_staged(const FqLane<G>& ln, Ops&& ops,
                                               Sink&& sink) {
  if constexpr (O < K) {
    constexpr int M = K - O < NP / 3 ? K - O : NP / 3;
    Fe<G> x[3 * M], y[3 * M], z[3 * M];
    fq2_operands<G, O, 0, M>(ln, ops, x, y);
    fq_mul_n<G, 3 * M>(ln, z, x, y);
    fq2_sink<G, O, 0, M>(ln, sink, z);
    fq2_mul_staged<G, NP, K, O + M>(ln, ops, sink);
  }
}

// Thread-private Fq2 slots in shared memory for the values that live
// across chunks (the inputs, the products of a stage, the operands of
// the next): slot position k of thread x at int k·T + x, so a warp's
// access of one position falls on 32 banks.  Only registers of the
// chunk in flight stay live; the __syncwarp of each product keeps the
// compiler from carrying a slot's value in registers past it.
template <int T, int G>
struct Fq2Stash {
  static constexpr int L = FqGroup<G>::L;
  int* base;  // the block's stash + threadIdx.x

  __device__ __forceinline__ void put(int slot, const Fe2<G>& e) const {
#pragma unroll
    for (int s = 0; s < L; ++s) {
      base[(2 * slot * L + s) * T] = e.c0.v[s];
      base[((2 * slot + 1) * L + s) * T] = e.c1.v[s];
    }
  }

  __device__ __forceinline__ Fe2<G> get(int slot) const {
    Fe2<G> e;
#pragma unroll
    for (int s = 0; s < L; ++s) {
      e.c0.v[s] = base[(2 * slot * L + s) * T];
      e.c1.v[s] = base[((2 * slot + 1) * L + s) * T];
    }
    return e;
  }

  // Ints a block's stash of `slots` slots takes.
  __host__ __device__ static constexpr int ints(int slots) {
    return slots * 2 * L * T;
  }
};

// This thread's slices of its lane's (B, 2, n) coordinate (rows 2·lane
// and 2·lane + 1), the lane and slots read afresh from the special
// registers.
template <int THREADS, int G>
__device__ __forceinline__ Fe2<G> fq2_load_now(const int* src, int batch) {
  const long lane = fq_lane_now<THREADS, G>();
  const int t = fq_tid_now() & (G - 1);
  Fe2<G> e;
  fq_load(e.c0, src, 2 * lane, 2 * batch, t);
  fq_load(e.c1, src, 2 * lane + 1, 2 * batch, t);
  return e;
}

// Store a result of this thread's lane, its lane and slots read afresh.
template <int THREADS, int G>
__device__ __forceinline__ void fq2_store_now(int* dst, const Fe2<G>& e,
                                              int batch) {
  const long lane = fq_lane_now<THREADS, G>();
  const int t = fq_tid_now() & (G - 1);
  fq_store(dst, e.c0, 2 * lane, 2 * batch, t);
  fq_store(dst, e.c1, 2 * lane + 1, 2 * batch, t);
}

// Stash slots of the add: its inputs, then stage 1's products; after
// stage 1 the first six hold stage 2's operands.
enum { A_X1, A_Y1, A_Z1, A_X2, A_Y2, A_Z2, A_M0, A_SLOTS = A_M0 + 6 };
enum { A_T3 = 0, A_T4, A_Y3, A_3T0, A_Z3, A_T1 };

// One output of the add from its two products a0·b0 and a1·b1 (operand
// slots), their difference (SUB) or sum, stored at once.
template <int T, int NP, int A0, int A1, int B0, int B1, bool SUB, int G>
__device__ __forceinline__ void g2_add_output(const FqLane<G>& ln,
                                              const Fq2Stash<T, G>& st,
                                              int* dst, int batch) {
  Fe2<G> r[2];
  fq2_mul_staged<G, NP, 2>(
      ln,
      [&](auto k, Fe2<G>& a, Fe2<G>& b) {
        a = st.get(k.value == 0 ? A0 : A1);
        b = st.get(k.value == 0 ? B0 : B1);
      },
      [&](auto k, const Fe2<G>& v) { r[k.value] = v; });
  fq2_store_now<T>(dst, SUB ? fq2_sub(ln, r[0], r[1])
                            : fq2_add(ln, r[0], r[1]), batch);
}

__global__ void __launch_bounds__(G2_ADD_THREADS, G2_ADD_MIN_BLOCKS)
    g2_add_kernel(int* ox, int* oy, int* oz, const int* px, const int* py,
                  const int* pz, const int* qx, const int* qy,
                  const int* qz, int batch) {
  constexpr int G = G2_ADD_G, NP = G2_ADD_NP, T = G2_ADD_THREADS;
  using F2 = Fe2<G>;
  using Stash = Fq2Stash<T, G>;
  __shared__ __align__(16) int scratch[T / G * FqGroup<G>::stride(NP)];
  __shared__ int stash[Stash::ints(A_SLOTS)];
  FqLane<G> ln;
  fq_lane_init<G, NP>(ln, scratch);
  const Stash st{stash + threadIdx.x};
  {
    const int* const src[6] = {px, py, pz, qx, qy, qz};
#pragma unroll
    for (int k = 0; k < 6; ++k) st.put(A_X1 + k, fq2_load_now<T, G>(src[k], batch));
  }
  // x1x2, y1y2, z1z2, (x1+y1)(x2+y2), (y1+z1)(y2+z2), (x1+z1)(x2+z2)
  fq2_mul_staged<G, NP, 6>(
      ln,
      [&](auto k, F2& a, F2& b) {
        constexpr int i = k.value;
        if constexpr (i < 3) {
          a = st.get(A_X1 + i);
          b = st.get(A_X2 + i);
        } else {
          constexpr int u = i == 4 ? 1 : 0, v = i == 3 ? 1 : 2;
          a = fq2_add(ln, st.get(A_X1 + u), st.get(A_X1 + v));
          b = fq2_add(ln, st.get(A_X2 + u), st.get(A_X2 + v));
        }
      },
      [&](auto k, const F2& r) { st.put(A_M0 + k.value, r); });
  {
    const F2 t0 = st.get(A_M0), t1 = st.get(A_M0 + 1), t2 = st.get(A_M0 + 2);
    // x1y2 + x2y1, y1z2 + y2z1, x1z2 + x2z1
    st.put(A_T3, fq2_sub(ln, st.get(A_M0 + 3), fq2_add(ln, t0, t1)));
    st.put(A_T4, fq2_sub(ln, st.get(A_M0 + 4), fq2_add(ln, t1, t2)));
    st.put(A_Y3, fq2_mul_b3(
                     ln, fq2_sub(ln, st.get(A_M0 + 5), fq2_add(ln, t0, t2))));
    st.put(A_3T0, fq2_small<FQ_PLAN_SMALL3>(ln, t0, 3));
    const F2 b3_t2 = fq2_mul_b3(ln, t2);
    st.put(A_Z3, fq2_add(ln, t1, b3_t2));
    st.put(A_T1, fq2_sub(ln, t1, b3_t2));
  }
  // Each output's two products, then the output, stored at once:
  // t3·t1 − t4·y3, t1·z3 + y3·3t0, z3·t4 + 3t0·t3.
  g2_add_output<T, NP, A_T3, A_T4, A_T1, A_Y3, true>(ln, st, ox, batch);
  g2_add_output<T, NP, A_T1, A_Y3, A_Z3, A_3T0, false>(ln, st, oy, batch);
  g2_add_output<T, NP, A_Z3, A_3T0, A_T4, A_T3, false>(ln, st, oz, batch);
}

// Stash slots of the doubling: its inputs, then stage 1's products;
// later stages reuse the inputs' slots.
enum { D_X, D_Y, D_Z, D_YY, D_YZ, D_ZZ, D_XY, D_SLOTS };
enum { D_Z3 = 0, D_T2, D_X3 };

__global__ void __launch_bounds__(G2_DBL_THREADS, G2_DBL_MIN_BLOCKS)
    g2_dbl_kernel(int* ox, int* oy, int* oz, const int* px, const int* py,
                  const int* pz, int batch) {
  constexpr int G = G2_DBL_G, NP = G2_DBL_NP, T = G2_DBL_THREADS;
  using F2 = Fe2<G>;
  using Stash = Fq2Stash<T, G>;
  __shared__ __align__(16) int scratch[T / G * FqGroup<G>::stride(NP)];
  __shared__ int stash[Stash::ints(D_SLOTS)];
  FqLane<G> ln;
  fq_lane_init<G, NP>(ln, scratch);
  const Stash st{stash + threadIdx.x};
  st.put(D_X, fq2_load_now<T, G>(px, batch));
  st.put(D_Y, fq2_load_now<T, G>(py, batch));
  st.put(D_Z, fq2_load_now<T, G>(pz, batch));
  // Y², YZ, Z², XY
  fq2_mul_staged<G, NP, 4>(
      ln,
      [&](auto k, F2& a, F2& b) {
        constexpr int i = k.value;
        a = st.get(i == 2 ? D_Z : i == 3 ? D_X : D_Y);
        b = st.get(i == 1 || i == 2 ? D_Z : D_Y);
      },
      [&](auto k, const F2& r) { st.put(D_YY + k.value, r); });
  st.put(D_Z3, fq2_small<FQ_PLAN_SMALL8>(ln, st.get(D_YY), 8));  // 8Y²
  st.put(D_T2, fq2_mul_b3(ln, st.get(D_ZZ)));                     // 3bZ²
  // 24bY²Z², 8Y³Z
  fq2_mul_staged<G, NP, 2>(
      ln,
      [&](auto k, F2& a, F2& b) {
        a = st.get(k.value == 0 ? D_T2 : D_YZ);
        b = st.get(D_Z3);
      },
      [&](auto k, const F2& r) {
        if constexpr (k.value == 0)
          st.put(D_X3, r);
        else
          fq2_store_now<T>(oz, r, batch);
      });
  {
    const F2 t0 = st.get(D_YY), t2 = st.get(D_T2);
    st.put(D_Z3, fq2_add(ln, t0, t2));  // Y² + 3bZ² (z3's slot is free)
    st.put(D_YY, fq2_sub(ln, t0, fq2_small<FQ_PLAN_SMALL3>(ln, t2, 3)));
  }                                     // Y² − 9bZ²
  // (Y²−9bZ²)(Y²+3bZ²) + 24bY²Z², 2XY(Y² − 9bZ²)
  fq2_mul_staged<G, NP, 2>(
      ln,
      [&](auto k, F2& a, F2& b) {
        a = st.get(D_YY);
        b = st.get(k.value == 0 ? D_Z3 : D_XY);
      },
      [&](auto k, const F2& r) {
        if constexpr (k.value == 0)
          fq2_store_now<T>(oy, fq2_add(ln, r, st.get(D_X3)), batch);
        else
          fq2_store_now<T>(ox, fq2_small<FQ_PLAN_SMALL2>(ln, r, 2), batch);
      });
}

static int g2_blocks(int batch, int lanes_per_block) {
  return (batch + lanes_per_block - 1) / lanes_per_block;
}

extern "C" int g2_add_launch(void* ox, void* oy, void* oz, const void* px,
                             const void* py, const void* pz, const void* qx,
                             const void* qy, const void* qz, int batch,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = g2_blocks(batch, G2_ADD_THREADS / G2_ADD_G);
  g2_add_kernel<<<blocks, G2_ADD_THREADS, 0, (cudaStream_t)stream>>>(
      (int*)ox, (int*)oy, (int*)oz, (const int*)px, (const int*)py,
      (const int*)pz, (const int*)qx, (const int*)qy, (const int*)qz, batch);
  return (int)cudaGetLastError();
}

extern "C" int g2_dbl_launch(void* ox, void* oy, void* oz, const void* px,
                             const void* py, const void* pz, int batch,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = g2_blocks(batch, G2_DBL_THREADS / G2_DBL_G);
  g2_dbl_kernel<<<blocks, G2_DBL_THREADS, 0, (cudaStream_t)stream>>>(
      (int*)ox, (int*)oy, (int*)oz, (const int*)px, (const int*)py,
      (const int*)pz, batch);
  return (int)cudaGetLastError();
}

// Blocks of each kernel (0: g2_add, 1: g2_dbl) an SM holds at once, and
// the threads of a block: what chip_smoke.py reports as resident warps.
extern "C" int g2_point_occupancy(int dbl, int* threads, int* blocks) {
  *threads = dbl ? G2_DBL_THREADS : G2_ADD_THREADS;
  if (dbl)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, g2_dbl_kernel, G2_DBL_THREADS, 0);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, g2_add_kernel, G2_ADD_THREADS, 0);
}
