// The lane-group Fq core, the one field core of the port's kernels
// (fq_mul.cu; g1_point.cu g1_add_kernel and g1_dbl_kernel; pairing.cu;
// ed_point.cu; wp_point.cu): G threads of one warp compute one lane
// together (G is a build-time constant per kernel: MUL_G, ADD_G, DBL_G,
// TOWER_G, ED_G, WP_G), so a batch of B lanes runs B·G threads
// and each thread's dependent chain is about G times shorter than with
// one thread per lane.
//
// Layout.  Thread t of a group owns L = ceil((n + 1) / G) slots of the
// lane (n = FQ_N limbs: 39 for BLS12-381, 26 for the 256-bit fields):
// element limbs and the low part of a wide accumulator at positions
// tL..tL+L−1 of W = G·L, and the high part at W+tL..W+tL+L−1.  Slots
// past limb n − 1 hold 0.  Every register array is indexed by compile-time
// slots only, so nothing lives in local memory.
//
// Multiply.  The operands' slices go to a per-lane scratch in shared
// memory (FqGroup::stride).  Thread t sums the columns of its own slots
// ("interleaved": tL+s and W+tL+s), so no shuffle is needed before the
// plan; it walks the rows in an order rotated by tL, which makes every
// b position it reads a compile-time constant and puts each product in
// its low or high column by a rule fixed per block of L rows
// (fq_conv_rotated): W·L multiply-adds a thread, all n² terms once.  (Summing contiguous columns instead and shuffling the sums to
// their owners was 1.4–1.6x slower at every G on the H100: PERF.md.)
//
// Reduction.  The plan's steps (fq_plans.h) run as templates: a carry
// step is one pass over the slots plus one __shfl_sync of each part's
// top carry to the next thread; a fold step broadcasts each high
// position h_r from its owner by __shfl_sync and each thread adds
// h_r · fold[r][j] at its own positions j, with fold row 0 in registers
// and the other rows read from device memory through the read-only
// cache, laid out per group size so a thread's slice is whole int4s.
// Several independent products (N) run their plans in lockstep, so
// their chains overlap and share the fold-row loads.
//
// Every thread of a block runs every instruction (lanes past the batch
// compute on zeros): the shuffles use the full warp mask.
#pragma once

#include "fq_field.cuh"

#define FQ_FULL_MASK 0xffffffffu

template <int G>
struct FqGroup {
  static_assert(G == 8 || G == 16, "lane groups of 8 or 16");
  static constexpr int L = (FQ_N + 1 + G - 1) / G;  // slots per part
  static constexpr int W = G * L;                   // low-part positions
  static constexpr int C = (L + 3) / 4;             // int4 per row slice
  static constexpr int ROWS = FQ_GEN_FOLD_ROWS;     // fold rows laid out
  // Scratch of one product: W ints of b, then BLEN ints of a twice over.
  static constexpr int BLEN = 2 * W;
  static constexpr int LANE_INTS = W + BLEN;
  static constexpr int FOLD_INT4 = ROWS * C * G;    // fold-row layout
  static_assert(2 * W >= FQ_MAXW, "the accumulator cannot hold a plan");
  static_assert(W % 4 == 0, "operand scratch must stay int4-aligned");
  // Shared ints a lane's scratch of np products takes: np · LANE_INTS
  // padded to an odd multiple of G, so the 32 / G lanes of a warp start
  // G banks apart and their threads' slot reads (stride L, odd) fall on
  // 32 different banks.  A multiple of 4: int4-aligned.
  __host__ __device__ static constexpr int stride(int np) {
    return np * LANE_INTS + (3 * G - np * LANE_INTS % (2 * G)) % (2 * G);
  }
};

// One element: this thread's L slots of a lane.
template <int G>
struct Fe {
  int v[FqGroup<G>::L];
};

// The fold rows in each group size's layout, [r][c][t] int4 (slot
// s = 4c + k of thread t is position tL + s; 0 past limb n − 1), built from
// g_fq by fq_set_tables and read through the read-only cache.
__device__ int4 g_fold4_8[FqGroup<8>::FOLD_INT4];
__device__ int4 g_fold4_16[FqGroup<16>::FOLD_INT4];

template <int G>
__device__ __forceinline__ int4* fq_fold4() {
  if constexpr (G == 8)
    return g_fold4_8;
  else
    return g_fold4_16;
}

template <int G>
__global__ void fq_fold_layout_kernel() {
  using Gp = FqGroup<G>;
  int* f = reinterpret_cast<int*>(fq_fold4<G>());
  for (int i = blockIdx.x * blockDim.x + threadIdx.x;
       i < Gp::FOLD_INT4 * 4; i += gridDim.x * blockDim.x) {
    const int k = i & 3, q = i >> 2;
    const int tt = q % G, c = (q / G) % Gp::C, r = q / (G * Gp::C);
    const int s = 4 * c + k, j = tt * Gp::L + s;
    f[i] = (s < Gp::L && j < FQ_N) ? g_fq[FQ_TAB_FOLD + r * FQ_N + j] : 0;
  }
}

// What a thread knows of its lane group.
template <int G>
struct FqLane {
  static constexpr int L = FqGroup<G>::L;
  int t;               // index in the group
  int f0[L];           // fold row 0 at this thread's positions
  int pad[L];          // subtraction pad at this thread's positions
  const int4* fold;    // fq_fold4<G>()
  int* a_s;            // the lane's operand scratch: NP × W ints,
  int* b_s;            // then NP × BLEN ints
};

// Lane set-up: the lane's operand scratch (only the group's own warp
// touches it, so no block barrier) and this thread's row-0 and pad
// slices.
template <int G, int NP>
__device__ __forceinline__ void fq_lane_init(FqLane<G>& ln, int* scratch) {
  using Gp = FqGroup<G>;
  ln.t = threadIdx.x & (G - 1);
  ln.fold = fq_fold4<G>();
  ln.a_s = scratch + (threadIdx.x / G) * Gp::stride(NP);
  ln.b_s = ln.a_s + NP * Gp::W;
#pragma unroll
  for (int s = 0; s < Gp::L; ++s) {
    const int j = ln.t * Gp::L + s;
    ln.f0[s] = j < FQ_N ? g_fq[FQ_TAB_FOLD + j] : 0;
    ln.pad[s] = j < FQ_N ? g_fq[FQ_TAB_PAD + j] : 0;
  }
}

// This thread's lane, read afresh from the special registers each call:
// the compiler cannot keep it, or addresses made from it, live across a
// long body (a ladder), where the registers go to the body; the reads
// are cheap where the lane is needed (loads and stores of the lane's
// rows).
__device__ __forceinline__ unsigned fq_tid_now() {
  unsigned tid;
#ifdef __CUDA_ARCH__
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
#else
  tid = threadIdx.x;
#endif
  return tid;
}

template <int THREADS, int G>
__device__ __forceinline__ long fq_lane_now() {
  unsigned cta;
#ifdef __CUDA_ARCH__
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(cta));
#else
  cta = blockIdx.x;
#endif
  return (long)cta * (THREADS / G) + fq_tid_now() / G;
}

template <int G>
__device__ __forceinline__ void fq_load(Fe<G>& e, const int* src, long lane,
                                        int batch, int t) {
#pragma unroll
  for (int s = 0; s < FqGroup<G>::L; ++s) {
    const int j = t * FqGroup<G>::L + s;
    e.v[s] = (lane < batch && j < FQ_N) ? src[lane * FQ_N + j] : 0;
  }
}

template <int G>
__device__ __forceinline__ void fq_store(int* dst, const Fe<G>& e,
                                         long lane, int batch, int t) {
#pragma unroll
  for (int s = 0; s < FqGroup<G>::L; ++s) {
    const int j = t * FqGroup<G>::L + s;
    if (lane < batch && j < FQ_N) dst[lane * FQ_N + j] = e.v[s];
  }
}

// Store a result of this thread's lane, its lane and slots read afresh.
template <int THREADS, int G, int K>
__device__ __forceinline__ void fq_store_now(int* const (&dst)[K],
                                             const Fe<G> (&e)[K], int batch) {
  const long lane = fq_lane_now<THREADS, G>();
  const int t = fq_tid_now() & (G - 1);
#pragma unroll
  for (int k = 0; k < K; ++k) fq_store(dst[k], e[k], lane, batch, t);
}

// N wide accumulators of one lane group, reduced in lockstep by a plan.
template <int G, int N>
struct FqGroupAcc {
  static constexpr int L = FqGroup<G>::L, W = FqGroup<G>::W,
                       C = FqGroup<G>::C;
  const FqLane<G>& ln;
  int (&lo)[N][L];
  int (&hi)[N][L];

  template <int K, int A, int WI, int WO>
  __device__ __forceinline__ void step() {
    if constexpr (K == FQ_STEP_CARRY) {
      carry<WO>();
    } else if constexpr (K == FQ_STEP_FOLD) {
      fold<A>();
    }  // pad: the new positions already hold zeros
  }

  // v[i] = (v[i] & mask) + (v[i−1] >> bits) over the WO live positions.
  // The high part takes part only when the width reaches it.
  template <int WO>
  __device__ __forceinline__ void carry() {
    constexpr bool HI = WO > W;
    const int prev = (ln.t + G - 1) & (G - 1);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      // Thread 0 gets thread G−1's low top carry: it enters position W.
      const int x = __shfl_sync(FQ_FULL_MASK, lo[n][L - 1] >> FQ_BITS,
                                prev, G);
      int y = 0;
      if constexpr (HI)
        y = __shfl_sync(FQ_FULL_MASK, hi[n][L - 1] >> FQ_BITS, prev, G);
#pragma unroll
      for (int s = L - 1; s > 0; --s)
        lo[n][s] = (lo[n][s] & FQ_MASK) + (lo[n][s - 1] >> FQ_BITS);
      lo[n][0] = (lo[n][0] & FQ_MASK) + (ln.t ? x : 0);
      if constexpr (HI) {
#pragma unroll
        for (int s = L - 1; s > 0; --s)
          hi[n][s] = (hi[n][s] & FQ_MASK) + (hi[n][s - 1] >> FQ_BITS);
        hi[n][0] = (hi[n][0] & FQ_MASK) + (ln.t ? y : x);
      }
    }
  }

  // lo += Σ_r h_r · fold[r] for the A positions h_r = v[n + r], which
  // are then consumed.  Fold rows are 0 past limb n − 1, so h positions in
  // the low part keep their value until they are cleared.
  // In the 256-bit fields' build, the h_r that lie in the low part
  // (n <= p < W) are read before any row is added: the rows add 0 there,
  // but read as they are updated they would chain each of those rows'
  // shuffle to the previous row's multiply-adds.  BLS12-381's build keeps
  // the fold as it was measured.
  static constexpr bool SNAP = FQ_N <= 32;

  template <int A>
  __device__ __forceinline__ void fold() {
    constexpr int S = SNAP ? (A < W - FQ_N ? A : W - FQ_N) : 0;
    int src[N][S > 0 ? S : 1];
#pragma unroll
    for (int n = 0; n < N; ++n) {
#pragma unroll
      for (int r = 0; r < S; ++r) src[n][r] = lo[n][(FQ_N + r) % L];
    }
#pragma unroll
    for (int r = 0; r < A; ++r) {
      const int p = FQ_N + r;
      const bool in_hi = p >= W;
      const int q = in_hi ? p - W : p;
      int f[L];
      if (r == 0) {
#pragma unroll
        for (int s = 0; s < L; ++s) f[s] = ln.f0[s];
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int4 w = __ldg(&ln.fold[(r * C + c) * G + ln.t]);
          const int wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (4 * c + k < L) f[4 * c + k] = wv[k];
        }
      }
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const int h = __shfl_sync(
            FQ_FULL_MASK,
            r < S ? src[n][r < S ? r : 0]
                  : in_hi ? hi[n][q % L] : lo[n][q % L],
            q / L, G);
#pragma unroll
        for (int s = 0; s < L; ++s) lo[n][s] += h * f[s];
      }
    }
#pragma unroll
    for (int n = 0; n < N; ++n) {
#pragma unroll
      for (int s = 0; s < L; ++s) {
        hi[n][s] = 0;
        if ((G - 1) * L + s >= FQ_N && ln.t * L + s >= FQ_N) lo[n][s] = 0;
      }
    }
  }
};

// The interleaved split, rows rotated: thread t walks the rows
// i = (tL + k) mod W for k = 0..W−1.  Column tL + s then takes
// b[(s − k) mod W] at step k, the same compile-time position for every
// thread of the group, from a cyclic copy of b (limbs n..W−1 are 0, so
// b[W + c − i] is the high column's operand).  A product belongs to the
// low column when i <= tL + s and to the high one otherwise: by slot in
// the first block of L steps, and for the block k in [qL, qL + L) to the
// high part while q < G − t, to the low part from there on.  W·L
// multiply-adds a thread, no zero terms but those of rows n..W−1.
template <int G, int N>
__device__ __forceinline__ void fq_conv_rotated(
    const FqLane<G>& ln, const Fe<G> (&a)[N], const Fe<G> (&b)[N],
    int (&lo)[N][FqGroup<G>::L], int (&hi)[N][FqGroup<G>::L]) {
  using Gp = FqGroup<G>;
  constexpr int L = Gp::L, W = Gp::W, BLEN = Gp::BLEN;
  const int t = ln.t;
  __syncwarp();  // the scratch is free: the warp is done reading it
#pragma unroll
  for (int n = 0; n < N; ++n) {
    int* a2 = ln.b_s + n * BLEN;  // a twice over: a2[j] = a[j mod W]
    int* bc = ln.a_s + n * W;
#pragma unroll
    for (int s = 0; s < L; ++s) {
      a2[t * L + s] = a[n].v[s];
      a2[W + t * L + s] = a[n].v[s];
      bc[t * L + s] = b[n].v[s];
    }
  }
  __syncwarp();

  int acc[N][L], w[N][L];  // acc: the high part until the switch
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int s = 0; s < L; ++s) {
      lo[n][s] = hi[n][s] = acc[n][s] = 0;
      w[n][s] = ln.a_s[n * W + s];  // b[(s − 0) mod W]
    }
  }
  int4 next[N];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int q = k / L, u = k % L;
    if (q >= 1 && u == 0) {
      const bool sw = q == G - t;  // from this block on, rows are low
#pragma unroll
      for (int n = 0; n < N; ++n) {
#pragma unroll
        for (int s = 0; s < L; ++s) {
          hi[n][s] = sw ? acc[n][s] : hi[n][s];
          acc[n][s] = sw ? lo[n][s] : acc[n][s];
        }
      }
    }
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int ak = ln.b_s[n * BLEN + t * L + k];
#pragma unroll
      for (int s = 0; s < L; ++s) {
        if (q == 0 && u <= s)
          lo[n][s] += ak * w[n][s];
        else
          acc[n][s] += ak * w[n][s];
      }
      if (k + 1 < W) {  // slide: b[(s − k − 1) mod W]
        if (k % 4 == 0)
          next[n] = *reinterpret_cast<const int4*>(ln.a_s + n * W + W - 4 -
                                                   k);
        const int nx[4] = {next[n].x, next[n].y, next[n].z, next[n].w};
#pragma unroll
        for (int s = L - 1; s > 0; --s) w[n][s] = w[n][s - 1];
        w[n][0] = nx[3 - k % 4];
      }
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int s = 0; s < L; ++s) {
      hi[n][s] = t ? hi[n][s] : acc[n][s];  // thread 0 never switches
      lo[n][s] = t ? acc[n][s] : lo[n][s];
    }
  }
}

// r[n] = a[n] · b[n] for N independent products, loose in, loose out.
template <int G, int N>
__device__ __forceinline__ void fq_mul_n(const FqLane<G>& ln,
                                         Fe<G> (&r)[N],
                                         const Fe<G> (&a)[N],
                                         const Fe<G> (&b)[N]) {
  constexpr int L = FqGroup<G>::L;
  int lo[N][L], hi[N][L];
  fq_conv_rotated<G, N>(ln, a, b, lo, hi);
  FqGroupAcc<G, N> acc{ln, lo, hi};
  fq_run_plan<FQ_PLAN_MUL>(acc);
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int s = 0; s < L; ++s) r[n].v[s] = lo[n][s];
  }
}

// r[k] = a_k · b_k for K independent products, NP at a time in lockstep
// (the lane scratch holds NP products).  ops(k, a, b) makes operand pair
// k (k an FqIndex<k>) just before its chunk, so only a
// chunk's operands are live: a smaller NP keeps fewer values in
// registers, a larger one overlaps more chains.  The products are the
// same whatever NP is.
template <int K>
struct FqIndex {
  static constexpr int value = K;
};

template <int O, int M0, int M, class Ops, class F>
__device__ __forceinline__ void fq_operands(Ops& ops, F (&x)[M], F (&y)[M]) {
  if constexpr (M0 < M) {
    ops(FqIndex<O + M0>{}, x[M0], y[M0]);
    fq_operands<O, M0 + 1, M>(ops, x, y);
  }
}

template <int G, int NP, int K, int O = 0, class Ops>
__device__ __forceinline__ void fq_mul_staged(const FqLane<G>& ln,
                                              Fe<G> (&r)[K], Ops&& ops) {
  if constexpr (O < K) {
    constexpr int M = K - O < NP ? K - O : NP;
    Fe<G> x[M], y[M], z[M];
    fq_operands<O, 0, M>(ops, x, y);
    fq_mul_n<G, M>(ln, z, x, y);
#pragma unroll
    for (int m = 0; m < M; ++m) r[O + m] = z[m];
    fq_mul_staged<G, NP, K, O + M>(ln, r, ops);
  }
}

// Reduce a low-part-only value by plan P.
template <int P, int G>
__device__ __forceinline__ Fe<G> fq_reduce_lo(const FqLane<G>& ln,
                                              const Fe<G>& v) {
  constexpr int L = FqGroup<G>::L;
  int lo[1][L], hi[1][L];
#pragma unroll
  for (int s = 0; s < L; ++s) {
    lo[0][s] = v.v[s];
    hi[0][s] = 0;
  }
  FqGroupAcc<G, 1> acc{ln, lo, hi};
  fq_run_plan<P>(acc);
  Fe<G> out;
#pragma unroll
  for (int s = 0; s < L; ++s) out.v[s] = lo[0][s];
  return out;
}

template <int G>
__device__ __forceinline__ Fe<G> fq_add(const FqLane<G>& ln, const Fe<G>& a,
                                        const Fe<G>& b) {
  Fe<G> v;
#pragma unroll
  for (int s = 0; s < FqGroup<G>::L; ++s) v.v[s] = a.v[s] + b.v[s];
  return fq_reduce_lo<FQ_PLAN_ADD2>(ln, v);
}

// a − b as a + (pad − b): pad is a multiple of p with every limb >= the
// loose bound, so each limb stays non-negative.
template <int G>
__device__ __forceinline__ Fe<G> fq_sub(const FqLane<G>& ln, const Fe<G>& a,
                                        const Fe<G>& b) {
  Fe<G> v;
#pragma unroll
  for (int s = 0; s < FqGroup<G>::L; ++s)
    v.v[s] = a.v[s] + (ln.pad[s] - b.v[s]);
  return fq_reduce_lo<FQ_PLAN_SUB>(ln, v);
}

// −a as (pad − a), the plain FieldSpec.neg with its NEG plan.
template <int G>
__device__ __forceinline__ Fe<G> fq_neg(const FqLane<G>& ln, const Fe<G>& a) {
  Fe<G> v;
#pragma unroll
  for (int s = 0; s < FqGroup<G>::L; ++s) v.v[s] = ln.pad[s] - a.v[s];
  return fq_reduce_lo<FQ_PLAN_NEG>(ln, v);
}

// a · k for a small constant k whose bound plan is P.
template <int P, int G>
__device__ __forceinline__ Fe<G> fq_small(const FqLane<G>& ln,
                                          const Fe<G>& a, int k) {
  Fe<G> v;
#pragma unroll
  for (int s = 0; s < FqGroup<G>::L; ++s) v.v[s] = a.v[s] * k;
  return fq_reduce_lo<P>(ln, v);
}

// C entries every library exports: table upload (the fold rows and the
// pad to device memory, then each group size's fold-row layout), its
// size, and error text for the codes the launch functions return.
extern "C" int fq_set_tables(const int* host_tab, int ints, int device) {
  if (ints != FQ_TAB_INTS) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyToSymbol(g_fq, host_tab, sizeof(int) * FQ_TAB_INTS);
  if (err != cudaSuccess) return (int)err;
  fq_fold_layout_kernel<8><<<8, 256>>>();
  fq_fold_layout_kernel<16><<<8, 256>>>();
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceSynchronize();
}

extern "C" int fq_table_ints() { return FQ_TAB_INTS; }

extern "C" const char* fq_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
