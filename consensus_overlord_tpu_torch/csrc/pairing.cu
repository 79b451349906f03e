// The BLS12-381 pairing tower for Hopper (sm_90a): three kernels that
// run the staged multi-pairing verdict of a verify flush on the card.
//
//   miller_product_kernel  per pair, the 63-step optimal-ate Miller loop
//                          on the twist (|x|'s bits fixed), the final
//                          conjugation, skipped pairs forced to one;
//   fq12_mul_kernel        a batch of Fq12 products (the pair tree);
//   final_exp_kernel       f -> f^(3(p^12-1)/r): the easy part with its Fq
//                          inversion, the five cyclotomic |x|-power
//                          chains, the Frobenius maps.
//
// They replace no Pallas kernel: the JAX package computes this stage as
// two XLA jits, consensus_overlord_tpu/ops/pairing.py _miller_product_fn
// (:203, the Miller loops and the tree product) and _final_is_one_fn
// (:211).  Written as PyTorch over the field kernels, one flush would be
// about 30,000 Fq products and 10^5 launches; here it is three to five.
//
// What bounds them on the H100: not bytes (a pair reads 1 KB) and not the
// card's int32 rates (a 2-pair flush is 30,047 products of 3,198
// multiply-adds, about 6 us at the card's IMAD rate), but latency: a
// final exponentiation has a multiply depth of 837 (the 489-product Fq
// inversion and 315 cyclotomic squarings among it) and a Miller loop one
// of 138, with the additions and subtractions that feed each product in
// between.  At P <= 5 pairs and one final exponentiation, one block per
// lane, the card is nearly empty.  The latency bound is the multiply
// depth times one dependent product of the field core on one warp,
// 0.97 us (tower_probe_kernel, no program table): 0.134 ms for a Miller
// loop, 0.81 ms for a final exponentiation.
//
// The design: each kernel is one interpreter over a *program*, the
// straight-line base-field op sequence (mul, add, sub, neg, mul_small by
// 2, 3, 8, 12) that the plain PyTorch tower (ops/pairing.py) runs,
// recorded, scheduled and register-allocated by ops/tower_program.py,
// and uploaded once per device as an int32 table (with its constants:
// one, zero, the Frobenius gammas).  Every op replays its own build-time
// reduction plan (fq_plans.h) on the lane-group field core
// (fq_group.cuh), so the outputs are bit-identical to the plain versions
// by construction.  A block of TOWER_THREADS threads computes one lane (a
// pair, or one Fq12 element).  Program format 2: every op belongs to one
// warp, and each warp walks its own stream of steps, a step being a pair
// of ops of one kind for its two lane groups (the field core shuffles
// with the full warp mask; a lone op is padded with a copy that writes a
// trash register).  Streams run in epochs: a warp reads a value another
// warp wrote only in a later epoch, so a block barrier falls only where
// an epoch ends (a flag in the step word) and a __syncwarp between steps
// carries values between the warp's two lane groups.  The scheduler keeps
// chains of ops on one warp and spreads each rank of products over all
// warps; the register allocator lets another warp reuse a register only
// after a barrier.  A warp stages 32 steps of its stream at a time in
// shared memory and prefetches the next 32 into L1, so no step waits on
// an L2 fetch of its words.  Values live in a register file in shared
// memory, each thread of a group owning its L limbs of every register, so
// loads and stores between ops need no shuffle.  The bit schedules are
// data: the source does not unroll the 63 Miller steps or the 315
// squarings, and builds in seconds.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md, from
// scripts/torch_pairing_breakdown.py): the per-stage design before this
// one spent 0.37 us on a dependent addition (0.08 us of it the add itself
// in registers, 0.022 us the block barrier, the rest two dependent
// program fetches, the register file and the loop) and 1.22 us on a
// product.  Here a step costs 0.24 us for an addition and 1.27 us for a
// product at one warp (2.4 us when all 16 warps multiply at once): the
// op itself in the interpreter, not its fetch or barrier, is what is
// left (PERF.md section 6).
// miller_product 1.35 ms at 2 and 5 pairs (1.47 before), final_exp
// 3.59 ms (3.74), fq12_mul 0.013 ms; 128 registers, no spills.

#include "fq_group.cuh"

#define TOWER_THREADS 512
#define TOWER_G 16  // threads per lane group
// Words before the register lists in a program table (layout:
// ops/tower_program.py Program).
#define TOWER_HEADER 8
// A step word: kind in bits 0-3, TOWER_BARRIER, the destination from
// bit 8.
#define TOWER_BARRIER 0x10
// Steps a warp stages at once in shared memory (one per lane).
#define TOWER_RING 32
enum {
  TOWER_OP_MUL = 0,
  TOWER_OP_ADD,
  TOWER_OP_SUB,
  TOWER_OP_NEG,
  TOWER_OP_SMALL2,
  TOWER_OP_SMALL3,
  TOWER_OP_SMALL8,
  TOWER_OP_SMALL12,
  TOWER_OP_NOP,
};

using TGp = FqGroup<TOWER_G>;
using TFe = Fe<TOWER_G>;
constexpr int TOWER_GROUPS = TOWER_THREADS / TOWER_G;
constexpr int TOWER_WARPS = TOWER_THREADS / 32;
constexpr int TOWER_SCRATCH_INTS = TOWER_GROUPS * TGp::stride(1);

extern __shared__ __align__(16) int tower_smem[];
// Each warp's next TOWER_RING steps, staged from its stream.
__shared__ int4 tower_ring[TOWER_WARPS][TOWER_RING];

// A lane's Fq inputs: input k is element k of in[0] (in_fq[0] elements a
// lane), then of in[1], and so on.
struct TowerIO {
  const int* in[4];
  int in_fq[4];
};

__device__ __forceinline__ void reg_load(TFe& e, const int* regs, int r,
                                         int t) {
  const int* p = regs + r * TGp::W + t * TGp::L;
#pragma unroll
  for (int s = 0; s < TGp::L; ++s) e.v[s] = p[s];
}

__device__ __forceinline__ void reg_store(int* regs, int r, const TFe& e,
                                          int t) {
  int* p = regs + r * TGp::W + t * TGp::L;
#pragma unroll
  for (int s = 0; s < TGp::L; ++s) p[s] = e.v[s];
}

// One op of a step on this thread's lane group.
__device__ __forceinline__ void tower_op(const FqLane<TOWER_G>& ln,
                                         int* regs, int w0, int w1) {
  const int kind = w0 & 0xf, dst = w0 >> 8;
  const int ra = w1 & 0xffff, rb = (int)((unsigned)w1 >> 16);
  TFe a, b, r;
  reg_load(a, regs, ra, ln.t);
  switch (kind) {
    case TOWER_OP_MUL: {
      reg_load(b, regs, rb, ln.t);
      TFe x[1] = {a}, y[1] = {b}, z[1];
      fq_mul_n<TOWER_G, 1>(ln, z, x, y);
      r = z[0];
      break;
    }
    case TOWER_OP_ADD:
      reg_load(b, regs, rb, ln.t);
      r = fq_add(ln, a, b);
      break;
    case TOWER_OP_SUB:
      reg_load(b, regs, rb, ln.t);
      r = fq_sub(ln, a, b);
      break;
    case TOWER_OP_NEG:
      r = fq_neg(ln, a);
      break;
    case TOWER_OP_SMALL2:
      r = fq_small<FQ_PLAN_SMALL2>(ln, a, 2);
      break;
    case TOWER_OP_SMALL3:
      r = fq_small<FQ_PLAN_SMALL3>(ln, a, 3);
      break;
    case TOWER_OP_SMALL8:
      r = fq_small<FQ_PLAN_SMALL8>(ln, a, 8);
      break;
    default:  // TOWER_OP_SMALL12
      r = fq_small<FQ_PLAN_SMALL12>(ln, a, 12);
      break;
  }
  reg_store(regs, dst, r, ln.t);
}

// The barrier that ends an epoch.  The warps reach it at different steps
// of their own streams (each the same number of times), so it is the
// non-aligned form, which a block may reach from diverged code.
__device__ __forceinline__ void tower_epoch_barrier() {
#ifdef __CUDA_ARCH__
  asm volatile("barrier.sync 0;" ::: "memory");
#else
  __syncthreads();
#endif
}

__device__ __forceinline__ void tower_prefetch(const void* p) {
#ifdef __CUDA_ARCH__
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
#endif
}

// Run `prog` on lane `lane` (one block): load the constants and the
// lane's inputs into the register file, walk this warp's stream of
// steps, store the outputs ((lane, outputs, 39) int32; Fq12 one where
// `skip`).
__device__ __forceinline__ void tower_run(const int* __restrict__ prog,
                                          const int* __restrict__ consts,
                                          const TowerIO& io, int* out,
                                          long lane, bool skip) {
  constexpr int L = TGp::L;
  int* regs = tower_smem + TOWER_SCRATCH_INTS;
  FqLane<TOWER_G> ln;
  fq_lane_init<TOWER_G, 1>(ln, tower_smem);
  const int group = threadIdx.x / TOWER_G, t = ln.t;
  if (__ldg(prog + 2) != TOWER_WARPS) __trap();  // built for other warps
  const int nc = __ldg(prog + 3), ni = __ldg(prog + 4),
            no = __ldg(prog + 5);
  const int* const_regs = prog + TOWER_HEADER;
  const int* in_regs = const_regs + nc;
  const int* out_regs = in_regs + ni;
  const int* starts = out_regs + no;
  const int steps_at = TOWER_HEADER + nc + ni + no + TOWER_WARPS + 1;
  const int4* steps =
      reinterpret_cast<const int4*>(prog + ((steps_at + 3) & ~3));

  for (int c = group; c < nc; c += TOWER_GROUPS) {
    int* dst = regs + __ldg(const_regs + c) * TGp::W + t * L;
#pragma unroll
    for (int s = 0; s < L; ++s) {
      const int j = t * L + s;
      dst[s] = j < FQ_N ? __ldg(consts + c * FQ_N + j) : 0;
    }
  }
  for (int k = group; k < ni; k += TOWER_GROUPS) {
    const int* src = nullptr;
    int kk = k;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if (!src) {
        if (kk < io.in_fq[p])
          src = io.in[p] + (lane * io.in_fq[p] + kk) * FQ_N;
        else
          kk -= io.in_fq[p];
      }
    }
    int* dst = regs + __ldg(in_regs + k) * TGp::W + t * L;
#pragma unroll
    for (int s = 0; s < L; ++s) {
      const int j = t * L + s;
      dst[s] = j < FQ_N ? src[j] : 0;
    }
  }
  __syncthreads();

  // This warp's stream: step i is steps[i], lane group 0's two words
  // then lane group 1's, both of one kind and one barrier flag, so the
  // warp never diverges.  The warp stages TOWER_RING steps at a time in
  // shared memory (one coalesced load, a step per lane) and prefetches
  // the next TOWER_RING into L1 behind it, so a step reads its words from
  // shared memory and no program fetch waits on an L2 round trip; nothing
  // of the stream stays live in registers across an op.  A value crosses
  // lane groups of the warp at the __syncwarp after each step, and warps
  // at the barrier that ends each epoch.
  const int warp = threadIdx.x / 32, wl = threadIdx.x & 31;
  const int end = __ldg(starts + warp + 1);
  int4* ring = tower_ring[warp];
  for (int base = __ldg(starts + warp); base < end; base += TOWER_RING) {
    if (base + wl < end) ring[wl] = __ldg(steps + base + wl);
    if (base + TOWER_RING + wl < end)
      tower_prefetch(steps + base + TOWER_RING + wl);
    __syncwarp();
    const int n = min(TOWER_RING, end - base);
    for (int i = 0; i < n; ++i) {
      const int4 st = ring[i];
      const int w0 = group & 1 ? st.z : st.x, w1 = group & 1 ? st.w : st.y;
      if ((w0 & 0xf) != TOWER_OP_NOP) tower_op(ln, regs, w0, w1);
      if (w0 & TOWER_BARRIER)
        tower_epoch_barrier();
      else
        __syncwarp();
    }
  }

  for (int k = group; k < no; k += TOWER_GROUPS) {
    const int* src = regs + __ldg(out_regs + k) * TGp::W + t * L;
#pragma unroll
    for (int s = 0; s < L; ++s) {
      const int j = t * L + s;
      if (j < FQ_N)
        out[(lane * no + k) * FQ_N + j] = skip ? (k == 0 && j == 0) : src[s];
    }
  }
}

__global__ void __launch_bounds__(TOWER_THREADS)
    miller_product_kernel(int* out, TowerIO io,
                          const unsigned char* __restrict__ skip,
                          const int* __restrict__ prog,
                          const int* __restrict__ consts) {
  tower_run(prog, consts, io, out, blockIdx.x, skip && skip[blockIdx.x]);
}

// fq12_mul_kernel and final_exp_kernel take `skip` too (null from their
// launches), so the three compile to one code and one register
// allocation.
__global__ void __launch_bounds__(TOWER_THREADS)
    fq12_mul_kernel(int* out, TowerIO io,
                    const unsigned char* __restrict__ skip,
                    const int* __restrict__ prog,
                    const int* __restrict__ consts) {
  tower_run(prog, consts, io, out, blockIdx.x, skip && skip[blockIdx.x]);
}

__global__ void __launch_bounds__(TOWER_THREADS)
    final_exp_kernel(int* out, TowerIO io,
                     const unsigned char* __restrict__ skip,
                     const int* __restrict__ prog,
                     const int* __restrict__ consts) {
  tower_run(prog, consts, io, out, blockIdx.x, skip && skip[blockIdx.x]);
}

// A measuring kernel of the field core with no program table (only
// chip_smoke.py and the breakdown script launch it): one block of
// `threads` threads, each lane group running k dependent ops of one lane
// in a compiled loop, x <- x*y (mode 0) or x <- x + y (mode 1), or the
// block running k barriers (mode 2).  Its product time at one warp, times
// a program's multiply depth, is the pairing kernels' latency bound.
__global__ void __launch_bounds__(TOWER_THREADS)
    tower_probe_kernel(int* out, const int* __restrict__ x0,
                       const int* __restrict__ y0, int mode, int k) {
  FqLane<TOWER_G> ln;
  fq_lane_init<TOWER_G, 1>(ln, tower_smem);
  TFe x, y;
  fq_load(x, x0, 0, 1, ln.t);
  fq_load(y, y0, 0, 1, ln.t);
  if (mode == 0) {
    for (int i = 0; i < k; ++i) {
      TFe a[1] = {x}, b[1] = {y}, z[1];
      fq_mul_n<TOWER_G, 1>(ln, z, a, b);
      x = z[0];
    }
  } else if (mode == 1) {
    for (int i = 0; i < k; ++i) x = fq_add(ln, x, y);
  } else {
    for (int i = 0; i < k; ++i) __syncthreads();
  }
  if (threadIdx.x < TOWER_G) fq_store(out, x, 0, 1, ln.t);
}

// Dynamic shared memory of a launch: the lane groups' multiply scratch,
// then `nregs` registers of W ints.  Above 48 KB the kernel must be
// allowed it first.
template <class K>
static cudaError_t tower_prepare(K kernel, int nregs, size_t* bytes) {
  *bytes = sizeof(int) * ((size_t)TOWER_SCRATCH_INTS +
                          (size_t)nregs * TGp::W);
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*bytes);
}

static TowerIO tower_io(const void* a, int na, const void* b, int nb,
                        const void* c, int nc, const void* d, int nd) {
  TowerIO io;
  io.in[0] = (const int*)a, io.in[1] = (const int*)b;
  io.in[2] = (const int*)c, io.in[3] = (const int*)d;
  io.in_fq[0] = na, io.in_fq[1] = nb, io.in_fq[2] = nc, io.in_fq[3] = nd;
  return io;
}

extern "C" int miller_product_launch(void* out, const void* px,
                                     const void* py, const void* qx,
                                     const void* qy, const void* skip,
                                     const void* prog, const void* consts,
                                     int nregs, int pairs, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  size_t bytes;
  err = tower_prepare(miller_product_kernel, nregs, &bytes);
  if (err != cudaSuccess) return (int)err;
  miller_product_kernel<<<pairs, TOWER_THREADS, bytes,
                          (cudaStream_t)stream>>>(
      (int*)out, tower_io(px, 1, py, 1, qx, 2, qy, 2),
      (const unsigned char*)skip, (const int*)prog, (const int*)consts);
  return (int)cudaGetLastError();
}

extern "C" int fq12_mul_launch(void* out, const void* x, const void* y,
                               const void* prog, const void* consts,
                               int nregs, int batch, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  size_t bytes;
  err = tower_prepare(fq12_mul_kernel, nregs, &bytes);
  if (err != cudaSuccess) return (int)err;
  fq12_mul_kernel<<<batch, TOWER_THREADS, bytes, (cudaStream_t)stream>>>(
      (int*)out, tower_io(x, 12, y, 12, nullptr, 0, nullptr, 0), nullptr,
      (const int*)prog, (const int*)consts);
  return (int)cudaGetLastError();
}

extern "C" int final_exp_launch(void* out, const void* f, const void* prog,
                                const void* consts, int nregs, int batch,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  size_t bytes;
  err = tower_prepare(final_exp_kernel, nregs, &bytes);
  if (err != cudaSuccess) return (int)err;
  final_exp_kernel<<<batch, TOWER_THREADS, bytes, (cudaStream_t)stream>>>(
      (int*)out, tower_io(f, 12, nullptr, 0, nullptr, 0, nullptr, 0),
      nullptr, (const int*)prog, (const int*)consts);
  return (int)cudaGetLastError();
}

extern "C" int tower_probe_launch(void* out, const void* x, const void* y,
                                  int mode, int k, int threads, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (threads < 32 || threads > TOWER_THREADS || threads % 32)
    return (int)cudaErrorInvalidValue;
  size_t bytes;
  err = tower_prepare(tower_probe_kernel, 0, &bytes);
  if (err != cudaSuccess) return (int)err;
  tower_probe_kernel<<<1, threads, bytes, (cudaStream_t)stream>>>(
      (int*)out, (const int*)x, (const int*)y, mode, k);
  return (int)cudaGetLastError();
}
