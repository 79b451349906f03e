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
// final exponentiation is a chain of 837 dependent product stages (the
// 489-product Fq inversion and 315 cyclotomic squarings among them) and
// a Miller loop one of 138, each stage followed by the additions and
// subtractions that feed the next.  At P <= 5 pairs and one final
// exponentiation, one block per lane, the card is nearly empty; what
// counts is the time of one dependent stage (1.22 us for a product).
// Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md): miller_product
// 1.46 ms at 2 and 5 pairs against a 0.168 ms latency bound, final_exp
// 3.73 ms against 1.02 ms, fq12_mul 0.0148 ms; 128 registers, no spills.
// The linear stages between the product stages (1,345 of the Miller
// loop's 1,483 stages, 3,561 of the final exponentiation's 4,398) take
// most of that time.
//
// The design: each kernel is one interpreter over a *program*, the
// straight-line base-field op sequence (mul, add, sub, neg, mul_small by
// 2, 3, 8, 12) that the plain PyTorch tower (ops/pairing.py) runs,
// recorded, scheduled into stages and register-allocated by
// ops/tower_program.py, and uploaded once per device as an int32 table
// (with its constants: one, zero, the Frobenius gammas).  Every op
// replays its own build-time reduction plan (fq_plans.h) on the
// lane-group field core (fq_group.cuh), so the outputs are bit-identical
// to the plain versions by construction.  A block of TOWER_THREADS
// threads computes one lane (a pair, or one Fq12 element): its
// TOWER_THREADS / TOWER_G lane groups take a stage's ops round-robin,
// with a block barrier between stages.  Values live in a register file
// in shared memory, each thread of a group owning its L limbs of every
// register, so loads and stores between ops need no shuffle.  The
// scheduler runs every multiply of one rank (multiplies left to the
// output) in one stage and the linear ops as late as their consumers
// allow, which keeps the multiply stages at their minimum and the
// register file small.  A stage lists its ops by kind, each kind padded
// to an even count, so the two lane groups of a warp always run the same
// op kind: the field core's shuffles use the full warp mask.  The bit
// schedules are data, walked by a loop: the source does not unroll the
// 63 Miller steps or the 315 squarings, and builds in seconds.

#include "fq_group.cuh"

#define TOWER_THREADS 512
#define TOWER_G 16  // threads per lane group
// Words before the register lists in a program table (layout:
// ops/tower_program.py Program).
#define TOWER_HEADER 7
enum {
  TOWER_OP_MUL = 0,
  TOWER_OP_ADD,
  TOWER_OP_SUB,
  TOWER_OP_NEG,
  TOWER_OP_SMALL2,
  TOWER_OP_SMALL3,
  TOWER_OP_SMALL8,
  TOWER_OP_SMALL12,
};

using TGp = FqGroup<TOWER_G>;
using TFe = Fe<TOWER_G>;
constexpr int TOWER_GROUPS = TOWER_THREADS / TOWER_G;
constexpr int TOWER_SCRATCH_INTS = TOWER_GROUPS * TGp::stride(1);

extern __shared__ __align__(16) int tower_smem[];

// A lane's Fq inputs: input k is element k of in[0] (in_fq[0] elements a
// lane), then of in[1], and so on.
struct TowerIO {
  const int* in[4];
  int in_fq[4];
};

// −x as (pad − x), the plain FieldSpec.neg with its NEG plan.
template <int G>
__device__ __forceinline__ Fe<G> fq_neg(const FqLane<G>& ln, const Fe<G>& a) {
  Fe<G> v;
#pragma unroll
  for (int s = 0; s < FqGroup<G>::L; ++s) v.v[s] = ln.pad[s] - a.v[s];
  return fq_reduce_lo<FQ_PLAN_NEG>(ln, v);
}

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

// One op of a stage on this thread's lane group.
__device__ __forceinline__ void tower_op(const FqLane<TOWER_G>& ln,
                                         int* regs, int w0, int w1) {
  const int kind = w0 & 0xff, dst = w0 >> 8;
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

// Run `prog` on lane `lane` (one block): load the constants and the
// lane's inputs into the register file, walk the stages, store the
// outputs ((lane, outputs, 39) int32; Fq12 one where `skip`).
__device__ __forceinline__ void tower_run(const int* __restrict__ prog,
                                          const int* __restrict__ consts,
                                          const TowerIO& io, int* out,
                                          long lane, bool skip) {
  constexpr int L = TGp::L;
  int* regs = tower_smem + TOWER_SCRATCH_INTS;
  FqLane<TOWER_G> ln;
  fq_lane_init<TOWER_G, 1>(ln, tower_smem);
  const int group = threadIdx.x / TOWER_G, t = ln.t;
  const int nstages = __ldg(prog + 2), nc = __ldg(prog + 3),
            ni = __ldg(prog + 4), no = __ldg(prog + 5);
  const int* const_regs = prog + TOWER_HEADER;
  const int* in_regs = const_regs + nc;
  const int* out_regs = in_regs + ni;
  const int* starts = out_regs + no;
  const int* ops = starts + nstages + 1;

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

  // Stage starts are even and each op kind of a stage comes in an even
  // count, so lane groups 2w and 2w + 1 (one warp) run the same kind and
  // the same number of ops.
  for (int st = 0; st < nstages; ++st) {
    const int end = __ldg(starts + st + 1);
    for (int i = __ldg(starts + st) + group; i < end; i += TOWER_GROUPS)
      tower_op(ln, regs, __ldg(ops + 2 * i), __ldg(ops + 2 * i + 1));
    __syncthreads();
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
  tower_run(prog, consts, io, out, blockIdx.x, skip[blockIdx.x] != 0);
}

__global__ void __launch_bounds__(TOWER_THREADS)
    fq12_mul_kernel(int* out, TowerIO io, const int* __restrict__ prog,
                    const int* __restrict__ consts) {
  tower_run(prog, consts, io, out, blockIdx.x, false);
}

__global__ void __launch_bounds__(TOWER_THREADS)
    final_exp_kernel(int* out, TowerIO io, const int* __restrict__ prog,
                     const int* __restrict__ consts) {
  tower_run(prog, consts, io, out, blockIdx.x, false);
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
      (int*)out, tower_io(x, 12, y, 12, nullptr, 0, nullptr, 0),
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
      (const int*)prog, (const int*)consts);
  return (int)cudaGetLastError();
}
