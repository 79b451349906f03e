// BLS12-381's G2 group law for Hopper (sm_90a): the complete projective
// addition and the dedicated a=0 doubling over Fq2 = Fq[u]/(u² + 1), each
// one kernel, on the twist y² = x³ + 4(1 + u).
//
// Replace no Pallas kernel: the JAX package runs this group law inside
// its XLA jits (consensus_overlord_tpu/ops/curve.py CurveOps.add and
// CurveOps.dbl over ops/fq2.py Fq2Ops, in crypto/tpu_provider.py
// verify_round_fn, _g2_sum_rows, _g2_validate and _build_g2_tables).
//
// g2_add_kernel is Renes–Costello–Batina 2016 Algorithm 7 with a = 0,
// g2_dbl_kernel Algorithm 9, with 3b = 12(1 + u), as ops/curve.py
// CurveOps.add / CurveOps.dbl compute them: every output coordinate is
// the same element of Fq as the plain version's (bls12381_groups.G2.
// add_plain / dbl_plain), in another limb form (a plain 10-bit split of
// a value below 2p, every limb below 1024), so the two agree after
// FieldSpec.strict, not limb for limb.
//
// Layout: each coordinate is a contiguous (B, 2, 39) int32 tensor of
// loose limbs, so lane i's c0 is row 2i and its c1 row 2i + 1 of a
// (2B, 39) view.
//
// The design (ops/g2_words.py, csrc/fp381_words.cuh): inside, Fq is 12
// words of 32 bits with hardware carry chains; every output component
// is a sum of up to four word products reduced once (Montgomery), and
// one more product by R⁴ mod p restores the scale that the
// unconverted inputs leave (R⁻³ on every output of these homogeneous
// formulas).  A kernel is a program of five phases (LOAD, MUL, LIN,
// LIN, OUT) whose tables ops/g2_words.py generates into g2_words.h and
// replays on Python integers in the CPU tests.  A block serves 32 lanes
// with WARPS warps: the jobs of a phase (12 entries, 12 stage-1 sums,
// 10 linear steps and 6 outputs in the add; 6, 8, 8 and 6 in the
// doubling) go round-robin to its warps, each warp running one job for
// its 32 lanes, so no thread of a warp diverges from the others.  The
// values between phases live in the block's shared memory, one slot of
// 12 words a value and lane, word-major with the 32 lanes innermost (a
// warp's access of one word falls on 32 banks).
//
// What bounds them on the H100: an add reads six and writes three
// coordinates (2,808 bytes a lane) and runs 66 word products (24
// multiply-adds a word row), 24 REDCs and 22 quotient steps as written;
// the function needs at least 42 word products (36 Karatsuba Fq
// products and the 6 corrections), the 24 REDCs and the 12 entries'
// quotient steps: about 19,800 IMADs and 6,100 ALU ops a lane; a
// doubling 38 products as written, at least 30 products and 20 REDCs,
// about 15,000 and 3,900 (ops/g2_words.py bound_ops, chip_smoke.py
// `bound`).  The multiply-adds bound both.  ptxas issues each multiply-add with carry as an IMAD and
// an IADD3 that carries through a predicate, and interleaves the rows'
// chains itself (splitting each product into two accumulators, low and
// high halves, gained nothing and cost 35 registers).  With 12 warps a
// block (8 in the doubling) a thread runs at most one job a phase, so
// one lane's add is 9 products and 3 REDCs long; 64 registers and 97 KB
// of shared memory a block (the doubling's 52 KB) let an SM hold 24 warps
// of the add and 32 of the doubling.

#include "fq_group.cuh"  // the libraries' C entries (fq_set_tables, ...)
#include "fp381_words.cuh"

// Each kernel's shape: warps a block of 32 lanes ("threads a lane").  A
// sweep sed-edits them in copies of the package.
#define G2_ADD_WARPS 12
#define G2_DBL_WARPS 8

#define G2_LANES 32  // lanes of a block
// A tile of the block's lanes' coordinates in shared memory (all six
// inputs of the add, three of the doubling), in the order of device
// memory ((coordinate, lane, component, limb)), each lane's 78 ints
// padded to 79 so that the 32 lanes' reads of one limb fall on 32 banks:
// the inputs come in through it and the outputs go out through it, each
// read or written whole by all the block's threads on consecutive ints.
// (Read and written limb by limb from each lane's thread, 32 sectors a
// warp instruction, the coordinates took 41% of the add's time at 8,192
// lanes and 53% of the doubling's.)
#define G2_ROW (2 * FPW_LIMBS)  // ints of a lane's coordinate
#define G2_ROW_PAD (G2_ROW + 1)

// The programs: LOAD (dst slot, input coordinate·2 + component); MUL and
// OUT (dst, terms, correction, 0, then (a, b, neg) × 4); LIN (dst, a, b,
// m, neg, k, 0, 0): see ops/g2_words.py header_text.
__constant__ int c_add_load[G2W_ADD_LOADS][2] = G2W_ADD_LOAD_TABLE;
__constant__ int c_add_mul[G2W_ADD_MULS][16] = G2W_ADD_MUL_TABLE;
__constant__ int c_add_lin[G2W_ADD_LIN1 + G2W_ADD_LIN2][8] = G2W_ADD_LIN_TABLE;
__constant__ int c_add_out[G2W_ADD_OUTS][16] = G2W_ADD_OUT_TABLE;
__constant__ int c_dbl_load[G2W_DBL_LOADS][2] = G2W_DBL_LOAD_TABLE;
__constant__ int c_dbl_mul[G2W_DBL_MULS][16] = G2W_DBL_MUL_TABLE;
__constant__ int c_dbl_lin[G2W_DBL_LIN1 + G2W_DBL_LIN2][8] = G2W_DBL_LIN_TABLE;
__constant__ int c_dbl_out[G2W_DBL_OUTS][16] = G2W_DBL_OUT_TABLE;
__constant__ uint32_t c_corr[FPW_NCORR][FPW_N] = FPW_CORR_TABLE;

// Dynamic shared memory of a block: the program's slots, then the tile of
// `coords` coordinates.
__host__ __device__ constexpr int g2_smem_bytes(int slots, int coords) {
  return 4 * (slots * FPW_N * G2_LANES + coords * G2_LANES * G2_ROW_PAD);
}
extern __shared__ uint32_t g2_smem[];

struct AddProgram {
  static constexpr int WARPS = G2_ADD_WARPS, SLOTS = G2W_ADD_SLOTS,
                       LOADS = G2W_ADD_LOADS, MULS = G2W_ADD_MULS,
                       LIN1 = G2W_ADD_LIN1, LIN2 = G2W_ADD_LIN2,
                       OUTS = G2W_ADD_OUTS;
  static __device__ int load(int j, int f) { return c_add_load[j][f]; }
  static __device__ int mul(int j, int f) { return c_add_mul[j][f]; }
  static __device__ int lin(int j, int f) { return c_add_lin[j][f]; }
  static __device__ int out(int j, int f) { return c_add_out[j][f]; }
};

struct DblProgram {
  static constexpr int WARPS = G2_DBL_WARPS, SLOTS = G2W_DBL_SLOTS,
                       LOADS = G2W_DBL_LOADS, MULS = G2W_DBL_MULS,
                       LIN1 = G2W_DBL_LIN1, LIN2 = G2W_DBL_LIN2,
                       OUTS = G2W_DBL_OUTS;
  static __device__ int load(int j, int f) { return c_dbl_load[j][f]; }
  static __device__ int mul(int j, int f) { return c_dbl_mul[j][f]; }
  static __device__ int lin(int j, int f) { return c_dbl_lin[j][f]; }
  static __device__ int out(int j, int f) { return c_dbl_out[j][f]; }
};

// A kernel's coordinates: the inputs (x1, y1, z1[, x2, y2, z2]) and the
// outputs (x3, y3, z3).
struct G2Io {
  const int* in[6];
  int* out[3];
};

__device__ __forceinline__ void g2_get(uint32_t (&x)[FPW_N],
                                       const uint32_t* sm, int slot, int l) {
#pragma unroll
  for (int k = 0; k < FPW_N; ++k) x[k] = sm[(slot * FPW_N + k) * G2_LANES + l];
}

__device__ __forceinline__ void g2_put(uint32_t* sm, int slot, int l,
                                       const uint32_t (&x)[FPW_N]) {
#pragma unroll
  for (int k = 0; k < FPW_N; ++k) sm[(slot * FPW_N + k) * G2_LANES + l] = x[k];
}

// A MUL or OUT job's value: REDC of the sum of its terms a·b, each b
// replaced by 2p − b where the term is negative.
template <class Prog, bool OUT>
__device__ __forceinline__ void g2_sum(uint32_t (&x)[FPW_N],
                                       const uint32_t* sm, int l, int j) {
  auto field = [&](int f) { return OUT ? Prog::out(j, f) : Prog::mul(j, f); };
  uint32_t d[2 * FPW_N];
#pragma unroll
  for (int k = 0; k < 2 * FPW_N; ++k) d[k] = 0;
  const int terms = field(1);
#pragma unroll 1
  for (int t = 0; t < terms; ++t) {
    uint32_t a[FPW_N], b[FPW_N];
    g2_get(a, sm, field(4 + 3 * t), l);
    g2_get(b, sm, field(5 + 3 * t), l);
    if (field(6 + 3 * t)) fpw_neg<1>(b);
    fpw_mac(d, a, b);
  }
  fpw_redc(x, d);
}

// A LIN job: k·(a + t), t = 0, m·b or N − m·b, then a quotient step.
template <class Prog>
__device__ __forceinline__ void g2_lin(uint32_t (&x)[FPW_N],
                                       const uint32_t* sm, int l, int j) {
  uint32_t s[FPW_N], v[FPW_N + 1];
  g2_get(s, sm, Prog::lin(j, 1), l);
  const int b = Prog::lin(j, 2), m = Prog::lin(j, 3), neg = Prog::lin(j, 4);
  const uint32_t k = (uint32_t)Prog::lin(j, 5);
  if (b >= 0) {
    uint32_t t[FPW_N];
    g2_get(t, sm, b, l);
    if (m > 1) {
      fpw_small(v, t, (uint32_t)m);  // below 2^384: the top word is 0
#pragma unroll
      for (int i = 0; i < FPW_N; ++i) t[i] = v[i];
    }
    if (neg == 1)
      fpw_neg<1>(t);
    else if (neg == 2)
      fpw_neg<2>(t);
    fpw_add(s, t);
  }
  if (k > 1) {
    fpw_small(v, s, k);
  } else {
#pragma unroll
    for (int i = 0; i < FPW_N; ++i) v[i] = s[i];
    v[FPW_N] = 0;
  }
  fpw_reduce13(x, v);
}

// The block's part of the first COORDS coordinates (device memory,
// `ptrs`) to or from the tile: the THREADS threads of the block on
// consecutive ints of the block's live lanes, one int of every
// coordinate in flight a thread (two or four measured slower).  The tile
// rows of lanes past the batch are neither read nor written.
template <bool STORE, int THREADS, int COORDS, class T, int N>
__device__ __forceinline__ void g2_tile_copy(int* tile, T const (&ptrs)[N],
                                             int batch) {
  constexpr int INTS = G2_LANES * G2_ROW;
  const long base = (long)blockIdx.x * INTS;
  const long left = (long)batch * G2_ROW - base;  // ints of live lanes
  const int live = left < INTS ? (int)left : INTS;
#pragma unroll 1
  for (int r = threadIdx.x; r < live; r += THREADS) {
    const int t = r / G2_ROW * G2_ROW_PAD + r % G2_ROW;  // in coordinate 0
    int v[COORDS];
#pragma unroll
    for (int c = 0; c < COORDS; ++c) {
      if constexpr (STORE)
        ptrs[c][base + r] = tile[c * G2_LANES * G2_ROW_PAD + t];
      else
        v[c] = ptrs[c][base + r];
    }
    if constexpr (!STORE) {
#pragma unroll
      for (int c = 0; c < COORDS; ++c)
        tile[c * G2_LANES * G2_ROW_PAD + t] = v[c];
    }
  }
}

// One block's 32 lanes through the program, phase by phase.
template <class Prog>
__device__ __forceinline__ void g2_program(const G2Io& io, int batch) {
  uint32_t* const sm = g2_smem;
  int* const tile = (int*)(g2_smem + Prog::SLOTS * FPW_N * G2_LANES);
  const int l = threadIdx.x % G2_LANES, warp = threadIdx.x / G2_LANES;
  constexpr int THREADS = Prog::WARPS * G2_LANES;
  // This lane's row of input or output component `io_index` in the tile.
  auto row = [&](int io_index) {
    return tile + (io_index / 2 * G2_LANES + l) * G2_ROW_PAD +
           (io_index & 1) * FPW_LIMBS;
  };
  g2_tile_copy<false, THREADS, Prog::LOADS / 2>(tile, io.in, batch);
  __syncthreads();
#pragma unroll 1
  for (int j = warp; j < Prog::LOADS; j += Prog::WARPS) {
    uint32_t x[FPW_N];
    fpw_entry(x, row(Prog::load(j, 1)));
    g2_put(sm, Prog::load(j, 0), l, x);
  }
  __syncthreads();
#pragma unroll 1
  for (int j = warp; j < Prog::MULS; j += Prog::WARPS) {
    uint32_t x[FPW_N];
    g2_sum<Prog, false>(x, sm, l, j);
    g2_put(sm, Prog::mul(j, 0), l, x);
  }
  __syncthreads();
#pragma unroll 1
  for (int j = warp; j < Prog::LIN1; j += Prog::WARPS) {
    uint32_t x[FPW_N];
    g2_lin<Prog>(x, sm, l, j);
    g2_put(sm, Prog::lin(j, 0), l, x);
  }
  __syncthreads();
#pragma unroll 1
  for (int j = Prog::LIN1 + warp; j < Prog::LIN1 + Prog::LIN2;
       j += Prog::WARPS) {
    uint32_t x[FPW_N];
    g2_lin<Prog>(x, sm, l, j);
    g2_put(sm, Prog::lin(j, 0), l, x);
  }
  __syncthreads();
#pragma unroll 1
  for (int j = warp; j < Prog::OUTS; j += Prog::WARPS) {
    uint32_t x[FPW_N], c[FPW_N], d[2 * FPW_N];
    g2_sum<Prog, true>(x, sm, l, j);
    const int corr = Prog::out(j, 2), dst = Prog::out(j, 0);
#pragma unroll
    for (int k = 0; k < FPW_N; ++k) {
      c[k] = c_corr[corr][k];
      d[k] = d[FPW_N + k] = 0;
    }
    fpw_mac(d, x, c);
    fpw_redc(x, d);
    fpw_exit(row(dst), x);
  }
  __syncthreads();
  g2_tile_copy<true, THREADS, 3>(tile, io.out, batch);
}

__global__ void __launch_bounds__(G2_ADD_WARPS * G2_LANES)
    g2_add_kernel(int* ox, int* oy, int* oz, const int* px, const int* py,
                  const int* pz, const int* qx, const int* qy,
                  const int* qz, int batch) {
  const G2Io io = {{px, py, pz, qx, qy, qz}, {ox, oy, oz}};
  g2_program<AddProgram>(io, batch);
}

__global__ void __launch_bounds__(G2_DBL_WARPS * G2_LANES)
    g2_dbl_kernel(int* ox, int* oy, int* oz, const int* px, const int* py,
                  const int* pz, int batch) {
  const G2Io io = {{px, py, pz, px, py, pz}, {ox, oy, oz}};
  g2_program<DblProgram>(io, batch);
}

static int g2_blocks(int batch) {
  return (batch + G2_LANES - 1) / G2_LANES;
}

// Lets `kernel` take `bytes` of dynamic shared memory on `device` (above
// 48 KB only so), once per device.
template <class K>
static cudaError_t g2_allow_smem(K kernel, int bytes, int device,
                                 bool (&done)[64]) {
  if (device >= 0 && device < 64 && done[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && device >= 0 && device < 64) done[device] = true;
  return err;
}
static bool g2_add_smem_set[64], g2_dbl_smem_set[64];
#define G2_ADD_SMEM g2_smem_bytes(G2W_ADD_SLOTS, G2W_ADD_LOADS / 2)
#define G2_DBL_SMEM g2_smem_bytes(G2W_DBL_SLOTS, G2W_DBL_LOADS / 2)

extern "C" int g2_add_launch(void* ox, void* oy, void* oz, const void* px,
                             const void* py, const void* pz, const void* qx,
                             const void* qy, const void* qz, int batch,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = g2_allow_smem(g2_add_kernel, G2_ADD_SMEM, device, g2_add_smem_set);
  if (err != cudaSuccess) return (int)err;
  g2_add_kernel<<<g2_blocks(batch), G2_ADD_WARPS * G2_LANES, G2_ADD_SMEM,
                  (cudaStream_t)stream>>>(
      (int*)ox, (int*)oy, (int*)oz, (const int*)px, (const int*)py,
      (const int*)pz, (const int*)qx, (const int*)qy, (const int*)qz, batch);
  return (int)cudaGetLastError();
}

extern "C" int g2_dbl_launch(void* ox, void* oy, void* oz, const void* px,
                             const void* py, const void* pz, int batch,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = g2_allow_smem(g2_dbl_kernel, G2_DBL_SMEM, device, g2_dbl_smem_set);
  if (err != cudaSuccess) return (int)err;
  g2_dbl_kernel<<<g2_blocks(batch), G2_DBL_WARPS * G2_LANES, G2_DBL_SMEM,
                  (cudaStream_t)stream>>>(
      (int*)ox, (int*)oy, (int*)oz, (const int*)px, (const int*)py,
      (const int*)pz, batch);
  return (int)cudaGetLastError();
}

// Blocks of each kernel (0: g2_add, 1: g2_dbl) an SM holds at once, and
// the threads of a block: what chip_smoke.py reports as resident warps.
extern "C" int g2_point_occupancy(int dbl, int* threads, int* blocks) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  *threads = (dbl ? G2_DBL_WARPS : G2_ADD_WARPS) * G2_LANES;
  if (dbl) {
    err = g2_allow_smem(g2_dbl_kernel, G2_DBL_SMEM, device, g2_dbl_smem_set);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, g2_dbl_kernel, *threads, G2_DBL_SMEM);
  }
  err = g2_allow_smem(g2_add_kernel, G2_ADD_SMEM, device, g2_add_smem_set);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, g2_add_kernel, *threads, G2_ADD_SMEM);
}
