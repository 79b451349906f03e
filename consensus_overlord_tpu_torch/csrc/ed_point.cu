// Unified twisted-Edwards addition on edwards25519 for Hopper (sm_90a),
// one kernel: the add-2008-hwcd-3 formula with a = −1 in extended
// coordinates (X : Y : Z : T), complete on this curve, so doubling is
// add(p, p) and every lane of a scalar-multiplication ladder runs the
// same straight line.
//
// Replaces the group law inside the JAX package's XLA jit
// consensus_overlord_tpu/crypto/ed25519_tpu.py `_ed_msm_is_identity`
// (its scan of ops/edwards.py `add`), which has no Pallas twin.  It
// replays edwards.py `add` op for op over the 26-limb field of
// 2^255 − 19, every field op ending in the same planned reduction
// (fq_plans.h), so its outputs are bit-identical to the plain version
// (ops/edwards.py add_plain) and to the JAX package's.
//
// What bounds it on the H100: a lane reads eight and writes four (B, 26)
// int32 coordinates (1,248 bytes) and does 9 field multiplies (each
// 676 convolution and about 780 fold multiply-adds) plus 11 add/sub
// reductions: about 13,400 integer multiply-adds a lane, so the
// multiply-adds bound it (chip_smoke.py `bound`).
//
// The design is g1_point.cu's on the lane-group field core
// (fq_group.cuh): G = 8 threads a lane (ED_G; L = 4 limbs a thread for
// 26 limbs), the coordinates as register slices, each thread reading and
// writing its own limbs of the (B, 26) rows.  The independent products
// run as interleaved multiplies in three stages: (Y1−X1)(Y2−X2),
// (Y1+X1)(Y2+X2), T1·2d and 2Z1·Z2; then (T1·2d)·T2, alone because it
// needs the first stage; then the four of the output.  2d is a (1, 26)
// row the wrapper passes (ops/edwards.py's constant).

#include "fq_group.cuh"

#define ED_THREADS 64
#define ED_G 8  // threads per lane

__global__ void __launch_bounds__(ED_THREADS)
    ed_add_kernel(int* ox, int* oy, int* oz, int* ot, const int* px,
                  const int* py, const int* pz, const int* pt,
                  const int* qx, const int* qy, const int* qz,
                  const int* qt, const int* d2row, int batch) {
  constexpr int G = ED_G;
  using F = Fe<G>;
  constexpr int LANES = ED_THREADS / G;
  constexpr int NP = 4;  // products one multiply interleaves: a stage
  __shared__ __align__(16) int scratch[LANES * FqGroup<G>::stride(NP)];
  FqLane<G> ln;
  fq_lane_init<G, NP>(ln, scratch);
  const long lane = (long)blockIdx.x * LANES + threadIdx.x / G;
  F x1, y1, z1, t1, x2, y2, z2, t2, d2;
  fq_load(x1, px, lane, batch, ln.t);
  fq_load(y1, py, lane, batch, ln.t);
  fq_load(z1, pz, lane, batch, ln.t);
  fq_load(t1, pt, lane, batch, ln.t);
  fq_load(x2, qx, lane, batch, ln.t);
  fq_load(y2, qy, lane, batch, ln.t);
  fq_load(z2, qz, lane, batch, ln.t);
  fq_load(t2, qt, lane, batch, ln.t);
  fq_load(d2, d2row, 0, 1, ln.t);

  F a, b, c, d;
  {
    F u[NP] = {fq_sub(ln, y1, x1), fq_add(ln, y1, x1), t1, fq_add(ln, z1, z1)};
    F v[NP] = {fq_sub(ln, y2, x2), fq_add(ln, y2, x2), d2, z2};
    F r[NP];
    fq_mul_n<G, NP>(ln, r, u, v);
    a = r[0], b = r[1], c = r[2], d = r[3];
  }
  {
    F u[1] = {c}, v[1] = {t2}, r[1];
    fq_mul_n<G, 1>(ln, r, u, v);
    c = r[0];  // T1·2d·T2
  }
  const F e = fq_sub(ln, b, a);
  const F f = fq_sub(ln, d, c);
  const F g = fq_add(ln, d, c);
  const F h = fq_add(ln, b, a);
  {
    F u[NP] = {e, g, f, e}, v[NP] = {f, h, g, h}, r[NP];
    fq_mul_n<G, NP>(ln, r, u, v);
    fq_store(ox, r[0], lane, batch, ln.t);
    fq_store(oy, r[1], lane, batch, ln.t);
    fq_store(oz, r[2], lane, batch, ln.t);
    fq_store(ot, r[3], lane, batch, ln.t);
  }
}

extern "C" int ed_add_launch(void* ox, void* oy, void* oz, void* ot,
                             const void* px, const void* py, const void* pz,
                             const void* pt, const void* qx, const void* qy,
                             const void* qz, const void* qt, const void* d2,
                             int batch, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  constexpr int LANES = ED_THREADS / ED_G;
  const int blocks = (batch + LANES - 1) / LANES;
  ed_add_kernel<<<blocks, ED_THREADS, 0, (cudaStream_t)stream>>>(
      (int*)ox, (int*)oy, (int*)oz, (int*)ot, (const int*)px,
      (const int*)py, (const int*)pz, (const int*)pt, (const int*)qx,
      (const int*)qy, (const int*)qz, (const int*)qt, (const int*)d2,
      batch);
  return (int)cudaGetLastError();
}
