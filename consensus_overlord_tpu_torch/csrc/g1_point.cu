// Fused BLS12-381 G1 group operations for Hopper (sm_90a): the complete
// projective addition and the dedicated a=0 doubling, each one kernel.
//
// Replaces the TPU kernel consensus_overlord_tpu/ops/pallas_point.py
// `_point_kernel` in both its forms: op="add" (body _g1_add_body,
// Renes–Costello–Batina 2016 Algorithm 7 with a = 0, b3 = 12) and
// op="dbl" (body _g1_dbl_body, Algorithm 9).  Each replays the straight
// line of ops/curve.py CurveOps.add / CurveOps.dbl op for op, with every
// field op ending in the same planned reduction (fq_field.cuh), so the
// outputs are bit-identical to the generic formulas over the plain field
// (bls12381_groups.G1.add_plain / dbl_plain).
//
// What bounds it on the H100: an add reads six and writes three (B, 39)
// int32 coordinates (1,404 bytes a lane) and does 12 field multiplies
// plus 20 add/sub/small-multiple reductions — about 40,000 int32
// multiply-adds a lane, some 60 operations per byte: the multiply-adds
// bound it (a doubling: 8 multiplies, 936 bytes, the same verdict).
// The design keeps every intermediate off device memory: one thread per
// lane, the coordinates and temporaries in thread-private arrays, each
// field op an out-of-line function whose accumulator sits in registers
// and whose fold rows are constant-memory operands.  Lanes are staged
// through a shared-memory tile one coordinate at a time so the row-major
// (B, 39) global accesses stay coalesced.  At B = 8192 the grid holds
// two warps per SM, so the kernel is latency-bound; more threads per
// lane is the next step.

#include "fq_field.cuh"

#define PT_BLOCK 64
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
  fe_small(three_t0, t0, 3, FQ_PLAN_SMALL3);
  fe_small(b3_t2, t2, G1_B3, FQ_PLAN_SMALL12);
  fe_add(z3, t1, b3_t2);
  fe_sub(t1, t1, b3_t2);
  fe_small(y3, t5, G1_B3, FQ_PLAN_SMALL12);
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

__global__ void __launch_bounds__(PT_BLOCK)
    g1_dbl_kernel(int* ox, int* oy, int* oz, const int* px, const int* py,
                  const int* pz, int batch) {
  __shared__ int tile[PT_BLOCK * FQ_N];
  const long lane0 = (long)blockIdx.x * PT_BLOCK;
  const int lanes = min(PT_BLOCK, batch - (int)lane0);
  const bool live = threadIdx.x < lanes;
  int x[FQ_N], y[FQ_N], z[FQ_N];
  int t0[FQ_N], t1[FQ_N], t2[FQ_N], u[FQ_N];
  int x3[FQ_N], y3[FQ_N], z3[FQ_N];

  stage_in(tile, px, lane0, lanes, live, x);
  stage_in(tile, py, lane0, lanes, live, y);
  stage_in(tile, pz, lane0, lanes, live, z);

  fe_mul(t0, y, y);                         // Y²
  fe_small(z3, t0, 8, FQ_PLAN_SMALL8);      // 8Y²
  fe_mul(t1, y, z);                         // YZ
  fe_mul(u, z, z);
  fe_small(t2, u, G1_B3, FQ_PLAN_SMALL12);  // 3bZ²
  fe_mul(x3, t2, z3);                       // 24bY²Z²
  fe_add(y3, t0, t2);                       // Y² + 3bZ²
  fe_mul(z3, t1, z3);                       // 8Y³Z
  fe_small(u, t2, 3, FQ_PLAN_SMALL3);
  fe_sub(t0, t0, u);                        // Y² − 9bZ²
  fe_mul(u, t0, y3);
  fe_add(y3, u, x3);
  fe_mul(u, x, y);
  fe_mul(u, t0, u);
  fe_small(x3, u, 2, FQ_PLAN_SMALL2);       // 2XY(Y² − 9bZ²)

  stage_out(tile, ox, lane0, lanes, live, x3);
  stage_out(tile, oy, lane0, lanes, live, y3);
  stage_out(tile, oz, lane0, lanes, live, z3);
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
  const int blocks = (batch + PT_BLOCK - 1) / PT_BLOCK;
  g1_dbl_kernel<<<blocks, PT_BLOCK, 0, (cudaStream_t)stream>>>(
      (int*)ox, (int*)oy, (int*)oz, (const int*)px, (const int*)py,
      (const int*)pz, batch);
  return (int)cudaGetLastError();
}
