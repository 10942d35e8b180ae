// Shared device code of the slab-sweep kernels (colsweep_fused.cu,
// colsweep.cu) and the brute kernel (brute_nn.cu).
//
// Design common to all three: one CTA per tile of 128 queries, one thread
// per query. Candidate rows are staged through shared memory in chunks of
// kChunk rows (xyz as float4, 16 KB); every thread scans the chunk from
// shared memory (a broadcast read) and keeps a running
// (best_d2, best_row, tie). The winner's coordinates are gathered by row
// index at the end; the TPU kernels extracted them with a one-hot matrix
// product and a bf16 hi/mid/lo split, which a gather makes unnecessary
// (it returns the f32 coordinates bit-exactly).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace icp {

constexpr int kTileQ = 128;    // queries per CTA, one per thread
constexpr int kChunk = 1024;   // candidate rows staged per pass
constexpr float kBig = 1.0e18f;  // "no candidate yet" d² (the JAX _BIG)

// ((dx*dx + dy*dy) + dz*dz), each operation rounded on its own. An FMA
// would change the bits of d², which moves `dist <= radius`
// certification and exact-tie detection away from the plain versions.
__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float4 c) {
  const float dx = __fsub_rn(qx, c.x);
  const float dy = __fsub_rn(qy, c.y);
  const float dz = __fsub_rn(qz, c.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Running winner. A strict < keeps the first minimum in scan order; a tie
// is an equal d² from a row with a DIFFERENT index (an overlapping window
// may show the same row twice, which is not a tie).
struct Best {
  float d2;
  int row;
  bool tie;
};

// Scan rows [r0, r0 + len) of the transposed target tgt_t (rows 0-2 are
// x, y, z with `stride` floats per row). `len` is uniform over the CTA,
// so the barriers are reached by every thread.
__device__ __forceinline__ void sweep_rows(Best& b, float4* cand,
                                           const float* __restrict__ tgt_t,
                                           int64_t stride, float qx, float qy,
                                           float qz, int64_t r0, int len) {
  for (int c0 = 0; c0 < len; c0 += kChunk) {
    const int w = min(kChunk, len - c0);
    __syncthreads();  // the previous chunk is no longer read
    for (int k = threadIdx.x; k < w; k += blockDim.x) {
      const int64_t r = r0 + c0 + k;
      cand[k] = make_float4(tgt_t[r], tgt_t[stride + r],
                            tgt_t[2 * stride + r], 0.f);
    }
    __syncthreads();
    const int row0 = (int)(r0 + c0);
#pragma unroll 8
    for (int k = 0; k < w; ++k) {
      const float d2 = sq_dist(qx, qy, qz, cand[k]);
      const int row = row0 + k;
      if (d2 < b.d2) {
        b.d2 = d2;
        b.row = row;
        b.tie = false;
      } else if (d2 == b.d2 && row != b.row && b.row >= 0) {
        b.tie = true;
      }
    }
  }
}

// The tile's (8, 128) output block, the JAX kernels' contract: rows 0-5
// the winner's rows 0-5 of tgt_t (xyz and normal), row 6 its d², row 7
// 1 for a unique winner and 2 for an exact tie.
__device__ __forceinline__ void write_tile(const Best& b,
                                           const float* __restrict__ tgt_t,
                                           int64_t stride,
                                           float* __restrict__ out) {
  const int l = threadIdx.x;
  for (int r = 0; r < 6; ++r) {
    out[r * kTileQ + l] = b.row >= 0 ? tgt_t[r * stride + b.row] : 0.f;
  }
  out[6 * kTileQ + l] = b.d2;
  out[7 * kTileQ + l] = b.tie ? 2.f : 1.f;
}

}  // namespace icp
