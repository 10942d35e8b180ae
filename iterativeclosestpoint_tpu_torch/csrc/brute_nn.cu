// K3: exact all-pairs 1-NN with the first-minimum tie order.
//
// Replaces iterativeclosestpoint_tpu/ops/pallas_nn.py::_colsweep_kernel
// with first_tie=True on a one-cell grid (make_pallas_brute), which the
// JAX package runs for the coarse multiscale level; here it also serves
// the repair chain's brute tiers and global fallback. Its plain version
// is ops/bruteforce.py::nn_bruteforce.
//
// Each CTA takes 128 queries (one per thread) and one split of the target
// rows, staged through shared memory; a strict < while scanning the split
// in row order keeps the split's first minimum. Splits spread a small
// query count over the whole card (4096 repair queries are only 32 tiles).
// They merge by a 64-bit atomicMin on (d² bits << 32 | row): d² ≥ 0, so
// its f32 bit pattern orders as an unsigned integer, and the minimum key
// is the smallest d² and, among equal d², the lowest row — the first
// minimum of a row-order scan, nn_bruteforce's order. keys must hold all
// ones on entry; a query whose candidates never fall below 1e18 keeps it.
// The TPU version was capped at m <= 131072 rows by its VMEM; streaming
// the target through shared memory has no such cap.
//
// Bound on the H100: operations, ~9 f32 operations per pair against the
// FP32 CUDA-core rate; bytes are (n + m)·12 plus n·8 of keys. The coarse
// level at 1M points is 29,412 × 29,412 ≈ 8.7e8 pairs per call; the repair
// chain's first brute stage is 512 queries × 1M targets ≈ 5.1e8 pairs.
//
// Left for later: cp.async or TMA double-buffering of the staged chunks,
// and several queries per thread.

#include "sweep.cuh"

namespace icp {

__global__ void __launch_bounds__(kTileQ)
    brute_nn_kernel(const float* __restrict__ q, int n,
                    const float* __restrict__ tgt, int m, int rows_per_split,
                    unsigned long long* __restrict__ keys) {
  __shared__ float4 cand[kChunk];
  const int qi = blockIdx.x * kTileQ + threadIdx.x;
  const bool live = qi < n;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    qx = q[3 * (int64_t)qi];
    qy = q[3 * (int64_t)qi + 1];
    qz = q[3 * (int64_t)qi + 2];
  }
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(m, r_begin + rows_per_split);
  float best = kBig;
  int best_row = -1;
  for (int c0 = r_begin; c0 < r_end; c0 += kChunk) {
    const int w = min(kChunk, r_end - c0);
    __syncthreads();
    for (int k = threadIdx.x; k < w; k += blockDim.x) {
      const int64_t r = (int64_t)(c0 + k) * 3;
      cand[k] = make_float4(tgt[r], tgt[r + 1], tgt[r + 2], 0.f);
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < w; ++k) {
      const float d2 = sq_dist(qx, qy, qz, cand[k]);
      if (d2 < best) {
        best = d2;
        best_row = c0 + k;
      }
    }
  }
  if (live && best_row >= 0) {
    const unsigned long long key =
        ((unsigned long long)__float_as_uint(best) << 32) |
        (unsigned long long)(unsigned int)best_row;
    atomicMin(keys + qi, key);
  }
}

}  // namespace icp

extern "C" int brute_nn(const float* q, int n, const float* tgt, int m,
                        int splits, int rows_per_split,
                        unsigned long long* keys, cudaStream_t stream) {
  if (n > 0 && m > 0) {
    const dim3 grid((n + icp::kTileQ - 1) / icp::kTileQ, splits);
    icp::brute_nn_kernel<<<grid, icp::kTileQ, 0, stream>>>(
        q, n, tgt, m, rows_per_split, keys);
  }
  return (int)cudaGetLastError();
}
