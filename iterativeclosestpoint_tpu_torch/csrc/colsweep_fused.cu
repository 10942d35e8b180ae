// K1: the fused slab sweep, the fine level's exact-NN kernel.
//
// Replaces iterativeclosestpoint_tpu/ops/pallas_nn.py::_colsweep_fused_kernel
// (launched by _sweep_kernel_call with fused=True). For each tile of 128
// queries it finds the nearest row among `slabs` candidate row ranges of
// the cell-sorted target. Slot s reads rows [base + lo, base + lo + len)
// with (lo, width) packed as slack = lo | (width << 7) and
// len = min(width, trange - lo): exactly the lanes the TPU kernel's
// per-slot mask left valid, so slot ranges are disjoint rows.
//
// Bound on the H100: operations. Each query–candidate pair costs ~9 f32
// operations (3 sub, 3 mul, 2 add, 1 compare) against the FP32 CUDA-core
// rate, while the bytes are tiles·slabs·trange·12 of staged rows against
// 3.35 TB/s, and the same rows are reused by all 128 queries of a tile.
// At the 1M-point fine grid (R=128, trange 768, 4 slabs) that is ~3e9
// pairs per call.
//
// Left for later: cp.async or TMA double-buffering of the staged chunks
// (each chunk now waits on its own load), and several queries per thread
// to amortize the shared-memory read of each candidate.

#include "sweep.cuh"

namespace icp {

__global__ void __launch_bounds__(kTileQ)
    colsweep_fused_kernel(const int* __restrict__ base,
                          const int* __restrict__ slack,
                          const float* __restrict__ q,
                          const float* __restrict__ tgt_t, int64_t stride,
                          int slabs, int trange, float* __restrict__ out) {
  __shared__ float4 cand[kChunk];
  const int tile = blockIdx.x;
  const int64_t qi = (int64_t)tile * kTileQ + threadIdx.x;
  const float qx = q[3 * qi], qy = q[3 * qi + 1], qz = q[3 * qi + 2];
  Best b{kBig, -1, false};
  for (int s = 0; s < slabs; ++s) {
    const int v = slack[tile * slabs + s];
    const int lo = v & 127;
    const int len = min(v >> 7, trange - lo);
    sweep_rows(b, cand, tgt_t, stride, qx, qy, qz,
               (int64_t)base[tile * slabs + s] + lo, len);
  }
  write_tile(b, tgt_t, stride, out + (int64_t)tile * 8 * kTileQ);
}

}  // namespace icp

extern "C" int colsweep_fused(const int* base, const int* slack,
                              const float* q, const float* tgt_t,
                              long long stride, int tiles, int slabs,
                              int trange, float* out, cudaStream_t stream) {
  if (tiles > 0) {
    icp::colsweep_fused_kernel<<<tiles, icp::kTileQ, 0, stream>>>(
        base, slack, q, tgt_t, stride, slabs, trange, out);
  }
  return (int)cudaGetLastError();
}
