// K2: the slot-wise slab sweep, the coarse repair grid's exact-NN kernel.
//
// Replaces iterativeclosestpoint_tpu/ops/pallas_nn.py::_colsweep_kernel
// (launched by _sweep_kernel_call with fused=False). For each tile of 128
// queries it scans the full rows [base, base + trange) of each of `slabs`
// slabs with no lane mask: rows outside the certified window are real
// target points or far padding, a candidate superset that keeps the
// certificate valid. Windows of neighbouring slabs may overlap, so the
// same row can be scanned twice; the tie rule counts only a different row
// at the winner's d², or a duplicated winner would decertify the query.
//
// Bound on the H100: operations, ~9 f32 operations per query–candidate
// pair against the FP32 CUDA-core rate; bytes are tiles·slabs·trange·12
// against 3.35 TB/s. At the 1M-point coarse repair grid (R=32, trange
// 8192, 4 slabs) the steady state's first repair stage is 64 tiles,
// ~2.7e8 pairs, and a full-budget 512-tile pass ~2.1e9 pairs.
//
// Left for later: cp.async or TMA double-buffering of the staged chunks,
// and several queries per thread (the 64-tile stage fills under half of
// the card's 132 SMs).

#include "sweep.cuh"

namespace icp {

__global__ void __launch_bounds__(kTileQ)
    colsweep_kernel(const int* __restrict__ base, const float* __restrict__ q,
                    const float* __restrict__ tgt_t, int64_t stride, int slabs,
                    int trange, float* __restrict__ out) {
  __shared__ float4 cand[kChunk];
  const int tile = blockIdx.x;
  const int64_t qi = (int64_t)tile * kTileQ + threadIdx.x;
  const float qx = q[3 * qi], qy = q[3 * qi + 1], qz = q[3 * qi + 2];
  Best b{kBig, -1, false};
  for (int s = 0; s < slabs; ++s) {
    sweep_rows(b, cand, tgt_t, stride, qx, qy, qz,
               (int64_t)base[tile * slabs + s], trange);
  }
  write_tile(b, tgt_t, stride, out + (int64_t)tile * 8 * kTileQ);
}

}  // namespace icp

extern "C" int colsweep(const int* base, const float* q, const float* tgt_t,
                        long long stride, int tiles, int slabs, int trange,
                        float* out, cudaStream_t stream) {
  if (tiles > 0) {
    icp::colsweep_kernel<<<tiles, icp::kTileQ, 0, stream>>>(
        base, q, tgt_t, stride, slabs, trange, out);
  }
  return (int)cudaGetLastError();
}
