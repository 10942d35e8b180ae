// K1: the fused slab sweep, the fine level's exact-NN kernel.
//
// Replaces iterativeclosestpoint_tpu/ops/pallas_nn.py::_colsweep_fused_kernel
// (launched by _sweep_kernel_call with fused=True). For each tile of 128
// queries it finds the nearest row among `slabs` candidate row ranges of
// the cell-sorted target. Slot s reads rows [base + lo, base + lo + len)
// with (lo, width) packed as slack = lo | (width << 7) and
// len = min(width, trange - lo): exactly the lanes the TPU kernel's
// per-slot mask left valid. The windows that feed it (the slab sweep's x
// slabs, the z-column sweep's 12 (x, y) columns) are disjoint rows, which
// the scan relies on: an equal d² is always another row.
//
// Design (sweep.cuh): the live rows of all slots form one candidate stream
// in slot-then-row order, so a z-column tile's ~1,600 live rows over ~9
// short slots take two staged passes instead of a pass and two barriers
// per slot; one CTA per tile, 4 row groups × 4 queries per thread, a
// minimum per step of 8 candidates instead of per-pair row bookkeeping,
// cp.async double buffering.
//
// Bound on the H100: instruction issue. Each query–candidate pair costs at
// least 9 f32 instructions (3 sub, 3 mul, 2 add, 1 compare, none fused:
// FMA is forbidden by the d² contract), at 128 per SM per clock; bytes
// are tiles·slabs·trange·12 of staged rows against 3.35 TB/s, and each row
// is read once per tile for 128 queries. At the 1M-point fine grid (R=128,
// trange 768, 4 slabs) that is ~9.2e8 live pairs per call; on the volume
// grid (12 slots, zrange 512) ~1.8e9.
//
// Left for later: the scan loop issues about 10 instructions per pair
// against the floor's 9, yet the kernel reaches ~0.6 of the floor on an
// H100, and so does K2 at 512 tiles × 65,536 rows, whose CTAs scan 64
// passes each: per-tile set-up is not what holds it back, the loop's
// issue rate is. Why it issues below one instruction per clock is not
// measured (no stall-reason profiler was at hand). Steps of 4 or 16
// candidates and 7 resident CTAs per SM (smaller chunks) each moved it by
// a few percent only.

#include "sweep.cuh"

namespace icp {

__global__ void __launch_bounds__(kThreads, kMinCtas)
    colsweep_fused_kernel(const int* __restrict__ base,
                          const int* __restrict__ slack,
                          const float* __restrict__ q,
                          const float* __restrict__ tgt_t, int64_t stride,
                          int slabs, int trange, float* __restrict__ out) {
  __shared__ float4 buf[2 * kChunk];
  __shared__ Stream st;
  const int tile = blockIdx.x;
  const int s = threadIdx.x;
  if (s < slabs) {
    const int v = slack[tile * slabs + s];
    const int lo = v & 127;
    st.start[s] = base[tile * slabs + s] + lo;
    st.pre[s + 1] = max(0, min(v >> 7, trange - lo));
  }
  finish_stream(st, slabs);
  const Best b = scan_stream<true>(st, slabs, 0, st.pre[slabs],
                                   q + (int64_t)tile * kTileQ * 3,
                                   CoordRows{tgt_t, stride}, buf);
  write_tile(b, tgt_t, stride, out + (int64_t)tile * 8 * kTileQ);
}

}  // namespace icp

extern "C" int colsweep_fused(const int* base, const int* slack,
                              const float* q, const float* tgt_t,
                              long long stride, int tiles, int slabs,
                              int trange, float* out, cudaStream_t stream) {
  if (tiles > 0) {
    icp::colsweep_fused_kernel<<<tiles, icp::kThreads, 0, stream>>>(
        base, slack, q, tgt_t, stride, slabs, trange, out);
  }
  return (int)cudaGetLastError();
}
