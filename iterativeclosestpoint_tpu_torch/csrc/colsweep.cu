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
// Design (sweep.cuh). Each slab is clipped to the rows no earlier slab
// showed: all windows have the same length, so an earlier window covers
// either a head or a tail of a later one and the rest stays one range,
// [max(b, b' + trange over earlier b' ≤ b), min(b + trange, b' over
// earlier b' > b)). That keeps every row's first occurrence, hence the
// first minimum and the index-identity tie flag, and makes the stream's
// rows distinct. The repair chain's first stage has 64 tiles, too few CTAs
// for 132 SMs, so the wrapper cuts each tile's stream into `splits`
// contiguous ranges, one CTA each (about 4 CTAs per SM, each range at
// least one staged pass); the CTAs write their partials to `part` and
// colsweep_merge_kernel merges them in scan order with merge_best. With one
// split the scan writes the tile directly.
//
// Bound on the H100: instruction issue, at least 9 f32 instructions per
// query–candidate pair (no FMA, by the d² contract) at 128 per SM per
// clock; bytes are tiles·slabs·trange·12 against 3.35 TB/s. At the
// 1M-point coarse repair grid (R=32, trange 8192, 4 slabs) the steady
// state's first repair stage is 64 tiles, ~2.7e8 pairs, and a full-budget
// 512-tile pass ~2.1e9 pairs.
//
// Left for later: the shared scan's issue rate (see colsweep_fused.cu);
// with splits, one more launch merges the partials.

#include "sweep.cuh"

namespace icp {

__global__ void __launch_bounds__(kThreads, kMinCtas)
    colsweep_kernel(const int* __restrict__ base, const float* __restrict__ q,
                    const float* __restrict__ tgt_t, int64_t stride, int slabs,
                    int trange, int* __restrict__ part,
                    float* __restrict__ out) {
  __shared__ float4 buf[2 * kChunk];
  __shared__ Stream st;
  const int tile = blockIdx.x;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int s = threadIdx.x;
  if (s < slabs) {
    const int* tb = base + tile * slabs;
    const int bs = tb[s];
    int lo = bs, hi = bs + trange;
    for (int k = 0; k < s; ++k) {
      const int bk = tb[k];
      if (bk <= bs) {
        lo = max(lo, bk + trange);
      } else {
        hi = min(hi, bk);
      }
    }
    st.start[s] = lo;
    st.pre[s + 1] = max(0, hi - lo);
  }
  finish_stream(st, slabs);
  const int n = st.pre[slabs];
  const int per = (n + splits - 1) / splits;
  const int a = min(n, split * per);
  const Best b = scan_stream<true>(st, slabs, a, min(n, a + per),
                                   q + (int64_t)tile * kTileQ * 3,
                                   CoordRows{tgt_t, stride}, buf);
  if (splits == 1) {
    write_tile(b, tgt_t, stride, out + (int64_t)tile * 8 * kTileQ);
    return;
  }
  // part: (3, tiles, splits, 128) words: d² bits, row, tie.
  const int64_t plane = (int64_t)gridDim.x * splits * kTileQ;
  const int64_t k = ((int64_t)tile * splits + split) * kTileQ + threadIdx.x;
  part[k] = __float_as_int(b.d2);
  part[plane + k] = b.row;
  part[2 * plane + k] = b.tie;
}

__global__ void __launch_bounds__(kTileQ)
    colsweep_merge_kernel(const int* __restrict__ part, int splits,
                          const float* __restrict__ tgt_t, int64_t stride,
                          float* __restrict__ out) {
  const int tile = blockIdx.x;
  const int64_t plane = (int64_t)gridDim.x * splits * kTileQ;
  const int64_t k0 = (int64_t)tile * splits * kTileQ + threadIdx.x;
  Best m{__int_as_float(part[k0]), part[plane + k0],
         part[2 * plane + k0] != 0};
  for (int sp = 1; sp < splits; ++sp) {
    const int64_t k = k0 + (int64_t)sp * kTileQ;
    m = merge_best(m, Best{__int_as_float(part[k]), part[plane + k],
                           part[2 * plane + k] != 0});
  }
  write_tile(m, tgt_t, stride, out + (int64_t)tile * 8 * kTileQ);
}

}  // namespace icp

extern "C" int colsweep(const int* base, const float* q, const float* tgt_t,
                        long long stride, int tiles, int slabs, int trange,
                        int splits, int* part, float* out,
                        cudaStream_t stream) {
  if (tiles > 0) {
    icp::colsweep_kernel<<<dim3(tiles, splits), icp::kThreads, 0, stream>>>(
        base, q, tgt_t, stride, slabs, trange, part, out);
    if (splits > 1) {
      icp::colsweep_merge_kernel<<<tiles, icp::kTileQ, 0, stream>>>(
          part, splits, tgt_t, stride, out);
    }
  }
  return (int)cudaGetLastError();
}
