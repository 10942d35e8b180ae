// K3: exact all-pairs 1-NN with the first-minimum tie order.
//
// Replaces iterativeclosestpoint_tpu/ops/pallas_nn.py::_colsweep_kernel
// with first_tie=True on a one-cell grid (make_pallas_brute), which the
// JAX package runs for the coarse multiscale level; here it also serves
// the repair chain's brute tiers and global fallback. Its plain version
// is ops/bruteforce.py::nn_bruteforce.
//
// Design (sweep.cuh). Each CTA takes a tile of 128 queries and one split
// of the target rows, [r_begin, r_end), as a one-slot candidate stream
// read in place from the (m, 3) target (PointRows: no transposed copy).
// The shared scan runs without its tie bookkeeping: its 4 warps each scan
// a contiguous quarter of the split for all 128 queries, 4 queries per
// thread, keep a minimum per step of 8 candidates and the first step that
// lowered it, recover the step's first row at that minimum from shared
// memory, and merge in row order (merge_best), so each CTA holds its
// split's first minimum. The tile's queries are staged in shared memory;
// the lanes past n read zeros and write nothing. Splits spread a small
// query count over the whole card (4096 repair queries are only 32
// tiles); the wrapper picks their number (ops/sweep_kernels.py::
// brute_splits). They merge by a 64-bit atomicMin on (d² bits << 32 |
// row): d² ≥ 0, so its f32 bit pattern orders as an unsigned integer, and
// the minimum key is the smallest d² and, among equal d², the lowest row —
// the first minimum of a row-order scan, nn_bruteforce's order, since
// splits are contiguous. keys must hold all ones on entry; a query whose
// candidates never fall below 1e18 keeps it. The TPU version was capped at
// m <= 131072 rows by its VMEM; streaming the target through shared memory
// has no such cap.
//
// Bound on the H100: instruction issue, at least 9 f32 instructions per
// pair (no FMA, by the d² contract) at 128 per SM per clock; the scan
// issues about 9.25. Bytes are (n + m)·12 plus n·8 of keys, far below. The
// coarse level at 1M points is 29,412 × 29,412 ≈ 8.7e8 pairs per call; the
// repair chain's first brute stage is 512 queries × 1M targets ≈ 5.1e8
// pairs.

#include "sweep.cuh"

namespace icp {

__global__ void __launch_bounds__(kThreads, kMinCtas)
    brute_nn_kernel(const float* __restrict__ q, int n,
                    const float* __restrict__ tgt, int m, int rows_per_split,
                    unsigned long long* __restrict__ keys) {
  __shared__ float4 buf[2 * kChunk];
  __shared__ Stream st;
  __shared__ float qs[3 * kTileQ];
  const int t = threadIdx.x;
  const int64_t q0 = (int64_t)blockIdx.x * kTileQ * 3;
  const int64_t q_end = 3 * (int64_t)n;
  for (int e = t; e < 3 * kTileQ; e += kThreads) {
    qs[e] = q0 + e < q_end ? q[q0 + e] : 0.f;
  }
  const int r_begin = blockIdx.y * rows_per_split;
  if (t == 0) {
    st.start[0] = r_begin;
    st.pre[1] = max(0, min(m, r_begin + rows_per_split) - r_begin);
  }
  finish_stream(st, 1);  // its barriers also publish qs
  const Best b = scan_stream<false>(st, 1, 0, st.pre[1], qs,
                                    PointRows{tgt}, buf);
  const int qi = blockIdx.x * kTileQ + t;
  if (qi < n && b.row >= 0) {
    const unsigned long long key =
        ((unsigned long long)__float_as_uint(b.d2) << 32) |
        (unsigned long long)(unsigned int)b.row;
    atomicMin(keys + qi, key);
  }
}

}  // namespace icp

extern "C" int brute_nn(const float* q, int n, const float* tgt, int m,
                        int splits, int rows_per_split,
                        unsigned long long* keys, cudaStream_t stream) {
  if (n > 0 && m > 0) {
    const dim3 grid((n + icp::kTileQ - 1) / icp::kTileQ, splits);
    icp::brute_nn_kernel<<<grid, icp::kThreads, 0, stream>>>(
        q, n, tgt, m, rows_per_split, keys);
  }
  return (int)cudaGetLastError();
}
