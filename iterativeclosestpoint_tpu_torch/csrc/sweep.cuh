// Shared device code of the sweep kernels (colsweep_fused.cu, colsweep.cu)
// and the brute kernel (brute_nn.cu).
//
// The scan (K1, K2 and K3). A tile's candidates are the rows of its
// slots, taken slot by slot and row by row: the tile's candidate stream.
// The sweeps hand the scan DISJOINT slot ranges (K1's windows are; K2
// clips away rows an earlier slab already showed, which leaves every row's
// first occurrence in place), so an equal d² in the stream always comes
// from another row, and the scan needs no row test to flag a tie. K3 hands
// it one slot, a contiguous split of the target's rows, and asks for no
// tie flag (kTies = false).
//
// One CTA of 128 threads takes a tile's 128 queries and a contiguous range
// of its stream (the whole stream, or one of K2's or K3's splits). Each of
// its 4 warps (row groups) scans a contiguous quarter of that range for all
// 128 queries, 4 queries per thread, so each candidate read from shared
// memory (one broadcast LDS.128 of x, y, z and the row index) serves 4
// query–candidate pairs; per pair the scan keeps only a step minimum (see
// scan_stream). Rows are staged in passes of kChunk rows, kSect per group,
// by 4-byte cp.async copies into two buffers: pass i + 1 loads while pass
// i is scanned. 4-byte copies take any layout: the sweeps' tgt_t (one
// coordinate per row of the array, CoordRows), whose y and z rows are
// 16-byte aligned only when the stride is a multiple of 4, and K3's (m, 3)
// points (PointRows); a packed stream crosses slot boundaries at arbitrary
// rows anyway. The 4 group partials of each query then merge in scan order
// through shared memory (merge_best), which keeps the first minimum of the
// whole range. Occupancy: 33-35 KB of shared memory per CTA allows 6 CTAs
// (24 warps) per SM; ptxas's register count (under 85) allows them.
//
// The winner's coordinates are gathered by row index at the end; the TPU
// kernels extracted them with a one-hot matrix product and a bf16
// hi/mid/lo split, which a gather makes unnecessary (it returns the f32
// coordinates bit-exactly).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace icp {

constexpr int kTileQ = 128;    // queries per tile
constexpr int kChunk = 1024;   // candidate rows staged per pass
constexpr float kBig = 1.0e18f;  // "no candidate yet" d² (the JAX _BIG)

constexpr int kQ = 4;                      // queries per thread
constexpr int kGroups = 4;                 // row groups, one warp each
constexpr int kThreads = 32 * kGroups;     // threads per sweep CTA
constexpr int kSect = kChunk / kGroups;    // rows per group per pass
constexpr int kUnroll = 8;                 // candidates per scan step
constexpr int kMaxSlots = 16;              // slots (slabs) per tile
constexpr int kMinCtas = 6;                // resident CTAs per SM (smem)
static_assert(32 * kQ == kTileQ, "each warp holds all of a tile's queries");
static_assert(kThreads == kTileQ, "one thread per query in the epilogue");
static_assert(kSect % kUnroll == 0, "a group's section holds whole steps");

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

// A query's winner over part of its candidates: the first minimum in scan
// order, its d² (kBig and row -1 when no candidate fell below kBig), and
// whether another row has exactly that d².
struct Best {
  float d2;
  int row;
  bool tie;
};

// The one merge rule for partial scans: `a` covers a contiguous range of
// the scan order that comes before `b`'s. The earlier partial keeps an
// equal d², so the result is the first minimum of the joined range; the
// same row seen by both (overlapping K2 slabs) is not a tie.
__device__ __forceinline__ Best merge_best(const Best& a, const Best& b) {
  if (b.d2 < a.d2) return b;
  if (a.d2 < b.d2) return a;
  Best m = a.row >= 0 ? a : b;
  m.tie = a.tie | b.tie | ((a.row >= 0) & (b.row >= 0) & (a.row != b.row));
  return m;
}

// A tile's candidate stream: slot s holds rows [start[s], start[s] +
// pre[s+1] - pre[s]) at stream positions [pre[s], pre[s+1]).
struct Stream {
  int start[kMaxSlots];
  int pre[kMaxSlots + 1];
};

// After each thread s < slots has written start[s] and its length into
// pre[s + 1]: turn the lengths into stream positions.
__device__ __forceinline__ void finish_stream(Stream& st, int slots) {
  __syncthreads();
  if (threadIdx.x == 0) {
    st.pre[0] = 0;
    for (int s = 0; s < slots; ++s) st.pre[s + 1] += st.pre[s];
  }
  __syncthreads();
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where the target keeps coordinate k (0-2: x, y, z) of row r.
// The sweeps' tgt_t: (8, stride), one coordinate per row of the array.
struct CoordRows {
  const float* p;
  int64_t stride;
  __device__ __forceinline__ const float* at(int r, int k) const {
    return p + k * stride + r;
  }
};

// K3's target: (m, 3) row-major points.
struct PointRows {
  const float* p;
  __device__ __forceinline__ const float* at(int r, int k) const {
    return p + 3 * (int64_t)r + k;
  }
};

// Stream position p's row, from slot `s` on (s ≤ p's slot).
__device__ __forceinline__ int stream_row(const Stream& st, int slots, int p,
                                          int& s) {
  while (s + 1 < slots && p >= st.pre[s + 1]) ++s;
  return st.start[s] + (p - st.pre[s]);
}

// Stage pass `i` of every group into `dst` (kChunk float4: x, y, z and the
// row index as int bits). Group g scans stream positions [gs, ge) with
// gs = min(b, a + g·pg); its section of `dst` gets positions
// gs + i·kSect + [0, kSect). A position past ge becomes an x = +inf
// candidate, whose d² (+inf) never wins and never ties.
template <class Rows>
__device__ __forceinline__ void stage_pass(float4* dst, const Stream& st,
                                           int slots, int a, int b, int pg,
                                           int i, Rows rows) {
  for (int e = threadIdx.x; e < kChunk; e += kThreads) {
    const int g = e / kSect;
    const int gs = min(b, a + g * pg);
    const int ge = min(b, gs + pg);
    const int p = gs + i * kSect + (e - g * kSect);
    float4* c = dst + e;
    if (p < ge) {
      int s = 0;
      const int r = stream_row(st, slots, p, s);
      cp_async4(&c->x, rows.at(r, 0));
      cp_async4(&c->y, rows.at(r, 1));
      cp_async4(&c->z, rows.at(r, 2));
      c->w = __int_as_float(r);
    } else {
      *c = make_float4(__int_as_float(0x7f800000), 0.f, 0.f, 0.f);
    }
  }
}

// Scan stream positions [a, b) for the tile's 128 queries (q_tile: 128 × 3
// f32, in device or shared memory). Returns query threadIdx.x's Best over
// the range. Every thread of the CTA must call it (it holds barriers);
// `buf` is 2·kChunk float4 of shared memory, reused for the group merge.
//
// The scan keeps, per query, the minimum over each step of kUnroll
// candidates (a tree of fminf), the first step that lowered it and, with
// kTies, the second smallest step minimum, not the row of every pair: about
// 9.5 instructions per pair with kTies (8 f32 arithmetic, 7 per 8 for the
// tree, 5 per 8 for the step's compare, select and two-minimum update, a
// quarter of a shared load per 8) and 9.25 without, against the 9 of the
// issue floor. A second step at the minimum is another row at the
// winner's d², a tie (rows are distinct). The winner's row, the first
// candidate at the minimum, and a tie inside its step come from
// recomputing that step's kUnroll d² (the same bits) from shared memory at
// the end of the pass that found it, while the step is still staged.
// Without kTies the returned tie is false.
template <bool kTies, class Rows>
__device__ __forceinline__ Best scan_stream(const Stream& st, int slots,
                                            int a, int b,
                                            const float* __restrict__ q_tile,
                                            Rows rows, float4* buf) {
  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x >> 5;
  float qx[kQ], qy[kQ], qz[kQ], best[kQ], second[kQ];
  int step[kQ], row[kQ], tie[kQ];
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    const int qi = lane + 32 * j;
    qx[j] = q_tile[3 * qi];
    qy[j] = q_tile[3 * qi + 1];
    qz[j] = q_tile[3 * qi + 2];
    best[j] = kBig;
    second[j] = kBig;
    step[j] = -1;
    row[j] = -1;
    tie[j] = 0;
  }
  const int pg = (b - a + kGroups - 1) / kGroups;  // rows per group
  const int gs = min(b, a + g * pg);
  const int ge = min(b, gs + pg);
  const int passes = (pg + kSect - 1) / kSect;
  if (passes > 0) {
    stage_pass(buf, st, slots, a, b, pg, 0, rows);
    cp_async_commit();
  }
  for (int i = 0; i < passes; ++i) {
    if (i + 1 < passes) {
      // The buffer of pass i + 1 was last read in pass i - 1, which every
      // warp left through the barrier at the end of that pass.
      stage_pass(buf + ((i + 1) & 1) * kChunk, st, slots, a, b, pg, i + 1,
                 rows);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float4* c = buf + (i & 1) * kChunk + g * kSect;
    const int p0 = gs + i * kSect;
    const int cnt = min(kSect, max(0, ge - p0));
    const int steps = (cnt + kUnroll - 1) / kUnroll;  // padded with +inf
    for (int k = 0; k < steps * kUnroll; k += kUnroll) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = c[k + u];
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        float d[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          d[u] = sq_dist(qx[j], qy[j], qz[j], v[u]);
        }
#pragma unroll
        for (int w = kUnroll / 2; w > 0; w /= 2) {
#pragma unroll
          for (int u = 0; u < w; ++u) d[u] = fminf(d[u], d[u + w]);
        }
        step[j] = d[0] < best[j] ? p0 + k : step[j];
        if (kTies) second[j] = fminf(second[j], fmaxf(best[j], d[0]));
        best[j] = fminf(best[j], d[0]);
      }
    }
    // Rows of the steps this pass made winners, while they are staged.
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      if (step[j] >= p0) {
        const float4* w = c + (step[j] - p0);
        row[j] = -1;
        tie[j] = 0;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float4 v = w[u];
          if (sq_dist(qx[j], qy[j], qz[j], v) == best[j]) {
            if (kTies) tie[j] |= row[j] >= 0;
            row[j] = row[j] >= 0 ? row[j] : __float_as_int(v.w);
          }
        }
      }
    }
    __syncthreads();
  }

  // Group partials in scan order: group g's range precedes group g + 1's.
  float* pd = reinterpret_cast<float*>(buf);
  int* pr = reinterpret_cast<int*>(pd + kGroups * kTileQ);
  int* pt = pr + kGroups * kTileQ;
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    const int k = g * kTileQ + lane + 32 * j;
    pd[k] = best[j];
    pr[k] = row[j];
    // d² == kBig on an empty winner is not a tie (the plain versions
    // flag ties only where a candidate fell below kBig).
    if (kTies) pt[k] = (tie[j] | (second[j] == best[j])) & (row[j] >= 0);
  }
  __syncthreads();
  const int t = threadIdx.x;
  Best m{pd[t], pr[t], kTies && pt[t] != 0};
  for (int h = 1; h < kGroups; ++h) {
    const int k = h * kTileQ + t;
    m = merge_best(m, Best{pd[k], pr[k], kTies && pt[k] != 0});
  }
  return m;
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
