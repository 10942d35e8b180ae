// The sweep windows: each tile's slot bases, K1's slot masks and each
// query's certificate, in one launch.
//
// Replaces no TPU kernel. The JAX package computes the windows as XLA ops
// around _sweep_kernel_call (iterativeclosestpoint_tpu/ops/pallas_nn.py:
// nn_colsweep :1429 and nn_colsweep_z :1692); the port ran them as ~90
// small PyTorch launches a window, whose host time exceeded the sweep's.
// Their plain versions are ops/sweep_nn.py::_sweep_window_plain (the slab
// window, slab_window here) and _zcol_window_plain (the z-column window,
// zcol_window here); the outputs are theirs bit for bit.
//
// Design: one CTA of 128 threads per tile of 128 queries, one query per
// thread (tile_front). Each thread computes its query's clamped cell and
// its offset from the grid's origin; the tile's per-axis min and max cells
// come from warp shuffles and one shared-memory step (integers, so exact
// in any order). The first `slots` threads then gather their slot's row
// range from the CSR and write its base and mask; every thread writes its
// query's completeness and certificate radius. The grid's origin, cell
// size and box are read from device memory: nothing goes back to the
// host.
//
// Bit equality with the plain versions: each f32 operation is rounded on
// its own, in the plain version's order (the subtract, then an IEEE
// divide, never a reciprocal multiply; -fmad=false); float to int32 as
// PyTorch's CUDA cast (truncation, saturating, NaN to 0); torch.minimum,
// torch.maximum and clamp keep a NaN operand; sqrt_rn is the f64 square
// root rounded to f32, as ops/bruteforce.py::sqrt_rn computes it.
//
// Bound on the H100: bytes. Per query 12 B read and 5 B written (radius
// f32, complete u8); per slot 8 B written (base, mask) and 8 B gathered.
// That is ~18 MB at 1M queries (5 us at 3.35 TB/s) and ~180 MB at 10M
// (54 us); at 1M the launch itself sets the pace.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace icp {

constexpr int kTileQ = 128;  // queries per tile, one thread each
constexpr int kWarps = kTileQ / 32;
constexpr int kMaxSlots = 16;  // slots per tile (K1's and K2's limit)
constexpr float kInf = __builtin_huge_valf();

// torch.minimum / torch.maximum on CUDA: a NaN operand is the result.
__device__ __forceinline__ float min_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// ops/bruteforce.py::sqrt_rn: the f64 square root rounded to f32.
__device__ __forceinline__ float sqrt_rn(float x) {
  return __double2float_rn(__dsqrt_rn((double)x));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// A tile's shared front (sweep_nn.py::_tile_cells): the thread's query
// offset from the origin and its clamped cell, the tile's per-axis min and
// max cells, the cells' size and the target's extent past the origin.
struct Front {
  float pq[3];
  int qc[3];
  int minc[3];
  int maxc[3];
  float cs[3];
  float hi[3];
};

__device__ __forceinline__ Front tile_front(const float* __restrict__ q,
                                            const float* __restrict__ origin,
                                            const float* __restrict__ cell,
                                            int cell_n,
                                            const float* __restrict__ bbox_hi,
                                            int R) {
  __shared__ int red[2][3][kWarps];
  Front f;
  const int tid = threadIdx.x;
  const int64_t row = (int64_t)blockIdx.x * kTileQ + tid;
  for (int a = 0; a < 3; ++a) {
    const float org = origin[a];
    const float cs = cell[cell_n == 3 ? a : 0];
    const float hi = __fsub_rn(bbox_hi[a], org);
    const float p = __fsub_rn(q[row * 3 + a], org);
    // Clamp to the occupied cell range per axis (the grid cube spans the
    // longest axis in every dim).
    const int occ = min(__float2int_rz(floorf(__fdiv_rn(hi, cs))), R - 1);
    const int c = __float2int_rz(floorf(__fdiv_rn(p, cs)));
    f.qc[a] = min(max(c, 0), occ);
    f.pq[a] = p;
    f.cs[a] = cs;
    f.hi[a] = hi;
  }
  const int lane = tid & 31, warp = tid >> 5;
  for (int a = 0; a < 3; ++a) {
    int lo = f.qc[a], hi = f.qc[a];
    for (int off = 16; off > 0; off >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if (lane == 0) {
      red[0][a][warp] = lo;
      red[1][a][warp] = hi;
    }
  }
  __syncthreads();
  for (int a = 0; a < 3; ++a) {
    int lo = red[0][a][0], hi = red[1][a][0];
    for (int w = 1; w < kWarps; ++w) {
      lo = min(lo, red[0][a][w]);
      hi = max(hi, red[1][a][w]);
    }
    f.minc[a] = lo;
    f.maxc[a] = hi;
  }
  return f;
}

// sweep_nn.py::_edge_dist: the distance along one axis from the query
// coordinate p to the edge of a window over cells [lo_c - 1, hi_c + 1];
// an edge at the grid's boundary, or strictly past the target's extent
// hi, is infinitely far.
__device__ __forceinline__ float edge_dist(float p, int lo_c, int hi_c,
                                           float cell, float hi, int R) {
  const float r_lo =
      lo_c <= 1 ? kInf : __fsub_rn(p, __fmul_rn(__int2float_rn(lo_c - 1),
                                                cell));
  const float e_hi = __fmul_rn(__int2float_rn(hi_c + 2), cell);
  const float r_hi = (hi_c >= R - 2 || e_hi > hi) ? kInf : __fsub_rn(e_hi, p);
  return min_nan(r_lo, r_hi);
}

// The query's distance past the target's box on each axis, and its square.
__device__ __forceinline__ float gap(const Front& f, int a) {
  const float g = max_nan(-f.pq[a], __fsub_rn(f.pq[a], f.hi[a]));
  return isnan(g) ? g : fmaxf(g, 0.0f);  // clamp(min=0) keeps a NaN
}

// sweep_nn.py::_slot_bases for one slot's row range [start, end): its
// 128-aligned base, clamped to max_base = rows - trange, and K1's mask
// lo | (width << 7) where slack is given.
__device__ __forceinline__ void write_slot(int start, int end, int max_base,
                                           int trange, int* base, int* slack,
                                           int64_t at) {
  const int b = min(start, max_base) & ~127;  // floor to a multiple of 128
  base[at] = b;
  if (slack != nullptr) {
    const unsigned width = (unsigned)min(end - start, trange);
    slack[at] = (start - b) | (int)(width << 7);
  }
}

// The slab window (sweep_nn.py::_sweep_window_plain): slab s of a tile
// covers x = minx - 1 + s, y in [miny - 1, maxy + 1], all z, one row range
// of the (R^2 + 1) column CSR.
__global__ void __launch_bounds__(kTileQ)
    slab_window_kernel(const float* __restrict__ q,
                       const int* __restrict__ col_start,
                       const float* __restrict__ origin,
                       const float* __restrict__ cell, int cell_n,
                       const float* __restrict__ bbox_hi, int R, int slabs,
                       int trange, int max_base, int* __restrict__ base,
                       int* __restrict__ slack,
                       unsigned char* __restrict__ complete,
                       float* __restrict__ radius) {
  __shared__ bool fit[kMaxSlots];
  const Front f = tile_front(q, origin, cell, cell_n, bbox_hi, R);
  const int tile = blockIdx.x;
  const int s = threadIdx.x;
  if (s < slabs) {
    const int xs = f.minc[0] - 1 + s;
    const bool x_ok = xs >= 0 && xs < R && xs <= f.maxc[0] + 1;
    int start = 0, end = 0;
    if (x_ok) {
      const int64_t col = (int64_t)xs * R;
      start = col_start[col + clampi(f.minc[1] - 1, 0, R - 1)];
      end = col_start[col + clampi(f.maxc[1] + 1, 0, R - 1) + 1];
    }
    // Bases align down to 128 rows; the fit margin keeps room for that.
    fit[s] = end - start <= trange - 128;
    write_slot(start, end, max_base, trange, base, slack,
               (int64_t)tile * slabs + s);
  }
  __syncthreads();

  // Complete: the query's own x±1 slabs are present and fit (a slab past
  // either end of the tile's slabs stands in for its edge neighbour).
  const int sx = f.qc[0] - (f.minc[0] - 1);
  bool ok = false;
  if (sx >= 0 && sx < slabs && sx + 1 <= slabs - 1) {
    ok = fit[sx] && fit[max(sx - 1, 0)] && fit[min(sx + 1, slabs - 1)];
  }
  // Radius: to the edge of the guaranteed window (x: the query's own ±1
  // cells; y: the tile's dilated span; z: unbounded), strengthened past
  // the target's box: a candidate outside the window escapes it in x or
  // y and still lies in the box.
  const float rx = edge_dist(f.pq[0], f.qc[0], f.qc[0], f.cs[0], f.hi[0], R);
  const float ry = edge_dist(f.pq[1], f.minc[1], f.maxc[1], f.cs[1], f.hi[1],
                             R);
  const float gx = gap(f, 0), gy = gap(f, 1), gz = gap(f, 2);
  const float ex = sqrt_rn(__fadd_rn(
      __fadd_rn(__fmul_rn(rx, rx), __fmul_rn(gy, gy)), __fmul_rn(gz, gz)));
  const float ey = sqrt_rn(__fadd_rn(
      __fadd_rn(__fmul_rn(ry, ry), __fmul_rn(gx, gx)), __fmul_rn(gz, gz)));
  const int64_t row = (int64_t)tile * kTileQ + threadIdx.x;
  complete[row] = ok;
  radius[row] = min_nan(ex, ey);
}

// The z-column window (sweep_nn.py::_zcol_window_plain): slot k covers
// column (lo_x + k / ny, lo_y + k % ny) of the tile's dilated window and
// its cells [lo_z, hi_z], one row range of the (R^3 + 1) cell CSR. The
// tile is complete when every window column fits and the window has at
// most `slots` columns.
__global__ void __launch_bounds__(kTileQ)
    zcol_window_kernel(const float* __restrict__ q,
                       const int* __restrict__ cell_start,
                       const float* __restrict__ origin,
                       const float* __restrict__ cell, int cell_n,
                       const float* __restrict__ bbox_hi, int R, int slots,
                       int zrange, int max_base, int* __restrict__ base,
                       int* __restrict__ slack,
                       unsigned char* __restrict__ complete,
                       float* __restrict__ radius) {
  const Front f = tile_front(q, origin, cell, cell_n, bbox_hi, R);
  const int tile = blockIdx.x;
  const int k = threadIdx.x;
  int lo[3], hi[3];
  for (int a = 0; a < 3; ++a) {
    lo[a] = clampi(f.minc[a] - 1, 0, R - 1);
    hi[a] = clampi(f.maxc[a] + 1, 0, R - 1);
  }
  const int nx = hi[0] - lo[0] + 1, ny = hi[1] - lo[1] + 1;
  bool fits = true;
  if (k < slots) {
    const int ny_c = max(ny, 1);
    const int dx = k / ny_c, dy = k - dx * ny_c;
    int start = 0, end = 0;
    if (dx < nx) {
      const int64_t col = ((int64_t)clampi(lo[0] + dx, 0, R - 1) * R +
                           clampi(lo[1] + dy, 0, R - 1)) * R;
      start = cell_start[col + lo[2]];
      end = cell_start[col + hi[2] + 1];
    }
    fits = end - start <= zrange - 128;
    write_slot(start, end, max_base, zrange, base, slack,
               (int64_t)tile * slots + k);
  }
  const bool ok = __syncthreads_and(fits) && nx * ny <= slots;

  // Radius: a candidate outside the window escapes it along some axis a
  // and still lies in the target's box, so the escape bound is
  // sqrt(r_a^2 + (g_b0^2 + g_b1^2)).
  float g2[3];
  for (int a = 0; a < 3; ++a) {
    const float g = gap(f, a);
    g2[a] = __fmul_rn(g, g);
  }
  float esc[3];
  for (int a = 0; a < 3; ++a) {
    const float r = edge_dist(f.pq[a], f.minc[a], f.maxc[a], f.cs[a],
                              f.hi[a], R);
    const int b0 = a == 0 ? 1 : 0, b1 = a == 2 ? 1 : 2;
    esc[a] = sqrt_rn(__fadd_rn(__fmul_rn(r, r), __fadd_rn(g2[b0], g2[b1])));
  }
  const int64_t row = (int64_t)tile * kTileQ + threadIdx.x;
  complete[row] = ok;
  radius[row] = min_nan(min_nan(esc[0], esc[1]), esc[2]);
}

}  // namespace icp

extern "C" int slab_window(const float* q, const int* col_start,
                           const float* origin, const float* cell, int cell_n,
                           const float* bbox_hi, int tiles, int R, int slabs,
                           int trange, int max_base, int* base, int* slack,
                           unsigned char* complete, float* radius,
                           cudaStream_t stream) {
  if (tiles > 0) {
    icp::slab_window_kernel<<<tiles, icp::kTileQ, 0, stream>>>(
        q, col_start, origin, cell, cell_n, bbox_hi, R, slabs, trange,
        max_base, base, slack, complete, radius);
  }
  return (int)cudaGetLastError();
}

extern "C" int zcol_window(const float* q, const int* cell_start,
                           const float* origin, const float* cell, int cell_n,
                           const float* bbox_hi, int tiles, int R, int slots,
                           int zrange, int max_base, int* base, int* slack,
                           unsigned char* complete, float* radius,
                           cudaStream_t stream) {
  if (tiles > 0) {
    icp::zcol_window_kernel<<<tiles, icp::kTileQ, 0, stream>>>(
        q, cell_start, origin, cell, cell_n, bbox_hi, R, slots, zrange,
        max_base, base, slack, complete, radius);
  }
  return (int)cudaGetLastError();
}
