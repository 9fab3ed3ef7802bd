// The points binning of the splat kernels' general mode (the layout is
// described in splat_points.cuh): any query points sorted stably by voxel
// tile, and the work items of K4's general mode (splat_points.cu) and the
// tile order of K7's (splat_points_bwd.cu).
//
// Replaces: the per-tile bounds that
//           gaussianformer_tpu/ops/pallas/splat_kernel.py splat_raw_pallas
//           takes from the points' own voxel coordinates (:334-371) when
//           the points are not declared a raster grid (zrun = 0). There a
//           tile is any tile_n consecutive points and its bounds decide
//           which chunks of Gaussians it visits; here the points are moved
//           into the tile their voxel lies in, so that the Gaussians' tile
//           bins (splat_bin.cu) serve them as they serve the raster grid.
//
// In one call with no host read: the number of points bounds every array.
//   1. a stable LSD radix sort of the point indices by tile (bin_sort.cuh,
//      the counting sort's ranking of bin_rank.cuh: no atomic decides an
//      order), in one or two passes of at most MAX_BITS bits, three
//      launches a pass; a point's tile is recomputed from its coordinates
//      wherever a pass reads it;
//   2. each tile's first place in the sorted order (a binary search);
//   3. one block: the work items, each tile's points cut into runs of at
//      most TILE_VOXELS in order (an item is the sorted place of its first
//      point), and the tiles by descending count of points (ties by index),
//      so that K7's longest tiles start first.
//
// Bound on the H100: bytes, and launch latency at these sizes (the points
// once a pass, a few int32 words a point).
#include "bin_sort.cuh"
#include "splat_points.cuh"

namespace {

using gf::splat::Grid;
using gf::splat::TILE_VOXELS;

constexpr int MAX_BITS = 10;            // digit bits of a pass
constexpr int POINTS_PER_BLOCK = 4096;  // of a sort pass's blocks
constexpr int MAX_BLOCKS = 512;
constexpr int ITEMS = 8;                // keys a lane computes at once
constexpr int SCAN_THREADS = 1024;
constexpr int MAX_TILES = 4096;

__device__ __forceinline__ int tile_of_point(const float* __restrict__ pts,
                                             long i, const Grid& g) {
  return gf::splat::tile_index(gf::splat::voxel_of(pts, i, g), g);
}

// The first pass's items: the points in input order, keyed by their tile.
struct PointItems {
  const float* pts;
  Grid g;

  template <class F>
  __device__ __forceinline__ void walk(long lo, long hi, int*, F&& f) const {
    const int lane = threadIdx.x & 31;
    for (long c = lo; c < hi; c += 32 * ITEMS) {
      int k[ITEMS];
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        const long i = c + 32 * j + lane;
        k[j] = i < hi ? tile_of_point(pts, i, g) : 0;
      }
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        const long i = c + 32 * j + lane;
        f(i < hi, k[j], (int)i);
      }
    }
  }
};

// The second pass's items: the first pass's order, keys recomputed.
struct OrderItems {
  const int* vals;
  const float* pts;
  Grid g;

  template <class F>
  __device__ __forceinline__ void walk(long lo, long hi, int*, F&& f) const {
    const int lane = threadIdx.x & 31;
    for (long c = lo; c < hi; c += 32 * ITEMS) {
      int v[ITEMS], k[ITEMS];
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        const long e = c + 32 * j + lane;
        v[j] = e < hi ? __ldcs(vals + e) : 0;
      }
#pragma unroll
      for (int j = 0; j < ITEMS; ++j)
        k[j] = c + 32 * j + lane < hi ? tile_of_point(pts, v[j], g) : 0;
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) f(c + 32 * j + lane < hi, k[j], v[j]);
    }
  }
};

// start[t] for t in [0, T]: the first sorted place whose point's tile is
// >= t (a binary search, each probe's tile recomputed).
__global__ void points_start_kernel(const int* __restrict__ order, int N,
                                    const float* __restrict__ pts, Grid g,
                                    int T, int* __restrict__ start) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t > T) return;
  int lo = 0, hi = N;
  while (lo < hi) {
    const int mid = (int)(((unsigned)lo + (unsigned)hi) >> 1);
    if (tile_of_point(pts, order[mid], g) < t)
      lo = mid + 1;
    else
      hi = mid;
  }
  start[t] = lo;
}

// One block: items [I + 1] (the items' first places in tile order, then -1
// up to I, and items[I] their count) and tile_order [T] (the tiles by
// descending count of points, ties by index).
__global__ void __launch_bounds__(SCAN_THREADS)
points_items_kernel(int T, const int* __restrict__ start, int I,
                    int* __restrict__ items, int* __restrict__ tile_order) {
  __shared__ int s_total;
  const int tid = threadIdx.x;
  const int per = (T + SCAN_THREADS - 1) / SCAN_THREADS;
  const int t0 = min(tid * per, T), t1 = min(t0 + per, T);
  int mine = 0;
  for (int t = t0; t < t1; ++t)
    mine += (start[t + 1] - start[t] + TILE_VOXELS - 1) / TILE_VOXELS;
  int k = gf::binrank::block_exclusive_sum(mine);
  for (int t = t0; t < t1; ++t)
    for (int p = start[t]; p < start[t + 1]; p += TILE_VOXELS) items[k++] = p;
  if (tid == SCAN_THREADS - 1) {
    s_total = k;
    items[I] = k;
  }
  __syncthreads();
  for (int i = s_total + tid; i < I; i += SCAN_THREADS) items[i] = -1;
  for (int t = tid; t < T; t += SCAN_THREADS) {
    const int len = start[t + 1] - start[t];
    int rank = 0;
    for (int u = 0; u < T; ++u) {
      const int lu = start[u + 1] - start[u];
      rank += lu > len || (lu == len && u < t);
    }
    tile_order[rank] = t;
  }
}

struct Plan {
  Grid g;
  int T, blocks, passes, bits[2];
  long ws_words, items;
};

// -1 for more than MAX_TILES tiles or 2^31 points
int plan_of(long N, const float* pc_min, float gs, int GH, int GW, int GD,
            Plan* pl) {
  pl->g = gf::splat::grid_of(pc_min, gs, GH, GW, GD);
  pl->T = gf::splat::tiles_of(pl->g);
  if (GH < 1 || GW < 1 || GD < 1 || pl->T > MAX_TILES || N < 0 ||
      N >= (1L << 31))
    return -1;
  int nbits = 1;
  while ((1 << nbits) < pl->T) ++nbits;
  pl->passes = nbits > MAX_BITS ? 2 : 1;
  pl->bits[0] = pl->passes == 2 ? (nbits + 1) / 2 : nbits;
  pl->bits[1] = nbits - pl->bits[0];
  const long blocks = (N + POINTS_PER_BLOCK - 1) / POINTS_PER_BLOCK;
  pl->blocks = (int)(blocks < 1 ? 1 : (blocks > MAX_BLOCKS ? MAX_BLOCKS
                                                           : blocks));
  pl->ws_words = gf::binsort::work_words(N, pl->blocks, MAX_BITS);
  // a tile of n points gives ceil(n / TILE_VOXELS) <= n / TILE_VOXELS + 1
  // items, and only a tile with points gives any
  pl->items = N / TILE_VOXELS + (N < pl->T ? N : pl->T);
  return 0;
}

}  // namespace

// For N points on the grid (GH, GW, GD): out[0] the int32 words of the
// binning's workspace, out[1] the bound I on its work items (items holds
// I + 1 words). Returns -1 for more than 4096 tiles or 2^31 points.
GF_EXPORT int gf_splat_points_bin_sizes(long long N, int GH, int GW, int GD,
                                        long long* out) {
  const float pc[3] = {0.f, 0.f, 0.f};
  Plan pl;
  if (plan_of(N, pc, 1.f, GH, GW, GD, &pl)) return -1;
  out[0] = pl.ws_words;
  out[1] = pl.items;
  return 0;
}

// pts [N, 3] fp32; pc_min: 3 host floats; voxel grid (GH, GW, GD) of edge
// `gs`; ws: the workspace (gf_splat_points_bin_sizes). Writes order [N]
// int32 (the point indices sorted stably by tile), start [T + 1] (tile t's
// points are order[start[t], start[t + 1])), items [I + 1] (the work
// items' first places, -1 past their count, which is items[I]) and
// tile_order [T] (the tiles by descending count of points, ties by index).
// Launches on `stream`, no host read. Returns a cudaError_t, or -1 for an
// unsupported shape.
GF_EXPORT int gf_splat_points_bin(const void* pts, long long N,
                                  const float* pc_min, float gs, int GH,
                                  int GW, int GD, void* ws, void* order,
                                  void* start, void* items, void* tile_order,
                                  void* stream) {
  Plan pl;
  if (plan_of(N, pc_min, gs, GH, GW, GD, &pl)) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  const gf::binsort::Work wk =
      gf::binsort::work_of(ws, N, pl.blocks, MAX_BITS);
  const bool two = pl.passes == 2;
  int* out = (int*)order;
  PointItems first{(const float*)pts, pl.g};
  int err = gf::binsort::sort_pass(first, nullptr, N, 0, pl.bits[0],
                                   pl.blocks, wk, nullptr,
                                   two ? wk.vals0 : out, st);
  if (err) return err;
  if (two) {
    OrderItems second{wk.vals0, (const float*)pts, pl.g};
    err = gf::binsort::sort_pass(second, nullptr, N, pl.bits[0], pl.bits[1],
                                 pl.blocks, wk, nullptr, out, st);
    if (err) return err;
  }
  points_start_kernel<<<(pl.T + 1 + 255) / 256, 256, 0, st>>>(
      out, (int)N, (const float*)pts, pl.g, pl.T, (int*)start);
  points_items_kernel<<<1, SCAN_THREADS, 0, st>>>(
      pl.T, (const int*)start, (int)pl.items, (int*)items, (int*)tile_order);
  return (int)cudaGetLastError();
}
