// The points binning of the splat kernels' general mode (the layout is
// described in splat_points.cuh): any query points sorted stably by voxel,
// tile-major, each key's first sorted place, and the work items of K4's
// general mode (splat_points.cu). K7's general mode (splat_points_bwd.cu)
// reads a box's points as runs through the first places.
//
// Replaces: the per-tile bounds that
//           gaussianformer_tpu/ops/pallas/splat_kernel.py splat_raw_pallas
//           takes from the points' own voxel coordinates (:334-371) when
//           the points are not declared a raster grid (zrun = 0). There a
//           tile is any tile_n consecutive points and its bounds decide
//           which chunks of Gaussians it visits; here the points are moved
//           into the tile their voxel lies in, so that the Gaussians' tile
//           bins (splat_bin.cu) serve them as they serve the raster grid,
//           and within the tile into their voxel's place.
//
// In one call with no host read: the number of points bounds every array.
//   1. each point's key (point_key: tile << CODE_BITS | place), once;
//   2. a stable LSD radix sort of the point indices by key (bin_sort.cuh,
//      the counting sort's ranking of bin_rank.cuh: no atomic decides an
//      order), in passes of at most MAX_BITS bits (two at the shipped grid:
//      625 tiles x 1024 places is 20 bits), three launches a pass; a later
//      pass reads the keys through the last pass's order (20 MB at 5.12 M
//      points, which the H100's L2 holds);
//   3. the sorted keys, then each key's first sorted place (voxel_start,
//      a binary search a key, all in L2);
//   4. one block: the work items, each tile's points cut into runs of at
//      most TILE_VOXELS in order (an item is the sorted place of its first
//      point).
//
// Bound on the H100: bytes, and launch latency at these sizes (the points
// once, a few int32 words a point a pass).
#include "bin_sort.cuh"
#include "splat_points.cuh"

namespace {

using gf::splat::CODE_BITS;
using gf::splat::Grid;
using gf::splat::TILE_VOXELS;

constexpr int MAX_BITS = 10;            // digit bits of a pass
constexpr int MAX_PASSES = 3;
constexpr int POINTS_PER_BLOCK = 4096;  // of a sort pass's blocks
constexpr int MAX_BLOCKS = 512;
constexpr int ITEMS = 8;                // keys a lane reads at once
constexpr int SCAN_THREADS = 1024;
constexpr int MAX_TILES = 4096;

__global__ void points_key_kernel(const float* __restrict__ pts, long N,
                                  Grid g, int* __restrict__ key) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < N;
       i += (long)gridDim.x * blockDim.x)
    key[i] = gf::splat::point_key(gf::splat::voxel_of(pts, i, g), g);
}

// A pass's items: the last pass's order (the input order for the first),
// each point's key read through it.
struct KeyItems {
  const int* vals;   // null: the input order
  const int* keys;

  template <class F>
  __device__ __forceinline__ void walk(long lo, long hi, int*, F&& f) const {
    const int lane = threadIdx.x & 31;
    for (long c = lo; c < hi; c += 32 * ITEMS) {
      int v[ITEMS], k[ITEMS];
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        const long e = c + 32 * j + lane;
        v[j] = e < hi ? (vals != nullptr ? __ldcs(vals + e) : (int)e) : 0;
      }
#pragma unroll
      for (int j = 0; j < ITEMS; ++j)
        k[j] = c + 32 * j + lane < hi ? keys[v[j]] : 0;
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) f(c + 32 * j + lane < hi, k[j], v[j]);
    }
  }
};

__global__ void sorted_keys_kernel(const int* __restrict__ order, long N,
                                   const int* __restrict__ key,
                                   int* __restrict__ skey) {
  for (long s = blockIdx.x * (long)blockDim.x + threadIdx.x; s < N;
       s += (long)gridDim.x * blockDim.x)
    skey[s] = key[order[s]];
}

// vstart[k] for k in [0, K]: the first sorted place whose key is >= k.
__global__ void voxel_start_kernel(const int* __restrict__ skey, int N, int K,
                                   int* __restrict__ vstart) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k > K) return;
  int lo = 0, hi = N;
  while (lo < hi) {
    const int mid = (int)(((unsigned)lo + (unsigned)hi) >> 1);
    if (skey[mid] < k)
      lo = mid + 1;
    else
      hi = mid;
  }
  vstart[k] = lo;
}

// One block: items [I + 1], the items' first places in tile order, then -1
// up to I, and items[I] their count. Tile t's points start at
// vstart[t * TILE_VOXELS].
__global__ void __launch_bounds__(SCAN_THREADS)
points_items_kernel(int T, const int* __restrict__ vstart, int I,
                    int* __restrict__ items) {
  __shared__ int s_total;
  const int tid = threadIdx.x;
  const int per = (T + SCAN_THREADS - 1) / SCAN_THREADS;
  const int t0 = min(tid * per, T), t1 = min(t0 + per, T);
  auto start = [&](int t) { return vstart[(long)t * TILE_VOXELS]; };
  int mine = 0;
  for (int t = t0; t < t1; ++t)
    mine += (start(t + 1) - start(t) + TILE_VOXELS - 1) / TILE_VOXELS;
  int k = gf::binrank::block_exclusive_sum(mine);
  for (int t = t0; t < t1; ++t)
    for (int p = start(t); p < start(t + 1); p += TILE_VOXELS) items[k++] = p;
  if (tid == SCAN_THREADS - 1) {
    s_total = k;
    items[I] = k;
  }
  __syncthreads();
  for (int i = s_total + tid; i < I; i += SCAN_THREADS) items[i] = -1;
}

struct Plan {
  Grid g;
  int T, K, blocks, passes, bits[MAX_PASSES];
  long sort_words, items;
};

// -1 for more than MAX_TILES tiles or 2^31 points
int plan_of(long N, const float* pc_min, float gs, int GH, int GW, int GD,
            Plan* pl) {
  pl->g = gf::splat::grid_of(pc_min, gs, GH, GW, GD);
  pl->T = gf::splat::tiles_of(pl->g);
  if (GH < 1 || GW < 1 || GD < 1 || pl->T > MAX_TILES || N < 0 ||
      N >= (1L << 31))
    return -1;
  pl->K = pl->T * TILE_VOXELS;
  int nbits = CODE_BITS + 1;
  while ((1 << (nbits - CODE_BITS)) < pl->T) ++nbits;
  pl->passes = (nbits + MAX_BITS - 1) / MAX_BITS;
  for (int p = 0; p < pl->passes; ++p)
    pl->bits[p] = nbits * (p + 1) / pl->passes - nbits * p / pl->passes;
  const long blocks = (N + POINTS_PER_BLOCK - 1) / POINTS_PER_BLOCK;
  pl->blocks = (int)(blocks < 1 ? 1 : (blocks > MAX_BLOCKS ? MAX_BLOCKS
                                                           : blocks));
  pl->sort_words = gf::binsort::work_words(N, pl->blocks, MAX_BITS);
  // a tile of n points gives ceil(n / TILE_VOXELS) <= n / TILE_VOXELS + 1
  // items, and only a tile with points gives any
  pl->items = N / TILE_VOXELS + (N < pl->T ? N : pl->T);
  return 0;
}

}  // namespace

// For N points on the grid (GH, GW, GD): out[0] the int32 words of the
// binning's workspace, out[1] the bound I on its work items (items holds
// I + 1 words), out[2] the keys K (voxel_start holds K + 1 words). Returns
// -1 for more than 4096 tiles or 2^31 points.
GF_EXPORT int gf_splat_points_bin_sizes(long long N, int GH, int GW, int GD,
                                        long long* out) {
  const float pc[3] = {0.f, 0.f, 0.f};
  Plan pl;
  if (plan_of(N, pc, 1.f, GH, GW, GD, &pl)) return -1;
  out[0] = pl.sort_words + N;
  out[1] = pl.items;
  out[2] = pl.K;
  return 0;
}

// pts [N, 3] fp32; pc_min: 3 host floats; voxel grid (GH, GW, GD) of edge
// `gs`; ws: the workspace (gf_splat_points_bin_sizes). Writes order [N]
// int32 (the point indices sorted stably by key: tile, then the voxel's
// place in the tile), voxel_start [K + 1] (key k's points are
// order[voxel_start[k], voxel_start[k + 1]); tile t's are those of keys
// [t * 1024, (t + 1) * 1024)) and items [I + 1] (the work items' first
// places, -1 past their count, which is items[I]). Launches on `stream`,
// no host read. Returns a cudaError_t, or -1 for an unsupported shape.
GF_EXPORT int gf_splat_points_bin(const void* pts, long long N,
                                  const float* pc_min, float gs, int GH,
                                  int GW, int GD, void* ws, void* order,
                                  void* voxel_start, void* items,
                                  void* stream) {
  Plan pl;
  if (plan_of(N, pc_min, gs, GH, GW, GD, &pl)) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  const gf::binsort::Work wk =
      gf::binsort::work_of(ws, N, pl.blocks, MAX_BITS);
  int* key = (int*)ws + pl.sort_words;
  int* out = (int*)order;
  const int grid = (int)((N + 255) / 256 < 4096 ? (N + 255) / 256 : 4096);
  if (N > 0)
    points_key_kernel<<<grid, 256, 0, st>>>((const float*)pts, N, pl.g, key);
  // pass p writes `out` when an even number of passes follow it, so that
  // the last pass ends there
  const int* vals = nullptr;
  int shift = 0;
  for (int p = 0; p < pl.passes; ++p) {
    int* dst = (pl.passes - 1 - p) % 2 == 0 ? out : wk.vals0;
    const int err = gf::binsort::sort_pass(KeyItems{vals, key}, nullptr, N,
                                           shift, pl.bits[p], pl.blocks, wk,
                                           nullptr, dst, st);
    if (err) return err;
    vals = dst;
    shift += pl.bits[p];
  }
  int* skey = wk.vals0;   // free once the sort is done
  if (N > 0) sorted_keys_kernel<<<grid, 256, 0, st>>>(out, N, key, skey);
  voxel_start_kernel<<<(pl.K + 1 + 255) / 256, 256, 0, st>>>(
      skey, (int)N, pl.K, (int*)voxel_start);
  points_items_kernel<<<1, SCAN_THREADS, 0, st>>>(
      pl.T, (const int*)voxel_start, (int)pl.items, (int*)items);
  return (int)cudaGetLastError();
}
