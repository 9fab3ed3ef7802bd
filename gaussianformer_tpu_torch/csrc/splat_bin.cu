// The per-tile Gaussian lists of the splat kernels K4 and K7 (the layout is
// described in splat_bin.cuh).
//
// Replaces: the per-tile chunk table that
//           gaussianformer_tpu/ops/pallas/splat_kernel.py splat_raw_pallas
//           builds before its pallas_call (the overlap matrix, the COVERS
//           bit and the stable argsort, :343-366): here per Gaussian rather
//           than per chunk of Gaussians, since a Hopper block can gather
//           each Gaussian it needs.
//
// The reference CUDA's preprocess -> scan -> duplicate -> sort, with a
// stable counting sort by tile in place of its radix sort, in two calls.
// The Gaussians go in blocks of GBLOCK (by index).
// gf_splat_bin_count, which ends in the binning's one host read:
//   1. count: per Gaussian, the number of tiles its clipped box meets, and
//      per block their sum; in the same launch, per point, whether the
//      points are the raster grid;
//   2. offsets (one block): the blocks' sums scanned; the entry total and
//      the raster flag are copied to the host.
// gf_splat_bin_build:
//   3. expand: each Gaussian's range of entries (its block's offset + the
//      counts before it in the block); its (tile, entry) pairs written
//      there, tiles in raster order (the Gaussian-major order); per block,
//      its entries of each tile;
//   4. columns: per tile, the blocks' counts scanned in block order;
//   5. tiles (one block): the tiles' starts, and the splat kernels' work
//      items: the tiles by descending list length (ties by index), so that
//      the longest lists start first, and a tile with more than twice the
//      mean entries as two items, so that no block holds the others up (K4
//      splits the tile's voxels in two, K7 its entries);
//   6. place: each entry goes to its tile's start + the earlier blocks' and
//      warps' entries of that tile + its rank among its warp's earlier
//      entries of that tile (a tile's Gaussians stay in ascending index
//      order; the ranking of bin_rank.cuh); its Gaussian-major position is
//      its slot.
// At most MAX_TILES tiles.
//
// Bound on the H100: bytes, and launch latency at these sizes (the boxes,
// the points for the raster check, and a few int32 words per entry).
#include <math.h>

#include "bin_rank.cuh"
#include "splat_bin.cuh"

namespace {

using namespace gf::splat;
using gf::binrank::block_exclusive_sum;

constexpr int GBLOCK = 256;        // Gaussians a block of count and expand
constexpr int PLACE_WARPS = 8;
constexpr int SCAN_THREADS = 1024;
constexpr int MAX_TILES = 4096;

__device__ __forceinline__ int tiles_met(const int* __restrict__ b, int GH,
                                         int GW, int GD) {
  const int dims[3] = {GH, GW, GD};
  const int tile[3] = {TX, TY, TZ};
  int cnt = 1;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int lo = max(b[a], 0);
    const int hi = min(b[3 + a], dims[a] - 1);
    cnt = lo <= hi ? cnt * (hi / tile[a] - lo / tile[a] + 1) : 0;
  }
  return cnt;
}

// meta [blocks + 2]: each block's sum of counts at [block]; the raster flag
// at [blocks + 1], zeroed by the caller.
__global__ void __launch_bounds__(GBLOCK)
bin_count_kernel(const float* __restrict__ pts, int N,
                 const int* __restrict__ box, int P, float pcx, float pcy,
                 float pcz, float gs, int GH, int GW, int GD,
                 int* __restrict__ counts, int* __restrict__ meta) {
  const long i = (long)blockIdx.x * GBLOCK + threadIdx.x;
  const int blocks = (P + GBLOCK - 1) / GBLOCK;
  if (blockIdx.x < blocks) {
    const int cnt = i < P ? tiles_met(box + 6 * i, GH, GW, GD) : 0;
    if (i < P) counts[i] = cnt;
    int sum = cnt;
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    __shared__ int s_sum[GBLOCK / 32];
    if ((threadIdx.x & 31) == 0) s_sum[threadIdx.x >> 5] = sum;
    __syncthreads();
    if (threadIdx.x == 0) {
      int s = 0;
      for (int w = 0; w < GBLOCK / 32; ++w) s += s_sum[w];
      meta[blockIdx.x] = s;
    }
  }
  if (i < N) {
    // the voxel of point i, as ops/splat.py::SplatGridSpec.voxelize
    const float pc[3] = {pcx, pcy, pcz};
    const int dims[3] = {GH, GW, GD};
    int iv[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int v = (int)floorf((pts[3 * i + a] - pc[a]) / gs);
      iv[a] = min(max(v, 0), dims[a] - 1);
    }
    if (((long)iv[0] * GW + iv[1]) * GD + iv[2] != i) meta[blocks + 1] = 1;
  }
}

// One block: meta[0, blocks) scanned in place (each block's first entry),
// meta[blocks] the total.
__global__ void __launch_bounds__(SCAN_THREADS)
bin_offsets_kernel(int* __restrict__ meta, int blocks) {
  const int per = (blocks + SCAN_THREADS - 1) / SCAN_THREADS;
  const int b0 = min((int)threadIdx.x * per, blocks);
  const int b1 = min(b0 + per, blocks);
  int sum = 0;
  for (int b = b0; b < b1; ++b) sum += meta[b];
  int run = block_exclusive_sum(sum);
  for (int b = b0; b < b1; ++b) {
    const int v = meta[b];   // only this thread reads or writes b
    meta[b] = run;
    run += v;
  }
  if (threadIdx.x == SCAN_THREADS - 1) meta[blocks] = run;
}

// Per block of GBLOCK Gaussians: their entries (keys: the tile, vals: the
// Gaussian with COVERS) and gauss_start; hist[t][block], the block's
// entries of tile t.
__global__ void __launch_bounds__(GBLOCK)
bin_expand_kernel(const int* __restrict__ box, int P, int GH, int GW, int GD,
                  int T, const int* __restrict__ counts,
                  const int* __restrict__ offsets,
                  int* __restrict__ gauss_start, int* __restrict__ keys,
                  int* __restrict__ vals, int* __restrict__ hist) {
  extern __shared__ int s_hist[];   // [T]
  const int blocks = gridDim.x;
  for (int t = threadIdx.x; t < T; t += GBLOCK) s_hist[t] = 0;
  const int g = blockIdx.x * GBLOCK + threadIdx.x;
  const int cnt = g < P ? counts[g] : 0;
  int k = offsets[blockIdx.x] + block_exclusive_sum(cnt);
  if (g < P) gauss_start[g] = k;
  if (g == P - 1) gauss_start[P] = k + cnt;
  if (cnt > 0) {
    const int* b = box + 6 * (long)g;
    const int lo0 = max(b[0], 0), lo1 = max(b[1], 0), lo2 = max(b[2], 0);
    const int hi0 = min(b[3], GH - 1), hi1 = min(b[4], GW - 1),
              hi2 = min(b[5], GD - 1);
    const int nty = (GW + TY - 1) / TY, ntz = (GD + TZ - 1) / TZ;
    for (int tx = lo0 / TX; tx <= hi0 / TX; ++tx) {
      const int x0 = tx * TX, x1 = min(x0 + TX, GH) - 1;
      const bool cx = b[0] <= x0 && b[3] >= x1;
      for (int ty = lo1 / TY; ty <= hi1 / TY; ++ty) {
        const int y0 = ty * TY, y1 = min(y0 + TY, GW) - 1;
        const bool cy = cx && b[1] <= y0 && b[4] >= y1;
        for (int tz = lo2 / TZ; tz <= hi2 / TZ; ++tz, ++k) {
          const int z0 = tz * TZ, z1 = min(z0 + TZ, GD) - 1;
          const bool covers = cy && b[2] <= z0 && b[5] >= z1;
          const int t = (tx * nty + ty) * ntz + tz;
          keys[k] = t;
          vals[k] = g | (covers ? COVERS : 0);
          atomicAdd(&s_hist[t], 1);
        }
      }
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < T; t += GBLOCK)
    hist[(long)t * blocks + blockIdx.x] = s_hist[t];
}

// A warp per tile: hist[t][0, blocks) scanned in place (exclusive); the
// tile's total to tile_start[t] (scanned over the tiles next).
__global__ void __launch_bounds__(256)
bin_columns_kernel(int* __restrict__ hist, int blocks, int T,
                   int* __restrict__ tile_start) {
  const int t = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (t >= T) return;   // the whole warp
  int* h = hist + (long)t * blocks;
  int carry = 0;
  for (int b0 = 0; b0 < blocks; b0 += 32) {
    const int v = b0 + lane < blocks ? h[b0 + lane] : 0;
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    if (b0 + lane < blocks) h[b0 + lane] = carry + incl - v;
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) tile_start[t] = carry;
}

// One block: tile_start [T + 1] (the tiles' totals scanned in place) and
// the work items (items [2 T + 1]): item = 4 t + (0 whole, 1 first half,
// 2 second half); items[2 T] counts them, and the rest of items is -1.
__global__ void __launch_bounds__(SCAN_THREADS)
bin_tiles_kernel(int T, int E, int* __restrict__ tile_start,
                 int* __restrict__ items) {
  extern __shared__ int s_start[];   // [T + 1], then the tile of each rank
  int* s_by_rank = s_start + T + 1;
  const int tid = threadIdx.x;
  // a run of `per` consecutive tiles (or ranks) a thread
  const int per = (T + SCAN_THREADS - 1) / SCAN_THREADS;
  const int t0 = min(tid * per, T), t1 = min(t0 + per, T);
  int sum = 0;
  for (int t = t0; t < t1; ++t) sum += tile_start[t];
  int run = block_exclusive_sum(sum);
  for (int t = t0; t < t1; ++t) {
    const int v = tile_start[t];   // only this thread reads or writes t
    s_start[t] = run;
    tile_start[t] = run;
    run += v;
  }
  if (tid == 0) {
    s_start[T] = E;
    tile_start[T] = E;
  }
  __syncthreads();
  for (int t = tid; t < T; t += SCAN_THREADS) {
    const int len = s_start[t + 1] - s_start[t];
    int rank = 0;
    for (int u = 0; u < T; ++u) {
      const int lu = s_start[u + 1] - s_start[u];
      rank += lu > len || (lu == len && u < t);
    }
    s_by_rank[rank] = t;
  }
  __syncthreads();
  int parts = 0;
  for (int r = t0; r < t1; ++r) {
    const int t = s_by_rank[r];
    parts += (long)(s_start[t + 1] - s_start[t]) * T > 2L * E ? 2 : 1;
  }
  int k = block_exclusive_sum(parts);
  for (int r = t0; r < t1; ++r) {
    const int t = s_by_rank[r];
    if ((long)(s_start[t + 1] - s_start[t]) * T > 2L * E) {
      items[k++] = 4 * t + 1;
      items[k++] = 4 * t + 2;
    } else {
      items[k++] = 4 * t;
    }
  }
  if (tid == SCAN_THREADS - 1) {
    for (int i = k; i < 2 * T; ++i) items[i] = -1;
    items[2 * T] = k;
  }
}

// Per block of GBLOCK Gaussians, a warp for each eighth of their entries
// in order: each entry's place in the tile-major list.
__global__ void __launch_bounds__(PLACE_WARPS * 32)
bin_place_kernel(const int* __restrict__ keys, const int* __restrict__ vals,
                 int T, const int* __restrict__ offsets,
                 const int* __restrict__ hist,
                 const int* __restrict__ tile_start,
                 int* __restrict__ entries, int* __restrict__ slot) {
  extern __shared__ int s_wc[];   // [PLACE_WARPS][T]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int blocks = gridDim.x;
  for (int i = tid; i < PLACE_WARPS * T; i += PLACE_WARPS * 32) s_wc[i] = 0;
  __syncthreads();
  int* wc = s_wc + warp * T;
  const int e0 = offsets[blockIdx.x], len = offsets[blockIdx.x + 1] - e0;
  const int lo = e0 + (int)((long)len * warp / PLACE_WARPS);
  const int hi = e0 + (int)((long)len * (warp + 1) / PLACE_WARPS);
  // each warp's entries of each tile
  for (int s = lo; s < hi; s += 32) {
    const int e = s + lane;
    gf::binrank::count_round(e < hi, e < hi ? keys[e] : 0, wc);
  }
  __syncthreads();
  // each warp's first place in each tile
  for (int t = tid; t < T; t += PLACE_WARPS * 32) {
    int run = tile_start[t] + hist[(long)t * blocks + blockIdx.x];
    for (int w = 0; w < PLACE_WARPS; ++w) {
      const int c = s_wc[w * T + t];
      s_wc[w * T + t] = run;
      run += c;
    }
  }
  __syncthreads();
  for (int s = lo; s < hi; s += 32) {
    const int e = s + lane;
    const int pos = gf::binrank::place_round(e < hi, e < hi ? keys[e] : 0,
                                             wc);
    if (pos >= 0) {
      entries[pos] = vals[e];
      slot[pos] = e;
    }
  }
}

int tiles_of(int GH, int GW, int GD) {
  return ((GH + TX - 1) / TX) * ((GW + TY - 1) / TY) * ((GD + TZ - 1) / TZ);
}

}  // namespace

// The tile's edge in voxels along x, y and z (TX, TY, TZ), and the
// Gaussians a block of the binning (the size of its scratch).
GF_EXPORT void gf_splat_tile_dims(int* out) {
  out[0] = TX;
  out[1] = TY;
  out[2] = TZ;
  out[3] = GBLOCK;
}

// pts [N, 3] fp32; box [P, 6] int32 (voxel lo xyz, hi xyz); pc_min: 3 host
// floats; voxel grid (GH, GW, GD) of edge `gs`. Writes counts [P] int32
// (the tiles each Gaussian's clipped box meets) and meta, an int32 scratch
// of ceil(P / 256) + 2 words (the blocks' first entries, then the total),
// then reads the entry total to *total (the host), -1 unless point i lies
// in voxel i of the raster order for every i < N. Synchronises the stream.
// Returns a cudaError_t.
GF_EXPORT int gf_splat_bin_count(const void* pts, int N, const void* box,
                                 int P, const float* pc_min, float gs,
                                 int GH, int GW, int GD, void* counts,
                                 void* meta, int* total, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (P + GBLOCK - 1) / GBLOCK;
  int* m = (int*)meta;
  cudaError_t err = cudaMemsetAsync(m + blocks + 1, 0, sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const long n = P > N ? P : N;
  const int grid = n > 0 ? (int)((n + GBLOCK - 1) / GBLOCK) : 1;
  bin_count_kernel<<<grid, GBLOCK, 0, st>>>(
      (const float*)pts, N, (const int*)box, P, pc_min[0], pc_min[1],
      pc_min[2], gs, GH, GW, GD, (int*)counts, m);
  bin_offsets_kernel<<<1, SCAN_THREADS, 0, st>>>(m, blocks);
  int host[2];
  err = cudaMemcpyAsync(host, m + blocks, sizeof(host),
                        cudaMemcpyDeviceToHost, st);
  if (err == cudaSuccess) err = cudaStreamSynchronize(st);
  if (err != cudaSuccess) return (int)err;
  *total = host[1] ? -1 : host[0];
  return (int)cudaGetLastError();
}

// The rest of the binning, after gf_splat_bin_count (its counts and meta,
// and the entry total E): ws, an int32 scratch of 2 E + T ceil(P / 256)
// words. Writes gauss_start [P + 1], entries [E], slot [E], tile_start
// [T + 1] and tile_items [2 T + 1] int32 (T, the tiles of the grid; the
// items as bin_tiles_kernel makes them). Returns a cudaError_t, or -1 for
// more than 4096 tiles.
GF_EXPORT int gf_splat_bin_build(const void* box, int P, int GH, int GW,
                                 int GD, const void* counts, const void* meta,
                                 int E, void* ws, void* gauss_start,
                                 void* entries, void* slot, void* tile_start,
                                 void* tile_items, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int T = tiles_of(GH, GW, GD);
  if (T > MAX_TILES) return -1;
  const int blocks = (P + GBLOCK - 1) / GBLOCK;
  int* keys = (int*)ws;
  int* vals = keys + E;
  int* hist = vals + E;
  const int* offsets = (const int*)meta;
  const size_t place_smem = (size_t)PLACE_WARPS * T * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      bin_place_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)place_smem);
  if (err != cudaSuccess) return (int)err;
  if (blocks > 0) {
    bin_expand_kernel<<<blocks, GBLOCK, T * sizeof(int), st>>>(
        (const int*)box, P, GH, GW, GD, T, (const int*)counts, offsets,
        (int*)gauss_start, keys, vals, hist);
    bin_columns_kernel<<<(T + 7) / 8, 256, 0, st>>>(hist, blocks, T,
                                                    (int*)tile_start);
  } else {
    err = cudaMemsetAsync(gauss_start, 0, sizeof(int), st);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(tile_start, 0, T * sizeof(int), st);
    if (err != cudaSuccess) return (int)err;
  }
  bin_tiles_kernel<<<1, SCAN_THREADS, (2 * T + 1) * sizeof(int), st>>>(
      T, E, (int*)tile_start, (int*)tile_items);
  if (E > 0)
    bin_place_kernel<<<blocks, PLACE_WARPS * 32, place_smem, st>>>(
        keys, vals, T, offsets, hist, (const int*)tile_start,
        (int*)entries, (int*)slot);
  return (int)cudaGetLastError();
}
