// K7, general mode: Gaussian -> point splat, backward (of K4's general
// mode, splat_points.cu), at any query points, in both variants of the TPU
// kernel: `prob` (GaussianFormer-2) and `additive` (the v1 models).
//
// Replaces: gaussianformer_tpu/ops/pallas/splat_bwd_kernel.py
//           splat_bwd_raw_pallas (kernel `_kernel`), whose points are
//           always arbitrary: it has no raster mode.
//
// Computes splat_bwd.cu's per-Gaussian sums (the exponent's moments in
// d = mu - x, gw and gsem[C]) over every (point, Gaussian) pair inside the
// Gaussian's integer AABB, the point's voxel that of
// SplatGridSpec.voxelize (floor, clamped into the grid), with the same
// per-point cotangents (prob: gl = g_logits / prob_sum and the scalars
// dot_gl, bin_term, g_density; additive: gl = g_logits).
//
// Bound on the H100: flops, as splat_bwd.cu: about 60 + 4 C (prob) or
// 50 + 4 C (additive) fp32 operations a pair.
//
// Design: the points are binned by voxel, tile-major (splat_points_bin.cu),
// so that the points of an entry's box (its Gaussian's box clipped to the
// entry's tile) are one run of the sorted order per (x, y) column of the
// box, found through voxel_start, and a COVERS entry's are the tile's one
// run. The Gaussians keep their tile bins (splat_bin.cu, the forward's).
// An entry's points, in run order, are cut into pieces of PIECE << level
// points; the entries go in groups of consecutive ones (mostly of one
// tile: 32 for prob, 8 for additive), and a block takes piece j of each of
// a group's entries, a warp taking GROUP / 8 of them in turn.
// Launches, all on the caller's stream with no host read:
//   1. gather: the per-point inputs (coordinates, gl rows, the prob
//      scalars) copied once into the sorted order, so that a run is read
//      contiguously;
//   2. plan: per entry its tile and its points n_e (the runs' lengths), and
//      per block of groups the pieces (blocks) its groups make at each
//      level, a group as many as its largest entry;
//   3. one block: the smallest level whose blocks fit the budget (twice
//      the groups the entries' room holds), and the first block of each
//      block of groups;
//   4. per group its first block, and each block's group;
//   5. a block per (group, piece): a warp lays out its entry's runs and the
//      piece's flat range of them. prob: where the block's ranges span at
//      most a raster tile's places and read each of them twice on average
//      (a tile's COVERS entries read the same points), the block stages the
//      span in shared memory once (cp.async) and its warps read it there;
//      else, and always for additive (whose small boxes share few points,
//      and which keeps the SM's L1 whole), the warps read the sorted
//      copies. Lanes take the points 32 apart, each summing the nine
//      moments, gw and gsem[C] in registers; one transposed warp reduction
//      leaves sum v in lane v. A one-piece entry writes its Gaussian-major
//      slot of the workspace (as splat_bwd.cu's tile launch does), a piece
//      of a larger one its own row;
//   6. per entry of more than one piece, its pieces' rows summed in piece
//      order into its slot.
// Then splat_bwd.cu's fold (gf_splat_backward's second launch) sums each
// Gaussian's slots in a fixed order and applies the closing math. The work
// is the box's points, whatever the tile holds besides; a crowded tile or a
// border tile, where the points outside the range fall, gives more pieces,
// not a longer one. No atomics decide a sum and the pieces depend on the
// data alone, so a second call gives the same bits.
#include <limits.h>
#include <math.h>

#include "bin_rank.cuh"
#include "splat_points.cuh"

namespace {

using namespace gf::splat;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PIECE = 1024;   // the fewest points of a piece
// places a prob block stages at most (a raster tile's 1024 and the slack of
// a start rounded down to a multiple of 8)
constexpr int STAGE_ROWS = 1024 + 8;

// The entries of a group, a block's: prob, 32 (a warp takes 4 in turn, over
// one staged span); additive, 8 (a warp each, read from the sorted copies).
template <bool PROB>
__host__ __device__ constexpr int group_of() {
  return PROB ? 32 : 8;
}
// piece sizes PIECE << k for k < LEVELS - 1, one piece an entry at the last
constexpr int LEVELS = 12;
constexpr int PLAN_THREADS = 256;
constexpr int CHOOSE_THREADS = 1024;
constexpr int COMBINE_BLOCKS = 1056;   // 8 an SM
constexpr float NORM_3D = 0.063493635934240969f;   // (2 pi)^-1.5

// groups of 32 per-entry sums (9 moments, gw, gsem[C]), one per lane each
template <int MAXC>
__host__ __device__ constexpr int sum_groups() {
  return (10 + MAXC + 31) / 32;
}

// One step of the transposed warp sum over v[B, B + 2 O): the lanes with
// bit O set keep the upper half (summed with their partner's), the others
// the lower half, in v[B, B + O). (The reduction of splat_bwd.cu.)
template <int O, int B, int N>
__device__ __forceinline__ void transpose_halve(float (&v)[N], int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = upper ? v[B + i] : v[B + i + O];
    const float keep = upper ? v[B + i + O] : v[B + i];
    v[B + i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
  if constexpr (O > 1) transpose_halve<O / 2, B, N>(v, lane);
}

// After it, lane L holds in out[k] the warp's total of v[32 k + L].
template <int G>
__device__ __forceinline__ void warp_transpose_sum(float (&v)[32 * G],
                                                   float (&out)[G]) {
  const int lane = threadIdx.x & 31;
  transpose_halve<16, 0, 32 * G>(v, lane);
  out[0] = v[0];
  if constexpr (G > 1) {
    transpose_halve<16, 32, 32 * G>(v, lane);
    out[1] = v[32];
  }
  static_assert(G <= 2, "at most 64 sums an entry");
}

// The box of an entry in its tile's coordinates, clipped to the tile: its
// (x, y) columns (1 for a COVERS entry: the tile's one run) and the runs'
// z range.
struct EntryBox {
  int tile, ncol, ny, x0, y0, z0, z1;
  bool covers;
};

__device__ __forceinline__ EntryBox entry_box(int tile, int ent,
                                              const int* __restrict__ box,
                                              const Grid& g) {
  EntryBox b;
  b.tile = tile;
  b.covers = ent < 0;
  if (b.covers) {
    b.ncol = 1;
    return b;
  }
  const Tile tl = tile_of(tile, g.GH, g.GW, g.GD);
  const int* bx = box + 6 * (long)(ent & INDEX_MASK);
  b.x0 = max(bx[0], tl.x0) - tl.x0;
  const int x1 = min(bx[3], tl.x0 + tl.ex - 1) - tl.x0;
  b.y0 = max(bx[1], tl.y0) - tl.y0;
  const int y1 = min(bx[4], tl.y0 + tl.ey - 1) - tl.y0;
  b.z0 = max(bx[2], tl.z0) - tl.z0;
  b.z1 = min(bx[5], tl.z0 + tl.ez - 1) - tl.z0;
  b.ny = y1 - b.y0 + 1;
  b.ncol = (x1 - b.x0 + 1) * b.ny;
  return b;
}

// An entry of a block: its index, its piece's flat range, its pieces and
// its box.
struct Meta {
  int e, f0, f1, pieces;
  EntryBox eb;
};

// Column c's run of sorted places [*start, *start + return).
__device__ __forceinline__ int column_run(const EntryBox& b, int c,
                                          const int* __restrict__ vstart,
                                          int* start) {
  const long base = (long)b.tile * TILE_VOXELS;
  if (b.covers) {
    *start = vstart[base];
    return vstart[base + TILE_VOXELS] - *start;
  }
  const int x = b.x0 + c / b.ny, y = b.y0 + c % b.ny;
  const int col = x << CODE_X | y << CODE_Y;
  *start = vstart[base + (col | b.z0)];
  return vstart[base + (col | b.z1) + 1] - *start;
}

// 1. the per-point inputs in the sorted order: a warp copies 32 places'
// coordinates (and dot_gl) as float4, their scalars (bin_term, g_density)
// as float2, and their gl rows as one contiguous block.
__global__ void __launch_bounds__(THREADS)
gather_kernel(const int* __restrict__ order, int N,
              const float* __restrict__ pts, const float* __restrict__ gl,
              const float* __restrict__ scal, int C,
              float4* __restrict__ spt, float2* __restrict__ ssc,
              float* __restrict__ sgl) {
  const int lane = threadIdx.x & 31;
  const long s0 = ((long)blockIdx.x * WARPS + (threadIdx.x >> 5)) * 32;
  if (s0 >= N) return;   // the whole warp
  const int rows = (int)min(32L, N - s0);
  const int i = lane < rows ? order[s0 + lane] : 0;
  if (lane < rows) {
    const float* p = pts + 3 * (long)i;
    const float* sc = scal != nullptr ? scal + 3 * (long)i : nullptr;
    spt[s0 + lane] = make_float4(p[0], p[1], p[2],
                                 sc != nullptr ? sc[0] : 0.f);
    if (sc != nullptr) ssc[s0 + lane] = make_float2(sc[1], sc[2]);
  }
  float* dst = sgl + s0 * C;
  const int total = rows * C;
  for (int f0 = 0; f0 < total; f0 += 32) {
    const int f = f0 + lane;
    const int r = min(f / C, rows - 1);
    const int src = __shfl_sync(0xffffffffu, i, r);   // every lane
    if (f < total) dst[f] = gl[(long)src * C + (f - r * C)];
  }
}

// an entry of n points in pieces of PIECE << level (one at the last level)
__device__ __forceinline__ int pieces_of(int n, int level) {
  return level == LEVELS - 1
             ? 1
             : max(1, (int)(((long)n + (PIECE << level) - 1) >> (10 + level)));
}
static_assert(PIECE == 1 << 10, "the shift of pieces_of");

// the largest over each aligned group of GROUP lanes, in every lane of it
template <int GROUP>
__device__ __forceinline__ int group_max(int v) {
#pragma unroll
  for (int o = 1; o < GROUP; o <<= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Issue the cp.async copies of n floats from src to dst, both 16-byte
// aligned: 16 bytes a copy, 4 for the tail.
__device__ __forceinline__ void stage_async(float* dst, const float* src,
                                            int n) {
  const int n16 = n >> 2;
  for (int i = threadIdx.x; i < n16; i += THREADS)
    gf::cp_async16(dst + 4 * i, src + 4 * i, true);
  for (int i = 4 * n16 + threadIdx.x; i < n; i += THREADS)
    cp_async4(dst + i, src + i);
}

// 2. per entry its tile (etile) and points (cnt), and per block of groups
// the blocks its groups make at each level: bsum[block][k].
template <int GROUP>
__global__ void __launch_bounds__(PLAN_THREADS)
plan_count_kernel(const int* __restrict__ ts, int T,
                  const int* __restrict__ entries,
                  const int* __restrict__ box,
                  const int* __restrict__ vstart, Grid g, int ecap,
                  int* __restrict__ etile, int* __restrict__ cnt,
                  int* __restrict__ bsum) {
  __shared__ int s_sum[PLAN_THREADS / 32][LEVELS];
  const int e = blockIdx.x * PLAN_THREADS + threadIdx.x;
  const int E = ts[T];
  int n = 0;
  if (e < E) {
    // the entry's tile: the last t with ts[t] <= e (entries are tile-major)
    int lo = 0, hi = T;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (ts[mid] <= e)
        lo = mid;
      else
        hi = mid;
    }
    etile[e] = lo;
    const EntryBox b = entry_box(lo, entries[e], box, g);
    for (int c = 0; c < b.ncol; ++c) {
      int st;
      n += column_run(b, c, vstart, &st);
    }
  }
  if (e < ecap) cnt[e] = n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < LEVELS; ++k) {
    int pk = group_max<GROUP>(e < E ? pieces_of(n, k) : 0);
    pk = __reduce_add_sync(0xffffffffu, lane % GROUP == 0 ? pk : 0);
    if (lane == 0) s_sum[warp][k] = pk;
  }
  __syncthreads();
  if (threadIdx.x < LEVELS) {
    int s = 0;
    for (int w = 0; w < PLAN_THREADS / 32; ++w) s += s_sum[w][threadIdx.x];
    bsum[(long)blockIdx.x * LEVELS + threadIdx.x] = s;
  }
}

// 3. one block: the blocks' total at each level, the smallest level whose
// total fits `budget` (hdr[0] the level, hdr[1] the total), and the first
// block of each block of groups at it (boff).
__global__ void __launch_bounds__(CHOOSE_THREADS)
plan_choose_kernel(const int* __restrict__ bsum, int nb, int budget,
                   int* __restrict__ boff, int* __restrict__ hdr) {
  __shared__ int s_tot[CHOOSE_THREADS / 32][LEVELS];
  __shared__ int s_level;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (nb + CHOOSE_THREADS - 1) / CHOOSE_THREADS;
  const int b0 = min(tid * per, nb), b1 = min(b0 + per, nb);
#pragma unroll
  for (int k = 0; k < LEVELS; ++k) {
    int t = 0;
    for (int b = b0; b < b1; ++b) t += bsum[(long)b * LEVELS + k];
    t = __reduce_add_sync(0xffffffffu, t);
    if (lane == 0) s_tot[warp][k] = t;
  }
  __syncthreads();
  if (tid < 32) {
    // lane k < LEVELS: level k's total
    int t = 0;
    if (lane < LEVELS)
      for (int w = 0; w < CHOOSE_THREADS / 32; ++w) t += s_tot[w][lane];
    const unsigned fits =
        __ballot_sync(0xffffffffu, lane < LEVELS && t <= budget);
    if (lane == 0) s_level = fits ? __ffs(fits) - 1 : LEVELS - 1;
  }
  __syncthreads();
  const int level = s_level;
  int mine = 0;
  for (int b = b0; b < b1; ++b) mine += bsum[(long)b * LEVELS + level];
  int run = gf::binrank::block_exclusive_sum(mine);
  for (int b = b0; b < b1; ++b) {
    boff[b] = run;
    run += bsum[(long)b * LEVELS + level];
  }
  if (tid == CHOOSE_THREADS - 1) {
    hdr[0] = level;
    hdr[1] = run;
  }
}

// 4. per group its first block, and each block's group.
template <int GROUP>
__global__ void __launch_bounds__(PLAN_THREADS)
plan_expand_kernel(const int* __restrict__ ts, int T,
                   const int* __restrict__ cnt, const int* __restrict__ hdr,
                   const int* __restrict__ boff, int* __restrict__ gfirst,
                   int* __restrict__ block_group) {
  const int e = blockIdx.x * PLAN_THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int pieces =
      group_max<GROUP>(e < ts[T] ? pieces_of(cnt[e], hdr[0]) : 0);
  const int mine = lane % GROUP == 0 ? pieces : 0;
  const int first = boff[blockIdx.x] + gf::binrank::block_exclusive_sum(mine);
  if (lane % GROUP != 0 || pieces == 0) return;
  const int group = e / GROUP;
  gfirst[group] = first;
  for (int q = 0; q < pieces; ++q) block_group[first + q] = group;
}

// 5. a block per (group, piece).
template <int MAXC, bool PROB>
__global__ void __launch_bounds__(THREADS, 2)
piece_kernel(const int* __restrict__ ts, int T,
             const int* __restrict__ entries, const int* __restrict__ slot,
             const int* __restrict__ box, const int* __restrict__ vstart,
             Grid g, const int* __restrict__ etile,
             const int* __restrict__ cnt, const int* __restrict__ hdr,
             const int* __restrict__ gfirst,
             const int* __restrict__ block_group,
             const float* __restrict__ gdata, const float* __restrict__ opa,
             const float* __restrict__ sem, const float4* __restrict__ spt,
             const float2* __restrict__ ssc, const float* __restrict__ sgl,
             int c_arg, float* __restrict__ work, float* __restrict__ pbuf,
             unsigned long long* __restrict__ block_ns) {
  constexpr int G = sum_groups<MAXC>();
  constexpr int GROUP = group_of<PROB>();
  constexpr int PER = GROUP / WARPS;   // entries a warp takes in turn
  // the staged span (prob): (x, y, z, dot_gl), (bin_term, g_density) and
  // the gl rows of STAGE_ROWS places
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_start[WARPS][64];
  __shared__ int s_pre[WARPS][65];
  __shared__ int s_span[WARPS][3];   // first place, end place, points
  // prob: each warp's entries, from the first pass to the second
  __shared__ Meta s_meta[WARPS][PROB ? PER : 1];
  // prob: the group's Gaussians (gdata, opacity and semantic row, GW words
  // each), staged once for the warps' turns
  constexpr int GW = 10 + MAXC;
  __shared__ float s_gauss[PROB ? GROUP * GW : 1];
  const int b = blockIdx.x;
  if (b >= hdr[1]) return;   // the whole block
  const unsigned long long t_begin = block_ns != nullptr ? global_ns() : 0;
  const int C = MAXC == 18 ? 18 : c_arg;
  const int WS = round4(10 + C);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = block_group[b];
  const int j = b - gfirst[group];
  const int level = hdr[0];
  const int E = ts[T];

  if (PROB) {
    // the group's Gaussians' tables (4-byte copies: rows of 9, 1 and C)
    for (int i = threadIdx.x; i < GROUP * (10 + C); i += THREADS) {
      const int m = i / (10 + C), k = i - m * (10 + C);
      const int e = group * GROUP + m;
      if (e >= E) continue;
      const long gi = entries[e] & INDEX_MASK;
      const float* src = k < 9 ? gdata + 9 * gi + k
                               : (k == 9 ? opa + gi : sem + gi * C + (k - 10));
      cp_async4(s_gauss + m * GW + k, src);
    }
    gf::cp_async_commit();
  }

  // entry r of the warp: its piece's flat range and box; returns the
  // entry's pieces (j >= them: the block has no piece of it)
  auto entry_of = [&](int r, int& e, int& f0, int& f1, EntryBox& eb) {
    e = group * GROUP + warp + WARPS * r;
    const int n = e < E ? cnt[e] : 0;
    const int pieces = e < E ? pieces_of(n, level) : 0;
    f0 = f1 = 0;
    eb.ncol = 0;
    if (j < pieces) {
      f0 = level == LEVELS - 1 ? 0 : j * (PIECE << level);
      f1 = level == LEVELS - 1 ? n : min(n, f0 + (PIECE << level));
      eb = entry_box(etile[e], entries[e], box, g);
    }
    return pieces;
  };
  // an entry's runs laid out in s_start[warp] / s_pre[warp]
  auto runs_of = [&](const EntryBox& eb) {
    __syncwarp();   // the last entry's runs are read
    int carry = 0;
    for (int c0 = 0; c0 < eb.ncol; c0 += 32) {
      int st = 0, len = 0;
      if (c0 + lane < eb.ncol) len = column_run(eb, c0 + lane, vstart, &st);
      int incl = len;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      if (c0 + lane < eb.ncol) {
        s_start[warp][c0 + lane] = st;
        s_pre[warp][c0 + lane] = carry + incl - len;
      }
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) s_pre[warp][eb.ncol] = carry;
    __syncwarp();
  };
  // the place of flat index f, from column `col` on
  auto place = [&](int f, int& col) {
    while (s_pre[warp][col + 1] <= f) ++col;
    return s_start[warp][col] + (f - s_pre[warp][col]);
  };

  // prob: the warps' entries (kept for the second pass), the block's span
  // of places and its points, and whether to stage the span (from a
  // multiple of 8 places, so that every copy is of 16 bytes but a row
  // tail's): when it fits and each of its points is read twice on average.
  // A COVERS entry's places are the tile's run from its start.
  bool staged = false;
  int first = 0;
  if (PROB) {
    int e[PER], f0[PER], f1[PER], np[PER];
    EntryBox eb[PER];
#pragma unroll
    for (int r = 0; r < PER; ++r) np[r] = entry_of(r, e[r], f0[r], f1[r], eb[r]);
    int base[PER];
#pragma unroll
    for (int r = 0; r < PER; ++r)
      base[r] = f1[r] > f0[r] && eb[r].covers
                    ? vstart[(long)eb[r].tile * TILE_VOXELS]
                    : 0;
    int lo = INT_MAX, hi = 0, total = 0;
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      if (f1[r] <= f0[r]) continue;
      if (eb[r].covers) {
        lo = min(lo, base[r] + f0[r]);
        hi = max(hi, base[r] + f1[r]);
      } else {
        runs_of(eb[r]);
        int col = 0;
        lo = min(lo, place(f0[r], col));
        hi = max(hi, place(f1[r] - 1, col) + 1);
      }
      total += f1[r] - f0[r];
    }
    if (lane == 0) {
      s_span[warp][0] = lo;
      s_span[warp][1] = hi;
      s_span[warp][2] = total;
#pragma unroll
      for (int r = 0; r < PER; ++r)
        s_meta[warp][r] = Meta{e[r], f0[r], f1[r], np[r], eb[r]};
    }
    __syncthreads();
    lo = INT_MAX, hi = 0, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      lo = min(lo, s_span[w][0]);
      hi = max(hi, s_span[w][1]);
      total += s_span[w][2];
    }
    first = lo & ~7;
    staged = hi > lo && hi - first <= STAGE_ROWS && total >= 2 * (hi - lo);
    if (staged) {
      const int rows = hi - first;
      stage_async(smem, reinterpret_cast<const float*>(spt + first),
                  4 * rows);
      stage_async(smem + 4 * STAGE_ROWS,
                  reinterpret_cast<const float*>(ssc + first), 2 * rows);
      stage_async(smem + 6 * STAGE_ROWS, sgl + (long)first * C, rows * C);
      gf::cp_async_commit();
    }
    gf::cp_async_wait<0>();
    __syncthreads();   // the Gaussians' tables and the staged span
  }
  const float4* w_pt = reinterpret_cast<const float4*>(smem);
  const float2* w_sc = reinterpret_cast<const float2*>(smem + 4 * STAGE_ROWS);
  const float* w_gl = smem + 6 * STAGE_ROWS;

  for (int r = 0; r < PER; ++r) {
    int e, f0, f1, pieces;
    EntryBox eb;
    if (PROB) {
      const Meta m = s_meta[warp][r];
      e = m.e, f0 = m.f0, f1 = m.f1, pieces = m.pieces, eb = m.eb;
    } else {
      pieces = entry_of(r, e, f0, f1, eb);
    }
    if (j >= pieces) continue;   // uniform across the warp
    runs_of(eb);
    // the Gaussian's tables: staged (prob), else from global memory
    const long gi = entries[e] & INDEX_MASK;
    const float* gd = PROB ? s_gauss + (warp + WARPS * r) * GW : gdata + 9 * gi;
    const float* gs = PROB ? gd + 10 : sem + gi * C;
    const float mx = gd[0], my = gd[1], mz = gd[2];
    const float a0 = gd[3], a1 = gd[4], a2 = gd[5], a3 = gd[6], a4 = gd[7],
                a5 = gd[8], op = PROB ? gd[9] : opa[gi];
    const float det = a0 * a1 * a2 + 2.f * a3 * a4 * a5 - a0 * a4 * a4 -
                      a1 * a5 * a5 - a2 * a3 * a3;
    const float w = PROB ? NORM_3D * sqrtf(fmaxf(det, 1e-30f)) * op : op;
    float sm[MAXC];
#pragma unroll
    for (int c = 0; c < MAXC; ++c) sm[c] = c < C ? gs[c] : 0.f;
    float acc[32 * G];
#pragma unroll
    for (int v = 0; v < 32 * G; ++v) acc[v] = 0.f;
    // one pair: the point's coordinates (and dot_gl), scalars and gl row
    auto pair = [&](float4 pt, float2 sc, const float* glr) {
      const float dx = mx - pt.x;
      const float dy = my - pt.y;
      const float dz = mz - pt.z;
      const float logit = -0.5f * (a0 * dx * dx + a1 * dy * dy +
                                   a2 * dz * dz) -
                          (a3 * dx * dy + a4 * dy * dz + a5 * dx * dz);
      const float power = expf(fminf(logit, 30.f));
      float gr[MAXC];
      if constexpr (MAXC % 2 == 0 && MAXC <= 18) {
        const float2* g2p = reinterpret_cast<const float2*>(glr);
#pragma unroll
        for (int c = 0; c < MAXC / 2; ++c) {
          const float2 q = g2p[c];
          gr[2 * c] = q.x;
          gr[2 * c + 1] = q.y;
        }
      } else {
#pragma unroll
        for (int c = 0; c < MAXC; ++c) gr[c] = c < C ? glr[c] : 0.f;
      }
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < MAXC; ++c)
        if (c < C) dot += gr[c] * sm[c];
      float gprob, gpower;
      if (PROB) {
        gprob = dot - pt.w;
        const float one_m = 1.f - fminf(power, 1.f - 1e-9f) + 1e-9f;
        gpower = sc.y + __fdividef(sc.x, one_m) + gprob * w;
      } else {
        gprob = dot;
        gpower = gprob * w;
      }
      const float glogit = logit < 30.f ? gpower * power : 0.f;
      const float gx = glogit * dx, gy = glogit * dy, gz = glogit * dz;
      acc[0] += gx;
      acc[1] += gy;
      acc[2] += gz;
      acc[3] += gx * dx;
      acc[4] += gy * dy;
      acc[5] += gz * dz;
      acc[6] += gx * dy;
      acc[7] += gy * dz;
      acc[8] += gx * dz;
      acc[9] += gprob * power;
      const float prob = power * w;
#pragma unroll
      for (int c = 0; c < MAXC; ++c)
        if (c < C) acc[10 + c] += prob * gr[c];
    };
    if (f1 > f0) {
      // the lane's first column: the last c with s_pre[c] <= f0 + lane
      int clo = 0, chi = eb.ncol;
      while (chi - clo > 1) {
        const int mid = (clo + chi) >> 1;
        if (s_pre[warp][mid] <= f0 + lane)
          clo = mid;
        else
          chi = mid;
      }
      int col = clo;
      if (staged) {
        for (int fl = f0 + lane; fl < f1; fl += 32) {
          const int i = place(fl, col) - first;
          pair(w_pt[i], w_sc[i], w_gl + i * C);
        }
      } else {
        for (int fl = f0 + lane; fl < f1; fl += 32) {
          const long s = place(fl, col);
          pair(spt[s], PROB ? ssc[s] : make_float2(0.f, 0.f), sgl + s * C);
        }
      }
    }
    float tot[G];
    warp_transpose_sum<G>(acc, tot);
    float* dst = pieces == 1
                     ? work + (long)slot[e] * WS
                     : pbuf + ((long)b * GROUP + warp + WARPS * r) * WS;
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int v = 32 * k + lane;
      if (v < 10 + C) dst[v] = tot[k];
    }
  }
  if (block_ns != nullptr) {
    __syncthreads();
    if (threadIdx.x == 0) {
      block_ns[2 * blockIdx.x] = t_begin;
      block_ns[2 * blockIdx.x + 1] = global_ns();
    }
  }
}

// 6. a warp per entry of more than one piece: its pieces' rows in order.
__global__ void __launch_bounds__(THREADS)
combine_kernel(const int* __restrict__ ts, int T, int ecap, int group,
               const int* __restrict__ cnt, const int* __restrict__ hdr,
               const int* __restrict__ gfirst,
               const int* __restrict__ slot, const float* __restrict__ pbuf,
               int C, float* __restrict__ work) {
  const int lane = threadIdx.x & 31;
  const int E = min(ecap, ts[T]), level = hdr[0];
  const int WS = round4(10 + C);
  for (int e = blockIdx.x * WARPS + (threadIdx.x >> 5); e < E;
       e += gridDim.x * WARPS) {
    const int pieces = pieces_of(cnt[e], level);
    if (pieces == 1) continue;
    const long first = gfirst[e / group];
    float* dst = work + (long)slot[e] * WS;
    for (int v = lane; v < 10 + C; v += 32) {
      float s = 0.f;
      for (int q = 0; q < pieces; ++q)
        s += pbuf[((first + q) * group + e % group) * WS + v];
      dst[v] = s;
    }
  }
}

// The workspace: each array's offset in 4-byte words, 16-byte aligned.
struct Layout {
  long spt, ssc, sgl, etile, cnt, gfirst, bsum, boff, hdr, bgroup, pbuf,
      words;
  int nb, budget;
};

Layout layout_of(long N, long ecap, int C, int group) {
  auto up = [](long w) { return (w + 3) / 4 * 4; };
  Layout l;
  const long groups = (ecap + group - 1) / group;
  l.nb = (int)((ecap + PLAN_THREADS - 1) / PLAN_THREADS);
  l.budget = (int)(2 * groups + 1);
  long o = 0;
  l.spt = o;
  o += 4 * N;
  l.ssc = o;
  o = up(o + 2 * N);
  l.sgl = o;
  o = up(o + N * C);
  l.etile = o;
  o = up(o + ecap);
  l.cnt = o;
  o = up(o + ecap);
  l.gfirst = o;
  o = up(o + groups);
  l.bsum = o;
  o = up(o + (long)l.nb * LEVELS);
  l.boff = o;
  o = up(o + l.nb);
  l.hdr = o;
  o = up(o + 2);
  l.bgroup = o;
  o = up(o + l.budget);
  l.pbuf = o;
  o = up(o + (long)l.budget * group * round4(10 + C));
  l.words = o;
  return l;
}

template <int MAXC, bool PROB>
int launch(const float* pts, Grid g, long N, const int* order,
           const int* vstart, const float* gdata, const float* opa,
           const float* sem, const int* box, const float* gl,
           const float* scal, int C, const int* ts, const int* entries,
           const int* slot, int ecap, float* work, float* ws,
           unsigned long long* block_ns, cudaStream_t st) {
  const int T = tiles_of(g);
  if (T == 0 || ecap == 0) return 0;
  constexpr int GROUP = group_of<PROB>();
  const Layout l = layout_of(N, ecap, C, GROUP);
  float4* spt = reinterpret_cast<float4*>(ws + l.spt);
  float2* ssc = reinterpret_cast<float2*>(ws + l.ssc);
  float* sgl = ws + l.sgl;
  int* iws = reinterpret_cast<int*>(ws);
  int *etile = iws + l.etile, *cnt = iws + l.cnt, *gfirst = iws + l.gfirst,
      *bsum = iws + l.bsum, *boff = iws + l.boff, *hdr = iws + l.hdr,
      *bgroup = iws + l.bgroup;
  float* pbuf = ws + l.pbuf;
  const size_t smem =
      PROB ? (size_t)STAGE_ROWS * (6 + C) * sizeof(float) : 0;
  cudaError_t err = cudaFuncSetAttribute(
      piece_kernel<MAXC, PROB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (N > 0)
    gather_kernel<<<(int)((N + THREADS - 1) / THREADS), THREADS, 0, st>>>(
        order, (int)N, pts, gl, scal, C, spt, ssc, sgl);
  plan_count_kernel<GROUP><<<l.nb, PLAN_THREADS, 0, st>>>(ts, T, entries, box,
                                                   vstart, g, ecap, etile,
                                                   cnt, bsum);
  plan_choose_kernel<<<1, CHOOSE_THREADS, 0, st>>>(bsum, l.nb, l.budget,
                                                   boff, hdr);
  plan_expand_kernel<GROUP><<<l.nb, PLAN_THREADS, 0, st>>>(
      ts, T, cnt, hdr, boff, gfirst, bgroup);
  piece_kernel<MAXC, PROB><<<l.budget, THREADS, smem, st>>>(
      ts, T, entries, slot, box, vstart, g, etile, cnt, hdr, gfirst, bgroup,
      gdata, opa, sem, spt, ssc, sgl, C, work, pbuf, block_ns);
  combine_kernel<<<min((ecap + WARPS - 1) / WARPS, COMBINE_BLOCKS), THREADS,
                   0, st>>>(
      ts, T, ecap, GROUP, cnt, hdr, gfirst, slot, pbuf, C, work);
  return (int)cudaGetLastError();
}

}  // namespace

// For N points, room for `ecap` entries and C classes: out[0] the fp32
// words of the general backward's workspace, out[1] the blocks of its
// piece launch (block_ns holds 2 words a block).
GF_EXPORT int gf_splat_points_backward_sizes(long long N, long long ecap,
                                             int C, long long* out) {
  if (C < 2 || C > 32 || N < 0 || ecap < 0 || ecap >= (1L << 30))
    return -1;
  const Layout a = layout_of(N, ecap, C, group_of<false>());
  const Layout p = layout_of(N, ecap, C, group_of<true>());
  out[0] = a.words > p.words ? a.words : p.words;
  out[1] = a.budget > p.budget ? a.budget : p.budget;
  return 0;
}

// pts [N, 3] fp32, any points; pc_min: 3 host floats; voxel grid (GH, GW,
// GD) of edge `gs`; the points' bins of splat_points_bin.cu (order [N],
// voxel_start [K + 1] int32); gdata [P, 9] fp32; opa [P]; sem [P, C]; box
// [P, 6] int32; gl [N, C] and scal [N, 3] = (dot_gl, bin_term, g_density)
// fp32; the Gaussians' bins of splat_bin.cu (tile_start [T + 1], entries
// and slot with room for `ecap`, int32); work [ecap, round4(10 + C)] fp32,
// each entry's sums over its box's points, in its slot (then folded per
// Gaussian by gf_splat_backward with parts = 2); ws: the workspace
// (gf_splat_points_backward_sizes); block_ns (or null): uint64 [blocks, 2],
// the piece launch's blocks' first and last %globaltimer readings. Returns
// a cudaError_t, or -1 for C outside 2..32.
GF_EXPORT int gf_splat_points_backward(
    const void* pts, long long N, const float* pc_min, float gs, int GH,
    int GW, int GD, const void* order, const void* voxel_start,
    const void* gdata, const void* opa, const void* sem, const void* box,
    const void* gl, const void* scal, int C, const void* tile_start,
    const void* entries, const void* slot, long long ecap, void* work,
    void* ws, void* block_ns, void* stream) {
  if (C < 2 || C > 32 || ecap >= (1L << 30)) return -1;
  auto run = C == 18 ? launch<18, true> : launch<32, true>;
  return run((const float*)pts, grid_of(pc_min, gs, GH, GW, GD), N,
             (const int*)order, (const int*)voxel_start, (const float*)gdata,
             (const float*)opa, (const float*)sem, (const int*)box,
             (const float*)gl, (const float*)scal, C,
             (const int*)tile_start, (const int*)entries, (const int*)slot,
             (int)ecap, (float*)work, (float*)ws,
             (unsigned long long*)block_ns, (cudaStream_t)stream);
}

// The additive variant: gl [N, C] is the logits cotangent itself and there
// are no per-point scalars.
GF_EXPORT int gf_splat_points_backward_additive(
    const void* pts, long long N, const float* pc_min, float gs, int GH,
    int GW, int GD, const void* order, const void* voxel_start,
    const void* gdata, const void* opa, const void* sem, const void* box,
    const void* gl, int C, const void* tile_start, const void* entries,
    const void* slot, long long ecap, void* work, void* ws, void* block_ns,
    void* stream) {
  if (C < 2 || C > 32 || ecap >= (1L << 30)) return -1;
  auto run = C == 18 ? launch<18, false> : launch<32, false>;
  return run((const float*)pts, grid_of(pc_min, gs, GH, GW, GD), N,
             (const int*)order, (const int*)voxel_start, (const float*)gdata,
             (const float*)opa, (const float*)sem, (const int*)box,
             (const float*)gl, nullptr, C, (const int*)tile_start,
             (const int*)entries, (const int*)slot, (int)ecap, (float*)work,
             (float*)ws, (unsigned long long*)block_ns,
             (cudaStream_t)stream);
}
