// K6: multi-camera, multi-level deformable feature aggregation, backward
// (of K3, with the key-point sum).
//
// Replaces: gaussianformer_tpu/ops/pallas/deformable_kernel.py
//           deformable_fused_bwd (kernel `_bwd_kernel`), the VJP of
//           deformable_fused_fwd (ops/deformable.py op_bwd).
//
// With the forward of deformable.cu, for key point q = p*K + k, camera cam,
// level l, group g = c / (C / G), weight w = weight[b, q, cam, l, g] and the
// bilinear corner weights cw_n of (u W_l - 0.5, v H_l - 0.5):
//   g_feat_l[corner_n, c] += w cw_n g_out[b, p, c]
//   g_weight[b, q, cam, l, g] = sum_{c in g} g_out[c] sum_n cw_n f_n[c]
//   g_u[b, q, cam] = sum_l W_l sum_c w g_out[c] sum_n dcw_n/dlw f_n[c]
//   g_v[b, q, cam] = sum_l H_l sum_c w g_out[c] sum_n dcw_n/dlh f_n[c]
// for (u, v) strictly inside (0, 1) and corners inside the level, exactly
// the gates of the forward; everything else has a zero gradient.
//
// Bound on the H100: bytes. The feature gradients are written once in the
// maps' dtype (6 cams x 28,700 pixels x 128 channels at flagship size, 44
// MB of bf16) and the features (44 MB) read; flops are negligible. What a
// design must avoid is the scatter: summing 4 corners x 4 levels of every
// in-image pair into the feature gradient with float atomics is 4 x 512 B
// of read-modify-write at the L2 a sample and level.
//
// Design: two launches on the pixel bins of deformable_bin.cu, no float
// atomics, no host read, the same bits on every call.
// 1. Points and weights (one warp an anchor, K3's structure): the lanes
//    load the anchor's pairs' (u, v) in one coalesced load, a ballot gives
//    the in-image pairs, and for each of them all 4 L corners are loaded
//    together (clamped addresses, zero weight outside the level); a lane
//    forms its channels' dot products with its g_out slice, the weight
//    gradient is reduced over the group's lanes, the (u, v) gradient over
//    the warp. Every element of g_pts and g_wts is written, zeros included.
// 2. Feature gradients, gathered: a block of 8 warps takes a run of one
//    level's pixels (sized so that each block gets about BLOCK_ENTRIES of
//    the entries' bound; the coarsest level's blocks first), each warp an
//    equal part of the run's entries in order, whatever pixels they belong
//    to. A lane owns C / 32 channels and sums in fp32; a pixel's sum is
//    stored when the next entry is another pixel's. The entries go in
//    rounds of 32: the lanes load the next round's entries, (u, v) and
//    weights while the warp sums this round, whose scalars (w[g] cw,
//    anchor, pixel) sit in shared memory; a g_out row is loaded only where
//    the anchor changes from the previous entry's (an anchor's entries are
//    consecutive), SB entries ahead of the FMAs. A pixel whose list
//    crosses a part's end keeps its runs in shared memory, added in warp
//    order once the block is done. Each pixel's gradient is written once,
//    in the maps' dtype; a pixel without entries writes 0.
#include "deformable.cuh"

namespace {

using gf::deform::Chunk;
using gf::deform::Levels;
using gf::deform::MAX_LEVELS;

constexpr int WARPS = 8;        // a block's warps (points: a warp an anchor)
constexpr int MAX_BLOCK_PIXELS = 64;
// entries of the bound a block of the features launch takes: about a
// quarter are real (in-image pairs, measured on the shipped configs),
// some 128 a warp
constexpr int BLOCK_ENTRIES = 4096;
constexpr int MAX_G = 8;
constexpr int MAX_C = 256;
constexpr int SB = 4;           // g_out rows a warp loads ahead
constexpr int POINTS_LAUNCH = 1;
constexpr int FEATURES_LAUNCH = 2;

// The features launch's blocks: per level, its first key, its pixels, the
// pixels a block, its blocks and the first of them (the coarsest level's
// blocks first).
struct Grid {
  int off[MAX_LEVELS];
  int npix[MAX_LEVELS];
  int per_block[MAX_LEVELS];
  int blocks[MAX_LEVELS];
  int first_block[MAX_LEVELS];
  int total;   // blocks
};

// What the two launches read and write.
struct Args {
  Levels lv;
  Grid grid;
  const int* entries;
  const int* pixel_start;
  const float* pts;
  const float* wts;
  const float* gout;
  float* g_pts;
  float* g_wts;
  int B, P, K, cams, C, G;
};

// The point and weight gradients of block `block`'s anchors.
template <typename T, int VEC, int L>
__device__ __forceinline__ void points_block(const Args& a, int block) {
  constexpr int LB = gf::deform::levels_in_flight<T, VEC, L>();
  const Levels& lv = a.lv;
  const float* __restrict__ pts = a.pts;
  const float* __restrict__ wts = a.wts;
  float* __restrict__ g_pts = a.g_pts;
  float* __restrict__ g_wts = a.g_wts;
  const int P = a.P, cams = a.cams, C = a.C, G = a.G;
  const int warp = block * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (warp >= a.B * P) return;   // the whole warp
  const int c0 = lane * VEC;
  const int gdim = C / G;
  const int g = c0 / gdim;
  const int lanes_per_group = gdim / VEC;
  const int KC = a.K * cams;
  const long pair0 = (long)warp * KC;
  const int b = warp / P;
  const int LG = L * G;

  float go[VEC];
  gf::load_vec<VEC>(a.gout + (long)warp * C + c0, go);

  for (int j0 = 0; j0 < KC; j0 += 32) {
    const bool real = j0 + lane < KC;
    float u = 0.f, v = 0.f;
    if (real) {
      const float2 uv =
          reinterpret_cast<const float2*>(pts)[pair0 + j0 + lane];
      u = uv.x;
      v = uv.y;
    }
    const bool in = gf::deform::inside(u, v);
    unsigned todo = __ballot_sync(0xffffffffu, in);
    // zero gradients of the pairs outside every image
    const unsigned out = __ballot_sync(0xffffffffu, real && !in);
    if (real && !in)
      reinterpret_cast<float2*>(g_pts)[pair0 + j0 + lane] =
          make_float2(0.f, 0.f);
    if (out) {
      float* wrow = g_wts + (pair0 + j0) * LG;
      const int n = min(32, KC - j0) * LG;
      for (int i = lane; i < n; i += 32)
        if ((out >> (i / LG)) & 1u) wrow[i] = 0.f;
    }
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const float pu = __shfl_sync(0xffffffffu, u, src);
      const float pv = __shfl_sync(0xffffffffu, v, src);
      const long pair = pair0 + j0 + src;
      const long plane = (long)b * cams + (j0 + src) % cams;
      float gu = 0.f, gv = 0.f;
#pragma unroll
      for (int l0 = 0; l0 < L; l0 += LB) {
        // the loads of LB levels' corners first; kept for the sums: the
        // fractional parts and which corners lie in their level
        Chunk<T, VEC> f[LB][4];
        float lh[LB], lw[LB], wgt[LB];
        unsigned valid = 0;
#pragma unroll
        for (int i = 0; i < LB; ++i) {
          const int l = l0 + i;
          const int hl = lv.h[l], wl = lv.w[l];
          wgt[i] = wts[(pair * L + l) * G + g];
          const gf::deform::Corners cn = gf::deform::corners(pu, pv, hl, wl);
          lh[i] = cn.lh;
          lw[i] = cn.lw;
          const T* base = static_cast<const T*>(lv.ptr[l]) +
                          plane * hl * wl * C + c0;
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            f[i][n].load(base + (long)cn.pix[n] * C);
            valid |= (unsigned)cn.valid[n] << (4 * i + n);
          }
        }
#pragma unroll
        for (int i = 0; i < LB; ++i) {
          const int l = l0 + i;
          const float cw[4] = {(1.f - lh[i]) * (1.f - lw[i]),
                               (1.f - lh[i]) * lw[i], lh[i] * (1.f - lw[i]),
                               lh[i] * lw[i]};
          const float dlw[4] = {-(1.f - lh[i]), 1.f - lh[i], -lh[i], lh[i]};
          const float dlh[4] = {-(1.f - lw[i]), -lw[i], 1.f - lw[i], lw[i]};
          float sw = 0.f, su = 0.f, sv = 0.f;
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            // uniform over the warp
            if (!((valid >> (4 * i + n)) & 1u)) continue;
            float dot = 0.f;
#pragma unroll
            for (int e = 0; e < VEC; ++e) dot += f[i][n].get(e) * go[e];
            sw += cw[n] * dot;
            su += dlw[n] * dot;
            sv += dlh[n] * dot;
          }
          // weight gradient: sum over the group's lanes
          for (int s = lanes_per_group / 2; s >= 1; s >>= 1)
            sw += __shfl_xor_sync(0xffffffffu, sw, s);
          if (lane % lanes_per_group == 0) g_wts[(pair * L + l) * G + g] = sw;
          gu += wgt[i] * su * (float)lv.w[l];
          gv += wgt[i] * sv * (float)lv.h[l];
        }
      }
#pragma unroll
      for (int s = 16; s >= 1; s >>= 1) {
        gu += __shfl_xor_sync(0xffffffffu, gu, s);
        gv += __shfl_xor_sync(0xffffffffu, gv, s);
      }
      if (lane == 0)
        reinterpret_cast<float2*>(g_pts)[pair] = make_float2(gu, gv);
    }
  }
}

// A warp's scratch in the features launch: its round's entries' scalars
// w[g] cw, anchors and pixels (within the block).
struct Round {
  float s[32][MAX_G];
  int anchor[32];
  int pix[32];
};

// The feature gradients of block `block`'s pixels.
template <typename T, int VEC>
__device__ __forceinline__ void features_block(const Args& args, int block) {
  using gf::deform::pick;
  const Levels& lv = args.lv;
  const Grid& grid = args.grid;
  const int* __restrict__ entries = args.entries;
  const float* __restrict__ pts = args.pts;
  const float* __restrict__ wts = args.wts;
  const float* __restrict__ gout = args.gout;
  const int KC = args.K * args.cams, C = args.C, G = args.G;
  __shared__ int s_start[MAX_BLOCK_PIXELS + 1];
  __shared__ float s_part[WARPS][2][MAX_C];
  __shared__ Round s_round[WARPS][2];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the block's level: the coarsest level's blocks come first
  int l = lv.n - 1;
#pragma unroll
  for (int i = MAX_LEVELS - 1; i >= 0; --i)
    if (i < lv.n && grid.first_block[i] <= block) l = i;
  const int h = pick(lv.h, l), w = pick(lv.w, l), L = lv.n;
  const int off = pick(grid.off, l);
  const int per_block = pick(grid.per_block, l);
  const int p_lo = off + (block - pick(grid.first_block, l)) * per_block;
  const int npx = min(per_block, off + pick(grid.npix, l) - p_lo);
  T* grad = static_cast<T*>(pick(lv.grad, l)) + (long)(p_lo - off) * C;
  const int c0 = lane * VEC;
  const int g = c0 / (C / G);
  for (int i = tid; i <= npx; i += WARPS * 32)
    s_start[i] = args.pixel_start[p_lo + i];
  __syncthreads();
  const int S = s_start[0], E = s_start[npx];
  // the pixel (within the block) of entry e in [S, E): the last one whose
  // list starts at or before e
  auto pixel_of = [&](int e) {
    int lo = 0, hi = npx - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (s_start[mid] <= e)
        lo = mid;
      else
        hi = mid - 1;
    }
    return lo;
  };
  auto store = [&](int k, const float* v) {
    gf::store_vec<VEC>(grad + (long)k * C + c0, v);
  };
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  for (int k = warp; k < npx; k += WARPS)
    if (s_start[k] == s_start[k + 1]) store(k, acc);   // no entries: 0

  // the warp's equal part of the block's entries, in order
  const int a = S + (int)((long)(E - S) * warp / WARPS);
  const int b = S + (int)((long)(E - S) * (warp + 1) / WARPS);
  // a pixel's sum: stored when the pixel's list lies in [a, b), else kept
  // for the block (its first run in slot 0, its last in slot 1)
  auto flush = [&](int k) {
    if (k >= 0) {
      if (s_start[k] >= a && s_start[k + 1] <= b) {
        store(k, acc);
      } else {
        float* part = s_part[warp][s_start[k] < a ? 0 : 1];
#pragma unroll
        for (int e = 0; e < VEC; ++e) part[c0 + e] = acc[e];
      }
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  };
  // A round is 32 entries. The lanes load the next round's entries and
  // their (u, v) and weights while the warp sums this round's terms, and
  // publish them to the other half of the warp's scratch; within a round
  // the g_out rows of the next SB entries are loaded before the FMAs of
  // these SB.
  int ent = b > a + lane ? entries[a + lane] : 0;
  int ent_next = b > a + 32 + lane ? entries[a + 32 + lane] : 0;
  float2 uv = make_float2(0.f, 0.f);
  float wv[MAX_G];
  auto load = [&](int base) {   // the lane's entry `ent` of round `base`
    if (base + lane < b) {
      const int sample = ent >> 2;
      uv = reinterpret_cast<const float2*>(pts)[sample / L];
      const float* wrow = wts + (long)sample * G;
#pragma unroll
      for (int gg = 0; gg < MAX_G; ++gg)
        if (gg < G) wv[gg] = wrow[gg];
    }
  };
  auto publish = [&](int base, Round& rd) {
    if (base + lane < b) {
      const int sample = ent >> 2;
      const float cw = gf::deform::corner_weight(uv.x, uv.y, h, w, ent & 3);
#pragma unroll
      for (int gg = 0; gg < MAX_G; ++gg)
        if (gg < G) rd.s[lane][gg] = wv[gg] * cw;
      rd.anchor[lane] = sample / L / KC;
      rd.pix[lane] = pixel_of(base + lane);
    }
    __syncwarp();
  };
  load(a);
  publish(a, s_round[warp][0]);
  int kcur = -1;
  int cur = -1;   // the anchor whose g_out row `go` holds
  float go[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) go[e] = 0.f;
  for (int base = a, r = 0; base < b; base += 32, r ^= 1) {
    const int n = min(32, b - base);
    const Round& rd = s_round[warp][r];
    // the next round's loads, in flight during this round's sums
    ent = ent_next;
    load(base + 32);
    ent_next = b > base + 64 + lane ? entries[base + 64 + lane] : 0;
    float rows[2][SB][VEC];
    unsigned need[2] = {0u, 0u};
    // issue the row loads of entries [i0, i0 + SB) into rows[buf]
    auto issue = [&](int i0, int buf, int prev) {
      need[buf] = 0u;
#pragma unroll
      for (int i = 0; i < SB; ++i) {
        if (i0 + i < n) {   // uniform over the warp
          const int an = rd.anchor[i0 + i];
          if (an != prev) {
            need[buf] |= 1u << i;
            gf::load_vec<VEC>(gout + (long)an * C + c0, rows[buf][i]);
          }
          prev = an;
        }
      }
    };
    issue(0, 0, cur);
#pragma unroll
    for (int sb = 0; sb < 32 / SB; ++sb) {
      const int i0 = sb * SB;
      if (i0 >= n) break;   // uniform over the warp
      if (i0 + SB < n) issue(i0 + SB, (sb + 1) & 1, rd.anchor[i0 + SB - 1]);
#pragma unroll
      for (int i = 0; i < SB; ++i) {
        if (i0 + i < n) {
          const int kk = rd.pix[i0 + i];
          if (kk != kcur) {
            flush(kcur);
            kcur = kk;
          }
          if ((need[sb & 1] >> i) & 1u) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) go[e] = rows[sb & 1][i][e];
          }
          const float sc = rd.s[i0 + i][g];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] += sc * go[e];
        }
      }
    }
    cur = rd.anchor[n - 1];
    publish(base + 32, s_round[warp][r ^ 1]);
  }
  flush(kcur);
  __syncthreads();
  // a pixel whose list began in an earlier warp's part and ends in this
  // one's: its parts added in warp order
  if (a < b) {
    const int k = pixel_of(a);
    const int ks = s_start[k], ke = s_start[k + 1];
    if (ks < a && ke <= b) {
      float t[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) t[e] = 0.f;
      for (int w0 = 0; w0 <= warp; ++w0) {
        const int a0 = S + (int)((long)(E - S) * w0 / WARPS);
        const int b0 = S + (int)((long)(E - S) * (w0 + 1) / WARPS);
        if (a0 >= b0 || b0 <= ks || a0 >= ke) continue;
        const float* part = s_part[w0][ks < a0 ? 0 : 1];
#pragma unroll
        for (int e = 0; e < VEC; ++e) t[e] += part[c0 + e];
      }
      store(k, t);
    }
  }
}

template <typename T, int VEC, int L>
__global__ void __launch_bounds__(WARPS * 32, 4)
deformable_bwd_points_kernel(Args a) {
  points_block<T, VEC, L>(a, blockIdx.x);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(WARPS * 32, 3)
deformable_bwd_features_kernel(Args a) {
  features_block<T, VEC>(a, blockIdx.x);
}

template <typename T, int VEC>
int launch(const Args& a, int parts, cudaStream_t st) {
  const int points = (a.B * a.P + WARPS - 1) / WARPS;
  if ((parts & POINTS_LAUNCH) && points > 0) {
    switch (a.lv.n) {
      case 1: deformable_bwd_points_kernel<T, VEC, 1><<<points, WARPS * 32, 0, st>>>(a); break;
      case 2: deformable_bwd_points_kernel<T, VEC, 2><<<points, WARPS * 32, 0, st>>>(a); break;
      case 3: deformable_bwd_points_kernel<T, VEC, 3><<<points, WARPS * 32, 0, st>>>(a); break;
      default: deformable_bwd_points_kernel<T, VEC, 4><<<points, WARPS * 32, 0, st>>>(a); break;
    }
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  if ((parts & FEATURES_LAUNCH) && a.grid.total > 0)
    deformable_bwd_features_kernel<T, VEC>
        <<<a.grid.total, WARPS * 32, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, int parts, cudaStream_t st) {
  switch (a.C / 32) {
    case 1: return launch<T, 1>(a, parts, st);
    case 2: return launch<T, 2>(a, parts, st);
    case 4: return launch<T, 4>(a, parts, st);
    case 8: return launch<T, 8>(a, parts, st);
    default: return -1;
  }
}

}  // namespace

// feats / grads: `num_levels` pointers to [B, cams, H_l, W_l, C] (features
// and their gradients fp32 when is_bf16 == 0, else bf16); pts
// [B, P*K, cams, 2] fp32; wts [B, P*K, cams, L, G] fp32; g_out [B, P, C]
// fp32; entries and pixel_start: the bins of gf_deformable_bin on pts.
// Writes every element of grads, g_pts and g_wts (shapes of pts and wts,
// fp32). `parts`: 1 the points launch (g_pts, g_wts), 2 the features
// launch (grads), 3 both. Requires C in {32, 64, 128, 256}, C == 32 * VEC
// with (C / G) % VEC == 0 and (C / G) / VEC a power of two.
// Returns a cudaError_t, or -1 for an unsupported shape.
GF_EXPORT int gf_deformable_backward(const void* const* feats,
                                     void* const* grads, const int* heights,
                                     const int* widths, int num_levels,
                                     int is_bf16, const void* pts,
                                     const void* wts, const void* g_out,
                                     void* g_pts, void* g_wts,
                                     const void* entries,
                                     const void* pixel_start, int B, int P,
                                     int K, int cams, int C, int G,
                                     int parts, void* stream) {
  if (num_levels < 1 || num_levels > MAX_LEVELS) return -1;
  const int vec = C / 32;
  if (vec < 1 || C > MAX_C || C % 32 != 0 || G > MAX_G || C % G != 0 ||
      (C / G) % vec != 0)
    return -1;
  const int lpg = (C / G) / vec;
  if (lpg & (lpg - 1)) return -1;
  Args a;
  Levels& lv = a.lv;
  Grid& grid = a.grid;
  lv.n = num_levels;
  int off = 0;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    const bool has = l < num_levels;
    lv.ptr[l] = has ? feats[l] : nullptr;
    lv.grad[l] = has ? grads[l] : nullptr;
    lv.h[l] = has ? heights[l] : 0;
    lv.w[l] = has ? widths[l] : 0;
    grid.off[l] = off;
    grid.npix[l] = has ? B * cams * heights[l] * widths[l] : 0;
    off += grid.npix[l];
    // pixels a block: about BLOCK_ENTRIES of the entries' bound (4 a
    // pair), spread over the level's pixels
    const long bound = 4L * B * P * K * cams;
    const long per = has && bound > 0
                         ? (long)BLOCK_ENTRIES * grid.npix[l] / bound : 1;
    grid.per_block[l] = (int)(per < 1 ? 1 : (per > MAX_BLOCK_PIXELS
                                                 ? MAX_BLOCK_PIXELS
                                                 : per));
    grid.blocks[l] = (grid.npix[l] + grid.per_block[l] - 1) /
                     grid.per_block[l];
  }
  grid.total = 0;
  for (int l = num_levels - 1; l >= 0; --l) {
    grid.first_block[l] = grid.total;
    grid.total += grid.blocks[l];
  }
  for (int l = num_levels; l < MAX_LEVELS; ++l) grid.first_block[l] = 0;
  a.entries = (const int*)entries;
  a.pixel_start = (const int*)pixel_start;
  a.pts = (const float*)pts;
  a.wts = (const float*)wts;
  a.gout = (const float*)g_out;
  a.g_pts = (float*)g_pts;
  a.g_wts = (float*)g_wts;
  a.B = B;
  a.P = P;
  a.K = K;
  a.cams = cams;
  a.C = C;
  a.G = G;
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? dispatch<__nv_bfloat16>(a, parts, st)
                 : dispatch<float>(a, parts, st);
}
