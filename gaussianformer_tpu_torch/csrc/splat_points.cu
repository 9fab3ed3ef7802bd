// K4, general mode: Gaussian -> point splat with the final-occ label
// epilogue at any query points, in both variants of the TPU kernel:
// `prob` (GaussianFormer-2) and `additive` (the v1 models).
//
// Replaces: gaussianformer_tpu/ops/pallas/splat_kernel.py splat_raw_pallas
//           with zrun = 0 (the points not declared a raster grid, as
//           ops/splat.py::splat reaches it with grid_ordered=False, and
//           the head does when occ_xyz is not the splat grid).
//
// Computes what splat.cu computes, for every query point x and Gaussian g
// whose integer AABB [lo_g, hi_g] holds x's voxel (the voxel of
// SplatGridSpec.voxelize: floor, clamped into the grid):
//   e      = exp(min(-1/2 (mu_g - x)^T A_g (mu_g - x), 30))
//   acc[c] += e * sem_aug[g, c];  om *= 1 - e (prob only)
// and the same label epilogue per point (prob: "combine" or "threshold";
// additive: the first-index argmax of the raw sums, 0 where no box holds
// the voxel).
//
// Bound on the H100: flops, as splat.cu: the exponent and the C + 2
// multiply-adds of every (point, Gaussian) pair inside an AABB.
//
// Design: the points are binned by voxel, tile-major (splat_points_bin.cu:
// a tile's points in the order of their voxels' places, z fastest, cut into
// work items of at most TILE_VOXELS), and the Gaussians keep their tile
// bins (splat_bin.cu). A block per work item (additive) or half of one
// (prob: two blocks share an SM); warp w takes its block's points
// [64 w, 64 w + 64), two a lane (32 apart), which lie in a few neighbouring
// voxels, and gathers their bounds in the tile (min and max place on each
// axis, warp reductions). The block walks the tile's entries, staged through shared
// memory in chunks with a cp.async double buffer as splat.cu stages them;
// an entry whose box misses a warp's bounds costs that warp one test, a
// COVERS entry runs without a test (two in a row at a warp of live points
// take their four exponents together, for the scheduler), and a point
// outside the box skips the exponent and the multiply-adds. The points
// share no x and y, so the exponent is the full quadratic form at each
// point's own coordinates (there is no dz recurrence, the TPU kernel's zrun
// path). Two points a lane keep 2 x (C + 3) fp32 sums in at most 128
// registers with no spill at C = 18. Each point sums its Gaussians in
// ascending index order and writes its own row at its input index: no
// atomics, so a second call gives the same bits.
#include <math.h>

#include "splat_points.cuh"

namespace {

using namespace gf::splat;

constexpr int VPT = 2;                      // points a lane
constexpr int CHUNK = 64;                   // entries staged at once
// A block's threads and its share of a work item: prob, half an item, so
// that two blocks share an SM (a long block's start and end overlap the
// other's work); additive, whose blocks are short and whose entries are
// mostly skipped, the whole item, so that its entries are staged once.
template <bool PROB>
struct Shape {
  static constexpr int THREADS = PROB ? 256 : 512;
  static constexpr int BLOCK_POINTS = THREADS * VPT;
  static constexpr int HALVES = TILE_VOXELS / BLOCK_POINTS;
  static constexpr int MIN_BLOCKS = PROB ? 2 : 1;
};

// The sums of one (point, Gaussian) pair: e into the point's C + 2
// channels (and 1 - e into its product, prob).
template <int MAXC, bool PROB>
__device__ __forceinline__ void add_pair(float e, const float* sr, int C,
                                         float (&a)[MAXC], float& ps,
                                         float& dens, float& om) {
  if constexpr (MAXC == 18) {
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const float4 q = reinterpret_cast<const float4*>(sr)[j];
      if (j < 4) {
        a[4 * j] += e * q.x;
        a[4 * j + 1] += e * q.y;
        a[4 * j + 2] += e * q.z;
        a[4 * j + 3] += e * q.w;
      } else {
        a[16] += e * q.x;
        a[17] += e * q.y;
        ps += e * q.z;
        dens += e * q.w;
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < MAXC; ++c)
      if (c < C) a[c] += e * sr[c];
    ps += e * sr[C];
    dens += e * sr[C + 1];
  }
  if (PROB) om *= 1.f - e;
}

// e of a Gaussian's staged record at a point
__device__ __forceinline__ float pair_e(const float* rec, float x, float y,
                                        float z) {
  const float4 g0 = *reinterpret_cast<const float4*>(rec);
  const float4 g1 = *reinterpret_cast<const float4*>(rec + 4);
  const float g8 = rec[8];
  const float dx = g0.x - x;
  const float dy = g0.y - y;
  const float dz = g0.z - z;
  const float logit =
      -0.5f * (g0.w * dx * dx + g1.x * dy * dy + g1.y * dz * dz) -
      (g1.z * dx * dy + g1.w * dy * dz + g8 * dx * dz);
  return __expf(fminf(logit, 30.f));
}

template <int MAXC, bool PROB>
__global__ void __launch_bounds__(Shape<PROB>::THREADS,
                                  Shape<PROB>::MIN_BLOCKS)
splat_points_kernel(const float* __restrict__ pts, Grid g,
                    const int* __restrict__ order,
                    const int* __restrict__ voxel_start,
                    const int* __restrict__ items, int max_items,
                    const float* __restrict__ gdata,
                    const int* __restrict__ box, const float* __restrict__ sem,
                    int c_arg, const int* __restrict__ tile_start,
                    const int* __restrict__ entries,
                    float* __restrict__ acc_out, float* __restrict__ om_out,
                    int* __restrict__ labels, bool threshold, float thresh,
                    int empty_label,
                    unsigned long long* __restrict__ block_ns) {
  constexpr int SP = round4(MAXC + 2);
  constexpr int R = record_words(SP);
  constexpr int THREADS = Shape<PROB>::THREADS;
  constexpr int BLOCK_POINTS = Shape<PROB>::BLOCK_POINTS;
  constexpr int HALVES = Shape<PROB>::HALVES;
  __shared__ __align__(16) float s_rec[2][CHUNK * R];
  const int C = MAXC == 18 ? 18 : c_arg;
  const int CA = C + 2;

  const int item = blockIdx.x / HALVES;
  if (item >= items[max_items]) return;
  const int first_pt = items[item];
  const int3 v0 = voxel_of(pts, order[first_pt], g);
  const int tile = tile_index(v0, g);
  const int count = min(TILE_VOXELS,
                        voxel_start[(long)(tile + 1) * TILE_VOXELS] -
                            first_pt);
  const int half = (blockIdx.x % HALVES) * BLOCK_POINTS;
  if (half >= count) return;   // the whole block
  const unsigned long long t_begin = block_ns != nullptr ? global_ns() : 0;
  const int3 origin = make_int3(v0.x / TX * TX, v0.y / TY * TY,
                                v0.z / TZ * TZ);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int base = half + (tid >> 5) * 32 * VPT;   // the warp's first point

  bool live[VPT];
  int code[VPT];
  float xs[VPT], ys[VPT], zs[VPT];
  int3 wlo = make_int3(1 << 20, 1 << 20, 1 << 20);
  int3 whi = make_int3(-1, -1, -1);
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    const int j = base + v * 32 + lane;
    live[v] = j < count;
    xs[v] = ys[v] = zs[v] = 0.f;
    code[v] = 0;
    if (live[v]) {
      const long n = order[first_pt + j];
      xs[v] = pts[3 * n];
      ys[v] = pts[3 * n + 1];
      zs[v] = pts[3 * n + 2];
      code[v] = local_code(voxel_of(pts, n, g));
      const int x = code[v] >> CODE_X, y = (code[v] >> CODE_Y) & (TY - 1),
                z = code[v] & (TZ - 1);
      wlo = make_int3(min(wlo.x, x), min(wlo.y, y), min(wlo.z, z));
      whi = make_int3(max(whi.x, x), max(whi.y, y), max(whi.z, z));
    }
  }
  // the warp's bounds (a warp with no point keeps lo > hi: every box
  // misses it)
  const unsigned full = 0xffffffffu;
  wlo = make_int3(__reduce_min_sync(full, wlo.x), __reduce_min_sync(full, wlo.y),
                  __reduce_min_sync(full, wlo.z));
  whi = make_int3(__reduce_max_sync(full, whi.x), __reduce_max_sync(full, whi.y),
                  __reduce_max_sync(full, whi.z));
  const bool warp_live = base < count;
  const bool full_warp = base + 32 * VPT <= count;   // every point live

  float a[VPT][MAXC];
  float ps[VPT], dens[VPT], om[VPT];
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
#pragma unroll
    for (int c = 0; c < MAXC; ++c) a[v][c] = 0.f;
    ps[v] = dens[v] = 0.f;
    om[v] = 1.f;
  }

  const int first = tile_start[tile];
  const int total = tile_start[tile + 1] - first;
  const int nch = (total + CHUNK - 1) / CHUNK;
  if (nch > 0)
    stage_entries<SP, THREADS>(s_rec[0], entries, first, min(CHUNK, total),
                               gdata, nullptr, box, sem, CA, nullptr);
  gf::cp_async_commit();
  for (int k = 0; k < nch; ++k) {
    if (k + 1 < nch) {
      const int f = first + (k + 1) * CHUNK;
      stage_entries<SP, THREADS>(s_rec[(k + 1) & 1], entries, f,
                                 min(CHUNK, first + total - f), gdata,
                                 nullptr, box, sem, CA, nullptr);
    }
    gf::cp_async_commit();
    gf::cp_async_wait<1>();
    __syncthreads();
    const float* buf = s_rec[k & 1];
    const int cnt = warp_live ? min(CHUNK, total - k * CHUNK) : 0;
    for (int s = 0; s < cnt; ++s) {
      const float* rec = buf + s * R;
      const int4 b0 = *reinterpret_cast<const int4*>(rec + 12);  // lo, hi.x
      const int4 b1 = *reinterpret_cast<const int4*>(rec + 16);  // hi.yz, e
      const bool covers = b1.z < 0;
      if (PROB && covers && full_warp && s + 1 < cnt &&
          reinterpret_cast<const int*>(rec + R)[18] < 0) {
        // two COVERS entries in a row at a warp of live points: the four
        // exponents first (independent), then the sums in entry order
        const float* rec2 = rec + R;
        float e1[VPT], e2[VPT];
#pragma unroll
        for (int v = 0; v < VPT; ++v) {
          e1[v] = pair_e(rec, xs[v], ys[v], zs[v]);
          e2[v] = pair_e(rec2, xs[v], ys[v], zs[v]);
        }
#pragma unroll
        for (int v = 0; v < VPT; ++v) {
          add_pair<MAXC, PROB>(e1[v], rec + 20, C, a[v], ps[v], dens[v],
                               om[v]);
          add_pair<MAXC, PROB>(e2[v], rec2 + 20, C, a[v], ps[v], dens[v],
                               om[v]);
        }
        ++s;
        continue;
      }
      // the box in the tile's coordinates
      const int3 lo = make_int3(b0.x - origin.x, b0.y - origin.y,
                                b0.z - origin.z);
      const int3 hi = make_int3(b0.w - origin.x, b1.x - origin.y,
                                b1.y - origin.z);
      // uniform across the warp
      if (!covers && (hi.x < wlo.x || hi.y < wlo.y || hi.z < wlo.z ||
                      lo.x > whi.x || lo.y > whi.y || lo.z > whi.z))
        continue;
#pragma unroll
      for (int v = 0; v < VPT; ++v) {
        if (!(live[v] && (covers || code_in(code[v], lo, hi)))) continue;
        add_pair<MAXC, PROB>(pair_e(rec, xs[v], ys[v], zs[v]), rec + 20, C,
                             a[v], ps[v], dens[v], om[v]);
      }
    }
    __syncthreads();   // the buffer is staged again two chunks on
  }

#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    if (!live[v]) continue;
    const long row = order[first_pt + base + v * 32 + lane];
    float* ao = acc_out + row * CA;
    if constexpr (MAXC == 18) {
      float4* a4 = reinterpret_cast<float4*>(ao);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        a4[j] = make_float4(a[v][4 * j], a[v][4 * j + 1], a[v][4 * j + 2],
                            a[v][4 * j + 3]);
      a4[4] = make_float4(a[v][16], a[v][17], ps[v], dens[v]);
    } else {
#pragma unroll
      for (int c = 0; c < MAXC; ++c)
        if (c < C) ao[c] = a[v][c];
      ao[C] = ps[v];
      ao[C + 1] = dens[v];
    }
    if (PROB) om_out[row] = om[v];
    if (labels == nullptr) continue;
    float best = -INFINITY;
    int lab = 0;
    if (!PROB) {
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        if (c < C && a[v][c] > best) {
          best = a[v][c];
          lab = c;
        }
      }
      labels[row] = lab;
      continue;
    }
    const bool covered = ps[v] > 1e-9f;
    const float denom = covered ? ps[v] : 1.f;
    const float uni = 1.f / (float)(C - 1);
    const float bins = 1.f - om[v];
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (c < C) {
        const float logit =
            covered ? a[v][c] / denom : (c == C - 1 ? 0.f : uni);
        const float comb =
            threshold ? logit : (c == C - 1 ? 1.f - bins : logit * bins);
        if (comb > best) {
          best = comb;
          lab = c;
        }
      }
    }
    labels[row] = threshold && !(bins > thresh) ? empty_label : lab;
  }
  if (block_ns != nullptr) {
    __syncthreads();
    if (tid == 0) {
      block_ns[2 * blockIdx.x] = t_begin;
      block_ns[2 * blockIdx.x + 1] = global_ns();
    }
  }
}

struct Args {
  const float* pts;
  Grid g;
  const int *order, *voxel_start, *items;
  int max_items;
  const float* gdata;
  const int* box;
  const float* sem;
  int C;
  const int *tile_start, *entries;
  float *acc, *om;
  int* labels;
  bool threshold;
  float thresh;
  int empty_label;
  unsigned long long* block_ns;
};

template <int MAXC, bool PROB>
int launch(const Args& x, cudaStream_t st) {
  if (x.max_items == 0) return 0;
  splat_points_kernel<MAXC, PROB>
      <<<x.max_items * Shape<PROB>::HALVES, Shape<PROB>::THREADS, 0, st>>>(
      x.pts, x.g, x.order, x.voxel_start, x.items, x.max_items, x.gdata,
      x.box, x.sem, x.C, x.tile_start, x.entries, x.acc, x.om, x.labels,
      x.threshold, x.thresh, x.empty_label, x.block_ns);
  return (int)cudaGetLastError();
}

}  // namespace

// pts [N, 3] fp32, any points; pc_min: 3 host floats; voxel grid (GH, GW,
// GD) of edge `gs`; the points' bins of splat_points_bin.cu (order [N],
// voxel_start [K + 1], items [max_items + 1] int32); gdata [P, 9] fp32 (mu,
// inverse covariance [xx, yy, zz, xy, yz, xz]); box [P, 6] int32 (voxel lo
// xyz, hi xyz); sem_aug [P, C + 2] fp32; the Gaussians' bins of
// splat_bin.cu (tile_start [T + 1], entries [E] int32). Outputs acc [N, C +
// 2], one_minus [N], labels [N] int32 (or null), each point's row at its
// input index. `label_mode` 0 ("combine") or 1 ("threshold", with `thresh`
// and `empty_label`). block_ns (or null): uint64 [2 max_items, 2], each
// block's (two a work item) first and last %globaltimer reading (blocks
// with no point write none); the additive variant's [max_items, 2]. Returns a cudaError_t, or -1 for C outside 2..32 or an
// unknown mode.
GF_EXPORT int gf_splat_points_forward(
    const void* pts, const float* pc_min, float gs, int GH, int GW, int GD,
    const void* order, const void* voxel_start, const void* items,
    int max_items, const void* gdata, const void* box, const void* sem_aug,
    int C, const void* tile_start, const void* entries, void* acc,
    void* one_minus, void* labels, int label_mode, float thresh,
    int empty_label, void* block_ns, void* stream) {
  if (C < 2 || C > 32 || label_mode < 0 || label_mode > 1) return -1;
  const Args x{(const float*)pts, grid_of(pc_min, gs, GH, GW, GD),
               (const int*)order, (const int*)voxel_start, (const int*)items,
               max_items, (const float*)gdata, (const int*)box,
               (const float*)sem_aug, C, (const int*)tile_start,
               (const int*)entries, (float*)acc, (float*)one_minus,
               (int*)labels, label_mode == 1, thresh, empty_label,
               (unsigned long long*)block_ns};
  return C == 18 ? launch<18, true>(x, (cudaStream_t)stream)
                 : launch<32, true>(x, (cudaStream_t)stream);
}

// The additive variant: sem_aug [P, C + 2] = (sem * opa, opa, 1); outputs
// acc [N, C + 2] and labels [N] int32 (or null), no one_minus.
GF_EXPORT int gf_splat_points_forward_additive(
    const void* pts, const float* pc_min, float gs, int GH, int GW, int GD,
    const void* order, const void* voxel_start, const void* items,
    int max_items, const void* gdata, const void* box, const void* sem_aug,
    int C, const void* tile_start, const void* entries, void* acc,
    void* labels, void* block_ns, void* stream) {
  if (C < 2 || C > 32) return -1;
  const Args x{(const float*)pts, grid_of(pc_min, gs, GH, GW, GD),
               (const int*)order, (const int*)voxel_start, (const int*)items,
               max_items, (const float*)gdata, (const int*)box,
               (const float*)sem_aug, C, (const int*)tile_start,
               (const int*)entries, (float*)acc, nullptr, (int*)labels,
               false, 0.f, 0, (unsigned long long*)block_ns};
  return C == 18 ? launch<18, false>(x, (cudaStream_t)stream)
                 : launch<32, false>(x, (cudaStream_t)stream);
}
