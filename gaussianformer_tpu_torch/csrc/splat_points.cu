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
// Design: the points are binned by voxel tile (splat_points_bin.cu: each
// tile's points in input order, cut into work items of at most
// TILE_VOXELS), and the Gaussians keep their tile bins (splat_bin.cu). One
// block per work item: a thread takes VPT of the item's points (strided by
// the block, so that a warp's points are neighbours in the input order),
// keeps each point's place in the tile as a packed code, and walks the
// tile's entries, staged through shared memory in chunks with a cp.async
// double buffer as splat.cu stages them. The block first gathers its
// points' bounds in the tile, so an entry whose box misses them all is
// skipped by the whole block; a COVERS entry runs without a box test.
// The points share no x and y, so the exponent is the full quadratic form
// at each point's own coordinates (there is no dz recurrence, the TPU
// kernel's zrun path). Each point sums its Gaussians in ascending index
// order and writes its own row at its input index: no atomics, so a
// second call gives the same bits.
#include <math.h>

#include "splat_points.cuh"

namespace {

using namespace gf::splat;

constexpr int VPT = 4;                      // points a thread
constexpr int THREADS = TILE_VOXELS / VPT;  // 256
constexpr int CHUNK = 64;                   // entries staged at once

template <int MAXC, bool PROB>
__global__ void __launch_bounds__(THREADS, MAXC <= 18 ? 2 : 1)
splat_points_kernel(const float* __restrict__ pts, Grid g,
                    const int* __restrict__ order,
                    const int* __restrict__ pt_start,
                    const int* __restrict__ items, int max_items,
                    const float* __restrict__ gdata,
                    const int* __restrict__ box, const float* __restrict__ sem,
                    int c_arg, const int* __restrict__ tile_start,
                    const int* __restrict__ entries,
                    float* __restrict__ acc_out, float* __restrict__ om_out,
                    int* __restrict__ labels, bool threshold, float thresh,
                    int empty_label) {
  constexpr int SP = round4(MAXC + 2);
  constexpr int R = record_words(SP);
  __shared__ __align__(16) float s_rec[2][CHUNK * R];
  __shared__ int s_bounds[6];
  const int C = MAXC == 18 ? 18 : c_arg;
  const int CA = C + 2;

  if (blockIdx.x >= items[max_items]) return;
  const int first_pt = items[blockIdx.x];
  const int3 v0 = voxel_of(pts, order[first_pt], g);
  const int tile = tile_index(v0, g);
  const int count = min(TILE_VOXELS, pt_start[tile + 1] - first_pt);
  const int3 origin = make_int3(v0.x / TX * TX, v0.y / TY * TY,
                                v0.z / TZ * TZ);
  const int tid = threadIdx.x;
  bounds_reset(s_bounds);
  __syncthreads();

  bool live[VPT];
  int code[VPT];
  float xs[VPT], ys[VPT], zs[VPT];
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    const int j = tid + v * THREADS;
    live[v] = j < count;
    xs[v] = ys[v] = zs[v] = 0.f;
    code[v] = 0;
    if (live[v]) {
      const long n = order[first_pt + j];
      xs[v] = pts[3 * n];
      ys[v] = pts[3 * n + 1];
      zs[v] = pts[3 * n + 2];
      code[v] = local_code(voxel_of(pts, n, g));
      bounds_add(s_bounds, code[v]);
    }
  }

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
    __syncthreads();   // the chunk, and (first time) the item's bounds
    const float* buf = s_rec[k & 1];
    const int cnt = min(CHUNK, total - k * CHUNK);
    for (int s = 0; s < cnt; ++s) {
      const float* rec = buf + s * R;
      const int4 b0 = *reinterpret_cast<const int4*>(rec + 12);  // lo, hi.x
      const int4 b1 = *reinterpret_cast<const int4*>(rec + 16);  // hi.yz, e
      const bool covers = b1.z < 0;
      // the box in the tile's coordinates
      const int3 lo = make_int3(b0.x - origin.x, b0.y - origin.y,
                                b0.z - origin.z);
      const int3 hi = make_int3(b0.w - origin.x, b1.x - origin.y,
                                b1.y - origin.z);
      if (!covers && misses(s_bounds, lo, hi)) continue;   // the block
      bool in[VPT];
      bool any = false;
#pragma unroll
      for (int v = 0; v < VPT; ++v) {
        in[v] = live[v] && (covers || code_in(code[v], lo, hi));
        any |= in[v];
      }
      if (!any) continue;
      const float4 g0 = *reinterpret_cast<const float4*>(rec);
      const float4 g1 = *reinterpret_cast<const float4*>(rec + 4);
      const float g8 = rec[8];
      float e[VPT];
#pragma unroll
      for (int v = 0; v < VPT; ++v) {
        const float dx = g0.x - xs[v];
        const float dy = g0.y - ys[v];
        const float dz = g0.z - zs[v];
        const float logit =
            -0.5f * (g0.w * dx * dx + g1.x * dy * dy + g1.y * dz * dz) -
            (g1.z * dx * dy + g1.w * dy * dz + g8 * dx * dz);
        e[v] = in[v] ? __expf(fminf(logit, 30.f)) : 0.f;
      }
      const float* sr = rec + 20;
      if constexpr (MAXC == 18) {
        float q[20];
#pragma unroll
        for (int j = 0; j < 5; ++j) {
          const float4 t = reinterpret_cast<const float4*>(sr)[j];
          q[4 * j] = t.x;
          q[4 * j + 1] = t.y;
          q[4 * j + 2] = t.z;
          q[4 * j + 3] = t.w;
        }
#pragma unroll
        for (int v = 0; v < VPT; ++v) {
#pragma unroll
          for (int c = 0; c < 18; ++c) a[v][c] += e[v] * q[c];
          ps[v] += e[v] * q[18];
          dens[v] += e[v] * q[19];
        }
      } else {
#pragma unroll
        for (int c = 0; c < MAXC; ++c) {
          if (c < C) {
            const float q = sr[c];
#pragma unroll
            for (int v = 0; v < VPT; ++v) a[v][c] += e[v] * q;
          }
        }
        const float qp = sr[C], qd = sr[C + 1];
#pragma unroll
        for (int v = 0; v < VPT; ++v) {
          ps[v] += e[v] * qp;
          dens[v] += e[v] * qd;
        }
      }
      if (PROB) {
#pragma unroll
        for (int v = 0; v < VPT; ++v) om[v] *= 1.f - e[v];
      }
    }
    __syncthreads();   // the buffer is staged again two chunks on
  }

#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    if (!live[v]) continue;
    const long row = order[first_pt + tid + v * THREADS];
    float* ao = acc_out + row * CA;
#pragma unroll
    for (int c = 0; c < MAXC; ++c)
      if (c < C) ao[c] = a[v][c];
    ao[C] = ps[v];
    ao[C + 1] = dens[v];
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
}

struct Args {
  const float* pts;
  Grid g;
  const int *order, *pt_start, *items;
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
};

template <int MAXC, bool PROB>
int launch(const Args& x, cudaStream_t st) {
  if (x.max_items == 0) return 0;
  splat_points_kernel<MAXC, PROB><<<x.max_items, THREADS, 0, st>>>(
      x.pts, x.g, x.order, x.pt_start, x.items, x.max_items, x.gdata, x.box,
      x.sem, x.C, x.tile_start, x.entries, x.acc, x.om, x.labels,
      x.threshold, x.thresh, x.empty_label);
  return (int)cudaGetLastError();
}

}  // namespace

// pts [N, 3] fp32, any points; pc_min: 3 host floats; voxel grid (GH, GW,
// GD) of edge `gs`; the points' bins of splat_points_bin.cu (order [N],
// pt_start [T + 1], items [max_items + 1] int32); gdata [P, 9] fp32 (mu,
// inverse covariance [xx, yy, zz, xy, yz, xz]); box [P, 6] int32 (voxel lo
// xyz, hi xyz); sem_aug [P, C + 2] fp32; the Gaussians' bins of
// splat_bin.cu (tile_start [T + 1], entries [E] int32). Outputs acc [N, C +
// 2], one_minus [N], labels [N] int32 (or null), each point's row at its
// input index. `label_mode` 0 ("combine") or 1 ("threshold", with `thresh`
// and `empty_label`). Returns a cudaError_t, or -1 for C outside 2..32 or
// an unknown mode.
GF_EXPORT int gf_splat_points_forward(
    const void* pts, const float* pc_min, float gs, int GH, int GW, int GD,
    const void* order, const void* pt_start, const void* items,
    int max_items, const void* gdata, const void* box, const void* sem_aug,
    int C, const void* tile_start, const void* entries, void* acc,
    void* one_minus, void* labels, int label_mode, float thresh,
    int empty_label, void* stream) {
  if (C < 2 || C > 32 || label_mode < 0 || label_mode > 1) return -1;
  const Args x{(const float*)pts, grid_of(pc_min, gs, GH, GW, GD),
               (const int*)order, (const int*)pt_start, (const int*)items,
               max_items, (const float*)gdata, (const int*)box,
               (const float*)sem_aug, C, (const int*)tile_start,
               (const int*)entries, (float*)acc, (float*)one_minus,
               (int*)labels, label_mode == 1, thresh, empty_label};
  return C == 18 ? launch<18, true>(x, (cudaStream_t)stream)
                 : launch<32, true>(x, (cudaStream_t)stream);
}

// The additive variant: sem_aug [P, C + 2] = (sem * opa, opa, 1); outputs
// acc [N, C + 2] and labels [N] int32 (or null), no one_minus.
GF_EXPORT int gf_splat_points_forward_additive(
    const void* pts, const float* pc_min, float gs, int GH, int GW, int GD,
    const void* order, const void* pt_start, const void* items,
    int max_items, const void* gdata, const void* box, const void* sem_aug,
    int C, const void* tile_start, const void* entries, void* acc,
    void* labels, void* stream) {
  if (C < 2 || C > 32) return -1;
  const Args x{(const float*)pts, grid_of(pc_min, gs, GH, GW, GD),
               (const int*)order, (const int*)pt_start, (const int*)items,
               max_items, (const float*)gdata, (const int*)box,
               (const float*)sem_aug, C, (const int*)tile_start,
               (const int*)entries, (float*)acc, nullptr, (int*)labels,
               false, 0.f, 0};
  return C == 18 ? launch<18, false>(x, (cudaStream_t)stream)
                 : launch<32, false>(x, (cudaStream_t)stream);
}
