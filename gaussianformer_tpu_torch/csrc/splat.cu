// K4: Gaussian -> voxel splat, forward, with the final-occ label epilogue,
// in both variants of the TPU kernel: `prob` (GaussianFormer-2) and
// `additive` (the v1 models).
//
// Replaces: gaussianformer_tpu/ops/pallas/splat_kernel.py splat_raw_pallas
//           (kernel `_kernel`, with emit_labels), reached through
//           ops/splat.py::splat_deferred -> _splat_pallas_fwd_only.
//
// Computes, for every query point x (a voxel centre) and Gaussian g whose
// integer AABB [lo_g, hi_g] holds the point's voxel (ops/splat.py
// _chunk_step):
//   e      = exp(min(-1/2 (mu_g - x)^T A_g (mu_g - x), 30))
//   acc[c] += e * sem_aug[g, c]     sem_aug = [sem * w, w, 1] (packed by the
//                                   caller: w = (2 pi)^-1.5 sqrt(det A) opa
//                                   for prob, w = opa for additive)
//   om     *= 1 - e                 (prob only)
// then, per point, the label epilogue of the TPU kernel. prob
// (ops/splat.py::_postprocess_prob + _labels_xla): normalise by the
// probability sum with the uniform fallback when it is <= 1e-9, then by the
// label mode, a runtime flag: "combine" (splat_kernel.py:190-193) combines
// semantics with the geometry bin (combine_geosem) and takes the first-index
// argmax; "threshold" (:194-205) takes the first-index argmax of the C
// normalised lanes where the occupancy 1 - om exceeds `thresh` (strictly)
// and `empty_label` elsewhere. The accumulation is the same in both modes.
// additive (_labels_xla, splat_kernel.py mode "additive"): first-index
// argmax of the raw sums acc[:C]; a voxel that no box holds is all zeros
// and gets label 0.
//
// Bound on the H100: flops. The output (640,000 x 20 floats + labels) and
// the Gaussian table are tens of MB; the work is the exponent and the
// 20-channel accumulation of every (point, Gaussian) pair inside an AABB,
// which depends on the Gaussians' radii (counted by the caller from the
// run's data).
//
// Design: the points are the raster voxel grid, and the Gaussians are
// binned by voxel tile beforehand (splat_bin.cu: per tile, the ascending
// indices of the Gaussians whose box meets it, each with a COVERS flag).
// One block per work item of the bins: a tile, the tiles with the longest
// lists first, or half of one whose list is more than twice the mean (its
// first or last TX / 2 x planes, the other warps idle). A thread owns VPT
// voxels along z, so a warp owns one x plane of the tile and the box test on
// x is uniform across it. The
// tile's entries are staged through shared memory in chunks with a
// cp.async double buffer (gdata padded to 12 floats, the box and the entry,
// the sem_aug row), read back with 16-byte loads; each Gaussian read
// serves a thread's VPT voxels. A COVERS entry runs without a box test.
// Where a thread's voxels share x and y (a raster grid), the exponent is
// taken as a quadratic in dz whose three coefficients are computed once per
// Gaussian for the VPT voxels, and exp is the hardware's (ex2.approx). Each
// voxel sums its Gaussians in ascending index order (outside voxels add
// e = 0, which leaves the sums' bits as they were), so the sums are
// deterministic. The accumulation stays on fp32 FMAs: cut out, they were
// a sixth of the kernel's time (the exponent another sixth; the box tests,
// the quadratic and the loop the rest), and a version that summed on
// tensor cores (mma.sync m16n8k8 tf32, hi/lo split, e computed into the A
// fragment) was slower than this one.
#include <math.h>

#include "splat_bin.cuh"

namespace {

using namespace gf::splat;

constexpr int VPT = 4;                      // voxels a thread, along z
constexpr int THREADS = TILE_VOXELS / VPT;  // 256
constexpr int CHUNK = 64;                   // entries staged at once
static_assert(TY * TZ / VPT == 32, "a warp owns one x plane of the tile");

template <int MAXC, bool PROB>
__global__ void __launch_bounds__(THREADS, MAXC <= 18 ? 2 : 1)
splat_kernel(const float* __restrict__ pts, const float* __restrict__ gdata,
             const int* __restrict__ box, const float* __restrict__ sem,
             int c_arg, int GH, int GW, int GD,
             const int* __restrict__ tile_start,
             const int* __restrict__ tile_items,
             const int* __restrict__ entries, float* __restrict__ acc_out,
             float* __restrict__ om_out, int* __restrict__ labels,
             bool threshold, float thresh, int empty_label) {
  constexpr int SP = round4(MAXC + 2);
  constexpr int R = record_words(SP);
  __shared__ __align__(16) float s_rec[2][CHUNK * R];
  // the flagship's width is a constant, so its channel loops fold
  const int C = MAXC == 18 ? 18 : c_arg;
  const int CA = C + 2;

  const int tiles = ((GH + TX - 1) / TX) * ((GW + TY - 1) / TY) *
                    ((GD + TZ - 1) / TZ);
  if (blockIdx.x >= tile_items[2 * tiles]) return;
  const int item = tile_items[blockIdx.x];
  const int tile = item >> 2;
  const int half = item & 3;   // 0 the whole tile, 1 / 2 its x planes' halves
  const Tile tl = tile_of(tile, GH, GW, GD);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const bool mine = half == 0 || ((tid >> 5) < TX / 2) == (half == 1);
  const int ix = tl.x0 + (tid >> 5);
  const int iy = tl.y0 + lane / (TZ / VPT);
  const int iz0 = tl.z0 + (lane % (TZ / VPT)) * VPT;
  const long n0 = ((long)ix * GW + iy) * GD + iz0;
  bool live[VPT];
  float xs[VPT], ys[VPT], zs[VPT];
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    live[v] = mine && ix < GH && iy < GW && iz0 + v < GD;
    xs[v] = ys[v] = zs[v] = 0.f;
    if (live[v]) {
      xs[v] = pts[3 * (n0 + v)];
      ys[v] = pts[3 * (n0 + v) + 1];
      zs[v] = pts[3 * (n0 + v) + 2];
    }
  }
  // on a raster grid a thread's voxels share x and y: the exponent is then
  // a quadratic in dz whose coefficients serve all VPT voxels
  bool column = true;
#pragma unroll
  for (int v = 1; v < VPT; ++v)
    column &= !live[v] || (xs[v] == xs[0] && ys[v] == ys[0]);

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
    const int cnt = min(CHUNK, total - k * CHUNK);
    for (int s = 0; s < cnt; ++s) {
      const float* rec = buf + s * R;
      const int4 b0 = *reinterpret_cast<const int4*>(rec + 12);  // lo, hi.x
      const int4 b1 = *reinterpret_cast<const int4*>(rec + 16);  // hi.yz, e
      bool in[VPT];
      if (b1.z < 0) {   // COVERS: the box holds the whole tile
#pragma unroll
        for (int v = 0; v < VPT; ++v) in[v] = live[v];
      } else {
        if (ix < b0.x || ix > b0.w) continue;   // uniform across the warp
        const bool yin = iy >= b0.y && iy <= b1.x;
#pragma unroll
        for (int v = 0; v < VPT; ++v)
          in[v] = live[v] && yin && iz0 + v >= b0.z && iz0 + v <= b1.y;
      }
      bool any = false;
#pragma unroll
      for (int v = 0; v < VPT; ++v) any |= in[v];
      if (!any) continue;
      const float4 g0 = *reinterpret_cast<const float4*>(rec);
      const float4 g1 = *reinterpret_cast<const float4*>(rec + 4);
      const float g8 = rec[8];
      float e[VPT];
      if (column) {
        const float dx = g0.x - xs[0];
        const float dy = g0.y - ys[0];
        const float q0 =
            -0.5f * (g0.w * dx * dx + g1.x * dy * dy) - g1.z * dx * dy;
        const float q1 = -(g1.w * dy + g8 * dx);
        const float q2 = -0.5f * g1.y;
#pragma unroll
        for (int v = 0; v < VPT; ++v) {
          const float dz = g0.z - zs[v];
          const float logit = fmaf(fmaf(q2, dz, q1), dz, q0);
          e[v] = in[v] ? __expf(fminf(logit, 30.f)) : 0.f;
        }
      } else {
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
    const long n = n0 + v;
    float* ao = acc_out + n * CA;
#pragma unroll
    for (int c = 0; c < MAXC; ++c)
      if (c < C) ao[c] = a[v][c];
    ao[C] = ps[v];
    ao[C + 1] = dens[v];
    if (PROB) om_out[n] = om[v];
    if (labels != nullptr && !PROB) {
      float best = -INFINITY;
      int lab = 0;
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        if (c < C && a[v][c] > best) {
          best = a[v][c];
          lab = c;
        }
      }
      labels[n] = lab;
    } else if (labels != nullptr) {
      const bool covered = ps[v] > 1e-9f;
      const float denom = covered ? ps[v] : 1.f;
      const float uni = 1.f / (float)(C - 1);
      const float bins = 1.f - om[v];
      float best = -INFINITY;
      int lab = 0;
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
      labels[n] = threshold && !(bins > thresh) ? empty_label : lab;
    }
  }
}

template <int MAXC, bool PROB>
int launch(const float* pts, const float* gdata, const int* box,
           const float* sem, int C, int GH, int GW, int GD,
           const int* tile_start, const int* tile_items, const int* entries,
           float* acc, float* om, int* labels, cudaStream_t st,
           bool threshold, float thresh, int empty_label) {
  const int tiles = ((GH + TX - 1) / TX) * ((GW + TY - 1) / TY) *
                    ((GD + TZ - 1) / TZ);
  if (tiles == 0) return 0;
  splat_kernel<MAXC, PROB><<<2 * tiles, THREADS, 0, st>>>(
      pts, gdata, box, sem, C, GH, GW, GD, tile_start, tile_items, entries,
      acc, om,
      labels, threshold, thresh, empty_label);
  return (int)cudaGetLastError();
}

}  // namespace

// pts [GH * GW * GD, 3] fp32, the raster voxel grid (x slowest, z fastest);
// gdata [P, 9] fp32 (mu, inverse covariance [xx, yy, zz, xy, yz, xz]); box
// [P, 6] int32 (voxel lo xyz, hi xyz); sem_aug [P, C + 2] fp32; the bins of
// splat_bin.cu (tile_start [tiles + 1], tile_items [2 tiles + 1], entries
// [E] int32). Outputs acc
// [N, C + 2], one_minus [N], labels [N] int32 (or null). `label_mode` 0
// ("combine") or 1 ("threshold", with `thresh` and `empty_label`). Returns a
// cudaError_t, or -1 for C outside 2..32 or an unknown mode.
GF_EXPORT int gf_splat_forward(const void* pts, const void* gdata,
                               const void* box, const void* sem_aug, int C,
                               int GH, int GW, int GD, const void* tile_start,
                               const void* tile_items, const void* entries,
                               void* acc, void* one_minus, void* labels,
                               int label_mode, float thresh, int empty_label,
                               void* stream) {
  if (C < 2 || C > 32 || label_mode < 0 || label_mode > 1) return -1;
  auto run = C == 18 ? launch<18, true> : launch<32, true>;
  return run((const float*)pts, (const float*)gdata, (const int*)box,
             (const float*)sem_aug, C, GH, GW, GD, (const int*)tile_start,
             (const int*)tile_items, (const int*)entries, (float*)acc,
             (float*)one_minus, (int*)labels, (cudaStream_t)stream,
             label_mode == 1, thresh, empty_label);
}

// The additive variant: sem_aug [P, C + 2] = (sem * opa, opa, 1); outputs
// acc [N, C + 2] and labels [N] int32 (or null), no one_minus.
GF_EXPORT int gf_splat_forward_additive(const void* pts, const void* gdata,
                                        const void* box, const void* sem_aug,
                                        int C, int GH, int GW, int GD,
                                        const void* tile_start,
                                        const void* tile_items,
                                        const void* entries, void* acc,
                                        void* labels, void* stream) {
  if (C < 2 || C > 32) return -1;
  auto run = C == 18 ? launch<18, false> : launch<32, false>;
  return run((const float*)pts, (const float*)gdata, (const int*)box,
             (const float*)sem_aug, C, GH, GW, GD, (const int*)tile_start,
             (const int*)tile_items, (const int*)entries, (float*)acc,
             nullptr, (int*)labels, (cudaStream_t)stream, false, 0.f, 0);
}
