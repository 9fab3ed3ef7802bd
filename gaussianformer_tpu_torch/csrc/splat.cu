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
// probability sum with the uniform fallback when it is <= 1e-9, combine
// semantics with the geometry bin (combine_geosem), first-index argmax.
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
// Design: a first version tiled over voxels. A block owns TILE consecutive
// points (one per thread) and walks the Gaussians in chunks of TILE: each
// thread tests one Gaussian's box against the block's voxel bounds, the
// overlapping ones are compacted into shared memory in index order (warp
// ballots, so the accumulation order is deterministic), and every thread
// then runs the per-point AABB test and, inside it, the exponent and the
// accumulation in registers. Per-tile binning of the Gaussians (the
// reference's localagg_prob) is the next step: with the v1 models' many
// small boxes (25,601 or 144,000 Gaussians of 1-4 voxels radius) the scan
// of every box by every block is most of the time. The variant is a
// template parameter, so the prob kernel's code is as it was.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int TILE = 256;
constexpr int WARPS = TILE / 32;

template <int MAXC, bool PROB>
__global__ void __launch_bounds__(TILE)
splat_kernel(const float* __restrict__ pts, int N,
             const float* __restrict__ gdata, const int* __restrict__ box,
             const float* __restrict__ sem, int P, int C, float pcx,
             float pcy, float pcz, float gs, int GH, int GW, int GD,
             float* __restrict__ acc_out, float* __restrict__ om_out,
             int* __restrict__ labels) {
  extern __shared__ float smem[];
  const int CA = C + 2;
  float* s_g = smem;                                   // [TILE][9]
  int* s_box = reinterpret_cast<int*>(s_g + TILE * 9);  // [TILE][6]
  float* s_sem = reinterpret_cast<float*>(s_box + TILE * 6);  // [TILE][CA]
  __shared__ int s_lo[3], s_hi[3];
  __shared__ int s_wcount[WARPS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long n = (long)blockIdx.x * TILE + tid;
  const bool live = n < N;

  float x = 0.f, y = 0.f, z = 0.f;
  int iv[3] = {0, 0, 0};
  if (live) {
    x = pts[3 * n];
    y = pts[3 * n + 1];
    z = pts[3 * n + 2];
    const float pc[3] = {pcx, pcy, pcz};
    const float xyz[3] = {x, y, z};
    const int dims[3] = {GH, GW, GD};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      int i = (int)floorf((xyz[a] - pc[a]) / gs);
      iv[a] = min(max(i, 0), dims[a] - 1);
    }
  }
  if (tid < 3) {
    s_lo[tid] = 0x7fffffff;
    s_hi[tid] = -0x7fffffff;
  }
  __syncthreads();
  if (live) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      atomicMin(&s_lo[a], iv[a]);
      atomicMax(&s_hi[a], iv[a]);
    }
  }
  __syncthreads();
  const int lo0 = s_lo[0], lo1 = s_lo[1], lo2 = s_lo[2];
  const int hi0 = s_hi[0], hi1 = s_hi[1], hi2 = s_hi[2];

  float a[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) a[c] = 0.f;
  float ps = 0.f, dens = 0.f, om = 1.f;

  for (int j0 = 0; j0 < P; j0 += TILE) {
    const int j = j0 + tid;
    int bx[6];
    bool hit = false;
    if (j < P) {
#pragma unroll
      for (int e = 0; e < 6; ++e) bx[e] = box[6 * (long)j + e];
      hit = bx[0] <= hi0 && bx[3] >= lo0 && bx[1] <= hi1 && bx[4] >= lo1 &&
            bx[2] <= hi2 && bx[5] >= lo2;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) s_wcount[warp] = __popc(bal);
    __syncthreads();
    int off = 0, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int cnt = s_wcount[w];
      off += w < warp ? cnt : 0;
      total += cnt;
    }
    if (hit) {
      const int slot = off + __popc(bal & ((1u << lane) - 1u));
#pragma unroll
      for (int e = 0; e < 9; ++e) s_g[slot * 9 + e] = gdata[9 * (long)j + e];
#pragma unroll
      for (int e = 0; e < 6; ++e) s_box[slot * 6 + e] = bx[e];
      for (int e = 0; e < CA; ++e)
        s_sem[slot * CA + e] = sem[(long)j * CA + e];
    }
    __syncthreads();
    if (live) {
      for (int s = 0; s < total; ++s) {
        const int* b = s_box + s * 6;
        if (iv[0] < b[0] || iv[0] > b[3] || iv[1] < b[1] || iv[1] > b[4] ||
            iv[2] < b[2] || iv[2] > b[5])
          continue;
        const float* g = s_g + s * 9;
        const float dx = g[0] - x;
        const float dy = g[1] - y;
        const float dz = g[2] - z;
        const float logit =
            -0.5f * (g[3] * dx * dx + g[4] * dy * dy + g[5] * dz * dz) -
            (g[6] * dx * dy + g[7] * dy * dz + g[8] * dx * dz);
        const float e = expf(fminf(logit, 30.f));
        const float* sr = s_sem + s * CA;
#pragma unroll
        for (int c = 0; c < MAXC; ++c)
          if (c < C) a[c] += e * sr[c];
        ps += e * sr[C];
        dens += e * sr[C + 1];
        if (PROB) om *= 1.f - e;
      }
    }
    __syncthreads();
  }

  if (!live) return;
  float* ao = acc_out + n * CA;
#pragma unroll
  for (int c = 0; c < MAXC; ++c)
    if (c < C) ao[c] = a[c];
  ao[C] = ps;
  ao[C + 1] = dens;
  if (PROB) om_out[n] = om;
  if (labels != nullptr && !PROB) {
    float best = -INFINITY;
    int lab = 0;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (c < C && a[c] > best) {
        best = a[c];
        lab = c;
      }
    }
    labels[n] = lab;
  } else if (labels != nullptr) {
    const bool covered = ps > 1e-9f;
    const float denom = covered ? ps : 1.f;
    const float uni = 1.f / (float)(C - 1);
    const float bins = 1.f - om;
    float best = -INFINITY;
    int lab = 0;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (c < C) {
        const float logit = covered ? a[c] / denom : (c == C - 1 ? 0.f : uni);
        const float comb = c == C - 1 ? 1.f - bins : logit * bins;
        if (comb > best) {
          best = comb;
          lab = c;
        }
      }
    }
    labels[n] = lab;
  }
}

template <int MAXC, bool PROB>
int launch(const float* pts, int N, const float* gdata, const int* box,
           const float* sem, int P, int C, const float* pc, float gs, int GH,
           int GW, int GD, float* acc, float* om, int* labels,
           cudaStream_t st) {
  const size_t smem = (size_t)TILE * (9 + 6 + C + 2) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      splat_kernel<MAXC, PROB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + TILE - 1) / TILE;
  splat_kernel<MAXC, PROB><<<blocks, TILE, smem, st>>>(
      pts, N, gdata, box, sem, P, C, pc[0], pc[1], pc[2], gs, GH, GW, GD,
      acc, om, labels);
  return (int)cudaGetLastError();
}

}  // namespace

// pts [N, 3] fp32; gdata [P, 9] fp32 (mu, inverse covariance
// [xx, yy, zz, xy, yz, xz]); box [P, 6] int32 (voxel lo xyz, hi xyz);
// sem_aug [P, C + 2] fp32; pc_min: 3 host floats; voxel grid (GH, GW, GD)
// of edge `gs`. Outputs acc [N, C + 2], one_minus [N], labels [N] int32
// (or null). Returns a cudaError_t, or -1 for C outside 2..32.
GF_EXPORT int gf_splat_forward(const void* pts, int N, const void* gdata,
                               const void* box, const void* sem_aug, int P,
                               int C, const float* pc_min, float gs, int GH,
                               int GW, int GD, void* acc, void* one_minus,
                               void* labels, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C < 2 || C > 32) return -1;
  if (C == 18)
    return launch<18, true>((const float*)pts, N, (const float*)gdata,
                      (const int*)box, (const float*)sem_aug, P, C, pc_min,
                      gs, GH, GW, GD, (float*)acc, (float*)one_minus,
                      (int*)labels, st);
  return launch<32, true>((const float*)pts, N, (const float*)gdata,
                    (const int*)box, (const float*)sem_aug, P, C, pc_min, gs,
                    GH, GW, GD, (float*)acc, (float*)one_minus, (int*)labels,
                    st);
}

// The additive variant: sem_aug [P, C + 2] = (sem * opa, opa, 1); outputs
// acc [N, C + 2] and labels [N] int32 (or null), no one_minus.
GF_EXPORT int gf_splat_forward_additive(const void* pts, int N,
                                        const void* gdata, const void* box,
                                        const void* sem_aug, int P, int C,
                                        const float* pc_min, float gs, int GH,
                                        int GW, int GD, void* acc,
                                        void* labels, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C < 2 || C > 32) return -1;
  if (C == 18)
    return launch<18, false>((const float*)pts, N, (const float*)gdata,
                             (const int*)box, (const float*)sem_aug, P, C,
                             pc_min, gs, GH, GW, GD, (float*)acc, nullptr,
                             (int*)labels, st);
  return launch<32, false>((const float*)pts, N, (const float*)gdata,
                           (const int*)box, (const float*)sem_aug, P, C,
                           pc_min, gs, GH, GW, GD, (float*)acc, nullptr,
                           (int*)labels, st);
}
