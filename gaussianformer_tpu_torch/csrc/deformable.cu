// K3: multi-camera, multi-level deformable feature aggregation, forward,
// with the key-point sum fused.
//
// Replaces: gaussianformer_tpu/ops/pallas/deformable_kernel.py
//           deformable_fused_fwd (kernel `_fwd_kernel`), reached through
//           ops/deformable.py::deformable_aggregation_fused_cm.
//
// Computes ops/deformable.py::deformable_aggregation followed by the sum
// over the key points of each anchor:
//   out[b, p, c] = sum_{k, cam, l} [0 < u < 1 and 0 < v < 1]
//                  * weight[b, p*K + k, cam, l, c / (C / G)]
//                  * bilinear(feat_l[b, cam], u * W_l - 0.5, v * H_l - 0.5)[c]
// with (u, v) = points[b, p*K + k, cam] and corners outside the level
// contributing zero (deformable.py:113-160).
//
// Bound on the H100: bytes. Each in-image (key point, camera) pair reads 4
// corners x 4 levels of C channels; at flagship size the feature maps are
// about 44 MB of bf16 (mostly L2 hits: the card's L2 holds 50 MB) and the
// inputs another 10 MB. Flops are negligible; the latency of dependent
// loads is what a design must hide.
//
// Design: a direct gather, like the reference's
// deformable_aggregation_cuda.cu, with the loads of a pair issued together.
// One warp owns one anchor; each lane owns VEC contiguous channels (one
// vector load per corner, a warp reads a whole channel row). The lanes
// load the anchor's K x cams (u, v) in one coalesced load (32 pairs at a
// time) and one ballot gives the in-image pairs; the warp visits only
// those, taking (u, v) by shuffle. The level count is a template
// parameter, and a pair's 4 L corner addresses are computed branch-free
// (clamped into the level, zero weight outside), so all 16 loads of a pair
// (with its L weights) are in flight before the first FMA. Sums are fp32
// registers in the pairs' order, so the key-point sum is fused with no
// atomics and no intermediate tensors. Unlike the TPU kernel it needs no
// x-sort, no sampling windows and no spill clean-up.
#include "deformable.cuh"

namespace {

using gf::deform::Chunk;
using gf::deform::Levels;

constexpr int WARPS = 8;

template <typename T, int VEC, int L>
__global__ void __launch_bounds__(WARPS * 32)
deformable_kernel(Levels lv, const float* __restrict__ pts,
                  const float* __restrict__ wts, float* __restrict__ out,
                  int B, int P, int K, int cams, int C, int G) {
  constexpr int LB = gf::deform::levels_in_flight<T, VEC, L>();
  const int warp = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (warp >= B * P) return;   // the whole warp
  const int c0 = lane * VEC;
  const int g = c0 / (C / G);
  const int KC = K * cams;
  const long pair0 = (long)warp * KC;   // the anchor's first pair
  const int b = warp / P;

  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;

  for (int j0 = 0; j0 < KC; j0 += 32) {
    float u = 0.f, v = 0.f;
    if (j0 + lane < KC) {
      const float2 uv =
          reinterpret_cast<const float2*>(pts)[pair0 + j0 + lane];
      u = uv.x;
      v = uv.y;
    }
    unsigned todo = __ballot_sync(0xffffffffu, gf::deform::inside(u, v));
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const float pu = __shfl_sync(0xffffffffu, u, src);
      const float pv = __shfl_sync(0xffffffffu, v, src);
      const long pair = pair0 + j0 + src;
      const int cam = (j0 + src) % cams;
      const long plane = (long)b * cams + cam;
#pragma unroll
      for (int l0 = 0; l0 < L; l0 += LB) {
        Chunk<T, VEC> f[LB][4];
        float cwt[LB][4];
#pragma unroll
        for (int i = 0; i < LB; ++i) {
          const int l = l0 + i;
          const int hl = lv.h[l], wl = lv.w[l];
          const float wgt = wts[(pair * L + l) * G + g];
          const gf::deform::Corners cn = gf::deform::corners(pu, pv, hl, wl);
          const T* base = static_cast<const T*>(lv.ptr[l]) +
                          plane * hl * wl * C + c0;
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            f[i][n].load(base + (long)cn.pix[n] * C);
            cwt[i][n] = cn.cw[n] * wgt;
          }
        }
#pragma unroll
        for (int i = 0; i < LB; ++i)
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[e] += f[i][n].get(e) * cwt[i][n];
      }
    }
  }
  gf::store_vec<VEC>(out + (long)warp * C + c0, acc);
}

template <typename T, int VEC, int L>
int launch(const Levels& lv, const float* pts, const float* wts, float* out,
           int B, int P, int K, int cams, int C, int G, cudaStream_t st) {
  const int warps = B * P;
  if (warps == 0) return 0;
  const int blocks = (warps + WARPS - 1) / WARPS;
  deformable_kernel<T, VEC, L><<<blocks, WARPS * 32, 0, st>>>(
      lv, pts, wts, out, B, P, K, cams, C, G);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int by_levels(const Levels& lv, const float* pts, const float* wts,
              float* out, int B, int P, int K, int cams, int C, int G,
              cudaStream_t st) {
  switch (lv.n) {
    case 1: return launch<T, VEC, 1>(lv, pts, wts, out, B, P, K, cams, C, G, st);
    case 2: return launch<T, VEC, 2>(lv, pts, wts, out, B, P, K, cams, C, G, st);
    case 3: return launch<T, VEC, 3>(lv, pts, wts, out, B, P, K, cams, C, G, st);
    case 4: return launch<T, VEC, 4>(lv, pts, wts, out, B, P, K, cams, C, G, st);
    default: return -1;
  }
}

template <typename T>
int dispatch(const Levels& lv, const float* pts, const float* wts,
             float* out, int B, int P, int K, int cams, int C, int G,
             cudaStream_t st) {
  switch (C / 32) {
    case 1: return by_levels<T, 1>(lv, pts, wts, out, B, P, K, cams, C, G, st);
    case 2: return by_levels<T, 2>(lv, pts, wts, out, B, P, K, cams, C, G, st);
    case 4: return by_levels<T, 4>(lv, pts, wts, out, B, P, K, cams, C, G, st);
    case 8: return by_levels<T, 8>(lv, pts, wts, out, B, P, K, cams, C, G, st);
    default: return -1;
  }
}

}  // namespace

// feats: `num_levels` pointers to [B, cams, H_l, W_l, C] (fp32 when
// is_bf16 == 0, else bf16); pts [B, P*K, cams, 2] fp32; wts
// [B, P*K, cams, L, G] fp32; out [B, P, C] fp32.
// Requires C in {32, 64, 128, 256} and (C / G) % (C / 32) == 0.
// Returns a cudaError_t, or -1 for an unsupported C.
GF_EXPORT int gf_deformable_forward(const void* const* feats,
                                    const int* heights, const int* widths,
                                    int num_levels, int is_bf16,
                                    const void* pts, const void* wts,
                                    void* out, int B, int P, int K, int cams,
                                    int C, int G, void* stream) {
  using gf::deform::MAX_LEVELS;
  if (num_levels < 1 || num_levels > MAX_LEVELS) return -1;
  if (C % 32 != 0 || C % G != 0 || (C / G) % (C / 32) != 0) return -1;
  Levels lv;
  lv.n = num_levels;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    lv.ptr[l] = l < num_levels ? feats[l] : nullptr;
    lv.grad[l] = nullptr;
    lv.h[l] = l < num_levels ? heights[l] : 0;
    lv.w[l] = l < num_levels ? widths[l] : 0;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch<__nv_bfloat16>(lv, (const float*)pts, (const float*)wts,
                                   (float*)out, B, P, K, cams, C, G, st);
  return dispatch<float>(lv, (const float*)pts, (const float*)wts,
                         (float*)out, B, P, K, cams, C, G, st);
}
