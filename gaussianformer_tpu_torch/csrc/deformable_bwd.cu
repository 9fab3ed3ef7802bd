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
// Bound on the H100: bytes. The fp32 feature gradients (6 cams x 28,700
// pixels x 128 channels at flagship size, 88 MB) are written, the bf16
// features (44 MB) read; flops are negligible.
//
// Design: K3's gather, mirrored. One warp owns one anchor; each lane owns
// VEC contiguous channels and keeps its g_out slice in registers. For each
// in-image (key point, camera) pair and level, a lane reads its corner
// channels once, scatters w cw g_out into the fp32 feature gradient with
// one vector atomicAdd (a float4 at C = 128), and forms its partial dot
// products: the weight gradient is reduced over the group's lanes
// (shuffles), the (u, v) gradient over the whole warp. Each (key point,
// camera, level, group) belongs to one warp, so those gradients are plain
// stores; only the feature gradient needs atomics (their order changes
// from run to run).
#include "common.cuh"

namespace {

constexpr int MAX_LEVELS = 4;
constexpr int WARPS = 8;

struct Levels {
  const void* ptr[MAX_LEVELS];
  float* grad[MAX_LEVELS];
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int n;
};

template <typename T, int VEC>
__global__ void __launch_bounds__(WARPS * 32)
deformable_bwd_kernel(Levels lv, const float* __restrict__ pts,
                      const float* __restrict__ wts,
                      const float* __restrict__ gout,
                      float* __restrict__ g_pts, float* __restrict__ g_wts,
                      int B, int P, int K, int cams, int C, int G) {
  const int warp = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (warp >= B * P) return;
  const int b = warp / P;
  const int p = warp % P;
  const int c0 = lane * VEC;
  const int gdim = C / G;
  const int g = c0 / gdim;
  const int lanes_per_group = gdim / VEC;
  const int L = lv.n;
  const long Q = (long)P * K;

  float go[VEC];
  {
    const float* src = gout + ((long)b * P + p) * C + c0;
#pragma unroll
    for (int e = 0; e < VEC; ++e) go[e] = src[e];
  }

  for (int k = 0; k < K; ++k) {
    const long q = (long)b * Q + (long)p * K + k;
    for (int cam = 0; cam < cams; ++cam) {
      const float u = pts[(q * cams + cam) * 2];
      const float v = pts[(q * cams + cam) * 2 + 1];
      if (!(u > 0.f && u < 1.f && v > 0.f && v < 1.f)) continue;
      const long row = (q * cams + cam) * L;
      float gu = 0.f, gv = 0.f;
      for (int l = 0; l < L; ++l) {
        const int hl = lv.h[l];
        const int wl = lv.w[l];
        const float wgt = wts[(row + l) * G + g];
        const float w_im = __fsub_rn(__fmul_rn(u, (float)wl), 0.5f);
        const float h_im = __fsub_rn(__fmul_rn(v, (float)hl), 0.5f);
        const float h0f = floorf(h_im);
        const float w0f = floorf(w_im);
        const float lh = h_im - h0f;
        const float lw = w_im - w0f;
        const int h0 = (int)h0f;
        const int w0 = (int)w0f;
        const float cw[4] = {(1.f - lh) * (1.f - lw), (1.f - lh) * lw,
                             lh * (1.f - lw), lh * lw};
        const float dlw[4] = {-(1.f - lh), 1.f - lh, -lh, lh};
        const float dlh[4] = {-(1.f - lw), -lw, 1.f - lw, lw};
        const long plane = (long)(b * cams + cam) * hl * wl;
        const T* base = static_cast<const T*>(lv.ptr[l]) + plane * C;
        float* gbase = lv.grad[l] + plane * C;
        float sw = 0.f, su = 0.f, sv = 0.f;
#pragma unroll
        for (int cn = 0; cn < 4; ++cn) {
          const int hy = h0 + (cn >> 1);
          const int wx = w0 + (cn & 1);
          if (hy < 0 || hy > hl - 1 || wx < 0 || wx > wl - 1) continue;
          const long off = ((long)hy * wl + wx) * C + c0;
          float f[VEC];
          gf::load_vec<VEC>(base + off, f);
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) dot += f[e] * go[e];
          sw += cw[cn] * dot;
          su += dlw[cn] * dot;
          sv += dlh[cn] * dot;
          const float s = wgt * cw[cn];
          float share[VEC];
#pragma unroll
          for (int e = 0; e < VEC; ++e) share[e] = s * go[e];
          gf::atomic_add_vec<VEC>(gbase + off, share);
        }
        // weight gradient: sum over the group's lanes
        for (int s = lanes_per_group / 2; s >= 1; s >>= 1)
          sw += __shfl_xor_sync(0xffffffffu, sw, s);
        if (lane % lanes_per_group == 0) g_wts[(row + l) * G + g] = sw;
        gu += wgt * su * (float)wl;
        gv += wgt * sv * (float)hl;
      }
#pragma unroll
      for (int s = 16; s >= 1; s >>= 1) {
        gu += __shfl_xor_sync(0xffffffffu, gu, s);
        gv += __shfl_xor_sync(0xffffffffu, gv, s);
      }
      if (lane == 0) {
        g_pts[(q * cams + cam) * 2] = gu;
        g_pts[(q * cams + cam) * 2 + 1] = gv;
      }
    }
  }
}

template <typename T, int VEC>
int launch(const Levels& lv, const float* pts, const float* wts,
           const float* gout, float* g_pts, float* g_wts, int B, int P,
           int K, int cams, int C, int G, cudaStream_t st) {
  const int warps = B * P;
  const int blocks = (warps + WARPS - 1) / WARPS;
  deformable_bwd_kernel<T, VEC><<<blocks, WARPS * 32, 0, st>>>(
      lv, pts, wts, gout, g_pts, g_wts, B, P, K, cams, C, G);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Levels& lv, const float* pts, const float* wts,
             const float* gout, float* g_pts, float* g_wts, int B, int P,
             int K, int cams, int C, int G, cudaStream_t st) {
  switch (C / 32) {
    case 1:
      return launch<T, 1>(lv, pts, wts, gout, g_pts, g_wts, B, P, K, cams,
                          C, G, st);
    case 2:
      return launch<T, 2>(lv, pts, wts, gout, g_pts, g_wts, B, P, K, cams,
                          C, G, st);
    case 4:
      return launch<T, 4>(lv, pts, wts, gout, g_pts, g_wts, B, P, K, cams,
                          C, G, st);
    case 8:
      return launch<T, 8>(lv, pts, wts, gout, g_pts, g_wts, B, P, K, cams,
                          C, G, st);
    default:
      return -1;
  }
}

}  // namespace

// feats / grads: `num_levels` pointers to [B, cams, H_l, W_l, C] (features
// fp32 when is_bf16 == 0, else bf16; gradients fp32, zeroed by the caller);
// pts [B, P*K, cams, 2] fp32; wts [B, P*K, cams, L, G] fp32; g_out [B, P, C]
// fp32. Outputs g_pts and g_wts (shapes of pts and wts, fp32, zeroed by the
// caller). Requires C in {32, 64, 128, 256}, C == 32 * VEC with
// (C / G) % VEC == 0 and (C / G) / VEC a power of two.
// Returns a cudaError_t, or -1 for an unsupported shape.
GF_EXPORT int gf_deformable_backward(const void* const* feats,
                                     void* const* grads, const int* heights,
                                     const int* widths, int num_levels,
                                     int is_bf16, const void* pts,
                                     const void* wts, const void* g_out,
                                     void* g_pts, void* g_wts, int B, int P,
                                     int K, int cams, int C, int G,
                                     void* stream) {
  if (num_levels < 1 || num_levels > MAX_LEVELS) return -1;
  const int vec = C / 32;
  if (vec < 1 || C % 32 != 0 || C % G != 0 || (C / G) % vec != 0)
    return -1;
  const int lpg = (C / G) / vec;
  if (lpg & (lpg - 1)) return -1;
  Levels lv;
  lv.n = num_levels;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    lv.ptr[l] = l < num_levels ? feats[l] : nullptr;
    lv.grad[l] = l < num_levels ? (float*)grads[l] : nullptr;
    lv.h[l] = l < num_levels ? heights[l] : 0;
    lv.w[l] = l < num_levels ? widths[l] : 0;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch<__nv_bfloat16>(lv, (const float*)pts, (const float*)wts,
                                   (const float*)g_out, (float*)g_pts,
                                   (float*)g_wts, B, P, K, cams, C, G, st);
  return dispatch<float>(lv, (const float*)pts, (const float*)wts,
                         (const float*)g_out, (float*)g_pts, (float*)g_wts,
                         B, P, K, cams, C, G, st);
}
