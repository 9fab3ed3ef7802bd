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
// about 60 MB of bf16 and the inputs another 10 MB, and the gather re-reads
// corners from L2. Flops are negligible.
//
// Design: a direct gather, like the reference's
// deformable_aggregation_cuda.cu. One warp owns one anchor; each lane owns
// VEC contiguous channels (one vector load per corner, a warp reads a whole
// contiguous channel row). The warp walks key points, cameras and levels,
// skipping (key point, camera) pairs outside the image with a warp-uniform
// branch, and accumulates in fp32 registers, so the key-point sum is fused
// and no atomics or intermediate tensors are needed. Unlike the TPU kernel
// it needs no x-sort, no sampling windows and no spill clean-up.
#include "common.cuh"

namespace {

constexpr int MAX_LEVELS = 4;
constexpr int WARPS = 8;

struct Levels {
  const void* ptr[MAX_LEVELS];
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int n;
};

template <typename T, int VEC>
__global__ void __launch_bounds__(WARPS * 32)
deformable_kernel(Levels lv, const float* __restrict__ pts,
                  const float* __restrict__ wts, float* __restrict__ out,
                  int B, int P, int K, int cams, int C, int G) {
  const int warp = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (warp >= B * P) return;
  const int b = warp / P;
  const int p = warp % P;
  const int c0 = lane * VEC;
  const int g = c0 / (C / G);
  const int L = lv.n;
  const long Q = (long)P * K;

  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;

  for (int k = 0; k < K; ++k) {
    const long q = (long)b * Q + (long)p * K + k;
    for (int cam = 0; cam < cams; ++cam) {
      const float u = pts[(q * cams + cam) * 2];
      const float v = pts[(q * cams + cam) * 2 + 1];
      if (!(u > 0.f && u < 1.f && v > 0.f && v < 1.f)) continue;
      const float* wrow = wts + ((q * cams + cam) * L) * G;
      for (int l = 0; l < L; ++l) {
        const int hl = lv.h[l];
        const int wl = lv.w[l];
        const float wgt = wrow[l * G + g];
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
        const T* base = static_cast<const T*>(lv.ptr[l]) +
                        (long)(b * cams + cam) * hl * wl * C;
#pragma unroll
        for (int cn = 0; cn < 4; ++cn) {
          const int hy = h0 + (cn >> 1);
          const int wx = w0 + (cn & 1);
          if (hy < 0 || hy > hl - 1 || wx < 0 || wx > wl - 1) continue;
          const float cwt = cw[cn] * wgt;
          float f[VEC];
          gf::load_vec<VEC>(base + ((long)hy * wl + wx) * C + c0, f);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] += f[e] * cwt;
        }
      }
    }
  }
  float* o = out + ((long)b * P + p) * C + c0;
#pragma unroll
  for (int e = 0; e < VEC; ++e) o[e] = acc[e];
}

template <typename T, int VEC>
int launch(const Levels& lv, const float* pts, const float* wts, float* out,
           int B, int P, int K, int cams, int C, int G, cudaStream_t st) {
  const int warps = B * P;
  const int blocks = (warps + WARPS - 1) / WARPS;
  deformable_kernel<T, VEC><<<blocks, WARPS * 32, 0, st>>>(
      lv, pts, wts, out, B, P, K, cams, C, G);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Levels& lv, const float* pts, const float* wts,
             float* out, int B, int P, int K, int cams, int C, int G,
             cudaStream_t st) {
  switch (C / 32) {
    case 1: return launch<T, 1>(lv, pts, wts, out, B, P, K, cams, C, G, st);
    case 2: return launch<T, 2>(lv, pts, wts, out, B, P, K, cams, C, G, st);
    case 4: return launch<T, 4>(lv, pts, wts, out, B, P, K, cams, C, G, st);
    case 8: return launch<T, 8>(lv, pts, wts, out, B, P, K, cams, C, G, st);
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
  if (num_levels < 1 || num_levels > MAX_LEVELS) return -1;
  Levels lv;
  lv.n = num_levels;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    lv.ptr[l] = l < num_levels ? feats[l] : nullptr;
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
