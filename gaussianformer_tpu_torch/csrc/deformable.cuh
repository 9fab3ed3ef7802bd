// What the deformable aggregation kernels share: K3 (deformable.cu), K6
// (deformable_bwd.cu) and K6's pixel bins (deformable_bin.cu).
//
// The sampling of ops/deformable.py (deformable.py:113-160): a (key point,
// camera) pair takes part only with (u, v) strictly inside (0, 1); on a
// level of h x w pixels it samples the bilinear corners of
// (u w - 0.5, v h - 0.5), and a corner outside the level contributes zero.
// Pairs are numbered ((b Q + q) cams + cam) with q = p K + k, so an
// anchor's K x cams pairs are consecutive; a sample is a (pair, level),
// numbered pair L + l.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace gf {
namespace deform {

constexpr int MAX_LEVELS = 4;

struct Levels {
  const void* ptr[MAX_LEVELS];   // features [B, cams, h, w, C]
  void* grad[MAX_LEVELS];        // K6: their gradients, in their dtype
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int n;
};

// a[l] for a level l known only at run time, without indexing the array
// at run time (which would copy it to local memory)
template <typename V>
__device__ __forceinline__ V pick(const V (&a)[MAX_LEVELS], int l) {
  V v = a[0];
#pragma unroll
  for (int i = 1; i < MAX_LEVELS; ++i)
    if (l == i) v = a[i];
  return v;
}

__device__ __forceinline__ bool inside(float u, float v) {
  return u > 0.f && u < 1.f && v > 0.f && v < 1.f;
}

// The bilinear corners of (u, v) on an h x w level, in the order (y0, x0),
// (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1): each corner's pixel y w + x
// clamped into the level (a valid address for any corner) and its weight,
// zero for a corner outside the level; and the fractional parts. The
// arithmetic is the plain version's, rounding step by step.
struct Corners {
  int pix[4];
  float cw[4];
  bool valid[4];
  float lh, lw;
};

__device__ __forceinline__ Corners corners(float u, float v, int h, int w) {
  const float w_im = __fsub_rn(__fmul_rn(u, (float)w), 0.5f);
  const float h_im = __fsub_rn(__fmul_rn(v, (float)h), 0.5f);
  const float h0f = floorf(h_im);
  const float w0f = floorf(w_im);
  Corners c;
  c.lh = h_im - h0f;
  c.lw = w_im - w0f;
  const int h0 = (int)h0f;
  const int w0 = (int)w0f;
  const float cw[4] = {(1.f - c.lh) * (1.f - c.lw), (1.f - c.lh) * c.lw,
                       c.lh * (1.f - c.lw), c.lh * c.lw};
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int hy = h0 + (n >> 1);
    const int wx = w0 + (n & 1);
    c.valid[n] = hy >= 0 && hy <= h - 1 && wx >= 0 && wx <= w - 1;
    c.pix[n] = min(max(hy, 0), h - 1) * w + min(max(wx, 0), w - 1);
    c.cw[n] = c.valid[n] ? cw[n] : 0.f;
  }
  return c;
}

// Corner n of (u, v) on an h x w level (the order of `corners`): whether it
// lies in the level, and then its pixel y w + x in *pix. The same
// arithmetic as `corners`.
__device__ __forceinline__ bool corner_pixel(float u, float v, int h, int w,
                                             int n, int* pix) {
  const float w_im = __fsub_rn(__fmul_rn(u, (float)w), 0.5f);
  const float h_im = __fsub_rn(__fmul_rn(v, (float)h), 0.5f);
  const int hy = (int)floorf(h_im) + (n >> 1);
  const int wx = (int)floorf(w_im) + (n & 1);
  *pix = hy * w + wx;
  return hy >= 0 && hy <= h - 1 && wx >= 0 && wx <= w - 1;
}

// The bilinear weight of corner n of (u, v) on an h x w level (inside the
// level or not), with the arithmetic of `corners`.
__device__ __forceinline__ float corner_weight(float u, float v, int h,
                                               int w, int n) {
  const float w_im = __fsub_rn(__fmul_rn(u, (float)w), 0.5f);
  const float h_im = __fsub_rn(__fmul_rn(v, (float)h), 0.5f);
  const float lh = h_im - floorf(h_im);
  const float lw = w_im - floorf(w_im);
  return ((n >> 1) ? lh : 1.f - lh) * ((n & 1) ? lw : 1.f - lw);
}

// VEC consecutive feature channels as loaded (bf16 kept packed until use,
// so a warp can hold many corners in flight in few registers).
template <typename T, int VEC>
struct Chunk;

template <int VEC>
struct Chunk<float, VEC> {
  float v[VEC];
  __device__ __forceinline__ void load(const float* p) { load_vec<VEC>(p, v); }
  __device__ __forceinline__ float get(int i) const { return v[i]; }
};

template <int VEC>
struct Chunk<__nv_bfloat16, VEC> {
  using Raw = std::conditional_t<
      VEC == 1, unsigned short,
      std::conditional_t<VEC == 2, unsigned,
                         std::conditional_t<VEC == 4, uint2, uint4>>>;
  Raw raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = *reinterpret_cast<const Raw*>(p);
  }
  __device__ __forceinline__ float get(int i) const {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&raw)[i]);
  }
};

// Levels of corners whose loads a warp issues together: all of a pair's
// 4 L corners where they fit in 64 registers a lane, else the largest
// divisor of L that fits.
template <typename T, int VEC, int L>
__host__ __device__ constexpr int levels_in_flight() {
  constexpr int regs = (int)((sizeof(T) * VEC + 3) / 4);
  int d = 64 / (4 * regs) < L ? 64 / (4 * regs) : L;
  while (d > 1 && L % d != 0) --d;
  return d < 1 ? 1 : d;
}

}  // namespace deform
}  // namespace gf
