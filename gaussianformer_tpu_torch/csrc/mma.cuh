// Tensor-core and sampling helpers shared by the DCNv2 kernels: K1
// (dcn.cu, the forward) and K5 (dcn_bwd.cu, the backward).
//
// - cp.async copies of 16 bytes into shared memory, ldmatrix loads and the
//   bf16 mma.sync.m16n8k16 with fp32 sums (on sm_90a, nvcuda::wmma loads
//   compile to generic LD + MOVM rather than ldmatrix, so the kernels issue
//   these instructions themselves);
// - the bilinear corners of one (pixel, tap) sample and the load and blend
//   of 8 channels of it, so that the forward and the backward build the
//   same sampled column: corner weight x mask, corners summed 0..3 in fp32,
//   one round-to-nearest to bf16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gf {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16-byte cp.async, zero-filled when !full (src must still be a valid
// address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8 (.trans: each matrix transposed).
__device__ __forceinline__ void ldsm_x4(unsigned r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 in, fp32 sums. Lane l holds
// c[l / 4][2 (l % 4) + {0, 1}] in c[0..1] and the same of row l / 4 + 8 in
// c[2..3].
__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A pixel's index and image coordinates, stepped forward without
// divisions.
struct Pixel {
  int m, b, y, x;
  __device__ __forceinline__ void advance(int n, int H, int W) {
    m += n;
    x += n;
    while (x >= W) {
      x -= W;
      if (++y == H) {
        y = 0;
        ++b;
      }
    }
  }
};

// The four bilinear corners of one (pixel, tap) sample: corner k is
// (y0 + (k >> 1), x0 + (k & 1)), at element i00 + ((k >> 1) W + (k & 1)) Cin
// of x; its weight is m * cw_k, and bit k of `in` says it lies in the image
// (a corner outside contributes 0 and is never read).
struct Corners {
  long i00;
  float w[4];
  unsigned in;
};

// r = (dy, dx, m) of the pixel and tap
__device__ __forceinline__ Corners corners_of(int tap, const Pixel& px,
                                              bool live, const float r[3],
                                              int H, int W, int Cin) {
  Corners c;
  c.i00 = 0;
  c.in = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) c.w[k] = 0.f;
  if (!live) return c;
  const float sy = (float)(px.y - 1 + tap / 3) + r[0];
  const float sx = (float)(px.x - 1 + tap % 3) + r[1];
  const float fy = floorf(sy);
  const float fx = floorf(sx);
  const float ly = sy - fy;
  const float lx = sx - fx;
  const int cy0 = (int)fy, cx0 = (int)fx;
  const float w4[4] = {(1.f - ly) * (1.f - lx), (1.f - ly) * lx,
                       ly * (1.f - lx), ly * lx};
  c.i00 = ((long)(px.b * H + cy0) * W + cx0) * Cin;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int cy = cy0 + (k >> 1), cx = cx0 + (k & 1);
    if (cy >= 0 && cy <= H - 1 && cx >= 0 && cx <= W - 1) {
      c.in |= 1u << k;
      c.w[k] = w4[k] * r[2];
    }
  }
  return c;
}

// The four corner vectors (8 channels each) of one sampled column entry,
// loaded ahead of the MMAs, and their weights m * cw (0 where invalid).
struct Sample {
  uint4 raw[4];
  float w[4];
};

// channels ch .. ch + 8 of the corners c
__device__ __forceinline__ void sample_corners(
    Sample& s, const Corners& c, int W, int Cin, int ch,
    const __nv_bfloat16* __restrict__ x) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    s.w[k] = c.w[k];
    s.raw[k] = make_uint4(0u, 0u, 0u, 0u);
    if (c.in >> k & 1u)
      s.raw[k] = *reinterpret_cast<const uint4*>(
          x + c.i00 + ch + ((k >> 1) * W + (k & 1)) * Cin);
  }
}

// the corners of (px, tap) and their channels c .. c + 8: the arithmetic
// of corners_of, with each load issued as its corner is tested (K5's
// weight launch, which samples a new pixel each step, was slower as
// corners_of followed by sample_corners)
__device__ __forceinline__ void sample_load(
    Sample& s, int tap, const Pixel& px, bool live, const float r[3], int H,
    int W, int Cin, int c, const __nv_bfloat16* __restrict__ x) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    s.raw[k] = make_uint4(0u, 0u, 0u, 0u);
    s.w[k] = 0.f;
  }
  if (!live) return;
  const float sy = (float)(px.y - 1 + tap / 3) + r[0];
  const float sx = (float)(px.x - 1 + tap % 3) + r[1];
  const float fy = floorf(sy);
  const float fx = floorf(sx);
  const float ly = sy - fy;
  const float lx = sx - fx;
  const int cy0 = (int)fy, cx0 = (int)fx;
  const float w4[4] = {(1.f - ly) * (1.f - lx), (1.f - ly) * lx,
                       ly * (1.f - lx), ly * lx};
  const long i00 = ((long)(px.b * H + cy0) * W + cx0) * Cin + c;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int cy = cy0 + (k >> 1), cx = cx0 + (k & 1);
    if (cy >= 0 && cy <= H - 1 && cx >= 0 && cx <= W - 1) {
      s.raw[k] = *reinterpret_cast<const uint4*>(
          x + i00 + ((k >> 1) * W + (k & 1)) * Cin);
      s.w[k] = w4[k] * r[2];
    }
  }
}

// v = sum_k w_k x_k over the 8 channels, rounded to bf16 into dst
__device__ __forceinline__ void sample_store(const Sample& s,
                                             __nv_bfloat16* dst) {
  float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162* h =
        reinterpret_cast<const __nv_bfloat162*>(&s.raw[k]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      v[2 * e] += s.w[k] * f.x;
      v[2 * e + 1] += s.w[k] * f.y;
    }
  }
  __align__(16) __nv_bfloat162 packed[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    packed[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(packed);
}

}  // namespace gf
