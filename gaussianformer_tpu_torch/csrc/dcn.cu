// K1: modulated deformable convolution v2 (3x3, stride 1, pad 1), forward,
// with the optional frozen-BN + ReLU epilogue of the inference path.
//
// Replaces: gaussianformer_tpu/ops/pallas/dcn_kernel.py
//           deform_conv2d_pallas_fwd (kernel `_kernel`).
//
// Computes, per output pixel p and tap t (ky = t / 3, kx = t % 3):
//   s = p + (ky - 1, kx - 1) + offset[p, t]            (dy, dx per tap)
//   v[p, t, :] = mask[p, t] * bilinear(x, s)           (corners outside the
//                                                        image contribute 0)
//   out[p, :] = sum_t v[p, t, :] @ W[t]                 W: [3, 3, Cin, Cout]
//   out = relu(out * inv + shift)                       (when inv != null)
// exactly as ops/dcn.py::deform_conv2d does, for ANY offset: there is no
// sampling window here, unlike the TPU kernel.
//
// Bound on the H100: the contraction, 2 * B*H*W * 9*Cin * Cout flops
// (38.2 GFLOP for a flagship stage-3 or stage-4 block), is compute bound in
// bf16 (about 39 us at 989 TFLOP/s), while the bytes it must move are a few
// tens of MB (about 10 us at 3.35 TB/s).
//
// Design: a fused implicit GEMM. A block owns BM output pixels x BN output
// channels. For each tap it computes the four bilinear corner indices and
// mask-scaled weights of its pixels once, then for each BK-channel chunk
// samples the A tile straight from x (NHWC, 16-byte channel-contiguous
// loads) into shared memory, stages the matching weight tile, and runs
// bf16 tensor-core MMAs (nvcuda::wmma, fp32 accumulation). The epilogue
// applies inv/shift + ReLU in registers and writes bf16. The sampled tile
// never touches device memory, which is what keeps the op compute bound.
// The simple single-buffered loop leaves tensor cores idle while a tile is
// sampled; pipelining and wgmma are the next steps.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64;          // output pixels per block
constexpr int BN = 128;         // output channels per block
constexpr int BK = 64;          // input channels per K step
constexpr int THREADS = 256;    // 8 warps as 2 (M) x 4 (N), 32x32 each
constexpr int A_LD = BK + 8;    // bf16 row pitch of the A tile
constexpr int B_LD = BN + 8;    // bf16 row pitch of the B tile
constexpr int C_LD = BN + 4;    // fp32 row pitch of the output staging

struct MainTiles {
  __nv_bfloat16 a[BM * A_LD];
  __nv_bfloat16 b[BK * B_LD];
};
union Tiles {
  MainTiles m;
  float c[BM * C_LD];
};

__global__ void __launch_bounds__(THREADS)
dcn_fwd_kernel(const __nv_bfloat16* __restrict__ x,
               const float* __restrict__ offset, int off_stride,
               const float* __restrict__ mask, int mask_stride,
               const __nv_bfloat16* __restrict__ wt,
               const float* __restrict__ inv, const float* __restrict__ shift,
               __nv_bfloat16* __restrict__ out, int B, int H, int W, int Cin,
               int Cout) {
  __shared__ __align__(128) Tiles tile;
  __shared__ int s_idx[BM][4];
  __shared__ float s_w[BM][4];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int warp_m = warp / 4;
  const int warp_n = warp % 4;
  const long M = (long)B * H * W;
  const long m0 = (long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int tap = 0; tap < 9; ++tap) {
    __syncthreads();  // the previous tap's corner tables are no longer read
    if (tid < BM) {
      const long m = m0 + tid;
      int idx[4] = {-1, -1, -1, -1};
      float wc[4] = {0.f, 0.f, 0.f, 0.f};
      if (m < M) {
        const int xx = (int)(m % W);
        const long r = m / W;
        const int yy = (int)(r % H);
        const int b = (int)(r / H);
        const float dy = offset[m * off_stride + 2 * tap];
        const float dx = offset[m * off_stride + 2 * tap + 1];
        const float mk = mask[m * mask_stride + tap];
        const float sy = (float)(yy - 1 + tap / 3) + dy;
        const float sx = (float)(xx - 1 + tap % 3) + dx;
        const float y0f = floorf(sy);
        const float x0f = floorf(sx);
        const float ly = sy - y0f;
        const float lx = sx - x0f;
        const int y0 = (int)y0f;
        const int x0 = (int)x0f;
        const float cw[4] = {(1.f - ly) * (1.f - lx), (1.f - ly) * lx,
                             ly * (1.f - lx), ly * lx};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int cy = y0 + (c >> 1);
          const int cx = x0 + (c & 1);
          if (cy >= 0 && cy <= H - 1 && cx >= 0 && cx <= W - 1) {
            idx[c] = (b * H + cy) * W + cx;
            wc[c] = cw[c] * mk;
          }
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s_idx[tid][c] = idx[c];
        s_w[tid][c] = wc[c];
      }
    }
    __syncthreads();

    for (int c0 = 0; c0 < Cin; c0 += BK) {
      // A tile: bilinear, mask-scaled samples of BK channels per pixel.
      for (int t = tid; t < BM * (BK / 8); t += THREADS) {
        const int p = t / (BK / 8);
        const int g = t % (BK / 8);
        float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int id = s_idx[p][c];
          if (id >= 0) {
            float f[8];
            gf::load_vec<8>(x + (long)id * Cin + c0 + g * 8, f);
            const float w = s_w[p][c];
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] += w * f[e];
          }
        }
        __align__(16) __nv_bfloat162 packed[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          packed[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
        *reinterpret_cast<uint4*>(tile.m.a + p * A_LD + g * 8) =
            *reinterpret_cast<const uint4*>(packed);
      }
      // B tile: rows (tap, c0 .. c0+BK) of W, columns n0 .. n0+BN.
      for (int t = tid; t < BK * (BN / 8); t += THREADS) {
        const int k = t / (BN / 8);
        const int g = t % (BN / 8);
        const int col = n0 + g * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (col < Cout)
          val = *reinterpret_cast<const uint4*>(
              wt + (long)(tap * Cin + c0 + k) * Cout + col);
        *reinterpret_cast<uint4*>(tile.m.b + k * B_LD + g * 8) = val;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> af[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bf[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(
              af[i], tile.m.a + (warp_m * 32 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(
              bf[j], tile.m.b + kk * B_LD + warp_n * 32 + j * 16, B_LD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          tile.c + (warp_m * 32 + i * 16) * C_LD + warp_n * 32 + j * 16,
          acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();

  for (int t = tid; t < BM * (BN / 8); t += THREADS) {
    const int r = t / (BN / 8);
    const int g = t % (BN / 8);
    const long m = m0 + r;
    const int col = n0 + g * 8;
    if (m >= M || col >= Cout) continue;
    __align__(16) __nv_bfloat16 o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float v = tile.c[r * C_LD + g * 8 + e];
      if (inv != nullptr) v = fmaxf(v * inv[col + e] + shift[col + e], 0.f);
      o[e] = __float2bfloat16(v);
    }
    *reinterpret_cast<uint4*>(out + m * Cout + col) =
        *reinterpret_cast<const uint4*>(o);
  }
}

}  // namespace

// x [B, H, W, Cin] bf16; offset rows of `off_stride` floats per pixel (the
// first 18 are (dy, dx) per tap); mask rows of `mask_stride` floats (the
// first 9 are the sigmoided mask); weight [9 * Cin, Cout] bf16 (HWIO);
// inv/shift [Cout] fp32 or null; out [B, H, W, Cout] bf16.
// Requires Cin % 64 == 0 and Cout % 8 == 0.
GF_EXPORT int gf_dcn_forward(const void* x, const void* offset,
                             int off_stride, const void* mask,
                             int mask_stride, const void* weight,
                             const void* inv, const void* shift, void* out,
                             int B, int H, int W, int Cin, int Cout,
                             void* stream) {
  const long M = (long)B * H * W;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Cout + BN - 1) / BN));
  dcn_fwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const float*)offset, off_stride,
      (const float*)mask, mask_stride, (const __nv_bfloat16*)weight,
      (const float*)inv, (const float*)shift, (__nv_bfloat16*)out, B, H, W,
      Cin, Cout);
  return (int)cudaGetLastError();
}

GF_EXPORT const char* gf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
