// K5: modulated deformable convolution v2 (3x3, stride 1, pad 1), backward.
//
// Replaces: gaussianformer_tpu/ops/pallas/dcn_kernel.py
//           deform_conv2d_pallas_bwd (kernel `_bwd_kernel`), the VJP of
//           deform_conv2d_pallas_fwd.
//
// With the forward of dcn.cu (K1), for output pixel p, tap t and channel c
//   v[p, t, c] = m[p, t] * sum_k cw_k(ly, lx) x[corner_k, c]  (valid corners)
//   out[p, :]  = sum_t v[p, t, :] @ W[t]
// the gradients are, with gc[p, t, :] = g_out[p, :] @ W[t]^T:
//   g_x[corner_k, c] += m cw_k gc[p, t, c]
//   g_mask[p, t]      = sum_c gc[p, t, c] sum_k cw_k x[corner_k, c]
//   g_dy[p, t]        = m sum_c gc[p, t, c] sum_k dcw_k/dly x[corner_k, c]
//   g_dx[p, t]        = m sum_c gc[p, t, c] sum_k dcw_k/dlx x[corner_k, c]
//   g_W[t, c, :]      = sum_p v[p, t, c] g_out[p, :]
// exactly as autodiff of ops/dcn.py::deform_conv2d, for ANY offset: corners
// outside the image add nothing to the value or to any gradient. The TPU
// kernel drops corners outside its sampling window; this one has none.
//
// Bound on the H100: the two contractions, 2 x 2 * B*H*W * 9*Cin * Cout
// flops (2 x 38.2 GFLOP for a flagship stage-3 or stage-4 block), compute
// bound in bf16 (about 77 us at 989 TFLOP/s). The bytes (x, g_out, the fp32
// g_x written once) are tens of MB.
//
// Design: two launches, counted as one kernel.
//  1. dcn_bwd_input_kernel: a block owns IM output pixels of one tap. For
//     each IN-channel chunk of C_in it computes the g_cols tile
//     g_out[IM, Cout] @ W[t]^T with bf16 tensor-core MMAs (nvcuda::wmma,
//     fp32 accumulation), then in its epilogue scatters each corner's
//     mask-weighted bilinear share into the fp32 g_x with vector atomicAdd
//     (two float4 atomics per 8 channels) and reduces the g_offset /
//     g_mask dot products over the chunk's channels (8-lane shuffles, then
//     one shared-memory slot per pixel). Every (pixel, tap) belongs to one
//     block, so g_offset and g_mask are plain stores. The scatter adds 36
//     corner shares of C_in floats per pixel through L2 atomics, far more
//     traffic than the bound counts; gathering per input pixel instead
//     would remove it, at the cost of inverting the sampling map.
//  2. dcn_bwd_weight_kernel: g_W = cols^T @ g_out, a GEMM whose K dimension
//     is the B*H*W pixels. A block owns 64 rows (tap, channel) x 128 output
//     channels and a split of the pixels; it rebuilds the sampled columns
//     as K1's A-tile loader does, straight from x into shared memory, runs
//     the same MMAs, and adds its partial tile into the fp32 g_W with
//     atomicAdd (the split keeps about 1000 blocks in flight).
// Atomic sums run in a changing order, so g_x and g_W are not bitwise
// reproducible; both stay in fp32 until the wrapper casts them.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int THREADS = 256;

// ---- 1. input gradients ---------------------------------------------------
constexpr int IM = 64;           // output pixels per block
constexpr int IN = 64;           // input channels per chunk
constexpr int IK = 32;           // output channels per K step
constexpr int IA_LD = IK + 8;    // bf16 pitch of the g_out tile
constexpr int IB_LD = IK + 8;    // bf16 pitch of the W^T tile (col-major B)
constexpr int IC_LD = IN + 4;    // fp32 pitch of the g_cols tile

__device__ __forceinline__ void corner_tables(
    int tap, long m, long M, int H, int W, const float* offset,
    int off_stride, const float* mask, int mask_stride, int idx[4],
    float cw[4], float dly[4], float dlx[4], float* mk_out) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    idx[c] = -1;
    cw[c] = dly[c] = dlx[c] = 0.f;
  }
  *mk_out = 0.f;
  if (m >= M) return;
  const int xx = (int)(m % W);
  const long r = m / W;
  const int yy = (int)(r % H);
  const int b = (int)(r / H);
  const float dy = offset[m * off_stride + 2 * tap];
  const float dx = offset[m * off_stride + 2 * tap + 1];
  *mk_out = mask[m * mask_stride + tap];
  const float sy = (float)(yy - 1 + tap / 3) + dy;
  const float sx = (float)(xx - 1 + tap % 3) + dx;
  const float y0f = floorf(sy);
  const float x0f = floorf(sx);
  const float ly = sy - y0f;
  const float lx = sx - x0f;
  const int y0 = (int)y0f;
  const int x0 = (int)x0f;
  const float w4[4] = {(1.f - ly) * (1.f - lx), (1.f - ly) * lx,
                       ly * (1.f - lx), ly * lx};
  const float y4[4] = {-(1.f - lx), -lx, 1.f - lx, lx};
  const float x4[4] = {-(1.f - ly), 1.f - ly, -ly, ly};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int cy = y0 + (c >> 1);
    const int cx = x0 + (c & 1);
    if (cy >= 0 && cy <= H - 1 && cx >= 0 && cx <= W - 1) {
      idx[c] = (b * H + cy) * W + cx;
      cw[c] = w4[c];
      dly[c] = y4[c];
      dlx[c] = x4[c];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
dcn_bwd_input_kernel(const __nv_bfloat16* __restrict__ x,
                     const float* __restrict__ offset, int off_stride,
                     const float* __restrict__ mask, int mask_stride,
                     const __nv_bfloat16* __restrict__ wt,
                     const __nv_bfloat16* __restrict__ gout,
                     float* __restrict__ gx, float* __restrict__ goff,
                     float* __restrict__ gmask, int B, int H, int W, int Cin,
                     int Cout) {
  __shared__ __align__(128) __nv_bfloat16 s_a[IM * IA_LD];
  __shared__ __align__(128) __nv_bfloat16 s_b[IN * IB_LD];
  __shared__ __align__(128) float s_c[IM * IC_LD];
  __shared__ int s_idx[IM][4];
  __shared__ float s_cw[IM][4], s_dly[IM][4], s_dlx[IM][4];
  __shared__ float s_m[IM], s_gm[IM], s_gy[IM], s_gx[IM];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int warp_m = warp / 2;     // 4 x 16 rows
  const int warp_n = warp % 2;     // 2 x 32 columns
  const long M = (long)B * H * W;
  const long m0 = (long)blockIdx.x * IM;
  const int tap = blockIdx.y;

  if (tid < IM) {
    int idx[4];
    float cw[4], dly[4], dlx[4], mk;
    corner_tables(tap, m0 + tid, M, H, W, offset, off_stride, mask,
                  mask_stride, idx, cw, dly, dlx, &mk);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s_idx[tid][c] = idx[c];
      s_cw[tid][c] = cw[c];
      s_dly[tid][c] = dly[c];
      s_dlx[tid][c] = dlx[c];
    }
    s_m[tid] = mk;
    s_gm[tid] = s_gy[tid] = s_gx[tid] = 0.f;
  }

  for (int c0 = 0; c0 < Cin; c0 += IN) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.0f);
    wmma::fill_fragment(acc[1], 0.0f);
    for (int k0 = 0; k0 < Cout; k0 += IK) {
      __syncthreads();  // the previous tiles are no longer read
      {
        // A: g_out rows m0.., columns k0..k0+IK (one 16-byte load each)
        const int p = tid / (IK / 8);
        const int g = tid % (IK / 8);
        const long m = m0 + p;
        const int o = k0 + g * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (m < M && o < Cout)
          val = *reinterpret_cast<const uint4*>(gout + m * Cout + o);
        *reinterpret_cast<uint4*>(s_a + p * IA_LD + g * 8) = val;
      }
      {
        // B = W[tap]^T: element (k = o, n = c) stored at c * IB_LD + o
        const int c = tid / (IK / 8);
        const int g = tid % (IK / 8);
        const int o = k0 + g * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (o < Cout)
          val = *reinterpret_cast<const uint4*>(
              wt + (long)(tap * Cin + c0 + c) * Cout + o);
        *reinterpret_cast<uint4*>(s_b + c * IB_LD + g * 8) = val;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < IK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> af;
        wmma::load_matrix_sync(af, s_a + (warp_m * 16) * IA_LD + kk, IA_LD);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> bf;
          wmma::load_matrix_sync(
              bf, s_b + (warp_n * 32 + j * 16) * IB_LD + kk, IB_LD);
          wmma::mma_sync(acc[j], af, bf, acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          s_c + (warp_m * 16) * IC_LD + warp_n * 32 + j * 16, acc[j], IC_LD,
          wmma::mem_row_major);
    __syncthreads();

    // epilogue: 64 pixels x 8 groups of 8 channels, two items a thread;
    // the 8 groups of a pixel are 8 consecutive lanes of one warp
    for (int it = 0; it < 2; ++it) {
      const int t = tid + it * THREADS;
      const int p = t / (IN / 8);
      const int g = t % (IN / 8);
      const bool live = m0 + p < M;
      const int cbase = c0 + g * 8;
      float gc[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) gc[e] = s_c[p * IC_LD + g * 8 + e];
      const float mk = s_m[p];
      float pm = 0.f, py = 0.f, px = 0.f;
      if (live) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int id = s_idx[p][k];
          if (id < 0) continue;
          float f[8];
          gf::load_vec<8>(x + (long)id * Cin + cbase, f);
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) dot += gc[e] * f[e];
          pm += s_cw[p][k] * dot;
          py += s_dly[p][k] * dot;
          px += s_dlx[p][k] * dot;
          const float wk = mk * s_cw[p][k];
          float share[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) share[e] = wk * gc[e];
          gf::atomic_add_vec<8>(gx + (long)id * Cin + cbase, share);
        }
      }
#pragma unroll
      for (int s = 4; s >= 1; s >>= 1) {
        pm += __shfl_xor_sync(0xffffffffu, pm, s);
        py += __shfl_xor_sync(0xffffffffu, py, s);
        px += __shfl_xor_sync(0xffffffffu, px, s);
      }
      if (g == 0) {
        s_gm[p] += pm;
        s_gy[p] += mk * py;
        s_gx[p] += mk * px;
      }
    }
  }
  __syncthreads();
  if (tid < IM && m0 + tid < M) {
    const long m = m0 + tid;
    goff[m * 18 + 2 * tap] = s_gy[tid];
    goff[m * 18 + 2 * tap + 1] = s_gx[tid];
    gmask[m * 9 + tap] = s_gm[tid];
  }
}

// ---- 2. weight gradient ---------------------------------------------------
constexpr int WM = 64;           // rows (tap, input channel) per block
constexpr int WN = 128;          // output channels per block
constexpr int WK = 64;           // pixels per K step
constexpr int WA_LD = WM + 8;    // bf16 pitch of the sampled tile [p][c]
constexpr int WB_LD = WN + 8;    // bf16 pitch of the g_out tile [p][o]
constexpr int WC_LD = WN + 4;    // fp32 pitch of the output staging
constexpr int WSTEPS = 32;       // K steps per block before splitting

struct WeightTiles {
  __nv_bfloat16 a[WK * WA_LD];
  __nv_bfloat16 b[WK * WB_LD];
};
union WeightSmem {
  WeightTiles t;
  float c[WM * WC_LD];
};

__global__ void __launch_bounds__(THREADS)
dcn_bwd_weight_kernel(const __nv_bfloat16* __restrict__ x,
                      const float* __restrict__ offset, int off_stride,
                      const float* __restrict__ mask, int mask_stride,
                      const __nv_bfloat16* __restrict__ gout,
                      float* __restrict__ gw, int B, int H, int W, int Cin,
                      int Cout, long pix_per_split) {
  __shared__ __align__(128) WeightSmem sm;
  __shared__ int s_idx[WK][4];
  __shared__ float s_w[WK][4];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int warp_m = warp / 4;     // 2 x 32 rows
  const int warp_n = warp % 4;     // 4 x 32 columns
  const long M = (long)B * H * W;
  const int chunks = Cin / WM;
  const int tap = blockIdx.x / chunks;
  const int c0 = (blockIdx.x % chunks) * WM;
  const int n0 = blockIdx.y * WN;
  const long p_begin = (long)blockIdx.z * pix_per_split;
  const long p_end =
      p_begin + pix_per_split < M ? p_begin + pix_per_split : M;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (long k0 = p_begin; k0 < p_end; k0 += WK) {
    __syncthreads();  // the previous tiles and tables are no longer read
    if (tid < WK) {
      int idx[4];
      float cw[4], dly[4], dlx[4], mk;
      corner_tables(tap, k0 + tid < p_end ? k0 + tid : M, M, H, W, offset,
                    off_stride, mask, mask_stride, idx, cw, dly, dlx, &mk);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s_idx[tid][c] = idx[c];
        s_w[tid][c] = cw[c] * mk;
      }
    }
    // B: g_out rows k0.., columns n0..n0+WN (zero past the split / Cout)
    for (int t = tid; t < WK * (WN / 8); t += THREADS) {
      const int p = t / (WN / 8);
      const int g = t % (WN / 8);
      const long m = k0 + p;
      const int o = n0 + g * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m < p_end && o < Cout)
        val = *reinterpret_cast<const uint4*>(gout + m * Cout + o);
      *reinterpret_cast<uint4*>(sm.t.b + p * WB_LD + g * 8) = val;
    }
    __syncthreads();
    // A^T: the sampled columns v[p, tap, c0..c0+WM], stored [p][c]
    for (int t = tid; t < WK * (WM / 8); t += THREADS) {
      const int p = t / (WM / 8);
      const int g = t % (WM / 8);
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
      *reinterpret_cast<uint4*>(sm.t.a + p * WA_LD + g * 8) =
          *reinterpret_cast<const uint4*>(packed);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < WK; kk += 16) {
      // A(m = c, k = p) at a[p * WA_LD + c]: column-major
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(
            af[i], sm.t.a + kk * WA_LD + warp_m * 32 + i * 16, WA_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(
            bf[j], sm.t.b + kk * WB_LD + warp_n * 32 + j * 16, WB_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          sm.c + (warp_m * 32 + i * 16) * WC_LD + warp_n * 32 + j * 16,
          acc[i][j], WC_LD, wmma::mem_row_major);
  __syncthreads();
  for (int t = tid; t < WM * WN; t += THREADS) {
    const int r = t / WN;
    const int col = n0 + t % WN;
    if (col < Cout)
      atomicAdd(gw + (long)(tap * Cin + c0 + r) * Cout + col,
                sm.c[r * WC_LD + t % WN]);
  }
}

}  // namespace

// x [B, H, W, Cin] bf16; offset / mask as for gf_dcn_forward (pixel rows of
// off_stride / mask_stride floats); weight [9 * Cin, Cout] bf16; g_out
// [B, H, W, Cout] bf16. Outputs: g_x [B, H, W, Cin] fp32 and g_w
// [9 * Cin, Cout] fp32, both zeroed by the caller (atomic sums); g_offset
// [B, H, W, 18] and g_mask [B, H, W, 9] fp32, fully written.
// Requires Cin % 64 == 0 and Cout % 8 == 0.
GF_EXPORT int gf_dcn_backward(const void* x, const void* offset,
                              int off_stride, const void* mask,
                              int mask_stride, const void* weight,
                              const void* g_out, void* g_x, void* g_offset,
                              void* g_mask, void* g_w, int B, int H, int W,
                              int Cin, int Cout, void* stream) {
  if (Cin % 64 != 0 || Cout % 8 != 0) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  const long M = (long)B * H * W;
  dim3 grid_in((unsigned)((M + IM - 1) / IM), 9);
  dcn_bwd_input_kernel<<<grid_in, THREADS, 0, st>>>(
      (const __nv_bfloat16*)x, (const float*)offset, off_stride,
      (const float*)mask, mask_stride, (const __nv_bfloat16*)weight,
      (const __nv_bfloat16*)g_out, (float*)g_x, (float*)g_offset,
      (float*)g_mask, B, H, W, Cin, Cout);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long steps = (M + WK - 1) / WK;
  const long splits = (steps + WSTEPS - 1) / WSTEPS;
  const long per_split = ((steps + splits - 1) / splits) * WK;
  dim3 grid_w((unsigned)(9 * (Cin / WM)), (unsigned)((Cout + WN - 1) / WN),
              (unsigned)((M + per_split - 1) / per_split));
  dcn_bwd_weight_kernel<<<grid_w, THREADS, 0, st>>>(
      (const __nv_bfloat16*)x, (const float*)offset, off_stride,
      (const float*)mask, mask_stride, (const __nv_bfloat16*)g_out,
      (float*)g_w, B, H, W, Cin, Cout, per_split);
  return (int)cudaGetLastError();
}
