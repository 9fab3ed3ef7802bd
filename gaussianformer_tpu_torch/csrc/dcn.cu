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
// Design: a fused implicit GEMM on bf16 mma.sync.m16n8k16 (fp32 sums) fed
// by ldmatrix (helpers in mma.cuh, shared with K5). A block of 256 threads
// owns BM = 64 output pixels x BN = 256 output channels: all of C_out up
// to 256, so each (pixel, tap, channel) sample is made once a call (C_out
// 512 takes two column blocks). The K loop walks the 9 taps, each in
// BK = 32-channel steps:
//  - W streams through a cp.async ring of STAGES slices [32 x 256], the
//    next two in flight under the current MMAs;
//  - each thread samples one (pixel, 8 channels) entry of the A tile per
//    step. It computes its pixel's corners once a tap (the tap's offsets
//    are loaded a tap ahead) and loads the next step's four corner vectors
//    into registers before the current step's MMAs, blending them into the
//    other A buffer after them, so the gather latency hides under the
//    tensor cores (K5's weight launch does the same);
//  - one __syncthreads a step.
// The epilogue applies inv/shift + ReLU to the fp32 sums in registers,
// rounds to bf16 once, and stages the tile through shared memory for
// 16-byte stores. Two blocks fit on an SM (128 registers a thread, 61 KB of
// shared memory each).
#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace gf;

constexpr int BM = 64;          // output pixels per block
constexpr int BN = 256;         // output channels per block
constexpr int BK = 32;          // input channels per K step
constexpr int THREADS = 256;    // 8 warps as 2 (M) x 4 (N), 32 x 64 each
constexpr int STAGES = 3;       // W slices in the ring
constexpr int A_LD = BK + 8;    // bf16 row pitch of the A tile
constexpr int W_LD = BN + 8;    // bf16 row pitch of a W slice
constexpr int C_LD = BN + 8;    // bf16 row pitch of the output staging
constexpr int SMEM_W = STAGES * BK * W_LD * 2;
constexpr int SMEM_A = 2 * BM * A_LD * 2;
constexpr int SMEM = SMEM_W + SMEM_A;  // 60,928 bytes
static_assert(BM * C_LD * 2 <= SMEM, "the output staging fits the ring");
static_assert(BM * (BK / 8) == THREADS, "one A entry a thread a step");

__global__ void __launch_bounds__(THREADS, 2)
dcn_fwd_kernel(const __nv_bfloat16* __restrict__ x,
               const float* __restrict__ offset, int off_stride,
               const float* __restrict__ mask, int mask_stride,
               const __nv_bfloat16* __restrict__ wt,
               const float* __restrict__ inv, const float* __restrict__ shift,
               __nv_bfloat16* __restrict__ out, int B, int H, int W, int Cin,
               int Cout) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_a = s_w + STAGES * BK * W_LD;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp / 4;
  const int warp_n = warp % 4;
  const int M = B * H * W;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int kc = Cin / BK;      // K steps a tap
  const int nk = 9 * kc;        // K step s reads rows s * BK .. of W

  // W slices: this thread copies the 16 bytes at column w_col of rows
  // w_r + W_RSTEP j (zero past C_out)
  constexpr int W_RSTEP = THREADS / (BN / 8);
  const int w_r = tid / (BN / 8), w_col = (tid % (BN / 8)) * 8;
  const bool w_ok = n0 + w_col < Cout;
  const __nv_bfloat16* w_src = wt + (long)w_r * Cout + n0 + w_col;
  int i_slice = 0, i_stage = 0;  // the next slice to copy
  auto issue = [&]() {
    if (i_slice < nk) {
      const __nv_bfloat16* src = w_src + (long)i_slice * BK * Cout;
      __nv_bfloat16* dst = s_w + i_stage * BK * W_LD + w_r * W_LD + w_col;
#pragma unroll
      for (int j = 0; j < BK / W_RSTEP; ++j)
        cp_async16(dst + j * W_RSTEP * W_LD,
                   w_ok ? src + (long)j * W_RSTEP * Cout : wt, w_ok);
      ++i_slice;
      if (++i_stage == STAGES) i_stage = 0;
    }
    cp_async_commit();  // an empty group past the last slice
  };
  for (int s = 0; s < STAGES - 1; ++s) issue();

  // this thread's A entry: pixel sp of the block, channels sg * 8 .. + 8 of
  // the step's chunk
  const int sp = tid / (BK / 8);
  const int sg = tid % (BK / 8);
  Pixel px;
  px.m = m0 + sp;
  px.x = px.m % W;
  px.y = (px.m / W) % H;
  px.b = px.m / (W * H);
  const bool live = px.m < M;
  float raw[3];  // (dy, dx, m) of the tap whose corners are computed next
  auto load_raw = [&](int tap) {
    raw[0] = raw[1] = raw[2] = 0.f;
    if (live) {
      raw[0] = offset[(long)px.m * off_stride + 2 * tap];
      raw[1] = offset[(long)px.m * off_stride + 2 * tap + 1];
      raw[2] = mask[(long)px.m * mask_stride + tap];
    }
  };
  Corners cor;
  Sample smp;
  int a_tap = 0, a_chunk = 0;  // the step whose corners load next
  auto load_a = [&]() {
    if (a_chunk == 0) {
      cor = corners_of(a_tap, px, live, raw, H, W, Cin);
      if (a_tap < 8) load_raw(a_tap + 1);  // a tap ahead
    }
    sample_corners(smp, cor, W, Cin, a_chunk * BK + sg * 8, x);
    if (++a_chunk == kc) {
      a_chunk = 0;
      ++a_tap;
    }
  };

  // ldmatrix addresses: A(m = pixel, k = channel) at a[p][c], B(k, n) at
  // w[k][n], the latter loaded transposed
  const int lr = lane % 8, lm = lane / 8;
  const int a_off = (warp_m * 32 + (lm % 2) * 8 + lr) * A_LD + (lm / 2) * 8;
  const int b_off = ((lm % 2) * 8 + lr) * W_LD + warp_n * 64 + (lm / 2) * 8;
  // a warp whose 64 columns lie past C_out has no MMAs to run
  const bool warp_live = n0 + warp_n * 64 < Cout;
  float acc[2][8][4] = {};

  load_raw(0);
  load_a();
  sample_store(smp, s_a + sp * A_LD + sg * 8);
  int stage = 0;
  for (int k = 0; k < nk; ++k) {
    cp_async_wait<STAGES - 2>();  // slice k has landed
    __syncthreads();  // ... for every thread, as has A tile k; step k - 1's
    issue();          // MMAs are done, so its stage takes slice k + 2
    const bool more = k + 1 < nk;
    if (more) load_a();  // in flight under the MMAs below
    const __nv_bfloat16* a = s_a + (k & 1) * BM * A_LD + a_off;
    const __nv_bfloat16* bt = s_w + stage * BK * W_LD + b_off;
    if (++stage == STAGES) stage = 0;
    if (warp_live) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        unsigned af[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) ldsm_x4(af[i], a + i * 16 * A_LD + kk);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          unsigned bf[4];
          ldsm_x4_t(bf, bt + kk * W_LD + j * 16);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma_bf16(acc[i][2 * j], af[i], bf[0], bf[1]);
            mma_bf16(acc[i][2 * j + 1], af[i], bf[2], bf[3]);
          }
        }
      }
    }
    if (more)
      sample_store(smp, s_a + ((k + 1) & 1) * BM * A_LD + sp * A_LD + sg * 8);
  }

  // epilogue: BN + ReLU in registers, one rounding to bf16, staged through
  // shared memory (the ring is empty and every MMA is done)
  cp_async_wait<0>();
  __syncthreads();
  __nv_bfloat16* s_c = reinterpret_cast<__nv_bfloat16*>(smem);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = warp_n * 64 + j * 8 + 2 * (lane % 4);
    float sc[2] = {1.f, 1.f}, sh[2] = {0.f, 0.f};
    if (inv != nullptr && n0 + col < Cout) {
      sc[0] = inv[n0 + col];
      sc[1] = inv[n0 + col + 1];
      sh[0] = shift[n0 + col];
      sh[1] = shift[n0 + col + 1];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = acc[i][j][e];
        if (inv != nullptr) v[e] = fmaxf(v[e] * sc[e % 2] + sh[e % 2], 0.f);
      }
      const int row = warp_m * 32 + i * 16 + lane / 4;
      *reinterpret_cast<__nv_bfloat162*>(s_c + row * C_LD + col) =
          __floats2bfloat162_rn(v[0], v[1]);
      *reinterpret_cast<__nv_bfloat162*>(s_c + (row + 8) * C_LD + col) =
          __floats2bfloat162_rn(v[2], v[3]);
    }
  }
  __syncthreads();
  for (int t = tid; t < BM * (BN / 8); t += THREADS) {
    const int r = t / (BN / 8);
    const int g = t % (BN / 8);
    const int m = m0 + r;
    const int col = n0 + g * 8;
    if (m >= M || col >= Cout) continue;
    *reinterpret_cast<uint4*>(out + (long)m * Cout + col) =
        *reinterpret_cast<const uint4*>(s_c + r * C_LD + g * 8);
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
  if (Cin % 64 != 0 || Cout % 8 != 0) return -1;
  const long M = (long)B * H * W;
  if (M == 0) return 0;
  if (M > (1L << 30)) return -1;  // 32-bit pixel indices
  // (no carveout preference: what shared memory leaves of the SM's 256 KB
  // is L1, which serves the corner gathers of neighbouring pixels)
  const cudaError_t err = cudaFuncSetAttribute(
      dcn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Cout + BN - 1) / BN));
  dcn_fwd_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const float*)offset, off_stride,
      (const float*)mask, mask_stride, (const __nv_bfloat16*)weight,
      (const float*)inv, (const float*)shift, (__nv_bfloat16*)out, B, H, W,
      Cin, Cout);
  return (int)cudaGetLastError();
}

GF_EXPORT const char* gf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
