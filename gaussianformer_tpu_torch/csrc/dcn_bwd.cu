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
// outside the image add nothing to the value or to any gradient.
//
// Bound on the H100: the two contractions, 2 x 2 * B*H*W * 9*Cin * Cout
// flops (2 x 38.2 GFLOP for a flagship stage-3 or stage-4 block), compute
// bound in bf16 (about 77 us at 989 TFLOP/s). The bytes (x, g_out, the fp32
// g_x written once) are tens of MB. What costs time is moving the 36
// corner shares of g_x per pixel and channel, and the corner gathers.
//
// Design: two launches, counted as one kernel; every MMA is a bf16
// mma.sync.m16n8k16 with fp32 sums, fed by ldmatrix from shared memory.
//  1. dcn_bwd_input_kernel (g_x, g_offset, g_mask). A block of 256 threads
//     owns an 8 x 8 tile of output pixels of one image, NC = 32 input
//     channels and all 9 taps. Its g_out tile [64, C_out] is copied into
//     shared memory once (cp.async) and serves every tap; W[t] streams
//     through a cp.async ring, the next slice in flight under the current
//     MMAs. Each tap's g_cols tile [64, 32] goes through shared memory to
//     two passes:
//     - pixel pass, a thread per (pixel, 8 channels): the tap's 4 corners,
//       the g_offset / g_mask dot products (x corners read from shared
//       memory), and for the corner k == its channel group, an entry (pixel,
//       m * cw) in that corner's window-cell bucket (slot from an int
//       shared atomic). A corner in the image but outside the window, or
//       past a full bucket (CAP entries), adds its shares to the global
//       g_x with atomicAdd right there: the exact fallback, with no
//       sampling window and no dropped corner. Corners outside the image
//       add nothing. The chunks of a pixel live in different blocks, so
//       g_offset and g_mask are zeroed by the wrapper and each (pixel, tap)
//       adds its chunk's sums with three atomics.
//     - owner pass: the g_x WINDOW is the tile plus HALO = 3 pixels on every
//       side, its first WCELLS = 192 cells in raster order (all but 4 of
//       the 14 x 14 square; it holds every corner of a sample whose offsets
//       lie in [-1, 1), and nearly all in [-2, 2)). Each thread owns 3
//       (cell, 8-channel) pairs, summed in registers over the 9 taps; it
//       adds its cells' bucket entries, so no window word has two writers
//       and no float atomics are needed. It runs in the next tap's first
//       slice, after that slice's MMAs are issued.
//     At the end each thread adds its window cells in the image to the
//     global g_x with float4 atomics (all-zero ones skipped): 3 cells per
//     pixel against 36 corner shares.
//     Shared memory (bytes), C_out <= 256: g_out 64 * 264 * 2 = 33,792; W a
//     whole tap a stage, two stages 2 * 32 * 264 * 2 = 33,792; g_cols
//     64 * 36 * 4 = 9,216; x under the window 192 * 32 * 2 = 12,288;
//     buckets 192 * 4 * 8 = 6,144 and counts 768: 96,000.
//     C_out <= 512: g_out 64 * 520 * 2 = 66,560; 128-channel W slices, two
//     stages 2 * 32 * 136 * 2 = 17,408; the rest as above: 112,384.
//     Either way two blocks (and 128 registers a thread) fit on an SM (at
//     most 115,712 bytes a block); C_out above 512 is refused. The loops
//     count slices and pixels instead of dividing by runtime values, and a
//     corner's bf16 is unpacked once whichever memory it came from: the
//     launch is bound by its instruction issue and the latency between its
//     phases, not by memory (gaussianformer_tpu_torch/ablate_dcn_bwd.py
//     times each phase).
//  2. dcn_bwd_weight_kernel (g_W = cols^T @ g_out, K = the B*H*W pixels).
//     A block owns one tap x 64 input channels x 256 output channels (all
//     of C_out up to 256, two halves at 512) x a split of the pixels, so a
//     sampled column is built once per pixel and output-channel half. Per
//     32-pixel step it double-buffers both tiles: the next g_out tile is in
//     flight through cp.async, and the next step's four corner vectors are
//     loaded into registers before the current MMAs (their offsets a step
//     earlier still) and blended into the other A buffer after them; one
//     barrier a step. The splits fill whole waves of two blocks per SM;
//     each thread adds its partial tile into the fp32 g_W with float2
//     atomics.
// Atomic sums run in a changing order, so g_x, g_offset, g_mask and g_W are
// not bitwise reproducible; all stay in fp32 (the wrapper casts g_x, g_W).
#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace gf;

// ---- 1. input gradients ---------------------------------------------------
constexpr int IN_THREADS = 256;
constexpr int TH = 8, TW = 8, TP = TH * TW;   // output pixels per tile
constexpr int NC = 32;                        // input channels per block
constexpr int HALO = 3;                       // window margin, pixels
constexpr int WH = TH + 2 * HALO, WW = TW + 2 * HALO;
// the window's cells, in raster order; the few cells of the square past
// WCELLS (its last row's end) take the fallback, so that every thread owns
// the same number of cells
constexpr int WCELLS =
    WH * WW * (NC / 8) / IN_THREADS * IN_THREADS / (NC / 8);
constexpr int CAP = 4;                        // entries per cell and tap
constexpr int GC_LD = NC + 4;                 // fp32 pitch of g_cols
constexpr int WIN_J = WCELLS * (NC / 8) / IN_THREADS;
static_assert(WIN_J * IN_THREADS == WCELLS * (NC / 8), "whole cells a thread");
constexpr int SMEM_MAX = 232448;
static_assert(TP * (NC / 8) == IN_THREADS, "one (pixel, 8 channels) a thread");

// W streams in slices of KS output channels through a ring of two stages
constexpr int STAGES = 2;
template <int KS>
__host__ __device__ constexpr int in_kpad(int cout) {
  return (cout + KS - 1) / KS * KS;
}
template <int KS>
__host__ __device__ constexpr int in_smem_bytes(int cout) {
  return TP * (in_kpad<KS>(cout) + 8) * 2 + STAGES * NC * (KS + 8) * 2 +
         TP * GC_LD * 4 + WCELLS * NC * 2 + WCELLS * CAP * 8 + WCELLS * 4;
}

template <int KS>
__global__ void __launch_bounds__(IN_THREADS, 2)
dcn_bwd_input_kernel(const __nv_bfloat16* __restrict__ x,
                     const float* __restrict__ offset, int off_stride,
                     const float* __restrict__ mask, int mask_stride,
                     const __nv_bfloat16* __restrict__ wt,
                     const __nv_bfloat16* __restrict__ gout,
                     float* __restrict__ gx, float* __restrict__ goff,
                     float* __restrict__ gmask, int B, int H, int W, int Cin,
                     int Cout) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int WS_LD = KS + 8;  // bf16 pitch of a W slice
  const int kpad = in_kpad<KS>(Cout);
  const int go_ld = kpad + 8;
  __nv_bfloat16* s_gout = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_w = s_gout + TP * go_ld;
  float* s_gc = reinterpret_cast<float*>(s_w + STAGES * NC * WS_LD);
  __nv_bfloat16* s_xwin = reinterpret_cast<__nv_bfloat16*>(s_gc +
                                                           TP * GC_LD);
  // the tap's in-window corner entries, bucketed by window cell: (pixel,
  // m * cw) pairs and their count
  float2* s_bkt = reinterpret_cast<float2*>(s_xwin + WCELLS * NC);
  int* s_cnt = reinterpret_cast<int*>(s_bkt + WCELLS * CAP);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  const int tx = blockIdx.x % tiles_x;
  const int ty = (blockIdx.x / tiles_x) % tiles_y;
  const int b = blockIdx.x / (tiles_x * tiles_y);
  const int y0 = ty * TH, x0 = tx * TW;          // tile origin
  const int wy0 = y0 - HALO, wx0 = x0 - HALO;    // window origin
  const int c0 = blockIdx.y * NC;

  // group 0: the g_out tile (zero past the image and C_out) and x under
  // the window (cells outside the image are never read)
  // (16 threads a pixel row, no divisions: kpad / 8 is a multiple of 16)
  for (int p = tid / 16; p < TP; p += IN_THREADS / 16) {
    const int yy = y0 + p / TW, xx = x0 + p % TW;
    const bool live = yy < H && xx < W;
    const long m = live ? ((long)b * H + yy) * W + xx : 0;
    for (int g = tid % 16; g < kpad / 8; g += 16) {
      const bool ok = live && g * 8 < Cout;
      cp_async16(s_gout + p * go_ld + g * 8,
                 gout + m * Cout + (ok ? g * 8 : 0), ok);
    }
  }
  for (int i = tid; i < WCELLS * (NC / 8); i += IN_THREADS) {
    const int cell = i / (NC / 8);
    const int g = i % (NC / 8);
    const int yy = wy0 + cell / WW, xx = wx0 + cell % WW;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W)
      cp_async16(s_xwin + cell * NC + g * 8,
                 x + (((long)b * H + yy) * W + xx) * Cin + c0 + g * 8, true);
  }
  cp_async_commit();
  for (int i = tid; i < WCELLS; i += IN_THREADS) s_cnt[i] = 0;

  // W slices: tap t's kt slices of KS output channels, in order. This
  // thread copies the 16 bytes at column w_col of rows w_r + W_RSTEP j;
  // the slices are counted, not divided out, here and in the main loop.
  const int kt = kpad / KS;
  constexpr int W_RSTEP = IN_THREADS / (KS / 8);
  static_assert(NC % W_RSTEP == 0, "whole rows of a W slice a pass");
  const int w_r = tid / (KS / 8), w_col = (tid % (KS / 8)) * 8;
  const __nv_bfloat16* w_src = wt + (long)(c0 + w_r) * Cout + w_col;
  const int w_dst = w_r * WS_LD + w_col;
  int i_tap = 0, i_k = 0, i_stage = 0;  // the next slice to copy
  auto issue = [&]() {
    if (i_tap < 9) {
      const bool ok = i_k * KS + w_col < Cout;
      const __nv_bfloat16* src = w_src + (long)i_tap * Cin * Cout + i_k * KS;
      __nv_bfloat16* dst = s_w + i_stage * NC * WS_LD + w_dst;
#pragma unroll
      for (int j = 0; j < NC / W_RSTEP; ++j)
        cp_async16(dst + j * W_RSTEP * WS_LD,
                   ok ? src + (long)j * W_RSTEP * Cout : wt, ok);
      if (++i_k == kt) {
        i_k = 0;
        ++i_tap;
      }
      if (++i_stage == STAGES) i_stage = 0;
    }
    cp_async_commit();  // an empty group past the last slice
  };
  for (int s = 0; s < STAGES - 1; ++s) issue();

  // the epilogue's item: pixel ep, channels c0 + eg * 8 .. + 8; the same
  // thread owns window cells (tid / 4 + 64 j, group eg), summed in win
  const int ep = tid / (NC / 8);
  const int eg = tid % (NC / 8);
  const int eyy = y0 + ep / TW, exx = x0 + ep % TW;
  const bool elive = eyy < H && exx < W;
  const long em = elive ? ((long)b * H + eyy) * W + exx : 0;
  float edy = 0.f, edx = 0.f, emk = 0.f;
  float win[WIN_J][8];
#pragma unroll
  for (int j = 0; j < WIN_J; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) win[j][e] = 0.f;

  // g_cols [64 pixels, 32 channels]: warp_m x 16 pixels, warp_n x 16
  // channels (two n8 tiles)
  const int warp_m = warp % 4;
  const int warp_n = warp / 4;
  const int lr = lane % 8, lm = lane / 8;  // ldmatrix row, matrix
  const __nv_bfloat16* a_row =
      s_gout + (warp_m * 16 + (lm % 2) * 8 + lr) * go_ld + (lm / 2) * 8;
  const int b_off = (warp_n * 16 + (lm / 2) * 8 + lr) * WS_LD + (lm % 2) * 8;
  // owner pass of a tap: each thread adds its cells' bucketed entries into
  // its registers (a window cell's 4 groups are 4 lanes of one warp), then
  // empties the buckets for the next tap. It reads g_cols and the buckets
  // of the tap before, under the first slice's MMAs of the next.
  auto owner_pass = [&]() {
    int n[WIN_J], nmax[WIN_J];  // entries of each owned cell; warp max
#pragma unroll
    for (int j = 0; j < WIN_J; ++j) {
      const int q = tid / (NC / 8) + j * (IN_THREADS / (NC / 8));
      n[j] = min(s_cnt[q], CAP);
      nmax[j] = __reduce_max_sync(0xffffffffu, n[j]);
    }
    // entry e of every owned cell at once: WIN_J independent chains
#pragma unroll
    for (int e = 0; e < CAP; ++e) {
#pragma unroll
      for (int j = 0; j < WIN_J; ++j) {
        if (e >= nmax[j]) continue;  // uniform over the warp
        if (e >= n[j]) continue;
        const int q = tid / (NC / 8) + j * (IN_THREADS / (NC / 8));
        const float2 en = s_bkt[q * CAP + e];
        const float* g = s_gc + __float_as_int(en.x) * GC_LD + eg * 8;
        const float4 u = *reinterpret_cast<const float4*>(g);
        const float4 v = *reinterpret_cast<const float4*>(g + 4);
        win[j][0] += en.y * u.x; win[j][1] += en.y * u.y;
        win[j][2] += en.y * u.z; win[j][3] += en.y * u.w;
        win[j][4] += en.y * v.x; win[j][5] += en.y * v.y;
        win[j][6] += en.y * v.z; win[j][7] += en.y * v.w;
      }
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < WIN_J; ++j) {
      const int q = tid / (NC / 8) + j * (IN_THREADS / (NC / 8));
      if (eg == 0) s_cnt[q] = 0;
    }
  };

  float acc[2][2][4] = {};  // [k-step parity][n8 tile]
  int tap = 0, kq = 0, stage = 0;  // the slice summed now
  for (int s = 0; s < 9 * kt; ++s) {
    cp_async_wait<0>();  // slice s (and group 0) have landed
    __syncthreads();  // ... for every thread; slice s - 1 is done with, so
    issue();          // its stage takes slice s + STAGES - 1
    if (kq == 0 && elive) {
      // this tap's (dy, dx, m) of the epilogue's pixel, in flight under
      // the tap's MMAs
      edy = offset[em * off_stride + 2 * tap];
      edx = offset[em * off_stride + 2 * tap + 1];
      emk = mask[em * mask_stride + tap];
    }
    const __nv_bfloat16* sw = s_w + stage * NC * WS_LD + b_off;
    const int k0 = kq * KS;
    if (++stage == STAGES) stage = 0;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 16) {
      unsigned af[4], bf[4];
      ldsm_x4(af, a_row + k0 + kk);
      // B = W[tap]^T, stored [channel][output channel]
      ldsm_x4(bf, sw + kk);
      float (&c)[2][4] = acc[(kk / 16) % 2];
      mma_bf16(c[0], af, bf[0], bf[1]);
      mma_bf16(c[1], af, bf[2], bf[3]);
    }
    const bool owner = tap > 0 && kq == 0;
    if (owner) owner_pass();
    if (++kq < kt) continue;
    kq = 0;

    // the tap is summed: g_cols to shared memory, once the owner pass
    // before is done with it
    if (kt == 1 && owner) __syncthreads();
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      float* c = s_gc + (warp_m * 16 + lane / 4) * GC_LD + warp_n * 16 +
                 t * 8 + 2 * (lane % 4);
      *reinterpret_cast<float2*>(c) = make_float2(
          acc[0][t][0] + acc[1][t][0], acc[0][t][1] + acc[1][t][1]);
      *reinterpret_cast<float2*>(c + 8 * GC_LD) = make_float2(
          acc[0][t][2] + acc[1][t][2], acc[0][t][3] + acc[1][t][3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][t][e] = acc[1][t][e] = 0.f;
    }
    __syncthreads();

    // pixel pass: the corners of (ep, tap) and the g_offset / g_mask dot
    // products over 8 channels; corner k's entry goes into its cell's
    // bucket by the thread eg == k, and a corner outside the window (or
    // whose bucket is full) adds its shares to the global g_x here
    {
      const float sy = (float)(eyy - 1 + tap / 3) + edy;
      const float sx = (float)(exx - 1 + tap % 3) + edx;
      const float fy = floorf(sy);
      const float fx = floorf(sx);
      const float ly = sy - fy;
      const float lx = sx - fx;
      const int cy0 = (int)fy, cx0 = (int)fx;
      const float w4[4] = {(1.f - ly) * (1.f - lx), (1.f - ly) * lx,
                           ly * (1.f - lx), ly * lx};
      const float y4[4] = {-(1.f - lx), -lx, 1.f - lx, lx};
      const float x4[4] = {-(1.f - ly), 1.f - ly, -ly, ly};
      float gc[8];
      {
        const float4 u = *reinterpret_cast<const float4*>(
            s_gc + ep * GC_LD + eg * 8);
        const float4 v = *reinterpret_cast<const float4*>(
            s_gc + ep * GC_LD + eg * 8 + 4);
        gc[0] = u.x; gc[1] = u.y; gc[2] = u.z; gc[3] = u.w;
        gc[4] = v.x; gc[5] = v.y; gc[6] = v.z; gc[7] = v.w;
      }
      int cell[4];  // window cell; -1 outside the image; -2 fallback
      int cid[4];   // the corner's pixel index
      int my_cell = -1, my_id = 0;
      float my_w = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int cy = cy0 + (k >> 1), cx = cx0 + (k & 1);
        const int wy = cy - wy0, wxx = cx - wx0;
        cid[k] = (b * H + cy) * W + cx;
        cell[k] = -1;
        if (elive && cy >= 0 && cy <= H - 1 && cx >= 0 && cx <= W - 1)
          cell[k] = wy >= 0 && wy < WH && wxx >= 0 && wxx < WW &&
                            wy * WW + wxx < WCELLS
                        ? wy * WW + wxx
                        : -2;
        if (k == eg) {
          my_cell = cell[k];
          my_w = emk * w4[k];
          my_id = cid[k];
        }
      }
      // this thread's corner takes a bucket slot (its latency hides under
      // the dot products)
      const int slot = my_cell >= 0 ? atomicAdd(s_cnt + my_cell, 1) : 0;
      float pm = 0.f, py = 0.f, px = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (cell[k] == -1) continue;
        // the corner's 8 channels from the window (else from x), unpacked
        // once after the load, not once for each source
        const uint4 raw =
            cell[k] >= 0
                ? *reinterpret_cast<const uint4*>(s_xwin + cell[k] * NC +
                                                  eg * 8)
                : *reinterpret_cast<const uint4*>(x + (long)cid[k] * Cin +
                                                  c0 + eg * 8);
        const __nv_bfloat162* h =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h[e]);
          dot += gc[2 * e] * f.x;
          dot += gc[2 * e + 1] * f.y;
        }
        pm += w4[k] * dot;
        py += y4[k] * dot;
        px += x4[k] * dot;
      }
      if (my_cell >= 0) {
        if (slot < CAP) {
          s_bkt[my_cell * CAP + slot] =
              make_float2(__int_as_float(ep), my_w);
        } else {  // a full bucket: this thread adds all NC channels
          for (int e = 0; e < NC; e += 4) {
            const float4 u = *reinterpret_cast<const float4*>(
                s_gc + ep * GC_LD + e);
            const float share[4] = {my_w * u.x, my_w * u.y, my_w * u.z,
                                    my_w * u.w};
            gf::atomic_add_vec<4>(gx + (long)my_id * Cin + c0 + e, share);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (cell[k] == -2) {  // the exact fallback
          float share[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) share[e] = emk * w4[k] * gc[e];
          gf::atomic_add_vec<8>(gx + (long)cid[k] * Cin + c0 + eg * 8,
                                share);
        }
      }
#pragma unroll
      for (int sh = 1; sh < NC / 8; sh <<= 1) {
        pm += __shfl_xor_sync(0xffffffffu, pm, sh);
        py += __shfl_xor_sync(0xffffffffu, py, sh);
        px += __shfl_xor_sync(0xffffffffu, px, sh);
      }
      if (elive && eg == 0) {
        atomicAdd(goff + em * 18 + 2 * tap, emk * py);
        atomicAdd(goff + em * 18 + 2 * tap + 1, emk * px);
        atomicAdd(gmask + em * 9 + tap, pm);
      }
    }
    ++tap;
  }
  __syncthreads();
  owner_pass();
  // the window into the global g_x, once per cell in the image
#pragma unroll
  for (int j = 0; j < WIN_J; ++j) {
    const int q = tid / (NC / 8) + j * (IN_THREADS / (NC / 8));
    const int yy = wy0 + q / WW, xx = wx0 + q % WW;
    if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
    bool any = false;
#pragma unroll
    for (int e = 0; e < 8; ++e) any |= win[j][e] != 0.f;
    if (any)
      gf::atomic_add_vec<8>(
          gx + (((long)b * H + yy) * W + xx) * Cin + c0 + eg * 8, win[j]);
  }
}

// ---- 2. weight gradient ---------------------------------------------------
constexpr int THREADS = 256;
constexpr int WM = 64;           // rows (tap, input channel) per block
constexpr int WN = 256;          // output channels per block
constexpr int WK = 32;           // pixels per K step
constexpr int WA_LD = WM + 8;    // bf16 pitch of the sampled tile [p][c]
constexpr int WB_LD = WN + 8;    // bf16 pitch of the g_out tile [p][o]
constexpr int W_SMEM = 2 * WK * WA_LD * 2 + 2 * WK * WB_LD * 2;  // 43,008
constexpr int W_WAVES = 3;       // least waves of the weight-gradient grid

__global__ void __launch_bounds__(THREADS, 2)
dcn_bwd_weight_kernel(const __nv_bfloat16* __restrict__ x,
                      const float* __restrict__ offset, int off_stride,
                      const float* __restrict__ mask, int mask_stride,
                      const __nv_bfloat16* __restrict__ gout,
                      float* __restrict__ gw, int B, int H, int W, int Cin,
                      int Cout, int pix_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* s_a = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_b = s_a + 2 * WK * WA_LD;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp / 4;     // 2 x 32 rows
  const int warp_n = warp % 4;     // 4 x 64 columns
  const int M = B * H * W;
  const int chunks = Cin / WM;
  const int tap = blockIdx.x / chunks;
  const int c0 = (blockIdx.x % chunks) * WM;
  const int n0 = blockIdx.y * WN;
  const int p_begin = blockIdx.z * pix_per_split;
  const int p_end = p_begin + pix_per_split < M ? p_begin + pix_per_split : M;
  const int nsteps = (p_end - p_begin + WK - 1) / WK;

  // B: g_out rows of step k, columns n0..n0+WN (zero past the split and
  // C_out): this thread copies 16 bytes of rows bp + 8 j, j < 4
  constexpr int B_ROWS = THREADS / (WN / 8);
  const int bp = tid / (WN / 8);
  const int bo = n0 + (tid % (WN / 8)) * 8;
  const __nv_bfloat16* b_src = gout + (long)(p_begin + bp) * Cout + bo;
  const int b_dst = bp * WB_LD + (tid % (WN / 8)) * 8;
  auto issue_b = [&](int k, int buf) {
#pragma unroll
    for (int j = 0; j < WK / B_ROWS; ++j) {
      const int m = p_begin + k * WK + bp + j * B_ROWS;
      const bool ok = m < p_end && bo < Cout;
      cp_async16(s_b + buf * WK * WB_LD + b_dst + j * B_ROWS * WB_LD,
                 ok ? b_src + ((long)k * WK + j * B_ROWS) * Cout : gout, ok);
    }
    cp_async_commit();
  };
  // A^T: this thread's entry of the sampled tile, pixel sp of the step, 8
  // channels sg. The offsets of step k + 1 are loaded during step k - 1,
  // so that the corner gathers of step k + 1 go out before the MMAs of
  // step k.
  const int sp = tid / (WM / 8);
  const int sg = tid % (WM / 8);
  Pixel pa;   // this thread's pixel of the step whose corners load next
  pa.m = p_begin + sp;
  pa.x = pa.m % W;
  pa.y = (pa.m / W) % H;
  pa.b = pa.m / (W * H);
  Pixel po = pa;  // ... and of the step whose offsets load next
  Sample smp;
  float raw[3];
  auto load_offsets = [&]() {
    raw[0] = raw[1] = raw[2] = 0.f;
    if (po.m < p_end) {
      raw[0] = offset[(long)po.m * off_stride + 2 * tap];
      raw[1] = offset[(long)po.m * off_stride + 2 * tap + 1];
      raw[2] = mask[(long)po.m * mask_stride + tap];
    }
    po.advance(WK, H, W);
  };
  auto load_a = [&]() {
    sample_load(smp, tap, pa, pa.m < p_end, raw, H, W, Cin, c0 + sg * 8, x);
    pa.advance(WK, H, W);
  };

  // ldmatrix addresses: A(m = c, k = p) at a[p][c] and B(k = p, n = o) at
  // b[p][o], both loaded transposed
  const int lr = lane % 8, lm = lane / 8;
  const int a_off = ((lm / 2) * 8 + lr) * WA_LD + warp_m * 32 + (lm % 2) * 8;
  const int b_off = ((lm % 2) * 8 + lr) * WB_LD + warp_n * 64 + (lm / 2) * 8;
  float acc[2][8][4] = {};

  issue_b(0, 0);
  load_offsets();
  load_a();
  load_offsets();
  sample_store(smp, s_a + sp * WA_LD + sg * 8);
  for (int k = 0; k < nsteps; ++k) {
    cp_async_wait<0>();  // step k's g_out tile has landed
    __syncthreads();     // ... and its A tile; step k - 1's MMAs are done
    const int buf = k & 1;
    const bool more = k + 1 < nsteps;
    if (more) {
      issue_b(k + 1, buf ^ 1);
      load_a();          // in flight under the MMAs below
      load_offsets();
    }
    const __nv_bfloat16* a = s_a + buf * WK * WA_LD + a_off;
    const __nv_bfloat16* bt = s_b + buf * WK * WB_LD + b_off;
#pragma unroll
    for (int kk = 0; kk < WK; kk += 16) {
      unsigned af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4_t(af[i], a + kk * WA_LD + i * 16);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        unsigned bf[4];
        ldsm_x4_t(bf, bt + kk * WB_LD + j * 16);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * j], af[i], bf[0], bf[1]);
          mma_bf16(acc[i][2 * j + 1], af[i], bf[2], bf[3]);
        }
      }
    }
    if (more)
      sample_store(smp, s_a + (buf ^ 1) * WK * WA_LD + sp * WA_LD + sg * 8);
  }

  // the partial tile into g_W, two floats an atomic
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + warp_n * 64 + j * 8 + 2 * (lane % 4);
      if (col >= Cout) continue;
      const long row = tap * Cin + c0 + warp_m * 32 + i * 16 + lane / 4;
      gf::atomic_add_vec<2>(gw + row * Cout + col, acc[i][j]);
      gf::atomic_add_vec<2>(gw + (row + 8) * Cout + col, acc[i][j] + 2);
    }
}

template <int KS>
cudaError_t launch_input(dim3 grid, cudaStream_t st, const void* x,
                         const void* offset, int off_stride, const void* mask,
                         int mask_stride, const void* weight,
                         const void* g_out, void* g_x, void* g_offset,
                         void* g_mask, int B, int H, int W, int Cin,
                         int Cout) {
  const auto kernel = dcn_bwd_input_kernel<KS>;
  const int smem = in_smem_bytes<KS>(Cout);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<grid, IN_THREADS, smem, st>>>(
      (const __nv_bfloat16*)x, (const float*)offset, off_stride,
      (const float*)mask, mask_stride, (const __nv_bfloat16*)weight,
      (const __nv_bfloat16*)g_out, (float*)g_x, (float*)g_offset,
      (float*)g_mask, B, H, W, Cin, Cout);
  return cudaGetLastError();
}

}  // namespace

// x [B, H, W, Cin] bf16; offset / mask as for gf_dcn_forward (pixel rows of
// off_stride / mask_stride floats); weight [9 * Cin, Cout] bf16; g_out
// [B, H, W, Cout] bf16. Outputs, all fp32 and zeroed by the caller (atomic
// sums): g_x [B, H, W, Cin], g_offset [B, H, W, 18], g_mask [B, H, W, 9],
// g_w [9 * Cin, Cout]. Requires Cin % 64 == 0, Cout % 8 == 0, Cout <= 512.
// `parts` selects the launches: 1 the input gradients, 2 the weight
// gradient (gf_dcn_backward runs both; one alone serves to time it).
GF_EXPORT int gf_dcn_backward_parts(const void* x, const void* offset,
                                    int off_stride, const void* mask,
                                    int mask_stride, const void* weight,
                                    const void* g_out, void* g_x,
                                    void* g_offset, void* g_mask, void* g_w,
                                    int B, int H, int W, int Cin, int Cout,
                                    int parts, void* stream) {
  if (Cin % 64 != 0 || Cout % 8 != 0 || Cout > 512) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  const long M = (long)B * H * W;
  if (M == 0) return 0;
  if (M > (1L << 30)) return -1;  // 32-bit pixel indices
  cudaError_t err;
  const long tiles = (long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  dim3 grid_in((unsigned)tiles, (unsigned)(Cin / NC));
  // W slices of a whole tap up to C_out 256, of 128 channels up to 512:
  // either way two blocks fit on an SM
  if (!(parts & 1))
    err = cudaSuccess;
  else if (Cout <= 256)
    err = launch_input<256>(grid_in, st, x, offset, off_stride, mask,
                            mask_stride, weight, g_out, g_x, g_offset,
                            g_mask, B, H, W, Cin, Cout);
  else
    err = launch_input<128>(grid_in, st, x, offset, off_stride, mask,
                            mask_stride, weight, g_out, g_x, g_offset,
                            g_mask, B, H, W, Cin, Cout);
  if (err != cudaSuccess) return (int)err;
  if (!(parts & 2)) return 0;

  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // split the pixels into whole waves of two blocks per SM: of W_WAVES to
  // 2 W_WAVES waves, the count whose last wave is fullest
  const long base = 9L * (Cin / WM) * ((Cout + WN - 1) / WN);
  const long steps = (M + WK - 1) / WK;
  const long slots = 2L * sms;
  long splits = 1;
  double best = -1.0;
  for (long waves = W_WAVES; waves <= 2 * W_WAVES; ++waves) {
    const long sp = waves * slots / base;
    if (sp < 1) continue;
    const double fill = (double)(sp * base) / (double)(waves * slots);
    if (fill > best + 1e-9) {
      best = fill;
      splits = sp;
    }
  }
  splits = splits > steps ? steps : splits;
  const long per_split = ((steps + splits - 1) / splits) * WK;
  dim3 grid_w((unsigned)(9 * (Cin / WM)), (unsigned)((Cout + WN - 1) / WN),
              (unsigned)((M + per_split - 1) / per_split));
  dcn_bwd_weight_kernel<<<grid_w, THREADS, W_SMEM, st>>>(
      (const __nv_bfloat16*)x, (const float*)offset, off_stride,
      (const float*)mask, mask_stride, (const __nv_bfloat16*)g_out,
      (float*)g_w, B, H, W, Cin, Cout, (int)per_split);
  return (int)cudaGetLastError();
}

GF_EXPORT int gf_dcn_backward(const void* x, const void* offset,
                              int off_stride, const void* mask,
                              int mask_stride, const void* weight,
                              const void* g_out, void* g_x, void* g_offset,
                              void* g_mask, void* g_w, int B, int H, int W,
                              int Cin, int Cout, void* stream) {
  return gf_dcn_backward_parts(x, offset, off_stride, mask, mask_stride,
                               weight, g_out, g_x, g_offset, g_mask, g_w, B,
                               H, W, Cin, Cout, 3, stream);
}
