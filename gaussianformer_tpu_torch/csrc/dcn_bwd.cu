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
// Design: launches counted as one kernel; every MMA is a bf16
// mma.sync.m16n8k16 with fp32 sums, fed by ldmatrix from shared memory.
// No float atomics: every sum runs in a fixed order, so a call gives the
// same bits every time, for any offset.
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
//       m * cw) in that corner's window-cell bucket. Its slot is its rank
//       among the block's entries of the cell in thread order: its rank in
//       its warp (__match_any_sync) plus the earlier warps' counts, which
//       each warp's leader for the cell ORs into the cell's word as a
//       nibble (an int shared atomic; an OR of disjoint nibbles does not
//       depend on the order). A corner in the image but outside the
//       window, or past a full bucket (CAP entries), is a fallback record
//       (target pixel, m * cw) at its source key (p 9 + t) 4 + k, written
//       by the chunk-0 blocks; the (pixel, tap)'s g_cols row goes to the
//       gc workspace. Corners outside the image add nothing. Each (pixel,
//       tap)'s g_offset / g_mask sums over the block's channels go to the
//       chunk's rows of a workspace.
//     - owner pass: the g_x WINDOW is the tile plus HALO = 3 pixels on every
//       side, its first WCELLS = 192 cells in raster order (all but 4 of
//       the 14 x 14 square; it holds every corner of a sample whose offsets
//       lie in [-1, 1), and nearly all in [-2, 2)). Each thread owns 3
//       (cell, 8-channel) pairs, summed in registers over the 9 taps; it
//       adds its cells' bucket entries in slot order, so no window word
//       has two writers. It runs in the next tap's first slice, after that
//       slice's MMAs are issued.
//     At the end each thread writes its window cells in the image to the
//     block's window in the workspace.
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
//     each block writes its partial tile to its split's g_W in the
//     workspace.
//  3. dcn_bwd_om_kernel: each g_offset / g_mask value, the chunks' rows
//     summed in chunk order.
//  4. the fallback bins: the records sorted by target pixel with K6's
//     stable radix sort (bin_sort.cuh), so each pixel's list is in
//     source-key order, sized by the bound (36 records a pixel) with no
//     host read; each pixel's first entry (dcn_bwd_start_kernel).
//  5. dcn_bwd_gx_kernel, a thread per (pixel, 8 channels): the cells of
//     the (at most 4) windows that hold the pixel, in tile order, then its
//     fallback list in order, each entry m * cw times its gc row.
//  6. dcn_bwd_wsum_kernel: g_W, the splits summed in split order.
// Every output is written once, in fp32 (the wrapper casts g_x and g_W).
// At the flagship's stage 3 the workspace holds the windows (107 MB), the
// gc rows (299 MB, written only where a corner falls back), the chunks'
// g_offset / g_mask rows (28 MB), the records and their bins (36 words a
// pixel each) and the splits' g_W (104 MB).
#include "bin_sort.cuh"
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
constexpr int RECORDS = 36;                   // fallback records a pixel
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

// The sum of the eight 4-bit counts of a cell's word (each at most 8).
__device__ __forceinline__ int nibble_sum(unsigned v) {
  v = (v & 0x0F0F0F0Fu) + ((v >> 4) & 0x0F0F0F0Fu);
  return (int)((v * 0x01010101u) >> 24);
}

// The input launch's outputs, in the workspace: the windows [tiles][WCELLS]
// [C_in], each chunk's g_offset / g_mask rows [C_in / NC][M][27], the
// fallback records (target pixel or -1, weight) [M * 36], and the gc rows
// [M * 9][C_in] of the (pixel, tap)s with a fallback corner.
struct InputWork {
  float* win;
  float* om;
  int* rec_target;
  float* rec_weight;
  float* gc;
};

template <int KS>
__global__ void __launch_bounds__(IN_THREADS, 2)
dcn_bwd_input_kernel(const __nv_bfloat16* __restrict__ x,
                     const float* __restrict__ offset, int off_stride,
                     const float* __restrict__ mask, int mask_stride,
                     const __nv_bfloat16* __restrict__ wt,
                     const __nv_bfloat16* __restrict__ gout, InputWork work,
                     int B, int H, int W, int Cin, int Cout) {
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
  // m * cw) pairs, and each warp's count of them as a nibble of the cell's
  // word
  float2* s_bkt = reinterpret_cast<float2*>(s_xwin + WCELLS * NC);
  unsigned* s_cnt = reinterpret_cast<unsigned*>(s_bkt + WCELLS * CAP);

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
  const long M = (long)B * H * W;

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
  for (int i = tid; i < WCELLS; i += IN_THREADS) s_cnt[i] = 0u;

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
  // its registers in slot order (a window cell's 4 groups are 4 lanes of
  // one warp), then empties the buckets for the next tap. It reads g_cols
  // and the buckets of the tap before, under the first slice's MMAs of the
  // next.
  auto owner_pass = [&]() {
    int n[WIN_J], nmax[WIN_J];  // entries of each owned cell; warp max
#pragma unroll
    for (int j = 0; j < WIN_J; ++j) {
      const int q = tid / (NC / 8) + j * (IN_THREADS / (NC / 8));
      n[j] = min(nibble_sum(s_cnt[q]), CAP);
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
      if (eg == 0) s_cnt[q] = 0u;
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
    // bucket by the thread eg == k, or, outside the window or past a full
    // bucket, becomes a fallback record
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
      // this thread's corner's rank among its warp's lanes with its cell,
      // and the warp's count in the cell's word (its latency hides under
      // the dot products): a warp holds 8 pixels, each with at most one
      // corner in a cell
      const unsigned peers = __match_any_sync(0xffffffffu, my_cell);
      const int rank = __popc(peers & ((1u << lane) - 1u));
      if (my_cell >= 0 && rank == 0)
        atomicOr(s_cnt + my_cell, (unsigned)__popc(peers) << (4 * warp));
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
      __syncthreads();  // every warp's count is in its cells' words
      // the slot: the rank in the warp plus the earlier warps' counts
      bool fallback = my_cell == -2;
      if (my_cell >= 0) {
        const int slot =
            rank + nibble_sum(s_cnt[my_cell] & ((1u << (4 * warp)) - 1u));
        if (slot < CAP)
          s_bkt[my_cell * CAP + slot] =
              make_float2(__int_as_float(ep), my_w);
        else
          fallback = true;
      }
      if (blockIdx.y == 0 && elive) {
        const long src = (em * 9 + tap) * 4 + eg;  // the source key
        work.rec_target[src] = fallback ? my_id : -1;
        work.rec_weight[src] = my_w;
      }
      // the (pixel, tap)'s g_cols row, where any of its corners falls back
      int any = fallback;
      any |= __shfl_xor_sync(0xffffffffu, any, 1);
      any |= __shfl_xor_sync(0xffffffffu, any, 2);
      if (any && elive)
        store_vec<8>(work.gc + (em * 9 + tap) * Cin + c0 + eg * 8, gc);
#pragma unroll
      for (int sh = 1; sh < NC / 8; sh <<= 1) {
        pm += __shfl_xor_sync(0xffffffffu, pm, sh);
        py += __shfl_xor_sync(0xffffffffu, py, sh);
        px += __shfl_xor_sync(0xffffffffu, px, sh);
      }
      if (elive && eg == 0) {
        float* o = work.om + ((long)blockIdx.y * M + em) * 27 + tap * 3;
        o[0] = emk * py;
        o[1] = emk * px;
        o[2] = pm;
      }
    }
    ++tap;
  }
  __syncthreads();
  owner_pass();
  // the window's cells in the image into the block's window of the
  // workspace (the g_x launch sums each pixel's windows)
#pragma unroll
  for (int j = 0; j < WIN_J; ++j) {
    const int q = tid / (NC / 8) + j * (IN_THREADS / (NC / 8));
    const int yy = wy0 + q / WW, xx = wx0 + q % WW;
    if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
    store_vec<8>(
        work.win + ((long)blockIdx.x * WCELLS + q) * Cin + c0 + eg * 8,
        win[j]);
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
                      float* __restrict__ wsum, int B, int H, int W, int Cin,
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

  // the partial tile into its split's g_W
  float* part = wsum + (long)blockIdx.z * 9 * Cin * Cout;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + warp_n * 64 + j * 8 + 2 * (lane % 4);
      if (col >= Cout) continue;
      const long row = tap * Cin + c0 + warp_m * 32 + i * 16 + lane / 4;
      *reinterpret_cast<float2*>(part + row * Cout + col) =
          make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(part + (row + 8) * Cout + col) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
}

// ---- 3. g_offset and g_mask -----------------------------------------------
// A thread per (pixel, tap, value): the chunks' rows summed in chunk order.
__global__ void __launch_bounds__(256)
dcn_bwd_om_kernel(const float* __restrict__ om, int chunks, long M,
                  float* __restrict__ goff, float* __restrict__ gmask) {
  const long i = (long)blockIdx.x * 256 + threadIdx.x;
  if (i >= M * 27) return;
  float s = om[i];
  for (int ch = 1; ch < chunks; ++ch) s += om[ch * M * 27 + i];
  const long m = i / 27;
  const int r = (int)(i - m * 27), tap = r / 3;
  if (r % 3 < 2)
    goff[m * 18 + 2 * tap + r % 3] = s;
  else
    gmask[m * 9 + tap] = s;
}

// ---- 4. the fallback bins -------------------------------------------------
constexpr int SORT_ITEMS = 8;     // items a lane loads at once
constexpr int SORT_MAX_BITS = 10;
constexpr int SORT_MAX_BLOCKS = 1024;
constexpr int SORT_ITEMS_PER_BLOCK = 4096;

// The items of a sort pass: the records 0..n in order (vals null) or the
// records vals[0..n), each keyed by its target pixel (valid when >= 0).
struct RecordItems {
  const int* target;
  const int* vals;

  template <class F>
  __device__ __forceinline__ void walk(long lo, long hi, int*, F&& f) const {
    const int lane = threadIdx.x & 31;
    for (long c = lo; c < hi; c += 32 * SORT_ITEMS) {
      int v[SORT_ITEMS], k[SORT_ITEMS];
#pragma unroll
      for (int j = 0; j < SORT_ITEMS; ++j) {
        const long e = c + 32 * j + lane;
        v[j] = e < hi ? (vals != nullptr ? __ldcs(vals + e) : (int)e) : 0;
      }
#pragma unroll
      for (int j = 0; j < SORT_ITEMS; ++j)
        k[j] = c + 32 * j + lane < hi ? target[v[j]] : -1;
#pragma unroll
      for (int j = 0; j < SORT_ITEMS; ++j) f(k[j] >= 0, k[j], v[j]);
    }
  }
};

// start[p] for p in [0, npix]: the first sorted record whose target is
// >= p (a binary search).
__global__ void dcn_bwd_start_kernel(const int* __restrict__ entries,
                                     const int* __restrict__ total,
                                     const int* __restrict__ target,
                                     int npix, int* __restrict__ start) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p > npix) return;
  int lo = 0, hi = *total;
  while (lo < hi) {
    const int mid = (int)(((unsigned)lo + (unsigned)hi) >> 1);
    if (target[entries[mid]] < p)
      lo = mid + 1;
    else
      hi = mid;
  }
  start[p] = lo;
}

// ---- 5. g_x ---------------------------------------------------------------
// A thread per (pixel, 8 channels): the cells of the windows that hold the
// pixel, tile after tile in order, then its fallback list in order.
__global__ void __launch_bounds__(256)
dcn_bwd_gx_kernel(const float* __restrict__ win, const int* __restrict__ start,
                  const int* __restrict__ entries,
                  const float* __restrict__ rec_weight,
                  const float* __restrict__ gc, int B, int H, int W, int Cin,
                  float* __restrict__ gx) {
  const int G = Cin / 8;
  const long i = (long)blockIdx.x * 256 + threadIdx.x;
  if (i >= (long)B * H * W * G) return;
  const long m = i / G;
  const int g = (int)(i - m * G);
  const int x = (int)(m % W), y = (int)((m / W) % H);
  const int b = (int)(m / ((long)W * H));
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  // the tiles whose window rows hold y: t TH - HALO <= y <= t TH + TH - 1 +
  // HALO (and columns x alike)
  const int ay = y - (TH - 1 + HALO), ax = x - (TW - 1 + HALO);
  const int ty0 = ay > 0 ? (ay + TH - 1) / TH : 0;
  const int tx0 = ax > 0 ? (ax + TW - 1) / TW : 0;
  const int ty1 = min(tiles_y - 1, (y + HALO) / TH);
  const int tx1 = min(tiles_x - 1, (x + HALO) / TW);
  float acc[8] = {};
  for (int ty = ty0; ty <= ty1; ++ty)
    for (int tx = tx0; tx <= tx1; ++tx) {
      const int cell = (y - ty * TH + HALO) * WW + (x - tx * TW + HALO);
      if (cell >= WCELLS) continue;
      const long tile = ((long)b * tiles_y + ty) * tiles_x + tx;
      float v[8];
      load_vec<8>(win + (tile * WCELLS + cell) * Cin + g * 8, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += v[e];
    }
  const int e1 = start[m + 1];
  for (int e = start[m]; e < e1; ++e) {
    const int src = entries[e];
    const float w = rec_weight[src];
    float v[8];
    load_vec<8>(gc + (long)(src >> 2) * Cin + g * 8, v);
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] += w * v[k];
  }
  store_vec<8>(gx + m * Cin + g * 8, acc);
}

// ---- 6. g_W ---------------------------------------------------------------
// A thread per 4 floats of g_W: the splits summed in split order.
__global__ void __launch_bounds__(256)
dcn_bwd_wsum_kernel(const float4* __restrict__ parts, int splits, long n4,
                    float4* __restrict__ gw) {
  const long i = (long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n4) return;
  float4 s = parts[i];
  for (int sp = 1; sp < splits; ++sp) {
    const float4 v = parts[sp * n4 + i];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  gw[i] = s;
}

template <int KS>
cudaError_t launch_input(dim3 grid, cudaStream_t st, const void* x,
                         const void* offset, int off_stride, const void* mask,
                         int mask_stride, const void* weight,
                         const void* g_out, const InputWork& work, int B,
                         int H, int W, int Cin, int Cout) {
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
      (const __nv_bfloat16*)g_out, work, B, H, W, Cin, Cout);
  return cudaGetLastError();
}

// The weight launch's split of the pixels: whole waves of two blocks per
// SM, of W_WAVES to 2 W_WAVES waves the count whose last wave is fullest.
cudaError_t weight_splits(long M, int Cin, int Cout, long* splits,
                          long* per_split) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long base = 9L * (Cin / WM) * ((Cout + WN - 1) / WN);
  const long steps = (M + WK - 1) / WK;
  const long slots = 2L * sms;
  long sp_best = 1;
  double best = -1.0;
  for (long waves = W_WAVES; waves <= 2 * W_WAVES; ++waves) {
    const long sp = waves * slots / base;
    if (sp < 1) continue;
    const double fill = (double)(sp * base) / (double)(waves * slots);
    if (fill > best + 1e-9) {
      best = fill;
      sp_best = sp;
    }
  }
  sp_best = sp_best > steps ? steps : sp_best;
  *per_split = ((steps + sp_best - 1) / sp_best) * WK;
  *splits = (M + *per_split - 1) / *per_split;
  return cudaSuccess;
}

// A call's launches and its workspace's parts (offsets in 4-byte words,
// each at a multiple of 64 words).
struct Plan {
  long M, tiles, records, splits, per_split;
  int passes, bits[2], sort_blocks;
  long win, om, rec_target, rec_weight, gc, entries, start, sort, wsum;
  long words;
};

// -1 for an unsupported shape, else 0 (or a cudaError_t)
int plan_of(int B, int H, int W, int Cin, int Cout, Plan* pl) {
  if (B < 0 || H < 0 || W < 0 || Cin < 64 || Cin % 64 != 0 || Cout < 8 ||
      Cout % 8 != 0 || Cout > 512)
    return -1;
  const long M = (long)B * H * W;
  // 32-bit record keys; at most 2^20 target pixels (two 10-bit passes)
  if (M * RECORDS >= (1L << 31) || M > (1L << (2 * SORT_MAX_BITS)))
    return -1;
  pl->M = M;
  pl->tiles = (long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  pl->records = M * RECORDS;
  pl->splits = pl->per_split = 0;
  if (M > 0) {
    const cudaError_t err =
        weight_splits(M, Cin, Cout, &pl->splits, &pl->per_split);
    if (err != cudaSuccess) return (int)err;
  }
  int nbits = 1;
  while ((1L << nbits) < M) ++nbits;
  pl->passes = nbits > SORT_MAX_BITS ? 2 : 1;
  pl->bits[0] = pl->passes == 2 ? (nbits + 1) / 2 : nbits;
  pl->bits[1] = nbits - pl->bits[0];
  const long blocks =
      (pl->records + SORT_ITEMS_PER_BLOCK - 1) / SORT_ITEMS_PER_BLOCK;
  pl->sort_blocks = (int)(blocks < 1 ? 1
                          : (blocks > SORT_MAX_BLOCKS ? SORT_MAX_BLOCKS
                                                      : blocks));
  long off = 0;
  auto take = [&off](long words) {
    const long at = off;
    off += (words + 63) / 64 * 64;
    return at;
  };
  pl->win = take(pl->tiles * WCELLS * Cin);
  pl->om = take((long)(Cin / NC) * M * 27);
  pl->rec_target = take(pl->records);
  pl->rec_weight = take(pl->records);
  pl->gc = take(M * 9 * Cin);
  pl->entries = take(pl->records);
  pl->start = take(M + 1);
  pl->sort = take(gf::binsort::work_words(pl->records, pl->sort_blocks,
                                          pl->bits[0]));
  pl->wsum = take(pl->splits * 9 * Cin * Cout);
  pl->words = off;
  return 0;
}

}  // namespace

// The sizes of a call on x [B, H, W, Cin] -> C_out: out[0] the 4-byte words
// of its workspace, out[1] the weight launch's splits, out[2] the bound of
// its fallback records (36 a pixel). Returns -1 for an unsupported shape.
GF_EXPORT int gf_dcn_backward_sizes(int B, int H, int W, int Cin, int Cout,
                                    long long* out) {
  Plan pl;
  const int err = plan_of(B, H, W, Cin, Cout, &pl);
  if (err) return err;
  out[0] = pl.words;
  out[1] = pl.splits;
  out[2] = pl.records;
  return 0;
}

// x [B, H, W, Cin] bf16; offset / mask as for gf_dcn_forward (pixel rows of
// off_stride / mask_stride floats); weight [9 * Cin, Cout] bf16; g_out
// [B, H, W, Cout] bf16; ws: the workspace (gf_dcn_backward_sizes' words,
// 256-byte aligned). Outputs, all fp32, each element written once: g_x
// [B, H, W, Cin], g_offset [B, H, W, 18], g_mask [B, H, W, 9], g_w
// [9 * Cin, Cout]. Requires Cin % 64 == 0, Cout % 8 == 0, Cout <= 512.
// `parts` selects the launches (bits, in the order they run): 1 the input
// launch, 2 the weight launch, 4 the g_offset / g_mask sums, 8 the
// fallback bins, 16 g_x, 32 the splits' sum of g_W (gf_dcn_backward runs
// them all; one alone, on a workspace that a whole call filled, serves to
// time it). No host read, no allocation.
GF_EXPORT int gf_dcn_backward_parts(const void* x, const void* offset,
                                    int off_stride, const void* mask,
                                    int mask_stride, const void* weight,
                                    const void* g_out, void* g_x,
                                    void* g_offset, void* g_mask, void* g_w,
                                    void* ws, int B, int H, int W, int Cin,
                                    int Cout, int parts, void* stream) {
  Plan pl;
  const int bad = plan_of(B, H, W, Cin, Cout, &pl);
  if (bad) return bad;
  cudaStream_t st = (cudaStream_t)stream;
  const long M = pl.M;
  if (M == 0) return 0;
  float* wsf = (float*)ws;
  int* wsi = (int*)ws;
  const InputWork work{wsf + pl.win, wsf + pl.om, wsi + pl.rec_target,
                       wsf + pl.rec_weight, wsf + pl.gc};
  int* entries = wsi + pl.entries;
  int* start = wsi + pl.start;
  cudaError_t err = cudaSuccess;
  if (parts & 1) {
    // W slices of a whole tap up to C_out 256, of 128 channels up to 512:
    // either way two blocks fit on an SM
    const dim3 grid_in((unsigned)pl.tiles, (unsigned)(Cin / NC));
    err = Cout <= 256
              ? launch_input<256>(grid_in, st, x, offset, off_stride, mask,
                                  mask_stride, weight, g_out, work, B, H, W,
                                  Cin, Cout)
              : launch_input<128>(grid_in, st, x, offset, off_stride, mask,
                                  mask_stride, weight, g_out, work, B, H, W,
                                  Cin, Cout);
    if (err != cudaSuccess) return (int)err;
  }
  if (parts & 2) {
    const dim3 grid_w((unsigned)(9 * (Cin / WM)),
                      (unsigned)((Cout + WN - 1) / WN), (unsigned)pl.splits);
    dcn_bwd_weight_kernel<<<grid_w, THREADS, W_SMEM, st>>>(
        (const __nv_bfloat16*)x, (const float*)offset, off_stride,
        (const float*)mask, mask_stride, (const __nv_bfloat16*)g_out,
        wsf + pl.wsum, B, H, W, Cin, Cout, (int)pl.per_split);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (parts & 4) {
    dcn_bwd_om_kernel<<<(unsigned)((M * 27 + 255) / 256), 256, 0, st>>>(
        work.om, Cin / NC, M, (float*)g_offset, (float*)g_mask);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (parts & 8) {
    const gf::binsort::Work wk = gf::binsort::work_of(
        wsi + pl.sort, pl.records, pl.sort_blocks, pl.bits[0]);
    const bool two = pl.passes == 2;
    const RecordItems first{work.rec_target, nullptr};
    int e = gf::binsort::sort_pass(first, nullptr, pl.records, 0,
                                   pl.bits[0], pl.sort_blocks, wk, wk.total,
                                   two ? wk.vals0 : entries, st);
    if (e) return e;
    if (two) {
      const RecordItems second{work.rec_target, wk.vals0};
      e = gf::binsort::sort_pass(second, wk.total, 0, pl.bits[0],
                                 pl.bits[1], pl.sort_blocks, wk, nullptr,
                                 entries, st);
      if (e) return e;
    }
    dcn_bwd_start_kernel<<<(unsigned)((M + 1 + 255) / 256), 256, 0, st>>>(
        entries, wk.total, work.rec_target, (int)M, start);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (parts & 16) {
    dcn_bwd_gx_kernel<<<(unsigned)((M * (Cin / 8) + 255) / 256), 256, 0,
                        st>>>(work.win, start, entries, work.rec_weight,
                              work.gc, B, H, W, Cin, (float*)g_x);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (parts & 32) {
    const long n4 = 9L * Cin * Cout / 4;
    dcn_bwd_wsum_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, st>>>(
        (const float4*)(wsf + pl.wsum), (int)pl.splits, n4, (float4*)g_w);
    err = cudaGetLastError();
  }
  return (int)err;
}

GF_EXPORT int gf_dcn_backward(const void* x, const void* offset,
                              int off_stride, const void* mask,
                              int mask_stride, const void* weight,
                              const void* g_out, void* g_x, void* g_offset,
                              void* g_mask, void* g_w, void* ws, int B,
                              int H, int W, int Cin, int Cout, void* stream) {
  return gf_dcn_backward_parts(x, offset, off_stride, mask, mask_stride,
                               weight, g_out, g_x, g_offset, g_mask, g_w, ws,
                               B, H, W, Cin, Cout, 63, stream);
}
