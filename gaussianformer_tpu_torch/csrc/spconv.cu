// The submanifold sparse 3D convolution of the frame path, fused: a voxel ->
// anchor table built on the card, then one kernel that gathers each tap's
// neighbour rows straight into shared memory and multiplies them there.
//
// Replaces no TPU kernel: gaussianformer_tpu/ops/sparse_conv.py leaves the
// gather and the matmuls to XLA. The port's plain version
// (ops/sparse_conv.py::submanifold_conv3d) materialises every tap's
// neighbour rows: at 144,000 anchors and 128 channels in bf16 it writes
// 0.92 GB of gathered rows a chunk of 25 taps (4.6 GB for 125 taps), zeroes
// the empty ones in another pass and reads them again in the matmul. Here
// no gathered tensor reaches device memory.
//
// Computes, for every anchor i (voxel v_i) and tap t of the k^3 stencil
// (t = (kx k + ky) k + kz, offset (kx, ky, kz) - k / 2):
//   nb(i, t) = table[v_i + offset(t)]   (-1 outside the grid or empty)
//   out[i, :] = sum_t W_t^T x[nb(i, t), :] (+ bias)   W: [C_out, k^3, C_in]
// where the table holds, per voxel, the highest index of the anchors in it
// (an int atomicMax: deterministic, as the JAX package's last-writer-wins
// scatter of indices in order). x is bf16, the sums fp32, the output fp32.
//
// Bound on the H100: the contraction with every tap dense, 2 P k^3 C_in
// C_out flops: 0.59 TFLOP at 144,000 anchors (0.60 ms at 989 TFLOP/s), 26
// GFLOP at Prob-64's 6400; the bytes (bf16 features once, the weights, the
// table, the fp32 output) are about 0.12 GB at 144k (0.04 ms at 3.35 TB/s),
// and the rows read again for each tap come from L2. Operation bound. Only
// the non-empty (anchor, tap) pairs need their MMAs: about a fifth of the
// taps at 144k (0.11 ms) and a tenth at Prob-64, so this design, which
// runs every live tap of a tile dense, spends most of its MMAs on
// zero-filled rows (a tile's rows are spread over the scene, so its taps
// are rarely empty all at once).
//
// Design: an implicit GEMM on bf16 mma.sync.m16n8k16 with fp32 sums, fed by
// ldmatrix (mma.cuh, shared with K1 and K5). A block of 256 threads (8
// warps as 2 x 4) owns BM anchor rows x 128 output channels (C_out 256
// takes two column blocks): BM = 128 where there are such tiles for two
// blocks on every SM, since every block reads each tap's W slice again from
// L2 (4.6 GB a call at 144k, the larger part of the kernel's traffic), else
// BM = 64 (Prob-64: 100 blocks). The block
//  1. looks up its rows' neighbours in every tap (the table is 2.6 MB at
//     the 0.5 m grid, resident in L2) and keeps a mask of the taps in which
//     some row has one; a tap with none is skipped whole, weights included;
//  2. walks the live taps in increasing order in 32-channel steps. Each
//     step's A tile (BM gathered rows) and W slice (128 x 32) go through a
//     3-stage cp.async ring, one barrier a step; an empty neighbour is a
//     cp.async of source size 0, which zero-fills the row with no load. The
//     next tap's neighbours are looked up a tap ahead, in registers;
//  3. adds the bias to the fp32 sums and stores them.
// Every row's sums run in the same order on every call: no float atomics,
// the same bits each call. Features are cast to bf16 by the wrapper (the
// plain version's own rounding), so a gathered row is 256 bytes, not 512.
// Where the time goes at 144k (H100, 128 x 128 blocks): 2.35 ms a call;
// with the MMAs cut 1.49 ms (the copies: L2 bandwidth), with the copies cut
// 2.01 ms (the MMAs and ldmatrix at about 300 TFLOP/s): both halves bound
// it, and a 256-row block, which halves the W traffic, loses more in the
// MMAs at one block an SM than it saves.
#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace gf;

constexpr int BK = 32;         // input channels a step
constexpr int THREADS = 256;   // 8 warps
constexpr int STAGES = 3;      // steps in the ring
constexpr int CH = BK / 8;     // 16-byte chunks of a row a step
constexpr int RSTEP = THREADS / CH;  // rows between a thread's copies
constexpr int A_LD = BK + 8;   // bf16 row pitch of an A tile
constexpr int W_LD = BK + 8;   // bf16 row pitch of a W slice ([n][k])
constexpr int MAX_TAPS = 128;  // k <= 5
constexpr int BN = 128;        // output channels of a block
constexpr int WARPS_M = 2;     // warps along a block's rows
constexpr int WARPS_N = THREADS / 32 / WARPS_M;  // ... and its channels

// bf16 elements of a ring stage (an A tile and a W slice), bytes of the ring
template <int BM>
constexpr int STAGE_ELEMS = BM * A_LD + BN * W_LD;
template <int BM>
constexpr int SMEM_BYTES = STAGES * STAGE_ELEMS<BM> * 2;

// the anchor in the voxel at c + offset(tap), or -1; c[0] < 0 marks a row
// past P
__device__ __forceinline__ int neighbour(const int* __restrict__ table,
                                         const int* c, int tap, int k, int X,
                                         int Y, int Z) {
  if (c[0] < 0) return -1;
  const int r = k >> 1;
  const int x = c[0] + tap / (k * k) - r;
  const int y = c[1] + (tap / k) % k - r;
  const int z = c[2] + tap % k - r;
  if (x < 0 || x >= X || y < 0 || y >= Y || z < 0 || z >= Z) return -1;
  return __ldg(table + (x * Y + y) * Z + z);
}

__global__ void spconv_table_kernel(const int* __restrict__ coords, int P,
                                    int X, int Y, int Z,
                                    int* __restrict__ table) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P) return;
  const int x = coords[3 * i], y = coords[3 * i + 1], z = coords[3 * i + 2];
  if (x < 0 || x >= X || y < 0 || y >= Y || z < 0 || z >= Z) return;
  atomicMax(table + (x * Y + y) * Z + z, i);
}

// a block: BM anchor rows x BN output channels; each warp a (BM / WARPS_M)
// x (BN / WARPS_N) tile of MI x 2 NJ mma tiles
template <int BM>
__global__ void __launch_bounds__(THREADS, 2)
spconv_kernel(const __nv_bfloat16* __restrict__ x,
              const int* __restrict__ coords, const int* __restrict__ table,
              const __nv_bfloat16* __restrict__ w,
              const float* __restrict__ bias, float* __restrict__ out,
              int* __restrict__ stats, int P, int Cin, int Cout, int k,
              int X, int Y, int Z) {
  constexpr int RA = BM / RSTEP;          // A rows a thread copies a step
  constexpr int RW = BN / RSTEP;          // W rows a thread copies a step
  constexpr int MI = BM / WARPS_M / 16;   // m16 tiles of a warp
  constexpr int WN = BN / WARPS_N;        // output channels of a warp
  constexpr int NJ = WN / 16;             // ldmatrix.x4 of B a k16 step
  static_assert(RA * RSTEP == BM && RW * RSTEP == BN && NJ >= 1, "tiling");
  constexpr int STAGE = STAGE_ELEMS<BM>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_xyz[BM][3];
  __shared__ unsigned s_mask[MAX_TAPS / 32];
  __shared__ int s_taps[MAX_TAPS];
  __shared__ int s_live, s_pairs;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int kkk = k * k * k;

  // this thread copies the 16 bytes at channel q * 8 of the step's chunk:
  // A rows r0 + RSTEP i, W rows (output channels) r0 + RSTEP j
  const int q = tid % CH;
  const int r0 = tid / CH;
  for (int r = tid; r < BM; r += THREADS) {
    const bool in = m0 + r < P;
#pragma unroll
    for (int d = 0; d < 3; ++d)
      s_xyz[r][d] = in ? coords[3L * (m0 + r) + d] : -1;
  }
  if (tid < MAX_TAPS / 32) s_mask[tid] = 0u;
  if (tid == 0) s_pairs = 0;
  __syncthreads();

  // 1. the taps in which some row has a neighbour (the CH threads of a row
  // group take every CH-th tap)
  int pairs = 0;
#pragma unroll
  for (int wi = 0; wi < MAX_TAPS / 32; ++wi) {
    unsigned bits = 0u;
    for (int b = q; b < 32; b += CH) {
      const int t = wi * 32 + b;
      if (t >= kkk) break;
      bool any = false;
#pragma unroll
      for (int i = 0; i < RA; ++i) {
        const bool found =
            neighbour(table, s_xyz[r0 + RSTEP * i], t, k, X, Y, Z) >= 0;
        any |= found;
        pairs += (int)found;
      }
      bits |= (unsigned)any << b;
    }
    bits = __reduce_or_sync(0xffffffffu, bits);
    if (lane == 0 && bits) atomicOr(&s_mask[wi], bits);
  }
  if (stats != nullptr) {
    pairs = __reduce_add_sync(0xffffffffu, pairs);
    if (lane == 0) atomicAdd(&s_pairs, pairs);
  }
  __syncthreads();
  if (warp == 0) {
    // the live taps in increasing order
    int base = 0;
#pragma unroll
    for (int wi = 0; wi < MAX_TAPS / 32; ++wi) {
      const unsigned bits = s_mask[wi];
      if (bits >> lane & 1u)
        s_taps[base + __popc(bits & ((1u << lane) - 1u))] = wi * 32 + lane;
      base += __popc(bits);
    }
    if (lane == 0) {
      s_live = base;
      if (stats != nullptr && blockIdx.y == 0) {
        stats[2 * blockIdx.x] = s_pairs;
        stats[2 * blockIdx.x + 1] = kkk - base;
      }
    }
  }
  __syncthreads();
  const int live = s_live;

  // 2. the K loop: live tap i_tap, channels i_chunk * BK .. + BK
  const int kc = Cin / BK;
  const int nk = live * kc;
  int i_step = 0, i_stage = 0, i_chunk = 0, i_tap = 0;
  int nb[RA], pf[RA];  // this tap's neighbours of the rows, the next tap's
#pragma unroll
  for (int i = 0; i < RA; ++i) {
    const int* c = s_xyz[r0 + RSTEP * i];
    nb[i] = live > 0 ? neighbour(table, c, s_taps[0], k, X, Y, Z) : -1;
    pf[i] = live > 1 ? neighbour(table, c, s_taps[1], k, X, Y, Z) : -1;
  }
  auto issue = [&]() {
    if (i_step < nk) {
      if (i_chunk == 0 && i_tap > 0) {
        const bool more = i_tap + 1 < live;
        const int t = more ? s_taps[i_tap + 1] : 0;
#pragma unroll
        for (int i = 0; i < RA; ++i) {
          nb[i] = pf[i];
          if (more)
            pf[i] = neighbour(table, s_xyz[r0 + RSTEP * i], t, k, X, Y, Z);
        }
      }
      const int tap = s_taps[i_tap];
      __nv_bfloat16* sa = ring + i_stage * STAGE;
      __nv_bfloat16* sw = sa + BM * A_LD;
      const int ch = i_chunk * BK + q * 8;
#pragma unroll
      for (int i = 0; i < RA; ++i)
        cp_async16(sa + (r0 + RSTEP * i) * A_LD + q * 8,
                   nb[i] >= 0 ? x + (long)nb[i] * Cin + ch : x, nb[i] >= 0);
#pragma unroll
      for (int j = 0; j < RW; ++j) {
        const int n = r0 + RSTEP * j;
        const bool ok = n0 + n < Cout;
        cp_async16(sw + n * W_LD + q * 8,
                   ok ? w + ((long)(n0 + n) * kkk + tap) * Cin + ch : w, ok);
      }
      ++i_step;
      if (++i_stage == STAGES) i_stage = 0;
      if (++i_chunk == kc) {
        i_chunk = 0;
        ++i_tap;
      }
    }
    cp_async_commit();  // an empty group past the last step
  };

  // ldmatrix addresses: A(m = row, k = channel) at a[m][k]; B(k, n) at
  // w[n][k], which is the mma's column-major B, loaded without .trans
  const int lr = lane & 7, lm = lane >> 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int a_off =
      (wm * (BM / WARPS_M) + (lm & 1) * 8 + lr) * A_LD + (lm >> 1) * 8;
  const int b_off = BM * A_LD + (wn * WN + (lm >> 1) * 8 + lr) * W_LD +
                    (lm & 1) * 8;
  float acc[MI][2 * NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 2 * NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int s = 0; s < STAGES - 1; ++s) issue();
  int stage = 0;
  for (int ks = 0; ks < nk; ++ks) {
    cp_async_wait<STAGES - 2>();  // step ks has landed
    __syncthreads();  // ... for every thread; step ks - 1's MMAs are done,
    issue();          // so its stage takes step ks + STAGES - 1
    const __nv_bfloat16* a = ring + stage * STAGE + a_off;
    const __nv_bfloat16* b = ring + stage * STAGE + b_off;
    if (++stage == STAGES) stage = 0;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned af[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) ldsm_x4(af[i], a + i * 16 * A_LD + kk);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        // (W rows past C_out are zeros: their sums are never stored)
        unsigned bf[4];
        ldsm_x4(bf, b + j * 16 * W_LD + kk);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          mma_bf16(acc[i][2 * j], af[i], bf[0], bf[1]);
          mma_bf16(acc[i][2 * j + 1], af[i], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // 3. the bias, one fp32 add, and the fp32 rows (each lane stores two
  // neighbouring channels of two rows)
#pragma unroll
  for (int j = 0; j < 2 * NJ; ++j) {
    const int col = n0 + wn * WN + j * 8 + 2 * (lane & 3);
    if (col >= Cout) continue;
    float b0 = 0.f, b1 = 0.f;
    if (bias != nullptr) {
      b0 = bias[col];
      b1 = bias[col + 1];
    }
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int row = m0 + wm * (BM / WARPS_M) + i * 16 + (lane >> 2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (row + 8 * h >= P) continue;
        float2 v = make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        if (bias != nullptr) {
          v.x += b0;
          v.y += b1;
        }
        *reinterpret_cast<float2*>(out + (long)(row + 8 * h) * Cout + col) =
            v;
      }
    }
  }
}

template <int BM>
int launch(const void* x, const void* coords, const void* table,
           const void* weight, const void* bias, void* out, void* stats,
           int P, int Cin, int Cout, int k, int X, int Y, int Z,
           cudaStream_t stream) {
  const cudaError_t err =
      cudaFuncSetAttribute(spconv_kernel<BM>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_BYTES<BM>);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((P + BM - 1) / BM), (unsigned)((Cout + BN - 1) / BN));
  spconv_kernel<BM><<<grid, THREADS, SMEM_BYTES<BM>, stream>>>(
      (const __nv_bfloat16*)x, (const int*)coords, (const int*)table,
      (const __nv_bfloat16*)weight, (const float*)bias, (float*)out,
      (int*)stats, P, Cin, Cout, k, X, Y, Z);
  return (int)cudaGetLastError();
}

}  // namespace

// coords int32 [P, 3] (voxel coordinates inside the X x Y x Z grid); table
// int32 [X * Y * Z], filled here with -1, then with the highest anchor
// index of each voxel.
GF_EXPORT int gf_spconv_table(const void* coords, int P, int X, int Y, int Z,
                              void* table, void* stream) {
  const long cells = (long)X * Y * Z;
  if (P < 0 || cells <= 0 || cells > (1L << 31) - 1) return -1;
  cudaError_t err = cudaMemsetAsync(table, 0xff, cells * sizeof(int),
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  if (P == 0) return 0;
  spconv_table_kernel<<<(P + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const int*)coords, P, X, Y, Z, (int*)table);
  return (int)cudaGetLastError();
}

// The anchor rows of a block gf_spconv_forward takes for P anchors and C_out
// channels: 128 where such blocks fill the card's two blocks an SM at least
// once (each W slice then serves twice the rows), else 64.
GF_EXPORT int gf_spconv_block_rows(int P, int Cout) {
  const long tiles = (P + 127) / 128 * (long)((Cout + BN - 1) / BN);
  return tiles >= 2L * gf::sm_count() ? 128 : 64;
}

// x [P, C_in] bf16; coords int32 [P, 3]; table from gf_spconv_table; weight
// [C_out, k^3, C_in] bf16 (spconv's layout); bias [C_out] fp32 or null; out
// [P, C_out] fp32; stats null, or int32 [ceil(P / gf_spconv_block_rows), 2]:
// each row tile's non-empty (anchor, tap) pairs and taps skipped whole.
// Requires C_in % 32 == 0, C_out % 32 == 0 and an odd k <= 5.
GF_EXPORT int gf_spconv_forward(const void* x, const void* coords,
                                const void* table, const void* weight,
                                const void* bias, void* out, void* stats,
                                int P, int Cin, int Cout, int k, int X, int Y,
                                int Z, void* stream) {
  if (Cin <= 0 || Cout <= 0 || Cin % BK != 0 || Cout % 32 != 0) return -1;
  if (k < 1 || k % 2 == 0 || k * k * k > MAX_TAPS) return -1;
  if (P < 0 || (long)X * Y * Z > (1L << 31) - 1) return -1;
  if (P == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (gf_spconv_block_rows(P, Cout) == 128)
    return launch<128>(x, coords, table, weight, bias, out, stats, P, Cin,
                       Cout, k, X, Y, Z, s);
  return launch<64>(x, coords, table, weight, bias, out, stats, P, Cin, Cout,
                    k, X, Y, Z, s);
}
