// The pixel bins of K6 (deformable_bwd.cu): each in-image sample's corners
// inside their level, listed by feature pixel, so that K6 can gather each
// pixel's gradient instead of scattering it with float atomics.
//
// Replaces: nothing of the TPU kernel (deformable_kernel.py
//           deformable_fused_bwd accumulates its feature gradient in VMEM
//           strips); this is the index that lets a Hopper kernel gather.
//
// Keys and entries (the layout of kernels/deformable.py::DeformableBins):
// a pixel's key is level-major, then plane (b cams + cam), y, x:
//   key = off_l + ((b cams + cam) H_l + y) W_l + x,
// off_l the pixels of the levels before l. An entry is one int32,
// sample x 4 + corner (sample = pair L + l, deformable.cuh), for each
// corner of an in-image sample that lies in its level (a corner outside is
// dropped, never clamped). The entries are sorted by key, each pixel's
// entries in sample order; pixel_start[key] is the first of pixel key's,
// pixel_start[npix] the total. Only entries are stored between the passes
// (a key is recomputed from its entry's (u, v)), so that the places a
// pass writes (4 bytes an entry) stay in the L2 until they are whole.
//
// A stable LSD radix sort by key (bin_sort.cuh, with the counting sort's
// ranking of bin_rank.cuh: no atomic decides an order), in one or two
// passes of at most MAX_BITS bits (keys below 2^20). The first pass walks the pairs in
// order: a warp loads 4 x 32 pairs' (u, v), one ballot a 32 finds the
// in-image ones, and their 4 L corner slots are spread over the lanes, so
// the entries are generated in sample order without being stored first;
// the second walks the first's entries, 8 a lane loaded at once. Each
// pass is three launches: per block and warp, its count of each digit
// (blocks take equal ranges, each warp an equal part in order); a warp a
// digit, the blocks' counts scanned into each block's first place and the
// digit's total; per block, the digits' totals scanned, and each item to
// its place (the first pass's block 0 stores the entry total on the
// device). Then one launch finds each pixel's start in the sorted entries
// (a binary search). Nothing is read back to the host: the arrays are sized
// by the bound the shapes give, 4 L entries a pair, and every grid by the
// shapes.
//
// Bound on the H100: bytes, and the launches' latency at these sizes (the
// points, and a few int32 words an entry each pass).
#include "bin_sort.cuh"
#include "deformable.cuh"

namespace {

using gf::deform::MAX_LEVELS;
using gf::deform::pick;

constexpr int MAX_BITS = 10;
constexpr int PAIRS_PER_BLOCK = 512;
constexpr int MAX_BLOCKS = 1024;
constexpr int CHUNKS = 4;          // pass 1: chunks of 32 pairs loaded at once
constexpr int ITEMS = 8;           // pass 2: items a lane loads at once

struct Shape {
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int off[MAX_LEVELS];
  int L, cams, qc;   // qc: pairs of a batch element (Q cams)
};

// The key of an entry (sample x 4 + corner), recomputed from its sample's
// (u, v) as pass 1 computed it.
__device__ __forceinline__ int key_of(int val, const float* __restrict__ pts,
                                      const Shape& sh) {
  const int sample = val >> 2;
  const int l = sample % sh.L;
  const int pair = sample / sh.L;
  const float2 uv = reinterpret_cast<const float2*>(pts)[pair];
  const int hl = pick(sh.h, l), wl = pick(sh.w, l);
  int pix;
  gf::deform::corner_pixel(uv.x, uv.y, hl, wl, val & 3, &pix);
  const int plane = pair / sh.qc * sh.cams + pair % sh.cams;
  return pick(sh.off, l) + plane * hl * wl + pix;
}

// Pass 1's items: each in-image sample's corners, in sample order, from
// the pairs [lo, hi).
struct PairItems {
  const float* pts;
  Shape sh;

  template <class F>
  __device__ __forceinline__ void walk(long lo, long hi, int* s_lane,
                                       F&& f) const {
    const int lane = threadIdx.x & 31;
    const int slots = 4 * sh.L;   // a pair's corner slots
    for (long c0 = lo; c0 < hi; c0 += 32 * CHUNKS) {
      float2 uv[CHUNKS];
#pragma unroll
      for (int j = 0; j < CHUNKS; ++j) {
        const long pr = c0 + 32 * j + lane;
        uv[j] = pr < hi ? reinterpret_cast<const float2*>(pts)[pr]
                        : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < CHUNKS; ++j) {
        const long c = c0 + 32 * j;
        const float u = uv[j].x, v = uv[j].y;
        const bool in = gf::deform::inside(u, v);
        const unsigned mask = __ballot_sync(0xffffffffu, in);
        // the lane of each in-image pair, by rank
        if (in) s_lane[__popc(mask & ((1u << lane) - 1u))] = lane;
        __syncwarp();
        const int n_slots = __popc(mask) * slots;
        for (int r = 0; r < n_slots; r += 32) {
          const int s = r + lane;
          const bool live = s < n_slots;
          const int ord = live ? s / slots : 0;
          const int src = s_lane[ord];
          const float pu = __shfl_sync(0xffffffffu, u, src);
          const float pv = __shfl_sync(0xffffffffu, v, src);
          int key = 0, val = 0;
          bool valid = false;
          if (live) {
            const int within = s - ord * slots;
            const int l = within >> 2, n = within & 3;
            const int hl = pick(sh.h, l), wl = pick(sh.w, l);
            int pix;
            valid = gf::deform::corner_pixel(pu, pv, hl, wl, n, &pix);
            const long pair = c + src;
            const int plane = (int)(pair / sh.qc) * sh.cams +
                              (int)(pair % sh.cams);
            key = pick(sh.off, l) + plane * hl * wl + pix;
            val = (int)((pair * sh.L + l) * 4 + n);
          }
          f(valid, key, val);
        }
        __syncwarp();   // s_lane is written again
      }
    }
  }
};

// The second pass's items: the first pass's entries, in order, ITEMS a
// lane loaded at once (striped, so that the calls keep the order; streamed
// past the L2, which holds the places being written), their keys
// recomputed.
struct EntryItems {
  const int* vals;
  const float* pts;
  Shape sh;

  template <class F>
  __device__ __forceinline__ void walk(long lo, long hi, int*, F&& f) const {
    const int lane = threadIdx.x & 31;
    for (long c = lo; c < hi; c += 32 * ITEMS) {
      int v[ITEMS], k[ITEMS];
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        const long e = c + 32 * j + lane;
        v[j] = e < hi ? __ldcs(vals + e) : 0;
      }
#pragma unroll
      for (int j = 0; j < ITEMS; ++j)
        k[j] = c + 32 * j + lane < hi ? key_of(v[j], pts, sh) : 0;
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) f(c + 32 * j + lane < hi, k[j], v[j]);
    }
  }
};

// pixel_start[p] for p in [0, npix]: the first sorted entry whose key is
// >= p (a binary search, each probe's key recomputed).
__global__ void bin_pixel_start_kernel(const int* __restrict__ entries,
                                       const int* __restrict__ total,
                                       const float* __restrict__ pts,
                                       Shape sh, int npix,
                                       int* __restrict__ start) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p > npix) return;
  int lo = 0, hi = *total;
  while (lo < hi) {
    const int mid = (int)(((unsigned)lo + (unsigned)hi) >> 1);
    if (key_of(entries[mid], pts, sh) < p)
      lo = mid + 1;
    else
      hi = mid;
  }
  start[p] = lo;
}

struct Plan {
  Shape sh;
  long npair, emax;
  int npix, blocks, passes, bits[2];
  long ws_words;
};

// -1 for an unsupported shape
int plan_of(const int* heights, const int* widths, int L, int B, int Q,
            int cams, Plan* pl) {
  if (L < 1 || L > MAX_LEVELS || B < 0 || Q < 0 || cams < 1) return -1;
  Shape& sh = pl->sh;
  sh.L = L;
  sh.cams = cams;
  sh.qc = Q * cams;
  long npix = 0;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    sh.h[l] = l < L ? heights[l] : 0;
    sh.w[l] = l < L ? widths[l] : 0;
    sh.off[l] = (int)npix;
    if (l < L) npix += (long)B * cams * sh.h[l] * sh.w[l];
  }
  pl->npair = (long)B * Q * cams;
  pl->emax = pl->npair * L * 4;
  if (npix > (1L << (2 * MAX_BITS)) || pl->emax >= (1L << 31)) return -1;
  pl->npix = (int)npix;
  int nbits = 1;
  while ((1L << nbits) < npix) ++nbits;
  pl->passes = nbits > MAX_BITS ? 2 : 1;
  pl->bits[0] = pl->passes == 2 ? (nbits + 1) / 2 : nbits;
  pl->bits[1] = nbits - pl->bits[0];
  long blocks = (pl->npair + PAIRS_PER_BLOCK - 1) / PAIRS_PER_BLOCK;
  pl->blocks = (int)(blocks < 1 ? 1 : (blocks > MAX_BLOCKS ? MAX_BLOCKS
                                                           : blocks));
  pl->ws_words = gf::binsort::work_words(pl->emax, pl->blocks, MAX_BITS);
  return 0;
}

}  // namespace

// The sizes of the bins of pairs [B, Q, cams] over `num_levels` levels of
// heights x widths pixels: out[0] the entries' bound (4 L B Q cams int32
// words), out[1] the pixels (pixel_start holds out[1] + 1 words), out[2]
// the int32 words of the workspace. Returns -1 for an unsupported shape
// (more than 2^20 pixels or 2^31 entries).
GF_EXPORT int gf_deformable_bin_sizes(const int* heights, const int* widths,
                                      int num_levels, int B, int Q, int cams,
                                      long long* out) {
  Plan pl;
  if (plan_of(heights, widths, num_levels, B, Q, cams, &pl)) return -1;
  out[0] = pl.emax;
  out[1] = pl.npix;
  out[2] = pl.ws_words;
  return 0;
}

// pts [B, Q, cams, 2] fp32; ws: the workspace (int32, of the size
// gf_deformable_bin_sizes gives). Writes entries [bound] int32 (the first
// pixel_start[npix] of the bound) and pixel_start [npix + 1] int32.
// Launches on `stream`, no host read. Returns a cudaError_t, or -1 for an
// unsupported shape.
GF_EXPORT int gf_deformable_bin(const int* heights, const int* widths,
                                int num_levels, const void* pts, int B,
                                int Q, int cams, void* ws, void* entries,
                                void* pixel_start, void* stream) {
  Plan pl;
  if (plan_of(heights, widths, num_levels, B, Q, cams, &pl)) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  const gf::binsort::Work wk =
      gf::binsort::work_of(ws, pl.emax, pl.blocks, MAX_BITS);
  const bool two = pl.passes == 2;
  PairItems first{(const float*)pts, pl.sh};
  int* out = (int*)entries;
  int err = gf::binsort::sort_pass(first, nullptr, pl.npair, 0, pl.bits[0],
                                   pl.blocks, wk, wk.total,
                                   two ? wk.vals0 : out, st);
  if (err) return err;
  if (two) {
    EntryItems second{wk.vals0, (const float*)pts, pl.sh};
    err = gf::binsort::sort_pass(second, wk.total, 0, pl.bits[0],
                                 pl.bits[1], pl.blocks, wk, nullptr, out,
                                 st);
    if (err) return err;
  }
  bin_pixel_start_kernel<<<(pl.npix + 1 + 255) / 256, 256, 0, st>>>(
      out, wk.total, (const float*)pts, pl.sh, pl.npix, (int*)pixel_start);
  return (int)cudaGetLastError();
}
