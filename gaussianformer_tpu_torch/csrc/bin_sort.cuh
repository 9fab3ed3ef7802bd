// A stable LSD radix sort of int items by an int key, on the device with no
// host read and no atomic that decides an order: the pixel bins of K6
// (deformable_bin.cu) and the fallback bins of K5 (dcn_bwd.cu).
//
// An `Items` type walks a warp's part of the items in order, a round of 32
// at a time (lane order within a round), calling f(valid, key, val) on
// every lane of the warp for each round. A pass sorts the valid items by
// `bits` bits of their key from `shift` on, with the counting sort's
// ranking of bin_rank.cuh, in three launches: per block and warp, its
// count of each digit (blocks take equal ranges, each warp an equal part
// in order); a warp a digit, the blocks' counts scanned into each block's
// first place and the digit's total; per block, the digits' totals
// scanned, and each item's val to its place (the pass that is given
// `total` stores the count of valid items there, from block 0). Items of
// one key keep their order.
#pragma once

#include "bin_rank.cuh"

namespace gf {
namespace binsort {
namespace {

constexpr int WARPS = 8;
constexpr int COLUMN_WARPS = 8;

// The block's and the warp's equal parts of n items in order.
__device__ __forceinline__ void warp_range(long n, long* lo, long* hi) {
  const long b0 = n * blockIdx.x / gridDim.x;
  const long b1 = n * (blockIdx.x + 1) / gridDim.x;
  const int warp = threadIdx.x >> 5;
  *lo = b0 + (b1 - b0) * warp / WARPS;
  *hi = b0 + (b1 - b0) * (warp + 1) / WARPS;
}

// Per block and warp, its items of each digit: wcount[block][warp][digit],
// and the block's: hist[digit][block]. n: the items (*total where given).
template <class Items>
__global__ void __launch_bounds__(WARPS * 32)
bin_count_kernel(Items items, const int* __restrict__ total, long n,
                 int shift, int T, int* __restrict__ wcount,
                 int* __restrict__ hist) {
  extern __shared__ int s_wc[];   // [WARPS][T]
  __shared__ int s_lane[WARPS][32];
  const int tid = threadIdx.x, warp = tid >> 5;
  if (total != nullptr) n = *total;
  for (int i = tid; i < WARPS * T; i += WARPS * 32) s_wc[i] = 0;
  __syncthreads();
  long lo, hi;
  warp_range(n, &lo, &hi);
  int* wc = s_wc + warp * T;
  // a count does not depend on the order: shared int atomics
  items.walk(lo, hi, s_lane[warp], [&](bool valid, int key, int) {
    if (valid) atomicAdd(&wc[(key >> shift) & (T - 1)], 1);
  });
  __syncthreads();
  int* mine = wcount + (long)blockIdx.x * WARPS * T;
  for (int i = tid; i < WARPS * T; i += WARPS * 32) mine[i] = s_wc[i];
  for (int t = tid; t < T; t += WARPS * 32) {
    int sum = 0;
    for (int w = 0; w < WARPS; ++w) sum += s_wc[w * T + t];
    hist[(long)t * gridDim.x + blockIdx.x] = sum;
  }
}

// A warp a digit: hist[digit][0, blocks) scanned in place (each block's
// first place among the digit's items), the digit's total to dtot[digit].
__global__ void __launch_bounds__(COLUMN_WARPS * 32)
bin_columns_kernel(int* __restrict__ hist, int blocks, int T,
                   int* __restrict__ dtot) {
  const int t = blockIdx.x * COLUMN_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (t >= T) return;   // the whole warp
  int* h = hist + (long)t * blocks;
  int carry = 0;
  for (int b0 = 0; b0 < blocks; b0 += 32) {
    const int v = b0 + lane < blocks ? h[b0 + lane] : 0;
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    if (b0 + lane < blocks) h[b0 + lane] = carry + incl - v;
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) dtot[t] = carry;
}

// Per block, each item to its place: the digit's first place (the earlier
// digits' totals) + the earlier blocks' and warps' items of the digit +
// its rank in its warp. Block 0 stores the total where `total` is given.
template <class Items>
__global__ void __launch_bounds__(WARPS * 32)
bin_place_kernel(Items items, const int* __restrict__ n_total, long n,
                 int shift, int T, const int* __restrict__ wcount,
                 const int* __restrict__ hist, const int* __restrict__ dtot,
                 int* __restrict__ total, int* __restrict__ out) {
  extern __shared__ int s_wc[];   // [WARPS][T]
  __shared__ int s_lane[WARPS][32];
  const int tid = threadIdx.x, warp = tid >> 5;
  if (n_total != nullptr) n = *n_total;
  // the digits' first places: a run of T / threads digits a thread
  const int per = (T + WARPS * 32 - 1) / (WARPS * 32);
  const int t0 = min(tid * per, T), t1 = min(t0 + per, T);
  int sum = 0;
  for (int t = t0; t < t1; ++t) sum += dtot[t];
  int run = gf::binrank::block_exclusive_sum(sum);
  const int* mine = wcount + (long)blockIdx.x * WARPS * T;
  for (int t = t0; t < t1; ++t) {
    int r = run + hist[(long)t * gridDim.x + blockIdx.x];
    run += dtot[t];
    for (int w = 0; w < WARPS; ++w) {
      s_wc[w * T + t] = r;
      r += mine[w * T + t];
    }
  }
  if (total != nullptr && blockIdx.x == 0 && tid == WARPS * 32 - 1)
    *total = run;   // the last thread's run ends at the total
  __syncthreads();
  long lo, hi;
  warp_range(n, &lo, &hi);
  int* wc = s_wc + warp * T;
  items.walk(lo, hi, s_lane[warp], [&](bool valid, int key, int val) {
    const int pos =
        gf::binrank::place_round(valid, (key >> shift) & (T - 1), wc);
    if (pos >= 0) out[pos] = val;
  });
}

// The scratch of a sort of at most `emax` items over `blocks` blocks with
// digits of at most `max_bits` bits: the first pass's output (where there
// are two), the per-warp and per-block counts, the digits' totals and the
// total.
struct Work {
  int *vals0, *wcount, *hist, *dtot, *total;
};

inline long work_words(long emax, int blocks, int max_bits) {
  const long T = 1L << max_bits;
  return emax + (long)blocks * (WARPS + 1) * T + T + 1;
}

inline Work work_of(void* ws, long emax, int blocks, int max_bits) {
  const long T = 1L << max_bits;
  Work w;
  w.vals0 = (int*)ws;
  w.wcount = w.vals0 + emax;
  w.hist = w.wcount + (long)blocks * WARPS * T;
  w.dtot = w.hist + (long)blocks * T;
  w.total = w.dtot + T;
  return w;
}

// One pass over `blocks` blocks: three launches on `st`.
template <class Items>
int sort_pass(const Items& items, const int* n_total, long n, int shift,
              int bits, int blocks, const Work& wk, int* total, int* out,
              cudaStream_t st) {
  const int T = 1 << bits;
  const size_t smem = (size_t)WARPS * T * sizeof(int);
  bin_count_kernel<Items><<<blocks, WARPS * 32, smem, st>>>(
      items, n_total, n, shift, T, wk.wcount, wk.hist);
  bin_columns_kernel<<<(T + COLUMN_WARPS - 1) / COLUMN_WARPS,
                       COLUMN_WARPS * 32, 0, st>>>(wk.hist, blocks, T,
                                                   wk.dtot);
  bin_place_kernel<Items><<<blocks, WARPS * 32, smem, st>>>(
      items, n_total, n, shift, T, wk.wcount, wk.hist, wk.dtot, total, out);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace binsort
}  // namespace gf
