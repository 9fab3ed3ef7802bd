// The stable counting sort's ranking, shared by the splat's tile bins
// (splat_bin.cu) and the deformable backward's pixel bins
// (deformable_bin.cu).
//
// A sort walks its items in order, a warp at a time in rounds of 32 (lane
// order within a round). Each warp first counts its items of each key into
// its own row of shared counters (count_round, or shared int atomics: a
// count does not depend on the order), the rows are turned into
// first places (a scan over the earlier blocks and warps), and a second
// walk over the same items in the same order gives each item its place
// (place_round): its warp's next place for the key plus its rank among the
// round's earlier lanes with that key (__match_any_sync). Every place
// follows from the items' order alone, so no atomic decides an order and
// items of one key keep their order.
#pragma once

#include "common.cuh"

namespace gf {
namespace binrank {

// The exclusive prefix sum of v over the block's threads in order; every
// thread of the block calls it.
__device__ __forceinline__ int block_exclusive_sum(int v) {
  __shared__ int s_warp[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += s_warp[w];
  __syncthreads();   // s_warp may be written again
  return before + incl - v;
}

// One round of a warp's count: the lanes with `valid` add one to `wc[key]`
// (the warp's own counters). Every lane of the warp calls it.
__device__ __forceinline__ void count_round(bool valid, int key, int* wc) {
  const int lane = threadIdx.x & 31;
  const unsigned live = __ballot_sync(0xffffffffu, valid);
  if (valid) {
    const unsigned peers = __match_any_sync(live, key);
    if (lane == __ffs(peers) - 1) wc[key] += __popc(peers);
  }
  __syncwarp();
}

// One round of a warp's placing, on the warp's next place for each key
// (`wc`): returns the place of a lane with `valid` (-1 for the others) and
// moves the key's next place past the round's items. Every lane of the
// warp calls it.
__device__ __forceinline__ int place_round(bool valid, int key, int* wc) {
  const int lane = threadIdx.x & 31;
  const unsigned live = __ballot_sync(0xffffffffu, valid);
  int pos = -1;
  unsigned peers = 0;
  if (valid) {
    peers = __match_any_sync(live, key);
    pos = wc[key] + __popc(peers & ((1u << lane) - 1u));
  }
  __syncwarp();
  if (valid && lane == __ffs(peers) - 1) wc[key] += __popc(peers);
  __syncwarp();
  return pos;
}

}  // namespace binrank
}  // namespace gf
