// The voxel tiles of the splat kernels K4 (splat.cu) and K7 (splat_bwd.cu)
// and the per-tile Gaussian lists they share (built by splat_bin.cu).
//
// A tile is a brick of TX x TY x TZ voxels of the raster grid (x slowest, z
// fastest); tiles are numbered in raster order too, and bricks at the grid's
// far edges are partial. A Gaussian has one entry for every tile that its
// box, clipped to the grid, meets. An entry is an int32: the Gaussian's
// index, with the sign bit (COVERS) set when the box holds every voxel of
// the (clipped) tile. The lists are tile-major, each tile's Gaussians in
// ascending index order, with each entry's position in the Gaussian-major
// order (its "slot": a Gaussian's entries are contiguous there, its tiles
// in raster order), so a per-entry result can be folded per Gaussian in a
// fixed order.
//
// Both kernels stage a tile's entries through shared memory in chunks, as
// records of 20 + SP words: the Gaussian's 9 gdata floats and its opacity
// (K7) padded to 12, its box lo xyz / hi xyz, the entry and its slot as 8
// ints, and its SP-float semantic row (a multiple of 4 floats), so that a
// record is read with 16-byte loads.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace gf {
namespace splat {

constexpr int TX = 8;
constexpr int TY = 8;
constexpr int TZ = 16;
constexpr int TILE_VOXELS = TX * TY * TZ;
constexpr int COVERS = (int)0x80000000u;
constexpr int INDEX_MASK = 0x7fffffff;

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// words of one staged entry record with a semantic row of SP floats
__host__ __device__ constexpr int record_words(int SP) { return 20 + SP; }

// A tile's origin (voxels) and its extent clipped to the grid.
struct Tile {
  int x0, y0, z0, ex, ey, ez;
};

__device__ __forceinline__ Tile tile_of(int t, int GH, int GW, int GD) {
  const int ntz = (GD + TZ - 1) / TZ;
  const int nty = (GW + TY - 1) / TY;
  Tile tl;
  tl.z0 = (t % ntz) * TZ;
  tl.y0 = ((t / ntz) % nty) * TY;
  tl.x0 = (t / (ntz * nty)) * TX;
  tl.ex = min(TX, GH - tl.x0);
  tl.ey = min(TY, GW - tl.y0);
  tl.ez = min(TZ, GD - tl.z0);
  return tl;
}

// 4-byte cp.async (global -> shared), cached in L1
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

// Issue the cp.async copies (and plain stores) that stage entries
// [first, first + count) of the tile-major list into `rec` (count records
// of record_words(SP) words). `opa` and `slot` may be null (the record's
// opacity / slot words are then left unset). SW: the semantic row's width.
template <int SP, int NT>
__device__ __forceinline__ void stage_entries(
    float* __restrict__ rec, const int* __restrict__ entries, int first,
    int count, const float* __restrict__ gdata, const float* __restrict__ opa,
    const int* __restrict__ box, const float* __restrict__ sem, int SW,
    const int* __restrict__ slot) {
  constexpr int R = record_words(SP);
  const int tid = threadIdx.x;
  int* irec = reinterpret_cast<int*>(rec);
  for (int idx = tid; idx < count * 16; idx += NT) {
    const int i = idx >> 4;
    const int f = idx & 15;
    const long g = entries[first + i] & INDEX_MASK;
    if (f < 9)
      cp_async4(rec + i * R + f, gdata + 9 * g + f);
    else if (f == 9) {
      if (opa != nullptr) cp_async4(rec + i * R + 9, opa + g);
    } else {
      cp_async4(irec + i * R + 12 + (f - 10), box + 6 * g + (f - 10));
    }
  }
  for (int idx = tid; idx < count * SW; idx += NT) {
    const int i = idx / SW;
    const int c = idx - i * SW;
    const long g = entries[first + i] & INDEX_MASK;
    cp_async4(rec + i * R + 20 + c, sem + SW * g + c);
  }
  for (int i = tid; i < count; i += NT) {
    irec[i * R + 18] = entries[first + i];
    irec[i * R + 19] = slot != nullptr ? slot[first + i] : 0;
  }
}

}  // namespace splat
}  // namespace gf
