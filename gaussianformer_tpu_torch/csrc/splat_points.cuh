// The query points of the splat kernels' general mode (splat_points.cu,
// splat_points_bwd.cu) and of their binning (splat_points_bin.cu): any
// points, in any number and order. A point's voxel is that of
// ops/splat.py::SplatGridSpec.voxelize (floor, clamped into the grid), so a
// point outside the range falls into a border voxel, as in the JAX
// package; its tile is the voxel's tile of splat_bin.cuh. The binning
// sorts the points stably by voxel, tile-major: by their key, the tile's
// index times TILE_VOXELS plus the voxel's place in the tile (local_code,
// z fastest), so that the points of one voxel are adjacent in input order
// and the points of any box within a tile are one run per (x, y) column.
// It writes each key's first sorted place (voxel_start, T * TILE_VOXELS +
// 1 words) and cuts each tile's points into work items of at most
// TILE_VOXELS. The Gaussians keep the tile bins of splat_bin.cu, and every
// point of a tile lies in that tile, so a COVERS entry holds all of
// them.
#pragma once

#include "splat_bin.cuh"

namespace gf {
namespace splat {

// The voxel grid: its corner, voxel edge and shape.
struct Grid {
  float pc[3];
  float gs;
  int GH, GW, GD;
};

inline Grid grid_of(const float* pc_min, float gs, int GH, int GW, int GD) {
  return Grid{{pc_min[0], pc_min[1], pc_min[2]}, gs, GH, GW, GD};
}

// point i's voxel (x, y, z), as SplatGridSpec.voxelize
__device__ __forceinline__ int3 voxel_of(const float* __restrict__ pts,
                                         long i, const Grid& g) {
  const int dims[3] = {g.GH, g.GW, g.GD};
  int v[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int q = (int)floorf((pts[3 * i + a] - g.pc[a]) / g.gs);
    v[a] = min(max(q, 0), dims[a] - 1);
  }
  return make_int3(v[0], v[1], v[2]);
}

__host__ __device__ __forceinline__ int tiles_of(const Grid& g) {
  return ((g.GH + TX - 1) / TX) * ((g.GW + TY - 1) / TY) *
         ((g.GD + TZ - 1) / TZ);
}

// the tile of a voxel, numbered as tile_of (splat_bin.cuh) reads it
__device__ __forceinline__ int tile_index(int3 v, const Grid& g) {
  const int nty = (g.GW + TY - 1) / TY, ntz = (g.GD + TZ - 1) / TZ;
  return (v.x / TX * nty + v.y / TY) * ntz + v.z / TZ;
}

// a voxel's place in its tile, packed: x (3 bits) | y (3 bits) | z (4 bits)
constexpr int CODE_X = 7, CODE_Y = 4, CODE_BITS = 10;
static_assert(TX == 8 && TY == 8 && TZ == 16, "the packing of local_code");
static_assert(TILE_VOXELS == 1 << CODE_BITS, "a key's place bits");

__device__ __forceinline__ int local_code(int3 v) {
  return (v.x % TX) << CODE_X | (v.y % TY) << CODE_Y | v.z % TZ;
}

// a point's sort key: its tile, then its voxel's place in the tile
__device__ __forceinline__ int point_key(int3 v, const Grid& g) {
  return tile_index(v, g) << CODE_BITS | local_code(v);
}

// the device's nanosecond clock (a block's start and end, for the share of
// its launch that the longest block takes)
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Whether the packed place `code` lies in the box [lo, hi] given in the
// tile's own voxel coordinates (either may reach past the tile).
__device__ __forceinline__ bool code_in(int code, int3 lo, int3 hi) {
  const int x = code >> CODE_X, y = (code >> CODE_Y) & (TY - 1),
            z = code & (TZ - 1);
  return x >= lo.x && x <= hi.x && y >= lo.y && y <= hi.y && z >= lo.z &&
         z <= hi.z;
}

}  // namespace splat
}  // namespace gf
