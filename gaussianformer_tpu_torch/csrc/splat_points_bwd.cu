// K7, general mode: Gaussian -> point splat, backward (of K4's general
// mode, splat_points.cu), at any query points, in both variants of the TPU
// kernel: `prob` (GaussianFormer-2) and `additive` (the v1 models).
//
// Replaces: gaussianformer_tpu/ops/pallas/splat_bwd_kernel.py
//           splat_bwd_raw_pallas (kernel `_kernel`), whose points are
//           always arbitrary: it has no raster mode.
//
// Computes splat_bwd.cu's per-Gaussian sums (the exponent's moments in
// d = mu - x, gw and gsem[C]) over every (point, Gaussian) pair inside the
// Gaussian's integer AABB, the point's voxel that of
// SplatGridSpec.voxelize (floor, clamped into the grid), with the same
// per-point cotangents (prob: gl = g_logits / prob_sum and the scalars
// dot_gl, bin_term, g_density; additive: gl = g_logits).
//
// Bound on the H100: flops, as splat_bwd.cu: about 60 + 4 C (prob) or
// 50 + 4 C (additive) fp32 operations a pair.
//
// Design: the points are binned by voxel tile (splat_points_bin.cu), the
// Gaussians keep their tile bins (splat_bin.cu, the forward's). One block
// per tile, the tiles with the most points first (a crowded border tile,
// where the points outside the range fall, starts early rather than last).
// The block loops over the tile's work items (runs of at most TILE_VOXELS
// of its points in input order): it copies the item's gl rows, scalars,
// coordinates and places in the tile into shared memory with cp.async,
// and gathers the item's bounds in the tile; then it walks the tile's
// entries, staged in chunks (a cp.async double buffer), warps taking the
// entries in turn. The lanes take the item's points 32 apart, test each
// point's place against the box (none for a COVERS entry; an entry whose
// box misses the item's bounds is skipped by its warp), sum the nine
// moments, gw and gsem[C] in registers, and one transposed warp reduction
// leaves sum v in lane v. The entry's slot of the workspace (its
// Gaussian-major place, as splat_bwd.cu's) takes the first item's sums and
// then adds each later item's, in item order, so the entry sums are
// carried across the items with no atomics and the workspace stays one
// row an entry however many points a tile holds. Then splat_bwd.cu's fold
// (gf_splat_backward's second launch) sums each Gaussian's slots in a
// fixed order and applies the closing math. Both launches are
// deterministic: a second call gives the same bits.
#include <math.h>

#include "splat_points.cuh"

namespace {

using namespace gf::splat;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 32;   // entries staged at once
constexpr float NORM_3D = 0.063493635934240969f;   // (2 pi)^-1.5

// groups of 32 per-entry sums (9 moments, gw, gsem[C]), one per lane each
template <int MAXC>
__host__ __device__ constexpr int sum_groups() {
  return (10 + MAXC + 31) / 32;
}

// One step of the transposed warp sum over v[B, B + 2 O): the lanes with
// bit O set keep the upper half (summed with their partner's), the others
// the lower half, in v[B, B + O). (The reduction of splat_bwd.cu.)
template <int O, int B, int N>
__device__ __forceinline__ void transpose_halve(float (&v)[N], int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = upper ? v[B + i] : v[B + i + O];
    const float keep = upper ? v[B + i + O] : v[B + i];
    v[B + i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
  if constexpr (O > 1) transpose_halve<O / 2, B, N>(v, lane);
}

// After it, lane L holds in out[k] the warp's total of v[32 k + L].
template <int G>
__device__ __forceinline__ void warp_transpose_sum(float (&v)[32 * G],
                                                   float (&out)[G]) {
  const int lane = threadIdx.x & 31;
  transpose_halve<16, 0, 32 * G>(v, lane);
  out[0] = v[0];
  if constexpr (G > 1) {
    transpose_halve<16, 32, 32 * G>(v, lane);
    out[1] = v[32];
  }
  static_assert(G <= 2, "at most 64 sums an entry");
}

template <int MAXC, bool PROB>
__global__ void __launch_bounds__(THREADS, MAXC <= 18 ? 2 : 1)
splat_points_bwd_kernel(const float* __restrict__ pts, Grid g,
                        const int* __restrict__ order,
                        const int* __restrict__ pt_start,
                        const int* __restrict__ tile_order,
                        const float* __restrict__ gdata,
                        const float* __restrict__ opa,
                        const float* __restrict__ sem,
                        const int* __restrict__ box,
                        const float* __restrict__ gl,
                        const float* __restrict__ scal, int c_arg,
                        const int* __restrict__ tile_start,
                        const int* __restrict__ entries,
                        const int* __restrict__ slot,
                        float* __restrict__ work) {
  constexpr int SP = round4(MAXC);
  constexpr int R = record_words(SP);
  constexpr int G = sum_groups<MAXC>();
  const int C = MAXC == 18 ? 18 : c_arg;
  const int WS = round4(10 + C);    // workspace row stride
  extern __shared__ __align__(16) float smem[];
  float* s_rec = smem;                                 // [2][CHUNK * R]
  // per point of the item (x, y, z, dot_gl) and (bin_term, g_density); its
  // gl row at a stride of C floats; its place in the tile
  float4* s_pt = reinterpret_cast<float4*>(s_rec + 2 * CHUNK * R);
  float2* s_sc = reinterpret_cast<float2*>(s_pt + TILE_VOXELS);
  float* s_gl = reinterpret_cast<float*>(s_sc + (PROB ? TILE_VOXELS : 0));
  unsigned short* s_code =
      reinterpret_cast<unsigned short*>(s_gl + TILE_VOXELS * C);
  __shared__ int s_bounds[6];

  const int tile = tile_order[blockIdx.x];
  const int first = tile_start[tile];
  const int total = tile_start[tile + 1] - first;
  if (total == 0) return;   // no entry: no slot to write
  const Tile tl = tile_of(tile, g.GH, g.GW, g.GD);
  const int p0 = pt_start[tile];
  const int np = pt_start[tile + 1] - p0;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nch = (total + CHUNK - 1) / CHUNK;
  // a tile without points still writes its slots (zeros)
  const int n_items = max((np + TILE_VOXELS - 1) / TILE_VOXELS, 1);

  for (int it = 0; it < n_items; ++it) {
    const int base = p0 + it * TILE_VOXELS;
    const int count = min(TILE_VOXELS, np - it * TILE_VOXELS);
    __syncthreads();   // the last item's points and records are read
    bounds_reset(s_bounds);
    __syncthreads();
    for (int idx = tid; idx < count * C; idx += THREADS) {
      const int l = idx / C;
      const int c = idx - l * C;
      const long n = order[base + l];
      cp_async4(s_gl + idx, gl + n * C + c);
    }
    for (int idx = tid; idx < count * 3; idx += THREADS) {
      const int l = idx / 3;
      const int a = idx - l * 3;
      const long n = order[base + l];
      float* pt = reinterpret_cast<float*>(s_pt + l);
      cp_async4(pt + a, pts + 3 * n + a);
      if (PROB) {
        float* sc = reinterpret_cast<float*>(s_sc + l);
        cp_async4(a == 0 ? pt + 3 : sc + a - 1, scal + 3 * n + a);
      }
    }
    for (int l = tid; l < count; l += THREADS) {
      const int code = local_code(voxel_of(pts, order[base + l], g));
      s_code[l] = (unsigned short)code;
      bounds_add(s_bounds, code);
    }

    stage_entries<SP, THREADS>(s_rec, entries, first, min(CHUNK, total),
                               gdata, opa, box, sem, C, slot);
    gf::cp_async_commit();
    for (int k = 0; k < nch; ++k) {
      if (k + 1 < nch) {
        const int f = first + (k + 1) * CHUNK;
        stage_entries<SP, THREADS>(s_rec + ((k + 1) & 1) * CHUNK * R,
                                   entries, f, min(CHUNK, first + total - f),
                                   gdata, opa, box, sem, C, slot);
      }
      gf::cp_async_commit();
      gf::cp_async_wait<1>();
      __syncthreads();
      const float* buf = s_rec + (k & 1) * CHUNK * R;
      const int cnt = min(CHUNK, total - k * CHUNK);
      for (int s = warp; s < cnt; s += WARPS) {
        const float* rec = buf + s * R;
        const int4 b0 = *reinterpret_cast<const int4*>(rec + 12);
        const int4 b1 = *reinterpret_cast<const int4*>(rec + 16);
        const bool covers = b1.z < 0;
        const int3 lo = make_int3(b0.x - tl.x0, b0.y - tl.y0, b0.z - tl.z0);
        const int3 hi = make_int3(b0.w - tl.x0, b1.x - tl.y0, b1.y - tl.z0);
        float* dst = work + (long)b1.w * WS;
        // uniform across the warp
        const bool skip = count <= 0 || (!covers && misses(s_bounds, lo, hi));
        if (skip) {
          if (it == 0)
            for (int v = lane; v < 10 + C; v += 32) dst[v] = 0.f;
          continue;
        }
        const float4 g0 = *reinterpret_cast<const float4*>(rec);
        const float4 g1 = *reinterpret_cast<const float4*>(rec + 4);
        const float4 g2 = *reinterpret_cast<const float4*>(rec + 8);
        const float mx = g0.x, my = g0.y, mz = g0.z;
        const float a0 = g0.w, a1 = g1.x, a2 = g1.y, a3 = g1.z, a4 = g1.w,
                    a5 = g2.x, op = g2.y;
        const float det = a0 * a1 * a2 + 2.f * a3 * a4 * a5 - a0 * a4 * a4 -
                          a1 * a5 * a5 - a2 * a3 * a3;
        const float w = PROB ? NORM_3D * sqrtf(fmaxf(det, 1e-30f)) * op : op;
        float sm[MAXC];
#pragma unroll
        for (int c = 0; c < MAXC; ++c) sm[c] = c < C ? rec[20 + c] : 0.f;

        float acc[32 * G];
#pragma unroll
        for (int v = 0; v < 32 * G; ++v) acc[v] = 0.f;
        for (int p = lane; p < count; p += 32) {
          if (!covers && !code_in(s_code[p], lo, hi)) continue;
          const float4 pt = s_pt[p];
          const float dx = mx - pt.x;
          const float dy = my - pt.y;
          const float dz = mz - pt.z;
          const float logit = -0.5f * (a0 * dx * dx + a1 * dy * dy +
                                       a2 * dz * dz) -
                              (a3 * dx * dy + a4 * dy * dz + a5 * dx * dz);
          const float power = expf(fminf(logit, 30.f));
          float gr[MAXC];
          if constexpr (MAXC % 2 == 0 && MAXC <= 18) {
            const float2* g2p = reinterpret_cast<const float2*>(s_gl + p * C);
#pragma unroll
            for (int c = 0; c < MAXC / 2; ++c) {
              const float2 q = g2p[c];
              gr[2 * c] = q.x;
              gr[2 * c + 1] = q.y;
            }
          } else {
#pragma unroll
            for (int c = 0; c < MAXC; ++c)
              gr[c] = c < C ? s_gl[p * C + c] : 0.f;
          }
          float dot = 0.f;
#pragma unroll
          for (int c = 0; c < MAXC; ++c)
            if (c < C) dot += gr[c] * sm[c];
          float gprob, gpower;
          if (PROB) {
            const float2 sc = s_sc[p];
            gprob = dot - pt.w;
            const float one_m = 1.f - fminf(power, 1.f - 1e-9f) + 1e-9f;
            gpower = sc.y + __fdividef(sc.x, one_m) + gprob * w;
          } else {
            gprob = dot;
            gpower = gprob * w;
          }
          const float glogit = logit < 30.f ? gpower * power : 0.f;
          const float gx = glogit * dx, gy = glogit * dy, gz = glogit * dz;
          acc[0] += gx;
          acc[1] += gy;
          acc[2] += gz;
          acc[3] += gx * dx;
          acc[4] += gy * dy;
          acc[5] += gz * dz;
          acc[6] += gx * dy;
          acc[7] += gy * dz;
          acc[8] += gx * dz;
          acc[9] += gprob * power;
          const float prob = power * w;
#pragma unroll
          for (int c = 0; c < MAXC; ++c)
            if (c < C) acc[10 + c] += prob * gr[c];
        }
        float tot[G];
        warp_transpose_sum<G>(acc, tot);
#pragma unroll
        for (int k2 = 0; k2 < G; ++k2) {
          const int v = 32 * k2 + lane;
          if (v < 10 + C) dst[v] = it == 0 ? tot[k2] : dst[v] + tot[k2];
        }
      }
      __syncthreads();   // the buffer is staged again two chunks on
    }
  }
}

template <int MAXC, bool PROB>
int launch(const float* pts, Grid g, const int* order, const int* pt_start,
           const int* tile_order, const float* gdata, const float* opa,
           const float* sem, const int* box, const float* gl,
           const float* scal, int C, const int* tile_start,
           const int* entries, const int* slot, float* work,
           cudaStream_t st) {
  constexpr int R = record_words(round4(MAXC));
  const int tiles = tiles_of(g);
  if (tiles == 0) return 0;
  const size_t smem =
      (size_t)(2 * CHUNK * R + TILE_VOXELS * (4 + (PROB ? 2 : 0) + C)) *
          sizeof(float) +
      TILE_VOXELS * sizeof(unsigned short);
  cudaError_t err = cudaFuncSetAttribute(
      splat_points_bwd_kernel<MAXC, PROB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  splat_points_bwd_kernel<MAXC, PROB><<<tiles, THREADS, smem, st>>>(
      pts, g, order, pt_start, tile_order, gdata, opa, sem, box, gl, scal, C,
      tile_start, entries, slot, work);
  return (int)cudaGetLastError();
}

}  // namespace

// pts [N, 3] fp32, any points; pc_min: 3 host floats; voxel grid (GH, GW,
// GD) of edge `gs`; the points' bins of splat_points_bin.cu (order [N],
// pt_start [T + 1], tile_order [T] int32); gdata [P, 9] fp32; opa [P]; sem
// [P, C]; box [P, 6] int32; gl [N, C] and scal [N, 3] = (dot_gl, bin_term,
// g_density) fp32; the Gaussians' bins of splat_bin.cu (tile_start [T + 1],
// entries [E], slot [E] int32); work [E, round4(10 + C)] fp32, each
// entry's sums over the tile's points, in its slot (then folded per
// Gaussian by gf_splat_backward with parts = 2). Returns a cudaError_t, or
// -1 for C outside 2..32.
GF_EXPORT int gf_splat_points_backward(
    const void* pts, const float* pc_min, float gs, int GH, int GW, int GD,
    const void* order, const void* pt_start, const void* tile_order,
    const void* gdata, const void* opa, const void* sem, const void* box,
    const void* gl, const void* scal, int C, const void* tile_start,
    const void* entries, const void* slot, void* work, void* stream) {
  if (C < 2 || C > 32) return -1;
  auto run = C == 18 ? launch<18, true> : launch<32, true>;
  return run((const float*)pts, grid_of(pc_min, gs, GH, GW, GD),
             (const int*)order, (const int*)pt_start,
             (const int*)tile_order, (const float*)gdata,
             (const float*)opa, (const float*)sem, (const int*)box,
             (const float*)gl, (const float*)scal, C,
             (const int*)tile_start, (const int*)entries, (const int*)slot,
             (float*)work, (cudaStream_t)stream);
}

// The additive variant: gl [N, C] is the logits cotangent itself and there
// are no per-point scalars.
GF_EXPORT int gf_splat_points_backward_additive(
    const void* pts, const float* pc_min, float gs, int GH, int GW, int GD,
    const void* order, const void* pt_start, const void* tile_order,
    const void* gdata, const void* opa, const void* sem, const void* box,
    const void* gl, int C, const void* tile_start, const void* entries,
    const void* slot, void* work, void* stream) {
  if (C < 2 || C > 32) return -1;
  auto run = C == 18 ? launch<18, false> : launch<32, false>;
  return run((const float*)pts, grid_of(pc_min, gs, GH, GW, GD),
             (const int*)order, (const int*)pt_start,
             (const int*)tile_order, (const float*)gdata,
             (const float*)opa, (const float*)sem, (const int*)box,
             (const float*)gl, nullptr, C, (const int*)tile_start,
             (const int*)entries, (const int*)slot, (float*)work,
             (cudaStream_t)stream);
}
