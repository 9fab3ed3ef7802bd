// K7: Gaussian -> voxel splat, backward (of K4), in both variants of the TPU
// kernel: `prob` (GaussianFormer-2) and `additive` (the v1 models).
//
// Replaces: gaussianformer_tpu/ops/pallas/splat_bwd_kernel.py
//           splat_bwd_raw_pallas (kernel `_kernel`), reached through
//           ops/splat.py::_splat_bwd_pallas_batched, the VJP of the splat.
//
// Computes ops/splat.py::_splat_bwd_single. Per (voxel n, Gaussian g) pair
// inside g's integer AABB, with d = mu_g - x_n:
//   logit  = -1/2 d^T A_g d,  power = exp(min(logit, 30))
// prob: the caller prepares gl[n] = covered g_logits / prob_sum and the
// scalars (dot_gl = gl . logits, bin_term = g_bin * one_minus, g_density);
//   gprob  = gl[n] . sem_g - dot_gl[n]
//   gpower = g_density[n] + bin_term[n] / (1 - min(power, 1 - 1e-9) + 1e-9)
//            + gprob w_g                     w_g = (2 pi)^-1.5 sqrt(det A) opa
// additive: gl[n] = g_logits[n], no scalars;
//   gprob  = gl[n] . sem_g,  gpower = gprob w_g,  w_g = opa_g
// both:
//   glogit = gpower power [logit < 30]
// and per Gaussian, summed over its pairs:
//   gw = sum gprob power;  gsem = sum power w_g gl[n]
//   gmu = -A sum glogit d;  gA = -1/2 sum glogit d_i d_j (diagonal),
//   -sum glogit d_i d_j (off-diagonal); prob adds the det(A) term of w_g:
//   gw opa (2 pi)^-1.5 / (2 sqrt(det A)) ddet/dA, and gopa = gw (2 pi)^-1.5
//   sqrt(det A); additive has gopa = gw and no det term.
// The moments are taken in d, not in world coordinates as the TPU kernel's
// phi(x) matmuls do, which avoids cancelling 1e3-sized terms in fp32.
//
// Bound on the H100: flops, about 60 + 4 C (prob) or 50 + 4 C (additive)
// fp32 operations per AABB pair (the exponent, the C-wide dot and gsem
// sums, the nine moments), unless the boxes are so small that the bytes of
// the per-voxel table win (gl [N, C] fp32 is 46 MB at the 200 x 200 x 16
// grid).
//
// Design: the query points are the raster voxel grid, and the Gaussians are
// binned by voxel tile (splat_bin.cu; the forward's bins are reused). Two
// launches, no atomics, so both variants are deterministic:
//   1. one block per work item of the bins (a tile, the longest lists
//      first, or half the entries of one whose list is more than twice the
//      mean) copies the tile's gl rows, scal and pts into shared memory
//      once, with cp.async (a lane reads a gl row 8 bytes at a time, which
//      at C = 18 falls in distinct banks for neighbouring voxels), and
//      stages its entries in chunks (cp.async double buffer). Warps take
//      the entries in turn; the lanes enumerate the box's sub-brick of the tile directly (the whole
//      tile for a COVERS entry), each summing the nine moments, gw and
//      gsem[C] in registers as a per-Gaussian walk would; one transposed
//      warp reduction (31 shuffles for 32 sums) leaves sum v in lane v, and
//      the warp writes the entry's 10 + C sums to the entry's Gaussian-major
//      slot of a workspace;
//   2. the fold: a warp per Gaussian sums its slots (its tiles, in raster
//      order) in a fixed order (lane v adds value v slot after slot for a
//      short list, else the lanes take every 32nd slot and a transposed
//      warp sum follows) and applies the closing math (gmu, gopa, gsem,
//      gcov and, for prob, the det term).
// A box as large as the grid (the v1 head's empty Gaussian) is one entry
// per tile, like any other.
#include <math.h>

#include "splat_bin.cuh"

namespace {

using namespace gf::splat;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 32;   // entries staged at once
// a Gaussian with at most this many slots is folded slot after slot
constexpr int SHORT_FOLD = 16;
constexpr float NORM_3D = 0.063493635934240969f;   // (2 pi)^-1.5

// groups of 32 per-entry sums (9 moments, gw, gsem[C]), one per lane each
template <int MAXC>
__host__ __device__ constexpr int sum_groups() {
  return (10 + MAXC + 31) / 32;
}

// One step of the transposed warp sum over v[B, B + 2 O): the lanes with
// bit O set keep the upper half (summed with their partner's), the others
// the lower half, in v[B, B + O).
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

// After it, lane L holds in out[k] the warp's total of v[32 k + L]. A fixed
// tree of 31 shuffles a group: each step halves the values a lane keeps.
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
splat_bwd_tile_kernel(const float* __restrict__ pts,
                      const float* __restrict__ gdata,
                      const float* __restrict__ opa,
                      const float* __restrict__ sem,
                      const int* __restrict__ box,
                      const float* __restrict__ gl,
                      const float* __restrict__ scal, int c_arg, int GH,
                      int GW, int GD, const int* __restrict__ tile_start,
                      const int* __restrict__ tile_items,
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
  // per voxel (x, y, z, dot_gl) and (bin_term, g_density); its gl row at a
  // stride of C floats, read 8 bytes a lane (conflict-free for C = 18)
  float4* s_pt = reinterpret_cast<float4*>(s_rec + 2 * CHUNK * R);
  float2* s_sc = reinterpret_cast<float2*>(s_pt + TILE_VOXELS);
  float* s_gl = reinterpret_cast<float*>(s_sc + (PROB ? TILE_VOXELS : 0));

  const int tiles = ((GH + TX - 1) / TX) * ((GW + TY - 1) / TY) *
                    ((GD + TZ - 1) / TZ);
  if (blockIdx.x >= tile_items[2 * tiles]) return;
  const int item = tile_items[blockIdx.x];
  const int tile = item >> 2;
  const int half = item & 3;   // 0 all the tile's entries, 1 / 2 a half
  const Tile tl = tile_of(tile, GH, GW, GD);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // the tile's voxels, local index l = (lx * TY + ly) * TZ + lz
  for (int idx = tid; idx < TILE_VOXELS * C; idx += THREADS) {
    const int l = idx / C;
    const int c = idx - l * C;
    const int lx = l / (TY * TZ), ly = (l / TZ) % TY, lz = l % TZ;
    if (lx < tl.ex && ly < tl.ey && lz < tl.ez) {
      const long n = ((long)(tl.x0 + lx) * GW + tl.y0 + ly) * GD + tl.z0 + lz;
      gf::splat::cp_async4(s_gl + idx, gl + n * C + c);
    }
  }
  for (int idx = tid; idx < TILE_VOXELS * 3; idx += THREADS) {
    const int l = idx / 3;
    const int a = idx - l * 3;
    const int lx = l / (TY * TZ), ly = (l / TZ) % TY, lz = l % TZ;
    if (lx < tl.ex && ly < tl.ey && lz < tl.ez) {
      const long n = ((long)(tl.x0 + lx) * GW + tl.y0 + ly) * GD + tl.z0 + lz;
      float* pt = reinterpret_cast<float*>(s_pt + l);
      gf::splat::cp_async4(pt + a, pts + 3 * n + a);
      if (PROB) {
        float* sc = reinterpret_cast<float*>(s_sc + l);
        gf::splat::cp_async4(a == 0 ? pt + 3 : sc + a - 1, scal + 3 * n + a);
      }
    }
  }

  const int mid = (tile_start[tile + 1] - tile_start[tile]) / 2;
  const int first = tile_start[tile] + (half == 2 ? mid : 0);
  const int total =
      half == 1 ? mid : tile_start[tile + 1] - first;
  const int nch = (total + CHUNK - 1) / CHUNK;
  if (nch > 0)
    stage_entries<SP, THREADS>(s_rec, entries, first, min(CHUNK, total),
                               gdata, opa, box, sem, C, slot);
  gf::cp_async_commit();
  for (int k = 0; k < nch; ++k) {
    if (k + 1 < nch) {
      const int f = first + (k + 1) * CHUNK;
      stage_entries<SP, THREADS>(s_rec + ((k + 1) & 1) * CHUNK * R, entries,
                                 f, min(CHUNK, first + total - f), gdata, opa,
                                 box, sem, C, slot);
    }
    gf::cp_async_commit();
    gf::cp_async_wait<1>();
    __syncthreads();
    const float* buf = s_rec + (k & 1) * CHUNK * R;
    const int cnt = min(CHUNK, total - k * CHUNK);
    for (int s = warp; s < cnt; s += WARPS) {
      const float* rec = buf + s * R;
      const int4 b0 = *reinterpret_cast<const int4*>(rec + 12);  // lo, hi.x
      const int4 b1 = *reinterpret_cast<const int4*>(rec + 16);  // hi.yz, e
      // the box's sub-brick of the tile, in the tile's coordinates
      const int lo0 = max(b0.x - tl.x0, 0), hi0 = min(b0.w - tl.x0, tl.ex - 1);
      const int lo1 = max(b0.y - tl.y0, 0), hi1 = min(b1.x - tl.y0, tl.ey - 1);
      const int lo2 = max(b0.z - tl.z0, 0), hi2 = min(b1.y - tl.z0, tl.ez - 1);
      const int e1 = hi1 - lo1 + 1, e2 = hi2 - lo2 + 1;
      const int count = (hi0 - lo0 + 1) * e1 * e2;
      // exact for sub-bricks of up to 1024 voxels: the quotient's fraction
      // stays >= 1/32 from an integer
      const float inv1 = 1.f / (float)e1, inv2 = 1.f / (float)e2;

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
      // lane's voxel i = r e2 + iz of the sub-brick, r = ix e1 + iy; the
      // lanes step 32 voxels at a time
      const int step_r = (int)(32.5f * inv2), step_z = 32 - step_r * e2;
      int r = (int)(((float)lane + 0.5f) * inv2);
      int iz = lane - r * e2;
      for (int i = lane; i < count; i += 32) {
        const int ix = (int)(((float)r + 0.5f) * inv1);
        const int iy = r - ix * e1;
        const int l = ((lo0 + ix) * TY + lo1 + iy) * TZ + lo2 + iz;
        r += step_r;
        iz += step_z;
        if (iz >= e2) {
          iz -= e2;
          ++r;
        }
        const float4 pt = s_pt[l];
        const float dx = mx - pt.x;
        const float dy = my - pt.y;
        const float dz = mz - pt.z;
        const float logit = -0.5f * (a0 * dx * dx + a1 * dy * dy +
                                     a2 * dz * dz) -
                            (a3 * dx * dy + a4 * dy * dz + a5 * dx * dz);
        const float power = expf(fminf(logit, 30.f));
        float gr[MAXC];
        if constexpr (MAXC % 2 == 0 && MAXC <= 18) {
          const float2* g2 = reinterpret_cast<const float2*>(s_gl + l * C);
#pragma unroll
          for (int c = 0; c < MAXC / 2; ++c) {
            const float2 q = g2[c];
            gr[2 * c] = q.x;
            gr[2 * c + 1] = q.y;
          }
        } else {
#pragma unroll
          for (int c = 0; c < MAXC; ++c) gr[c] = c < C ? s_gl[l * C + c] : 0.f;
        }
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < MAXC; ++c)
          if (c < C) dot += gr[c] * sm[c];
        float gprob, gpower;
        if (PROB) {
          const float2 sc = s_sc[l];
          gprob = dot - pt.w;
          const float one_m = 1.f - fminf(power, 1.f - 1e-9f) + 1e-9f;
          // the hardware's reciprocal (2 ulp) in place of an IEEE division,
          // which cost a third of the launch; the exponent stays accurate
          // (the moments cancel, and __expf's error grows with |logit|)
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
      float* dst = work + (long)b1.w * WS;
#pragma unroll
      for (int k2 = 0; k2 < G; ++k2)
        if (32 * k2 + lane < 10 + C) dst[32 * k2 + lane] = tot[k2];
    }
    __syncthreads();   // the buffer is staged again two chunks on
  }
}

// A warp per Gaussian: its slots summed in order, then the closing math.
template <int MAXC, bool PROB>
__global__ void __launch_bounds__(THREADS)
splat_bwd_fold_kernel(const float* __restrict__ gdata,
                      const float* __restrict__ opa, int P, int c_arg,
                      const int* __restrict__ gauss_start,
                      const float* __restrict__ work,
                      float* __restrict__ gmu, float* __restrict__ gopa,
                      float* __restrict__ gsem, float* __restrict__ gcov) {
  constexpr int G = sum_groups<MAXC>();
  const int C = MAXC == 18 ? 18 : c_arg;
  const int WS = round4(10 + C);
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (j >= P) return;   // the whole warp
  const int first = gauss_start[j], end = gauss_start[j + 1];
  float tot[G];
  if (end - first <= SHORT_FOLD) {
    // lane v sums value v over the slots in order
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int v = 32 * k + lane;
      float s = 0.f;
      if (v < 10 + C)
        for (int e = first; e < end; ++e) s += work[(long)e * WS + v];
      tot[k] = s;
    }
  } else {
    // lane L sums slots L, L + 32, ...; then the transposed warp sum
    float acc[32 * G];
#pragma unroll
    for (int v = 0; v < 32 * G; ++v) acc[v] = 0.f;
    for (int e = first + lane; e < end; e += 32) {
      const float* row = work + (long)e * WS;
      if constexpr (MAXC == 18) {
#pragma unroll
        for (int q = 0; q < 7; ++q) {
          const float4 t = reinterpret_cast<const float4*>(row)[q];
          acc[4 * q] += t.x;
          acc[4 * q + 1] += t.y;
          acc[4 * q + 2] += t.z;
          acc[4 * q + 3] += t.w;
        }
      } else {
#pragma unroll
        for (int v = 0; v < 10 + MAXC; ++v)
          if (v < 10 + C) acc[v] += row[v];
      }
    }
    warp_transpose_sum<G>(acc, tot);
  }
  float t[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) t[i] = __shfl_sync(0xffffffffu, tot[0], i);
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const int c = 32 * k + lane - 10;
    if (c >= 0 && c < C) gsem[(long)j * C + c] = tot[k];
  }
  if (lane != 0) return;
  const float* gd = gdata + 9 * (long)j;
  const float a0 = gd[3], a1 = gd[4], a2 = gd[5], a3 = gd[6], a4 = gd[7],
              a5 = gd[8];
  const float det = a0 * a1 * a2 + 2.f * a3 * a4 * a5 - a0 * a4 * a4 -
                    a1 * a5 * a5 - a2 * a3 * a3;
  const float sqrt_det = sqrtf(fmaxf(det, 1e-30f));
  gmu[3 * (long)j] = -(a0 * t[0] + a3 * t[1] + a5 * t[2]);
  gmu[3 * (long)j + 1] = -(a3 * t[0] + a1 * t[1] + a4 * t[2]);
  gmu[3 * (long)j + 2] = -(a5 * t[0] + a4 * t[1] + a2 * t[2]);
  const float gw = t[9];
  gopa[j] = PROB ? gw * NORM_3D * sqrt_det : gw;
  const float ga[6] = {-0.5f * t[3], -0.5f * t[4], -0.5f * t[5],
                       -t[6], -t[7], -t[8]};
  float gdet = 0.f;
  if (PROB && det > 1e-30f) gdet = gw * opa[j] * NORM_3D / (2.f * sqrt_det);
  // d det / d [xx, yy, zz, xy, yz, xz] of the compact symmetric layout
  const float dd[6] = {a1 * a2 - a4 * a4, a0 * a2 - a5 * a5,
                       a0 * a1 - a3 * a3, 2.f * (a4 * a5 - a2 * a3),
                       2.f * (a3 * a5 - a0 * a4), 2.f * (a3 * a4 - a1 * a5)};
#pragma unroll
  for (int e = 0; e < 6; ++e) gcov[6 * (long)j + e] = ga[e] + gdet * dd[e];
}

template <int MAXC, bool PROB>
int launch(const float* pts, const float* gdata, const float* opa,
           const float* sem, const int* box, const float* gl,
           const float* scal, int P, int C, int GH, int GW, int GD,
           const int* tile_start, const int* tile_items, const int* entries,
           const int* slot,
           const int* gauss_start, float* work, float* gmu, float* gopa,
           float* gsem, float* gcov, int parts, cudaStream_t st) {
  constexpr int R = record_words(round4(MAXC));
  const int tiles = ((GH + TX - 1) / TX) * ((GW + TY - 1) / TY) *
                    ((GD + TZ - 1) / TZ);
  if ((parts & 1) && tiles > 0) {
    const size_t smem =
        (size_t)(2 * CHUNK * R + TILE_VOXELS * (4 + (PROB ? 2 : 0) + C)) *
        sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        splat_bwd_tile_kernel<MAXC, PROB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    splat_bwd_tile_kernel<MAXC, PROB><<<2 * tiles, THREADS, smem, st>>>(
        pts, gdata, opa, sem, box, gl, scal, C, GH, GW, GD, tile_start,
        tile_items, entries, slot, work);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if ((parts & 2) && P > 0) {
    splat_bwd_fold_kernel<MAXC, PROB><<<(P + WARPS - 1) / WARPS, THREADS, 0,
                                        st>>>(gdata, opa, P, C, gauss_start,
                                              work, gmu, gopa, gsem, gcov);
    return (int)cudaGetLastError();
  }
  return 0;
}

}  // namespace

// pts [GH * GW * GD, 3] fp32, the raster voxel grid (x slowest, z fastest);
// gdata [P, 9] fp32 (mu, inverse covariance [xx, yy, zz, xy, yz, xz]);
// opa [P]; sem [P, C]; box [P, 6] int32 (voxel lo xyz, hi xyz); gl [N, C]
// and scal [N, 3] = (dot_gl, bin_term, g_density) fp32; the bins of
// splat_bin.cu (tile_start [tiles + 1], tile_items [2 tiles + 1], entries
// [E], slot [E], gauss_start [P + 1], int32); work [E, round4(10 + C)] fp32
// scratch.
// Outputs gmu [P, 3], gopa [P], gsem [P, C], gcov [P, 6] fp32, fully
// written. `parts`: 3 runs both launches; 1 the tile launch alone, 2 the
// fold alone (for timing them apart). Returns a cudaError_t, or -1 for C
// outside 2..32.
GF_EXPORT int gf_splat_backward(
    const void* pts, const void* gdata, const void* opa, const void* sem,
    const void* box, const void* gl, const void* scal, int P, int C, int GH,
    int GW, int GD, const void* tile_start, const void* tile_items,
    const void* entries, const void* slot, const void* gauss_start,
    void* work, void* gmu, void* gopa, void* gsem, void* gcov, int parts,
    void* stream) {
  if (C < 2 || C > 32) return -1;
  auto run = C == 18 ? launch<18, true> : launch<32, true>;
  return run((const float*)pts, (const float*)gdata, (const float*)opa,
             (const float*)sem, (const int*)box, (const float*)gl,
             (const float*)scal, P, C, GH, GW, GD, (const int*)tile_start,
             (const int*)tile_items, (const int*)entries, (const int*)slot,
             (const int*)gauss_start, (float*)work, (float*)gmu,
             (float*)gopa, (float*)gsem, (float*)gcov, parts,
             (cudaStream_t)stream);
}

// The additive variant: gl [N, C] is the logits cotangent itself and there
// are no per-voxel scalars.
GF_EXPORT int gf_splat_backward_additive(
    const void* pts, const void* gdata, const void* opa, const void* sem,
    const void* box, const void* gl, int P, int C, int GH, int GW, int GD,
    const void* tile_start, const void* tile_items, const void* entries,
    const void* slot, const void* gauss_start, void* work, void* gmu,
    void* gopa, void* gsem, void* gcov, int parts, void* stream) {
  if (C < 2 || C > 32) return -1;
  auto run = C == 18 ? launch<18, false> : launch<32, false>;
  return run((const float*)pts, (const float*)gdata, (const float*)opa,
             (const float*)sem, (const int*)box, (const float*)gl, nullptr,
             P, C, GH, GW, GD, (const int*)tile_start, (const int*)tile_items,
             (const int*)entries, (const int*)slot, (const int*)gauss_start,
             (float*)work, (float*)gmu, (float*)gopa, (float*)gsem,
             (float*)gcov, parts, (cudaStream_t)stream);
}
