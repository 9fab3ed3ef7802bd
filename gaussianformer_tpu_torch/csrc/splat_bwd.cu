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
// Design: the query points are the raster voxel grid (x slowest, z
// fastest), so a Gaussian's pairs are exactly the voxels of its clipped
// AABB and can be enumerated by raster index. One block per Gaussian walks
// them, each thread accumulating the moments, gw and gsem[C] in registers;
// a block reduction (shuffles, then shared memory) and one finishing thread
// fold them into gmu, gcov, gopa and gsem. No atomics there: every
// Gaussian's sums are reduced in a fixed order, so they are deterministic
// (always so for prob). The TPU kernel's Morton chunking and point tiling
// are not needed. The wrapper checks that the points are the raster grid.
//
// Large boxes of the additive variant: the v1 head's empty Gaussian covers
// the whole grid (640,000 voxels) beside 25,600 boxes of 27-729 voxels, and
// one block walking it alone would be the kernel's tail. A Gaussian whose
// clipped box holds more than BIG_VOXELS voxels is not walked by its own
// block: the block zeroes its output rows and appends it to a device list,
// and a second launch on a fixed grid walks every listed box in segments of
// SEGMENT_VOXELS voxels, one block a segment. Every output is linear in the
// per-pair sums, so each segment folds its partial sums as a whole box would
// and adds them to the output rows with atomics (their order, and so the
// last bits of those rows, may change from run to run). No host read of
// the list: the second launch's grid strides over whatever the first found.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float NORM_3D = 0.063493635934240969f;   // (2 pi)^-1.5
constexpr long BIG_VOXELS = 8192;    // above this a box is walked in segments
constexpr long SEGMENT_VOXELS = 4096;  // 16 voxels a thread
constexpr int SEGMENT_GRID_X = 160;    // the whole 200 x 200 x 16 grid at once
constexpr int SEGMENT_GRID_Y = 4;

template <int MAXC>
struct Sums {
  static constexpr int NV = 10 + MAXC;   // 9 moments, gw, gsem[C]
};

struct Gaussian {
  float mx, my, mz, a0, a1, a2, a3, a4, a5, w;
  int lo0, lo1, lo2, e1, e2;
  long count;
};

template <bool PROB>
__device__ __forceinline__ Gaussian load_gaussian(
    const float* __restrict__ gdata, const float* __restrict__ opa,
    const int* __restrict__ box, int j, int GH, int GW, int GD,
    float* det_out, float* sqrt_det_out) {
  Gaussian g;
  const float* gd = gdata + 9 * (long)j;
  g.mx = gd[0], g.my = gd[1], g.mz = gd[2];
  g.a0 = gd[3], g.a1 = gd[4], g.a2 = gd[5];
  g.a3 = gd[6], g.a4 = gd[7], g.a5 = gd[8];
  const float det = g.a0 * g.a1 * g.a2 + 2.f * g.a3 * g.a4 * g.a5 -
                    g.a0 * g.a4 * g.a4 - g.a1 * g.a5 * g.a5 -
                    g.a2 * g.a3 * g.a3;
  const float sqrt_det = sqrtf(fmaxf(det, 1e-30f));
  *det_out = det;
  *sqrt_det_out = sqrt_det;
  g.w = PROB ? NORM_3D * sqrt_det * opa[j] : opa[j];
  const int* bx = box + 6 * (long)j;
  g.lo0 = max(bx[0], 0), g.lo1 = max(bx[1], 0), g.lo2 = max(bx[2], 0);
  const int e0 = min(bx[3], GH - 1) - g.lo0 + 1;
  g.e1 = min(bx[4], GW - 1) - g.lo1 + 1;
  g.e2 = min(bx[5], GD - 1) - g.lo2 + 1;
  g.count = (e0 > 0 && g.e1 > 0 && g.e2 > 0) ? (long)e0 * g.e1 * g.e2 : 0;
  return g;
}

// Adds the pairs of box voxels [first, last) (raster order inside the box),
// strided over the block's threads, to acc.
template <int MAXC, bool PROB>
__device__ __forceinline__ void walk(
    float (&acc)[Sums<MAXC>::NV], const Gaussian& g, long first, long last,
    const float* __restrict__ s_sem, const float* __restrict__ pts,
    const float* __restrict__ gl, const float* __restrict__ scal, int C,
    int GW, int GD) {
  for (long i = first + threadIdx.x; i < last; i += THREADS) {
    const int iz = (int)(i % g.e2);
    const long r = i / g.e2;
    const int iy = (int)(r % g.e1);
    const int ix = (int)(r / g.e1);
    const long n =
        ((long)(g.lo0 + ix) * GW + (g.lo1 + iy)) * GD + (g.lo2 + iz);
    const float dx = g.mx - pts[3 * n];
    const float dy = g.my - pts[3 * n + 1];
    const float dz = g.mz - pts[3 * n + 2];
    const float logit =
        -0.5f * (g.a0 * dx * dx + g.a1 * dy * dy + g.a2 * dz * dz) -
        (g.a3 * dx * dy + g.a4 * dy * dz + g.a5 * dx * dz);
    const float power = expf(fminf(logit, 30.f));
    const float* gr = gl + n * C;
    float dot = 0.f;
#pragma unroll
    for (int c = 0; c < MAXC; ++c)
      if (c < C) dot += gr[c] * s_sem[c];
    float gprob, gpower;
    if (PROB) {
      gprob = dot - scal[3 * n];
      const float one_m = 1.f - fminf(power, 1.f - 1e-9f) + 1e-9f;
      gpower = scal[3 * n + 2] + scal[3 * n + 1] / one_m + gprob * g.w;
    } else {
      gprob = dot;
      gpower = gprob * g.w;
    }
    const float glogit = logit < 30.f ? gpower * power : 0.f;
    acc[0] += glogit * dx;
    acc[1] += glogit * dy;
    acc[2] += glogit * dz;
    acc[3] += glogit * dx * dx;
    acc[4] += glogit * dy * dy;
    acc[5] += glogit * dz * dz;
    acc[6] += glogit * dx * dy;
    acc[7] += glogit * dy * dz;
    acc[8] += glogit * dx * dz;
    acc[9] += gprob * power;
    const float prob = power * g.w;
#pragma unroll
    for (int c = 0; c < MAXC; ++c)
      if (c < C) acc[10 + c] += prob * gr[c];
  }
}

// Block-reduces acc (fixed order) and folds the sums into Gaussian j's
// output rows: stored, or added with atomics when ATOMIC.
template <int MAXC, bool PROB, bool ATOMIC>
__device__ __forceinline__ void reduce_and_fold(
    float (&acc)[Sums<MAXC>::NV], float (*s_red)[Sums<MAXC>::NV],
    const Gaussian& g, float det, float sqrt_det, float op, int j, int C,
    float* __restrict__ gmu, float* __restrict__ gopa,
    float* __restrict__ gsem, float* __restrict__ gcov) {
  constexpr int NV = Sums<MAXC>::NV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    float s = acc[v];
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) s_red[warp][v] = s;
  }
  __syncthreads();
  if (tid < NV) {
    float s = 0.f;
#pragma unroll
    for (int wp = 0; wp < WARPS; ++wp) s += s_red[wp][tid];
    s_red[0][tid] = s;
  }
  __syncthreads();
  if (tid == 0) {
    const float* t = s_red[0];
    float out[10];
    out[0] = -(g.a0 * t[0] + g.a3 * t[1] + g.a5 * t[2]);
    out[1] = -(g.a3 * t[0] + g.a1 * t[1] + g.a4 * t[2]);
    out[2] = -(g.a5 * t[0] + g.a4 * t[1] + g.a2 * t[2]);
    const float gw = t[9];
    out[3] = PROB ? gw * NORM_3D * sqrt_det : gw;
    const float ga[6] = {-0.5f * t[3], -0.5f * t[4], -0.5f * t[5],
                         -t[6], -t[7], -t[8]};
    float gdet = 0.f;
    if (PROB && det > 1e-30f) gdet = gw * op * NORM_3D / (2.f * sqrt_det);
    // d det / d [xx, yy, zz, xy, yz, xz] of the compact symmetric layout
    const float dd[6] = {g.a1 * g.a2 - g.a4 * g.a4, g.a0 * g.a2 - g.a5 * g.a5,
                         g.a0 * g.a1 - g.a3 * g.a3,
                         2.f * (g.a4 * g.a5 - g.a2 * g.a3),
                         2.f * (g.a3 * g.a5 - g.a0 * g.a4),
                         2.f * (g.a3 * g.a4 - g.a1 * g.a5)};
#pragma unroll
    for (int e = 0; e < 6; ++e) out[4 + e] = ga[e] + gdet * dd[e];
    float* dst[10] = {gmu + 3 * (long)j,     gmu + 3 * (long)j + 1,
                      gmu + 3 * (long)j + 2, gopa + j,
                      gcov + 6 * (long)j,     gcov + 6 * (long)j + 1,
                      gcov + 6 * (long)j + 2, gcov + 6 * (long)j + 3,
                      gcov + 6 * (long)j + 4, gcov + 6 * (long)j + 5};
#pragma unroll
    for (int e = 0; e < 10; ++e) {
      if (ATOMIC)
        atomicAdd(dst[e], out[e]);
      else
        *dst[e] = out[e];
    }
  }
  if (tid < C) {
    if (ATOMIC)
      atomicAdd(gsem + (long)j * C + tid, s_red[0][10 + tid]);
    else
      gsem[(long)j * C + tid] = s_red[0][10 + tid];
  }
}

// One block per Gaussian. `big` (additive only): big[0] counts, big[1..]
// lists the Gaussians left to splat_bwd_segments.
template <int MAXC, bool PROB>
__global__ void __launch_bounds__(THREADS)
splat_bwd_kernel(const float* __restrict__ pts,
                 const float* __restrict__ gdata,
                 const float* __restrict__ opa, const float* __restrict__ sem,
                 const int* __restrict__ box, const float* __restrict__ gl,
                 const float* __restrict__ scal, int P, int C, int GH,
                 int GW, int GD, float* __restrict__ gmu,
                 float* __restrict__ gopa, float* __restrict__ gsem,
                 float* __restrict__ gcov, int* __restrict__ big) {
  constexpr int NV = Sums<MAXC>::NV;
  __shared__ float s_red[WARPS][NV];
  __shared__ float s_sem[MAXC];

  const int j = blockIdx.x;
  const int tid = threadIdx.x;
  float det, sqrt_det;
  const Gaussian g =
      load_gaussian<PROB>(gdata, opa, box, j, GH, GW, GD, &det, &sqrt_det);
  if (!PROB && g.count > BIG_VOXELS) {
    if (tid == 0) big[1 + atomicAdd(big, 1)] = j;
    if (tid < 3) gmu[3 * (long)j + tid] = 0.f;
    if (tid < 6) gcov[6 * (long)j + tid] = 0.f;
    if (tid == 0) gopa[j] = 0.f;
    if (tid < C) gsem[(long)j * C + tid] = 0.f;
    return;
  }
  if (tid < MAXC) s_sem[tid] = tid < C ? sem[(long)j * C + tid] : 0.f;
  __syncthreads();

  float acc[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) acc[v] = 0.f;
  walk<MAXC, PROB>(acc, g, 0, g.count, s_sem, pts, gl, scal, C, GW, GD);
  reduce_and_fold<MAXC, PROB, false>(acc, s_red, g, det, sqrt_det, opa[j], j,
                                     C, gmu, gopa, gsem, gcov);
}

// The listed large boxes of the additive variant, one block a segment of
// SEGMENT_VOXELS voxels; the grid strides over segments (x) and boxes (y).
template <int MAXC>
__global__ void __launch_bounds__(THREADS)
splat_bwd_segments(const float* __restrict__ pts,
                 const float* __restrict__ gdata,
                 const float* __restrict__ opa, const float* __restrict__ sem,
                 const int* __restrict__ box, const float* __restrict__ gl,
                 int C, int GH, int GW, int GD, float* __restrict__ gmu,
                 float* __restrict__ gopa, float* __restrict__ gsem,
                 float* __restrict__ gcov, const int* __restrict__ big) {
  constexpr int NV = Sums<MAXC>::NV;
  __shared__ float s_red[WARPS][NV];
  __shared__ float s_sem[MAXC];
  const int tid = threadIdx.x;
  const int n_big = big[0];
  for (int b = blockIdx.y; b < n_big; b += gridDim.y) {
    const int j = big[1 + b];
    float det, sqrt_det;
    const Gaussian g =
        load_gaussian<false>(gdata, opa, box, j, GH, GW, GD, &det, &sqrt_det);
    __syncthreads();   // the previous round's s_sem and s_red are read
    if (tid < MAXC) s_sem[tid] = tid < C ? sem[(long)j * C + tid] : 0.f;
    __syncthreads();
    for (long first = (long)blockIdx.x * SEGMENT_VOXELS; first < g.count;
         first += (long)gridDim.x * SEGMENT_VOXELS) {
      const long last =
          first + SEGMENT_VOXELS < g.count ? first + SEGMENT_VOXELS : g.count;
      float acc[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) acc[v] = 0.f;
      walk<MAXC, false>(acc, g, first, last, s_sem, pts, gl, nullptr, C, GW,
                        GD);
      __syncthreads();   // the previous segment's s_red is read
      reduce_and_fold<MAXC, false, true>(acc, s_red, g, det, sqrt_det, 0.f, j,
                                         C, gmu, gopa, gsem, gcov);
    }
  }
}

template <int MAXC, bool PROB>
int launch(const float* pts, const float* gdata, const float* opa,
           const float* sem, const int* box, const float* gl,
           const float* scal, int P, int C, int GH, int GW, int GD,
           float* gmu, float* gopa, float* gsem, float* gcov, int* big,
           cudaStream_t st) {
  if (P == 0) return 0;
  splat_bwd_kernel<MAXC, PROB><<<P, THREADS, 0, st>>>(
      pts, gdata, opa, sem, box, gl, scal, P, C, GH, GW, GD, gmu, gopa, gsem,
      gcov, big);
  cudaError_t err = cudaGetLastError();
  if (PROB || err != cudaSuccess) return (int)err;
  const dim3 grid(SEGMENT_GRID_X, SEGMENT_GRID_Y);
  splat_bwd_segments<MAXC><<<grid, THREADS, 0, st>>>(
      pts, gdata, opa, sem, box, gl, C, GH, GW, GD, gmu, gopa, gsem, gcov,
      big);
  return (int)cudaGetLastError();
}

}  // namespace

// pts [GH * GW * GD, 3] fp32, the raster voxel grid (x slowest, z fastest);
// gdata [P, 9] fp32 (mu, inverse covariance [xx, yy, zz, xy, yz, xz]);
// opa [P]; sem [P, C]; box [P, 6] int32 (voxel lo xyz, hi xyz); gl [N, C]
// and scal [N, 3] = (dot_gl, bin_term, g_density) fp32. Outputs gmu [P, 3],
// gopa [P], gsem [P, C], gcov [P, 6] fp32, fully written.
// Returns a cudaError_t, or -1 for C outside 2..32.
GF_EXPORT int gf_splat_backward(const void* pts, const void* gdata,
                                const void* opa, const void* sem,
                                const void* box, const void* gl,
                                const void* scal, int P, int C, int GH,
                                int GW, int GD, void* gmu, void* gopa,
                                void* gsem, void* gcov, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C < 2 || C > 32) return -1;
  if (C == 18)
    return launch<18, true>(
        (const float*)pts, (const float*)gdata, (const float*)opa,
        (const float*)sem, (const int*)box, (const float*)gl,
        (const float*)scal, P, C, GH, GW, GD, (float*)gmu, (float*)gopa,
        (float*)gsem, (float*)gcov, nullptr, st);
  return launch<32, true>(
      (const float*)pts, (const float*)gdata, (const float*)opa,
      (const float*)sem, (const int*)box, (const float*)gl,
      (const float*)scal, P, C, GH, GW, GD, (float*)gmu, (float*)gopa,
      (float*)gsem, (float*)gcov, nullptr, st);
}

// The additive variant: gl [N, C] is the logits cotangent itself, there are
// no per-voxel scalars, and `big` is an int32 scratch of P + 1 entries whose
// first entry the caller has set to 0 (the list of large boxes).
GF_EXPORT int gf_splat_backward_additive(
    const void* pts, const void* gdata, const void* opa, const void* sem,
    const void* box, const void* gl, int P, int C, int GH, int GW, int GD,
    void* gmu, void* gopa, void* gsem, void* gcov, void* big, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C < 2 || C > 32) return -1;
  if (C == 18)
    return launch<18, false>(
        (const float*)pts, (const float*)gdata, (const float*)opa,
        (const float*)sem, (const int*)box, (const float*)gl, nullptr, P, C,
        GH, GW, GD, (float*)gmu, (float*)gopa, (float*)gsem, (float*)gcov,
        (int*)big, st);
  return launch<32, false>(
      (const float*)pts, (const float*)gdata, (const float*)opa,
      (const float*)sem, (const int*)box, (const float*)gl, nullptr, P, C, GH,
      GW, GD, (float*)gmu, (float*)gopa, (float*)gsem, (float*)gcov,
      (int*)big, st);
}
