// K7: probabilistic Gaussian -> voxel splat, backward (of K4).
//
// Replaces: gaussianformer_tpu/ops/pallas/splat_bwd_kernel.py
//           splat_bwd_raw_pallas (kernel `_kernel`), reached through
//           ops/splat.py::_splat_bwd_pallas_batched, the VJP of the splat.
//
// Computes ops/splat.py::_splat_bwd_single (prob variant). Per voxel n the
// caller prepares gl[n] = covered g_logits / prob_sum and the scalars
// (dot_gl = gl . logits, bin_term = g_bin * one_minus, g_density). Per
// (voxel n, Gaussian g) pair inside g's integer AABB, with d = mu_g - x_n:
//   logit  = -1/2 d^T A_g d,  power = exp(min(logit, 30))
//   gprob  = gl[n] . sem_g - dot_gl[n]
//   gpower = g_density[n] + bin_term[n] / (1 - min(power, 1 - 1e-9) + 1e-9)
//            + gprob w_g                     w_g = (2 pi)^-1.5 sqrt(det A) opa
//   glogit = gpower power [logit < 30]
// and per Gaussian, summed over its pairs:
//   gw = sum gprob power;  gsem = sum power w_g gl[n]
//   gmu = -A sum glogit d;  gA = -1/2 sum glogit d_i d_j (diagonal),
//   -sum glogit d_i d_j (off-diagonal), plus the det(A) term of w_g:
//   gw opa (2 pi)^-1.5 / (2 sqrt(det A)) ddet/dA;  gopa = gw (2 pi)^-1.5
//   sqrt(det A).
// The moments are taken in d, not in world coordinates as the TPU kernel's
// phi(x) matmuls do, which avoids cancelling 1e3-sized terms in fp32.
//
// Bound on the H100: flops, about 60 + 4 C fp32 operations per AABB pair
// (the exponent, the C-wide dot and gsem sums, the nine moments); the bytes
// read are the per-voxel tables (gl [N, C] fp32 is 46 MB at flagship size).
//
// Design: the query points are the raster voxel grid (x slowest, z
// fastest), so a Gaussian's pairs are exactly the voxels of its clipped
// AABB and can be enumerated by raster index. One block per Gaussian walks
// them, each thread accumulating the moments, gw and gsem[C] in registers;
// a block reduction (shuffles, then shared memory) and one finishing thread
// fold them into gmu, gcov (with the det term), gopa and gsem. No atomics:
// every Gaussian's sums are reduced in a fixed order, so they are
// deterministic. The TPU kernel's Morton chunking and point tiling are not
// needed. The wrapper checks that the points are the raster grid.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float NORM_3D = 0.063493635934240969f;   // (2 pi)^-1.5

template <int MAXC>
__global__ void __launch_bounds__(THREADS)
splat_bwd_kernel(const float* __restrict__ pts,
                 const float* __restrict__ gdata,
                 const float* __restrict__ opa, const float* __restrict__ sem,
                 const int* __restrict__ box, const float* __restrict__ gl,
                 const float* __restrict__ scal, int P, int C, int GH,
                 int GW, int GD, float* __restrict__ gmu,
                 float* __restrict__ gopa, float* __restrict__ gsem,
                 float* __restrict__ gcov) {
  constexpr int NV = 10 + MAXC;   // 9 moments, gw, gsem[C]
  __shared__ float s_red[WARPS][NV];
  __shared__ float s_sem[MAXC];

  const int j = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const float* gd = gdata + 9 * (long)j;
  const float mx = gd[0], my = gd[1], mz = gd[2];
  const float a0 = gd[3], a1 = gd[4], a2 = gd[5];
  const float a3 = gd[6], a4 = gd[7], a5 = gd[8];
  const float det = a0 * a1 * a2 + 2.f * a3 * a4 * a5 - a0 * a4 * a4 -
                    a1 * a5 * a5 - a2 * a3 * a3;
  const float sqrt_det = sqrtf(fmaxf(det, 1e-30f));
  const float op = opa[j];
  const float w = NORM_3D * sqrt_det * op;
  if (tid < MAXC) s_sem[tid] = tid < C ? sem[(long)j * C + tid] : 0.f;

  const int* bx = box + 6 * (long)j;
  const int lo0 = max(bx[0], 0), lo1 = max(bx[1], 0), lo2 = max(bx[2], 0);
  const int e0 = min(bx[3], GH - 1) - lo0 + 1;
  const int e1 = min(bx[4], GW - 1) - lo1 + 1;
  const int e2 = min(bx[5], GD - 1) - lo2 + 1;
  const long count =
      (e0 > 0 && e1 > 0 && e2 > 0) ? (long)e0 * e1 * e2 : 0;
  __syncthreads();

  float acc[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) acc[v] = 0.f;

  for (long i = tid; i < count; i += THREADS) {
    const int iz = (int)(i % e2);
    const long r = i / e2;
    const int iy = (int)(r % e1);
    const int ix = (int)(r / e1);
    const long n = ((long)(lo0 + ix) * GW + (lo1 + iy)) * GD + (lo2 + iz);
    const float dx = mx - pts[3 * n];
    const float dy = my - pts[3 * n + 1];
    const float dz = mz - pts[3 * n + 2];
    const float logit =
        -0.5f * (a0 * dx * dx + a1 * dy * dy + a2 * dz * dz) -
        (a3 * dx * dy + a4 * dy * dz + a5 * dx * dz);
    const float power = expf(fminf(logit, 30.f));
    const float* gr = gl + n * C;
    float dot = 0.f;
#pragma unroll
    for (int c = 0; c < MAXC; ++c)
      if (c < C) dot += gr[c] * s_sem[c];
    const float gprob = dot - scal[3 * n];
    const float one_m = 1.f - fminf(power, 1.f - 1e-9f) + 1e-9f;
    const float gpower = scal[3 * n + 2] + scal[3 * n + 1] / one_m +
                         gprob * w;
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
    const float prob = power * w;
#pragma unroll
    for (int c = 0; c < MAXC; ++c)
      if (c < C) acc[10 + c] += prob * gr[c];
  }

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
    gmu[3 * (long)j] = -(a0 * t[0] + a3 * t[1] + a5 * t[2]);
    gmu[3 * (long)j + 1] = -(a3 * t[0] + a1 * t[1] + a4 * t[2]);
    gmu[3 * (long)j + 2] = -(a5 * t[0] + a4 * t[1] + a2 * t[2]);
    const float gw = t[9];
    gopa[j] = gw * NORM_3D * sqrt_det;
    const float gdet =
        det > 1e-30f ? gw * op * NORM_3D / (2.f * sqrt_det) : 0.f;
    // d det / d [xx, yy, zz, xy, yz, xz] of the compact symmetric layout
    const float dd[6] = {a1 * a2 - a4 * a4, a0 * a2 - a5 * a5,
                         a0 * a1 - a3 * a3, 2.f * (a4 * a5 - a2 * a3),
                         2.f * (a3 * a5 - a0 * a4), 2.f * (a3 * a4 - a1 * a5)};
    const float ga[6] = {-0.5f * t[3], -0.5f * t[4], -0.5f * t[5],
                         -t[6], -t[7], -t[8]};
#pragma unroll
    for (int e = 0; e < 6; ++e) gcov[6 * (long)j + e] = ga[e] + gdet * dd[e];
  }
  if (tid < C) gsem[(long)j * C + tid] = s_red[0][10 + tid];
}

template <int MAXC>
int launch(const float* pts, const float* gdata, const float* opa,
           const float* sem, const int* box, const float* gl,
           const float* scal, int P, int C, int GH, int GW, int GD,
           float* gmu, float* gopa, float* gsem, float* gcov,
           cudaStream_t st) {
  if (P == 0) return 0;
  splat_bwd_kernel<MAXC><<<P, THREADS, 0, st>>>(
      pts, gdata, opa, sem, box, gl, scal, P, C, GH, GW, GD, gmu, gopa, gsem,
      gcov);
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
    return launch<18>((const float*)pts, (const float*)gdata,
                      (const float*)opa, (const float*)sem, (const int*)box,
                      (const float*)gl, (const float*)scal, P, C, GH, GW, GD,
                      (float*)gmu, (float*)gopa, (float*)gsem, (float*)gcov,
                      st);
  return launch<32>((const float*)pts, (const float*)gdata, (const float*)opa,
                    (const float*)sem, (const int*)box, (const float*)gl,
                    (const float*)scal, P, C, GH, GW, GD, (float*)gmu,
                    (float*)gopa, (float*)gsem, (float*)gcov, st);
}
