// The towers' frozen BatchNorm that follows a conv, with the residual add and
// the ReLU of the frame path, in one pass over the conv's output.
//
// Replaces no TPU kernel: the JAX package leaves the BN, the residual and
// the ReLU to XLA, which fuses them into its convolutions. The port's eager
// code (models/backbone/resnet.py, FrozenBatchNorm2d.forward and
// Bottleneck.forward) runs them as separate elementwise passes over each
// conv's bf16 output: x * inv, + shift, the ReLU, the residual add and the
// ReLU again, each reading and writing the whole activation, plus five small
// launches a BN for its coefficients.
//
// Computes, for every element of the conv's output a (channel c):
//   inv_a = rsqrt(var_a[c] + eps_a) * weight_a[c]
//   shift_a = bias_a[c] - mean_a[c] * inv_a           (FrozenBatchNorm2d's
//                                                      coeffs())
//   y = relu(a * inv_a + shift_a)                      FORM_RELU
//   y = relu(a * inv_a + shift_a + b)                  FORM_IDENTITY
//   y = relu(a * inv_a + shift_a + (b * inv_b + shift_b))   FORM_DOWNSAMPLE
// with b the block's identity input or its downsample conv's output, in
// fp32 in that order (each product and sum rounded on its own, no FMA, as
// the plain version's tensor operations are), rounded to bf16 once.
//
// Bound on the H100: memory. Each element is read once from a (and b) and
// written once, 4 or 6 bytes for about 3-6 flops: the largest calls of a
// Prob-64 tower (6 x 256 x 216 x 400 block ends) move 0.80 GB, 0.24 ms at
// 3.35 TB/s.
//
// Design: a bf16 channels-last (NHWC) tensor, C innermost, C % 8 == 0, read
// and written as 16-byte vectors of 8 channels. The grid's thread count is a
// multiple of C / 8, so a thread's vectors in its grid-stride loop all hold
// the same 8 channels: it computes their coefficients once, from the BN's
// own fp32 statistics, into registers, and the loop is loads, 8 to 24 fp32
// operations a vector and a store. Each thread keeps UNROLL vectors (and
// their residuals) in flight. The loads are streaming (evict-first): a conv
// output and a residual are dead after this pass. Measured on the H100 at a
// Prob-64 tower's largest calls: 0.83-0.85 of 3.35 TB/s; a grid of one
// resident wave, UNROLL 2 or 8, __ldg loads or evict-first stores each
// moved it by 2% or less.
#include "common.cuh"

namespace {

using namespace gf;

constexpr int FORM_RELU = 0;
constexpr int FORM_IDENTITY = 1;
constexpr int FORM_DOWNSAMPLE = 2;
constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;   // 2048 threads, an SM's limit
constexpr int UNROLL = 4;

__device__ __forceinline__ void coeffs(const float* __restrict__ weight,
                                       const float* __restrict__ bias,
                                       const float* __restrict__ mean,
                                       const float* __restrict__ var,
                                       float eps, int c0, float* inv,
                                       float* shift) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float s = __fmul_rn(rsqrtf(__fadd_rn(var[c0 + i], eps)),
                              weight[c0 + i]);
    inv[i] = s;
    shift[i] = __fsub_rn(bias[c0 + i], __fmul_rn(mean[c0 + i], s));
  }
}

__device__ __forceinline__ void unpack(uint4 raw, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

template <int FORM>
__global__ void __launch_bounds__(THREADS)
bn_epilogue_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                   const float* __restrict__ wa, const float* __restrict__ ba,
                   const float* __restrict__ ma, const float* __restrict__ va,
                   float eps_a, const float* __restrict__ wb,
                   const float* __restrict__ bb, const float* __restrict__ mb,
                   const float* __restrict__ vb, float eps_b,
                   uint4* __restrict__ out, long long vectors, int groups) {
  const long long first = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  if (first >= vectors) return;
  // the stride is a multiple of groups: every vector of this thread holds
  // channels c0 .. c0 + 7
  const int c0 = (int)(first % groups) * 8;
  float inv_a[8], shift_a[8], inv_b[8], shift_b[8];
  coeffs(wa, ba, ma, va, eps_a, c0, inv_a, shift_a);
  if constexpr (FORM == FORM_DOWNSAMPLE)
    coeffs(wb, bb, mb, vb, eps_b, c0, inv_b, shift_b);

  for (long long v0 = first; v0 < vectors; v0 += UNROLL * stride) {
    uint4 ra[UNROLL], rb[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long v = v0 + u * stride;
      if (v < vectors) {
        ra[u] = __ldcs(a + v);
        if constexpr (FORM != FORM_RELU) rb[u] = __ldcs(b + v);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long v = v0 + u * stride;
      if (v >= vectors) break;
      float x[8], y[8];
      unpack(ra[u], x);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        y[i] = __fadd_rn(__fmul_rn(x[i], inv_a[i]), shift_a[i]);
      if constexpr (FORM != FORM_RELU) {
        unpack(rb[u], x);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float r =
              FORM == FORM_DOWNSAMPLE
                  ? __fadd_rn(__fmul_rn(x[i], inv_b[i]), shift_b[i])
                  : x[i];
          y[i] = __fadd_rn(y[i], r);
        }
      }
      uint4 packed;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        h[i] = __floats2bfloat162_rn(fmaxf(y[2 * i], 0.f),
                                     fmaxf(y[2 * i + 1], 0.f));
      out[v] = packed;
    }
  }
}

int gcd(int x, int y) {
  while (y) {
    const int t = x % y;
    x = y;
    y = t;
  }
  return x;
}

// Up to BLOCKS_PER_SM blocks an SM, in a multiple of q = groups /
// gcd(groups, THREADS) so that the grid's thread count is a multiple of
// groups.
template <int FORM>
int launch(const uint4* a, const uint4* b, const float* const* bn_a,
           float eps_a, const float* const* bn_b, float eps_b, uint4* out,
           long long vectors, int groups, cudaStream_t stream) {
  const int q = groups / gcd(groups, THREADS);
  long long blocks = (vectors + THREADS - 1) / THREADS;
  const long long most = (long long)BLOCKS_PER_SM * sm_count();
  if (blocks > most) blocks = most;
  blocks = (blocks + q - 1) / q * q;
  if (blocks > 0x7fffffffLL) return -1;
  bn_epilogue_kernel<FORM><<<(unsigned)blocks, THREADS, 0, stream>>>(
      a, b, bn_a[0], bn_a[1], bn_a[2], bn_a[3], eps_a, bn_b[0], bn_b[1],
      bn_b[2], bn_b[3], eps_b, out, vectors, groups);
  return (int)cudaGetLastError();
}

}  // namespace

// a, b, out: bf16, n elements in channels-last order (C innermost), 16-byte
// aligned; b null (FORM_RELU) or the residual. The BN of a: weight_a,
// bias_a, mean_a, var_a fp32 [C] and eps_a; weight_b.. of b's BN, or null
// for a residual added as it is. Requires C % 8 == 0 and n % C == 0.
GF_EXPORT int gf_bn_epilogue(const void* a, const void* b,
                             const void* weight_a, const void* bias_a,
                             const void* mean_a, const void* var_a,
                             float eps_a, const void* weight_b,
                             const void* bias_b, const void* mean_b,
                             const void* var_b, float eps_b, void* out,
                             long long n, int C, void* stream) {
  if (C <= 0 || C % 8 != 0 || n % C != 0) return -1;
  if (b == nullptr && weight_b != nullptr) return -1;
  const long long vectors = n / 8;
  if (vectors == 0) return 0;
  const float* bn_a[4] = {(const float*)weight_a, (const float*)bias_a,
                          (const float*)mean_a, (const float*)var_a};
  const float* bn_b[4] = {(const float*)weight_b, (const float*)bias_b,
                          (const float*)mean_b, (const float*)var_b};
  const uint4* pa = (const uint4*)a;
  const uint4* pb = (const uint4*)b;
  const cudaStream_t s = (cudaStream_t)stream;
  if (b == nullptr)
    return launch<FORM_RELU>(pa, pb, bn_a, eps_a, bn_b, eps_b, (uint4*)out,
                             vectors, C / 8, s);
  if (weight_b == nullptr)
    return launch<FORM_IDENTITY>(pa, pb, bn_a, eps_a, bn_b, eps_b,
                                 (uint4*)out, vectors, C / 8, s);
  return launch<FORM_DOWNSAMPLE>(pa, pb, bn_a, eps_a, bn_b, eps_b,
                                 (uint4*)out, vectors, C / 8, s);
}
