// K2: masked farthest-point sampling, all selections in one launch.
//
// Replaces: gaussianformer_tpu/ops/pallas/fps_kernel.py
//           farthest_point_sampling_pallas (kernel `_kernel`).
//
// Computes ops/fps.py::farthest_point_sampling: seed at the first valid
// index (0 when none is valid); keep for every point the running minimum
// of its squared distance to the selected set (+inf at start, -inf for
// invalid points, which therefore stay -inf); each step selects the
// argmax, with FIRST-index tie-breaking (the TPU kernel takes the highest
// index; the reference op and the XLA path take the first).
//
// Bound on the H100: each step must read the running distances and update
// them, 129,600 points x 16 bytes = 2 MB, which is a few hundred ns at
// 3.35 TB/s and far less out of on-chip storage; the 4000 steps are
// sequential, so the kernel is bound by the latency of one step (a
// distance pass, a block reduction and a cross-block reduction), not by
// bytes or flops.
//
// Design: one thread-block cluster (16 blocks of 1024 threads where the
// card allows it, else 8) is the whole grid. Each block owns a contiguous
// slice of the points and keeps their coordinates and running distances in
// REGISTERS for the whole launch (PPT points per thread), so a step reads
// no memory at all. A step is: update distances, warp-shuffle argmax,
// block argmax through shared memory, then a cluster barrier and a read of
// every block's candidate through distributed shared memory (double
// buffered by step parity, so one cluster barrier per step suffices).
// Squared distances use __fmul_rn/__fadd_rn in the reference's order so
// they are bit-identical to the plain PyTorch version.
#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;

struct Cand {
  float d;
  int i;
  float x, y, z;
};

__device__ __forceinline__ bool better(float d, int i, float bd, int bi) {
  return d > bd || (d == bd && i < bi);
}

__device__ __forceinline__ void warp_argmax(Cand& c) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Cand o;
    o.d = __shfl_down_sync(0xffffffffu, c.d, off);
    o.i = __shfl_down_sync(0xffffffffu, c.i, off);
    o.x = __shfl_down_sync(0xffffffffu, c.x, off);
    o.y = __shfl_down_sync(0xffffffffu, c.y, off);
    o.z = __shfl_down_sync(0xffffffffu, c.z, off);
    if (better(o.d, o.i, c.d, c.i)) c = o;
  }
}

template <int PPT>
__global__ void __launch_bounds__(THREADS, 1)
fps_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ valid,
           const int* __restrict__ seed, int N, int S, int* __restrict__ out) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  __shared__ Cand s_warp[WARPS];
  __shared__ Cand s_slot[2];   // this block's candidate, by step parity
  __shared__ Cand s_sel;       // the step's global winner

  const int chunk = (N + csize - 1) / csize;
  const int base = rank * chunk;
  const int end = min(N, base + chunk);

  float px[PPT], py[PPT], pz[PPT], dist[PPT];
  bool ok[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = base + tid + k * THREADS;
    const bool in = i < end;
    px[k] = in ? pts[3 * (long)i] : 0.f;
    py[k] = in ? pts[3 * (long)i + 1] : 0.f;
    pz[k] = in ? pts[3 * (long)i + 2] : 0.f;
    ok[k] = in && (valid == nullptr || valid[i] != 0);
    dist[k] = ok[k] ? INFINITY : -INFINITY;
  }

  const int s0 = *seed;
  float lx = pts[3 * (long)s0];
  float ly = pts[3 * (long)s0 + 1];
  float lz = pts[3 * (long)s0 + 2];
  if (rank == 0 && tid == 0) out[0] = s0;

  for (int step = 1; step < S; ++step) {
    Cand c;
    c.d = -INFINITY;
    c.i = 0x7fffffff;
    c.x = c.y = c.z = 0.f;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int i = base + tid + k * THREADS;
      if (i >= end) continue;
      if (ok[k]) {
        const float dx = __fsub_rn(px[k], lx);
        const float dy = __fsub_rn(py[k], ly);
        const float dz = __fsub_rn(pz[k], lz);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                            __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        dist[k] = fminf(dist[k], d);
      }
      if (better(dist[k], i, c.d, c.i)) {
        c.d = dist[k];
        c.i = i;
        c.x = px[k];
        c.y = py[k];
        c.z = pz[k];
      }
    }
    warp_argmax(c);
    if (lane == 0) s_warp[warp] = c;
    __syncthreads();
    if (warp == 0) {
      Cand w = s_warp[lane];
      warp_argmax(w);
      if (lane == 0) s_slot[step & 1] = w;
    }
    cluster.sync();
    if (warp == 0) {
      Cand w;
      w.d = -INFINITY;
      w.i = 0x7fffffff;
      w.x = w.y = w.z = 0.f;
      if (lane < csize) w = *cluster.map_shared_rank(&s_slot[step & 1], lane);
      warp_argmax(w);
      if (lane == 0) {
        s_sel = w;
        if (rank == 0) out[step] = w.i;
      }
    }
    __syncthreads();
    lx = s_sel.x;
    ly = s_sel.y;
    lz = s_sel.z;
  }
  // no block may exit while another can still read its shared memory
  cluster.sync();
}

template <int PPT>
int launch(int csize, const float* pts, const uint8_t* valid, const int* seed,
           int N, int S, int* out, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, fps_kernel<PPT>, pts, valid,
                                       seed, N, S, out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Largest cluster (16, else 8) that can be resident with 1024-thread blocks.
int cluster_size() {
  static int cached = 0;
  if (cached) return cached;
  cudaFuncSetAttribute(fps_kernel<8>,
                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  for (int cs : {16, 8}) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cs);
    cfg.blockDim = dim3(THREADS);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, fps_kernel<8>, &cfg) ==
            cudaSuccess &&
        n > 0) {
      cached = cs;
      return cs;
    }
  }
  cudaGetLastError();  // clear a refused query
  cached = 8;
  return cached;
}

template <int PPT>
void allow_large_clusters() {
  cudaFuncSetAttribute(fps_kernel<PPT>,
                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

}  // namespace

// Cluster size the kernel launches with on this card (16 or 8).
GF_EXPORT int gf_fps_cluster_size() { return cluster_size(); }

// pts [N, 3] fp32; valid [N] uint8 or null; seed: one int32 on the device
// (the first valid index); out [S] int32. Returns a cudaError_t, or -1 when
// N needs more than 32 points per thread.
GF_EXPORT int gf_fps_forward(const void* pts, const void* valid,
                             const void* seed, int N, int S, void* out,
                             void* stream) {
  const int cs = cluster_size();
  const int per_thread = ((N + cs - 1) / cs + THREADS - 1) / THREADS;
  const float* p = (const float*)pts;
  const uint8_t* v = (const uint8_t*)valid;
  const int* s = (const int*)seed;
  int* o = (int*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (per_thread <= 1) {
    allow_large_clusters<1>();
    return launch<1>(cs, p, v, s, N, S, o, st);
  }
  if (per_thread <= 2) {
    allow_large_clusters<2>();
    return launch<2>(cs, p, v, s, N, S, o, st);
  }
  if (per_thread <= 4) {
    allow_large_clusters<4>();
    return launch<4>(cs, p, v, s, N, S, o, st);
  }
  if (per_thread <= 8) {
    allow_large_clusters<8>();
    return launch<8>(cs, p, v, s, N, S, o, st);
  }
  if (per_thread <= 16) {
    allow_large_clusters<16>();
    return launch<16>(cs, p, v, s, N, S, o, st);
  }
  if (per_thread <= 32) {
    allow_large_clusters<32>();
    return launch<32>(cs, p, v, s, N, S, o, st);
  }
  return -1;
}
