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
// 3.35 TB/s and far less out of on-chip storage; the S steps are
// sequential, so the kernel is bound by the latency of one step (a
// distance pass, a block reduction and a cross-block exchange), not by
// bytes or flops. gf_fps_step_floor runs the exchange alone, S times over
// no points: the least a step of this design can take.
//
// Design: one thread-block cluster (16 blocks of 1024 threads where the
// card allows it, else 8) is the whole grid. Each block owns a contiguous
// slice of the points and keeps their coordinates and running distances in
// REGISTERS for the whole launch (PPT points per thread), so a step reads
// no device memory. Squared distances use __fsub_rn/__fmul_rn/__fadd_rn in
// the reference's order, so they are bit-identical to the plain version.
//
// A point's running distance is kept as one 32-bit ordered KEY:
// bits(d) + 1 for a valid point (d >= +0, whose bit patterns order as
// unsigned integers; +inf becomes 0x7f800001) and 0 for an invalid one
// (-inf), so the running minimum is an unsigned min, which leaves an
// invalid point at 0, and the argmax with first-index ties is: the largest
// key, then the smallest index among its holders. A warp owns 32 x PPT
// consecutive points; the wrapper orders the points spatially (Morton
// order), so each warp's box is compact, and passes each point's own index
// for the output and the ties. A step is
//  1. pruning: a warp skips its distance pass when the squared distance
//     from the new point to the box of its valid points, computed with the
//     pass's own operations, is at least the warp's largest running
//     distance. Rounding is monotonic, so then no point of the box gets a
//     smaller computed distance, no minimum changes, and the warp's record
//     of its last pass stands: exact, not approximate. Once the selected
//     points are spread, most warps skip most steps;
//  2. the distance pass: per point 3 sub, 3 mul, 2 add, the key's min, and
//     the thread's largest key;
//  3. per warp a REDUX max of the key; the lanes that hold it find their
//     smallest index among the slots that hold it (ties are rare, so the
//     pass itself carries no index), then a REDUX min of the index; the
//     winning lane picks its point's coordinates with an unrolled select
//     and writes its warp's record to shared memory;
//  4. one __syncthreads; warp 0 reduces the 32 warp records the same way
//     and PUSHES the block's record (key, index, x, y, z) into slot [rank]
//     of every block of the cluster: lane r stores into block r with
//     st.async, whose bytes complete a transaction on block r's mbarrier;
//  5. every thread waits on its own block's mbarrier until the cluster's
//     csize records have landed, then every warp reduces the slots from its
//     own shared memory: the new point reaches every thread with no remote
//     load, no cluster-wide barrier (a block waits for the records, not for
//     every thread of the cluster) and no further block barrier.
// Why the slots and the two mbarriers, both double-buffered by step
// parity, are safe: a block pushes its records of step s + 2 only after
// its wait of step s + 1, that is after every block's record of step s + 1
// landed; a block pushes that record only after its __syncthreads of step
// s + 1, which each of its threads reaches only after its wait on, and its
// reads of, the buffers of step s. The same holds for a warp's record in
// shared memory, read by warp 0 of its own block.
#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CLUSTER = 16;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NO_INDEX = 0xffffffffu;
// the key of a valid point that is not selected yet: bits(+inf) + 1
constexpr unsigned FAR_KEY = 0x7f800000u + 1u;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// the shared-memory address of `local` in block `rank` of the cluster
__device__ __forceinline__ unsigned cluster_addr(const void* local,
                                                 unsigned rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(local)), "r"(rank));
  return remote;
}

// bytes of one pushed record: (key, index, x, y) and z
constexpr int RECORD_BYTES = 20;

// Store a record (v, z) at `local` in block `rank`, each store completing
// its bytes on that block's mbarrier `bar` (asynchronous: the sender does
// not wait)
__device__ __forceinline__ void push_record(const void* local,
                                            const void* bar, unsigned rank,
                                            uint4 v, float z) {
  const unsigned dst = cluster_addr(local, rank);
  const unsigned mbar = cluster_addr(bar, rank);
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[%0], {%1, %2, %3, %4}, [%6];\n"
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
      "[%0 + 16], %5, [%6];\n" ::"r"(dst),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(__float_as_uint(z)),
      "r"(mbar)
      : "memory");
}

__device__ __forceinline__ void mbar_init(void* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// this block's one arrival on `bar`, expecting `bytes` more to land
__device__ __forceinline__ void mbar_expect(void* bar, unsigned bytes) {
  asm volatile(
      "{\n .reg .b64 state;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::
          "r"(smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// wait until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(void* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// one candidate: (key, index, x bits, y bits) and z
struct __align__(16) Record {
  uint4 kixy;
  float z;
};

// PPT points per thread; PPT == 0 runs the exchange alone (the floor).
// order[j] is the caller's index of point j (null: j itself); seed is the
// position of the seed in this order.
template <int PPT>
__global__ void __launch_bounds__(THREADS, 1)
fps_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ valid,
           const int* __restrict__ order, const int* __restrict__ seed, int N,
           int S, int* __restrict__ out) {
  constexpr int NP = PPT > 0 ? PPT : 1;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  __shared__ Record s_warp[WARPS];
  __shared__ Record s_slot[2][MAX_CLUSTER];  // by step parity, by rank
  // by step parity: complete when the step's csize records have landed
  __shared__ __align__(8) unsigned long long s_bar[2];
  if (tid == 0) {
    mbar_init(&s_bar[0], 1);
    mbar_init(&s_bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every block's barriers are set up before any record is pushed
  cluster_barrier();

  const int chunk = (N + csize - 1) / csize;
  const int end = min(N, (int)rank * chunk + chunk);
  // a warp owns 32 PPT consecutive points (compact when the caller orders
  // them spatially); slot k of a lane is point j0 + 32 k
  const int j0 = (int)rank * chunk + warp * 32 * PPT + lane;

  float px[NP], py[NP], pz[NP];
  unsigned key[NP];
  // the box of the warp's valid points (empty: +inf lower corner)
  float lo[3] = {INFINITY, INFINITY, INFINITY};
  float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int j = j0 + 32 * k;
    const bool in = j < end;
    px[k] = in ? pts[3 * (long)j] : 0.f;
    py[k] = in ? pts[3 * (long)j + 1] : 0.f;
    pz[k] = in ? pts[3 * (long)j + 2] : 0.f;
    // a slot past the block's points holds key 0 and no index
    const bool ok = in && (valid == nullptr || valid[j] != 0);
    key[k] = ok ? FAR_KEY : 0u;
    if (ok) {
      lo[0] = fminf(lo[0], px[k]); hi[0] = fmaxf(hi[0], px[k]);
      lo[1] = fminf(lo[1], py[k]); hi[1] = fmaxf(hi[1], py[k]);
      lo[2] = fminf(lo[2], pz[k]); hi[2] = fmaxf(hi[2], pz[k]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = fminf(lo[a], __shfl_xor_sync(FULL, lo[a], off));
      hi[a] = fmaxf(hi[a], __shfl_xor_sync(FULL, hi[a], off));
    }
  // the largest key of the warp's points, as of the last update
  unsigned wkey = 0u;
#pragma unroll
  for (int k = 0; k < PPT; ++k) wkey = max(wkey, key[k]);
  wkey = __reduce_max_sync(FULL, wkey);
  // the floor's records (a warp that holds points writes its own at step 1)
  if (lane == 0) {
    s_warp[warp].kixy = make_uint4(0u, NO_INDEX, 0u, 0u);
    s_warp[warp].z = 0.f;
  }
  __syncwarp();
  // the caller's index of each slot, in shared memory (a load from device
  // memory on every update would sit on the step's critical path)
  extern __shared__ unsigned s_index[];  // [PPT][THREADS] when order != null
  const int local = warp * 32 * PPT + lane;  // slot 0's place in the block
  if (order != nullptr) {
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int j = j0 + 32 * k;
      s_index[local + 32 * k] = j < end ? (unsigned)order[j] : NO_INDEX;
    }
  }
  // the caller's index of slot k
  auto index_of = [&](int k) -> unsigned {
    if (order != nullptr) return s_index[local + 32 * k];
    const int j = j0 + 32 * k;
    return PPT == 0 || j >= end ? NO_INDEX : (unsigned)j;
  };

  float lx = 0.f, ly = 0.f, lz = 0.f;
  if (PPT > 0) {
    const int s0 = *seed;
    lx = pts[3 * (long)s0];
    ly = pts[3 * (long)s0 + 1];
    lz = pts[3 * (long)s0 + 2];
    if (rank == 0 && tid == 0) out[0] = order != nullptr ? order[s0] : s0;
  }

  for (int step = 1; step < S; ++step) {
    // this block's barrier of the step's parity: its phase of two steps
    // ago is complete (every thread waited on it), so it takes this step's
    // records (they may land first: the count of bytes may go below zero)
    if (tid == 0) mbar_expect(&s_bar[step & 1], csize * RECORD_BYTES);
    // 1. pruning: the squared distance from the new point to the warp's
    // box, in the distance pass's operations. Rounding is monotonic, so no
    // point of the box gets a smaller computed distance; if that is at
    // least the warp's largest running distance, no minimum can change,
    // and the warp's record of the last update stands.
    const float ex = fmaxf(fmaxf(__fsub_rn(lo[0], lx), __fsub_rn(lx, hi[0])),
                           0.f);
    const float ey = fmaxf(fmaxf(__fsub_rn(lo[1], ly), __fsub_rn(ly, hi[1])),
                           0.f);
    const float ez = fmaxf(fmaxf(__fsub_rn(lo[2], lz), __fsub_rn(lz, hi[2])),
                           0.f);
    const float dbox = __fadd_rn(__fadd_rn(__fmul_rn(ex, ex),
                                           __fmul_rn(ey, ey)),
                                 __fmul_rn(ez, ez));
    // A warp without a valid point (wkey 0, an empty box) is pruned from
    // step 2 on: at step 1 it writes its record of key 0 and its first
    // index, which wins only when no point is valid at all.
    // (The floor, PPT == 0, tests its empty box too, so that the exchange
    // it times still ends in the new point's coordinates.)
    const bool prune =
        PPT == 0 ? dbox >= 0.f
                 : step > 1 && (wkey == 0u ||
                                __float_as_uint(dbox) + 1u >= wkey);
    if (!prune) {
      // 2. distances and this thread's largest key
      unsigned best = 0u;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const float dx = __fsub_rn(px[k], lx);
        const float dy = __fsub_rn(py[k], ly);
        const float dz = __fsub_rn(pz[k], lz);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                            __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        key[k] = min(key[k], __float_as_uint(d) + 1u);
        best = max(best, key[k]);
      }
      // 3. the warp's record: the lanes that hold the warp's largest key
      // find their smallest index among the slots that hold it (usually
      // one lane, one slot; the others' index is not needed)
      wkey = __reduce_max_sync(FULL, best);
      unsigned my_idx = NO_INDEX;
      int bk = 0;
      if (best == wkey) {
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          const unsigned idx = index_of(k);
          if (key[k] == best && idx < my_idx) {
            my_idx = idx;
            bk = k;
          }
        }
      }
      const unsigned widx =
          __reduce_min_sync(FULL, best == wkey ? my_idx : NO_INDEX);
      if (best == wkey && my_idx == widx) {
        float x = 0.f, y = 0.f, z = 0.f;
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          if (k == bk) {
            x = px[k];
            y = py[k];
            z = pz[k];
          }
        }
        s_warp[warp].kixy = make_uint4(wkey, widx, __float_as_uint(x),
                                       __float_as_uint(y));
        s_warp[warp].z = z;
      }
    }
    __syncthreads();

    // 4. the block's winner, pushed into slot [rank] of every block
    Record* slots = s_slot[step & 1];
    void* bar = &s_bar[step & 1];
    if (warp == 0) {
      const uint4 r = s_warp[lane].kixy;
      const unsigned bkey = __reduce_max_sync(FULL, r.x);
      const unsigned bidx =
          __reduce_min_sync(FULL, r.x == bkey ? r.y : NO_INDEX);
      const int wl =
          __ffs(__ballot_sync(FULL, r.x == bkey && r.y == bidx)) - 1;
      if (lane < csize)
        push_record(&slots[rank], bar, (unsigned)lane, s_warp[wl].kixy,
                    s_warp[wl].z);
    }

    // 5. the cluster's winner, in every warp
    mbar_wait(bar, ((step - 1) >> 1) & 1);
    uint4 r = make_uint4(0u, NO_INDEX, 0u, 0u);
    float rz = 0.f;
    if (lane < csize) {
      r = slots[lane].kixy;
      rz = slots[lane].z;
    }
    const unsigned ckey = __reduce_max_sync(FULL, r.x);
    const unsigned cidx =
        __reduce_min_sync(FULL, r.x == ckey ? r.y : NO_INDEX);
    const int cl = __ffs(__ballot_sync(FULL, r.x == ckey && r.y == cidx)) - 1;
    lx = __uint_as_float(__shfl_sync(FULL, r.z, cl));
    ly = __uint_as_float(__shfl_sync(FULL, r.w, cl));
    lz = __shfl_sync(FULL, rz, cl);
    if (rank == 0 && tid == 0) out[step] = (int)cidx;
  }
  // no block may exit while another can still write its shared memory
  cluster_barrier();
}

template <int PPT>
int launch(int csize, const float* pts, const uint8_t* valid,
           const int* order, const int* seed, int N, int S, int* out,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel<PPT>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  // the slots' indices: up to 128 KB at 32 points a thread
  const int smem = order != nullptr ? PPT * THREADS * 4 : 0;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        fps_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fps_kernel<PPT>, pts, valid, order, seed, N,
                           S, out);
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

}  // namespace

// Cluster size the kernel launches with on this card (16 or 8).
GF_EXPORT int gf_fps_cluster_size() { return cluster_size(); }

// pts [N, 3] fp32; valid [N] uint8 or null; order [N] int32, the caller's
// index of each point (null: its position), which the output and the
// tie-breaking use; seed: one int32 on the device, the position of the
// seed (the first valid point by the caller's index); out [S] int32, the
// caller's indices; csize: 8 or 16 blocks in the cluster (0: the card's
// default, gf_fps_cluster_size()). The result does not depend on the
// order; its time does, through the pruning (a spatial order makes the
// warps' boxes compact). Returns a cudaError_t, or -1 when N needs more
// than 32 points per thread.
GF_EXPORT int gf_fps_forward_ordered(const void* pts, const void* valid,
                                     const void* order, const void* seed,
                                     int N, int S, void* out, int csize,
                                     void* stream) {
  const int cs = csize ? csize : cluster_size();
  if (cs != 8 && cs != 16) return -1;
  const int per_thread = ((N + cs - 1) / cs + THREADS - 1) / THREADS;
  const float* p = (const float*)pts;
  const uint8_t* v = (const uint8_t*)valid;
  const int* o = (const int*)order;
  const int* s = (const int*)seed;
  int* r = (int*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (per_thread <= 1) return launch<1>(cs, p, v, o, s, N, S, r, st);
  if (per_thread <= 2) return launch<2>(cs, p, v, o, s, N, S, r, st);
  if (per_thread <= 4) return launch<4>(cs, p, v, o, s, N, S, r, st);
  if (per_thread <= 8) return launch<8>(cs, p, v, o, s, N, S, r, st);
  if (per_thread <= 16) return launch<16>(cs, p, v, o, s, N, S, r, st);
  if (per_thread <= 32) return launch<32>(cs, p, v, o, s, N, S, r, st);
  return -1;
}

// pts [N, 3] fp32; valid [N] uint8 or null; seed: one int32 on the device
// (the first valid index); out [S] int32. Returns a cudaError_t, or -1 when
// N needs more than 32 points per thread.
GF_EXPORT int gf_fps_forward(const void* pts, const void* valid,
                             const void* seed, int N, int S, void* out,
                             void* stream) {
  return gf_fps_forward_ordered(pts, valid, nullptr, seed, N, S, out, 0,
                                stream);
}

// The latency floor of a step: the kernel's exchange (the pruning test,
// the block and cluster reductions, the barriers, the pushes and the new
// point's broadcast) run S - 1 times over no points, with a cluster of `csize`
// blocks (0: the default). out [S] int32 takes its winners (no point's
// index: the values mean nothing). Never on the model's path, only timed.
GF_EXPORT int gf_fps_step_floor(int S, void* out, int csize, void* stream) {
  const int cs = csize ? csize : cluster_size();
  if (cs != 8 && cs != 16) return -1;
  return launch<0>(cs, nullptr, nullptr, nullptr, nullptr, 0, S, (int*)out,
                   (cudaStream_t)stream);
}
