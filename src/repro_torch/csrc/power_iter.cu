// Power iteration for the top eigenpair of each stream's PSD Gram K, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/power_iter/kernel.py:42
// (power_iter_pallas, body _power_kernel), which held the whole (m, m) K
// in VMEM for every step.
//
// What it computes, for every stream b of an (S, m, m) f32 slab K:
// u₀ = 1/√m; `iters` times w = K u, u = w / √max(Σw², 1e-30) (or, with
// floor_norm != 0, w / max(‖w‖, 1e-30): the reference's inline krylov
// floor, repro/core/dsfd.py:200); then λ̂ = Σ (K u)·u.  -> λ̂ (S,), û (S, m)
//
// What bounds it on this card: the function needs K read once (m²·4 B a
// stream) and (iters + 1)·2m² operations, ~13 FLOP per byte at 24 steps,
// under the f32 ridge of 20: device memory bounds it.  But every step
// needs all of K, and at m = 256 one stream's K is 256 KB (1 MiB at
// m = 512), more than the 227 KB of shared memory a block may have; and
// the dump loop launches it over few streams at a time, so one CTA a
// stream leaves most SMs idle through `iters` dependent steps, each as
// long as its chain of latencies.
//
// Design.  Each stream gets a thread-block cluster of c CTAs (c ∈ {1, 2,
// 4, 8}, 8 the portable limit).  CTA r of the cluster owns rows
// [r·rows, (r + 1)·rows) of K, rows = ⌈m/c⌉, and copies them once into
// its shared memory with cp.async, at a row stride ld (m rounded up to 4,
// the pad zero).  A CTA has a warp for each 8 of its rows, up to 16.
// Every CTA keeps two whole vectors x, one for each step parity, each
// with an mbarrier.  u_t = x_t / n_t is never stored: step t reads x_t
// and sends x_{t+1} = K x_t / n_t (x₀ = u₀, n₀ = 1), which is K u_t up to
// rounding.  A step (the norm and the row groups of 1-2 are
// power_steps.cuh's, shared with fused_tick.cu):
// 1. every warp waits on its CTA's mbarrier for x_t (t ≥ 1); a warp with
//    rows (every warp at the last step) sums Σx_t² in one fixed order
//    (16-byte reads, lane-strided, then an xor butterfly, whose every lane
//    ends with the same bits), so all of them, in every CTA, get the
//    identical n_t; the loads of step 2 overlap it;
// 2. each warp takes 8 of the CTA's rows; a lane owns the columns
//    4·lane + 128·q and reads them with 16-byte loads of K's rows and of
//    x_t, then the warp reduces its 8 partial sums, halving the rows at
//    each shuffle level (9 shuffles), and divides them by n_t;
// 3. the lanes that hold a row send it to every CTA of the cluster,
//    itself included, with st.async into x_{t+1}'s buffer; the bytes
//    count on that buffer's mbarrier in the receiving CTA, whose thread 0
//    has announced the step's m·4.  No cluster barrier: a CTA waits only
//    for the data it needs;
// 4. one block barrier, so that no warp of a CTA falls a step behind (an
//    mbarrier phase is then never passed by a warp still waiting on it).
// Two buffers suffice: a CTA sends x_{t+2} only after it has received all
// of x_{t+1}, including every peer's slice, which each peer sent after it
// had read x_t from the buffer x_{t+2} overwrites.  After `iters` steps
// one more gives K û; rank 0 writes λ̂ = Σ (K û)_j û_j, every rank its
// own slice of û = x / n.  A cluster barrier at the start (every CTA runs
// and has initialised its mbarriers before a peer sends to it) and one at
// the end are the only two: a cluster barrier a step, after plain stores
// into the peers' shared memory, made each step markedly longer.
//
// The cluster size is a pure function of (m, S) and the card's limits
// (power_iter_plan; kernels/power_iter/kernel.py mirrors it): the smallest
// c whose rows of K fit a CTA's shared memory, then larger while c·S CTAs
// fit one wave of the card's SMs (a launch over few streams spreads each
// over up to 8 SMs), but not past ⌈m/8⌉ (8 rows a CTA).  At m = 256 K is
// held whole by c = 2 (128 KB a CTA), at m = 512 by c = 8.  Where even 8
// CTAs cannot hold their rows (m ≳ 640; the reference bounds m = 2ℓ ≤
// 512) a CTA keeps as many as fit and reads the rest from device memory
// at every step.  All arithmetic is plain f32 FMA, no TF32.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <mutex>
#include <set>
#include <tuple>

#include "power_steps.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxWarps = 16;       // a warp a group of rows, up to 16
constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr int kRowsPerCta = 8;      // no larger cluster than ⌈m/8⌉ CTAs
constexpr int kBarBytes = 16;       // the two mbarriers, before the floats

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Columns [j, j + 4) of a row of K in device memory, zeros past m;
// `vec`: rows are 16-byte aligned (m % 4 == 0 and K aligned).
__device__ __forceinline__ float4 global4(const float* __restrict__ row,
                                          int j, int m, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(row + j));
  float4 v;
  v.x = j < m ? __ldg(row + j) : 0.f;
  v.y = j + 1 < m ? __ldg(row + j + 1) : 0.f;
  v.z = j + 2 < m ? __ldg(row + j + 2) : 0.f;
  v.w = j + 3 < m ? __ldg(row + j + 3) : 0.f;
  return v;
}

__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n\t.reg .pred P;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P, [%1], "
        "%2;\n\tselp.u32 %0, 1, 0, P;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

__global__ void __launch_bounds__(kMaxWarps * 32)
power_iter_kernel(const float* __restrict__ K, float* __restrict__ lam_out,
                  float* __restrict__ u_out, int m, int ld, int rows, int R,
                  int iters, int floor_norm) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t bar0 = (uint32_t)__cvta_generic_to_shared(smem);
  float* sK = reinterpret_cast<float*>(smem + kBarBytes);  // R × ld
  float* sw = sK + (size_t)R * ld;                         // 2 × ld
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, nw = nt >> 5;
  const size_t b = blockIdx.x / c;
  const int r0 = rank * rows;                    // first row of this CTA
  const int nr = max(0, min(rows, m - r0));      // its rows
  const int nres = min(nr, R);                   // of them in shared memory
  const float* gK = K + (b * m + r0) * (size_t)m;
  const bool vec = m % 4 == 0 && (uintptr_t)K % 16 == 0;

  // this CTA's resident rows, zero-padded to ld columns
  if (vec) {
    const int per_row = ld / 4;
    for (int idx = tid; idx < nres * per_row; idx += nt) {
      const int i = idx / per_row, j = idx % per_row * 4;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                       (uint32_t)__cvta_generic_to_shared(sK + (size_t)i * ld + j)),
                   "l"(gK + (size_t)i * m + j)
                   : "memory");
    }
  } else {
    for (int idx = tid; idx < nres * ld; idx += nt) {
      const int i = idx / ld, j = idx % ld;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                       (uint32_t)__cvta_generic_to_shared(sK + (size_t)i * ld + j)),
                   "l"(j < m ? gK + (size_t)i * m + j : gK), "r"(j < m ? 4 : 0)
                   : "memory");
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  const float u0 = 1.0f / sqrtf((float)m);
  for (int j = tid; j < ld; j += nt) {
    sw[j] = j < m ? u0 : 0.f;  // x₀ = u₀
    sw[ld + j] = 0.f;          // the pad
  }
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar0)
                 : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar0 + 8)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  cluster_sync();  // every CTA runs, with its rows, x₀ and mbarriers

  // Step t reads x_t from sw[t & 1] and sends x_{t+1} = K x_t / n_t into
  // sw[(t + 1) & 1] of every CTA (n₀ = 1, x₀ = u₀), so u_t = x_t / n_t is
  // never stored.  x_t (t ≥ 1) is phase (t − 1) / 2 of mbarrier t & 1.
  const bool busy = warp * kGroup < nr;  // the warp has rows
  float nrm = 1.f;
  for (int t = 0; t <= iters; ++t) {
    const float* x = sw + (t & 1) * ld;
    const uint32_t bar = bar0 + 8 * ((t + 1) & 1);  // counts x_{t+1}
    if (t) __syncthreads();  // no warp is a step behind (see the wait)
    if (tid == 0)
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
          "r"(4 * m)
          : "memory");
    if (t) {
      wait_phase(bar0 + 8 * (t & 1), ((t - 1) >> 1) & 1);  // x_t landed
      if (busy || t == iters) nrm = norm(x, lane, ld, floor_norm);
    }
    // rows of this CTA (local numbering): resident in shared memory, or
    // (past R) read from device memory; each y_i goes into y[r0 + i] of
    // every CTA of the cluster, counted on the mbarrier at `bar` there
    const float* y = sw + ((t + 1) & 1) * ld;
    auto resident = [&](int i, int j) {
      return *reinterpret_cast<const float4*>(sK + (size_t)i * ld + j);
    };
    auto any_row = [&](int i, int j) {
      return i < R ? resident(i, j) : global4(gK + (size_t)i * m, j, m, vec);
    };
    auto send = [&](int i, float v) {
      v /= nrm;
      const uint32_t at = (uint32_t)__cvta_generic_to_shared(y + r0 + i);
      for (int p = 0; p < c; ++p) {
        uint32_t ra, rb;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                     : "=r"(ra) : "r"(at), "r"(p));
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                     : "=r"(rb) : "r"(bar), "r"(p));
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 "
            "[%0], %1, [%2];" ::"r"(ra), "f"(v), "r"(rb)
            : "memory");
      }
    };
    for (int g0 = warp * kGroup; g0 < nr; g0 += nw * kGroup) {
      if (g0 + kGroup <= nres)
        group_rows<true>(resident, any_row, x, g0, nr, ld, send);
      else
        group_rows<false>(resident, any_row, x, g0, nr, ld, send);
    }
  }
  wait_phase(bar0 + 8 * ((iters + 1) & 1), (iters >> 1) & 1);  // K u landed
  const float* x = sw + (iters & 1) * ld;  // û = x / n
  const float* y = sw + ((iters + 1) & 1) * ld;  // K û
  if (rank == 0 && warp == 0) {
    float lam = 0.f;
    for (int j = lane; j < m; j += 32) lam = fmaf(y[j], x[j] / nrm, lam);
    lam = warp_sum(lam);
    if (lane == 0) lam_out[b] = lam;
  }
  for (int i = tid; i < nr; i += nt)
    u_out[b * m + r0 + i] = x[r0 + i] / nrm;
  cluster_sync();  // no CTA leaves while a peer may still address it
}

struct Plan {
  int c, rows, resident;  // cluster size, rows a CTA, of them in smem
  size_t smem;            // dynamic shared memory a CTA
};

// The plan for a cluster of c CTAs over an (m, m) K, with `limit` bytes
// of shared memory a block: every CTA keeps the mbarriers and two x
// buffers, then as many of its rows as fit (resident −1: not even those).
Plan plan_with(int m, int c, long limit) {
  const long ld = (m + 3) / 4 * 4;
  const long fixed = kBarBytes + 4 * 2 * ld, row = 4 * ld;
  Plan p;
  p.c = c;
  p.rows = (m + c - 1) / c;
  const long fit = limit >= fixed ? (limit - fixed) / row : -1;
  p.resident = (int)(fit < p.rows ? fit : p.rows);
  p.smem = (size_t)(fixed + (p.resident < 0 ? 0 : p.resident) * row);
  return p;
}

// The plan for S streams on a card with `limit` bytes of shared memory a
// block and `sms` SMs (kernels/power_iter/kernel.py::cluster_plan).
Plan plan_for(int m, int S, long limit, int sms) {
  int c = 1;  // the smallest cluster that holds K
  while (c < kMaxCluster && plan_with(m, c, limit).resident < (m + c - 1) / c)
    c *= 2;
  int wide = 1;  // the widest cluster whose c·S CTAs fit one wave
  while (wide < kMaxCluster && 2L * wide * S <= sms) wide *= 2;
  int cap = 1;   // no cluster wider than ⌈m/8⌉ CTAs
  while (cap < kMaxCluster && 2L * cap * kRowsPerCta < m + kRowsPerCta)
    cap *= 2;
  if (wide > cap) wide = cap;
  return plan_with(m, wide > c ? wide : c, limit);
}

int device_plan(int m, int S, int device, Plan* p) {
  int smem = 0, sms = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  *p = plan_for(m, S, smem, sms);
  return p->resident < 0 ? (int)cudaErrorInvalidValue : 0;
}

// The (device, c, threads, smem) launch shapes that
// cudaOccupancyMaxActiveClusters has placed at least once: the check then
// costs a set lookup on later launches of the same shape.
std::mutex placed_mutex;
std::set<std::tuple<int, int, int, size_t>> placed;

int launch(const Plan& p, const float* K, float* lam_out, float* u_out,
           int S, int m, int iters, int floor_norm, int device,
           cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      power_iter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)p.smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(p.c * S));
  cfg.blockDim = dim3(32 * min(kMaxWarps, max(1, (p.rows + kGroup - 1) / kGroup)));
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a cluster that cannot be placed is refused, never run another way
  const auto shape = std::make_tuple(device, p.c, (int)cfg.blockDim.x, p.smem);
  {
    std::lock_guard<std::mutex> lock(placed_mutex);
    if (!placed.count(shape)) {
      int clusters = 0;
      e = cudaOccupancyMaxActiveClusters(&clusters, power_iter_kernel, &cfg);
      if (e != cudaSuccess) return (int)e;
      if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
      placed.insert(shape);
    }
  }
  const int ld = (m + 3) / 4 * 4;
  e = cudaLaunchKernelEx(&cfg, power_iter_kernel, K, lam_out, u_out, m, ld,
                         p.rows, p.resident, iters, floor_norm);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch plan for S streams of an (m, m) K on `device`: out[0] the
// cluster size c, out[1] the rows a CTA owns, out[2] the rows of them it
// keeps in shared memory.  Returns a cudaError_t (nonzero if the card's
// limits cannot be read or the mbarriers and x buffers do not fit).
int power_iter_plan(int m, int S, int device, int* out) {
  Plan p = {1, 0, -1, 0};
  const int err = device_plan(m, S, device, &p);
  out[0] = p.c;
  out[1] = p.rows;
  out[2] = p.resident;
  return err;
}

const char* power_iter_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int power_iter_topvec(const float* K, float* lam_out, float* u_out, int S,
                      int m, int iters, int floor_norm, int device,
                      void* stream) {
  Plan p;
  const int err = device_plan(m, S, device, &p);
  if (err) return err;
  return launch(p, K, lam_out, u_out, S, m, iters, floor_norm, device,
                (cudaStream_t)stream);
}

}  // extern "C"
