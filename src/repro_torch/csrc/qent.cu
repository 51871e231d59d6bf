// Fused multi-eps quantize + hashed histogram (the q-ent predictor),
// for Hopper.
//
// Replaces: src/repro/kernels/qent/qent.py, qent_histogram_sweep, and
// the pad-and-subtract correction of kernels/qent/ops.py (nothing is
// padded here: each cluster masks its own element range, so the
// histogram is the same without a correction).
//
// For slice s, error bound eps[e] and element v:
//   code = (int) clip(floorf(v / eps), INT32_CODE_MIN, INT32_CODE_MAX)
//   bin  = code mod bins, taken positive
//   hist[s, e, bin] += 1
// The division is __fdiv_rn (IEEE, correctly rounded), matching the
// reference's jitted x / eps bit for bit; a reciprocal multiply would
// move floor codes.  x holds no subnormal (the port's entry points flush
// the data, quant.flush_subnormals); a subnormal quotient reads as a
// signed zero, as in the reference (flush.cuh): a negative one would
// otherwise floor to code -1.
//
// Bound on the card: bytes, by the data sheet (4 bytes read per element,
// a handful of operations per eps); in practice the rate of the
// division, the hashing and above all the shared-memory adds, once per
// (element, eps).  The TPU kernel compares codes to a bin iota because
// VMEM has no scatter; here the histogram lives in shared memory.  65536
// int32 bins take 256 KiB, more than one block's 227 KB, so a thread
// block cluster holds them in distributed shared memory:
//   * a cluster of C CTAs owns the histogram of one (slice, eps group,
//     element run): with 65536 bins C = 2 and each CTA holds 32768 bins
//     (128 KiB) of one eps; with bins that fit one CTA (4096, the
//     default; 3000) C = 1 and a CTA holds up to 8 eps side by side, so
//     it reads each element once for all of them.  Bins beyond what 8
//     CTAs hold are taken in passes over the bin range;
//   * the CTAs of a cluster split the run's elements in batches of 8192
//     each and quantize each element once per eps.  A count for a bin
//     the CTA owns is added to its shared memory; any other is appended
//     to the CTA's outbox.  After a cluster barrier each CTA reads the
//     other CTAs' outboxes through cooperative_groups::this_cluster().
//     map_shared_rank and adds the entries it owns.  Coalesced reads of
//     distributed shared memory take the place of an atomicAdd through
//     map_shared_rank for half the elements, which limited an earlier
//     version of this kernel.  Two outboxes alternate, so one cluster
//     barrier a batch keeps a batch's writer and its readers apart;
//   * hot bins (cesm-cloud's clear-sky zeros send a large share of every
//     slice to one bin): in a cluster, a run of lanes of a warp that hit
//     the same bin (found with one shuffle and one ballot) becomes one
//     add or one outbox entry of its length (__match_any_sync, which
//     finds every lane of a bin, cost more than it saved in an earlier
//     version).  A lone CTA adds with plain shared atomics, which were
//     faster there than either way of aggregating;
//   * bins a power of two (65536, 4096): code & (bins - 1) is the
//     positive remainder, so no integer `%`; other bins keep it;
//   * grid: the cluster index runs element run -> bin pass -> eps group,
//     eps fastest, so the clusters that read one element run for the
//     eps of a slice run together and re-read it from L2, not device
//     memory; the number of runs is chosen from the co-resident cluster
//     count (cudaOccupancyMaxActiveClusters) so that k = 32 x 6 eps and
//     k = 1 x 1 eps both fill the card in whole waves, with at least
//     MIN_PER_CTA elements a CTA (16384; a build with
//     -DREPRO_QENT_MIN_PER_CTA=n is a candidate of the offline search in
//     kernels/tune.py, which found no other value faster on the H100);
//   * at the end each CTA adds its non-zero bins to the global histogram
//     with atomicAdd: one flush per cluster, however many elements.
// Integer counts make every schedule give the same histogram bits.  If
// the cluster cannot be placed, the entry point returns the error and
// the wrapper raises: there is no other route on the card.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "flush.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float CODE_MIN = -2147483648.0f;
constexpr float CODE_MAX = 2147483520.0f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 1024;
constexpr int UNROLL = 8;           // elements in flight per thread
constexpr int BATCH = THREADS * UNROLL;    // elements a CTA takes per batch
constexpr int MAX_CLUSTER = 8;      // portable cluster size
constexpr int MAX_EPS = 8;          // eps one CTA holds side by side
#ifndef REPRO_QENT_MIN_PER_CTA
#define REPRO_QENT_MIN_PER_CTA 16384
#endif
constexpr long long MIN_PER_CTA = REPRO_QENT_MIN_PER_CTA;  // elements a
                                    // CTA takes at least
constexpr int CNT_BITS = 6;         // an outbox entry: slot << 6 | count
constexpr int MAX_SMEM_INTS = 232448 / 4;  // shared memory of one CTA

struct Plan {
  int cluster;      // CTAs per cluster
  int eps_per;      // eps per cluster (1 when cluster > 1)
  int groups;       // eps groups
  int passes;       // bin passes
  int bins_pass;    // bins per pass
  int per_cta;      // counter slots per CTA
};

// floor(v / eps) saturated to int32, hashed into [0, bins), as a slot of
// this cluster's counters (-1: outside this bin pass).
template <bool POW2>
__device__ __forceinline__ int slot_of(float v, float eps, int bins,
                                       int lo_bin, int width, int ei) {
  float q = floorf(ftz(__fdiv_rn(v, eps)));
  q = fminf(fmaxf(q, CODE_MIN), CODE_MAX);
  const int code = (int)q;
  int b;
  if (POW2) {
    b = code & (bins - 1);
  } else {
    b = code % bins;
    if (b < 0) b += bins;
  }
  const int off = b - lo_bin;
  return (unsigned)off < (unsigned)width ? ei * width + off : -1;
}

template <bool POW2, bool MULTI>
__global__ void __launch_bounds__(THREADS, 1)
qent_cluster_kernel(const float* __restrict__ x,
                    const float* __restrict__ epss, int* __restrict__ hist,
                    long long n, int n_eps, int bins, Plan p, int runs,
                    long long per_run) {
  extern __shared__ int sh[];                // counters [, outboxes, counts]
  cg::cluster_group cluster = cg::this_cluster();
  const int C = p.cluster;
  const int rank = MULTI ? (int)cluster.block_rank() : 0;
  long long cid = blockIdx.x / C;            // run -> pass -> eps group
  const int grp = (int)(cid % p.groups);
  cid /= p.groups;
  const int pass = (int)(cid % p.passes);
  cid /= p.passes;
  const long long run = cid % runs;
  const int s = (int)(cid / runs);
  const int e0 = grp * p.eps_per;
  const int ne = min(p.eps_per, n_eps - e0);
  const int lo_bin = pass * p.bins_pass;
  const int width = min(p.bins_pass, bins - lo_bin);
  const int used = ne * width;               // slots of this cluster
  const int lane = threadIdx.x & 31;
  const int my_lo = rank * p.per_cta;        // first slot this CTA owns

  for (int j = threadIdx.x; j < p.per_cta; j += THREADS) sh[j] = 0;

  float ev[MAX_EPS];
#pragma unroll
  for (int ei = 0; ei < MAX_EPS; ++ei) ev[ei] = ei < ne ? epss[e0 + ei] : 1.0f;

  const float* xs = x + (long long)s * n;
  const long long start = run * per_run;
  const long long end = min(n, start + per_run);

  if (!MULTI) {
    // one CTA holds every slot: plain shared atomics
    __syncthreads();
    for (long long base = start; base < end; base += BATCH) {
      float v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long i = base + u * THREADS + threadIdx.x;
        v[u] = i < end ? xs[i] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (base + u * THREADS + threadIdx.x >= end) break;
#pragma unroll
        for (int ei = 0; ei < MAX_EPS; ++ei) {   // constant indices into ev
          if (ei >= ne) break;
          const int slot =
              slot_of<POW2>(v[u], ev[ei], bins, lo_bin, width, ei);
          if (slot >= 0) atomicAdd(sh + slot, 1);
        }
      }
    }
    __syncthreads();
  } else {
    // the slots are spread over the cluster (eps_per == 1).  Batch bt
    // appends to outbox bt % 2; the others read it after barrier bt and
    // before barrier bt + 1, so it is rewritten only after barrier bt + 1.
    int* outbox = sh + p.per_cta;            // 2 x BATCH entries
    int* ocount = outbox + 2 * BATCH;        // 2 counts
    const float ev0 = ev[0];
    if (threadIdx.x < 2) ocount[threadIdx.x] = 0;
    cluster.sync();                          // all zeroed before any add
    const long long span = (long long)C * BATCH;
    const long long nb = (end - start + span - 1) / span;
    for (long long bt = 0; bt < nb; ++bt) {
      const int buf = (int)(bt & 1);
      int* ob = outbox + buf * BATCH;
      const long long base = start + bt * span + (long long)rank * BATCH;
      float v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long i = base + u * THREADS + threadIdx.x;
        v[u] = i < end ? xs[i] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        // every lane of the warp is here: the loop bounds are uniform
        const bool in = base + u * THREADS + threadIdx.x < end;
        const int slot =
            in ? slot_of<POW2>(v[u], ev0, bins, lo_bin, width, 0) : -1;
        const int prev = __shfl_up_sync(FULL, slot, 1);
        const unsigned heads = __ballot_sync(FULL, lane == 0 || prev != slot);
        const bool head = slot >= 0 && ((heads >> lane) & 1u);
        const unsigned after = heads >> lane >> 1;
        const int cnt = after ? __ffs(after) : 32 - lane;
        const bool mine = (unsigned)(slot - my_lo) < (unsigned)p.per_cta;
        if (head && mine) atomicAdd(sh + slot - my_lo, cnt);
        const bool remote = head && !mine;
        const unsigned rmask = __ballot_sync(FULL, remote);
        if (rmask) {
          const int leader = __ffs(rmask) - 1;
          int at = 0;
          if (lane == leader) at = atomicAdd(ocount + buf, __popc(rmask));
          at = __shfl_sync(FULL, at, leader);
          if (remote)
            ob[at + __popc(rmask & ((1u << lane) - 1u))] =
                slot << CNT_BITS | cnt;
        }
      }
      cluster.sync();                        // batch bt's outboxes written
      if (threadIdx.x == 0) ocount[buf ^ 1] = 0;   // read by all in bt - 1
      for (int q = 1; q < C; ++q) {
        const int src = (rank + q) % C;
        const int* rob = cluster.map_shared_rank(ob, src);
        const int m = *cluster.map_shared_rank(ocount + buf, src);
        for (int j = threadIdx.x; j < m; j += THREADS) {
          const int e = rob[j];
          const int sl = (e >> CNT_BITS) - my_lo;
          if ((unsigned)sl < (unsigned)p.per_cta)
            atomicAdd(sh + sl, e & ((1 << CNT_BITS) - 1));
        }
      }
      __syncthreads();                       // the reset count is seen
    }
    cluster.sync();                          // every outbox has been read
  }

  for (int j = threadIdx.x; j < p.per_cta; j += THREADS) {
    const int cnt = sh[j];
    const int slot = my_lo + j;
    if (cnt && slot < used) {
      const int ei = slot / width;
      const long long row = (long long)s * n_eps + e0 + ei;
      atomicAdd(&hist[row * bins + lo_bin + (slot - ei * width)], cnt);
    }
  }
}

Plan make_plan(int n_eps, int bins, int slots_max) {
  Plan p;
  if (bins <= slots_max) {
    p.cluster = 1;
    p.eps_per = std::min(std::min(n_eps, MAX_EPS), slots_max / bins);
    p.passes = 1;
    p.bins_pass = bins;
    p.per_cta = p.eps_per * bins;
  } else {
    // a CTA of a cluster also holds two outboxes of BATCH entries
    const int cap = std::min(slots_max, MAX_SMEM_INTS - 2 * BATCH - 2);
    p.eps_per = 1;
    p.bins_pass = (int)std::min((long long)bins, (long long)MAX_CLUSTER * cap);
    p.passes = (bins + p.bins_pass - 1) / p.bins_pass;
    p.cluster = (p.bins_pass + cap - 1) / cap;
    p.per_cta = (p.bins_pass + p.cluster - 1) / p.cluster;
  }
  p.groups = (n_eps + p.eps_per - 1) / p.eps_per;
  return p;
}

template <bool POW2, bool MULTI>
int launch(const float* x, const float* epss, int* hist, int k, long long n,
           int n_eps, int bins, const Plan& p, cudaStream_t stream) {
  auto kern = qent_cluster_kernel<POW2, MULTI>;
  const size_t smem =
      ((size_t)p.per_cta + (MULTI ? 2 * BATCH + 2 : 0)) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(
      &active, reinterpret_cast<const void*>(kern), &cfg);
  if (err != cudaSuccess) return (int)err;
  if (active <= 0) return (int)cudaErrorLaunchOutOfResources;

  // runs per (slice, pass, group): the fewest that fill the co-resident
  // clusters in whole waves (>= 95 % of the last wave busy), with at
  // least MIN_PER_CTA elements a CTA
  const long long units = (long long)k * p.passes * p.groups;
  long long max_runs = n / (MIN_PER_CTA * p.cluster);
  if (max_runs < 1) max_runs = 1;
  long long runs = 1;
  double best = -1.0;
  for (long long r = 1; r <= max_runs && r <= 4 * active; ++r) {
    const long long clusters = units * r;
    const long long waves = (clusters + active - 1) / active;
    const double eff = (double)clusters / (double)(waves * active);
    if (eff > best + 1e-9) { best = eff; runs = r; }
    if (eff >= 0.95) break;
  }
  long long per_run = (n + runs - 1) / runs;
  runs = (n + per_run - 1) / per_run;
  const long long blocks = units * runs * p.cluster;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cfg.gridDim = dim3((unsigned)blocks);
  err = cudaLaunchKernelEx(&cfg, kern, x, epss, hist, n, n_eps, bins, p,
                           (int)runs, per_run);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// x: (k, n) float32 contiguous; epss: (n_eps,) float32 on the device;
// hist: (k, n_eps, bins) int32, ZEROED by the caller.
// smem_budget: bytes of shared memory one CTA may take for counters.
// Returns cudaGetLastError() after the launch, or the error that refused
// it (a cluster that cannot be placed included).
extern "C" int repro_qent_hist(const float* x, const float* epss, int* hist,
                               int k, long long n, int n_eps, int bins,
                               int smem_budget, void* stream) {
  if (k <= 0 || n <= 0 || n_eps <= 0) return (int)cudaGetLastError();
  const int slots_max = smem_budget / (int)sizeof(int);
  if (bins <= 0 || slots_max < 1) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(n_eps, bins, slots_max);
  const bool pow2 = (bins & (bins - 1)) == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (p.cluster > 1)
    return pow2 ? launch<true, true>(x, epss, hist, k, n, n_eps, bins, p, st)
                : launch<false, true>(x, epss, hist, k, n, n_eps, bins, p, st);
  return pow2 ? launch<true, false>(x, epss, hist, k, n, n_eps, bins, p, st)
              : launch<false, false>(x, epss, hist, k, n, n_eps, bins, p, st);
}
