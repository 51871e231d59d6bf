// A second design of the ZFP forward transform for Hopper, kept as the
// measured alternative to src/repro_torch/csrc/zfp_block.cu (which the
// port runs): the same per-block arithmetic, bit for bit, with the data
// moved by the Tensor Memory Accelerator's bulk copies.  Built and timed
// beside the port's kernel by `python3 tools/ab_kernels.py --base TREE
// --zfp-probes` (ZFP_THREADS / ZFP_STAGES set with -D, the plan from
// ab_kernels.bulk_plan); never called by the port.
//
// Design (the pattern for a bytes-bound kernel): a persistent grid of
// `ctas` CTAs; the slice's 4x4 blocks, in band-major order (a band is 4
// rows), are cut into equal contiguous ranges, one a CTA, so every SM
// moves the same bytes.  A CTA walks its range in units of up to UNIT
// blocks that never cross a band: a unit is 4 row segments of 16 * w
// bytes.  One thread issues each unit's four cp.async.bulk copies into a
// ring of STAGES shared-memory stages, completing on the stage's
// mbarrier; the first STAGES units are requested at once.  Each thread
// transforms one block from the stage and writes its int32 coefficients
// back in place; after fence.proxy.async the stage leaves by
// cp.async.bulk shared -> global, so a unit's store overlaps the next
// unit's compute, and the stage is refilled once its store has been read
// out.  Exponents are stored coalesced.
//
// Measured slower than the port's full-wave register kernel at 1800^2
// and 1028^2 at every configuration tried (PERF.md, PR 19): the port's
// kernel already runs at the speed of a cold copy of the same bytes, and
// a few warps an SM computing from a stage hide less than a full wave.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../../src/repro_torch/csrc/zfp_transform.cuh"

#ifndef ZFP_THREADS
#define ZFP_THREADS 256
#endif
#ifndef ZFP_STAGES
#define ZFP_STAGES 4
#endif

namespace {

constexpr int UNIT = ZFP_THREADS;          // blocks a unit holds, one a thread
constexpr int STAGES = ZFP_STAGES;
constexpr int STAGE_FLOATS = 4 * 4 * UNIT;  // 4 rows x UNIT blocks x 4 values
constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * 4 + STAGES * 8;
static_assert(STAGES >= 2, "a stage is refilled while the next one computes");

// ---- mbarriers and bulk copies (PTX of sm_90) ----------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// global -> shared, completing `bytes` on the barrier
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// shared -> global, in the thread's current bulk group
__device__ __forceinline__ void bulk_store(void* dst, unsigned src,
                                           unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(src), "r"(bytes) : "memory");
}

// A unit: blocks [pos, pos + w) of the band-major order, inside one band.
struct Unit {
  int band, col, w;
};

__device__ __forceinline__ Unit unit_at(long long pos, long long end,
                                        int nbn) {
  Unit u;
  u.band = (int)(pos / nbn);
  u.col = (int)(pos - (long long)u.band * nbn);
  u.w = (int)min((long long)min(UNIT, nbn - u.col), end - pos);
  return u;
}

// Thread 0: request unit u into stage s (4 row segments, one barrier).
__device__ __forceinline__ void issue_load(const float* x, float* stage,
                                           unsigned bar, const Unit& u,
                                           int n) {
  const unsigned row_bytes = 16u * (unsigned)u.w;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(4 * row_bytes) : "memory");
#pragma unroll
  for (int r = 0; r < 4; ++r)
    bulk_load(smem_addr(stage + r * 4 * UNIT),
              x + (long long)(4 * u.band + r) * n + 4 * u.col, row_bytes, bar);
}

__global__ void __launch_bounds__(UNIT)
zfp_forward_kernel(const float* __restrict__ x, int* __restrict__ coef,
                   int* __restrict__ exps, int m, int n, long long per) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* stages = reinterpret_cast<float*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_FLOATS * 4);
  const int nbn = n / 4;
  const long long nblocks = (long long)(m / 4) * nbn;
  const long long begin = (long long)blockIdx.x * per;
  const long long end = min(begin + per, nblocks);
  if (begin >= end) return;                  // the same for the whole CTA
  const int t = threadIdx.x;

  long long next = begin;                    // thread 0: the next unit to load
  int loaded = 0;
  if (t == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_addr(&bars[s]));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (; loaded < STAGES && next < end; ++loaded) {
      const Unit u = unit_at(next, end, nbn);
      issue_load(x, stages + loaded * STAGE_FLOATS,
                 smem_addr(&bars[loaded]), u, n);
      next += u.w;
    }
  }
  __syncthreads();

  long long pos = begin;
  for (int i = 0; pos < end; ++i) {
    const Unit u = unit_at(pos, end, nbn);
    const int s = i % STAGES;
    float* stage = stages + s * STAGE_FLOATS;
    mbar_wait(smem_addr(&bars[s]), (unsigned)(i / STAGES) & 1u);
    if (t < u.w) {
      float v[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 f =
            *reinterpret_cast<const float4*>(stage + r * 4 * UNIT + 4 * t);
        v[r][0] = f.x; v[r][1] = f.y; v[r][2] = f.z; v[r][3] = f.w;
      }
      int q[4][4];
      exps[(long long)u.band * nbn + u.col + t] = zfp::forward_block(v, q);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        *reinterpret_cast<int4*>(stage + r * 4 * UNIT + 4 * t) =
            make_int4(q[r][0], q[r][1], q[r][2], q[r][3]);
      // make the in-place results visible to the bulk copy out
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    __syncthreads();
    if (t == 0) {
      const unsigned row_bytes = 16u * (unsigned)u.w;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        bulk_store(coef + (long long)(4 * u.band + r) * n + 4 * u.col,
                   smem_addr(stage + r * 4 * UNIT), row_bytes);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      if (i > 0 && next < end) {
        // the previous unit's store has left its stage: refill it
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
        const Unit nu = unit_at(next, end, nbn);
        const int ns = loaded % STAGES;
        issue_load(x, stages + ns * STAGE_FLOATS, smem_addr(&bars[ns]), nu, n);
        next += nu.w;
        ++loaded;
      }
    }
    pos += u.w;
  }
  if (t == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

}  // namespace

// x: (m, n) float32 contiguous, m and n multiples of 4; coef: (m, n)
// int32; exps: (m/4, n/4) int32; x and coef 16-byte aligned.  The plan
// (tools/ab_kernels.bulk_plan): `ctas` CTAs, CTA c taking blocks
// [c * per, (c + 1) * per) of the band-major order.  Returns
// cudaGetLastError() after the launch.
extern "C" int repro_zfp_forward2d(const float* x, int* coef, int* exps,
                                   int m, int n, int ctas, long long per,
                                   void* stream) {
  if (m <= 0 || n <= 0) return (int)cudaGetLastError();
  if (m % 4 || n % 4 || ctas <= 0 || per <= 0 ||
      (long long)ctas * per < (long long)(m / 4) * (n / 4) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(coef)) % 16)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      zfp_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  zfp_forward_kernel<<<ctas, UNIT, SMEM_BYTES, (cudaStream_t)stream>>>(
      x, coef, exps, m, n, per);
  return (int)cudaGetLastError();
}
