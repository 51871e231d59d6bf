// Fused quantize-dequantize SSE sweep (the quality half of the frontier).
//
// Replaces: src/repro/kernels/quality/quality.py, qdq_sse_sweep, with
// the fixed reduction tree of ref.tile_sse / ref.tile_sse_all_eps.
//
// For slice s and error bound eps[e], sse[s, e] is the sum over the
// slice of (x - code * eps)^2 with code = clip(floor(x / eps)), in a
// FIXED order that reproduces the reference's float32 bits:
//   * element i lies in tile i / 2048; inside the tile, column
//     (i % 2048) / 8 and sublane i % 8, so a column is 8 contiguous
//     floats (the reference's (k, 8, n/8) layout, read in place);
//   * err = fma(-code, eps, x)  (XLA contracts x - code*eps into one FMA);
//   * a column folds its sublanes as
//       (fma(e0, e0, e1*e1) + fma(e2, e2, e3*e3))
//     + (fma(e4, e4, e5*e5) + fma(e6, e6, e7*e7));
//   * the 256 column sums of a tile halve pairwise, v[0::2] + v[1::2]
//     repeated: inside a thread's 4 adjacent columns, then xor-1 ...
//     xor-16 shuffles inside a warp, then across the 2 warps;
//   * tile sums are added in tile order starting from 0.0f.
// Every operation is an __f*_rn intrinsic, so nvcc cannot contract or
// reassociate any of it.  x holds no subnormal (the port's entry points
// flush the data, quant.flush_subnormals); the rest follows the
// reference (flush.cuh): the quotients of the __fdiv_rn path, each
// square and each multiply-add of the column fold are flushed to zero
// where subnormal
// (the fast path's quotients are normal; a subnormal error squares to
// exactly 0 and cannot move a multiply-add with a normal addend, so
// the error itself needs no flush).  Elements past the end of the slice count as
// 0.0f, the reference's zero padding: their error is exactly +0.
//
// x / eps is the correctly rounded quotient of quotient.cuh (eps's
// reciprocal once per CTA, three FMAs per quotient).  The reference casts
// the clipped floor to int32 and back; on a clipped floor (an integral
// float in [-2^31, 2^31), never NaN: fmaxf drops it) that round trip is
// the identity but for -0.0, which becomes +0.0, and the two codes give
// errors that differ at most in the sign of a zero, which the square
// removes: so it is left out.  Where a thread's |x| / eps stays below 2^30
// the clip cannot bind and is left out too.
//
// Bound on the card: issue slots, not bytes.  Each element is read once
// (4 bytes) for all eps, but each (element, eps) takes ~7 instructions
// (3 FMAs for the quotient, a floor, the error, the column fold and its
// share of the shuffles), and the floor runs on the 16-lane-a-clock
// conversion pipe.  The TPU kernel carries the running sum across its
// sequential grid; blocks on the card run in no order, so:
//   * pass 1 is a persistent grid, sized from the occupancy, of CTAs of
//     64 threads, each thread 4 adjacent columns (32 contiguous floats,
//     8 16-byte loads), walking the tiles of one slice; all eps of a tile
//     (up to 8 at a time) fold with ONE barrier: each warp leaves its warp
//     sums in a double-buffered shared array, and warp w finishes eps w,
//     w + 2, ...  Tile sums go to partial[(s, e), tile], a row per
//     (slice, eps);
//   * pass 2 gives each row one warp, which reads it in coalesced
//     128-byte runs and adds it in tile order (every lane keeps the same
//     running sum), so the in-order chain costs one dependent add a tile.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flush.cuh"
#include "quotient.cuh"

namespace {

constexpr float CODE_MIN = -2147483648.0f;
constexpr float CODE_MAX = 2147483520.0f;
constexpr int TILE = 2048;
constexpr int CPT = 4;                  // adjacent columns a thread
constexpr int NV = 8 * CPT;             // floats a thread
constexpr int THREADS = TILE / NV;      // 64
constexpr int WARPS = THREADS / 32;     // 2
constexpr int GROUP = 8;                // eps folded per barrier
constexpr int CHAIN_WARPS = 4;          // pass 2: rows per CTA
constexpr int CHAIN_UNROLL = 4;         // pass 2: loads in flight a lane
constexpr unsigned FULL = 0xffffffffu;

// this thread's NV floats of tile t, zero past n; 16-byte loads where the
// slice is 16-byte aligned and the floats whole
__device__ __forceinline__ void load_cols(const float* __restrict__ xs,
                                          long long n, long long t, int tid,
                                          bool vec, float (&v)[NV]) {
  const long long base = t * TILE + (long long)tid * NV;
  if (vec && base + NV <= n) {
    const float4* p = reinterpret_cast<const float4*>(xs + base);
#pragma unroll
    for (int i = 0; i < NV / 4; ++i) {
      const float4 a = __ldg(p + i);
      v[4 * i] = a.x;
      v[4 * i + 1] = a.y;
      v[4 * i + 2] = a.z;
      v[4 * i + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < NV; ++j)
      v[j] = base + j < n ? xs[base + j] : 0.0f;
  }
}

// the fixed tree of this thread's CPT columns at one eps (r = its
// reciprocal); bit j of `slow` marks an element whose quotient must take
// __fdiv_rn (quotient.cuh)
template <bool CLIP>
__device__ __forceinline__ float columns_sse(const float (&v)[NV], float eps,
                                             float r, unsigned slow) {
  float q[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) q[j] = quot_fast(v[j], eps, r);
  if (slow) {
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (slow >> j & 1u) q[j] = ftz(__fdiv_rn(v[j], eps));
  }
  float e[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    float code = floorf(q[j]);
    if (CLIP) code = fminf(fmaxf(code, CODE_MIN), CODE_MAX);
    e[j] = __fmaf_rn(-code, eps, v[j]);
  }
  float col[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const float* ec = e + 8 * c;
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = ftz_nonneg(__fmaf_rn(ec[2 * i], ec[2 * i],
                                  ftz_nonneg(__fmul_rn(ec[2 * i + 1],
                                                       ec[2 * i + 1]))));
    const float p01 = p[0], p23 = p[1], p45 = p[2], p67 = p[3];
    col[c] = __fadd_rn(__fadd_rn(p01, p23), __fadd_rn(p45, p67));
  }
#pragma unroll
  for (int w = 1; w < CPT; w <<= 1)
#pragma unroll
    for (int c = 0; c < CPT; c += 2 * w) col[c] = __fadd_rn(col[c], col[c + w]);
  return col[0];
}

// eps g0 .. g0 + gn - 1 and their reciprocals into shared memory
__device__ __forceinline__ void stage_eps(const float* __restrict__ epss,
                                          int g0, int gn, float* s_eps,
                                          float* s_rcp) {
  if ((int)threadIdx.x < gn) {
    const float eps = __ldg(epss + g0 + threadIdx.x);
    s_eps[threadIdx.x] = eps;
    s_rcp[threadIdx.x] = quot_recip(eps);
  }
}

// grid (G, k): CTA (c, s) folds tiles c, c + G, ... of slice s
__global__ void __launch_bounds__(THREADS)
tile_sse_kernel(const float* __restrict__ x, const float* __restrict__ epss,
                float* __restrict__ partial, long long n, int n_eps,
                long long tiles) {
  __shared__ float wsum[2][GROUP][WARPS];
  __shared__ float s_eps[GROUP], s_rcp[GROUP];
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* xs = x + (long long)s * n;
  const bool vec = (reinterpret_cast<uintptr_t>(xs) & 15) == 0;
  float* ps = partial + (long long)s * n_eps * tiles;
  const bool one_group = n_eps <= GROUP;
  if (one_group) stage_eps(epss, 0, n_eps, s_eps, s_rcp);
  __syncthreads();
  int buf = 0;

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    float v[NV];
    load_cols(xs, n, t, tid, vec, v);
    unsigned slow = 0;
    float vmax = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (!quot_dividend_ok(v[j])) slow |= 1u << j;
      vmax = fmaxf(vmax, fabsf(v[j]));
    }
    for (int g0 = 0; g0 < n_eps; g0 += GROUP) {
      const int gn = min(GROUP, n_eps - g0);
      if (!one_group) {
        // the previous group's readers all passed the barrier below
        stage_eps(epss, g0, gn, s_eps, s_rcp);
        __syncthreads();
      }
#pragma unroll 2
      for (int j = 0; j < gn; ++j) {
        const float eps = s_eps[j];
        const float r = s_rcp[j];
        const unsigned sl = quot_divisor_ok(eps) ? slow : FULL;
        // with no slow element and |q| < 2^30 the clip cannot bind
        float w = sl == 0 && __fmul_rn(vmax, r) < 0x1p30f
                      ? columns_sse<false>(v, eps, r, 0)
                      : columns_sse<true>(v, eps, r, sl);
        // lane l ends with the tree sum of its aligned group; float
        // addition is commutative, so both partners hold the same bits
#pragma unroll
        for (int off = 1; off < 32; off <<= 1)
          w = __fadd_rn(w, __shfl_xor_sync(FULL, w, off));
        if (lane == 0) wsum[buf][j][warp] = w;
      }
      // the one barrier of this group; the other buffer's readers, two
      // barriers back, are done
      __syncthreads();
      for (int e = warp; e < gn; e += WARPS) {
        float u = lane < WARPS ? wsum[buf][e][lane] : 0.0f;
#pragma unroll
        for (int off = 1; off < WARPS; off <<= 1)
          u = __fadd_rn(u, __shfl_xor_sync(FULL, u, off));
        if (lane == 0) ps[(long long)(g0 + e) * tiles + t] = u;
      }
      buf ^= 1;
    }
  }
}

// one warp per (slice, eps) row: sse[r] = ((0 + p[0]) + p[1]) + ...
__global__ void __launch_bounds__(CHAIN_WARPS * 32)
sum_tiles_kernel(const float* __restrict__ partial, float* __restrict__ sse,
                 long long tiles, int rows) {
  const int r = blockIdx.x * CHAIN_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const float* p = partial + (long long)r * tiles;
  float acc = 0.0f;
  for (long long t0 = 0; t0 < tiles; t0 += 32 * CHAIN_UNROLL) {
    float v[CHAIN_UNROLL];
#pragma unroll
    for (int u = 0; u < CHAIN_UNROLL; ++u) {
      const long long t = t0 + u * 32 + lane;
      v[u] = t < tiles ? __ldg(p + t) : 0.0f;
    }
    // a tile sum is +0 or more, or NaN, so the zeros past the end add
    // nothing
#pragma unroll
    for (int u = 0; u < CHAIN_UNROLL; ++u)
#pragma unroll
      for (int j = 0; j < 32; ++j)
        acc = __fadd_rn(acc, __shfl_sync(FULL, v[u], j));
  }
  if (lane == 0) sse[r] = acc;
}

// every finite float32 v against every divisor: quotient() as the kernels
// take it against __fdiv_rn, mismatches counted per divisor
__global__ void quotient_check_kernel(const float* __restrict__ divisors,
                                      int n_div,
                                      unsigned long long* __restrict__ bad) {
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  for (int e = 0; e < n_div; ++e) {
    const float d = __ldg(divisors + e);
    const float r = quot_recip(d);
    unsigned long long miss = 0;
    for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x +
                                threadIdx.x;
         i < (1ull << 32); i += stride) {
      const float v = __uint_as_float((unsigned)i);
      if (isfinite(v) && !(quotient(v, d, r) == __fdiv_rn(v, d))) ++miss;
    }
    if (miss) atomicAdd(bad + e, miss);
  }
}

}  // namespace

// For each of n_div divisors (float32 on the device), adds to bad[e]
// (zeroed by the caller) the finite float32 v whose quotient() differs
// from __fdiv_rn(v, d) (+0 and -0 compare equal).  Returns
// cudaGetLastError() after the launch.
extern "C" int repro_quotient_check(const float* divisors, int n_div,
                                    unsigned long long* bad, void* stream) {
  if (n_div <= 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  quotient_check_kernel<<<sms * 8, 256, 0, (cudaStream_t)stream>>>(
      divisors, n_div, bad);
  return (int)cudaGetLastError();
}

// x: (k, n) float32 contiguous; epss: (n_eps,) float32 on the device;
// partial: (ceil(n / 2048), k * n_eps) float32 scratch (used as k * n_eps
// rows of ceil(n / 2048)); sse: (k, n_eps).
// Returns cudaGetLastError() after the two launches, or the error that
// refused the first.
extern "C" int repro_quality_sse(const float* x, const float* epss,
                                 float* partial, float* sse, int k,
                                 long long n, int n_eps, void* stream) {
  if (k <= 0 || n_eps <= 0) return (int)cudaGetLastError();
  if (k > 65535) return (int)cudaErrorInvalidValue;
  const long long tiles = (n + TILE - 1) / TILE;
  const int rows = k * n_eps;
  cudaStream_t st = (cudaStream_t)stream;
  if (tiles > 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, tile_sse_kernel, THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    if (per_sm <= 0) return (int)cudaErrorLaunchOutOfResources;
    // at most one wave of co-resident CTAs, shared out among the slices
    long long per_slice = (long long)sms * per_sm / k;
    if (per_slice < 1) per_slice = 1;
    if (per_slice > tiles) per_slice = tiles;
    dim3 grid((unsigned)per_slice, k);
    tile_sse_kernel<<<grid, THREADS, 0, st>>>(x, epss, partial, n, n_eps,
                                              tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  sum_tiles_kernel<<<(rows + CHAIN_WARPS - 1) / CHAIN_WARPS, CHAIN_WARPS * 32,
                     0, st>>>(partial, sse, tiles, rows);
  return (int)cudaGetLastError();
}
