// ZFP forward transform of a 2-D slice: per 4x4 block, block-floating-
// point alignment to the block's exponent, then the exact zfp integer
// lifting along rows and then columns (ZFP's encode; the arithmetic,
// bit-equal to the reference's, in zfp_transform.cuh).
//
// Replaces: src/repro/kernels/zfp_block/zfp_block.py, zfp_forward2d (and
// its _block_exponents, _lift_rows, _lift_cols), i.e.
// compressors/zfp.zfp_transform laid out as (m, n) coefficients and
// (m/4, n/4) exponents.
//
// Bound on the card: bytes.  Each element is read once (4 bytes) and one
// int32 coefficient written, plus one int32 exponent per 16 elements
// (8.25 bytes an element), against ~15 integer ops per element and ~60
// dependent float ops per block.  Its callers hand it one slice at a
// time, cold: measured on an H100, the time is that of a cold SM copy of
// the same bytes (torch.neg into a second buffer), and the same kernel
// without its arithmetic takes as long, so the arithmetic is hidden and
// what is left is DRAM, including the write-back of the dirty lines a
// cold L2 holds (tools/ab_kernels.py --zfp-probes).
//
// Design: the simpler of two designs measured for Hopper, at least as
// fast as the other.  Every thread of a grid sized from the card
// (kernels/zfp_block/ops.launch_plan: at most a full wave, 8 CTAs of 256
// threads an SM at 32 registers) takes blocks of the band-major order (a
// band is 4 rows) with a grid stride, so neighbouring threads take
// neighbouring blocks, no lane of the grid is idle but the last CTA's,
// and a slice up to ~4.3 M values is one block a thread, all in flight
// at once: a warp moves 512 contiguous bytes per block row, as 16-byte
// vectors.  The other design, a persistent grid that moves units of
// 4 row segments by cp.async.bulk through a ring of shared-memory stages
// on mbarriers (tools/variants/zfp_bulk.cu), was slower at every
// configuration tried: 8-16 warps an SM cannot run the dependent chain
// as fast as a full wave, which overlaps one warp's loads, another's
// arithmetic and a third's stores by itself.  A block's bits depend on
// its 16 values alone, never on the plan.

#include <cuda_runtime.h>

#include "zfp_transform.cuh"

namespace {

constexpr int THREADS = 256;  // a CTA (kernels/zfp_block/ops.THREADS)
constexpr int CTAS_PER_SM = 8;  // a full wave (ops.CTAS_PER_SM): 32 registers

__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)
zfp_forward_kernel(const float* __restrict__ x, int* __restrict__ coef,
                   int* __restrict__ exps, int m, int n) {
  const int nbn = n / 4;
  const int nblocks = (m / 4) * nbn;        // < 2^31: the wrapper checks
  for (int b = blockIdx.x * THREADS + threadIdx.x; b < nblocks;
       b += gridDim.x * THREADS) {
    const int bi = b / nbn;
    const int bj = b - bi * nbn;
    float v[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 f = *reinterpret_cast<const float4*>(
          x + (long long)(4 * bi + r) * n + 4 * bj);
      v[r][0] = f.x; v[r][1] = f.y; v[r][2] = f.z; v[r][3] = f.w;
    }
    int q[4][4];
    exps[b] = zfp::forward_block(v, q);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<int4*>(coef + (long long)(4 * bi + r) * n + 4 * bj) =
          make_int4(q[r][0], q[r][1], q[r][2], q[r][3]);
  }
}

}  // namespace

// x: (m, n) float32 contiguous and 16-byte aligned, m and n multiples of
// 4, fewer than 2^31 blocks; coef: (m, n) int32; exps: (m/4, n/4) int32;
// `ctas` CTAs of THREADS threads (kernels/zfp_block/ops.launch_plan).
// Returns cudaGetLastError() after the launch.
extern "C" int repro_zfp_forward2d(const float* x, int* coef, int* exps,
                                   int m, int n, int ctas, void* stream) {
  if (m <= 0 || n <= 0) return (int)cudaGetLastError();
  if (m % 4 || n % 4 || ctas <= 0 ||
      (long long)(m / 4) * (n / 4) >= (1LL << 31) - (long long)ctas * THREADS)
    return (int)cudaErrorInvalidValue;
  zfp_forward_kernel<<<ctas, THREADS, 0, (cudaStream_t)stream>>>(x, coef,
                                                                 exps, m, n);
  return (int)cudaGetLastError();
}
