// Dual-quantization Lorenzo codes of a 2-D slice (SZ3-lorenzo's encode).
//
// Replaces: src/repro/kernels/lorenzo/lorenzo.py, lorenzo2d (and its
// _quantize), with the zero halo of compressors/sz.lorenzo_encode.
//
//   codes[i, j] = Q(x[i,j]) - Q(x[i-1,j]) - Q(x[i,j-1]) + Q(x[i-1,j-1])
//
// Q is the Lorenzo pre-quantizer of compressors/sz._prequant, bit for
// bit:
//   q = (int) rint(v / two_eps)              (__fdiv_rn, half-even rint)
//   twice: err = fma(-(float) q, two_eps, v) (__fmaf_rn, one rounding)
//          q += (err > eps) - (err < -eps)
// and Q = 0 outside the slice (row -1, column -1), the reference's zero
// pad; Q(0.0) = 0, so a zero read in place of a value outside the slice
// is the halo exactly.  The error is one FMA because that is what the
// reference computes: its optimization_barrier around q * two_eps does
// not survive XLA's CPU pipeline, which fuses the product and the
// subtraction into one loop that the CPU contracts into an FMA (an
// un-fused error moves codes on values that sit within an ulp of a bin
// edge).  Every operation is an __f*_rn intrinsic, so nvcc cannot
// contract or reorder anything else.  two_eps and eps are the float32
// values the plain version computes (f32(2 eps), f32(eps)).  The
// four-term difference is taken modulo 2^32, as int32 arithmetic wraps
// in the reference.  Subnormals need no flush here (flush.cuh): the
// reference reads a subnormal v, quotient or error as a signed zero, but
// rint of a subnormal quotient is +-0 either way and the error only
// meets the comparisons with +-eps, which see a subnormal as they see
// its zero, so no code changes.
//
// Bound on the card: bytes.  Each element is read once (4 bytes) and one
// int32 code written, against ~25 instructions of quantizer.  The TPU
// kernel streams four shifted copies of the padded input from HBM and
// quantizes each (recompute over communicate).  Here a thread owns a
// strip of 4 columns x R rows and issues all of its loads -- R + 1 rows
// of 16 bytes, the row above the strip included -- before its first
// quantize.  Q of the row above is carried down the strip in registers;
// the left neighbour comes from the lane to the left by a shuffle, and
// the column left of the warp is loaded and quantized once per row,
// spread over lanes 0..R, then shuffled to lane 0.  Codes are stored as
// 16-byte vectors.  Where n is not a multiple of 4 or a pointer is not
// 16-byte aligned, the same kernel reads and writes each element singly,
// masked at the edge.  So device memory sees each input element
// (1 + 1/R) times, the halo row from L2 in the main, and nothing is
// padded.  The quantizer divides by quotient.cuh's shared reciprocal and,
// where |v / two_eps| < 2^21, keeps q as an integral float, so that it
// takes no special-function or conversion op (quantize below).  A short
// strip (R = 4) gives 1.3 waves of CTAs at 1800 x 1800, so one CTA's
// loads overlap another's quantizing and stores.

#include <cuda_runtime.h>
#include <stdint.h>

#include "quotient.cuh"

namespace {

constexpr int R = 4;                  // rows a thread strip
constexpr int WARPS = 4;              // strips a CTA, stacked along rows
constexpr int CTA_COLS = 32 * 4;      // a warp's 128 columns
constexpr int CTA_ROWS = WARPS * R;
constexpr unsigned FULL = 0xffffffffu;
constexpr float MAGIC = 12582912.0f;  // 1.5 * 2^23
static_assert(R + 1 <= 32, "lanes 0..R carry the left halo column");

__device__ __forceinline__ int quantize_slow(float v, float two_eps,
                                             float eps) {
  int q = (int)rintf(__fdiv_rn(v, two_eps));
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float err = __fmaf_rn(-(float)q, two_eps, v);
    q += (int)(err > eps) - (int)(err < -eps);
  }
  return q;
}

// quantize_slow's code with no special-function or conversion op where
// |v / two_eps| < 2^21: the quotient by quotient.cuh's shared reciprocal
// rcp, and q kept as an integral float, exact at that size, so that
// adding 1.5 * 2^23 rounds half to even and leaves q in the low bits.
// Elsewhere (and where `fast` is false) quantize_slow's.
__device__ __forceinline__ int quantize(float v, float two_eps, float eps,
                                        float rcp, bool fast) {
  const float quot = quot_fast(v, two_eps, rcp);
  if (!(fast && quot_dividend_ok(v) && fabsf(quot) < 0x1p21f))
    return quantize_slow(v, two_eps, eps);
  float q = __fsub_rn(__fadd_rn(quot, MAGIC), MAGIC);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float err = __fmaf_rn(-q, two_eps, v);
    q = __fadd_rn(q, err > eps ? 1.0f : (err < -eps ? -1.0f : 0.0f));
  }
  return __float_as_int(__fadd_rn(q, MAGIC)) - __float_as_int(MAGIC);
}

// x[i, j .. j+3], zero outside the slice
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ x, int m,
                                        int n, int i, int j) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (i < 0 || i >= m) return v;
  const float* row = x + (long long)i * n;
  if (VEC) {
    if (j < n) v = __ldg(reinterpret_cast<const float4*>(row + j));
  } else {
    if (j < n) v.x = row[j];
    if (j + 1 < n) v.y = row[j + 1];
    if (j + 2 < n) v.z = row[j + 2];
    if (j + 3 < n) v.w = row[j + 3];
  }
  return v;
}

template <bool VEC>
__device__ __forceinline__ void store4(int* __restrict__ out, int m, int n,
                                       int i, int j, int4 c) {
  if (i >= m) return;
  int* row = out + (long long)i * n;
  if (VEC) {
    if (j < n) *reinterpret_cast<int4*>(row + j) = c;
  } else {
    if (j < n) row[j] = c.x;
    if (j + 1 < n) row[j + 1] = c.y;
    if (j + 2 < n) row[j + 2] = c.z;
    if (j + 3 < n) row[j + 3] = c.w;
  }
}

// Lorenzo difference of a row's 4 codes; `left`, `left_up` are Q of the
// column to the left in this row and the row above.  Modulo 2^32.
__device__ __forceinline__ int4 lorenzo4(int4 q, int4 up, int left,
                                         int left_up) {
  int4 c;
  c.x = (int)((unsigned)q.x - (unsigned)up.x - (unsigned)left + (unsigned)left_up);
  c.y = (int)((unsigned)q.y - (unsigned)up.y - (unsigned)q.x + (unsigned)up.x);
  c.z = (int)((unsigned)q.z - (unsigned)up.z - (unsigned)q.y + (unsigned)up.y);
  c.w = (int)((unsigned)q.w - (unsigned)up.w - (unsigned)q.z + (unsigned)up.z);
  return c;
}

template <bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
lorenzo_kernel(const float* __restrict__ x, int* __restrict__ out, int m,
               int n, float two_eps, float eps) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j0 = blockIdx.x * CTA_COLS;               // the warp's columns
  const int j = j0 + lane * 4;                        // this thread's
  const int i0 = blockIdx.y * CTA_ROWS + warp * R;    // the strip's rows

  const float rcp = quot_recip(two_eps);
  const bool fast = quot_divisor_ok(two_eps);
  // every load first: the row above the strip and the strip's R rows, and
  // in lane l <= R the value left of the warp in row i0 - 1 + l
  float4 v[R + 1];
#pragma unroll
  for (int r = 0; r <= R; ++r) v[r] = load4<VEC>(x, m, n, i0 - 1 + r, j);
  float h = 0.0f;
  if (lane <= R && j0 > 0 && i0 - 1 + lane >= 0 && i0 - 1 + lane < m)
    h = __ldg(x + (long long)(i0 - 1 + lane) * n + j0 - 1);
  const int qh = quantize(h, two_eps, eps, rcp, fast);

  int4 up = make_int4(quantize(v[0].x, two_eps, eps, rcp, fast),
                      quantize(v[0].y, two_eps, eps, rcp, fast),
                      quantize(v[0].z, two_eps, eps, rcp, fast),
                      quantize(v[0].w, two_eps, eps, rcp, fast));
  int left_up = __shfl_up_sync(FULL, up.w, 1);
  const int halo_up = __shfl_sync(FULL, qh, 0);
  if (lane == 0) left_up = halo_up;
#pragma unroll
  for (int r = 1; r <= R; ++r) {
    const int4 q = make_int4(quantize(v[r].x, two_eps, eps, rcp, fast),
                             quantize(v[r].y, two_eps, eps, rcp, fast),
                             quantize(v[r].z, two_eps, eps, rcp, fast),
                             quantize(v[r].w, two_eps, eps, rcp, fast));
    int left = __shfl_up_sync(FULL, q.w, 1);
    const int halo = __shfl_sync(FULL, qh, r);
    if (lane == 0) left = halo;
    store4<VEC>(out, m, n, i0 - 1 + r, j, lorenzo4(q, up, left, left_up));
    up = q;
    left_up = left;
  }
}

}  // namespace

// x: (m, n) float32 contiguous; out: (m, n) int32.  two_eps = f32(2 eps),
// eps = f32(eps).  Returns cudaGetLastError() after the launch.
extern "C" int repro_lorenzo2d(const float* x, int* out, int m, int n,
                               float two_eps, float eps, void* stream) {
  if (m <= 0 || n <= 0) return (int)cudaGetLastError();
  const long long rows = ((long long)m + CTA_ROWS - 1) / CTA_ROWS;
  if (rows > 65535 || n > 0x7fffffff - CTA_COLS)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(((long long)n + CTA_COLS - 1) / CTA_COLS),
                  (unsigned)rows);
  const bool vec = n % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    lorenzo_kernel<true><<<grid, WARPS * 32, 0, st>>>(x, out, m, n, two_eps,
                                                      eps);
  else
    lorenzo_kernel<false><<<grid, WARPS * 32, 0, st>>>(x, out, m, n, two_eps,
                                                       eps);
  return (int)cudaGetLastError();
}
