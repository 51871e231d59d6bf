// ZFP forward transform of a 2-D slice: per 4x4 block, block-floating-
// point alignment to the block's exponent, then the exact zfp integer
// lifting along rows and then columns (ZFP's encode).
//
// Replaces: src/repro/kernels/zfp_block/zfp_block.py, zfp_forward2d (and
// its _block_exponents, _lift_rows, _lift_cols), i.e.
// compressors/zfp.zfp_transform laid out as (m, n) coefficients and
// (m/4, n/4) exponents.
//
// Per block (one thread, the 16 values in registers):
//   amax = max |x|
//   e    = amax > 0 ? ceil(log2(max(amax, 1e-38))) : 0
//   q    = (int) rint(x * exp2(24 - e))
//   fwd_lift along each column of the block, then along each row.
// log2 and exp2 are the reference's float32 functions as XLA evaluates
// them on the CPU (repro_torch/refmath.py): log(x) * f32(1/ln 2) and
// exp(k * f32(ln 2)), each a Cephes polynomial with XLA's multiply-add
// contraction pattern.  They are not exact: ceil(log2(2^k)) is k + 1 for
// some k, and exp2(k) misses 2^k by up to ~30 ulp, so an exact frexp or
// ldexp would not give the reference's exponents and coefficients.  Every
// step is an __f*_rn intrinsic, so nvcc cannot contract or reorder it.
// x holds no subnormal: the port's entry points flush the data
// (quant.flush_subnormals), as XLA on the CPU reads it.
//
// Bound on the card: bytes.  Each element is read once (4 bytes) and one
// int32 coefficient written, plus one int32 exponent per 16 elements,
// against ~15 integer ops per element and ~60 float ops per block.  The
// TPU kernel lifts a (128, 128) tile with strided slices so all blocks
// advance in lockstep on 128-wide lanes; here a block of 16 values fits
// one thread's registers, neighbouring threads take neighbouring blocks,
// and each thread loads and stores its four block rows as 16-byte
// vectors, so a warp moves 512 contiguous bytes per row.

#include <cuda_runtime.h>

namespace {

constexpr int BX = 32;        // 4x4 blocks per thread block, along columns
constexpr int BY = 8;         // ... along rows
constexpr int INTPREC = 26;

__device__ __forceinline__ float f32(unsigned bits) {
  return __uint_as_float(bits);
}

// XLA's CPU float32 log, for positive inputs (refmath.log_f32)
__device__ __forceinline__ float xla_log(float x) {
  x = fmaxf(x, f32(0x00800000u));                    // smallest normal
  const int bits = __float_as_int(x);
  float e = __fadd_rn((float)((bits >> 23) - 127), 1.0f);
  const float m = __int_as_float((bits & 0x007FFFFF) | 0x3F000000);
  const bool small = m < f32(0x3F3504F3u);           // sqrt(1/2)
  const float t = __fadd_rn(__fsub_rn(m, 1.0f), small ? m : 0.0f);
  e = __fsub_rn(e, small ? 1.0f : 0.0f);
  const float t2 = __fmul_rn(t, t);
  const float t3 = __fmul_rn(t2, t);
  float y = __fmaf_rn(__fmaf_rn(t, f32(0x3D9021BBu), f32(0xBDEBD1B8u)), t,
                      f32(0x3DEF251Au));
  const float y1 = __fmaf_rn(__fmaf_rn(t, f32(0xBDFE5D4Fu), f32(0x3E11E9BFu)),
                             t, f32(0xBE2AAE50u));
  const float y2 = __fmaf_rn(__fmaf_rn(t, f32(0x3E4CCEACu), f32(0xBE7FFFFCu)),
                             t, f32(0x3EAAAAAAu));
  y = __fmaf_rn(y, t3, y1);
  y = __fmaf_rn(y, t3, y2);
  y = __fmaf_rn(y, t3, __fmul_rn(e, f32(0xB95E8083u)));   // ln 2, low part
  const float r = __fadd_rn(__fmaf_rn(t2, -0.5f, t), y);
  return __fmaf_rn(e, f32(0x3F318000u), r);                // ln 2, high part
}

// ceil(log2(x)) of the reference, log2(x) = log(x) * f32(1 / ln 2)
__device__ __forceinline__ int ceil_log2(float x) {
  return (int)ceilf(__fmul_rn(xla_log(x), f32(0x3FB8AA3Bu)));
}

// XLA's CPU float32 exp2 of an integer k (refmath.exp2_f32)
__device__ __forceinline__ float xla_exp2(int k) {
  float a = __fmul_rn((float)k, f32(0x3F317218u));         // f32(ln 2)
  a = fminf(fmaxf(a, f32(0xC2AF999Au)), f32(0x42B1999Au));
  float fx = floorf(__fmaf_rn(a, f32(0x3FB8AA3Bu), 0.5f));
  fx = fminf(fmaxf(fx, -127.0f), 127.0f);
  float r = __fmaf_rn(-fx, f32(0x3F318000u), a);
  r = __fmaf_rn(-fx, f32(0xB95E8083u), r);
  float y = f32(0x39506967u);
  y = __fmaf_rn(y, r, f32(0x3AB743CEu));
  y = __fmaf_rn(y, r, f32(0x3C088908u));
  y = __fmaf_rn(y, r, f32(0x3D2AA9C1u));
  y = __fmaf_rn(y, r, f32(0x3E2AAAAAu));
  y = __fmaf_rn(y, r, 0.5f);
  const float t = __fadd_rn(__fmaf_rn(y, __fmul_rn(r, r), r), 1.0f);
  const float out = __fmul_rn(t, __int_as_float(((int)fx + 127) << 23));
  return fabsf(out) < f32(0x00800000u) ? 0.0f : out;       // XLA flushes
}

// exact zfp forward lift of one 4-vector (int32, arithmetic shifts)
__device__ __forceinline__ void fwd_lift(int& x, int& y, int& z, int& w) {
  x += w; x >>= 1; w -= x;
  z += y; z >>= 1; y -= z;
  x += z; x >>= 1; z -= x;
  w += y; w >>= 1; y -= w;
  w += y >> 1; y -= w >> 1;
}

__global__ void __launch_bounds__(BX * BY)
zfp_forward_kernel(const float* __restrict__ x, int* __restrict__ coef,
                   int* __restrict__ exps, int m, int n) {
  const int nbm = m / 4;
  const int nbn = n / 4;
  const int bi = blockIdx.y * BY + threadIdx.y;
  const int bj = blockIdx.x * BX + threadIdx.x;
  if (bi >= nbm || bj >= nbn) return;

  float v[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float4 f = *reinterpret_cast<const float4*>(
        x + (long long)(4 * bi + r) * n + 4 * bj);
    v[r][0] = f.x; v[r][1] = f.y; v[r][2] = f.z; v[r][3] = f.w;
  }
  float amax = 0.0f;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) amax = fmaxf(amax, fabsf(v[r][c]));
  const int e = amax > 0.0f ? ceil_log2(fmaxf(amax, 1e-38f)) : 0;
  const float scale = xla_exp2(INTPREC - 2 - e);

  int q[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) q[r][c] = (int)rintf(__fmul_rn(v[r][c], scale));
#pragma unroll
  for (int c = 0; c < 4; ++c) fwd_lift(q[0][c], q[1][c], q[2][c], q[3][c]);
#pragma unroll
  for (int r = 0; r < 4; ++r) fwd_lift(q[r][0], q[r][1], q[r][2], q[r][3]);

#pragma unroll
  for (int r = 0; r < 4; ++r)
    *reinterpret_cast<int4*>(coef + (long long)(4 * bi + r) * n + 4 * bj) =
        make_int4(q[r][0], q[r][1], q[r][2], q[r][3]);
  exps[(long long)bi * nbn + bj] = e;
}

}  // namespace

// x: (m, n) float32 contiguous and 16-byte aligned, m and n multiples of
// 4; coef: (m, n) int32; exps: (m/4, n/4) int32.  Returns
// cudaGetLastError() after the launch.
extern "C" int repro_zfp_forward2d(const float* x, int* coef, int* exps,
                                   int m, int n, void* stream) {
  if (m <= 0 || n <= 0) return (int)cudaGetLastError();
  if (m % 4 || n % 4) return (int)cudaErrorInvalidValue;
  const long long rows = (m / 4 + BY - 1) / BY;
  if (rows > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((n / 4 + BX - 1) / BX, (unsigned)rows);
  dim3 block(BX, BY);
  zfp_forward_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(x, coef, exps,
                                                               m, n);
  return (int)cudaGetLastError();
}
