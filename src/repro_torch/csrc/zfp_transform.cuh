// The per-block arithmetic of ZFP's forward transform, shared by the
// port's kernel (zfp_block.cu) and the measured bulk-copy alternative
// (tools/variants/zfp_bulk.cu), so both give the same bits:
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
// The values hold no subnormal: the port's entry points flush the data
// (quant.flush_subnormals), as XLA on the CPU reads it.
#pragma once

#include <cuda_runtime.h>

namespace zfp {

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

// The block's 16 values -> its int32 coefficients; returns its exponent.
__device__ __forceinline__ int forward_block(const float (&v)[4][4],
                                             int (&q)[4][4]) {
  float amax = 0.0f;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) amax = fmaxf(amax, fabsf(v[r][c]));
  const int e = amax > 0.0f ? ceil_log2(fmaxf(amax, 1e-38f)) : 0;
  const float scale = xla_exp2(INTPREC - 2 - e);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) q[r][c] = (int)rintf(__fmul_rn(v[r][c], scale));
#pragma unroll
  for (int c = 0; c < 4; ++c) fwd_lift(q[0][c], q[1][c], q[2][c], q[3][c]);
#pragma unroll
  for (int r = 0; r < 4; ++r) fwd_lift(q[r][0], q[r][1], q[r][2], q[r][3]);
  return e;
}

}  // namespace zfp
