// XLA on the CPU computes float32 with denormals-are-zero and
// flush-to-zero: each operation reads a subnormal operand as a zero of
// its sign and writes a subnormal result as one.  The port's entry
// points flush the data once (quant.flush_subnormals), so a kernel's
// input holds no subnormal; the kernels flush the intermediates that can
// be subnormal where that changes their integer or bit-exact outputs,
// by these integer operations, which no compiler flag alters (built with
// nvcc -ftz=true instead, the q-ent kernel still disagreed with its
// flushing plain version on a slice with planted subnormals).  The plain
// versions flush the same intermediates with quant.flush_subnormals.
#pragma once

#include <cuda_runtime.h>

// a subnormal x becomes a zero of its sign; everything else is kept
__device__ __forceinline__ float ftz(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x7f800000u) ? x : __uint_as_float(u & 0x80000000u);
}

// the same for an x that is +0 or more (a square, a sum of squares)
__device__ __forceinline__ float ftz_nonneg(float x) {
  return x < 0x1p-126f ? 0.0f : x;
}
