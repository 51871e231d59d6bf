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
// pad.  The error is one FMA because that is what the reference computes:
// its optimization_barrier around q * two_eps does not survive XLA's CPU
// pipeline, which fuses the product and the subtraction into one loop
// that the CPU contracts into an FMA (an un-fused error moves codes on
// values that sit within an ulp of a bin edge).  Every operation is an
// __f*_rn intrinsic, so nvcc cannot contract or reorder anything else.
// two_eps and eps are the float32 values the plain version computes
// (f32(2 eps), f32(eps)).  The four-term difference is taken modulo 2^32,
// as int32 arithmetic wraps in the reference.
//
// Bound on the card: bytes.  Each element is read once (4 bytes) and one
// int32 code written, against ~25 float ops (one division).  The TPU
// kernel streams four shifted copies of the padded input from HBM and
// quantizes each (recompute over communicate).  Here a block stages its
// TM x TN tile plus a one-row, one-column halo in shared memory and
// quantizes each staged value once, so device memory sees each element
// about (1 + 1/TM + 1/TN) times and no input is padded.

#include <cuda_runtime.h>

namespace {

constexpr int TN = 32;        // tile columns: one warp, 128-byte rows
constexpr int TM = 16;        // tile rows
constexpr int THREADS = TM * TN;

__device__ __forceinline__ int quantize(float v, float two_eps, float eps) {
  int q = (int)rintf(__fdiv_rn(v, two_eps));
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float err = __fmaf_rn(-(float)q, two_eps, v);
    q += (int)(err > eps) - (int)(err < -eps);
  }
  return q;
}

__global__ void __launch_bounds__(THREADS)
lorenzo_kernel(const float* __restrict__ x, int* __restrict__ out, int m,
               int n, float two_eps, float eps) {
  __shared__ int sq[TM + 1][TN + 1];
  const int row0 = blockIdx.y * TM;
  const int col0 = blockIdx.x * TN;
  const int tid = threadIdx.y * TN + threadIdx.x;
  // stage Q of rows row0-1 .. row0+TM-1 and columns col0-1 .. col0+TN-1
  for (int t = tid; t < (TM + 1) * (TN + 1); t += THREADS) {
    const int r = t / (TN + 1);
    const int c = t - r * (TN + 1);
    const int i = row0 - 1 + r;
    const int j = col0 - 1 + c;
    int q = 0;
    if (i >= 0 && j >= 0 && i < m && j < n)
      q = quantize(x[(long long)i * n + j], two_eps, eps);
    sq[r][c] = q;
  }
  __syncthreads();
  const int i = row0 + threadIdx.y;
  const int j = col0 + threadIdx.x;
  if (i < m && j < n) {
    const int r = threadIdx.y + 1;
    const int c = threadIdx.x + 1;
    const unsigned d = (unsigned)sq[r][c] - (unsigned)sq[r - 1][c]
                       - (unsigned)sq[r][c - 1] + (unsigned)sq[r - 1][c - 1];
    out[(long long)i * n + j] = (int)d;
  }
}

}  // namespace

// x: (m, n) float32 contiguous; out: (m, n) int32.  two_eps = f32(2 eps),
// eps = f32(eps).  Returns cudaGetLastError() after the launch.
extern "C" int repro_lorenzo2d(const float* x, int* out, int m, int n,
                               float two_eps, float eps, void* stream) {
  if (m <= 0 || n <= 0) return (int)cudaGetLastError();
  const long long rows = (m + TM - 1) / TM;
  if (rows > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((n + TN - 1) / TN, (unsigned)rows);
  dim3 block(TN, TM);
  lorenzo_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(x, out, m, n,
                                                           two_eps, eps);
  return (int)cudaGetLastError();
}
