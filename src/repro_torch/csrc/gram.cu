// Batched Gram matrix G = A^T A per slice, in IEEE float32.
//
// Replaces: src/repro/kernels/gram/gram.py, gram_xtx_batched (and
// gram_xtx as its k = 1 case), reached through kernels/gram/ops.py.
//
// A slice is an (m, n) row-major matrix X.  With contraction length T
// and output edge N, the kernel reads A(t, a) = x[t * stride_t +
// a * stride_a]:  X^T X is (T, N) = (m, n), stride_t = n, stride_a = 1;
// X X^T is (T, N) = (n, m), stride_t = 1, stride_a = n.  So both
// orientations read the slice in place, with no transposed copy.
//
// Bound on the card: operations.  The product needs N(N+1)/2 * T
// fused multiply-adds per slice (the symmetric half), against
// (T*N + N*N) * 4 bytes; at N = T = 1800 that is ~870 flops per byte,
// far above the H100's float32 ridge (67 TFLOP/s over 3.35 TB/s = 20).
// Tensor cores are excluded on purpose: TF32 keeps a 10-bit mantissa,
// and svd_trunc counts eigenvalues against a 0.99 variance threshold,
// which such rounding moves.  So the design is a classic shared-memory
// SGEMM on the FP32 pipes:
//   * one block per 64x64 output tile with i-block <= j-block only (the
//     lower triangle is the mirror image; blocks below the diagonal exit
//     at once), 256 threads each owning a 4x4 register tile;
//   * 16-deep contraction chunks staged in shared memory, rows padded by
//     one word so the transposed (X X^T) staging is bank-conflict free;
//   * each chunk is summed into a fresh register partial, then added to
//     the running sum: the per-chunk blocking the TPU kernel also has
//     (bk = 128), which keeps the rounding error of a 1800-long sum
//     several times below a single sequential chain;
//   * the ragged edge is masked at load time (zeros), so no padding.
// Every product is __fmaf_rn and every sum __fadd_rn, so the tile's
// (i, j) and (j, i) values are the same bits and the mirror is exact.

#include <cuda_runtime.h>

namespace {

constexpr int BN = 64;        // output tile edge
constexpr int BK = 16;        // contraction chunk
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int PAD = 1;

__global__ void __launch_bounds__(THREADS)
gram_kernel(const float* __restrict__ x, float* __restrict__ g, int T, int N,
            long long slice_stride, long long stride_t, long long stride_a,
            int contiguous_a) {
  const int bj = blockIdx.x;
  const int bi = blockIdx.y;
  if (bi > bj) return;                       // lower triangle: mirrored
  const int s = blockIdx.z;
  const float* xs = x + (long long)s * slice_stride;
  float* gs = g + (long long)s * N * N;

  __shared__ float As[BK][BN + PAD];
  __shared__ float Bs[BK][BN + PAD];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int i0 = bi * BN;
  const int j0 = bj * BN;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;

  for (int t0 = 0; t0 < T; t0 += BK) {
    // stage A(t0 : t0+BK, i0 : i0+BN) and A(t0 : t0+BK, j0 : j0+BN);
    // neighbouring threads take neighbouring addresses of the slice
#pragma unroll
    for (int r = 0; r < (BK * BN) / THREADS; ++r) {
      const int e = tid + r * THREADS;
      int tl, al;
      if (contiguous_a) { tl = e / BN; al = e % BN; }
      else              { tl = e % BK; al = e / BK; }
      const int t = t0 + tl;
      const int ia = i0 + al;
      const int ja = j0 + al;
      float va = 0.0f, vb = 0.0f;
      if (t < T) {
        const long long row = (long long)t * stride_t;
        if (ia < N) va = xs[row + (long long)ia * stride_a];
        if (ja < N) vb = xs[row + (long long)ja * stride_a];
      }
      As[tl][al] = va;
      Bs[tl][al] = vb;
    }
    __syncthreads();

    float part[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[r][c] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = As[kk][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = Bs[kk][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          part[r][c] = __fmaf_rn(a[r], b[c], part[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = __fadd_rn(acc[r][c], part[r][c]);
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= N) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      if (j >= N) continue;
      gs[(long long)i * N + j] = acc[r][c];
      if (bi != bj) gs[(long long)j * N + i] = acc[r][c];
    }
  }
}

}  // namespace

// x: k slices of (m, n) float32, row-major, contiguous.
// g: k outputs of (N, N) float32, N = n if xtx else m.
// Returns cudaGetLastError() after the launch.
extern "C" int repro_gram_batched(const float* x, float* g, int k, int m,
                                  int n, int xtx, void* stream) {
  const int T = xtx ? m : n;
  const int N = xtx ? n : m;
  const long long stride_t = xtx ? n : 1;
  const long long stride_a = xtx ? 1 : n;
  const int tiles = (N + BN - 1) / BN;
  if (k <= 0 || N <= 0) return (int)cudaGetLastError();
  dim3 grid(tiles, tiles, k);
  gram_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      x, g, T, N, (long long)m * n, stride_t, stride_a, xtx);
  return (int)cudaGetLastError();
}
