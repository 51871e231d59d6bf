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
//     repeated: xor-1, xor-2, ... xor-16 shuffles inside a warp, then
//     the same pairing across the 8 warps;
//   * tile sums are added in tile order starting from 0.0f.
// Every operation is an __f*_rn intrinsic, so nvcc cannot contract or
// reassociate any of it.  Elements past the end of the slice count as
// 0.0f, the reference's zero padding: their error is exactly +0.
//
// Bound on the card: bytes.  Each element is read once (4 bytes) for
// all eps, against ~10 float ops per (element, eps).  The TPU kernel
// carries the running sum across its sequential grid; blocks on the card
// run in no order, so pass 1 (one block per (tile, slice)) writes each
// tile's sum per eps to a (T, k * e) buffer, and pass 2 adds those in
// tile order, one thread per (slice, eps), reading coalesced rows.  The
// sequential chain stays bit-exact without serialising pass 1.

#include <cuda_runtime.h>

namespace {

constexpr float CODE_MIN = -2147483648.0f;
constexpr float CODE_MAX = 2147483520.0f;
constexpr int TILE = 2048;
constexpr int COLS = TILE / 8;          // 256 columns, one per thread
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float qdq_err(float v, float eps) {
  float q = floorf(__fdiv_rn(v, eps));
  q = fminf(fmaxf(q, CODE_MIN), CODE_MAX);
  const float code = (float)(int)q;
  return __fmaf_rn(-code, eps, v);
}

__global__ void __launch_bounds__(COLS)
tile_sse_kernel(const float* __restrict__ x, const float* __restrict__ epss,
                float* __restrict__ partial, long long n, int n_eps,
                int rows) {
  const long long t = blockIdx.x;        // tile
  const int s = blockIdx.y;              // slice
  const int col = threadIdx.x;
  const int lane = col & 31;
  const int warp = col >> 5;
  __shared__ float wsum[COLS / 32];

  const float* xs = x + (long long)s * n;
  const long long base = t * TILE + (long long)col * 8;
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = (base + j < n) ? xs[base + j] : 0.0f;

  for (int ei = 0; ei < n_eps; ++ei) {
    const float eps = epss[ei];
    float e[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = qdq_err(v[j], eps);
    const float p01 = __fmaf_rn(e[0], e[0], __fmul_rn(e[1], e[1]));
    const float p23 = __fmaf_rn(e[2], e[2], __fmul_rn(e[3], e[3]));
    const float p45 = __fmaf_rn(e[4], e[4], __fmul_rn(e[5], e[5]));
    const float p67 = __fmaf_rn(e[6], e[6], __fmul_rn(e[7], e[7]));
    float w = __fadd_rn(__fadd_rn(p01, p23), __fadd_rn(p45, p67));
    // lane l ends with the tree sum of its aligned group; float addition
    // is commutative, so both partners of a pair hold the same bits
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
      w = __fadd_rn(w, __shfl_xor_sync(FULL, w, off));
    if (lane == 0) wsum[warp] = w;
    __syncthreads();
    if (warp == 0) {
      float u = lane < COLS / 32 ? wsum[lane] : 0.0f;
#pragma unroll
      for (int off = 1; off < COLS / 32; off <<= 1)
        u = __fadd_rn(u, __shfl_xor_sync(FULL, u, off));
      if (lane == 0) partial[t * rows + (long long)s * n_eps + ei] = u;
    }
    __syncthreads();
  }
}

__global__ void sum_tiles_kernel(const float* __restrict__ partial,
                                 float* __restrict__ sse, long long tiles,
                                 int rows) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  float acc = 0.0f;
  for (long long t = 0; t < tiles; ++t)
    acc = __fadd_rn(acc, partial[t * rows + r]);
  sse[r] = acc;
}

}  // namespace

// x: (k, n) float32 contiguous; epss: (n_eps,) float32 on the device;
// partial: (ceil(n / 2048), k * n_eps) float32 scratch; sse: (k, n_eps).
// Returns cudaGetLastError() after the two launches.
extern "C" int repro_quality_sse(const float* x, const float* epss,
                                 float* partial, float* sse, int k,
                                 long long n, int n_eps, void* stream) {
  if (k <= 0 || n_eps <= 0) return (int)cudaGetLastError();
  const long long tiles = (n + TILE - 1) / TILE;
  const int rows = k * n_eps;
  cudaStream_t st = (cudaStream_t)stream;
  if (tiles > 0) {
    dim3 grid((unsigned)tiles, k);
    tile_sse_kernel<<<grid, COLS, 0, st>>>(x, epss, partial, n, n_eps, rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  sum_tiles_kernel<<<(rows + 127) / 128, 128, 0, st>>>(partial, sse, tiles,
                                                        rows);
  return (int)cudaGetLastError();
}
