// Batched Gram matrix G = A^T A per slice, in IEEE float32, for Hopper.
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
// which such rounding moves (3xTF32 wgmma would not round like IEEE
// float32 either).  So the design is an SGEMM on the FP32 pipes:
//   * 128 x 128 output tiles, 256 threads, each owning an 8 x 8 register
//     tile (two 4-row by two 4-column quadrants, read from shared memory
//     with 128-bit loads: 16 bytes of operands per 16 FMAs);
//   * only the upper-triangle tiles are launched: a linear tile index is
//     mapped to (bi <= bj), and the lower triangle is the mirrored write,
//     so no block exits at once;
//   * a 3-deep ring of 32-deep contraction stages filled by cp.async
//     (one __syncthreads per stage; the copies of stages s + 1 and s + 2
//     overlap the FMAs of stage s).  X^T X rows are copied 16 bytes at a
//     time; the X X^T orientation, whose contiguous axis is the
//     contraction, is copied 4 bytes at a time into the same [t][a]
//     layout, a warp taking 8 t x 4 a so that its global reads fill whole
//     32-byte sectors and its shared writes, on rows padded to 132 words,
//     hit 32 distinct banks.  The ragged edge (1800 = 14 * 128 + 8) is
//     zero-filled by cp.async's source size, so nothing is padded or
//     cropped;
//   * the contraction is cut into chunks of chunk_t (a multiple of the
//     32-deep stage) by a rule of the slice's own (N, T) that the wrapper
//     computes (kernels/gram/ops.py: contraction_chunks), never of the
//     batch or the card: so a slice gets the same bits alone, in its
//     batch or in a padded bucket.  One chunk (every slice edge up to a
//     few thousand) writes its tile of G directly.  Several chunks (a
//     volume's mode unfolding, T ~ 10^5) give each (chunk, tile, slice)
//     its own CTA, which writes its partial tile to global memory; a
//     second kernel sums each entry's partials in chunk order: no float
//     atomics, and 24-36 chunks a tile fill the 132 SMs where a cluster
//     of at most 8 left them idle;
//   * numerics: each 32-deep stage of the contraction is summed into a
//     fresh register partial (its first product a multiply) and then
//     added to the running sum (the TPU kernel's bk blocking), which
//     keeps the rounding error of a long sum well below one sequential
//     chain.  Every product and sum is PTX's mul/fma/add.rn.ftz.f32:
//     round to nearest, and a subnormal operand or result reads as a
//     zero, as XLA's CPU dot reads and writes it (a slice whose centred
//     values all lie below 2^-63 has a zero Gram there, and here).  The
//     .ftz forms time the same as __fmul_rn / __fmaf_rn / __fadd_rn
//     (tools/ab_kernels.py --gram-rn); nvcc's -ftz=true is not used,
//     since it would move the other kernels' operations.  So on
//     a diagonal tile (i, j) and (j, i) are the same bits, and elsewhere
//     the mirror writes one value twice.
//
// On the H100 80GB HBM3 at 700 W this reaches about half the FP32 bound
// at (32, 1800, 1800) and beats torch.bmm / torch.mm at every slice
// shape; at Table 4's volume unfoldings it reaches ~30 % (its X X^T
// copies are 4 bytes wide) and beats torch.bmm at (12, 256, 147456) but
// not at (12, 384, 98304) (PERF.md, from chip_smoke.py).  Registers
// (185-223 a thread) allow one 256-thread CTA per SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;            // output tile edge
constexpr int BK = 32;             // contraction depth of one stage, and
                                   // of one partial sum
constexpr int STAGES = 3;          // cp.async ring depth
constexpr int THREADS = 256;       // 16 x 16 threads, 8 x 8 outputs each
constexpr int LD = BM + 4;         // padded row, still 16-byte aligned
constexpr int STAGE_FLOATS = 2 * BK * LD;
constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * (int)sizeof(float);
constexpr int TILE_FLOATS = BM * BM;
constexpr int REDUCE_THREADS = 256;

enum Mode { VEC_ROWS = 0, ROWS = 1, COLS = 2 };

// round-to-nearest float32 arithmetic that reads a subnormal operand and
// writes a subnormal result as a zero of its sign (XLA's CPU rule)
__device__ __forceinline__ float mul_ftz(float a, float b) {
  float r;
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float fma_ftz(float a, float b, float c) {
  float r;
  asm("fma.rn.ftz.f32 %0, %1, %2, %3;" : "=f"(r) : "f"(a), "f"(b), "f"(c));
  return r;
}

__device__ __forceinline__ float add_ftz(float a, float b) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N_PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N_PENDING));
}

// Stage A(t0 : t0+BK, c0 : c0+BM) into dst[t][a] (row stride LD); rows
// t >= t_hi and columns a >= N are zero-filled.
template <int MODE>
__device__ __forceinline__ void load_stage(float* dst, const float* xs,
                                           int t0, int t_hi, int c0, int N,
                                           long long stride_t,
                                           long long stride_a, int tid) {
  if (MODE == VEC_ROWS) {                    // X^T X, n % 4 == 0, aligned
#pragma unroll
    for (int r = 0; r < (BK * BM / 4) / THREADS; ++r) {
      const int v = tid + r * THREADS;
      const int tl = v / (BM / 4);
      const int al = (v % (BM / 4)) * 4;
      const int t = t0 + tl, a = c0 + al;
      const bool ok = t < t_hi && a < N;
      cp_async16(dst + tl * LD + al,
                 ok ? xs + (long long)t * stride_t + a : xs, ok);
    }
  } else {
#pragma unroll 4
    for (int r = 0; r < (BK * BM) / THREADS; ++r) {
      const int e = tid + r * THREADS;
      int tl, al;
      if (MODE == ROWS) { tl = e / BM; al = e % BM; }
      else { tl = (e & 7) + 8 * (e >> 10); al = (e >> 3) & (BM - 1); }
      const int t = t0 + tl, a = c0 + al;
      const bool ok = t < t_hi && a < N;
      cp_async4(dst + tl * LD + al,
                ok ? xs + (long long)t * stride_t + (long long)a * stride_a
                   : xs, ok);
    }
  }
}

__device__ __forceinline__ void store4(float* g, int N, int i, int j,
                                       float v0, float v1, float v2,
                                       float v3, bool vec) {
  if (i >= N) return;
  float* row = g + (long long)i * N;
  if (vec) {
    if (j < N) *reinterpret_cast<float4*>(row + j) = make_float4(v0, v1, v2, v3);
  } else {
    if (j < N) row[j] = v0;
    if (j + 1 < N) row[j + 1] = v1;
    if (j + 2 < N) row[j + 2] = v2;
    if (j + 3 < N) row[j + 3] = v3;
  }
}

// grid: (chunks, upper tiles, k).  With one chunk (PARTIAL false) the
// CTA writes its tile of G (and the mirror); with several it writes its
// partial tile to partial[((s * upper + tile) * chunks + chunk) * BM * BM],
// which gram_reduce_kernel sums in chunk order.  PARTIAL is a template
// argument, so the one-chunk kernel of every slice shape holds no code of
// the partial path.
template <int MODE, bool PARTIAL>
__global__ void __launch_bounds__(THREADS, 1)
gram_kernel(const float* __restrict__ x, float* __restrict__ g,
            float* __restrict__ partial, int T, int N, int tiles,
            long long slice_stride, long long stride_t, long long stride_a,
            int chunks, int chunk_t, int vec_out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  int idx = blockIdx.y, bi = 0;              // linear index -> (bi <= bj)
  while (idx >= tiles - bi) { idx -= tiles - bi; ++bi; }
  const int bj = bi + idx;
  const int s = blockIdx.z;
  const int chunk = blockIdx.x;
  const float* xs = x + (long long)s * slice_stride;
  float* gs = g + (long long)s * N * N;
  const int i0 = bi * BM, j0 = bj * BM;
  const int t_lo = chunk * chunk_t;
  const int t_hi = min(T, t_lo + chunk_t);
  const int ntiles = t_hi > t_lo ? (t_hi - t_lo + BK - 1) / BK : 0;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  float acc[8][8], part[8][8];               // part: set by each kk == 0
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < ntiles) {
      float* as = smem + st * STAGE_FLOATS;
      const int t0 = t_lo + st * BK;
      load_stage<MODE>(as, xs, t0, t_hi, i0, N, stride_t, stride_a, tid);
      load_stage<MODE>(as + BK * LD, xs, t0, t_hi, j0, N, stride_t,
                       stride_a, tid);
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < ntiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    {   // refill the slot every thread finished with in stage kt - 1
      const int nt = kt + STAGES - 1;
      if (nt < ntiles) {
        float* as = smem + (nt % STAGES) * STAGE_FLOATS;
        const int t0 = t_lo + nt * BK;
        load_stage<MODE>(as, xs, t0, t_hi, i0, N, stride_t, stride_a, tid);
        load_stage<MODE>(as + BK * LD, xs, t0, t_hi, j0, N, stride_t,
                         stride_a, tid);
      }
      cp_async_commit();
    }
    const float* As = smem + (kt % STAGES) * STAGE_FLOATS;
    const float* Bs = As + BK * LD;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(As + kk * LD + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(As + kk * LD + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * LD + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(Bs + kk * LD + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          part[r][c] = kk == 0 ? mul_ftz(a[r], b[c])
                               : fma_ftz(a[r], b[c], part[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = add_ftz(acc[r][c], part[r][c]);
  }
  cp_async_wait<0>();

  if (PARTIAL) {          // partial tile, row-major, for the reduction
    float* pt = partial +
        (((long long)s * gridDim.y + blockIdx.y) * chunks + chunk) * TILE_FLOATS;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int hc = 0; hc < 2; ++hc)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          *reinterpret_cast<float4*>(
              pt + (hr * 64 + ty * 4 + r) * BM + hc * 64 + tx * 4) =
              make_float4(acc[hr * 4 + r][hc * 4 + 0],
                          acc[hr * 4 + r][hc * 4 + 1],
                          acc[hr * 4 + r][hc * 4 + 2],
                          acc[hr * 4 + r][hc * 4 + 3]);
    return;
  }
  const bool mirror = bi != bj;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)
#pragma unroll
    for (int hc = 0; hc < 2; ++hc) {
      const int ib = i0 + hr * 64 + ty * 4;
      const int jb = j0 + hc * 64 + tx * 4;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        store4(gs, N, ib + r, jb, acc[hr * 4 + r][hc * 4 + 0],
               acc[hr * 4 + r][hc * 4 + 1], acc[hr * 4 + r][hc * 4 + 2],
               acc[hr * 4 + r][hc * 4 + 3], vec_out);
      if (mirror) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          store4(gs, N, jb + c, ib, acc[hr * 4 + 0][hc * 4 + c],
                 acc[hr * 4 + 1][hc * 4 + c], acc[hr * 4 + 2][hc * 4 + c],
                 acc[hr * 4 + 3][hc * 4 + c], vec_out);
      }
    }
}

// grid: (BM * BM / REDUCE_THREADS, upper tiles, k).  Entry e of a tile is
// the sum of its chunks' partials, added in chunk order from the first;
// consecutive threads read consecutive entries of each partial tile.
__global__ void __launch_bounds__(REDUCE_THREADS)
gram_reduce_kernel(const float* __restrict__ partial, float* __restrict__ g,
                   int N, int tiles, int chunks) {
  int idx = blockIdx.y, bi = 0;
  while (idx >= tiles - bi) { idx -= tiles - bi; ++bi; }
  const int bj = bi + idx;
  const int e = blockIdx.x * REDUCE_THREADS + threadIdx.x;
  const int i = bi * BM + e / BM, j = bj * BM + e % BM;
  if (i >= N || j >= N) return;
  const float* p = partial +
      ((long long)blockIdx.z * gridDim.y + blockIdx.y) * chunks * TILE_FLOATS + e;
  float sum = p[0];
  for (int c = 1; c < chunks; ++c)
    sum = add_ftz(sum, p[(long long)c * TILE_FLOATS]);
  float* gs = g + (long long)blockIdx.z * N * N;
  gs[(long long)i * N + j] = sum;
  if (bi != bj) gs[(long long)j * N + i] = sum;
}

template <int MODE>
int launch(const float* x, float* g, float* partial, int k, int T, int N,
           int tiles, long long upper, long long slice_stride,
           long long stride_t, long long stride_a, int chunks, int chunk_t,
           int vec_out, cudaStream_t stream) {
  const dim3 grid(chunks, (unsigned)upper, k);
  if (chunks == 1) {
    cudaError_t err = cudaFuncSetAttribute(
        gram_kernel<MODE, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    gram_kernel<MODE, false><<<grid, THREADS, SMEM_BYTES, stream>>>(
        x, g, partial, T, N, tiles, slice_stride, stride_t, stride_a, chunks,
        chunk_t, vec_out);
    return (int)cudaGetLastError();
  }
  cudaError_t err = cudaFuncSetAttribute(
      gram_kernel<MODE, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  gram_kernel<MODE, true><<<grid, THREADS, SMEM_BYTES, stream>>>(
      x, g, partial, T, N, tiles, slice_stride, stride_t, stride_a, chunks,
      chunk_t, vec_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gram_reduce_kernel<<<dim3(TILE_FLOATS / REDUCE_THREADS, (unsigned)upper, k),
                       REDUCE_THREADS, 0, stream>>>(partial, g, N, tiles,
                                                    chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// x: k slices of (m, n) float32, row-major, contiguous.
// g: k outputs of (N, N) float32, N = n if xtx else m.
// chunks, chunk_t: the contraction T (m if xtx else n) in `chunks` pieces
// of chunk_t, a multiple of 32, the last one ragged; the wrapper's rule.
// partial: k * upper * chunks * 128 * 128 float32 scratch when chunks > 1
// (upper = tiles * (tiles + 1) / 2, tiles = ceil(N / 128)), else unused.
// Returns cudaGetLastError() after the launches (or the error that
// refused one: no fallback).
extern "C" int repro_gram_batched(const float* x, float* g, float* partial,
                                  int k, int m, int n, int xtx, int chunks,
                                  int chunk_t, void* stream) {
  const int T = xtx ? m : n;
  const int N = xtx ? n : m;
  const long long stride_t = xtx ? n : 1;
  const long long stride_a = xtx ? 1 : n;
  if (k <= 0 || N <= 0) return (int)cudaGetLastError();
  const int tiles = (N + BM - 1) / BM;
  const long long upper = (long long)tiles * (tiles + 1) / 2;
  if (upper > 65535 || k > 65535 || chunks < 1 || chunk_t % BK != 0 ||
      (long long)chunks * chunk_t < T ||
      (long long)(chunks - 1) * chunk_t >= (T > 0 ? T : 1))
    return (int)cudaErrorInvalidValue;
  if (chunks > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;

  const int vec_out = N % 4 == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  const bool vec_in = xtx && n % 4 == 0 &&
                      (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long ss = (long long)m * n;
  if (!xtx)
    return launch<COLS>(x, g, partial, k, T, N, tiles, upper, ss, stride_t,
                        stride_a, chunks, chunk_t, vec_out, st);
  if (vec_in)
    return launch<VEC_ROWS>(x, g, partial, k, T, N, tiles, upper, ss,
                            stride_t, stride_a, chunks, chunk_t, vec_out, st);
  return launch<ROWS>(x, g, partial, k, T, N, tiles, upper, ss, stride_t,
                      stride_a, chunks, chunk_t, vec_out, st);
}
