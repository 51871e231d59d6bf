// Fused multi-eps quantize + hashed histogram (the q-ent predictor).
//
// Replaces: src/repro/kernels/qent/qent.py, qent_histogram_sweep, and
// the pad-and-subtract correction of kernels/qent/ops.py (nothing is
// padded here: each block masks its own element range, so the
// histogram is the same without a correction).
//
// For slice s, error bound eps[e] and element v:
//   code = (int) clip(floorf(v / eps), INT32_CODE_MIN, INT32_CODE_MAX)
//   bin  = code mod bins, taken positive
//   hist[s, e, bin] += 1
// The division is __fdiv_rn (IEEE, correctly rounded), matching the
// reference's jitted x / eps bit for bit.
//
// Bound on the card: bytes.  Each element is read once (4 bytes) and
// quantized at every eps with a handful of float ops, well under the
// H100's 20 flops-per-byte ridge.  The TPU kernel compares codes to a
// bin iota because VMEM has no scatter; here the histogram lives in
// shared memory and is filled with shared-memory atomics.  65536 int32
// bins are 256 KiB, above the 227 KB a block may use, so:
//   * the bin range is split into chunks that fit shared memory, one
//     chunk per block; a block counts only codes that fall in its chunk
//     and keeps the histograms of a group of eps side by side, so it
//     reads its elements once for the whole group;
//   * the chunk index varies fastest in the grid, so the blocks that
//     share an element range run together and re-read it from L2, not
//     device memory;
//   * each block owns a run of elements of one slice; at the end it adds
//     its non-zero bins to the global histogram with atomicAdd.
// Integer counts make every schedule give the same histogram bits.
// A 2-CTA cluster over distributed shared memory would halve the chunk
// count; that is a later optimisation.

#include <cuda_runtime.h>

namespace {

constexpr float CODE_MIN = -2147483648.0f;
constexpr float CODE_MAX = 2147483520.0f;
constexpr int THREADS = 512;

__global__ void __launch_bounds__(THREADS)
qent_hist_kernel(const float* __restrict__ x, const float* __restrict__ epss,
                 int* __restrict__ hist, long long n, int n_eps, int bins,
                 int chunk, int eps_per_block, int groups,
                 long long per_block) {
  extern __shared__ int sh[];
  const int c = blockIdx.x;                  // bin chunk
  const long long run = blockIdx.y;          // element run
  const int s = blockIdx.z / groups;         // slice
  const int grp = blockIdx.z % groups;       // eps group
  const int e0 = grp * eps_per_block;
  const int ne = n_eps - e0 < eps_per_block ? n_eps - e0 : eps_per_block;
  const int lo_bin = c * chunk;
  const int width = bins - lo_bin < chunk ? bins - lo_bin : chunk;

  for (int j = threadIdx.x; j < ne * width; j += blockDim.x) sh[j] = 0;
  __syncthreads();

  const float* xs = x + (long long)s * n;
  const long long start = run * per_block;
  const long long end = start + per_block < n ? start + per_block : n;
  for (long long i = start + threadIdx.x; i < end; i += blockDim.x) {
    const float v = xs[i];
    for (int ei = 0; ei < ne; ++ei) {
      float q = floorf(__fdiv_rn(v, epss[e0 + ei]));
      q = fminf(fmaxf(q, CODE_MIN), CODE_MAX);
      int b = ((int)q) % bins;
      if (b < 0) b += bins;
      const int off = b - lo_bin;
      if ((unsigned)off < (unsigned)width) atomicAdd(&sh[ei * width + off], 1);
    }
  }
  __syncthreads();

  for (int j = threadIdx.x; j < ne * width; j += blockDim.x) {
    const int cnt = sh[j];
    if (cnt) {
      const int ei = j / width;
      const long long row = (long long)s * n_eps + e0 + ei;
      atomicAdd(&hist[row * bins + lo_bin + (j - ei * width)], cnt);
    }
  }
}

}  // namespace

// x: (k, n) float32 contiguous; epss: (n_eps,) float32 on the device;
// hist: (k, n_eps, bins) int32, ZEROED by the caller.
// smem_budget: bytes of shared memory a block may take for counters.
// Returns cudaGetLastError() after the launch.
extern "C" int repro_qent_hist(const float* x, const float* epss, int* hist,
                               int k, long long n, int n_eps, int bins,
                               int smem_budget, void* stream) {
  if (k <= 0 || n <= 0 || n_eps <= 0) return (int)cudaGetLastError();
  const int slots = smem_budget / (int)sizeof(int);
  const int eps_per_block = n_eps < 8 ? n_eps : 8;
  const int groups = (n_eps + eps_per_block - 1) / eps_per_block;
  int chunk = 1;
  while (chunk * 2 <= slots / eps_per_block) chunk *= 2;
  if (chunk > bins) chunk = bins;
  const int chunks = (bins + chunk - 1) / chunk;

  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long per_slice_blocks = (long long)chunks * groups * k;
  long long runs = (4LL * sms + per_slice_blocks - 1) / per_slice_blocks;
  const long long max_runs = (n + 4095) / 4096;   // >= 4096 elements a run
  if (runs > max_runs) runs = max_runs;
  if (runs < 1) runs = 1;
  if (runs > 65535) runs = 65535;
  const long long per_block = (n + runs - 1) / runs;
  runs = (n + per_block - 1) / per_block;

  const size_t smem = (size_t)eps_per_block * chunk * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      qent_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(chunks, (unsigned)runs, k * groups);
  qent_hist_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, epss, hist, n, n_eps, bins, chunk, eps_per_block, groups, per_block);
  return (int)cudaGetLastError();
}
