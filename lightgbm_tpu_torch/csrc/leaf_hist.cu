// Leaf histogram of int8 radix-256 digits: exact int32 sums per
// (feature, digit stream, bin) over a contiguous window of rows.
//
// Replaces the TPU kernel lightgbm_tpu/ops/leafhist.py `_digit_hist_kernel`
// (reached through `digit_histogram_pallas`).  That kernel builds a one-hot
// matrix of the bins in VMEM and contracts it against the digit block on
// the MXU, because Mosaic has no cheap scatter.  Hopper has fast
// shared-memory atomics, so this is the direct form, a privatized
// histogram:
//
//   * the grid is (row chunks) x (feature groups).  A full [F, 9, B] int32
//     histogram at F = 28, B = 255 is 257 KB, more than one block's 227 KB,
//     so each block owns `fg` features (the wrapper picks fg so that a
//     block needs at most a third of an SM's shared memory: 7 features,
//     63 KB at B = 255, three blocks per SM);
//   * a block zeroes its [fg][9][B] int32 histogram in shared memory, then
//     each thread takes rows of the block's chunk in turn: it loads the
//     row's 9 digits once and, for each feature of the group, adds every
//     non-zero digit into the shared bin with atomicAdd;
//   * the block then adds its non-zero entries into the global [F, 9, B]
//     output (zeroed by the wrapper) with global atomicAdd.
//
// Exactness: every sum is an integer (|digit| <= 128, fewer than 2^24 rows
// per window), so any order of atomics gives the same bits as the plain
// index_add_ version.  Rows past `count` are never read (no padding), zero
// digits add nothing, and a window of 0 rows still launches one block per
// feature group and leaves the output zero.  Bins >= B are skipped.
//
// What bounds it on an H100: the bytes are S*F*itemsize + 9*S + 4*F*9*B
// (about 37 MB at the 1 M-row root, ~11 us at 3.35 TB/s); the work is up to
// 9*S*F shared-memory atomics, and same-address atomics within a warp
// serialize.  This first version is simple and exact; an int8 one-hot IMMA
// (tensor-core) variant, warp-aggregated atomics and TMA row loads are
// later work.
//
// Launch rules: the kernel runs on the stream it is given (PyTorch's
// current stream), allocates nothing, and the C entry point returns
// cudaGetLastError() right after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStreams = 9;

template <typename BinT>
__global__ void digit_hist_kernel(const BinT* __restrict__ bins,
                                  const int8_t* __restrict__ digits,
                                  long long start, long long count, int F,
                                  int B, int fg, long long rows_per_block,
                                  int* __restrict__ out) {
  extern __shared__ int s_hist[];  // [nf][9][B]
  const int f0 = blockIdx.y * fg;
  const int nf = min(fg, F - f0);
  const int n_sh = nf * kStreams * B;
  for (int i = threadIdx.x; i < n_sh; i += blockDim.x) s_hist[i] = 0;
  __syncthreads();

  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = min(r0 + rows_per_block, count);
  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const long long row = start + r;
    const int8_t* d = digits + row * kStreams;
    int dg[kStreams];
#pragma unroll
    for (int k = 0; k < kStreams; ++k) dg[k] = static_cast<int>(d[k]);
    const BinT* b = bins + row * F + f0;
    for (int j = 0; j < nf; ++j) {
      const int bin = static_cast<int>(b[j]);
      if (bin >= B) continue;
      int* h = s_hist + j * kStreams * B + bin;
#pragma unroll
      for (int k = 0; k < kStreams; ++k) {
        if (dg[k] != 0) atomicAdd(h + k * B, dg[k]);
      }
    }
  }
  __syncthreads();

  int* o = out + static_cast<long long>(f0) * kStreams * B;
  for (int i = threadIdx.x; i < n_sh; i += blockDim.x) {
    const int v = s_hist[i];
    if (v != 0) atomicAdd(o + i, v);
  }
}

template <typename BinT>
int launch(const void* bins, const int8_t* digits, long long start,
           long long count, int F, int B, int fg, long long rows_per_block,
           int* out, int threads, void* stream) {
  if (fg <= 0 || rows_per_block <= 0 || threads <= 0 || B <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(fg) * kStreams * B * sizeof(int);
  auto kern = digit_hist_kernel<BinT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  long long chunks = (count + rows_per_block - 1) / rows_per_block;
  if (chunks < 1) chunks = 1;
  const int groups = F > 0 ? (F + fg - 1) / fg : 1;
  dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(groups));
  kern<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const BinT*>(bins), digits, start, count, F, B, fg,
      rows_per_block, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// bins [N, F] row-major codes of `bin_bytes` bytes (1: uint8, 2: uint16),
// digits [N, 9] int8; sums rows [start, start + count) into out [F, 9, B]
// int32, which must be zero on entry.
int lgbt_digit_histogram(const void* bins, int bin_bytes, const void* digits,
                         long long start, long long count, int F, int B,
                         int fg, long long rows_per_block, int* out,
                         int threads, void* stream) {
  const int8_t* d = static_cast<const int8_t*>(digits);
  if (bin_bytes == 1)
    return launch<uint8_t>(bins, d, start, count, F, B, fg, rows_per_block,
                           out, threads, stream);
  if (bin_bytes == 2)
    return launch<uint16_t>(bins, d, start, count, F, B, fg, rows_per_block,
                            out, threads, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
