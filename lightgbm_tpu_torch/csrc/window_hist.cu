// Leaf histogram of int8 radix-256 digits over a window of rows that is
// given on the device: exact int32 sums per (feature, digit stream, bin)
// of the rows [off, off + count) intersected with [0, N), where
// window = {off, count} is read by the kernel itself.
//
// Replaces the TPU kernel behind tools/probe_dynhist.py `make_variant`
// (its `laneconcat`, `subconcat_T` and `digmat` bodies).  On the TPU the
// window reaches the grid through scalar prefetch (`PrefetchScalarGridSpec`,
// the grid sized from the window), the 28 uint8 bins arrive as 7 packed
// int32 words and the 9 digits as 3 packed words or an [N, 9] int8 matrix,
// and each block contracts an int8 one-hot of its bins against its digits
// on the MXU into a VMEM accumulator.  It computes K1's function; so does
// this kernel, with K1's design (csrc/leaf_hist.cu):
//
//   * CUDA has no grid sized from device memory, so the grid is fixed by
//     N: (row chunks) x (feature groups).  Every block reads off and count,
//     clamps the window to [0, N) and finds its chunk of it; a block whose
//     chunk lies past the window returns at once, before touching shared
//     memory.  With `rows_per_block` > 0 each block takes that many rows of
//     the window (the probe's `nb`; the wrapper launches ceil(N / nb)
//     chunks, enough for a window of all N rows); with 0 the window is
//     split as K1 splits a window of the same size: min(ceil(rows /
//     threads), gridDim.x) chunks of equal size;
//   * each live block zeroes its privatized [fg][9][B] int32 histogram in
//     shared memory (fg features of the group: 7 at F = 28, B = 256, 63 KB,
//     three blocks an SM), each thread takes rows in turn, unpacks the
//     row's 9 digits once (a byte b of a digit word is (int8_t)b: sign
//     extension) and, feature by feature, the bin byte from its word, and
//     adds every non-zero digit into the shared bin with atomicAdd;
//   * the block adds its non-zero entries into the global [F, 9, B] output
//     (zeroed by the wrapper) with global atomicAdd.
//
// The digit layout (words or matrix) is a template parameter.  `laneconcat`
// and `subconcat_T` differ on the TPU only in the orientation of the digit
// tile in VMEM; this kernel stages no digit tile, so both run the words
// instantiation.
//
// Exactness: integer sums (|digit| <= 128, N < 2^24), so any order of
// atomics gives the bits of the plain index_add_ version.  Rows outside the
// clamped window are never read; bins >= B are skipped.
//
// What bounds it on an H100: the bytes are rows * (4 * bin words + 12)
// (or + 9 for the matrix) + the 4*F*9*B output: 21.0 MB for the probe's
// 2^19-row window with words, 6.3 us at 3.35 TB/s; the work is up to
// 9 * rows * F shared-memory atomics, which bound it in practice, as they
// bound K1.
//
// Launch rules: the kernel runs on the stream it is given (PyTorch's
// current stream), allocates nothing, never reads the window on the host,
// and the C entry point returns cudaGetLastError() right after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStreams = 9;
constexpr int kDigitWords = 3;
constexpr int kMaxBinWords = 16;

struct BinWords {
  const uint32_t* p[kMaxBinWords];
};
struct DigitWords {
  const uint32_t* p[kDigitWords];
};

template <bool kMatrix>
__global__ void window_hist_kernel(BinWords bins, DigitWords dwords,
                                   const int8_t* __restrict__ dmat,
                                   const int* __restrict__ window,
                                   long long n, int F, int B, int fg,
                                   long long rows_per_block,
                                   int* __restrict__ out) {
  extern __shared__ int s_hist[];  // [nf][9][B]
  const long long off = window[0];
  const long long cnt = window[1];
  const long long lo = min(max(off, 0LL), n);
  const long long hi = min(max(off + cnt, lo), n);
  const long long rows = hi - lo;
  if (rows <= 0) return;
  long long rpb = rows_per_block;
  if (rpb <= 0) {
    long long chunks = (rows + blockDim.x - 1) / blockDim.x;
    chunks = max(1LL, min(chunks, static_cast<long long>(gridDim.x)));
    rpb = (rows + chunks - 1) / chunks;
  }
  const long long r0 = lo + static_cast<long long>(blockIdx.x) * rpb;
  if (r0 >= hi) return;  // uniform across the block: before any barrier
  const long long r1 = min(r0 + rpb, hi);

  const int f0 = blockIdx.y * fg;
  const int nf = min(fg, F - f0);
  const int n_sh = nf * kStreams * B;
  for (int i = threadIdx.x; i < n_sh; i += blockDim.x) s_hist[i] = 0;
  __syncthreads();

  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    int dg[kStreams];
    if (kMatrix) {
      const int8_t* d = dmat + r * kStreams;
#pragma unroll
      for (int k = 0; k < kStreams; ++k) dg[k] = static_cast<int>(d[k]);
    } else {
      uint32_t w[kDigitWords];
#pragma unroll
      for (int q = 0; q < kDigitWords; ++q) w[q] = dwords.p[q][r];
#pragma unroll
      for (int k = 0; k < kStreams; ++k)
        dg[k] = static_cast<int>(
            static_cast<int8_t>((w[k >> 2] >> (8 * (k & 3))) & 0xFFu));
    }
    int word_at = -1;
    uint32_t word = 0;
    for (int j = 0; j < nf; ++j) {
      const int f = f0 + j;
      if ((f >> 2) != word_at) {
        word_at = f >> 2;
        word = bins.p[word_at][r];
      }
      const int bin = static_cast<int>((word >> (8 * (f & 3))) & 0xFFu);
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

template <bool kMatrix>
int launch(const BinWords& bins, const DigitWords& dwords,
           const int8_t* dmat, const int* window, long long n, int F, int B,
           int fg, long long rows_per_block, int chunks, int* out,
           int threads, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(fg) * kStreams * B * sizeof(int);
  auto kern = window_hist_kernel<kMatrix>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int groups = (F + fg - 1) / fg;
  dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(groups));
  kern<<<grid, threads, smem, stream>>>(bins, dwords, dmat, window, n, F, B,
                                        fg, rows_per_block, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// bin_words: host array of n_bin_words device pointers to [n] int32 words
// (feature f in byte f % 4 of word f / 4); digit_words: host array of 3
// device pointers to [n] int32 digit words, used when digit_matrix is null;
// digit_matrix: [n, 9] int8 or null; window: device int32 {off, count}.
// Sums into out [F, 9, B] int32, which must be zero on entry.
int lgbt_window_digit_histogram(const void* const* bin_words,
                                int n_bin_words,
                                const void* const* digit_words,
                                const void* digit_matrix, const void* window,
                                long long n, int F, int B, int fg,
                                long long rows_per_block, int chunks,
                                void* out, int threads, void* stream) {
  if (n_bin_words < 1 || n_bin_words > kMaxBinWords || F < 1 ||
      F > 4 * n_bin_words || B < 1 || B > 256 || fg < 1 || chunks < 1 ||
      threads < 1 || rows_per_block < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  BinWords bins = {};
  for (int i = 0; i < n_bin_words; ++i)
    bins.p[i] = static_cast<const uint32_t*>(bin_words[i]);
  DigitWords dwords = {};
  const int8_t* dmat = static_cast<const int8_t*>(digit_matrix);
  if (dmat == nullptr) {
    for (int q = 0; q < kDigitWords; ++q)
      dwords.p[q] = static_cast<const uint32_t*>(digit_words[q]);
  }
  const int* win = static_cast<const int*>(window);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dmat != nullptr)
    return launch<true>(bins, dwords, dmat, win, n, F, B, fg, rows_per_block,
                        chunks, o, threads, s);
  return launch<false>(bins, dwords, dmat, win, n, F, B, fg, rows_per_block,
                       chunks, o, threads, s);
}

}  // extern "C"
