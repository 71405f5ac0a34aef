// Leaf histogram of int8 radix-256 digits over a window of rows that is
// given on the device: exact int32 sums per (feature, digit stream, bin)
// of the rows [off, off + count) intersected with [0, N), where
// window = {off, count} is read by the kernel itself (P2).
//
// Replaces the TPU kernel behind tools/probe_dynhist.py `make_variant`
// (its `laneconcat`, `subconcat_T` and `digmat` bodies).  On the TPU the
// window reaches the grid through scalar prefetch (`PrefetchScalarGridSpec`,
// the grid sized from the window in blocks of `nb` rows, a VMEM tile), the
// 28 uint8 bins arrive as 7 packed int32 words and the 9 digits as 3 packed
// words or an [N, 9] int8 matrix, and each block contracts an int8 one-hot
// of its bins against its digits on the MXU into a VMEM accumulator.  It
// computes K1's function (csrc/leaf_hist.cu), and so does this kernel, with
// K1's row loop.
//
// What bounds it on an H100.  The bytes are rows * (4 * bin words + 12)
// (+ 9 for the matrix) + the 4*F*9*B output: 21.0 MB for the probe's
// 2^19-row window with words, 6.3 us at 3.35 TB/s.  The work is up to
// 9 * rows * F shared-memory atomics (132 M at that window), which bound it
// in practice, as they bound K1.  So the design spends nothing beside them:
//
//   * the grid does not follow the TPU's `nb`.  CUDA has no grid sized from
//     device memory, so the wrapper's plan (ops/window_hist.py
//     `plan_window`) sizes one wave from the card and never from the
//     window: (row chunks) x (feature groups).  Every block reads off and
//     count, clamps the window to [0, N) and takes chunk c of `chunks`
//     equal shares, rows [lo + rows*c/chunks, lo + rows*(c+1)/chunks);
//   * a feature group is one bin word: 4 features, a [4][9][B] int32
//     histogram in shared memory (36 KB at B = 256).  Word q of the bins
//     lies at `bin_words + q * bin_stride` (the words are the rows of one
//     [W, N] buffer), so a block reads its word from one base pointer and
//     a stride: no pointer table, no stack frame.  A
//     thread takes rows in turn, loads the row's digit words (or matrix
//     row) once into registers, unpacks the 9 digits (a byte b of a digit
//     word is (int8_t)b: sign extension) and adds every non-zero digit of
//     each of its 4 features into the shared bin with atomicAdd;
//   * the output is written whole by this one launch: nothing is zeroed
//     beforehand and no global atomics merge the blocks.  Each block stores
//     its histogram as a partial with plain stores, the launch is
//     cooperative (the plan never exceeds the blocks the card holds at
//     once), and after a grid barrier every thread of the grid sums output
//     entries over their group's partials in chunk order.
//
// The digit layout (words or matrix) is a template parameter.  `laneconcat`
// and `subconcat_T` differ on the TPU only in the orientation of the digit
// tile in VMEM, and `nb` only in the tile's rows; this kernel stages no
// tile, so every (layout, nb) of the probe runs the words or the matrix
// instantiation with the same plan.
//
// Exactness: integer sums (|digit| <= 128, N < 2^24), so any order of
// atomics gives the bits of the plain index_add_ version.  Rows outside the
// clamped window are never read; bins >= B are skipped; an empty window
// writes zeros.
//
// Launch rules: the kernel runs on the stream it is given (PyTorch's
// current stream), allocates nothing (the wrapper gives the partials),
// never reads the window on the host, and the C entry point returns
// cudaGetLastError() right after the launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kStreams = 9;
constexpr int kWordFeatures = 4;   // features of a bin word and of a block
constexpr int kMaxBinWords = 16;
constexpr int kMaxThreads = 1024;
constexpr int kLoads = 8;          // partial loads in flight a thread

template <bool kMatrix>
__global__ void __launch_bounds__(kMaxThreads)
window_hist_kernel(const uint32_t* __restrict__ bin_words,
                   long long bin_stride,
                   const uint32_t* __restrict__ digit_words,
                   long long digit_stride, const int8_t* __restrict__ dmat,
                   const int* __restrict__ window, long long n, int F, int B,
                   int chunks, int* __restrict__ partials,
                   int* __restrict__ out) {
  extern __shared__ int s_hist[];  // [nf][9][B]
  const int g = blockIdx.y;        // bin word g: features 4g .. 4g + nf - 1
  const int chunk = blockIdx.x;
  const int nf = min(kWordFeatures, F - g * kWordFeatures);
  const int E = kWordFeatures * kStreams * B;  // a group's entries
  const int n_sh = nf * kStreams * B;

  const long long off = window[0];
  const long long cnt = window[1];
  const long long lo = min(max(off, 0LL), n);
  const long long hi = min(max(off + cnt, lo), n);
  const long long rows = hi - lo;
  const long long r0 = lo + rows * chunk / chunks;
  const long long r1 = lo + rows * (chunk + 1) / chunks;

  for (int i = threadIdx.x; i < n_sh; i += blockDim.x) s_hist[i] = 0;
  __syncthreads();

  const uint32_t* bw = bin_words + g * bin_stride;
  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    int dg[kStreams];
    if constexpr (kMatrix) {
      const int8_t* d = dmat + r * kStreams;
#pragma unroll
      for (int k = 0; k < kStreams; ++k) dg[k] = static_cast<int>(d[k]);
    } else {
      const uint32_t w[3] = {digit_words[r], digit_words[digit_stride + r],
                             digit_words[2 * digit_stride + r]};
#pragma unroll
      for (int k = 0; k < kStreams; ++k)
        dg[k] = static_cast<int>(
            static_cast<int8_t>((w[k >> 2] >> (8 * (k & 3))) & 0xFFu));
    }
    const uint32_t word = bw[r];
#pragma unroll
    for (int j = 0; j < kWordFeatures; ++j) {
      const int bin = static_cast<int>((word >> (8 * j)) & 0xFFu);
      if (j >= nf || bin >= B) continue;
      int* h = s_hist + j * kStreams * B + bin;
#pragma unroll
      for (int k = 0; k < kStreams; ++k) {
        if (dg[k] != 0) atomicAdd(h + k * B, dg[k]);
      }
    }
  }

  __syncthreads();
  int* dst = partials + (static_cast<long long>(g) * chunks + chunk) * E;
  for (int i = threadIdx.x; i < n_sh; i += blockDim.x) dst[i] = s_hist[i];
  cg::this_grid().sync();
  // output entry e of group e / E: its partials in chunk order, E apart
  // (consecutive threads on consecutive entries: coalesced)
  const long long total = static_cast<long long>(F) * kStreams * B;
  const long long step =
      static_cast<long long>(gridDim.x) * gridDim.y * blockDim.x;
  for (long long e = (static_cast<long long>(blockIdx.y) * gridDim.x +
                      blockIdx.x) * blockDim.x + threadIdx.x;
       e < total; e += step) {
    const long long gg = e / E;
    const int* p = partials + gg * chunks * E + (e - gg * E);
    int s = 0;
    int q = 0;
    for (; q + kLoads <= chunks; q += kLoads) {
      int v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
        v[u] = __ldcg(p + static_cast<long long>(q + u) * E);
#pragma unroll
      for (int u = 0; u < kLoads; ++u) s += v[u];
    }
    for (; q < chunks; ++q) s += __ldcg(p + static_cast<long long>(q) * E);
    out[e] = s;
  }
}

template <bool kMatrix>
int launch(const uint32_t* bins, long long bin_stride, const uint32_t* dw,
           long long digit_stride, const int8_t* dmat, const int* window,
           long long n, int F, int B, int chunks, int threads, int* partials,
           int* out, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(chunks),
                     static_cast<unsigned>((F + kWordFeatures - 1) /
                                           kWordFeatures));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes =
      static_cast<size_t>(kWordFeatures) * kStreams * B * sizeof(int);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t l =
      cudaLaunchKernelEx(&cfg, window_hist_kernel<kMatrix>, bins, bin_stride,
                         dw, digit_stride, dmat, window, n, F, B, chunks,
                         partials, out);
  if (l != cudaSuccess) return static_cast<int>(l);
  return static_cast<int>(cudaGetLastError());
}

template <bool kMatrix>
int resident(int threads, int smem, int* blocks_per_sm, int* sms) {
  int dev = 0;
  cudaError_t r = cudaGetDevice(&dev);
  if (r == cudaSuccess)
    r = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (r == cudaSuccess)
    r = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, window_hist_kernel<kMatrix>, threads, smem);
  return static_cast<int>(r);
}

}  // namespace

extern "C" {

// The most blocks of the kernel (digits as a matrix when `matrix` != 0)
// with `threads` threads and `smem` bytes of dynamic shared memory that one
// SM holds at once, and the SM count: the wrapper's cooperative grid never
// exceeds their product.
int lgbt_window_resident_blocks(int matrix, int threads, int smem,
                                int* blocks_per_sm, int* sms) {
  return matrix ? resident<true>(threads, smem, blocks_per_sm, sms)
                : resident<false>(threads, smem, blocks_per_sm, sms);
}

// bin_words: bin word q (features 4q .. 4q + 3, feature f in byte f % 4) is
// the [n] int32 array at bin_words + q * bin_stride elements; digit words
// likewise at digit_words + q * digit_stride (q < 3), used when
// digit_matrix ([n, 9] int8) is null; window: device int32 {off, count}.
// Writes out [F, 9, B] int32 whole: a cooperative grid of chunks x
// ceil(F / 4) blocks (all resident), partials [ceil(F / 4), chunks, 4, 9, B]
// int32 with no initial value.
int lgbt_window_digit_histogram(const void* bin_words, long long bin_stride,
                                const void* digit_words,
                                long long digit_stride,
                                const void* digit_matrix, const void* window,
                                long long n, int F, int B, int chunks,
                                int threads, void* partials, void* out,
                                void* stream) {
  if (F < 1 || F > kWordFeatures * kMaxBinWords || B < 1 || B > 256 ||
      chunks < 1 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || partials == nullptr || bin_words == nullptr ||
      (digit_matrix == nullptr && digit_words == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t* bins = static_cast<const uint32_t*>(bin_words);
  const uint32_t* dw = static_cast<const uint32_t*>(digit_words);
  const int8_t* dmat = static_cast<const int8_t*>(digit_matrix);
  const int* win = static_cast<const int*>(window);
  int* pa = static_cast<int*>(partials);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dmat != nullptr
             ? launch<true>(bins, bin_stride, dw, digit_stride, dmat, win, n,
                            F, B, chunks, threads, pa, o, s)
             : launch<false>(bins, bin_stride, dw, digit_stride, dmat, win, n,
                             F, B, chunks, threads, pa, o, s);
}

}  // extern "C"
