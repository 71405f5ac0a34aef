// Leaf histogram of int8 radix-256 digits: exact int32 sums per
// (feature, digit stream, bin) over a contiguous window of rows (K1).
//
// Replaces the TPU kernel lightgbm_tpu/ops/leafhist.py `_digit_hist_kernel`
// (reached through `digit_histogram_pallas`).  That kernel builds a one-hot
// matrix of the bins in VMEM and contracts it against the digit block on
// the MXU, because Mosaic has no cheap scatter.  Hopper has fast
// shared-memory atomics, so this is the direct form, a privatized
// histogram per block.
//
// What bounds it on an H100.  The bytes are S*F*itemsize + 9*S + 4*F*9*B
// (about 37 MB at the 1M-row root, ~11 us at 3.35 TB/s).  The work is up
// to 9*S*F shared-memory atomics (250M at the root), which is what the
// large windows pay.  The small windows the ordered grower launches most
// (72% of its launches are 2^15 rows or fewer) pay fixed costs instead:
// zeroing and merging a 63 KB block histogram per block, a zero-filled
// output and the host's launch path.  The design cuts each of them:
//
//   * the grid is (row chunks) x (feature groups), launched with
//     cudaLaunchKernelEx and a cluster dimension of `cluster` consecutive
//     chunks (up to 16 blocks with the non-portable size; 1 on the large
//     path).  A
//     block zeroes its [nf][9][B] int32 histogram in shared memory; each
//     thread takes rows of the block's chunk in turn, loads the row's 9
//     digits once and, for each feature of the group, adds every non-zero
//     digit into the shared bin with atomicAdd;
//   * a cluster of more than one block reduces its histograms through distributed
//     shared memory: block `rank` sums every cluster-th entry over the
//     peers' shared memory (`map_shared_rank`, between two cluster
//     barriers), so each entry is read once per peer and written once;
//   * small path (`atomic_out` = 0): one cluster covers a feature group's
//     whole window, so the cluster's sums are the answer.  They are written
//     with plain stores, zeros included: no zero-filled output, no global
//     atomics, one launch a call.  The wrapper uses 1-2 features a block
//     (9-18 KB at 255 bins) so that a small window still spreads over many
//     blocks;
//   * large path (`atomic_out` = 1): many row chunks cover a group's
//     window, within one wave of blocks; each block adds its non-zero sums
//     into the output, zeroed here by cudaMemsetAsync, with global atomics.
//     It launches no clusters: chip_smoke.py measured clusters of 2 no
//     faster at the root, and 4 or more cannot all be resident at 63 KB a
//     block (a second wave);
//   * a warp's lanes add feature j at step j, all into one feature's
//     histogram.  Lane-staggered features and warp-aggregated same-bin
//     adds (__match_any_sync) were both measured on the card and both lost
//     on the training path's bins (the aggregation's match and nine
//     reductions a feature cost more than the collisions they save; the
//     stagger paid only on the large path with rows crowded into a few
//     bins), so the in-step order is the only one kept;
//   * host path: the dynamic shared-memory and cluster-size attributes are
//     set once per instantiation and device (a static flag), not per launch.
//
// Exactness: every sum is an integer (|digit| <= 128, fewer than 2^24 rows
// per window), so any order of atomics gives the same bits as the plain
// index_add_ version.  Rows past `count` are never read (no padding), zero
// digits add nothing, and a window of 0 rows still writes every entry of
// the output (zeros).  Bins >= B are skipped.
//
// Launch rules: the kernel runs on the stream it is given (PyTorch's
// current stream), allocates nothing, and the C entry point returns
// cudaGetLastError() right after the launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kStreams = 9;
constexpr int kMaxSmem = 232448;     // an H100 block's shared-memory limit
constexpr int kMaxDevices = 64;
constexpr int kBatch = 8;   // features whose bins a thread loads at once

// One row's digits into the block's shared [nf][9][B] histogram, for
// every feature of the group (kBatch features' bins loaded at a time).
template <typename BinT>
__device__ __forceinline__ void add_row(const BinT* __restrict__ b,
                                        const int* dg, int nf, int B,
                                        int* s_hist) {
  for (int j0 = 0; j0 < nf; j0 += kBatch) {
    int bv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      bv[u] = j0 + u < nf ? static_cast<int>(b[j0 + u]) : B;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (bv[u] >= B) continue;
      int* h = s_hist + (j0 + u) * kStreams * B + bv[u];
#pragma unroll
      for (int k = 0; k < kStreams; ++k) {
        if (dg[k] != 0) atomicAdd(h + k * B, dg[k]);
      }
    }
  }
}

template <typename BinT, bool STORE>
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
    int dg[kStreams];
#pragma unroll
    for (int k = 0; k < kStreams; ++k)
      dg[k] = static_cast<int>(digits[row * kStreams + k]);
    add_row<BinT>(bins + row * F + f0, dg, nf, B, s_hist);
  }

  int* o = out + static_cast<long long>(f0) * kStreams * B;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  if (cs == 1) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_sh; i += blockDim.x) {
      const int v = s_hist[i];
      if (STORE) {
        o[i] = v;
      } else if (v != 0) {
        atomicAdd(o + i, v);
      }
    }
    return;
  }
  // small path only (lgbt_digit_histogram refuses clusters with
  // atomic_out):
  // every block of the cluster has finished its adds; block `rank` sums
  // every cs-th entry over the peers' shared memory and stores it
  cluster.sync();
  const int rank = static_cast<int>(cluster.block_rank());
  for (int i = rank * blockDim.x + threadIdx.x; i < n_sh;
       i += cs * blockDim.x) {
    int v = 0;
    for (int q = 0; q < cs; ++q) v += cluster.map_shared_rank(s_hist, q)[i];
    o[i] = v;
  }
  // keep this block's shared memory alive until every peer has read it
  cluster.sync();
}

// Sets the kernel's attributes once per device: the dynamic shared-memory
// ceiling (all that a block may have beside its static shared memory) and
// cluster sizes above 8.
template <typename Kernel>
int prepare_once(Kernel kern, bool* ready) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < kMaxDevices && ready[dev]) return 0;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, kern);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmem - static_cast<int>(fa.sharedSizeBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(kern,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < kMaxDevices) ready[dev] = true;
  return 0;
}

template <typename BinT, bool STORE>
int launch(const void* bins, const int8_t* digits, long long start,
           long long count, int F, int B, int fg, long long rows_per_block,
           long long chunks, int cluster, int* out, int threads,
           cudaStream_t stream) {
  auto kern = digit_hist_kernel<BinT, STORE>;
  static bool ready[kMaxDevices] = {};
  const int e = prepare_once(kern, ready);
  if (e) return e;
  const int groups = (F + fg - 1) / fg;
  if (!STORE) {
    const cudaError_t m = cudaMemsetAsync(
        out, 0, static_cast<size_t>(F) * kStreams * B * sizeof(int), stream);
    if (m != cudaSuccess) return static_cast<int>(m);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(chunks),
                     static_cast<unsigned>(groups));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(fg) * kStreams * B * sizeof(int);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t l = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const BinT*>(bins), digits, start, count, F, B,
      fg, rows_per_block, out);
  if (l != cudaSuccess) return static_cast<int>(l);
  return static_cast<int>(cudaGetLastError());
}

template <typename BinT>
int launch_out(bool atomic_out, const void* bins, const int8_t* digits,
               long long start, long long count, int F, int B, int fg,
               long long rows_per_block, long long chunks, int cluster,
               int* out, int threads, cudaStream_t stream) {
  if (atomic_out)
    return launch<BinT, false>(bins, digits, start, count, F, B, fg,
                               rows_per_block, chunks, cluster, out, threads,
                               stream);
  return launch<BinT, true>(bins, digits, start, count, F, B, fg,
                            rows_per_block, chunks, cluster, out, threads,
                            stream);
}

}  // namespace

extern "C" {

// bins [N, F] row-major codes of `bin_bytes` bytes (1: uint8, 2: uint16),
// digits [N, 9] int8; sums rows [start, start + count) into out [F, 9, B]
// int32 (written whole).  The grid is `chunks` x ceil(F / fg) blocks of
// `threads`, in clusters of `cluster` chunks (chunks a multiple of it);
// with `atomic_out` 0 there must be one cluster a feature group, with
// `atomic_out` 1 clusters of one block.
int lgbt_digit_histogram(const void* bins, int bin_bytes, const void* digits,
                         long long start, long long count, int F, int B,
                         int fg, long long rows_per_block, long long chunks,
                         int cluster, int atomic_out, int* out,
                         int threads, void* stream) {
  if (F <= 0 || B <= 0 || fg <= 0 || rows_per_block <= 0 || chunks <= 0
      || cluster <= 0 || cluster > 16 || chunks % cluster != 0
      || (!atomic_out && chunks != cluster) || (atomic_out && cluster != 1)
      || threads <= 0
      || threads % 32 != 0
      || static_cast<long long>(fg) * kStreams * B * 4 > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* d = static_cast<const int8_t*>(digits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bin_bytes == 1)
    return launch_out<uint8_t>(atomic_out != 0, bins, d, start, count, F, B,
                               fg, rows_per_block, chunks, cluster, out,
                               threads, s);
  if (bin_bytes == 2)
    return launch_out<uint16_t>(atomic_out != 0, bins, d, start, count, F, B,
                                fg, rows_per_block, chunks, cluster, out,
                                threads, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
