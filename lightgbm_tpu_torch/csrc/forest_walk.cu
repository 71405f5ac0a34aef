// Forest walk for serving: all trees of a constant-leaf forest, per row.
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_walk.py `_walk_kernel`
// (with `_class_walk`), reached through `forest_walk` (binned rows) and
// `forest_walk_raw` (raw f32 rows, bucketized inside the kernel).  That
// kernel recast the walk as a path-consistency matmul because Mosaic has
// no cheap dynamic gather; Hopper has one, so this is a direct walk:
//
//   * one thread per row, blocks of `blockDim.x` rows (128 by default);
//   * the row's F bins sit in shared memory as [F][block] u16, not in a
//     register array indexed at run time (that would spill);
//   * raw variant: each bin is the count of cuts strictly below the
//     value, a lower-bound binary search on the sorted f32 row of
//     `bnd [F, C]` (+inf padded; ties from the f64 -> f32 cast keep the
//     search a true lower bound).  NaN goes to `nan_bin`; a categorical
//     value is truncated to int and searched in `cats [F, C]` (INT32_MAX
//     padded): a hit gives its index, a miss gives `nan_bin`;
//   * for each class k and each tree t in order, the block stages tree
//     t's nodes (16 bytes each) and leaf values in shared memory, then
//     every thread walks from the root: go left when `bin <= thr`
//     (numerical) or `bin == thr` (categorical); a negative child ~leaf
//     ends the walk.  The loop is bounded by num_leaves and no lower: a
//     leaf-wise tree with 255 leaves can be 254 levels deep.  Absorbing
//     trees (left == right == ~0: one-leaf trees and the multiclass
//     ragged-tail padding) end at leaf 0;
//   * per class, trees fold in tree order with the same Kahan update as
//     the plain walk: y = v - comp; tot = acc + y; comp = (tot - acc) - y.
//     It has no multiplies, so contraction cannot change it; the build
//     uses no fast-math.
//
// What bounds it on an H100: the bytes are small -- reading X is B*F*4
// bytes, the output K*B*4, and the forest (T*(16*M + 4*L) bytes) is read
// from L2 once per block.  The work is B * sum_t depth_t dependent
// shared-memory loads (a node record, then the bin of its feature), so
// the kernel is latency bound, not bandwidth bound.  The design keeps
// both loads in shared memory and runs many independent rows per SM to
// hide that latency; keeping node tables resident across trees, several
// rows per thread, or a tree-chunked grid with a second pass are the
// next steps.
//
// Launch rules: the kernel runs on the stream it is given (PyTorch's
// current stream), allocates nothing, and each C entry point returns
// cudaGetLastError() right after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct __align__(16) Node {
  int feat2;   // (split feature << 1) | is_categorical
  int thr;     // threshold bin
  int left;    // child node, or ~leaf
  int right;
};

__device__ __forceinline__ int lower_bound_f32(const float* __restrict__ row,
                                               int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(row + mid) < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int lower_bound_i32(const int* __restrict__ row,
                                               int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(row + mid) < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// RAW = false: `bins` [F, B] holds bin codes (categorical misses already
// mapped to nan_bin).  RAW = true: `x` [F, B] holds raw f32 values.
template <bool RAW, typename BinT>
__global__ void forest_walk_kernel(
    const Node* __restrict__ nodes, const float* __restrict__ leaves,
    int K, int T, int M, int L,
    const BinT* __restrict__ bins, const float* __restrict__ x,
    const float* __restrict__ bnd, const int* __restrict__ cats,
    const unsigned char* __restrict__ is_cat_col, int C, int nan_bin,
    int F, int B, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Node* s_nodes = reinterpret_cast<Node*>(smem);
  float* s_leaves = reinterpret_cast<float*>(s_nodes + M);
  unsigned short* s_bins = reinterpret_cast<unsigned short*>(s_leaves + L);

  const int tid = threadIdx.x;
  const int nb = blockDim.x;
  const int row = blockIdx.x * nb + tid;
  const bool valid = row < B;

  for (int f = 0; f < F; ++f) {
    int b = 0;
    if (valid) {
      if (!RAW) {
        b = static_cast<int>(bins[static_cast<size_t>(f) * B + row]);
      } else {
        const float v = x[static_cast<size_t>(f) * B + row];
        if (isnan(v)) {
          b = nan_bin;
        } else if (is_cat_col[f]) {
          const int iv = static_cast<int>(v);   // truncates toward zero
          const int* crow = cats + static_cast<size_t>(f) * C;
          const int j = lower_bound_i32(crow, C, iv);
          b = (j < C && __ldg(crow + j) == iv) ? j : nan_bin;
        } else {
          b = lower_bound_f32(bnd + static_cast<size_t>(f) * C, C, v);
        }
      }
    }
    s_bins[f * nb + tid] = static_cast<unsigned short>(b);
  }

  for (int k = 0; k < K; ++k) {
    float acc = 0.0f, comp = 0.0f;
    for (int t = 0; t < T; ++t) {
      const size_t tt = static_cast<size_t>(k) * T + t;
      __syncthreads();              // the previous tree's readers are done
      for (int i = tid; i < M; i += nb) s_nodes[i] = nodes[tt * M + i];
      for (int i = tid; i < L; i += nb) s_leaves[i] = leaves[tt * L + i];
      __syncthreads();
      int node = 0;
      for (int s = 0; s < L && node >= 0; ++s) {
        const Node nd = s_nodes[node];
        const int b = s_bins[(nd.feat2 >> 1) * nb + tid];
        const bool go_left = (nd.feat2 & 1) ? (b == nd.thr) : (b <= nd.thr);
        node = go_left ? nd.left : nd.right;
      }
      const float v = s_leaves[node < 0 ? ~node : 0];
      const float y = v - comp;
      const float tot = acc + y;
      comp = (tot - acc) - y;
      acc = tot;
    }
    if (valid) out[static_cast<size_t>(k) * B + row] = acc;
  }
}

size_t smem_bytes(int M, int L, int F, int block) {
  return static_cast<size_t>(M) * sizeof(Node) + static_cast<size_t>(L) * 4 +
         static_cast<size_t>(F) * block * 2;
}

template <bool RAW, typename BinT>
int launch(const void* nodes, const float* leaves, int K, int T, int M, int L,
           const BinT* bins, const float* x, const float* bnd, const int* cats,
           const unsigned char* is_cat_col, int C, int nan_bin, int F, int B,
           float* out, int block, void* stream) {
  const size_t smem = smem_bytes(M, L, F, block);
  auto kern = forest_walk_kernel<RAW, BinT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (B + block - 1) / block;
  kern<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Node*>(nodes), leaves, K, T, M, L, bins, x, bnd, cats,
      is_cat_col, C, nan_bin, F, B, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// bins [F, B] of 1-byte (uint8) or 2-byte (uint16) codes -> out [K, B].
int lgbt_forest_walk_binned(const void* nodes, const float* leaves, int K,
                            int T, int M, int L, const void* bins,
                            int bin_bytes, int F, int B, float* out,
                            int block, void* stream) {
  if (bin_bytes == 1)
    return launch<false, uint8_t>(nodes, leaves, K, T, M, L,
                                  static_cast<const uint8_t*>(bins), nullptr,
                                  nullptr, nullptr, nullptr, 0, 0, F, B, out,
                                  block, stream);
  if (bin_bytes == 2)
    return launch<false, uint16_t>(nodes, leaves, K, T, M, L,
                                   static_cast<const uint16_t*>(bins),
                                   nullptr, nullptr, nullptr, nullptr, 0, 0, F,
                                   B, out, block, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x [F, B] raw f32, bnd [F, C] f32, cats [F, C] i32, is_cat_col [F] u8
// -> out [K, B].
int lgbt_forest_walk_raw(const void* nodes, const float* leaves, int K, int T,
                         int M, int L, const float* x, const float* bnd,
                         const int* cats, const unsigned char* is_cat_col,
                         int C, int nan_bin, int F, int B, float* out,
                         int block, void* stream) {
  return launch<true, uint8_t>(nodes, leaves, K, T, M, L, nullptr, x, bnd,
                               cats, is_cat_col, C, nan_bin, F, B, out, block,
                               stream);
}

}  // extern "C"
