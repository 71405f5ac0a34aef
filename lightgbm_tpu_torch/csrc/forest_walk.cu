// Forest walk for serving: all trees of a forest, per row.
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_walk.py `_walk_kernel`
// (with `_class_walk`), reached through `forest_walk` (binned rows) and
// `forest_walk_raw` (raw f32 rows, bucketized inside the kernel), with
// both of its optional parts: the affine leaf epilogue of piece-wise
// linear forests and bf16 leaf tables.  That kernel recast the walk as a
// path-consistency matmul because Mosaic has no cheap dynamic gather;
// Hopper has one, so this is a direct walk:
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
//   * LINEAR (piece-wise linear forests): the block also stages the
//     tree's affine tables `coeff [L, Kf]` f32 and `feat [L, Kf]` i32
//     (real feature indices, -1 pad), and each thread keeps its row's
//     covariates as [F][block] f32 in shared memory: NaN read as 0.0 from
//     `x` in the raw variant, the pre-imputed `xt [F, B]` operand in the
//     binned one.  Routing still sends NaN to `nan_bin`.  After the walk
//     ends at `leaf`: s = sum over ascending k of coeff[leaf, k] *
//     x[feat[leaf, k]], skipping -1 slots, and v = leaf_value + s.  The
//     products and sums are written with __fmul_rn / __fadd_rn: nvcc
//     contracts a*b + c into an FMA by default, which would round once
//     where the plain version rounds twice;
//   * LeafT = uint16_t: the leaf table is stored as bf16 (16-bit words)
//     and widened to f32 exactly (<< 16); the fold stays f32;
//   * per class, trees fold in tree order with the same Kahan update as
//     the plain walk: y = v - comp; tot = acc + y; comp = (tot - acc) - y
//     (explicit round-to-nearest adds; the build uses no fast-math).
//
// What bounds it on an H100: the bytes are small -- reading X is B*F*4
// bytes (plus xt in the binned linear variant), the output K*B*4, and
// the forest (T*(16*M + 4*L) bytes, plus 8*L*Kf of affine tables) is
// read from L2 once per block.  The work is B * sum_t depth_t dependent
// shared-memory loads (a node record, then the bin of its feature) plus
// at most Kf multiply-adds per row per tree, so the kernel is latency
// bound, not bandwidth bound.  The design keeps every load in shared
// memory and runs many independent rows per SM to hide that latency;
// keeping node tables resident across trees, several rows per thread, or
// a tree-chunked grid with a second pass are the next steps.
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

__device__ __forceinline__ float leaf_f32(float v) { return v; }

// bf16 -> f32 is exact: the 16 bits are the high half of the f32 word
__device__ __forceinline__ float leaf_f32(uint16_t v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// Shared memory of one block: nodes | leaves (16-byte aligned) | coeff |
// feat | x tile [F][block] f32 | bins tile [F][block] u16.  The affine
// tables and the x tile are empty unless the forest is linear.
size_t smem_bytes(int M, int L, int leaf_bytes, int Kf, bool linear, int F,
                  int block) {
  size_t b = static_cast<size_t>(M) * sizeof(Node) +
             align16(static_cast<size_t>(L) * leaf_bytes);
  if (linear)
    b += static_cast<size_t>(L) * Kf * 8 + static_cast<size_t>(F) * block * 4;
  return b + static_cast<size_t>(F) * block * 2;
}

// RAW = false: `bins` [F, B] holds bin codes (categorical misses already
// mapped to nan_bin) and, when LINEAR, `xt` [F, B] the NaN-imputed f32
// covariates.  RAW = true: `x` [F, B] holds raw f32 values.
template <bool RAW, typename BinT, bool LINEAR, typename LeafT>
__global__ void forest_walk_kernel(
    const Node* __restrict__ nodes, const LeafT* __restrict__ leaves,
    int K, int T, int M, int L,
    const BinT* __restrict__ bins, const float* __restrict__ x,
    const float* __restrict__ bnd, const int* __restrict__ cats,
    const unsigned char* __restrict__ is_cat_col, int C, int nan_bin,
    const float* __restrict__ coeff, const int* __restrict__ feat, int Kf,
    const float* __restrict__ xt, int F, int B, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Node* s_nodes = reinterpret_cast<Node*>(smem);
  LeafT* s_leaves = reinterpret_cast<LeafT*>(s_nodes + M);
  unsigned char* p = smem + static_cast<size_t>(M) * sizeof(Node) +
                     align16(static_cast<size_t>(L) * sizeof(LeafT));
  const int tid = threadIdx.x;
  const int nb = blockDim.x;
  const int LK = LINEAR ? L * Kf : 0;
  float* s_coeff = reinterpret_cast<float*>(p);
  int* s_feat = reinterpret_cast<int*>(s_coeff + LK);
  float* s_x = reinterpret_cast<float*>(s_feat + LK);
  unsigned short* s_bins =
      reinterpret_cast<unsigned short*>(s_x + (LINEAR ? F * nb : 0));

  const int row = blockIdx.x * nb + tid;
  const bool valid = row < B;

  for (int f = 0; f < F; ++f) {
    int b = 0;
    float cov = 0.0f;
    if (valid) {
      const size_t at = static_cast<size_t>(f) * B + row;
      if (!RAW) {
        b = static_cast<int>(bins[at]);
        if (LINEAR) cov = xt[at];
      } else {
        const float v = x[at];
        if (isnan(v)) {
          b = nan_bin;
        } else {
          cov = v;
          if (is_cat_col[f]) {
            const int iv = static_cast<int>(v);   // truncates toward zero
            const int* crow = cats + static_cast<size_t>(f) * C;
            const int j = lower_bound_i32(crow, C, iv);
            b = (j < C && __ldg(crow + j) == iv) ? j : nan_bin;
          } else {
            b = lower_bound_f32(bnd + static_cast<size_t>(f) * C, C, v);
          }
        }
      }
    }
    s_bins[f * nb + tid] = static_cast<unsigned short>(b);
    if (LINEAR) s_x[f * nb + tid] = cov;
  }

  for (int k = 0; k < K; ++k) {
    float acc = 0.0f, comp = 0.0f;
    for (int t = 0; t < T; ++t) {
      const size_t tt = static_cast<size_t>(k) * T + t;
      __syncthreads();              // the previous tree's readers are done
      for (int i = tid; i < M; i += nb) s_nodes[i] = nodes[tt * M + i];
      for (int i = tid; i < L; i += nb) s_leaves[i] = leaves[tt * L + i];
      if (LINEAR) {
        for (int i = tid; i < LK; i += nb) {
          s_coeff[i] = coeff[tt * LK + i];
          s_feat[i] = feat[tt * LK + i];
        }
      }
      __syncthreads();
      int node = 0;
      for (int s = 0; s < L && node >= 0; ++s) {
        const Node nd = s_nodes[node];
        const int b = s_bins[(nd.feat2 >> 1) * nb + tid];
        const bool go_left = (nd.feat2 & 1) ? (b == nd.thr) : (b <= nd.thr);
        node = go_left ? nd.left : nd.right;
      }
      const int leaf = node < 0 ? ~node : 0;
      float v = leaf_f32(s_leaves[leaf]);
      if (LINEAR) {
        const float* c = s_coeff + leaf * Kf;
        const int* fe = s_feat + leaf * Kf;
        float s = 0.0f;
        for (int j = 0; j < Kf; ++j) {
          const int f = fe[j];
          if (f >= 0) s = __fadd_rn(s, __fmul_rn(c[j], s_x[f * nb + tid]));
        }
        v = __fadd_rn(v, s);
      }
      const float y = __fsub_rn(v, comp);
      const float tot = __fadd_rn(acc, y);
      comp = __fsub_rn(__fsub_rn(tot, acc), y);
      acc = tot;
    }
    if (valid) out[static_cast<size_t>(k) * B + row] = acc;
  }
}

template <bool RAW, typename BinT, bool LINEAR, typename LeafT>
int launch(const void* nodes, const void* leaves, int K, int T, int M, int L,
           const BinT* bins, const float* x, const float* bnd, const int* cats,
           const unsigned char* is_cat_col, int C, int nan_bin,
           const float* coeff, const int* feat, int Kf, const float* xt,
           int F, int B, float* out, int block, void* stream) {
  const size_t smem = smem_bytes(M, L, static_cast<int>(sizeof(LeafT)), Kf,
                                 LINEAR, F, block);
  auto kern = forest_walk_kernel<RAW, BinT, LINEAR, LeafT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (B + block - 1) / block;
  kern<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Node*>(nodes), static_cast<const LeafT*>(leaves), K,
      T, M, L, bins, x, bnd, cats, is_cat_col, C, nan_bin, coeff, feat, Kf,
      xt, F, B, out);
  return static_cast<int>(cudaGetLastError());
}

// The leaf type and the linear flag of one call, resolved to a template.
template <bool RAW, typename BinT>
int dispatch(const void* nodes, const void* leaves, int leaf_bytes, int K,
             int T, int M, int L, const BinT* bins, const float* x,
             const float* bnd, const int* cats,
             const unsigned char* is_cat_col, int C, int nan_bin,
             const float* coeff, const int* feat, int Kf, const float* xt,
             int F, int B, float* out, int block, void* stream) {
  const bool linear = coeff != nullptr;
  if (linear && (feat == nullptr || Kf <= 0 || (!RAW && xt == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
#define LGBT_WALK(LIN, LT)                                                   \
  return launch<RAW, BinT, LIN, LT>(nodes, leaves, K, T, M, L, bins, x, bnd, \
                                    cats, is_cat_col, C, nan_bin, coeff,     \
                                    feat, LIN ? Kf : 0, xt, F, B, out, block, \
                                    stream)
  if (leaf_bytes == 4) {
    if (linear) LGBT_WALK(true, float);
    LGBT_WALK(false, float);
  }
  if (leaf_bytes == 2) {
    if (linear) LGBT_WALK(true, uint16_t);
    LGBT_WALK(false, uint16_t);
  }
#undef LGBT_WALK
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// bins [F, B] of 1-byte (uint8) or 2-byte (uint16) codes -> out [K, B].
// leaves [K*T, L] of 4-byte f32 or 2-byte bf16 words.  A linear forest
// passes coeff/feat [K*T, L, Kf] and xt [F, B] f32 (NaN-imputed); a
// constant one passes null pointers and Kf = 0.
int lgbt_forest_walk_binned(const void* nodes, const void* leaves,
                            int leaf_bytes, int K, int T, int M, int L,
                            const void* bins, int bin_bytes, int F, int B,
                            const float* coeff, const int* feat, int Kf,
                            const float* xt, float* out, int block,
                            void* stream) {
  if (bin_bytes == 1)
    return dispatch<false, uint8_t>(
        nodes, leaves, leaf_bytes, K, T, M, L,
        static_cast<const uint8_t*>(bins), nullptr, nullptr, nullptr, nullptr,
        0, 0, coeff, feat, Kf, xt, F, B, out, block, stream);
  if (bin_bytes == 2)
    return dispatch<false, uint16_t>(
        nodes, leaves, leaf_bytes, K, T, M, L,
        static_cast<const uint16_t*>(bins), nullptr, nullptr, nullptr,
        nullptr, 0, 0, coeff, feat, Kf, xt, F, B, out, block, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x [F, B] raw f32, bnd [F, C] f32, cats [F, C] i32, is_cat_col [F] u8
// -> out [K, B].  Leaves and the affine tables as above; the covariates
// are x itself with NaN read as 0.0.
int lgbt_forest_walk_raw(const void* nodes, const void* leaves,
                         int leaf_bytes, int K, int T, int M, int L,
                         const float* x, const float* bnd, const int* cats,
                         const unsigned char* is_cat_col, int C, int nan_bin,
                         int F, int B, const float* coeff, const int* feat,
                         int Kf, float* out, int block, void* stream) {
  return dispatch<true, uint8_t>(nodes, leaves, leaf_bytes, K, T, M, L,
                                 nullptr, x, bnd, cats, is_cat_col, C,
                                 nan_bin, coeff, feat, Kf, nullptr, F, B, out,
                                 block, stream);
}

}  // extern "C"
