// Forest walk for serving: all trees of a forest, per row, as a
// tree-parallel walk.
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_walk.py `_walk_kernel`
// (with `_class_walk`), reached through `forest_walk` (binned rows) and
// `forest_walk_raw` (raw f32 rows, bucketized on the card), with both of
// its optional parts: the affine leaf epilogue of piece-wise linear
// forests and bf16 leaf tables.  That kernel recast the walk as a
// path-consistency matmul because Mosaic has no cheap dynamic gather, and
// ran its grid in order over the trees; Hopper has a cheap gather from
// shared memory and runs its blocks in parallel, so this is a direct walk
// spread over rows and trees at once:
//
//   * pass 0 (raw rows only, `bucketize_kernel`): one thread per (feature,
//     row) writes the row's bin as u16 to a [F, B] scratch: the count of
//     cuts strictly below the value, a lower-bound binary search on the
//     sorted f32 row of `bnd [F, C]` (+inf padded; ties from the f64 ->
//     f32 cast keep the search a true lower bound).  NaN goes to
//     `nan_bin`; a categorical value is truncated to int and searched in
//     `cats [F, C]` (INT32_MAX padded): a hit gives its index, a miss
//     gives `nan_bin`.  Done once, not once per tree chunk;
//   * pass 1 (`walk_trees_kernel`): the grid is (tree chunks) x (row
//     tiles).  A block stages its chunk's node records (16 bytes each),
//     leaf values and, for linear forests, affine (coeff, feat) pairs into
//     shared memory once, with asynchronous copies (cp.async) that fly
//     while the block loads its tile's bins as [F][tile] u16 (and, for
//     linear forests, the covariates as [F][tile] f32).  Then it walks every
//     (tree, row) of the chunk and tile: each thread takes one tree and 4
//     rows at once, so 4 independent chains of dependent shared loads are
//     in flight.  A step: go left when `bin <= thr` (numerical) or
//     `bin == thr` (categorical); a negative child ~leaf ends the chain.
//     The walk is bounded by num_leaves and no lower: a leaf-wise tree
//     with 255 leaves can be 254 levels deep.  Absorbing trees (left ==
//     right == ~0: one-leaf trees and the multiclass ragged-tail padding)
//     end at leaf 0.  The thread writes the leaf's value, widened from
//     bf16 (`<< 16`, exact) where the table is bf16, to a [K*T, rows] f32
//     scratch.  LINEAR: it first adds s = sum over ascending k of
//     coeff[leaf, k] * x[feat[leaf, k]], skipping -1 slots, written with
//     __fmul_rn / __fadd_rn (nvcc contracts a*b + c into an FMA by
//     default, which would round once where the plain version rounds
//     twice).  The covariates are x with NaN read as 0.0 in the raw
//     variant, the pre-imputed `xt [F, B]` operand in the binned one;
//     routing still sends NaN to `nan_bin`;
//   * pass 2 (`fold_trees_kernel`): one thread per (class, row) folds the
//     class's T values in tree order with the plain walk's Kahan update:
//     y = v - comp; tot = acc + y; comp = (tot - acc) - y (explicit
//     round-to-nearest adds; the build uses no fast math).  The values
//     and their order are the plain walk's (ops/predict.py), so every
//     variant is bit-equal to it, as the TPU kernel's `_class_walk` is.
//     Up to 1024 (class, row) pairs a wave it is one warp a pair
//     (`fold_trees_warp_kernel`: the lanes load 32 trees' values at once,
//     the next 32 in flight, and fold them in order through shuffles);
//     measured on the card, that took the fold of one row of 500 trees
//     from 14 to 9 us, and lost to a thread a pair at 4096 rows.  Pass 2
//     is a second small kernel, not the same launch after a grid barrier:
//     a barrier needs every block resident, which caps pass 1 at one wave
//     of blocks, and at B >= 4096 pass 1 takes several.
//
// The launch plan (chunk, tile, threads, shared bytes, rows a wave) is
// ops/forest_walk.py `plan_walk`, a pure function the CPU tests cover:
// the widest tile (512 rows, stepping down to 32) whose tables of one tree
// fit, up to 1024 threads a block, then as many trees a chunk as shared
// memory holds, fewer where the grid would not fill the card's SMs or
// would end in a part-filled wave.  At the Higgs forest that is 3 trees a
// block at B = 1, 16 at B = 4096 and ~40 at B = 65536.  Measured on the
// card against 256-row tiles, 256 or 512 threads, two blocks an SM (half
// the shared memory each) and 8-byte node records: none was better by
// more than ~10% on both constant and linear forests, so none is kept.
// The scratch is [K*T, wave] f32: all rows in one wave up to 256 MB (131
// MB at 500 trees and B = 65536, a round trip through device memory of
// ~0.08 ms at 3.35 TB/s, accepted), waves of rows beyond that.
//
// What bounds it on an H100: the bytes are small -- reading X is B*F*4
// bytes (plus xt in the binned linear variant), the output K*B*4, and the
// forest (T*(16*M + 4*L) bytes, plus 8*L*Kf of affine tables) once.  The
// work is B * sum_t depth_t dependent shared-memory loads (a node record,
// then the bin of its feature) plus at most Kf multiply-adds per row per
// tree, so the kernel is bound by the latency and throughput of shared
// memory, not by device memory.  The first port walked every tree in
// series in every block (stage one tree, two barriers, walk, repeat),
// ~1.5 us a tree whatever B; here a block stages its chunk once, the
// chunks run in parallel, and each thread keeps 4 chains in flight.  At
// large B what is left is the walk's own issue rate: ~10 instructions a
// node visit, and lanes that wait for the deepest of a warp's chains.
//
// Launch rules: the kernels run on the stream they are given (PyTorch's
// current stream), allocate nothing, and each C entry point returns
// cudaGetLastError() right after its launches.  The shared-memory ceiling
// is set once per kernel and device, not per launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 4;             // rows a thread walks at once
constexpr int kWalkThreads = 1024;   // most threads a pass-1 block
constexpr int kFoldThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBinThreads = 256;
constexpr int kMaxSmem = 232448;
constexpr int kMaxDevices = 64;
constexpr int kMaxRowTiles = 65535;  // gridDim.y

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

// Asynchronous global -> shared copies (cp.async, completed by
// cp_async_wait): 16 bytes (both addresses 16-byte aligned) or 4 bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Shared memory of one pass-1 block: `chunk` trees' nodes (16 bytes each)
// | leaves (16-byte aligned) | affine (coeff, feat) pairs | x tile
// [F][tile] f32 | bins tile [F][tile] u16.  The affine pairs and the x
// tile are empty unless the forest is linear.  ops/forest_walk.py
// `walk_smem` is the same sum.
size_t smem_bytes(int chunk, int M, int L, int leaf_bytes, int Kf,
                  bool linear, int F, int tile) {
  size_t b = static_cast<size_t>(chunk) * M * sizeof(Node) +
             align16(static_cast<size_t>(chunk) * L * leaf_bytes);
  if (linear)
    b += static_cast<size_t>(chunk) * L * Kf * 8 +
         static_cast<size_t>(F) * tile * 4;
  return b + static_cast<size_t>(F) * tile * 2;
}

// Pass 0: x [F, B] raw f32 -> bins [F, B] u16.
__global__ void bucketize_kernel(const float* __restrict__ x,
                                 const float* __restrict__ bnd,
                                 const int* __restrict__ cats,
                                 const unsigned char* __restrict__ is_cat_col,
                                 int C, int nan_bin, int F, long long B,
                                 uint16_t* __restrict__ bins) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (i >= F * B) return;
  const int f = static_cast<int>(i / B);
  const float v = x[i];
  int b;
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
  bins[i] = static_cast<uint16_t>(b);
}

// Pass 1.  Block (x, y) walks trees [x * chunk, ...) of the K*T (class-
// major) for rows [r0 + y * tile, ...) of this wave's `nrows`; `bins` and
// `cov` are [F, ld].  Writes scratch [K*T][nrows].  ops/forest_walk.py
// `walk_items` states the same mapping for the CPU tests.
template <typename BinT, bool LINEAR, typename LeafT>
__global__ void __launch_bounds__(kWalkThreads)
walk_trees_kernel(const Node* __restrict__ nodes,
                  const LeafT* __restrict__ leaves, int KT, int M, int L,
                  const BinT* __restrict__ bins,
                  const float* __restrict__ cov, int impute, long long ld,
                  long long r0, int nrows, const float* __restrict__ coeff,
                  const int* __restrict__ feat, int Kf, int F, int tile,
                  int chunk, float* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c0 = blockIdx.x * chunk;
  const int nt = min(chunk, KT - c0);
  const int t0 = blockIdx.y * tile;
  const int nr = min(tile, nrows - t0);
  const int LK = LINEAR ? L * Kf : 0;
  Node* s_nodes = reinterpret_cast<Node*>(smem);
  const size_t node_end = static_cast<size_t>(chunk) * M * sizeof(Node);
  LeafT* s_leaves = reinterpret_cast<LeafT*>(smem + node_end);
  unsigned char* p = smem + node_end
                     + align16(static_cast<size_t>(chunk) * L * sizeof(LeafT));
  // (coeff bits, feat) of each slot, one 8-byte load in the epilogue
  int2* s_aff = reinterpret_cast<int2*>(p);
  float* s_x = reinterpret_cast<float*>(s_aff
                                        + static_cast<size_t>(chunk) * LK);
  unsigned short* s_bins = reinterpret_cast<unsigned short*>(
      s_x + (LINEAR ? static_cast<size_t>(F) * tile : 0));
  const int tid = threadIdx.x;
  const int nth = blockDim.x;

  // the chunk's tables, in flight while the tile's rows load
  {
    const Node* src = nodes + static_cast<size_t>(c0) * M;
    for (int i = tid; i < nt * M; i += nth) cp_async16(s_nodes + i, src + i);
    const LeafT* lsrc = leaves + static_cast<size_t>(c0) * L;
    if constexpr (sizeof(LeafT) == 4) {
      for (int i = tid; i < nt * L; i += nth)
        cp_async4(s_leaves + i, lsrc + i);
    } else {
      for (int i = tid; i < nt * L; i += nth) s_leaves[i] = lsrc[i];
    }
    if (LINEAR) {
      const size_t at = static_cast<size_t>(c0) * LK;
      for (int i = tid; i < nt * LK; i += nth) {
        cp_async4(&s_aff[i].x, coeff + at + i);
        cp_async4(&s_aff[i].y, feat + at + i);
      }
    }
  }
  for (int i = tid; i < F * nr; i += nth) {
    const int f = i / nr;
    const int r = i - f * nr;
    const size_t at = static_cast<size_t>(f) * ld + r0 + t0 + r;
    s_bins[f * tile + r] = static_cast<unsigned short>(bins[at]);
    if (LINEAR) {
      const float v = cov[at];
      s_x[f * tile + r] = impute && isnan(v) ? 0.0f : v;
    }
  }
  cp_async_wait();
  __syncthreads();

  // item = (tree j of the chunk, row slot g): rows g + q * G, q < kRows
  const int G = (nr + kRows - 1) / kRows;
  for (int item = tid; item < nt * G; item += nth) {
    const int j = item / G;
    const int g = item - j * G;
    const Node* tn = s_nodes + static_cast<size_t>(j) * M;
    int node[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) node[q] = g + q * G < nr ? 0 : -1;
    for (int s = 0; s < L; ++s) {
      bool live = false;
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        if (node[q] < 0) continue;
        live = true;
        const Node nd = tn[node[q]];
        const int b = s_bins[(nd.feat2 >> 1) * tile + g + q * G];
        const bool left = (nd.feat2 & 1) ? (b == nd.thr) : (b <= nd.thr);
        node[q] = left ? nd.left : nd.right;
      }
      if (!live) break;
    }
    float* dst = scratch + static_cast<size_t>(c0 + j) * nrows + t0;
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int r = g + q * G;
      if (r >= nr) continue;
      const int leaf = node[q] < 0 ? ~node[q] : 0;
      const size_t lj = static_cast<size_t>(j) * L + leaf;
      float v = leaf_f32(s_leaves[lj]);
      if (LINEAR) {
        const int2* a = s_aff + lj * Kf;
        float acc = 0.0f;
        for (int k = 0; k < Kf; ++k) {
          const int2 cf = a[k];
          if (cf.y >= 0)
            acc = __fadd_rn(acc, __fmul_rn(__int_as_float(cf.x),
                                           s_x[cf.y * tile + r]));
        }
        v = __fadd_rn(v, acc);
      }
      dst[r] = v;
    }
  }
}

// Pass 2: out[k, r0 + r] = the Kahan fold over t of scratch[k * T + t][r].
__global__ void fold_trees_kernel(const float* __restrict__ scratch, int K,
                                  int T, int nrows, long long B,
                                  long long r0, float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (i >= static_cast<long long>(K) * nrows) return;
  const int k = static_cast<int>(i / nrows);
  const int r = static_cast<int>(i - static_cast<long long>(k) * nrows);
  const float* col = scratch + static_cast<size_t>(k) * T * nrows + r;
  float acc = 0.0f, comp = 0.0f;
#pragma unroll 8
  for (int t = 0; t < T; ++t) {
    const float v = __ldg(col + static_cast<size_t>(t) * nrows);
    const float y = __fsub_rn(v, comp);
    const float tot = __fadd_rn(acc, y);
    comp = __fsub_rn(__fsub_rn(tot, acc), y);
    acc = tot;
  }
  out[static_cast<size_t>(k) * B + r0 + r] = acc;
}

// Pass 2 for few (class, row) pairs: one warp a pair.  Each lane loads
// one tree's value of a run of 32, the next run's in flight while every
// lane folds this run's 32 values in tree order (the same fold in every
// lane; lane 0 stores it).
__global__ void fold_trees_warp_kernel(const float* __restrict__ scratch,
                                       int K, int T, int nrows, long long B,
                                       long long r0,
                                       float* __restrict__ out) {
  const long long w = (static_cast<long long>(blockIdx.x) * blockDim.x
                       + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= static_cast<long long>(K) * nrows) return;   // warp-uniform
  const int k = static_cast<int>(w / nrows);
  const int r = static_cast<int>(w - static_cast<long long>(k) * nrows);
  const float* col = scratch + static_cast<size_t>(k) * T * nrows + r;
  float acc = 0.0f, comp = 0.0f;
  float next = lane < T ? __ldg(col + static_cast<size_t>(lane) * nrows)
                        : 0.0f;
  for (int t0 = 0; t0 < T; t0 += 32) {
    const float mine = next;
    const int t = t0 + 32 + lane;
    next = t < T ? __ldg(col + static_cast<size_t>(t) * nrows) : 0.0f;
    const int n = min(32, T - t0);
    for (int j = 0; j < n; ++j) {
      const float v = __shfl_sync(kFull, mine, j);
      const float y = __fsub_rn(v, comp);
      const float tot = __fadd_rn(acc, y);
      comp = __fsub_rn(__fsub_rn(tot, acc), y);
      acc = tot;
    }
  }
  if (lane == 0) out[static_cast<size_t>(k) * B + r0 + r] = acc;
}

// Sets the kernel's dynamic shared-memory ceiling once per device: all
// that a block may have beside its static shared memory.
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
  if (dev < kMaxDevices) ready[dev] = true;
  return 0;
}

// One call's plan, as ops/forest_walk.py `plan_walk` makes it.
struct Plan {
  int tile, rows_per_thread, chunk, threads, smem, wave, fold_warps;
};

bool bad_plan(const Plan& p, int K, int T, int M, int L, int leaf_bytes,
              int Kf, bool linear, int F, int B) {
  return K <= 0 || T <= 0 || M <= 0 || L <= 0 || F < 0 || B <= 0
         || p.rows_per_thread != kRows || p.tile <= 0 || p.chunk <= 0
         || p.threads <= 0 || p.threads > kWalkThreads
         || p.threads % 32 != 0 || p.wave <= 0
         || (p.wave + p.tile - 1) / p.tile > kMaxRowTiles
         || p.smem > kMaxSmem
         || smem_bytes(p.chunk, M, L, leaf_bytes, Kf, linear, F, p.tile)
                > static_cast<size_t>(p.smem);
}

template <typename BinT, bool LINEAR, typename LeafT>
int walk(const void* nodes, const void* leaves, int K, int T, int M, int L,
         const BinT* bins, const float* cov, int impute, int F, int B,
         const float* coeff, const int* feat, int Kf, const Plan& p,
         float* scratch, float* out, cudaStream_t stream) {
  auto kern = walk_trees_kernel<BinT, LINEAR, LeafT>;
  static bool ready[kMaxDevices] = {};
  const int e = prepare_once(kern, ready);
  if (e) return e;
  const int KT = K * T;
  const unsigned chunks = static_cast<unsigned>((KT + p.chunk - 1) / p.chunk);
  for (long long r0 = 0; r0 < B; r0 += p.wave) {
    const int nrows = static_cast<int>(
        p.wave < B - r0 ? static_cast<long long>(p.wave) : B - r0);
    const dim3 grid(chunks,
                    static_cast<unsigned>((nrows + p.tile - 1) / p.tile));
    kern<<<grid, p.threads, p.smem, stream>>>(
        static_cast<const Node*>(nodes), static_cast<const LeafT*>(leaves),
        KT, M, L, bins, cov, impute, B, r0, nrows, coeff, feat, Kf, F, p.tile,
        p.chunk, scratch);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long n = static_cast<long long>(K) * nrows
                        * (p.fold_warps ? 32 : 1);
    const unsigned blocks = static_cast<unsigned>((n + kFoldThreads - 1)
                                                  / kFoldThreads);
    if (p.fold_warps)
      fold_trees_warp_kernel<<<blocks, kFoldThreads, 0, stream>>>(
          scratch, K, T, nrows, B, r0, out);
    else
      fold_trees_kernel<<<blocks, kFoldThreads, 0, stream>>>(
          scratch, K, T, nrows, B, r0, out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// The leaf type and the linear flag of one call, resolved to a template.
template <typename BinT>
int dispatch(const void* nodes, const void* leaves, int leaf_bytes, int K,
             int T, int M, int L, const BinT* bins, const float* cov,
             int impute, int F, int B, const float* coeff, const int* feat,
             int Kf, const Plan& p, float* scratch, float* out,
             cudaStream_t stream) {
  const bool linear = coeff != nullptr;
  if (linear && (feat == nullptr || Kf <= 0 || cov == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bad_plan(p, K, T, M, L, leaf_bytes, linear ? Kf : 0, linear, F, B))
    return static_cast<int>(cudaErrorInvalidValue);
#define LGBT_WALK(LIN, LT)                                                  \
  return walk<BinT, LIN, LT>(nodes, leaves, K, T, M, L, bins, cov, impute,  \
                             F, B, coeff, feat, LIN ? Kf : 0, p, scratch,   \
                             out, stream)
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
// nodes [K*T, M] 16-byte records; leaves [K*T, L] of 4-byte f32 or 2-byte
// bf16 words.  A linear forest passes coeff/feat [K*T, L, Kf] and xt
// [F, B] f32 (NaN-imputed); a constant one passes null pointers and
// Kf = 0.  The plan's fields (tile rows, rows a thread, trees a chunk,
// threads, shared bytes, rows a wave, a warp a row in pass 2) come from
// ops/forest_walk.py `plan_walk`; scratch [K*T, wave] f32 needs no
// initial value.
int lgbt_forest_walk_binned(const void* nodes, const void* leaves,
                            int leaf_bytes, int K, int T, int M, int L,
                            const void* bins, int bin_bytes, int F, int B,
                            const float* coeff, const int* feat, int Kf,
                            const float* xt, int tile, int rows_per_thread,
                            int chunk, int threads, int smem, int wave,
                            int fold_warps, float* scratch, float* out,
                            void* stream) {
  const Plan p{tile, rows_per_thread, chunk, threads, smem, wave,
               fold_warps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bin_bytes == 1)
    return dispatch<uint8_t>(nodes, leaves, leaf_bytes, K, T, M, L,
                             static_cast<const uint8_t*>(bins), xt, 0, F, B,
                             coeff, feat, Kf, p, scratch, out, s);
  if (bin_bytes == 2)
    return dispatch<uint16_t>(nodes, leaves, leaf_bytes, K, T, M, L,
                              static_cast<const uint16_t*>(bins), xt, 0, F,
                              B, coeff, feat, Kf, p, scratch, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x [F, B] raw f32, bnd [F, C] f32, cats [F, C] i32, is_cat_col [F] u8
// -> out [K, B].  Leaves, affine tables and the plan as above; the
// covariates are x itself with NaN read as 0.0; bin_scratch [F, B] u16
// receives pass 0's bins.
int lgbt_forest_walk_raw(const void* nodes, const void* leaves,
                         int leaf_bytes, int K, int T, int M, int L,
                         const float* x, const float* bnd, const int* cats,
                         const unsigned char* is_cat_col, int C, int nan_bin,
                         int F, int B, const float* coeff, const int* feat,
                         int Kf, int tile, int rows_per_thread, int chunk,
                         int threads, int smem, int wave, int fold_warps,
                         void* bin_scratch, float* scratch, float* out,
                         void* stream) {
  const Plan p{tile, rows_per_thread, chunk, threads, smem, wave,
               fold_warps};
  if (C <= 0 || F <= 0 || bin_scratch == nullptr
      || bad_plan(p, K, T, M, L, leaf_bytes, coeff ? Kf : 0,
                  coeff != nullptr, F, B))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint16_t* bins = static_cast<uint16_t*>(bin_scratch);
  const long long n = static_cast<long long>(F) * B;
  bucketize_kernel<<<static_cast<unsigned>((n + kBinThreads - 1)
                                           / kBinThreads),
                     kBinThreads, 0, s>>>(x, bnd, cats, is_cat_col, C,
                                          nan_bin, F, B, bins);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return dispatch<uint16_t>(nodes, leaves, leaf_bytes, K, T, M, L, bins,
                            coeff ? x : nullptr, 1, F, B, coeff, feat, Kf, p,
                            scratch, out, s);
}

}  // extern "C"
