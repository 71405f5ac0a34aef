// Both children's f32 histograms of a split in one pass (K2), and the same
// pass fused with the per-feature split-gain scan (K3): one kernel body,
// `fused_split_kernel<BinT, SCAN>`, with SCAN = false for K2.
//
// Replaces the TPU kernels of lightgbm_tpu/ops/pallas_histogram.py:
//   * `children_histograms_pallas` (`_hist_kernel`, reused by
//     `root_histogram_pallas` with leaf 0 and right = -2) -> K2,
//     `lgbt_children_histograms`;
//   * `fused_children_split_candidates_pallas` (`_fused_split_kernel`) -> K3,
//     `lgbt_fused_split_candidates`.
// Both TPU kernels share `_accumulate_block`: for every row whose leaf id is
// the split's `parent` (left child) or `right` (right child), add
// (g, h, w) to that child's (feature, bin) entry.  On the TPU that is a
// one-hot matrix built in VMEM and contracted on the MXU at HIGHEST
// precision (Mosaic has no cheap scatter), and the grid runs in order, so
// the final grid step owns the whole accumulator.  Hopper has fast
// shared-memory atomics, and its blocks run in parallel in no order.
//
// K2 and K3 share one accumulation, built for what the full-pass growers
// launch: a pass over all N rows where the two children often hold few of
// them, so a fixed cost per launch weighs more than the per-row work.
//   * One pass over the rows for all features where shared memory allows:
//     at F = 28, B = 255 both children's histograms take 171 KB of a
//     block's 227 KB.  One persistent block of 1024 threads per SM strides
//     over tiles of 4 x blockDim rows; each thread takes 4 consecutive rows
//     and reads their leaf ids once (16-byte loads where the rows are
//     aligned).  Where F * B does not fit (uint16, 1000 bins), the features
//     split into groups that share the card's blocks.
//   * Sparse tiles are compacted.  When a child holds few rows, most warps
//     hold one child row or two among their 128 and would walk every
//     feature for it.  The block counts its child rows (a warp scan and one
//     shared atomic a warp); when they fit the queue of `queue_cap` rows
//     in shared memory (16 KB beside the histograms), it queues them (row,
//     child, g, h, w) and adds them one row a thread.  A dense tile keeps
//     4 rows a thread: g, h, w in 16-byte loads, then 4 features' bins in
//     flight before their adds.
//   * The root form (K2's `root_histogram`): a null `leaf` pointer puts
//     every row in the left child.  No leaf id is read, no row is counted
//     or queued, and every tile takes the dense path.
//   * Bins are read feature-major [F, N] as the dataset holds them, 4 rows
//     in one 4- or 8-byte load (uint8, uint16) on dense tiles.  Every lane
//     of a warp adds feature j at step j: a lane-staggered order (lane l
//     starting at feature l mod nf) was measured on the card and was 3-10%
//     slower at every leaf occupancy, so it is not kept.  Shared f32
//     atomicAdd is a compare-and-swap loop on this card (int32 is native),
//     which is what the per-row part pays.
//   * Cross-block reduction with no zero-filled scratch and no global
//     atomics: each block writes its shared histogram to its own slot of
//     a partials buffer with plain stores.  The launch is cooperative, with
//     at most as many blocks as can be resident (the wrapper sizes the grid
//     from cudaOccupancyMaxActiveBlocksPerMultiprocessor), so a grid-wide
//     barrier (`this_grid().sync()`) can follow.  Then every thread of the
//     card sums entries of the [2, F, B, 3] histogram over the partials in
//     slot order (a fixed order) into a reduced buffer: K2's output.  K2
//     ends there.  K3 passes a second barrier, and one warp per (child,
//     feature) runs the per-feature scan of ops/split.py
//     `per_feature_scan` on the reduced histogram: an exact prefix over the
//     bins (each lane sums a run of bins in f64, a warp scan joins the
//     runs, each prefix is rounded once to f32, as torch.cumsum on the CPU
//     does), the gain of `leaf_split_gain`, the validity mask, the max
//     gain with ties to the largest threshold, and the left sums at that
//     threshold.  It writes all of [2, F, 8] (gain, threshold, left g, h,
//     count, 3 zeros), as the TPU kernel does.  The buffers come from the
//     wrapper (PyTorch's caching allocator, in the order of the launch's
//     stream) and are never zeroed: the kernel writes every slot it reads.
//
// The split leaf and the new right leaf (and K3's child totals) are read
// from device memory, as the TPU kernel reads them from SMEM, so the grower
// never brings them to the host.
//
// Numbers: f32 atomics make the last bits of every sum depend on the order
// of the adds, which changes from run to run; the plain index_add_ version
// on the card is just as order-dependent.  Kernel and plain version agree
// to a stated tolerance (ops/children_hist.py), not bit for bit.  The gain
// arithmetic uses round-to-nearest intrinsics, so it rounds as the plain
// torch version does (no contraction into FMAs, no fast math).
//
// What bounds them on an H100: at the training root (1M rows, 28 features,
// uint8) the pass reads 28 MB of bins and 16 MB of g, h, w and leaf ids,
// about 0.013 ms at 3.35 TB/s; its 84M adds of 3 values are 0.0025 ms at
// 67 TFLOP/s.  Both are bound by bytes.  What they pay in practice is the
// shared atomics (3 per row and feature, each a compare-and-swap loop) and
// a fixed part: the partials (132 slots of 171 KB) written and summed back,
// and the grid barriers.  The first K2 (a grid of row chunks x feature
// groups, a zeroed output merged into by global atomics, the row's 16
// bytes re-read by every feature group) is gone: K2 is K3 less the scan.
//
// Launch rules: the kernels run on the stream they are given (PyTorch's
// current stream), allocate nothing, and each C entry point returns
// cudaGetLastError() right after the launch.  The shared-memory ceiling is
// set once per kernel and device, not per launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kVals = 3;   // g, h, w
constexpr int kOut = 8;    // gain, threshold, left g/h/count, 3 pad lanes
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRows = 4;   // consecutive rows a thread takes per tile
constexpr int kBatch = 4;  // features whose bins a thread loads at once
constexpr int kMaxSmem = 232448;
constexpr int kMaxDevices = 64;

struct ScanParams {
  float min_data;   // min_data_in_leaf, compared as f32
  float min_hess;   // min_sum_hessian_in_leaf
  float l1, l2;     // lambda_l1, lambda_l2
  float min_gain;   // min_gain_to_split
};

// GetLeafSplitGain (ops/split.py leaf_split_gain) with explicit
// round-to-nearest f32 operations.  (r < 0 ? 0 : r) keeps a NaN as
// torch.clamp does.
__device__ __forceinline__ float split_gain(float sum_g, float sum_h,
                                            float l1, float l2) {
  float r = __fsub_rn(fabsf(sum_g), l1);
  r = r < 0.f ? 0.f : r;
  return __fdiv_rn(__fmul_rn(r, r), __fadd_rn(sum_h, l2));
}

// One warp: the per_feature_scan of one (child, feature) over hist [B][3]
// (global memory other blocks wrote before a barrier, read through L2),
// written to out[0..7].
__device__ void scan_feature(const float* hist, int B, float tg, float th,
                             float tc, int num_bin, bool cat, bool usable,
                             const ScanParams& p, float* out) {
  const int lane = threadIdx.x & 31;
  const int per = (B + 31) / 32;
  const int b0 = min(lane * per, B);
  const int b1 = min(b0 + per, B);

  // exact-as-f64 prefix: this lane's run, then an inclusive warp scan
  double sg = 0.0, sh = 0.0, sc = 0.0;
  for (int b = b0; b < b1; ++b) {
    sg += static_cast<double>(__ldcg(hist + b * kVals));
    sh += static_cast<double>(__ldcg(hist + b * kVals + 1));
    sc += static_cast<double>(__ldcg(hist + b * kVals + 2));
  }
  for (int d = 1; d < 32; d <<= 1) {
    const double og = __shfl_up_sync(kFull, sg, d);
    const double oh = __shfl_up_sync(kFull, sh, d);
    const double oc = __shfl_up_sync(kFull, sc, d);
    if (lane >= d) {
      sg += og;
      sh += oh;
      sc += oc;
    }
  }
  double pg = __shfl_up_sync(kFull, sg, 1);
  double ph = __shfl_up_sync(kFull, sh, 1);
  double pc = __shfl_up_sync(kFull, sc, 1);
  if (lane == 0) pg = ph = pc = 0.0;

  const float gain_shift = split_gain(tg, th, p.l1, p.l2);
  const float min_gain_shift = __fadd_rn(gain_shift, p.min_gain);
  const int t_limit = cat ? num_bin : num_bin - 1;

  float best = -CUDART_INF_F;
  int best_t = -1;
  float blg = 0.f, blh = 0.f, blc = 0.f;
  for (int b = b0; b < b1; ++b) {
    const float hg = __ldcg(hist + b * kVals);
    const float hh = __ldcg(hist + b * kVals + 1);
    const float hc = __ldcg(hist + b * kVals + 2);
    pg += hg;
    ph += hh;
    pc += hc;
    const float lg = cat ? hg : static_cast<float>(pg);
    const float lh = cat ? hh : static_cast<float>(ph);
    const float lc = cat ? hc : static_cast<float>(pc);
    const float rg = __fsub_rn(tg, lg);
    const float rh = __fsub_rn(th, lh);
    const float rc = __fsub_rn(tc, lc);
    const float gain = __fadd_rn(split_gain(lg, lh, p.l1, p.l2),
                                 split_gain(rg, rh, p.l1, p.l2));
    const bool valid = usable && b < t_limit && lc >= p.min_data
        && rc >= p.min_data && lh >= p.min_hess && rh >= p.min_hess
        && gain > min_gain_shift;
    const float gv = valid ? gain : -CUDART_INF_F;
    if (gv >= best) {          // later bins win ties: the largest threshold
      best = gv;
      best_t = b;
      blg = lg;
      blh = lh;
      blc = lc;
    }
  }
  // max over the warp; ties to the larger threshold
  for (int d = 16; d > 0; d >>= 1) {
    const float og = __shfl_down_sync(kFull, best, d);
    const int ot = __shfl_down_sync(kFull, best_t, d);
    const float olg = __shfl_down_sync(kFull, blg, d);
    const float olh = __shfl_down_sync(kFull, blh, d);
    const float olc = __shfl_down_sync(kFull, blc, d);
    if (og > best || (og == best && ot > best_t)) {
      best = og;
      best_t = ot;
      blg = olg;
      blh = olh;
      blc = olc;
    }
  }
  if (lane == 0) {
    out[0] = isfinite(best) ? best : -CUDART_INF_F;
    out[1] = static_cast<float>(best_t);
    out[2] = blg;
    out[3] = blh;
    out[4] = blc;
    out[5] = out[6] = out[7] = 0.f;
  }
}

// Four consecutive rows' bins of one feature (row r0 of a feature-major
// row `col`); `vec` when r0 + 3 < N and the 4 codes are one aligned load.
template <typename BinT>
__device__ __forceinline__ void load_bins(const BinT* __restrict__ col,
                                          long long r0, long long N, bool vec,
                                          int* bin);

template <>
__device__ __forceinline__ void load_bins<uint8_t>(
    const uint8_t* __restrict__ col, long long r0, long long N, bool vec,
    int* bin) {
  if (vec) {
    const uint32_t v = __ldg(reinterpret_cast<const uint32_t*>(col + r0));
#pragma unroll
    for (int i = 0; i < kRows; ++i) bin[i] = (v >> (8 * i)) & 0xff;
  } else {
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      bin[i] = r0 + i < N ? static_cast<int>(col[r0 + i]) : 0;
  }
}

template <>
__device__ __forceinline__ void load_bins<uint16_t>(
    const uint16_t* __restrict__ col, long long r0, long long N, bool vec,
    int* bin) {
  if (vec) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(col + r0));
    bin[0] = v.x & 0xffff;
    bin[1] = v.x >> 16;
    bin[2] = v.y & 0xffff;
    bin[3] = v.y >> 16;
  } else {
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      bin[i] = r0 + i < N ? static_cast<int>(col[r0 + i]) : 0;
  }
}

// Adds one child row's (g, h, w) at its bins of the nf features of the
// group, kBatch features' bins in flight.
template <typename BinT>
__device__ __forceinline__ void add_queued_row(
    const BinT* __restrict__ bins, long long N, long long r, int c, float vg,
    float vh, float vw, int f0, int nf, int B, int n_half,
    float* s_hist) {
  for (int j0 = 0; j0 < nf; j0 += kBatch) {
    int bin[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      bin[u] = j0 + u < nf
          ? static_cast<int>(bins[static_cast<long long>(f0 + j0 + u) * N + r])
          : B;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (bin[u] >= B) continue;
      float* e = s_hist + c * n_half + ((j0 + u) * B + bin[u]) * kVals;
      atomicAdd(e, vg);
      atomicAdd(e + 1, vh);
      atomicAdd(e + 2, vw);
    }
  }
}

// K2 (SCAN = false) and K3.  Grid: `per_group` blocks per feature group;
// block b takes group b / per_group (and every gridDim.x / per_group-th
// after it, when there are more groups than blocks) and tiles
// (b % per_group) + k * per_group of `tile` (= blockDim.x * kRows) rows.
// ops/children_hist.py `fused_block_rows` states the same walk for the
// CPU tests.
// Dynamic shared memory: the histogram [2][nf][B][3] f32, then a queue of
// `queue_cap` child rows (row | child << 31, g, h, w), then 3 counters.
// partials [per_group][2][F][B][3], reduced [2][F][B][3] (K2's output),
// out [2][F][8] (K3 only).  A null `leaf`: every row in the left child.
template <typename BinT, bool SCAN>
__global__ void __launch_bounds__(1024)
fused_split_kernel(const BinT* __restrict__ bins,
                   const float* __restrict__ g, const float* __restrict__ h,
                   const float* __restrict__ w, const int* __restrict__ leaf,
                   const int* parent_p, const int* right_p, int parent_v,
                   int right_v, const float* __restrict__ totals,
                   const int* __restrict__ num_bin,
                   const uint8_t* __restrict__ is_cat,
                   const uint8_t* __restrict__ feat_mask, ScanParams p,
                   long long N, int F, int B, int fg, int groups,
                   int per_group, long long tile, int queue_cap,
                   int vec_rows, float* partials, float* reduced,
                   float* __restrict__ out) {
  extern __shared__ float s_hist[];
  cg::grid_group grid = cg::this_grid();
  const int parent = parent_p ? *parent_p : parent_v;
  const int right = right_p ? *right_p : right_v;
  const bool all_left = leaf == nullptr;
  const int lane = threadIdx.x & 31;
  const int pb = blockIdx.x % per_group;
  const long long ntiles = (N + tile - 1) / tile;
  const long long E = 2LL * F * B * kVals;   // entries of one partial
  unsigned* q_row = reinterpret_cast<unsigned*>(s_hist + 2 * fg * B * kVals);
  float* q_g = reinterpret_cast<float*>(q_row + queue_cap);
  float* q_h = q_g + queue_cap;
  float* q_w = q_h + queue_cap;
  // child rows of a tile, three counters in turn: tile k counts in
  // k % 3 and resets (k + 1) % 3 before its first barrier, which every
  // thread passed after its last read of that counter (tile k - 2)
  int* s_count = reinterpret_cast<int*>(q_w + queue_cap);
  for (int gi = blockIdx.x / per_group; gi < groups;
       gi += gridDim.x / per_group) {
    const int f0 = gi * fg;
    const int nf = min(fg, F - f0);
    const int n_half = nf * B * kVals;
    for (int i = threadIdx.x; i < 2 * n_half; i += blockDim.x)
      s_hist[i] = 0.f;
    if (threadIdx.x < 3) s_count[threadIdx.x] = 0;
    __syncthreads();
    int slot = 0;
    for (long long t = pb; t < ntiles;
         t += per_group, slot = slot == 2 ? 0 : slot + 1) {
      const long long r0 = t * tile + static_cast<long long>(threadIdx.x)
                                          * kRows;
      // 16-byte row loads (leaf, g, h, w) and one-load bins need
      // N % 4 == 0 and aligned bases (the wrapper checks them: vec_rows)
      const bool vec = vec_rows && r0 + kRows <= N;
      int c[kRows];
      if (all_left) {
#pragma unroll
        for (int i = 0; i < kRows; ++i) c[i] = r0 + i < N ? 0 : -1;
      } else if (vec) {
        const int4 l4 = __ldg(reinterpret_cast<const int4*>(leaf + r0));
        const int lf[kRows] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          // the plain version's rule: right wins where both match
          c[i] = lf[i] == right ? 1 : (lf[i] == parent ? 0 : -1);
      } else {
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const long long r = r0 + i;
          const int lf = r < N ? leaf[r] : parent;
          c[i] = r >= N ? -1 : (lf == right ? 1 : (lf == parent ? 0 : -1));
        }
      }
      int mine = 0;
#pragma unroll
      for (int i = 0; i < kRows; ++i) mine += c[i] >= 0;
      // this thread's child rows, their place among the warp's, and the
      // warp's place among the tile's (one shared atomic a warp); the
      // root form (block-uniform) skips it: all its tiles are dense
      int before = mine, base = 0, n = 0;
      if (!all_left) {
        for (int d = 1; d < 32; d <<= 1) {
          const int o = __shfl_up_sync(kFull, before, d);
          if (lane >= d) before += o;
        }
        if (lane == 31 && before > 0)
          base = atomicAdd(&s_count[slot], before);
        base = __shfl_sync(kFull, base, 31) + before - mine;
        if (threadIdx.x == 0) s_count[slot == 2 ? 0 : slot + 1] = 0;
        __syncthreads();
        n = s_count[slot];
        if (n == 0) continue;            // block-uniform: no child row
      }
      if (!all_left && n <= queue_cap) {
        // sparse tile: queue the child rows, then one row a thread
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          if (c[i] < 0) continue;
          const long long r = r0 + i;
          q_row[base] = static_cast<unsigned>(r)
                        | (static_cast<unsigned>(c[i]) << 31);
          q_g[base] = g[r];
          q_h[base] = h[r];
          q_w[base] = w[r];
          ++base;
        }
        __syncthreads();
        for (int q = threadIdx.x; q < n; q += blockDim.x) {
          const unsigned e = q_row[q];
          add_queued_row<BinT>(bins, N, e & 0x7fffffffu,
                               static_cast<int>(e >> 31), q_g[q], q_h[q],
                               q_w[q], f0, nf, B, n_half, s_hist);
        }
        __syncthreads();                 // the queue is free again
        continue;
      }
      // dense tile: every thread its own 4 rows, 4 features' bins a load
      if (!__any_sync(kFull, mine > 0) || mine == 0) continue;
      float vg[kRows], vh[kRows], vw[kRows];
      if (vec) {
        const float4 g4 = __ldg(reinterpret_cast<const float4*>(g + r0));
        const float4 h4 = __ldg(reinterpret_cast<const float4*>(h + r0));
        const float4 w4 = __ldg(reinterpret_cast<const float4*>(w + r0));
        vg[0] = g4.x; vg[1] = g4.y; vg[2] = g4.z; vg[3] = g4.w;
        vh[0] = h4.x; vh[1] = h4.y; vh[2] = h4.z; vh[3] = h4.w;
        vw[0] = w4.x; vw[1] = w4.y; vw[2] = w4.z; vw[3] = w4.w;
      } else {
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const long long r = r0 + i;
          vg[i] = c[i] >= 0 ? g[r] : 0.f;
          vh[i] = c[i] >= 0 ? h[r] : 0.f;
          vw[i] = c[i] >= 0 ? w[r] : 0.f;
        }
      }
      for (int j0 = 0; j0 < nf; j0 += kBatch) {
        int bin[kBatch][kRows];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (j0 + u < nf)
            load_bins<BinT>(bins + static_cast<long long>(f0 + j0 + u) * N,
                            r0, N, vec, bin[u]);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (j0 + u >= nf) break;
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            if (c[i] < 0 || bin[u][i] >= B) continue;
            float* e = s_hist + c[i] * n_half
                       + ((j0 + u) * B + bin[u][i]) * kVals;
            atomicAdd(e, vg[i]);
            atomicAdd(e + 1, vh[i]);
            atomicAdd(e + 2, vw[i]);
          }
        }
      }
    }
    __syncthreads();
    // this block's partial, plain stores: [2][F][B][3] at slot pb
    float* dst = partials + static_cast<long long>(pb) * E;
    for (int i = threadIdx.x; i < 2 * n_half; i += blockDim.x) {
      const int cc = i / n_half;
      dst[(static_cast<long long>(cc) * F + f0) * B * kVals + (i - cc * n_half)]
          = s_hist[i];
    }
    __syncthreads();
  }

  grid.sync();
  // every entry summed over the partials in slot order; runs of 32
  // entries dealt round the blocks, so that every SM takes a share
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long runs = (E + 31) / 32;
  for (long long k = blockIdx.x + static_cast<long long>(warp) * gridDim.x;
       k < runs; k += static_cast<long long>(nwarps) * gridDim.x) {
    const long long e = k * 32 + lane;
    if (e >= E) continue;
    float s = 0.f;
#pragma unroll 32
    for (int q = 0; q < per_group; ++q) s += __ldcg(partials + q * E + e);
    reduced[e] = s;
  }
  if constexpr (!SCAN) return;         // K2: the reduced sums are its output
  grid.sync();

  // one warp per (child, feature), dealt round the blocks
  for (int task = blockIdx.x + warp * gridDim.x; task < 2 * F;
       task += nwarps * gridDim.x) {
    const int cc = task / F;
    const int f = task - cc * F;
    scan_feature(reduced + static_cast<long long>(task) * B * kVals, B,
                 totals[cc * 3], totals[cc * 3 + 1], totals[cc * 3 + 2],
                 num_bin[f], is_cat[f] != 0,
                 feat_mask[f] != 0 && num_bin[f] > 1, p, out + task * kOut);
  }
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

// The least dynamic shared memory K3's layout needs: the histogram, the
// child-row queue and its counters (the wrapper's plan gives the size).
size_t fused_smem(int fg, int B, int queue_cap) {
  return static_cast<size_t>(2) * fg * B * kVals * sizeof(float)
         + static_cast<size_t>(queue_cap) * 4 * sizeof(float) + 16;
}

template <typename BinT, bool SCAN>
int fused_resident(int smem, int threads, int* blocks_per_sm, int* sms) {
  auto kern = fused_split_kernel<BinT, SCAN>;
  static bool ready[kMaxDevices] = {};
  const int e = prepare_once(kern, ready);
  if (e) return e;
  int dev = 0;
  cudaError_t r = cudaGetDevice(&dev);
  if (r == cudaSuccess)
    r = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (r == cudaSuccess)
    r = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kern,
                                                      threads, smem);
  return static_cast<int>(r);
}

template <typename BinT, bool SCAN>
int launch_fused(const void* bins, const float* g, const float* h,
                 const float* w, const int* leaf, const int* parent_p,
                 const int* right_p, int parent_v, int right_v,
                 const float* totals, const int* num_bin,
                 const uint8_t* is_cat, const uint8_t* feat_mask,
                 ScanParams p, long long N, int F, int B, int fg, int groups,
                 int per_group, int grid, long long tile, int queue_cap,
                 int smem, int vec_rows, float* partials, float* reduced,
                 float* out, int threads, cudaStream_t stream) {
  auto kern = fused_split_kernel<BinT, SCAN>;
  static bool ready[kMaxDevices] = {};
  const int e = prepare_once(kern, ready);
  if (e) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t l = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const BinT*>(bins), g, h, w, leaf, parent_p,
      right_p, parent_v, right_v, totals, num_bin, is_cat, feat_mask, p, N, F,
      B, fg, groups, per_group, tile, queue_cap, vec_rows, partials, reduced,
      out);
  if (l != cudaSuccess) return static_cast<int>(l);
  return static_cast<int>(cudaGetLastError());
}

// The launch plan's fields a kernel refuses (ops/children_hist.py
// plan_fused makes them).
bool bad_plan(long long N, int F, int B, int fg, int groups, int per_group,
              int grid, long long tile, int queue_cap, int smem,
              int threads) {
  return F <= 0 || B <= 0 || fg <= 0 || groups != (F + fg - 1) / fg
         || per_group <= 0 || grid <= 0 || grid % per_group != 0
         || (grid / per_group > groups) || threads <= 0 || threads > 1024
         || threads % 32 != 0 || N >= (1LL << 31)
         || tile != static_cast<long long>(threads) * kRows || queue_cap <= 0
         || smem > kMaxSmem
         || fused_smem(fg, B, queue_cap) > static_cast<size_t>(smem);
}

}  // namespace

extern "C" {

// K2.  bins [F, N] feature-major codes of `bin_bytes` bytes (1: uint8, 2:
// uint16); g, h, w [N] f32; leaf [N] int32, or null for the root form
// (every row in the left child).  The split leaf and the right leaf (-2
// for none) are each a device int32 (parent_p, right_p) or, where that
// pointer is null, the value given (parent_v, right_v).  A cooperative
// launch of `grid` blocks (no more than can be resident), `per_group` of
// them per feature group of `fg`; partials [per_group, 2, F, B, 3] f32 need
// no initial value.  Each block strides over tiles of `tile` rows, which
// must be threads * kRows (4 rows a thread), and queues up to `queue_cap`
// child rows of a tile in its `smem` bytes of dynamic shared memory.
// `vec_rows`: N % 4 == 0 and every base 16-byte aligned.  Writes out
// [2, F, B, 3] f32 whole.
int lgbt_children_histograms(const void* bins, int bin_bytes, const void* g,
                             const void* h, const void* w, const void* leaf,
                             const void* parent_p, const void* right_p,
                             int parent_v, int right_v, long long N, int F,
                             int B, int fg, int groups, int per_group,
                             int grid, long long tile, int queue_cap,
                             int smem, int vec_rows, void* partials,
                             void* out, int threads, void* stream) {
  if (bad_plan(N, F, B, fg, groups, per_group, grid, tile, queue_cap, smem,
               threads))
    return static_cast<int>(cudaErrorInvalidValue);
  const ScanParams p{};
  const float* gf = static_cast<const float*>(g);
  const float* hf = static_cast<const float*>(h);
  const float* wf = static_cast<const float*>(w);
  const int* lf = static_cast<const int*>(leaf);
  const int* pp = static_cast<const int*>(parent_p);
  const int* rp = static_cast<const int*>(right_p);
  float* pa = static_cast<float*>(partials);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bin_bytes == 1)
    return launch_fused<uint8_t, false>(
        bins, gf, hf, wf, lf, pp, rp, parent_v, right_v, nullptr, nullptr,
        nullptr, nullptr, p, N, F, B, fg, groups, per_group, grid, tile,
        queue_cap, smem, vec_rows, pa, o, nullptr, threads, s);
  if (bin_bytes == 2)
    return launch_fused<uint16_t, false>(
        bins, gf, hf, wf, lf, pp, rp, parent_v, right_v, nullptr, nullptr,
        nullptr, nullptr, p, N, F, B, fg, groups, per_group, grid, tile,
        queue_cap, smem, vec_rows, pa, o, nullptr, threads, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The most blocks of the kernel for `bin_bytes`, with the scan (`scan`
// != 0: K3) or without (K2), with `smem` bytes of dynamic shared memory
// (histogram and queue) and `threads` threads that one SM holds at once,
// and the SM count: the wrapper's cooperative grid never exceeds their
// product.
int lgbt_fused_resident_blocks(int bin_bytes, int scan, int smem,
                               int threads, int* blocks_per_sm, int* sms) {
  if (bin_bytes == 1)
    return scan ? fused_resident<uint8_t, true>(smem, threads, blocks_per_sm,
                                                sms)
                : fused_resident<uint8_t, false>(smem, threads,
                                                 blocks_per_sm, sms);
  if (bin_bytes == 2)
    return scan ? fused_resident<uint16_t, true>(smem, threads,
                                                 blocks_per_sm, sms)
                : fused_resident<uint16_t, false>(smem, threads,
                                                  blocks_per_sm, sms);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K3.  As lgbt_children_histograms, plus totals [2, 3] f32 (g, h, count of
// the left and right child) on the device, num_bin [F] int32, is_cat and
// feat_mask [F] bool; reduced [2, F, B, 3] f32 needs no initial value.
// Writes out [2, F, 8] f32 whole.
int lgbt_fused_split_candidates(
    const void* bins, int bin_bytes, const void* g, const void* h,
    const void* w, const void* leaf, const void* parent_p,
    const void* right_p, int parent_v, int right_v, const void* totals,
    const void* num_bin, const void* is_cat, const void* feat_mask,
    float min_data, float min_hess, float l1, float l2, float min_gain,
    long long N, int F, int B, int fg, int groups, int per_group, int grid,
    long long tile, int queue_cap, int smem, int vec_rows, void* partials,
    void* reduced, void* out, int threads, void* stream) {
  if (bad_plan(N, F, B, fg, groups, per_group, grid, tile, queue_cap, smem,
               threads))
    return static_cast<int>(cudaErrorInvalidValue);
  const ScanParams p{min_data, min_hess, l1, l2, min_gain};
  const float* gf = static_cast<const float*>(g);
  const float* hf = static_cast<const float*>(h);
  const float* wf = static_cast<const float*>(w);
  const int* lf = static_cast<const int*>(leaf);
  const int* pp = static_cast<const int*>(parent_p);
  const int* rp = static_cast<const int*>(right_p);
  const float* tot = static_cast<const float*>(totals);
  const int* nb = static_cast<const int*>(num_bin);
  const uint8_t* cat = static_cast<const uint8_t*>(is_cat);
  const uint8_t* fm = static_cast<const uint8_t*>(feat_mask);
  float* pa = static_cast<float*>(partials);
  float* re = static_cast<float*>(reduced);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bin_bytes == 1)
    return launch_fused<uint8_t, true>(bins, gf, hf, wf, lf, pp, rp,
                                       parent_v, right_v, tot, nb, cat, fm,
                                       p, N, F, B, fg, groups, per_group,
                                       grid, tile, queue_cap, smem, vec_rows,
                                       pa, re, o, threads, s);
  if (bin_bytes == 2)
    return launch_fused<uint16_t, true>(bins, gf, hf, wf, lf, pp, rp,
                                        parent_v, right_v, tot, nb, cat, fm,
                                        p, N, F, B, fg, groups, per_group,
                                        grid, tile, queue_cap, smem,
                                        vec_rows, pa, re, o, threads, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
