// Both children's f32 histograms of a split in one pass (K2), and the same
// pass fused with the per-feature split-gain scan (K3).
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
// shared-memory atomics, and its blocks run in parallel in no order:
//
//   * the grid is (row chunks) x (feature groups), as in leaf_hist.cu.  A
//     block zeroes a private [2][nf][B][3] f32 histogram in shared memory
//     (2 * B * 3 * 4 bytes a feature: 6 KB at 255 bins, 24 KB at 1000; the
//     wrapper sizes the group to a third of an SM), each thread takes rows
//     of the block's chunk in turn, reads the row's leaf id, g, h, w once
//     and, for each feature of the group, adds them into the child's bin
//     with shared atomicAdd; rows of neither child add nothing.  Bins are
//     read feature-major [F, N] as uint8 or uint16, as the dataset holds
//     them (no int32 copy, no row padding);
//   * the block then adds its non-zero entries into a zeroed global
//     [2, F, B, 3] f32 tensor with global atomicAdd.  For K2 that tensor is
//     the output;
//   * K3 accumulates into a zeroed global scratch of the same shape (172 KB
//     at 28 features and 255 bins: it stays in L2).  After its merge, each
//     block fences and takes a ticket on its feature group's counter (a
//     zeroed counter per launch); the block that finishes last runs the
//     per-feature scan of ops/split.py `per_feature_scan` for its group,
//     one warp per (child, feature): an exact prefix over the bins (each
//     lane sums a run of bins in f64, a warp scan joins the runs, each
//     prefix is rounded once to f32, as torch.cumsum on the CPU does), the
//     gain of `leaf_split_gain`, the validity mask, the max gain with ties
//     to the largest threshold, and the left sums at that threshold.  It
//     writes [2, F, 8] (gain, threshold, left g, h, count, 3 zeros), as
//     the TPU kernel does, in one launch.
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
// What bounds it on an H100: at the training root (1M rows, 28 features,
// uint8) the pass reads 28 MB of bins and 16 MB of g, h, w and leaf ids,
// about 0.013 ms at 3.35 TB/s; its 168M adds are 0.0025 ms at 67 TFLOP/s.
// Both kernels are bound by bytes.  This first version is simple: one
// thread a row, three shared atomics per (row, feature), and every feature
// group re-reads the row's 16 bytes of g, h, w and leaf id.  Warp-aggregated
// atomics, a tensor-core one-hot and a direct path for small leaves are
// later work.
//
// Launch rules: the kernels run on the stream they are given (PyTorch's
// current stream), allocate nothing, and each C entry point returns
// cudaGetLastError() right after the launch.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kVals = 3;   // g, h, w
constexpr int kOut = 8;    // gain, threshold, left g/h/count, 3 pad lanes
constexpr unsigned kFull = 0xffffffffu;

struct ScanParams {
  float min_data;   // min_data_in_leaf, compared as f32
  float min_hess;   // min_sum_hessian_in_leaf
  float l1, l2;     // lambda_l1, lambda_l2
  float min_gain;   // min_gain_to_split
};

// Shared accumulation of K2 and K3: this block's rows into shared
// [2][nf][B][3], then the non-zero entries into out [2, F, B, 3].
template <typename BinT>
__device__ void accumulate(const BinT* __restrict__ bins,
                           const float* __restrict__ g,
                           const float* __restrict__ h,
                           const float* __restrict__ w,
                           const int* __restrict__ leaf, int parent,
                           int right, long long N, int F, int B, int fg,
                           long long rows_per_block, float* s_hist,
                           float* __restrict__ out) {
  const int f0 = blockIdx.y * fg;
  const int nf = min(fg, F - f0);
  const int n_sh = 2 * nf * B * kVals;
  for (int i = threadIdx.x; i < n_sh; i += blockDim.x) s_hist[i] = 0.f;
  __syncthreads();

  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = min(r0 + rows_per_block, N);
  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const int lf = leaf[r];
    // the plain version's rule: right wins where both match
    const int c = lf == right ? 1 : (lf == parent ? 0 : -1);
    if (c < 0) continue;
    const float vg = g[r], vh = h[r], vw = w[r];
    float* base = s_hist + c * nf * B * kVals;
    for (int j = 0; j < nf; ++j) {
      const int bin = static_cast<int>(bins[static_cast<long long>(f0 + j) * N
                                            + r]);
      if (bin >= B) continue;
      float* e = base + (j * B + bin) * kVals;
      atomicAdd(e, vg);
      atomicAdd(e + 1, vh);
      atomicAdd(e + 2, vw);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n_sh; i += blockDim.x) {
    const float v = s_hist[i];
    if (v == 0.f) continue;
    const int k = i % kVals;
    int rest = i / kVals;
    const int b = rest % B;
    rest /= B;
    const int j = rest % nf;
    const int c = rest / nf;
    atomicAdd(out + ((static_cast<long long>(c) * F + f0 + j) * B + b) * kVals
                  + k,
              v);
  }
}

template <typename BinT>
__global__ void children_hist_kernel(const BinT* __restrict__ bins,
                                     const float* __restrict__ g,
                                     const float* __restrict__ h,
                                     const float* __restrict__ w,
                                     const int* __restrict__ leaf,
                                     const int* __restrict__ leaves,
                                     long long N, int F, int B, int fg,
                                     long long rows_per_block,
                                     float* __restrict__ out) {
  extern __shared__ float s_hist[];
  accumulate<BinT>(bins, g, h, w, leaf, leaves[0], leaves[1], N, F, B, fg,
                   rows_per_block, s_hist, out);
}

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
// (global scratch, read through L2), written to out[0..7].
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

template <typename BinT>
__global__ void fused_split_kernel(const BinT* __restrict__ bins,
                                   const float* __restrict__ g,
                                   const float* __restrict__ h,
                                   const float* __restrict__ w,
                                   const int* __restrict__ leaf,
                                   const int* __restrict__ leaves,
                                   const float* __restrict__ totals,
                                   const int* __restrict__ num_bin,
                                   const uint8_t* __restrict__ is_cat,
                                   const uint8_t* __restrict__ feat_mask,
                                   ScanParams p, long long N, int F, int B,
                                   int fg, long long rows_per_block,
                                   float* scratch, int* tickets,
                                   float* __restrict__ out) {
  extern __shared__ float s_hist[];
  __shared__ int s_last;
  accumulate<BinT>(bins, g, h, w, leaf, leaves[0], leaves[1], N, F, B, fg,
                   rows_per_block, s_hist, scratch);
  // every add of this block is done (atomics land in L2) before its ticket
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(tickets + blockIdx.y, 1)
             == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  const int f0 = blockIdx.y * fg;
  const int nf = min(fg, F - f0);
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int task = warp; task < 2 * nf; task += nwarps) {
    const int c = task / nf;
    const int f = f0 + task % nf;
    const long long row = static_cast<long long>(c) * F + f;
    scan_feature(scratch + row * B * kVals, B, totals[c * 3],
                 totals[c * 3 + 1], totals[c * 3 + 2], num_bin[f],
                 is_cat[f] != 0, feat_mask[f] != 0 && num_bin[f] > 1, p,
                 out + row * kOut);
  }
}

template <typename Kernel>
int prepare(Kernel kern, size_t smem) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

dim3 grid_of(long long N, int F, int fg, long long rows_per_block) {
  long long chunks = (N + rows_per_block - 1) / rows_per_block;
  if (chunks < 1) chunks = 1;
  const int groups = (F + fg - 1) / fg;
  return dim3(static_cast<unsigned>(chunks), static_cast<unsigned>(groups));
}

bool bad_shape(int F, int B, int fg, long long rows_per_block, int threads) {
  return F <= 0 || B <= 0 || fg <= 0 || rows_per_block <= 0 || threads <= 0
         || threads % 32 != 0;
}

template <typename BinT>
int launch_children(const void* bins, const float* g, const float* h,
                    const float* w, const int* leaf, const int* leaves,
                    long long N, int F, int B, int fg,
                    long long rows_per_block, float* out, int threads,
                    void* stream) {
  if (bad_shape(F, B, fg, rows_per_block, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(2) * fg * B * kVals * sizeof(float);
  auto kern = children_hist_kernel<BinT>;
  const int e = prepare(kern, smem);
  if (e) return e;
  kern<<<grid_of(N, F, fg, rows_per_block), threads, smem,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const BinT*>(bins), g, h, w, leaf, leaves, N, F, B, fg,
      rows_per_block, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename BinT>
int launch_fused(const void* bins, const float* g, const float* h,
                 const float* w, const int* leaf, const int* leaves,
                 const float* totals, const int* num_bin,
                 const uint8_t* is_cat, const uint8_t* feat_mask,
                 ScanParams p, long long N, int F, int B, int fg,
                 long long rows_per_block, float* scratch, int* tickets,
                 float* out, int threads, void* stream) {
  if (bad_shape(F, B, fg, rows_per_block, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(2) * fg * B * kVals * sizeof(float);
  auto kern = fused_split_kernel<BinT>;
  const int e = prepare(kern, smem);
  if (e) return e;
  kern<<<grid_of(N, F, fg, rows_per_block), threads, smem,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const BinT*>(bins), g, h, w, leaf, leaves, totals, num_bin,
      is_cat, feat_mask, p, N, F, B, fg, rows_per_block, scratch, tickets,
      out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// bins [F, N] feature-major codes of `bin_bytes` bytes (1: uint8, 2:
// uint16); g, h, w [N] f32; leaf [N] int32; leaves [2] int32 on the device
// (split leaf, right leaf; -2 for no right child).  out [2, F, B, 3] f32
// must be zero on entry.
int lgbt_children_histograms(const void* bins, int bin_bytes, const void* g,
                             const void* h, const void* w, const void* leaf,
                             const void* leaves, long long N, int F, int B,
                             int fg, long long rows_per_block, void* out,
                             int threads, void* stream) {
  const float* gf = static_cast<const float*>(g);
  const float* hf = static_cast<const float*>(h);
  const float* wf = static_cast<const float*>(w);
  const int* lf = static_cast<const int*>(leaf);
  const int* lv = static_cast<const int*>(leaves);
  float* o = static_cast<float*>(out);
  if (bin_bytes == 1)
    return launch_children<uint8_t>(bins, gf, hf, wf, lf, lv, N, F, B, fg,
                                    rows_per_block, o, threads, stream);
  if (bin_bytes == 2)
    return launch_children<uint16_t>(bins, gf, hf, wf, lf, lv, N, F, B, fg,
                                     rows_per_block, o, threads, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// As lgbt_children_histograms, plus totals [2, 3] f32 (g, h, count of the
// left and right child) on the device, num_bin [F] int32, is_cat and
// feat_mask [F] bool; scratch [2, F, B, 3] f32 and tickets [groups] int32
// must be zero on entry.  Writes out [2, F, 8] f32.
int lgbt_fused_split_candidates(
    const void* bins, int bin_bytes, const void* g, const void* h,
    const void* w, const void* leaf, const void* leaves, const void* totals,
    const void* num_bin, const void* is_cat, const void* feat_mask,
    float min_data, float min_hess, float l1, float l2, float min_gain,
    long long N, int F, int B, int fg, long long rows_per_block,
    void* scratch, void* tickets, void* out, int threads, void* stream) {
  const ScanParams p{min_data, min_hess, l1, l2, min_gain};
  const float* gf = static_cast<const float*>(g);
  const float* hf = static_cast<const float*>(h);
  const float* wf = static_cast<const float*>(w);
  const int* lf = static_cast<const int*>(leaf);
  const int* lv = static_cast<const int*>(leaves);
  const float* tot = static_cast<const float*>(totals);
  const int* nb = static_cast<const int*>(num_bin);
  const uint8_t* cat = static_cast<const uint8_t*>(is_cat);
  const uint8_t* fm = static_cast<const uint8_t*>(feat_mask);
  float* sc = static_cast<float*>(scratch);
  int* tk = static_cast<int*>(tickets);
  float* o = static_cast<float*>(out);
  if (bin_bytes == 1)
    return launch_fused<uint8_t>(bins, gf, hf, wf, lf, lv, tot, nb, cat, fm,
                                 p, N, F, B, fg, rows_per_block, sc, tk, o,
                                 threads, stream);
  if (bin_bytes == 2)
    return launch_fused<uint16_t>(bins, gf, hf, wf, lf, lv, tot, nb, cat, fm,
                                  p, N, F, B, fg, rows_per_block, sc, tk, o,
                                  threads, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
