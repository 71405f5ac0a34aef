// The roll/compare/select stage chain of a bitonic-style stable partition
// over one [12, 2048] int32 block (P1): 28 stages, each rolling the key row
// and the 12 word rows (the key included) by 1 << (s % 7) columns,
// comparing the rolled key with the key as signed int32 and taking the
// rolled column where it is smaller.
//
// Replaces the TPU kernel tools/probe_roll.py `kernel` (the roll-chain
// probe), where each stage is a `pltpu.roll` on the lanes of all 12 rows
// plus a select in vector registers.  Hopper has no cross-lane roll over
// 2048 columns, so the columns live in shared memory, and the design moves
// as little through it as the function allows:
//
//   * one permutation instead of twelve copies.  Each stage's select
//     depends only on the key, and the 12 words of a column move together,
//     so after any number of stages column i holds the words of one source
//     column src[i] of the input, and its key is x[0][src[i]].  The stages
//     carry (key, src) per column, packed as one 8-byte int2; the 12 words
//     are gathered once at the end, out[w][i] = x[w][src[i]] (x is 96 KB,
//     read through L1/L2), with coalesced stores;
//   * one block of 1024 threads, two columns a thread.  A thread keeps its
//     own columns' (key, src) in registers across the stages; per stage
//     and column it reads the rolled column's pair from one shared buffer
//     and writes its new pair into the other (a ping-pong of 2 x 16 KB:
//     reading one buffer while writing the other is what removes the
//     in-place race), then one __syncthreads() ends the stage.  That is
//     16 bytes of shared traffic a column and stage (0.92 MB a launch),
//     where copying the 12 words took 104 (5.96 MB);
//   * 32 KB of static shared memory: nothing is set per launch (no
//     cudaFuncSetAttribute);
//   * the compare is on `int`, so the key's full signed range orders as
//     the TPU's `<` on int32 does.
//
// What bounds it on an H100: the bytes are 2 x 96 KB (in and out, 6e-5 ms
// at 3.35 TB/s) and the work ~1.5 M integer operations, so one instance of
// 28 dependent stages sits far above its bound: the stages' shared-memory
// round trips and barriers on one SM, and the launch itself, set its time.
// `lgbt_empty_launches` launches an empty kernel back to back, the floor
// any launch of this function stands on.
//
// Launch rules: the kernel runs on the stream it is given (PyTorch's
// current stream), allocates nothing, and the C entry point returns
// cudaGetLastError() right after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kWords = 12;
constexpr int kCols = 2048;      // a power of two: the roll wraps by mask
constexpr int kStages = 28;
constexpr int kThreads = 1024;
constexpr int kPerThread = kCols / kThreads;

__global__ void __launch_bounds__(kThreads, 1)
roll_chain_kernel(const int* __restrict__ x, int* __restrict__ out) {
  __shared__ int2 cols[2][kCols];  // (key, source column) a column
  int2 mine[kPerThread];
#pragma unroll
  for (int c = 0; c < kPerThread; ++c) {
    const int i = threadIdx.x + c * kThreads;
    mine[c] = make_int2(x[i], i);
    cols[0][i] = mine[c];
  }
  __syncthreads();

#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    const int shift = 1 << (s % 7);
    const int2* cur = cols[s & 1];
    int2* nxt = cols[(s & 1) ^ 1];
#pragma unroll
    for (int c = 0; c < kPerThread; ++c) {
      const int i = threadIdx.x + c * kThreads;
      const int2 rolled = cur[(i - shift) & (kCols - 1)];
      if (rolled.x < mine[c].x) mine[c] = rolled;
      nxt[i] = mine[c];
    }
    __syncthreads();
  }

#pragma unroll
  for (int c = 0; c < kPerThread; ++c) {
    const int i = threadIdx.x + c * kThreads;
    const int src = mine[c].y;
    out[i] = mine[c].x;            // the key row: x[0][src]
#pragma unroll
    for (int w = 1; w < kWords; ++w)
      out[w * kCols + i] = __ldg(x + w * kCols + src);
  }
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// x, out: [12, 2048] int32, contiguous, distinct.
int lgbt_roll_chain(const void* x, void* out, void* stream) {
  roll_chain_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// `count` launches of an empty one-thread kernel, back to back on `stream`.
int lgbt_empty_launches(int count, void* stream) {
  for (int k = 0; k < count; ++k)
    empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
