// The roll/compare/select stage chain of a bitonic-style stable partition
// over one [12, 2048] int32 block: 28 stages, each rolling the key row and
// the 12 word rows (the key included) by 1 << (s % 7) columns, comparing
// the rolled key with the key as signed int32 and taking the rolled column
// where it is smaller.
//
// Replaces the TPU kernel tools/probe_roll.py `kernel` (the roll-chain
// probe), where each stage is a `pltpu.roll` on the lanes plus a select
// in vector registers.  Hopper has no cross-lane roll over 2048 columns,
// so the block lives in shared memory:
//
//   * one block of 1024 threads holds the 96 KB instance twice (a
//     ping-pong pair, 192 KB of dynamic shared memory, which needs
//     cudaFuncSetAttribute above 48 KB);
//   * each stage, a thread takes columns t and t + 1024: it reads the key
//     at i and at (i - shift) mod 2048 from one buffer, picks the source
//     column, and copies the 12 words of that column into the other
//     buffer at i; one __syncthreads() ends the stage.  Reading one buffer
//     while writing the other is what removes the in-place race (a column
//     read by one thread is overwritten by another in the same stage);
//   * the compare is on `int`, so the key's full signed range orders as
//     the TPU's `<` on int32 does.
//
// What bounds it on an H100: the bytes are 2 x 96 KB (in and out, 6e-5 ms
// at 3.35 TB/s) and the work ~1.5 M integer operations, so any single-block
// launch sits far above its bound on launch latency and on the 28 serial
// barrier-separated stages of one SM.  This first version is simple and
// exact; batching many instances (one per block) is what would fill the
// card.
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
  extern __shared__ int smem[];  // two [kWords][kCols] buffers
  int* cur = smem;
  int* nxt = smem + kWords * kCols;
  for (int i = threadIdx.x; i < kWords * kCols; i += kThreads) cur[i] = x[i];
  __syncthreads();

#pragma unroll 1
  for (int s = 0; s < kStages; ++s) {
    const int shift = 1 << (s % 7);
#pragma unroll
    for (int c = 0; c < kPerThread; ++c) {
      const int i = threadIdx.x + c * kThreads;
      const int j = (i - shift) & (kCols - 1);
      const int src = cur[j] < cur[i] ? j : i;
#pragma unroll
      for (int w = 0; w < kWords; ++w) nxt[w * kCols + i] = cur[w * kCols + src];
    }
    __syncthreads();
    int* t = cur;
    cur = nxt;
    nxt = t;
  }

  for (int i = threadIdx.x; i < kWords * kCols; i += kThreads) out[i] = cur[i];
}

}  // namespace

extern "C" {

// x, out: [12, 2048] int32, contiguous, distinct.
int lgbt_roll_chain(const void* x, void* out, void* stream) {
  const int smem = 2 * kWords * kCols * static_cast<int>(sizeof(int));
  cudaError_t e = cudaFuncSetAttribute(
      roll_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  roll_chain_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
