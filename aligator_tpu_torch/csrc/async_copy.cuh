// Asynchronous copies from device memory to shared memory (cp.async,
// sm_80 and later): each thread starts its copies, commits them as a group
// and later waits until at most N of its groups are still in flight. A
// __syncthreads() after the wait makes every thread's copies visible to
// the block. And L2 prefetches. Used by fused_stage.cu (K3, K4).

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace aligator {

// 16 bytes; both addresses 16-byte aligned (L2 only: streamed data)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// one 4- or 8-byte element, naturally aligned
template <int Bytes>
__device__ __forceinline__ void cp_async_small(void* smem, const void* gmem) {
  static_assert(Bytes == 4 || Bytes == 8, "cp.async copies 4, 8 or 16 bytes");
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem),
               "n"(Bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ask for the 128-byte lines of [p, p + bytes) to be brought into L2, the
// block's threads sharing the lines out; nothing waits for them
__device__ __forceinline__ void prefetch_l2(const void* p, size_t bytes) {
  const uintptr_t end = reinterpret_cast<uintptr_t>(p) + bytes;
  for (uintptr_t a = (reinterpret_cast<uintptr_t>(p) & ~uintptr_t(127)) + threadIdx.x * 128;
       a < end; a += blockDim.x * 128)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(a));
}

}  // namespace aligator
