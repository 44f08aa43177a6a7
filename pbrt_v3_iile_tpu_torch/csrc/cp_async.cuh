// Asynchronous global -> shared copies (sm_80+ cp.async), 16 bytes at a
// time, grouped and awaited per commit group.
#pragma once

#include <stdint.h>

namespace cp_async {

// Copies 16 bytes from global `src` to shared `dst` (both 16-byte
// aligned), bypassing L1 (.cg): the data is read once per block.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// Closes the current group of copies issued by this thread.
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's groups are still in flight.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace cp_async
