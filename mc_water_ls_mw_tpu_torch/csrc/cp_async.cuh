// Asynchronous global -> shared copies (cp.async, sm_80 and later):
// the copy needs no register and the thread does not wait for the data
// until it asks to.  Shared by the kernels that stage device rows in
// shared memory (chain_wl.cu, cell_movers.cu).
#pragma once

#include <cuda_runtime.h>

// Copy one element of T (4 or 8 bytes) from src to the shared dst.
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(sizeof(T)));
}

// Close the thread's current group of copies (possibly empty).
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of the thread's groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait for all of the thread's copies.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
