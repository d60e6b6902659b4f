// Asynchronous global -> shared staging shared by the port's kernels.
//
// cp.async copies bypass the registers; a group of them is committed and
// later waited for.  stage() copies `count` elements of T with 16-byte
// copies for the body of the range, and T-sized copies for a head and a
// tail that are not 16-byte aligned.  So that the body can use 16-byte
// copies whatever the source's alignment, the destination is shifted by
// the source's address modulo 16: a region must be 16-byte aligned and
// hold count * sizeof(T) + 16 bytes, and stage() returns where element 0
// landed.  After the wait, a barrier over every thread that started copies
// makes them visible to all of them.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace hqp {

__host__ __device__ constexpr size_t round16(size_t bytes) {
  return (bytes + 15) & ~size_t(15);
}

// bytes of a staging region for `count` elements of T
template <typename T>
__host__ __device__ constexpr size_t stage_bytes(size_t count) {
  return round16(count * sizeof(T) + 16);
}

// The shared memory one block may use after opting in (227 KB on an
// H100), read once from the current device.
inline int smem_optin() {
  static int limit = -1;
  if (limit < 0) {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
      return 48 * 1024;
    limit = v;
  }
  return limit;
}

template <int Bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (Bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(Bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most `Pending` of this thread's committed groups are in
// flight
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// Where element 0 of src lands in the region at dst.
template <typename T>
__device__ __forceinline__ T* landed(unsigned char* dst, const T* src) {
  return reinterpret_cast<T*>(dst + (reinterpret_cast<uintptr_t>(src) & 15));
}

// Copy src[0, count) into the region at dst by the `nthreads` threads
// numbered `tid` (no commit, no wait); returns the landed element 0.
template <typename T>
__device__ __forceinline__ T* stage(unsigned char* dst, const T* src,
                                    size_t count, int tid, int nthreads) {
  const size_t mis = reinterpret_cast<uintptr_t>(src) & 15;
  unsigned char* d = dst + mis;
  const unsigned char* s = reinterpret_cast<const unsigned char*>(src);
  const size_t bytes = count * sizeof(T);
  const size_t head = ((16 - mis) & 15) < bytes ? ((16 - mis) & 15) : bytes;
  const size_t body_end = head + ((bytes - head) & ~size_t(15));
  constexpr int E = sizeof(T);
  for (size_t o = E * tid; o < head; o += E * nthreads)
    cp_async<E>(d + o, s + o);
  for (size_t o = head + 16 * (size_t)tid; o < body_end; o += 16 * nthreads)
    cp_async<16>(d + o, s + o);
  for (size_t o = body_end + E * tid; o < bytes; o += E * nthreads)
    cp_async<E>(d + o, s + o);
  return reinterpret_cast<T*>(d);
}

}  // namespace hqp
