// Pieces the register routes of K1 share (gj_interior.cu, the tile route,
// and gj_interior_batch.cu, the batched route): the rounding of the
// elimination and the write-out of Minv, W and Schur from the eliminated
// matrix in shared memory.  Both routes run the same write-out, so their
// W and Schur are summed in the same order.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// A product, then a difference, each rounded: never fused into an FMA, as
// the plain twin (ops/gj_cuda.py) rounds them.
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}

// Minv[i][j] = a[perm[i]][pos[j]];  W = Minv MIB;  Schur = MIB' W.
// a: the eliminated [s, s] matrix by physical row; Bs: MIB; Ws: [s, b]
// scratch; pos: physical row -> logical position, perm its inverse.  Rows
// of Minv i0, i0 + di, ... and their columns j0, j0 + dj, ... fall to this
// thread; W and Schur go by tid over the block's NT threads.
template <typename T, int NT>
__device__ __forceinline__ void write_out(const T* a, const T* Bs, T* Ws,
                                          const int* pos, const int* perm,
                                          T* Mo, T* Wo, T* So, int s, int b,
                                          int i0, int di, int j0, int dj,
                                          int tid) {
  for (int i = i0; i < s; i += di) {
    const T* ar = a + perm[i] * s;
    for (int j = j0; j < s; j += dj) Mo[(long)i * s + j] = ar[pos[j]];
  }
  for (int e = tid; e < s * b; e += NT) {
    const int i = e / b, c = e - i * b;
    const T* ar = a + perm[i] * s;
    T acc[4] = {T(0), T(0), T(0), T(0)};  // 4 chains in flight
    int q = 0;
    for (; q + 4 <= s; q += 4)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        acc[u] += ar[q + u] * Bs[perm[q + u] * b + c];
    for (; q < s; ++q) acc[0] += ar[q] * Bs[perm[q] * b + c];
    const T w = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    Ws[e] = w;
    Wo[e] = w;
  }
  __syncthreads();
  for (int e = tid; e < b * b; e += NT) {
    const int c1 = e / b, c2 = e - c1 * b;
    T acc[4] = {T(0), T(0), T(0), T(0)};
    int i = 0;
    for (; i + 4 <= s; i += 4)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        acc[u] += Bs[(i + u) * b + c1] * Ws[(i + u) * b + c2];
    for (; i < s; ++i) acc[0] += Bs[i * b + c1] * Ws[i * b + c2];
    So[e] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  }
}

}  // namespace
