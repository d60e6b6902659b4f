// Batched pivoted Gauss-Jordan inverse of partition interiors too large for
// one block's shared memory (K1, large route).
//
// Replaces the Pallas TPU kernel hqp_tpu/ops/gj_pallas.py::interior_factor
// (body _kernel) for the interiors gj_interior.cu cannot stage: its tile of
// s^2 + 2 s b + 18 s values passes the 227 KB a block may use above s = 151
// in f64 (b = 10), and the TPU kernel takes any s <= 512.  It computes what
// that kernel and the twin (ops/gj_cuda.py::interior_factor_plain) compute,
// for every matrix m of a flattened batch:
//     Minv_m  = MII_m^-1,   W_m = Minv_m MIB_m,   Schur_m = MIB_m' W_m
// with the same pivot rule (the FIRST row i >= k with the largest
// |A[i, k]|; NaN never wins) and the twin's order of operations: the
// elimination rounds a product, then a difference, never fused, so the
// inverse equals the twin's to the last bit.
//
// What bounds it on an H100: the bandwidth between one SM and L2.  The
// whole matrix is read and written once per elimination step: s = 245 in
// f64 is 0.48 MB per pass and 245 passes, ~235 MB through one SM, while
// the bytes the function must move from device memory are 1 MB.
//
// Design (simple first): one block of 1024 threads per matrix; the matrix
// lives in the output Minv, which stays L2-resident (0.48 MB at s = 245,
// 2 MB at s = 512 in f64).  Each step stages the pivot row, column k and
// the scaled pivot row through shared memory; rows are interchanged in
// place, as the twin does, and the column interchanges are undone at the
// end.  Four barriers per step.  A thread-block cluster that holds the
// tile in distributed shared memory is the later, faster design.
// Kernels launch on the caller's stream and allocate nothing.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kTx = 32, kTy = 32;           // column lanes, row groups
constexpr int kThreads = kTx * kTy;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxS = 512;                  // the TPU kernel's own limit
constexpr unsigned kFull = 0xffffffffu;

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

// |x| as a pivot candidate; NaN ranks below every number
template <typename T>
__device__ __forceinline__ T rank(T x) {
  const T v = x < T(0) ? -x : x;
  return v >= T(0) ? v : T(-1);
}

// keep (ov, oi) in (v, i) if it is larger, or equal at a lower row
template <typename T>
__device__ __forceinline__ void keep_better(T ov, int oi, T& v, int& i) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

template <typename T>
__device__ __forceinline__ void warp_best(T& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    keep_better(__shfl_down_sync(kFull, v, o), __shfl_down_sync(kFull, i, o),
                v, i);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
gj_large_kernel(const T* __restrict__ MII, const T* __restrict__ MIB,
                T* __restrict__ Minv, T* __restrict__ W,
                T* __restrict__ Schur, int s, int b) {
  __shared__ T rowk[kMaxS];    // row k after the interchange
  __shared__ T rows[kMaxS];    // the same, scaled by 1/pivot
  __shared__ T colk[kMaxS];    // column k after the interchange
  __shared__ int piv[kMaxS];   // the row interchanged with row k
  __shared__ T cand_v[kWarps];
  __shared__ int cand_i[kWarps];
  const long m = blockIdx.x;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTx + tx, lane = tid & 31, warp = tid >> 5;
  const long ss = (long)s * s;
  T* a = Minv + m * ss;
  const T* A0 = MII + m * ss;
  for (long e = tid; e < ss; e += kThreads) a[e] = A0[e];
  __syncthreads();

  for (int k = 0; k < s; ++k) {
    // 1. the pivot: first max of |a[i][k]| over rows i >= k
    T bv = T(-2);
    int bi = INT_MAX;
    for (int i = k + tid; i < s; i += kThreads)
      keep_better(rank(a[i * (long)s + k]), i, bv, bi);
    warp_best(bv, bi);
    if (lane == 0) {
      cand_v[warp] = bv;
      cand_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = cand_v[lane];
      bi = cand_i[lane];
      warp_best(bv, bi);
      if (lane == 0) piv[k] = bi;
    }
    __syncthreads();
    const int p = piv[k];
    // 2. interchange rows k and p (row k's new values go to shared memory;
    // row k itself is written in step 4)
    for (int j = tid; j < s; j += kThreads) {
      const T vk = a[k * (long)s + j];
      rowk[j] = a[p * (long)s + j];
      a[p * (long)s + j] = vk;
    }
    __syncthreads();
    // 3. column k and the pivot row scaled by 1/pivot (its column-k entry:
    // 1/pivot)
    const T pinv = T(1) / rowk[k];
    for (int j = tid; j < s; j += kThreads) {
      rows[j] = j == k ? pinv : mul_rn(rowk[j], pinv);
      colk[j] = j == k ? rowk[k] : a[j * (long)s + k];
    }
    __syncthreads();
    // 4. eliminate column k from every other row
    for (int i = ty; i < s; i += kTy) {
      T* ar = a + i * (long)s;
      const T ci = colk[i];
      if (i == k) {
        for (int j = tx; j < s; j += kTx) ar[j] = rows[j];
      } else {
        for (int j = tx; j < s; j += kTx)
          ar[j] = j == k ? mul_rn(-ci, pinv) : sub_rn(ar[j], mul_rn(ci, rows[j]));
      }
    }
    __syncthreads();
  }
  // undo the interchanges on the columns, last first
  for (int k = s - 1; k >= 0; --k) {
    const int p = piv[k];
    if (p != k)
      for (int i = tid; i < s; i += kThreads) {
        const T v = a[i * (long)s + k];
        a[i * (long)s + k] = a[i * (long)s + p];
        a[i * (long)s + p] = v;
      }
    __syncthreads();
  }

  // W = Minv MIB;  Schur = MIB' W
  const T* B = MIB + m * (long)s * b;
  T* Wo = W + m * (long)s * b;
  for (int e = tid; e < s * b; e += kThreads) {
    const int i = e / b, c = e - i * b;
    const T* ar = a + i * (long)s;
    T acc[4] = {T(0), T(0), T(0), T(0)};  // 4 chains in flight
    int q = 0;
    for (; q + 4 <= s; q += 4)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[u] += ar[q + u] * B[(q + u) * b + c];
    for (; q < s; ++q) acc[0] += ar[q] * B[q * b + c];
    Wo[e] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  }
  __syncthreads();
  T* So = Schur + m * (long)b * b;
  for (int e = tid; e < b * b; e += kThreads) {
    const int c1 = e / b, c2 = e - c1 * b;
    T acc[4] = {T(0), T(0), T(0), T(0)};
    int i = 0;
    for (; i + 4 <= s; i += 4)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        acc[u] += B[(i + u) * b + c1] * Wo[(i + u) * b + c2];
    for (; i < s; ++i) acc[0] += B[i * b + c1] * Wo[i * b + c2];
    So[e] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  }
}

template <typename T>
int launch(const T* MII, const T* MIB, T* Minv, T* W, T* Schur, int nb,
           int s, int b, cudaStream_t stream) {
  if (nb <= 0 || s <= 0) return (int)cudaSuccess;
  if (s > kMaxS) return (int)cudaErrorInvalidValue;
  gj_large_kernel<T><<<nb, dim3(kTx, kTy), 0, stream>>>(MII, MIB, Minv, W,
                                                        Schur, s, b);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// s > 512 is refused (cudaErrorInvalidValue): the wrapper routes it to
// torch.linalg.inv before it gets here.
int hqp_gj_large_f64(const double* MII, const double* MIB, double* Minv,
                     double* W, double* Schur, int nb, int s, int b,
                     void* stream) {
  return launch<double>(MII, MIB, Minv, W, Schur, nb, s, b,
                        (cudaStream_t)stream);
}

int hqp_gj_large_f32(const float* MII, const float* MIB, float* Minv,
                     float* W, float* Schur, int nb, int s, int b,
                     void* stream) {
  return launch<float>(MII, MIB, Minv, W, Schur, nb, s, b,
                       (cudaStream_t)stream);
}

}  // extern "C"
