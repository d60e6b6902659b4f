// Batched pivoted Gauss-Jordan inverse of the partition interiors (K1).
//
// Replaces the Pallas TPU kernel hqp_tpu/ops/gj_pallas.py::interior_factor
// (body _kernel).  For every matrix m of a flattened [B*P] batch it returns
//     Minv_m  = MII_m^-1              [s, s]
//     W_m     = Minv_m MIB_m          [s, b]
//     Schur_m = MIB_m' W_m            [b, b]
// with the TPU kernel's pivot rule: at step k the pivot row is the FIRST
// row i >= k with the largest |A[i, k]| (lowest index on ties; NaN never
// wins), so the kernel and its plain twin (ops/gj_cuda.py) take the same
// pivot sequence.
//
// What bounds it on an H100: latency, not bytes or FLOPs.  The DID-1000
// factor has P = 100 matrices of s = 48 (1.8 MB in f64 in and out, 2*s^3 =
// 0.2 MFLOP each), so the work is one wave of 100 blocks on 132 SMs and the
// time is the s dependent elimination steps, each a few shared-memory
// passes separated by barriers.
//
// Design: one thread block per matrix; the matrix lives in shared memory
// for the whole elimination and is inverted IN PLACE (row interchanges
// recorded, columns unpermuted at the end), so one s x s tile is all the
// shared memory it needs: s^2 * 8 bytes in f64 (18 KB at s = 48, 43 KB at
// s = 73, 123 KB at s = 124).  The two-buffer [A | M] form of the TPU
// kernel would need twice that.  Tiles above 48 KB use dynamic shared
// memory after cudaFuncSetAttribute; the wrapper refuses s past what fits
// in 227 KB.  W and Schur are computed in the same launch from the inverse
// in shared memory (W goes to global memory and is read back after a
// barrier, which makes the block's global writes visible to itself).
// Kernels launch on the caller's stream and allocate nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ void swap_vals(T& a, T& b) {
  T t = a;
  a = b;
  b = t;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gj_interior_kernel(const T* __restrict__ MII, const T* __restrict__ MIB,
                   T* __restrict__ Minv, T* __restrict__ W,
                   T* __restrict__ Schur, int s, int b) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* a = reinterpret_cast<T*>(smem);      // [s, s] working matrix
  T* col = a + s * s;                      // [s] column k before elimination
  int* piv = reinterpret_cast<int*>(col + s);  // [s] pivot row of step k

  const long m = blockIdx.x;
  const int tid = threadIdx.x;
  const int ss = s * s;
  const T* A0 = MII + m * ss;
  const T* B0 = MIB + m * (long)s * b;
  T* Mo = Minv + m * ss;
  T* Wo = W + m * (long)s * b;
  T* So = Schur + m * (long)b * b;

  for (int e = tid; e < ss; e += kThreads) a[e] = A0[e];
  __syncthreads();

  for (int k = 0; k < s; ++k) {
    // pivot search in column k over rows >= k by warp 0: each lane scans
    // its rows in increasing order keeping strict improvements (so the
    // first max per lane), then the shuffle tree prefers the lower row on
    // ties -- the first max overall
    if (tid < 32) {
      T bv = T(-2);
      int bi = s;
      for (int i = k + tid; i < s; i += 32) {
        const T x = a[i * s + k];
        T v = x < T(0) ? -x : x;
        if (!(v >= T(0))) v = T(-1);  // NaN
        if (v > bv) {
          bv = v;
          bi = i;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        T ov = __shfl_down_sync(0xffffffffu, bv, off);
        int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (tid == 0) piv[k] = bi;
    }
    __syncthreads();
    const int p = piv[k];
    if (p != k)
      for (int j = tid; j < s; j += kThreads)
        swap_vals(a[k * s + j], a[p * s + j]);
    __syncthreads();

    const T pinv = T(1) / a[k * s + k];
    for (int i = tid; i < s; i += kThreads) col[i] = a[i * s + k];
    __syncthreads();
    // row k scaled by 1/pivot; its column-k slot takes the inverse's entry
    for (int j = tid; j < s; j += kThreads)
      a[k * s + j] = (j == k) ? pinv : a[k * s + j] * pinv;
    __syncthreads();
    // eliminate column k from every other row
    for (int e = tid; e < ss; e += kThreads) {
      const int i = e / s;
      if (i == k) continue;
      const int j = e - i * s;
      const T f = col[i];
      a[e] = (j == k) ? -f * pinv : a[e] - f * a[k * s + j];
    }
    __syncthreads();
  }

  // undo the row interchanges on the columns, last interchange first
  for (int i = tid; i < s; i += kThreads)
    for (int k = s - 1; k >= 0; --k) {
      const int p = piv[k];
      if (p != k) swap_vals(a[i * s + k], a[i * s + p]);
    }
  __syncthreads();

  for (int e = tid; e < ss; e += kThreads) Mo[e] = a[e];
  for (int e = tid; e < s * b; e += kThreads) {
    const int i = e / b, c = e - i * b;
    T acc = T(0);
    for (int j = 0; j < s; ++j) acc += a[i * s + j] * B0[j * b + c];
    Wo[e] = acc;
  }
  __syncthreads();
  for (int e = tid; e < b * b; e += kThreads) {
    const int c1 = e / b, c2 = e - c1 * b;
    T acc = T(0);
    for (int i = 0; i < s; ++i) acc += B0[i * b + c1] * Wo[i * b + c2];
    So[e] = acc;
  }
}

template <typename T>
size_t smem_bytes(int s) {
  return (size_t)s * s * sizeof(T) + (size_t)s * sizeof(T) +
         (size_t)s * sizeof(int);
}

template <typename T>
int launch(const T* MII, const T* MIB, T* Minv, T* W, T* Schur, int nb,
           int s, int b, cudaStream_t stream) {
  if (nb <= 0 || s <= 0) return (int)cudaSuccess;
  const size_t bytes = smem_bytes<T>(s);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gj_interior_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  gj_interior_kernel<T><<<nb, kThreads, bytes, stream>>>(MII, MIB, Minv, W,
                                                        Schur, s, b);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one matrix of size s needs (the wrapper checks it against
// the device limit before launching).
size_t hqp_gj_interior_smem_f64(int s) { return smem_bytes<double>(s); }
size_t hqp_gj_interior_smem_f32(int s) { return smem_bytes<float>(s); }

int hqp_gj_interior_f64(const double* MII, const double* MIB, double* Minv,
                        double* W, double* Schur, int nb, int s, int b,
                        void* stream) {
  return launch<double>(MII, MIB, Minv, W, Schur, nb, s, b,
                        (cudaStream_t)stream);
}

int hqp_gj_interior_f32(const float* MII, const float* MIB, float* Minv,
                        float* W, float* Schur, int nb, int s, int b,
                        void* stream) {
  return launch<float>(MII, MIB, Minv, W, Schur, nb, s, b,
                       (cudaStream_t)stream);
}

}  // extern "C"
