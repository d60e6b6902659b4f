// Batched block-Thomas solve of SPD block-tridiagonal systems (K2).
//
// Replaces the Pallas TPU kernel hqp_tpu/ops/thomas_pallas.py::thomas_solve
// (body _kernel, block inverse _inv_unrolled).  For every system m of a
// batch it solves  tridiag(U', D, U) x = rhs  by the block-Thomas sweeps
//     C_0 = D_0^-1,  G_0 = C_0 U_0,  g_0 = C_0 b_0
//     C_i = (D_i - U_{i-1}' G_{i-1})^-1,  G_i = C_i U_i,
//     g_i = C_i (b_i - U_{i-1}' g_{i-1})
//     x_{N-1} = g_{N-1},  x_i = g_i - G_i x_{i+1}
// with every n x n block inverted by Gauss-Jordan WITHOUT pivoting, as the
// TPU kernel does: the caller equilibrates the SPD system first
// (ops/blocktri.equilibrate), which keeps the pivots safe.
//
// What bounds it on an H100: the sequential dependence along N.  The
// DID-1000 master is N = 101 blocks of n = 2 (a few KB), so memory and
// arithmetic are negligible and the time is N dependent steps of a few
// barrier-separated shared-memory passes, plus the launch itself.
//
// Design: one thread block per system (systems of a batch run on separate
// SMs), the sequential loop over N inside the block, and one thread per
// element of the n x n block (n <= 8, so at most 64 busy threads).  The
// G and g scratch arrays are allocated by the wrapper; the block writes
// them to global memory on the forward sweep and reads them back on the
// backward sweep (after a barrier, which makes its own writes visible).
// Kernels launch on the caller's stream and allocate nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxBlock = 8;
constexpr int kThreads = kMaxBlock * kMaxBlock;

// In-place inverse of the n x n block in A (shared) into M (shared):
// Gauss-Jordan without pivoting; thread t owns element (t / n, t % n).
template <typename T>
__device__ void inv_nopiv(T* A, T* M, int n) {
  const int t = threadIdx.x;
  const bool own = t < n * n;
  const int r = own ? t / n : 0, c = own ? t % n : 0;
  if (own) M[t] = (r == c) ? T(1) : T(0);
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    T ak = T(0), mk = T(0), cr = T(0);
    if (own) {
      const T ip = T(1) / A[k * n + k];
      ak = A[k * n + c] * ip;
      mk = M[k * n + c] * ip;
      cr = A[r * n + k];
    }
    __syncthreads();
    if (own) {
      if (r == k) {
        A[t] = ak;
        M[t] = mk;
      } else {
        A[t] = A[t] - cr * ak;
        M[t] = M[t] - cr * mk;
      }
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
thomas_kernel(const T* __restrict__ D, const T* __restrict__ U,
              const T* __restrict__ rhs, T* __restrict__ x,
              T* __restrict__ G, T* __restrict__ g, int N, int n) {
  __shared__ T sA[kThreads];   // block being inverted
  __shared__ T sC[kThreads];   // its inverse
  __shared__ T sr[kMaxBlock];  // right-hand side of the current row
  __shared__ T sx[kMaxBlock];  // x_{i+1} on the backward sweep

  const long m = blockIdx.x;
  const int nn = n * n;
  const int t = threadIdx.x;
  const bool own = t < nn;
  const int r = own ? t / n : 0, c = own ? t % n : 0;
  const T* Dm = D + m * N * nn;
  const T* Um = U + m * (N - 1) * (long)nn;
  const T* bm = rhs + m * (long)N * n;
  T* xm = x + m * (long)N * n;
  T* Gm = G + m * (long)N * nn;
  T* gm = g + m * (long)N * n;

  for (int i = 0; i < N; ++i) {
    // S = D_i - U_{i-1}' G_{i-1},  r = b_i - U_{i-1}' g_{i-1}
    if (own) {
      T acc = Dm[(long)i * nn + t];
      if (i > 0)
        for (int k = 0; k < n; ++k)
          acc -= Um[(long)(i - 1) * nn + k * n + r] *
                 Gm[(long)(i - 1) * nn + k * n + c];
      sA[t] = acc;
    }
    if (t < n) {
      T acc = bm[(long)i * n + t];
      if (i > 0)
        for (int k = 0; k < n; ++k)
          acc -= Um[(long)(i - 1) * nn + k * n + t] * gm[(long)(i - 1) * n + k];
      sr[t] = acc;
    }
    __syncthreads();
    inv_nopiv(sA, sC, n);
    // G_i = C_i U_i (zero past the last coupling), g_i = C_i r
    if (own) {
      T acc = T(0);
      if (i < N - 1)
        for (int k = 0; k < n; ++k)
          acc += sC[r * n + k] * Um[(long)i * nn + k * n + c];
      Gm[(long)i * nn + t] = acc;
    }
    if (t < n) {
      T acc = T(0);
      for (int k = 0; k < n; ++k) acc += sC[t * n + k] * sr[k];
      gm[(long)i * n + t] = acc;
    }
    __syncthreads();
  }

  for (int i = N - 1; i >= 0; --i) {
    T xi = T(0);
    if (t < n) {
      xi = gm[(long)i * n + t];
      if (i < N - 1)
        for (int k = 0; k < n; ++k) xi -= Gm[(long)i * nn + t * n + k] * sx[k];
      xm[(long)i * n + t] = xi;
    }
    __syncthreads();
    if (t < n) sx[t] = xi;
    __syncthreads();
  }
}

template <typename T>
int launch(const T* D, const T* U, const T* rhs, T* x, T* G, T* g, int nb,
           int N, int n, cudaStream_t stream) {
  if (nb <= 0 || N <= 0) return (int)cudaSuccess;
  if (n <= 0 || n > kMaxBlock) return (int)cudaErrorInvalidValue;
  thomas_kernel<T><<<nb, kThreads, 0, stream>>>(D, U, rhs, x, G, g, N, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int hqp_thomas_f64(const double* D, const double* U, const double* rhs,
                   double* x, double* G, double* g, int nb, int N, int n,
                   void* stream) {
  return launch<double>(D, U, rhs, x, G, g, nb, N, n, (cudaStream_t)stream);
}

int hqp_thomas_f32(const float* D, const float* U, const float* rhs,
                   float* x, float* G, float* g, int nb, int N, int n,
                   void* stream) {
  return launch<float>(D, U, rhs, x, G, g, nb, N, n, (cudaStream_t)stream);
}

}  // extern "C"
