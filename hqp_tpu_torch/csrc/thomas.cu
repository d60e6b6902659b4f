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
// TPU kernel does (row k scaled by 1/pivot, then eliminated, in the order
// of the plain twin ops/thomas_cuda.py::_inv_nopiv): the caller
// equilibrates the SPD system first (ops/blocktri.equilibrate), which
// keeps the pivots safe.
//
// What bounds it on an H100: the latency of the N dependent steps.  The
// DID-1000 master is N = 101 blocks of n = 2: 9.7 KB in and out and about
// 8 kFLOP, nothing against 3.35 TB/s or the FP64 rate, so the time is N
// times the latency of one step plus the launch.
//
// Design: everything that a step waits for stays in registers.
// - One warp per system (one system per block of 32 threads; a batch runs
//   on separate SMs).  Lane e holds element e of an n x n block (n <= 8,
//   so at most two elements a lane); lane t < n holds element t of a
//   vector.  Steps exchange values by register shuffles: no barrier and no
//   memory round trip is on the forward or the backward chain.
// - G_{i-1} and g_{i-1} are carried in registers into step i.  The stored
//   G and g serve only the backward sweep: they go to shared memory where
//   they fit, else to the caller's global scratch; either way their
//   writes are off the chain.
// - D, U and rhs are staged into shared memory by cp.async before the
//   sweep (16-byte copies, coalesced).  A system too large for one block's
//   shared memory streams through a ring of two chunks instead: the next
//   chunk's copies are in flight while the current chunk is solved.  Every
//   (N, n <= 8) is taken.
// Tensor cores do not pay here: the products are 2x2 to 8x8, the bound is
// latency, and Hopper has no f64 wgmma.
// Kernels launch on the caller's stream and allocate nothing.

#include <cuda_runtime.h>

#include "staging.cuh"

namespace {

constexpr int kMaxBlock = 8;
constexpr unsigned kFull = 0xffffffffu;
// shared memory of the two-chunk ring used when a system does not fit
constexpr size_t kRingBytes = 48 * 1024;

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

// Element e of an n x n block spread over the warp (element e in lane
// e % 32, register slot e / 32).  Every lane of the warp must call it.
template <typename T, int SL>
__device__ __forceinline__ T fetch(const T (&v)[SL], int e) {
  T x = __shfl_sync(kFull, v[0], e & 31);
  if constexpr (SL > 1) {
    const T y = __shfl_sync(kFull, v[1], e & 31);
    if (e >= 32) x = y;
  }
  return x;
}

// Shared memory of one system: `nslots` chunk slots of CH blocks each
// (D, U with one leading block, rhs), then G and g if they live there.
struct Layout {
  size_t d, u, b, slot, G, g, total;
};

template <typename T>
__host__ __device__ Layout layout(int n, int CH, int nslots, int N,
                                  bool g_in_smem) {
  Layout L;
  const size_t nn = (size_t)n * n;
  L.d = hqp::stage_bytes<T>((size_t)CH * nn);
  L.u = hqp::stage_bytes<T>((size_t)(CH + 1) * nn);
  L.b = hqp::stage_bytes<T>((size_t)CH * n);
  L.slot = L.d + L.u + L.b;
  L.G = nslots * L.slot;
  L.g = L.G + (g_in_smem ? hqp::round16((size_t)N * nn * sizeof(T)) : 0);
  L.total = L.g + (g_in_smem ? hqp::round16((size_t)N * n * sizeof(T)) : 0);
  return L;
}

template <typename T, int NB>
__global__ void __launch_bounds__(32)
thomas_kernel(const T* __restrict__ D, const T* __restrict__ U,
              const T* __restrict__ rhs, T* __restrict__ x, T* Gg, T* gg,
              int N, int CH, int g_in_smem) {
  constexpr int NN = NB * NB, SL = (NN + 31) / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nch = (N + CH - 1) / CH;
  const Layout L = layout<T>(NB, CH, nch > 1 ? 2 : 1, N, g_in_smem);
  const int lane = threadIdx.x;
  const long m = blockIdx.x;
  const T* Dm = D + m * N * NN;
  const T* Um = U + m * (long)(N - 1) * NN;
  const T* bm = rhs + m * (long)N * NB;
  T* xm = x + m * (long)N * NB;
  T* Gs = g_in_smem ? reinterpret_cast<T*>(smem + L.G) : Gg + m * N * NN;
  T* gs = g_in_smem ? reinterpret_cast<T*>(smem + L.g) : gg + m * N * NB;

  // this lane's block elements (lanes past the block mirror element 0)
  int e[SL], r[SL], c[SL];
  bool own[SL];
#pragma unroll
  for (int s = 0; s < SL; ++s) {
    e[s] = lane + 32 * s;
    own[s] = e[s] < NN;
    if (!own[s]) e[s] = 0;
    r[s] = e[s] / NB;
    c[s] = e[s] % NB;
  }
  const int t = lane < NB ? lane : 0;  // this lane's vector element

  // chunk ch: blocks [i0, i0 + len) of D and rhs, [lo, hi) of U
  auto bounds = [&](int ch, int& i0, int& len, int& lo, int& hi) {
    i0 = ch * CH;
    len = min(CH, N - i0);
    lo = max(i0 - 1, 0);
    hi = min(i0 + len, N - 1);
  };
  auto stage_chunk = [&](int ch) {
    int i0, len, lo, hi;
    bounds(ch, i0, len, lo, hi);
    unsigned char* base = smem + (ch & 1) * L.slot;
    hqp::stage(base, Dm + (long)i0 * NN, (size_t)len * NN, lane, 32);
    hqp::stage(base + L.d, Um + (long)lo * NN,
               hi > lo ? (size_t)(hi - lo) * NN : 0, lane, 32);
    hqp::stage(base + L.d + L.u, bm + (long)i0 * NB, (size_t)len * NB, lane,
               32);
    hqp::cp_async_commit();
  };

  stage_chunk(0);
  if (nch > 1) stage_chunk(1);
  T Gp[SL], gp = T(0);  // G_{i-1}, g_{i-1}
#pragma unroll
  for (int s = 0; s < SL; ++s) Gp[s] = T(0);

  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch)
      hqp::cp_async_wait<1>();
    else
      hqp::cp_async_wait<0>();
    __syncwarp();
    int i0, len, lo, hi;
    bounds(ch, i0, len, lo, hi);
    unsigned char* base = smem + (ch & 1) * L.slot;
    const T* sD = hqp::landed(base, Dm + (long)i0 * NN);
    const T* sU = hqp::landed(base + L.d, Um + (long)lo * NN);
    const T* sb = hqp::landed(base + L.d + L.u, bm + (long)i0 * NB);

    for (int i = i0; i < i0 + len; ++i) {
      const T* Di = sD + (i - i0) * NN;
      const T* Up = sU + (i - 1 - lo) * NN;  // U_{i-1}, read when i > 0
      const T* Ui = sU + (i - lo) * NN;      // U_i, read when i < N - 1
      // S = D_i - U_{i-1}' G_{i-1},  rv = b_i - U_{i-1}' g_{i-1}
      T S[SL], M[SL];
#pragma unroll
      for (int s = 0; s < SL; ++s) S[s] = Di[e[s]];
      T rv = sb[(i - i0) * NB + t];
      if (i > 0) {
#pragma unroll
        for (int s = 0; s < SL; ++s) {
          T acc = T(0);
#pragma unroll
          for (int k = 0; k < NB; ++k)
            acc += Up[k * NB + r[s]] * fetch(Gp, k * NB + c[s]);
          S[s] -= acc;
        }
        T acc = T(0);
#pragma unroll
        for (int k = 0; k < NB; ++k)
          acc += Up[k * NB + t] * __shfl_sync(kFull, gp, k);
        rv -= acc;
      }
      // C = S^-1 (in M) by Gauss-Jordan without pivoting
#pragma unroll
      for (int s = 0; s < SL; ++s) M[s] = r[s] == c[s] ? T(1) : T(0);
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        const T ip = T(1) / fetch(S, k * NB + k);
        T ak[SL], mk[SL], cr[SL];
#pragma unroll
        for (int s = 0; s < SL; ++s) {
          ak[s] = mul_rn(fetch(S, k * NB + c[s]), ip);
          mk[s] = mul_rn(fetch(M, k * NB + c[s]), ip);
          cr[s] = fetch(S, r[s] * NB + k);
        }
#pragma unroll
        for (int s = 0; s < SL; ++s) {
          if (r[s] == k) {
            S[s] = ak[s];
            M[s] = mk[s];
          } else {
            S[s] = sub_rn(S[s], mul_rn(cr[s], ak[s]));
            M[s] = sub_rn(M[s], mul_rn(cr[s], mk[s]));
          }
        }
      }
      // G_i = C U_i (zero past the last coupling), g_i = C rv
#pragma unroll
      for (int s = 0; s < SL; ++s) {
        T acc = T(0);
        if (i < N - 1) {
#pragma unroll
          for (int k = 0; k < NB; ++k)
            acc += fetch(M, r[s] * NB + k) * Ui[k * NB + c[s]];
        }
        Gp[s] = acc;
        if (own[s]) Gs[(long)i * NN + e[s]] = acc;
      }
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < NB; ++k)
        acc += fetch(M, t * NB + k) * __shfl_sync(kFull, rv, k);
      gp = acc;
      if (lane < NB) gs[(long)i * NB + lane] = acc;
    }
    __syncwarp();  // every lane is done with this slot
    if (ch + 2 < nch) stage_chunk(ch + 2);
  }

  // backward sweep: the stored G and g are read off the chain
  if (!g_in_smem) __threadfence_block();
  __syncwarp();
  T xv = gs[(long)(N - 1) * NB + t];
  if (lane < NB) xm[(long)(N - 1) * NB + lane] = xv;
  for (int i = N - 2; i >= 0; --i) {
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < NB; ++k)
      acc += Gs[(long)i * NN + t * NB + k] * __shfl_sync(kFull, xv, k);
    xv = gs[(long)i * NB + t] - acc;
    if (lane < NB) xm[(long)i * NB + lane] = xv;
  }
}

struct Plan {
  int CH;          // blocks per chunk (N: the whole system at once)
  bool g_in_smem;  // G and g stored in shared memory
  size_t bytes;    // dynamic shared memory
};

// The whole system staged with G and g beside it if that fits in one
// block's shared memory, else the whole system with G and g in global
// scratch, else the two-chunk ring.
template <typename T>
Plan plan(int N, int n) {
  const size_t limit = hqp::smem_optin();
  Layout L = layout<T>(n, N, 1, N, true);
  if (L.total <= limit) return {N, true, L.total};
  L = layout<T>(n, N, 1, N, false);
  if (L.total <= limit) return {N, false, L.total};
  int CH = (int)(kRingBytes / (2 * (2 * n * n + n) * sizeof(T)));
  while (CH > 1 && layout<T>(n, CH, 2, N, false).total > kRingBytes) --CH;
  return {CH, false, layout<T>(n, CH, 2, N, false).total};
}

template <typename T>
int plan_code(int N, int n) {
  if (N <= 0 || n <= 0 || n > kMaxBlock) return -1;
  const Plan p = plan<T>(N, n);
  return p.g_in_smem ? 0 : (p.CH < N ? 2 : 1);
}

template <typename T, int NB>
int launch_nb(const T* D, const T* U, const T* rhs, T* x, T* G, T* g, int nb,
              int N, const Plan& p, cudaStream_t stream) {
  if (p.bytes > 48 * 1024) {
    static bool raised = false;
    if (!raised) {
      cudaError_t err = cudaFuncSetAttribute(
          thomas_kernel<T, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          hqp::smem_optin());
      if (err != cudaSuccess) return (int)err;
      raised = true;
    }
  }
  thomas_kernel<T, NB><<<nb, 32, p.bytes, stream>>>(D, U, rhs, x, G, g, N,
                                                     p.CH, p.g_in_smem);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* D, const T* U, const T* rhs, T* x, T* G, T* g, int nb,
           int N, int n, cudaStream_t stream) {
  if (nb <= 0 || N <= 0) return (int)cudaSuccess;
  if (n <= 0 || n > kMaxBlock) return (int)cudaErrorInvalidValue;
  const Plan p = plan<T>(N, n);
  if (!p.g_in_smem && (G == nullptr || g == nullptr))
    return (int)cudaErrorInvalidValue;
  switch (n) {
    case 1: return launch_nb<T, 1>(D, U, rhs, x, G, g, nb, N, p, stream);
    case 2: return launch_nb<T, 2>(D, U, rhs, x, G, g, nb, N, p, stream);
    case 3: return launch_nb<T, 3>(D, U, rhs, x, G, g, nb, N, p, stream);
    case 4: return launch_nb<T, 4>(D, U, rhs, x, G, g, nb, N, p, stream);
    case 5: return launch_nb<T, 5>(D, U, rhs, x, G, g, nb, N, p, stream);
    case 6: return launch_nb<T, 6>(D, U, rhs, x, G, g, nb, N, p, stream);
    case 7: return launch_nb<T, 7>(D, U, rhs, x, G, g, nb, N, p, stream);
    default: return launch_nb<T, 8>(D, U, rhs, x, G, g, nb, N, p, stream);
  }
}

}  // namespace

extern "C" {

// How the kernel takes a system of N blocks of n x n: 0 staged whole with
// G and g in shared memory, 1 staged whole with G and g in the caller's
// global scratch (G as large as D, g as large as rhs), 2 streamed through
// the two-chunk ring with G and g in the scratch; -1 if it does not take
// the size.
int hqp_thomas_plan_f64(int N, int n) { return plan_code<double>(N, n); }
int hqp_thomas_plan_f32(int N, int n) { return plan_code<float>(N, n); }

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
