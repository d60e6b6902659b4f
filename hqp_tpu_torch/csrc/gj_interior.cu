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
// pivot sequence.  The elimination rounds as the twin does (a product,
// then a difference, never fused), so the two agree to the last bit
// before W and Schur.
//
// The route for 98 < s (gj_interior_batch.cu, two matrices an SM, takes
// s <= 98; ops/gj_cuda.py::route_rule): the crane's interiors, P = 100 of
// s = 124 (12.6 MB in f64 in and out, 3.8 us at 3.35 TB/s; 1.9 MFLOP
// each).  What bounds it on an H100: latency, not bytes or FLOPs: the
// work is one wave of 100 blocks on 132 SMs and the time is the s
// dependent elimination steps.  Tensor cores do not pay: one matrix is a
// couple of MFLOP, Hopper has no f64 wgmma, and mma.sync's f64 tiles
// would not shorten the chain of s steps.
//
// Design: one thread block per matrix; one barrier per step.
// - The matrix lives in registers during the elimination: thread (row
//   group rg, column lane cl) owns rows rg + 16 r and columns cl + 16 c
//   (N x N entries, N = 8, 12 or 16, the first >= ceil(s / 16), a
//   template parameter so that the loops unroll and need no division).  Shared memory carries only what
//   a step exchanges: the pivot row, column k, the pivot candidates.
// - No row swap.  Rows stay where they were loaded; each thread keeps the
//   logical positions of its rows, and the output is read out through
//   them: Minv[i][j] = a[perm[i]][pos[j]].
// - The next pivot is found during the current step: the owners of column
//   k+1 track the first max over their unpivoted rows, a shuffle combines
//   a warp's halves, and the warp publishes its candidate together with
//   the candidate's whole row (one half-warp holds it).  After the
//   barrier every thread reduces the 8 candidates by a tree and reads the
//   winner's row: no second barrier.
// - Every entry takes the same instructions: the pivot row and column k
//   are selects, not branches.
// - The tile and MIB are staged by 16-byte cp.async copies.  W is computed
//   from the inverse in shared memory into shared memory, and Schur from
//   there.
// Shared memory: s^2 + 2 s b + 18 s values and 2 s ints: 29 KB at s = 48,
// 147 KB at s = 124 (b = 4, f64).  Above 48 KB it is dynamic shared memory
// after cudaFuncSetAttribute; the wrapper refuses what does not fit.
// Kernels launch on the caller's stream and allocate nothing.

#include <cuda_runtime.h>

#include <climits>
#include <type_traits>

#include "gj_common.cuh"
#include "staging.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 16;                   // column lanes
constexpr int kRows = kThreads / kCols;     // row groups
constexpr int kWarps = kThreads / 32;

struct Layout {
  size_t a, B, col, row, W, cand, pos, perm, total;
};

// a warp's pivot candidate: |value| (NaN ranks -1), logical row, physical
// row, and the signed value
template <typename T>
struct Cand {
  T v;
  int p, q;
  T x;
};

template <typename T>
__host__ __device__ Layout layout(int s, int b) {
  Layout L;
  L.a = 0;
  L.B = L.a + hqp::stage_bytes<T>((size_t)s * s);
  L.col = L.B + hqp::stage_bytes<T>((size_t)s * b);
  L.row = L.col + hqp::round16(2 * (size_t)s * sizeof(T));
  L.W = L.row + hqp::round16(2 * kWarps * (size_t)s * sizeof(T));
  L.cand = L.W + hqp::round16((size_t)s * b * sizeof(T));
  L.pos = L.cand + hqp::round16(2 * kWarps * sizeof(Cand<T>));
  L.perm = L.pos + hqp::round16((size_t)s * sizeof(int));
  L.total = L.perm + hqp::round16((size_t)s * sizeof(int));
  return L;
}

// Keep o if it beats c: larger |value|, or the same at a lower logical
// row; true if it did.
template <typename T>
__device__ __forceinline__ bool better(const Cand<T>& o, Cand<T>& c) {
  const bool b = o.v > c.v || (o.v == c.v && o.p < c.p);
  if (b) c = o;
  return b;
}

// |x| as a pivot candidate; NaN ranks below every number
template <typename T>
__device__ __forceinline__ T rank(T x) {
  const T v = x < T(0) ? -x : x;
  return v >= T(0) ? v : T(-1);
}

template <typename T>
__device__ __forceinline__ Cand<T> shfl(const Cand<T>& c, int lane) {
  return {__shfl_sync(kFull, c.v, lane), __shfl_sync(kFull, c.p, lane),
          __shfl_sync(kFull, c.q, lane), __shfl_sync(kFull, c.x, lane)};
}

// N: rows and columns a thread owns, at least ceil(s / 16)
template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 1)
gj_interior_kernel(const T* __restrict__ MII, const T* __restrict__ MIB,
                   T* __restrict__ Minv, T* __restrict__ W,
                   T* __restrict__ Schur, int s, int b) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout<T>(s, b);
  const long m = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cl = tid % kCols, rg = tid / kCols;

  T* a = hqp::stage(smem + L.a, MII + m * s * s, (size_t)s * s, tid,
                    kThreads);                     // [s, s] physical rows
  const T* Bs = hqp::stage(smem + L.B, MIB + m * s * b, (size_t)s * b, tid,
                           kThreads);              // [s, b]
  hqp::cp_async_commit();
  T* colbuf = reinterpret_cast<T*>(smem + L.col);  // [2][s] column k
  T* rowbuf = reinterpret_cast<T*>(smem + L.row);  // [2][kWarps][s]
  T* Ws = reinterpret_cast<T*>(smem + L.W);        // [s, b]
  Cand<T>* cand = reinterpret_cast<Cand<T>*>(smem + L.cand);  // [2][kWarps]
  int* pos = reinterpret_cast<int*>(smem + L.pos);    // row -> logical
  int* perm = reinterpret_cast<int*>(smem + L.perm);  // logical -> row

  hqp::cp_async_wait<0>();
  __syncthreads();
  // this thread's entries, in registers for the whole elimination:
  // rows rg + kRows r, columns cl + kCols c; and the rows' logical
  // positions
  T x[N][N];
  int lp[N];
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const int q = rg + kRows * r;
    lp[r] = q;
#pragma unroll
    for (int c = 0; c < N; ++c) {
      const int j = cl + kCols * c;
      x[r][c] = q < s && j < s ? a[q * s + j] : T(0);
    }
  }

  // Publish column j (j / kCols = cj, uniform) for step j: its copy, and
  // the warp's best candidate with that candidate's whole row (one
  // half-warp holds it), so that the step after the barrier needs no
  // second one.  `pr` (the current pivot row) is no candidate.
  auto publish = [&](int buf, int j, int pr) {
    const int cj = j / kCols;
    Cand<T> best = {T(-2), INT_MAX, 0, T(0)};
    if (cl == j % kCols)
#pragma unroll
      for (int r = 0; r < N; ++r) {
        const int q = rg + kRows * r;
        T v = x[r][0];
#pragma unroll
        for (int c = 1; c < N; ++c) v = c == cj ? x[r][c] : v;
        if (q < s) {
          colbuf[buf * s + q] = v;
          if (q != pr && lp[r] >= j) better({rank(v), lp[r], q, v}, best);
        }
      }
    better(shfl(best, lane ^ 16), best);
    best = shfl(best, j % kCols);
    if (lane == j % kCols) cand[buf * kWarps + warp] = best;
    if (rg == best.q % kRows) {
      const int rq = best.q / kRows;
      T* out = rowbuf + (buf * kWarps + warp) * s;
#pragma unroll
      for (int c = 0; c < N; ++c) {
        const int jj = cl + kCols * c;
        T v = x[0][c];
#pragma unroll
        for (int r = 1; r < N; ++r) v = r == rq ? x[r][c] : v;
        if (jj < s) out[jj] = v;
      }
    }
  };

  publish(0, 0, -1);
  __syncthreads();

  for (int k = 0; k < s; ++k) {
    const int cur = k & 1, nxt = cur ^ 1;
    // the pivot: the best of the warps' candidates, by a tree
    Cand<T> cw[kWarps];
    int ww[kWarps];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      cw[w] = cand[cur * kWarps + w];
      ww[w] = w;
    }
#pragma unroll
    for (int h = kWarps / 2; h > 0; h /= 2)
#pragma unroll
      for (int w = 0; w < h; ++w)
        if (better(cw[w + h], cw[w])) ww[w] = ww[w + h];
    const int pp = cw[0].p, pr = cw[0].q;
    const T pinv = T(1) / cw[0].x;
    const T* prow = rowbuf + (cur * kWarps + ww[0]) * s;
    const T* colk = colbuf + cur * s;
    // row k scaled by 1/pivot (its column-k entry: 1/pivot), and column k
    // eliminated from every other row; no branch per entry
    T rk[N], cq[N];
#pragma unroll
    for (int c = 0; c < N; ++c) {
      const int j = cl + kCols * c;
      rk[c] = j == k ? pinv : mul_rn(prow[min(j, s - 1)], pinv);
    }
#pragma unroll
    for (int r = 0; r < N; ++r) cq[r] = colk[min(rg + kRows * r, s - 1)];
#pragma unroll
    for (int r = 0; r < N; ++r) {
      const int q = rg + kRows * r;
#pragma unroll
      for (int c = 0; c < N; ++c) {
        const int j = cl + kCols * c;
        const T v = j == k ? mul_rn(-cq[r], pinv)
                           : sub_rn(x[r][c], mul_rn(cq[r], rk[c]));
        x[r][c] = q == pr ? rk[c] : v;
      }
      // logical positions after the interchange of positions k and pp
      lp[r] = q == pr ? k : (lp[r] == k ? pp : lp[r]);
    }
    if (k + 1 < s) publish(nxt, k + 1, pr);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const int q = rg + kRows * r;
    if (q >= s) continue;
    if (cl == 0) {
      pos[q] = lp[r];
      perm[lp[r]] = q;
    }
#pragma unroll
    for (int c = 0; c < N; ++c) {
      const int j = cl + kCols * c;
      if (j < s) a[q * s + j] = x[r][c];
    }
  }
  __syncthreads();

  write_out<T, kThreads>(a, Bs, Ws, pos, perm, Minv + m * s * s,
                         W + m * s * b, Schur + m * b * b, s, b, rg, kRows,
                         cl, kCols, tid);
}

// Raise the kernel's dynamic shared memory to the opt-in limit, once,
// where the tile needs more than the default 48 KB.
template <typename T, int N>
cudaError_t raise_smem(size_t bytes) {
  static bool raised = false;
  if (bytes > 48 * 1024 && !raised) {
    cudaError_t err = cudaFuncSetAttribute(
        gj_interior_kernel<T, N>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, hqp::smem_optin());
    if (err != cudaSuccess) return err;
    raised = true;
  }
  return cudaSuccess;
}

template <typename T, int N>
int launch_n(const T* MII, const T* MIB, T* Minv, T* W, T* Schur, int nb,
             int s, int b, size_t bytes, cudaStream_t stream) {
  cudaError_t err = raise_smem<T, N>(bytes);
  if (err != cudaSuccess) return (int)err;
  gj_interior_kernel<T, N><<<nb, kThreads, bytes, stream>>>(
      MII, MIB, Minv, W, Schur, s, b);
  return (int)cudaGetLastError();
}

// Calls f(std::integral_constant<int, N>) for the N whose tile holds s;
// cudaErrorInvalidValue above s = 256, more than any tile holds.  The
// route takes s > 98 here, so the smallest tile is N = 8 (s <= 128); a
// smaller s, launched directly, runs in it padded.
template <typename F>
int by_tile(int s, F&& f) {
  const int n = (s + kCols - 1) / kCols;
#define HQP_GJ_N(N_) \
  if (n <= N_) return f(std::integral_constant<int, N_>{});
  HQP_GJ_N(8) HQP_GJ_N(12) HQP_GJ_N(16)
#undef HQP_GJ_N
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch(const T* MII, const T* MIB, T* Minv, T* W, T* Schur, int nb,
           int s, int b, cudaStream_t stream) {
  if (nb <= 0 || s <= 0) return (int)cudaSuccess;
  const size_t bytes = layout<T>(s, b).total;
  return by_tile(s, [&](auto N) {
    return launch_n<T, decltype(N)::value>(MII, MIB, Minv, W, Schur, nb, s,
                                           b, bytes, stream);
  });
}

// The kernel size s takes: blocks resident on one SM, registers and local
// (spilled) bytes a thread, threads a block, into out[0..3].
template <typename T>
int attrs(int s, int b, int* out) {
  const size_t bytes = layout<T>(s, b).total;
  return by_tile(s, [&](auto N) {
    constexpr int n = decltype(N)::value;
    cudaError_t err = raise_smem<T, n>(bytes);
    cudaFuncAttributes fa{};
    if (err == cudaSuccess)
      err = cudaFuncGetAttributes(&fa, gj_interior_kernel<T, n>);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          out, gj_interior_kernel<T, n>, kThreads, bytes);
    out[1] = fa.numRegs;
    out[2] = (int)fa.localSizeBytes;
    out[3] = kThreads;
    return (int)err;
  });
}

}  // namespace

extern "C" {

// Shared memory one matrix of size s with b boundary columns needs (the
// wrapper checks it against the device limit before launching).
size_t hqp_gj_interior_smem_f64(int s, int b) {
  return layout<double>(s, b).total;
}
size_t hqp_gj_interior_smem_f32(int s, int b) {
  return layout<float>(s, b).total;
}

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

// Occupancy and resources of the kernel size s takes (see attrs).
int hqp_gj_interior_attrs_f64(int s, int b, int* out) {
  return attrs<double>(s, b, out);
}
int hqp_gj_interior_attrs_f32(int s, int b, int* out) {
  return attrs<float>(s, b, out);
}

}  // extern "C"
