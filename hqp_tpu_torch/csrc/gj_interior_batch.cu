// Batched pivoted Gauss-Jordan inverse of interiors of size s <= 98 (K1,
// batched route; gj_interior.cu takes larger ones).
//
// Replaces, as gj_interior.cu does, the Pallas TPU kernel
// hqp_tpu/ops/gj_pallas.py::interior_factor (body _kernel).  For every
// matrix m of a flattened batch it returns
//     Minv_m = MII_m^-1,   W_m = Minv_m MIB_m,   Schur_m = MIB_m' W_m
// with the same pivot rule (the FIRST row, in the twin's logical order,
// with the largest |A[i, k]| over the unpivoted rows; NaN never wins) and
// the same rounding (a product, then a difference, never fused; an IEEE
// reciprocal), so its Minv equals the twin's (ops/gj_cuda.py) and the tile
// kernel's to the last bit.  W and Schur come from the write-out the tile
// kernel runs (gj_common.cuh): the same sums in the same order.
//
// What bounds it on an H100: latency.  A batch of hundreds of waves, such
// as the scenario batch's 49,152 interiors of s = 98 in f64, needs 2.35
// ms of bytes and about 5.5 ms of FP64 issue (a product and a difference
// an entry a step), but each of the s steps of a matrix is a chain of
// dependent operations (on an H100: ~9 cycles an FP64 operation, ~30 a
// shuffle or shared load, ~90 a reciprocal).  The tile kernel gives each
// matrix a 256-thread block and an SM of its own, so nothing fills the
// chain's waits.  A batch of one wave or less, such as DID-1000's 100
// interiors of s = 48, gains from the shorter chain alone.
//
// Design: two matrices resident on each SM, each in registers, so that one
// matrix's chain overlaps the other's elimination; and a shorter chain.
// - A tile fitted to s: warp w owns the columns 2w + h + 8 c (h, the half
//   of the warp; 4 warps), and lane rg of a half the rows rg + 16 r, so a
//   thread holds NR x NC entries: 6 x 13 at s = 98, rows 0-95 and columns
//   0-103.  The rows past the tile (96 and 97 at s = 98) stay where they
//   were staged, in shared memory, and lane rg updates row 16 NR + rg of
//   its columns there.  __launch_bounds__(128, 2): two blocks, two
//   matrices, on each SM, and 255 registers a thread, 156 of them the
//   entries, which leaves room for products in flight.  (With a seventh
//   row slot in registers, or over 7 warps, the products went one at a
//   time, or the step loop spilled.)
// - Column k+1 lies in one half-warp, so the next pivot is found there,
//   with no second barrier: by three reductions over the half's lanes
//   (redux.sync: the largest rank, an integer in the order of |value|,
//   by its two words, then the lowest logical row of that rank).  That
//   half eliminates its part of column k+1 first, then publishes the
//   pivot (row, 1/pivot, every lane taking the reciprocal) with the
//   column, then eliminates the rest: the chain of a step is one column
//   long.
// - Each warp holds the pivot row's entries of its own columns: they reach
//   the lanes that need them by a shuffle.  One barrier a step.
// - The k loop runs by the slot of column k+1, so it and column k's slot
//   are known at compile time: column k's entries start the step at -0.0
//   (-0 - cq/p equals -(cq/p) to the bit, signed zeros included), and
//   every entry takes one product and one difference, with no select
//   between two results.  The pivot row's entries are replaced by the
//   scaled row in a branch on its register slot, which is uniform over
//   the block.
// - Rows stay where they were loaded.  The logical positions (pos) and
//   their inverse (perm) live in shared memory: the searching half reads
//   its rows' positions, and the winning lane applies the interchange.
// - The matrix comes in by 16-byte cp.async copies and goes out through
//   shared memory by coalesced stores: 77 KB of staging at s = 98 in f64,
//   which two blocks an SM hold (the registers allow no third).
// Kernels launch on the caller's stream and allocate nothing.

#include <cuda_runtime.h>

#include <climits>
#include <type_traits>

#include "gj_common.cuh"
#include "staging.cuh"

namespace {

template <int I>
using ic = std::integral_constant<int, I>;

// f(ic<I>) for I = B .. E-1, unrolled at compile time
template <int B, int E, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (B < E) {
    f(ic<B>{});
    static_for<B + 1, E>(f);
  }
}

// f(ic<R>) for the R == r by a branch: r must be uniform over the warp,
// and R indexes registers.
template <int NR, typename F>
__device__ __forceinline__ void at_row(int r, F&& f) {
  static_assert(NR <= 8, "at_row: at most 8 row slots");
  switch (r) {
#define HQP_AT(R_) \
  case R_:         \
    if constexpr (R_ < NR) f(ic<R_>{}); \
    break;
    HQP_AT(0) HQP_AT(1) HQP_AT(2) HQP_AT(3)
    HQP_AT(4) HQP_AT(5) HQP_AT(6) HQP_AT(7)
#undef HQP_AT
  }
}

// the step's pivot: 1/pivot and its physical row
template <typename T>
struct Piv {
  T pinv;
  int pr;
};

struct BLayout {
  size_t a, B, col, piv, W, pos, perm, total;
};

// Shared memory of one matrix whose register tile covers rp - 16 rows
// (ops/gj_cuda.py::batch_smem is its copy).  Column k and the logical
// positions are padded to rp rows, so that a lane reads its rows without
// a bound check.
template <typename T>
__host__ __device__ BLayout blayout(int s, int b, int rp) {
  BLayout L;
  L.a = 0;
  L.B = L.a + hqp::stage_bytes<T>((size_t)s * s);
  L.col = L.B + hqp::stage_bytes<T>((size_t)s * b);
  L.piv = L.col + hqp::round16(2 * (size_t)rp * sizeof(T));
  L.W = L.piv + hqp::round16(2 * sizeof(Piv<T>));
  L.pos = L.W + hqp::round16((size_t)s * b * sizeof(T));
  L.perm = L.pos + hqp::round16((size_t)rp * sizeof(int));
  L.total = L.perm + hqp::round16((size_t)s * sizeof(int));
  return L;
}

// A pivot candidate's rank: 0 none, 1 NaN, 2 + |value|'s bits otherwise,
// an integer in the order of |value| (NaN never wins), so that the
// warp's integer reductions (redux.sync) find the largest.
__device__ __forceinline__ unsigned long long rank_of(double x, bool ok) {
  const unsigned long long a =
      (unsigned long long)__double_as_longlong(x) & 0x7fffffffffffffffULL;
  return ok ? (a > 0x7ff0000000000000ULL ? 1ULL : a + 2) : 0ULL;
}
__device__ __forceinline__ unsigned rank_of(float x, bool ok) {
  const unsigned a = (unsigned)__float_as_int(x) & 0x7fffffffu;
  return ok ? (a > 0x7f800000u ? 1u : a + 2) : 0u;
}

// The largest of N ranks over the lanes of `mask`: by halves for 64 bits.
template <int N>
__device__ __forceinline__ unsigned long long max_rank(
    unsigned mask, const unsigned long long (&rk)[N]) {
  unsigned h = 0, l = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) h = max(h, (unsigned)(rk[i] >> 32));
  h = __reduce_max_sync(mask, h);
#pragma unroll
  for (int i = 0; i < N; ++i)
    l = max(l, (unsigned)(rk[i] >> 32) == h ? (unsigned)rk[i] : 0u);
  return (unsigned long long)h << 32 | __reduce_max_sync(mask, l);
}
template <int N>
__device__ __forceinline__ unsigned max_rank(unsigned mask,
                                             const unsigned (&rk)[N]) {
  unsigned v = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) v = max(v, rk[i]);
  return __reduce_max_sync(mask, v);
}

// NR, NC: register rows and columns a thread owns; W: warps, a matrix a
// block
template <typename T, int NR, int NC, int W>
__global__ void __launch_bounds__(32 * W, 2)
gj_interior_kernel_batched(const T* __restrict__ MII,
                           const T* __restrict__ MIB, T* __restrict__ Minv,
                           T* __restrict__ Wout, T* __restrict__ Schur,
                           int s, int b) {
  constexpr int NT = 32 * W;        // threads
  constexpr int CL = 2 * W;         // column lanes
  constexpr int RP = 16 * NR + 16;  // rows of the tile and past it
  extern __shared__ __align__(16) unsigned char smem[];
  const BLayout L = blayout<T>(s, b, RP);
  const long m = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = lane & 15, cl = 2 * warp + (lane >> 4);
  // this lane's row past the register tile, if any, in shared memory
  const int qx = 16 * NR + rg;
  const bool hx = qx < s;

  T* a = hqp::stage(smem + L.a, MII + m * s * s, (size_t)s * s, tid,
                    NT);                           // [s, s] physical rows
  const T* Bs = hqp::stage(smem + L.B, MIB + m * s * b, (size_t)s * b, tid,
                           NT);                    // [s, b]
  hqp::cp_async_commit();
  T* colbuf = reinterpret_cast<T*>(smem + L.col);         // [2][RP] column k
  Piv<T>* piv = reinterpret_cast<Piv<T>*>(smem + L.piv);  // [2]
  T* Ws = reinterpret_cast<T*>(smem + L.W);               // [s, b]
  int* pos = reinterpret_cast<int*>(smem + L.pos);    // row -> logical
  int* perm = reinterpret_cast<int*>(smem + L.perm);  // logical -> row
  for (int q = tid; q < RP; q += NT) {
    pos[q] = q < s ? q : -1;   // a padding row is never a candidate
    if (q < s) perm[q] = q;
  }
  hqp::cp_async_wait<0>();
  __syncthreads();

  // this thread's entries, in registers for the whole elimination: rows
  // rg + 16 r, columns cl + CL c
  T x[NR][NC];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int q = rg + 16 * r;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int j = cl + CL * c;
      x[r][c] = q < s && j < s ? a[q * s + j] : T(0);
    }
  }
  T* const xrow = a + qx * s;   // the row past the tile (where hx)

  // Publish column j (slot CN of lanes cl == j % CL; xe, the entry of the
  // lane's row past the tile) for step j: the half-warp that holds the
  // column finds the first largest |entry| over the unpivoted rows
  // (logical position >= j) by three reductions over its lanes (the
  // largest rank, then the lowest logical row of that rank), and writes
  // the column, the pivot's reciprocal and row, and the logical positions
  // after step j's interchange.
  auto publish = [&](auto CN, int buf, int j, T xe) {
    constexpr int cn = decltype(CN)::value;
    if (cl != j % CL) return;
    const unsigned half = 0xffffu << (lane & 16);
    decltype(rank_of(T(0), true)) rk_[NR + 1];
    int p_[NR + 1];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      p_[r] = pos[rg + 16 * r];
      rk_[r] = rank_of(x[r][cn], p_[r] >= j);
    }
    p_[NR] = pos[qx];
    rk_[NR] = rank_of(xe, p_[NR] >= j);
    const auto best = max_rank(half, rk_);
    int pm = INT_MAX;
#pragma unroll
    for (int r = 0; r < NR + 1; ++r)
      pm = min(pm, rk_[r] == best ? p_[r] : INT_MAX);
    pm = __reduce_min_sync(half, pm);
    // the winner (logical positions are unique), its value and row
    T xw = xe;
    int qw = p_[NR] == pm ? qx : -1;
#pragma unroll
    for (int r = 0; r < NR; ++r)
      if (p_[r] == pm) {
        xw = x[r][cn];
        qw = rg + 16 * r;
      }
#pragma unroll
    for (int r = 0; r < NR; ++r) colbuf[buf * RP + rg + 16 * r] = x[r][cn];
    colbuf[buf * RP + qx] = xe;
    const T pinv = T(1) / xw;   // every lane: no branch around it
    if (qw >= 0) {
      piv[buf] = {pinv, qw};
      const int o = perm[j];
      pos[o] = pm;
      pos[qw] = j;
      perm[pm] = o;
      perm[j] = qw;
    }
  };

  {
    const int j = cl;   // column 0's slot is 0
    publish(ic<0>{}, 0, 0, hx && j < s ? xrow[j] : T(0));
  }
  __syncthreads();

  static_for<0, NC>([&](auto CN) {
    constexpr int cn = decltype(CN)::value;
    const int lo = cn == 0 ? 0 : cn * CL - 1;
    const int hi = cn + 1 == NC ? s : min(s, (cn + 1) * CL - 1);
    for (int k = lo; k < hi; ++k) {
      const int cur = k & 1;
      const Piv<T> pv = piv[cur];
      const T pinv = pv.pinv;
      const int pr = pv.pr, rq = pr >> 4, src = (pr & 15) | (lane & 16);
      const bool mine = rg == (pr & 15);   // this lane holds row pr
      // the pivot row's entries of this lane's columns, by a shuffle from
      // its lane in this half (from shared memory past the tile), scaled
      // by 1/pivot; column k's: 1/pivot
      T rk[NC];
      if (rq < NR) {
        at_row<NR>(rq, [&](auto R) {
#pragma unroll
          for (int c2 = 0; c2 < NC; ++c2)
            rk[c2] = __shfl_sync(kFull, x[decltype(R)::value][c2], src);
        });
      } else {
        // (past column s - 1 this reads the next row, or MIB, which only
        // columns past s take, and no one stores)
#pragma unroll
        for (int c2 = 0; c2 < NC; ++c2) rk[c2] = a[pr * s + cl + CL * c2];
        // the lane that holds row pr overwrites these entries later in the
        // step (start, past): every lane of its half reads them first
        __syncwarp();
      }
#pragma unroll
      for (int c2 = 0; c2 < NC; ++c2) rk[c2] = mul_rn(rk[c2], pinv);
      // column k: its entries start at -0.0, its scaled pivot is 1/pivot
      auto start = [&](auto C0) {
        constexpr int c0 = decltype(C0)::value;
        if (cl + CL * c0 == k) {
          rk[c0] = pinv;
#pragma unroll
          for (int r = 0; r < NR; ++r) x[r][c0] = T(-0.0);
          if (hx) xrow[k] = T(-0.0);
        }
      };
      if constexpr (cn > 0) {
        if (k < cn * CL)
          start(ic<cn - 1>{});
        else
          start(CN);
      } else {
        start(CN);
      }
      const T* colk = colbuf + cur * RP + rg;   // column k at this lane's rows
      const T cqx = colk[16 * NR];              // and at its row past the tile

      // the pivot row's entries: the scaled row, in slot CN (ONLY) or in
      // every slot but CN (a branch on its register slot, uniform over the
      // block)
      auto fix = [&](auto ONLY) {
        at_row<NR>(rq, [&](auto R) {
          if (mine)
            static_for<0, NC>([&](auto S) {
              constexpr int sl = decltype(S)::value;
              if constexpr ((sl == cn) == decltype(ONLY)::value)
                x[decltype(R)::value][sl] = rk[sl];
            });
        });
      };
      // the row past the tile, eliminated in place, in slot CN (ONLY) or in
      // every slot but CN: loads, then arithmetic, then stores, with no
      // branch between them (a load past column s - 1 reads the next row
      // or MIB, and is not stored); returns slot CN's entry
      auto past_of = [&](auto ONLY, auto LO, auto HI) {
        constexpr bool only = decltype(ONLY)::value;
        constexpr int lo = decltype(LO)::value, hi = decltype(HI)::value;
        T v[NC];
        static_for<lo, hi>([&](auto S) {
          constexpr int sl = decltype(S)::value;
          if constexpr ((sl == cn) == only)
            v[sl] = xrow[cl + CL * sl];
        });
        static_for<lo, hi>([&](auto S) {
          constexpr int sl = decltype(S)::value;
          if constexpr ((sl == cn) == only)
            v[sl] = qx == pr ? rk[sl] : sub_rn(v[sl], mul_rn(cqx, rk[sl]));
        });
        static_for<lo, hi>([&](auto S) {
          constexpr int sl = decltype(S)::value;
          if constexpr ((sl == cn) == only)
            if (cl + CL * sl < s) xrow[cl + CL * sl] = v[sl];
        });
        if constexpr (only) return v[cn]; else return T(0);
      };
      // (by half a row, to hold fewer registers)
      auto past = [&](auto ONLY) {
        if constexpr (decltype(ONLY)::value) {
          return past_of(ONLY, ic<cn>{}, ic<cn + 1>{});
        } else {
          past_of(ONLY, ic<0>{}, ic<NC / 2>{});
          return past_of(ONLY, ic<NC / 2>{}, ic<NC>{});
        }
      };

      // slot CN (column k+1) first: its entries, the pivot row's, the row
      // past the tile's
      static_for<0, NR>([&](auto R) {
        constexpr int r = decltype(R)::value;
        x[r][cn] = sub_rn(x[r][cn], mul_rn(colk[16 * r], rk[cn]));
      });
      fix(std::true_type{});
      T xe = T(0);
      if (hx) xe = past(std::true_type{});
      // then the next pivot
      if (k + 1 < s) publish(CN, cur ^ 1, k + 1, xe);
      // then the rest, by row and half a row, the products before their
      // differences: one product and one difference an entry
      static_for<0, 2 * NR>([&](auto RH) {
        constexpr int r = decltype(RH)::value / 2, c1 = NC / 2;
        constexpr int lo = decltype(RH)::value % 2 ? c1 : 0;
        constexpr int hi = decltype(RH)::value % 2 ? NC : c1;
        const T cq = colk[16 * r];
        T p[NC];
        static_for<lo, hi>([&](auto S) {
          constexpr int sl = decltype(S)::value;
          if constexpr (sl != cn) p[sl] = mul_rn(cq, rk[sl]);
        });
        static_for<lo, hi>([&](auto S) {
          constexpr int sl = decltype(S)::value;
          if constexpr (sl != cn) x[r][sl] = sub_rn(x[r][sl], p[sl]);
        });
      });
      fix(std::false_type{});
      if (hx) past(std::false_type{});
      __syncthreads();
    }
  });

  // the eliminated matrix by physical row (the rows past the tile are in
  // place), the maps, then Minv, W and Schur
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int q = rg + 16 * r;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int j = cl + CL * c;
      if (q < s && j < s) a[q * s + j] = x[r][c];
    }
  }
  __syncthreads();
  write_out<T, NT>(a, Bs, Ws, pos, perm, Minv + m * s * s,
                   Wout + m * s * b, Schur + m * b * b, s, b, warp, W, lane,
                   32, tid);
}

template <int NR_, int NC_, int W_>
struct Tile {
  static constexpr int NR = NR_, NC = NC_, W = W_;
};

// Calls f(Tile) for the tile that holds s, the smaller of two over 4
// warps (ops/gj_cuda.py::BATCH_TILES is their copy): 48 x 48, and 96 x
// 104 with up to 2 rows past it, 156 registers of f64 entries a thread;
// cudaErrorInvalidValue above s = 98.
template <typename F>
int by_tile(int s, F&& f) {
  if (s <= 48) return f(Tile<3, 6, 4>{});
  if (s <= 98) return f(Tile<6, 13, 4>{});
  return (int)cudaErrorInvalidValue;
}

// The kernel's dynamic shared memory raised to the opt-in limit and its
// carveout to the most shared memory, once.
template <typename T, typename TL>
cudaError_t prepare() {
  static bool done = false;
  if (done) return cudaSuccess;
  auto k = gj_interior_kernel_batched<T, TL::NR, TL::NC, TL::W>;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, hqp::smem_optin());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(k,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  done = err == cudaSuccess;
  return err;
}

template <typename T>
int launch(const T* MII, const T* MIB, T* Minv, T* W, T* Schur, int nb,
           int s, int b, cudaStream_t stream) {
  if (nb <= 0 || s <= 0) return (int)cudaSuccess;
  return by_tile(s, [&](auto tl) {
    using TL = decltype(tl);
    const size_t bytes = blayout<T>(s, b, 16 * TL::NR + 16).total;
    cudaError_t err = prepare<T, TL>();
    if (err != cudaSuccess) return (int)err;
    gj_interior_kernel_batched<T, TL::NR, TL::NC, TL::W>
        <<<nb, 32 * TL::W, bytes, stream>>>(MII, MIB, Minv, W, Schur, s, b);
    return (int)cudaGetLastError();
  });
}

// The kernel size s takes: blocks resident on one SM, registers and local
// (spilled) bytes a thread, threads a block, into out[0..3].
template <typename T>
int attrs(int s, int b, int* out) {
  return by_tile(s, [&](auto tl) {
    using TL = decltype(tl);
    const size_t bytes = blayout<T>(s, b, 16 * TL::NR + 16).total;
    auto k = gj_interior_kernel_batched<T, TL::NR, TL::NC, TL::W>;
    cudaError_t err = prepare<T, TL>();
    cudaFuncAttributes fa{};
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, k);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, k,
                                                          32 * TL::W, bytes);
    out[1] = fa.numRegs;
    out[2] = (int)fa.localSizeBytes;
    out[3] = 32 * TL::W;
    return (int)err;
  });
}

}  // namespace

extern "C" {

// Shared memory one matrix of size s with b boundary columns takes; 0
// above s = 98.
size_t hqp_gj_batch_smem_f64(int s, int b) {
  size_t n = 0;
  by_tile(s, [&](auto tl) {
    using TL = decltype(tl);
    n = blayout<double>(s, b, 16 * TL::NR + 16).total;
    return 0;
  });
  return n;
}
size_t hqp_gj_batch_smem_f32(int s, int b) {
  size_t n = 0;
  by_tile(s, [&](auto tl) {
    using TL = decltype(tl);
    n = blayout<float>(s, b, 16 * TL::NR + 16).total;
    return 0;
  });
  return n;
}

int hqp_gj_batch_f64(const double* MII, const double* MIB, double* Minv,
                     double* W, double* Schur, int nb, int s, int b,
                     void* stream) {
  return launch<double>(MII, MIB, Minv, W, Schur, nb, s, b,
                        (cudaStream_t)stream);
}

int hqp_gj_batch_f32(const float* MII, const float* MIB, float* Minv,
                     float* W, float* Schur, int nb, int s, int b,
                     void* stream) {
  return launch<float>(MII, MIB, Minv, W, Schur, nb, s, b,
                       (cudaStream_t)stream);
}

// Occupancy and resources of the kernel size s takes (see attrs).
int hqp_gj_batch_attrs_f64(int s, int b, int* out) {
  return attrs<double>(s, b, out);
}
int hqp_gj_batch_attrs_f32(int s, int b, int* out) {
  return attrs<float>(s, b, out);
}

}  // extern "C"
