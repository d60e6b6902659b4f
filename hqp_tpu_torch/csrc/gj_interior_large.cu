// Batched pivoted Gauss-Jordan inverse of partition interiors too large for
// one block's shared memory (K1, large route): a thread-block-cluster
// kernel that spreads each matrix over C SMs and exchanges the pivot
// through distributed shared memory.
//
// Replaces the Pallas TPU kernel hqp_tpu/ops/gj_pallas.py::interior_factor
// (body _kernel) for the interiors gj_interior.cu cannot stage: its tile of
// s^2 + 2 s b + 18 s values passes the 227 KB a block may use above s = 151
// in f64 (b = 10), and the TPU kernel takes any s <= 512.  It computes what
// that kernel and the twin (ops/gj_cuda.py::interior_factor_plain) compute,
// for every matrix m of a flattened batch:
//     Minv_m  = MII_m^-1,   W_m = Minv_m MIB_m,   Schur_m = MIB_m' W_m
// with the same pivot rule (the FIRST row i >= k, in the twin's logical
// order, with the largest |A[i, k]|; NaN never wins) and the twin's order
// of operations: the elimination rounds a product, then a difference,
// never fused, with an IEEE reciprocal, so the inverse equals the twin's
// to the last bit.
//
// What bounds it on an H100: the chain of s dependent elimination steps.
// The bytes (1 MB in and out at s = 245, f64) take 0.3 us at 3.35 TB/s and
// the 30.7 MFLOP 0.46 us at 67 TFLOP/s; what is left is each step's
// latency: one exchange of the pivot among the C SMs that share the
// matrix, which no one SM can hold (0.48 MB at s = 245, 2 MB at s = 512).
//
// Design: one cluster of C blocks (C = 4, 8 or 16, chosen by the wrapper's
// rule ops/gj_cuda.py::cluster_size) per matrix; grid.x = P C.
// - Block r holds rows [r R, r R + R) (R = ceil(s / C)) in REGISTERS:
//   warp w owns rows w + 16 i, lane l columns l + 32 c.  The matrix is read
//   from device memory once and written once; column k of a row reaches
//   the row's lanes by a shuffle.  (A band in shared memory cost R s 16
//   bytes of shared-memory traffic a step.)
// - Rows stay where they were loaded.  Each warp keeps the logical
//   positions of its rows, and every block the logical -> row map of all
//   rows (it learns every pivot); Minv[lp(q)][perm[j]] = a[q][j].
// - The next pivot is found during the current step: the lane that owns
//   column k+1 in each warp tracks the warp's first-max candidate among
//   its unpivoted rows; after a block barrier warp 0 reduces the warps'
//   candidates by shuffles, and after another the warp that holds the
//   block's candidate writes its header and whole row to a staging buffer
//   and pushes it by cp.async.bulk into a slot of its own in EVERY block
//   of the cluster, completing on that block's mbarrier.
// - So a step has no cluster barrier and no remote read: a block waits on
//   its own mbarrier for the C headers and rows of step k, warp 0 picks
//   the winner by the twin's rule on the LOGICAL row index, and a block
//   barrier shares it; the pivot row is read from the block's own shared
//   memory.  Slots, staging buffers and mbarriers are double-buffered by
//   k's parity; a buffer of step k is written again only for step k+2,
//   which no block can reach before every block has consumed step k (each
//   waits for every block's step-(k+1) push, made after its step-k
//   reads).  A wait that outlasts any real step traps instead of hanging.
//   (cluster.sync, the simpler exchange, compiles to a GPU-scope fence and
//   an L1 invalidate besides the barrier.)
// - W and Schur at the end: each warp forms W for its rows, and the b x b
//   Schur partials are summed across the cluster in rank order through
//   DSMEM.  A last cluster barrier keeps every block's shared memory alive
//   until its peers' remote reads are done.
// Launched by cudaLaunchKernelEx with a cluster dimension; C = 16 is a
// non-portable size (cudaFuncAttributeNonPortableClusterSizeAllowed).  If
// the occupancy query finds no cluster of that size that fits, the launch
// is refused (kNoCluster).  Kernels launch on the caller's stream and
// allocate nothing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>

#include "staging.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;   // a warp per row group
constexpr int kMaxS = 512;              // the TPU kernel's own limit
constexpr int kRegBytes = 256;          // band bytes a thread may hold
constexpr int kNoCluster = -2;          // occupancy: no cluster fits
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

// a pivot candidate: |value| (NaN ranks -1, none -2), logical row,
// physical row; 16 bytes, the header of a pushed row
template <typename T>
struct __align__(16) Cand {
  T v;
  int p, q;
};

template <typename T>
__device__ __forceinline__ Cand<T> no_cand() {
  return {T(-2), INT_MAX, 0};
}

// Keep o if it beats c: larger |value|, or the same at a lower logical row.
template <typename T>
__device__ __forceinline__ void better(const Cand<T>& o, Cand<T>& c) {
  if (o.v > c.v || (o.v == c.v && o.p < c.p)) c = o;
}

// |x| as a pivot candidate; NaN ranks below every number
template <typename T>
__device__ __forceinline__ T rank(T x) {
  const T v = x < T(0) ? -x : x;
  return v >= T(0) ? v : T(-1);
}

// the best candidate of lanes 0-15, in lane 0 (the order is total, so
// any tree gives the same winner)
template <typename T>
__device__ __forceinline__ Cand<T> best16(Cand<T> c) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    better(Cand<T>{__shfl_xor_sync(kFull, c.v, o),
                   __shfl_xor_sync(kFull, c.p, o),
                   __shfl_xor_sync(kFull, c.q, o)},
           c);
  return c;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// -- mbarriers and the bulk push (PTX, sm_90) ---------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// the address of the same shared variable in block `rank` of the cluster
__device__ __forceinline__ unsigned peer_addr(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void bar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
}
// this block's one arrival of a phase, expecting `bytes` of pushes
__device__ __forceinline__ void bar_arm(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  for (long n = 0;; ++n) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (n > (1L << 22)) __trap();   // a lost push: fail, never hang
  }
}
// copy `bytes` from this block's shared memory to shared::cluster address
// dst, completing on the mbarrier at shared::cluster address bar
__device__ __forceinline__ void push(unsigned dst, unsigned src,
                                     unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst), "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// columns a lane owns and rows a warp owns for (s, C); 0 rows: refused
__host__ __device__ inline int cols_of(int s) { return s <= 256 ? 8 : 16; }
__host__ __device__ inline int rows_of(int s, int C) {
  const int n = ((s + C - 1) / C + kWarps - 1) / kWarps;
  return n <= 1 ? 1 : n <= 2 ? 2 : n <= 4 ? 4 : 0;
}

// the step's pivot, shared by warp 0: physical and logical row, 1/pivot
template <typename T>
struct __align__(16) Win {
  int pr, pp;
  T pinv;
};

struct Layout {
  size_t B, slot, stage, bar, wcand, win, perm, lp, W, part, entry, total;
};

// One block's shared memory; ops/gj_cuda.py::large_smem mirrors it (the
// cluster-size rule), and chip_smoke.py holds the two against each other.
template <typename T>
__host__ __device__ Layout layout(int s, int b, int C) {
  const size_t R = (s + C - 1) / C;
  Layout L;
  L.entry = hqp::round16(sizeof(Cand<T>) + (size_t)s * sizeof(T));
  L.B = 0;                                                  // [s, b] MIB
  L.slot = L.B + hqp::stage_bytes<T>((size_t)s * b);        // [2][C] entry
  L.stage = L.slot + 2 * C * L.entry;                       // [2] entry
  L.bar = L.stage + 2 * L.entry;                            // [2] mbarrier
  L.wcand = L.bar + 16;                             // [kWarps] + block's
  L.win = L.wcand + (kWarps + 1) * sizeof(Cand<T>);         // the pivot
  L.perm = L.win + sizeof(Win<T>);                          // [s]
  L.lp = L.perm + hqp::round16((size_t)s * sizeof(int));    // [R]
  L.W = L.lp + hqp::round16(R * sizeof(int));               // [R, b]
  L.part = L.W + hqp::round16(R * b * sizeof(T));           // [b, b]
  L.total = L.part + hqp::round16((size_t)b * b * sizeof(T));
  return L;
}

// NR rows a warp owns, NC columns a lane owns (rows_of, cols_of)
template <typename T, int NR, int NC>
__global__ void __launch_bounds__(kThreads, 1)
gj_cluster_kernel(const T* __restrict__ MII, const T* __restrict__ MIB,
                  T* __restrict__ Minv, T* __restrict__ W,
                  T* __restrict__ Schur, int s, int b) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int me = (int)cluster.block_rank();
  const long m = blockIdx.x / C;
  const Layout L = layout<T>(s, b, C);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = (s + C - 1) / C, row0 = me * R;
  const int nr = max(0, min(R, s - row0));   // rows of this band
  const unsigned E = (unsigned)L.entry;

  const T* Bs = hqp::stage(smem + L.B, MIB + m * s * b, (size_t)s * b, tid,
                           kThreads);              // [s, b]
  hqp::cp_async_commit();
  unsigned char* slot = smem + L.slot;    // [2][C] pushed header + row
  unsigned char* stage = smem + L.stage;  // [2] this block's outgoing push
  const unsigned bar0 = smem_addr(smem + L.bar);
  Cand<T>* wcand = reinterpret_cast<Cand<T>*>(smem + L.wcand);
  Cand<T>* bcand = wcand + kWarps;                     // the block's
  Win<T>* win = reinterpret_cast<Win<T>*>(smem + L.win);
  int* perm = reinterpret_cast<int*>(smem + L.perm);  // logical -> row
  auto row_of = [&](unsigned char* e) {
    return reinterpret_cast<T*>(e + sizeof(Cand<T>));
  };

  // this thread's entries: rows row0 + warp + 16 r, columns lane + 32 c,
  // and the rows' logical positions
  T x[NR][NC];
  int lp[NR];
  const T* A0 = MII + m * s * s;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int ql = warp + kWarps * r;
    lp[r] = row0 + ql;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int j = lane + 32 * c;
      x[r][c] = ql < nr && j < s ? A0[(long)(row0 + ql) * s + j] : T(0);
    }
  }
  for (int i = tid; i < s; i += kThreads) perm[i] = i;
  if (tid == 0) {
    bar_init(bar0);
    bar_init(bar0 + 8);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    bar_arm(bar0, C * E);
    bar_arm(bar0 + 8, C * E);
  }
  hqp::cp_async_wait<0>();
  cluster.sync();   // barriers armed, every block of the cluster running

  // The lane that owns column j: its warp's candidate for pivot j into
  // wcand (logical positions already updated).
  auto warp_cand = [&](int j) {
    if (lane != (j & 31)) return;
    Cand<T> best = no_cand<T>();
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      T v = x[r][0];
#pragma unroll
      for (int c = 1; c < NC; ++c) v = c == (j >> 5) ? x[r][c] : v;
      if (warp + kWarps * r < nr && lp[r] >= j)
        better({rank(v), lp[r], row0 + warp + kWarps * r}, best);
    }
    wcand[warp] = best;
  };
  // After a block barrier, warp 0: the block's candidate into bcand.
  auto block_cand = [&]() {
    if (warp != 0) return;
    const Cand<T> c = best16(lane < kWarps ? wcand[lane] : no_cand<T>());
    if (lane == 0) *bcand = c;
  };
  // After another: the warp that holds the block's candidate (warp 0 if
  // there is none) pushes header and row into slot `me` of every block's
  // parity-buf slots.
  auto publish = [&](int buf) {
    const Cand<T> c = *bcand;
    const bool some = c.p != INT_MAX;
    if (warp != (some ? (c.q - row0) % kWarps : 0)) return;
    unsigned char* e = stage + buf * E;
    if (some) {
      const int rq = (c.q - row0) / kWarps;
      T* row = row_of(e);
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        T v = x[0][cc];
#pragma unroll
        for (int r = 1; r < NR; ++r) v = r == rq ? x[r][cc] : v;
        if (lane + 32 * cc < s) row[lane + 32 * cc] = v;
      }
    }
    if (lane == 0) *reinterpret_cast<Cand<T>*>(e) = c;
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane < C)
      push(peer_addr(smem_addr(slot + (buf * C + me) * E), lane),
           smem_addr(e), E, peer_addr(bar0 + 8 * buf, lane));
  };

  warp_cand(0);
  __syncthreads();
  block_cand();
  __syncthreads();
  publish(0);

  for (int k = 0; k < s; ++k) {
    const int cur = k & 1;
    bar_wait(bar0 + 8 * cur, (k >> 1) & 1);
    if (tid == 0 && k + 2 < s) bar_arm(bar0 + 8 * cur, C * E);
    // the pivot: the best of the C blocks' candidates, by warp 0
    const unsigned char* sl = slot + cur * C * E;
    if (warp == 0) {
      const Cand<T> w = best16(
          lane < C ? *reinterpret_cast<const Cand<T>*>(sl + lane * E)
                   : no_cand<T>());
      if (lane == 0)
        *win = {w.q, w.p, T(1) / reinterpret_cast<const T*>(
                                     sl + (w.q / R) * E + sizeof(Cand<T>))[k]};
    }
    __syncthreads();
    const int pr = win->pr, pp = win->pp;
    const T pinv = win->pinv;
    const T* prow = reinterpret_cast<const T*>(sl + (pr / R) * E +
                                               sizeof(Cand<T>));
    // column k of this warp's rows, from the lane that owns it
    T ci[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      T v = x[r][0];
#pragma unroll
      for (int c = 1; c < NC; ++c) v = c == (k >> 5) ? x[r][c] : v;
      ci[r] = __shfl_sync(kFull, v, k & 31);
    }
    // the pivot row scaled by 1/pivot (its column-k entry: 1/pivot), and
    // column k eliminated from every other row (its column-k entry:
    // -a[q][k] / pivot)
    const bool lk = lane == (k & 31);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const bool kc = lk && c == (k >> 5);
      const T rk = kc ? pinv : mul_rn(prow[min(lane + 32 * c, s - 1)], pinv);
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        T v = sub_rn(x[r][c], mul_rn(ci[r], rk));
        if (kc) v = mul_rn(-ci[r], pinv);
        x[r][c] = row0 + warp + kWarps * r == pr ? rk : v;
      }
    }
#pragma unroll
    for (int r = 0; r < NR; ++r)
      lp[r] = row0 + warp + kWarps * r == pr ? k : (lp[r] == k ? pp : lp[r]);
    if (tid == 0) {   // the interchange of logical positions k and pp
      const int qk = perm[k];
      perm[k] = pr;
      perm[pp] = qk;
    }
    if (k + 1 < s) {
      warp_cand(k + 1);
      __syncthreads();
      block_cand();
      __syncthreads();
      publish(cur ^ 1);
    }
  }
  __syncthreads();   // perm

  // Minv[lp][perm[j]] = a[q][j];  W = Minv MIB for the band's rows
  T* Mo = Minv + m * s * s;
  T* Wo = W + m * s * b;
  T* Wb = reinterpret_cast<T*>(smem + L.W);     // [R, b]
  int* lpb = reinterpret_cast<int*>(smem + L.lp);
  int pj[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) pj[c] = perm[min(lane + 32 * c, s - 1)];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int ql = warp + kWarps * r;
    if (ql >= nr) continue;
    T* out = Mo + (long)lp[r] * s;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (lane + 32 * c < s) out[pj[c]] = x[r][c];
    for (int bc = 0; bc < b; ++bc) {
      T acc = T(0);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if (lane + 32 * c < s) acc += x[r][c] * Bs[pj[c] * b + bc];
      acc = warp_sum(acc);
      if (lane == 0) {
        Wb[ql * b + bc] = acc;
        Wo[(long)lp[r] * b + bc] = acc;
      }
    }
    if (lane == 0) lpb[ql] = lp[r];
  }
  __syncthreads();
  // the band's part of Schur = MIB' W, then the partials in rank order
  T* part = reinterpret_cast<T*>(smem + L.part);  // [b, b]
  for (int e = tid; e < b * b; e += kThreads) {
    const int c1 = e / b, c2 = e - c1 * b;
    T acc = T(0);
    for (int ql = 0; ql < nr; ++ql) acc += Bs[lpb[ql] * b + c1] * Wb[ql * b + c2];
    part[e] = acc;
  }
  cluster.sync();
  if (me == 0) {
    T* So = Schur + m * b * b;
    for (int e = tid; e < b * b; e += kThreads) {
      T acc = T(0);
      for (int r = 0; r < C; ++r) acc += cluster.map_shared_rank(part, r)[e];
      So[e] = acc;
    }
  }
  cluster.sync();   // the peers' shared memory outlives rank 0's reads
}

template <typename T, int NR, int NC>
int launch_k(const T* MII, const T* MIB, T* Minv, T* W, T* Schur, int nb,
             int s, int b, int C, size_t bytes, cudaStream_t stream) {
  auto kernel = gj_cluster_kernel<T, NR, NC>;
  static bool raised = false;
  if (!raised) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        hqp::smem_optin());
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    raised = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the occupancy of this (C, bytes), asked again only when they change
  static int last_c = 0, clusters = 0;
  static size_t last_bytes = 0;
  if (C != last_c || bytes != last_bytes) {
    cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    last_c = C;
    last_bytes = bytes;
  }
  if (clusters == 0) return kNoCluster;
  cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, MII, MIB, Minv, W, Schur, s, b);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* MII, const T* MIB, T* Minv, T* W, T* Schur, int nb,
           int s, int b, int C, cudaStream_t stream) {
  if (nb <= 0 || s <= 0) return (int)cudaSuccess;
  const int nr = rows_of(s, C), nc = cols_of(s);
  if (s > kMaxS || (C != 4 && C != 8 && C != 16) || nr == 0 ||
      nr * nc * (int)sizeof(T) > kRegBytes)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = layout<T>(s, b, C).total;
  if (bytes > (size_t)hqp::smem_optin()) return (int)cudaErrorInvalidValue;
#define HQP_GJ_K(NR_, NC_)                                                   \
  if (nr == NR_ && nc == NC_)                                                \
    return launch_k<T, NR_, NC_>(MII, MIB, Minv, W, Schur, nb, s, b, C,      \
                                 bytes, stream);
  HQP_GJ_K(1, 8) HQP_GJ_K(2, 8) HQP_GJ_K(4, 8) HQP_GJ_K(1, 16)
  HQP_GJ_K(2, 16)
  if constexpr (sizeof(T) == 4) { HQP_GJ_K(4, 16) }
#undef HQP_GJ_K
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shared memory one block of a cluster of C needs for an interior of size
// s with b boundary columns (chip_smoke.py holds the wrapper's copy of
// this layout against it).
size_t hqp_gj_large_smem_f64(int s, int b, int C) {
  return layout<double>(s, b, C).total;
}
size_t hqp_gj_large_smem_f32(int s, int b, int C) {
  return layout<float>(s, b, C).total;
}

// C, the cluster size, is 4, 8 or 16 (the wrapper's rule picks it).
// Refused with cudaErrorInvalidValue: s > 512 (the wrapper routes it to
// torch.linalg.inv first), another C, a band that does not fit a block's
// registers or shared memory; with -2: no cluster of C blocks fits on
// the device.
int hqp_gj_large_f64(const double* MII, const double* MIB, double* Minv,
                     double* W, double* Schur, int nb, int s, int b, int C,
                     void* stream) {
  return launch<double>(MII, MIB, Minv, W, Schur, nb, s, b, C,
                        (cudaStream_t)stream);
}

int hqp_gj_large_f32(const float* MII, const float* MIB, float* Minv,
                     float* W, float* Schur, int nb, int s, int b, int C,
                     void* stream) {
  return launch<float>(MII, MIB, Minv, W, Schur, nb, s, b, C,
                       (cudaStream_t)stream);
}

}  // extern "C"
