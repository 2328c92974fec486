// Symmetric, class-walked covariance tiles shared by the covariance kernels,
// cov.cu (K7F/K7B, one tree's K(x1, x2), n, m <= 512) and megacov.cu (K4/K5,
// K(x_p, x_p), n <= 4096), and by K1's backward walk in megalml.cu (the
// VJP of K(x_p, x_p) under the LML's cotangent, n <= 512).  Each source
// includes this header and instantiates what it launches; its own C entry
// points check its envelope.  K1 takes the tiles, the class walk and the
// launch plan with its own cotangent and double partials (megalml.cu);
// K5/K7B's DkCotangent reads a dK buffer.
//
// What bounds them.  The forward writes P n m floats, the VJP reads as many;
// at the fits' shapes that is microseconds of memory time.  The walk is what
// costs: each element runs the tree's node bodies (heapwalk.cuh, the code
// K1/K2 run) with an exp/log/sinpi per leaf and a chain of type compares per
// slot, so both kernels are bound by issued instructions and by the
// occupancy that hides the special-function latency.  The design cuts the
// instructions and keeps the occupancy:
//
// * Symmetric path.  For K(x, x) of one buffer (the caller decides from the
//   operands, never from values) only the lower triangle is walked, in
//   32 x 32 tiles (bi >= bj; a diagonal tile enumerates its rows (rows +
//   1) / 2 lower elements only): the walk is symmetric in
//   (xi, xj) bit for bit (r and r^2 from |xi - xj|; LINEAR's and CP's
//   products commute).  The forward stores each off-diagonal tile directly
//   and its transpose through shared memory, so both stores coalesce.  The
//   VJP folds the cotangent, w_ij = dK_ij + dK_ji below the diagonal and
//   dK_ii on it, so an asymmetric dK stays right; both dK tiles are staged
//   in shared memory (K1 stages its folded cotangent's one tile).
// * General path: tiles of 32 rows by TC columns, TC = 32 or, for a
//   narrow m, the next power of two >= m, so K(x, xs) at m = 8 fills every
//   lane (one element a thread) and no element index is divided by m.
// * Heap classes.  A tree's class Nc in {1, 3, 7, 15, 31, 63} is the
//   smallest complete heap holding every live slot (heap_class); slots at
//   or past Nc are empty and get zero gradients.  A block walks only its
//   tree's first Nc slots and skips empty slots inside them with one
//   compare.  The class is uniform over the block, so nothing diverges.
//   The forward is one launch in which each block switches on its tree's
//   class.  The VJP's launches each take a range of classes, a block of
//   another class exiting before it loads anything.  On a large grid it is
//   one launch per class, so each class body runs at its own register
//   count instead of the largest class's (48 for classes 1 and 3, 119-123
//   for 15 and 31); on a small one, where a launch costs more than the
//   registers save, two class-switched launches (CLASS_LAUNCH_BLOCKS).
// * Registers.  With the element loop around it, the compiler hoists every
//   node field of the walk into registers (225 for a chunked K7F at N = 31,
//   one block an SM).  The nodes are re-read from shared memory for each
//   element instead (fresh_nodes).  The VJP keeps classes up to 15's 3 Nc
//   accumulators in registers, and classes 31 and 63's in shared memory, a
//   column per thread ([3 Nc][256] floats, 95 KB at Nc = 31), so a launch
//   takes classes from one side of 15 only.  VJP launches are held to 128
//   registers (two blocks of 256 threads an SM).
//
// Each VJP block reduces its accumulators in a fixed order to one partial
// per tile (zeros past its class), and reduce_partials_kernel sums a
// particle's tiles in tile order (K1: in double, its own reduction): no
// float atomics, so every VJP is deterministic, and its launch plan
// changes no bit.  x1 and x2 are each per-particle (row stride n or m) or
// shared by every particle (stride 0).
//
// Everything here is in the unnamed namespace, as reduce_partials_kernel
// is: each including source gets its own copy.

#pragma once

#include "heapwalk.cuh"

namespace {

using namespace heapwalk;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_LG = 5;  // 32 x 32 tiles (64 x 64: K5 a third slower)
constexpr int TILE = 1 << TILE_LG;
constexpr int REG_CLASS_MAX = 15;  // VJP: larger classes sum in shared memory
// VJP: one launch per heap class on a grid of at least this many blocks (P
// x tiles); below it one launch for classes up to REG_CLASS_MAX and one for
// the larger ones.  Per class, K7B lost 6-22 us a call up to 2,000 blocks
// and won 17-188 us from 4,200 (ablate_cov.py, PERF.md).
constexpr long CLASS_LAUNCH_BLOCKS = 4096;

// The node array at an offset the compiler cannot see is 0, so the walk's
// loads are issued for each element rather than hoisted out of the element
// loop into registers.
__device__ __forceinline__ const Node* fresh_nodes(const Node* nd) {
  int zero;
  asm volatile("mov.b32 %0, 0;" : "=r"(zero));
  return nd + zero;
}

// Column width of a general-path tile: TILE, or the next power of two >= m.
__host__ __device__ inline int col_log2(int m) {
  int lg = 0;
  while (lg < TILE_LG && (1 << lg) < m) ++lg;
  return lg;
}

int n_tiles(int n, int m, bool sym) {
  const int tr = (n + TILE - 1) / TILE;
  if (sym) return tr * (tr + 1) / 2;
  const int tc = 1 << col_log2(m);
  return tr * ((m + tc - 1) / tc);
}

// One block's tile and the enumeration of its elements q = 0 .. count.
struct Tile {
  int I, J;     // first row and column
  int rows;     // live rows (and, on a diagonal tile, columns)
  int cols;     // live columns
  int lgc;      // log2 of the column width
  int count;
  bool sym, diag;

  __device__ Tile(int t, int n, int m, bool symmetric) {
    sym = symmetric;
    int bi, bj;
    if (sym) {  // lower triangle, row-major over tiles bi >= bj
      bi = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
      while (bi * (bi + 1) / 2 > t) --bi;
      while ((bi + 1) * (bi + 2) / 2 <= t) ++bi;
      bj = t - bi * (bi + 1) / 2;
      lgc = TILE_LG;
    } else {
      lgc = col_log2(m);
      const int across = (m + (1 << lgc) - 1) >> lgc;
      bi = t / across;
      bj = t - bi * across;
    }
    I = bi * TILE;
    J = bj << (sym ? TILE_LG : lgc);
    rows = min(TILE, n - I);
    cols = min(1 << lgc, m - J);
    diag = sym && bi == bj;
    count = diag ? rows * (rows + 1) / 2 : rows << lgc;
  }

  // Element q's (r, c) within the tile; false past a ragged column edge.
  __device__ bool at(int q, int& r, int& c) const {
    if (diag) {  // packed lower triangle, c <= r
      r = static_cast<int>((sqrtf(8.0f * q + 1.0f) - 1.0f) * 0.5f);
      while (r * (r + 1) / 2 > q) --r;
      while ((r + 1) * (r + 2) / 2 <= q) ++r;
      c = q - r * (r + 1) / 2;
      return true;
    }
    r = q >> lgc;
    c = q & ((1 << lgc) - 1);
    return c < cols;
  }
};

// The tile's row points xr[r] = x1[I + r] and column points xc[c] =
// x2[J + c]; the caller synchronises.
__device__ __forceinline__ void load_points(const Tile& tl, const float* a,
                                            const float* b, float* xr,
                                            float* xc) {
  const int tid = threadIdx.x;
  if (tid < TILE) {
    xr[tid] = tid < tl.rows ? a[tl.I + tid] : 0.0f;
  } else if (tid < 2 * TILE) {
    const int c = tid - TILE;
    xc[c] = c < tl.cols ? b[tl.J + c] : 0.0f;
  }
}

// Particle p's heap class from its row of types in global memory, by
// heap_class's rule; uniform over the block.  A VJP block asks it before
// loading anything.
template <int N>
__device__ __forceinline__ int tree_class(const int* __restrict__ types,
                                          int p) {
  const int* row = types + static_cast<size_t>(p) * N;
  const int lane = threadIdx.x & 31;
  return class_of(__ballot_sync(0xffffffffu, lane < N && row[lane] != EMPTY),
                  __ballot_sync(0xffffffffu,
                                lane + 32 < N && row[lane + 32] != EMPTY));
}

// Forward body for heap class NC: walk the tile's elements, store them (and,
// on the symmetric path, their mirror images).
template <int NC>
__device__ __forceinline__ void fwd_tile(const Node* nd, const Tile& tl,
                                         const float* xr, const float* xc,
                                         float (*tr)[TILE + 1], float* Kp,
                                         int m) {
#pragma unroll 1
  for (int q = threadIdx.x; q < tl.count; q += THREADS) {
    int r, c;
    if (!tl.at(q, r, c)) continue;
    const float v = cov_elem<NC, true>(fresh_nodes(nd), xr[r], xc[c]);
    if (!tl.diag) Kp[static_cast<size_t>(tl.I + r) * m + tl.J + c] = v;
    if (tl.sym) {
      tr[r][c] = v;
      if (tl.diag) tr[c][r] = v;
    }
  }
  if (!tl.sym) return;
  __syncthreads();
  for (int q = threadIdx.x; q < TILE * TILE; q += THREADS) {
    const int r = q >> TILE_LG, c = q & (TILE - 1);
    if (c >= tl.rows) continue;
    if (tl.diag) {
      if (r < tl.rows)
        Kp[static_cast<size_t>(tl.I + r) * m + tl.I + c] = tr[r][c];
    } else {  // row J + r, column I + c holds element (I + c, J + r)
      Kp[static_cast<size_t>(tl.J + r) * m + tl.I + c] = tr[c][r];
    }
  }
}

// The forward: one tile of particle blockIdx.y.
template <int N>
__global__ void __launch_bounds__(THREADS, 4)
cov_fwd_kernel(int n, int m, int sym, const int* __restrict__ types,
               const float* __restrict__ params, const float* __restrict__ x1,
               int s1, const float* __restrict__ x2, int s2,
               float* __restrict__ K) {
  const int p = blockIdx.y;
  __shared__ Node nd[N];
  __shared__ float xr[TILE], xc[TILE];
  __shared__ float tr[TILE][TILE + 1];
  const Tile tl(blockIdx.x, n, m, sym != 0);
  load_nodes<N, THREADS>(nd, p, types, params);
  load_points(tl, x1 + static_cast<size_t>(p) * s1,
              x2 + static_cast<size_t>(p) * s2, xr, xc);
  __syncthreads();
  float* Kp = K + static_cast<size_t>(p) * n * m;
  switch (heap_class(nd, N)) {
    case 1: fwd_tile<1>(nd, tl, xr, xc, tr, Kp, m); break;
    case 3: fwd_tile<3>(nd, tl, xr, xc, tr, Kp, m); break;
    case 7: fwd_tile<7>(nd, tl, xr, xc, tr, Kp, m); break;
    case 15: if constexpr (N >= 15) fwd_tile<15>(nd, tl, xr, xc, tr, Kp, m); break;
    case 31: if constexpr (N >= 31) fwd_tile<31>(nd, tl, xr, xc, tr, Kp, m); break;
    case 63: if constexpr (N >= 63) fwd_tile<63>(nd, tl, xr, xc, tr, Kp, m); break;
  }
}

// VJP accumulators in shared memory: slot k, parameter q of this thread at
// p[(3 k + q) * THREADS], a column per thread (no bank conflicts).
struct ColumnAcc {
  float* p;
  struct Slot {
    float* p;
    __device__ float& operator[](int q) const { return p[q * THREADS]; }
  };
  __device__ Slot operator[](int k) const { return Slot{p + 3 * k * THREADS}; }
};

// The cotangent of K5/K7B, a general dK: read from global memory on the
// general path; on the symmetric path staged in shared memory (da[r][c] =
// dK[I + r][J + c], db[r][c] = dK[J + r][I + c]) and folded, w_ij = dK_ij
// + dK_ji below the diagonal and dK_ii on it, so an asymmetric dK stays
// right.
struct DkCotangent {
  const float (*da)[TILE + 1];
  const float (*db)[TILE + 1];
  const float* Dp;
  int m;

  __device__ float operator()(const Tile& tl, int r, int c) const {
    if (!tl.sym) return Dp[static_cast<size_t>(tl.I + r) * m + tl.J + c];
    if (tl.diag) return r == c ? da[r][c] : da[r][c] + da[c][r];
    return da[r][c] + db[c][r];
  }
};

// Every element of the tile swept into acc with its (folded) cotangent
// w = cot(tl, r, c).
template <int NC, class Cot, class Acc>
__device__ __forceinline__ void sweep_tile(const Node* nd, const Tile& tl,
                                           const float* xr, const float* xc,
                                           const Cot& cot, Acc& acc) {
#pragma unroll 1
  for (int q = threadIdx.x; q < tl.count; q += THREADS) {
    int r, c;
    if (!tl.at(q, r, c)) continue;
    const float w = cot(tl, r, c);
    walk_bwd<NC, true>(fresh_nodes(nd), xr[r], xc[c], w, acc);
  }
}

// VJP body for heap class NC: the tile's 3 NC sums written to out[0 ..
// 3 NC), in registers (SMEM false) or in shared memory s_acc.  Each thread
// sums its elements in float; the threads are summed in T, the partial's
// type.
template <int NC, bool SMEM, class Cot, class T>
__device__ __forceinline__ void bwd_tile(const Node* nd, const Tile& tl,
                                         const float* xr, const float* xc,
                                         const Cot& cot, float* s_acc,
                                         T* out) {
  if constexpr (SMEM) {
    const int tid = threadIdx.x;
    for (int q = 0; q < 3 * NC; ++q) s_acc[q * THREADS + tid] = 0.0f;
    ColumnAcc acc{s_acc + tid};
    sweep_tile<NC>(nd, tl, xr, xc, cot, acc);
    __syncthreads();
    // column sums in a fixed order: warp w takes q = w, w + WARPS, ...
    const int lane = tid & 31, warp = tid >> 5;
    for (int q = warp; q < 3 * NC; q += WARPS) {
      T s = 0;
#pragma unroll
      for (int i = 0; i < WARPS; ++i) s += s_acc[q * THREADS + 32 * i + lane];
      s = warp_sum(s);
      if (lane == 0) out[q] = s;
    }
  } else {
    __shared__ T s_red[WARPS][3 * NC];
    float acc[NC][3];
#pragma unroll
    for (int k = 0; k < NC; ++k) acc[k][0] = acc[k][1] = acc[k][2] = 0.0f;
    sweep_tile<NC>(nd, tl, xr, xc, cot, acc);
    block_partial<NC, WARPS>(acc, s_red, out);
  }
}

// Class NC's body where the launch takes classes LO ... HI.
template <int NC, int LO, int HI, class Cot, class T>
__device__ __forceinline__ void bwd_class(const Node* nd, const Tile& tl,
                                          const float* xr, const float* xc,
                                          const Cot& cot, float* s_acc,
                                          T* out) {
  if constexpr (LO <= NC && NC <= HI)
    bwd_tile<NC, (HI > REG_CLASS_MAX)>(nd, tl, xr, xc, cot, s_acc, out);
}

// A VJP block's tile partial, out[0 .. 3 cls), for its tree of heap class
// cls, where the launch takes classes LO ... HI: that class's body.  The
// kernel writes the zeros past the class.
template <int N, int LO, int HI, class Cot, class T>
__device__ __forceinline__ void bwd_classes(int cls, const Node* nd,
                                            const Tile& tl, const float* xr,
                                            const float* xc, const Cot& cot,
                                            float* s_acc, T* out) {
  switch (cls) {
    case 1: bwd_class<1, LO, HI>(nd, tl, xr, xc, cot, s_acc, out); break;
    case 3: bwd_class<3, LO, HI>(nd, tl, xr, xc, cot, s_acc, out); break;
    case 7: bwd_class<7, LO, HI>(nd, tl, xr, xc, cot, s_acc, out); break;
    case 15: bwd_class<15, LO, HI>(nd, tl, xr, xc, cot, s_acc, out); break;
    case 31: bwd_class<31, LO, HI>(nd, tl, xr, xc, cot, s_acc, out); break;
    case 63: bwd_class<63, LO, HI>(nd, tl, xr, xc, cot, s_acc, out); break;
  }
}

// The VJP, pass 1, for the trees of heap classes LO ... HI, all on one side
// of REG_CLASS_MAX: one tile of particle blockIdx.y, whose block exits
// first if its tree is of another class.  Writes the tile's 3N partial
// sums to partial[p][tile][:], zeros past the class.
template <int N, int LO, int HI>
__global__ void __launch_bounds__(THREADS, 2)
cov_bwd_kernel(int n, int m, int sym, const int* __restrict__ types,
               const float* __restrict__ params, const float* __restrict__ x1,
               int s1, const float* __restrict__ x2, int s2,
               const float* __restrict__ dK, float* __restrict__ partial) {
  static_assert((LO > REG_CLASS_MAX) == (HI > REG_CLASS_MAX),
                "a launch sums in registers or in shared memory");
  const int p = blockIdx.y, tid = threadIdx.x;
  const int cls = tree_class<N>(types, p);
  if (cls < LO || cls > HI) return;  // another launch's block
  extern __shared__ float s_acc[];  // HI > REG_CLASS_MAX: [3 HI][THREADS]
  __shared__ Node nd[N];
  __shared__ float xr[TILE], xc[TILE];
  __shared__ float da[TILE][TILE + 1];   // dK[I + r][J + c]
  __shared__ float db[TILE][TILE + 1];   // dK[J + r][I + c]
  const Tile tl(blockIdx.x, n, m, sym != 0);
  load_nodes<N, THREADS>(nd, p, types, params);
  load_points(tl, x1 + static_cast<size_t>(p) * s1,
              x2 + static_cast<size_t>(p) * s2, xr, xc);
  const float* Dp = dK + static_cast<size_t>(p) * n * m;
  if (tl.sym) {
    for (int q = tid; q < TILE * TILE; q += THREADS) {
      const int r = q >> TILE_LG, c = q & (TILE - 1);
      const bool in_a = r < tl.rows && tl.J + c < n;
      const bool in_b = !tl.diag && tl.J + r < n && c < tl.rows;
      da[r][c] = in_a ? Dp[static_cast<size_t>(tl.I + r) * n + tl.J + c] : 0.0f;
      db[r][c] = in_b ? Dp[static_cast<size_t>(tl.J + r) * n + tl.I + c] : 0.0f;
    }
  }
  __syncthreads();
  float* out = partial + (static_cast<size_t>(p) * gridDim.x + blockIdx.x) * 3 * N;
  bwd_classes<N, LO, HI>(cls, nd, tl, xr, xc, DkCotangent{da, db, Dp, m},
                         s_acc, out);
  for (int q = 3 * cls + tid; q < 3 * N; q += THREADS) out[q] = 0.0f;
}

// The operands of one forward or VJP call, as the C entry points take them.
struct CovArgs {
  int P, n, m, s1, s2, sym;
  const int* types;
  const float* params;
  const float* x1;
  const float* x2;
};

// The forward: one class-switched launch.
template <int N>
int launch_fwd(const CovArgs& a, float* K, cudaStream_t s) {
  cov_fwd_kernel<N><<<dim3(n_tiles(a.n, a.m, a.sym), a.P), THREADS, 0, s>>>(
      a.n, a.m, a.sym, a.types, a.params, a.x1, a.s1, a.x2, a.s2, K);
  return static_cast<int>(cudaGetLastError());
}

// One VJP pass-1 launch of kernel, a pass-1 kernel instantiated for
// classes up to HI, on grid.  Classes above REG_CLASS_MAX get their
// shared-memory columns, 3 HI THREADS floats; the attribute is set before
// every launch, since it is per device.
template <int HI, class... P, class... A>
int launch_pass(void (*kernel)(P...), dim3 grid, cudaStream_t s,
                A... args) {
  size_t smem = 0;
  if constexpr (HI > REG_CLASS_MAX) {
    smem = sizeof(float) * 3 * HI * THREADS;
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  kernel<<<grid, THREADS, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// One launch per heap class C, 2 C + 1, ... <= N.
template <int N, class Pass, int C = 1>
int launch_classes(const Pass& pass) {
  const int e = pass.template launch<C, C>();
  if (e != 0) return e;
  if constexpr (2 * C + 1 <= N)
    return launch_classes<N, Pass, 2 * C + 1>(pass);
  return 0;
}

// Pass 1 of a VJP (K5, K7B and K1's backward walk) by its grid's size,
// blocks = P x tiles: one launch per heap class from CLASS_LAUNCH_BLOCKS,
// else one class-switched launch for classes up to REG_CLASS_MAX and one
// for the larger ones.  pass.launch<LO, HI>() makes the launch for classes
// LO ... HI.  ops/megalml.py::vjp_launches mirrors the count.
template <int N, class Pass>
int launch_plan(long blocks, const Pass& pass) {
  constexpr int REG_HI = N < REG_CLASS_MAX ? N : REG_CLASS_MAX;
  if (blocks >= CLASS_LAUNCH_BLOCKS) return launch_classes<N>(pass);
  int e = pass.template launch<1, REG_HI>();
  if constexpr (N > REG_CLASS_MAX)
    if (e == 0) e = pass.template launch<2 * REG_CLASS_MAX + 1, N>();
  return e;
}

// K5/K7B's pass-1 launch for classes LO ... HI.
template <int N>
struct CovBwdPass {
  const CovArgs& a;
  const float* dK;
  float* partial;
  cudaStream_t s;

  template <int LO, int HI>
  int launch() const {
    return launch_pass<HI>(cov_bwd_kernel<N, LO, HI>,
                           dim3(n_tiles(a.n, a.m, a.sym), a.P), s, a.n, a.m,
                           a.sym, a.types, a.params, a.x1, a.s1, a.x2, a.s2,
                           dK, partial);
  }
};

// The VJP: pass 1 by the grid's size, then the tile partials summed in tile
// order.  partial holds n_tiles(n, m, sym) x 3 N floats per particle.
template <int N>
int launch_bwd(const CovArgs& a, const float* dK, float* dparams,
               float* partial, cudaStream_t s) {
  const int T = n_tiles(a.n, a.m, a.sym);
  const int e = launch_plan<N>(static_cast<long>(a.P) * T,
                               CovBwdPass<N>{a, dK, partial, s});
  if (e != 0) return e;
  const int total = a.P * 3 * N;
  reduce_partials_kernel<<<(total + 255) / 256, 256, 0, s>>>(a.P, T, 3 * N,
                                                             partial, dparams);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
