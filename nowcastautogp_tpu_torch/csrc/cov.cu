// One heap tree's covariance K(x1, x2) per particle and its VJP, for Hopper
// (sm_90a): the covariance kernels of the "pallas" covariance backend.
//
//   K7F  cov_fwd_kernel  K_p(x1_p, x2_p) -> (P, n, m), 1 <= n, m <= 512
//        replaces nowcastautogp_tpu/ops/pallas_cov.py::_cov_fwd_kernel
//   K7B  cov_bwd_kernel  a general cotangent dK (P, n, m) -> dparams
//        replaces nowcastautogp_tpu/ops/pallas_cov.py::_cov_bwd_kernel
//
// They carry every covariance of that backend: the fit's K(x, x), and the
// predictive's K(x, xs) and K(xs, xs), whose horizon m = 8 is smaller than
// any square tile.
//
// What bounds them.  K7F writes P n m floats, K7B reads as many; at the
// fit's shapes that is a few microseconds of memory time.  The walk is what
// costs: each element runs the tree's node bodies (heapwalk.cuh, the code
// K1/K2/K4/K5 run) with an exp/log/sinpi per leaf and a chain of type
// compares per slot, so both kernels are bound by issued instructions and
// by the occupancy that hides the special-function latency.  The design
// cuts the instructions and keeps the occupancy:
//
// * Symmetric path.  Most calls are K(x, x) of one buffer (the wrapper
//   decides from the operands, never from values), and the walk is
//   symmetric in (xi, xj) bit for bit (r and r^2 from |xi - xj|; LINEAR's
//   and CP's products commute).  So only the lower triangle is walked, in
//   32 x 32 tiles (bi >= bj; a diagonal tile enumerates its rows (rows + 1)
//   / 2 lower elements only).  K7F stores each off-diagonal tile directly
//   and its transpose through shared memory, so both stores coalesce (K4's
//   pattern).  K7B folds the cotangent, w_ij = dK_ij + dK_ji below the
//   diagonal and dK_ii on it (K5's fold), so an asymmetric dK stays right;
//   both dK tiles are staged in shared memory.  At n = 160 that is 12,880
//   walks instead of 25,600.
// * General path: 2-D tiles of 32 rows by TC columns, TC = 32 or, for a
//   narrow m, the next power of two >= m, so K(x, xs) at m = 8 fills every
//   lane (one element a thread) and no element index is divided by m.
// * Heap classes.  Each block finds its tree's class Nc in {1, 3, 7, 15,
//   31, 63}, the smallest complete heap holding every live slot, and walks
//   only the first Nc slots (heap_class); slots at or past Nc are empty and
//   get zero gradients.  The class is uniform over the block, so nothing
//   diverges.  The walks skip empty slots inside the class with one compare.
// * Registers.  With the element loop around it, the compiler hoists
//   every node field of the walk into registers (the chunked kernel this
//   replaces: 225 for K7F at N = 31, one block an SM).  The nodes are
//   re-read from shared memory for each element instead (fresh_nodes), so
//   K7F fits 64 registers (four blocks an SM).  K7B is two launches from
//   one C call: classes up to 15 keep their 3 Nc accumulators in
//   registers; classes 31 and 63 keep them in shared memory, a column per
//   thread ([3N][256] floats, 95 KB at N = 31), which frees the 93
//   registers the sweep's accumulators took.  Blocks of the other launch's
//   classes exit at once.  Both launches are held to 128 registers (two
//   blocks of 256 threads an SM).
//
// Each K7B block reduces its accumulators in a fixed order to one partial
// per tile (zeros past its class), and a second kernel sums a particle's
// tiles in tile order: no float atomics, so both kernels are deterministic.
// x1 and x2 are each per-particle (row stride n or m) or shared by every
// particle (stride 0).

#include "heapwalk.cuh"

namespace {

using namespace heapwalk;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 32;
constexpr int MAX_N = 512;
constexpr int REG_CLASS_MAX = 15;  // K7B: larger classes sum in shared memory

// The node array at an offset the compiler cannot see is 0, so the walk's
// loads are issued for each element rather than hoisted out of the element
// loop into registers.
__device__ __forceinline__ const Node* fresh_nodes(const Node* nd) {
  int zero;
  asm volatile("mov.b32 %0, 0;" : "=r"(zero));
  return nd + zero;
}

// Column width of a general-path tile: 32, or the next power of two >= m.
__host__ __device__ inline int col_log2(int m) {
  int lg = 0;
  while (lg < 5 && (1 << lg) < m) ++lg;
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
  int lgc;      // general path: log2 of the column width
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
      lgc = 5;
    } else {
      lgc = col_log2(m);
      const int across = (m + (1 << lgc) - 1) >> lgc;
      bi = t / across;
      bj = t - bi * across;
    }
    I = bi * TILE;
    J = bj << (sym ? 5 : lgc);
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

// K7F body for heap class NC: walk the tile's elements, store them (and,
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
    const int r = q >> 5, c = q & (TILE - 1);
    if (c >= tl.rows) continue;
    if (tl.diag) {
      if (r < tl.rows)
        Kp[static_cast<size_t>(tl.I + r) * m + tl.I + c] = tr[r][c];
    } else {  // row J + r, column I + c holds element (I + c, J + r)
      Kp[static_cast<size_t>(tl.J + r) * m + tl.I + c] = tr[c][r];
    }
  }
}

template <int N>
__global__ void __launch_bounds__(THREADS, 4)
cov_fwd_kernel(int n, int m, int sym, const int* __restrict__ types,
               const float* __restrict__ params, const float* __restrict__ x1,
               int s1, const float* __restrict__ x2, int s2,
               float* __restrict__ K) {
  __shared__ Node nd[N];
  __shared__ float xr[TILE], xc[TILE];
  __shared__ float tr[TILE][TILE + 1];
  const int p = blockIdx.y;
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

// K7B accumulators in shared memory: slot k, parameter q of this thread at
// p[(3 k + q) * THREADS], a column per thread (no bank conflicts).
struct ColumnAcc {
  float* p;
  struct Slot {
    float* p;
    __device__ float& operator[](int q) const { return p[q * THREADS]; }
  };
  __device__ Slot operator[](int k) const { return Slot{p + 3 * k * THREADS}; }
};

// Every element of the tile swept into acc with its (folded) cotangent.
template <int NC, class Acc>
__device__ __forceinline__ void sweep_tile(const Node* nd, const Tile& tl,
                                           const float* xr, const float* xc,
                                           const float (*da)[TILE + 1],
                                           const float (*db)[TILE + 1],
                                           const float* Dp, int m, Acc& acc) {
#pragma unroll 1
  for (int q = threadIdx.x; q < tl.count; q += THREADS) {
    int r, c;
    if (!tl.at(q, r, c)) continue;
    float w;
    if (!tl.sym) {
      w = Dp[static_cast<size_t>(tl.I + r) * m + tl.J + c];
    } else if (tl.diag) {
      w = r == c ? da[r][c] : da[r][c] + da[c][r];
    } else {
      w = da[r][c] + db[c][r];
    }
    walk_bwd<NC, true>(fresh_nodes(nd), xr[r], xc[c], w, acc);
  }
}

// K7B body for heap class NC: the tile's 3 NC sums written to out[0 ..
// 3 NC), in registers (SMEM false) or in shared memory s_acc.
template <int NC, bool SMEM>
__device__ __forceinline__ void bwd_tile(const Node* nd, const Tile& tl,
                                         const float* xr, const float* xc,
                                         const float (*da)[TILE + 1],
                                         const float (*db)[TILE + 1],
                                         const float* Dp, int m, float* s_acc,
                                         float* out) {
  if constexpr (SMEM) {
    const int tid = threadIdx.x;
    for (int q = 0; q < 3 * NC; ++q) s_acc[q * THREADS + tid] = 0.0f;
    ColumnAcc acc{s_acc + tid};
    sweep_tile<NC>(nd, tl, xr, xc, da, db, Dp, m, acc);
    __syncthreads();
    // column sums in a fixed order: warp w takes q = w, w + WARPS, ...
    const int lane = tid & 31, warp = tid >> 5;
    for (int q = warp; q < 3 * NC; q += WARPS) {
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < WARPS; ++i) s += s_acc[q * THREADS + 32 * i + lane];
      s = warp_sum(s);
      if (lane == 0) out[q] = s;
    }
  } else {
    __shared__ float s_red[WARPS][3 * NC];
    float acc[NC][3];
#pragma unroll
    for (int k = 0; k < NC; ++k) acc[k][0] = acc[k][1] = acc[k][2] = 0.0f;
    sweep_tile<NC>(nd, tl, xr, xc, da, db, Dp, m, acc);
    block_partial<NC, WARPS>(acc, s_red, out);
  }
}

// Class NC's body where this launch (BIG or not) takes that class.
template <int NC, int N, bool BIG>
__device__ __forceinline__ void bwd_class(const Node* nd, const Tile& tl,
                                          const float* xr, const float* xc,
                                          const float (*da)[TILE + 1],
                                          const float (*db)[TILE + 1],
                                          const float* Dp, int m, float* s_acc,
                                          float* out) {
  if constexpr (NC <= N && BIG == (NC > REG_CLASS_MAX))
    bwd_tile<NC, BIG>(nd, tl, xr, xc, da, db, Dp, m, s_acc, out);
}

// K7B, pass 1: one tile of one particle, if the particle's class belongs to
// this launch (BIG: classes above REG_CLASS_MAX; else the others).  Writes
// the tile's 3N partial sums to partial[p][tile][:].
template <int N, bool BIG>
__global__ void __launch_bounds__(THREADS, 2)
cov_bwd_kernel(int n, int m, int sym, const int* __restrict__ types,
               const float* __restrict__ params, const float* __restrict__ x1,
               int s1, const float* __restrict__ x2, int s2,
               const float* __restrict__ dK, float* __restrict__ partial) {
  extern __shared__ float s_acc[];  // BIG: [3 N][THREADS]
  __shared__ Node nd[N];
  __shared__ float xr[TILE], xc[TILE];
  __shared__ float da[TILE][TILE + 1];   // dK[I + r][J + c]
  __shared__ float db[TILE][TILE + 1];   // dK[J + r][I + c]
  const int p = blockIdx.y, tid = threadIdx.x;
  const Tile tl(blockIdx.x, n, m, sym != 0);
  load_nodes<N, THREADS>(nd, p, types, params);
  __syncthreads();
  const int nc = heap_class(nd, N);
  if (BIG != (nc > REG_CLASS_MAX)) return;  // the other launch's block
  load_points(tl, x1 + static_cast<size_t>(p) * s1,
              x2 + static_cast<size_t>(p) * s2, xr, xc);
  const float* Dp = dK + static_cast<size_t>(p) * n * m;
  if (tl.sym) {
    for (int q = tid; q < TILE * TILE; q += THREADS) {
      const int r = q >> 5, c = q & (TILE - 1);
      const bool in_a = r < tl.rows && tl.J + c < n;
      const bool in_b = !tl.diag && tl.J + r < n && c < tl.rows;
      da[r][c] = in_a ? Dp[static_cast<size_t>(tl.I + r) * n + tl.J + c] : 0.0f;
      db[r][c] = in_b ? Dp[static_cast<size_t>(tl.J + r) * n + tl.I + c] : 0.0f;
    }
  }
  __syncthreads();
  float* out = partial + (static_cast<size_t>(p) * gridDim.x + blockIdx.x) * 3 * N;
  switch (nc) {
    case 1: bwd_class<1, N, BIG>(nd, tl, xr, xc, da, db, Dp, m, s_acc, out); break;
    case 3: bwd_class<3, N, BIG>(nd, tl, xr, xc, da, db, Dp, m, s_acc, out); break;
    case 7: bwd_class<7, N, BIG>(nd, tl, xr, xc, da, db, Dp, m, s_acc, out); break;
    case 15: bwd_class<15, N, BIG>(nd, tl, xr, xc, da, db, Dp, m, s_acc, out); break;
    case 31: bwd_class<31, N, BIG>(nd, tl, xr, xc, da, db, Dp, m, s_acc, out); break;
    case 63: bwd_class<63, N, BIG>(nd, tl, xr, xc, da, db, Dp, m, s_acc, out); break;
  }
  for (int q = 3 * nc + tid; q < 3 * N; q += THREADS) out[q] = 0.0f;
}

bool shape_ok(int P, int n, int m, int s1, int s2, int sym, const float* x1,
              const float* x2) {
  return P > 0 && P <= 65535 && n >= 1 && n <= MAX_N && m >= 1 &&
         m <= MAX_N && (s1 == 0 || s1 == n) && (s2 == 0 || s2 == m) &&
         (!sym || (n == m && s1 == s2 && x1 == x2));
}

template <int N>
int launch_fwd(int P, int n, int m, int s1, int s2, int sym, const int* types,
               const float* params, const float* x1, const float* x2,
               float* K, cudaStream_t s) {
  cov_fwd_kernel<N><<<dim3(n_tiles(n, m, sym), P), THREADS, 0, s>>>(
      n, m, sym, types, params, x1, s1, x2, s2, K);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch_bwd(int P, int n, int m, int s1, int s2, int sym, const int* types,
               const float* params, const float* x1, const float* x2,
               const float* dK, float* dparams, float* partial,
               cudaStream_t s) {
  const int T = n_tiles(n, m, sym);
  cov_bwd_kernel<N, false><<<dim3(T, P), THREADS, 0, s>>>(
      n, m, sym, types, params, x1, s1, x2, s2, dK, partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if constexpr (N > REG_CLASS_MAX) {
    constexpr size_t smem = sizeof(float) * 3 * N * THREADS;
    static const cudaError_t attr = cudaFuncSetAttribute(
        cov_bwd_kernel<N, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    cov_bwd_kernel<N, true><<<dim3(T, P), THREADS, smem, s>>>(
        n, m, sym, types, params, x1, s1, x2, s2, dK, partial);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int total = P * 3 * N;
  reduce_partials_kernel<<<(total + 255) / 256, 256, 0, s>>>(P, T, 3 * N,
                                                             partial, dparams);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points.  Every pointer is a contiguous device buffer: types int32
// [P, N]; params f32 [P, N, 3]; x1 f32 [P, n] (s1 = n) or [n] (s1 = 0); x2
// likewise with m and s2; K, dK f32 [P, n, m]; dparams f32 [P, N, 3];
// partial f32 [P, cov_tiles(n, m, sym), 3 N] scratch.  sym = 1 asks for the
// symmetric path: x2 is x1 (the same pointer and stride, n = m).  Return
// the cudaError_t of the launches (0 = success).
extern "C" int cov_tiles(int n, int m, int sym) {
  return n_tiles(n, m, sym != 0);
}

extern "C" int cov_fwd(int N, int P, int n, int m, int s1, int s2, int sym,
                       const int* types, const float* params, const float* x1,
                       const float* x2, float* K, void* stream) {
  if (!shape_ok(P, n, m, s1, s2, sym, x1, x2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 7:  return launch_fwd<7>(P, n, m, s1, s2, sym, types, params, x1, x2, K, s);
    case 15: return launch_fwd<15>(P, n, m, s1, s2, sym, types, params, x1, x2, K, s);
    case 31: return launch_fwd<31>(P, n, m, s1, s2, sym, types, params, x1, x2, K, s);
    case 63: return launch_fwd<63>(P, n, m, s1, s2, sym, types, params, x1, x2, K, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int cov_bwd(int N, int P, int n, int m, int s1, int s2, int sym,
                       const int* types, const float* params, const float* x1,
                       const float* x2, const float* dK, float* dparams,
                       float* partial, void* stream) {
  if (!shape_ok(P, n, m, s1, s2, sym, x1, x2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 7:  return launch_bwd<7>(P, n, m, s1, s2, sym, types, params, x1, x2, dK, dparams, partial, s);
    case 15: return launch_bwd<15>(P, n, m, s1, s2, sym, types, params, x1, x2, dK, dparams, partial, s);
    case 31: return launch_bwd<31>(P, n, m, s1, s2, sym, types, params, x1, x2, dK, dparams, partial, s);
    case 63: return launch_bwd<63>(P, n, m, s1, s2, sym, types, params, x1, x2, dK, dparams, partial, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
