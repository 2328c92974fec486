// Batched covariance of heap-encoded kernel trees and its VJP, for Hopper
// (sm_90a).  Two kernels:
//
//   K4  megacov_fwd_kernel  K(x_p, x_p) for P heterogeneous trees
//       replaces nowcastautogp_tpu/ops/pallas_megacov.py::_cov_fwd_kernel
//   K5  megacov_bwd_kernel  dK -> dparams by a recomputed walk
//       replaces nowcastautogp_tpu/ops/pallas_megacov.py::_cov_bwd_kernel
//
// They carry the composed LML path (capacities above K1/K2's 512) and the
// K(x, x) plane of the predictive and the nowcast.
//
// Design.  The covariance is symmetric and elementwise in (row, col), so
// the grid is (lower-triangle 64 x 64 tiles, particles): one block of 256
// threads per tile of one particle, 16 elements a thread.  The tree is
// uniform across the block (the node bodies of heapwalk.cuh, the same code
// K1/K2 run), so there is nothing to gate and nothing to sort: the TPU
// kernel's chunk flags, structure sort and tiled/untiled split have no role.
// K4 writes each tile and, off the diagonal, its transpose through shared
// memory, so both stores are coalesced.
//
// K5 folds the cotangent as the TPU kernel does (pallas_megacov.py:852-858):
// w_ij = dK_ij + dK_ji below the diagonal, dK_ii on it, so the result is
// right for an asymmetric dK; the two dK tiles are staged in shared memory
// so both reads are coalesced.  Nothing is saved from the forward: each
// element recomputes its walk, then sweeps cotangents top-down into 3N
// per-thread accumulators.  Each block reduces them in a fixed order (warp
// shuffles, then warps in order) to one partial per tile, and a second
// kernel sums the tiles of a particle in tile order: no float atomics, so
// both kernels are deterministic.
//
// What bounds them.  K4 moves P n^2 floats out and does a few tens of
// operations per element, so at the fit's shapes its floor is the store of
// K (bytes); the exp/log/sinpi of the walk run on the special-function
// units and keep it above that floor.  K5 reads dK once (bytes floor) but
// runs the forward walk plus the backward sweep per element with 5N live
// floats a thread: at N = 31 that is register spills, and the transcendental
// walk, not memory, is what it waits on.

#include "heapwalk.cuh"

namespace {

using namespace heapwalk;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;
constexpr int ROWS_PER_PASS = THREADS / TILE;   // 4
constexpr int MAX_N = 2048;

// Tile t of the lower triangle (row-major over tiles bi >= bj).
__device__ __forceinline__ void tile_coords(int t, int& bi, int& bj) {
  int b = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  while (b * (b + 1) / 2 > t) --b;
  while ((b + 1) * (b + 2) / 2 <= t) ++b;
  bi = b;
  bj = t - b * (b + 1) / 2;
}

// K4: one 64 x 64 tile (bi, bj), bi >= bj, of particle blockIdx.y.
template <int N>
__global__ void __launch_bounds__(THREADS)
megacov_fwd_kernel(int n, const int* __restrict__ types,
                   const float* __restrict__ params,
                   const float* __restrict__ x, float* __restrict__ K) {
  __shared__ Node nd[N];
  __shared__ float xr[TILE], xc[TILE];
  __shared__ float tr[TILE][TILE + 1];
  const int p = blockIdx.y, tid = threadIdx.x;
  int bi, bj;
  tile_coords(blockIdx.x, bi, bj);
  const int I = bi * TILE, J = bj * TILE;
  const float* xp = x + static_cast<size_t>(p) * n;
  float* Kp = K + static_cast<size_t>(p) * n * n;

  load_nodes<N, THREADS>(nd, p, types, params);
  if (tid < TILE) {
    xr[tid] = (I + tid < n) ? xp[I + tid] : 0.0f;
  } else if (tid < 2 * TILE) {
    const int c = tid - TILE;
    xc[c] = (J + c < n) ? xp[J + c] : 0.0f;
  }
  __syncthreads();

  const int c = tid % TILE, r0 = tid / TILE;
  const int j = J + c;
#pragma unroll 1
  for (int r = r0; r < TILE; r += ROWS_PER_PASS) {
    const int i = I + r;
    const float v = cov_elem<N>(nd, xr[r], xc[c]);
    if (i < n && j < n) Kp[static_cast<size_t>(i) * n + j] = v;
    tr[r][c] = v;
  }
  if (bi == bj) return;  // a diagonal tile is written whole above
  __syncthreads();
  // transpose: row J + r, column I + c holds element (I + c, J + r)
#pragma unroll 1
  for (int r = r0; r < TILE; r += ROWS_PER_PASS) {
    const int i = J + r, jj = I + c;
    if (i < n && jj < n) Kp[static_cast<size_t>(i) * n + jj] = tr[c][r];
  }
}

// K5, pass 1: one tile's folded cotangent swept through the walk; writes
// the tile's 3N partial sums to partial[p][tile][:].
template <int N>
__global__ void __launch_bounds__(THREADS)
megacov_bwd_kernel(int n, const int* __restrict__ types,
                   const float* __restrict__ params,
                   const float* __restrict__ x, const float* __restrict__ dK,
                   float* __restrict__ partial) {
  __shared__ Node nd[N];
  __shared__ float xr[TILE], xc[TILE];
  __shared__ float da[TILE][TILE + 1];   // dK[I + r][J + c]
  __shared__ float db[TILE][TILE + 1];   // dK[J + r][I + c]
  __shared__ float s_red[WARPS][3 * N];
  const int p = blockIdx.y, tid = threadIdx.x;
  int bi, bj;
  tile_coords(blockIdx.x, bi, bj);
  const int I = bi * TILE, J = bj * TILE;
  const float* xp = x + static_cast<size_t>(p) * n;
  const float* Dp = dK + static_cast<size_t>(p) * n * n;

  load_nodes<N, THREADS>(nd, p, types, params);
  if (tid < TILE) {
    xr[tid] = (I + tid < n) ? xp[I + tid] : 0.0f;
  } else if (tid < 2 * TILE) {
    const int c = tid - TILE;
    xc[c] = (J + c < n) ? xp[J + c] : 0.0f;
  }
  const int c = tid % TILE, r0 = tid / TILE;
  for (int r = r0; r < TILE; r += ROWS_PER_PASS) {
    const bool in_a = (I + r < n) && (J + c < n);
    const bool in_b = (J + r < n) && (I + c < n);
    da[r][c] = in_a ? Dp[static_cast<size_t>(I + r) * n + J + c] : 0.0f;
    db[r][c] = in_b ? Dp[static_cast<size_t>(J + r) * n + I + c] : 0.0f;
  }
  __syncthreads();

  float acc[N][3];
#pragma unroll
  for (int k = 0; k < N; ++k) acc[k][0] = acc[k][1] = acc[k][2] = 0.0f;
  const int j = J + c;
#pragma unroll 1
  for (int r = r0; r < TILE; r += ROWS_PER_PASS) {
    const int i = I + r;
    if (i < n && j < n && i >= j) {
      const float w = (i == j) ? da[r][c] : da[r][c] + db[c][r];
      walk_bwd<N>(nd, xr[r], xc[c], w, acc);
    }
  }

  block_partial<N, WARPS>(
      acc, s_red,
      partial + (static_cast<size_t>(p) * gridDim.x + blockIdx.x) * 3 * N);
}

bool n_supported(int n) { return n >= 8 && n <= MAX_N && n % 8 == 0; }

int n_tiles(int n) {
  const int nt = (n + TILE - 1) / TILE;
  return nt * (nt + 1) / 2;
}

template <int N>
int launch_fwd(int P, int n, const int* types, const float* params,
               const float* x, float* K, cudaStream_t s) {
  megacov_fwd_kernel<N><<<dim3(n_tiles(n), P), THREADS, 0, s>>>(
      n, types, params, x, K);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch_bwd(int P, int n, const int* types, const float* params,
               const float* x, const float* dK, float* dparams,
               float* partial, cudaStream_t s) {
  const int T = n_tiles(n);
  megacov_bwd_kernel<N><<<dim3(T, P), THREADS, 0, s>>>(n, types, params, x,
                                                        dK, partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int total = P * 3 * N;
  reduce_partials_kernel<<<(total + 255) / 256, 256, 0, s>>>(P, T, 3 * N,
                                                             partial, dparams);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points.  Every pointer is a contiguous device buffer: types
// int32 [P, N]; params f32 [P, N, 3]; x f32 [P, n]; K, dK f32 [P, n, n];
// dparams f32 [P, N, 3]; partial f32 [P, megacov_tiles(n), 3 N] scratch.
// Return the cudaError_t of the launches (0 = success).
extern "C" int megacov_tiles(int n) { return n_tiles(n); }

extern "C" int megacov_fwd(int N, int P, int n, const int* types,
                           const float* params, const float* x, float* K,
                           void* stream) {
  if (P <= 0 || P > 65535 || !n_supported(n))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 7:  return launch_fwd<7>(P, n, types, params, x, K, s);
    case 15: return launch_fwd<15>(P, n, types, params, x, K, s);
    case 31: return launch_fwd<31>(P, n, types, params, x, K, s);
    case 63: return launch_fwd<63>(P, n, types, params, x, K, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int megacov_bwd(int N, int P, int n, const int* types,
                           const float* params, const float* x,
                           const float* dK, float* dparams, float* partial,
                           void* stream) {
  if (P <= 0 || P > 65535 || !n_supported(n))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 7:  return launch_bwd<7>(P, n, types, params, x, dK, dparams, partial, s);
    case 15: return launch_bwd<15>(P, n, types, params, x, dK, dparams, partial, s);
    case 31: return launch_bwd<31>(P, n, types, params, x, dK, dparams, partial, s);
    case 63: return launch_bwd<63>(P, n, types, params, x, dK, dparams, partial, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
