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
// Design.  Nothing is assumed of (x1, x2): no symmetry, no square shape.
// Each particle's n m elements are taken in row-major order in chunks of
// 2,048, one block of 256 threads a chunk (8 elements a thread, element e at
// row e / m, column e % m), so every shape fills its blocks, stores are
// coalesced and the ragged end is one bounds check; no padding, so the
// edges are computed like any other element (the TPU kernel padded x to
// 128 lanes).  x1 and x2 are each per-particle (row stride n or m) or
// shared by every particle (stride 0).  The tree is uniform across a block
// and runs the node bodies of heapwalk.cuh, the same code K1/K2/K4/K5 run.
// K7B recomputes each element's walk and sweeps dK_ij top-down into 3N
// per-thread accumulators; the block reduces them in a fixed order to one
// partial per chunk, and a second kernel sums a particle's chunks in chunk
// order: no float atomics, so both kernels are deterministic.
//
// What bounds them.  K7F writes P n m floats and does a few tens of
// operations an element, K7B reads as many; at these shapes the floor is
// the bytes, but the exp/log/sinpi of the walk (and, in K7B, 5N live floats
// a thread) keep them well above it, as for K4/K5.

#include "heapwalk.cuh"

namespace {

using namespace heapwalk;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int EPT = 8;                    // elements a thread
constexpr int CHUNK = THREADS * EPT;      // elements a block
constexpr int MAX_N = 512;

template <int N>
__global__ void __launch_bounds__(THREADS)
cov_fwd_kernel(int n, int m, const int* __restrict__ types,
               const float* __restrict__ params, const float* __restrict__ x1,
               int s1, const float* __restrict__ x2, int s2,
               float* __restrict__ K) {
  __shared__ Node nd[N];
  const int p = blockIdx.y;
  load_nodes<N, THREADS>(nd, p, types, params);
  __syncthreads();
  const float* a = x1 + static_cast<size_t>(p) * s1;
  const float* b = x2 + static_cast<size_t>(p) * s2;
  float* Kp = K + static_cast<size_t>(p) * n * m;
  const int total = n * m, base = blockIdx.x * CHUNK + threadIdx.x;
#pragma unroll 1
  for (int k = 0; k < EPT; ++k) {
    const int e = base + k * THREADS;
    if (e < total) Kp[e] = cov_elem<N>(nd, a[e / m], b[e % m]);
  }
}

template <int N>
__global__ void __launch_bounds__(THREADS)
cov_bwd_kernel(int n, int m, const int* __restrict__ types,
               const float* __restrict__ params, const float* __restrict__ x1,
               int s1, const float* __restrict__ x2, int s2,
               const float* __restrict__ dK, float* __restrict__ partial) {
  __shared__ Node nd[N];
  __shared__ float s_red[WARPS][3 * N];
  const int p = blockIdx.y;
  load_nodes<N, THREADS>(nd, p, types, params);
  __syncthreads();
  const float* a = x1 + static_cast<size_t>(p) * s1;
  const float* b = x2 + static_cast<size_t>(p) * s2;
  const float* Dp = dK + static_cast<size_t>(p) * n * m;
  float acc[N][3];
#pragma unroll
  for (int k = 0; k < N; ++k) acc[k][0] = acc[k][1] = acc[k][2] = 0.0f;
  const int total = n * m, base = blockIdx.x * CHUNK + threadIdx.x;
#pragma unroll 1
  for (int k = 0; k < EPT; ++k) {
    const int e = base + k * THREADS;
    if (e < total) walk_bwd<N>(nd, a[e / m], b[e % m], Dp[e], acc);
  }
  block_partial<N, WARPS>(
      acc, s_red,
      partial + (static_cast<size_t>(p) * gridDim.x + blockIdx.x) * 3 * N);
}

int n_chunks(int n, int m) { return (n * m + CHUNK - 1) / CHUNK; }

bool shape_ok(int P, int n, int m, int s1, int s2) {
  return P > 0 && P <= 65535 && n >= 1 && n <= MAX_N && m >= 1 &&
         m <= MAX_N && (s1 == 0 || s1 == n) && (s2 == 0 || s2 == m);
}

template <int N>
int launch_fwd(int P, int n, int m, int s1, int s2, const int* types,
               const float* params, const float* x1, const float* x2,
               float* K, cudaStream_t s) {
  cov_fwd_kernel<N><<<dim3(n_chunks(n, m), P), THREADS, 0, s>>>(
      n, m, types, params, x1, s1, x2, s2, K);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch_bwd(int P, int n, int m, int s1, int s2, const int* types,
               const float* params, const float* x1, const float* x2,
               const float* dK, float* dparams, float* partial,
               cudaStream_t s) {
  const int C = n_chunks(n, m);
  cov_bwd_kernel<N><<<dim3(C, P), THREADS, 0, s>>>(n, m, types, params, x1,
                                                    s1, x2, s2, dK, partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int total = P * 3 * N;
  reduce_partials_kernel<<<(total + 255) / 256, 256, 0, s>>>(P, C, 3 * N,
                                                             partial, dparams);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points.  Every pointer is a contiguous device buffer: types int32
// [P, N]; params f32 [P, N, 3]; x1 f32 [P, n] (s1 = n) or [n] (s1 = 0); x2
// likewise with m and s2; K, dK f32 [P, n, m]; dparams f32 [P, N, 3];
// partial f32 [P, cov_chunks(n, m), 3 N] scratch.  Return the cudaError_t
// of the launches (0 = success).
extern "C" int cov_chunks(int n, int m) { return n_chunks(n, m); }

extern "C" int cov_fwd(int N, int P, int n, int m, int s1, int s2,
                       const int* types, const float* params, const float* x1,
                       const float* x2, float* K, void* stream) {
  if (!shape_ok(P, n, m, s1, s2)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 7:  return launch_fwd<7>(P, n, m, s1, s2, types, params, x1, x2, K, s);
    case 15: return launch_fwd<15>(P, n, m, s1, s2, types, params, x1, x2, K, s);
    case 31: return launch_fwd<31>(P, n, m, s1, s2, types, params, x1, x2, K, s);
    case 63: return launch_fwd<63>(P, n, m, s1, s2, types, params, x1, x2, K, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int cov_bwd(int N, int P, int n, int m, int s1, int s2,
                       const int* types, const float* params, const float* x1,
                       const float* x2, const float* dK, float* dparams,
                       float* partial, void* stream) {
  if (!shape_ok(P, n, m, s1, s2)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 7:  return launch_bwd<7>(P, n, m, s1, s2, types, params, x1, x2, dK, dparams, partial, s);
    case 15: return launch_bwd<15>(P, n, m, s1, s2, types, params, x1, x2, dK, dparams, partial, s);
    case 31: return launch_bwd<31>(P, n, m, s1, s2, types, params, x1, x2, dK, dparams, partial, s);
    case 63: return launch_bwd<63>(P, n, m, s1, s2, types, params, x1, x2, dK, dparams, partial, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
