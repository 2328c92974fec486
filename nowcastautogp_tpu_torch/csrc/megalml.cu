// Fused masked GP log marginal likelihood over a batch of heap-encoded
// kernel trees, for Hopper (sm_90a).  Two kernels:
//
//   K2  megalml_val_kernel  core = -0.5 (ym^T A^-1 ym + logdet A)
//       replaces nowcastautogp_tpu/ops/pallas_megalml.py::_megalml_val_kernel
//   K1  megalml_vag_kernel  core, d core / d params, d core / d diagv, alpha
//       replaces nowcastautogp_tpu/ops/pallas_megalml.py::_megalml_kernel
//
// with A = K(x, x) o (m m^T) + diag(diagv) per particle.  Both inline what
// the TPU kernels inline: the heap-walk node bodies of
// ops/pallas_megacov.py (_node_fwd_body, _node_bwd_body; here heapwalk.cuh,
// shared with K4/K5 in megacov.cu) and the Cholesky plus triangular
// inverse of ops/chol_mxu.py (tri_inv_body).
//
// Design.  One block of 256 threads per particle.  A particle's tree is
// uniform across its block, so the per-node type branch never diverges;
// the TPU kernel's chunk activity flags, structure sorting and VMEM chunk
// policies existed to share one vector program between particles of
// different structure and have no role here.  The covariance is
// elementwise in (row, col): threads stride over the lower triangle and
// evaluate the tree bottom-up per element with the node values in a
// per-thread array (N, the heap size, is a template parameter: 7/15/31/63).
// A lives in a per-particle workspace in device memory (2 x 200 x 160^2 x
// 4 B = 41 MB at the fit's largest shape, which L2 holds) and is factored
// in place by a right-looking Cholesky whose current column is staged in
// shared memory; t = L^-1 ym rides along as an extra right-hand side.
//
// What bounds it.  The factorisation is n sequential steps, each a rank-1
// update of the trailing triangle followed by a block barrier: at the fit's
// n = 160 that is latency (barriers and L2 round trips), not arithmetic.
// The gradient kernel adds two more such passes (L^-1, then the lower
// triangle of A^-1 = L^-T L^-1) and a second tree walk per element, which
// is transcendental-heavy (exp, log, sinpi per leaf).  One particle per
// block keeps every reduction inside a block, so results are deterministic.
//
// Consistency contract (JAX ops/lml.py:367-378): K1's core must equal K2's
// bit for bit.  Both call value_steps<N>, which is __noinline__, so the two
// kernels run one compiled copy of the value path.
//
// A non-positive or non-finite pivot makes sqrtf return NaN (or inf); it
// propagates through that particle's factor and core only.  No thread
// exits early, so a broken particle cannot hang its block, and the
// caller's -1e10 guard then rejects the particle.

#include "heapwalk.cuh"

namespace {

using namespace heapwalk;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_N = 512;
constexpr int FLUSH = 16;  // elements per lane between K1's accumulator flushes

// Deterministic block sum of f(i) over i < n: lanes of warp 0 sum strided
// entries in order, then a fixed shuffle tree.  Result valid in warp 0.
template <typename F>
__device__ __forceinline__ float warp0_sum(int n, F f) {
  float s = 0.0f;
  for (int i = threadIdx.x; i < n; i += 32) s += f(i);
  return warp_sum(s);
}

// Adds a warp's per-lane gradient sums into its double accumulator dst
// (3 N entries; lane 0 writes) and zeroes them.  Slots without parameters
// (empty, Plus, Times: the type is uniform over the block) hold zeros and
// are skipped.
template <int N>
__device__ __forceinline__ void flush_acc(const Node* nd, float (&acc)[N][3],
                                          double* dst, int lane) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int t = nd[k].type;
    if (t == EMPTY || t == PLUS || t == TIMES) continue;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float s = warp_sum(acc[k][c]);
      if (lane == 0) dst[3 * k + c] += s;
      acc[k][c] = 0.0f;
    }
  }
}

// Per-particle shared state.  s_t enters value_steps holding ym and leaves
// holding t = L^-1 ym.
struct Shared {
  Node nd[64];
  float x[MAX_N], m[MAX_N], dg[MAX_N], t[MAX_N], col[MAX_N];
  float piv;
};

template <int N>
__device__ __forceinline__ void load_particle(
    Shared& sh, int p, int n, const int* types, const float* params,
    const float* diagv, const float* mask, const float* x, const float* ym) {
  for (int k = threadIdx.x; k < N; k += THREADS) {
    const float* pp = params + (static_cast<size_t>(p) * N + k) * 3;
    sh.nd[k] = make_node(types[static_cast<size_t>(p) * N + k], pp[0], pp[1],
                         pp[2]);
  }
  const size_t o = static_cast<size_t>(p) * n;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    sh.x[i] = x[o + i];
    sh.m[i] = mask[o + i];
    sh.dg[i] = diagv[o + i];
    sh.t[i] = ym[o + i];
  }
  __syncthreads();
}

// Steps shared by K1 and K2: covariance walk and masked assembly of A,
// in-place Cholesky A = L L^T with t = L^-1 ym alongside, and
// core = -0.5 (t^T t + 2 sum log L_kk).  Leaves L in the lower triangle of A.
template <int N>
__device__ __noinline__ void value_steps(Shared& sh, float* A, int n,
                                         float* core_out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 1. covariance + assembly, lower triangle by rows; mirrored above
  for (int i = warp; i < n; i += WARPS) {
    const float xi = sh.x[i], mi = sh.m[i];
    for (int j = lane; j <= i; j += 32) {
      const float xj = sh.x[j];
      const float d = xi - xj;
      const float r = fabsf(d);
      float v[N];
      walk_fwd<N>(sh.nd, xi, xj, r, d * d, logf(fmaxf(r, 1e-30f)), v);
      float a = v[0] * (mi * sh.m[j]);
      if (i == j) a += sh.dg[i];
      A[static_cast<size_t>(i) * n + j] = a;
      A[static_cast<size_t>(j) * n + i] = a;
    }
  }
  __syncthreads();

  // 2. right-looking Cholesky; column k of L staged in shared memory
  for (int k = 0; k < n; ++k) {
    if (tid == 0) {
      const float dk = sqrtf(A[static_cast<size_t>(k) * n + k]);
      A[static_cast<size_t>(k) * n + k] = dk;
      sh.piv = dk;
      sh.t[k] = sh.t[k] / dk;
    }
    __syncthreads();
    const float dk = sh.piv;
    for (int i = k + 1 + tid; i < n; i += THREADS) {
      const float l = A[static_cast<size_t>(i) * n + k] / dk;
      A[static_cast<size_t>(i) * n + k] = l;
      sh.col[i] = l;
    }
    __syncthreads();
    const float tk = sh.t[k];
    for (int i = k + 1 + tid; i < n; i += THREADS) sh.t[i] -= sh.col[i] * tk;
    for (int i = k + 1 + warp; i < n; i += WARPS) {
      const float lik = sh.col[i];
      float* row = A + static_cast<size_t>(i) * n;
      for (int j = k + 1 + lane; j <= i; j += 32) row[j] -= lik * sh.col[j];
    }
    __syncthreads();
  }

  // 3. core = -0.5 (quad + logdet), fixed-order reductions
  if (warp == 0) {
    const float quad = warp0_sum(n, [&](int i) { return sh.t[i] * sh.t[i]; });
    const float sl = warp0_sum(n, [&](int i) {
      return logf(A[static_cast<size_t>(i) * n + i]);
    });
    if (lane == 0) *core_out = -0.5f * (quad + 2.0f * sl);
  }
  __syncthreads();
}

// K2 (replaces ops/pallas_megalml.py::_megalml_val_kernel): value only.
// Bound by the factorisation's n barrier-separated steps; 150 launches per
// fit (reweights and proposal LMLs), so its cost is small next to K1's.
template <int N>
__global__ void __launch_bounds__(THREADS)
megalml_val_kernel(int n, const int* __restrict__ types,
                   const float* __restrict__ params,
                   const float* __restrict__ diagv,
                   const float* __restrict__ mask,
                   const float* __restrict__ x, const float* __restrict__ ym,
                   float* __restrict__ core, float* __restrict__ ws) {
  __shared__ Shared sh;
  const int p = blockIdx.x;
  load_particle<N>(sh, p, n, types, params, diagv, mask, x, ym);
  value_steps<N>(sh, ws + static_cast<size_t>(p) * n * n, n, core + p);
}

// K1 (replaces ops/pallas_megalml.py::_megalml_kernel): value, then
// alpha, L^-1, A^-1 and the backward walk.  Three n-step barrier loops
// plus a second transcendental walk per element; the per-thread
// accumulators (3 N floats) set its register pressure.  One launch per HMC
// leapfrog, 3,640 per fit.
template <int N>
__global__ void __launch_bounds__(THREADS)
megalml_vag_kernel(int n, const int* __restrict__ types,
                   const float* __restrict__ params,
                   const float* __restrict__ diagv,
                   const float* __restrict__ mask,
                   const float* __restrict__ x, const float* __restrict__ ym,
                   float* __restrict__ core, float* __restrict__ dparams,
                   float* __restrict__ gdiag, float* __restrict__ alpha_out,
                   float* __restrict__ ws1, float* __restrict__ ws2) {
  __shared__ Shared sh;
  __shared__ float s_a[MAX_N];
  __shared__ double s_acc[WARPS][3 * N];
  const int p = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* L = ws1 + static_cast<size_t>(p) * n * n;
  float* X = ws2 + static_cast<size_t>(p) * n * n;

  load_particle<N>(sh, p, n, types, params, diagv, mask, x, ym);
  value_steps<N>(sh, L, n, core + p);

  // 4. alpha = L^-T t (rows of L are contiguous: coalesced reads)
  for (int i = tid; i < n; i += THREADS) s_a[i] = sh.t[i];
  __syncthreads();
  for (int k = n - 1; k >= 0; --k) {
    if (tid == 0) s_a[k] = s_a[k] / L[static_cast<size_t>(k) * n + k];
    __syncthreads();
    const float ak = s_a[k];
    for (int i = tid; i < k; i += THREADS)
      s_a[i] -= L[static_cast<size_t>(k) * n + i] * ak;
    __syncthreads();
  }
  for (int i = tid; i < n; i += THREADS)
    alpha_out[static_cast<size_t>(p) * n + i] = s_a[i];

  // 5. X = L^-1 (lower), right-looking: row k is final once scaled
  for (int i = warp; i < n; i += WARPS)
    for (int c = lane; c <= i; c += 32)
      X[static_cast<size_t>(i) * n + c] = (i == c) ? 1.0f : 0.0f;
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    const float dk = L[static_cast<size_t>(k) * n + k];
    float* xk = X + static_cast<size_t>(k) * n;
    for (int c = tid; c <= k; c += THREADS) xk[c] = xk[c] / dk;
    __syncthreads();
    for (int i = k + 1 + warp; i < n; i += WARPS) {
      const float lik = L[static_cast<size_t>(i) * n + k];
      float* xi = X + static_cast<size_t>(i) * n;
      for (int c = lane; c <= k; c += 32) xi[c] -= lik * xk[c];
    }
    __syncthreads();
  }

  // 6. lower triangle of A^-1 = X^T X into ws1 (L is no longer needed)
  for (int i = warp; i < n; i += WARPS) {
    for (int j = lane; j <= i; j += 32) {
      float s = 0.0f;
      for (int k = i; k < n; ++k)
        s += X[static_cast<size_t>(k) * n + i] * X[static_cast<size_t>(k) * n + j];
      L[static_cast<size_t>(i) * n + j] = s;
    }
  }
  __syncthreads();
  const float* Ainv = L;
  for (int j = tid; j < n; j += THREADS)
    gdiag[static_cast<size_t>(p) * n + j] =
        0.5f * (s_a[j] * s_a[j] - Ainv[static_cast<size_t>(j) * n + j]);

  // 7. backward walk over the lower triangle with the folded cotangent
  //    W = 0.5 (alpha alpha^T - A^-1) o (m m^T), weight 2 below the diagonal.
  //    On an ill-conditioned particle W's entries are large and cancel, so
  //    one float running sum per lane over its ~n^2 / 512 elements loses
  //    the gradient; every FLUSH elements a lane's sums go through the warp
  //    tree into the warp's double accumulator (same order every launch).
  for (int q = tid; q < WARPS * 3 * N; q += THREADS) (&s_acc[0][0])[q] = 0.0;
  __syncthreads();
  float acc[N][3];
#pragma unroll
  for (int k = 0; k < N; ++k) acc[k][0] = acc[k][1] = acc[k][2] = 0.0f;
  int pending = 0;  // elements per lane since the last flush, warp-uniform
  for (int i = warp; i < n; i += WARPS) {
    const float xi = sh.x[i], mi = sh.m[i], ai = s_a[i];
    for (int j = lane; j <= i; j += 32) {
      const float fold = (i > j) ? 2.0f : 1.0f;
      const float w = 0.5f * (ai * s_a[j] - Ainv[static_cast<size_t>(i) * n + j])
                      * fold * (mi * sh.m[j]);
      walk_bwd<N>(sh.nd, xi, sh.x[j], w, acc);
    }
    pending += (i + 32) / 32;
    if (pending >= FLUSH || i + WARPS >= n) {
      flush_acc<N>(sh.nd, acc, s_acc[warp], lane);
      pending = 0;
    }
  }
  __syncthreads();

  // 8. dparams: the warps' double sums added in a fixed order
  for (int q = tid; q < 3 * N; q += THREADS) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += s_acc[w][q];
    dparams[static_cast<size_t>(p) * 3 * N + q] = static_cast<float>(s);
  }
}

bool n_supported(int n) { return n >= 32 && n <= MAX_N && n % 32 == 0; }

template <int N>
int launch_val(int P, int n, const int* types, const float* params,
               const float* diagv, const float* mask, const float* x,
               const float* ym, float* core, float* ws, cudaStream_t s) {
  megalml_val_kernel<N><<<P, THREADS, 0, s>>>(n, types, params, diagv, mask,
                                              x, ym, core, ws);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch_vag(int P, int n, const int* types, const float* params,
               const float* diagv, const float* mask, const float* x,
               const float* ym, float* core, float* dparams, float* gdiag,
               float* alpha, float* ws1, float* ws2, cudaStream_t s) {
  megalml_vag_kernel<N><<<P, THREADS, 0, s>>>(
      n, types, params, diagv, mask, x, ym, core, dparams, gdiag, alpha, ws1,
      ws2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points.  Every pointer is a contiguous device buffer: types
// int32 [P, N]; params f32 [P, N, 3]; diagv, mask, x, ym f32 [P, n];
// core f32 [P]; dparams f32 [P, N, 3]; gdiag, alpha f32 [P, n]; ws, ws1,
// ws2 f32 [P, n, n].  Return the cudaError_t of the launch (0 = success).
extern "C" int megalml_val(int N, int P, int n, const int* types,
                           const float* params, const float* diagv,
                           const float* mask, const float* x, const float* ym,
                           float* core, float* ws, void* stream) {
  if (P <= 0 || !n_supported(n)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 7:  return launch_val<7>(P, n, types, params, diagv, mask, x, ym, core, ws, s);
    case 15: return launch_val<15>(P, n, types, params, diagv, mask, x, ym, core, ws, s);
    case 31: return launch_val<31>(P, n, types, params, diagv, mask, x, ym, core, ws, s);
    case 63: return launch_val<63>(P, n, types, params, diagv, mask, x, ym, core, ws, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int megalml_vag(int N, int P, int n, const int* types,
                           const float* params, const float* diagv,
                           const float* mask, const float* x, const float* ym,
                           float* core, float* dparams, float* gdiag,
                           float* alpha, float* ws1, float* ws2,
                           void* stream) {
  if (P <= 0 || !n_supported(n)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 7:  return launch_vag<7>(P, n, types, params, diagv, mask, x, ym, core, dparams, gdiag, alpha, ws1, ws2, s);
    case 15: return launch_vag<15>(P, n, types, params, diagv, mask, x, ym, core, dparams, gdiag, alpha, ws1, ws2, s);
    case 31: return launch_vag<31>(P, n, types, params, diagv, mask, x, ym, core, dparams, gdiag, alpha, ws1, ws2, s);
    case 63: return launch_vag<63>(P, n, types, params, diagv, mask, x, ym, core, dparams, gdiag, alpha, ws1, ws2, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
