// Fused masked GP log marginal likelihood over a batch of heap-encoded
// kernel trees, for Hopper (sm_90a).  Two kernels:
//
//   K2  megalml_val_kernel  core = -0.5 (ym^T A^-1 ym + logdet A)
//       replaces nowcastautogp_tpu/ops/pallas_megalml.py::_megalml_val_kernel
//   K1  megalml_vag_kernel + megalml_bwd_kernel  core, d core / d params,
//       d core / d diagv, alpha
//       replaces nowcastautogp_tpu/ops/pallas_megalml.py::_megalml_kernel
//
// with A = K(x, x) o (m m^T) + diag(diagv) per particle.  Both inline what
// the TPU kernels inline: the heap-walk node bodies of
// ops/pallas_megacov.py (_node_fwd_body, _node_bwd_body; here heapwalk.cuh,
// shared with K4/K5 and K7F/K7B) and the blocked Cholesky plus triangular
// inverse of ops/chol_mxu.py (tri_inv_body; here the engine of
// chol_blocked.cuh, shared with K3 and K6a/K6b).
//
// Design.  One block of 256 threads per particle.  A particle's tree is
// uniform across its block, so the per-node type branch never diverges;
// the TPU kernel's chunk activity flags, structure sorting and VMEM chunk
// policies existed to share one vector program between particles of
// different structure and have no role here.  The covariance is
// elementwise in (row, col): warps take rows of the lower triangle and
// evaluate the tree bottom-up per element with the node values in a
// per-thread array (N, the heap size, is a template parameter: 7/15/31/63).
// A lives in a per-particle workspace in device memory and is factored in
// place by the engine's left-looking blocked Cholesky (32-wide panels,
// 128 x 32 product tiles on the float64 tensor cores), which keeps each
// diagonal block's inverse in a (n x 32) workspace and carries
// t = L^-1 ym along, one 32-row block at a time.  K1 then takes
// alpha = L^-T t by blocked back substitution, builds XT = L^-T with the
// engine's blocked inverse and the lower triangle of A^-1 = XT XT^T with
// the same tiles, as the TPU kernel formed them as matrix products.
//
// The backward walk is covtile.cuh's VJP (megalml_bwd_kernel, the tiles,
// class walk and launch plan K5 and K7B run) under K1's own cotangent: one
// block per lower 32 x 32 tile of a particle (a diagonal tile walks only its
// lower elements: at n = 160 all 12,880 walked elements are live), each tree
// walked only as far as its heap class with its empty slots skipped, the
// nodes re-read from shared memory per element (fresh_nodes), classes up to
// 15 accumulating in registers and 31/63 in shared-memory columns, at most
// 128 registers, two blocks an SM (at N = 31: 61 registers for classes
// 1 and 3, 74 for 7, 119 for 15, 121 for 31, 120 for one launch of classes
// 1 to 15, no spill; class 63, depth-6 trees only, spills about 850 bytes,
// as K5's does).  The launches follow the grid's size, P x tiles: two
// class-switched launches below CLASS_LAUNCH_BLOCKS (at P = 200 up to
// n = 160: the weekly fit, the daily fit's first capacities), one per heap
// class from there (the daily fit from n = 224, the nowcast refresh's
// 20,000 rows at n = 160).
// The cotangent w = 0.5 (alpha alpha^T - A^-1) o (m m^T), weight 2 below
// the diagonal, is formed per tile in shared memory from alpha and the
// lower triangle of A^-1; no dK buffer is written.  Each thread sums its
// elements of a tile (four) in float; the threads, the tile partials and
// a particle's tiles are summed in double, in a fixed order
// (reduce_tiles_kernel for the tiles): on an ill-conditioned particle the
// cotangent's entries are large and cancel, and a float running sum over
// many elements loses the gradient.  All the launches count as one K1
// call.
//
// What bounds it.  The linear algebra is n^3 / 3 flops each for the
// factorisation, the inverse and the Gram product (K2: the factorisation
// only); the walks are transcendental-heavy (exp, log, sinpi per leaf) on
// n^2 / 2 elements each.  At the daily fit's n = 512 the workspaces
// (2 x 200 x 512^2 x 4 B) exceed the 50 MB L2, but each panel product
// streams its operands once and writes its output once.  What stays serial
// is warp 0's 32 x 32 diagonal factor and inverse per panel; the second
// block on the SM (at most 128 registers and about 90 KB of shared memory a
// block) runs meanwhile.  One particle per block keeps every reduction
// inside a block, so results are deterministic.
//
// Consistency contract (JAX ops/lml.py:367-378): K1's core must equal K2's
// bit for bit.  Both call value_steps<N>, which is __noinline__, so the two
// kernels run one compiled copy of the value path.
//
// A non-positive or non-finite pivot makes sqrtf return NaN (or inf); it
// propagates through that particle's factor and core only.  No thread
// exits early, so a broken particle cannot hang its block, and the
// caller's -1e10 guard then rejects the particle.

#include "chol_blocked.cuh"
#include "covtile.cuh"

namespace {

// The factorisation kernels' block (the engine's); the backward walk runs
// covtile.cuh's THREADS.
constexpr int ENGINE_THREADS = cholblk::THREADS;
constexpr int ENGINE_WARPS = ENGINE_THREADS / 32;
constexpr int MAX_N = 512;

// Deterministic block sum of f(i) over i < n: lanes of warp 0 sum strided
// entries in order, then a fixed shuffle tree.  Result valid in warp 0.
template <typename F>
__device__ __forceinline__ float warp0_sum(int n, F f) {
  float s = 0.0f;
  for (int i = threadIdx.x; i < n; i += 32) s += f(i);
  return warp_sum(s);
}

// Per-particle state beside the engine's.  t enters value_steps holding ym
// and leaves holding t = L^-1 ym; a holds alpha in K1.
struct Shared {
  Node nd[64];
  float x[MAX_N], m[MAX_N], dg[MAX_N], t[MAX_N], a[MAX_N];
};

struct LmlSmem {
  cholblk::Smem eng;
  Shared sh;
};

template <int N>
__device__ __forceinline__ void load_particle(
    Shared& sh, int p, int n, const int* types, const float* params,
    const float* diagv, const float* mask, const float* x, const float* ym) {
  load_nodes<N, ENGINE_THREADS>(sh.nd, p, types, params);
  const size_t o = static_cast<size_t>(p) * n;
  for (int i = threadIdx.x; i < n; i += ENGINE_THREADS) {
    sh.x[i] = x[o + i];
    sh.m[i] = mask[o + i];
    sh.dg[i] = diagv[o + i];
    sh.t[i] = ym[o + i];
  }
  __syncthreads();
}

// Steps shared by K1 and K2: covariance walk and masked assembly of the
// lower triangle of A, the blocked Cholesky A = L L^T in place with
// t = L^-1 ym alongside, and core = -0.5 (t^T t + 2 sum log L_kk).  Leaves
// L below the diagonal blocks of A, the factored diagonal blocks on them,
// and their inverses in D.
template <int N>
__device__ __noinline__ void value_steps(LmlSmem& s, float* A, float* D, int n,
                                         float* core_out) {
  Shared& sh = s.sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 1. covariance + assembly, lower triangle by rows
  for (int i = warp; i < n; i += ENGINE_WARPS) {
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
    }
  }
  __syncthreads();

  // 2. blocked Cholesky in place; t = L^-1 ym
  cholblk::blocked_cholesky(s.eng, A, A, D, n, sh.t);

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
// 150 launches per weekly fit (reweights and proposal LMLs).
template <int N>
__global__ void __launch_bounds__(ENGINE_THREADS, 2)
megalml_val_kernel(int n, const int* __restrict__ types,
                   const float* __restrict__ params,
                   const float* __restrict__ diagv,
                   const float* __restrict__ mask,
                   const float* __restrict__ x, const float* __restrict__ ym,
                   float* __restrict__ core, float* __restrict__ ws,
                   float* __restrict__ dws) {
  extern __shared__ __align__(16) unsigned char smem[];
  LmlSmem& s = *reinterpret_cast<LmlSmem*>(smem);
  const int p = blockIdx.x;
  load_particle<N>(s.sh, p, n, types, params, diagv, mask, x, ym);
  value_steps<N>(s, ws + static_cast<size_t>(p) * n * n,
                 dws + static_cast<size_t>(p) * n * cholblk::B, n, core + p);
}

// K1, first launch (replaces ops/pallas_megalml.py::_megalml_kernel with
// the second): value, then alpha = L^-T t, XT = L^-T, the lower triangle
// of A^-1 = XT XT^T (into ws1, over L) and gdiag.  One launch per HMC
// leapfrog, 3,640 per weekly fit.
template <int N>
__global__ void __launch_bounds__(ENGINE_THREADS, 2)
megalml_vag_kernel(int n, const int* __restrict__ types,
                   const float* __restrict__ params,
                   const float* __restrict__ diagv,
                   const float* __restrict__ mask,
                   const float* __restrict__ x, const float* __restrict__ ym,
                   float* __restrict__ core, float* __restrict__ gdiag,
                   float* __restrict__ alpha_out, float* __restrict__ ws1,
                   float* __restrict__ ws2, float* __restrict__ dws) {
  extern __shared__ __align__(16) unsigned char smem[];
  LmlSmem& s = *reinterpret_cast<LmlSmem*>(smem);
  Shared& sh = s.sh;
  const int p = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* L = ws1 + static_cast<size_t>(p) * n * n;
  float* XT = ws2 + static_cast<size_t>(p) * n * n;
  float* D = dws + static_cast<size_t>(p) * n * cholblk::B;

  load_particle<N>(sh, p, n, types, params, diagv, mask, x, ym);
  value_steps<N>(s, L, D, n, core + p);

  // 4. alpha = L^-T t (blocked back substitution)
  cholblk::Smem& eng = s.eng;
  for (int i = tid; i < n; i += ENGINE_THREADS) sh.a[i] = sh.t[i];
  cholblk::back_substitute(eng, L, sh.a, n);

  // 5. XT = L^-T (upper) from L's panels and the kept diagonal inverses
  cholblk::blocked_tri_inverse(eng, L, D, XT, n);

  // 6. lower triangle of A^-1 = XT XT^T into ws1 (L is no longer needed)
  cholblk::lower_gram(eng, XT, L, n);
  for (int j = tid; j < n; j += ENGINE_THREADS) {
    const size_t o = static_cast<size_t>(p) * n + j;
    gdiag[o] = 0.5f * (sh.a[j] * sh.a[j] - L[static_cast<size_t>(j) * n + j]);
    alpha_out[o] = sh.a[j];
  }
}

// K1's folded cotangent, staged a tile at a time in shared memory.
struct StagedCotangent {
  const float (*w)[TILE + 1];

  __device__ float operator()(const Tile&, int r, int c) const {
    return w[r][c];
  }
};

// K1, second launch, for the trees of heap classes LO ... HI, all on one
// side of REG_CLASS_MAX (covtile.cuh's launch plan): the backward walk of
// one lower 32 x 32 tile of particle blockIdx.y, whose block exits first if
// its tree is of another class.  The tile's folded cotangent
// w = 0.5 (alpha alpha^T - A^-1) o (m m^T), weight 2 below the diagonal, is
// formed from the first launch's alpha and the lower triangle of A^-1
// (ws1) into shared memory; the tile's 3 N sums go to partial[p][tile][:]
// in double, zeros past the class.
template <int N, int LO, int HI>
__global__ void __launch_bounds__(THREADS, 2)
megalml_bwd_kernel(int n, const int* __restrict__ types,
                   const float* __restrict__ params,
                   const float* __restrict__ mask,
                   const float* __restrict__ x,
                   const float* __restrict__ alpha,
                   const float* __restrict__ Ainv,
                   double* __restrict__ partial) {
  static_assert((LO > REG_CLASS_MAX) == (HI > REG_CLASS_MAX),
                "a launch sums in registers or in shared memory");
  const int p = blockIdx.y, tid = threadIdx.x;
  const int cls = tree_class<N>(types, p);
  if (cls < LO || cls > HI) return;  // another launch's block
  extern __shared__ float s_acc[];  // HI > REG_CLASS_MAX: [3 HI][THREADS]
  __shared__ Node nd[N];
  __shared__ float xr[TILE], xc[TILE];
  __shared__ float w[TILE][TILE + 1];  // lower triangle on a diagonal tile
  const Tile tl(blockIdx.x, n, n, true);
  const size_t o = static_cast<size_t>(p) * n;
  const float* Ap = Ainv + o * n;
  load_nodes<N, THREADS>(nd, p, types, params);
  load_points(tl, x + o, x + o, xr, xc);
  for (int q = tid; q < TILE * TILE; q += THREADS) {
    const int r = q >> TILE_LG, c = q & (TILE - 1);
    const int i = tl.I + r, j = tl.J + c;
    float v = 0.0f;
    if (r < tl.rows && c < tl.cols && i >= j) {
      const float fold = (i > j) ? 2.0f : 1.0f;
      v = 0.5f * (alpha[o + i] * alpha[o + j]
                  - Ap[static_cast<size_t>(i) * n + j])
          * fold * (mask[o + i] * mask[o + j]);
    }
    w[r][c] = v;
  }
  __syncthreads();
  double* out = partial + (static_cast<size_t>(p) * gridDim.x + blockIdx.x) * 3 * N;
  bwd_classes<N, LO, HI>(cls, nd, tl, xr, xc, StagedCotangent{w}, s_acc, out);
  for (int q = 3 * cls + tid; q < 3 * N; q += THREADS) out[q] = 0.0;
}

// dparams[p][q] = the tiles' double partials of particle p added in tile
// order, so the result does not depend on the order blocks ran in.
__global__ void reduce_tiles_kernel(int P, int n_parts, int width,
                                    const double* __restrict__ partial,
                                    float* __restrict__ dparams) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= P * width) return;
  const int p = idx / width, q = idx % width;
  const double* src = partial + static_cast<size_t>(p) * n_parts * width + q;
  double s = 0.0;
  for (int t = 0; t < n_parts; ++t) s += src[static_cast<size_t>(t) * width];
  dparams[idx] = static_cast<float>(s);
}

bool n_supported(int n) { return n >= 32 && n <= MAX_N && n % 32 == 0; }

template <int N>
int launch_val(int P, int n, const int* types, const float* params,
               const float* diagv, const float* mask, const float* x,
               const float* ym, float* core, float* ws, float* dws,
               cudaStream_t s) {
  const cudaError_t attr =
      cholblk::set_smem_limit(megalml_val_kernel<N>, sizeof(LmlSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  megalml_val_kernel<N><<<P, ENGINE_THREADS, sizeof(LmlSmem), s>>>(
      n, types, params, diagv, mask, x, ym, core, ws, dws);
  return static_cast<int>(cudaGetLastError());
}

// K1's pass-1 launch of the backward walk for classes LO ... HI.
template <int N>
struct LmlBwdPass {
  int P, n;
  const int* types;
  const float* params;
  const float* mask;
  const float* x;
  const float* alpha;
  const float* Ainv;
  double* partial;
  cudaStream_t s;

  template <int LO, int HI>
  int launch() const {
    return launch_pass<HI>(megalml_bwd_kernel<N, LO, HI>,
                           dim3(n_tiles(n, n, true), P), s, n, types, params,
                           mask, x, alpha, Ainv, partial);
  }
};

template <int N>
int launch_vag(int P, int n, const int* types, const float* params,
               const float* diagv, const float* mask, const float* x,
               const float* ym, float* core, float* dparams, float* gdiag,
               float* alpha, float* ws1, float* ws2, float* dws,
               double* partial, cudaStream_t s) {
  const cudaError_t attr =
      cholblk::set_smem_limit(megalml_vag_kernel<N>, sizeof(LmlSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  megalml_vag_kernel<N><<<P, ENGINE_THREADS, sizeof(LmlSmem), s>>>(
      n, types, params, diagv, mask, x, ym, core, gdiag, alpha, ws1, ws2, dws);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int T = n_tiles(n, n, true);
  const int b = launch_plan<N>(
      static_cast<long>(P) * T,
      LmlBwdPass<N>{P, n, types, params, mask, x, alpha, ws1, partial, s});
  if (b != 0) return b;
  reduce_tiles_kernel<<<(P * 3 * N + 255) / 256, 256, 0, s>>>(P, T, 3 * N,
                                                             partial, dparams);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points.  Every pointer is a contiguous device buffer: types
// int32 [P, N]; params f32 [P, N, 3]; diagv, mask, x, ym f32 [P, n];
// core f32 [P]; dparams f32 [P, N, 3]; gdiag, alpha f32 [P, n]; ws, ws1,
// ws2 f32 [P, n, n]; dws f32 [P, n, 32]; partial f64
// [P, megalml_tiles(n), 3 N].  Return the cudaError_t of the launches
// (0 = success).
extern "C" int megalml_tiles(int n) { return n_tiles(n, n, true); }

extern "C" int megalml_val(int N, int P, int n, const int* types,
                           const float* params, const float* diagv,
                           const float* mask, const float* x, const float* ym,
                           float* core, float* ws, float* dws, void* stream) {
  if (P <= 0 || !n_supported(n)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 7:  return launch_val<7>(P, n, types, params, diagv, mask, x, ym, core, ws, dws, s);
    case 15: return launch_val<15>(P, n, types, params, diagv, mask, x, ym, core, ws, dws, s);
    case 31: return launch_val<31>(P, n, types, params, diagv, mask, x, ym, core, ws, dws, s);
    case 63: return launch_val<63>(P, n, types, params, diagv, mask, x, ym, core, ws, dws, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int megalml_vag(int N, int P, int n, const int* types,
                           const float* params, const float* diagv,
                           const float* mask, const float* x, const float* ym,
                           float* core, float* dparams, float* gdiag,
                           float* alpha, float* ws1, float* ws2, float* dws,
                           double* partial, void* stream) {
  if (P <= 0 || P > 65535 || !n_supported(n))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 7:  return launch_vag<7>(P, n, types, params, diagv, mask, x, ym, core, dparams, gdiag, alpha, ws1, ws2, dws, partial, s);
    case 15: return launch_vag<15>(P, n, types, params, diagv, mask, x, ym, core, dparams, gdiag, alpha, ws1, ws2, dws, partial, s);
    case 31: return launch_vag<31>(P, n, types, params, diagv, mask, x, ym, core, dparams, gdiag, alpha, ws1, ws2, dws, partial, s);
    case 63: return launch_vag<63>(P, n, types, params, diagv, mask, x, ym, core, dparams, gdiag, alpha, ws1, ws2, dws, partial, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
