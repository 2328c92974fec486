// Batched Cholesky solve and triangular inverse for the masked LML core of
// the "pallas" LML backend, for Hopper (sm_90a).  Two kernels:
//
//   K6a  chol_solve_kernel   L with L L^T = K, and alpha = K^-1 ym
//        replaces nowcastautogp_tpu/ops/pallas_chol.py::_chol_solve_kernel
//   K6b  tri_inverse_kernel  X = L^-1 from a Cholesky factor L
//        replaces nowcastautogp_tpu/ops/pallas_chol.py::_tri_inverse_kernel
//
// ops/chol.py's lml_core runs K6a in the forward (logdet from diag L, the
// quadratic form from alpha) and K6b in the backward, where
// K^-1 = X^T X and dK = (alpha alpha^T - K^-1) / 2.  K carries the masked-
// identity contract of ops/lml.py, so masked rows factor to identity rows.
//
// Design.  One block of 256 threads per particle, n a multiple of 32 up to
// 2048, on the blocked engine of chol_blocked.cuh (shared with K3 and
// K1/K2):
//   K6a factors K into L with the left-looking blocked Cholesky, storing
//       the factored diagonal blocks and each one's inverse Dinv_k
//       (workspace D, n x 32), with the forward solve riding along on a
//       right-hand side held in shared memory (z_k = L_kk^-1 r_k by
//       substitution, then the panel solve pushes r_i -= L[i, block k] z_k
//       into the rows below);
//       then it zeroes the strict upper triangle and runs the engine's
//       blocked back substitution for alpha = L^-T r.
//   K6b inverts each diagonal block of L (warp 0) into D, then runs the
//       blocked inverse of K3 from L's panels into X as XT = L^-T and
//       transposes it in place.
// The TPU kernels kept a whole chunk of particles in VMEM and swept it with
// one-hot masked vector ops; here a particle is a block and the panel
// products are the engine's 128 x 32 tiles on the float64 tensor cores.
//
// What bounds them.  K6a does n^3 / 3 flops of factorisation and 2 n^2 of
// solves a particle against P (n^2 + 2 n) floats read and written, K6b
// n^3 / 3 against 2 P n^2: both are arithmetic-bound on paper; at the
// "pallas" path's n = 160 a particle is five panels, so warp 0's serial
// 32 x 32 diagonal steps and the block barriers are most of the time.
// Everything is per particle in a fixed order, so both kernels are
// deterministic.
//
// A non-positive pivot makes sqrtf return NaN; it spreads through that
// particle's L, alpha and X only, and the caller's -1e10 guard rejects it.

#include "chol_blocked.cuh"

namespace {

using namespace cholblk;

constexpr int MAX_N = 2048;

__global__ void __launch_bounds__(THREADS, 2)
chol_solve_kernel(int n, const float* __restrict__ K,
                  const float* __restrict__ ym, float* __restrict__ L,
                  float* __restrict__ alpha, float* __restrict__ Dk) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem& sm = *reinterpret_cast<Smem*>(smem);
  __shared__ float r[MAX_N];
  const int p = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t nn = static_cast<size_t>(n) * n;
  float* Lp = L + p * nn;
  float* D = Dk + static_cast<size_t>(p) * n * B;

  for (int i = tid; i < n; i += THREADS) r[i] = ym[static_cast<size_t>(p) * n + i];
  __syncthreads();
  blocked_cholesky(sm, K + p * nn, Lp, D, n, r);  // r = L^-1 ym
  for (int i = warp; i < n; i += WARPS) {
    const size_t o = static_cast<size_t>(i) * n;
    for (int j = i + 1 + lane; j < n; j += 32) Lp[o + j] = 0.0f;
  }
  __syncthreads();

  back_substitute(sm, Lp, r, n);  // r = L^-T L^-1 ym
  for (int i = tid; i < n; i += THREADS) alpha[static_cast<size_t>(p) * n + i] = r[i];
}

__global__ void __launch_bounds__(THREADS, 2)
tri_inverse_kernel(int n, const float* __restrict__ L, float* __restrict__ X,
                   float* __restrict__ Dk) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem& sm = *reinterpret_cast<Smem*>(smem);
  const int p = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t nn = static_cast<size_t>(n) * n;
  const float* Lp = L + p * nn;
  float* Xp = X + p * nn;
  float* D = Dk + static_cast<size_t>(p) * n * B;
  const int nb = n / B;

  for (int kb = 0; kb < nb; ++kb) {
    const int s = kb * B;
    for (int e = tid; e < B * B; e += THREADS) {
      const int i = e / B, j = e % B;
      sm.d[i][j] = Lp[static_cast<size_t>(s + i) * n + s + j];
    }
    __syncthreads();
    if (warp == 0) diag_invert(sm, lane);
    __syncthreads();
    for (int e = tid; e < B * B; e += THREADS) {
      const int i = e / B, j = e % B;
      D[static_cast<size_t>(s + i) * B + j] = sm.di[i][j];
    }
  }
  blocked_tri_inverse(sm, Lp, D, Xp, n);
  upper_to_lower(sm, Xp, n);
}

bool n_supported(int n) { return n >= B && n <= MAX_N && n % B == 0; }

}  // namespace

// C entry points.  K, L, X f32 [P, n, n]; ym, alpha f32 [P, n]; dws f32
// [P, n, 32] scratch; all contiguous device buffers.  Return the
// cudaError_t of the launch (0 = success).
extern "C" int chol_solve(int P, int n, const float* K, const float* ym,
                          float* L, float* alpha, float* dws, void* stream) {
  if (P <= 0 || !n_supported(n)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = set_smem_limit(chol_solve_kernel, sizeof(Smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  chol_solve_kernel<<<P, THREADS, sizeof(Smem), static_cast<cudaStream_t>(stream)>>>(
      n, K, ym, L, alpha, dws);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int chol_tri_inverse(int P, int n, const float* L, float* X,
                                float* dws, void* stream) {
  if (P <= 0 || !n_supported(n)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = set_smem_limit(tri_inverse_kernel, sizeof(Smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  tri_inverse_kernel<<<P, THREADS, sizeof(Smem), static_cast<cudaStream_t>(stream)>>>(
      n, L, X, dws);
  return static_cast<int>(cudaGetLastError());
}
