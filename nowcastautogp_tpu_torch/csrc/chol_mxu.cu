// Batched X = L^-1 with L L^T = A for SPD A, for Hopper (sm_90a).
//
//   K3  tri_inv_kernel
//       replaces nowcastautogp_tpu/ops/chol_mxu.py::_tri_inv_kernel
//       (tri_inv_fused; the body is tri_inv_body)
//
// One output carries the whole composed LML core (ops/lml.py's InvCoreFn):
// logdet A = -2 sum log diag X, A^-1 = X^T X, alpha = A^-1 ym.
//
// Design.  One block of 256 threads per particle, n a multiple of 32.  The
// factor is built in a per-particle workspace W (a copy of A) by the
// blocked right-looking Cholesky of chol_blocked.cuh (shared with K6a/K6b),
// which keeps each diagonal factor block's inverse in the workspace D
// (n x 32); then the blocked triangular inverse runs in place in X
// (initialised to I).  The trailing downdates and the inverse updates are
// the O(n^3) work: 64 x 64 output tiles with K = 32 in FP32 FMAs.  Where
// the TPU kernel gave these products to its matrix unit, this kernel
// computes them itself.
//
// What bounds it.  (2/3) n^3 flops a particle against 2 P n^2 floats moved,
// so its floor is arithmetic.  With one block per particle the diagonal
// steps are serial latency (2 x 32 dependent steps on one warp per panel,
// n / 32 panels), and every block barrier idles the other warps; the tiled
// products run from shared memory at a 4 x 4 register tile, well below the
// FP32 peak.  Everything is per particle, so the result is deterministic.
//
// A non-positive pivot makes sqrtf return NaN (a zero one, inf and then
// NaN); it spreads through that particle's W, D and X only, and the
// caller's -1e10 guard rejects the particle.

#include "chol_blocked.cuh"

namespace {

using namespace cholblk;

constexpr int MAX_N = 1024;

__global__ void __launch_bounds__(THREADS)
tri_inv_kernel(int n, const float* __restrict__ A, float* __restrict__ X,
               float* __restrict__ Wk, float* __restrict__ Dk) {
  __shared__ Smem sm;
  const int p = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t nn = static_cast<size_t>(n) * n;
  const float* Ap = A + p * nn;
  float* Xp = X + p * nn;
  float* W = Wk + p * nn;
  float* D = Dk + static_cast<size_t>(p) * n * B;

  for (int i = warp; i < n; i += WARPS) {
    const size_t o = static_cast<size_t>(i) * n;
    for (int j = lane; j < n; j += 32) {
      W[o + j] = Ap[o + j];
      Xp[o + j] = (i == j) ? 1.0f : 0.0f;
    }
  }
  __syncthreads();
  blocked_cholesky<false>(sm, W, D, n);
  blocked_tri_inverse(sm, W, D, Xp, n);
}

}  // namespace

// C entry point.  A, X, ws f32 [P, n, n] and dws f32 [P, n, 32], contiguous
// device buffers; A is read only, ws and dws are scratch.  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int tri_inv(int P, int n, const float* A, float* X, float* ws,
                       float* dws, void* stream) {
  if (P <= 0 || n < B || n > MAX_N || n % B != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  tri_inv_kernel<<<P, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      n, A, X, ws, dws);
  return static_cast<int>(cudaGetLastError());
}
