// Batched X = L^-1 with L L^T = A for SPD A, for Hopper (sm_90a).
//
//   K3  tri_inv_kernel
//       replaces nowcastautogp_tpu/ops/chol_mxu.py::_tri_inv_kernel
//       (tri_inv_fused; the body is tri_inv_body)
//
// One output carries the whole composed LML core (ops/lml.py's InvCoreFn):
// logdet A = -2 sum log diag X, A^-1 = X^T X, alpha = A^-1 ym.
//
// Design.  One block of 256 threads per particle, n a multiple of 32, on
// the engine of chol_blocked.cuh (shared with K1/K2 and K6a/K6b): the
// left-looking blocked Cholesky reads A and writes the factor into the
// per-particle workspace W (no separate copy pass), keeping each diagonal
// factor block's inverse in D (n x 32); the blocked inverse then builds
// XT = L^-T in X, and a last pass transposes it in place.  The TPU kernel
// gave the panel products to its matrix unit; here they are the engine's
// 128 x 32 tiles on the float64 tensor cores (DMMA), which keep the digits
// the composed core's gradient needs on ill-conditioned particles.
//
// What bounds it.  (2/3) n^3 flops a particle against 2 P n^2 floats moved,
// so its floor is arithmetic (0.380 ms at P = 200, n = 576 on the FP32
// peak; the float64 tensor cores' peak, 67 TFLOP/s, is the same).  The
// products run with the next k chunk's loads in flight; what stays serial
// is warp 0's 32 x 32 diagonal factor and inverse per panel (n / 32 of
// them) and the substitutions, which the second block on the SM (54 KB of
// shared memory and at most 128 registers a block) overlaps.  200 particles fill 200 of the 264 block slots, so 68
// SMs carry two.  Everything is per particle, so the result is
// deterministic.
//
// A non-positive pivot makes sqrtf return NaN (a zero one, inf and then
// NaN); it spreads through that particle's W, D and X only, and the
// caller's -1e10 guard rejects the particle.

#include "chol_blocked.cuh"

namespace {

using namespace cholblk;

constexpr int MAX_N = 1024;

__global__ void __launch_bounds__(THREADS, 2)
tri_inv_kernel(int n, const float* __restrict__ A, float* __restrict__ X,
               float* __restrict__ Wk, float* __restrict__ Dk) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem& sm = *reinterpret_cast<Smem*>(smem);
  const size_t nn = static_cast<size_t>(n) * n;
  const size_t p = blockIdx.x;
  float* W = Wk + p * nn;
  float* Xp = X + p * nn;
  blocked_cholesky(sm, A + p * nn, W, Dk + p * n * B, n, nullptr);
  blocked_tri_inverse(sm, W, Dk + p * n * B, Xp, n);
  upper_to_lower(sm, Xp, n);
}

}  // namespace

// C entry point.  A, X, ws f32 [P, n, n] and dws f32 [P, n, 32], contiguous
// device buffers; A is read only, ws and dws are scratch.  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int tri_inv(int P, int n, const float* A, float* X, float* ws,
                       float* dws, void* stream) {
  if (P <= 0 || n < B || n > MAX_N || n % B != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = set_smem_limit(tri_inv_kernel, sizeof(Smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  tri_inv_kernel<<<P, THREADS, sizeof(Smem), static_cast<cudaStream_t>(stream)>>>(
      n, A, X, ws, dws);
  return static_cast<int>(cudaGetLastError());
}
