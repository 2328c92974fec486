// Batched covariance of heap-encoded kernel trees and its VJP, for Hopper
// (sm_90a):
//
//   K4  megacov_fwd  K(x_p, x_p) for P heterogeneous trees, 8 <= n <= 4096
//       replaces nowcastautogp_tpu/ops/pallas_megacov.py::_cov_fwd_kernel
//   K5  megacov_bwd  dK -> dparams by a recomputed walk
//       replaces nowcastautogp_tpu/ops/pallas_megacov.py::_cov_bwd_kernel
//
// They carry the composed LML path (capacities above K1/K2's 512) and the
// K(x, x) plane of the predictive and the nowcast.  The envelope ends at
// n = 4096 (11 years of days): 8,256 lower tiles a particle in gridDim.x,
// P <= 65,535 in gridDim.y, every offset into K, dK and partial a size_t
// (covtile.cuh), and K5's partial P x tiles x 3 N floats (614 MB at
// P = 200, N = 31).  The JAX package ends its kernel at 2048 and runs its
// interpreter beyond; the port runs the same tiles there.
//
// They are the symmetric path of covtile.cuh's kernels, the ones K7F/K7B
// run, with per-particle points x (row stride n): lower 32 x 32 tiles only,
// each tree walked as far as its heap class, the nodes re-read per element,
// the VJP folding the cotangent as the TPU kernel does (pallas_megacov.py:
// 852-858) and summing its tile partials in a fixed order.  So K4 is the
// same float function as K7F's symmetric path and K1/K2's covariance.  The
// TPU kernel's chunk flags, structure sort and tiled/untiled split have no
// role.  The daily fit's K5 grids (P x tiles, 34,200 blocks at P = 200,
// n = 576) are past covtile.cuh's CLASS_LAUNCH_BLOCKS, so it runs one
// launch per heap class, each class body at its own register count (48 for classes 1 and
// 3 against 124 for one class-switched launch of classes up to 15); K4
// keeps one class-switched launch (54 registers at N = 31), where
// per-class launches' idle blocks cost more than the registers saved.
// The tile edge and both plans were chosen by ablate_megacov.py (PERF.md).

#include "covtile.cuh"

namespace {

constexpr int MAX_N = 4096;

bool shape_ok(int P, int n) {
  return P > 0 && P <= 65535 && n >= 8 && n <= MAX_N && n % 8 == 0;
}

}  // namespace

// C entry points.  Every pointer is a contiguous device buffer: types
// int32 [P, N]; params f32 [P, N, 3]; x f32 [P, n]; K, dK f32 [P, n, n];
// dparams f32 [P, N, 3]; partial f32 [P, megacov_tiles(n), 3 N] scratch.
// Return the cudaError_t of the launches (0 = success).
extern "C" int megacov_tiles(int n) { return n_tiles(n, n, true); }

extern "C" int megacov_fwd(int N, int P, int n, const int* types,
                           const float* params, const float* x, float* K,
                           void* stream) {
  if (!shape_ok(P, n)) return static_cast<int>(cudaErrorInvalidValue);
  const CovArgs a{P, n, n, n, n, 1, types, params, x, x};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 7:  return launch_fwd<7>(a, K, s);
    case 15: return launch_fwd<15>(a, K, s);
    case 31: return launch_fwd<31>(a, K, s);
    case 63: return launch_fwd<63>(a, K, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int megacov_bwd(int N, int P, int n, const int* types,
                           const float* params, const float* x,
                           const float* dK, float* dparams, float* partial,
                           void* stream) {
  if (!shape_ok(P, n)) return static_cast<int>(cudaErrorInvalidValue);
  const CovArgs a{P, n, n, n, n, 1, types, params, x, x};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 7:  return launch_bwd<7>(a, dK, dparams, partial, s);
    case 15: return launch_bwd<15>(a, dK, dparams, partial, s);
    case 31: return launch_bwd<31>(a, dK, dparams, partial, s);
    case 63: return launch_bwd<63>(a, dK, dparams, partial, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
