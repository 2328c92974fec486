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
// any square tile.  The kernels are covtile.cuh's, shared with K4/K5
// (megacov.cu), which says what bounds them and how they are laid out.
// Here: 32 x 32 tiles (at n = 160 the symmetric path walks 12,880 elements
// instead of 25,600), one class-switched launch for the forward; for the
// VJP, two class-switched launches (register and shared-memory
// accumulators) on the "pallas" fit's grids (n <= 160 at P = 200), one
// launch per heap class on grids of CLASS_LAUNCH_BLOCKS or more (n >= 192
// at P = 200).

#include "covtile.cuh"

namespace {

constexpr int MAX_N = 512;

bool shape_ok(int P, int n, int m, int s1, int s2, int sym, const float* x1,
              const float* x2) {
  return P > 0 && P <= 65535 && n >= 1 && n <= MAX_N && m >= 1 &&
         m <= MAX_N && (s1 == 0 || s1 == n) && (s2 == 0 || s2 == m) &&
         (!sym || (n == m && s1 == s2 && x1 == x2));
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
  const CovArgs a{P, n, m, s1, s2, sym, types, params, x1, x2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 7:  return launch_fwd<7>(a, K, s);
    case 15: return launch_fwd<15>(a, K, s);
    case 31: return launch_fwd<31>(a, K, s);
    case 63: return launch_fwd<63>(a, K, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int cov_bwd(int N, int P, int n, int m, int s1, int s2, int sym,
                       const int* types, const float* params, const float* x1,
                       const float* x2, const float* dK, float* dparams,
                       float* partial, void* stream) {
  if (!shape_ok(P, n, m, s1, s2, sym, x1, x2))
    return static_cast<int>(cudaErrorInvalidValue);
  const CovArgs a{P, n, m, s1, s2, sym, types, params, x1, x2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 7:  return launch_bwd<7>(a, dK, dparams, partial, s);
    case 15: return launch_bwd<15>(a, dK, dparams, partial, s);
    case 31: return launch_bwd<31>(a, dK, dparams, partial, s);
    case 63: return launch_bwd<63>(a, dK, dparams, partial, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
