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
// factor is built in a per-particle workspace W (a copy of A) by a blocked
// right-looking Cholesky with 32-wide panels:
//   1. the 32 x 32 diagonal block is factored and inverted in shared memory
//      by warp 0 (32 sequential column steps, then one forward substitution
//      per lane); the inverse is kept in the workspace D (n x 32);
//   2. panel solve: L_panel = W_panel Dinv^T, one warp per row;
//   3. trailing downdate W -= L_panel L_panel^T over the lower 64 x 64 tiles.
// Then the blocked triangular inverse runs in place in X (initialised to
// I): row block k becomes Dinv_k X[rows k], and the rows below take
// X -= L[:, panel k] X[rows k].  Steps 3 and the inverse update are the
// O(n^3) work: 64 x 64 output tiles with K = 32, both operands staged in
// shared memory, 4 x 4 register tile a thread, FP32 FMAs on the CUDA cores
// (TF32 would lose the digits the LML needs).  Where the TPU kernel gave
// these products to its matrix unit, this kernel computes them itself.
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

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int B = 32;        // panel width
constexpr int T = 64;        // output tile of the products
constexpr int MAX_N = 1024;

struct Smem {
  float d[B][B + 1];         // diagonal block, then its factor
  float di[B][B + 1];        // inverse of the diagonal factor
  float a[B][T + 1];         // a[k][r] = left operand (T rows, K = 32)
  float b[B][T + 1];         // b[k][c] = right operand (K = 32, T cols)
};

// c[r][c] -= sum_k a[k][r] b[k][c] for the tile at (I, J) of M (row stride
// n), rows < row_end and columns < col_end.  Thread (ty, tx) owns rows
// ty + 16 ii and columns tx + 16 jj.
__device__ __forceinline__ void tile_update(Smem& sm, float* M, int n, int I,
                                            int J, int row_end, int col_end) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = 0.0f;
#pragma unroll 8
  for (int k = 0; k < B; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) av[ii] = sm.a[k][ty + 16 * ii];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) bv[jj] = sm.b[k][tx + 16 * jj];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = fmaf(av[ii], bv[jj], acc[ii][jj]);
  }
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int i = I + ty + 16 * ii;
    if (i >= row_end) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = J + tx + 16 * jj;
      if (j < col_end) M[static_cast<size_t>(i) * n + j] -= acc[ii][jj];
    }
  }
}

// a[k][r] = S[(R0 + r) * n + C0 + k]: T rows of a 32-wide column panel,
// transposed into shared memory (rows past row_end read as 0).
__device__ __forceinline__ void load_panel_t(float (&dst)[B][T + 1],
                                             const float* S, int n, int R0,
                                             int C0, int row_end) {
  for (int e = threadIdx.x; e < T * B; e += THREADS) {
    const int r = e / B, k = e % B;
    dst[k][r] = (R0 + r < row_end) ? S[static_cast<size_t>(R0 + r) * n + C0 + k]
                                   : 0.0f;
  }
}

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
  const int nb = n / B;

  for (int i = warp; i < n; i += WARPS) {
    const size_t o = static_cast<size_t>(i) * n;
    for (int j = lane; j < n; j += 32) {
      W[o + j] = Ap[o + j];
      Xp[o + j] = (i == j) ? 1.0f : 0.0f;
    }
  }
  __syncthreads();

  // ---- phase 1: blocked right-looking Cholesky
  for (int kb = 0; kb < nb; ++kb) {
    const int s = kb * B, t = s + B;
    for (int e = tid; e < B * B; e += THREADS) {
      const int i = e / B, j = e % B;
      sm.d[i][j] = W[static_cast<size_t>(s + i) * n + s + j];
    }
    __syncthreads();
    if (warp == 0) {
      // factor: lane i owns row i
      for (int j = 0; j < B; ++j) {
        const float dj = sqrtf(sm.d[j][j]);
        __syncwarp();
        if (lane == j) sm.d[j][j] = dj;
        if (lane > j) sm.d[lane][j] = sm.d[lane][j] / dj;
        __syncwarp();
        if (lane > j) {
          const float lij = sm.d[lane][j];
          for (int c = j + 1; c <= lane; ++c) sm.d[lane][c] -= lij * sm.d[c][j];
        }
        __syncwarp();
      }
      // invert: lane c owns column c (forward substitution)
      float xc[B];
#pragma unroll
      for (int i = 0; i < B; ++i) {
        float v = (i == lane) ? 1.0f : 0.0f;
#pragma unroll
        for (int k = 0; k < i; ++k) v -= sm.d[i][k] * xc[k];
        xc[i] = v / sm.d[i][i];
      }
#pragma unroll
      for (int i = 0; i < B; ++i) sm.di[i][lane] = xc[i];
      __syncwarp();
    }
    __syncthreads();
    for (int e = tid; e < B * B; e += THREADS) {
      const int i = e / B, j = e % B;
      D[static_cast<size_t>(s + i) * B + j] = sm.di[i][j];
    }
    if (t >= n) break;
    // panel solve: L[i][s + c] = sum_k W[i][s + k] Dinv[c][k], one warp a row
    for (int i = t + warp; i < n; i += WARPS) {
      float* row = W + static_cast<size_t>(i) * n + s;
      const float w = row[lane];
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < B; ++k)
        acc = fmaf(__shfl_sync(0xffffffffu, w, k), sm.di[lane][k], acc);
      row[lane] = acc;
    }
    __syncthreads();
    // trailing downdate of the lower tiles: W[t:, t:] -= Lp Lp^T
    const int nt = (n - t + T - 1) / T;
    for (int a = 0; a < nt; ++a) {
      for (int b = 0; b <= a; ++b) {
        const int I = t + a * T, J = t + b * T;
        load_panel_t(sm.a, W, n, I, s, n);
        load_panel_t(sm.b, W, n, J, s, n);
        __syncthreads();
        tile_update(sm, W, n, I, J, n, n);
        __syncthreads();
      }
    }
  }

  // ---- phase 2: blocked triangular inverse, in place in X (= I on entry)
  __syncthreads();
  for (int kb = 0; kb < nb; ++kb) {
    const int s = kb * B, w = s + B;
    for (int e = tid; e < B * B; e += THREADS) {
      const int i = e / B, j = e % B;
      sm.di[i][j] = D[static_cast<size_t>(s + i) * B + j];
    }
    __syncthreads();
    // rows s..s+31: X[s + r][c] = sum_k Dinv[r][k] X[s + k][c], c < w
    for (int j0 = 0; j0 < w; j0 += T) {
      for (int e = tid; e < B * T; e += THREADS) {
        const int k = e / T, c = e % T;
        sm.b[k][c] = (j0 + c < w) ? Xp[static_cast<size_t>(s + k) * n + j0 + c]
                                  : 0.0f;
      }
      __syncthreads();
      const int c = tid % T, r0 = tid / T;
      for (int r = r0; r < B; r += THREADS / T) {
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < B; ++k) acc = fmaf(sm.di[r][k], sm.b[k][c], acc);
        if (j0 + c < w) Xp[static_cast<size_t>(s + r) * n + j0 + c] = acc;
      }
      __syncthreads();
    }
    if (w >= n) break;
    // rows below: X[w:, :w] -= L[w:, s:s+32] X[s:s+32, :w]
    const int nr = (n - w + T - 1) / T, nc = (w + T - 1) / T;
    for (int a = 0; a < nr; ++a) {
      for (int b = 0; b < nc; ++b) {
        const int I = w + a * T, J = b * T;
        load_panel_t(sm.a, W, n, I, s, n);
        for (int e = tid; e < B * T; e += THREADS) {
          const int k = e / T, c = e % T;
          sm.b[k][c] = (J + c < w) ? Xp[static_cast<size_t>(s + k) * n + J + c]
                                   : 0.0f;
        }
        __syncthreads();
        tile_update(sm, Xp, n, I, J, n, w);
        __syncthreads();
      }
    }
  }
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
