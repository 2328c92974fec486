// Blocked Cholesky pieces shared by the triangular-inverse kernel K3
// (chol_mxu.cu) and the Cholesky solve / triangular inverse kernels K6a/K6b
// (chol.cu).  One block of THREADS threads works on one particle's n x n
// matrix (row-major, n a multiple of B) in device memory; shared memory
// holds one 32 x 32 diagonal block, its inverse and the two operands of a
// 64 x 64 product tile.
//
//   blocked_cholesky     right-looking Cholesky with 32-wide panels, in
//                        place: the 32 x 32 diagonal block is factored and
//                        inverted by warp 0 (32 sequential column steps,
//                        then one forward substitution per lane) and the
//                        inverse is kept in D (n x 32); panel solve
//                        L_panel = W_panel Dinv^T, one warp a row; trailing
//                        downdate W -= L_panel L_panel^T over lower tiles.
//   blocked_tri_inverse  X = L^-1 in place in X (= I on entry): row block k
//                        becomes Dinv_k X[rows k], the rows below take
//                        X -= L[:, panel k] X[rows k].
//
// The O(n^3) work is the 64 x 64 output tiles with K = 32: both operands
// staged in shared memory, a 4 x 4 register tile a thread, FP32 FMAs on
// the CUDA cores (TF32 would lose the digits the LML needs).  Everything is
// per particle, so results are deterministic.  A non-positive pivot makes
// sqrtf return NaN (a zero one, inf and then NaN); it spreads through that
// particle's buffers only.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace cholblk {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int B = 32;        // panel width
constexpr int T = 64;        // output tile of the products

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

// Warp 0: factor sm.d in place, lane i owning row i (only entries on and
// below the diagonal are read or written).
__device__ __forceinline__ void diag_factor(Smem& sm, int lane) {
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
}

// Warp 0: sm.di = inverse of the lower-triangular factor in sm.d, lane c
// owning column c (forward substitution).
__device__ __forceinline__ void diag_invert(Smem& sm, int lane) {
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

// Cholesky of W in place.  D (n x 32) gets the inverse of each diagonal
// factor block.  Below the diagonal blocks W holds the factor; with
// WRITE_DIAG the factored diagonal blocks (zero above their diagonal) are
// stored too, else W keeps their downdated input.  Entries above the
// diagonal outside the diagonal blocks are left as scratch.
template <bool WRITE_DIAG>
__device__ __forceinline__ void blocked_cholesky(Smem& sm, float* W, float* D,
                                                 int n) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = n / B;
  for (int kb = 0; kb < nb; ++kb) {
    const int s = kb * B, t = s + B;
    for (int e = tid; e < B * B; e += THREADS) {
      const int i = e / B, j = e % B;
      sm.d[i][j] = W[static_cast<size_t>(s + i) * n + s + j];
    }
    __syncthreads();
    if (warp == 0) {
      diag_factor(sm, lane);
      diag_invert(sm, lane);
    }
    __syncthreads();
    for (int e = tid; e < B * B; e += THREADS) {
      const int i = e / B, j = e % B;
      D[static_cast<size_t>(s + i) * B + j] = sm.di[i][j];
      if (WRITE_DIAG)
        W[static_cast<size_t>(s + i) * n + s + j] = (j <= i) ? sm.d[i][j] : 0.0f;
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
}

// X = L^-1 in place in X (= I on entry), from the factor's panels below
// the diagonal blocks of W and the diagonal blocks' inverses in D.
__device__ __forceinline__ void blocked_tri_inverse(Smem& sm, const float* W,
                                                    const float* D, float* Xp,
                                                    int n) {
  const int tid = threadIdx.x;
  const int nb = n / B;
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

}  // namespace cholblk
