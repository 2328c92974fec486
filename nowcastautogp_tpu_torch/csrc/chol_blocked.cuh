// Blocked Cholesky engine shared by the triangular-inverse kernel K3
// (chol_mxu.cu), the Cholesky solve / triangular inverse kernels K6a/K6b
// (chol.cu) and the fused LML kernels K1/K2 (megalml.cu).  One block of
// THREADS threads works on one particle's n x n matrix (row-major, n a
// multiple of B) in device memory.
//
//   blocked_cholesky     left-looking Cholesky with 32-wide panels: panel k
//                        takes W[s:, s:s+32] -= L[s:, :s] L[s:s+32, :s]^T in
//                        one product per 128 rows, from -src (read from
//                        src, written to W); warp 0 factors and inverts the
//                        32 x 32 diagonal block (inverse kept in D, n x 32);
//                        L_panel L_kk^T = W_panel is solved by substitution,
//                        one lane a row; an optional right-hand side r
//                        becomes L^-1 r alongside.
//   back_substitute      a = L^-T a, by blocks.
//   blocked_tri_inverse  XT = L^-T (upper) in XT: panel k's columns of XT
//                        are -(XT[:s, :s] L[s:s+32, :s]^T) L_kk^-T (the same
//                        substitution), its diagonal block Dinv_k^T.
//   lower_gram           the lower triangle of XT XT^T (A^-1 for K1).
//   upper_to_lower       XT in place -> X = XT^T, zero above the diagonal.
//
// Every O(n^3) step is one primitive, product: a 128 x 32 output tile
// C[r][c] = sum_k a_r[k] b_c[k] of two row-major operands whose rows are
// contiguous in k (so every load is a 16-byte run), on the float64 tensor
// cores (DMMA, mma.sync m8n8k4), with the output in registers over the
// whole k range.  Each 32-wide k chunk is loaded into registers while the
// previous one is multiplied, and staged as doubles in shared memory.
// Left-looking, each panel is written once per factorisation instead of
// the trailing matrix once per panel.
//   Precision: the float operands are exact in double and the sums run in
// double.  On an ill-conditioned particle the Cholesky downdate cancels
// almost all of each entry down to the small pivots, and L^-1 and A^-1
// cancel as much; every float32 order tried (from zero, 32-term partial
// sums, from -a one term at a time, a double diagonal block only) left
// some particle an order of magnitude less accurate than float32
// cuSOLVER.  TF32 would be worse still.
//   Everything is per particle in a fixed order, so results are
// deterministic.  A non-positive pivot makes sqrtf return NaN (a zero
// one, inf and then NaN); it spreads through that particle's buffers only.
//
// Smem is about 54 KB, so a kernel takes it as dynamic shared memory, after
// set_smem_limit (cudaFuncSetAttribute) for that kernel; with at most 128
// registers a thread two blocks fit on an SM.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace cholblk {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int B = 32;        // panel width and k chunk
constexpr int MT = 128;      // rows of a product tile
constexpr int LD = B + 4;    // row stride of the staged tile, in doubles

struct Smem {
  double a[MT][LD];          // one k chunk of the product's left rows
  double b[B][LD];           // and of its right rows, as doubles
  float d[B][B + 1];         // diagonal block, then its factor
  float di[B][B + 1];        // inverse of the diagonal factor
  float z[B];                // this panel's block of L^-1 r
};

// Allows `kernel` the dynamic shared memory it asks for on the current
// device.  The attribute is per device, so a launcher sets it before every
// launch (a call costs microseconds) rather than once per process.
template <typename Kernel>
cudaError_t set_smem_limit(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

__device__ __forceinline__ void dmma(double (&c)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, "
      "{%0, %1};\n"
      : "+d"(c[0]), "+d"(c[1])
      : "d"(a), "d"(b));
}

// acc[mt][nt][h] += sum_{k0 <= k < k1} a_r[k] b_c[k] for the rows
// r = 16 warp + 8 mt + g of a (row 0 = matrix row R0, `rows` of them valid,
// the others zero) and the columns c = 8 nt + 2 q + h (g = lane / 4,
// q = lane % 4) of the B rows b; k0 and k1 are multiples of B.  upper:
// the left matrix is upper triangular (XT), and row R reads as zero in
// every k chunk that ends at or before its own 32-row block (entries there
// are never written).  Called by the whole block.
__device__ __forceinline__ void product(Smem& sm, const float* a, int R0,
                                        int rows, bool upper, const float* b,
                                        int n, int k0, int k1,
                                        double (&acc)[2][4][2]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  constexpr int PER = (MT + B) * (B / 4) / THREADS;   // float4s a thread
  float4 pre[PER];
  auto fetch = [&](int k) {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int e = tid + THREADS * u, r = e >> 3, c = (e & 7) * 4;
      if (r < MT) {
        const bool ok = r < rows && !(upper && R0 + r >= k + B);
        pre[u] = ok ? *reinterpret_cast<const float4*>(
                          a + static_cast<size_t>(r) * n + k + c)
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      } else {
        pre[u] = *reinterpret_cast<const float4*>(
            b + static_cast<size_t>(r - MT) * n + k + c);
      }
    }
  };
  __syncthreads();  // the tile may still be read by the previous step
  fetch(k0);
  for (int k = k0; k < k1; k += B) {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int e = tid + THREADS * u, r = e >> 3, c = (e & 7) * 4;
      double* d = (r < MT) ? &sm.a[r][c] : &sm.b[r - MT][c];
      reinterpret_cast<double2*>(d)[0] = make_double2(pre[u].x, pre[u].y);
      reinterpret_cast<double2*>(d)[1] = make_double2(pre[u].z, pre[u].w);
    }
    __syncthreads();
    if (k + B < k1) fetch(k + B);  // in flight while this chunk multiplies
#pragma unroll
    for (int kk = 0; kk < B; kk += 4) {
      double af[2], bf[4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) af[mt] = sm.a[16 * warp + 8 * mt + g][kk + q];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) bf[nt] = sm.b[8 * nt + g][kk + q];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) dmma(acc[mt][nt], af[mt], bf[nt]);
    }
    __syncthreads();
  }
}

// Warp 0: factor sm.d in place, lane i holding row i in registers (only
// entries on and below the diagonal are read or written); column j of the
// factor reaches the other lanes by shuffles, so the 32 steps need no
// shared-memory round trip and each step's updates are independent FMAs.
__device__ __forceinline__ void diag_factor(Smem& sm, int lane) {
  float a[B];
#pragma unroll
  for (int c = 0; c < B; ++c) a[c] = sm.d[lane][c];
#pragma unroll
  for (int j = 0; j < B; ++j) {
    const float dj = sqrtf(__shfl_sync(0xffffffffu, a[j], j));
    a[j] = (lane == j) ? dj : a[j] / dj;
#pragma unroll
    for (int c = j + 1; c < B; ++c) {
      const float lcj = __shfl_sync(0xffffffffu, a[j], c);
      if (lane >= c) a[c] = fmaf(-a[j], lcj, a[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < B; ++c)
    if (c <= lane) sm.d[lane][c] = a[c];
  __syncwarp();
}

// Warp 0: sm.di = inverse of the lower-triangular factor in sm.d, lane c
// owning column c (forward substitution; exact zeros above the diagonal).
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

// Solves x L_kk^T = M[i][s:s+32] for rows r0 <= i < r1 by substitution
// with the factored diagonal block in sm.d, one lane a row (backward
// stable, unlike a product with the block's inverse on ill-conditioned
// blocks), and writes x over it; with r, also r[i] -= x . z.
__device__ __forceinline__ void panel_solve(Smem& sm, float* M, int n, int s,
                                            int r0, int r1, float* r) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i0 = r0 + warp * 32; i0 < r1; i0 += THREADS) {
    const int i = i0 + lane;
    if (i >= r1) continue;
    float4* row = reinterpret_cast<float4*>(M + static_cast<size_t>(i) * n + s);
    float x[B];
#pragma unroll
    for (int q = 0; q < B / 4; ++q) {
      const float4 v = row[q];
      x[4 * q] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int c = 0; c < B; ++c) {
      float v = x[c];
#pragma unroll
      for (int k = 0; k < c; ++k) v = fmaf(-x[k], sm.d[c][k], v);
      x[c] = v / sm.d[c][c];
    }
#pragma unroll
    for (int q = 0; q < B / 4; ++q)
      row[q] = make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
    if (r != nullptr) {  // one term at a time, as an unblocked solve runs
      float v = r[i];
#pragma unroll
      for (int c = 0; c < B; ++c) v = fmaf(-x[c], sm.z[c], v);
      r[i] = v;
    }
  }
}

// Cholesky of src into W (src == W: in place).  Row i of the result holds
// the factor in columns below its diagonal block and the factored diagonal
// block (zero above its diagonal); D (n x 32) gets each diagonal factor
// block's inverse.  Entries above the diagonal blocks are never read or
// written.  With r (n floats), r becomes L^-1 r: block k is solved by
// substitution with L_kk (warp 0) and pushed into the rows below by the
// panel solve.
__device__ __forceinline__ void blocked_cholesky(Smem& sm, const float* src,
                                                 float* W, float* D, int n,
                                                 float* r) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int s = 0; s < n; s += B) {
    // panel downdate W[i][s + c] = src[i][s + c] - L[i, :s] . L[s + c, :s]
    // for rows i >= s, accumulated in float64 from -src
    for (int R0 = s; R0 < n; R0 += MT) {
      double acc[2][4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int i = R0 + 16 * warp + 8 * mt + (lane >> 2);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = 0.0;
        if (i >= n) continue;
        const float* in = src + static_cast<size_t>(i) * n + s;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            acc[mt][nt][h] = -static_cast<double>(in[8 * nt + 2 * (lane & 3) + h]);
      }
      if (s > 0)
        product(sm, W + static_cast<size_t>(R0) * n, R0, n - R0, false,
                W + static_cast<size_t>(s) * n, n, 0, s, acc);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int i = R0 + 16 * warp + 8 * mt + (lane >> 2);
        if (i >= n) continue;
        float* out = W + static_cast<size_t>(i) * n + s;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            out[8 * nt + 2 * (lane & 3) + h] = static_cast<float>(-acc[mt][nt][h]);
      }
    }
    __syncthreads();
    for (int e = tid; e < B * B; e += THREADS) {
      const int i = e / B, j = e % B;
      sm.d[i][j] = W[static_cast<size_t>(s + i) * n + s + j];
    }
    __syncthreads();
    if (warp == 0) {
      diag_factor(sm, lane);
      diag_invert(sm, lane);
      if (r != nullptr) {  // z = L_kk^-1 r_k by forward substitution
        float v = r[s + lane];
#pragma unroll
        for (int c = 0; c < B; ++c) {
          const float zc = __shfl_sync(0xffffffffu, v, c) / sm.d[c][c];
          if (lane == c) v = zc;
          else if (lane > c) v = fmaf(-sm.d[lane][c], zc, v);
        }
        r[s + lane] = v;
        sm.z[lane] = v;
      }
    }
    __syncthreads();
    for (int e = tid; e < B * B; e += THREADS) {
      const int i = e / B, j = e % B;
      D[static_cast<size_t>(s + i) * B + j] = sm.di[i][j];
      W[static_cast<size_t>(s + i) * n + s + j] = (j <= i) ? sm.d[i][j] : 0.0f;
    }
    panel_solve(sm, W, n, s, s + B, n, r);
  }
  __syncthreads();
}

// a = L^-T a in place (a: n floats in shared memory) from the factor in W
// (blocked_cholesky's layout), by blocks, last first: warp 0 solves the
// block with L_kk^T by back substitution, then each column j before the
// block takes a_j -= L[block k, j] . a_k one term at a time (one thread a
// column, coalesced), in the order of an unblocked column sweep.
__device__ __forceinline__ void back_substitute(Smem& sm, const float* W,
                                                float* a, int n) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int s = n - B; s >= 0; s -= B) {
    __syncthreads();
    for (int e = tid; e < B * B; e += THREADS) {
      const int i = e / B, j = e % B;
      sm.d[i][j] = W[static_cast<size_t>(s + i) * n + s + j];
    }
    __syncthreads();
    if (warp == 0) {
      float v = a[s + lane];
#pragma unroll
      for (int c = B - 1; c >= 0; --c) {
        const float ac = __shfl_sync(0xffffffffu, v, c) / sm.d[c][c];
        if (lane == c) v = ac;
        else if (lane < c) v = fmaf(-sm.d[c][lane], ac, v);
      }
      a[s + lane] = v;
    }
    __syncthreads();
    for (int j = tid; j < s; j += THREADS) {
      float v = a[j];
#pragma unroll 8
      for (int i = B - 1; i >= 0; --i)
        v = fmaf(-W[static_cast<size_t>(s + i) * n + j], a[s + i], v);
      a[j] = v;
    }
  }
  __syncthreads();
}

// XT = L^-T (upper triangular) from the factor in W (its panels below the
// diagonal blocks and the factored diagonal blocks, as blocked_cholesky
// leaves them) and the diagonal blocks' inverses in D.  XT's diagonal
// blocks are written whole (zeros below their diagonal); entries below
// them are never read or written.
__device__ __forceinline__ void blocked_tri_inverse(Smem& sm, const float* W,
                                                    const float* D, float* XT,
                                                    int n) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int s = 0; s < n; s += B) {
    __syncthreads();
    for (int e = tid; e < B * B; e += THREADS) {
      const int i = e / B, j = e % B;
      sm.d[i][j] = W[static_cast<size_t>(s + i) * n + s + j];
      sm.di[i][j] = D[static_cast<size_t>(s + i) * B + j];
    }
    __syncthreads();
    for (int e = tid; e < B * B; e += THREADS) {
      const int i = e / B, j = e % B;
      XT[static_cast<size_t>(s + i) * n + s + j] = sm.di[j][i];
    }
    // rows above: XT[i][s + c] = -(XT[i, :s] . L[s + c, :s]), then the
    // panel solve with the diagonal factor L_kk (times L_kk^-T)
    for (int R0 = 0; R0 < s; R0 += MT) {
      double acc[2][4][2] = {};
      product(sm, XT + static_cast<size_t>(R0) * n, R0, s - R0, true,
              W + static_cast<size_t>(s) * n, n, R0, s, acc);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int i = R0 + 16 * warp + 8 * mt + (lane >> 2);
        if (i >= s) continue;
        float* out = XT + static_cast<size_t>(i) * n + s;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            out[8 * nt + 2 * (lane & 3) + h] = static_cast<float>(-acc[mt][nt][h]);
      }
    }
    __syncthreads();
    panel_solve(sm, XT, n, s, 0, s, nullptr);
  }
  __syncthreads();
}

// out[i][j] = sum_k XT[i][k] XT[j][k] for i >= j (the lower triangle of
// XT XT^T; entries above the diagonal are not written).
__device__ __forceinline__ void lower_gram(Smem& sm, const float* XT,
                                           float* out, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b0 = 0; b0 < n; b0 += B) {
    for (int R0 = b0; R0 < n; R0 += MT) {
      double acc[2][4][2] = {};
      product(sm, XT + static_cast<size_t>(R0) * n, R0, n - R0, true,
              XT + static_cast<size_t>(b0) * n, n, R0, n, acc);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int i = R0 + 16 * warp + 8 * mt + (lane >> 2);
        if (i >= n) continue;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = b0 + 8 * nt + 2 * (lane & 3) + h;
            if (j <= i)
              out[static_cast<size_t>(i) * n + j] = static_cast<float>(acc[mt][nt][h]);
          }
      }
    }
  }
  __syncthreads();
}

// M holds XT (upper, as blocked_tri_inverse leaves it); afterwards it holds
// X = XT^T with zeros above the diagonal.  One warp a pair of 32 x 32
// blocks, through a tile in the (idle) staging area of product.
__device__ __forceinline__ void upper_to_lower(Smem& sm, float* M, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float(*t)[B + 1] =
      reinterpret_cast<float(*)[B + 1]>(&sm.a[0][0]) + warp * B;
  const int nb = n / B;
  __syncthreads();
  for (int q = warp; q < nb * (nb + 1) / 2; q += WARPS) {
    int bi = 0;
    while ((bi + 1) * (bi + 2) / 2 <= q) ++bi;
    const int bj = q - bi * (bi + 1) / 2;
    float* up = M + static_cast<size_t>(bj * B) * n + bi * B;   // XT block
    float* lo = M + static_cast<size_t>(bi * B) * n + bj * B;   // X block
    for (int r = 0; r < B; ++r) t[r][lane] = up[static_cast<size_t>(r) * n + lane];
    __syncwarp();
    if (bi != bj)
      for (int r = 0; r < B; ++r) up[static_cast<size_t>(r) * n + lane] = 0.0f;
    for (int r = 0; r < B; ++r) lo[static_cast<size_t>(r) * n + lane] = t[lane][r];
    __syncwarp();
  }
  __syncthreads();
}

}  // namespace cholblk
