// Heap-encoded kernel-tree walks shared by the LML kernels (megalml.cu,
// K1/K2) and the covariance kernels (covtile.cuh: megacov.cu, K4/K5;
// cov.cu, K7F/K7B).
//
// Device counterpart of nowcastautogp_tpu/ops/pallas_megacov.py's node
// bodies (_node_fwd_body, _node_bwd_body): one element (x_i, x_j) of
// K(x, x) evaluated bottom-up over the heap (children of slot k at 2k+1 and
// 2k+2), and the top-down cotangent sweep that accumulates dK_ij/dparams.
// The node values live in a per-thread array (N, the heap size, is a
// template parameter: 7/15/31/63); every caller runs one particle per block,
// so the per-node type branch is uniform across the block.
//
// Every kernel that includes this header runs the same node bodies, so the
// covariance the LML kernels assemble and the one K4 returns are the same
// float function of (params, x).  The covariance kernels (covtile.cuh: K4/K5
// and K7F/K7B) walk only the first heap_class slots of each tree and skip
// its empty slots (SKIP_EMPTY); K1/K2 walk all N slots.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace heapwalk {

constexpr int EMPTY = 0, CONST = 1, LINEAR = 2, SE = 3, GE = 4, PERIODIC = 5,
              PLUS = 6, TIMES = 7, CP = 8;
constexpr float LOG_EPS = -27.631021f;  // log(1e-12): GammaExp clamp
constexpr float PI_F = 3.14159265358979f;

// Per-node data, uniform over the block.  c0/c1 hold per-node scalars that
// every element of the walk would otherwise recompute.
struct Node {
  int type;
  float p0, p1, p2;
  float c0, c1;
};

__device__ __forceinline__ float sigmoidf(float z) {
  return 1.0f / (1.0f + expf(-z));
}

__device__ __forceinline__ Node make_node(int t, float p0, float p1,
                                          float p2) {
  Node q;
  q.type = t;
  q.p0 = p0;
  q.p1 = p1;
  q.p2 = p2;
  q.c0 = 0.0f;
  q.c1 = 0.0f;
  if (t == CONST) {
    q.c0 = expf(p0);
  } else if (t == SE) {
    q.c0 = expf(-2.0f * p0);
  } else if (t == GE) {
    q.c0 = sigmoidf(p1);        // sigma
    q.c1 = 2.0f * q.c0;         // gamma
  } else if (t == PERIODIC) {
    q.c0 = expf(-2.0f * p0);
    q.c1 = expf(-p1);           // 1 / period
  } else if (t == LINEAR) {
    q.c0 = expf(p1);
  } else if (t == CP) {
    q.c0 = expf(-p1);           // 1 / scale
  }
  return q;
}

// Bottom-up tree walk for one element: v[k] = value of heap slot k.
// SKIP_EMPTY tests for an empty slot first (its value is 0 either way), so
// a sparse heap pays one compare per empty slot instead of the whole chain.
template <int N, bool SKIP_EMPTY = false>
__device__ __forceinline__ void walk_fwd(const Node* nd, float xi, float xj,
                                         float r, float r2, float log_r,
                                         float (&v)[N]) {
#pragma unroll
  for (int k = N - 1; k >= 0; --k) {
    const int t = nd[k].type;
    if (SKIP_EMPTY && t == EMPTY) {
      v[k] = 0.0f;
      continue;
    }
    float val = 0.0f;
    if (t == CONST) {
      val = nd[k].c0;
    } else if (t == SE) {
      val = expf(nd[k].p1 - 0.5f * r2 * nd[k].c0);
    } else if (t == GE) {
      const float pw = expf(nd[k].c1 * fmaxf(log_r - nd[k].p0, LOG_EPS));
      val = expf(r > 0.0f ? nd[k].p2 - pw : nd[k].p2);
    } else if (t == PERIODIC) {
      const float s = sinpif(r * nd[k].c1);
      val = expf(nd[k].p2 - 2.0f * s * s * nd[k].c0);
    } else if (t == LINEAR) {
      val = nd[k].c0 * ((xi - nd[k].p0) * (xj - nd[k].p0));
    }
    if (2 * k + 2 < N) {  // static per unrolled slot: only these have children
      const float vl = v[2 * k + 1], vr = v[2 * k + 2];
      if (t == PLUS) {
        val = vl + vr;
      } else if (t == TIMES) {
        val = vl * vr;
      } else if (t == CP) {
        const float s1 = sigmoidf((xi - nd[k].p0) * nd[k].c0);
        const float s2 = sigmoidf((xj - nd[k].p0) * nd[k].c0);
        val = s1 * s2 * vl + (1.0f - s1) * (1.0f - s2) * vr;
      }
    }
    v[k] = val;
  }
}

// The root value K(xi, xj) of one element; bit for bit K(xj, xi).
template <int N, bool SKIP_EMPTY = false>
__device__ __forceinline__ float cov_elem(const Node* nd, float xi,
                                          float xj) {
  const float d = xi - xj;
  const float r = fabsf(d);
  float v[N];
  walk_fwd<N, SKIP_EMPTY>(nd, xi, xj, r, d * d, logf(fmaxf(r, 1e-30f)), v);
  return v[0];
}

// Top-down cotangent sweep for one element with seed w = dcore/dK_ij
// (already folded and masked); accumulates dK_ij/dparams * w into acc,
// anything indexed acc[k][q] (slot k, parameter q): a float [N][3] in
// registers, or an accessor onto shared memory.
template <int N, bool SKIP_EMPTY = false, class Acc>
__device__ __forceinline__ void walk_bwd(const Node* nd, float xi, float xj,
                                         float w, Acc& acc) {
  const float d = xi - xj;
  const float r = fabsf(d);
  const float r2 = d * d;
  const float log_r = logf(fmaxf(r, 1e-30f));
  float v[N];
  walk_fwd<N, SKIP_EMPTY>(nd, xi, xj, r, r2, log_r, v);
  float dv[N];
#pragma unroll
  for (int k = 0; k < N; ++k) dv[k] = 0.0f;
  dv[0] = w;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int t = nd[k].type;
    if (SKIP_EMPTY && t == EMPTY) continue;  // no parameters, no children
    const float g = dv[k];
    const float gk = g * v[k];
    if (t == CONST) {
      acc[k][0] += gk;
    } else if (t == SE) {
      acc[k][0] += gk * r2 * nd[k].c0;
      acc[k][1] += gk;
    } else if (t == GE) {
      const float lw = log_r - nd[k].p0;
      const float wc = fmaxf(lw, LOG_EPS);
      const float pw = expf(nd[k].c1 * wc);
      if (r > 0.0f) {
        if (lw > LOG_EPS) acc[k][0] += gk * pw * nd[k].c1;
        acc[k][1] -= gk * pw * wc * nd[k].c1 * (1.0f - nd[k].c0);
      }
      acc[k][2] += gk;
    } else if (t == PERIODIC) {
      const float u = r * nd[k].c1;
      const float s = sinpif(u);
      acc[k][0] += gk * 4.0f * s * s * nd[k].c0;
      acc[k][1] += gk * 4.0f * s * cospif(u) * (PI_F * u) * nd[k].c0;
      acc[k][2] += gk;
    } else if (t == LINEAR) {
      acc[k][0] -= g * ((xi - nd[k].p0) + (xj - nd[k].p0)) * nd[k].c0;
      acc[k][1] += gk;
    }
    if (2 * k + 2 < N) {
      const int l = 2 * k + 1, rr = 2 * k + 2;
      if (t == PLUS) {
        dv[l] = g;
        dv[rr] = g;
      } else if (t == TIMES) {
        dv[l] = g * v[rr];
        dv[rr] = g * v[l];
      } else if (t == CP) {
        const float inv_s = nd[k].c0;
        const float zc = (xi - nd[k].p0) * inv_s;
        const float zr = (xj - nd[k].p0) * inv_s;
        const float s1c = sigmoidf(zc), s1r = sigmoidf(zr);
        const float vl = v[l], vr = v[rr];
        dv[l] = g * (s1c * s1r);
        dv[rr] = g * ((1.0f - s1c) * (1.0f - s1r));
        const float m1 = g * (s1r * vl - (1.0f - s1r) * vr);  // d/d s(xi)
        const float m2 = g * (s1c * vl - (1.0f - s1c) * vr);  // d/d s(xj)
        const float spc = s1c * (1.0f - s1c), spr = s1r * (1.0f - s1r);
        acc[k][0] -= (m1 * spc + m2 * spr) * inv_s;
        acc[k][1] -= m1 * spc * zc + m2 * spr * zr;
      }
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The heap class of a tree whose live slots 0 .. 63 are the bits of lo
// and hi: the smallest complete heap, 2^d - 1 slots, that holds every live
// slot.  Heap slots are level ordered, so the first class slots hold the
// whole tree and every later slot is empty.
__device__ __forceinline__ int class_of(unsigned lo, unsigned hi) {
  const int top = hi ? 63 - __clz(hi) : (lo ? 31 - __clz(lo) : 0);
  return (2 << (31 - __clz(top + 1))) - 1;
}

// The heap class of a block's tree nd[0 .. N).  Every warp computes it from
// shared memory (N <= 64); call it with the whole warp active.
__device__ __forceinline__ int heap_class(const Node* nd, int N) {
  const int lane = threadIdx.x & 31;
  return class_of(
      __ballot_sync(0xffffffffu, lane < N && nd[lane].type != EMPTY),
      __ballot_sync(0xffffffffu, lane + 32 < N && nd[lane + 32].type != EMPTY));
}

// Load heap nodes of particle p into shared memory (block-strided).
template <int N, int THREADS>
__device__ __forceinline__ void load_nodes(Node* nd, int p, const int* types,
                                           const float* params) {
  for (int k = threadIdx.x; k < N; k += THREADS) {
    const float* pp = params + (static_cast<size_t>(p) * N + k) * 3;
    nd[k] = make_node(types[static_cast<size_t>(p) * N + k], pp[0], pp[1],
                      pp[2]);
  }
}

// Block partials of the walk's 3N accumulators: warp shuffles, then the
// warps in order, written to out[0 .. 3N).  s_red is shared scratch.
template <int N, int WARPS>
__device__ __forceinline__ void block_partial(float (&acc)[N][3],
                                              float (&s_red)[WARPS][3 * N],
                                              float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float s = warp_sum(acc[k][q]);
      if (lane == 0) s_red[warp][3 * k + q] = s;
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < 3 * N; q += 32 * WARPS) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += s_red[w][q];
    out[q] = s;
  }
}

}  // namespace heapwalk

// Second pass of the covariance VJPs (K5, K7B): dparams[p][q] = the sum of
// particle p's block partials in block order, so the result does not
// depend on the order blocks ran in.  In the unnamed namespace, which every
// kernel source that includes this header also uses: each gets its own
// copy.
namespace {
__global__ void reduce_partials_kernel(int P, int n_parts, int width,
                                       const float* __restrict__ partial,
                                       float* __restrict__ dparams) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= P * width) return;
  const int p = idx / width, q = idx % width;
  const float* src = partial + static_cast<size_t>(p) * n_parts * width + q;
  float s = 0.0f;
  for (int t = 0; t < n_parts; ++t) s += src[static_cast<size_t>(t) * width];
  dparams[idx] = s;
}
}  // namespace
