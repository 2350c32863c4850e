// Cross-rank batch norm in training for Hopper (sm_90a): the four passes
// of ops/sync_bn.py, float32 or bfloat16 x with float32 statistics.
//
// Replaces no TPU kernel.  Under the JAX package's data mesh XLA computes a
// train-mode BatchNorm's statistics over the sharded batch itself; the port
// runs one process a card and exchanges each BN's statistics explicitly,
// and its plain PyTorch stages cost ~25 eager launches a BN forward and ~15
// backward.  These kernels make that 2 + 2, the exchanges between them:
//
//   (a) stats_kernel      x -> this rank's [count, mean, M2] row of the
//                         (W, 1 + 2C) buffer the all-gather fills in place;
//   (c) normalize_kernel  the W rows combined (Chan's parallel update, the
//                         biased variance), Flax's running update, and
//                         y = (x - mean) * invstd * w + b in x's dtype;
//   (d) reduce_kernel     g, x -> [sum g, sum g * xhat] (the all-reduce's
//                         buffer) and this rank's db, dw;
//   (f) dx_kernel         dx = g s - s (sum_g / n + xhat sum_g_xhat / n),
//                         s = invstd * w; at bfloat16 the direct path g s
//                         and the rest rounded apart, then summed (JAX's
//                         rounding: ops/sync_bn.py).
//
// Layout: x is the model's channels-last NCHW view, so memory is a (P, C)
// row-major matrix, P = N H W, and every reduction is a column reduction.
//
// Bound on the card: bytes.  Each pass reads x (and g) once and (c), (f)
// write one map, a handful of flops an element; at the stem's shape (P =
// 16 x 224 x 224, C = 40, float32) (a) moves 128 MB (38 us at 3.35 TB/s),
// (c) 257 MB, (d) 257 MB, (f) 385 MB.
//
// Design.
// - A CTA of 256 threads covers G groups of V channels, at most 64
//   channels (V: 16 bytes of x, 4 floats or 8 bf16, where C and the
//   pointers allow; else 1), and a contiguous range of rows, R = 256 / G
//   rows at a time, so a narrow layer's CTA reads R whole rows at once: one
//   contiguous span, fully coalesced.  Each thread loads UNROLL rows before
//   it reduces them, so four 16-byte loads a thread are in flight.
// - The grid is (channel blocks, row blocks): one wave of 2 CTAs an SM
//   (the stem: 264 CTAs of 3,041 rows; 4 an SM doubles the tail below and
//   reads no faster).  A row block's partial statistics
//   go to a workspace; the last CTA of a channel block to finish (an atomic
//   ticket, reset by that CTA for the next launch) combines the partials,
//   256 / (channels a CTA) threads a channel over the row blocks and then
//   in a fixed order, so the result does not depend on the order the CTAs
//   ran.  Capping a CTA's channels keeps that tail short for wide layers;
//   its threads load 8 partials before they add any, and (a)'s tail reads
//   each partial once (its mean and M2 together).
// - The mean and M2 are combined by Chan's parallel update at every level
//   (a chunk of UNROLL rows and, in (a)'s tail, the row blocks,
//   incrementally; the rows of a CTA and the ranks in its two-pass form:
//   the count-weighted mean, then the parts' M2 plus each count times its
//   mean's squared distance from it): the variance never takes E[x^2] -
//   mean^2.
// - (c) and (f) recompute the W-rank combine (W x C reads) in every CTA:
//   cheaper than another launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;            // rows a thread loads before it reduces them
constexpr int CTAS_PER_SM = 2;       // the grid: one wave of this many CTAs an SM
constexpr int MIN_ROWS_PER_CTA = 64;
constexpr int CHANNELS_PER_CTA = 64;  // at most; the rest of the threads take more rows
constexpr int BATCH = 8;              // row blocks' partials a thread of the tail loads at once

typedef __nv_bfloat16 bf16;

// ---- loads and stores of V channels of one row, as float ------------------

template <typename T, int V>
struct Io;

template <>
struct Io<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Io<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* v) { v[0] = *p; }
  static __device__ __forceinline__ void store(float* p, const float* v) { *p = v[0]; }
};

template <>
struct Io<bf16, 8> {
  static __device__ __forceinline__ void load(const bf16* p, float* v) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = hopper::bf16_lo(w[i]);
      v[2 * i + 1] = hopper::bf16_hi(w[i]);
    }
  }
  static __device__ __forceinline__ void store(bf16* p, const float* v) {
    uint4 a;
    a.x = hopper::pack_bf16(v[0], v[1]);
    a.y = hopper::pack_bf16(v[2], v[3]);
    a.z = hopper::pack_bf16(v[4], v[5]);
    a.w = hopper::pack_bf16(v[6], v[7]);
    *reinterpret_cast<uint4*>(p) = a;
  }
};

template <>
struct Io<bf16, 1> {
  static __device__ __forceinline__ void load(const bf16* p, float* v) {
    v[0] = __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(bf16* p, const float* v) {
    *p = __float2bfloat16_rn(v[0]);
  }
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Chan's merge of a part (nb rows, mean mb, M2 m2b) into (n rows, mean,
// m2), given f = nb / (n + nb); n is updated by the caller.
__device__ __forceinline__ void merge(float n, float& mean, float& m2, float f, float mb,
                                      float m2b) {
  const float d = mb - mean;
  mean += d * f;
  m2 += m2b + d * d * n * f;
}

// ---- the plan: how a (P, C) pass is cut into CTAs ---------------------------

struct Plan {
  int v;       // channels a thread loads at once
  int g;       // channel groups of v a CTA covers
  int r;       // rows a CTA loads at once
  int gx, gy;  // CTAs over the channels, over the rows
  int rows;    // rows a row block covers (the last ones may cover fewer)
};

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;  // an H100 SXM's
  }
  return sms;
}

// Channel blocks: G V channels each, at most CHANNELS_PER_CTA (a multiple
// of every v), so ceil(C / CHANNELS_PER_CTA) whatever v is.
int channel_blocks(int C) { return (C + CHANNELS_PER_CTA - 1) / CHANNELS_PER_CTA; }

// Row blocks: one wave of CTAS_PER_SM CTAs on every SM over the channel
// blocks, each at least MIN_ROWS_PER_CTA rows.
int row_blocks(int P, int C) {
  const int gx = channel_blocks(C);
  long long gy = ((long long)sm_count() * CTAS_PER_SM + gx - 1) / gx;
  const long long by_rows = ((long long)P + MIN_ROWS_PER_CTA - 1) / MIN_ROWS_PER_CTA;
  if (gy > by_rows) gy = by_rows;
  return gy < 1 ? 1 : (int)gy;
}

Plan make_plan(int P, int C, int vmax, bool aligned) {
  Plan p;
  p.v = (aligned && C % vmax == 0) ? vmax : 1;
  const int groups = C / p.v, gmax = CHANNELS_PER_CTA / p.v;
  p.g = groups < gmax ? groups : gmax;
  p.r = THREADS / p.g;
  p.gx = (groups + p.g - 1) / p.g;
  const int gy = row_blocks(P, C);
  p.rows = (P + gy - 1) / gy;
  p.gy = (P + p.rows - 1) / p.rows;  // no row block empty
  return p;
}

__device__ __forceinline__ int block_rows(int P, int rows, int b) {
  return min(P, (b + 1) * rows) - b * rows;
}

// The last CTA of this channel block to arrive: true for one CTA, which
// resets the ticket.  The partials written before the call are visible to it.
__device__ __forceinline__ bool last_to_arrive(int* tickets) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(&tickets[blockIdx.x], 1) == (int)gridDim.y - 1;
    if (last) tickets[blockIdx.x] = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// ---- (a) local statistics ----------------------------------------------------

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
    stats_kernel(const T* __restrict__ x, float* __restrict__ row, float* __restrict__ ws,
                 int* __restrict__ tickets, int P, int C, int G, int R, int rows) {
  __shared__ float s_mean[THREADS * V], s_m2[THREADS * V], s_n[THREADS];
  const int tid = threadIdx.x, g = tid % G, r = tid / G;
  const int cb = blockIdx.x * G * V, c0 = cb + g * V;
  const bool active = r < R && c0 < C;
  const int row0 = blockIdx.y * rows, row1 = min(P, row0 + rows);
  float n = 0.f, mean[V], m2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) mean[i] = m2[i] = 0.f;
  if (active) {
    for (int p = row0 + r; p < row1; p += R * UNROLL) {
      float v[UNROLL][V];
      int k = 0;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int q = p + u * R;
        if (q < row1) {
          Io<T, V>::load(x + (size_t)q * C + c0, v[u]);
          ++k;
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) v[u][i] = 0.f;
        }
      }
      const float inv_k = 1.f / (float)k, f = (float)k / (n + (float)k);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float s = 0.f;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) s += u < k ? v[u][i] : 0.f;
        const float cm = s * inv_k;
        float cm2 = 0.f;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const float d = v[u][i] - cm;
          cm2 += u < k ? d * d : 0.f;
        }
        merge(n, mean[i], m2[i], f, cm, cm2);
      }
      n += (float)k;
    }
  }
  if (r < R) {
    if (g == 0) s_n[r] = n;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      s_mean[r * G * V + g * V + i] = mean[i];
      s_m2[r * G * V + g * V + i] = m2[i];
    }
  }
  __syncthreads();
  // the CTA's R row slots combined in Chan's two-pass form: the
  // count-weighted mean, then M2 as the parts' M2 plus each count times
  // its mean's squared distance
  const int E = G * V, c = cb + tid;
  const bool owner = tid < E && c < C;
  float bmean = 0.f, bm2 = 0.f;
  if (owner) {
    float bn = 0.f, acc = 0.f;
    for (int j = 0; j < R; ++j) bn += s_n[j], acc += s_n[j] * s_mean[j * E + tid];
    bmean = acc / bn;
    for (int j = 0; j < R; ++j) {
      const float d = s_mean[j * E + tid] - bmean;
      bm2 += s_m2[j * E + tid] + s_n[j] * d * d;
    }
  }
  if (gridDim.y > 1) {
    if (owner) {
      ws[(size_t)blockIdx.y * 2 * C + c] = bmean;
      ws[(size_t)blockIdx.y * 2 * C + C + c] = bm2;
    }
    if (!last_to_arrive(tickets)) return;
    // S = THREADS / E threads a channel, each merging every S-th row
    // block's partial by Chan's update, BATCH partials (mean and M2)
    // loaded at once; then the S threads' parts in order
    const int S = THREADS / E, e = tid % E, sub = tid / E, gy = gridDim.y;
    const float* wm = ws + cb + e;
    float tn = 0.f, tmean = 0.f, tm2 = 0.f;
    if (sub < S && cb + e < C) {
      for (int b0 = sub; b0 < gy; b0 += BATCH * S) {
        float m[BATCH], q[BATCH];
#pragma unroll
        for (int j = 0; j < BATCH; ++j) {
          const int b = b0 + j * S;
          m[j] = b < gy ? __ldcg(wm + (size_t)b * 2 * C) : 0.f;
          q[j] = b < gy ? __ldcg(wm + (size_t)b * 2 * C + C) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < BATCH; ++j) {
          const int b = b0 + j * S;
          if (b < gy) {
            const float nb = (float)block_rows(P, rows, b);
            merge(tn, tmean, tm2, nb / (tn + nb), m[j], q[j]);
            tn += nb;
          }
        }
      }
    }
    if (sub < S) {
      s_n[sub * E + e] = tn;
      s_mean[sub * E + e] = tmean;
      s_m2[sub * E + e] = tm2;
    }
    __syncthreads();
    if (owner) {
      float bn = 0.f;
      bmean = bm2 = 0.f;
      for (int j = 0; j < S; ++j) {
        const float nb = s_n[j * E + tid];
        if (nb > 0.f) {
          merge(bn, bmean, bm2, nb / (bn + nb), s_mean[j * E + tid], s_m2[j * E + tid]);
          bn += nb;
        }
      }
    }
  }
  if (owner) {
    row[1 + c] = bmean;
    row[1 + C + c] = bm2;
  }
  if (blockIdx.x == 0 && tid == 0) row[0] = (float)P;
}

// ---- (c) combine, running statistics, normalise -------------------------------

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
    normalize_kernel(const T* __restrict__ x, const float* __restrict__ stats, int W,
                     const float* __restrict__ weight, const float* __restrict__ bias, float eps,
                     float momentum, float* __restrict__ run_mean, float* __restrict__ run_var,
                     long long* __restrict__ batches, float* __restrict__ saved,
                     T* __restrict__ y, int P, int C, int G, int R, int rows) {
  __shared__ float s_mean[THREADS], s_scale[THREADS], s_bias[THREADS];
  const int tid = threadIdx.x, cb = blockIdx.x * G * V;
  if (tid < G * V && cb + tid < C) {
    const int c = cb + tid, stride = 1 + 2 * C;
    float n = 0.f, acc = 0.f;
    for (int w = 0; w < W; ++w) {
      const float cnt = stats[w * stride];
      n += cnt;
      acc += cnt * stats[w * stride + 1 + c];
    }
    const float mean = acc / n;
    float m2 = 0.f, dev = 0.f;
    for (int w = 0; w < W; ++w) {
      const float d = stats[w * stride + 1 + c] - mean;
      m2 += stats[w * stride + 1 + C + c];
      dev += stats[w * stride] * d * d;
    }
    const float var = (m2 + dev) / n;
    const float invstd = rsqrtf(var + eps);
    s_mean[tid] = mean;
    s_scale[tid] = invstd * weight[c];
    s_bias[tid] = bias[c];
    if (blockIdx.y == 0) {
      saved[c] = mean;
      saved[C + c] = invstd;
      if (run_mean != nullptr) {
        run_mean[c] = run_mean[c] * (1.f - momentum) + momentum * mean;
        run_var[c] = run_var[c] * (1.f - momentum) + momentum * var;
      }
      if (c == 0) {
        saved[2 * C] = n;
        if (batches != nullptr) *batches += 1;
      }
    }
  }
  __syncthreads();
  const int g = tid % G, r = tid / G, c0 = cb + g * V;
  if (r >= R || c0 >= C) return;
  float mean[V], scale[V], b[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    mean[i] = s_mean[g * V + i], scale[i] = s_scale[g * V + i], b[i] = s_bias[g * V + i];
  }
  const int row0 = blockIdx.y * rows, row1 = min(P, row0 + rows);
  for (int p = row0 + r; p < row1; p += R * UNROLL) {
    float v[UNROLL][V];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (p + u * R < row1) Io<T, V>::load(x + (size_t)(p + u * R) * C + c0, v[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (p + u * R < row1) {
#pragma unroll
        for (int i = 0; i < V; ++i) v[u][i] = (v[u][i] - mean[i]) * scale[i] + b[i];
        Io<T, V>::store(y + (size_t)(p + u * R) * C + c0, v[u]);
      }
    }
  }
}

// ---- (d) backward reduce ------------------------------------------------------

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
    reduce_kernel(const T* __restrict__ gy, const T* __restrict__ x,
                  const float* __restrict__ saved, float* __restrict__ red,
                  float* __restrict__ dw, float* __restrict__ db, float* __restrict__ ws,
                  int* __restrict__ tickets, int P, int C, int G, int R, int rows) {
  __shared__ float s_dy[THREADS * V], s_dyx[THREADS * V];
  const int tid = threadIdx.x, g = tid % G, r = tid / G;
  const int cb = blockIdx.x * G * V, c0 = cb + g * V;
  const bool active = r < R && c0 < C;
  const int row0 = blockIdx.y * rows, row1 = min(P, row0 + rows);
  float sdy[V], sdyx[V], mean[V];
#pragma unroll
  for (int i = 0; i < V; ++i) sdy[i] = sdyx[i] = 0.f, mean[i] = active ? saved[c0 + i] : 0.f;
  if (active) {
    for (int p = row0 + r; p < row1; p += R * UNROLL) {
      float gv[UNROLL][V], xv[UNROLL][V];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (p + u * R < row1) {
          Io<T, V>::load(gy + (size_t)(p + u * R) * C + c0, gv[u]);
          Io<T, V>::load(x + (size_t)(p + u * R) * C + c0, xv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (p + u * R < row1) {
#pragma unroll
          for (int i = 0; i < V; ++i) {
            sdy[i] += gv[u][i];
            sdyx[i] += gv[u][i] * (xv[u][i] - mean[i]);
          }
        }
      }
    }
  }
  if (r < R) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      s_dy[r * G * V + g * V + i] = sdy[i];
      s_dyx[r * G * V + g * V + i] = sdyx[i];
    }
  }
  __syncthreads();
  const int c = cb + tid;
  const bool owner = tid < G * V && c < C;
  float a = 0.f, b = 0.f;
  if (owner) {
    for (int j = 0; j < R; ++j) a += s_dy[j * G * V + tid], b += s_dyx[j * G * V + tid];
  }
  if (gridDim.y > 1) {
    if (owner) {
      ws[(size_t)blockIdx.y * 2 * C + c] = a;
      ws[(size_t)blockIdx.y * 2 * C + C + c] = b;
    }
    if (!last_to_arrive(tickets)) return;
    // as (a)'s: S threads a channel over every S-th row block, BATCH at once
    const int E = G * V, S = THREADS / E, e = tid % E, sub = tid / E, gy = gridDim.y;
    const float* wa = ws + cb + e;
    float pa = 0.f, pb = 0.f;
    if (sub < S && cb + e < C) {
      for (int k0 = sub; k0 < gy; k0 += BATCH * S) {
        float ta[BATCH], tb[BATCH];
#pragma unroll
        for (int j = 0; j < BATCH; ++j) {
          const int k = k0 + j * S;
          ta[j] = k < gy ? __ldcg(wa + (size_t)k * 2 * C) : 0.f;
          tb[j] = k < gy ? __ldcg(wa + (size_t)k * 2 * C + C) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < BATCH; ++j) pa += ta[j], pb += tb[j];
      }
    }
    if (sub < S) {
      s_dy[sub * E + e] = pa;
      s_dyx[sub * E + e] = pb;
    }
    __syncthreads();
    if (owner) {
      a = b = 0.f;
      for (int j = 0; j < S; ++j) a += s_dy[j * E + tid], b += s_dyx[j * E + tid];
    }
  }
  if (owner) {
    b *= saved[C + c];  // sum g (x - mean) -> sum g xhat
    red[c] = a;
    red[C + c] = b;
    db[c] = a;
    dw[c] = b;
  }
}

// ---- (f) backward elementwise ------------------------------------------------

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
    dx_kernel(const T* __restrict__ gy, const T* __restrict__ x, const float* __restrict__ saved,
              const float* __restrict__ weight, const float* __restrict__ red,
              T* __restrict__ dx, int P, int C, int G, int R, int rows) {
  __shared__ float s_mean[THREADS], s_invstd[THREADS], s_scale[THREADS], s_a[THREADS],
      s_b[THREADS];
  const int tid = threadIdx.x, cb = blockIdx.x * G * V;
  if (tid < G * V && cb + tid < C) {
    const int c = cb + tid;
    const float n = saved[2 * C], invstd = saved[C + c];
    s_mean[tid] = saved[c];
    s_invstd[tid] = invstd;
    s_scale[tid] = invstd * weight[c];
    s_a[tid] = red[c] / n;
    s_b[tid] = red[C + c] / n;
  }
  __syncthreads();
  const int g = tid % G, r = tid / G, c0 = cb + g * V;
  if (r >= R || c0 >= C) return;
  float mean[V], invstd[V], scale[V], a[V], b[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int k = g * V + i;
    mean[i] = s_mean[k], invstd[i] = s_invstd[k], scale[i] = s_scale[k];
    a[i] = s_a[k], b[i] = s_b[k];
  }
  const int row0 = blockIdx.y * rows, row1 = min(P, row0 + rows);
  for (int p = row0 + r; p < row1; p += R * UNROLL) {
    float gv[UNROLL][V], xv[UNROLL][V];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (p + u * R < row1) {
        Io<T, V>::load(gy + (size_t)(p + u * R) * C + c0, gv[u]);
        Io<T, V>::load(x + (size_t)(p + u * R) * C + c0, xv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (p + u * R < row1) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float xhat = (xv[u][i] - mean[i]) * invstd[i];
          const float direct = gv[u][i] * scale[i];
          const float full = direct - scale[i] * (a[i] + xhat * b[i]);
          if constexpr (std::is_same<T, bf16>::value)  // the paths rounded apart, then summed
            gv[u][i] = round_bf16(direct) + round_bf16(full - direct);
          else
            gv[u][i] = full;
        }
        Io<T, V>::store(dx + (size_t)(p + u * R) * C + c0, gv[u]);
      }
    }
  }
}

// ---- launches ------------------------------------------------------------------

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
constexpr int vmax() {
  return 16 / (int)sizeof(T);
}

template <typename T>
int launch_stats(const void* x, float* row, float* ws, int* tickets, int P, int C,
                 cudaStream_t st) {
  if (P < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(P, C, vmax<T>(), aligned16(x));
  const dim3 grid(p.gx, p.gy);
  const T* xt = static_cast<const T*>(x);
  if (p.v == vmax<T>())
    stats_kernel<T, vmax<T>()><<<grid, THREADS, 0, st>>>(xt, row, ws, tickets, P, C, p.g, p.r,
                                                         p.rows);
  else
    stats_kernel<T, 1><<<grid, THREADS, 0, st>>>(xt, row, ws, tickets, P, C, p.g, p.r, p.rows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_normalize(const void* x, const float* stats, int W, const float* weight,
                     const float* bias, float eps, float momentum, float* run_mean,
                     float* run_var, long long* batches, float* saved, void* y, int P, int C,
                     cudaStream_t st) {
  if (P < 1 || C < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(P, C, vmax<T>(), aligned16(x) && aligned16(y));
  const dim3 grid(p.gx, p.gy);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (p.v == vmax<T>())
    normalize_kernel<T, vmax<T>()><<<grid, THREADS, 0, st>>>(
        xt, stats, W, weight, bias, eps, momentum, run_mean, run_var, batches, saved, yt, P, C,
        p.g, p.r, p.rows);
  else
    normalize_kernel<T, 1><<<grid, THREADS, 0, st>>>(xt, stats, W, weight, bias, eps, momentum,
                                                     run_mean, run_var, batches, saved, yt, P,
                                                     C, p.g, p.r, p.rows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_reduce(const void* gy, const void* x, const float* saved, float* red, float* dw,
                  float* db, float* ws, int* tickets, int P, int C, cudaStream_t st) {
  if (P < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(P, C, vmax<T>(), aligned16(x) && aligned16(gy));
  const dim3 grid(p.gx, p.gy);
  const T* gt = static_cast<const T*>(gy);
  const T* xt = static_cast<const T*>(x);
  if (p.v == vmax<T>())
    reduce_kernel<T, vmax<T>()><<<grid, THREADS, 0, st>>>(gt, xt, saved, red, dw, db, ws,
                                                          tickets, P, C, p.g, p.r, p.rows);
  else
    reduce_kernel<T, 1><<<grid, THREADS, 0, st>>>(gt, xt, saved, red, dw, db, ws, tickets, P, C,
                                                  p.g, p.r, p.rows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dx(const void* gy, const void* x, const float* saved, const float* weight,
              const float* red, void* dx, int P, int C, cudaStream_t st) {
  if (P < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(P, C, vmax<T>(), aligned16(x) && aligned16(gy) && aligned16(dx));
  const dim3 grid(p.gx, p.gy);
  const T* gt = static_cast<const T*>(gy);
  const T* xt = static_cast<const T*>(x);
  T* dt = static_cast<T*>(dx);
  if (p.v == vmax<T>())
    dx_kernel<T, vmax<T>()><<<grid, THREADS, 0, st>>>(gt, xt, saved, weight, red, dt, P, C,
                                                      p.g, p.r, p.rows);
  else
    dx_kernel<T, 1><<<grid, THREADS, 0, st>>>(gt, xt, saved, weight, red, dt, P, C, p.g, p.r,
                                              p.rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* sync_bn_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Floats of the workspace a (P, C) pass takes: 2C a row block.
int sync_bn_workspace_floats(int P, int C) { return row_blocks(P, C) * 2 * C; }

// Tickets (int32, zero before the first launch; each launch leaves them
// zero) a pass over C channels takes.
int sync_bn_tickets(int C) { return channel_blocks(C); }

// (a): x (P, C) -> row[0] = P, row[1 .. C] = mean, row[1 + C .. 2C] = M2.
int sync_bn_stats_f32(const void* x, float* row, float* ws, int* tickets, int P, int C,
                      void* stream) {
  return launch_stats<float>(x, row, ws, tickets, P, C, (cudaStream_t)stream);
}
int sync_bn_stats_bf16(const void* x, float* row, float* ws, int* tickets, int P, int C,
                       void* stream) {
  return launch_stats<bf16>(x, row, ws, tickets, P, C, (cudaStream_t)stream);
}

// (c): stats (W, 1 + 2C) -> saved = [mean (C), invstd (C), n], y (P, C);
// run_mean, run_var and batches updated where not null.
int sync_bn_normalize_f32(const void* x, const float* stats, int W, const float* weight,
                          const float* bias, float eps, float momentum, float* run_mean,
                          float* run_var, long long* batches, float* saved, void* y, int P,
                          int C, void* stream) {
  return launch_normalize<float>(x, stats, W, weight, bias, eps, momentum, run_mean, run_var,
                                 batches, saved, y, P, C, (cudaStream_t)stream);
}
int sync_bn_normalize_bf16(const void* x, const float* stats, int W, const float* weight,
                           const float* bias, float eps, float momentum, float* run_mean,
                           float* run_var, long long* batches, float* saved, void* y, int P,
                           int C, void* stream) {
  return launch_normalize<bf16>(x, stats, W, weight, bias, eps, momentum, run_mean, run_var,
                                batches, saved, y, P, C, (cudaStream_t)stream);
}

// (d): red = [sum g, sum g xhat] (2C), db = sum g, dw = sum g xhat.
int sync_bn_reduce_f32(const void* gy, const void* x, const float* saved, float* red,
                       float* dw, float* db, float* ws, int* tickets, int P, int C,
                       void* stream) {
  return launch_reduce<float>(gy, x, saved, red, dw, db, ws, tickets, P, C,
                              (cudaStream_t)stream);
}
int sync_bn_reduce_bf16(const void* gy, const void* x, const float* saved, float* red,
                        float* dw, float* db, float* ws, int* tickets, int P, int C,
                        void* stream) {
  return launch_reduce<bf16>(gy, x, saved, red, dw, db, ws, tickets, P, C,
                             (cudaStream_t)stream);
}

// (f): dx (P, C) from g, x, saved and the summed red.
int sync_bn_dx_f32(const void* gy, const void* x, const float* saved, const float* weight,
                   const float* red, void* dx, int P, int C, void* stream) {
  return launch_dx<float>(gy, x, saved, weight, red, dx, P, C, (cudaStream_t)stream);
}
int sync_bn_dx_bf16(const void* gy, const void* x, const float* saved, const float* weight,
                    const float* red, void* dx, int P, int C, void* stream) {
  return launch_dx<bf16>(gy, x, saved, weight, red, dx, P, C, (cudaStream_t)stream);
}

}  // extern "C"
