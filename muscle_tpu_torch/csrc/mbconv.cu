// Inference stride-1 MBConv block for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel muscle_tpu/ops/pallas/mbconv.py
// (fused_mbconv_stride1 / _kernel).  Computes, per image b of x (B,H,W,Cin)
// NHWC with valid window win[b] = (oy, ox, h, w):
//
//   e = swish(x @ w_exp * s0 + b0)         (e = x when the block has no expand)
//   e = e * mask                           (zero outside the window: the
//                                           reference's SAME pad sees zeros)
//   d = swish(depthwise_kxk(e) * s1 + b1) * mask
//   g = sigmoid(swish(mean_window(d) @ w_se_r + b_se_r) @ w_se_e + b_se_e)
//   y = ((d * g) @ w_proj * s2 + b2) * mask  (+ x when Cin == Cout)
//
// with the batch norms folded to per-channel scale and bias by the caller.
//
// Design.  The TPU kernel keeps one whole image's expanded map in VMEM.
// An H100 block has 227 KB of shared memory, which does not hold that map
// at the early stages, and the SE gate needs a reduction over the whole
// image before the project can start.  So the block is three launches:
//
//   1. expand_dw: one CTA per (image, TH x TW output tile, TC mid channels).
//      It computes the expand product for the tile plus its k/2 halo in
//      shared memory (recomputing the halo rather than exchanging it),
//      applies BN0 + swish + mask, runs the depthwise k x k + BN1 + swish +
//      mask from shared memory, writes d, and writes the tile's SE partial
//      sums.  No atomics: a fixed-order sum, so results repeat run to run.
//   2. se: one CTA per image reduces the partials and runs both SE FCs.
//   3. project: a tiled GEMM over (B*H*W) x Cout that scales d by the gate
//      as it loads it; BN2, the mask and the residual in the epilogue.
//
// Bound on the card: the ideal kernel moves x in and y out (d never leaves
// the chip) and does 2*B*H*W*(Cin*Cmid + k*k*Cmid + Cmid*Cout) FLOPs on the
// f32 pipes (67 TFLOP/s, 3.35 TB/s).  At the b3 CAM shapes every block sits
// on the operations side of that line.  This first version writes d to HBM
// and reads it back (3x the ideal bytes at Cmid = 6 Cin) and runs its
// products as plain f32 FMAs from shared memory, without tensor cores;
// keeping d on chip and moving the 1x1 products to wgmma/TMA is later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TH = 8;    // output rows per expand_dw tile
constexpr int TW = 16;   // output columns per expand_dw tile
constexpr int TC = 32;   // mid channels per expand_dw CTA: one per lane
constexpr int KC = 8;    // input channels per expand chunk (two float4s)
constexpr int NT = 256;  // threads per CTA
constexpr int NWARP = NT / 32;
static_assert(NT == 256 && TC == 32 && KC * TC == NT,
              "the expand and project thread maps assume 256 threads, 32 channels");

__device__ __forceinline__ float sigmoidf_(float v) { return 1.f / (1.f + expf(-v)); }
__device__ __forceinline__ float swishf_(float v) { return v * sigmoidf_(v); }

__device__ __forceinline__ bool in_window(const int* w, int y, int x) {
  return y >= w[0] && y < w[0] + w[2] && x >= w[1] && x < w[1] + w[3];
}

template <int K, bool EXPAND>
__global__ void __launch_bounds__(NT) expand_dw_kernel(
    const float* __restrict__ x, const int* __restrict__ win,
    const float* __restrict__ w_exp, const float* __restrict__ s0,
    const float* __restrict__ b0, const float* __restrict__ w_dw,
    const float* __restrict__ s1, const float* __restrict__ b1,
    float* __restrict__ d, float* __restrict__ part,
    int H, int W, int Cin, int Cmid, int tiles_w) {
  constexpr int P = K / 2;
  constexpr int HH = TH + 2 * P;
  constexpr int HW = TW + 2 * P;
  constexpr int HP = HH * HW;                      // halo pixels
  constexpr int PPT = (HP + 31) / 32;              // halo pixels per thread (expand)
  constexpr int OPER = TH * TW / NWARP;            // output pixels per warp

  __shared__ __align__(16) float e_s[HP * TC];
  __shared__ __align__(16) float x_s[HP * KC];
  __shared__ __align__(16) float w_s[KC * TC];
  __shared__ float wdw_s[K * K * TC];
  __shared__ float red_s[NWARP * TC];
  __shared__ int win_s[4];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.z;
  const int c0 = blockIdx.y * TC;
  const int c = c0 + lane;
  const bool cok = c < Cmid;
  const int ty0 = (blockIdx.x / tiles_w) * TH;
  const int tx0 = (blockIdx.x % tiles_w) * TW;
  const size_t img = (size_t)b * H * W;

  if (threadIdx.x < 4) win_s[threadIdx.x] = win[4 * b + threadIdx.x];
  for (int i = threadIdx.x; i < K * K * TC; i += NT) {
    const int cc = c0 + i % TC;
    wdw_s[i] = cc < Cmid ? w_dw[(size_t)(i / TC) * Cmid + cc] : 0.f;
  }
  __syncthreads();

  if constexpr (EXPAND) {
    // the expand product as a (halo pixels x TC) tile: each thread holds
    // 4 channels of PPT pixels, so one float4 of x feeds 16 FMAs
    const int quad = threadIdx.x & 7;  // channels 4*quad .. 4*quad+3 of the tile
    const int pg = threadIdx.x >> 3;   // pixels pg, pg + 32, ...
    float acc[PPT][4];
#pragma unroll
    for (int j = 0; j < PPT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
    // staging of the next input chunk in registers while this one is
    // multiplied: thread t stages input channel k0 + t % KC of halo pixels
    // t / KC + 32 i, and one expand weight
    constexpr int XL = (HP + 31) / 32;
    long long xoff[XL];  // element offset of the staged pixel's row, -1 outside
#pragma unroll
    for (int t = 0; t < XL; ++t) {
      const int pix = pg + 32 * t;
      const int gy = ty0 - P + pix / HW, gx = tx0 - P + pix % HW;
      const bool ok = pix < HP && gy >= 0 && gy < H && gx >= 0 && gx < W;
      xoff[t] = ok ? (long long)(img + (size_t)gy * W + gx) * Cin : -1;
    }
    const int skk = threadIdx.x % KC;
    float xr[XL], wr;
    auto stage = [&](int k0) {
      const int ci = k0 + skk;
#pragma unroll
      for (int t = 0; t < XL; ++t) xr[t] = (xoff[t] >= 0 && ci < Cin) ? x[xoff[t] + ci] : 0.f;
      const int wi = k0 + threadIdx.x / TC, wc = c0 + threadIdx.x % TC;
      wr = (wc < Cmid && wi < Cin) ? w_exp[(size_t)wi * Cmid + wc] : 0.f;
    };
    stage(0);
    for (int k0 = 0; k0 < Cin; k0 += KC) {
      __syncthreads();  // the previous chunk has been consumed
#pragma unroll
      for (int t = 0; t < XL; ++t)
        if (pg + 32 * t < HP) x_s[(pg + 32 * t) * KC + skk] = xr[t];
      w_s[threadIdx.x] = wr;
      __syncthreads();
      if (k0 + KC < Cin) stage(k0 + KC);
#pragma unroll
      for (int kq = 0; kq < KC; kq += 4) {
        float4 wv[4];
#pragma unroll
        for (int t = 0; t < 4; ++t)
          wv[t] = *reinterpret_cast<const float4*>(w_s + (kq + t) * TC + 4 * quad);
#pragma unroll
        for (int j = 0; j < PPT; ++j) {
          const int pix = pg + 32 * j;
          if (pix < HP) {
            const float4 xv = *reinterpret_cast<const float4*>(x_s + pix * KC + kq);
            const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              acc[j][0] = fmaf(xs[t], wv[t].x, acc[j][0]);
              acc[j][1] = fmaf(xs[t], wv[t].y, acc[j][1]);
              acc[j][2] = fmaf(xs[t], wv[t].z, acc[j][2]);
              acc[j][3] = fmaf(xs[t], wv[t].w, acc[j][3]);
            }
          }
        }
      }
    }
    float sc[4], bi[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int cc = c0 + 4 * quad + q;
      sc[q] = cc < Cmid ? s0[cc] : 0.f;
      bi[q] = cc < Cmid ? b0[cc] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int pix = pg + 32 * j;
      if (pix < HP) {
        const int gy = ty0 - P + pix / HW, gx = tx0 - P + pix % HW;
        const bool keep = gy >= 0 && gy < H && gx >= 0 && gx < W && in_window(win_s, gy, gx);
        float4 e;
        e.x = keep ? swishf_(acc[j][0] * sc[0] + bi[0]) : 0.f;
        e.y = keep ? swishf_(acc[j][1] * sc[1] + bi[1]) : 0.f;
        e.z = keep ? swishf_(acc[j][2] * sc[2] + bi[2]) : 0.f;
        e.w = keep ? swishf_(acc[j][3] * sc[3] + bi[3]) : 0.f;
        *reinterpret_cast<float4*>(e_s + pix * TC + 4 * quad) = e;
      }
    }
  } else {  // no expand: Cmid == Cin, the depthwise runs on x itself
    for (int i = threadIdx.x; i < HP * TC; i += NT) {
      const int pix = i / TC, cc = c0 + i % TC;
      const int gy = ty0 - P + pix / HW, gx = tx0 - P + pix % HW;
      float v = 0.f;
      if (cc < Cmid && gy >= 0 && gy < H && gx >= 0 && gx < W && in_window(win_s, gy, gx))
        v = x[(img + (size_t)gy * W + gx) * Cin + cc];
      e_s[i] = v;
    }
  }
  __syncthreads();

  const float sc1 = cok ? s1[c] : 0.f;
  const float bi1 = cok ? b1[c] : 0.f;
  float psum = 0.f;
#pragma unroll 4
  for (int j = 0; j < OPER; ++j) {
    const int opix = warp + NWARP * j;
    const int ly = opix / TW, lx = opix % TW;
    const int gy = ty0 + ly, gx = tx0 + lx;
    float a = 0.f;
#pragma unroll
    for (int ky = 0; ky < K; ++ky)
#pragma unroll
      for (int kx = 0; kx < K; ++kx)
        a = fmaf(e_s[((ly + ky) * HW + lx + kx) * TC + lane], wdw_s[(ky * K + kx) * TC + lane], a);
    float v = swishf_(a * sc1 + bi1);
    if (gy < H && gx < W) {
      v = in_window(win_s, gy, gx) ? v : 0.f;
      if (cok) d[(img + (size_t)gy * W + gx) * Cmid + c] = v;
      psum += v;
    }
  }
  red_s[warp * TC + lane] = psum;
  __syncthreads();
  if (warp == 0 && cok) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) s += red_s[w * TC + lane];
    part[((size_t)b * gridDim.x + blockIdx.x) * Cmid + c] = s;
  }
}

constexpr int SE_NT = 1024;

// One CTA per image: gate[b] = sigmoid(swish(mean @ w_r + b_r) @ w_e + b_e).
__global__ void __launch_bounds__(SE_NT) se_kernel(
    const float* __restrict__ part, int ntiles, const int* __restrict__ win,
    const float* __restrict__ w_r, const float* __restrict__ b_r,
    const float* __restrict__ w_e, const float* __restrict__ b_e,
    float* __restrict__ gate, int Cmid, int Csq) {
  extern __shared__ float sm[];
  float* mean = sm;            // Cmid
  float* sq = sm + Cmid;       // Csq
  __shared__ float red[32][33];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, row = threadIdx.x >> 5;  // 32 rows of 32
  const float count = (float)(win[4 * b + 2] * win[4 * b + 3]);
  const float* pb = part + (size_t)b * ntiles * Cmid;

  for (int cb = 0; cb < Cmid; cb += 32) {
    const int c = cb + lane;
    float s = 0.f;
    if (c < Cmid)
      for (int t = row; t < ntiles; t += 32) s += pb[(size_t)t * Cmid + c];
    red[row][lane] = s;
    __syncthreads();
    if (row == 0 && c < Cmid) {
      float tot = 0.f;
      for (int r = 0; r < 32; ++r) tot += red[r][lane];
      mean[c] = tot / count;
    }
    __syncthreads();
  }

  for (int j = row; j < Csq; j += 32) {
    float s = 0.f;
    for (int c = lane; c < Cmid; c += 32) s = fmaf(mean[c], w_r[(size_t)c * Csq + j], s);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) sq[j] = swishf_(s + b_r[j]);
  }
  __syncthreads();

  for (int c = threadIdx.x; c < Cmid; c += SE_NT) {
    float s = 0.f;
    for (int j = 0; j < Csq; ++j) s = fmaf(sq[j], w_e[(size_t)j * Cmid + c], s);
    gate[(size_t)b * Cmid + c] = sigmoidf_(s + b_e[c]);
  }
}

constexpr int BM = 128, BN = 64, BK = 8;  // project tile; 8 x 4 outputs per thread

// y[m, n] = ((d[m, :] * gate[b(m), :]) @ w_p[:, n]) * s2[n] + b2[n], masked
// by the window, plus x[m, n] when the block has its residual.
__global__ void __launch_bounds__(NT) project_kernel(
    const float* __restrict__ dm, const float* __restrict__ gate,
    const float* __restrict__ w_p, const float* __restrict__ s2,
    const float* __restrict__ b2, const float* __restrict__ x,
    const int* __restrict__ win, float* __restrict__ y,
    long long M, int H, int W, int Cmid, int Cout, int has_skip) {
  __shared__ __align__(16) float As[BK][BM + 4];  // gated d, k-major
  __shared__ __align__(16) float Bs[BK][BN];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;  // 16 x 16 threads
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const long long hw = (long long)H * W;
  const bool vec = (Cmid & 3) == 0;
  // A loader: row r of the tile, input channels kq .. kq+3 of the chunk
  const int ar = threadIdx.x >> 1, akq = (threadIdx.x & 1) * 4;
  const long long am = m0 + ar;
  const float* drow = am < M ? dm + am * Cmid : nullptr;
  const float* grow = am < M ? gate + (am / hw) * Cmid : nullptr;
  float acc[8][4] = {};
  // the next chunk is staged in registers while this one is multiplied
  float av[4], bw[BK * BN / NT];
  auto stage = [&](int k0) {
    const int k = k0 + akq;
#pragma unroll
    for (int q = 0; q < 4; ++q) av[q] = 0.f;
    if (drow != nullptr) {
      if (vec && k + 3 < Cmid) {
        const float4 dv = *reinterpret_cast<const float4*>(drow + k);
        const float4 gv = *reinterpret_cast<const float4*>(grow + k);
        av[0] = dv.x * gv.x;
        av[1] = dv.y * gv.y;
        av[2] = dv.z * gv.z;
        av[3] = dv.w * gv.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (k + q < Cmid) av[q] = drow[k + q] * grow[k + q];
      }
    }
#pragma unroll
    for (int t = 0; t < BK * BN / NT; ++t) {
      const int i = threadIdx.x + t * NT;
      const int kr = k0 + i / BN, n = n0 + i % BN;
      bw[t] = (kr < Cmid && n < Cout) ? w_p[(size_t)kr * Cout + n] : 0.f;
    }
  };
  stage(0);
  for (int k0 = 0; k0 < Cmid; k0 += BK) {
    __syncthreads();  // the previous chunk has been consumed
#pragma unroll
    for (int q = 0; q < 4; ++q) As[akq + q][ar] = av[q];
#pragma unroll
    for (int t = 0; t < BK * BN / NT; ++t) {
      const int i = threadIdx.x + t * NT;
      Bs[i / BN][i % BN] = bw[t];
    }
    __syncthreads();
    if (k0 + BK < Cmid) stage(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * 8 + 4]);
      const float4 bq = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + ty * 8 + i;
    if (m >= M) continue;
    const long long b = m / hw;
    const long long rem = m - b * hw;
    const int gy = (int)(rem / W), gx = (int)(rem % W);
    const bool keep = in_window(win + 4 * b, gy, gx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= Cout) continue;
      float v = keep ? acc[i][j] * s2[n] + b2[n] : 0.f;
      if (has_skip) v += x[m * Cout + n];
      y[m * Cout + n] = v;
    }
  }
}

template <int K, bool EXPAND>
cudaError_t launch_expand_dw(const float* x, const int* win, const float* w_exp,
                             const float* s0, const float* b0, const float* w_dw,
                             const float* s1, const float* b1, float* d, float* part,
                             int B, int H, int W, int Cin, int Cmid, cudaStream_t st) {
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  dim3 grid(tiles_h * tiles_w, (Cmid + TC - 1) / TC, B);
  expand_dw_kernel<K, EXPAND><<<grid, NT, 0, st>>>(x, win, w_exp, s0, b0, w_dw, s1, b1, d,
                                                   part, H, W, Cin, Cmid, tiles_w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// SE partial sums per image: the number of expand_dw tiles.
int mbconv_partials_per_image(int H, int W) {
  return ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
}

const char* mbconv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches the three kernels on `stream`; returns the first launch error
// (cudaGetLastError after each launch), 0 on success.
int mbconv_stride1_f32(const float* x, const int* win, const float* w_exp, const float* s0,
                       const float* b0, const float* w_dw, const float* s1, const float* b1,
                       const float* w_se_r, const float* b_se_r, const float* w_se_e,
                       const float* b_se_e, const float* w_proj, const float* s2,
                       const float* b2, float* d, float* part, float* gate, float* y, int B,
                       int H, int W, int Cin, int Cmid, int Csq, int Cout, int k,
                       int has_expand, int has_skip, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (k == 3 && has_expand)
    err = launch_expand_dw<3, true>(x, win, w_exp, s0, b0, w_dw, s1, b1, d, part, B, H, W, Cin, Cmid, st);
  else if (k == 3)
    err = launch_expand_dw<3, false>(x, win, w_exp, s0, b0, w_dw, s1, b1, d, part, B, H, W, Cin, Cmid, st);
  else if (k == 5 && has_expand)
    err = launch_expand_dw<5, true>(x, win, w_exp, s0, b0, w_dw, s1, b1, d, part, B, H, W, Cin, Cmid, st);
  else if (k == 5)
    err = launch_expand_dw<5, false>(x, win, w_exp, s0, b0, w_dw, s1, b1, d, part, B, H, W, Cin, Cmid, st);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;

  const int ntiles = mbconv_partials_per_image(H, W);
  se_kernel<<<B, SE_NT, (size_t)(Cmid + Csq) * sizeof(float), st>>>(
      part, ntiles, win, w_se_r, b_se_r, w_se_e, b_se_e, gate, Cmid, Csq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long M = (long long)B * H * W;
  dim3 grid((unsigned)((M + BM - 1) / BM), (Cout + BN - 1) / BN);
  project_kernel<<<grid, NT, 0, st>>>(d, gate, w_proj, s2, b2, x, win, y, M, H, W, Cmid, Cout,
                                      has_skip);
  return (int)cudaGetLastError();
}

}  // extern "C"
