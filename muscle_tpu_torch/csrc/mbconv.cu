// Inference stride-1 MBConv block for Hopper (sm_90a), float32 and
// bfloat16.
//
// Replaces the Pallas TPU kernel muscle_tpu/ops/pallas/mbconv.py
// (fused_mbconv_stride1 / _kernel) at compute_dtype float32 and bfloat16.
// Computes, per image b of x (B,H,W,Cin) NHWC with valid window win[b] =
// (oy, ox, h, w):
//
//   e = swish(x @ w_exp * s0 + b0)         (e = x when the block has no expand)
//   e = e * mask                           (zero outside the window: the
//                                           reference's SAME pad sees zeros)
//   d = swish(depthwise_kxk(e) * s1 + b1) * mask
//   g = sigmoid(swish(mean_window(d) @ w_se_r + b_se_r) @ w_se_e + b_se_e)
//   y = ((d * g) @ w_proj * s2 + b2) * mask  (+ x when Cin == Cout)
//
// with the batch norms folded to per-channel f32 scale and bias, and every
// channel count a multiple of 8 at both types (TMA wants 16-byte strides;
// the wrapper zero-pads other counts, which is exact).  A K chunk's tail
// beyond Cin or Cmid arrives zero-filled by TMA (a bf16 wgmma K step of 16
// values may hold 8 real ones); the N and channel tails are guarded in the
// tiles, the depthwise, the SE and the epilogue.  The two 1x1 weights come
// K-major, as ops/mbconv.py's kernel_operands makes them: wgmma takes
// non-16-bit operands from shared memory only K-major.  At f32 they are
// split for 3xTF32 (w_exp_kt = (hi, lo) of w_exp^T, (2, Cmid, Cin);
// w_proj_kt likewise (2, Cout, Cmid)); at bf16 they are w_exp^T and
// w_proj^T.
//
// Element type T (float or bf16).  x, the expand's halo tiles, e, d and y
// are T; so are the five weight matrices.  Every product runs on the
// tensor cores with f32 accumulation: three tf32 products (the 3xTF32
// split, f32 accuracy) at f32, one bf16 product at bf16.  BN, swish, the
// depthwise sums, the window masks, the SE sums and gate, and the residual
// add run in f32 registers.  At bf16 the rounding points are the Pallas
// kernel's: e is rounded to bf16 after BN0 + swish + mask, d after BN1 +
// swish + mask (the SE partial sums are taken from f32 d before that), the
// SE FCs' inputs and the gated d before their products, y once after the
// residual.  One difference stays: the Pallas kernel rounds each depthwise
// product e * w_dw to bf16 before its f32 sum; this kernel keeps the exact
// product (bf16 x bf16 fits f32) in its f32 FMA.  The bf16 swishes of BN0
// and BN1 take the fast exponential and division (a few f32 ulps, below
// the bf16 rounding that follows them).
//
// Bound on the card.  The ideal kernel moves x in and y out and does the
// 1x1 products (2*px*(Cin*Cmid + Cmid*Cout) FLOPs) on the tensor cores and
// the depthwise (2*px*k*k*Cmid) on the f32 pipes.  f32 accuracy on the
// tensor cores takes the 3xTF32 split (hopper.cuh): three tf32 products at
// 495/3 TFLOP/s.  At the b3 CAM shapes that bound is about half the f32
// one, and the early blocks (Cmid <= 288) sit on the bytes side.  At bf16
// the products run at 989 TFLOP/s and the activations move half the bytes,
// so the depthwise on the f32 pipes sets the bound at most shapes.
//
// Design: (a), (b) and (c) are separate launches, because the SE gate
// needs a reduction over the whole image before the project can start.  A
// K chunk is one 128-byte row: 32 channels at f32, 64 at bf16.
//
//   a. expand_dw: one CTA per (image, TH x 16 output tile, 64 mid
//      channels), TH = 12 at k = 3 and 8 at k = 5, so the halo (252 or 240
//      pixels, 1.31x and 1.88x the tile) fills four 64-row wgmma tiles.
//      Per K chunk of Cin, TMA brings the halo of x (one 128-byte swizzled
//      row per pixel; out-of-image pixels and channels arrive zero) and
//      the 64-row tiles of w_exp_kt (hi and lo at f32, one at bf16) into a
//      ring of two stages on mbarriers.  Each warpgroup runs the wgmma on
//      two of the row tiles: A (x) by ldmatrix into registers (split into
//      tf32 hi and lo there at f32), B from shared memory.  BN0 + swish +
//      mask write e over the ring.  TH is set by the four row tiles, not
//      by shared memory: the ring takes ~96 KB at f32 and ~80 KB at bf16
//      (one weight tile a stage), so two CTAs share an SM at both.
//      Without an expand, 32 channels of x go by TMA straight into e.  The
//      depthwise reads e from shared memory with the k*k taps in registers
//      (k shared reads per output, not k*k), then BN1 + swish + mask, SE
//      partial sums in a fixed order (no atomics), and d to HBM.  At f32 a
//      thread runs one channel along whole rows; at bf16 (depthwise_pairs)
//      two channels a 32-bit shared load along 8-column units, storing d
//      as bf16 pairs, 128 contiguous bytes a warp.  On the H100 the bf16
//      (a) is bound by these f32-pipe instructions (the depthwise and the
//      two swishes), not by its products or its bytes (PERF.md).
//   b. se, in two launches over (image, 128-channel slice): b1 reduces the
//      slice's partials to its mean and its share of FC1; b2 adds the
//      shares and runs FC2 for the slice's channels.  (a) and (b + c) are
//      separate entries: on a stripe of an image split over several cards
//      (parallel/spatial.py) x carries halo rows, (a) sums only the
//      stripe's own rows [row_lo, row_hi) into the partials, and the
//      caller adds the partials over the cards between the two.  The
//      window's oy is then in the stripe's rows and its h stays the
//      image's, so (b) divides by the whole window's pixel count.
//   c. project: 64-pixel x 64-channel tiles; a producer warp keeps a ring
//      of up to 4 stages of TMA tiles (d and w_proj_kt) in flight; a
//      consumer warpgroup runs the wgmma with A (d) from registers, where
//      the SE gate is applied (and, at f32, the hi/lo split; at bf16 the
//      gated d is rounded there), which costs nothing and avoids writing a
//      gated W per image (57 MB at _blocks_25), and B from shared memory;
//      BN2, the mask and the residual in the epilogue.  At f32 a CTA owns
//      one tile and stages its epilogue through shared memory for 16-byte
//      stores; at bf16 (project_bf16_kernel) a CTA walks up to 16 tiles
//      with the ring running on across them and stores bf16 pairs from
//      registers.
//
// d makes one round trip through HBM.  Keeping it on chip instead, by
// rebuilding e and d per project tile from x, measured ~3x slower than
// the round trip at every b3 CAM shape on an H100 (PERF.md), so d streams.
//
// Every sum runs in a fixed order: results repeat bit for bit.

#include <stddef.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int NT = 256;  // threads of the expand_dw CTAs
constexpr int TW = 16;   // output columns per tile

// The element types: the TMA map type, and the weight tiles a K chunk
// takes (hi and lo of the 3xTF32 split at f32, one at bf16).
template <class T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  static constexpr int NW = 2;
};
template <>
struct Elem<bf16> {
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr int NW = 1;
};

// channels of one K chunk: one 128-byte row
template <class T>
__host__ __device__ constexpr int kchunk() { return 128 / (int)sizeof(T); }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <class T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }
// v rounded to T, back in f32
template <class T>
__device__ __forceinline__ float round_as(float v) { return to_f(from_f<T>(v)); }

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf16_lo(r.x), bf16_hi(r.x), bf16_lo(r.y), bf16_hi(r.y));
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

__device__ __forceinline__ float sigmoidf_(float v) { return 1.f / (1.f + expf(-v)); }
__device__ __forceinline__ float swishf_(float v) { return v * sigmoidf_(v); }
// The swish of BN0 and BN1 in type T's kernel: at bf16 with the fast
// exponential and division (a few f32 ulps from swishf_, far below the bf16
// rounding that follows it), at f32 swishf_.
template <class T>
__device__ __forceinline__ float swish_t(float v) {
  if constexpr (std::is_same<T, float>::value)
    return swishf_(v);
  else
    return __fdividef(v, 1.f + __expf(-v));
}

__device__ __forceinline__ bool in_window(const int* w, int y, int x) {
  return y >= w[0] && y < w[0] + w[2] && x >= w[1] && x < w[1] + w[3];
}

__device__ __forceinline__ char* align1024(char* p) {
  return reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// The depthwise k x k + BN1 + swish over the TH x TW tile from e_s at f32
// (bf16 takes depthwise_pairs): thread (c = tid % TC, row group tid / TC)
// runs along its rows with the k*k taps in registers and a k x k window of
// e sliding along the row.  Calls out(ly, lx, c, v) for every output pixel
// of its rows, v before the mask.
template <int K, int TH, int TC, int ESP, class T, class Out>
__device__ __forceinline__ void depthwise_tile(const T* e_s, const T* __restrict__ w_dw,
                                               const float* __restrict__ s1,
                                               const float* __restrict__ b1, int c0, int Cmid,
                                               Out out) {
  constexpr int HW = TW + 2 * (K / 2);
  constexpr int RG = NT / TC;
  constexpr int RPG = (TH + RG - 1) / RG;
  const int c = threadIdx.x % TC, rg = threadIdx.x / TC;
  const bool cok = c0 + c < Cmid;
  float wk[K * K];
#pragma unroll
  for (int i = 0; i < K * K; ++i) wk[i] = cok ? to_f(w_dw[(size_t)i * Cmid + c0 + c]) : 0.f;
  const float sc1 = cok ? s1[c0 + c] : 0.f, bi1 = cok ? b1[c0 + c] : 0.f;
#pragma unroll 1
  for (int rr = 0; rr < RPG; ++rr) {
    const int ly = rg * RPG + rr;
    if (ly >= TH) break;
    float wnd[K][K];
#pragma unroll
    for (int ky = 0; ky < K; ++ky)
#pragma unroll
      for (int kx = 0; kx < K - 1; ++kx)
        wnd[ky][kx + 1] = to_f(e_s[((ly + ky) * HW + kx) * ESP + c]);
#pragma unroll
    for (int lx = 0; lx < TW; ++lx) {
      float a = 0.f;
#pragma unroll
      for (int ky = 0; ky < K; ++ky) {
#pragma unroll
        for (int kx = 0; kx < K - 1; ++kx) wnd[ky][kx] = wnd[ky][kx + 1];
        wnd[ky][K - 1] = to_f(e_s[((ly + ky) * HW + lx + K - 1) * ESP + c]);
#pragma unroll
        for (int kx = 0; kx < K; ++kx) a = fmaf(wnd[ky][kx], wk[ky * K + kx], a);
      }
      out(ly, lx, c, swishf_(a * sc1 + bi1));
    }
  }
}

// The depthwise at bf16, two channels a thread: thread (pair q = tid % NP,
// group tid / NP) computes channels c0 + 2q and c0 + 2q + 1 (one 32-bit
// shared load brings both) over units of 8 output columns of one row of the
// TH x TW tile, the units dealt to the NT / NP groups in turn.  Per unit it
// walks the k rows of e, each value read once into the sums of every
// output it touches (in the order of depthwise_tile: ky, then kx), in f32
// (each product of two bf16 values is exact in the FMA); then BN1 + swish +
// mask, d to HBM as one bf16 pair (a warp of 32 pairs writes 128 contiguous
// bytes a pixel), and the f32 d of rows [row_lo, row_hi) into psum.
template <int K, int TH, int NP, int ESP>
__device__ __forceinline__ void depthwise_pairs(const bf16* e_s, const bf16* __restrict__ w_dw,
                                                const float* __restrict__ s1,
                                                const float* __restrict__ b1,
                                                bf16* __restrict__ d, const int* win_s, int b,
                                                int ty0, int tx0, int c0, int H, int W, int Cmid,
                                                int row_lo, int row_hi, float2& psum) {
  constexpr int HW = TW + 2 * (K / 2), UW = 8, UPR = TW / UW, UNITS = TH * UPR;
  const int q = threadIdx.x % NP, grp = threadIdx.x / NP;
  const int c = c0 + 2 * q;
  const bool cok = c < Cmid;  // Cmid is even: both channels or neither
  float2 wk[K * K];
#pragma unroll
  for (int i = 0; i < K * K; ++i) {
    const uint32_t r = cok ? *reinterpret_cast<const uint32_t*>(w_dw + (size_t)i * Cmid + c) : 0u;
    wk[i] = make_float2(bf16_lo(r), bf16_hi(r));
  }
  const float2 sc = cok ? *reinterpret_cast<const float2*>(s1 + c) : make_float2(0.f, 0.f);
  const float2 bi = cok ? *reinterpret_cast<const float2*>(b1 + c) : make_float2(0.f, 0.f);
  const int oy = win_s[0], ox = win_s[1], wy1 = win_s[0] + win_s[2], wx1 = win_s[1] + win_s[3];
#pragma unroll 1
  for (int u = grp; u < UNITS; u += NT / NP) {
    const int ly = u / UPR, lx0 = (u % UPR) * UW, gy = ty0 + ly;
    if (gy >= H) continue;
    float2 acc[UW];
#pragma unroll
    for (int o = 0; o < UW; ++o) acc[o] = make_float2(0.f, 0.f);
#pragma unroll
    for (int ky = 0; ky < K; ++ky) {
      const bf16* row = e_s + ((ly + ky) * HW + lx0) * ESP + 2 * q;
#pragma unroll
      for (int xx = 0; xx < UW + K - 1; ++xx) {
        const uint32_t r = *reinterpret_cast<const uint32_t*>(row + xx * ESP);
        const float vx = bf16_lo(r), vy = bf16_hi(r);
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
          const int o = xx - kx;
          if (o >= 0 && o < UW) {
            acc[o].x = fmaf(vx, wk[ky * K + kx].x, acc[o].x);
            acc[o].y = fmaf(vy, wk[ky * K + kx].y, acc[o].y);
          }
        }
      }
    }
    const bool rowin = gy >= oy && gy < wy1, own = gy >= row_lo && gy < row_hi;
    bf16* dp = d + (((size_t)b * H + gy) * W + tx0 + lx0) * Cmid + c;
#pragma unroll
    for (int o = 0; o < UW; ++o) {
      const int gx = tx0 + lx0 + o;
      if (gx < W) {
        const bool keep = rowin && gx >= ox && gx < wx1;
        const float vx = keep ? swish_t<bf16>(acc[o].x * sc.x + bi.x) : 0.f;
        const float vy = keep ? swish_t<bf16>(acc[o].y * sc.y + bi.y) : 0.f;
        if (cok) *reinterpret_cast<uint32_t*>(dp + (size_t)o * Cmid) = pack_bf16(vx, vy);
        if (own) {  // f32 d, before the rounding; own rows only
          psum.x += vx;
          psum.y += vy;
        }
      }
    }
  }
}

// expand_dw's tiles: TH x 16 output pixels, 64 mid channels with an
// expand (the halo, 252 or 240 rows, fills four 64-row wgmma tiles), 32
// channels of x without one.
template <int K, bool EXPAND>
__host__ __device__ constexpr int dw_th() { return EXPAND && K == 3 ? 12 : 8; }
template <bool EXPAND>
__host__ __device__ constexpr int dw_tc() { return EXPAND ? 64 : 32; }

// Bytes of e without an expand: the halo of a TH x TW tile, TC channels.
template <int K, int TH, int TC, class T>
__host__ __device__ constexpr int x_tile_bytes() {
  return (TH + 2 * (K / 2)) * (TW + 2 * (K / 2)) * TC * (int)sizeof(T);
}

// e = x * mask for a block without an expand: one TMA box of TC channels
// over the halo of the output tile at (ty0, tx0) straight into e_s (pixels
// outside the image arrive zero), zeroed outside the window.  Ends
// synchronised.
template <int K, int TH, int TC, class T>
__device__ void load_x_tile(const CUtensorMap* xmap, T* e_s, uint64_t* bar, const int* win_s,
                            int b, int ty0, int tx0, int c0) {
  constexpr int P = K / 2, HW = TW + 2 * P;
  constexpr int BYTES = x_tile_bytes<K, TH, TC, T>(), N = BYTES / (int)sizeof(T);
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, BYTES);
    tma_load_4d(e_s, xmap, bar, c0, tx0 - P, ty0 - P, b);
  }
  mbar_wait(bar, 0);
  for (int pix = threadIdx.x; pix < N / TC; pix += NT)
    if (!in_window(win_s, ty0 - P + pix / HW, tx0 - P + pix % HW)) {
      uint4* row = reinterpret_cast<uint4*>(e_s + pix * TC);  // TC values: 64 or 128 bytes
#pragma unroll
      for (int i = 0; i < TC * (int)sizeof(T) / 16; ++i) row[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  __syncthreads();
}

// Shared memory of expand_dw's wgmma expand: two stages of (x halo chunk,
// written by TMA | the w_exp_kt chunk's tiles); e is written over them.
template <int K, int TH, class T>
struct WgTile {
  static constexpr int P = K / 2;
  static constexpr int HW = TW + 2 * P, HP = (TH + 2 * P) * HW;  // halo
  static constexpr int MT = (HP + 63) / 64;                      // 64-row wgmma tiles
  static constexpr int XBYTES = MT * 64 * 128, WBYTES = 64 * 128;
  static constexpr int STAGE = XBYTES + Elem<T>::NW * WBYTES;
  static constexpr int ESP = 64 + 16 / (int)sizeof(T);  // e row pitch (elements)
  static constexpr int REGION = cmax(2 * STAGE, HP * ESP * (int)sizeof(T));
};

// expand_dw's expand on wgmma: e (HP x ESP values at `buf`) for the halo of
// the output tile at (ty0, tx0), mid channels c0 .. c0 + 63.  Per K chunk
// of Cin, TMA brings the x halo and the w_exp_kt tiles into one of two
// stages (barrier xbar[kc % 2]), the next chunk's loads flying while this
// one is multiplied.  Warpgroup w runs the 64-row tiles 2w and 2w + 1
// against all 64 channels: A (x) by ldmatrix from the swizzled tile into
// registers, B (w) from shared memory.  At f32 A is split into tf32 hi and
// lo in registers and each tile's 3xTF32 products of the chunk go to a
// fresh accumulator added in f32; at bf16 one product per 16-deep step
// accumulates in place.  Ends synchronised.
template <int K, int TH, class T>
__device__ void expand_tile(const CUtensorMap* xmap, const CUtensorMap* wmap,
                            const float* __restrict__ s0, const float* __restrict__ b0, char* buf,
                            uint64_t* xbar, const int* win_s, int b, int ty0, int tx0, int c0,
                            int H, int W, int Cin, int Cmid) {
  using Tile = WgTile<K, TH, T>;
  constexpr int KC = kchunk<T>(), NW = Elem<T>::NW;
  static_assert(Tile::MT == 4 && NT == 256, "two 64-row tiles per warpgroup, two warpgroups");
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
  const int lr = lane & 7, lj = lane >> 3;
  const int nk = (Cin + KC - 1) / KC;
  auto issue = [&](int kc) {  // chunk kc into stage kc % 2
    char* st = buf + (kc & 1) * Tile::STAGE;
    uint64_t* bar = &xbar[kc & 1];
    mbar_expect_tx(bar, Tile::HP * 128 + NW * Tile::WBYTES);
    tma_load_4d(st, xmap, bar, kc * KC, tx0 - Tile::P, ty0 - Tile::P, b);
#pragma unroll
    for (int i = 0; i < NW; ++i)
      tma_load_3d(st + Tile::XBYTES + i * Tile::WBYTES, wmap, bar, kc * KC, c0, i);
  };
  if (tid == 0)
    for (int i = 0; i < 2 && i < nk; ++i) issue(i);
  float acc[2][32];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[m][i] = 0.f;

  for (int kc = 0; kc < nk; ++kc) {
    char* st = buf + (kc & 1) * Tile::STAGE;
    mbar_wait(&xbar[kc & 1], (kc >> 1) & 1);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      // ldmatrix rows of A: this warp's 16 rows of tile 2w + m, +8 for odd
      // j, the next 16-byte chunk for j >= 2 (row = lane mod 8, the swizzle)
      const int a_row = (2 * wg + m) * 64 + wl * 16 + lr + 8 * (lj & 1);
      if constexpr (std::is_same<T, float>::value) {
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t a[4];
          ldsm_x4(smem_addr(st) + a_row * 128 + (((2 * ks + (lj >> 1)) ^ lr) << 4), a);
#pragma unroll
          for (int q = 0; q < 4; ++q) split_tf32(__uint_as_float(a[q]), ah[ks][q], al[ks][q]);
        }
        float part[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          part[i] = 0.f;
          reg_fence(part[i]);
        }
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const uint64_t bh = desc_sw128(st + Tile::XBYTES + ks * 32);
          const uint64_t bl = desc_sw128(st + Tile::XBYTES + Tile::WBYTES + ks * 32);
          wgmma_m64n64k8_rs(part, al[ks], bh, ks > 0);
          wgmma_m64n64k8_rs(part, ah[ks], bl, 1);
          wgmma_m64n64k8_rs(part, ah[ks], bh, 1);
        }
        wgmma_commit();
        wgmma_wait0();
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          reg_fence(part[i]);
          acc[m][i] += part[i];
        }
      } else {
        uint32_t a[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          ldsm_x4(smem_addr(st) + a_row * 128 + (((2 * ks + (lj >> 1)) ^ lr) << 4), a[ks]);
#pragma unroll
        for (int i = 0; i < 32; ++i) reg_fence(acc[m][i]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_m64n64k16_bf16_rs(acc[m], a[ks], desc_sw128(st + Tile::XBYTES + ks * 32), 1);
        wgmma_commit();
        wgmma_wait0();
#pragma unroll
        for (int i = 0; i < 32; ++i) reg_fence(acc[m][i]);
      }
    }
    __syncthreads();  // the stage is consumed
    if (tid == 0 && kc + 2 < nk) issue(kc + 2);
  }

  // BN0 + swish + mask into e (over the consumed stages), rounded to T
  T* e_s = reinterpret_cast<T*>(buf);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = j * 8 + 2 * t, cc = c0 + col;
    const float2 sc = cc < Cmid ? *reinterpret_cast<const float2*>(s0 + cc) : float2{0.f, 0.f};
    const float2 bi = cc < Cmid ? *reinterpret_cast<const float2*>(b0 + cc) : float2{0.f, 0.f};
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = (2 * wg + m) * 64 + wl * 16 + g + 8 * h;
        if (row < Tile::HP) {
          const int gy = ty0 - Tile::P + row / Tile::HW, gx = tx0 - Tile::P + row % Tile::HW;
          const bool keep = gy >= 0 && gy < H && gx >= 0 && gx < W && in_window(win_s, gy, gx);
          const float ex = keep ? swish_t<T>(acc[m][4 * j + 2 * h] * sc.x + bi.x) : 0.f;
          const float ey = keep ? swish_t<T>(acc[m][4 * j + 2 * h + 1] * sc.y + bi.y) : 0.f;
          if constexpr (std::is_same<T, float>::value)
            *reinterpret_cast<float2*>(e_s + row * Tile::ESP + col) = make_float2(ex, ey);
          else
            *reinterpret_cast<uint32_t*>(e_s + row * Tile::ESP + col) = pack_bf16(ex, ey);
        }
      }
    }
  }
  __syncthreads();
}

template <int K, bool EXPAND, class T>
constexpr size_t expand_dw_smem() {
  constexpr int region = EXPAND ? WgTile<K, dw_th<K, EXPAND>(), T>::REGION
                                : x_tile_bytes<K, dw_th<K, EXPAND>(), dw_tc<EXPAND>(), T>();
  return 1024 + region + NT * 8 + 16 + 16;  // + the partials (a float2 a thread at bf16)
}

template <int K, bool EXPAND, class T>
__global__ void __launch_bounds__(NT, 2) expand_dw_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
    const int* __restrict__ win, const float* __restrict__ s0, const float* __restrict__ b0,
    const T* __restrict__ w_dw, const float* __restrict__ s1, const float* __restrict__ b1,
    T* __restrict__ d, float* __restrict__ part, int H, int W, int Cin, int Cmid,
    int tiles_w, int row_lo, int row_hi) {
  constexpr int TH = dw_th<K, EXPAND>(), TC = dw_tc<EXPAND>();
  constexpr int REGION = EXPAND ? WgTile<K, TH, T>::REGION : x_tile_bytes<K, TH, TC, T>();
  constexpr int ESP = EXPAND ? WgTile<K, TH, T>::ESP : TC;
  extern __shared__ char smem_raw[];
  char* base = align1024(smem_raw);
  float* red_s = reinterpret_cast<float*>(base + REGION);
  int* win_s = reinterpret_cast<int*>(red_s + 2 * NT);
  uint64_t* xbar = reinterpret_cast<uint64_t*>(win_s + 4);

  const int tid = threadIdx.x;
  const int b = blockIdx.z, c0 = blockIdx.y * TC;
  const int ty0 = (blockIdx.x / tiles_w) * TH, tx0 = (blockIdx.x % tiles_w) * TW;
  if (tid < 4) win_s[tid] = win[4 * b + tid];
  if (tid == 0) {
    mbar_init(&xbar[0], 1);
    mbar_init(&xbar[1], 1);
    fence_mbar_init();
  }
  __syncthreads();

  if constexpr (EXPAND) {
    expand_tile<K, TH, T>(&xmap, &wmap, s0, b0, base, xbar, win_s, b, ty0, tx0, c0, H, W, Cin,
                          Cmid);
  } else {
    load_x_tile<K, TH, TC, T>(&xmap, reinterpret_cast<T*>(base), &xbar[0], win_s, b, ty0, tx0,
                              c0);
  }

  if constexpr (std::is_same<T, bf16>::value) {
    constexpr int NP = TC / 2;
    float2 ps = make_float2(0.f, 0.f);
    depthwise_pairs<K, TH, NP, ESP>(reinterpret_cast<const bf16*>(base), w_dw, s1, b1, d, win_s,
                                    b, ty0, tx0, c0, H, W, Cmid, row_lo, row_hi, ps);
    float2* red2 = reinterpret_cast<float2*>(red_s);
    red2[tid] = ps;  // group tid / NP, channel pair tid % NP
    __syncthreads();
    if (tid < NP && c0 + 2 * tid < Cmid) {
      float2 s = make_float2(0.f, 0.f);
#pragma unroll
      for (int r = 0; r < NT / NP; ++r) {
        s.x += red2[r * NP + tid].x;
        s.y += red2[r * NP + tid].y;
      }
      *reinterpret_cast<float2*>(part + ((size_t)b * gridDim.x + blockIdx.x) * Cmid + c0 +
                                 2 * tid) = s;
    }
  } else {
    const size_t img = (size_t)b * H * W;
    float psum = 0.f;
    depthwise_tile<K, TH, TC, ESP, T>(reinterpret_cast<const T*>(base), w_dw, s1, b1, c0, Cmid,
                                      [&](int ly, int lx, int c, float v) {
                                        const int gy = ty0 + ly, gx = tx0 + lx;
                                        if (gy < H && gx < W) {
                                          v = in_window(win_s, gy, gx) ? v : 0.f;
                                          if (c0 + c < Cmid)
                                            d[(img + (size_t)gy * W + gx) * Cmid + c0 + c] = v;
                                          // own rows only
                                          if (gy >= row_lo && gy < row_hi) psum += v;
                                        }
                                      });
    red_s[tid] = psum;  // row group tid / TC, channel tid % TC
    __syncthreads();
    if (tid < TC && c0 + tid < Cmid) {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < NT / TC; ++r) s += red_s[r * TC + tid];
      part[((size_t)b * gridDim.x + blockIdx.x) * Cmid + c0 + tid] = s;
    }
  }
}

// (b) in two launches over (image, slice of SE_C channels), so the SE of a
// wide block runs on many SMs; the FC1 shares of the slices meet in
// scratch after the gates: gate (B, gate_floats(Cmid, Csq)) holds the
// gates (Cmid) and then the shares (se_slices(Cmid) x Csq) of each image.
constexpr int SE_C = 128, SE_NT = 512;

__host__ __device__ constexpr int se_slices(int Cmid) { return (Cmid + SE_C - 1) / SE_C; }
__host__ __device__ constexpr int gate_floats(int Cmid, int Csq) {
  return Cmid + se_slices(Cmid) * Csq;
}

// b1, CTA (slice s, image b): the mean of channels c0 .. c0 + SE_C - 1 over
// the partial sums of the tiles (thread (channel, row group), the groups'
// sums added through shared memory), rounded to T (the Pallas kernel's
// bf16 FC1 operand), and the slice's share of FC1, sum over its channels
// of mean[c] * w_r[c, j], for every squeeze channel j (thread (j, channel
// group): neighbouring lanes read neighbouring j of a row of w_r).  Every
// sum in a fixed order.
template <class T>
__global__ void __launch_bounds__(SE_NT) se_squeeze_kernel(
    const float* __restrict__ part, int ntiles, const int* __restrict__ win,
    const T* __restrict__ w_r, float* __restrict__ gate, int Cmid, int Csq) {
  __shared__ float mean[SE_C], red[SE_NT];
  const int s = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, c0 = s * SE_C;
  const int nc = min(SE_C, Cmid - c0);
  const float count = (float)(win[4 * b + 2] * win[4 * b + 3]);
  const float* pb = part + (size_t)b * ntiles * Cmid + c0;

  const int CW = (nc + 31) & ~31, R = SE_NT / CW;  // lanes a row group, row groups
  {
    const int c = tid % CW, r = tid / CW;
    float sum = 0.f;
    if (c < nc && r < R) {
#pragma unroll 16
      for (int t = r; t < ntiles; t += R) sum += pb[(size_t)t * Cmid + c];
    }
    red[tid] = sum;
  }
  __syncthreads();
  if (tid < SE_C) {
    float tot = 0.f;
    if (tid < nc)
      for (int i = 0; i < R; ++i) tot += red[i * CW + tid];
    mean[tid] = round_as<T>(tot / count);
  }
  __syncthreads();

  float* share = gate + (size_t)b * gate_floats(Cmid, Csq) + Cmid + (size_t)s * Csq;
  const int JW = min(SE_NT, (Csq + 31) & ~31), G = SE_NT / JW;
  for (int j0 = 0; j0 < Csq; j0 += JW) {
    const int j = j0 + tid % JW, grp = tid / JW;
    float sum = 0.f;
    if (j < Csq && grp < G) {
#pragma unroll 8
      for (int c = grp; c < nc; c += G)
        sum = fmaf(mean[c], to_f(w_r[(size_t)(c0 + c) * Csq + j]), sum);
    }
    __syncthreads();  // red is free
    red[tid] = sum;
    __syncthreads();
    if (tid < JW && j0 + tid < Csq) {
      float tot = 0.f;
      for (int i = 0; i < G; ++i) tot += red[i * JW + tid];
      share[j0 + tid] = tot;
    }
  }
}

// b2, CTA (slice s, image b): FC1 from the slices' shares (added in slice
// order) + b_r, swish, rounded to T, then the gates of the slice's
// channels, gate[b, c] = sigmoid(sum_j sq[j] * w_e[j, c] + b_e[c]): thread
// (channel, j group) sums every fourth j, the groups added through shared
// memory.
template <class T>
__global__ void __launch_bounds__(SE_NT) se_kernel(const T* __restrict__ w_e,
                                                   const float* __restrict__ b_r,
                                                   const float* __restrict__ b_e,
                                                   float* __restrict__ gate, int Cmid, int Csq) {
  constexpr int JG = SE_NT / SE_C;
  extern __shared__ float sq[];  // Csq
  __shared__ float red[SE_NT];
  const int s = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, ns = se_slices(Cmid);
  float* gb = gate + (size_t)b * gate_floats(Cmid, Csq);
  for (int j = tid; j < Csq; j += SE_NT) {
    float tot = 0.f;
    for (int i = 0; i < ns; ++i) tot += gb[Cmid + (size_t)i * Csq + j];
    sq[j] = round_as<T>(swishf_(tot + b_r[j]));
  }
  __syncthreads();
  const int c = s * SE_C + tid % SE_C, jg = tid / SE_C;
  float sum = 0.f;
  if (c < Cmid) {
#pragma unroll 8
    for (int j = jg; j < Csq; j += JG) sum = fmaf(sq[j], to_f(w_e[(size_t)j * Cmid + c]), sum);
  }
  red[tid] = sum;
  __syncthreads();
  if (tid < SE_C && c < Cmid) {
    float tot = 0.f;
#pragma unroll
    for (int i = 0; i < JG; ++i) tot += red[i * SE_C + tid];
    gb[c] = sigmoidf_(tot + b_e[c]);
  }
}

// ---- c, stream: wgmma project over d from HBM ------------------------------

constexpr int PBM = 64, PBN = 64, PSTAGES = 4;
constexpr int P_THREADS = 160;  // one consumer warpgroup and a producer warp
constexpr int PA_BYTES = PBM * 128, PB_BYTES = PBN * 128;
constexpr int PSTG = PBN + 4;  // epilogue staging pitch (floats)
constexpr int PSTG_BYTES = PBM * PSTG * 4;

template <class T>
__host__ __device__ constexpr int pstage_bytes() { return PA_BYTES + Elem<T>::NW * PB_BYTES; }

template <class T>
int project_stages(int Cmid) {
  const int nk = (Cmid + kchunk<T>() - 1) / kchunk<T>();
  return nk < PSTAGES ? nk : PSTAGES;
}

template <class T>
size_t project_smem(int Cmid) {
  const int nk = (Cmid + kchunk<T>() - 1) / kchunk<T>();
  return 1024 + cmax(project_stages<T>(Cmid) * pstage_bytes<T>(), PSTG_BYTES) +
         (size_t)nk * kchunk<T>() * 4 + 16 + 2 * PSTAGES * 8;
}

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// y[b, p, n] = ((d[b, p, :] * gate[b, :]) @ W_proj[:, n]) * s2[n] + b2[n],
// masked, plus x[b, p, n] with the residual, at f32; a CTA owns pixels p0
// .. p0 + 63 of image b and channels n0 .. n0 + 63.  (A CTA that walks
// several pixel tiles, with the ring running on across them, measured
// slower at every b3 shape at f32: it needs a staging buffer beside the
// ring, which halves the CTAs an SM holds.  bf16 takes project_bf16_kernel.)
template <class T>
__global__ void __launch_bounds__(P_THREADS) project_kernel(
    const __grid_constant__ CUtensorMap dmap, const __grid_constant__ CUtensorMap wmap,
    const float* __restrict__ gate, const float* __restrict__ s2, const float* __restrict__ b2,
    const T* __restrict__ x, const int* __restrict__ win, T* __restrict__ y, int H, int W,
    int Cmid, int Csq, int Cout, int has_skip, int stages) {
  static_assert(std::is_same<T, float>::value, "bf16 takes project_bf16_kernel");
  constexpr int KC = kchunk<T>(), NW = Elem<T>::NW, STAGE = pstage_bytes<T>();
  extern __shared__ char smem_raw[];
  char* ring = align1024(smem_raw);
  const int nk = (Cmid + KC - 1) / KC;
  float* gate_s = reinterpret_cast<float*>(ring + cmax(stages * STAGE, PSTG_BYTES));
  int* win_s = reinterpret_cast<int*>(gate_s + nk * KC);
  uint64_t* full = reinterpret_cast<uint64_t*>(win_s + 4);
  uint64_t* empty = full + PSTAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * PBN, p0 = blockIdx.y * PBM, b = blockIdx.z;
  for (int i = tid; i < nk * KC; i += P_THREADS)
    gate_s[i] = i < Cmid ? gate[(size_t)b * gate_floats(Cmid, Csq) + i] : 0.f;
  if (tid < 4) win_s[tid] = win[4 * b + tid];
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == 4) {  // producer
    if (lane == 0) {
      for (int kc = 0; kc < nk; ++kc) {
        const int s = kc % stages;
        if (kc >= stages) mbar_wait(&empty[s], ((kc / stages) - 1) & 1);
        char* st = ring + s * STAGE;
        mbar_expect_tx(&full[s], STAGE);
        tma_load_3d(st, &dmap, &full[s], kc * KC, p0, b);
#pragma unroll
        for (int i = 0; i < NW; ++i)
          tma_load_3d(st + PA_BYTES + i * PB_BYTES, &wmap, &full[s], kc * KC, n0, i);
      }
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3, lr = lane & 7, lj = lane >> 3;
  // ldmatrix rows of A (d): warp's 16 rows, +8 for odd j, next chunk for j >= 2
  const int a_row = warp * 16 + lr + 8 * (lj & 1);
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  for (int kc = 0; kc < nk; ++kc) {
    const int s = kc % stages;
    mbar_wait(&full[s], (kc / stages) & 1);
    const char* st = ring + s * STAGE;
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int k0 = ks * 8 + t;
      const float g0 = gate_s[kc * KC + k0], g1 = gate_s[kc * KC + k0 + 4];
      uint32_t a[4];
      ldsm_x4(smem_addr(st) + a_row * 128 + (((2 * ks + (lj >> 1)) ^ lr) << 4), a);
      const float gq[4] = {g0, g0, g1, g1};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        split_tf32(__uint_as_float(a[q]) * gq[q], ah[ks][q], al[ks][q]);
    }
    // this stage's 32-deep product in a fresh accumulator (the tensor
    // cores' accumulation truncates), added to acc in f32
    float part[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      part[i] = 0.f;
      reg_fence(part[i]);
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t dh = desc_sw128(st + PA_BYTES + ks * 32);
      const uint64_t dl = desc_sw128(st + PA_BYTES + PB_BYTES + ks * 32);
      wgmma_m64n64k8_rs(part, al[ks], dh, ks > 0);
      wgmma_m64n64k8_rs(part, ah[ks], dl, 1);
      wgmma_m64n64k8_rs(part, ah[ks], dh, 1);
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      reg_fence(part[i]);
      acc[i] += part[i];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // epilogue: stage the 64 x 64 tile over the ring, then 4-channel stores
  named_sync(1, 128);  // every consumer warp is done with the ring
  float* stg = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = j * 8 + 2 * t, row = warp * 16 + g;
    *reinterpret_cast<float2*>(stg + row * PSTG + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(stg + (row + 8) * PSTG + col) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  named_sync(1, 128);
  const int HWn = H * W;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int idx = i * 128 + tid, row = idx / 16, q = idx % 16;
    const int p = p0 + row, n = n0 + 4 * q;
    if (p < HWn && n < Cout) {
      const bool keep = in_window(win_s, p / W, p % W);
      float4 v = *reinterpret_cast<const float4*>(stg + row * PSTG + 4 * q);
      const float4 sc = *reinterpret_cast<const float4*>(s2 + n);
      const float4 bi = *reinterpret_cast<const float4*>(b2 + n);
      v.x = keep ? v.x * sc.x + bi.x : 0.f;
      v.y = keep ? v.y * sc.y + bi.y : 0.f;
      v.z = keep ? v.z * sc.z + bi.z : 0.f;
      v.w = keep ? v.w * sc.w + bi.w : 0.f;
      const size_t o = ((size_t)b * HWn + p) * Cout + n;
      if (has_skip) {
        const float4 r = load4(x + o);
        v.x += r.x;
        v.y += r.y;
        v.z += r.z;
        v.w += r.w;
      }
      store4(y + o, v);
    }
  }
}

// ---- c at bf16: several pixel tiles a CTA, the epilogue from registers -----

constexpr int PB16_STAGES = 4;

size_t project_bf16_smem(int Cmid) {
  const int nk = (Cmid + 63) / 64;
  return 1024 + PB16_STAGES * (PA_BYTES + PB_BYTES) + (size_t)nk * 64 * 4 + 2 * PBN * 4 + 16 +
         2 * PB16_STAGES * 8;
}

// project_kernel's product at bf16: a CTA owns channels n0 .. n0 + 63 of
// image b and the `tiles` pixel tiles (64 pixels each) from t0 on.  The
// producer warp runs the ring on across the tiles, so the next tiles' loads
// fly during a tile's product and epilogue; the consumer warpgroup gates and
// rounds A (d) in registers as project_kernel does, and applies BN2, the
// mask and the residual to its accumulators and stores y as bf16 pairs
// straight from registers: no staging buffer beside the ring, whose stages
// then hold four tiles ahead where a block's K is one chunk.
__global__ void __launch_bounds__(P_THREADS) project_bf16_kernel(
    const __grid_constant__ CUtensorMap dmap, const __grid_constant__ CUtensorMap wmap,
    const float* __restrict__ gate, const float* __restrict__ s2, const float* __restrict__ b2,
    const bf16* __restrict__ x, const int* __restrict__ win, bf16* __restrict__ y, int H, int W,
    int Cmid, int Csq, int Cout, int has_skip, int tiles) {
  constexpr int KC = 64, STAGE = PA_BYTES + PB_BYTES;
  extern __shared__ char smem_raw[];
  char* ring = align1024(smem_raw);
  const int nk = (Cmid + KC - 1) / KC;
  float* gate_s = reinterpret_cast<float*>(ring + PB16_STAGES * STAGE);
  float* s2_s = gate_s + nk * KC;
  float* b2_s = s2_s + PBN;
  int* win_s = reinterpret_cast<int*>(b2_s + PBN);
  uint64_t* full = reinterpret_cast<uint64_t*>(win_s + 4);
  uint64_t* empty = full + PB16_STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * PBN, b = blockIdx.z, HWn = H * W;
  const int t0 = blockIdx.y * tiles;
  const int nt = min(tiles, (HWn + PBM - 1) / PBM - t0);
  for (int i = tid; i < nk * KC; i += P_THREADS)
    gate_s[i] = i < Cmid ? gate[(size_t)b * gate_floats(Cmid, Csq) + i] : 0.f;
  for (int i = tid; i < PBN; i += P_THREADS) {
    s2_s[i] = n0 + i < Cout ? s2[n0 + i] : 0.f;
    b2_s[i] = n0 + i < Cout ? b2[n0 + i] : 0.f;
  }
  if (tid < 4) win_s[tid] = win[4 * b + tid];
  if (tid == 0) {
    for (int s = 0; s < PB16_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == 4) {  // producer: chunk kc of tile i is load it = i * nk + kc
    if (lane == 0) {
      for (int it = 0; it < nt * nk; ++it) {
        const int s = it % PB16_STAGES, i = it / nk, kc = it % nk;
        if (it >= PB16_STAGES) mbar_wait(&empty[s], ((it / PB16_STAGES) - 1) & 1);
        char* st = ring + s * STAGE;
        // with one K chunk every tile takes the same w_proj tile: each stage
        // keeps the one its first load brought
        const bool w = nk > 1 || it < PB16_STAGES;
        mbar_expect_tx(&full[s], w ? STAGE : PA_BYTES);
        tma_load_3d(st, &dmap, &full[s], kc * KC, (t0 + i) * PBM, b);
        if (w) tma_load_3d(st + PA_BYTES, &wmap, &full[s], kc * KC, n0, 0);
      }
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3, lr = lane & 7, lj = lane >> 3;
  // ldmatrix rows of A (d): warp's 16 rows, +8 for odd j, next chunk for j >= 2
  const int a_row = warp * 16 + lr + 8 * (lj & 1);
  for (int i = 0, it = 0; i < nt; ++i) {
    // the residual of this thread's outputs (rows 16 warp + g and + 8,
    // columns 8j + 2t, + 1), loaded before the product hides its latency
    const int pr = (t0 + i) * PBM + warp * 16 + g;
    uint32_t xr[2][8];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + 8 * j + 2 * t;
        xr[h][j] = has_skip && pr + 8 * h < HWn && n < Cout
                       ? *reinterpret_cast<const uint32_t*>(
                             x + ((size_t)b * HWn + pr + 8 * h) * Cout + n)
                       : 0u;
      }
    float acc[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[r] = 0.f;
    for (int kc = 0; kc < nk; ++kc, ++it) {
      const int s = it % PB16_STAGES;
      mbar_wait(&full[s], (it / PB16_STAGES) & 1);
      const char* st = ring + s * STAGE;
      // A: d (bf16 pairs) times the gate, rounded to bf16 again; a0/a1 hold
      // columns 2t, 2t + 1 of the 16-deep step, a2/a3 columns 2t + 8, 2t + 9
      uint32_t a[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const float* gk = gate_s + kc * KC + ks * 16 + 2 * t;
        uint32_t r[4];
        ldsm_x4(smem_addr(st) + a_row * 128 + (((2 * ks + (lj >> 1)) ^ lr) << 4), r);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int o = q < 2 ? 0 : 8;
          a[ks][q] = pack_bf16(bf16_lo(r[q]) * gk[o], bf16_hi(r[q]) * gk[o + 1]);
        }
      }
#pragma unroll
      for (int r = 0; r < 32; ++r) reg_fence(acc[r]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_m64n64k16_bf16_rs(acc, a[ks], desc_sw128(st + PA_BYTES + ks * 32), 1);
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int r = 0; r < 32; ++r) reg_fence(acc[r]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    // epilogue: rows 16 warp + g and + 8 of the tile, columns 8j + 2t, + 1
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = pr + 8 * h;
      if (p >= HWn) continue;
      const bool keep = in_window(win_s, p / W, p % W);
      const size_t o = ((size_t)b * HWn + p) * Cout + n0 + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * t;
        if (n0 + col < Cout) {  // Cout is even: both channels or neither
          float vx = keep ? acc[4 * j + 2 * h] * s2_s[col] + b2_s[col] : 0.f;
          float vy = keep ? acc[4 * j + 2 * h + 1] * s2_s[col + 1] + b2_s[col + 1] : 0.f;
          if (has_skip) {
            vx += bf16_lo(xr[h][j]);
            vy += bf16_hi(xr[h][j]);
          }
          *reinterpret_cast<uint32_t*>(y + o + 8 * j) = pack_bf16(vx, vy);
        }
      }
    }
  }
}

// ---- host ---------------------------------------------------------------------

// The pointers of one call: x, d, y, the weight matrices and the K-major
// operands in the element type, the scales and biases f32.
struct Args {
  const void *x, *w_exp_kt, *w_dw, *w_se_r, *w_se_e, *w_proj_kt;
  const float *s0, *b0, *s1, *b1, *b_se_r, *b_se_e, *s2, *b2;
  const int* win;
  void* d;
  float *part, *gate;
  void* y;
  int B, H, W, Cin, Cmid, Csq, Cout, has_skip;
  int row_lo, row_hi;  // (a): the rows whose d enters the SE partials
  int ntiles;          // (b): partial sums per image in part
  cudaStream_t st;
};

// x (B, H, W, C) as a 4-D tensor map with a box of `cbox` channels over
// a th x 16 tile's (th + 2p) x (16 + 2p) pixel halo; the 128-byte swizzle for the
// expand's K chunks, none where e = x is taken whole into e_s.
template <class T>
bool x_map(CUtensorMap* map, const Args& a, int cbox, int k, int th, bool swizzle) {
  const int p = k / 2;
  const uint64_t dims[4] = {(uint64_t)a.Cin, (uint64_t)a.W, (uint64_t)a.H, (uint64_t)a.B};
  const uint32_t box[4] = {(uint32_t)cbox, (uint32_t)(TW + 2 * p), (uint32_t)(th + 2 * p), 1};
  return make_tensor_map(map, Elem<T>::MAP, sizeof(T), a.x, 4, dims, box, swizzle);
}

// A K-major weight (NW, rows, K) as a 3-D map of (K chunk) x `rows_box`
// tiles in the 128-byte swizzle.
template <class T>
bool kt_map(CUtensorMap* map, const void* w, int rows, int K, int rows_box) {
  const uint64_t dims[3] = {(uint64_t)K, (uint64_t)rows, (uint64_t)Elem<T>::NW};
  const uint32_t box[3] = {(uint32_t)kchunk<T>(), (uint32_t)rows_box, 1};
  return make_tensor_map(map, Elem<T>::MAP, sizeof(T), w, 3, dims, box, true);
}

// Raises `kernel`'s dynamic shared memory limit to `bytes` where `done`
// (the size set so far on each device, one array per kernel) is below it,
// and asks for the largest shared-memory carveout, so that as many CTAs as
// the shared memory allows share an SM.
template <class F>
cudaError_t set_smem(F* kernel, size_t bytes, size_t* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64) return err != cudaSuccess ? err : cudaErrorInvalidDevice;
  if (done[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) done[dev] = bytes;
  return err;
}

template <int K, bool EXPAND, class T>
cudaError_t launch_expand_dw(const Args& a) {
  constexpr int TC = dw_tc<EXPAND>(), TH = dw_th<K, EXPAND>();
  CUtensorMap xm, wm;
  if (!x_map<T>(&xm, a, EXPAND ? kchunk<T>() : TC, K, TH, EXPAND)) return cudaErrorInvalidValue;
  if (!EXPAND)
    wm = xm;  // unused
  else if (!kt_map<T>(&wm, a.w_exp_kt, a.Cmid, a.Cin, TC))
    return cudaErrorInvalidValue;
  const int tiles_w = (a.W + TW - 1) / TW, tiles_h = (a.H + TH - 1) / TH;
  const dim3 grid(tiles_h * tiles_w, (a.Cmid + TC - 1) / TC, a.B);
  constexpr size_t smem = expand_dw_smem<K, EXPAND, T>();
  static size_t done[64] = {};
  cudaError_t err = set_smem(expand_dw_kernel<K, EXPAND, T>, smem, done);
  if (err != cudaSuccess) return err;
  expand_dw_kernel<K, EXPAND, T><<<grid, NT, smem, a.st>>>(
      xm, wm, a.win, a.s0, a.b0, static_cast<const T*>(a.w_dw), a.s1, a.b1,
      static_cast<T*>(a.d), a.part, a.H, a.W, a.Cin, a.Cmid, tiles_w, a.row_lo, a.row_hi);
  return cudaGetLastError();
}

template <class T>
cudaError_t launch_project(const Args& a) {
  CUtensorMap dmap, wmap;
  const uint64_t ddims[3] = {(uint64_t)a.Cmid, (uint64_t)a.H * a.W, (uint64_t)a.B};
  const uint32_t dbox[3] = {(uint32_t)kchunk<T>(), PBM, 1};
  if (!make_tensor_map(&dmap, Elem<T>::MAP, sizeof(T), a.d, 3, ddims, dbox, true) ||
      !kt_map<T>(&wmap, a.w_proj_kt, a.Cout, a.Cmid, PBN))
    return cudaErrorInvalidValue;
  const int ntp = (a.H * a.W + PBM - 1) / PBM, nn = (a.Cout + PBN - 1) / PBN;
  if constexpr (std::is_same<T, bf16>::value) {
    // pixel tiles a CTA: enough CTAs for about two waves of three an SM, at most 16 tiles each
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    const long per = (long)ntp * nn * a.B / (6L * sms);
    const int tiles = per < 1 ? 1 : per > 16 ? 16 : (int)per;
    const size_t smem = project_bf16_smem(a.Cmid);
    static size_t done[64] = {};
    err = set_smem(project_bf16_kernel, smem, done);
    if (err != cudaSuccess) return err;
    project_bf16_kernel<<<dim3(nn, (ntp + tiles - 1) / tiles, a.B), P_THREADS, smem, a.st>>>(
        dmap, wmap, a.gate, a.s2, a.b2, static_cast<const bf16*>(a.x), a.win,
        static_cast<bf16*>(a.y), a.H, a.W, a.Cmid, a.Csq, a.Cout, a.has_skip, tiles);
  } else {
    const size_t smem = project_smem<T>(a.Cmid);
    static size_t done[64] = {};
    cudaError_t err = set_smem(project_kernel<T>, smem, done);
    if (err != cudaSuccess) return err;
    project_kernel<T><<<dim3(nn, ntp, a.B), P_THREADS, smem, a.st>>>(
        dmap, wmap, a.gate, a.s2, a.b2, static_cast<const T*>(a.x), a.win, static_cast<T*>(a.y),
        a.H, a.W, a.Cmid, a.Csq, a.Cout, a.has_skip, project_stages<T>(a.Cmid));
  }
  return cudaGetLastError();
}

int partials_per_image(int H, int W, int k, int has_expand) {
  const int th = has_expand && k == 3 ? dw_th<3, true>() : dw_th<5, false>();
  return ((H + th - 1) / th) * ((W + TW - 1) / TW);
}

// Launch (a) on a.st; returns its error (an invalid value when a tensor
// map is refused or a channel count is not a multiple of the type's
// granularity), 0 on success.
template <class T>
int run_expand_dw(const Args& a, int k, int has_expand) {
  constexpr int MULT = 8;  // channel granularity: 16-byte TMA strides at both types
  if ((k != 3 && k != 5) || a.Cin % MULT || a.Cmid % MULT) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (k == 3)
    err = has_expand ? launch_expand_dw<3, true, T>(a) : launch_expand_dw<3, false, T>(a);
  else
    err = has_expand ? launch_expand_dw<5, true, T>(a) : launch_expand_dw<5, false, T>(a);
  return (int)err;
}

// Launches (b) and (c) on a.st; returns the first launch error, 0 on
// success.
template <class T>
int run_se_project(const Args& a) {
  constexpr int MULT = 8;
  if (a.Cmid % MULT || a.Cout % MULT || a.ntiles < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(se_slices(a.Cmid), a.B);
  se_squeeze_kernel<T><<<grid, SE_NT, 0, a.st>>>(a.part, a.ntiles, a.win,
                                                 static_cast<const T*>(a.w_se_r), a.gate, a.Cmid,
                                                 a.Csq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  se_kernel<T><<<grid, SE_NT, (size_t)a.Csq * sizeof(float), a.st>>>(
      static_cast<const T*>(a.w_se_e), a.b_se_r, a.b_se_e, a.gate, a.Cmid, a.Csq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_project<T>(a);
}

template <class T>
int expand_dw_entry(const void* x, const int* win, const void* w_exp_kt, const float* s0,
                    const float* b0, const void* w_dw, const float* s1, const float* b1,
                    void* d, float* part, int B, int H, int W, int Cin, int Cmid, int k,
                    int has_expand, int row_lo, int row_hi, void* stream) {
  Args a{};
  a.x = x, a.win = win, a.w_exp_kt = w_exp_kt, a.s0 = s0, a.b0 = b0, a.w_dw = w_dw;
  a.s1 = s1, a.b1 = b1, a.d = d, a.part = part;
  a.B = B, a.H = H, a.W = W, a.Cin = Cin, a.Cmid = Cmid;
  a.row_lo = row_lo, a.row_hi = row_hi, a.st = (cudaStream_t)stream;
  return run_expand_dw<T>(a, k, has_expand);
}

template <class T>
int se_project_entry(const void* x, const int* win, const float* part, const void* w_se_r,
                     const float* b_se_r, const void* w_se_e, const float* b_se_e,
                     const void* w_proj_kt, const float* s2, const float* b2, const void* d,
                     float* gate, void* y, int B, int H, int W, int Cmid, int Csq, int Cout,
                     int ntiles, int has_skip, void* stream) {
  Args a{};
  a.x = x, a.win = win, a.part = const_cast<float*>(part), a.w_se_r = w_se_r;
  a.b_se_r = b_se_r, a.w_se_e = w_se_e, a.b_se_e = b_se_e, a.w_proj_kt = w_proj_kt;
  a.s2 = s2, a.b2 = b2, a.d = const_cast<void*>(d), a.gate = gate, a.y = y;
  a.B = B, a.H = H, a.W = W, a.Cmid = Cmid, a.Csq = Csq, a.Cout = Cout;
  a.ntiles = ntiles, a.has_skip = has_skip, a.st = (cudaStream_t)stream;
  return run_se_project<T>(a);
}

}  // namespace

extern "C" {

// SE partial sums per image: the number of expand_dw tiles.
int mbconv_partials_per_image(int H, int W, int k, int has_expand) {
  return partials_per_image(H, W, k, has_expand);
}

// Floats per image of the gate scratch of mbconv_se_project_*: the gates,
// then the SE's FC1 shares of each channel slice.
int mbconv_gate_floats(int Cmid, int Csq) { return gate_floats(Cmid, Csq); }

const char* mbconv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// A block call is two entries on `stream`, each returning its first launch
// error (cudaGetLastError after each launch; an invalid value when a tensor
// map is refused or a channel count is off), 0 on success.  Channel counts
// are multiples of 8.
//
// mbconv_expand_dw_*: launch (a), d (B, H, W, Cmid) and the SE partial sums
// part (B, mbconv_partials_per_image, Cmid) of the rows [row_lo, row_hi)
// (0 and H for a whole image).
int mbconv_expand_dw_f32(const float* x, const int* win, const float* w_exp_kt, const float* s0,
                         const float* b0, const float* w_dw, const float* s1, const float* b1,
                         float* d, float* part, int B, int H, int W, int Cin, int Cmid, int k,
                         int has_expand, int row_lo, int row_hi, void* stream) {
  return expand_dw_entry<float>(x, win, w_exp_kt, s0, b0, w_dw, s1, b1, d, part, B, H, W, Cin,
                                Cmid, k, has_expand, row_lo, row_hi, stream);
}

// mbconv_se_project_*: launches (b) and (c), the gate from `ntiles` partial
// sums per image in part (B, ntiles, Cmid), then y (B, H, W, Cout); gate is
// scratch of (B, mbconv_gate_floats(Cmid, Csq)).
int mbconv_se_project_f32(const float* x, const int* win, const float* part,
                          const float* w_se_r, const float* b_se_r, const float* w_se_e,
                          const float* b_se_e, const float* w_proj_kt, const float* s2,
                          const float* b2, const float* d, float* gate, float* y, int B, int H,
                          int W, int Cmid, int Csq, int Cout, int ntiles, int has_skip,
                          void* stream) {
  return se_project_entry<float>(x, win, part, w_se_r, b_se_r, w_se_e, b_se_e, w_proj_kt, s2,
                                 b2, d, gate, y, B, H, W, Cmid, Csq, Cout, ntiles, has_skip,
                                 stream);
}

// The same at bf16: x, the weight matrices, the K-major operands, d and y
// bf16 (pointers to __nv_bfloat16), the rest f32.
int mbconv_expand_dw_bf16(const void* x, const int* win, const void* w_exp_kt, const float* s0,
                          const float* b0, const void* w_dw, const float* s1, const float* b1,
                          void* d, float* part, int B, int H, int W, int Cin, int Cmid, int k,
                          int has_expand, int row_lo, int row_hi, void* stream) {
  return expand_dw_entry<bf16>(x, win, w_exp_kt, s0, b0, w_dw, s1, b1, d, part, B, H, W, Cin,
                               Cmid, k, has_expand, row_lo, row_hi, stream);
}

int mbconv_se_project_bf16(const void* x, const int* win, const float* part,
                           const void* w_se_r, const float* b_se_r, const void* w_se_e,
                           const float* b_se_e, const void* w_proj_kt, const float* s2,
                           const float* b2, const void* d, float* gate, void* y, int B, int H,
                           int W, int Cmid, int Csq, int Cout, int ntiles, int has_skip,
                           void* stream) {
  return se_project_entry<bf16>(x, win, part, w_se_r, b_se_r, w_se_e, b_se_e, w_proj_kt, s2,
                                b2, d, gate, y, B, H, W, Cmid, Csq, Cout, ntiles, has_skip,
                                stream);
}

}  // extern "C"
