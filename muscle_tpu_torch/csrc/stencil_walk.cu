// Stencil random walk for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel muscle_tpu/ops/pallas/stencil_walk.py
// (stencil_walk_pallas / _make_kernel).  For x (B, C, H, W), per-direction
// affinities vs (B, D, H, W) and reciprocal column sums inv (B, H, W), each
// of `steps` iterations computes, per image b, class c and pixel p:
//
//   x'[p] = (x[p] + sum_d x[p-d] * v_d[p-d] + x[p+d] * v_d[p]) * inv[p]
//
// with neighbours outside the H x W grid contributing zero (the walk
// x <- x @ T with T column-normalised, written as a stencil).  The D = 34
// directions are those of radius 5 (ops/random_walk.py _directions); the
// caller's table is checked against the one compiled in here.  Every pixel
// has 68 neighbours in 9 rows (dy = -4 .. 4, |dx| <= 4, 3 or 2).
//
// Bound on the card: B*C*steps*H*W*(4D+1) f32 operations against x, vs and
// inv read once and x' written once; at the IRN shapes (B 8, C 20,
// 128 x 128, 64 steps) the operations bound it: 0.343 ms at 67 TFLOP/s.
//
// Design.  The weights are the costly operand: 68 per pixel, shared by the
// C classes, against one iterate value per pixel and class.  One launch is
// one step; a CTA owns a 32 x 16 pixel tile of one image:
//
// - Staging by TMA, no index arithmetic.  One 3-D box (40 x 20 x 34) brings
//   the tile's vs with a 4-pixel halo on top and at the sides (v_d[p - d]
//   lies up to 4 rows above p), one box (40 x 24 x K) each class chunk of
//   the iterate with its 4-pixel halo; the map's out-of-bounds fill gives
//   the zero border the walk needs.  The width is padded to a multiple of
//   4 by the wrapper (TMA strides are 16-byte multiples), with zeros that
//   the walk keeps zero.
// - Register blocking.  A thread owns 4 neighbouring pixels of one row and
//   CC classes.  For each of the 9 tap rows it reads that row's weights for
//   its 4 pixels into registers once (float4 shared loads; a -d weight at a
//   column not a multiple of 4 is two aligned loads and a register shift),
//   then per class one 12-value window (3 float4 loads) and runs every tap
//   of the row from registers: ~0.4 shared words per FMA instead of the
//   previous version's 1, and the weights are read once per class chunk,
//   not once per class.
// - Class groups.  Up to 2 groups of 128 threads split a chunk's classes,
//   so a CTA has 8 warps at C = 20 (CC = 10); a walk with more classes than
//   one chunk (20) takes chunks of 10 in a double-buffered pass loop: the
//   next chunk's TMA load runs while this one computes.
// - Launch cost.  Steps after the first launch as programmatic dependents:
//   a CTA stages its (constant) vs tile and inv before it waits for the
//   previous step's iterate, so that load overlaps the previous step's tail.
//
// PERF.md (PR 4) has the ablation of the previous version and the times.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>
#include <utility>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int RADIUS = 5;
constexpr int HALO = RADIUS - 1;  // max |dy|, |dx| of a direction
constexpr int TW = 32, TH = 16;   // tile: columns, rows
constexpr int QP = 4;             // pixels per thread, along a row
constexpr int GT = (TW / QP) * TH;  // threads of a class group: 128
constexpr int XP = TW + 2 * HALO;   // staged row pitch (floats): 40
constexpr int XR = TH + 2 * HALO;   // staged iterate rows: 24
constexpr int VR = TH + HALO;       // staged vs rows (top halo only): 20

// The d-th search direction (dy if want_y else dx), in the enumeration
// order of ops/random_walk.py _directions: strictly right on the first
// row, then every (y > 0, x) inside the disc.
__host__ __device__ constexpr int direction(int d, bool want_y) {
  int n = 0;
  for (int x = 1; x < RADIUS; ++x) {
    if (n == d) return want_y ? 0 : x;
    ++n;
  }
  for (int y = 1; y < RADIUS; ++y)
    for (int x = -RADIUS + 1; x < RADIUS; ++x)
      if (x * x + y * y < RADIUS * RADIUS) {
        if (n == d) return want_y ? y : x;
        ++n;
      }
  return 1 << 20;  // past the last direction
}

__host__ __device__ constexpr int count_directions() {
  int n = 0;
  while (direction(n, true) != (1 << 20)) ++n;
  return n;
}

constexpr int D = count_directions();
static_assert(D == 34, "radius 5 has 34 search directions");

// The index of direction (dy, dx), or -1.
__host__ __device__ constexpr int dir_index(int dy, int dx) {
  for (int d = 0; d < D; ++d)
    if (direction(d, true) == dy && direction(d, false) == dx) return d;
  return -1;
}

// Max |dx| of a neighbour in tap row dy.
__host__ __device__ constexpr int row_reach(int dy) {
  int r = 0;
  while ((r + 1) * (r + 1) + dy * dy < RADIUS * RADIUS) ++r;
  return r;
}

constexpr int VT_FLOATS = D * VR * XP;  // staged vs tile
constexpr int XT_FLOATS = XR * XP;      // one staged class plane
static_assert((VT_FLOATS * 4) % 128 == 0 && (XT_FLOATS * 4) % 128 == 0, "TMA destinations");

template <class F, int... I>
__device__ __forceinline__ void unrolled_seq(F&& f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}

// f(integral_constant<int, i>) for i = 0 .. N-1, unrolled at compile time.
template <int N, class F>
__device__ __forceinline__ void unrolled(F&& f) {
  unrolled_seq(f, std::make_integer_sequence<int, N>{});
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Keeps the compiler from moving shared-memory loads across this point, so
// one tap row's weights and windows are live at a time (hoisting the next
// rows' loads spills).
__device__ __forceinline__ void row_fence() { asm volatile("" ::: "memory"); }

__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// The weights of tap (DY, DX) for the thread's 4 pixels.  A +d tap (the
// neighbour p + d) weighs v_d[p]; a -d tap (the neighbour p - d, DY <= 0)
// weighs v_d[p - d], which lies DY rows and DX columns from p in the tile.
template <int DY, int DX>
__device__ __forceinline__ void tap_weight(float (&w)[4], const float* vt, int ry, int qx) {
  constexpr int dp = dir_index(DY, DX);
  if constexpr (dp >= 0) {
    const float4 t = lds4(vt + (dp * VR + ry + HALO) * XP + HALO + QP * qx);
    w[0] = t.x, w[1] = t.y, w[2] = t.z, w[3] = t.w;
  } else {
    constexpr int dm = dir_index(-DY, -DX);
    static_assert(dm >= 0, "every neighbour is a +d or a -d");
    constexpr int base = HALO + DX, a = base & ~3, s = base & 3;
    const float* row = vt + (dm * VR + ry + HALO + DY) * XP + QP * qx + a;
    const float4 f0 = lds4(row);
    if constexpr (s == 0) {
      w[0] = f0.x, w[1] = f0.y, w[2] = f0.z, w[3] = f0.w;
    } else {
      const float4 f1 = lds4(row + 4);
      const float v[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
      w[0] = v[s], w[1] = v[s + 1], w[2] = v[s + 2], w[3] = v[s + 3];
    }
  }
}

// Tap row DY for CC classes: the row's weights once, then per class one
// 12-value window and every tap of the row.  The centre row starts the
// accumulators at x[p].
template <int DY, int CC>
__device__ __forceinline__ void tap_row(float (&acc)[CC][QP], const float* vt, const float* xs,
                                        int ry, int qx) {
  constexpr int R = row_reach(DY);
  float w[2 * R + 1][QP];
  unrolled<2 * R + 1>([&](auto jc) {
    constexpr int DX = decltype(jc)::value - R;
    if constexpr (DY != 0 || DX != 0) tap_weight<DY, DX>(w[DX + R], vt, ry, qx);
  });
#pragma unroll
  for (int cls = 0; cls < CC; ++cls) {
    const float* row = xs + (cls * XR + ry + HALO + DY) * XP + QP * qx;
    float v[12];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float4 t = lds4(row + 4 * q);
      v[4 * q] = t.x, v[4 * q + 1] = t.y, v[4 * q + 2] = t.z, v[4 * q + 3] = t.w;
    }
    if constexpr (DY == 0) {
#pragma unroll
      for (int i = 0; i < QP; ++i) acc[cls][i] = v[HALO + i];
    }
    unrolled<2 * R + 1>([&](auto jc) {
      constexpr int DX = decltype(jc)::value - R;
      if constexpr (DY != 0 || DX != 0) {
#pragma unroll
        for (int i = 0; i < QP; ++i) acc[cls][i] = fmaf(v[HALO + DX + i], w[DX + R][i], acc[cls][i]);
      }
    });
  }
  row_fence();
}

size_t smem_bytes(int k, int nbuf) {
  return 128 + sizeof(float) * ((size_t)VT_FLOATS + (size_t)nbuf * k * XT_FLOATS) + 3 * 8;
}

// One step.  xmap: the iterate (W, H, B*C), box (XP, XR, K); vmap: vs (W,
// H, B*D), box (XP, VR, D).  W is a multiple of 4.  Block: ng groups of GT
// threads; grid (W / TW, H / TH, B) rounded up.
template <int CC>
__global__ void __launch_bounds__(2 * GT, 1)
stencil_step(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap vmap,
             const float* __restrict__ inv, float* __restrict__ y, int C, int H, int W, int ng,
             int passes) {
  extern __shared__ unsigned char smem_raw[];
  float* vt = reinterpret_cast<float*>((reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  const int K = ng * CC;
  const int nbuf = passes > 1 ? 2 : 1;
  float* xt = vt + VT_FLOATS;
  uint64_t* bar = reinterpret_cast<uint64_t*>(xt + (size_t)nbuf * K * XT_FLOATS);  // vs, x[2]

  const int tid = threadIdx.x;
  const int grp = tid / GT, lt = tid % GT;
  const int qx = lt % (TW / QP), ry = lt / (TW / QP);
  const int b = blockIdx.z, r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  griddep_launch_dependents();
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i], 1);
    fence_mbar_init();
    mbar_expect_tx(&bar[0], VT_FLOATS * 4);  // vs is constant: staged before the wait
    tma_load_3d(vt, &vmap, &bar[0], c0 - HALO, r0 - HALO, b * D);
  }
  const int r = r0 + ry, c = c0 + QP * qx;
  const bool live = r < H && c < W;
  float4 iv = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live) iv = __ldg(reinterpret_cast<const float4*>(inv + ((size_t)b * H + r) * W + c));
  griddep_wait();  // the previous step's iterate is complete from here on
  if (tid == 0) {
    for (int k = 0; k < nbuf; ++k) {
      mbar_expect_tx(&bar[1 + k], K * XT_FLOATS * 4);
      tma_load_3d(xt + (size_t)k * K * XT_FLOATS, &xmap, &bar[1 + k], c0 - HALO, r0 - HALO,
                  b * C + k * K);
    }
  }
  __syncthreads();  // the barriers' initialisation is visible
  mbar_wait(&bar[0], 0);

  const size_t hw = (size_t)H * W;
  for (int k = 0; k < passes; ++k) {
    const int buf = k & (nbuf - 1);
    mbar_wait(&bar[1 + buf], (k >> 1) & 1);
    const float* xs = xt + ((size_t)buf * K + grp * CC) * XT_FLOATS;
    float acc[CC][QP];
    tap_row<0, CC>(acc, vt, xs, ry, qx);
    tap_row<-4, CC>(acc, vt, xs, ry, qx);
    tap_row<-3, CC>(acc, vt, xs, ry, qx);
    tap_row<-2, CC>(acc, vt, xs, ry, qx);
    tap_row<-1, CC>(acc, vt, xs, ry, qx);
    tap_row<1, CC>(acc, vt, xs, ry, qx);
    tap_row<2, CC>(acc, vt, xs, ry, qx);
    tap_row<3, CC>(acc, vt, xs, ry, qx);
    tap_row<4, CC>(acc, vt, xs, ry, qx);
    const int cls0 = k * K + grp * CC;
    if (live) {
      float* yb = y + ((size_t)b * C + cls0) * hw + (size_t)r * W + c;
#pragma unroll
      for (int cls = 0; cls < CC; ++cls)
        if (cls0 + cls < C)
          *reinterpret_cast<float4*>(yb + cls * hw) =
              make_float4(acc[cls][0] * iv.x, acc[cls][1] * iv.y, acc[cls][2] * iv.z,
                          acc[cls][3] * iv.w);
    }
    if (k + 2 < passes) {  // refill this buffer with chunk k + 2
      __syncthreads();
      if (tid == 0) {
        mbar_expect_tx(&bar[1 + buf], K * XT_FLOATS * 4);
        tma_load_3d(xt + (size_t)buf * K * XT_FLOATS, &xmap, &bar[1 + buf], c0 - HALO, r0 - HALO,
                    b * C + (k + 2) * K);
      }
    }
  }
}

bool make_map(CUtensorMap* map, const float* base, int W, int H, int planes, int box_rows,
              int box_planes) {
  const uint64_t dims[3] = {(uint64_t)W, (uint64_t)H, (uint64_t)planes};
  const uint32_t box[3] = {(uint32_t)XP, (uint32_t)box_rows, (uint32_t)box_planes};
  return make_map_f32(map, base, 3, dims, box, false);
}

template <int CC>
int run(const float* x0, const float* vs, const float* inv, float* tmp, float* y, int B, int C,
        int H, int W, int steps, int ng, cudaStream_t st) {
  const int K = ng * CC, passes = (C + K - 1) / K, nbuf = passes > 1 ? 2 : 1;
  const size_t smem = smem_bytes(K, nbuf);
  cudaError_t err = cudaFuncSetAttribute(stencil_step<CC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap vmap, map_x0, map_tmp, map_y;
  if (!make_map(&vmap, vs, W, H, B * D, VR, D) || !make_map(&map_x0, x0, W, H, B * C, XR, K) ||
      !make_map(&map_tmp, tmp, W, H, B * C, XR, K) || !make_map(&map_y, y, W, H, B * C, XR, K))
    return (int)cudaErrorInvalidValue;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  cfg.blockDim = dim3(ng * GT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  const CUtensorMap* src = &map_x0;
  for (int s = 0; s < steps; ++s) {
    const bool last_is_y = (steps - 1 - s) % 2 == 0;  // the last step writes y
    float* dst = last_is_y ? y : tmp;
    cfg.attrs = s > 0 ? attr : nullptr;  // the first step follows the caller's kernels in full
    cfg.numAttrs = s > 0 ? 1 : 0;
    err = cudaLaunchKernelEx(&cfg, stencil_step<CC>, *src, vmap, inv, dst, C, H, W, ng, passes);
    if (err != cudaSuccess) return (int)err;
    src = last_is_y ? &map_y : &map_tmp;
  }
  return 0;
}

}  // namespace

extern "C" {

const char* stencil_walk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Runs `steps` walk steps of x0 (B, C, H, W) into y on `stream`, using tmp
// (same shape) as the second ping-pong buffer.  dirs: host (n_dirs, 2)
// int32 (dy, dx) table, which must equal the compiled radius-5 table.  W
// must be a multiple of 4 and every pointer 16-byte aligned.  The plan
// (ops/stencil_walk.py stencil_plan): cc classes per thread, ng class
// groups of 128 threads per CTA (cc in {1, 2, 3, 4, 5, 6, 8, 10}, ng in
// {1, 2}).  Returns 0 or the first CUDA error of a launch.
int stencil_walk_f32(const float* x0, const float* vs, const float* inv, float* tmp, float* y,
                     const int* dirs, int n_dirs, int B, int C, int H, int W, int steps, int cc,
                     int ng, void* stream) {
  if (n_dirs != D || C < 1 || B < 1 || H < 1 || W < 4 || W % 4 != 0 || steps < 0 || ng < 1 ||
      ng > 2)
    return (int)cudaErrorInvalidValue;
  for (int d = 0; d < D; ++d)
    if (dirs[2 * d] != direction(d, true) || dirs[2 * d + 1] != direction(d, false))
      return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (steps == 0)
    return (int)cudaMemcpyAsync(y, x0, sizeof(float) * B * C * H * W, cudaMemcpyDeviceToDevice, st);
  switch (cc) {
    case 1: return run<1>(x0, vs, inv, tmp, y, B, C, H, W, steps, ng, st);
    case 2: return run<2>(x0, vs, inv, tmp, y, B, C, H, W, steps, ng, st);
    case 3: return run<3>(x0, vs, inv, tmp, y, B, C, H, W, steps, ng, st);
    case 4: return run<4>(x0, vs, inv, tmp, y, B, C, H, W, steps, ng, st);
    case 5: return run<5>(x0, vs, inv, tmp, y, B, C, H, W, steps, ng, st);
    case 6: return run<6>(x0, vs, inv, tmp, y, B, C, H, W, steps, ng, st);
    case 8: return run<8>(x0, vs, inv, tmp, y, B, C, H, W, steps, ng, st);
    case 10: return run<10>(x0, vs, inv, tmp, y, B, C, H, W, steps, ng, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
