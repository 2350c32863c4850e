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
// caller's table is checked against the one compiled in here.
//
// Bound on the card: B*C*steps*H*W*(4D+1) f32 operations against x, vs and
// inv read once and x' written once; at the IRN shapes (C = 20, 128 x 128,
// 64 steps) the operations bound it (2.9 GFLOP per image: ~43 us at
// 67 TFLOP/s, against ~1.4 us for its 4.8 MB).
//
// Design.  The TPU kernel keeps the iterate in VMEM for all steps.  Here
// the expensive operand is the weights: 2*D of them per pixel, shared by
// the C classes, while the iterate is one float per pixel and class.  So
// a launch runs one step, and a CTA owns a 16 x 16 pixel tile of one image
// for ALL classes: each thread loads its pixel's 2*D weights into
// registers once (read once per step, not once per class), the CTA stages
// the C class tiles with their 4-pixel halo (zero outside the grid) in
// shared memory, and each thread sweeps its pixel's stencil over the
// classes.  The directions are compile-time constants, so every shared
// memory read has an immediate offset.  The iterate ping-pongs between two
// global buffers (1.3 MB per image, resident in L2); 64 launches per walk.
// One shared-memory read per FMA caps this version at ~4.5x the bound (an
// SM reads one warp-wide word per clock); PERF.md has its times.

#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>
#include <utility>

namespace {

constexpr int RADIUS = 5;
constexpr int HALO = RADIUS - 1;  // max |dy|, |dx| of a direction
constexpr int TILE = 16;
constexpr int TP = TILE + 2 * HALO;  // staged tile side
constexpr int NT = TILE * TILE;

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

template <class F, int... I>
__device__ __forceinline__ void for_each_direction(F&& f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}

using Directions = std::make_integer_sequence<int, D>;

__global__ void __launch_bounds__(NT, 2)
stencil_step(const float* __restrict__ x, const float* __restrict__ vs,
             const float* __restrict__ inv, float* __restrict__ y, int C, int H, int W) {
  extern __shared__ float tile[];  // C planes of TP x TP
  const int b = blockIdx.z;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int r0 = blockIdx.y * TILE, c0 = blockIdx.x * TILE;
  const int r = r0 + ty, c = c0 + tx;
  const size_t hw = (size_t)H * W;

  const float* xb = x + (size_t)b * C * hw;
  for (int i = ty * TILE + tx; i < C * TP * TP; i += NT) {
    const int cls = i / (TP * TP);
    const int rem = i - cls * (TP * TP);
    const int gr = r0 - HALO + rem / TP, gc = c0 - HALO + rem % TP;
    tile[i] = (gr >= 0 && gr < H && gc >= 0 && gc < W) ? xb[cls * hw + (size_t)gr * W + gc] : 0.f;
  }

  const bool inside = r < H && c < W;
  const float* vb = vs + (size_t)b * D * hw;
  float wp[D], wm[D];  // v_d[p], v_d[p - d]
  for_each_direction([&](auto dc) {
    constexpr int d = decltype(dc)::value;
    constexpr int dy = direction(d, true), dx = direction(d, false);
    const int rm = r - dy, cm = c - dx;
    wp[d] = inside ? __ldg(vb + d * hw + (size_t)r * W + c) : 0.f;
    wm[d] = (inside && rm >= 0 && rm < H && cm >= 0 && cm < W)
                ? __ldg(vb + d * hw + (size_t)rm * W + cm) : 0.f;
  }, Directions{});
  const float iv = inside ? __ldg(inv + (size_t)b * hw + (size_t)r * W + c) : 0.f;
  __syncthreads();
  if (!inside) return;

  float* yb = y + (size_t)b * C * hw + (size_t)r * W + c;
  for (int cls = 0; cls < C; ++cls) {
    const float* t = tile + cls * (TP * TP) + (ty + HALO) * TP + (tx + HALO);
    float acc = t[0];
    for_each_direction([&](auto dc) {
      constexpr int d = decltype(dc)::value;
      constexpr int off = direction(d, true) * TP + direction(d, false);  // in the staged tile
      acc = fmaf(t[-off], wm[d], acc);  // x[p-d] * v_d[p-d]
      acc = fmaf(t[off], wp[d], acc);   // x[p+d] * v_d[p]
    }, Directions{});
    yb[cls * hw] = acc * iv;
  }
}

}  // namespace

extern "C" {

const char* stencil_walk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Runs `steps` walk steps of x0 (B, C, H, W) into y on `stream`, using tmp
// (same shape) as the second ping-pong buffer.  dirs: host (n_dirs, 2)
// int32 (dy, dx) table, which must equal the compiled radius-5 table.
// Returns 0 or the first CUDA error (cudaGetLastError after each launch).
int stencil_walk_f32(const float* x0, const float* vs, const float* inv, float* tmp, float* y,
                     const int* dirs, int n_dirs, int B, int C, int H, int W, int steps,
                     void* stream) {
  if (n_dirs != D || C < 1 || B < 1 || H < 1 || W < 1 || steps < 0)
    return (int)cudaErrorInvalidValue;
  for (int d = 0; d < D; ++d)
    if (dirs[2 * d] != direction(d, true) || dirs[2 * d + 1] != direction(d, false))
      return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (steps == 0)
    return (int)cudaMemcpyAsync(y, x0, sizeof(float) * B * C * H * W, cudaMemcpyDeviceToDevice, st);
  const size_t smem = sizeof(float) * C * TP * TP;
  cudaError_t err = cudaFuncSetAttribute(stencil_step, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  const dim3 block(TILE, TILE);
  const float* src = x0;
  for (int s = 0; s < steps; ++s) {
    float* dst = ((steps - 1 - s) % 2 == 0) ? y : tmp;  // the last step writes y
    stencil_step<<<grid, block, smem, st>>>(src, vs, inv, dst, C, H, W);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src = dst;
  }
  return 0;
}

}  // extern "C"
