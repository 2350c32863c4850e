// Banded random-walk power iteration for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel muscle_tpu/ops/pallas/banded_walk.py
// (banded_random_walk / _kernel): x <- x @ T for `steps` steps, where T
// (V, V) is stored dense and its nonzeros lie within `band` of the diagonal
// (|i - j| <= band).  Each CTA reads only the rows within `band` of its
// column block; T must be zero outside the band, as the walk's T is.
//
// Bound on the card: the band of T read once, ~V*(2*band+1) floats, and the
// iterate in and out, against 2*C*steps*(band entries) f32 operations; at
// the IRN walk grid (V = 16384, band 516, C = 20, 64 steps: 43 GFLOP over
// 68 MB) the operations bound it, ~0.65 ms per image at 67 TFLOP/s.  A
// walk that cannot keep the 68 MB band on chip reads it once per step
// (4.3 GB, ~1.3 ms at 3.35 TB/s), and so does this kernel.
//
// Design.  The TPU kernel carries the iterate in VMEM across a sequential
// (steps, column blocks) grid.  A GPU grid has no order, so here one launch
// is one step and the iterate ping-pongs between two global buffers (1.3 MB
// per image, resident in L2).  A CTA owns 32 columns of one image for all
// classes: one column per lane, the 8 warps split the CTA's rows
// [j0 - band, j0 + 32 + band) into contiguous runs, so each row of T is one
// coalesced 128-byte read and many rows are in flight per SM.  The iterate
// is laid out (B, V, CP), CP the class count rounded up to 4, so a lane
// reads one row's classes as CP/4 broadcast float4 loads; the products are
// plain f32 FMAs into CP registers per lane.  The warps' partial sums are
// added in a fixed order through shared memory: no atomics, results repeat
// run to run.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int COLS = 32;  // columns per CTA, one per lane
constexpr int NWARP = 8;
constexpr int NT = COLS * NWARP;

template <int CP>
__global__ void __launch_bounds__(NT)
banded_step(const float* __restrict__ x, const float* __restrict__ T, float* __restrict__ y,
            int V, int band) {
  __shared__ float part[NWARP][CP][COLS];
  const int b = blockIdx.y;
  const int lane = threadIdx.x % COLS, warp = threadIdx.x / COLS;
  const int j0 = blockIdx.x * COLS, j = j0 + lane;
  const int lo = max(0, j0 - band), hi = min(V, j0 + COLS + band);
  const int per = (hi - lo + NWARP - 1) / NWARP;
  const int r0 = lo + warp * per, r1 = min(hi, r0 + per);

  const float* Tb = T + (size_t)b * V * V;
  const float* xb = x + (size_t)b * V * CP;
  const bool col_ok = j < V;
  float acc[CP];
#pragma unroll
  for (int c = 0; c < CP; ++c) acc[c] = 0.f;
#pragma unroll 4
  for (int i = r0; i < r1; ++i) {
    const float t = col_ok ? __ldg(Tb + (size_t)i * V + j) : 0.f;
    const float4* xr = reinterpret_cast<const float4*>(xb + (size_t)i * CP);
#pragma unroll
    for (int q = 0; q < CP / 4; ++q) {
      const float4 v = __ldg(xr + q);
      acc[4 * q + 0] = fmaf(v.x, t, acc[4 * q + 0]);
      acc[4 * q + 1] = fmaf(v.y, t, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(v.z, t, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(v.w, t, acc[4 * q + 3]);
    }
  }
#pragma unroll
  for (int c = 0; c < CP; ++c) part[warp][c][lane] = acc[c];
  __syncthreads();
  for (int o = threadIdx.x; o < CP * COLS; o += NT) {
    const int c = o / COLS, l = o % COLS;
    if (j0 + l >= V) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) s += part[w][c][l];
    y[(size_t)b * V * CP + (size_t)(j0 + l) * CP + c] = s;
  }
}

template <int CP>
cudaError_t run(const float* x0, const float* T, float* tmp, float* y, int B, int V, int band,
                int steps, cudaStream_t st) {
  const dim3 grid((V + COLS - 1) / COLS, B);
  const float* src = x0;
  for (int s = 0; s < steps; ++s) {
    float* dst = ((steps - 1 - s) % 2 == 0) ? y : tmp;  // the last step writes y
    banded_step<CP><<<grid, NT, 0, st>>>(src, T, dst, V, band);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    src = dst;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* banded_walk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Runs `steps` steps of x0 (B, V, CP) @ T (B, V, V) into y (B, V, CP) on
// `stream`, with tmp (B, V, CP) as the second ping-pong buffer.  CP is a
// multiple of 4 up to 32; the padded classes of x0 must be zero.  Returns
// 0 or the first CUDA error (cudaGetLastError after each launch).
int banded_walk_f32(const float* x0, const float* T, float* tmp, float* y, int B, int V, int CP,
                    int band, int steps, void* stream) {
  if (B < 1 || V < 1 || band < 0 || steps < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (steps == 0)
    return (int)cudaMemcpyAsync(y, x0, sizeof(float) * B * V * CP, cudaMemcpyDeviceToDevice, st);
  switch (CP) {
    case 4: return (int)run<4>(x0, T, tmp, y, B, V, band, steps, st);
    case 8: return (int)run<8>(x0, T, tmp, y, B, V, band, steps, st);
    case 12: return (int)run<12>(x0, T, tmp, y, B, V, band, steps, st);
    case 16: return (int)run<16>(x0, T, tmp, y, B, V, band, steps, st);
    case 20: return (int)run<20>(x0, T, tmp, y, B, V, band, steps, st);
    case 24: return (int)run<24>(x0, T, tmp, y, B, V, band, steps, st);
    case 28: return (int)run<28>(x0, T, tmp, y, B, V, band, steps, st);
    case 32: return (int)run<32>(x0, T, tmp, y, B, V, band, steps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
