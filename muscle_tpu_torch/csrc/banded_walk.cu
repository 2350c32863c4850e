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
// 68 MB) the operations bound it, ~0.64 ms per image at 67 TFLOP/s.  A
// walk that cannot keep the 68 MB band on chip (the L2 holds 50 MB) reads
// it once per step: 4.3 GB, ~1.3 ms at 3.35 TB/s, and so does this kernel.
//
// Design.  The TPU kernel carries the iterate in VMEM across a sequential
// (steps, column blocks) grid.  A GPU grid has no order, so one launch is
// one step and the iterate ping-pongs between two global buffers (resident
// in L2).  A CTA owns NC = 64 columns of one image and one chunk of up to
// 20 classes; it streams its band rows [j0 - band, j0 + NC + band) through
// a ring of 8 shared-memory stages of 32 rows: a producer warp puts each
// stage's T tile (32 x 64, one TMA box) and the iterate's 32 rows for the
// chunk (one bulk copy: the layout (B, chunks, V, CPC) keeps them
// contiguous) on the stage's mbarrier.  Two CTAs fit on an SM (84 KB of
// stages each), ~170 KB in flight per SM, so the band streams near the
// memory rate; 64 columns keep the rows read beyond the band to 6% (128
// columns: 12%, and one CTA per SM ran 1.1x slower).  Eight consumer
// warps in 8 row groups take every 8th row of a stage; a thread owns 2
// columns, reads each row's 2 T values and CPC iterate values (broadcast
// float4s) from shared memory and runs 2 * CPC f32 FMAs (tensor cores gain
// nothing: wgmma's tf32 operands are K-major and T would be the M-major
// one).  The row groups' partial sums are added in a fixed order through
// shared memory: no atomics, results repeat bit for bit.  Steps after the
// first are programmatic dependents: once every CTA has issued its last
// loads the next step may start, and its producer puts its first stages'
// T tiles (constant) in flight before it waits for this step's iterate.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int NC = 64;       // columns per CTA
constexpr int RB = 32;       // band rows per stage
constexpr int STAGES = 8;
constexpr int NRG = 8;       // consumer row groups
constexpr int CTAS_PER_SM = 2;
constexpr int CONSUMERS = NRG * NC / 2;  // 256: 2 columns per thread
constexpr int NT = CONSUMERS + 32;       // + the producer warp

template <int CPC>
struct Layout {
  static constexpr int T_FLOATS = RB * NC;
  static constexpr int X_FLOATS = RB * CPC;
  static constexpr int STAGE_FLOATS = T_FLOATS + X_FLOATS;
  static constexpr int RED_FLOATS = NRG * NC * (CPC + 1);
  static constexpr int RING_FLOATS = STAGES * STAGE_FLOATS;
  static constexpr int FLOATS = RING_FLOATS > RED_FLOATS ? RING_FLOATS : RED_FLOATS;
  static constexpr size_t BYTES = 128 + 4 * (size_t)FLOATS + 2 * STAGES * 8;
  static_assert((STAGE_FLOATS * 4) % 128 == 0 && (T_FLOATS * 4) % 128 == 0, "TMA destinations");
};

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// One step for column block blockIdx.x, class chunk blockIdx.y of image
// blockIdx.z.  tmap: T as (ld, V, B) with ld >= V, box (NC, RB, 1); x, y:
// (B, chunks, V, CPC).
template <int CPC>
__global__ void __launch_bounds__(NT, CTAS_PER_SM)
banded_step(const __grid_constant__ CUtensorMap tmap, const float* __restrict__ x,
            float* __restrict__ y, int V, int band) {
  using L = Layout<CPC>;
  extern __shared__ unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>((reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + L::FLOATS);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int j0 = blockIdx.x * NC, chunk = blockIdx.y, b = blockIdx.z;
  const int lo = max(0, j0 - band), hi = min(V, j0 + NC + band);
  const int nk = (hi - lo + RB - 1) / RB;
  const size_t xoff = ((size_t)b * gridDim.y + chunk) * V * CPC;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int g = tid / (NC / 2), cl = tid % (NC / 2);  // consumers: row group, column
  float acc[2][CPC];
  if (warp == CONSUMERS / 32) {  // producer
    if (lane == 0) {
      auto x_bytes = [&](int k) { return (uint32_t)(min(RB, hi - lo - k * RB) * CPC * 4); };
      const int first = min(nk, STAGES);
      for (int k = 0; k < first; ++k) {  // T is constant: in flight before the wait
        mbar_expect_tx(&full[k], L::T_FLOATS * 4 + x_bytes(k));
        tma_load_3d(ring + k * L::STAGE_FLOATS, &tmap, &full[k], j0, lo + k * RB, b);
      }
      griddep_wait();  // the previous step's iterate is complete from here on
      for (int k = 0; k < first; ++k)
        bulk_load(ring + k * L::STAGE_FLOATS + L::T_FLOATS, x + xoff + (size_t)(lo + k * RB) * CPC,
                  x_bytes(k), &full[k]);
      for (int k = first; k < nk; ++k) {
        const int s = k % STAGES;
        mbar_wait(&empty[s], ((k / STAGES) - 1) & 1);
        float* st = ring + s * L::STAGE_FLOATS;
        mbar_expect_tx(&full[s], L::T_FLOATS * 4 + x_bytes(k));
        tma_load_3d(st, &tmap, &full[s], j0, lo + k * RB, b);
        bulk_load(st + L::T_FLOATS, x + xoff + (size_t)(lo + k * RB) * CPC, x_bytes(k), &full[s]);
      }
      // the next step may start its T loads once every CTA has issued its
      // last ones (earlier, its waiting CTAs would share this CTA's SM)
      griddep_launch_dependents();
    }
    __syncwarp();
  } else {  // a thread owns columns cl and cl + NC / 2, every NRG-th row
#pragma unroll
    for (int c = 0; c < CPC; ++c) acc[0][c] = acc[1][c] = 0.f;
    for (int k = 0; k < nk; ++k) {
      const int s = k % STAGES;
      mbar_wait(&full[s], (k / STAGES) & 1);
      const float* ts = ring + s * L::STAGE_FLOATS;
      const float* xs = ts + L::T_FLOATS;
      const int rows = min(RB, hi - lo - k * RB);
#pragma unroll 2
      for (int r = g; r < rows; r += NRG) {
        const float t0 = ts[r * NC + cl], t1 = ts[r * NC + cl + NC / 2];
        const float4* xr = reinterpret_cast<const float4*>(xs + r * CPC);
#pragma unroll
        for (int q = 0; q < CPC / 4; ++q) {
          const float4 v = xr[q];
          acc[0][4 * q + 0] = fmaf(v.x, t0, acc[0][4 * q + 0]);
          acc[0][4 * q + 1] = fmaf(v.y, t0, acc[0][4 * q + 1]);
          acc[0][4 * q + 2] = fmaf(v.z, t0, acc[0][4 * q + 2]);
          acc[0][4 * q + 3] = fmaf(v.w, t0, acc[0][4 * q + 3]);
          acc[1][4 * q + 0] = fmaf(v.x, t1, acc[1][4 * q + 0]);
          acc[1][4 * q + 1] = fmaf(v.y, t1, acc[1][4 * q + 1]);
          acc[1][4 * q + 2] = fmaf(v.z, t1, acc[1][4 * q + 2]);
          acc[1][4 * q + 3] = fmaf(v.w, t1, acc[1][4 * q + 3]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }
  __syncthreads();  // every stage consumed: the ring becomes the reduction buffer
  float* red = ring;  // (NRG, NC, CPC + 1)
  if (warp < CONSUMERS / 32) {
#pragma unroll
    for (int c = 0; c < CPC; ++c) {
      red[(g * NC + cl) * (CPC + 1) + c] = acc[0][c];
      red[(g * NC + cl + NC / 2) * (CPC + 1) + c] = acc[1][c];
    }
  }
  __syncthreads();
  float* yb = y + xoff;
  for (int o = tid; o < NC * CPC; o += NT) {  // row groups added in a fixed order
    const int j = o / CPC, c = o % CPC;
    if (j0 + j >= V) continue;
    float s = 0.f;
#pragma unroll
    for (int gg = 0; gg < NRG; ++gg) s += red[(gg * NC + j) * (CPC + 1) + c];
    yb[(size_t)(j0 + j) * CPC + c] = s;
  }
}

template <int CPC>
int run(const float* x0, const float* T, float* tmp, float* y, int B, int V, int ld, int chunks,
        int band, int steps, cudaStream_t st) {
  using L = Layout<CPC>;
  cudaError_t err = cudaFuncSetAttribute(banded_step<CPC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L::BYTES);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tmap;
  const uint64_t dims[3] = {(uint64_t)ld, (uint64_t)V, (uint64_t)B};
  const uint32_t box[3] = {NC, RB, 1};
  if (!make_map_f32(&tmap, T, 3, dims, box, false)) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((V + NC - 1) / NC, chunks, B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = L::BYTES;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  const float* src = x0;
  for (int s = 0; s < steps; ++s) {
    float* dst = ((steps - 1 - s) % 2 == 0) ? y : tmp;  // the last step writes y
    cfg.attrs = s > 0 ? attr : nullptr;  // the first step follows the caller's kernels in full
    cfg.numAttrs = s > 0 ? 1 : 0;
    err = cudaLaunchKernelEx(&cfg, banded_step<CPC>, tmap, src, dst, V, band);
    if (err != cudaSuccess) return (int)err;
    src = dst;
  }
  return 0;
}

}  // namespace

extern "C" {

const char* banded_walk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Runs `steps` steps of x0 @ T into y on `stream`, with tmp as the second
// ping-pong buffer.  x0, tmp, y: (B, chunks, V, CPC), the classes in chunks
// of CPC (a multiple of 4 up to 20), padded classes zero.  T: (B, V, ld)
// with ld >= V a multiple of 4 (columns past V zero), 16-byte aligned.
// Returns 0 or the first CUDA error of a launch.
int banded_walk_f32(const float* x0, const float* T, float* tmp, float* y, int B, int V, int ld,
                    int chunks, int CPC, int band, int steps, void* stream) {
  if (B < 1 || V < 1 || ld < V || ld % 4 != 0 || chunks < 1 || band < 0 || steps < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (steps == 0)
    return (int)cudaMemcpyAsync(y, x0, sizeof(float) * B * chunks * V * CPC,
                                cudaMemcpyDeviceToDevice, st);
  switch (CPC) {
    case 4: return run<4>(x0, T, tmp, y, B, V, ld, chunks, band, steps, st);
    case 8: return run<8>(x0, T, tmp, y, B, V, ld, chunks, band, steps, st);
    case 12: return run<12>(x0, T, tmp, y, B, V, ld, chunks, band, steps, st);
    case 16: return run<16>(x0, T, tmp, y, B, V, ld, chunks, band, steps, st);
    case 20: return run<20>(x0, T, tmp, y, B, V, ld, chunks, band, steps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
