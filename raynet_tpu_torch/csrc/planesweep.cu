// K1: multi-view plane-sweep scores, softmax over the depth planes.
//
// Replaces the TPU kernel raynet_tpu/ops/pallas/planesweep.py::_kernel
// (:84, launched by _banded_pair_sums :236). That kernel could not gather
// inside Mosaic, so it copied a static epipolar "band" box of each view's
// features into VMEM per 128-ray tile and selected rows with one-hot
// matmuls; planners sized the boxes. Hopper gathers directly, so none of
// that carries over: this kernel computes what
// raynet_tpu_torch/ops/similarities.compute_similarities computes, from the
// ray segments, with the /n_pairs and the softmax over D fused in.
//
// Layout: one warp per ray, one lane per depth plane (lanes loop when
// D > 32 and idle when D < 32). A lane projects its point into every view
// (scalar f32 chain, no FMA: the library is built with -fmad=false, so the
// feature cells equal PyTorch's), rounds half-to-even (rintf), clamps with
// the both-zero sentinel, and reads the view's F-wide feature row with
// 16-byte vector loads into f32 accumulators: sum_v f and sum_v |f|^2.
// The pair sum is 0.5 (|sum f|^2 - sum |f|^2); its two sums of squares use
// explicit fused multiply-adds (the -fmad=false build fuses nothing else).
// The softmax is a warp-shuffle max and sum over the lanes. The launch takes
// any number of rays: the raynet pass hands it all the rays of an image at
// once, the mvcnn passes one batch at a time.
//
// What bounds it on the card: the gather loop, not the bytes or the flops.
// Each (ray, plane) reads V rows of F values (V=5, F=32 bf16: 320 bytes) at
// data-dependent cells, many times the distinct rows a launch touches, so
// rows come from L1 and L2; a warp's 32 lanes sit at 32 depths, so one
// warp load touches up to 32 lines, and per (ray, plane, view) a lane
// issues the projection (two IEEE divisions) and ~3 instructions per
// feature value. The bound (tools/roofline.py) is the ~3 V F flops per
// (ray, plane). Measured on an H100 and slower than this body (PERF.md):
// one lane per ray over 32 neighbouring rays (a 65,536-ray batch is too
// few threads to fill the card), a quad of lanes per ray and each row
// split over a group of lanes (fewer lines per warp load, more warp
// instructions), and the next view's row loaded ahead (more registers).
// Staging each block's epipolar footprint in shared memory, or fetching it
// with cp.async or TMA, is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxViews = 32;
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ void load_row(const float* p, float* out) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  out[0] = q.x; out[1] = q.y; out[2] = q.z; out[3] = q.w;
}

__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* out) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&q);
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = __bfloat162float(h[j]);
}

template <typename T, int F>
__global__ void plane_sweep_kernel(
    const T* __restrict__ feat, const float* __restrict__ P,
    const float* __restrict__ ray_start, const float* __restrict__ ray_end,
    float* __restrict__ scores, int* __restrict__ cells,
    int V, int Hf, int Wf, int N, int D, int offset, int H, int W) {
  constexpr int VEC = 16 / sizeof(T);  // values per 16-byte load
  __shared__ float Ps[kMaxViews * 12];
  for (int i = threadIdx.x; i < V * 12; i += blockDim.x) Ps[i] = P[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= N) return;  // uniform across the warp

  const float sx = ray_start[3 * r + 0];
  const float sy = ray_start[3 * r + 1];
  const float sz = ray_start[3 * r + 2];
  const float dx = ray_end[3 * r + 0] - sx;
  const float dy = ray_end[3 * r + 1] - sy;
  const float dz = ray_end[3 * r + 2] - sz;
  const float n_pairs = (float)((V * (V - 1)) / 2);
  float* out = scores + (size_t)r * D;

  float local_max = -INFINITY;
  for (int d = lane; d < D; d += 32) {
    const float frac = (float)d / (float)(D - 1);
    const float x = sx + frac * dx;
    const float y = sy + frac * dy;
    const float z = sz + frac * dz;

    float acc[F];
#pragma unroll
    for (int j = 0; j < F; ++j) acc[j] = 0.0f;
    float sq = 0.0f;
    for (int v = 0; v < V; ++v) {
      const float* Pv = Ps + 12 * v;
      const float u = Pv[0] * x + Pv[1] * y + Pv[2] * z + Pv[3];
      const float w_ = Pv[4] * x + Pv[5] * y + Pv[6] * z + Pv[7];
      const float h = Pv[8] * x + Pv[9] * y + Pv[10] * z + Pv[11];
      // rintf rounds half to even like torch.round; the int conversion
      // saturates like PyTorch's, and the offset add wraps like int32
      // tensor arithmetic
      int fx = (int)((unsigned)(int)rintf(u / h) + (unsigned)offset);
      int fy = (int)((unsigned)(int)rintf(w_ / h) + (unsigned)offset);
      fx = min(max(fx, 0), W);
      fy = min(max(fy, 0), H);
      if (fx == 0 || fy == 0) { fx = 0; fy = 0; }
      if (cells != nullptr) {
        int* c = cells + (((size_t)r * D + d) * V + v) * 2;
        c[0] = fx;
        c[1] = fy;
      }
      const T* row = feat + (((size_t)v * Hf + fy) * Wf + fx) * F;
#pragma unroll
      for (int c0 = 0; c0 < F; c0 += VEC) {
        float f[VEC];
        load_row(row + c0, f);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          acc[c0 + j] += f[j];
          sq = __fmaf_rn(f[j], f[j], sq);
        }
      }
    }
    float dot = 0.0f;
#pragma unroll
    for (int j = 0; j < F; ++j) dot = __fmaf_rn(acc[j], acc[j], dot);
    const float s = (0.5f * (dot - sq)) / n_pairs;
    out[d] = s;
    local_max = fmaxf(local_max, s);
  }

  // softmax over D: each lane revisits only the planes it wrote
  for (int o = 16; o > 0; o >>= 1)
    local_max = fmaxf(local_max, __shfl_xor_sync(0xffffffffu, local_max, o));
  float local_sum = 0.0f;
  for (int d = lane; d < D; d += 32) {
    const float e = expf(out[d] - local_max);
    out[d] = e;
    local_sum += e;
  }
  for (int o = 16; o > 0; o >>= 1)
    local_sum += __shfl_xor_sync(0xffffffffu, local_sum, o);
  for (int d = lane; d < D; d += 32) out[d] = out[d] / local_sum;
}

template <typename T, int F>
cudaError_t launch(const void* feat, const float* P, const float* rs,
                   const float* re, float* scores, int* cells, int V, int Hf,
                   int Wf, int N, int D, int offset, int H, int W,
                   cudaStream_t stream) {
  const int blocks = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
  plane_sweep_kernel<T, F><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      static_cast<const T*>(feat), P, rs, re, scores, cells, V, Hf, Wf, N, D,
      offset, H, W);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_f(int F, const void* feat, const float* P, const float* rs,
                     const float* re, float* scores, int* cells, int V, int Hf,
                     int Wf, int N, int D, int offset, int H, int W,
                     cudaStream_t stream) {
#define RAYNET_F_CASE(FF)                                                     \
  case FF:                                                                    \
    return launch<T, FF>(feat, P, rs, re, scores, cells, V, Hf, Wf, N, D,     \
                         offset, H, W, stream);
  switch (F) {
    RAYNET_F_CASE(8)
    RAYNET_F_CASE(16)
    RAYNET_F_CASE(24)
    RAYNET_F_CASE(32)
    RAYNET_F_CASE(40)
    RAYNET_F_CASE(48)
    RAYNET_F_CASE(56)
    RAYNET_F_CASE(64)
    default:
      return cudaErrorInvalidValue;
  }
#undef RAYNET_F_CASE
}

}  // namespace

// features (V, Hf, Wf, F) f32 or bf16, contiguous, 16-byte aligned rows;
// P (V, 3, 4) f32; ray_start/ray_end (N, 3) f32; scores (N, D) f32 out;
// cells (N, D, V, 2) int32 out, or null. Returns cudaGetLastError().
extern "C" int raynet_plane_sweep_scores(
    const void* features, int features_bf16, const float* P,
    const float* ray_start, const float* ray_end, float* scores, int* cells,
    int V, int Hf, int Wf, int F, int N, int D, int padding, int H, int W,
    void* stream) {
  if (V < 2 || V > kMaxViews || D < 2 || F % 8 != 0 || F > 64)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const int pm1 = padding - 1;  // Python's floor division (padding-1)//2
  const int offset = padding - (pm1 >= 0 ? pm1 / 2 : -((1 - pm1) / 2));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      features_bf16
          ? launch_f<__nv_bfloat16>(F, features, P, ray_start, ray_end, scores,
                                    cells, V, Hf, Wf, N, D, offset, H, W, s)
          : launch_f<float>(F, features, P, ray_start, ray_end, scores, cells,
                            V, Hf, Wf, N, D, offset, H, W, s);
  return (int)err;
}
