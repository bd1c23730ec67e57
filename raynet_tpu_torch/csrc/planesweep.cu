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
// Layout: one warp per ray, four rays a block, at most 64 registers a
// thread (eight blocks an SM); the planes in chunks of 32.
// 1. Projection, once per (ray, plane, view) cell: lane d projects plane d
//    into every view (scalar f32 chain, no FMA: the library is built with
//    -fmad=false, so the cells equal PyTorch's), rounds half-to-even
//    (rintf), clamps with the both-zero sentinel and puts the cell's row
//    in shared memory ([view][plane], conflict-free). When the caller asks
//    for the cells, the warp writes them from there with coalesced
//    8-byte stores.
// 2. Gather (pair_sums): a group of lanes reads each feature row whole,
//    16 bytes a lane, so a warp load reads 32 / G rows instead of a
//    16-byte piece of 32 rows; each group sums up to four planes at
//    once, view by view, and adds its lanes' shares by shuffles.
// 3. Lane d divides plane d's pair sum by n_pairs; the softmax is a
//    warp-shuffle max and sum (through the output row when D > 32).
// The launch takes any number of rays: the passes hand it all the rays of
// an image at once.
//
// Whole image of 1,920,000 rays on an H100 80GB HBM3 at 700 W (PERF.md
// section 6): 3.4 ms with bf16 features, 3.6 ms with float32 ones (the CLI's
// passes), against 3.85 and 5.8 ms for the previous body. What bounds it
// (controlled variants, each an edited copy of this file): instruction issue
// and latency, not the bytes or the scattered lines. With every lane reading
// row 0 of its view the previous body (a lane per plane, a 16-byte piece of
// 32 rows a warp load) is 16% faster and this one 3%; the bound
// (tools/roofline.py), ~3 V F flops per (ray, plane), is a sixth of the
// time. What is left is ~1,100 warp instructions a ray: the projection (two
// IEEE divisions a cell; 1.2 of 3.4 ms alone), three a feature value
// (convert, add, square) and the gather's addressing. The register bound is
// worth 20% (4.2 ms without it); more blocks an SM spill. Slower on the
// card: with the previous body, a quad of lanes per ray, a row split over
// lanes and the next view loaded ahead; a lane per ray (10.3 ms), eight
// warps a block (3.45), rays in image-row order (3.43), and, on bodies not
// kept, shared-memory staging by cp.async (4.3-4.8), the Gram matrices on
// the tensor cores with mma.m16n8k16 (4.2-5.2: moving the fragments and
// summing the shares cost more than the three instructions a value they
// save) and persistent warps over runs of rays (4.2-5.7).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxViews = 32;
constexpr int kPlanes = 32;    // planes a warp projects at once, one a lane
constexpr int kWarps = 4;      // warps (rays) a block
constexpr int kMinBlocks = 8;  // blocks an SM: at most 64 registers a thread

// the f32 values of a 16-byte piece of a feature row
template <typename T>
struct Piece;

template <>
struct Piece<float> {
  static constexpr int kValues = 4;
  static __device__ __forceinline__ void unpack(const uint4 q, float* out) {
    out[0] = __uint_as_float(q.x);
    out[1] = __uint_as_float(q.y);
    out[2] = __uint_as_float(q.z);
    out[3] = __uint_as_float(q.w);
  }
};

template <>
struct Piece<__nv_bfloat16> {
  static constexpr int kValues = 8;
  // a bf16 value is the high half of the f32 of the same value; element
  // 2j is the low half of word j
  static __device__ __forceinline__ void unpack(const uint4 q, float* out) {
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out[2 * j] = __uint_as_float(w[j] << 16);
      out[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
};

// the least power of two >= g
__host__ __device__ constexpr int pow2_at_least(int g) {
  return g <= 1 ? 1 : 2 * pow2_at_least((g + 1) / 2);
}

// shared memory a warp uses: rows[V][kPlanes] (a cell's fy * Wf + fx) and
// pair[kPlanes]
__host__ __device__ size_t warp_bytes(int V) {
  return (size_t)(V + 1) * kPlanes * 4;
}

// pair[j] = (|sum f|^2 - sum |f|^2) / 2 over the views of chunk plane
// j < nd. A group of G = F * sizeof(T) / 16 lanes (rounded up to a power
// of two) reads one feature row, 16 bytes a lane; group g sums planes g,
// g + NG, ... (KP of them), KB at a time, view by view, one view's KB
// pieces in flight, sum_v f and sum_v |f|^2 in f32 with explicit FMAs
// (the -fmad=false build fuses nothing else). With all KP planes at once
// the f32 build spilled 0.4-1.4 KB a thread and took 15.3 ms an image at
// F = 32 (PR 4's body 5.8); KB = 4, one batch of planes after another
// (not unrolled), spills nothing in f32 and runs it in 3.6 ms.
template <typename T, int F>
__device__ __forceinline__ void pair_sums(
    const T* __restrict__ feat, const int* rows, float* pair, int nd, int V,
    size_t view_stride, int lane) {
  constexpr int VEC = Piece<T>::kValues;  // values in a 16-byte piece
  constexpr int G = F / VEC;              // lanes that read a row
  constexpr int GP = pow2_at_least(G);    // lanes of a group
  constexpr int NG = 32 / GP;             // rows a warp load reads
  constexpr int KP = kPlanes / NG;        // planes a group sums
  constexpr int KB = KP < 4 ? KP : 4;     // of them at once
  static_assert(F % VEC == 0 && GP <= 32, "F");
  const int group = lane / GP;
  const int slot = lane % GP;
  const bool reads = slot < G;  // the lanes past G of a group idle
#pragma unroll 1
  for (int k0 = 0; k0 < KP; k0 += KB) {
    if (KP > KB && k0 * NG >= nd) break;  // uniform across the warp
    float acc[KB][VEC];
    float sq[KB];
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      sq[k] = 0.0f;
#pragma unroll
      for (int c = 0; c < VEC; ++c) acc[k][c] = 0.0f;
    }
    const int first = group + k0 * NG;  // this group's first plane
    const T* base = feat + slot * VEC;
    for (int v = 0; v < V; ++v, base += view_stride) {
      const int* rv = rows + v * kPlanes + first;
      uint4 q[KB];
#pragma unroll
      for (int k = 0; k < KB; ++k)
        if (reads && first + k * NG < nd)
          q[k] = *reinterpret_cast<const uint4*>(
              base + (size_t)(unsigned)rv[k * NG] * F);
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        if (reads && first + k * NG < nd) {
          float f[VEC];
          Piece<T>::unpack(q[k], f);
#pragma unroll
          for (int c = 0; c < VEC; ++c) {
            acc[k][c] += f[c];
            sq[k] = __fmaf_rn(f[c], f[c], sq[k]);
          }
        }
      }
    }
    // a lane's share (0 where it read nothing), summed over the group
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      float dot = 0.0f;
#pragma unroll
      for (int c = 0; c < VEC; ++c) dot = __fmaf_rn(acc[k][c], acc[k][c], dot);
      float part = dot - sq[k];
#pragma unroll
      for (int o = GP / 2; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (slot == 0 && first + k * NG < nd) pair[first + k * NG] = 0.5f * part;
    }
  }
}

template <typename T, int F>
__global__ void __launch_bounds__(32 * kWarps, kMinBlocks) plane_sweep_kernel(
    const T* __restrict__ feat, const float* __restrict__ P,
    const float* __restrict__ ray_start, const float* __restrict__ ray_end,
    float* __restrict__ scores, int* __restrict__ cells, int V, int Hf,
    int Wf, int N, int D, int offset, int H, int W) {
  __shared__ float Ps[kMaxViews * 12];
  extern __shared__ __align__(16) unsigned char smem[];
  for (int i = threadIdx.x; i < V * 12; i += blockDim.x) Ps[i] = P[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* rows = reinterpret_cast<int*>(smem + warp * warp_bytes(V));
  float* pair = reinterpret_cast<float*>(rows + V * kPlanes);
  const float n_pairs = (float)((V * (V - 1)) / 2);
  const size_t view_stride = (size_t)Hf * Wf * F;

  const int r = blockIdx.x * kWarps + warp;
  if (r >= N) return;  // uniform across the warp
  const float sx = ray_start[3 * r + 0];
  const float sy = ray_start[3 * r + 1];
  const float sz = ray_start[3 * r + 2];
  const float dx = ray_end[3 * r + 0] - sx;
  const float dy = ray_end[3 * r + 1] - sy;
  const float dz = ray_end[3 * r + 2] - sz;
  float* out = scores + (size_t)r * D;

  float own = 0.0f;  // this lane's plane's score when D <= kPlanes
  float local_max = -INFINITY;
  for (int d0 = 0; d0 < D; d0 += kPlanes) {
    const int nd = min(kPlanes, D - d0);
    if (lane < nd) {
      const float frac = (float)(d0 + lane) / (float)(D - 1);
      const float x = sx + frac * dx;
      const float y = sy + frac * dy;
      const float z = sz + frac * dz;
      for (int v = 0; v < V; ++v) {
        const float* Pv = Ps + 12 * v;
        const float u = Pv[0] * x + Pv[1] * y + Pv[2] * z + Pv[3];
        const float w_ = Pv[4] * x + Pv[5] * y + Pv[6] * z + Pv[7];
        const float h = Pv[8] * x + Pv[9] * y + Pv[10] * z + Pv[11];
        // rintf rounds half to even like torch.round; the int
        // conversion saturates like PyTorch's, and the offset add wraps
        // like int32 tensor arithmetic
        int fx = (int)((unsigned)(int)rintf(u / h) + (unsigned)offset);
        int fy = (int)((unsigned)(int)rintf(w_ / h) + (unsigned)offset);
        fx = min(max(fx, 0), W);
        fy = min(max(fy, 0), H);
        if (fx == 0 || fy == 0) { fx = 0; fy = 0; }
        rows[v * kPlanes + lane] = fy * Wf + fx;
      }
    }
    __syncwarp();
    if (cells != nullptr) {
      // the chunk's cells are nd * V consecutive (fx, fy) pairs
      int2* c = reinterpret_cast<int2*>(cells) + ((size_t)r * D + d0) * V;
      for (int i = lane; i < nd * V; i += 32) {
        const int q = rows[(i % V) * kPlanes + i / V];
        c[i] = make_int2(q % Wf, q / Wf);
      }
    }
    pair_sums<T, F>(feat, rows, pair, nd, V, view_stride, lane);
    __syncwarp();
    if (lane < nd) {
      const float s = pair[lane] / n_pairs;
      local_max = fmaxf(local_max, s);
      if (D <= kPlanes)
        own = s;
      else
        out[d0 + lane] = s;
    }
    __syncwarp();  // the next chunk rewrites rows and pair
  }

  // softmax over D, in registers when D <= kPlanes (a round trip through
  // the output row costs ~14% at the passes' D = 32)
  for (int o = 16; o > 0; o >>= 1)
    local_max = fmaxf(local_max, __shfl_xor_sync(0xffffffffu, local_max, o));
  float local_sum = 0.0f;
  if (D <= kPlanes) {
    const float e = lane < D ? expf(own - local_max) : 0.0f;
    local_sum = e;
    for (int o = 16; o > 0; o >>= 1)
      local_sum += __shfl_xor_sync(0xffffffffu, local_sum, o);
    if (lane < D) out[lane] = e / local_sum;
    return;
  }
  // each lane revisits only the planes it wrote
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
  const size_t smem = kWarps * warp_bytes(V);
  const int blocks = (N + kWarps - 1) / kWarps;
  plane_sweep_kernel<T, F><<<blocks, 32 * kWarps, smem, stream>>>(
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
