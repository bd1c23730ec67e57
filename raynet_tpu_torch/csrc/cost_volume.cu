// K4: the variance cost volume of MVSNet (Yao et al., ECCV 2018, eq. 2).
//
// New in the port, with no TPU counterpart: the JAX package has no MVSNet,
// and no kernel of it builds a dense cost volume. For every reference
// feature pixel (u, v) and depth hypothesis d it warps each source view's
// feature map by the homography of the pixel's depth z, samples it
// bilinearly (taps outside the map read 0, as grid_sample with zero
// padding and align_corners=True) and writes, per channel, the variance
// over the V views once:
//   out[c][d][v][u] = (sum_i f_i(c)^2) / V - ((sum_i f_i(c)) / V)^2,
// the reference view unwarped. Two modes, one body:
// - planes (MVSNet; CasMVSNet's first stage): z = depths[d], one
//   fronto-parallel plane for every pixel;
// - per pixel (CasMVSNet's later stages, Gu et al., CVPR 2020): z =
//   centre[v][u] + depths[d], each pixel's hypotheses around its own
//   centre depth.
// A source pixel is z A (u, v, 1) + b, taken in both modes as
// (z A[:, 0]) u + (z (A[:, 1] v + A[:, 2]) + b), so a centre of 0 gives
// the plane mode's values bit for bit. raynet_tpu_torch/ops/cost_volume.py holds
// the plain version, which takes the same steps in the same order (the
// library is built with -fmad=false, so each product rounds alone).
//
// The warp is computed in double: the homography's terms, the projection,
// its division and the bilinear weights (cast to float once). At 400-pixel
// maps a float32 coordinate is off by ~1e-5 pixel, which white-noise
// features turn into ~2e-5 of the variance: on the benchmark's cell that
// put the depths up to 0.07 of a plane interval from a float64 warp's,
// against 0.003 with the warp in double. The taps and the sums are float.
//
// What bounds it: the bytes written. At MVSNet's DTU size (C 32, D 256,
// 296 x 400 maps) the volume is 3.88 GB a view against 76 MB of features
// read, so the bound is the write at 3.35 TB/s, ~1.2 ms; the operations
// (~45 a value) take a third of that at the float32 rate. A torch chain
// of grid_sample calls would write four warped copies of the volume, plus
// their sum and square. In the benchmark's pass on an H100 80GB HBM3 at
// 700 W it takes 7.6 ms a view, 15.5% of that bound (PERF.md section 6).
//
// Layout: a block takes 32 consecutive pixels u of one (d, v) row, a
// quad of 4 channels a thread (256 threads at C 32). Its steps:
// 1. the row's homography terms of each source once per block into
//    shared memory: in the plane mode z A[:, 0] and z (A[:, 1] v +
//    A[:, 2]) + b; in the per-pixel mode A[:, 0], A[:, 1] v + A[:, 2] and
//    b, which step 2 multiplies by each pixel's z;
// 2. each (pixel, source) projected once, in double, into shared memory:
//    the 4 taps' offsets and float weights;
// 3. each thread sums its quad: the reference's float4, then per source
//    the 4 taps' float4s. The features are channels last, so the 8 lanes
//    of a pixel read its 128-byte row together and a warp's load touches
//    4 lines (with a lane per pixel it touches 32, one L1 wavefront each:
//    ~20 ms a view);
// 4. the variances through a shared tile, each warp then writing 32
//    contiguous u of a channel: 128 bytes a store.
// A tap outside the map reads the map's first pixel with a weight of 0,
// so that no branch stands between a thread's loads. Blocks run with u
// fastest, then the plane, then the row: the planes of one reference row
// read a narrow band of rows of each source map (the row's epipolar
// lines), which stays in L2.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPixels = 32;      // pixels a block
constexpr int kMaxChannels = 64;
constexpr int kMaxSources = 16;

// the bilinear weight of the tap (tx, ty) of (x, y), cast to float once,
// or 0 where the tap lies outside the map (or a coordinate is NaN); its
// pixel's offset in ``offset``, the map's first pixel where it lies outside
__device__ __forceinline__ float weight(double tx, double ty, double wx,
                                        double wy, int W, int H, int C,
                                        int* offset) {
  const bool inside = tx >= 0.0 && tx < (double)W && ty >= 0.0 &&
                      ty < (double)H;
  *offset = inside ? ((int)ty * W + (int)tx) * C : 0;
  return inside ? (float)(wx * wy) : 0.f;
}

__device__ __forceinline__ float4 load(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// kPerPixel: z = centre[v][u] + depths[d], else z = depths[d]
template <bool kPerPixel>
__global__ void __launch_bounds__(512) cost_volume_kernel(
    const float* __restrict__ features, const double* __restrict__ homs,
    const double* __restrict__ depths, const float* __restrict__ centre,
    float* __restrict__ out, int V, int H, int W, int C, int D) {
  // per source, planes: z A[k][0] (k < 3), then z (A[k][1] v + A[k][2]) +
  // b[k]; per pixel: A[k][0], A[k][1] v + A[k][2], then b[k]
  __shared__ double terms[kMaxSources][kPerPixel ? 9 : 6];
  // per (source, pixel): the 4 taps' offsets and weights
  __shared__ int offs[kMaxSources * kPixels][4];
  __shared__ float wts[kMaxSources * kPixels][4];
  __shared__ float tile[kMaxChannels][kPixels + 1];
  const int u0 = blockIdx.x * kPixels;
  const int d = blockIdx.y;
  const int v = blockIdx.z;
  const int S = V - 1;
  if (threadIdx.x < S) {
    const double* h = homs + 12 * threadIdx.x;
    const double dv = (double)v;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (kPerPixel) {
        terms[threadIdx.x][k] = h[3 * k];
        terms[threadIdx.x][3 + k] = h[3 * k + 1] * dv + h[3 * k + 2];
        terms[threadIdx.x][6 + k] = h[9 + k];
      } else {
        const double z = depths[d];
        terms[threadIdx.x][k] = z * h[3 * k];
        terms[threadIdx.x][3 + k] =
            z * (h[3 * k + 1] * dv + h[3 * k + 2]) + h[9 + k];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < S * kPixels; i += blockDim.x) {
    const double* t = terms[i / kPixels];
    const int iu = u0 + i % kPixels;
    const double du = (double)iu;
    double p0, p1, p2;
    if (kPerPixel) {
      // a pixel past the row's end projects like one at depth d, unused
      const double z =
          (double)(iu < W ? centre[(size_t)v * W + iu] : 0.f) + depths[d];
      p0 = (z * t[0]) * du + (z * t[3] + t[6]);
      p1 = (z * t[1]) * du + (z * t[4] + t[7]);
      p2 = (z * t[2]) * du + (z * t[5] + t[8]);
    } else {
      p0 = t[0] * du + t[3];
      p1 = t[1] * du + t[4];
      p2 = t[2] * du + t[5];
    }
    const double x = p0 / p2;
    const double y = p1 / p2;
    const double x0 = floor(x), y0 = floor(y);
    const double x1 = x0 + 1.0, y1 = y0 + 1.0;
    // north-west, north-east, south-west, south-east, as grid_sample
    wts[i][0] = weight(x0, y0, x1 - x, y1 - y, W, H, C, &offs[i][0]);
    wts[i][1] = weight(x1, y0, x - x0, y1 - y, W, H, C, &offs[i][1]);
    wts[i][2] = weight(x0, y1, x1 - x, y - y0, W, H, C, &offs[i][2]);
    wts[i][3] = weight(x1, y1, x - x0, y - y0, W, H, C, &offs[i][3]);
  }
  __syncthreads();
  const int quads = C / 4;
  const int p = threadIdx.x / quads;
  const int c = (threadIdx.x % quads) * 4;
  const int u = u0 + p;
  if (p < kPixels && u < W) {
    const float n = (float)V;
    const size_t map = (size_t)H * W * C;
    float4 f = load(features + ((size_t)v * W + u) * C + c);
    float4 sum = f;
    float4 sq = make_float4(f.x * f.x, f.y * f.y, f.z * f.z, f.w * f.w);
    for (int s = 0; s < S; ++s) {
      const int i = s * kPixels + p;
      const float* m = features + (size_t)(s + 1) * map + c;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        f = load(m + offs[i][k]);
        const float w = wts[i][k];
        val.x = val.x + f.x * w;
        val.y = val.y + f.y * w;
        val.z = val.z + f.z * w;
        val.w = val.w + f.w * w;
      }
      sum.x = sum.x + val.x;
      sum.y = sum.y + val.y;
      sum.z = sum.z + val.z;
      sum.w = sum.w + val.w;
      sq.x = sq.x + val.x * val.x;
      sq.y = sq.y + val.y * val.y;
      sq.z = sq.z + val.z * val.z;
      sq.w = sq.w + val.w * val.w;
    }
    const float mx = sum.x / n, my = sum.y / n, mz = sum.z / n,
                mw = sum.w / n;
    tile[c][p] = sq.x / n - mx * mx;
    tile[c + 1][p] = sq.y / n - my * my;
    tile[c + 2][p] = sq.z / n - mz * mz;
    tile[c + 3][p] = sq.w / n - mw * mw;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < C * kPixels; i += blockDim.x) {
    const int ch = i / kPixels, q = i % kPixels;
    if (u0 + q < W)
      out[(((size_t)ch * D + d) * H + v) * W + u0 + q] = tile[ch][q];
  }
}

}  // namespace

// centre: (H, W) float32 centre depths of the per-pixel mode, or null for
// the plane mode
extern "C" int raynet_cost_volume(const float* features, const double* homs,
                                  const double* depths, const float* centre,
                                  float* out, int V, int H, int W, int C,
                                  int D, void* stream) {
  if (V < 2 || V - 1 > kMaxSources || C % 4 != 0 || C > kMaxChannels ||
      D > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  if (H == 0 || W == 0 || D == 0) return 0;
  // a quad of channels a thread, at least a warp
  const int threads = (kPixels * C / 4 + 31) / 32 * 32;
  const dim3 grid((W + kPixels - 1) / kPixels, D, H);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (centre == nullptr)
    cost_volume_kernel<false><<<grid, threads, 0, s>>>(
        features, homs, depths, nullptr, out, V, H, W, C, D);
  else
    cost_volume_kernel<true><<<grid, threads, 0, s>>>(
        features, homs, depths, centre, out, V, H, W, C, D);
  return (int)cudaGetLastError();
}
