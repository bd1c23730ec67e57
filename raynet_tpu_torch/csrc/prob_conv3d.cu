// K7: the last layer of MVSNet's and CasMVSNet's cost-regularisation U-Net
// (MVSNet_pytorch's and cascade-stereo's CostRegNet prob): a 3x3x3
// convolution of stride 1 and zero padding 1 from 8 channels to 1, with an
// optional bias and no activation:
//   y[d][h][w] = b + sum_{ci, kd, kh, kw} w[ci][kd][kh][kw]
//                    x[ci][d + kd - 1][h + kh - 1][w + kw - 1]
// for x (8, D, H, W) and y (1, D, H, W), NCDHW, an input past an edge
// reading 0.
//
// New in the port, with no TPU counterpart: the JAX package has no MVSNet.
// cuDNN runs this layer as its FFMA implicit GEMM, whose tile is 32 or more
// output channels wide, of which Cout = 1 fills one column: 2% of the
// layer's bound.
// raynet_tpu_torch/ops/prob_conv3d.py holds the plain version, which takes
// the same steps in the same order (the sums here are fused multiply-adds,
// its sums a product and an add).
//
// What bounds it: 2 x 216 operations an output voxel against 36 bytes (8
// inputs read, 1 output written), 12 FLOP/B against the card's 20 (67
// TFLOP/s float32 over 3.35 TB/s): bound by bytes, but not by far, so the
// design reads each input from device memory about once and keeps the
// FFMA pipe fed. MVSNet's (8, 256, 296, 400): 1.09 GB, 0.326 ms, against
// 0.196 ms of FFMAs. The configuration is float32 with TF32 off: every
// product a float32 FFMA.
//
// Layout: the volume is streamed along D. A block owns a 32-column tile of
// kRows x kWarps rows over a run of output planes d0 .. d1 - 1 and reads
// the input planes d0 - 1 .. d1 once each, in order, each channel's plane
// tile with its one-voxel halo (kTileH + 2 rows of 40 columns, c0 - 4 ..
// c0 + 35, so that a row is 10 aligned float4s) staged in shared memory by
// cp.async, 16 bytes a copy, kGroup channels a stage, in a ring of kStages
// stages: the copies of the stages ahead run while this one's products do
// (one barrier a stage). A lane owns one output column of kRows rows; a
// warp takes 32 consecutive columns, so each shared-memory read of a row
// is 32 consecutive words (one wavefront, no bank conflict) and each store
// of an output row 128 bytes. Each input plane p feeds the output planes p + 1,
// p and p - 1 (taps kd 0, 1, 2), so a lane keeps three rolling planes of
// kRows sums; after plane p the oldest, output plane p - 1, is complete:
// the bias is added and it is stored, and the ring rolls. Per channel a
// lane reads its (kRows + 2) x 3 window of the plane once into registers
// and the channel's 27 weights as 7 float4s that the whole block reads at
// one address: 30 + 7 shared loads feed 216 FFMAs at kRows 8. Each output
// voxel sums its taps plane by plane (kd), in each plane channel by
// channel, in each channel in (kh, kw) order; the bias follows.
//
// The run along D is chosen from the shape: as many runs as fill the
// card's resident blocks (the occupancy at this layout times the SMs) with
// the shape's tiles, so that every volume fills the card; re-reading one
// halo plane at each end of a run is the only extra traffic.
//
// On an H100 the copies set the pace: at MVSNet's shape they take ~0.7 ms
// alone and the products ~0.45 ms, and the two overlap to ~0.61 ms, 53% of
// the bound. TMA in place of cp.async copied no faster (PERF.md, K7).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCin = 8;
constexpr int kWPitch = 28;  // a channel's 27 weights and a pad: 7 float4s
constexpr int kTileW = 32;   // output columns a block
constexpr int kPitch = 40;   // input columns c0 - 4 .. c0 + 35
constexpr int kLeft = 4;     // columns before c0

constexpr int kRows = 8;                   // output rows a lane
constexpr int kWarps = 8;                  // warps a block, stacked along H
constexpr int kThreads = kWarps * 32;
constexpr int kBlocks = 2;                 // blocks an SM: 128 registers
constexpr int kTileH = kRows * kWarps;     // output rows a block
constexpr int kInH = kTileH + 2;           // input rows with the halo
constexpr int kSlab = kPitch * kInH;       // a channel's plane tile
constexpr int kGroup = 2;                  // channels a stage
constexpr int kGroups = kCin / kGroup;     // stages a plane
constexpr int kStages = 3;                 // stages in the ring
constexpr int kStage = kGroup * kSlab;
constexpr int kSmem = (kCin * kWPitch + kStages * kStage) * (int)sizeof(float);

// cp.async of 4 floats; src-size 0 writes zeros and reads nothing: the
// zero padding
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A thread's copies of a channel's plane tile: copy k = threadIdx.x + s
// kThreads takes 4 floats of row k / (kPitch / 4); off[s] is its offset in
// an input plane, -1 where it lies past an edge (or past the tile's copies).
// Which copies a thread makes, and where each lies in a plane, is the same
// for every plane and channel, so it is worked out once.
struct Copies {
  static constexpr int kPerRow = kPitch / 4;
  static constexpr int kCount = kInH * kPerRow;
  static constexpr int kSlots = (kCount + kThreads - 1) / kThreads;
  int off[kSlots];

  __device__ __forceinline__ Copies(int h0, int c0, int H, int W) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int k = threadIdx.x + s * kThreads;
      const int gh = h0 - 1 + k / kPerRow;
      const int gc = c0 - kLeft + (k % kPerRow) * 4;
      // W a multiple of 4, so a float4 lies all in or all out
      const bool ok = k < kCount && gh >= 0 && gh < H && gc >= 0 && gc < W;
      off[s] = ok ? gh * W + gc : -1;
    }
  }

  // channels ci0 .. ci0 + kGroup - 1 of input plane p into buf
  __device__ __forceinline__ void stage(float* buf, const float* x, int ci0,
                                        int p, size_t volume, int HW) const {
#pragma unroll
    for (int c = 0; c < kGroup; ++c) {
      const float* src = x + (size_t)(ci0 + c) * volume + (size_t)p * HW;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int k = threadIdx.x + s * kThreads;
        if (s + 1 < kSlots || k < kCount) {
          const bool ok = off[s] >= 0;
          cp_async(buf + c * kSlab + k * 4, ok ? src + off[s] : x, ok);
        }
      }
    }
  }
};

// One stage's channels into the lane's three rolling planes of sums:
// acc[t] is output plane p - 1 + t, which takes input plane p at tap
// kd = 2 - t.
__device__ __forceinline__ void accumulate(const float* stage,
                                           const float* w_s,
                                           float (&acc)[3][kRows],
                                           int warp, int lane) {
#pragma unroll
  for (int c = 0; c < kGroup; ++c) {
    // the lane's window: rows warp kRows .., columns c0 + lane - 1 ..
    const float* in =
        stage + c * kSlab + warp * kRows * kPitch + kLeft - 1 + lane;
    float v[kRows + 2][3];
#pragma unroll
    for (int r = 0; r < kRows + 2; ++r)
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) v[r][kw] = in[r * kPitch + kw];
    const float4* wq = reinterpret_cast<const float4*>(w_s + c * kWPitch);
    float w[kWPitch];
#pragma unroll
    for (int q = 0; q < kWPitch / 4; ++q) {
      const float4 f = wq[q];
      w[4 * q] = f.x;
      w[4 * q + 1] = f.y;
      w[4 * q + 2] = f.z;
      w[4 * q + 3] = f.w;
    }
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int kh = 0; kh < 3; ++kh)
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const float wt = w[(2 - t) * 9 + kh * 3 + kw];
#pragma unroll
          for (int j = 0; j < kRows; ++j)
            acc[t][j] = __fmaf_rn(v[j + kh][kw], wt, acc[t][j]);
        }
  }
}

__global__ void __launch_bounds__(kThreads, kBlocks)
prob_conv3d_kernel(const float* __restrict__ x,
                   const float* __restrict__ weight,
                   const float* __restrict__ bias, float* __restrict__ y,
                   int D, int H, int W, int run) {
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                     // [kCin][kWPitch]
  float* in_s = smem + kCin * kWPitch;   // the ring of stages

  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int c0 = (blockIdx.x % tiles_w) * kTileW;
  const int h0 = (blockIdx.x / tiles_w) * kTileH;
  const int d0 = blockIdx.y * run;
  const int d1 = min(d0 + run, D);
  const int HW = H * W;
  const size_t volume = (size_t)D * HW;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // the input planes the run reads, pa .. pb, and the stages that stage them
  const int pa = max(d0 - 1, 0);
  const int pb = min(d1, D - 1);
  const int steps = (pb - pa + 1) * kGroups;

  const Copies copies(h0, c0, H, W);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < steps)
      copies.stage(in_s + i * kStage, x, (i % kGroups) * kGroup,
                   pa + i / kGroups, volume, HW);
    cp_async_commit();
  }
  for (int i = threadIdx.x; i < kCin * kWPitch; i += kThreads) {
    const int t = i % kWPitch;
    w_s[i] = t < 27 ? __ldg(weight + (i / kWPitch) * 27 + t) : 0.f;
  }

  // a warp whose rows all lie past H stages and waits, and computes nothing
  const int row0 = h0 + warp * kRows;
  const bool active = row0 < H;
  const int c = c0 + lane;
  const bool store = active && c < W;
  const bool has_bias = bias != nullptr;
  const float b = has_bias ? __ldg(bias) : 0.f;

  float acc[3][kRows];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int j = 0; j < kRows; ++j) acc[t][j] = 0.f;

  int step = 0;
#pragma unroll 1
  for (int p = d0 - 1; p <= d1; ++p) {
    if (p >= 0 && p < D) {
#pragma unroll 1
      for (int g = 0; g < kGroups; ++g, ++step) {
        cp_async_wait<kStages - 2>();
        __syncthreads();
        // the stage this overwrites was last read before this barrier
        const int next = step + kStages - 1;
        if (next < steps)
          copies.stage(in_s + (next % kStages) * kStage, x,
                       (next % kGroups) * kGroup,
                       pa + next / kGroups, volume, HW);
        cp_async_commit();
        if (active)
          accumulate(in_s + (step % kStages) * kStage,
                     w_s + g * kGroup * kWPitch, acc, warp, lane);
      }
    }
    // output plane p - 1 is complete: the bias, one store a value, 128
    // bytes a warp row
    if (p - 1 >= d0 && store) {
      float* o = y + (size_t)(p - 1) * HW + (size_t)row0 * W + c;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (row0 + j >= H) break;
        o[(size_t)j * W] = has_bias ? acc[0][j] + b : acc[0][j];
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      acc[0][j] = acc[1][j];
      acc[1][j] = acc[2][j];
      acc[2][j] = 0.f;
    }
  }
}

// *run: the output planes a block, as many runs along D as fill the card's
// resident blocks with the shape's tiles (at least one, at most D)
cudaError_t run_length(const void* kernel, long long tiles, int D, int* run) {
  static int resident = 0;  // blocks an SM times the SMs
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, kSmem);
    if (err != cudaSuccess) return err;
    resident = per_sm * sms;
  }
  long long runs = (resident + tiles / 2) / tiles;
  if (runs < 1) runs = 1;
  if (runs > D) runs = D;
  *run = (int)((D + runs - 1) / runs);
  return cudaSuccess;
}

int launch(const float* x, const float* weight, const float* bias, float* y,
           int D, int H, int W, cudaStream_t stream) {
  const long long tiles = (long long)((W + kTileW - 1) / kTileW) *
                          ((H + kTileH - 1) / kTileH);
  if (tiles > 0x7fffffffLL || D > 65535 || (long long)H * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const auto kernel = prob_conv3d_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  int run = 0;
  if (err == cudaSuccess)
    err = run_length(reinterpret_cast<const void*>(kernel), tiles, D, &run);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)tiles, (unsigned)((D + run - 1) / run)), kThreads,
           kSmem, stream>>>(x, weight, bias, y, D, H, W, run);
  return (int)cudaGetLastError();
}

}  // namespace

// x (1, 8, D, H, W), weight (1, 8, 3, 3, 3), bias (1,) or null, y (1, 1,
// D, H, W), all float32 and contiguous; cin 8 and cout 1 only, W a
// multiple of 4 and x on 16 bytes (every row starts on a float4: the
// U-Nets' volumes are 8 times as wide as their deepest level).
extern "C" int raynet_prob_conv3d(const float* x, const float* weight,
                                  const float* bias, float* y, int cin,
                                  int cout, int D, int H, int W,
                                  void* stream) {
  if (D < 0 || H < 0 || W < 0) return (int)cudaErrorInvalidValue;
  if (cin != kCin || cout != 1 || W % 4 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (D == 0 || H == 0 || W == 0) return 0;
  return launch(x, weight, bias, y, D, H, W,
                static_cast<cudaStream_t>(stream));
}
