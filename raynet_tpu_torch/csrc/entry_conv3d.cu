// K6: the entry layer of MVSNet's and CasMVSNet's cost-regularisation U-Net
// (MVSNet_pytorch's and cascade-stereo's CostRegNet conv0): a 3x3x3
// convolution of stride 1 and zero padding 1 from the cost volume's Cin
// channels to 8, with its eval-mode BatchNorm folded into the weight and
// bias, and the ReLU, in one pass:
//   y[co][d][h][w] = relu(b[co] + sum_{ci, kd, kh, kw} w[co][ci][kd][kh][kw]
//                         x[ci][d + kd - 1][h + kh - 1][w + kw - 1])
// for x (Cin, D, H, W) and y (8, D, H, W), NCDHW, an input past an edge
// reading 0.
//
// New in the port, with no TPU counterpart: the JAX package has no MVSNet.
// cuDNN runs this layer as its FFMA implicit GEMM, a 64x32 tile built for
// wide products, of which Cout = 8 fills a quarter of the N side, and the
// ReLU as a pass of its own over the output.
// raynet_tpu_torch/ops/entry_conv3d.py holds the plain version, which takes
// the same steps in the same order (the sums here are fused multiply-adds,
// its sums a product and an add).
//
// What bounds it: 2 x 27 x Cin x 8 operations an output voxel against 4
// (Cin + 8) bytes, so every shape it runs is bound by the card's float32
// FFMA rate (67 TFLOP/s): MVSNet's (32, 256, 296, 400) 419 GFLOP, 6.25 ms,
// against 1.45 ms of bytes. The configuration is float32 with TF32 off: no
// tensor cores, every product a float32 FFMA. So the design keeps the FFMA
// pipe fed and spends few instructions on anything else.
//
// Layout: a lane owns one output column and all 8 output channels of
// kRows = 8 rows of it, one output plane d: 64 sums in registers. A warp
// takes 32 consecutive columns, so each of its shared-memory reads of a
// row is 32 consecutive words (one wavefront, no bank conflict) and each
// store of an output row 128 bytes. A block's 8 warps stack along H: a
// 32 x 64 tile of one plane, blocks over (column tile, row tile) and d, so
// every shape fills the card with one output plane a block (MVSNet 16,640
// blocks, CasMVSNet's stages 3,120 / 8,000 / 7,600). Per input channel the
// block stages the tile's three input planes with their halo (3 x 66 rows
// of 40 columns, c0 - 4 .. c0 + 35, so that a row is 10 aligned float4s)
// in shared memory by cp.async, 16 bytes a copy where W is a multiple of
// 4 (4 bytes elsewhere); the next channel's while this one's products run
// (two buffers, one barrier a channel). Which copies a thread makes, and
// where each lies in a plane, is the same for every plane and channel, so
// it is worked out once. A lane then reads, per kd, the 10 x 3 inputs of
// its window once into registers and each (kd, kh, kw) tap's 8 weights as
// two float4s that the whole block reads at one address: 30 + 18 shared
// loads feed 576 FFMAs. The block's weights, 8 x Cin x 27 (27.6 KB at Cin
// 32), are staged once, ordered (ci, kd, kh, kw, co). Each output voxel
// sums its channels in order, and each channel's taps in (kd, kh, kw)
// order; the bias and the ReLU follow in registers before the one store.
// 91 KB of shared memory and 128 registers a thread: two blocks, 16 warps,
// an SM.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCout = 8;
constexpr int kRows = 8;                   // output rows a lane
constexpr int kWarps = 8;                  // warps a block, stacked along H
constexpr int kThreads = kWarps * 32;
constexpr int kBlocks = 2;                 // blocks an SM: 128 registers
constexpr int kTileW = 32;                 // output columns a block
constexpr int kTileH = kRows * kWarps;     // output rows a block
constexpr int kPitch = 40;                 // input columns c0 - 4 .. c0 + 35
constexpr int kLeft = 4;                   // columns before c0
constexpr int kInH = kTileH + 2;           // input rows with the halo
constexpr int kPlane = kPitch * kInH;      // values an input plane's tile
constexpr int kStage = 3 * kPlane;         // one input channel's 3 planes
constexpr int kTaps = 27;

// cp.async of S floats (4 or 16 bytes); src-size 0 writes zeros and reads
// nothing: the zero padding
template <int S>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (S == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A thread's copies of a plane's tile: copy k = threadIdx.x + s kThreads
// takes S floats of row k / (kPitch / S); off[s] is its offset in an input
// plane, -1 where it lies past an edge (or past the tile's copies).
template <int S>
struct Copies {
  static constexpr int kPerRow = kPitch / S;
  static constexpr int kCount = kInH * kPerRow;
  static constexpr int kSlots = (kCount + kThreads - 1) / kThreads;
  int off[kSlots];

  __device__ __forceinline__ Copies(int h0, int c0, int H, int W) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int k = threadIdx.x + s * kThreads;
      const int gh = h0 - 1 + k / kPerRow;
      const int gc = c0 - kLeft + (k % kPerRow) * S;
      // S = 4: W a multiple of 4, so a float4 lies all in or all out
      const bool ok = k < kCount && gh >= 0 && gh < H && gc >= 0 && gc < W;
      off[s] = ok ? gh * W + gc : -1;
    }
  }

  // input channel ci's planes d - 1 .. d + 1 into buf
  __device__ __forceinline__ void stage(float* buf, const float* x, int ci,
                                        int d, int D, int HW) const {
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const int gd = d - 1 + p;
      const bool plane_ok = gd >= 0 && gd < D;
      const float* src = x + ((size_t)ci * D + (plane_ok ? gd : 0)) * HW;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int k = threadIdx.x + s * kThreads;
        if (s + 1 < kSlots || k < kCount) {
          const bool ok = plane_ok && off[s] >= 0;
          cp_async<S>(buf + p * kPlane + k * S, ok ? src + off[s] : x, ok);
        }
      }
    }
  }
};

template <int CIN, int S>
__global__ void __launch_bounds__(kThreads, kBlocks)
entry_conv3d_kernel(const float* __restrict__ x,
                    const float* __restrict__ weight,
                    const float* __restrict__ bias, float* __restrict__ y,
                    int D, int H, int W) {
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                         // [CIN][kTaps][kCout]
  float* in_s = smem + CIN * kTaps * kCout;  // two stages

  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int c0 = (blockIdx.x % tiles_w) * kTileW;
  const int h0 = (blockIdx.x / tiles_w) * kTileH;
  const int d = blockIdx.y;
  const int HW = H * W;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const Copies<S> copies(h0, c0, H, W);
  copies.stage(in_s, x, 0, d, D, HW);
  cp_async_commit();
  // (co, ci, tap) -> (ci, tap, co): a tap's 8 weights, two float4s
  for (int i = threadIdx.x; i < CIN * kTaps * kCout; i += kThreads) {
    const int co = i % kCout;
    const int t = i / kCout;  // ci * kTaps + tap
    w_s[i] = __ldg(weight + co * CIN * kTaps + t);
  }

  // a warp whose rows all lie past H stages and waits, and computes nothing
  const int row0 = h0 + warp * kRows;
  const bool active = row0 < H;

  float acc[kRows][kCout];
#pragma unroll
  for (int j = 0; j < kRows; ++j)
#pragma unroll
    for (int co = 0; co < kCout; ++co) acc[j][co] = 0.f;

#pragma unroll 1
  for (int ci = 0; ci < CIN; ++ci) {
    cp_async_wait_all();
    __syncthreads();
    // the other buffer was last read before this barrier
    if (ci + 1 < CIN) {
      copies.stage(in_s + ((ci + 1) & 1) * kStage, x, ci + 1, d, D, HW);
      cp_async_commit();
    }
    if (!active) continue;
    // the lane's window: rows warp kRows .., columns c0 + lane - 1 ..
    const float* in = in_s + (ci & 1) * kStage + warp * kRows * kPitch +
                      kLeft - 1 + lane;
    const float4* wq =
        reinterpret_cast<const float4*>(w_s + ci * kTaps * kCout);
#pragma unroll
    for (int kd = 0; kd < 3; ++kd) {
      float v[kRows + 2][3];
#pragma unroll
      for (int r = 0; r < kRows + 2; ++r)
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) v[r][kw] = in[r * kPitch + kw];
#pragma unroll
      for (int kh = 0; kh < 3; ++kh)
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const float4 a = wq[(kh * 3 + kw) * 2];
          const float4 b = wq[(kh * 3 + kw) * 2 + 1];
          const float w[kCout] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
          for (int j = 0; j < kRows; ++j)
#pragma unroll
            for (int co = 0; co < kCout; ++co)
              acc[j][co] = __fmaf_rn(v[j + kh][kw], w[co], acc[j][co]);
        }
      in += kPlane;
      wq += 9 * 2;
    }
  }

  // the epilogue: the bias, the ReLU (NaN kept, as torch.relu keeps it),
  // one store a value, 128 bytes a warp row
  const int c = c0 + lane;
  if (!active || c >= W) return;
  const size_t volume = (size_t)D * HW;
#pragma unroll
  for (int co = 0; co < kCout; ++co) {
    const float bc = __ldg(bias + co);
    float* o = y + co * volume + (size_t)d * HW + (size_t)row0 * W + c;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (row0 + j >= H) break;
      const float v = acc[j][co] + bc;
      o[(size_t)j * W] = v < 0.f ? 0.f : v;
    }
  }
}

template <int CIN, int S>
int launch(const float* x, const float* weight, const float* bias, float* y,
           int D, int H, int W, cudaStream_t stream) {
  const long long tiles = (long long)((W + kTileW - 1) / kTileW) *
                          ((H + kTileH - 1) / kTileH);
  if (tiles > 0x7fffffffLL || D > 65535 || (long long)H * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int smem = (CIN * kTaps * kCout + 2 * kStage) * (int)sizeof(float);
  const auto kernel = entry_conv3d_kernel<CIN, S>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)tiles, (unsigned)D), kThreads, smem, stream>>>(
      x, weight, bias, y, D, H, W);
  return (int)cudaGetLastError();
}

template <int CIN>
int launch(const float* x, const float* weight, const float* bias, float* y,
           int D, int H, int W, cudaStream_t stream) {
  // 16-byte copies where every row starts on a float4
  if (W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0)
    return launch<CIN, 4>(x, weight, bias, y, D, H, W, stream);
  return launch<CIN, 1>(x, weight, bias, y, D, H, W, stream);
}

}  // namespace

// x (1, cin, D, H, W), weight (cout, cin, 3, 3, 3), bias (cout,), y (1,
// cout, D, H, W), all float32 and contiguous; the (cin, cout) pairs of the
// U-Nets' entry layers only.
extern "C" int raynet_entry_conv3d(const float* x, const float* weight,
                                   const float* bias, float* y, int cin,
                                   int cout, int D, int H, int W,
                                   void* stream) {
  if (D < 0 || H < 0 || W < 0) return (int)cudaErrorInvalidValue;
  if (cout != kCout) return (int)cudaErrorInvalidValue;
  if (D == 0 || H == 0 || W == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin == 32) return launch<32>(x, weight, bias, y, D, H, W, s);
  if (cin == 16) return launch<16>(x, weight, bias, y, D, H, W, s);
  if (cin == 8) return launch<8>(x, weight, bias, y, D, H, W, s);
  return (int)cudaErrorInvalidValue;
}
