// K5: MVSNet's upsampling layer (Yao et al., ECCV 2018; MVSNet_pytorch's
// CostRegNet conv7, conv9 and conv11): a 3x3x3 transposed convolution of
// stride 2, padding 1 and output padding 1 with its eval-mode BatchNorm
// folded into the weight and bias, the ReLU and the U-Net's skip sum, in
// one pass, written over the skip tensor:
//   io[co][o] = relu(b[co] + sum_{ci, i, k : o = 2 i - 1 + k}
//                    x[ci][i] w[ci][co][k]) + io[co][o]
// per dim, for x (Cin, D, H, W) and io (Cout, 2D, 2H, 2W), NCDHW.
//
// New in the port, with no TPU counterpart: the JAX package has no MVSNet
// and no transposed convolution. cuDNN runs these layers as its dgrad
// kernels at ~0.5 TFLOP/s, and the ReLU and the skip sum as two more
// passes over the output. raynet_tpu_torch/ops/transposed_conv3d.py holds
// the plain version, which takes the same steps in the same order (the
// sums here are fused multiply-adds, its sums a product and an add).
//
// The gather by output parity: per dim, an even output o = 2m takes tap
// k = 1 of input m; an odd one o = 2m + 1 takes k = 0 of input m + 1 (none
// past the input's last, where the output padding ends) and k = 2 of input
// m. So a thread that owns input voxel (a, b, c) computes the 2x2x2 outputs
// at (2a.., 2b.., 2c..) from the 8 inputs (a..a+1, b..b+1, c..c+1): the 27
// taps of each (ci, co) pair spread over the 8 outputs with no scatter, no
// atomics and no branch between even and odd outputs.
//
// What bounds it: at MVSNet's DTU size (D 256, 296 x 400 maps) the three
// layers take 22.9 G multiply-accumulates a view, ~0.7 ms at the float32
// rate of 67 TFLOP/s, and move 2.86 GB (the input read, the skip read, the
// result written), 0.85 ms at 3.35 TB/s: c7 and c9 are bound by the
// operations, c11 (16 -> 8 channels, 0.97 GB written) by the bytes. The
// configuration is float32 with TF32 off: no tensor cores, every product a
// float32 FFMA.
//
// Layout: a thread takes kCouts output channels of kRows input voxels
// (a, b0..b0+kRows-1, c), one column c a lane, so that a warp covers 32
// consecutive columns: its loads of a row are 128 bytes, and its stores of
// an output row (the even and odd outputs of a column as one float2) 256.
// Per input channel it loads the 2 x (kRows + 1) x 2 inputs it reads once
// (the next channel's while this one's products run) and each output
// channel's 27 weights, 7 float4s from shared memory that the whole warp
// reads at one address; each weight then serves kRows voxels and each input
// up to kCouts x 8 outputs. The 64 sums stay in registers, which are
// capped at 128 a thread for 16 warps an SM. Measured on an H100 80GB HBM3
// at 700 W, the three layers a view: 2 channels x 4 rows uncapped (216
// registers, 8 warps an SM) 6.23 ms; capped at 170, 4.83; capped at 128,
// 4.21 (a few values spill to local memory); 2 x 2, 4.32; 1 x 4, 5.15;
// 4 x 2, 3.72. A block's weights are its kCouts output channels for every
// input channel (28 KB at 64 -> 32), staged once. Blocks run with the
// output-channel group fastest, so the blocks that read one input tile run
// together and share it in L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCouts = 4;    // output channels a thread
constexpr int kRows = 2;     // input rows b a thread
constexpr int kWarps = 4;    // warps a block
constexpr int kBlocks = 4;   // blocks an SM: 128 registers a thread
constexpr int kTaps = 27;
constexpr int kTapPad = 28;  // the 27 taps padded to 7 float4s

// per output parity p and its tap t (1 + p of them): the input's offset
// (m or m + 1) and the kernel's tap k
__device__ constexpr int in_offset(int p, int t) {
  return p == 1 && t == 0 ? 1 : 0;
}
__device__ constexpr int tap(int p, int t) {
  return p == 0 ? 1 : (t == 0 ? 0 : 2);
}

__device__ __forceinline__ void load_inputs(
    const float* __restrict__ p, float (&v)[2][kRows + 1][2],
    const bool (&row_ok)[2][kRows + 1], const bool (&col_ok)[2],
    size_t plane, int W) {
#pragma unroll
  for (int da = 0; da < 2; ++da)
#pragma unroll
    for (int j = 0; j <= kRows; ++j)
#pragma unroll
      for (int dc = 0; dc < 2; ++dc)
        v[da][j][dc] = row_ok[da][j] && col_ok[dc]
                           ? __ldg(p + da * plane + (size_t)j * W + dc)
                           : 0.f;
}

template <int CIN, int COUT>
__global__ void __launch_bounds__(kWarps * 32, kBlocks)
transposed_conv3d_kernel(
    const float* __restrict__ x, const float* __restrict__ weight,
    const float* __restrict__ bias, float* io, int D, int H, int W) {
  static_assert(COUT % kCouts == 0, "output channels in whole groups");
  constexpr int kGroups = COUT / kCouts;
  __shared__ __align__(16) float w_s[CIN][kCouts][kTapPad];
  const int group = blockIdx.x % kGroups;
  const int co0 = group * kCouts;
  for (int i = threadIdx.x; i < CIN * kCouts * kTapPad; i += blockDim.x) {
    const int t = i % kTapPad;
    const int m = (i / kTapPad) % kCouts;
    const int ci = i / (kTapPad * kCouts);
    w_s[ci][m][t] =
        t < kTaps ? weight[((size_t)ci * COUT + co0 + m) * kTaps + t] : 0.f;
  }
  __syncthreads();

  // this warp's 32 columns and kRows rows of one input plane a: columns
  // fastest, then rows, then planes
  const int tiles = (W + 31) / 32;
  const int bands = (H + kRows - 1) / kRows;
  const int warp = (blockIdx.x / kGroups) * kWarps + threadIdx.x / 32;
  const int tile = warp % tiles;
  const int band = (warp / tiles) % bands;
  const int a = warp / (tiles * bands);
  if (a >= D) return;
  const int b0 = band * kRows;
  const int c = tile * 32 + threadIdx.x % 32;

  // an input past the far edge of a dim reads 0
  bool row_ok[2][kRows + 1];
#pragma unroll
  for (int da = 0; da < 2; ++da)
#pragma unroll
    for (int j = 0; j <= kRows; ++j)
      row_ok[da][j] = a + da < D && b0 + j < H;
  const bool col_ok[2] = {c < W, c + 1 < W};

  const size_t plane = (size_t)H * W;
  const size_t volume = plane * D;
  const float* p = x + ((size_t)a * H + b0) * W + c;

  float acc[kCouts][kRows][2][2][2];
#pragma unroll
  for (int m = 0; m < kCouts; ++m)
#pragma unroll
    for (int j = 0; j < kRows; ++j)
#pragma unroll
      for (int q = 0; q < 8; ++q)
        acc[m][j][q >> 2][(q >> 1) & 1][q & 1] = 0.f;

  float v[2][kRows + 1][2], next[2][kRows + 1][2];
  load_inputs(p, v, row_ok, col_ok, plane, W);
#pragma unroll 2
  for (int ci = 0; ci < CIN; ++ci) {
    if (ci + 1 < CIN)
      load_inputs(p + (ci + 1) * volume, next, row_ok, col_ok, plane, W);
#pragma unroll
    for (int m = 0; m < kCouts; ++m) {
      float w[kTapPad];
      const float4* wq = reinterpret_cast<const float4*>(w_s[ci][m]);
#pragma unroll
      for (int q = 0; q < kTapPad / 4; ++q) {
        const float4 t = wq[q];
        w[4 * q] = t.x;
        w[4 * q + 1] = t.y;
        w[4 * q + 2] = t.z;
        w[4 * q + 3] = t.w;
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j)
#pragma unroll
        for (int pd = 0; pd < 2; ++pd)
#pragma unroll
          for (int ph = 0; ph < 2; ++ph)
#pragma unroll
            for (int pw = 0; pw < 2; ++pw)
#pragma unroll
              for (int td = 0; td <= pd; ++td)
#pragma unroll
                for (int th = 0; th <= ph; ++th)
#pragma unroll
                  for (int tw = 0; tw <= pw; ++tw)
                    acc[m][j][pd][ph][pw] = __fmaf_rn(
                        v[in_offset(pd, td)][j + in_offset(ph, th)]
                         [in_offset(pw, tw)],
                        w[9 * tap(pd, td) + 3 * tap(ph, th) + tap(pw, tw)],
                        acc[m][j][pd][ph][pw]);
    }
#pragma unroll
    for (int da = 0; da < 2; ++da)
#pragma unroll
      for (int j = 0; j <= kRows; ++j)
#pragma unroll
        for (int dc = 0; dc < 2; ++dc) v[da][j][dc] = next[da][j][dc];
  }

  // the epilogue: the bias, the ReLU (NaN kept, as torch.relu keeps it),
  // then the skip read and the result written in its place, a float2 (the
  // even and odd output of column c) a lane
  if (c >= W) return;
  const int OW = 2 * W;
  const size_t oplane = (size_t)(2 * H) * OW;
  const size_t ovolume = oplane * (2 * D);
#pragma unroll
  for (int m = 0; m < kCouts; ++m) {
    const float bm = __ldg(bias + co0 + m);
    float* o = io + (size_t)(co0 + m) * ovolume + (size_t)(2 * a) * oplane +
               2 * c;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (b0 + j >= H) break;
#pragma unroll
      for (int pd = 0; pd < 2; ++pd)
#pragma unroll
        for (int ph = 0; ph < 2; ++ph) {
          float2* q = reinterpret_cast<float2*>(
              o + pd * oplane + (size_t)(2 * (b0 + j) + ph) * OW);
          const float2 s = *q;
          float y0 = acc[m][j][pd][ph][0] + bm;
          float y1 = acc[m][j][pd][ph][1] + bm;
          y0 = y0 < 0.f ? 0.f : y0;
          y1 = y1 < 0.f ? 0.f : y1;
          *q = make_float2(y0 + s.x, y1 + s.y);
        }
    }
  }
}

template <int CIN, int COUT>
int launch(const float* x, const float* weight, const float* bias, float* io,
           int D, int H, int W, cudaStream_t stream) {
  const long long warps = (long long)D * ((H + kRows - 1) / kRows) *
                          ((W + 31) / 32);
  const long long blocks = (warps + kWarps - 1) / kWarps * (COUT / kCouts);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  transposed_conv3d_kernel<CIN, COUT>
      <<<(unsigned)blocks, kWarps * 32, 0, stream>>>(x, weight, bias, io, D,
                                                     H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// x (1, cin, D, H, W), weight (cin, cout, 3, 3, 3), bias (cout,), io (1,
// cout, 2D, 2H, 2W), all float32 and contiguous, io 8-byte aligned; the
// (cin, cout) pairs of MVSNet's U-Net only.
extern "C" int raynet_transposed_conv3d(const float* x, const float* weight,
                                        const float* bias, float* io,
                                        int cin, int cout, int D, int H,
                                        int W, void* stream) {
  if (D < 0 || H < 0 || W < 0) return (int)cudaErrorInvalidValue;
  if (D == 0 || H == 0 || W == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin == 64 && cout == 32)
    return launch<64, 32>(x, weight, bias, io, D, H, W, s);
  if (cin == 32 && cout == 16)
    return launch<32, 16>(x, weight, bias, io, D, H, W, s);
  if (cin == 16 && cout == 8)
    return launch<16, 8>(x, weight, bias, io, D, H, W, s);
  return (int)cudaErrorInvalidValue;
}
