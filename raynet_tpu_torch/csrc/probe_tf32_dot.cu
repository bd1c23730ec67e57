// P2: a float32 matrix product on the tensor cores, with f32 accumulation,
// to learn what the card rounds float32 operands to.
//
// Replaces the TPU probe tools/probe_dma_align.py::probe_f32_dot_truncation
// (kern :104, call :114), which found that an f32 dot inside a Pallas
// kernel on the v5e rounds its operands to bf16. On Hopper the tensor
// cores are the only float32 product below full f32: they take TF32
// operands (10 mantissa bits). This kernel asks what they do with f32 bits
// given as they are ("raw"), beside the documented conversion
// cvt.rna.tf32.f32 (round to nearest, ties away; "rna"). Whichever
// rounding a later tensor-core design of K1 or K2 meets, it is this one.
// The spec is raynet_tpu_torch/tools/probe_dma_align.
// tensor_core_dot_reference.
//
// The instruction stays mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32:
// the probe's question is what this path does with raw f32 bits. wgmma
// (the warpgroup product, the card's full TF32 rate) reads its operands
// from shared memory through its own path and would ask another question.
//
// Design: a block of four warps stages its A row panel and its B column
// panel in shared memory one slice of K at a time, with 16-byte cp.async
// copies (4-byte ones when an operand is not 16-byte aligned), and the
// warps multiply one slice while the next ones load. Two block shapes,
// chosen by the launcher from the output's size:
// - large outputs (as many 64x64 tiles as the card has SMs): a 64x64
//   tile, each warp a 32x32 block of it (2x4 m16n8k8 tiles, so that each A
//   fragment serves four products and each B fragment two), K in slices of
//   32, two in flight;
// - small outputs (128^3 has four 64x64 tiles): a 32x32 tile, each warp
//   16x16 (1x2 tiles), K in slices of 32, four in flight, so that 128^3
//   runs as 16 blocks with all of K loading at once and each warp's chain
//   of products is short. Fewer, larger warp blocks were slower there (on
//   an H100 80GB HBM3 at 700 W, `time_kernels --probes`: 0.0080 ms for
//   four 64x64 blocks, 0.0104 ms for sixteen 32x32 blocks of one warp,
//   against 0.0041 ms for the first version and 0.0039 ms for this one).
// Each thread copies (and, in "rna" mode, rounds) a fixed number of
// 16-byte chunks a slice, in unrolled loops. Rows and columns outside the
// matrices, and K past its end, are zero-filled and never stored. The
// staged rows are padded (A by 4 floats, B by 8), so that the fragment
// reads, lanes (g, t) at g * (kBK + 4) + t in A and t * (kBN + 8) + g in
// B, hit 32 distinct banks. In "rna" mode each thread rounds the elements
// it staged once, in shared memory, before the block reads them. Each
// output element sums its k-steps of 8 in ascending order into one f32
// accumulator, as the first version of this kernel did (one warp per 16x8
// tile, operands read from device memory), so the products are that
// version's bit for bit.
//
// Fragments, with g = lane >> 2 and t = lane & 3 (PTX ISA, matrix
// fragments for mma.m16n8k8 with .tf32):
//   A (row-major, 16x8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                        a3 (g + 8, t + 4)
//   B (col, 8x8):        b0 (t, g), b1 (t + 4, g)
//   C (16x8):            c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                        c3 (g + 8, 2t + 1)
//
// What bounds it on the card: at (128, 128, 128) the host's launch path
// (13-22 us a call against ~0.004 ms on the device) and then the launch:
// 2 * 128^3 TF32 operations and 192 KiB (bound ~5.9e-5 ms, by bytes) are
// far below a launch and one round trip to device memory. At 1024^3 the
// operations (bound ~4.3e-3 ms at 495 TFLOP/s): mma.sync issues from one
// warp at a time and reaches only part of the rate that wgmma does.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copy kVec floats, or zero-fill them when !valid (src-size 0)
template <int kVec>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
  const int n = valid ? 4 * kVec : 0;
  if (kVec == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void round_rna(float* p) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(*p));
  *p = __uint_as_float(r);
}

// A block of kWarpsM x kWarpsN warps, each computing kTM x kTN m16n8k8
// tiles; K in slices of kBK, kStages of them staged at a time.
template <int kWarpsM, int kWarpsN, int kTM, int kTN, int kBK, int kStages>
struct Tile {
  static constexpr int kThreads = 32 * kWarpsM * kWarpsN;
  static constexpr int kSlice = kBK, kDepth = kStages;
  static constexpr int kWM = 16 * kTM, kWN = 8 * kTN;  // a warp's block
  static constexpr int kBM = kWM * kWarpsM, kBN = kWN * kWarpsN;
  static constexpr int kAStride = kBK + 4;  // floats per staged A row
  static constexpr int kBStride = kBN + 8;  // floats per staged B row
  struct Stage {
    float a[kBM][kAStride];  // A[m0 + r][k0 + c]
    float b[kBK][kBStride];  // B[k0 + r][n0 + c]
  };
  static_assert(sizeof(Stage) * kStages <= 48 * 1024, "static smem");
  static_assert((kBM * kBK) % (4 * kThreads) == 0 &&
                    (kBK * kBN) % (4 * kThreads) == 0,
                "whole chunks per thread");
};

// Stage K slice [k0, k0 + kBK) of the block's A rows and B columns; with
// kRound, round each element this thread staged (call again after the
// copies landed). Each thread takes the same chunks in both calls.
template <class T, int kVec, bool kRound>
__device__ __forceinline__ void stage(typename T::Stage& s,
                                      const float* __restrict__ x,
                                      const float* __restrict__ e, int M,
                                      int N, int K, int m0, int n0, int k0) {
  constexpr int kBK = T::kSlice;
  constexpr int kAPerRow = kBK / kVec, kBPerRow = T::kBN / kVec;
#pragma unroll
  for (int j = 0; j < T::kBM * kAPerRow / T::kThreads; ++j) {
    const int i = threadIdx.x + j * T::kThreads;
    const int r = i / kAPerRow, c = (i % kAPerRow) * kVec;
    float* dst = &s.a[r][c];
    if (kRound) {
#pragma unroll
      for (int v = 0; v < kVec; ++v) round_rna(dst + v);
    } else {
      const bool valid = m0 + r < M && k0 + c < K;
      cp_async<kVec>(dst, valid ? x + (size_t)(m0 + r) * K + k0 + c : x,
                     valid);
    }
  }
#pragma unroll
  for (int j = 0; j < kBK * kBPerRow / T::kThreads; ++j) {
    const int i = threadIdx.x + j * T::kThreads;
    const int r = i / kBPerRow, c = (i % kBPerRow) * kVec;
    float* dst = &s.b[r][c];
    if (kRound) {
#pragma unroll
      for (int v = 0; v < kVec; ++v) round_rna(dst + v);
    } else {
      const bool valid = k0 + r < K && n0 + c < N;
      cp_async<kVec>(dst, valid ? e + (size_t)(k0 + r) * N + n0 + c : e,
                     valid);
    }
  }
}

template <class T, bool kRna, int kVec>
__global__ void __launch_bounds__(T::kThreads)
    tf32_dot_kernel(const float* __restrict__ x, const float* __restrict__ e,
                    float* __restrict__ out, int M, int N, int K) {
  constexpr int kBK = T::kSlice, kStages = T::kDepth;
  constexpr int kTM = T::kWM / 16, kTN = T::kWN / 8;
  constexpr int kWarpsN = T::kBN / T::kWN;
  __shared__ __align__(16) typename T::Stage stages[kStages];
  const int tiles_n = (N + T::kBN - 1) / T::kBN;
  const int m0 = (blockIdx.x / tiles_n) * T::kBM;
  const int n0 = (blockIdx.x % tiles_n) * T::kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / kWarpsN) * T::kWM, wn = (warp % kWarpsN) * T::kWN;
  float acc[kTM][kTN][4] = {};

  // slice sl goes to stage sl % kStages; one commit group per slice (an
  // empty one past the last), so that wait_group kStages - 1 at slice sl
  // leaves slices sl + 1 ... in flight and slice sl landed
  const int slices = (K + kBK - 1) / kBK;
#pragma unroll
  for (int sl = 0; sl < kStages - 1; ++sl) {
    if (sl < slices)
      stage<T, kVec, false>(stages[sl], x, e, M, N, K, m0, n0, sl * kBK);
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  for (int sl = 0; sl < slices; ++sl) {
    const int ahead = sl + kStages - 1;
    if (ahead < slices)
      stage<T, kVec, false>(stages[ahead % kStages], x, e, M, N, K, m0, n0,
                            ahead * kBK);
    asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 1) : "memory");
    typename T::Stage& s = stages[sl % kStages];
    const int k0 = sl * kBK;
    if (kRna) stage<T, kVec, true>(s, x, e, M, N, K, m0, n0, k0);
    __syncthreads();
    const int steps = min(kBK, K - k0) / 8;
    for (int step = 0; step < steps; ++step) {
      const int kb = step * 8;
      uint32_t af[kTM][4], bf[kTN][2];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int r = wm + i * 16 + g;
        af[i][0] = __float_as_uint(s.a[r][kb + t]);
        af[i][1] = __float_as_uint(s.a[r + 8][kb + t]);
        af[i][2] = __float_as_uint(s.a[r][kb + t + 4]);
        af[i][3] = __float_as_uint(s.a[r + 8][kb + t + 4]);
      }
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int c = wn + j * 8 + g;
        bf[j][0] = __float_as_uint(s.b[kb + t][c]);
        bf[j][1] = __float_as_uint(s.b[kb + t + 4][c]);
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j)
          asm volatile(
              "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
              "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
              "{%0, %1, %2, %3};"
              : "+f"(acc[i][j][0]), "+f"(acc[i][j][1]), "+f"(acc[i][j][2]),
                "+f"(acc[i][j][3])
              : "r"(af[i][0]), "r"(af[i][1]), "r"(af[i][2]), "r"(af[i][3]),
                "r"(bf[j][0]), "r"(bf[j][1]));
    }
    __syncthreads();  // a later slice's copies overwrite this stage
  }

  // M % 16 == 0 and N % 8 == 0: a tile is inside the output or outside it
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = m0 + wm + i * 16 + g;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = n0 + wn + j * 8 + 2 * t;
      if (c >= N) continue;
      *reinterpret_cast<float2*>(out + (size_t)r * N + c) =
          make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(out + (size_t)(r + 8) * N + c) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
  }
}

template <int kWarpsM, int kWarpsN, int kTM, int kTN, int kBK, int kStages,
          bool kRna>
void launch(const float* x, const float* e, float* out, int M, int N, int K,
            bool vec16, cudaStream_t stream) {
  using T = Tile<kWarpsM, kWarpsN, kTM, kTN, kBK, kStages>;
  const unsigned blocks = (unsigned)((M + T::kBM - 1) / T::kBM) *
                          (unsigned)((N + T::kBN - 1) / T::kBN);
  if (vec16)
    tf32_dot_kernel<T, kRna, 4>
        <<<blocks, T::kThreads, 0, stream>>>(x, e, out, M, N, K);
  else
    tf32_dot_kernel<T, kRna, 1>
        <<<blocks, T::kThreads, 0, stream>>>(x, e, out, M, N, K);
}

template <bool kRna>
void launch_for_size(const float* x, const float* e, float* out, int M,
                     int N, int K, bool vec16, cudaStream_t stream) {
  // 64x64 tiles once there are as many as the card has SMs (132): at
  // 1024^3 the 32x32 tiles alone took 0.107 ms on the device against
  // 0.062-0.063 ms (H100 80GB HBM3 at 700 W, time_kernels --probes)
  if ((long long)((M + 63) / 64) * ((N + 63) / 64) >= 132)
    launch<2, 2, 2, 4, 32, 2, kRna>(x, e, out, M, N, K, vec16, stream);
  else
    launch<2, 2, 1, 2, 32, 4, kRna>(x, e, out, M, N, K, vec16, stream);
}

}  // namespace

// x (M, K) f32 and e (K, N) f32 row-major contiguous; out (M, N) f32,
// 8-byte aligned. M % 16 == 0, N % 8 == 0, K % 8 == 0 (the wrapper
// checks). rna: 0 passes the f32 bits to the tensor cores as they are, 1
// converts each operand with cvt.rna.tf32.f32 first. Returns
// cudaGetLastError().
extern "C" int raynet_probe_tf32_dot(const float* x, const float* e,
                                     float* out, int M, int N, int K,
                                     int rna, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M % 16 || N % 8 || K % 8 ||
      (long long)((M + 31) / 32) * ((N + 31) / 32) > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  // K % 8 and N % 8 keep every row 16-byte aligned if the base is
  const bool vec16 = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                     (reinterpret_cast<uintptr_t>(e) % 16 == 0);
  if (rna)
    launch_for_size<true>(x, e, out, M, N, K, vec16, (cudaStream_t)stream);
  else
    launch_for_size<false>(x, e, out, M, N, K, vec16, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
