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
// One warp computes one 16x8 tile of the output with
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, looping over K in
// steps of 8 and accumulating in f32 registers. Operands come straight
// from device memory (at (128, 128) the whole problem is 192 KiB and sits
// in L2). Fragments, with g = lane >> 2 and t = lane & 3 (PTX ISA, matrix
// fragments for mma.m16n8k8 with .tf32):
//   A (row-major, 16x8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                        a3 (g + 8, t + 4)
//   B (col, 8x8):        b0 (t, g), b1 (t + 4, g)
//   C (16x8):            c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                        c3 (g + 8, 2t + 1)
//
// What bounds it on the card: launch latency. 2 * 128^3 TF32 operations
// and 192 KiB (bound ~5.9e-5 ms, by bytes) are far below a launch.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;  // four warps, four output tiles per block

template <bool kRna>
__device__ __forceinline__ uint32_t operand(float v) {
  uint32_t r;
  if (kRna)
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  else
    r = __float_as_uint(v);
  return r;
}

template <bool kRna>
__global__ void __launch_bounds__(kThreads)
    tf32_dot_kernel(const float* __restrict__ x, const float* __restrict__ e,
                    float* __restrict__ out, int M, int N, int K) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int tiles_n = N / 8;
  if (warp >= (M / 16) * tiles_n) return;  // whole warps only
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp / tiles_n) * 16, n0 = (warp % tiles_n) * 8;
  const float* xa = x + (size_t)(m0 + g) * K;
  const float* xb = xa + (size_t)8 * K;
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
  for (int k0 = 0; k0 < K; k0 += 8) {
    const uint32_t a0 = operand<kRna>(xa[k0 + t]);
    const uint32_t a1 = operand<kRna>(xb[k0 + t]);
    const uint32_t a2 = operand<kRna>(xa[k0 + t + 4]);
    const uint32_t a3 = operand<kRna>(xb[k0 + t + 4]);
    const uint32_t b0 = operand<kRna>(e[(size_t)(k0 + t) * N + n0 + g]);
    const uint32_t b1 = operand<kRna>(e[(size_t)(k0 + t + 4) * N + n0 + g]);
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};"
        : "+f"(c0), "+f"(c1), "+f"(c2), "+f"(c3)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  float* o0 = out + (size_t)(m0 + g) * N + n0 + 2 * t;
  float* o1 = o0 + (size_t)8 * N;
  o0[0] = c0;
  o0[1] = c1;
  o1[0] = c2;
  o1[1] = c3;
}

}  // namespace

// x (M, K) f32 and e (K, N) f32 row-major contiguous; out (M, N) f32.
// M % 16 == 0, N % 8 == 0, K % 8 == 0 (the wrapper checks). rna: 0 passes
// the f32 bits to the tensor cores as they are, 1 converts each operand
// with cvt.rna.tf32.f32 first. Returns cudaGetLastError().
extern "C" int raynet_probe_tf32_dot(const float* x, const float* e,
                                     float* out, int M, int N, int K,
                                     int rna, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M % 16 || N % 8 || K % 8)
    return (int)cudaErrorInvalidValue;
  const int warps = (M / 16) * (N / 8);
  const int blocks = (warps * 32 + kThreads - 1) / kThreads;
  if (rna)
    tf32_dot_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        x, e, out, M, N, K);
  else
    tf32_dot_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        x, e, out, M, N, K);
  return (int)cudaGetLastError();
}
