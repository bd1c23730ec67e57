// P1: fetch a (BWG=12, BH=16, 128) bf16 box from a (WG, HF, 128) bf16
// source at arbitrary offsets (y0, xg0) with one TMA copy, then write rows
// [sub0 * BH, (sub0 + 4) * BH) of its (BWG * BH, 128) flattening as f32.
//
// Replaces the TPU probe tools/probe_dma_align.py::run (kern :33, call
// :66). On the TPU the question was whether Mosaic's DMA takes a box at
// unaligned offsets in the tiled dimensions; it forced pl.multiple_of(.., 8)
// hints and alignment slack on K1. Here the question is the same for
// Hopper's copy engine (the Tensor Memory Accelerator): one thread of a
// block issues cp.async.bulk.tensor.3d for the whole box at coordinates
// {0, y0, xg0}, the copy reports its bytes to an mbarrier in shared memory,
// and the block waits on it before converting. The box's shape and the one
// copy of all of it are the probe's question and stay as they are. The
// spec is raynet_tpu_torch/tools/probe_dma_align.tma_box_rows_reference.
//
// What bounds it on the card: the host and the launch. It copies the whole
// 49,152-byte box, but its output depends on 16,384 bytes of it; with the
// 32,768 bytes written the function's bound is ~1.5e-5 ms at 3.35 TB/s,
// far below the few microseconds a launch and one round trip to device
// memory take. So the design cuts what each call costs around the copy:
// - the tensor map (cuTensorMapEncodeTiled, reached with
//   cudaGetDriverEntryPoint so the library links no driver library) is
//   encoded once per (device, source address, WG, HF) and kept in a small
//   cache: a map holds only the address, the dims and the strides, so a
//   new tensor at the same address with the same shape gets the same map;
// - the shared-memory limit is set once per device, from the device index
//   the wrapper passes (no cudaGetDevice per call);
// - four blocks each copy the box and convert a quarter of its selected
//   rows, a thread 8 bf16 at a time: one 16-byte read of shared memory,
//   two float4 stores. (One block converting all of them took 0.0028 ms
//   on the device against 0.0018 ms for four, on an H100 80GB HBM3 at
//   700 W; time_kernels --probes, PERF.md.)
// TMA fills a box that leaves the tensor with zeros without an error, so
// the wrapper rejects offsets outside the source; it also checks the
// 16-byte alignment of the source's address that the map requires.
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <mutex>

namespace {

constexpr int kC = 128;   // innermost width (bf16 elements)
constexpr int kBH = 16;   // box rows
constexpr int kBWG = 12;  // box x-groups
constexpr int kNSub = 4;  // x-groups written out
constexpr int kBoxBytes = kBWG * kBH * kC * 2;  // 49,152
constexpr int kOutElems = kNSub * kBH * kC;      // (64, 128)
constexpr int kChunks = kOutElems / 8;           // 8 bf16 (16 bytes) each
constexpr int kThreads = 256;
constexpr int kBlocks = 4;  // each copies the box, converts a quarter
constexpr int kPerBlock = kChunks / kBlocks;
// the box is the whole static shared-memory limit: dynamic shared memory,
// with slack to align the destination to 128 bytes
constexpr int kSmemBytes = kBoxBytes + 128;

__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xFFFF0000u);
}

__global__ void __launch_bounds__(kThreads)
    tma_box_kernel(const __grid_constant__ CUtensorMap map,
                   float* __restrict__ out, int y0, int xg0, int sub0) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ alignas(8) uint64_t bar;
  unsigned char* box = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  const uint32_t box_s = static_cast<uint32_t>(__cvta_generic_to_shared(box));
  const uint32_t bar_s = static_cast<uint32_t>(__cvta_generic_to_shared(&bar));

  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar_s)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar_s),
        "r"(kBoxBytes)
        : "memory");
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(box_s),
        "l"(reinterpret_cast<uint64_t>(&map)), "r"(0), "r"(y0), "r"(xg0),
        "r"(bar_s)
        : "memory");
  }
  // phase 0 completes when the one arrival and all the box's bytes are in;
  // a copy that never completes traps (a launch error) instead of hanging
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 24)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar_s), "r"(0u)
        : "memory");
  }

  // the box lies in shared memory as (BWG, BH, 128) row-major, so the
  // selected rows are one contiguous run; bf16 -> f32 is exact: the bf16
  // bits are the high half of the f32. Block b converts chunks
  // [b, b + 1) * kPerBlock.
  const uint4* rows = reinterpret_cast<const uint4*>(box) +
                      (size_t)sub0 * kBH * kC / 8;
  float4* out4 = reinterpret_cast<float4*>(out);
  const int end = (blockIdx.x + 1) * kPerBlock;
  for (int i = blockIdx.x * kPerBlock + threadIdx.x; i < end; i += kThreads) {
    const uint4 v = rows[i];
    out4[2 * i] = make_float4(bf16_lo(v.x), bf16_hi(v.x), bf16_lo(v.y),
                              bf16_hi(v.y));
    out4[2 * i + 1] = make_float4(bf16_lo(v.z), bf16_hi(v.z), bf16_lo(v.w),
                                  bf16_hi(v.w));
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The last few tensor maps encoded, replaced in turn. The wrapper's
// caller may launch from several threads (ctypes releases the GIL), so
// the cache and the per-device flags sit behind one mutex.
struct MapEntry {
  bool used;
  int device;
  const void* src;
  int WG, HF;
  CUtensorMap map;
};
constexpr int kCacheSize = 8;
MapEntry map_cache[kCacheSize];
int next_entry = 0;
uint64_t smem_set = 0;  // bit d: the shared-memory limit is set on device d
std::mutex cache_mutex;

// the map of (device, src, WG, HF) into *map: 0, or 1000 + the CUresult
// of cuTensorMapEncodeTiled (1000 + 500 when the driver has no such entry
// point). Called with cache_mutex held.
int tensor_map(int device, const void* src, int WG, int HF, CUtensorMap* map) {
  for (const MapEntry& m : map_cache) {
    if (m.used && m.device == device && m.src == src && m.WG == WG &&
        m.HF == HF) {
      std::memcpy(map, &m.map, sizeof(CUtensorMap));
      return 0;
    }
  }
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return 1000 + (int)CUDA_ERROR_NOT_FOUND;
  // innermost dimension first; strides of the outer two in bytes
  const cuuint64_t dims[3] = {(cuuint64_t)kC, (cuuint64_t)HF, (cuuint64_t)WG};
  const cuuint64_t strides[2] = {(cuuint64_t)kC * 2, (cuuint64_t)HF * kC * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kC, (cuuint32_t)kBH,
                             (cuuint32_t)kBWG};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(src), dims, strides, box,
                        elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_NONE,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return 1000 + (int)res;
  MapEntry& slot = map_cache[next_entry];
  next_entry = (next_entry + 1) % kCacheSize;
  slot.used = true;
  slot.device = device;
  slot.src = src;
  slot.WG = WG;
  slot.HF = HF;
  std::memcpy(&slot.map, map, sizeof(CUtensorMap));
  return 0;
}

}  // namespace

// src (WG, HF, 128) bf16 contiguous, 16-byte aligned, on device `device`
// (the current device); out (64, 128) f32, 16-byte aligned. The wrapper
// checks 0 <= y0 <= HF - 16, 0 <= xg0 <= WG - 12 and 0 <= sub0 <= 8.
// Returns cudaGetLastError(), or 1000 + the CUresult
// of cuTensorMapEncodeTiled when the map cannot be encoded (1000 + 500
// when the driver has no such entry point).
extern "C" int raynet_probe_tma_box(const void* src, float* out, int WG,
                                    int HF, int y0, int xg0, int sub0,
                                    int device, void* stream) {
  if (WG < kBWG || HF < kBH || y0 < 0 || y0 > HF - kBH || xg0 < 0 ||
      xg0 > WG - kBWG || sub0 < 0 || sub0 > kBWG - kNSub || device < 0 ||
      device >= 64)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  {
    std::lock_guard<std::mutex> lock(cache_mutex);
    const int err = tensor_map(device, src, WG, HF, &map);
    if (err != 0) return err;
    if (!((smem_set >> device) & 1)) {
      const cudaError_t set = cudaFuncSetAttribute(
          tma_box_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kSmemBytes);
      if (set != cudaSuccess) return (int)set;
      smem_set |= uint64_t(1) << device;
    }
  }
  tma_box_kernel<<<kBlocks, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      map, out, y0, xg0, sub0);
  return (int)cudaGetLastError();
}
