// K3: Amanatides-Woo voxel traversal of a batch of ray segments, emitting
// the flat row-major voxel index of every step and the count per ray.
//
// Replaces the TPU kernel raynet_tpu/ops/pallas/traversal.py::_kernel (:28,
// launched by voxel_traversal_flat_pallas :135). On the TPU a grid step
// owned a (8, 128) block of 1024 rays whose march state lived in VMEM for
// all M steps, and stored step-major (M, N/128, 128) blocks that XLA then
// transposed to (N, M). Here one thread marches one ray with the shared
// __device__ march of march.cuh, which K2 (bp_sweep.cu) runs too, so the
// two kernels order crossings identically by construction; the spec is
// raynet_tpu_torch/ops/ray_marching.voxel_traversal_flat_reference.
//
// Output: idx (N, M) int32 row-major and counts (N,) int32. Every entry is
// written: entries from count to M-1 are 0, also for a ray whose first
// cell lies outside the grid (count 0), so the wrapper allocates with
// torch.empty. The march stops after emitting the last cell, or without
// emitting when the next cell leaves the grid, and the row is then zero to
// its end.
//
// What bounds it on the card: bytes written. Per ray it reads 24 bytes of
// endpoints and writes 4 * M + 4 bytes (at M = 384 and 65,536 rays, 100.7
// MB of indices against 1.6 MB read), and the march itself is a few dozen
// integer and float operations per step. The design keeps the march in
// registers and writes each index once, straight into its row. A thread
// writes its own row, so a warp's store at step k touches 32 lines, and
// the kernel relies on the L2 to fill each 32-byte sector from the next
// steps of the same thread before it reaches device memory. Staging steps
// through shared memory for coalesced row writes is left for a later change.
#include <cuda_runtime.h>

#include "march.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void traversal_kernel(const float* __restrict__ bbox,
                                 const float* __restrict__ ray_start,
                                 const float* __restrict__ ray_end,
                                 int* __restrict__ idx,
                                 int* __restrict__ counts, int N, int M,
                                 int gx, int gy, int gz) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;  // the ragged last block
  const int grid[3] = {gx, gy, gz};
  float bmin[3], bin[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    bmin[a] = bbox[a];
    // (max - min) / grid in f32, as the plain version and the TPU kernel
    bin[a] = (bbox[3 + a] - bbox[a]) / (float)grid[a];
  }
  int* row = idx + (size_t)r * M;
  int count = 0;
  VoxelMarch m;
  if (march_begin(m, ray_start + 3 * (size_t)r, ray_end + 3 * (size_t)r,
                  bmin, bin, grid)) {
    do {
      row[count] = march_flat(m);
      ++count;
    } while (count < M && march_advance(m));
  }
  counts[r] = count;
  for (int k = count; k < M; ++k) row[k] = 0;
}

}  // namespace

// bbox (6,) f32 [min_xyz, max_xyz]; ray_start/ray_end (N, 3) f32
// contiguous; idx (N, M) i32 out; counts (N,) i32 out. The flat index
// gx * gy * gz must fit int32 (the wrapper checks). Returns
// cudaGetLastError().
extern "C" int raynet_voxel_traversal(const float* bbox,
                                      const float* ray_start,
                                      const float* ray_end, int* idx,
                                      int* counts, int N, int M, int gx,
                                      int gy, int gz, void* stream) {
  if (M < 1 || N < 0 || gx < 1 || gy < 1 || gz < 1)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const int blocks = (N + kThreads - 1) / kThreads;
  traversal_kernel<<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      bbox, ray_start, ray_end, idx, counts, N, M, gx, gy, gz);
  return (int)cudaGetLastError();
}
