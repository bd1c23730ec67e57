// K3: Amanatides-Woo voxel traversal of ray segments, in two modes.
//
// Replaces the TPU kernel raynet_tpu/ops/pallas/traversal.py::_kernel (:28,
// launched by voxel_traversal_flat_pallas :135). On the TPU a grid step
// owned a (8, 128) block of 1024 rays whose march state lived in VMEM for
// all M steps, and stored step-major (M, N/128, 128) blocks that XLA then
// transposed to (N, M). Here one thread marches one ray with the shared
// __device__ march of march.cuh, which K2 (bp_sweep.cu) runs too, so the
// kernels order crossings identically by construction. A warp holds 32
// consecutive rays (in a whole image, vertically adjacent pixels).
//
// Rows mode (raynet_voxel_traversal; spec
// raynet_tpu_torch/ops/ray_marching.voxel_traversal_flat_reference): the
// flat row-major voxel index of every step, idx (N, M) int32, and counts
// (N,) int32. Every entry is written: entries from count to M-1 are 0, also
// for a ray whose first cell lies outside the grid (count 0), so the
// wrapper allocates with torch.empty. What bounds it: the bytes written,
// 4 * M + 4 per ray against 24 read (at M = 384, 100.7 MB per 65,536 rays),
// and then the march's serial latency. A thread owning a row would make a
// warp's store at step k touch 32 lines; instead each lane fills its own
// row of a shared [32][33] int tile for 32 steps, and lane l then stores
// column c0 + l of each of the warp's 32 rows, so every store is one
// coalesced 128-byte line. The chunks run to the warp's longest count; the
// rest of the rows (the zero tail) is stored the same way, without the
// tile.
//
// Voxel-depth mode (raynet_voxel_argmax_depth; spec
// raynet_tpu_torch/ops/voxel_depth.voxel_argmax_depth_reference, the tail
// of the mvcnn voxel-space step): per ray, the march of up to M cells,
// each cell's hat-mapped plane score s (hat.cuh, K2's mapping), the FIRST
// cell of maximum s, and the distance from the camera centre to that
// cell's centre (0 for a ray that visits no cell), with the count. No (N,
// M) array exists: the ray's D scores are staged in shared memory with an
// odd row stride (as in K2) and the march runs once. The plain version
// takes the argmax of s / T, T the ray's positive total: the division
// cannot reorder two scores, only merge two an ulp apart, so s is compared
// directly. If any s is NaN (a zero-length segment that marches cells: t =
// 0/0) the plain version's row is NaN throughout and its argmax is the
// first entry, so the kernel takes the first cell. What bounds it: the
// march and mapping, ~40 operations per visited cell in one serial loop
// per thread; its bytes are 24 + 4 D read and 8 written per ray.
#include <cuda_runtime.h>
#include <math.h>

#include "hat.cuh"
#include "march.cuh"

namespace {

constexpr int kWarps = 4;  // rows mode: warps per block
constexpr int kDepthWarps = 2;  // voxel-depth mode: warps per block
constexpr int kTile = 33;  // padded row of the index tile
constexpr int kMaxPlanes = 128;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(32 * kWarps) traversal_rows_kernel(
    const float* __restrict__ bbox, const float* __restrict__ ray_start,
    const float* __restrict__ ray_end, int* __restrict__ idx,
    int* __restrict__ counts, int N, int M, int gx, int gy, int gz) {
  __shared__ int tiles[kWarps][32 * kTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t r0 = ((size_t)blockIdx.x * kWarps + warp) * 32;
  if (r0 >= (size_t)N) return;  // the whole warp; no block barrier follows
  const int rows = min(32, (int)((size_t)N - r0));
  const bool live = lane < rows;
  const size_t r = r0 + lane;
  int* tile = tiles[warp];
  int* own = tile + lane * kTile;
  int* out = idx + r0 * M;  // the warp's rows, one contiguous block

  const Ray g = ray_setup(ray_start, ray_end, r, live, bbox, gx, gy, gz);
  VoxelMarch m;
  bool going = live && march_begin(m, g.rs, g.re, g.bmin, g.bin, g.grid);
  int count = 0;
  int c0 = 0;
  for (; c0 < M && __any_sync(kFull, going); c0 += 32) {
    // this lane's steps c0 .. c0+31 into its tile row, zero past its count
#pragma unroll 4
    for (int k = 0; k < 32; ++k) {
      int v = 0;
      if (going) {
        v = march_flat(m);
        ++count;
        going = count < M && march_advance(m);
      }
      own[k] = v;
    }
    __syncwarp();
    if (c0 + lane < M)
      for (int j = 0; j < rows; ++j)
        out[(size_t)j * M + c0 + lane] = tile[j * kTile + lane];
    __syncwarp();
  }
  // the zero tail past the warp's longest count
  for (int j = 0; j < rows; ++j)
    for (int c = c0 + lane; c < M; c += 32) out[(size_t)j * M + c] = 0;
  if (live) counts[r] = count;
}

__global__ void __launch_bounds__(32 * kDepthWarps) voxel_depth_kernel(
    const float* __restrict__ bbox, const float* __restrict__ ray_start,
    const float* __restrict__ ray_end, const float* __restrict__ S_planes,
    const float* __restrict__ camera_center, float* __restrict__ depth,
    int* __restrict__ counts, int N, int M, int D, int gx, int gy, int gz) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ss = D | 1;  // odd stride: 32 lanes at one plane hit 32 banks
  float* S_tile = smem + warp * 32 * ss;
  const size_t r0 = ((size_t)blockIdx.x * kDepthWarps + warp) * 32;
  if (r0 >= (size_t)N) return;  // the whole warp; no block barrier follows
  const int rows = min(32, (int)((size_t)N - r0));
  const size_t r = r0 + lane;

  // the warp's D-score rows, one contiguous block, into the padded tile
  for (int e = lane; e < rows * D; e += 32)
    S_tile[(e / D) * ss + e % D] = S_planes[r0 * D + e];
  __syncwarp();
  if (lane >= rows) return;  // nothing below is warp-wide
  const float* S = S_tile + lane * ss;

  const Ray g = ray_setup(ray_start, ray_end, r, true, bbox, gx, gy, gz);
  int count = 0;
  float dist = 0.0f;
  VoxelMarch m;
  if (march_begin(m, g.rs, g.re, g.bmin, g.bin, g.grid)) {
    const int first[3] = {m.cur[0], m.cur[1], m.cur[2]};
    int best[3] = {first[0], first[1], first[2]};
    float best_s = -INFINITY;
    bool any_nan = false;
    do {
      const float s = hat_score(m, g, S, D);
      if (s > best_s) {  // ties keep the earliest cell
        best_s = s;
#pragma unroll
        for (int a = 0; a < 3; ++a) best[a] = m.cur[a];
      }
      any_nan |= s != s;
      ++count;
    } while (count < M && march_advance(m));
    dist = cell_distance(any_nan ? first : best, g, camera_center);
  }
  depth[r] = dist;
  counts[r] = count;
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
  const int threads = 32 * kWarps;
  const int blocks = (N + threads - 1) / threads;
  traversal_rows_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      bbox, ray_start, ray_end, idx, counts, N, M, gx, gy, gz);
  return (int)cudaGetLastError();
}

// bbox (6,) f32; ray_start/ray_end (N, 3) f32; S_planes (N, D) f32 plane
// scores, 2 <= D <= 128; camera_center (3,) f32; depth (N,) f32 out; counts
// (N,) i32 out; all contiguous. Returns cudaGetLastError().
extern "C" int raynet_voxel_argmax_depth(
    const float* bbox, const float* ray_start, const float* ray_end,
    const float* S_planes, const float* camera_center, float* depth,
    int* counts, int N, int M, int D, int gx, int gy, int gz, void* stream) {
  if (M < 1 || N < 0 || D < 2 || D > kMaxPlanes || gx < 1 || gy < 1 ||
      gz < 1)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const int threads = 32 * kDepthWarps;
  const int blocks = (N + threads - 1) / threads;
  const size_t smem = sizeof(float) * kDepthWarps * 32 * (D | 1);
  voxel_depth_kernel<<<blocks, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      bbox, ray_start, ray_end, S_planes, camera_center, depth, counts, N, M,
      D, gx, gy, gz);
  return (int)cudaGetLastError();
}
