// The depth-plane -> voxel hat mapping shared by the port's marching
// kernels: K2 (bp_sweep.cu) and K3's voxel-depth mode (traversal.cu), so
// both map plane scores onto a cell from one source, as they march from one
// (march.cuh).
//
// Semantics of raynet_tpu_torch/ops/planes_voxels.planes_to_voxels_mapping
// before its renormalisation, bit for bit when built with -fmad=false: the
// cell centre's parameter t on the segment, clipped to [1e-4, 1 - 1e-4],
// and the interpolation between the two planes that bracket it.
#pragma once

#include <math.h>

#include "march.cuh"

constexpr float kTLo = (float)1e-4;
constexpr float kTHi = (float)(1.0 - 1e-4);

// NaN-propagating max/clip, as jnp.maximum/jnp.clip and torch.clamp
// behave (fmaxf/fminf would drop a NaN)
__device__ __forceinline__ float maxf(float x, float lo) {
  return x < lo ? lo : x;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// One ray's segment and the grid it marches.
struct Ray {
  float rs[3], re[3], ray[3], bmin[3], bin[3];
  float rr;
  int grid[3];
};

// Ray r's segment (from (N, 3) endpoint arrays) through the grid of
// ``bbox`` (6,) [min_xyz, max_xyz] with gx x gy x gz cells; a zero segment
// where ``live`` is false (a lane past the last ray).
__device__ __forceinline__ Ray ray_setup(const float* __restrict__ ray_start,
                                         const float* __restrict__ ray_end,
                                         size_t r, bool live,
                                         const float* __restrict__ bbox,
                                         int gx, int gy, int gz) {
  Ray g;
  g.grid[0] = gx;
  g.grid[1] = gy;
  g.grid[2] = gz;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    g.bmin[a] = bbox[a];
    // (max - min) / grid in f32, as the plain version and the TPU kernel
    g.bin[a] = (bbox[3 + a] - bbox[a]) / (float)g.grid[a];
    g.rs[a] = live ? ray_start[3 * r + a] : 0.0f;
    g.re[a] = live ? ray_end[3 * r + a] : 0.0f;
    g.ray[a] = g.re[a] - g.rs[a];
  }
  g.rr = g.ray[0] * g.ray[0] + g.ray[1] * g.ray[1] + g.ray[2] * g.ray[2];
  return g;
}

// The hat-mapped score of the march's current cell from the ray's D plane
// scores S (ops/planes_voxels.depth_planes_to_voxels): the cell centre's t
// on the segment, clipped, interpolated between the two bracketing planes;
// a NaN t (a zero-length segment: 0/0) gives lo 0 and a NaN score.
__device__ __forceinline__ float hat_score(const VoxelMarch& m, const Ray& g,
                                           const float* S, int D) {
  float c[3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    c[a] = g.bmin[a] + (float)m.cur[a] * g.bin[a] + g.bin[a] / 2.0f;
  const float t = clampf(((c[0] - g.rs[0]) * g.ray[0] +
                          (c[1] - g.rs[1]) * g.ray[1] +
                          (c[2] - g.rs[2]) * g.ray[2]) / g.rr,
                         kTLo, kTHi);
  const float x = t * (float)(D - 1);
  int lo = (int)floorf(x);
  lo = lo < 0 ? 0 : (lo > D - 2 ? D - 2 : lo);
  const float f = x - (float)lo;
  return S[lo] + (S[lo + 1] - S[lo]) * f;
}

// Distance from the camera centre to the centre of cell ``cell`` (x, y, z),
// as ops/ray_marching.voxel_centers and the plain versions' norm evaluate it.
__device__ __forceinline__ float cell_distance(const int* cell, const Ray& g,
                                               const float* camera_center) {
  float dd[3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    dd[a] = g.bmin[a] + (float)cell[a] * g.bin[a] + g.bin[a] / 2.0f -
            camera_center[a];
  return sqrtf(dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2]);
}
