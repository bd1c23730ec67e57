// Amanatides-Woo voxel march of one ray segment, as a __device__ routine
// shared by the port's kernels (K2 now; the standalone traversal kernel K3,
// raynet_tpu/ops/pallas/traversal.py::_kernel, when it is ported).
//
// Semantics of raynet_tpu/ops/ray_marching.voxel_traversal (and
// raynet_tpu_torch/ops/ray_marching.py), bit for bit when built with
// -fmad=false:
// - both endpoints nudged by eps = 1e-2 bins along the step direction;
// - cells are floor(s / bin);
// - the first cell is emitted iff it lies inside the grid;
// - crossing times are CLOSED FORM, t_max + n * t_delta (no drifting
//   incremental adds);
// - axis choice tx<ty ? (tx<tz ? X : Z) : (ty<tz ? Y : Z);
// - the march stops after emitting the last cell, or without emitting when
//   the next cell leaves the grid.
#pragma once

#include <cfloat>
#include <math.h>

struct VoxelMarch {
  int cur[3];
  int last[3];
  int step[3];
  int ncross[3];
  int grid[3];
  float t_max[3];
  float t_delta[3];
};

// Sets up the march from world-space endpoints; returns true when the
// first cell is inside the grid (it is then m.cur).
__device__ __forceinline__ bool march_begin(VoxelMarch& m, const float* rs,
                                            const float* re, const float* bmin,
                                            const float* bin,
                                            const int* grid) {
  const float eps = 1e-2f;
  bool inside = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float start = rs[a] - bmin[a];
    float end = re[a] - bmin[a];
    const float ray = end - start;
    const int step = ray >= 0.0f ? 1 : -1;
    const float stepf = (float)step;
    start = start + stepf * bin[a] * eps;
    end = end - stepf * bin[a] * eps;
    const int cur = (int)floorf(start / bin[a]);
    m.cur[a] = cur;
    m.last[a] = (int)floorf(end / bin[a]);
    m.step[a] = step;
    m.ncross[a] = 0;
    m.grid[a] = grid[a];
    inside = inside && cur >= 0 && cur < grid[a];
    const float cc = (float)cur * bin[a];
    const float boundary =
        (step < 0 && cc < start) ? cc : cc + stepf * bin[a];
    m.t_max[a] = ray != 0.0f ? (boundary - start) / ray : FLT_MAX;
    m.t_delta[a] = ray != 0.0f ? stepf * bin[a] / ray : FLT_MAX;
  }
  return inside;
}

// Moves to the next cell. Returns false (and leaves m.cur) when the ray
// already sits in its last cell or the next cell is outside the grid.
__device__ __forceinline__ bool march_advance(VoxelMarch& m) {
  if (m.cur[0] == m.last[0] && m.cur[1] == m.last[1] && m.cur[2] == m.last[2])
    return false;
  float t[3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    t[a] = m.t_max[a] + (float)m.ncross[a] * m.t_delta[a];
  const int axis = t[0] < t[1] ? (t[0] < t[2] ? 0 : 2) : (t[1] < t[2] ? 1 : 2);
  const int moved = m.cur[axis] + m.step[axis];
  if (moved < 0 || moved >= m.grid[axis]) return false;
  m.cur[axis] = moved;
  m.ncross[axis] += 1;
  return true;
}

// Row-major flat index of the current cell.
__device__ __forceinline__ int march_flat(const VoxelMarch& m) {
  return m.cur[0] * (m.grid[1] * m.grid[2]) + m.cur[1] * m.grid[2] + m.cur[2];
}
