// K2: one fused BP sweep over the rays of an image (first-iteration, message
// or depth mode), messages updated in place.
//
// Replaces the TPU kernel raynet_tpu/ops/pallas/bp_beam.py::_bp_kernel
// (:1062, launched by bp_beam_call :1700). On the TPU the sweep had to be
// planned: static beam boxes of the grid were copied into VMEM, voxels were
// gathered and scattered with one-hot matmuls (bf16-truncated), and the
// messages lived in a k-major slot layout, batch by batch. On Hopper a
// thread can gather and atomicAdd directly, so this kernel takes the shape
// of the paper's original mrf_bp.cu: one thread per ray, a serial march, and
// one launch for all the rays of an image. The spec is the XLA path,
// raynet_tpu/ops/fused.raynet_message_step / raynet_depth_step, and its
// plain PyTorch twin raynet_tpu_torch/ops/bp_sweep.bp_sweep_reference.
//
// Per ray, in order, each pass re-walking the march (march.cuh) from the
// start, so the passes visit the same cells without any scratch:
//   A. march up to M cells and hat-map the D plane scores onto each cell's
//      centre (t projected on the segment, clipped to [1e-4, 1-1e-4], then
//      interpolated between the two planes that bracket it); the count and
//      the total T1 of the mapped scores s;
//   B. message modes: the recurrence's total, sum_k mu_k excl_k c_k with
//      c = clip(s / T1, 1e-5, 1-1e-5) and mu = sigmoid(grid[v] - own
//      message) clipped to [1e-4, 1-1e-4] (the constant sigmoid(prior) on
//      the first iteration, with no grid gather); depth mode: the first
//      argmax of the posterior mu excl c (the first cell if any term is
//      NaN: the plain version's normalised posterior is then NaN
//      throughout, and torch.argmax and jnp.argmax take its first NaN),
//      and the distance from the camera to that cell's centre (0 when the
//      ray visits no cell);
//   D. message modes: the recurrence again, emitting each new pon message
//      and atomicAdd-ing it into grid_out.
// The plain version renormalises c by its total T2 before the recurrence.
// Every term of pos, neg and the posterior is linear in c, so p = pos /
// (pos + neg) and the argmax do not see that positive scale, and T2 is not
// computed. Rays with count <= 1 get zero messages and scatter nothing
// (count == 1 still has a depth: the first cell's). Messages are written
// for k < count only: entries past a ray's count are left as they are
// (zero in a store that starts at zero, since a ray's count is the same in
// every sweep).
//
// Layout: a warp holds 32 consecutive rays (in a whole image, vertically
// adjacent pixels). The warp stages its rays' D scores, 32 rows of D floats
// in one contiguous block, in shared memory with an odd row stride, and
// moves the (N, M) message rows 32 steps at a time through a shared
// [32][33] tile: lane l loads or stores column c0 + l of each of the 32
// rows, so every row segment is one coalesced 128-byte access, and each
// thread then reads or writes its own row of the tile at its step. A ray's
// messages are read and written in place; messages_in may be messages_out.
//
// Precision: the per-ray sums and products (T1, the recurrence's total,
// cumulative sum and exclusive product, pos and neg) are carried in double.
// Where mu nears its clip 1 - 1e-4, (total - cumsum) / (1 - mu) turns
// float32 rounding of the cumulative sum into pon errors of ~1e-2; in
// double that cancellation costs float64 rounding instead. Per-voxel values
// (mapped scores, mu, messages) stay float32, as in the plain version.
//
// What bounds it on the card: the instructions and latency of each
// thread's serial passes, not the bytes. The bytes the sweep must move (the
// scores, the visited messages read and written once, the visited grid
// cells) are ~40 MB per 65,536 rays; the message rows now move as whole
// 128-byte lines, with no zero tail and no scratch. What remains per
// visited cell is three re-marches with hat mapping (~25 operations each,
// the march's state in local memory), the double-precision recurrence with
// two divisions, expf, logf and log1pf, one grid gather through the
// read-only path (the 4 MB grid stays in L2) and one float atomicAdd.
// 65,536 rays are one partial wave of resident threads, so a batch's
// longest rays set its time; a whole image fills the card. Float atomics
// make the grid's summation order vary from run to run.
#include <cuda_runtime.h>
#include <math.h>

#include "march.cuh"

namespace {

constexpr int kFirst = 0;
constexpr int kMessage = 1;
constexpr int kDepth = 2;
constexpr int kWarps = 2;  // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 33;  // padded row of the message tile
constexpr int kMaxPlanes = 128;
constexpr unsigned kFull = 0xffffffffu;

constexpr float kTLo = (float)1e-4;
constexpr float kTHi = (float)(1.0 - 1e-4);
constexpr float kSLo = (float)1e-5;
constexpr float kSHi = (float)(1.0 - 1e-5);
constexpr float kMuLo = (float)1e-4;
constexpr float kMuHi = (float)(1.0 - 1e-4);
constexpr float kPLo = (float)1e-37;
constexpr float kPHi = (float)(1.0 - 1e-7);
constexpr float kTiny = (float)1e-30;

// NaN-propagating max/clip, as jnp.maximum/jnp.clip and torch.clamp
// behave (fmaxf/fminf would drop a NaN)
__device__ __forceinline__ float maxf(float x, float lo) {
  return x < lo ? lo : x;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Positive occupancy-to-ray message from a log-odds quotient
// (raynet_tpu/ops/mrf.occupancy_to_ray).
__device__ __forceinline__ float occupancy_mu(float pon) {
  const float mx = maxf(pon, 0.0f);
  const float t1 = expf(0.0f - mx);
  const float t2 = expf(pon - mx);
  return clampf(t2 / (t1 + t2), kMuLo, kMuHi);
}

// One ray's segment and the grid it marches.
struct Ray {
  float rs[3], re[3], ray[3], bmin[3], bin[3];
  float rr;
  int grid[3];
};

// The hat-mapped score of the march's current cell from the ray's D plane
// scores S (ops/planes_voxels.depth_planes_to_voxels): the cell centre's t
// on the segment, clipped, interpolated between the two bracketing planes;
// a NaN t gives lo 0.
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

// Columns c0 .. c0+31 of the warp's 32 message rows (from row r0 of an
// (N, M) array) into the tile: lane l moves column c0 + l of every row, so
// each row segment is one coalesced access. Row j moves its columns below
// lane j's n only.
__device__ __forceinline__ void load_tile(float* tile, const float* msg,
                                          size_t r0, int M, int c0, int n,
                                          int lane) {
#pragma unroll 8
  for (int j = 0; j < 32; ++j) {
    const int nj = __shfl_sync(kFull, n, j);
    if (c0 + lane < nj) tile[j * kTile + lane] = msg[(r0 + j) * M + c0 + lane];
  }
}

__device__ __forceinline__ void store_tile(const float* tile, float* msg,
                                           size_t r0, int M, int c0, int n,
                                           int lane) {
#pragma unroll 8
  for (int j = 0; j < 32; ++j) {
    const int nj = __shfl_sync(kFull, n, j);
    if (c0 + lane < nj) msg[(r0 + j) * M + c0 + lane] = tile[j * kTile + lane];
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads) bp_sweep_kernel(
    const float* __restrict__ ray_start, const float* __restrict__ ray_end,
    const float* __restrict__ S_planes, const float* msg_in,
    const float* __restrict__ grid_acc, float* __restrict__ grid_out,
    const float* __restrict__ camera_center, const float* __restrict__ bbox,
    float* msg_out, int* __restrict__ counts,
    float* __restrict__ depth, int N, int M, int D, int gx, int gy, int gz,
    float prior) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ss = D | 1;  // odd stride: 32 lanes at one plane hit 32 banks
  float* S_tile = smem + warp * 32 * ss;
  float* tile = smem + kWarps * 32 * ss + warp * 32 * kTile;

  const size_t r0 = ((size_t)blockIdx.x * kWarps + warp) * 32;
  if (r0 >= (size_t)N) return;  // the whole warp; no block barrier follows
  const int rows = min(32, (int)((size_t)N - r0));
  const bool live = lane < rows;
  const size_t r = r0 + lane;

  // the warp's D-score rows, one contiguous block, into the padded tile
  for (int e = lane; e < rows * D; e += 32)
    S_tile[(e / D) * ss + e % D] = S_planes[r0 * D + e];
  __syncwarp();
  const float* S = S_tile + lane * ss;

  Ray g;
  g.grid[0] = gx;
  g.grid[1] = gy;
  g.grid[2] = gz;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    g.bmin[a] = bbox[a];
    g.bin[a] = (bbox[3 + a] - bbox[a]) / (float)g.grid[a];
    g.rs[a] = live ? ray_start[3 * r + a] : 0.0f;
    g.re[a] = live ? ray_end[3 * r + a] : 0.0f;
    g.ray[a] = g.re[a] - g.rs[a];
  }
  g.rr = g.ray[0] * g.ray[0] + g.ray[1] * g.ray[1] + g.ray[2] * g.ray[2];

  // A: the march's count and the mapped scores' total
  int count = 0;
  double total1 = 0.0;
  if (live) {
    VoxelMarch m;
    if (march_begin(m, g.rs, g.re, g.bmin, g.bin, g.grid)) {
      do {
        total1 += hat_score(m, g, S, D);
        ++count;
      } while (count < M && march_advance(m));
    }
  }
  if (live) counts[r] = count;
  const bool active = count > 1;
  const int n_read = active ? count : 0;  // messages this ray reads
  const float T1 = maxf((float)total1, kTiny);
  const int warp_max = __reduce_max_sync(kFull, count);
  const float mu_const = occupancy_mu(prior);
  float* own = tile + lane * kTile;

  if (MODE == kDepth) {
    // B: the first argmax of the posterior mu excl c
    VoxelMarch m;
    int first = 0;
    if (count > 0) {
      march_begin(m, g.rs, g.re, g.bmin, g.bin, g.grid);
      first = march_flat(m);
    }
    int best = first;
    double excl = 1.0, best_v = -1.0;
    bool any_nan = false;
    for (int c0 = 0; c0 < warp_max; c0 += 32) {
      load_tile(tile, msg_in, r0, M, c0, n_read, lane);
      __syncwarp();
      const int end = min(c0 + 32, n_read);
      for (int k = c0; k < end; ++k) {
        if (k > 0) march_advance(m);
        const int v = march_flat(m);
        const float c = clampf(hat_score(m, g, S, D) / T1, kSLo, kSHi);
        const float mu = occupancy_mu(__ldg(grid_acc + v) - own[k - c0]);
        const double post = (double)mu * excl * c;
        if (post > best_v) {  // ties keep the earliest cell
          best_v = post;
          best = v;
        }
        any_nan |= post != post;
        excl *= (double)(1.0f - mu);
      }
      __syncwarp();
    }
    if (any_nan) best = first;
    float dist = 0.0f;
    if (count > 0) {
      const int cell[3] = {best / (gy * gz), (best / gz) % gy, best % gz};
      float dd[3];
#pragma unroll
      for (int a = 0; a < 3; ++a)
        dd[a] = g.bmin[a] + (float)cell[a] * g.bin[a] + g.bin[a] / 2.0f -
                camera_center[a];
      dist = sqrtf(dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2]);
    }
    if (live) depth[r] = dist;
    return;
  }

  // B: the recurrence's total
  double total = 0.0;
  {
    VoxelMarch m;
    if (active) march_begin(m, g.rs, g.re, g.bmin, g.bin, g.grid);
    double excl = 1.0;
    for (int c0 = 0; c0 < warp_max; c0 += 32) {
      if (MODE == kMessage) {
        load_tile(tile, msg_in, r0, M, c0, n_read, lane);
        __syncwarp();
      }
      const int end = min(c0 + 32, n_read);
      for (int k = c0; k < end; ++k) {
        if (k > 0) march_advance(m);
        const float c = clampf(hat_score(m, g, S, D) / T1, kSLo, kSHi);
        const float mu =
            MODE == kFirst
                ? mu_const
                : occupancy_mu(__ldg(grid_acc + march_flat(m)) - own[k - c0]);
        total += (double)mu * excl * c;
        excl *= (double)(1.0f - mu);
      }
      __syncwarp();
    }
  }

  // D: the new messages, through the tile, and the scatter
  VoxelMarch m;
  if (active) march_begin(m, g.rs, g.re, g.bmin, g.bin, g.grid);
  double excl = 1.0, cum = 0.0;
  for (int c0 = 0; c0 < warp_max; c0 += 32) {
    if (MODE == kMessage) load_tile(tile, msg_in, r0, M, c0, n_read, lane);
    __syncwarp();
    const int end = min(c0 + 32, count);
    for (int k = c0; k < end; ++k) {
      float pon = 0.0f;
      if (active) {
        if (k > 0) march_advance(m);
        const int v = march_flat(m);
        const float c = clampf(hat_score(m, g, S, D) / T1, kSLo, kSHi);
        const float mu =
            MODE == kFirst ? mu_const
                           : occupancy_mu(__ldg(grid_acc + v) - own[k - c0]);
        const float om = 1.0f - mu;
        const double incl = cum + (double)mu * excl * c;
        const double pos = cum + excl * c;
        const double neg = cum + (total - incl) / om;
        const double pn = pos + neg;
        float p = (float)(pos / (pn < (double)kPLo ? (double)kPLo : pn));
        p = clampf(p, kPLo, kPHi);
        pon = logf(p) - log1pf(-p);
        atomicAdd(grid_out + v, pon);
        cum = incl;
        excl *= (double)om;
      }
      own[k - c0] = pon;
    }
    __syncwarp();
    store_tile(tile, msg_out, r0, M, c0, count, lane);
  }
}

template <int MODE>
cudaError_t launch(const float* rs, const float* re, const float* S,
                   const float* msg_in, const float* grid_acc,
                   float* grid_out, const float* center, const float* bbox,
                   float* msg_out, int* counts, float* depth, int N, int M,
                   int D, int gx, int gy, int gz, float prior,
                   cudaStream_t stream) {
  const int blocks = (N + kThreads - 1) / kThreads;
  const size_t smem = sizeof(float) * kWarps * (32 * (D | 1) + 32 * kTile);
  bp_sweep_kernel<MODE><<<blocks, kThreads, smem, stream>>>(
      rs, re, S, msg_in, grid_acc, grid_out, center, bbox, msg_out,
      counts, depth, N, M, D, gx, gy, gz, prior);
  return cudaGetLastError();
}

}  // namespace

// ray_start/ray_end (N, 3) f32; S_planes (N, D) f32, D <= 128; messages_in
// (N, M) f32 (null in first-iteration mode); grid_acc (G,) f32 (unused in
// first-iteration mode); grid_out (G,) f32, atomically accumulated in
// message modes, not overlapping grid_acc; camera_center (3,) f32; bbox
// (6,) f32; messages_out (N, M) f32 (message modes), written for k < count
// only, and may be messages_in itself; counts (N,) i32 out; depth (N,) f32 out
// (depth mode). mode: 0 first iteration, 1 message, 2 depth. Returns
// cudaGetLastError().
extern "C" int raynet_bp_sweep(
    const float* ray_start, const float* ray_end, const float* S_planes,
    const float* messages_in, const float* grid_acc, float* grid_out,
    const float* camera_center, const float* bbox,
    float* messages_out, int* counts, float* depth, int N, int M, int D,
    int gx, int gy, int gz, float prior, int mode, void* stream) {
  if (M < 1 || D < 2 || D > kMaxPlanes || mode < kFirst || mode > kDepth)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RAYNET_BP_LAUNCH(MODE)                                               \
  launch<MODE>(ray_start, ray_end, S_planes, messages_in, grid_acc,           \
               grid_out, camera_center, bbox, messages_out, counts, depth, N, \
               M, D, gx, gy, gz, prior, s)
  const cudaError_t err = mode == kDepth     ? RAYNET_BP_LAUNCH(kDepth)
                          : mode == kFirst   ? RAYNET_BP_LAUNCH(kFirst)
                                             : RAYNET_BP_LAUNCH(kMessage);
#undef RAYNET_BP_LAUNCH
  return (int)err;
}
