// K2: one fused BP sweep over a batch of rays (first-iteration, message or
// depth mode).
//
// Replaces the TPU kernel raynet_tpu/ops/pallas/bp_beam.py::_bp_kernel
// (:1062, launched by bp_beam_call :1700). On the TPU the sweep had to be
// planned: static beam boxes of the grid were copied into VMEM, voxels were
// gathered and scattered with one-hot matmuls (bf16-truncated), and the
// messages lived in a k-major slot layout. On Hopper a thread can gather
// and atomicAdd directly, so this kernel takes the shape of the paper's
// original mrf_bp.cu: one thread per ray, a serial march. The spec is the
// XLA path, raynet_tpu/ops/fused.raynet_message_step / raynet_depth_step,
// and its plain PyTorch twin raynet_tpu_torch/ops/bp_sweep.bp_sweep_reference.
//
// Per ray, in order:
//   A. march the grid (march.cuh) up to M cells, keeping the flat indices,
//      and hat-map the D plane scores onto each visited cell's centre
//      (t projected on the segment, clipped to [1e-4, 1-1e-4]); the sum of
//      the mapped scores renormalises them (mask: k < count);
//   B. clip to [1e-5, 1-1e-5] and renormalise again (mask: count > 1);
//   C. message modes: the forward recurrence, for its total: mu =
//      sigmoid(grid[v] - own message) clipped to [1e-4, 1-1e-4] (the
//      constant sigmoid(prior) on the first iteration, with no grid gather);
//   D. message modes: the recurrence again, emitting each new pon message
//      and atomicAdd-ing it into grid_out; depth mode: one pass for the
//      first argmax of the posterior, and the distance from the camera to
//      that cell's centre (0 when the ray visits no cell).
// Rays with valid == 0 are treated as visiting no cell; rays with
// count <= 1 get zero messages and scatter nothing (count == 1 still has a
// depth: the first cell's).
//
// Precision: the per-ray sums and products (the two normalising totals,
// the cumulative sum and the exclusive product of the recurrence, pos and
// neg) are carried in double. Where mu nears its clip 1 - 1e-4,
// (total - cumsum) / (1 - mu) turns float32 rounding of the cumulative sum
// into pon errors of ~1e-2; in double that cancellation costs float64
// rounding instead. Per-voxel values (mapped scores, mu, messages) stay
// float32, as in the plain version.
//
// What bounds it on the card: memory latency of the serial per-ray loops.
// Each ray reads its D scores, and per visited cell one grid value and one
// message, and writes one message plus one atomic; the passes touch the
// per-ray scratch (flat index, mapped score) up to four times. The scratch is
// k-major, (M, N), so a warp's 32 rays at the same step k hit consecutive
// words; the (N, M) messages stay in DDA order like the XLA path, at the
// price of uncoalesced message reads and writes. Float atomics make the
// grid's summation order vary from run to run.
#include <cuda_runtime.h>
#include <math.h>

#include "march.cuh"

namespace {

// modes: 0 first iteration, 1 message (any later iteration), 2 depth
constexpr int kFirst = 0;
constexpr int kDepth = 2;
constexpr int kThreads = 128;

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

__global__ void bp_sweep_kernel(
    const float* __restrict__ ray_start, const float* __restrict__ ray_end,
    const int* __restrict__ valid, const float* __restrict__ S_planes,
    const float* __restrict__ msg_in, const float* __restrict__ grid_acc,
    float* __restrict__ grid_out, const float* __restrict__ camera_center,
    const float* __restrict__ bbox, float* __restrict__ msg_out,
    int* __restrict__ counts, float* __restrict__ depth,
    int* __restrict__ idx_s, float* __restrict__ sv_s, int N, int M, int D,
    int gx, int gy, int gz, float prior, int mode) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  const int grid[3] = {gx, gy, gz};
  float bmin[3], bin[3], rs[3], re[3], ray[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    bmin[a] = bbox[a];
    bin[a] = (bbox[3 + a] - bbox[a]) / (float)grid[a];
    rs[a] = ray_start[3 * r + a];
    re[a] = ray_end[3 * r + a];
    ray[a] = re[a] - rs[a];
  }
  const float rr = ray[0] * ray[0] + ray[1] * ray[1] + ray[2] * ray[2];
  const float* S = S_planes + (size_t)r * D;
  const float scale = (float)(D - 1);
  // scratch is k-major: element k of ray r sits at k * N + r
  int* idx = idx_s + r;
  float* sv = sv_s + r;

  // A: march + hat mapping
  int count = 0;
  double total1 = 0.0;
  if (valid[r] != 0) {
    VoxelMarch m;
    if (march_begin(m, rs, re, bmin, bin, grid)) {
      do {
        float c[3];
#pragma unroll
        for (int a = 0; a < 3; ++a)
          c[a] = bmin[a] + (float)m.cur[a] * bin[a] + bin[a] / 2.0f;
        const float t = clampf(((c[0] - rs[0]) * ray[0] +
                                (c[1] - rs[1]) * ray[1] +
                                (c[2] - rs[2]) * ray[2]) / rr,
                               kTLo, kTHi);
        float s = 0.0f;
        for (int d = 0; d < D; ++d) {
          const float w = maxf(1.0f - fabsf(t - (float)d / scale) * scale, 0.0f);
          s = s + S[d] * w;
        }
        idx[(size_t)count * N] = march_flat(m);
        sv[(size_t)count * N] = s;
        total1 += s;
        ++count;
      } while (count < M && march_advance(m));
    }
  }
  counts[r] = count;
  const bool active = count > 1;
  float* out = msg_out != nullptr ? msg_out + (size_t)r * M : nullptr;

  // B: the two renormalisations; Sr(k) = clip(s_k / T1) / T2
  const float T1 = maxf((float)total1, kTiny);
  double total2 = 0.0;
  if (active)
    for (int k = 0; k < count; ++k)
      total2 += clampf(sv[(size_t)k * N] / T1, kSLo, kSHi);
  const float T2 = maxf((float)total2, kTiny);
  const float* mrow = msg_in != nullptr ? msg_in + (size_t)r * M : nullptr;
  const float mu_const = occupancy_mu(prior);

  if (mode != kDepth) {
    int k0 = 0;
    if (active) {
      // C: the recurrence's total
      double excl = 1.0, cum = 0.0;
      for (int k = 0; k < count; ++k) {
        const float Sr = clampf(sv[(size_t)k * N] / T1, kSLo, kSHi) / T2;
        const float mu = mode == kFirst
                             ? mu_const
                             : occupancy_mu(grid_acc[idx[(size_t)k * N]] - mrow[k]);
        cum += (double)mu * excl * Sr;
        excl *= (double)(1.0f - mu);
      }
      const double total = cum;
      // D: new messages + scatter
      excl = 1.0;
      cum = 0.0;
      for (int k = 0; k < count; ++k) {
        const float Sr = clampf(sv[(size_t)k * N] / T1, kSLo, kSHi) / T2;
        const int v = idx[(size_t)k * N];
        const float mu =
            mode == kFirst ? mu_const : occupancy_mu(grid_acc[v] - mrow[k]);
        const float om = 1.0f - mu;
        const double incl = cum + (double)mu * excl * Sr;
        const double pos = cum + excl * Sr;
        const double neg = cum + (total - incl) / om;
        const double pn = pos + neg;
        float p = (float)(pos / (pn < (double)kPLo ? (double)kPLo : pn));
        p = clampf(p, kPLo, kPHi);
        const float pon = logf(p) - log1pf(-p);
        out[k] = pon;
        atomicAdd(grid_out + v, pon);
        cum = incl;
        excl *= (double)om;
      }
      k0 = count;
    }
    for (int k = k0; k < M; ++k) out[k] = 0.0f;
    return;
  }

  // depth mode
  int best = 0;
  if (active) {
    // the posterior mu * excl * Sr, normalised by its total, is a
    // positive scale of mu * excl * Sr: its argmax needs no total
    double excl = 1.0, best_v = -1.0;
    for (int k = 0; k < count; ++k) {
      const float Sr = clampf(sv[(size_t)k * N] / T1, kSLo, kSHi) / T2;
      const float mu = occupancy_mu(grid_acc[idx[(size_t)k * N]] - mrow[k]);
      const double post = (double)mu * excl * Sr;
      if (post > best_v) {  // ties keep the earliest cell
        best_v = post;
        best = k;
      }
      excl *= (double)(1.0f - mu);
    }
  }
  float dist = 0.0f;
  if (count > 0) {
    const int f = idx[(size_t)best * N];
    const int cell[3] = {f / (gy * gz), (f / gz) % gy, f % gz};
    float dd[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      dd[a] = bmin[a] + (float)cell[a] * bin[a] + bin[a] / 2.0f -
              camera_center[a];
    dist = sqrtf(dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2]);
  }
  depth[r] = dist;
}

}  // namespace

// ray_start/ray_end (N, 3) f32; valid (N,) i32; S_planes (N, D) f32;
// messages_in (N, M) f32 (null in first-iteration mode); grid_acc (G,) f32
// (unused in first-iteration mode); grid_out (G,) f32, atomically
// accumulated in message modes; camera_center (3,) f32; bbox (6,) f32;
// messages_out (N, M) f32 (message modes); counts (N,) i32 out;
// depth (N,) f32 out (depth mode); idx_scratch (M, N) i32 and
// s_scratch (M, N) f32 scratch. mode: 0 first iteration, 1 message,
// 2 depth. Returns cudaGetLastError().
extern "C" int raynet_bp_sweep(
    const float* ray_start, const float* ray_end, const int* valid,
    const float* S_planes, const float* messages_in, const float* grid_acc,
    float* grid_out, const float* camera_center, const float* bbox,
    float* messages_out, int* counts, float* depth, int* idx_scratch,
    float* s_scratch, int N, int M, int D, int gx, int gy, int gz, float prior,
    int mode, void* stream) {
  if (M < 1 || D < 2 || mode < kFirst || mode > kDepth)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const int blocks = (N + kThreads - 1) / kThreads;
  bp_sweep_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ray_start, ray_end, valid, S_planes, messages_in, grid_acc, grid_out,
      camera_center, bbox, messages_out, counts, depth, idx_scratch, s_scratch,
      N, M, D, gx, gy, gz, prior, mode);
  return (int)cudaGetLastError();
}
