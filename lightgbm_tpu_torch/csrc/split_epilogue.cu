// split_epilogue.cu -- the split-finding epilogue of a histogram tile pass.
//
// Replaces the epilogue half of lightgbm_tpu/ops/pallas_hist.py
// _fused_epi_kernel / _gather_epi_kernel, i.e. _epilogue_compute in both
// of its modes: in q8 mode dequantize the int32 tile (each cell
// acc * qscale[stat], rounded on its own before anything else touches it,
// as the JAX package's _round_fence does), then in both modes derive each
// odd (derived) slot's plane as parent - computed sibling, then
// ops/split.py numerical_candidates.
//
// One block per (slot, feature); one thread per bin (B <= 256):
//   1. full plane: derived slots read parent - tile[slot - 1], the others
//      the tile itself (the TPU kernel's static lane shift); a q8 tile is
//      read as __fmul_rn((float)acc, qscale[stat]);
//   2. the excluded bins of missing types NaN and Zero are zeroed;
//   3. the bin-axis cumulative sum in the plain version's order
//      (utils/ordered.py blocked_cumsum: a left-to-right prefix inside each
//      16-bin block from +0, a left-to-right prefix of the block totals,
//      one add of the two);
//   4. both directional scans (the accumulated side's hessian starts at
//      kEpsilon), leaf outputs with l1 / l2 / max_delta_step / path_smooth,
//      gains, the min_data / min_hessian masks and the strict
//      gain > min_gain_shift;
//   5. the reference's within-feature tie order: the reverse scan first,
//      keeping its highest-threshold maximum; the forward scan replaces
//      only on a strictly greater gain, lowest threshold first.
// Output: the full [P, F, B, 3] planes and the [P, F, 12] candidate table
// (ops/split.py CAND_*).
//
// Numerics: the table must be BITWISE equal to the plain version on the
// same planes, so every float operation is the plain version's, in its
// order, each rounded on its own: the library is built with --fmad=false
// (nvcc would otherwise contract a multiply feeding an add into an FMA).
//
// What bounds it on an H100: the work is P*F blocks of B threads, a few
// dozen flops per thread and ~3 plane reads/writes per cell -- about 3 us
// of bytes at the main path's shapes (P=42, F=28, B=255), so one launch
// (a few microseconds) is the floor. The design keeps it one launch per
// tile pass with every intermediate in shared memory; what it leaves on
// the table is latency: one thread per block runs the block-total scan and
// the 2*B-entry argmax serially (PERF.md has the measured time).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxBins = 256;
constexpr int kBlock = 16;        // the plain version's scan block
constexpr int kCand = 12;
constexpr int kMissingNone = 0, kMissingZero = 1, kMissingNan = 2;

struct Params {
  float l1, l2, max_delta_step, path_smooth, min_data, min_hess, min_gain;
};

// XLA's sign: +-1, +-0 for +-0, NaN for NaN (ops/split.py _sign)
__device__ __forceinline__ float xla_sign(float x) {
  if (x == 0.f || x != x) return x;
  return copysignf(1.f, x);
}

// torch.maximum(x, 0): NaN propagates
__device__ __forceinline__ float max0(float x) {
  if (x != x) return x;
  return x > 0.f ? x : 0.f;
}

__device__ __forceinline__ float threshold_l1(float s, float l1) {
  return xla_sign(s) * max0(fabsf(s) - l1);
}

__device__ __forceinline__ float leaf_output(float g, float h, float cnt,
                                             float parent_out,
                                             const Params& p) {
  float ret = -threshold_l1(g, p.l1) / (h + p.l2);
  if (p.max_delta_step > 0.f && fabsf(ret) > p.max_delta_step)
    ret = xla_sign(ret) * p.max_delta_step;
  if (p.path_smooth > static_cast<float>(1e-15)) {
    const float nos = cnt / p.path_smooth;
    ret = ret * (nos / (nos + 1.f)) + parent_out / (nos + 1.f);
  }
  return ret;
}

__device__ __forceinline__ float gain_given_output(float g, float h,
                                                   float out,
                                                   const Params& p) {
  const float sg = threshold_l1(g, p.l1);
  return -((2.f * sg) * out + ((h + p.l2) * out) * out);
}

// Cell `at` (stat c) of the tile: the f32 value, or in q8 mode (qscale
// set) the int32 sum dequantized by one rounded multiply.
__device__ __forceinline__ float tile_cell(const float* __restrict__ tile,
                                           const int32_t* __restrict__ qtile,
                                           const float* __restrict__ qscale,
                                           size_t at, int c) {
  if (qscale) return __fmul_rn(__int2float_rn(qtile[at]), qscale[c]);
  return tile[at];
}

__global__ void split_epilogue_kernel(const float* __restrict__ tile,
                                      const int32_t* __restrict__ qtile,
                                      const float* __restrict__ qscale,
                                      const float* __restrict__ parent,
                                      const int32_t* __restrict__ der,
                                      const float* __restrict__ la,
                                      const float* __restrict__ fm,
                                      const float* __restrict__ pv,
                                      float* __restrict__ full,
                                      float* __restrict__ cand,
                                      int f, int b) {
  __shared__ float hx[3][kMaxBins];      // excluded-zeroed plane
  __shared__ float within[3][kMaxBins];  // per-block prefix
  __shared__ float tot[3][kMaxBins / kBlock];
  __shared__ float key_rev[kMaxBins], key_fwd[kMaxBins];
  __shared__ float sums[12][kMaxBins];

  const int slot = blockIdx.x;
  const int feat = blockIdx.y;
  const int t = threadIdx.x;
  const Params prm{pv[0], pv[1], pv[2], pv[3], pv[4], pv[5], pv[6]};
  const int nb = static_cast<int>(fm[feat * 8 + 0]);
  const int mt = static_cast<int>(fm[feat * 8 + 1]);
  const int dbin = static_cast<int>(fm[feat * 8 + 2]);
  const bool mode_a = nb > 2 && mt != kMissingNone;
  const bool is_nan = mt == kMissingNan;
  const bool is_zero = mt == kMissingZero;
  const bool derived = der[slot * 3] != 0;

  const size_t plane = (size_t)b * 3;
  const size_t base = ((size_t)slot * f + feat) * plane;
  const size_t sib = slot > 0 ? ((size_t)(slot - 1) * f + feat) * plane : 0;

  // 1-2. full plane (written out) and its excluded-zeroed copy
  if (t < b) {
    const bool excl = (mode_a && is_nan && t == nb - 1)
                      || (mode_a && is_zero && t == dbin);
    for (int c = 0; c < 3; ++c) {
      const size_t at = base + (size_t)t * 3 + c;
      float v = tile_cell(tile, qtile, qscale, at, c);
      if (derived) {
        const float s = slot > 0
            ? tile_cell(tile, qtile, qscale, sib + (size_t)t * 3 + c, c)
            : 0.f;
        v = parent[at] - s;
      }
      full[at] = v;
      hx[c][t] = excl ? 0.f : v;
    }
  }
  __syncthreads();

  // 3. blocked cumulative sum (utils/ordered.py order)
  const int nblk = (b + kBlock - 1) / kBlock;
  if (t < nblk) {
    for (int c = 0; c < 3; ++c) {
      float acc = 0.f;
      for (int j = 0; j < kBlock; ++j) {
        const int i = t * kBlock + j;
        acc = acc + (i < b ? hx[c][i] : 0.f);
        within[c][i] = acc;
      }
    }
  }
  __syncthreads();
  if (t == 0 && b > kBlock) {
    for (int c = 0; c < 3; ++c) {
      float acc = 0.f;
      for (int k = 0; k < nblk; ++k) {
        acc = acc + within[c][k * kBlock + kBlock - 1];
        tot[c][k] = acc;
      }
    }
  }
  __syncthreads();
  float cs[3];
  if (t < b) {
    const int blk = t / kBlock;
    for (int c = 0; c < 3; ++c)
      cs[c] = b > kBlock ? within[c][t] + (blk == 0 ? 0.f : tot[c][blk - 1])
                         : within[c][t];
  }
  // every thread needs the last bin's csum (the excluded total)
  __syncthreads();
  if (t == b - 1) {
    for (int c = 0; c < 3; ++c) hx[c][0] = cs[c];
  }
  __syncthreads();

  // 4. candidates at threshold t, both directions
  const float* aux = la + (size_t)slot * 8;
  const float leaf_g = aux[0], leaf_h = aux[1], leaf_c = aux[2];
  const float leaf_out = aux[3];
  if (t < b) {
    const float eps = static_cast<float>(1e-15);
    const float fl_g = cs[0], fl_h = cs[1] + eps, fl_c = cs[2];
    const float rr_g = hx[0][0] - cs[0];
    const float rr_h = (hx[1][0] - cs[1]) + eps;
    const float rr_c = hx[2][0] - cs[2];
    const float fr_g = leaf_g - fl_g, fr_h = leaf_h - fl_h,
                fr_c = leaf_c - fl_c;
    const float rl_g = leaf_g - rr_g, rl_h = leaf_h - rr_h,
                rl_c = leaf_c - rr_c;

    const float gain_fwd =
        gain_given_output(fl_g, fl_h,
                          leaf_output(fl_g, fl_h, fl_c, leaf_out, prm), prm)
        + gain_given_output(fr_g, fr_h,
                            leaf_output(fr_g, fr_h, fr_c, leaf_out, prm),
                            prm);
    const float gain_rev =
        gain_given_output(rl_g, rl_h,
                          leaf_output(rl_g, rl_h, rl_c, leaf_out, prm), prm)
        + gain_given_output(rr_g, rr_h,
                            leaf_output(rr_g, rr_h, rr_c, leaf_out, prm),
                            prm);
    const float min_gain_shift =
        gain_given_output(leaf_g, leaf_h,
                          leaf_output(leaf_g, leaf_h, leaf_c, leaf_out, prm),
                          prm)
        + prm.min_gain;

    const bool cm_fwd = fl_c >= prm.min_data && fr_c >= prm.min_data
                        && fl_h >= prm.min_hess && fr_h >= prm.min_hess;
    const bool cm_rev = rl_c >= prm.min_data && rr_c >= prm.min_data
                        && rl_h >= prm.min_hess && rr_h >= prm.min_hess;
    const bool zero_skip = mode_a && is_zero && t == dbin;
    const bool fwd_ok = mode_a && t <= nb - 2 && !zero_skip;
    const int rev_upper = nb - 2 - ((mode_a && is_nan) ? 1 : 0);
    const bool rev_ok = t <= rev_upper && !zero_skip;
    const bool v_fwd = cm_fwd && fwd_ok && gain_fwd > min_gain_shift
                       && !(gain_fwd != gain_fwd);
    const bool v_rev = cm_rev && rev_ok && gain_rev > min_gain_shift
                       && !(gain_rev != gain_rev);
    key_fwd[t] = v_fwd ? gain_fwd - min_gain_shift : -CUDART_INF_F;
    key_rev[t] = v_rev ? gain_rev - min_gain_shift : -CUDART_INF_F;
    sums[0][t] = rl_g; sums[1][t] = rl_h; sums[2][t] = rl_c;
    sums[3][t] = rr_g; sums[4][t] = rr_h; sums[5][t] = rr_c;
    sums[6][t] = fl_g; sums[7][t] = fl_h; sums[8][t] = fl_c;
    sums[9][t] = fr_g; sums[10][t] = fr_h; sums[11][t] = fr_c;
  }
  __syncthreads();

  // 5. the within-feature lexicographic argmax over [rev(0..B-1), fwd(...)]
  if (t == 0) {
    float best = -CUDART_INF_F;
    for (int i = 0; i < b; ++i) best = key_rev[i] > best ? key_rev[i] : best;
    for (int i = 0; i < b; ++i) best = key_fwd[i] > best ? key_fwd[i] : best;
    int bdir = 1, bt = 0;
    bool found = false;
    for (int i = b - 1; i >= 0 && !found; --i)
      if (key_rev[i] == best) { bdir = 0; bt = i; found = true; }
    for (int i = 0; i < b && !found; ++i)
      if (key_fwd[i] == best) { bdir = 1; bt = i; found = true; }
    float* out = cand + ((size_t)slot * f + feat) * kCand;
    out[0] = best;
    out[1] = static_cast<float>(bt);
    out[2] = bdir == 0 ? 1.f : 0.f;
    const int o = bdir == 0 ? 0 : 6;
    for (int k = 0; k < 6; ++k) out[3 + k] = sums[o + k][bt];
    out[9] = 0.f; out[10] = 0.f; out[11] = 0.f;
  }
}

}  // namespace

// Returns cudaGetLastError() (0 = launched). `qscale` null: `tile` is
// p * f * b * 3 floats; else int32 sums dequantized by qscale[3].
extern "C" int split_epilogue_launch(const void* tile, const void* qscale,
                                     const void* parent, const void* der,
                                     const void* la, const void* fm,
                                     const void* pv, void* full, void* cand,
                                     int p, int f, int b, void* stream) {
  if (b > kMaxBins || b < 1) return (int)cudaErrorInvalidValue;
  dim3 grid(p, f);
  const float* qs = static_cast<const float*>(qscale);
  split_epilogue_kernel<<<grid, kMaxBins, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      qs ? nullptr : static_cast<const float*>(tile),
      qs ? static_cast<const int32_t*>(tile) : nullptr, qs,
      static_cast<const float*>(parent),
      static_cast<const int32_t*>(der), static_cast<const float*>(la),
      static_cast<const float*>(fm), static_cast<const float*>(pv),
      static_cast<float*>(full), static_cast<float*>(cand), f, b);
  return (int)cudaGetLastError();
}
