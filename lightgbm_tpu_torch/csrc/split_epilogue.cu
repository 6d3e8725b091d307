// split_epilogue.cu -- the split-finding epilogue of a histogram tile pass.
//
// Replaces the epilogue half of lightgbm_tpu/ops/pallas_hist.py
// _fused_epi_kernel / _gather_epi_kernel, i.e. _epilogue_compute in all
// of its modes: in q8 mode dequantize the int32 tile (each cell
// acc * qscale[stat], rounded on its own before anything else touches it,
// as the JAX package's _round_fence does), then in every mode derive each
// odd (derived) slot's plane as parent - computed sibling, then
// ops/split.py numerical_candidates, in the monotone mode
// (with_monotone, the basic monotone constraints) under each slot's
// output bounds.
//
// Per (slot, feature):
//   1. full plane: derived slots read parent - tile[slot - 1], the others
//      the tile itself (the TPU kernel's static lane shift); a q8 tile is
//      read as __fmul_rn((float)acc, qscale[stat]);
//   2. the excluded bins of missing types NaN and Zero are zeroed;
//   3. the bin-axis cumulative sum in the plain version's order
//      (utils/ordered.py blocked_cumsum: a left-to-right prefix inside each
//      16-bin block from +0, a left-to-right prefix of the block totals
//      from +0, one add of the two; B <= 16 is one prefix);
//   4. both directional scans (the accumulated side's hessian starts at
//      kEpsilon), leaf outputs with l1 / l2 / max_delta_step / path_smooth,
//      gains, the min_data / min_hessian masks and the strict
//      gain > min_gain_shift. The monotone mode clips each candidate's
//      left and right outputs to the slot's [la[p, 4], la[p, 5]] before
//      its gain (jnp.clip's arithmetic: maximum(lo, x), then minimum(hi,
//      .), NaN propagated and +0 over -0 as XLA's max / min give them,
//      not fmaxf / fminf), and sets the gain to 0 where the clipped
//      outputs break the feature's direction fm[f, 3] (mono > 0 and
//      left > right, or mono < 0 and left < right), before the
//      gain > min_gain_shift mask;
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
// What bounds it on an H100: the work is small (P*F planes of B bins, a
// few dozen flops a bin; each computed slot's tile plane and each derived
// slot's parent plane read once, every full plane written once: ~2.2 us
// of bytes at the main path's P=42, F=28, B=255 with half the slots
// derived), so the floor is one launch and the cost is latency: a chain
// of dependent steps per plane. The design keeps every step in registers and warp shuffles:
//   - one warp owns one (slot, feature); 4 warps a block, so the main
//     path's 1,176 planes are 294 blocks, one wave on 132 SMs;
//   - the warp reads its plane's contiguous B*3 floats coalesced (and the
//     parent and the sibling's plane for a derived slot), writes the full
//     plane back the same way, and stages it in shared memory once, by
//     stat and with one pad word every 32 bins so the next read is free
//     of bank conflicts;
//   - lane l holds bins 8l..8l+7, so lanes 2k and 2k+1 hold the 16-bin
//     block k. The prefix keeps the plain version's sequential order: a
//     lane adds its 8 bins left to right; the odd lane of a block starts
//     from the even lane's running total (one shuffle); every lane then
//     chains the block totals (shuffled from the odd lanes) left to right
//     up to its own block. No tree-shaped scan: that would round
//     differently;
//   - the argmax is a shuffle reduction over (key, position), position
//     ordering the candidates as the plain version does (reverse threshold
//     t at B-1-t, forward threshold t at B+t): the greatest key wins, the
//     smallest position among equal keys. Keys are -inf, finite or +inf
//     (a NaN gain is masked before its key), so the reduction is exact in
//     any order; with every key -inf the winner is reverse threshold B-1,
//     as in the plain version. Each lane keeps the six sums of its own
//     best candidate, and the winning lane writes the table row.
// The mode is a template parameter, so the unconstrained instantiation
// is the code it was; the monotone one adds two clips a side, the two
// compares and a select a candidate.
//
// Wide mode (B > 256, up to kMaxBinsWide = 4,096; split_epilogue_wide;
// past it the wider mode below, up to the bin types' 65,536): the same
// arithmetic per candidate, but the plane no longer fits one warp at 8
// bins a lane, and the scan follows XLA's order past 16 blocks, which is
// three levels, not a running sum (blocked_cumsum's recursion: the
// block totals are scanned in super-blocks of 16, the super-block totals
// once more, each level's exclusive prefix added from +0). A warp walking
// the plane in chunks (the first design) waited on one memory latency a
// pass and walked the chunks twice; here the plane is spread over a CTA:
//   - one CTA of ceil(B / 256) warps a (slot, feature); warp w owns the
//     256-bin chunk w and lane l its bins 8l..8l+7 for the 3 stats, in
//     registers from the load to the candidates. Inside a chunk, steps 1
//     to 3 are the kernel above: every load issued before its first use,
//     one coalesced write of the full plane, the transpose by stat through
//     the warp's padded tile, the within-block prefix;
//   - a chunk is exactly one super-block (16 blocks of 16 bins), so level
//     2 stays in the warp: every lane chains the chunk's 16 block totals
//     (shuffled from the odd lanes; +0 past the last block, the plain
//     version's padding) from +0, keeping the chain up to its own block's
//     predecessor; lane 0 puts the chunk's whole chain S[w] in shared
//     memory, and the lane holding bin B-1 that bin's within-block csum
//     and its chain;
//   - one barrier; then every thread chains S[0..] from +0 itself (lane
//     s reads S[s], the chain takes them by shuffles), which gives the
//     exclusive prefix E of its own chunk, of the one before and of the
//     last two, and adds its block's predecessor's inclusive scan --
//     chain + E[w], or for a chunk's first block S[w-1] + E[w-1], +0 for
//     block 0 -- to its registers, in the plain version's operand order;
//     the last bin's csum (`total`) is formed the same way by every
//     thread, so no second scan barrier;
//   - each warp reduces its best (key, position) by shuffles, its owner
//     puts it and the six sums in shared memory, and after a second
//     barrier warp 0 reduces the at most 16 entries in the same order and
//     its owner writes the row. The order is total, so the shape of the
//     reduction changes no bit.
// The work is the candidates' arithmetic (4 IEEE divisions a bin, each a
// branch region around its slow path), so instructions and their latency
// bound it, not bytes: a candidate outside its scan keys -inf whatever its
// gain, so its gain is not computed (a feature with no missing type, most
// of them, has no forward scan). Shared memory is sized to B (dynamic: the
// warps' tiles and 182 floats): 13.4 KB at B = 1,023, 51.4 KB at 4,096,
// so registers set the occupancy: the launch bounds ask for two 512-thread
// CTAs an SM (64 registers; a few bytes spill in the q8 modes), which
// measured faster in every mode than 78-128 registers at one CTA. Each of
// the four instantiations (q8 x monotone) counts its launches apart in
// the wrapper.
// PERF.md has the measured time against the bound.
//
// Wider mode (B > 4,096; split_epilogue_wider): 17 to 256 chunks, more
// than one CTA holds a warp each, and XLA's scan gains a fourth level
// (the chunk totals scanned in groups of 16, the group totals once more).
// A CTA of 16 warps a (slot, feature); warp w takes chunks w, w + 16, ...
// in turn, in two passes: the first writes each chunk's full plane and
// puts its total in shared memory, warp 0 then scans the totals in XLA's
// order, and the second rereads each chunk's full plane (the cells its own
// lanes wrote) and evaluates the candidates as the wide mode does, each
// lane keeping its best over its chunks. Same arithmetic, same
// missing-value handling and tie order, so the table stays bitwise the
// plain version. The plane is read twice, and the scan of the totals is
// one warp's; PERF.md has its time against the bound. A design that held
// every chunk in registers across a thread-block cluster of CTAs (the
// chunk totals shared through distributed shared memory, the plane read
// once) was bitwise this one but slower in the f32 and monotone modes at
// every B (1.77x at 65,535); PERF.md has its numbers and what to measure
// before it is tried again.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxBins = 256;
constexpr int kBinsPerLane = kMaxBins / 32;   // 8
constexpr int kBlock = 16;        // the plain version's scan block
constexpr int kCand = 12;
constexpr int kWarps = 4;         // (slot, feature) planes per block
constexpr int kStride = kMaxBins + kMaxBins / 32;   // one pad word / 32 bins
constexpr int kMissingNone = 0, kMissingZero = 1, kMissingNan = 2;
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ float split_gain(float g, float h, float c,
                                            float parent_out,
                                            const Params& p) {
  return gain_given_output(g, h, leaf_output(g, h, c, parent_out, p), p);
}

// XLA's float maximum / minimum (jnp.maximum / jnp.minimum): NaN when
// either is NaN; of two equal zeros +0 (max) or -0 (min)
__device__ __forceinline__ float ieee_max(float a, float b) {
  if (a != a || b != b) return __int_as_float(0x7fc00000);
  if (a > b) return a;
  if (b > a) return b;
  return a == 0.f ? a + b : a;
}

__device__ __forceinline__ float ieee_min(float a, float b) {
  if (a != a || b != b) return __int_as_float(0x7fc00000);
  if (a < b) return a;
  if (b < a) return b;
  return a == 0.f ? -((-a) + (-b)) : a;
}

// jnp.clip(x, lo, hi) as XLA lowers it: minimum(hi, maximum(lo, x))
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return ieee_min(hi, ieee_max(lo, x));
}

// One directional candidate's gain: the plain split_gain of each side, or
// in the monotone mode the sides' clipped outputs, the gain from them and
// 0 where they break the direction `mono`.
template <bool kMono>
__device__ __forceinline__ float candidate_gain(
    float lg, float lh, float lc, float rg, float rh, float rc,
    float parent_out, const Params& p, float lmin, float lmax, int mono) {
  if constexpr (!kMono) {
    return split_gain(lg, lh, lc, parent_out, p)
           + split_gain(rg, rh, rc, parent_out, p);
  } else {
    const float lo = clip(leaf_output(lg, lh, lc, parent_out, p), lmin, lmax);
    const float ro = clip(leaf_output(rg, rh, rc, parent_out, p), lmin, lmax);
    const float gain = gain_given_output(lg, lh, lo, p)
                       + gain_given_output(rg, rh, ro, p);
    const bool viol = (mono > 0 && lo > ro) || (mono < 0 && lo < ro);
    return viol ? 0.f : gain;
  }
}

// Cell `at` (stat c) of the tile: the f32 value, or in q8 mode the int32
// sum dequantized by one rounded multiply.
template <bool kQ8>
__device__ __forceinline__ float tile_cell(const float* __restrict__ tile,
                                           const int32_t* __restrict__ qtile,
                                           const float* __restrict__ qscale,
                                           size_t at, int c) {
  if (kQ8) return __fmul_rn(__int2float_rn(qtile[at]), qscale[c]);
  return tile[at];
}

// (key, pos) a beats (key, pos) b: greater key, then smaller position
__device__ __forceinline__ bool beats(float ka, int pa, float kb, int pb) {
  return ka > kb || (ka == kb && pa < pb);
}

template <bool kQ8, bool kMono>
__global__ void __launch_bounds__(32 * kWarps)
split_epilogue_kernel(const float* __restrict__ tile,
                      const int32_t* __restrict__ qtile,
                      const float* __restrict__ qscale,
                      const float* __restrict__ parent,
                      const int32_t* __restrict__ der,
                      const float* __restrict__ la,
                      const float* __restrict__ fm,
                      const float* __restrict__ pv,
                      float* __restrict__ full,
                      float* __restrict__ cand,
                      int p, int f, int b) {
  __shared__ float staged[kWarps][3][kStride];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int pair = blockIdx.x * kWarps + warp;
  if (pair >= p * f) return;      // whole warps leave; no block barrier
  const int slot = pair / f;
  const int feat = pair % f;
  const Params prm{pv[0], pv[1], pv[2], pv[3], pv[4], pv[5], pv[6]};
  const int nb = static_cast<int>(fm[feat * 8 + 0]);
  const int mt = static_cast<int>(fm[feat * 8 + 1]);
  const int dbin = static_cast<int>(fm[feat * 8 + 2]);
  const int mono = static_cast<int>(fm[feat * 8 + 3]);
  const bool mode_a = nb > 2 && mt != kMissingNone;
  const bool is_nan = mt == kMissingNan;
  const bool is_zero = mt == kMissingZero;
  const bool derived = der[slot * 3] != 0;

  const size_t plane = (size_t)b * 3;
  const size_t base = ((size_t)slot * f + feat) * plane;
  const size_t sib = slot > 0 ? ((size_t)(slot - 1) * f + feat) * plane : 0;
  float (*st)[kStride] = staged[warp];

  // 1. full plane, coalesced over its B*3 contiguous cells: every load of
  //    the lane issued before the first use (one memory latency, not 24),
  //    then written out and staged by stat
  constexpr int kCells = 3 * kMaxBins / 32;     // cells a lane, at most
  float v[kCells];
  if (derived) {
#pragma unroll
    for (int k = 0; k < kCells; ++k) {
      const int i = lane + 32 * k;
      const float s = i < 3 * b && slot > 0
          ? tile_cell<kQ8>(tile, qtile, qscale, sib + i, i % 3) : 0.f;
      v[k] = i < 3 * b ? parent[base + i] - s : 0.f;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kCells; ++k) {
      const int i = lane + 32 * k;
      v[k] = i < 3 * b ? tile_cell<kQ8>(tile, qtile, qscale, base + i, i % 3)
                       : 0.f;
    }
  }
#pragma unroll
  for (int k = 0; k < kCells; ++k) {
    const int i = lane + 32 * k;
    if (i < 3 * b) {
      const int c = i % 3, t = i / 3;
      full[base + i] = v[k];
      st[c][t + t / 32] = v[k];
    }
  }
  __syncwarp();

  // 2. this lane's 8 bins, the excluded ones zeroed; bins >= B are the
  //    plain version's +0 padding
  const int t0 = lane * kBinsPerLane;
  float x[3][kBinsPerLane];
#pragma unroll
  for (int j = 0; j < kBinsPerLane; ++j) {
    const int t = t0 + j;
    const bool excl = (mode_a && is_nan && t == nb - 1)
                      || (mode_a && is_zero && t == dbin);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      x[c][j] = (t < b && !excl) ? st[c][t + t / 32] : 0.f;
  }

  // 3. blocked cumulative sum. The even lane of a 16-bin block starts
  //    from +0, the odd lane from the even lane's total; then the
  //    exclusive prefix of the block totals, chained left to right.
  float run[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < kBinsPerLane; ++j) acc = acc + x[c][j];
    const float even_total = __shfl_sync(kFull, acc, lane & ~1);
    run[c] = (lane & 1) ? even_total : 0.f;
  }
  float cs[3][kBinsPerLane];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float acc = run[c];
#pragma unroll
    for (int j = 0; j < kBinsPerLane; ++j) {
      acc = acc + x[c][j];
      cs[c][j] = acc;
    }
  }
  if (b > kBlock) {
    const int nblk = (b + kBlock - 1) / kBlock;
    const int blk = lane / 2;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      // the block totals: the odd lanes' last within-block values
      const float last = cs[c][kBinsPerLane - 1];
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxBins / kBlock; ++k) {
        const float tot_k = __shfl_sync(kFull, last, 2 * k + 1);
        if (k < blk && k < nblk) acc = acc + tot_k;
      }
      const float excl = blk == 0 ? 0.f : acc;
#pragma unroll
      for (int j = 0; j < kBinsPerLane; ++j) cs[c][j] = cs[c][j] + excl;
    }
  }
  // the last bin's csum (the excluded total), from the lane holding it
  float total[3];
  {
    const int jl = (b - 1) % kBinsPerLane;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float mine = 0.f;
#pragma unroll
      for (int j = 0; j < kBinsPerLane; ++j)
        if (j == jl) mine = cs[c][j];
      total[c] = __shfl_sync(kFull, mine, (b - 1) / kBinsPerLane);
    }
  }

  // 4. candidates at each of this lane's thresholds, both directions;
  //    the lane's best (key, position) and the six sums it carries
  const float* aux = la + (size_t)slot * 8;
  const float leaf_g = aux[0], leaf_h = aux[1], leaf_c = aux[2];
  const float leaf_out = aux[3];
  const float lmin = aux[4], lmax = aux[5];
  const float min_gain_shift =
      split_gain(leaf_g, leaf_h, leaf_c, leaf_out, prm) + prm.min_gain;
  const int rev_upper = nb - 2 - ((mode_a && is_nan) ? 1 : 0);
  const float eps = static_cast<float>(1e-15);
  float best_key = -CUDART_INF_F;
  int best_pos = 0x7fffffff;
  float bs[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kBinsPerLane; ++j) {
    const int t = t0 + j;
    if (t < b) {
      const float fl_g = cs[0][j], fl_h = cs[1][j] + eps, fl_c = cs[2][j];
      const float rr_g = total[0] - cs[0][j];
      const float rr_h = (total[1] - cs[1][j]) + eps;
      const float rr_c = total[2] - cs[2][j];
      const float fr_g = leaf_g - fl_g, fr_h = leaf_h - fl_h,
                  fr_c = leaf_c - fl_c;
      const float rl_g = leaf_g - rr_g, rl_h = leaf_h - rr_h,
                  rl_c = leaf_c - rr_c;
      const float gain_fwd = candidate_gain<kMono>(
          fl_g, fl_h, fl_c, fr_g, fr_h, fr_c, leaf_out, prm, lmin, lmax, mono);
      const float gain_rev = candidate_gain<kMono>(
          rl_g, rl_h, rl_c, rr_g, rr_h, rr_c, leaf_out, prm, lmin, lmax, mono);
      const bool cm_fwd = fl_c >= prm.min_data && fr_c >= prm.min_data
                          && fl_h >= prm.min_hess && fr_h >= prm.min_hess;
      const bool cm_rev = rl_c >= prm.min_data && rr_c >= prm.min_data
                          && rl_h >= prm.min_hess && rr_h >= prm.min_hess;
      const bool zero_skip = mode_a && is_zero && t == dbin;
      const bool fwd_ok = mode_a && t <= nb - 2 && !zero_skip;
      const bool rev_ok = t <= rev_upper && !zero_skip;
      const bool v_fwd = cm_fwd && fwd_ok && gain_fwd > min_gain_shift
                         && !(gain_fwd != gain_fwd);
      const bool v_rev = cm_rev && rev_ok && gain_rev > min_gain_shift
                         && !(gain_rev != gain_rev);
      const float key_rev = v_rev ? gain_rev - min_gain_shift : -CUDART_INF_F;
      const float key_fwd = v_fwd ? gain_fwd - min_gain_shift : -CUDART_INF_F;
      if (beats(key_rev, b - 1 - t, best_key, best_pos)) {
        best_key = key_rev; best_pos = b - 1 - t;
        bs[0] = rl_g; bs[1] = rl_h; bs[2] = rl_c;
        bs[3] = rr_g; bs[4] = rr_h; bs[5] = rr_c;
      }
      if (beats(key_fwd, b + t, best_key, best_pos)) {
        best_key = key_fwd; best_pos = b + t;
        bs[0] = fl_g; bs[1] = fl_h; bs[2] = fl_c;
        bs[3] = fr_g; bs[4] = fr_h; bs[5] = fr_c;
      }
    }
  }

  // 5. the warp's best (key, position); its owner writes the table row
  float key = best_key;
  int pos = best_pos;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ok = __shfl_xor_sync(kFull, key, off);
    const int op = __shfl_xor_sync(kFull, pos, off);
    if (beats(ok, op, key, pos)) { key = ok; pos = op; }
  }
  if (best_pos == pos) {
    const bool rev = pos < b;
    float* out = cand + ((size_t)slot * f + feat) * kCand;
    out[0] = key;
    out[1] = static_cast<float>(rev ? b - 1 - pos : pos - b);
    out[2] = rev ? 1.f : 0.f;
#pragma unroll
    for (int k = 0; k < 6; ++k) out[3 + k] = bs[k];
    out[9] = 0.f; out[10] = 0.f; out[11] = 0.f;
  }
}

// ---------------------------------------------------------------- wide mode
constexpr int kMaxBinsWide = 4096;
constexpr int kChunk = kMaxBins;                 // bins a warp owns: 256
constexpr int kMaxWideWarps = kMaxBinsWide / kChunk;   // 16, 512 threads
constexpr int kTileFloats = 3 * kStride;         // a warp's transpose tile
// after the tiles: the chunk totals S [16][3], bin B-1's within-block csum
// and its block's in-chunk prefix [6], the warps' best key [16], position
// [16] and six sums [16][6]
constexpr int kWideScratch = 3 * kMaxWideWarps + 6 + 8 * kMaxWideWarps;
constexpr int kDefaultSmem = 48 * 1024;          // without the opt-in

inline int wide_smem_floats(int warps) {
  return warps * kTileFloats + kWideScratch;
}

template <bool kQ8, bool kMono>
__global__ void __launch_bounds__(32 * kMaxWideWarps, 2)
split_epilogue_wide(const float* __restrict__ tile,
                    const int32_t* __restrict__ qtile,
                    const float* __restrict__ qscale,
                    const float* __restrict__ parent,
                    const int32_t* __restrict__ der,
                    const float* __restrict__ la,
                    const float* __restrict__ fm,
                    const float* __restrict__ pv,
                    float* __restrict__ full,
                    float* __restrict__ cand,
                    int p, int f, int b) {
  extern __shared__ float wide_smem[];
  const int nw = blockDim.x / 32;                // ceil(B / 256) chunks
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int slot = blockIdx.x / f;               // the grid is P * F CTAs:
  const int feat = blockIdx.x % f;               // no thread leaves early
  const Params prm{pv[0], pv[1], pv[2], pv[3], pv[4], pv[5], pv[6]};
  const int nb = static_cast<int>(fm[feat * 8 + 0]);
  const int mt = static_cast<int>(fm[feat * 8 + 1]);
  const int dbin = static_cast<int>(fm[feat * 8 + 2]);
  const int mono = static_cast<int>(fm[feat * 8 + 3]);
  const bool mode_a = nb > 2 && mt != kMissingNone;
  const bool is_nan = mt == kMissingNan;
  const bool is_zero = mt == kMissingZero;
  const bool derived = der[slot * 3] != 0;

  float* st = wide_smem + warp * kTileFloats;    // [3][kStride]
  float* sup = wide_smem + nw * kTileFloats;     // [kMaxWideWarps][3]
  float* lastv = sup + 3 * kMaxWideWarps;        // [2][3]
  float* akey = lastv + 6;                       // [kMaxWideWarps]
  int* apos = reinterpret_cast<int*>(akey + kMaxWideWarps);
  float* asum = akey + 2 * kMaxWideWarps;        // [kMaxWideWarps][6]
  const size_t plane = (size_t)b * 3;
  const size_t base = ((size_t)slot * f + feat) * plane;
  const size_t sib = slot > 0 ? ((size_t)(slot - 1) * f + feat) * plane : 0;
  const int c0 = warp * 3 * kChunk;              // the chunk's first cell
  const int lim = 3 * b - c0;                    // its cells inside B

  // 1. the chunk's full plane, coalesced over its 768 contiguous cells:
  //    every load of the lane issued before the first use, then written
  //    out and staged by stat in the warp's tile
  constexpr int kCells = 3 * kChunk / 32;        // 24 cells a lane
  float v[kCells];
  if (derived) {
#pragma unroll
    for (int k = 0; k < kCells; ++k) {
      const int i = lane + 32 * k;
      const float s = i < lim && slot > 0
          ? tile_cell<kQ8>(tile, qtile, qscale, sib + c0 + i, i % 3) : 0.f;
      v[k] = i < lim ? parent[base + c0 + i] - s : 0.f;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kCells; ++k) {
      const int i = lane + 32 * k;
      v[k] = i < lim
          ? tile_cell<kQ8>(tile, qtile, qscale, base + c0 + i, i % 3) : 0.f;
    }
  }
#pragma unroll
  for (int k = 0; k < kCells; ++k) {
    const int i = lane + 32 * k;
    if (i < lim) {
      const int c = i % 3, t = i / 3;
      full[base + c0 + i] = v[k];
      st[c * kStride + t + t / 32] = v[k];
    }
  }
  __syncwarp();

  // 2. this lane's 8 bins of the chunk, the excluded ones zeroed; bins
  //    >= B are the plain version's +0 padding
  const int t0 = warp * kChunk + lane * kBinsPerLane;
  float x[3][kBinsPerLane];
#pragma unroll
  for (int j = 0; j < kBinsPerLane; ++j) {
    const int t = t0 + j, tl = lane * kBinsPerLane + j;
    const bool excl = (mode_a && is_nan && t == nb - 1)
                      || (mode_a && is_zero && t == dbin);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      x[c][j] = (t < b && !excl) ? st[c * kStride + tl + tl / 32] : 0.f;
  }

  // 3a. level 1: the within-block prefix of each 16-bin block (the even
  //     lane from +0, the odd lane from the even lane's total)
  float cs[3][kBinsPerLane];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < kBinsPerLane; ++j) acc = acc + x[c][j];
    const float even_total = __shfl_sync(kFull, acc, lane & ~1);
    acc = (lane & 1) ? even_total : 0.f;
#pragma unroll
    for (int j = 0; j < kBinsPerLane; ++j) {
      acc = acc + x[c][j];
      cs[c][j] = acc;
    }
  }
  // 3b. level 2: a chunk is one super-block of 16 block totals (the odd
  //     lanes' last values; +0 past the last block, as the plain version
  //     pads), chained from +0: w2, the chain up to the block before the
  //     lane's own, and S, the chunk's whole chain, to shared memory
  const int kb = lane / 2;                       // the lane's block
  float w2[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float last = cs[c][kBinsPerLane - 1];
    float acc = 0.f, mine = 0.f;
#pragma unroll
    for (int k = 0; k < kChunk / kBlock; ++k) {
      acc = acc + __shfl_sync(kFull, last, 2 * k + 1);
      if (k == kb - 1) mine = acc;
    }
    w2[c] = mine;
    if (lane == 0) sup[warp * 3 + c] = acc;
  }
  // the last bin's within-block csum and its block's w2, for `total`,
  // from the one (lane, j) holding bin B-1 (a store a j: a select by a
  // runtime j would put cs in local memory)
  const int tl_last = b - 1 - (nw - 1) * kChunk;
#pragma unroll
  for (int j = 0; j < kBinsPerLane; ++j) {
    if (t0 + j == b - 1) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        lastv[c] = cs[c][j];
        lastv[3 + c] = w2[c];
      }
    }
  }
  __syncthreads();

  // 3c. level 3: the exclusive prefix E of the chunk totals from +0 (E[0]
  //     the +0 itself), chained by every thread from lane s's S[s]
  //     (shuffled, so the 16 reads do not wait on each other); block k's
  //     inclusive scan is w2 + E[its chunk], the last block of chunk s - 1
  //     S[s - 1] + E[s - 1]. Each lane adds its block's predecessor's (+0
  //     for block 0, as the plain version adds it); every thread forms the
  //     last bin's csum the same way
  const int wm1 = warp > 0 ? warp - 1 : 0;
  float total[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float sl = lane < nw ? sup[lane * 3 + c] : 0.f;
    float acc = 0.f, ew = 0.f, ewm1 = 0.f, el = 0.f, elm1 = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxWideWarps; ++s) {
      const float ss = __shfl_sync(kFull, sl, s);
      if (s == warp) ew = acc;
      if (s == wm1) ewm1 = acc;
      if (s == nw - 1) el = acc;
      if (s == nw - 2) elm1 = acc;
      acc = acc + ss;
    }
    const float swm1 = __shfl_sync(kFull, sl, wm1);
    const float snm2 = __shfl_sync(kFull, sl, nw - 2);
    float add = 0.f;
    if (kb > 0) add = w2[c] + ew;
    else if (warp > 0) add = swm1 + ewm1;
#pragma unroll
    for (int j = 0; j < kBinsPerLane; ++j) cs[c][j] = cs[c][j] + add;
    total[c] = lastv[c] + (tl_last / kBlock > 0 ? lastv[3 + c] + el
                                                 : snm2 + elm1);
  }

  // 4. candidates at each of this lane's thresholds, both directions;
  //    the lane's best (key, position) and the six sums it carries
  const float* aux = la + (size_t)slot * 8;
  const float leaf_g = aux[0], leaf_h = aux[1], leaf_c = aux[2];
  const float leaf_out = aux[3];
  const float lmin = aux[4], lmax = aux[5];
  const float min_gain_shift =
      split_gain(leaf_g, leaf_h, leaf_c, leaf_out, prm) + prm.min_gain;
  const int rev_upper = nb - 2 - ((mode_a && is_nan) ? 1 : 0);
  const float eps = static_cast<float>(1e-15);
  float best_key = -CUDART_INF_F;
  int best_pos = 0x7fffffff;
  float bs[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kBinsPerLane; ++j) {
    const int t = t0 + j;
    if (t < b) {
      const float fl_g = cs[0][j], fl_h = cs[1][j] + eps, fl_c = cs[2][j];
      const float rr_g = total[0] - cs[0][j];
      const float rr_h = (total[1] - cs[1][j]) + eps;
      const float rr_c = total[2] - cs[2][j];
      const float fr_g = leaf_g - fl_g, fr_h = leaf_h - fl_h,
                  fr_c = leaf_c - fl_c;
      const float rl_g = leaf_g - rr_g, rl_h = leaf_h - rr_h,
                  rl_c = leaf_c - rr_c;
      const bool zero_skip = mode_a && is_zero && t == dbin;
      const bool fwd_ok = mode_a && t <= nb - 2 && !zero_skip;
      const bool rev_ok = t <= rev_upper && !zero_skip;
      // a candidate outside its scan keys -inf whatever its gain, so its
      // gain is not computed: a feature with no missing type (most) has
      // no forward scan, and the bins past nb - 2 none at all
      float gain_fwd = 0.f, gain_rev = 0.f;
      if (fwd_ok)
        gain_fwd = candidate_gain<kMono>(fl_g, fl_h, fl_c, fr_g, fr_h, fr_c,
                                         leaf_out, prm, lmin, lmax, mono);
      if (rev_ok)
        gain_rev = candidate_gain<kMono>(rl_g, rl_h, rl_c, rr_g, rr_h, rr_c,
                                         leaf_out, prm, lmin, lmax, mono);
      const bool cm_fwd = fl_c >= prm.min_data && fr_c >= prm.min_data
                          && fl_h >= prm.min_hess && fr_h >= prm.min_hess;
      const bool cm_rev = rl_c >= prm.min_data && rr_c >= prm.min_data
                          && rl_h >= prm.min_hess && rr_h >= prm.min_hess;
      const bool v_fwd = cm_fwd && fwd_ok && gain_fwd > min_gain_shift
                         && !(gain_fwd != gain_fwd);
      const bool v_rev = cm_rev && rev_ok && gain_rev > min_gain_shift
                         && !(gain_rev != gain_rev);
      const float key_rev = v_rev ? gain_rev - min_gain_shift : -CUDART_INF_F;
      const float key_fwd = v_fwd ? gain_fwd - min_gain_shift : -CUDART_INF_F;
      if (beats(key_rev, b - 1 - t, best_key, best_pos)) {
        best_key = key_rev; best_pos = b - 1 - t;
        bs[0] = rl_g; bs[1] = rl_h; bs[2] = rl_c;
        bs[3] = rr_g; bs[4] = rr_h; bs[5] = rr_c;
      }
      if (beats(key_fwd, b + t, best_key, best_pos)) {
        best_key = key_fwd; best_pos = b + t;
        bs[0] = fl_g; bs[1] = fl_h; bs[2] = fl_c;
        bs[3] = fr_g; bs[4] = fr_h; bs[5] = fr_c;
      }
    }
  }

  // 5. each warp's best (key, position) by shuffles, its owner's row to
  //    shared memory; warp 0 reduces the warps' and its owner writes the
  //    table row. Every warp holds a bin below B, so each has one owner.
  float key = best_key;
  int pos = best_pos;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ok = __shfl_xor_sync(kFull, key, off);
    const int op = __shfl_xor_sync(kFull, pos, off);
    if (beats(ok, op, key, pos)) { key = ok; pos = op; }
  }
  if (best_pos == pos) {
    akey[warp] = key;
    apos[warp] = pos;
#pragma unroll
    for (int k = 0; k < 6; ++k) asum[warp * 6 + k] = bs[k];
  }
  __syncthreads();
  if (warp == 0) {
    const float wk = lane < nw ? akey[lane] : -CUDART_INF_F;
    const int wp = lane < nw ? apos[lane] : 0x7fffffff;
    key = wk;
    pos = wp;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ok = __shfl_xor_sync(kFull, key, off);
      const int op = __shfl_xor_sync(kFull, pos, off);
      if (beats(ok, op, key, pos)) { key = ok; pos = op; }
    }
    if (lane < nw && wp == pos) {
      const bool rev = pos < b;
      float* out = cand + ((size_t)slot * f + feat) * kCand;
      out[0] = key;
      out[1] = static_cast<float>(rev ? b - 1 - pos : pos - b);
      out[2] = rev ? 1.f : 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) out[3 + k] = asum[lane * 6 + k];
      out[9] = 0.f; out[10] = 0.f; out[11] = 0.f;
    }
  }
}

// ------------------------------------------------------- wider mode
// B > kMaxBinsWide (up to kMaxBinsDevice, the bin types' cap): ceil(B /
// 256) = 17..256 chunks, more than a CTA of kMaxWideWarps warps holds one a
// warp, and XLA's scan gains a fourth level: the chunk totals are scanned
// in super-super-blocks of 16 (within each from +0), their totals once more
// from +0, and each level's exclusive prefix added from +0.
constexpr int kMaxBinsDevice = 65536;
constexpr int kMaxChunks = kMaxBinsDevice / kChunk;    // 256
// after the warps' tiles: the chunk totals T [256][3], their exclusive
// prefix E [256][3], bin B-1's within-block csum and its block's in-chunk
// prefix [6], the warps' best key [16], position [16] and six sums [16][6]
constexpr int kWiderScratch = 6 * kMaxChunks + 6 + 8 * kMaxWideWarps;

// Chunk w's full plane (derived or the tile itself) into v, written to
// `full` and staged by stat in the warp's tile `st`; `from_full` rereads
// what an earlier pass wrote to `full` (the same lane wrote those cells).
template <bool kQ8>
__device__ __forceinline__ void wider_load(
    const float* __restrict__ tile, const int32_t* __restrict__ qtile,
    const float* __restrict__ qscale, const float* __restrict__ parent,
    float* __restrict__ full, float* st, size_t base, size_t sib, int c0,
    int lim, int lane, bool derived, bool has_sib, bool from_full) {
  constexpr int kCells = 3 * kChunk / 32;        // 24 cells a lane
  float v[kCells];
#pragma unroll
  for (int k = 0; k < kCells; ++k) {
    const int i = lane + 32 * k;
    if (i >= lim) {
      v[k] = 0.f;
    } else if (from_full) {
      v[k] = full[base + c0 + i];
    } else if (derived) {
      const float s = has_sib
          ? tile_cell<kQ8>(tile, qtile, qscale, sib + c0 + i, i % 3) : 0.f;
      v[k] = parent[base + c0 + i] - s;
    } else {
      v[k] = tile_cell<kQ8>(tile, qtile, qscale, base + c0 + i, i % 3);
    }
  }
#pragma unroll
  for (int k = 0; k < kCells; ++k) {
    const int i = lane + 32 * k;
    if (i < lim) {
      const int c = i % 3, t = i / 3;
      if (!from_full) full[base + c0 + i] = v[k];
      st[c * kStride + t + t / 32] = v[k];
    }
  }
}

// Levels 1 and 2 of chunk w, as split_epilogue_wide's steps 2-3b: the
// lane's 8 bins (excluded bins zeroed, +0 past B) scanned within their
// 16-bin block into cs, w2 the chain of the chunk's block totals up to the
// block before the lane's own, and the chunk's whole chain returned.
__device__ __forceinline__ void wider_levels12(
    const float* st, int t0, int lane, int b, bool excl_nan, int nan_bin,
    bool excl_zero, int dbin, float cs[3][kBinsPerLane], float w2[3],
    float chain[3]) {
  float x[3][kBinsPerLane];
#pragma unroll
  for (int j = 0; j < kBinsPerLane; ++j) {
    const int t = t0 + j, tl = lane * kBinsPerLane + j;
    const bool excl = (excl_nan && t == nan_bin) || (excl_zero && t == dbin);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      x[c][j] = (t < b && !excl) ? st[c * kStride + tl + tl / 32] : 0.f;
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < kBinsPerLane; ++j) acc = acc + x[c][j];
    const float even_total = __shfl_sync(kFull, acc, lane & ~1);
    acc = (lane & 1) ? even_total : 0.f;
#pragma unroll
    for (int j = 0; j < kBinsPerLane; ++j) {
      acc = acc + x[c][j];
      cs[c][j] = acc;
    }
  }
  const int kb = lane / 2;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float last = cs[c][kBinsPerLane - 1];
    float acc = 0.f, mine = 0.f;
#pragma unroll
    for (int k = 0; k < kChunk / kBlock; ++k) {
      acc = acc + __shfl_sync(kFull, last, 2 * k + 1);
      if (k == kb - 1) mine = acc;
    }
    w2[c] = mine;
    chain[c] = acc;
  }
}

// One CTA of kMaxWideWarps warps a (slot, feature); warp w takes chunks w,
// w + 16, ... in turn, in two passes over the plane:
//   A. each chunk's full plane (written out), levels 1-2, its total T[w]
//      to shared memory, and bin B-1's within-block csum and w2;
//   B. after a barrier, warp 0 forms E = the exclusive prefix of the chunk
//      totals' scan in XLA's order (levels 3-4: lane m chains T[16m ..
//      16m + 15] from +0, the 16 group totals are chained from +0 by
//      shuffles, each chunk's scan is its group's chain plus its group's
//      exclusive prefix, and E[w] is chunk w - 1's, +0 for chunk 0);
//   C. after a second barrier each warp rereads its chunks' full planes
//      (the cells its own lanes wrote in A), repeats levels 1-2, adds its
//      blocks' predecessors' inclusive scans -- w2 + E[w], or for a chunk's
//      first block T[w-1] + E[w-1], +0 for block 0 -- and evaluates the
//      candidates as split_epilogue_wide does, each lane keeping its best
//      over all its chunks; then the same two-stage (key, position)
//      reduction. The order is total, so the chunks' order changes no bit.
template <bool kQ8, bool kMono>
__global__ void __launch_bounds__(32 * kMaxWideWarps, 2)
split_epilogue_wider(const float* __restrict__ tile,
                     const int32_t* __restrict__ qtile,
                     const float* __restrict__ qscale,
                     const float* __restrict__ parent,
                     const int32_t* __restrict__ der,
                     const float* __restrict__ la,
                     const float* __restrict__ fm,
                     const float* __restrict__ pv,
                     float* __restrict__ full,
                     float* __restrict__ cand,
                     int p, int f, int b) {
  extern __shared__ float wide_smem[];
  const int nw = (b + kChunk - 1) / kChunk;      // chunks: 17..256
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int slot = blockIdx.x / f;
  const int feat = blockIdx.x % f;
  const Params prm{pv[0], pv[1], pv[2], pv[3], pv[4], pv[5], pv[6]};
  const int nb = static_cast<int>(fm[feat * 8 + 0]);
  const int mt = static_cast<int>(fm[feat * 8 + 1]);
  const int dbin = static_cast<int>(fm[feat * 8 + 2]);
  const int mono = static_cast<int>(fm[feat * 8 + 3]);
  const bool mode_a = nb > 2 && mt != kMissingNone;
  const bool is_nan = mt == kMissingNan;
  const bool is_zero = mt == kMissingZero;
  const bool derived = der[slot * 3] != 0;

  float* st = wide_smem + warp * kTileFloats;    // [3][kStride]
  float* tot = wide_smem + warps * kTileFloats;  // [kMaxChunks][3]
  float* ex = tot + 3 * kMaxChunks;              // [kMaxChunks][3]
  float* lastv = ex + 3 * kMaxChunks;            // [2][3]
  float* akey = lastv + 6;                       // [kMaxWideWarps]
  int* apos = reinterpret_cast<int*>(akey + kMaxWideWarps);
  float* asum = akey + 2 * kMaxWideWarps;        // [kMaxWideWarps][6]
  const size_t plane = (size_t)b * 3;
  const size_t base = ((size_t)slot * f + feat) * plane;
  const size_t sib = slot > 0 ? ((size_t)(slot - 1) * f + feat) * plane : 0;

  // A. full planes, levels 1-2, the chunk totals
  for (int w = warp; w < nw; w += warps) {
    const int c0 = w * 3 * kChunk;
    wider_load<kQ8>(tile, qtile, qscale, parent, full, st, base, sib, c0,
                    3 * b - c0, lane, derived, slot > 0, false);
    __syncwarp();
    const int t0 = w * kChunk + lane * kBinsPerLane;
    float cs[3][kBinsPerLane], w2[3], chain[3];
    wider_levels12(st, t0, lane, b, mode_a && is_nan, nb - 1,
                   mode_a && is_zero, dbin, cs, w2, chain);
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < 3; ++c) tot[w * 3 + c] = chain[c];
    }
#pragma unroll
    for (int j = 0; j < kBinsPerLane; ++j) {
      if (t0 + j == b - 1) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          lastv[c] = cs[c][j];
          lastv[3 + c] = w2[c];
        }
      }
    }
    __syncwarp();                                // st is rewritten next
  }
  __syncthreads();

  // B. E, the chunk totals' exclusive prefix, levels 3-4
  if (warp == 0) {
    const int ng = (nw + kBlock - 1) / kBlock;   // groups of 16: 2..16
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float w3[kBlock];
      float run = 0.f;
#pragma unroll
      for (int i = 0; i < kBlock; ++i) {
        const int at = kBlock * lane + i;
        run = run + ((lane < ng && at < nw) ? tot[at * 3 + c] : 0.f);
        w3[i] = run;
      }
      float acc = 0.f, e3 = 0.f;
#pragma unroll
      for (int m = 0; m < kBlock; ++m) {
        const float tm = __shfl_sync(kFull, w3[kBlock - 1], m);
        if (m == lane) e3 = acc;
        if (m < ng) acc = acc + tm;
      }
#pragma unroll
      for (int i = 0; i < kBlock; ++i) {
        const int w = kBlock * lane + i + 1;
        if (lane < ng && w < nw) ex[w * 3 + c] = w3[i] + e3;
      }
      if (lane == 0) ex[c] = 0.f;
    }
  }
  __syncthreads();

  // C. the candidates of every chunk of the warp
  const float* aux = la + (size_t)slot * 8;
  const float leaf_g = aux[0], leaf_h = aux[1], leaf_c = aux[2];
  const float leaf_out = aux[3];
  const float lmin = aux[4], lmax = aux[5];
  const float min_gain_shift =
      split_gain(leaf_g, leaf_h, leaf_c, leaf_out, prm) + prm.min_gain;
  const int rev_upper = nb - 2 - ((mode_a && is_nan) ? 1 : 0);
  const float eps = static_cast<float>(1e-15);
  const int tl_last = b - 1 - (nw - 1) * kChunk;
  float total[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    total[c] = lastv[c] + (tl_last / kBlock > 0
                               ? lastv[3 + c] + ex[(nw - 1) * 3 + c]
                               : tot[(nw - 2) * 3 + c] + ex[(nw - 2) * 3 + c]);
  float best_key = -CUDART_INF_F;
  int best_pos = 0x7fffffff;
  float bs[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int kb = lane / 2;
  for (int w = warp; w < nw; w += warps) {
    const int c0 = w * 3 * kChunk;
    wider_load<kQ8>(tile, qtile, qscale, parent, full, st, base, sib, c0,
                    3 * b - c0, lane, derived, slot > 0, true);
    __syncwarp();
    const int t0 = w * kChunk + lane * kBinsPerLane;
    float cs[3][kBinsPerLane], w2[3], chain[3];
    wider_levels12(st, t0, lane, b, mode_a && is_nan, nb - 1,
                   mode_a && is_zero, dbin, cs, w2, chain);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float add = 0.f;
      if (kb > 0) add = w2[c] + ex[w * 3 + c];
      else if (w > 0) add = tot[(w - 1) * 3 + c] + ex[(w - 1) * 3 + c];
#pragma unroll
      for (int j = 0; j < kBinsPerLane; ++j) cs[c][j] = cs[c][j] + add;
    }
#pragma unroll
    for (int j = 0; j < kBinsPerLane; ++j) {
      const int t = t0 + j;
      if (t < b) {
        const float fl_g = cs[0][j], fl_h = cs[1][j] + eps, fl_c = cs[2][j];
        const float rr_g = total[0] - cs[0][j];
        const float rr_h = (total[1] - cs[1][j]) + eps;
        const float rr_c = total[2] - cs[2][j];
        const float fr_g = leaf_g - fl_g, fr_h = leaf_h - fl_h,
                    fr_c = leaf_c - fl_c;
        const float rl_g = leaf_g - rr_g, rl_h = leaf_h - rr_h,
                    rl_c = leaf_c - rr_c;
        const bool zero_skip = mode_a && is_zero && t == dbin;
        const bool fwd_ok = mode_a && t <= nb - 2 && !zero_skip;
        const bool rev_ok = t <= rev_upper && !zero_skip;
        float gain_fwd = 0.f, gain_rev = 0.f;
        if (fwd_ok)
          gain_fwd = candidate_gain<kMono>(fl_g, fl_h, fl_c, fr_g, fr_h,
                                           fr_c, leaf_out, prm, lmin, lmax,
                                           mono);
        if (rev_ok)
          gain_rev = candidate_gain<kMono>(rl_g, rl_h, rl_c, rr_g, rr_h,
                                           rr_c, leaf_out, prm, lmin, lmax,
                                           mono);
        const bool cm_fwd = fl_c >= prm.min_data && fr_c >= prm.min_data
                            && fl_h >= prm.min_hess && fr_h >= prm.min_hess;
        const bool cm_rev = rl_c >= prm.min_data && rr_c >= prm.min_data
                            && rl_h >= prm.min_hess && rr_h >= prm.min_hess;
        const bool v_fwd = cm_fwd && fwd_ok && gain_fwd > min_gain_shift
                           && !(gain_fwd != gain_fwd);
        const bool v_rev = cm_rev && rev_ok && gain_rev > min_gain_shift
                           && !(gain_rev != gain_rev);
        const float key_rev =
            v_rev ? gain_rev - min_gain_shift : -CUDART_INF_F;
        const float key_fwd =
            v_fwd ? gain_fwd - min_gain_shift : -CUDART_INF_F;
        if (beats(key_rev, b - 1 - t, best_key, best_pos)) {
          best_key = key_rev; best_pos = b - 1 - t;
          bs[0] = rl_g; bs[1] = rl_h; bs[2] = rl_c;
          bs[3] = rr_g; bs[4] = rr_h; bs[5] = rr_c;
        }
        if (beats(key_fwd, b + t, best_key, best_pos)) {
          best_key = key_fwd; best_pos = b + t;
          bs[0] = fl_g; bs[1] = fl_h; bs[2] = fl_c;
          bs[3] = fr_g; bs[4] = fr_h; bs[5] = fr_c;
        }
      }
    }
    __syncwarp();                                // st is rewritten next
  }

  // the warp's best, then the warps' (every lane held a bin of a full
  // first chunk, so each has a position and each warp one owner)
  float key = best_key;
  int pos = best_pos;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ok = __shfl_xor_sync(kFull, key, off);
    const int op = __shfl_xor_sync(kFull, pos, off);
    if (beats(ok, op, key, pos)) { key = ok; pos = op; }
  }
  if (best_pos == pos) {
    akey[warp] = key;
    apos[warp] = pos;
#pragma unroll
    for (int k = 0; k < 6; ++k) asum[warp * 6 + k] = bs[k];
  }
  __syncthreads();
  if (warp == 0) {
    const float wk = lane < warps ? akey[lane] : -CUDART_INF_F;
    const int wp = lane < warps ? apos[lane] : 0x7fffffff;
    key = wk;
    pos = wp;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ok = __shfl_xor_sync(kFull, key, off);
      const int op = __shfl_xor_sync(kFull, pos, off);
      if (beats(ok, op, key, pos)) { key = ok; pos = op; }
    }
    if (lane < warps && wp == pos) {
      const bool rev = pos < b;
      float* out = cand + ((size_t)slot * f + feat) * kCand;
      out[0] = key;
      out[1] = static_cast<float>(rev ? b - 1 - pos : pos - b);
      out[2] = rev ? 1.f : 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) out[3 + k] = asum[lane * 6 + k];
      out[9] = 0.f; out[10] = 0.f; out[11] = 0.f;
    }
  }
}

// One CTA of kMaxWideWarps warps a (slot, feature) past kMaxBinsWide
// bins: 57.3 KB of dynamic shared memory, above the default 48 KB.
template <bool kQ8, bool kMono>
int launch_wider(const void* tile, const float* qs, const float* par,
                 const int32_t* dr, const float* lap, const float* fmp,
                 const float* pvp, void* full, void* cand, int p, int f,
                 int b, cudaStream_t st) {
  const size_t smem =
      (size_t)(kMaxWideWarps * kTileFloats + kWiderScratch) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      split_epilogue_wider<kQ8, kMono>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  split_epilogue_wider<kQ8, kMono><<<p * f, 32 * kMaxWideWarps, smem, st>>>(
      kQ8 ? nullptr : static_cast<const float*>(tile),
      kQ8 ? static_cast<const int32_t*>(tile) : nullptr, qs, par, dr, lap,
      fmp, pvp, static_cast<float*>(full), static_cast<float*>(cand), p, f,
      b);
  return (int)cudaGetLastError();
}

// One CTA of ceil(B / 256) warps a (slot, feature), its dynamic shared
// memory sized to them. Above the 48 KB a launch gets without it (B >
// 3,840) the kernel's limit is raised first.
template <bool kQ8, bool kMono>
int launch_wide(const void* tile, const float* qs, const float* par,
                const int32_t* dr, const float* lap, const float* fmp,
                const float* pvp, void* full, void* cand, int p, int f,
                int b, cudaStream_t st) {
  const int warps = (b + kChunk - 1) / kChunk;
  const size_t smem = (size_t)wide_smem_floats(warps) * sizeof(float);
  if (smem > (size_t)kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        split_epilogue_wide<kQ8, kMono>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  split_epilogue_wide<kQ8, kMono><<<p * f, 32 * warps, smem, st>>>(
      kQ8 ? nullptr : static_cast<const float*>(tile),
      kQ8 ? static_cast<const int32_t*>(tile) : nullptr, qs, par, dr, lap,
      fmp, pvp, static_cast<float*>(full), static_cast<float*>(cand), p, f,
      b);
  return (int)cudaGetLastError();
}

template <bool kQ8, bool kMono>
void launch(const void* tile, const float* qs, const float* par,
            const int32_t* dr, const float* lap, const float* fmp,
            const float* pvp, void* full, void* cand, int p, int f, int b,
            int blocks, cudaStream_t st) {
  split_epilogue_kernel<kQ8, kMono><<<blocks, 32 * kWarps, 0, st>>>(
      kQ8 ? nullptr : static_cast<const float*>(tile),
      kQ8 ? static_cast<const int32_t*>(tile) : nullptr, qs, par, dr, lap,
      fmp, pvp, static_cast<float*>(full), static_cast<float*>(cand), p, f,
      b);
}

}  // namespace

// Returns cudaGetLastError() (0 = launched). `qscale` null: `tile` is
// p * f * b * 3 floats; else int32 sums dequantized by qscale[3].
// `with_monotone` nonzero selects the monotone mode; b > 256 the wide
// mode, b > 4,096 the wider mode (up to 65,536).
extern "C" int split_epilogue_launch(const void* tile, const void* qscale,
                                     const void* parent, const void* der,
                                     const void* la, const void* fm,
                                     const void* pv, void* full, void* cand,
                                     int p, int f, int b, int with_monotone,
                                     void* stream) {
  if (b > kMaxBinsDevice || b < 1) return (int)cudaErrorInvalidValue;
  const int pairs = p * f;
  if (pairs <= 0) return (int)cudaSuccess;
  const float* qs = static_cast<const float*>(qscale);
  const int blocks = (pairs + kWarps - 1) / kWarps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* par = static_cast<const float*>(parent);
  const int32_t* dr = static_cast<const int32_t*>(der);
  const float* lap = static_cast<const float*>(la);
  const float* fmp = static_cast<const float*>(fm);
  const float* pvp = static_cast<const float*>(pv);
  if (b > kMaxBinsWide) {
    if (qs && with_monotone)
      return launch_wider<true, true>(tile, qs, par, dr, lap, fmp, pvp, full,
                                      cand, p, f, b, st);
    if (qs)
      return launch_wider<true, false>(tile, qs, par, dr, lap, fmp, pvp,
                                       full, cand, p, f, b, st);
    if (with_monotone)
      return launch_wider<false, true>(tile, qs, par, dr, lap, fmp, pvp,
                                       full, cand, p, f, b, st);
    return launch_wider<false, false>(tile, qs, par, dr, lap, fmp, pvp, full,
                                      cand, p, f, b, st);
  }
  if (b > kMaxBins) {
    if (qs && with_monotone)
      return launch_wide<true, true>(tile, qs, par, dr, lap, fmp, pvp, full,
                                     cand, p, f, b, st);
    if (qs)
      return launch_wide<true, false>(tile, qs, par, dr, lap, fmp, pvp, full,
                                      cand, p, f, b, st);
    if (with_monotone)
      return launch_wide<false, true>(tile, qs, par, dr, lap, fmp, pvp, full,
                                      cand, p, f, b, st);
    return launch_wide<false, false>(tile, qs, par, dr, lap, fmp, pvp, full,
                                     cand, p, f, b, st);
  }
  if (qs && with_monotone)
    launch<true, true>(tile, qs, par, dr, lap, fmp, pvp, full, cand, p, f,
                       b, blocks, st);
  else if (qs)
    launch<true, false>(tile, qs, par, dr, lap, fmp, pvp, full, cand, p, f,
                        b, blocks, st);
  else if (with_monotone)
    launch<false, true>(tile, qs, par, dr, lap, fmp, pvp, full, cand, p, f,
                        b, blocks, st);
  else
    launch<false, false>(tile, qs, par, dr, lap, fmp, pvp, full, cand, p, f,
                         b, blocks, st);
  return (int)cudaGetLastError();
}
