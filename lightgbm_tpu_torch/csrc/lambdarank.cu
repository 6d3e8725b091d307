// lambdarank.cu -- the pairwise lambda pass of lambdarank.
//
// Computes what lightgbm_tpu/ranking.py LambdarankNDCG._padded_grads +
// _scatter_grads compute, before the log2(1+S)/S normalisation and the
// document weights (both plain torch in ops/rank.py): for every document
// its lambda and hessian summed over the pairs it forms with the other
// documents of its query. The JAX package has no Pallas kernel for it: it
// is plain jnp over a padded [Q, M, M] pair tensor, which at MS LTR width
// (18,919 queries, M = 1,256) is 119 GB a tensor. This kernel never builds
// a pair: it reads per-document arrays and walks each document's real
// partners, as the reference does (rank_objective.hpp:142-227).
//
// Per query (one block), the partners of a document d:
//   - every document of the query if rank(d) < trunc (a "top" document),
//     else only the top documents (the top list, ascending index order).
//     Any other pair has min(rank) >= trunc and is an exact 0 in the JAX
//     tensor, so the cut changes no sum; a pair with a top document is
//     always admitted, so only the labels decide;
//   - a pair with label(d) > label(j) adds its lambda and hessian to d's
//     "higher" sums, one with label(d) < label(j) to d's "lower" sums;
//   - lam = higher - lower, hess = higher + lower (sum(axis=2) -/+
//     sum(axis=1) of the JAX text); S = -2 * the query's sum of the
//     higher lambdas.
//
// Numerics: every pair term is the plain version's operations in its
// order (ops/rank.py _pair_terms), each float32 result flushed to zero
// below FLT_MIN as XLA:CPU's flush-to-zero mode does; the sigmoid's exp is
// the port's exp_f32 (objectives.py: XLA:CPU's Cephes exp with its fused
// multiply-adds evaluated in double and rounded once); no CUDA exp. The
// library is built with --fmad=false, so nothing is contracted, and the
// sums have a fixed order: two launches give the same bits.
//
// What bounds it on an H100: the pairs the truncation admits (those with
// a document ranked above trunc and unequal labels: 36.5M at train_rank's
// MS LTR-shaped layout with trunc 30), each ~45 operations (the exp's
// double-precision steps included); the per-document arrays are small
// (20 bytes a document in, 12 out). The first design (a thread a
// document, documents in rank order) was 88x that bound: a top document
// walked all n partners alone in one lane, so the longest query's first
// warp ran 1,251 steps in sequence while the block's other lanes idled,
// each step five global loads; every pair was evaluated by both of its
// documents; and thread 0 summed the query's n higher lambdas alone.
//
// This design, in the sum order lambdarank_grads_exact writes out:
//   - Partner arrays in shared memory: the query's score, label, gain,
//     discount and top flag in tiles of kTile documents (4.3 KB), read by
//     every warp; a query longer than a tile walks through its tiles in
//     order. Small tiles leave room for 12 blocks an SM.
//   - Each pair evaluated once. The top documents go in rounds of kWarps,
//     in ascending index, a warp each; lane l of the warp takes partners
//     l, l + 32, ... of the query in ascending index, so the longest
//     query's critical path is ~8 rounds of ~40 steps instead of 1,251.
//     Each lane sums the top document's terms in that order from +0, and
//     the 32 lane sums combine through a fixed butterfly, v +
//     shfl_xor(v, m) for m = 16, 8, 4, 2, 1. The warp also leaves each
//     pair's terms in shared memory; after the round, the thread that owns
//     a partner ranked at or below trunc (k mod kThreads) adds the round's
//     terms to its running sums in the top documents' order, so its sums
//     run over the top list in ascending index, one after another.
//   - The query's sum of higher lambdas: thread t sums documents t, t +
//     kThreads, ... in index order from +0, then a halving tree over the
//     threads' sums in shared memory (t += t + s for s = 64, 32, ..., 1).
//   - Blocks run longest query first (a permutation computed once per
//     layout, ops/rank.py RankLayout.by_length), so the longest blocks
//     start in the first wave instead of setting the tail. Queries are
//     independent: the order changes no bit.
//   - kThreads = 128: MS LTR's queries hold ~120 documents on average
//     (30 top ones): 4 warps take the 30 top ones in 8 rounds of ~4 steps
//     a lane, and one pass of the block's threads adds a round's terms.
// Measured on an H100 (PERF.md): 2.5x below the first design; evaluating
// each pair twice with the other documents' walks apart, or the block's
// threads over one top document at a time, were slower.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kFltMin = 1.17549435082228750797e-38f;
// objectives.py exp_f32's constants, as the float32 values it embeds
constexpr float kExpLo = -88.3762626647949f;
constexpr float kLog2e = 1.44269504088896341f;
constexpr float kLn2Hi = 0.693359375f;
constexpr float kLn2Lo = -2.12194440e-4f;
constexpr float kP0 = 1.9875691500e-4f, kP1 = 1.3981999507e-3f,
                kP2 = 8.3334519073e-3f, kP3 = 4.1665795894e-2f,
                kP4 = 1.6666665459e-1f, kP5 = 5.0000001201e-1f;

__device__ __forceinline__ float ftz(float x) {
  return fabsf(x) < kFltMin ? x * 0.0f : x;
}

// objectives.py _fma: a * b + c in double (the product is exact), rounded
// once to float
__device__ __forceinline__ float fma64(float a, double b, double c) {
  return (float)((double)a * b + c);
}

// objectives.py exp_f32, operation for operation
__device__ float exp_f32(float x) {
  if (isnan(x)) return x;
  x = fmaxf(x, kExpLo);
  float n = fminf(floorf(fma64(x, (double)kLog2e, 0.5)), 127.0f);
  float r = fma64(n, -(double)kLn2Hi, (double)x);
  r = fma64(n, -(double)kLn2Lo, (double)r);
  float z = r * r;
  float y = fma64(r, (double)kP0, (double)kP1);
  y = fma64(y, (double)r, (double)kP2);
  y = fma64(y, (double)r, (double)kP3);
  y = fma64(y, (double)r, (double)kP4);
  y = fma64(y, (double)r, (double)kP5);
  y = fma64(y, (double)z, (double)r) + 1.0f;
  double two_n = __longlong_as_double((long long)((int)n + 1023) << 52);
  float out = (float)((double)y * two_n);
  return out < kFltMin ? 0.0f : out;
}

// ops/rank.py _pair_terms for one admitted pair (i the higher label)
__device__ __forceinline__ void pair_terms(float s_i, float s_j, float g_i,
                                           float g_j, float d_i, float d_j,
                                           float inv, bool divide, float sig,
                                           float sig2, float& lam,
                                           float& hess) {
  float ds = ftz(s_i - s_j);
  float dn = ftz(ftz(ftz(g_i - g_j) * fabsf(ftz(d_i - d_j))) * inv);
  if (divide) dn = ftz(dn / (0.01f + fabsf(ds)));
  float x = ftz(-sig * ds);
  float p = ftz(1.0f / (1.0f + exp_f32(-x)));
  float ph = ftz(p * (1.0f - p));
  lam = ftz(ftz(-sig * dn) * p);
  hess = ftz(ftz(sig2 * dn) * ph);
}

constexpr int kThreads = 128;      // ops/rank.py _THREADS
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 256;         // partner documents a tile

__device__ __forceinline__ float butterfly(float v) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1)
    v = ftz(v + __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

__global__ void __launch_bounds__(kThreads, 12) lambdarank_kernel(
    const float* __restrict__ score, const float* __restrict__ label,
    const float* __restrict__ gain, const float* __restrict__ disc,
    const int32_t* __restrict__ rank, const int32_t* __restrict__ bounds,
    const int32_t* __restrict__ by_length,
    const int32_t* __restrict__ top, const float* __restrict__ inv_max,
    const int32_t* __restrict__ same, int t, int trunc, float sig, int norm,
    float* __restrict__ lam, float* __restrict__ hess, float* high,
    float* __restrict__ part, float* __restrict__ sum_high) {
  __shared__ float s_score[kTile], s_label[kTile], s_gain[kTile],
      s_disc[kTile];
  __shared__ bool s_other[kTile];               // ranked at or below trunc
  // a round's pair terms, a warp's top document by partner: lambda,
  // hessian, and 0 (no pair) / 1 (the partner lower) / 2 (higher)
  __shared__ float b_lam[kWarps][kTile], b_hess[kWarps][kTile];
  __shared__ uint8_t b_kind[kWarps][kTile];
  __shared__ float red[kThreads];
  const int q = by_length[blockIdx.x];
  const int b0 = bounds[q];
  const int n = bounds[q + 1] - b0;
  const int total = bounds[gridDim.x];
  const float inv = inv_max[q];
  const bool divide = norm != 0 && same[q] == 0;
  const float sig2 = sig * sig;
  const int32_t* tq = top + (size_t)q * t;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = min(trunc, n);                 // the top documents
  const int tiles = (n + kTile - 1) / kTile;
  // the other documents' running sums (higher lambda, higher hessian,
  // lower lambda, lower hessian), each owned by thread k mod kThreads
  float* p_hl = part;
  float* p_hh = part + total;
  float* p_ll = part + 2 * total;
  float* p_lh = part + 3 * total;
  for (int k = tid; k < n; k += kThreads) {
    p_hl[b0 + k] = 0.0f;
    p_hh[b0 + k] = 0.0f;
    p_ll[b0 + k] = 0.0f;
    p_lh[b0 + k] = 0.0f;
  }
  auto stage = [&](int tile) {
    const int base = tile * kTile, len = min(kTile, n - base);
    for (int k = tid; k < len; k += kThreads) {
      const int j = b0 + base + k;
      s_score[k] = score[j];
      s_label[k] = label[j];
      s_gain[k] = gain[j];
      s_disc[k] = disc[j];
      s_other[k] = rank[j] >= trunc;
    }
  };
  if (tiles == 1) {
    stage(0);
    __syncthreads();
  }
  // the top documents in ascending index, kWarps a round, a warp each,
  // its lanes over all the partners
  const int rounds = (nt + kWarps - 1) / kWarps;
  for (int round = 0; round < rounds; ++round) {
    const int p = round * kWarps + warp;
    const bool mine = p < nt;
    int i = 0;
    float s_d = 0.0f, l_d = 0.0f, g_d = 0.0f, d_d = 0.0f;
    if (mine) {
      i = tq[p];
      s_d = score[i];
      l_d = label[i];
      g_d = gain[i];
      d_d = disc[i];
    }
    float hl = 0.0f, hh = 0.0f, ll = 0.0f, lh = 0.0f;
    for (int tile = 0; tile < tiles; ++tile) {
      if (tiles > 1) {
        __syncthreads();
        stage(tile);
        __syncthreads();
      }
      const int base = tile * kTile;
      const int len = min(kTile, n - base);
      for (int k = lane; k < len; k += 32) {
        const float l_j = s_label[k];
        uint8_t kind = 0;
        if (mine && l_j != l_d) {
          // one evaluation, its operands ordered higher label first
          const bool up = l_d > l_j;
          const float s_j = s_score[k], g_j = s_gain[k], d_j = s_disc[k];
          float pl, ph;
          pair_terms(up ? s_d : s_j, up ? s_j : s_d, up ? g_d : g_j,
                     up ? g_j : g_d, up ? d_d : d_j, up ? d_j : d_d, inv,
                     divide, sig, sig2, pl, ph);
          if (up) {
            hl = ftz(hl + pl);
            hh = ftz(hh + ph);
          } else {
            ll = ftz(ll + pl);
            lh = ftz(lh + ph);
          }
          b_lam[warp][k] = pl;
          b_hess[warp][k] = ph;
          kind = up ? 1 : 2;
        }
        b_kind[warp][k] = kind;
      }
      __syncthreads();
      // each other document adds the round's terms in the top documents'
      // index order
      for (int k = tid; k < len; k += kThreads) {
        if (!s_other[k]) continue;
        const int j = b0 + base + k;
        float a_hl = p_hl[j], a_hh = p_hh[j], a_ll = p_ll[j], a_lh = p_lh[j];
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const uint8_t kind = b_kind[w][k];
          if (kind == 1) {
            a_ll = ftz(a_ll + b_lam[w][k]);
            a_lh = ftz(a_lh + b_hess[w][k]);
          } else if (kind == 2) {
            a_hl = ftz(a_hl + b_lam[w][k]);
            a_hh = ftz(a_hh + b_hess[w][k]);
          }
        }
        p_hl[j] = a_hl;
        p_hh[j] = a_hh;
        p_ll[j] = a_ll;
        p_lh[j] = a_lh;
      }
      __syncthreads();
    }
    if (mine) {
      hl = butterfly(hl);
      hh = butterfly(hh);
      ll = butterfly(ll);
      lh = butterfly(lh);
      if (lane == 0) {
        lam[i] = ftz(hl - ll);
        hess[i] = ftz(hh + lh);
        high[i] = hl;
      }
    }
  }
  for (int k = tid; k < n; k += kThreads) {
    const int j = b0 + k;
    if (rank[j] < trunc) continue;
    lam[j] = ftz(p_hl[j] - p_ll[j]);
    hess[j] = ftz(p_hh[j] + p_lh[j]);
    high[j] = p_hl[j];
  }
  __syncthreads();
  // the query's sum of higher lambdas: strided, then a halving tree
  float acc = 0.0f;
  for (int k = tid; k < n; k += kThreads) acc = ftz(acc + high[b0 + k]);
  red[tid] = acc;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] = ftz(red[tid] + red[tid + s]);
    __syncthreads();
  }
  if (tid == 0) sum_high[q] = red[0];
}

}  // namespace

// score/label/gain/disc [N] f32, rank [N] int32 (within the query),
// bounds [Q+1] int32, by_length [Q] int32 (the queries longest first), top
// [Q, t] int32 (the documents ranked above trunc, ascending), inv_max [Q]
// f32, same [Q] int32 (best == worst score); out: lam/hess [N] f32, high
// [N] scratch, part [4N] f32 scratch, sum_high [Q] f32.
extern "C" int lambdarank_launch(const void* score, const void* label,
                                 const void* gain, const void* disc,
                                 const void* rank, const void* bounds,
                                 const void* by_length, const void* top,
                                 const void* inv_max, const void* same,
                                 int q, int t, int trunc, float sig,
                                 int norm, void* lam, void* hess, void* high,
                                 void* part, void* sum_high, int threads,
                                 void* stream) {
  if (q <= 0) return (int)cudaSuccess;
  if (t < 1 || trunc < 0 || threads != kThreads)
    return (int)cudaErrorInvalidValue;
  lambdarank_kernel<<<q, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(score), static_cast<const float*>(label),
      static_cast<const float*>(gain), static_cast<const float*>(disc),
      static_cast<const int32_t*>(rank),
      static_cast<const int32_t*>(bounds),
      static_cast<const int32_t*>(by_length),
      static_cast<const int32_t*>(top), static_cast<const float*>(inv_max),
      static_cast<const int32_t*>(same), t, trunc, sig, norm,
      static_cast<float*>(lam), static_cast<float*>(hess),
      static_cast<float*>(high), static_cast<float*>(part),
      static_cast<float*>(sum_high));
  return (int)cudaGetLastError();
}
