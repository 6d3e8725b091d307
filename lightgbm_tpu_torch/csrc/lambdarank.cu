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
// Per query (one block), per document d (a thread, striding over the
// query's documents in rank order, so the documents ranked above trunc,
// the ones that walk every partner, share the first warp and the other
// warps run the short loop without divergence):
//   - partners: every document of the query if rank(d) < trunc, else only
//     the documents ranked above trunc (the top list, ascending index
//     order). Any other pair has min(rank) >= trunc and is an exact 0 in
//     the JAX tensor, so the cut changes no sum;
//   - a pair with label(d) > label(j) adds its lambda and hessian to d's
//     "higher" sums, one with label(d) < label(j) to d's "lower" sums, both
//     in ascending partner index (the order lambdarank_grads_exact, the
//     plain version the card holds this kernel to, adds in);
//   - lam = higher - lower, hess = higher + lower (sum(axis=2) -/+
//     sum(axis=1) of the JAX text); the query's sum of the higher lambdas
//     over its documents in index order, by thread 0 (S = -2 * it).
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
// MS LTR-shaped layout with trunc 30, each evaluated by both of its
// documents), each ~45 operations (the exp's double-precision steps
// included); the per-document arrays are small (20 bytes a document in,
// 12 out). A warp reads one
// partner at a time, the same address on every lane (a broadcast from L1).
// The cost is imbalance: a document ranked above trunc walks all n
// partners, the rest walk trunc, so the long queries' first warp sets the
// block's time; walking the documents in rank order keeps the long walks
// in that one warp instead of one lane of every warp.

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

__global__ void lambdarank_kernel(
    const float* __restrict__ score, const float* __restrict__ label,
    const float* __restrict__ gain, const float* __restrict__ disc,
    const int32_t* __restrict__ rank, const int32_t* __restrict__ order,
    const int32_t* __restrict__ bounds,
    const int32_t* __restrict__ top, const float* __restrict__ inv_max,
    const int32_t* __restrict__ same, int t, int trunc, float sig, int norm,
    float* __restrict__ lam, float* __restrict__ hess, float* high,
    float* __restrict__ sum_high) {
  const int q = blockIdx.x;
  const int b0 = bounds[q];
  const int n = bounds[q + 1] - b0;
  const float inv = inv_max[q];
  const bool divide = norm != 0 && same[q] == 0;
  const float sig2 = sig * sig;
  const int32_t* tq = top + (size_t)q * t;
  const int tn = min(t, n);
  for (int r_d = threadIdx.x; r_d < n; r_d += blockDim.x) {
    const int i = order[b0 + r_d];          // the document ranked r_d
    const float s_d = score[i], l_d = label[i], g_d = gain[i], d_d = disc[i];
    const bool every = r_d < trunc;
    const int cnt = every ? n : tn;
    float hl = 0.0f, hh = 0.0f, ll = 0.0f, lh = 0.0f;
    for (int k = 0; k < cnt; ++k) {
      const int j = every ? b0 + k : tq[k];
      const float l_j = label[j];
      if (l_j == l_d || min(r_d, rank[j]) >= trunc) continue;
      float pl, ph;
      if (l_d > l_j) {
        pair_terms(s_d, score[j], g_d, gain[j], d_d, disc[j], inv, divide,
                   sig, sig2, pl, ph);
        hl = ftz(hl + pl);
        hh = ftz(hh + ph);
      } else {
        pair_terms(score[j], s_d, gain[j], g_d, disc[j], d_d, inv, divide,
                   sig, sig2, pl, ph);
        ll = ftz(ll + pl);
        lh = ftz(lh + ph);
      }
    }
    lam[i] = ftz(hl - ll);
    hess[i] = ftz(hh + lh);
    high[i] = hl;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float acc = 0.0f;
    for (int d = 0; d < n; ++d) acc = ftz(acc + high[b0 + d]);
    sum_high[q] = acc;
  }
}

}  // namespace

// score/label/gain/disc [N] f32, rank [N] int32 (within the query), order
// [N] int32 (the documents by query, then rank), bounds [Q+1] int32, top
// [Q, t] int32 (the documents ranked above trunc, ascending), inv_max [Q]
// f32, same [Q] int32 (best == worst score);
// out: lam/hess [N] f32, high [N] scratch, sum_high [Q] f32.
extern "C" int lambdarank_launch(const void* score, const void* label,
                                 const void* gain, const void* disc,
                                 const void* rank, const void* order,
                                 const void* bounds,
                                 const void* top, const void* inv_max,
                                 const void* same, int q, int t, int trunc,
                                 float sig, int norm, void* lam, void* hess,
                                 void* high, void* sum_high, int threads,
                                 void* stream) {
  if (q <= 0) return (int)cudaSuccess;
  if (t < 1 || threads < 32 || threads > 1024)
    return (int)cudaErrorInvalidValue;
  lambdarank_kernel<<<q, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(score), static_cast<const float*>(label),
      static_cast<const float*>(gain), static_cast<const float*>(disc),
      static_cast<const int32_t*>(rank), static_cast<const int32_t*>(order),
      static_cast<const int32_t*>(bounds),
      static_cast<const int32_t*>(top), static_cast<const float*>(inv_max),
      static_cast<const int32_t*>(same), t, trunc, sig, norm,
      static_cast<float*>(lam), static_cast<float*>(hess),
      static_cast<float*>(high), static_cast<float*>(sum_high));
  return (int)cudaGetLastError();
}
