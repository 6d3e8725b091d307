// predict_ensemble.cu -- ensemble traversal and accumulation of a predict.
//
// Computes what lightgbm_tpu/models/predict_engine.py _accum_core and
// _leaves_core compute (plain jnp scans over the stacked trees, no Pallas
// kernel: this is a port-only kernel): for every row, walk trees a..b-1 IN
// TREE ORDER over the feature-major bin matrix binsT [F, N] with
// _decide_left_bins' semantics (models/tree.py: the missing bin routed by
// the default direction, an EFB bundle segment whose outside bins take the
// default direction, a categorical node's bitset word bin >> 5), then
//   - accumulate modes: v = leaf_value[leaf] (float32 as stored, widened
//     to double in the float64 mode), less the tree's bias when given,
//     added into carry[row, t % K]; a row whose active flag is 0 keeps its
//     carry. float64: col + v in double. float32: col + v in float, the
//     bias rounded to float first. compensated: two-float (Kahan) sums in
//     _accum_core's own operations and order, y = v - c, s' = s + y,
//     c' = (s' - s) - y;
//   - leaves mode: leaf [b - a, N] int32.
// The adds are single IEEE operations in tree order and the library is
// built with --fmad=false, so the result is bitwise the plain version
// (ops/predict.py predict_ensemble_plain) and the JAX engine, and two
// launches give the same bits.
//
// Layout: one thread a row, the row's K sums in a register when K = 1 and
// in the carry's own row (K contiguous doubles, L1-resident) otherwise.
// The node table is [T, C, 8] int32 (feature, threshold bin, default
// left, left child, right child, is categorical, segment lo, segment hi),
// the bitsets [T, C, W] 32-bit words, leaf values [T, L] float32.
//
// What bounds it on an H100: the node visits. A row reads one bin byte
// (two in the wide mode) and one 32-byte node record a visit; at 100
// trees of 255 leaves a row makes ~1,000-2,000 visits, each ~20 integer
// operations, against 28 bytes of bins and 8 bytes of result a row. The
// node records of one tree (8 KB) are shared by every thread and stay in
// L1/L2; the bins of a feature are read by neighbouring threads at
// neighbouring addresses only when they sit at the same node, so the bin
// reads scatter. This first design keeps to that; row-major bins, trees in
// shared memory and warp-coherent traversal are its second pass.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNodeInts = 8;

template <typename Bin>
__device__ __forceinline__ int walk_tree(const Bin* __restrict__ bins,
                                         long long ld, int row,
                                         const int32_t* __restrict__ mb,
                                         const int32_t* __restrict__ nodes,
                                         const uint32_t* __restrict__ bits,
                                         int words, int num_leaves) {
  if (num_leaves <= 1) return 0;
  int cur = 0;
  // a leaf lies at most num_leaves - 1 edges below the root
  for (int s = 0; s < num_leaves; ++s) {
    const int32_t* nd = nodes + (long long)cur * kNodeInts;
    const int feat = nd[0];
    const int thr = nd[1];
    const int bv = (int)bins[(long long)feat * ld + row];
    bool left;
    if (nd[5]) {
      const uint32_t w = bits[(long long)cur * words + (bv >> 5)];
      left = ((w >> (bv & 31)) & 1u) != 0u;
    } else if (nd[6] >= 0) {
      left = (bv >= nd[6] && bv <= nd[7]) ? (bv <= thr) : (nd[2] != 0);
    } else {
      const int m = mb[feat];
      left = (m >= 0 && bv == m) ? (nd[2] != 0) : (bv <= thr);
    }
    const int nxt = left ? nd[3] : nd[4];
    if (nxt < 0) return ~nxt;
    cur = nxt;
  }
  return 0;
}

// mode: 0 float64, 1 compensated, 2 float32, 3 leaves
template <typename Bin, int kMode, bool kOne>
__global__ void predict_ensemble_kernel(
    const Bin* __restrict__ bins, long long ld, int n,
    const int32_t* __restrict__ mb, const int32_t* __restrict__ nodes,
    const uint32_t* __restrict__ bits, int words, int node_cap,
    const float* __restrict__ leaf_value, int leaf_cap,
    const int32_t* __restrict__ num_leaves, int a, int b, int k,
    const double* __restrict__ bias, const uint8_t* __restrict__ active,
    void* carry, float* comp, int32_t* leaves_out) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  if (kMode != 3 && active != nullptr && active[row] == 0) return;
  double acc64 = 0.0;
  float acc32 = 0.0f, cmp32 = 0.0f;
  double* c64 = static_cast<double*>(carry);
  float* c32 = static_cast<float*>(carry);
  if (kOne) {
    if (kMode == 0) acc64 = c64[row];
    if (kMode == 1) { acc32 = c32[row]; cmp32 = comp[row]; }
    if (kMode == 2) acc32 = c32[row];
  }
  for (int t = a; t < b; ++t) {
    const int leaf = walk_tree<Bin>(
        bins, ld, row, mb, nodes + (long long)t * node_cap * kNodeInts,
        bits + (long long)t * node_cap * words, words, num_leaves[t]);
    if (kMode == 3) {
      leaves_out[(long long)(t - a) * n + row] = leaf;
      continue;
    }
    const float lv = leaf_value[(long long)t * leaf_cap + leaf];
    const long long at = kOne ? row : (long long)row * k + (t % k);
    if (kMode == 0) {
      double v = (double)lv;
      if (bias != nullptr) v = v - bias[t];
      if (kOne) acc64 = acc64 + v; else c64[at] = c64[at] + v;
    } else {
      float v = lv;
      if (bias != nullptr) v = v - (float)bias[t];
      if (kMode == 2) {
        if (kOne) acc32 = acc32 + v; else c32[at] = c32[at] + v;
      } else {
        const float s = kOne ? acc32 : c32[at];
        const float c = kOne ? cmp32 : comp[at];
        const float y = v - c;
        const float ts = s + y;
        const float nc = (ts - s) - y;
        if (kOne) { acc32 = ts; cmp32 = nc; }
        else { c32[at] = ts; comp[at] = nc; }
      }
    }
  }
  if (kOne) {
    if (kMode == 0) c64[row] = acc64;
    if (kMode == 1) { c32[row] = acc32; comp[row] = cmp32; }
    if (kMode == 2) c32[row] = acc32;
  }
}

template <typename Bin, int kMode>
cudaError_t launch_mode(const void* bins, long long ld, int n, const void* mb,
                        const void* nodes, const void* bits, int words,
                        int node_cap, const void* leaf_value, int leaf_cap,
                        const void* num_leaves, int a, int b, int k,
                        const void* bias, const void* active, void* carry,
                        void* comp, void* leaves_out, int threads,
                        cudaStream_t stream) {
  const int grid = (n + threads - 1) / threads;
  if (k == 1 || kMode == 3) {
    predict_ensemble_kernel<Bin, kMode, true><<<grid, threads, 0, stream>>>(
        static_cast<const Bin*>(bins), ld, n,
        static_cast<const int32_t*>(mb), static_cast<const int32_t*>(nodes),
        static_cast<const uint32_t*>(bits), words, node_cap,
        static_cast<const float*>(leaf_value), leaf_cap,
        static_cast<const int32_t*>(num_leaves), a, b, k,
        static_cast<const double*>(bias), static_cast<const uint8_t*>(active),
        carry, static_cast<float*>(comp), static_cast<int32_t*>(leaves_out));
  } else {
    predict_ensemble_kernel<Bin, kMode, false><<<grid, threads, 0, stream>>>(
        static_cast<const Bin*>(bins), ld, n,
        static_cast<const int32_t*>(mb), static_cast<const int32_t*>(nodes),
        static_cast<const uint32_t*>(bits), words, node_cap,
        static_cast<const float*>(leaf_value), leaf_cap,
        static_cast<const int32_t*>(num_leaves), a, b, k,
        static_cast<const double*>(bias), static_cast<const uint8_t*>(active),
        carry, static_cast<float*>(comp), static_cast<int32_t*>(leaves_out));
  }
  return cudaGetLastError();
}

template <typename Bin>
cudaError_t launch_bin(int mode, const void* bins, long long ld, int n,
                       const void* mb, const void* nodes, const void* bits,
                       int words, int node_cap, const void* leaf_value,
                       int leaf_cap, const void* num_leaves, int a, int b,
                       int k, const void* bias, const void* active,
                       void* carry, void* comp, void* leaves_out, int threads,
                       cudaStream_t stream) {
  switch (mode) {
    case 0:
      return launch_mode<Bin, 0>(bins, ld, n, mb, nodes, bits, words,
                                 node_cap, leaf_value, leaf_cap, num_leaves,
                                 a, b, k, bias, active, carry, comp,
                                 leaves_out, threads, stream);
    case 1:
      return launch_mode<Bin, 1>(bins, ld, n, mb, nodes, bits, words,
                                 node_cap, leaf_value, leaf_cap, num_leaves,
                                 a, b, k, bias, active, carry, comp,
                                 leaves_out, threads, stream);
    case 2:
      return launch_mode<Bin, 2>(bins, ld, n, mb, nodes, bits, words,
                                 node_cap, leaf_value, leaf_cap, num_leaves,
                                 a, b, k, bias, active, carry, comp,
                                 leaves_out, threads, stream);
    default:
      return launch_mode<Bin, 3>(bins, ld, n, mb, nodes, bits, words,
                                 node_cap, leaf_value, leaf_cap, num_leaves,
                                 a, b, k, bias, active, carry, comp,
                                 leaves_out, threads, stream);
  }
}

}  // namespace

// bins: uint8_t (wide = 0) or int16_t (wide = 1) [F, ld], rows 0..n-1 of
// it; carry: double [N, K] (mode 0) or float [N, K] (modes 1, 2); comp:
// float [N, K] (mode 1); leaves_out: int32 [b - a, N] (mode 3); bias,
// active: null when not given.
extern "C" int predict_ensemble_launch(
    const void* bins, int wide, long long ld, int n, const void* mb,
    const void* nodes, const void* bits, int words, int node_cap,
    const void* leaf_value, int leaf_cap, const void* num_leaves, int a,
    int b, int k, const void* bias, const void* active, void* carry,
    void* comp, void* leaves_out, int mode, int threads, void* stream) {
  if (n <= 0 || b <= a) return (int)cudaSuccess;
  if (k < 1 || mode < 0 || mode > 3 || threads < 32 || threads > 1024 ||
      words < 1 || node_cap < 1 || leaf_cap < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      wide ? launch_bin<int16_t>(mode, bins, ld, n, mb, nodes, bits, words,
                                 node_cap, leaf_value, leaf_cap, num_leaves,
                                 a, b, k, bias, active, carry, comp,
                                 leaves_out, threads, s)
           : launch_bin<uint8_t>(mode, bins, ld, n, mb, nodes, bits, words,
                                 node_cap, leaf_value, leaf_cap, num_leaves,
                                 a, b, k, bias, active, carry, comp,
                                 leaves_out, threads, s);
  return (int)err;
}
