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
// What bounds it on an H100: the node visits. A row reads one bin and one
// node record a visit; at 100 trees of 255 leaves a row makes ~860 visits
// in sequence, each ~20 integer operations, against 28 bytes of bins and
// 8 bytes of result a row. The first design (a thread a row, every record
// and bin read from global memory; kept as the "global" mode below) made
// each visit two dependent global loads: 10x the bound.
//
// The tile design (predict_ensemble_tile):
//   - Bins in shared memory. A block owns a tile of threads x kSlots rows
//     and copies the tile's bins once, feature by feature (the tile's
//     contiguous bytes of each feature row of binsT, read with its leading
//     dimension ld, so a column slice works), into shared memory row-major
//     with a row stride of an odd number of 32-bit words: a warp's 32
//     consecutive rows at one feature hit 32 different banks.
//   - Trees staged through shared memory. The wrapper packs each tree once
//     (ops/predict.py stage_ensemble) into a stage: 8-byte node records
//     numbered breadth first (below) and the leaf values. Chunks of
//     chunk_trees trees arrive by cp.async, double-buffered: the next
//     chunk lands while the block walks this one. A landed chunk's records
//     get their exception bins from mb in one pass, so a visit reads no
//     third array. Every thread of the block walks the same chunk.
//   - Rows in lock step, loads overlapped. The warp's rows walk each tree
//     together from the root, a thread's kSlots rows side by side: a step
//     loads every slot's record, then every slot's bin, then decides and
//     moves each slot by selects (no branch a slot, so the compiler issues
//     the slots' loads back to back); a row that reached its leaf waits on
//     a sentinel record, and its leaf value is added once the tree is
//     done. With breadth-first numbering the nodes a warp's rows reach at
//     one depth lie together, so their record loads mostly hit different
//     banks.
// Measured on an H100 (PERF.md): 2.5x below the first design, ~3.8x
// above the bound; the rows' dependent shared-memory loads (record, then
// bin) and their bank conflicts, not the instructions, set its time.
// Per-slot branches (no overlap), streams that carry a row from tree to
// tree within a chunk, 16-byte records, records read through L1, 8 slots
// a thread and lane-interleaved bins (conflict-free bin loads, more
// address arithmetic) were each slower.
//
// Which shapes take it (the wrapper's rule, ops/predict.py
// launch_geometry, chooses from the shape alone, never from a failure):
//   - tiled:  a numerical ensemble (no categorical or EFB-segment node,
//             every threshold below 4,096: a record's 12-bit field)
//             whose tree stages are at most 16 KB (1,023 leaves) and whose
//             tile of bins fits the block's shared memory beside two
//             chunk buffers (Higgs' 28 uint8 columns, max_bin 1,023's
//             int16 columns);
//   - global: every other shape, the first design unchanged. Measured
//             (lightgbm_tpu_torch/scripts/exp_predict_geometry.py), it
//             beats tiles on categorical and segment ensembles and from
//             2,047 leaves, and ties trees staged without the bins
//             (Epsilon's 2,000 columns).
// Each mode counts its own launches (predict_ensemble_geometry.*).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNodeInts = 8;

// ------------------------------------------------------------ global mode
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

// -------------------------------------------------------------- tile mode
// A staged node record (ops/predict.py stage_ensemble), 8 bytes:
//   x = feature (12 bits) | threshold bin << 12 (12) | e & 0xff << 24
//   y = e >> 8 (5 bits) | left << 5 (13) | right << 18 (13)
// A child is a node id below 4096 or 4096 + a leaf. e is the exception
// bin: the node sends bin e the other way than bin <= threshold does
// (the missing bin when the default direction disagrees with the
// threshold), 8191 for none; the stages hold the default direction there
// and a landed chunk's records get e from the call's mb. Nodes are
// numbered breadth first, so the nodes a warp's rows reach at one depth
// lie together and hit different banks.
constexpr int kSlots = 4;           // rows a thread (ops/predict.py)
constexpr int kNone = 8191;
constexpr int kRecBins = 4096;      // bins a record's threshold field holds

// A bin as the tiled mode keeps it in shared memory. The wrapper stages
// only trees whose thresholds lie below kRecBins, so every bin at or above
// it goes right of every threshold; only whether it is the column's
// missing bin m still matters. Those bins fold to kRecBins, or kRecBins + 1
// for m (whose exception bin folds the same way), so a 16- or 32-bit bin
// past the record's 12 bits decides as it would unfolded.
__device__ __forceinline__ int fold_bin(int v, int m) {
  return v < kRecBins ? v : (v == m ? kRecBins + 1 : kRecBins);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ int exception_bin(int m, int thr, int dl) {
  return (m >= 0 && ((m <= thr) != (dl != 0))) ? m : kNone;
}

// kMode as predict_ensemble_kernel. The threads of a block walk each tree
// together, each thread's kSlots rows in lock step: a step loads every
// slot's record, then every slot's bin, then decides and updates by
// selects, so the slots' loads overlap.
template <typename Bin, int kMode>
__global__ void __launch_bounds__(256, 3) predict_ensemble_tile(
    const Bin* __restrict__ bins, long long ld, int n, int f,
    const int32_t* __restrict__ mb, const uint8_t* __restrict__ stage,
    int stage_bytes, int node_cap, int off_leaf, int a, int b, int k,
    const double* __restrict__ bias, const uint8_t* __restrict__ active,
    void* carry, float* comp, int32_t* leaves_out, int stride,
    int chunk_trees, int off_trees) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int rows_tile = nt * kSlots;
  const int row0 = blockIdx.x * rows_tile;
  const Bin* bins_s = reinterpret_cast<const Bin*>(smem);
  const int stride_e = stride / (int)sizeof(Bin);
  uint8_t* trees_s = smem + off_trees;
  const int ct = chunk_trees;
  const int nchunks = (b - a + ct - 1) / ct;

  auto issue = [&](int c) {   // chunk c's stages -> buffer c & 1
    const int t0 = a + c * ct;
    const int cnt = min(ct, b - t0);
    const int vecs = cnt * stage_bytes / 16;
    const uint8_t* src = stage + (long long)t0 * stage_bytes;
    uint8_t* dst = trees_s + (c & 1) * ct * stage_bytes;
    for (int i = tid; i < vecs; i += nt)
      cp_async16(dst + i * 16, src + i * 16);
    cp_async_commit();
  };
  issue(0);
  {
    Bin* dst = reinterpret_cast<Bin*>(smem);
    for (int ff = 0; ff < f; ++ff) {
      const Bin* src = bins + (long long)ff * ld + row0;
      const int m = mb[ff];
      for (int lr = tid; lr < rows_tile; lr += nt) {
        const Bin v = row0 + lr < n ? src[lr] : (Bin)0;
        if constexpr (sizeof(Bin) > 1)
          dst[lr * stride_e + ff] = (Bin)fold_bin((int)v, m);
        else
          dst[lr * stride_e + ff] = v;
      }
    }
  }

  double* c64 = static_cast<double*>(carry);
  float* c32 = static_cast<float*>(carry);
  double acc64[kSlots];
  float acc32[kSlots], cmp32[kSlots];
  bool live[kSlots];
  int boff[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int lr = j * nt + tid;
    const int row = row0 + lr;
    live[j] = row < n;
    if (kMode != 3 && live[j] && active != nullptr && active[row] == 0)
      live[j] = false;
    boff[j] = lr * stride_e;
    acc64[j] = 0.0;
    acc32[j] = 0.0f;
    cmp32[j] = 0.0f;
    if (kMode != 3 && k == 1 && live[j]) {
      if (kMode == 0) acc64[j] = c64[row];
      if (kMode == 1) { acc32[j] = c32[row]; cmp32[j] = comp[row]; }
      if (kMode == 2) acc32[j] = c32[row];
    }
  }

  for (int c = 0; c < nchunks; ++c) {
    const int t0 = a + c * ct;
    const int cnt = min(ct, b - t0);
    if (c + 1 < nchunks) {
      issue(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    uint8_t* buf = trees_s + (c & 1) * ct * stage_bytes;
    for (int i = tid; i < cnt * node_cap; i += nt) {
      uint2* r = reinterpret_cast<uint2*>(
          buf + (i / node_cap) * stage_bytes + (i % node_cap) * 8);
      uint2 v = *r;
      const int ff = v.x & 0xFFF;
      const int m = ff < f ? mb[ff] : -1;
      const int e = exception_bin(m < kRecBins ? m : kRecBins + 1,
                                  (v.x >> 12) & 0xFFF, v.x >> 24);
      v.x = (v.x & 0xFFFFFFu) | ((unsigned)(e & 0xFF) << 24);
      v.y = (v.y & ~31u) | (unsigned)(e >> 8);
      *r = v;
    }
    __syncthreads();

    for (int tt = 0; tt < cnt; ++tt) {
      const int t = t0 + tt;
      const uint8_t* tb = buf + tt * stage_bytes;
      const uint2* recs = reinterpret_cast<const uint2*>(tb);
      const float* lvs = reinterpret_cast<const float*>(tb + off_leaf);
      const double bt = bias != nullptr ? bias[t] : 0.0;
      // a finished row sits on the sentinel record (node_cap), whose
      // children are itself
      int cur[kSlots], lf[kSlots];
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        cur[j] = live[j] ? 0 : node_cap;
        lf[j] = 0;
      }
      for (;;) {
        uint2 r[kSlots];
#pragma unroll
        for (int j = 0; j < kSlots; ++j) r[j] = recs[cur[j]];
        int bv[kSlots];
#pragma unroll
        for (int j = 0; j < kSlots; ++j)
          bv[j] = (int)bins_s[boff[j] + (r[j].x & 0xFFF)];
        bool any = false;
#pragma unroll
        for (int j = 0; j < kSlots; ++j) {
          const int thr = (r[j].x >> 12) & 0xFFF;
          const int e = (r[j].x >> 24) | ((r[j].y & 31) << 8);
          const bool left = (bv[j] <= thr) != (bv[j] == e);
          const int code = (r[j].y >> (left ? 5 : 18)) & 0x1FFF;
          const bool leaf = code >= 4096;
          lf[j] = leaf ? code - 4096 : lf[j];
          cur[j] = leaf ? node_cap : code;
          any |= cur[j] != node_cap;
        }
        if (!any) break;
      }
      // every live row reached one leaf of tree t: its value, added once
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const int row = row0 + j * nt + tid;
        if (kMode == 3) {
          if (live[j]) leaves_out[(long long)(t - a) * n + row] = lf[j];
          continue;
        }
        const float lv = lvs[lf[j]];
        if (k == 1) {
          if (kMode == 0) {
            double v = (double)lv;
            if (bias != nullptr) v = v - bt;
            const double s = acc64[j] + v;
            acc64[j] = live[j] ? s : acc64[j];
          } else {
            float v = lv;
            if (bias != nullptr) v = v - (float)bt;
            if (kMode == 2) {
              const float s = acc32[j] + v;
              acc32[j] = live[j] ? s : acc32[j];
            } else {
              const float y = v - cmp32[j];
              const float ts = acc32[j] + y;
              const float nc = (ts - acc32[j]) - y;
              acc32[j] = live[j] ? ts : acc32[j];
              cmp32[j] = live[j] ? nc : cmp32[j];
            }
          }
        } else if (live[j]) {
          const long long at = (long long)row * k + (t % k);
          if (kMode == 0) {
            double v = (double)lv;
            if (bias != nullptr) v = v - bt;
            c64[at] = c64[at] + v;
          } else {
            float v = lv;
            if (bias != nullptr) v = v - (float)bt;
            if (kMode == 2) {
              c32[at] = c32[at] + v;
            } else {
              const float y = v - comp[at];
              const float ts = c32[at] + y;
              comp[at] = (ts - c32[at]) - y;
              c32[at] = ts;
            }
          }
        }
      }
    }
    __syncthreads();   // buffer c & 1 is refilled next
  }

  if (kMode != 3 && k == 1) {
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if (!live[j]) continue;
      const int row = row0 + j * nt + tid;
      if (kMode == 0) c64[row] = acc64[j];
      if (kMode == 1) { c32[row] = acc32[j]; comp[row] = cmp32[j]; }
      if (kMode == 2) c32[row] = acc32[j];
    }
  }
}

// ------------------------------------------------------------ dispatch
struct Args {
  const void* bins; long long ld; int n; int f; const void* mb;
  const void* nodes; const void* bits; int words; int node_cap;
  const void* leaf_value; int leaf_cap; const void* num_leaves;
  int a; int b; int k; const void* bias; const void* active;
  void* carry; void* comp; void* leaves_out;
  const void* stage; int stage_bytes; int off_leaf; int stride;
  int chunk_trees; int off_trees; int smem; int threads; int blocks;
  cudaStream_t stream;
};

template <typename Bin, int kMode>
cudaError_t launch_global(const Args& p) {
  const int threads = 256;
  const int grid = (p.n + threads - 1) / threads;
  auto args = [&](auto kernel) {
    kernel<<<grid, threads, 0, p.stream>>>(
        static_cast<const Bin*>(p.bins), p.ld, p.n,
        static_cast<const int32_t*>(p.mb),
        static_cast<const int32_t*>(p.nodes),
        static_cast<const uint32_t*>(p.bits), p.words, p.node_cap,
        static_cast<const float*>(p.leaf_value), p.leaf_cap,
        static_cast<const int32_t*>(p.num_leaves), p.a, p.b, p.k,
        static_cast<const double*>(p.bias),
        static_cast<const uint8_t*>(p.active), p.carry,
        static_cast<float*>(p.comp), static_cast<int32_t*>(p.leaves_out));
  };
  if (p.k == 1 || kMode == 3)
    args(predict_ensemble_kernel<Bin, kMode, true>);
  else
    args(predict_ensemble_kernel<Bin, kMode, false>);
  return cudaGetLastError();
}

template <typename Bin, int kMode>
cudaError_t launch_tile(const Args& p) {
  auto kernel = predict_ensemble_tile<Bin, kMode>;
  static int smem_set = 0;   // this instantiation's opt-in so far
  if (p.smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
    smem_set = p.smem;
  }
  kernel<<<p.blocks, p.threads, p.smem, p.stream>>>(
      static_cast<const Bin*>(p.bins), p.ld, p.n, p.f,
      static_cast<const int32_t*>(p.mb), static_cast<const uint8_t*>(p.stage),
      p.stage_bytes, p.node_cap, p.off_leaf, p.a, p.b, p.k,
      static_cast<const double*>(p.bias),
      static_cast<const uint8_t*>(p.active), p.carry,
      static_cast<float*>(p.comp), static_cast<int32_t*>(p.leaves_out),
      p.stride, p.chunk_trees, p.off_trees);
  return cudaGetLastError();
}

// geometry: 0 global, 1 tiled (ops/predict.py GEOMETRY_MODES)
template <typename Bin, int kMode>
cudaError_t launch_geometry(int geometry, const Args& p) {
  return geometry == 0 ? launch_global<Bin, kMode>(p)
                       : launch_tile<Bin, kMode>(p);
}

template <typename Bin>
cudaError_t launch_bin(int mode, int geometry, const Args& p) {
  switch (mode) {
    case 0: return launch_geometry<Bin, 0>(geometry, p);
    case 1: return launch_geometry<Bin, 1>(geometry, p);
    case 2: return launch_geometry<Bin, 2>(geometry, p);
    default: return launch_geometry<Bin, 3>(geometry, p);
  }
}

}  // namespace

// bins: uint8_t (bin_bytes 1), int16_t (2) or int32_t (4) [F, ld], rows
// 0..n-1 of
// it; carry: double [N, K] (mode 0) or float [N, K] (modes 1, 2); comp:
// float [N, K] (mode 1); leaves_out: int32 [b - a, N] (mode 3); bias,
// active: null when not given. The global mode reads nodes [T, C, 8],
// bits [T, C, W], leaf_value [T, L] and num_leaves [T]; the tiled mode
// reads the stages [T, stage_bytes] with the geometry's shared-memory
// layout (ops/predict.py launch_geometry).
extern "C" int predict_ensemble_launch(
    const void* bins, int bin_bytes, long long ld, int n, int f,
    const void* mb,
    const void* nodes, const void* bits, int words, int node_cap,
    const void* leaf_value, int leaf_cap, const void* num_leaves, int a,
    int b, int k, const void* bias, const void* active, void* carry,
    void* comp, void* leaves_out, int mode, int geometry, const void* stage,
    int stage_bytes, int off_leaf, int stride, int chunk_trees,
    int off_trees, int smem, int threads, int blocks, void* stream) {
  if (n <= 0 || b <= a) return (int)cudaSuccess;
  if (k < 1 || mode < 0 || mode > 3 || geometry < 0 || geometry > 1 ||
      words < 1 || node_cap < 1 || leaf_cap < 1)
    return (int)cudaErrorInvalidValue;
  if (geometry == 1 &&
      (stage == nullptr || stage_bytes < 16 || stage_bytes % 16 != 0 ||
       f < 1 || f > 4096 || node_cap > 4094 || leaf_cap > 4096 ||
       blocks < 1 || smem < 0 || smem > 232448 || threads < 32 ||
       threads > 256 || threads % 32 != 0 || chunk_trees < 1))
    return (int)cudaErrorInvalidValue;
  Args p{bins, ld, n, f, mb, nodes, bits, words, node_cap, leaf_value,
         leaf_cap, num_leaves, a, b, k, bias, active, carry, comp,
         leaves_out, stage, stage_bytes, off_leaf, stride, chunk_trees,
         off_trees, smem, threads, blocks, static_cast<cudaStream_t>(stream)};
  cudaError_t err = bin_bytes == 4 ? launch_bin<int32_t>(mode, geometry, p)
                    : bin_bytes == 2 ? launch_bin<int16_t>(mode, geometry, p)
                                     : launch_bin<uint8_t>(mode, geometry, p);
  return (int)err;
}
