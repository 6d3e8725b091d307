// hist_tile.cu -- the histogram tile pass, deterministic, f32, f64 and q8.
//
// Replaces lightgbm_tpu/ops/pallas_hist.py:
//   _fused_kernel       plane-only full-row form   (hist_full_launch)
//   _gather_kernel      plane-only gather form     (hist_gather_launch;
//                                                   idx[m], entries >= n
//                                                   are padding)
// and the accumulation half of
//   _fused_epi_kernel   full-row form of the fused split epilogue
//   _gather_epi_kernel  gather form of the fused split epilogue
// (their epilogue half is csrc/split_epilogue.cu), in both of their
// accumulation modes: the f32 modes (`highest`, `hilo`; float stats) and
// `q8` (int8 stats summed exactly into int32 planes, _accumulate's q8
// branch). The classic split path launches it alone; the fused path
// launches split_epilogue after it.
//
// What it computes: out[p, f, b, s] = sum of stats[r, s] over the rows r
// whose leaf id is the leaf of slot p (chan[3p], the TPU lane table of
// chan_leaf_table) and whose bin of feature f is b. Slots whose lane holds
// no leaf (derived or inactive) come out zero.
//
// What bounds it on an H100: by bytes, the full form's pass must read the
// bin matrix once (n*F bytes), the leaf ids and stats once (16*n bytes f32,
// 7*n bytes q8) and write the tile (P*F*B*3*4 bytes); the gather form reads
// only the rung's rows. In practice both sit on the 3*F shared-memory
// atomics a kept row costs (PERF.md has the measured times), so both read
// each row once for all the features of a block and keep the atomics
// 32-bit.
//
// Determinism, f32 mode: the sums are the same bits from run to run. Each
// stat is added as a 64-bit fixed-point integer, value * 2^k rounded to the
// nearest integer, where k (one per stat channel and launch) is the largest
// that keeps any sum of the pass below 2^61: k = 61 - e with max|stat| *
// rows < 2^e (max|stat| over all n rows: the caller's `amax`, or
// stat_absmax when it passes none; a max is order-free). Integer addition
// is associative, so neither the atomics' order nor how the rows are split
// among blocks changes a bit, and the one conversion back to float32 at
// the end rounds once. Integer-valued stats (and any stat that is a
// multiple of 2^-k) are summed exactly, so they come out bitwise equal to
// the plain version; float stats come out within 2^-k-ish of the exact
// sum, closer than a float32 sum. A non-finite stat makes its channel NaN.
//
// q8 mode: the stats are int8 already (the grower's stochastic rounding),
// so each is added as it is with 32-bit atomics into int32 sums. No scale;
// |sum| <= 127 * rows, which int32 holds up to (2^31 - 1) / 127 rows (the
// wrapper checks). The sums are exact, so every launch, every split of the
// rows and the plain version give the same planes.
//
// Full-row form (idx absent). The Pallas kernel keeps a [F*B, 128]
// accumulator resident in VMEM across a sequential grid; GPU blocks run in
// parallel and in no order, and 3.7 MB does not fit in shared memory. With
// hist_subtraction a tile's computed slot is the smaller sibling of a pair,
// so after the root every pass fits a compaction rung: the full form the
// trainer launches is the root pass, one computed slot holding every row.
// That pass (any tile of one computed slot) is full_accumulate + the
// convert: one wave of blocks over contiguous row ranges, each block the
// planes of a feature group (all 28 Higgs features in f32). A warp reads
// 32 rows at a time -- leaf id and stats once, the stats converted once to
// the launch's fixed point -- stages the rows of the slot's leaf in shared
// memory and then takes their (row, feature) pairs lane by lane, the bins
// from the row-major copy, so the lanes of a warp add to different
// features and skewed bins rarely meet in one cell (on the Zipf-skewed
// Expo bins the pass takes the uniform bins' time, so the block keeps one
// copy of its planes: PERF.md). f32 cells are two 32-bit words
// (add_split), not int64 compare-and-swap loops. The flush adds each
// nonzero cell to [F, B, 3] integer sums in global memory. A tile of
// several computed slots runs the gather form below over the implicit
// rung 0..n-1 (no idx buffer).
//
// Gather form (rows idx[0:m], in row order, padded with n). The rung's
// rows are few and scattered, so the cost is per row, not per byte: each
// kept row's leaf and stats are read once, and its bins once, from a
// row-major copy of the bin matrix (`rows`, n * width bytes, one 32-byte
// sector a row at Higgs width; the wrapper builds it once per bin matrix),
// where the feature-major binsT would cost a sector per (row, feature) at
// a rung's density. Three passes and a convert, after the reference's GPU
// learner (rows grouped by leaf, DataPartition; per-block shared-memory
// sub-histograms over a group of features, histogram_16_64_256.cu):
//   1. gather_count: walk idx once; per computed slot (compact index c),
//      the number of kept rows -- padding, leaves outside [0, l) and
//      leaves of no computed slot are dropped.
//   2. gather_scatter: walk idx again in tiles of blockDim entries; each
//      tile ranks its rows by slot in shared memory, stages each kept row's
//      payload there -- its row id and its stats, converted once to the
//      launch's fixed-point int64 (f32) or packed as three int8 in one word
//      (q8) -- reserves one run per slot in the slot's region of `payload`
//      with one atomic, and copies the runs out. Rows within a slot are in
//      no fixed order; the sums are integers, so that changes no bit.
//   3. gather_accumulate: one wave of blocks over the payload's R kept
//      rows, each block a contiguous range (at least kMinRows rows) of them
//      for a group of features whose planes fit its shared memory (all 28
//      Higgs features in f32). Thread (row, feature) adds the row's stats to
//      the feature's plane (f32: two 32-bit atomics a stat, add_split); a
//      block flushes at each slot boundary of its range, adding each
//      nonzero cell to the [active, F, B, 3] integer sums in global memory
//      (order-free integer atomics). No host sync: every block reads the
//      slot offsets from the device counts.
//   4. hist_tile_reduce: converts the sums to the output planes and zeroes
//      the slots that are not computed (also the full form's convert).
//
// Numerics on Hopper: `pallas` and `pallas_hilo` are the same here. The
// TPU's `hilo` bf16 hi/lo split is an MXU device; this kernel needs none.
//
// f64 mode (`dp` != 0; gpu_use_dp, the classic path's plane-only forms
// only): the JAX package accumulates float64 planes there through XLA's
// scatter, not a Pallas kernel (ops/histogram.py:220-223). Here it is the
// f32 mode's accumulation unchanged -- the f32 stats read as they are (an
// f32 value is exact in f64), the same 64-bit fixed-point sums -- and a
// convert that writes double: the integer sum rounded once to 53 bits,
// where the f32 mode rounds it again to 24. The output type is a template
// parameter of the convert alone, so the f32, q8 and wide instantiations
// keep their code; no float atomics either way.
//
// Wide bins (`bin_bytes` 2 or 4; the Pallas kernels at num_bins > 256,
// which cast each bin to int32, pallas_hist.py:143): the bin type is a
// template parameter, uint8_t, uint16_t (the port's int16 bins, up to
// 32,768 bins) or uint32_t (its int32 bins above that, up to the cap of
// 65,536 bins a column), so the uint8 instantiations keep their code. Only
// the row-major copy's element and the planes' size change: a block's
// planes are [group, B, 3] cells, so `group` shrinks as B grows (at B =
// 1,023 in f32, 8 features fit a full-form block: the 28 Higgs features
// take 4 groups of 7 and the rows are read 4 times; at B = 4,095 one
// feature a block, 98 KB of planes). The payload of the gather form
// carries no bins, so it is unchanged. At wide B a block fills most of an
// SM's shared memory, so one block runs per SM, and the atomics spread
// over more banks.
//
// A feature's bins across the CTAs of a cluster (B past what one block's
// shared memory holds: ~8,400 bins in the full form's f32 mode, ~9,600 in
// the gather form's; at 65,536 bins one f32 plane is 1.5 MB). What bounds
// the pass there is moving each (row, feature) to its cell once: the
// earlier bin-range split gave each (feature, bin range) a block that
// reread every row's leaf, stats and bin and skipped the rows outside its
// range (traffic_model: 9.97 GB at 65,536 f32 against 1.18 GB least), and
// its one block an SM left a second wave mostly empty. On Hopper the
// shared memory of a thread-block cluster is one address space
// (distributed shared memory), so a cluster of `cluster` CTAs (2 at 16,384
// f32, 4 at 65,536 q8, 8 at 65,536 f32; at most 8, the portable size)
// holds one feature's whole [B, 3] plane, CTA rank k the bins [k*span,
// (k+1)*span):
//   - full_cluster / gather_cluster: the CTAs of a cluster read disjoint
//     shares of its rows (the full form, from the feature-major bins,
//     coalesced) or of its payload rows (the gather form, bins from the
//     row-major copy), and each (row, feature) adds its stats to the cell
//     of the CTA that owns its bin, through distributed shared memory
//     (cluster.map_shared_rank: the owner's cell as a generic address).
//     A row is read once per
//     feature, not once per (feature, range), and no add reaches L2
//     before the flush;
//   - one cluster barrier before the flush (every add landed), then each
//     CTA flushes its own bins by integer add into the sums (the gather
//     form at every slot boundary of its payload range, with a second
//     barrier before the next slot's adds reach the zeroed cells), and
//     one at the start (every plane zeroed before a remote add);
//   - the grid is features x cluster rows, features fastest, so the
//     clusters of one row range run together and share its leaf ids and
//     stats through L2; its rows are as many row ranges as make whole
//     waves of clusters (cudaOccupancyMaxActiveClusters: the wrapper's
//     ops/cuda_hist.py cluster_rows), with no tail wave. A card that
//     cannot place the cluster (0 active clusters) is refused by the
//     wrapper, which names the shape; no other form stands in.
// What bounds the cluster form is then its atomics: three a (row,
// feature), most of them remote. f32 cells are 64-bit fixed point, added
// as one 64-bit atomic on the mapped address (add_split's two words need
// the low word's old value for the carry, a round trip to the remote SM:
// 1.5x slower on the card, PERF.md); q8 cells int32. Skewed bins send
// many lanes of a warp to one remote cell, so the lanes that add to one
// cell merge their values first (warp_merge: match, then a reduction of
// each stat), one atomic a stat for the group.
// Every layout gives the same integers as one block's plane: the sums are
// fixed-point, exact in any order and any split, so the planes are
// bitwise hist_tile_exact's and bitwise from launch to launch. (The
// earlier forms past one block's plane -- a block a bin range rereading
// the rows, and global atomics into the sums -- lost to the cluster form
// in every case chip_smoke.py's forms_wider measured, and went.)
//
// The launch geometry is the caller's (ops/cuda_hist.py autotune_hist
// sweeps it): rows a block or a cluster takes (`per`; 0 = one wave of
// device_sms() x occupancy blocks of at least kMinRows rows, or the
// cluster rows the wrapper passes) and threads a block (a multiple of 32,
// at most 1,024).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kStats = 3;
constexpr int kThreads = 1024;
constexpr int kMaxExp = 1000;
constexpr int kMaxSlots = 42;     // 128 lanes / 3 stats
constexpr int kMinRows = 512;     // fewest payload rows an accumulate block
                                  // takes: its flush is F*B*3 cells
constexpr int kNonFinite = -2147483647 - 1;
constexpr int kUnroll = 4;        // entries, rows or pairs a thread loads
                                  // at once
constexpr int kMaxCluster = 8;    // CTAs of a cluster: the portable size

// Exponent k of the fixed-point scale 2^k for a channel whose largest
// |stat| has float bits `amax_bits`, over `rows` rows; kNonFinite when the
// channel holds a non-finite value.
__device__ int fixed_exponent(unsigned amax_bits, long long rows) {
  const float amax = __uint_as_float(amax_bits);
  if (!isfinite(amax)) return kNonFinite;
  const double bound = (double)amax * (double)rows;
  if (bound == 0.0) return 61;
  int e;
  frexp(bound, &e);                       // bound < 2^e
  const int k = 61 - e;
  return k > kMaxExp ? kMaxExp : (k < -kMaxExp ? -kMaxExp : k);
}

__device__ double fixed_scale(unsigned amax_bits, long long rows) {
  const int k = fixed_exponent(amax_bits, rows);
  return ldexp(1.0, k == kNonFinite ? 0 : k);
}

// amax_bits[s] = float bits of max |stats[r, s]| over all rows (NaN bits
// order above every finite value and inf, so a NaN wins).
__global__ void stat_absmax(const float* __restrict__ stats,
                            unsigned* __restrict__ amax_bits, int n) {
  unsigned local[kStats] = {0u, 0u, 0u};
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += (long long)gridDim.x * blockDim.x) {
    for (int s = 0; s < kStats; ++s) {
      const unsigned bits = __float_as_uint(stats[r * kStats + s]) &
                            0x7fffffffu;
      local[s] = local[s] > bits ? local[s] : bits;
    }
  }
  for (int s = 0; s < kStats; ++s) {
    const unsigned w = __reduce_max_sync(0xffffffffu, local[s]);
    if ((threadIdx.x & 31) == 0) atomicMax(amax_bits + s, w);
  }
}

// The two accumulation modes: the stat type, the global sums' type as the
// atomics add them (Acc) and as the convert reads them (Part), and the
// output type.
template <bool kQ8> struct Mode;
template <> struct Mode<false> {
  using Stat = float;
  using Acc = unsigned long long;
  using Part = long long;
  using Out = float;
};
template <> struct Mode<true> {
  using Stat = int8_t;
  using Acc = int;
  using Part = int;
  using Out = int;
};

// f32 mode's shared-memory cell: a 64-bit fixed-point sum kept as two
// 32-bit words, low (unsigned) and high (signed), so that an add is one or
// two native 32-bit shared-memory atomics instead of a 64-bit
// compare-and-swap loop (ATOMS.CAST.SPIN.64, which int64 shared-memory
// cells compile to). The low word's carry goes into the high word: the
// pair holds the exact sum modulo 2^64, as an int64 accumulator would
// (|high| stays below 2^31: the scale keeps |sum of v| < 2^61 over the
// pass, and the carries are at most one a row).
__device__ __forceinline__ void add_split(unsigned* cell, long long v) {
  const unsigned lo = (unsigned)v;
  int hi = (int)(v >> 32);
  if (lo) {
    const unsigned old = atomicAdd(cell, lo);
    hi += (old + lo < old) ? 1 : 0;
  }
  if (hi) atomicAdd(reinterpret_cast<int*>(cell) + 1, hi);
}

// ------------------------------------------------------------ full form
// Words of a staged row's stats: three int64 fixed-point values (f32), or
// three int8 packed in one word (q8).
template <bool kQ8> struct Staged {
  static constexpr int kWords = kQ8 ? 1 : 2 * kStats;
};

// Block (x, y): rows [x*per, x*per + per) of the n rows (per a multiple of
// 32); grid row y is the feature group: features [g0, g0 + group). Only
// the rows of leaf `target` are added. Shared memory: the planes
// ([group][b][3] cells: the add_split pair in f32 mode, 8 bytes; an int32
// sum in q8, 4), then each warp's 32 staged rows (their stats, then their
// row ids). accum [f][b][3] integer sums, zeroed by the caller. Pair q of
// a warp's staged rows is (row q / gn, feature q % gn).
template <bool kQ8, typename Bin>
__global__ void full_accumulate(
    const Bin* __restrict__ rows, const int32_t* __restrict__ leaf,
    const typename Mode<kQ8>::Stat* __restrict__ stats,
    const unsigned* __restrict__ amax_bits,
    typename Mode<kQ8>::Acc* __restrict__ accum, int n, int f, int b,
    int target, int width, int group, long long per, long long exp_rows) {
  using SG = Staged<kQ8>;
  constexpr int kWords = kQ8 ? 1 : 2;                      // words a cell
  extern __shared__ __align__(16) unsigned char full_smem[];
  __shared__ double scale[kStats];
  const int g0 = blockIdx.y * group;
  const int gn = min(group, f - g0);
  const int row_cells = b * kStats;
  const int cells = gn * row_cells;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned* plane = reinterpret_cast<unsigned*>(full_smem);
  uint32_t* val = plane + (size_t)cells * kWords;         // 8-byte aligned
  int* srow = reinterpret_cast<int*>(val + (size_t)warps * 32 * SG::kWords)
              + warp * 32;
  val += (size_t)warp * 32 * SG::kWords;
  for (int i = threadIdx.x; i < cells * kWords; i += blockDim.x) plane[i] = 0;
  if (!kQ8 && threadIdx.x < kStats)
    scale[threadIdx.x] = fixed_scale(amax_bits[threadIdx.x], exp_rows);
  __syncthreads();

  const long long r0 = (long long)blockIdx.x * per;
  const long long r1 = min((long long)n, r0 + per);
  const int step_j = 32 / gn, step_f = 32 % gn;    // a lane's step: 32 pairs
  for (long long base = r0 + (long long)warp * 32; base < r1;
       base += (long long)warps * 32) {
    // stage the chunk's rows of the slot: lane i reads row base + i
    const long long r = base + lane;
    int lf = -1;
    typename Mode<kQ8>::Stat st[kStats];
    if (r < r1) {
      lf = leaf[r];
      for (int c = 0; c < kStats; ++c) st[c] = stats[r * kStats + c];
    }
    const bool keep = lf == target;
    const unsigned mask = __ballot_sync(0xffffffffu, keep);
    if (keep) {
      const int j = __popc(mask & ((1u << lane) - 1u));
      srow[j] = (int)r;
      if constexpr (kQ8) {
        val[j] = (uint32_t)(uint8_t)st[0] | ((uint32_t)(uint8_t)st[1] << 8)
                 | ((uint32_t)(uint8_t)st[2] << 16);
      } else {
        long long* v = reinterpret_cast<long long*>(val + j * SG::kWords);
        for (int c = 0; c < kStats; ++c)
          v[c] = __double2ll_rn((double)st[c] * scale[c]);
      }
    }
    __syncwarp();
    // add the staged rows' (row, feature) pairs, kUnroll bins loaded at once
    const int total = __popc(mask) * gn;
    int j = lane / gn;
    int fi = lane - j * gn;
    for (int q = lane; q < total; q += 32 * kUnroll) {
      int bin[kUnroll], jr[kUnroll], fr[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        jr[u] = j;
        fr[u] = fi;
        bin[u] = q + 32 * u < total
                     ? (int)rows[(size_t)srow[j] * width + g0 + fi] : b;
        j += step_j;
        fi += step_f;
        if (fi >= gn) {
          fi -= gn;
          ++j;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if ((unsigned)bin[u] >= (unsigned)b) continue;   // b: skipped
        unsigned* cell =
            plane + ((size_t)fr[u] * row_cells + bin[u] * kStats) * kWords;
        if constexpr (kQ8) {
          const uint32_t w = val[jr[u]];
          for (int k = 0; k < kStats; ++k)
            atomicAdd(reinterpret_cast<int*>(cell) + k,
                      (int)(int8_t)(uint8_t)(w >> (8 * k)));
        } else {
          const long long* v =
              reinterpret_cast<const long long*>(val + jr[u] * SG::kWords);
          for (int k = 0; k < kStats; ++k) add_split(cell + 2 * k, v[k]);
        }
      }
    }
    __syncwarp();
  }
  __syncthreads();
  // flush: each nonzero cell added to the global sums
  typename Mode<kQ8>::Acc* dst = accum + (size_t)g0 * b * kStats;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int fi = i / row_cells;
    const size_t at = (size_t)fi * b * kStats + (i - fi * row_cells);
    if constexpr (kQ8) {
      const int v = (int)plane[i];
      if (v != 0) atomicAdd(dst + at, v);
    } else {
      const unsigned long long v =
          ((unsigned long long)plane[2 * i + 1] << 32) + plane[2 * i];
      if (v != 0) atomicAdd(dst + at, v);
    }
  }
}

// One fixed-point sum of a channel whose exponent is k, converted once:
// to double (one rounding), or to float32 through double (the integer
// rounded to double, then to float32); NaN for a non-finite channel.
template <typename Out>
__device__ __forceinline__ Out convert_cell(long long acc, int k) {
  if constexpr (sizeof(Out) == 8)
    return k == kNonFinite ? __longlong_as_double(0x7ff8000000000000LL)
                           : (double)acc * ldexp(1.0, -k);
  else
    return k == kNonFinite ? __int_as_float(0x7fffffff)
                           : (float)((double)acc * ldexp(1.0, -k));
}

// out[p][f][b][s] = the integer sums of slot p's compact index c (comp[p],
// or with comp null: 0 for slot `only`, none for the others), in f32 mode
// converted once to Out (float32, or double in the f64 mode), or with Out
// long long (the integer-planes mode) left as integers; 0 for a slot with
// none. `m` is the row count the fixed-point exponent was taken over.
template <bool kQ8, typename Out>
__global__ void hist_tile_reduce(
    const typename Mode<kQ8>::Part* __restrict__ accum,
    const int32_t* __restrict__ comp, int only,
    const unsigned* __restrict__ amax_bits, Out* __restrict__ out, int p,
    int f, int b, long long m) {
  const long long per_slot = (long long)f * b * kStats;
  const long long cells = (long long)p * per_slot;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < cells; e += (long long)gridDim.x * blockDim.x) {
    const int slot = (int)(e / per_slot);
    const long long rest = e - slot * per_slot;
    const int c = comp != nullptr ? comp[slot] : (slot == only ? 0 : -1);
    if (c < 0) {
      out[e] = 0;
      continue;
    }
    const typename Mode<kQ8>::Part acc = accum[c * per_slot + rest];
    if constexpr (kQ8 || std::is_same<Out, long long>::value)
      out[e] = acc;
    else
      out[e] = convert_cell<Out>(
          acc, fixed_exponent(amax_bits[rest % kStats], m));
  }
}

// The integer-planes mode's convert, a launch of its own: out[e] = the
// int64 sums acc[e] of `cells` * 3 planes cells (one rank's raw planes or
// the gang's sum of them), each channel's exponent from amax_bits and
// `rows`, converted as hist_tile_reduce converts.
template <typename Out>
__global__ void hist_convert(const long long* __restrict__ acc,
                             const unsigned* __restrict__ amax_bits,
                             Out* __restrict__ out, long long cells,
                             long long rows) {
  __shared__ int k[kStats];
  if (threadIdx.x < kStats)
    k[threadIdx.x] = fixed_exponent(amax_bits[threadIdx.x], rows);
  __syncthreads();
  const long long total = cells * kStats;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x)
    out[e] = convert_cell<Out>(acc[e], k[e % kStats]);
}

// The convert of one mode: q8 (int32 out), f32 (float) or, with `dp`, the
// f64 mode (double), or with `raw` the f32 mode's int64 sums unconverted.
int launch_reduce(bool q8, bool dp, bool raw, const void* accum,
                  const int32_t* comp, int only, const unsigned* amax_bits,
                  void* out, int p, int f, int b, long long m,
                  cudaStream_t st) {
  const long long cells = (long long)p * f * b * kStats;
  const long long want = (cells + 255) / 256;
  const int blocks = (int)(want < 65535 ? (want > 0 ? want : 1) : 65535);
  if (q8)
    hist_tile_reduce<true, int><<<blocks, 256, 0, st>>>(
        static_cast<const int*>(accum), comp, only, amax_bits,
        static_cast<int*>(out), p, f, b, m);
  else if (raw)
    hist_tile_reduce<false, long long><<<blocks, 256, 0, st>>>(
        static_cast<const long long*>(accum), comp, only, amax_bits,
        static_cast<long long*>(out), p, f, b, m);
  else if (dp)
    hist_tile_reduce<false, double><<<blocks, 256, 0, st>>>(
        static_cast<const long long*>(accum), comp, only, amax_bits,
        static_cast<double*>(out), p, f, b, m);
  else
    hist_tile_reduce<false, float><<<blocks, 256, 0, st>>>(
        static_cast<const long long*>(accum), comp, only, amax_bits,
        static_cast<float*>(out), p, f, b, m);
  return (int)cudaGetLastError();
}

int device_sms() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

// ----------------------------------------------------------- gather form
// Compact slot of the row r of a rung entry (-1: padding, or a leaf in no
// computed slot).
__device__ __forceinline__ int row_slot(const int32_t* __restrict__ leaf,
                                        const int32_t* __restrict__ slot_of,
                                        int r, int n, int l) {
  if (r < 0 || r >= n) return -1;                       // rung padding
  const int lf = leaf[r];
  return (lf < 0 || lf >= l) ? -1 : slot_of[lf];
}

// Adds each lane's one row to counter[s] (the lanes of one slot share one
// shared-memory atomic) and returns the lane's rank among the rows added
// to counter[s]; -1 for s < 0. Every lane of the warp must call it.
__device__ __forceinline__ int warp_slot_add(int* counter, int s) {
  const unsigned peers = __match_any_sync(0xffffffffu, s);
  if (s < 0) return -1;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(counter + s, __popc(peers));
  base = __shfl_sync(peers, base, leader);
  return base + __popc(peers & ((1u << lane) - 1u));
}

// Exclusive scan of in[0, k) (k <= 64 slots) into out[0, k], out[k] the
// total, by the block's first warp (each lane two slots); the caller syncs
// before reading out.
__device__ __forceinline__ void warp_scan_slots(const int* in, int* out,
                                                int k) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int a = 2 * lane < k ? in[2 * lane] : 0;
  const int b = 2 * lane + 1 < k ? in[2 * lane + 1] : 0;
  int s = a + b;
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, s, d);
    if (lane >= d) s += t;
  }
  if (2 * lane < k) out[2 * lane] = s - a - b;
  if (2 * lane + 1 < k) out[2 * lane + 1] = s - b;
  if (lane == 31) out[k] = s;
}

// counts[c] += the rung rows of compact slot c. Each thread loads kUnroll
// entries' row, leaf and slot before it counts them. A null idx is the
// implicit rung 0..m-1 (the full form's several-slot pass).
__global__ void gather_count(const int32_t* __restrict__ idx,
                             const int32_t* __restrict__ leaf,
                             const int32_t* __restrict__ slot_of,
                             int* __restrict__ counts, int n, int m, int l,
                             int active) {
  __shared__ int local[kMaxSlots];
  for (int s = threadIdx.x; s < active; s += blockDim.x) local[s] = 0;
  __syncthreads();
  const long long step = (long long)blockDim.x * kUnroll;
  for (long long base = blockIdx.x * step; base < m;
       base += gridDim.x * step) {
    int r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * blockDim.x + threadIdx.x;
      r[u] = i < m ? (idx != nullptr ? idx[i] : (int)i) : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      warp_slot_add(local, row_slot(leaf, slot_of, r[u], n, l));
  }
  __syncthreads();
  for (int s = threadIdx.x; s < active; s += blockDim.x)
    if (local[s]) atomicAdd(counts + s, local[s]);
}

// Payload row j: word 0 the row id, then its stats -- word 1 three int8
// (q8), or words 2..7 three int64 fixed-point values (f32; 8-byte
// aligned). counts[0, active) are the slot counts, counts[active,
// 2*active) the slots' fill cursors (zeroed by the caller). A tile is
// blockDim.x rung entries, one a thread; a null idx as in gather_count.
template <bool kQ8> struct Payload {
  static constexpr int kWords = kQ8 ? 2 : 8;    // words a row
  static constexpr int kStat = kQ8 ? 1 : 2;     // first stats word
};

template <bool kQ8>
__global__ void gather_scatter(
    const int32_t* __restrict__ leaf,
    const typename Mode<kQ8>::Stat* __restrict__ stats,
    const int32_t* __restrict__ slot_of, const int32_t* __restrict__ idx,
    const unsigned* __restrict__ amax_bits, int* __restrict__ counts,
    uint32_t* __restrict__ payload, int n, int m, int l, int active,
    long long exp_rows) {
  using PL = Payload<kQ8>;
  extern __shared__ __align__(16) unsigned char scat_smem[];
  const int T = blockDim.x;
  uint32_t* stage = reinterpret_cast<uint32_t*>(scat_smem);  // [T][words]
  int* stage_slot = reinterpret_cast<int*>(stage + (size_t)T * PL::kWords);
  __shared__ int g_off[kMaxSlots + 1];  // slot's first payload row
  __shared__ int t_cnt[kMaxSlots];      // this tile's rows of the slot
  __shared__ int t_off[kMaxSlots + 1];  // their first staging row; total
  __shared__ int g_base[kMaxSlots];     // their first payload row
  __shared__ double scale[kStats];
  warp_scan_slots(counts, g_off, active);
  if (!kQ8 && threadIdx.x < kStats)
    scale[threadIdx.x] = fixed_scale(amax_bits[threadIdx.x], exp_rows);
  int* cursor = counts + active;

  for (long long base = (long long)blockIdx.x * T; base < m;
       base += (long long)gridDim.x * T) {
    for (int s = threadIdx.x; s < active; s += T) t_cnt[s] = 0;
    __syncthreads();
    const long long i = base + threadIdx.x;
    const int r = i < m ? (idx != nullptr ? idx[i] : (int)i) : -1;
    const int s = row_slot(leaf, slot_of, r, n, l);
    const int rank = warp_slot_add(t_cnt, s);
    __syncthreads();
    warp_scan_slots(t_cnt, t_off, active);
    for (int c = threadIdx.x; c < active; c += T)
      if (t_cnt[c]) g_base[c] = g_off[c] + atomicAdd(cursor + c, t_cnt[c]);
    __syncthreads();
    if (s >= 0) {
      const int j = t_off[s] + rank;
      stage_slot[j] = s;
      uint32_t* dst = stage + (size_t)j * PL::kWords;
      dst[0] = (uint32_t)r;
      const typename Mode<kQ8>::Stat* st = stats + (size_t)r * kStats;
      if constexpr (kQ8) {
        dst[PL::kStat] = (uint32_t)(uint8_t)st[0]
                         | ((uint32_t)(uint8_t)st[1] << 8)
                         | ((uint32_t)(uint8_t)st[2] << 16);
      } else {
        long long* v = reinterpret_cast<long long*>(dst + PL::kStat);
        for (int c = 0; c < kStats; ++c)
          v[c] = __double2ll_rn((double)st[c] * scale[c]);
      }
    }
    __syncthreads();
    // the staged rows go out as one run per slot
    const int words = t_off[active] * PL::kWords;
    for (int e = threadIdx.x; e < words; e += T) {
      const int j = e / PL::kWords;
      const int c = stage_slot[j];
      payload[(size_t)(g_base[c] + j - t_off[c]) * PL::kWords
              + (e - j * PL::kWords)] = stage[e];
    }
    __syncthreads();
  }
}

// Block (x, y): payload rows [x*per, x*per + per) (per_rows, or with 0
// per >= kMinRows, the rows split evenly over gridDim.x); grid row y is the
// feature group: features [g0, g0 + group). accum [active][f][b][3] integer
// sums, zeroed by the caller. A plane cell is the add_split pair in f32
// mode (8 bytes), an int32 sum in q8 (4). Thread (jj, fi) takes feature
// fi of every rows_per_iter-th row, loading kUnroll rows before it adds
// them.
template <bool kQ8, typename Bin>
__global__ void gather_accumulate(const uint32_t* __restrict__ payload,
                                  const Bin* __restrict__ rows,
                                  const int* __restrict__ counts,
                                  typename Mode<kQ8>::Acc* __restrict__ accum,
                                  int f, int b, int active, int width,
                                  int group, long long per_rows) {
  using PL = Payload<kQ8>;
  extern __shared__ __align__(16) unsigned char acc_smem[];
  unsigned* plane = reinterpret_cast<unsigned*>(acc_smem);  // [group][b][3]
  __shared__ int g_off[kMaxSlots + 1];
  const int g0 = blockIdx.y * group;
  const int gn = min(group, f - g0);
  const int row_cells = b * kStats;
  const int cells = gn * row_cells;
  constexpr int kWords = kQ8 ? 1 : 2;                      // words a cell
  warp_scan_slots(counts, g_off, active);
  for (int i = threadIdx.x; i < cells * kWords; i += blockDim.x) plane[i] = 0;
  __syncthreads();
  const long long total = g_off[active];
  long long per = per_rows;
  if (per <= 0) {
    per = (total + gridDim.x - 1) / gridDim.x;
    per = per > kMinRows ? per : kMinRows;
  }
  const long long j0 = (long long)blockIdx.x * per;
  const long long j1 = min(total, j0 + per);
  if (j0 >= j1) return;
  const int rows_per_iter = blockDim.x / gn;
  const int jj = threadIdx.x / gn;
  const int fi = threadIdx.x - jj * gn;
  for (int c = 0; c < active; ++c) {
    const long long a = max(j0, (long long)g_off[c]);
    const long long z = min(j1, (long long)g_off[c + 1]);
    if (a >= z) continue;
    typename Mode<kQ8>::Acc* dst = accum + ((size_t)c * f + g0) * b * kStats;
    if (jj < rows_per_iter) {
      for (long long j = a + jj; j < z;
           j += (long long)kUnroll * rows_per_iter) {
        int bin[kUnroll];
        uint32_t w[kUnroll];
        long long v[kUnroll][kStats];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const long long jr = j + (long long)u * rows_per_iter;
          bin[u] = b;
          if (jr < z) {
            const uint32_t* pr = payload + (size_t)jr * PL::kWords;
            bin[u] = (int)rows[(size_t)pr[0] * width + g0 + fi];
            if constexpr (kQ8) {
              w[u] = pr[PL::kStat];
            } else {
              const long long* sv =
                  reinterpret_cast<const long long*>(pr + PL::kStat);
              for (int k = 0; k < kStats; ++k) v[u][k] = sv[k];
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if ((unsigned)bin[u] >= (unsigned)b) continue;   // b: skipped
          unsigned* cell = plane + ((size_t)fi * row_cells + bin[u] * kStats)
                                   * kWords;
          if constexpr (kQ8) {
            for (int k = 0; k < kStats; ++k)
              atomicAdd(reinterpret_cast<int*>(cell) + k,
                        (int)(int8_t)(uint8_t)(w[u] >> (8 * k)));
          } else {
            for (int k = 0; k < kStats; ++k)
              add_split(cell + 2 * k, v[u][k]);
          }
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
      const int fr = i / row_cells;
      const size_t at = (size_t)fr * b * kStats + (i - fr * row_cells);
      if constexpr (kQ8) {
        const int v = (int)plane[i];
        if (v != 0) {
          plane[i] = 0;
          atomicAdd(dst + at, v);
        }
      } else {
        const unsigned long long v =
            ((unsigned long long)plane[2 * i + 1] << 32) + plane[2 * i];
        if (v != 0) {
          plane[2 * i] = 0;
          plane[2 * i + 1] = 0;
          atomicAdd(dst + at, v);
        }
      }
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------ cluster form
namespace cg = cooperative_groups;

// One row's three values added to the cell `cell` of a plane, local or in
// another CTA of the cluster (a generic address from map_shared_rank): in
// q8 the three int32 `q`, in f32 the three fixed-point int64 `v` (one
// 64-bit atomic each, no value returned). Zero values add nothing.
template <bool kQ8>
__device__ __forceinline__ void cluster_add(unsigned* cell, const int* q,
                                            const long long* v) {
  for (int k = 0; k < kStats; ++k) {
    if constexpr (kQ8) {
      if (q[k]) atomicAdd(reinterpret_cast<int*>(cell) + k, q[k]);
    } else {
      if (v[k])
        atomicAdd(reinterpret_cast<unsigned long long*>(cell) + k,
                  (unsigned long long)v[k]);
    }
  }
}

// The lanes in `act` that add to one cell (`key`) merge their values
// first, so a cell that skewed bins send many lanes to takes one atomic a
// stat (integer sums: exact in any order; the f32 values summed mod 2^64
// as three 32-bit sums of their 16-bit pieces and high words). Called by
// the lanes of `act` alone; returns whether this lane adds, with its
// group's sums in q (q8) or v (f32).
template <bool kQ8>
__device__ __forceinline__ bool warp_merge(unsigned act, int key, int* q,
                                           long long* v) {
  const unsigned peers = __match_any_sync(act, key);
  if (__popc(peers) == 1) return true;
  for (int k = 0; k < kStats; ++k) {
    if constexpr (kQ8) {
      q[k] = __reduce_add_sync(peers, q[k]);
    } else {
      const unsigned long long u = (unsigned long long)v[k];
      const unsigned b0 = __reduce_add_sync(peers, (unsigned)(u & 0xffffu));
      const unsigned b1 =
          __reduce_add_sync(peers, (unsigned)((u >> 16) & 0xffffu));
      const unsigned hi = __reduce_add_sync(peers, (unsigned)(u >> 32));
      v[k] = (long long)(((unsigned long long)hi << 32)
                         + ((unsigned long long)b1 << 16) + b0);
    }
  }
  return (int)(threadIdx.x & 31) == __ffs(peers) - 1;
}

// A CTA's own bins flushed: each nonzero cell of its [bs][3] plane added
// to the integer sums at `dst` (the plane's first bin), and with `zero`
// cleared for the next slot.
template <bool kQ8>
__device__ __forceinline__ void cluster_flush(
    unsigned* plane, typename Mode<kQ8>::Acc* __restrict__ dst, int cells,
    bool zero) {
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    if constexpr (kQ8) {
      const int v = (int)plane[i];
      if (v != 0) {
        if (zero) plane[i] = 0;
        atomicAdd(dst + i, v);
      }
    } else {
      unsigned long long* cell =
          reinterpret_cast<unsigned long long*>(plane) + i;
      const unsigned long long v = *cell;
      if (v != 0) {
        if (zero) *cell = 0;
        atomicAdd(dst + i, v);
      }
    }
  }
}

// Full form past one block's plane. A 1-D cluster along x of C CTAs holds
// feature blockIdx.x / C; CTA rank k owns bins [k*span, k*span + span).
// Grid row y is the cluster's rows [y*per, y*per + per) of the n rows; its
// CTAs take them in chunks of 32 * kUnroll rows a warp, CTA k's warp w
// the chunks k*warps + w, k*warps + w + C*warps, ... Lane i of a chunk
// reads rows base + 32u + i: the leaf id, the stats and the feature's bin
// from the feature-major `binsT` (coalesced); a row of leaf `target` adds
// its stats (f32: converted once to the launch's fixed point) to the
// owner's cell, the lanes of a warp that add to one cell merged first.
// Shared memory: the CTA's [span][3] cells (int64 in f32, int32 in q8).
// accum [f][b][3], zeroed by the caller.
template <bool kQ8, typename Bin>
__global__ void full_cluster(
    const Bin* __restrict__ binsT, const int32_t* __restrict__ leaf,
    const typename Mode<kQ8>::Stat* __restrict__ stats,
    const unsigned* __restrict__ amax_bits,
    typename Mode<kQ8>::Acc* __restrict__ accum, int n, int b, int target,
    int span, long long per, long long exp_rows) {
  constexpr int kWords = kQ8 ? 1 : 2;                      // words a cell
  extern __shared__ __align__(16) unsigned char clu_smem[];
  __shared__ double scale[kStats];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int feat = blockIdx.x / csize;
  const int lo = rank * span;
  const int cells = max(0, min(span, b - lo)) * kStats;
  unsigned* plane = reinterpret_cast<unsigned*>(clu_smem);
  for (int i = threadIdx.x; i < cells * kWords; i += blockDim.x) plane[i] = 0;
  if (!kQ8 && threadIdx.x < kStats)
    scale[threadIdx.x] = fixed_scale(amax_bits[threadIdx.x], exp_rows);
  cluster.sync();                 // every plane zeroed before a remote add

  const long long r0 = (long long)blockIdx.y * per;
  const long long r1 = min((long long)n, r0 + per);
  const Bin* col = binsT + (size_t)feat * n;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long chunk = 32LL * kUnroll;
  for (long long base = r0 + ((long long)rank * warps + warp) * chunk;
       base < r1; base += (long long)csize * warps * chunk) {
    int lf[kUnroll], bin[kUnroll];
    typename Mode<kQ8>::Stat st[kUnroll][kStats];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = base + 32 * u + lane;
      lf[u] = -1;
      bin[u] = b;
      if (r < r1) {
        lf[u] = leaf[r];
        bin[u] = (int)col[r];
        for (int c = 0; c < kStats; ++c) st[u][c] = stats[r * kStats + c];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool add = lf[u] == target && (unsigned)bin[u] < (unsigned)b;
      const unsigned act = __ballot_sync(0xffffffffu, add);
      if (!add) continue;
      int q[kStats];
      long long v[kStats];
      for (int c = 0; c < kStats; ++c) {
        if constexpr (kQ8)
          q[c] = st[u][c];
        else
          v[c] = __double2ll_rn((double)st[u][c] * scale[c]);
      }
      if (!warp_merge<kQ8>(act, bin[u], q, v)) continue;
      const int owner = bin[u] / span;
      cluster_add<kQ8>(
          cluster.map_shared_rank(plane, owner)
              + (size_t)(bin[u] - owner * span) * kStats * kWords, q, v);
    }
  }
  cluster.sync();                 // every add landed
  cluster_flush<kQ8>(plane, accum + ((size_t)feat * b + lo) * kStats, cells,
                     false);
}

// Gather form past one block's plane: clusters as full_cluster, grid row y
// the cluster's payload rows [y*per, y*per + per) (per_rows, or with 0 per
// >= kMinRows, the rows split evenly over gridDim.y). Its CTAs take each
// slot's rows of the range in turn, thread t of CTA k the rows a + k*T +
// t, a + (k + C)*T + t, ... (T threads a CTA), reading each row's id and
// stats from the payload and the feature's bin from the row-major copy;
// at the slot's end one cluster barrier, the flush of each CTA's bins into
// the slot's sums, and a second barrier before the next slot's adds.
// accum [active][f][b][3], zeroed by the caller.
template <bool kQ8, typename Bin>
__global__ void gather_cluster(const uint32_t* __restrict__ payload,
                               const Bin* __restrict__ rows,
                               const int* __restrict__ counts,
                               typename Mode<kQ8>::Acc* __restrict__ accum,
                               int f, int b, int active, int width, int span,
                               long long per_rows) {
  using PL = Payload<kQ8>;
  constexpr int kWords = kQ8 ? 1 : 2;                      // words a cell
  extern __shared__ __align__(16) unsigned char clu_smem[];
  __shared__ int g_off[kMaxSlots + 1];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int feat = blockIdx.x / csize;
  const int lo = rank * span;
  const int cells = max(0, min(span, b - lo)) * kStats;
  unsigned* plane = reinterpret_cast<unsigned*>(clu_smem);
  warp_scan_slots(counts, g_off, active);
  for (int i = threadIdx.x; i < cells * kWords; i += blockDim.x) plane[i] = 0;
  cluster.sync();                 // every plane zeroed before a remote add
  const long long total = g_off[active];
  long long per = per_rows;
  if (per <= 0) {
    per = (total + gridDim.y - 1) / gridDim.y;
    per = per > kMinRows ? per : kMinRows;
  }
  const long long j0 = (long long)blockIdx.y * per;
  const long long j1 = min(total, j0 + per);
  if (j0 >= j1) return;           // the whole cluster: one row range
  const long long step = (long long)csize * blockDim.x;
  for (int c = 0; c < active; ++c) {
    const long long a = max(j0, (long long)g_off[c]);
    const long long z = min(j1, (long long)g_off[c + 1]);
    if (a >= z) continue;
    for (long long j = a + (long long)rank * blockDim.x + threadIdx.x; j < z;
         j += kUnroll * step) {
      int bin[kUnroll];
      uint32_t w[kUnroll];
      long long v[kUnroll][kStats];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long jr = j + u * step;
        bin[u] = b;
        if (jr < z) {
          const uint32_t* pr = payload + (size_t)jr * PL::kWords;
          bin[u] = (int)rows[(size_t)pr[0] * width + feat];
          if constexpr (kQ8) {
            w[u] = pr[PL::kStat];
          } else {
            const long long* sv =
                reinterpret_cast<const long long*>(pr + PL::kStat);
            for (int k = 0; k < kStats; ++k) v[u][k] = sv[k];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool add = (unsigned)bin[u] < (unsigned)b;
        const unsigned act = __ballot_sync(__activemask(), add);
        if (!add) continue;
        int q[kStats];
        if constexpr (kQ8)
          for (int k = 0; k < kStats; ++k)
            q[k] = (int)(int8_t)(uint8_t)(w[u] >> (8 * k));
        if (!warp_merge<kQ8>(act, bin[u], q, v[u])) continue;
        const int owner = bin[u] / span;
        cluster_add<kQ8>(
            cluster.map_shared_rank(plane, owner)
                + (size_t)(bin[u] - owner * span) * kStats * kWords, q, v[u]);
      }
    }
    cluster.sync();               // the slot's adds landed
    cluster_flush<kQ8>(plane,
                       accum + (((size_t)c * f + feat) * b + lo) * kStats,
                       cells, true);
    cluster.sync();               // zeroed before the next slot's adds
  }
}

// The launch geometry of an accumulate kernel (ops/cuda_hist.py
// launch_shape): features a block, bins a CTA's plane holds (`span`) and
// the CTAs of a cluster they cut B into (1: no cluster), rows a block or
// cluster (0 = one wave of blocks, or `ygrid` cluster rows) and threads a
// block.
struct Geo {
  int group, span, cluster;
  long long per;
  int ygrid, threads;
};

// Shared memory of a cluster CTA: its [span][3] cells (no staged rows: a
// row goes from its loads to its adds).
inline size_t cluster_smem(bool q8, int span) {
  return (size_t)span * kStats * (q8 ? 4 : 8);
}

// A kernel launched as clusters of g.cluster CTAs along x (the grid's x a
// multiple of it), with its dynamic shared memory raised to `smem`.
template <typename... Exp, typename... Act>
cudaError_t launch_clustered(void (*kernel)(Exp...), dim3 grid, int threads,
                             size_t smem, int cluster, cudaStream_t st,
                             Act&&... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Act&&>(args)...);
}

// Clusters of `cluster` CTAs of `threads` threads and `smem` bytes the card
// holds at once (cudaOccupancyMaxActiveClusters; 0: none can be placed).
template <typename... Exp>
int active_clusters(void (*kernel)(Exp...), int cluster, int threads,
                    size_t smem) {
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) != cudaSuccess)
    return -1;
  return clusters;
}

// The full form's accumulate launch of one mode past one block's plane:
// clusters over f features x ceil(n / per) row ranges (per from the
// geometry, or n cut into g.ygrid ranges), rows read from the
// feature-major `binsT`.
template <bool kQ8, typename Bin>
int launch_full_cluster(const Bin* binsT, const void* leaf, const void* stats,
                        const unsigned* amax_bits, void* accum, int n, int f,
                        int b, int target, const Geo& g, long long exp_rows,
                        cudaStream_t st) {
  using M = Mode<kQ8>;
  if constexpr (sizeof(Bin) == 1) {
    return (int)cudaErrorInvalidValue;   // 256 bins fit any block
  } else {
  long long per = g.per > 0 ? g.per
                            : ((long long)n + (g.ygrid > 0 ? g.ygrid : 1) - 1)
                                  / (g.ygrid > 0 ? g.ygrid : 1);
  per = (per + 31) / 32 * 32;
  const long long ys = ((long long)n + per - 1) / per;
  const dim3 grid((unsigned)(f * g.cluster), (unsigned)(ys > 0 ? ys : 1));
  const size_t smem = cluster_smem(kQ8, g.span);
  const int32_t* lf = static_cast<const int32_t*>(leaf);
  const typename M::Stat* sv = static_cast<const typename M::Stat*>(stats);
  return (int)launch_clustered(full_cluster<kQ8, Bin>, grid, g.threads,
                               smem, g.cluster, st, binsT, lf, sv, amax_bits,
                               static_cast<typename M::Acc*>(accum), n, b,
                               target, g.span, per, exp_rows);
  }
}

// The full form's accumulate launch of one mode where a feature group's
// planes fit a block.
template <bool kQ8, typename Bin>
int launch_full_form(const Bin* rows, const void* leaf, const void* stats,
                     const unsigned* amax_bits, void* accum, int n, int f,
                     int b, int target, int width, const Geo& g,
                     long long exp_rows, cudaStream_t st) {
  using M = Mode<kQ8>;
  auto kernel = full_accumulate<kQ8, Bin>;
  const size_t smem = (size_t)g.group * b * kStats * (kQ8 ? 4 : 8)
                      + (size_t)g.threads * (Staged<kQ8>::kWords + 1) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long ys = (long long)((f + g.group - 1) / g.group);
  long long per = g.per;
  if (per <= 0) {
    int occ = 1;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, g.threads,
                                                  smem);
    const long long wave = (long long)device_sms() * (occ > 0 ? occ : 1);
    long long blocks = (wave + ys - 1) / ys;
    const long long most = ((long long)n + kMinRows - 1) / kMinRows;
    blocks = blocks < most ? blocks : most;
    blocks = blocks > 0 ? blocks : 1;
    per = ((long long)n + blocks - 1) / blocks;
  }
  per = (per + 31) / 32 * 32;
  const long long xs = ((long long)n + per - 1) / per;
  kernel<<<dim3((unsigned)(xs > 0 ? xs : 1), (unsigned)ys), g.threads, smem,
           st>>>(rows, static_cast<const int32_t*>(leaf),
                 static_cast<const typename M::Stat*>(stats), amax_bits,
                 static_cast<typename M::Acc*>(accum), n, f, b, target,
                 width, g.group, per, exp_rows);
  return (int)cudaGetLastError();
}

// The full form's accumulate + convert launches of one mode (one computed
// slot, `slot`, whose leaf is `target`; slot -1: none computed, the convert
// alone writes zeros; `dp`: the f64 convert); returns cudaGetLastError().
// With a cluster, `rows` is the feature-major binsT.
template <bool kQ8, typename Bin>
int launch_full(const Bin* rows, const void* leaf, const void* stats,
                const unsigned* amax_bits, void* accum, void* out, int n,
                int f, int p, int b, int slot, int target, int width,
                const Geo& g, bool dp, long long exp_rows, bool raw,
                cudaStream_t st) {
  if (slot >= 0) {
    const int err =
        g.cluster > 1
            ? launch_full_cluster<kQ8, Bin>(rows, leaf, stats, amax_bits,
                                            accum, n, f, b, target, g,
                                            exp_rows, st)
            : launch_full_form<kQ8, Bin>(rows, leaf, stats, amax_bits, accum,
                                         n, f, b, target, width, g, exp_rows,
                                         st);
    if (err != 0) return err;
  }
  return launch_reduce(kQ8, dp, raw, accum, nullptr, slot, amax_bits, out,
                       p, f, b, exp_rows, st);
}

// gather_accumulate of one form over the payload: one wave of blocks
// (per 0) or ceil(m / per) blocks a grid row; past one block's plane,
// gather_cluster over f features x g.ygrid cluster rows (or ceil(m / per)).
template <bool kQ8, typename Bin>
cudaError_t launch_accumulate(const uint32_t* payload, const Bin* rows,
                              const int* counts, void* accum, int f, int m,
                              int b, int active, int width, const Geo& g,
                              int sms, cudaStream_t st) {
  using Acc = typename Mode<kQ8>::Acc;
  if constexpr (sizeof(Bin) > 1) {
  if (g.cluster > 1) {
    const long long ys = g.per > 0 ? ((long long)m + g.per - 1) / g.per
                                   : (g.ygrid > 0 ? g.ygrid : 1);
    const dim3 grid((unsigned)(f * g.cluster), (unsigned)(ys > 0 ? ys : 1));
    const size_t smem = cluster_smem(kQ8, g.span);
    return launch_clustered(gather_cluster<kQ8, Bin>, grid, g.threads, smem,
                            g.cluster, st, payload, rows, counts,
                            static_cast<Acc*>(accum), f, b, active, width,
                            g.span, g.per);
  }
  }
  auto kernel = gather_accumulate<kQ8, Bin>;
  const size_t asmem = (size_t)g.group * b * kStats * (kQ8 ? 4 : 8);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)asmem);
  if (err != cudaSuccess) return err;
  const long long ys = (long long)((f + g.group - 1) / g.group);
  long long xs;
  if (g.per > 0) {
    xs = ((long long)m + g.per - 1) / g.per;
  } else {
    int occ = 1;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, g.threads,
                                                  asmem);
    const long long awave = (long long)sms * (occ > 0 ? occ : 1);
    xs = (awave + ys - 1) / ys;
  }
  kernel<<<dim3((unsigned)(xs > 0 ? xs : 1), (unsigned)ys), g.threads, asmem,
           st>>>(payload, rows, counts, static_cast<Acc*>(accum), f, b,
                 active, width, g.group, g.per);
  return cudaGetLastError();
}

// The gather form's four launches (count, scatter, accumulate, convert) of
// one mode (`dp`: the f64 convert), after the scratch memset; returns
// cudaGetLastError().
template <bool kQ8, typename Bin>
int launch_gather(const Bin* rows, const void* leaf, const void* stats,
                  const int32_t* slotmap, const void* idx,
                  const unsigned* amax_bits, int* counts, uint32_t* payload,
                  void* accum, void* out, int n, int f, int m, int p, int b,
                  int l, int active, int width, const Geo& g, int tile,
                  bool dp, long long exp_rows, bool raw, cudaStream_t st) {
  using M = Mode<kQ8>;
  const int sms = device_sms();
  const int32_t* slot_of = slotmap;
  const int32_t* comp = slotmap + l;
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const int32_t* lf = static_cast<const int32_t*>(leaf);

  const long long cblocks = ((long long)m + kThreads * kUnroll - 1)
                            / (kThreads * kUnroll);
  gather_count<<<(int)(cblocks < 2 * sms ? cblocks : 2 * sms), kThreads, 0,
                 st>>>(ix, lf, slot_of, counts, n, m, l, active);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t ssmem = (size_t)tile * (Payload<kQ8>::kWords + 1) * 4;
  err = cudaFuncSetAttribute(gather_scatter<kQ8>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)ssmem);
  if (err != cudaSuccess) return (int)err;
  int occ = 1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, gather_scatter<kQ8>,
                                                tile, ssmem);
  const long long sblocks = ((long long)m + tile - 1) / tile;
  const long long swave = (long long)sms * (occ > 0 ? occ : 1);
  gather_scatter<kQ8><<<(int)(sblocks < swave ? sblocks : swave), tile,
                        ssmem, st>>>(
      lf, static_cast<const typename M::Stat*>(stats), slot_of, ix,
      amax_bits, counts, payload, n, m, l, active, exp_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = launch_accumulate<kQ8, Bin>(payload, rows, counts, accum, f, m, b,
                                    active, width, g, sms, st);
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(kQ8, dp, raw, accum, comp, 0, amax_bits, out, p, f, b,
                       exp_rows, st);
}

void launch_absmax(const void* stats, void* amax_bits, int n,
                   cudaStream_t st) {
  const int ablocks = (int)(((long long)n + 255) / 256 < 1024
                                ? ((long long)n + 255) / 256 : 1024);
  stat_absmax<<<ablocks > 0 ? ablocks : 1, 256, 0, st>>>(
      static_cast<const float*>(stats), static_cast<unsigned*>(amax_bits), n);
}

// The full form of one mode and bin type, after the scratch memset and
// stat_absmax.
template <typename Bin>
int full_mode(bool q8, bool dp, const void* rows, const void* leaf,
              const void* stats, void* amax_bits, int compute_amax,
              void* accum, void* out, int n, int f, int p, int b, int slot,
              int target, int width, const Geo& g, long long exp_rows,
              bool raw, cudaStream_t st) {
  const Bin* rw = static_cast<const Bin*>(rows);
  if (q8)
    return launch_full<true, Bin>(rw, leaf, stats, nullptr, accum, out, n,
                                  f, p, b, slot, target, width, g, false,
                                  exp_rows, false, st);
  if (compute_amax) {
    launch_absmax(stats, amax_bits, n, st);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return launch_full<false, Bin>(rw, leaf, stats,
                                 static_cast<const unsigned*>(amax_bits),
                                 accum, out, n, f, p, b, slot, target, width,
                                 g, dp, exp_rows, raw, st);
}

// The gather form of one mode and bin type, after the scratch memset and
// stat_absmax.
template <typename Bin>
int gather_mode(bool q8, bool dp, const void* rows, const void* leaf,
                const void* stats, const int32_t* sm, const void* idx,
                void* amax_bits, int compute_amax, int* cn, uint32_t* pl,
                void* accum, void* out, int n, int f, int m, int p, int b,
                int l, int active, int width, const Geo& g, int tile,
                long long exp_rows, bool raw, cudaStream_t st) {
  const Bin* rw = static_cast<const Bin*>(rows);
  if (q8)
    return launch_gather<true, Bin>(rw, leaf, stats, sm, idx, nullptr, cn,
                                    pl, accum, out, n, f, m, p, b, l, active,
                                    width, g, tile, false, exp_rows, false,
                                    st);
  if (compute_amax) {
    launch_absmax(stats, amax_bits, n, st);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return launch_gather<false, Bin>(rw, leaf, stats, sm, idx,
                                   static_cast<const unsigned*>(amax_bits),
                                   cn, pl, accum, out, n, f, m, p, b, l,
                                   active, width, g, tile, dp, exp_rows, raw,
                                   st);
}

// A launch's geometry from the entry points' arguments; an impossible one
// is refused (cudaErrorInvalidValue) before anything runs.
bool make_geo(int f, int b, int bin_bytes, int group, int span, int cluster,
              long long per, int ygrid, int threads, Geo* g) {
  *g = Geo{group, span, cluster, per, ygrid, threads};
  return group >= 1 && span >= 1 && cluster >= 1 && cluster <= kMaxCluster
         && (long long)span * cluster >= b
         && (long long)span * (cluster - 1) < b && threads >= 32
         && threads <= kThreads && threads % 32 == 0 && group <= threads
         && (cluster == 1 || (group == 1 && bin_bytes > 1))
         && per >= 0 && ygrid >= 0 && f >= 1;
}

}  // namespace

// Full-row form of a tile with one computed slot, `slot` (leaf `target`),
// `q8` != 0 for the q8 mode, `bin_bytes` the bin type's size (1 uint8, 2
// the 16-bit bins, 4 the 32-bit ones), `dp` != 0 for the f64 mode (float
// stats, double `out`; not with q8). Returns cudaGetLastError() (0 =
// launched). `rows` the bins row-major, n * `width` elements of the bin
// type (feature f of row r at r * width + f); `stats` n * 3 floats (f32) or
// int8 (q8); `amax_bits` 3 words, the float32 max|stat| of each channel,
// or (`compute_amax` != 0) 3 words of the scratch that stat_absmax fills
// (f32 mode only); `scratch` `scratch_bytes` bytes, zeroed here, holding
// `accum` (f * b * 3 int64 in f32 mode, int32 in q8) and stat_absmax's
// words; `out` p * f * b * 3 float32 (f32), double (f64), int32 (q8) or,
// with `raw` != 0 (the integer-planes mode of the f32 mode), int64 sums
// left unconverted. The geometry: `group` features share a block, whose
// plane holds `span` bins of each, B cut into the `cluster` CTAs of a
// cluster past one block's plane (then `rows` is the feature-major binsT,
// f * n elements, and the clusters' rows `per` each, or n cut into `ygrid`
// ranges), `per` rows a block (0: one wave), `threads` a block.
// `exp_rows` is the row count the fixed-point exponent is taken over (n
// for a pass of its own; the gang's rows when several ranks' planes are
// to be added).
extern "C" int hist_full_launch(const void* rows, const void* leaf,
                                const void* stats, void* amax_bits,
                                int compute_amax, void* scratch,
                                long long scratch_bytes, void* accum,
                                void* out, int q8, int bin_bytes, int dp,
                                int n, int f, int p, int b, int slot,
                                int target, int group, int span, int cluster,
                                long long per, int ygrid, int threads,
                                int width, long long exp_rows, int raw,
                                void* stream) {
  Geo g;
  if (!make_geo(f, b, bin_bytes, group, span, cluster, per, ygrid, threads,
                &g))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(scratch, 0, (size_t)scratch_bytes, st);
  if (err != cudaSuccess) return (int)err;
  if (bin_bytes == 4)
    return full_mode<uint32_t>(q8 != 0, dp != 0, rows, leaf, stats,
                               amax_bits, compute_amax, accum, out, n, f, p,
                               b, slot, target, width, g, exp_rows, raw != 0,
                               st);
  if (bin_bytes == 2)
    return full_mode<uint16_t>(q8 != 0, dp != 0, rows, leaf, stats,
                               amax_bits, compute_amax, accum, out, n, f, p,
                               b, slot, target, width, g, exp_rows, raw != 0,
                               st);
  return full_mode<uint8_t>(q8 != 0, dp != 0, rows, leaf, stats, amax_bits,
                            compute_amax, accum, out, n, f, p, b, slot,
                            target, width, g, exp_rows, raw != 0, st);
}

// Gather form over idx[m] (entries outside [0, n) are padding; a null idx
// is the implicit rung 0..m-1, the full form of a tile with several
// computed slots), `q8`, `bin_bytes`, `dp` and the geometry as
// hist_full_launch (`per` 0: one wave of accumulate blocks, or with a
// cluster `ygrid` cluster rows over the payload). `rows` the
// bins row-major, n * `width` elements of the bin type (feature f of row
// r at r * width + f); `slotmap` l + p int32: each leaf's compact slot
// (-1: not computed), then each slot's compact index (-1: none);
// `amax_bits` as hist_full_launch (f32 mode only); `scratch`
// `scratch_bytes` bytes, zeroed here, holding `counts` (2 * active int32),
// `accum` (active * f * b * 3 int64 in f32 mode, int32 in q8) and, with
// `compute_amax`, `amax_bits`; `payload` m * 8 (f32) or m * 2 (q8) words;
// `out` p * f * b * 3 float32 (f32), double (f64), int32 (q8) or int64
// (`raw`, as hist_full_launch). The scatter stages `tile` rung entries a
// block (a multiple of 32). `exp_rows` as hist_full_launch (m for a pass
// of its own).
extern "C" int hist_gather_launch(const void* rows, const void* leaf,
                                  const void* stats, const void* slotmap,
                                  const void* idx, void* amax_bits,
                                  int compute_amax, void* scratch,
                                  long long scratch_bytes, void* counts,
                                  void* payload, void* accum, void* out,
                                  int q8, int bin_bytes, int dp, int n, int f,
                                  int m, int p, int b, int l, int active,
                                  int group, int span, int cluster,
                                  long long per, int ygrid, int threads,
                                  int width, int tile, long long exp_rows,
                                  int raw, void* stream) {
  Geo g;
  if (!make_geo(f, b, bin_bytes, group, span, cluster, per, ygrid, threads,
                &g))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(scratch, 0, (size_t)scratch_bytes, st);
  if (err != cudaSuccess) return (int)err;
  const int32_t* sm = static_cast<const int32_t*>(slotmap);
  int* cn = static_cast<int*>(counts);
  uint32_t* pl = static_cast<uint32_t*>(payload);
  if (bin_bytes == 4)
    return gather_mode<uint32_t>(q8 != 0, dp != 0, rows, leaf, stats, sm,
                                 idx, amax_bits, compute_amax, cn, pl, accum,
                                 out, n, f, m, p, b, l, active, width, g,
                                 tile, exp_rows, raw != 0, st);
  if (bin_bytes == 2)
    return gather_mode<uint16_t>(q8 != 0, dp != 0, rows, leaf, stats, sm,
                                 idx, amax_bits, compute_amax, cn, pl, accum,
                                 out, n, f, m, p, b, l, active, width, g,
                                 tile, exp_rows, raw != 0, st);
  return gather_mode<uint8_t>(q8 != 0, dp != 0, rows, leaf, stats, sm, idx,
                              amax_bits, compute_amax, cn, pl, accum, out, n,
                              f, m, p, b, l, active, width, g, tile,
                              exp_rows, raw != 0, st);
}

// The integer-planes mode's convert: `acc` `cells` * 3 int64 fixed-point
// sums (planes of [P, F, B, 3]), their exponent from `amax_bits` (3 float
// words) and `rows`, to `out` float32 or (`dp` != 0) double. Returns
// cudaGetLastError().
extern "C" int hist_convert_launch(const void* acc, const void* amax_bits,
                                   void* out, long long cells,
                                   long long rows, int dp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long want = (cells * kStats + 255) / 256;
  const int blocks = (int)(want < 65535 ? (want > 0 ? want : 1) : 65535);
  const long long* a = static_cast<const long long*>(acc);
  const unsigned* k = static_cast<const unsigned*>(amax_bits);
  if (dp)
    hist_convert<double><<<blocks, 256, 0, st>>>(
        a, k, static_cast<double*>(out), cells, rows);
  else
    hist_convert<float><<<blocks, 256, 0, st>>>(
        a, k, static_cast<float*>(out), cells, rows);
  return (int)cudaGetLastError();
}

// Clusters of the cluster form the card holds at once for the accumulate
// kernel of a pass (`full` != 0 the full form's, else the gather form's;
// `q8`, `bin_bytes` 2 or 4) at `cluster` CTAs of `threads` threads and
// `span` bins: written to `clusters` (0: the card cannot place one).
// Returns the cudaError of the query.
extern "C" int hist_cluster_occupancy(int full, int q8, int bin_bytes,
                                      int cluster, int span, int threads,
                                      int* clusters) {
  const size_t smem = cluster_smem(q8 != 0, span);
  int got;
  if (full)
    got = q8 ? (bin_bytes == 4
                    ? active_clusters(full_cluster<true, uint32_t>,
                                      cluster, threads, smem)
                    : active_clusters(full_cluster<true, uint16_t>,
                                      cluster, threads, smem))
             : (bin_bytes == 4
                    ? active_clusters(full_cluster<false, uint32_t>,
                                      cluster, threads, smem)
                    : active_clusters(full_cluster<false, uint16_t>,
                                      cluster, threads, smem));
  else
    got = q8 ? (bin_bytes == 4
                    ? active_clusters(gather_cluster<true, uint32_t>,
                                      cluster, threads, smem)
                    : active_clusters(gather_cluster<true, uint16_t>,
                                      cluster, threads, smem))
             : (bin_bytes == 4
                    ? active_clusters(gather_cluster<false, uint32_t>,
                                      cluster, threads, smem)
                    : active_clusters(gather_cluster<false, uint16_t>,
                                      cluster, threads, smem));
  if (got < 0) {
    *clusters = 0;
    const int err = (int)cudaGetLastError();
    return err != 0 ? err : (int)cudaErrorInvalidConfiguration;
  }
  *clusters = got;
  return 0;
}
