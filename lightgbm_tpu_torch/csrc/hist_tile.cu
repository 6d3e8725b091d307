// hist_tile.cu -- the histogram tile pass, deterministic, f32 and q8.
//
// Replaces lightgbm_tpu/ops/pallas_hist.py:
//   _fused_kernel       plane-only full-row form   (idx == nullptr)
//   _gather_kernel      plane-only gather form     (idx[m]; entries >= n
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
// What bounds it on an H100: memory. One pass must read the bin matrix once
// (n*F bytes), the leaf ids and stats once (16*n bytes f32, 7*n bytes q8)
// and write the tile (P*F*B*3*4 bytes); the additions are 3*n*F, far below
// any rate. This design re-reads leaf ids and stats once per feature (and
// once per slot part, below), mostly from L2, so it runs well above that
// bound (PERF.md has the measured times).
//
// Design: the Pallas kernel keeps a [F*B, 128] accumulator resident in VMEM
// across a sequential grid; GPU blocks run in parallel and in no order, and
// 3.7 MB does not fit in shared memory. So the grid is (feature, row chunk,
// slot part): each block privatises ONE feature's plane for a part of the
// tile's computed slots in shared memory, maps leaf -> slot through a table
// in shared memory, and writes its plane to a per-chunk partial buffer; a
// second launch sums the chunk partials.
//
// Determinism, f32 mode: the sums are the same bits from run to run. Each
// stat is added as a 64-bit fixed-point integer, value * 2^k rounded to the
// nearest integer, where k (one per stat channel and launch) is the largest
// that keeps any sum of the pass below 2^61: k = 61 - e with max|stat| *
// rows < 2^e (stat_absmax finds max|stat| first; a max is order-free).
// Integer addition is associative, so neither the shared-memory atomics'
// order nor the chunk split changes a bit, and the one conversion back to
// float32 at the end rounds once. Integer-valued stats (and any stat that
// is a multiple of 2^-k) are summed exactly, so they come out bitwise equal
// to the plain version; float stats come out within 2^-k-ish of the exact
// sum, closer than a float32 sum. A non-finite stat makes its channel NaN.
// The int64 plane is twice a float plane: a slot part holds as many slots
// as fit in the 227 KB a block can have (37 at 255 bins), so a tile of 42
// computed slots runs as two parts.
//
// q8 mode: the stats are int8 already (the grower's stochastic rounding),
// so each is added as it is with 32-bit shared-memory atomics, and the
// chunk partials and the planes are int32. No scale and no stat_absmax
// pass; |sum| <= 127 * rows, which int32 holds up to (2^31 - 1) / 127
// rows (the wrapper checks). The sums are exact, so every launch, every
// chunk split and the plain version give the same planes. The int32 plane
// is half the f32 mode's int64 one: 42 slots at 255 bins take 128.5 KB,
// one slot part.
//
// Numerics on Hopper: `pallas` and `pallas_hilo` are the same here. The
// TPU's `hilo` bf16 hi/lo split is an MXU device; this kernel needs none.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kStats = 3;
constexpr int kThreads = 1024;
constexpr int kMaxExp = 1000;

// Exponent k of the fixed-point scale 2^k for a channel whose largest
// |stat| has float bits `amax_bits`, over `rows` rows; INT_MIN when the
// channel holds a non-finite value.
__device__ int fixed_exponent(unsigned amax_bits, long long rows) {
  const float amax = __uint_as_float(amax_bits);
  if (!isfinite(amax)) return -2147483647 - 1;
  const double bound = (double)amax * (double)rows;
  if (bound == 0.0) return 61;
  int e;
  frexp(bound, &e);                       // bound < 2^e
  const int k = 61 - e;
  return k > kMaxExp ? kMaxExp : (k < -kMaxExp ? -kMaxExp : k);
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

// The two accumulation modes: the stat type, the shared-memory
// accumulator, the chunk-partial type and the output type.
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

// Block (feat, chunk, part): slots of compact index [part*S, part*S + S).
// comp[p] is slot p's compact index among the computed slots (-1: none).
template <bool kQ8>
__global__ void hist_tile_accumulate(
    const uint8_t* __restrict__ binsT, const int32_t* __restrict__ leaf,
    const typename Mode<kQ8>::Stat* __restrict__ stats,
    const int32_t* __restrict__ chan, const int32_t* __restrict__ comp,
    const int32_t* __restrict__ idx, const unsigned* __restrict__ amax_bits,
    typename Mode<kQ8>::Part* __restrict__ partial, int n, int f, int m,
    int p, int b, int l, int nchunk, int active, int per_part) {
  using Acc = typename Mode<kQ8>::Acc;
  using Part = typename Mode<kQ8>::Part;
  extern __shared__ __align__(16) unsigned char hist_smem[];
  Acc* plane = reinterpret_cast<Acc*>(hist_smem);          // [S][b][3]
  int* slot_of_leaf = reinterpret_cast<int*>(plane +
                                             (size_t)per_part * b * kStats);
  __shared__ double scale[kStats];
  const int feat = blockIdx.x;
  const int chunk = blockIdx.y;
  const int c0 = blockIdx.z * per_part;
  const int here = min(per_part, active - c0);
  if (here <= 0) return;
  const int cells = here * b * kStats;

  for (int i = threadIdx.x; i < cells; i += blockDim.x) plane[i] = 0;
  for (int i = threadIdx.x; i < l; i += blockDim.x) slot_of_leaf[i] = -1;
  if (!kQ8 && threadIdx.x < kStats) {
    const int k = fixed_exponent(amax_bits[threadIdx.x], m);
    scale[threadIdx.x] = ldexp(1.0, k == -2147483647 - 1 ? 0 : k);
  }
  __syncthreads();
  if (threadIdx.x < p) {
    const int lf = chan[threadIdx.x * kStats];
    const int c = comp[threadIdx.x] - c0;
    if (lf >= 0 && lf < l && c >= 0 && c < here) slot_of_leaf[lf] = c;
  }
  __syncthreads();

  const long long per = ((long long)m + nchunk - 1) / nchunk;
  const long long r0 = (long long)chunk * per;
  const long long r1 = min((long long)m, r0 + per);
  const uint8_t* col = binsT + (size_t)feat * n;
  for (long long i = r0 + threadIdx.x; i < r1; i += blockDim.x) {
    const int r = idx ? idx[i] : (int)i;
    if (r < 0 || r >= n) continue;                      // gather padding
    const int lf = leaf[r];
    if (lf < 0 || lf >= l) continue;
    const int s = slot_of_leaf[lf];
    if (s < 0) continue;
    const int bin = col[r];
    if (bin >= b) continue;
    Acc* cell = plane + ((size_t)s * b + bin) * kStats;
    const typename Mode<kQ8>::Stat* st = stats + (size_t)r * kStats;
    for (int c = 0; c < kStats; ++c) {
      if constexpr (kQ8) {
        atomicAdd(cell + c, (int)st[c]);
      } else {
        const long long v = __double2ll_rn((double)st[c] * scale[c]);
        atomicAdd(cell + c, (unsigned long long)v);
      }
    }
  }
  __syncthreads();

  // partial layout [chunk][active][f][b][3]
  const int row = b * kStats;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int s = i / row;
    const int rem = i - s * row;
    partial[(((size_t)chunk * active + c0 + s) * f + feat) * row + rem] =
        (Part)plane[i];
  }
}

// out[p][f][b][s] = the chunk partials of slot p's compact index, summed
// as integers; in f32 mode converted to float32 once (0 for a slot with
// none).
template <bool kQ8>
__global__ void hist_tile_reduce(
    const typename Mode<kQ8>::Part* __restrict__ partial,
    const int32_t* __restrict__ comp, const unsigned* __restrict__ amax_bits,
    typename Mode<kQ8>::Out* __restrict__ out, int p, int f, int b, int m,
    int nchunk, int active) {
  const long long per_slot = (long long)f * b * kStats;
  const long long cells = (long long)p * per_slot;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < cells; e += (long long)gridDim.x * blockDim.x) {
    const int slot = (int)(e / per_slot);
    const long long rest = e - slot * per_slot;
    const int c = comp[slot];
    if (c < 0) {
      out[e] = 0;
      continue;
    }
    typename Mode<kQ8>::Part acc = 0;
    for (int ch = 0; ch < nchunk; ++ch)
      acc += partial[((long long)ch * active + c) * per_slot + rest];
    if constexpr (kQ8) {
      out[e] = acc;
    } else {
      const int k = fixed_exponent(amax_bits[rest % kStats], m);
      out[e] = k == -2147483647 - 1
                   ? __int_as_float(0x7fffffff)
                   : (float)((double)acc * ldexp(1.0, -k));
    }
  }
}

// The accumulate + reduce launches of one mode; returns cudaGetLastError().
template <bool kQ8>
int launch_passes(const void* binsT, const void* leaf, const void* stats,
                  const void* chan, const void* comp, const void* idx,
                  const unsigned* amax_bits, void* partial, void* out, int n,
                  int f, int m, int p, int b, int l, int nchunk, int active,
                  int per_part, int nparts, cudaStream_t st) {
  using M = Mode<kQ8>;
  const size_t smem = (size_t)per_part * b * kStats * sizeof(typename M::Acc)
                      + (size_t)l * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      hist_tile_accumulate<kQ8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(f, nchunk, nparts);
  hist_tile_accumulate<kQ8><<<grid, kThreads, smem, st>>>(
      static_cast<const uint8_t*>(binsT), static_cast<const int32_t*>(leaf),
      static_cast<const typename M::Stat*>(stats),
      static_cast<const int32_t*>(chan), static_cast<const int32_t*>(comp),
      static_cast<const int32_t*>(idx), amax_bits,
      static_cast<typename M::Part*>(partial), n, f, m, p, b, l, nchunk,
      active, per_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long cells = (long long)p * f * b * kStats;
  const long long want = (cells + 255) / 256;
  const int blocks = (int)(want < 65535 ? want : 65535);
  hist_tile_reduce<kQ8><<<blocks, 256, 0, st>>>(
      static_cast<const typename M::Part*>(partial),
      static_cast<const int32_t*>(comp), amax_bits,
      static_cast<typename M::Out*>(out), p, f, b, m, nchunk, active);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() (0 = launched). f32 mode: `stats` n * 3
// floats, `amax_bits` 3 zeroed words, `partial` nchunk * active * f * b * 3
// int64, `out` p * f * b * 3 floats; `comp` p int32 compact slot indices;
// grid (f, nchunk, nparts) with `per_part` slots a part.
extern "C" int hist_tile_launch(const void* binsT, const void* leaf,
                                const void* stats, const void* chan,
                                const void* comp, const void* idx,
                                void* amax_bits, void* partial, void* out,
                                int n, int f, int m, int p, int b, int l,
                                int nchunk, int active, int per_part,
                                int nparts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ablocks = (int)(((long long)n + 255) / 256 < 1024
                                ? ((long long)n + 255) / 256 : 1024);
  stat_absmax<<<ablocks > 0 ? ablocks : 1, 256, 0, st>>>(
      static_cast<const float*>(stats), static_cast<unsigned*>(amax_bits), n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_passes<false>(binsT, leaf, stats, chan, comp, idx,
                              static_cast<const unsigned*>(amax_bits),
                              partial, out, n, f, m, p, b, l, nchunk, active,
                              per_part, nparts, st);
}

// q8 mode: `stats` n * 3 int8, `partial` nchunk * active * f * b * 3 int32,
// `out` p * f * b * 3 int32; the rest as hist_tile_launch.
extern "C" int hist_tile_q8_launch(const void* binsT, const void* leaf,
                                   const void* stats, const void* chan,
                                   const void* comp, const void* idx,
                                   void* partial, void* out, int n, int f,
                                   int m, int p, int b, int l, int nchunk,
                                   int active, int per_part, int nparts,
                                   void* stream) {
  return launch_passes<true>(binsT, leaf, stats, chan, comp, idx, nullptr,
                             partial, out, n, f, m, p, b, l, nchunk, active,
                             per_part, nparts,
                             static_cast<cudaStream_t>(stream));
}
