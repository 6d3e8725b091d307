// hist_onehot.cu -- the feature-grouped one-hot histogram on the tensor
// cores (bf16 in, f32 accumulation).
//
// Replaces `kernel` in make_variant (scripts/exp_hist_variants.py:22,
// pallas_call :44), the experiment script's variant of the hi/lo kernel:
//   out[f*B + b, q] = sum over rows r of [binsT[f, r] == b]
//                     * (rhs[r, q] + rhs[r, q + 128]),   q < 128,
// with binsT [F, N] uint8, rhs [N, 256] bf16 (a hi/lo pair of 128 lanes),
// out [F*B, 128] f32. The TPU kernel builds, per block of `blk` rows and
// group of `fg` features, the [blk, fg*B] bf16 one-hot, contracts it with
// the rhs block on the MXU in f32, folds the two 128-lane halves and adds
// into the resident output.
//
// What bounds it on an H100. The function itself needs ~1.08 GB moved
// (bins and rhs read once, out written once: 0.32 ms at 3.35 TB/s) and
// N*(F+1)*128 f32 adds (0.11 ms at 67 TFLOP/s) at N=2M, F=28, B=255, so
// its least time is set by bytes. The one-hot form does 2*N*F*B*256 bf16
// products on the tensor cores (7.3e12: 7.4 ms at the data sheet's 989
// TFLOP/s), nearly all of them by a zero of the one-hot: that floor is
// 23x the function's, whatever the kernel does.
//
// Design: the output rows of a feature group (its fg*B one-hot columns,
// padded to a multiple of 128) are cut into tiles of 128 rows; a block
// owns one (group, row tile) pair and a contiguous chunk of whole
// blk-row blocks, and walks the chunk 32 rows at a time:
//   1. it zeroes the [128 x 32] bf16 one-hot of its tile rows in shared
//      memory (row m of the tile is feature g*fg + m / B, bin m % B) and
//      sets one 1 per (feature, data row) from the bins -- a few dozen
//      byte reads a step, not 4096 compares -- beside the [32 x 256] rhs
//      rows, which were prefetched into registers (16-byte loads) while
//      the previous step ran; both tiles' rows are padded by 16 bytes so a
//      fragment's rows fall on different banks;
//   2. eight warps, 16 tile rows each, run nvcuda::wmma bf16 16x16x16
//      products into eight f32 accumulator fragments (128 folded lanes):
//      the low and the high half of each lane tile go into the SAME
//      accumulator, which is the fold.
// Blocks run in parallel and in no order, so the chunks' partial tiles
// go to a [chunk, group, 128-padded rows, 128] buffer and a second launch
// sums them in chunk order: the result is the same bits every run.
// `fg` (features per group) and `blk` (rows per block) keep their names
// but set little here: `fg` only the padding of a group's one-hot rows to
// whole 128-row tiles, `blk` only the edges of the row chunks (rows are
// dealt in whole blk-row blocks; N is a multiple of blk, as the script
// pads it). So the script's four variants time the same work, within 2%
// of each other; on the TPU `fg` and `blk` size the resident output and
// the one-hot of a grid step. The chunk count gives about two blocks per
// SM.
//
// Numerics: each product of a one-hot 0/1 and a bf16 value is exact in
// f32; only the order of the f32 additions differs from the plain version
// and the TPU (and the tensor cores' f32 accumulation need not round each
// addition as IEEE does), so the plain comparison is within a tolerance
// relative to the summed magnitudes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kTileRows = 128;   // output rows (feature-bin pairs) a block
constexpr int kLanes = 128;      // folded output lanes
constexpr int kRhs = 256;        // rhs lanes (hi/lo halves)
constexpr int kStep = 32;        // data rows per shared-memory step
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// shared-memory row strides, padded by 8 bf16 (16 bytes) so the rows of a
// 16x16 fragment fall on different banks
constexpr int kLdA = kStep + 8;
constexpr int kLdB = kRhs + 8;
constexpr int kVec = kRhs * 2 / 16;              // 16-byte vectors a row
constexpr int kVecPerThread = kStep * kVec / kThreads;

__global__ void __launch_bounds__(kThreads)
hist_onehot_kernel(const uint8_t* __restrict__ binsT,
                   const __nv_bfloat16* __restrict__ rhs,
                   float* __restrict__ partial, int f, long long n, int b,
                   int fg, int tiles_per_group, int ngroups,
                   long long rows_per_chunk) {
  __shared__ __align__(32) __nv_bfloat16 onehot[kTileRows * kLdA];
  __shared__ __align__(32) __nv_bfloat16 rhs_s[kStep * kLdB];
  const int tile = blockIdx.x % tiles_per_group;
  const int group = blockIdx.x / tiles_per_group;
  const int chunk = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int feats = min(fg, f - group * fg);     // the last group may be short
  // the features whose one-hot rows meet this tile: [j0, j1)
  const int m0 = tile * kTileRows;
  const int j0 = m0 / b;
  const int j1 = min(feats, (m0 + kTileRows - 1) / b + 1);
  const int items = (j1 > j0 ? j1 - j0 : 0) * kStep;
  const long long r0 = (long long)chunk * rows_per_chunk;
  const long long r1 = min(n, r0 + rows_per_chunk);
  const __nv_bfloat16 one = __ushort_as_bfloat16(0x3F80);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kLanes / 16];
  for (int j = 0; j < kLanes / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
  using RowMajor = wmma::row_major;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, RowMajor> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, RowMajor> bl;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, RowMajor> bh;

  // the rhs rows of the next step, prefetched into registers while the
  // tensor cores work on the current one
  uint4 nxt[kVecPerThread];
  auto prefetch = [&](long long r) {
    const uint4* src = reinterpret_cast<const uint4*>(rhs + r * kRhs);
    for (int i = 0; i < kVecPerThread; ++i) {
      const int v = threadIdx.x + i * kThreads;
      nxt[i] = r + v / kVec < r1 ? src[v] : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  if (r0 < r1) prefetch(r0);

  for (long long r = r0; r < r1; r += kStep) {
    // 1. a zero one-hot tile, and the prefetched rhs rows in place
    uint4* oh4 = reinterpret_cast<uint4*>(onehot);
    for (int v = threadIdx.x; v < kTileRows * kLdA * 2 / 16; v += kThreads)
      oh4[v] = make_uint4(0u, 0u, 0u, 0u);
    for (int i = 0; i < kVecPerThread; ++i) {
      const int v = threadIdx.x + i * kThreads;
      *reinterpret_cast<uint4*>(rhs_s + (v / kVec) * kLdB + (v % kVec) * 8) =
          nxt[i];
    }
    __syncthreads();
    // 2. one 1 per (feature, row): row r + k of feature j sets tile row
    //    j * B + bin - m0 when that falls in the tile
    for (int it = threadIdx.x; it < items; it += kThreads) {
      const int j = j0 + it / kStep;
      const int k = it % kStep;
      if (r + k >= r1) continue;
      const int m = j * b + binsT[(size_t)(group * fg + j) * n + r + k] - m0;
      if (m >= 0 && m < kTileRows && m < (j + 1) * b - m0)
        onehot[m * kLdA + k] = one;
    }
    if (r + kStep < r1) prefetch(r + kStep);
    __syncthreads();
    // 3. the tensor-core products; both halves into one accumulator
    for (int ks = 0; ks < kStep / 16; ++ks) {
      wmma::load_matrix_sync(a, onehot + warp * 16 * kLdA + ks * 16, kLdA);
      for (int j = 0; j < kLanes / 16; ++j) {
        const __nv_bfloat16* bp = rhs_s + ks * 16 * kLdB + j * 16;
        wmma::load_matrix_sync(bl, bp, kLdB);
        wmma::load_matrix_sync(bh, bp + kLanes, kLdB);
        wmma::mma_sync(acc[j], a, bl, acc[j]);
        wmma::mma_sync(acc[j], a, bh, acc[j]);
      }
    }
    __syncthreads();
  }
  // partial layout [chunk][group][tiles_per_group * 128][128]
  float* out = partial + (((size_t)chunk * ngroups + group) * tiles_per_group
                          + tile) * kTileRows * kLanes;
  for (int j = 0; j < kLanes / 16; ++j)
    wmma::store_matrix_sync(out + (size_t)warp * 16 * kLanes + j * 16, acc[j],
                            kLanes, wmma::mem_row_major);
}

// out[(g*fg + j)*B + bin, q] = sum over chunks, in chunk order, of the
// partial row j*B + bin of group g.
__global__ void hist_onehot_reduce(const float* __restrict__ partial,
                                   float* __restrict__ out, int f, int b,
                                   int fg, int tiles_per_group, int ngroups,
                                   int nchunk) {
  const long long rows = (long long)f * b;
  const long long padded = (long long)tiles_per_group * kTileRows;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < rows * kLanes; e += (long long)gridDim.x * blockDim.x) {
    const long long row = e / kLanes;
    const int q = (int)(e % kLanes);
    const int fe = (int)(row / b);
    const int g = fe / fg;
    const long long prow = (long long)(fe - g * fg) * b + row % b;
    float acc = 0.f;
    for (int c = 0; c < nchunk; ++c)
      acc += partial[(((long long)c * ngroups + g) * padded + prow) * kLanes
                     + q];
    out[e] = acc;
  }
}

}  // namespace

// Returns cudaGetLastError() (0 = launched). `partial` holds nchunk *
// ngroups * tiles_per_group * 128 * 128 floats, `out` f * b * 128.
extern "C" int hist_onehot_launch(const void* binsT, const void* rhs,
                                  void* partial, void* out, int f,
                                  long long n, int b, int fg,
                                  int tiles_per_group, int ngroups,
                                  int nchunk, long long rows_per_chunk,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(ngroups * tiles_per_group, nchunk);
  hist_onehot_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const uint8_t*>(binsT),
      static_cast<const __nv_bfloat16*>(rhs), static_cast<float*>(partial),
      f, n, b, fg, tiles_per_group, ngroups, rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long cells = (long long)f * b * kLanes;
  const long long want = (cells + 255) / 256;
  hist_onehot_reduce<<<(int)(want < 65535 ? want : 65535), 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), f, b, fg,
      tiles_per_group, ngroups, nchunk);
  return (int)cudaGetLastError();
}
