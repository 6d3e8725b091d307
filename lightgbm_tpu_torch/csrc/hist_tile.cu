// hist_tile.cu -- the histogram tile pass of the fused split-finding pipeline.
//
// Replaces (accumulation half of) lightgbm_tpu/ops/pallas_hist.py:
//   _fused_epi_kernel   full-row form  (idx == nullptr)
//   _gather_epi_kernel  gather form    (idx[m]; entries >= n are padding)
// The epilogue half of those kernels is csrc/split_epilogue.cu.
//
// What it computes: out[p, f, b, s] = sum of stats[r, s] over the rows r
// whose leaf id is the leaf of computed slot p (chan[3p], the TPU lane table
// of chan_leaf_table) and whose bin of feature f is b. Derived and inactive
// slots (chan lane < 0) accumulate nothing and come out zero.
//
// What bounds it on an H100: memory. One pass must read the bin matrix once
// (n*F bytes), the leaf ids and stats once (16*n bytes) and write the tile
// (P*F*B*3*4 bytes); the additions are 3*n*F f32 adds, far below the f32
// rate. This first design re-reads leaf and stats once per feature
// (16*n*F bytes, mostly from L2), so it runs well above that bound; a
// design that reads each row once for all features is the next step
// (PERF.md has the measured times).
//
// Design: the Pallas kernel keeps a [F*B, 128] accumulator resident in VMEM
// across a sequential grid; GPU blocks run in parallel and in no order and
// 3.7 MB does not fit in shared memory. So the grid is (feature, row chunk):
// each block privatises ONE feature's [P, B, 3] plane in shared memory
// (<= 42*256*3*4 = 129,024 bytes, above 48 KB only through the dynamic
// shared-memory attribute), maps leaf -> slot through a table in shared
// memory, adds with shared-memory atomics, and writes its plane to a
// per-chunk partial buffer. A second launch sums the chunk partials in a
// fixed order (chunk 0, 1, ...) -- the layout of the reference's
// histogram_16_64_256.cu sub-histograms.
//
// Numerics: f32 throughout, the `highest` semantics. The TPU's `hilo`
// bf16 hi/lo split is an MXU device; here `pallas` and `pallas_hilo` both
// accumulate true f32 (within hilo's documented ~2^-17 bound). Within a
// chunk the shared-memory atomics add in an order that changes from run to
// run, so float sums may differ in the last bits between runs; sums of
// integer-valued stats are exact in any order and come out bitwise equal to
// the plain version (the JAX package's parity contract).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStats = 3;
constexpr int kThreads = 1024;

__global__ void hist_tile_accumulate(const uint8_t* __restrict__ binsT,
                                     const int32_t* __restrict__ leaf,
                                     const float* __restrict__ stats,
                                     const int32_t* __restrict__ chan,
                                     const int32_t* __restrict__ idx,
                                     float* __restrict__ partial,
                                     int n, int f, int m, int p, int b, int l,
                                     int nchunk) {
  extern __shared__ float smem[];
  float* hist = smem;                                   // [p][b][3]
  int* slot_of_leaf = reinterpret_cast<int*>(smem + (size_t)p * b * kStats);
  const int feat = blockIdx.x;
  const int chunk = blockIdx.y;
  const int cells = p * b * kStats;

  for (int i = threadIdx.x; i < cells; i += blockDim.x) hist[i] = 0.f;
  for (int i = threadIdx.x; i < l; i += blockDim.x) slot_of_leaf[i] = -1;
  __syncthreads();
  if (threadIdx.x < p) {
    const int lf = chan[threadIdx.x * kStats];
    if (lf >= 0 && lf < l) slot_of_leaf[lf] = threadIdx.x;
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
    float* cell = hist + ((size_t)s * b + bin) * kStats;
    const float* st = stats + (size_t)r * kStats;
    atomicAdd(cell + 0, st[0]);
    atomicAdd(cell + 1, st[1]);
    atomicAdd(cell + 2, st[2]);
  }
  __syncthreads();

  // partial layout [chunk][p][f][b][3]: the reduce below walks it with the
  // output's own [p][f][b][3] index
  const int plane = b * kStats;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int s = i / plane;
    const int rem = i - s * plane;
    partial[(((size_t)chunk * p + s) * f + feat) * plane + rem] = hist[i];
  }
}

__global__ void hist_tile_reduce(const float* __restrict__ partial,
                                 float* __restrict__ out, long long cells,
                                 int nchunk) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < cells; e += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int c = 0; c < nchunk; ++c) acc += partial[(size_t)c * cells + e];
    out[e] = acc;
  }
}

}  // namespace

// Returns cudaGetLastError() (0 = launched). `partial` holds
// nchunk * p * f * b * 3 floats; `out` p * f * b * 3 floats.
extern "C" int hist_tile_launch(const void* binsT, const void* leaf,
                                const void* stats, const void* chan,
                                const void* idx, void* partial, void* out,
                                int n, int f, int m, int p, int b, int l,
                                int nchunk, void* stream) {
  const size_t smem = (size_t)p * b * kStats * sizeof(float)
                      + (size_t)l * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      hist_tile_accumulate, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(f, nchunk);
  hist_tile_accumulate<<<grid, kThreads, smem, st>>>(
      static_cast<const uint8_t*>(binsT), static_cast<const int32_t*>(leaf),
      static_cast<const float*>(stats), static_cast<const int32_t*>(chan),
      static_cast<const int32_t*>(idx), static_cast<float*>(partial),
      n, f, m, p, b, l, nchunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long cells = (long long)p * f * b * kStats;
  const long long want = (cells + 255) / 256;
  const int blocks = (int)(want < 65535 ? want : 65535);
  hist_tile_reduce<<<blocks, 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), cells,
      nchunk);
  return (int)cudaGetLastError();
}
