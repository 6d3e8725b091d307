// hist_onehot.cu -- the feature-grouped one-hot histogram on the tensor
// cores (bf16 in, f32 accumulation), on Hopper's wgmma and TMA.
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
// 23x the function's, whatever the kernel does. This kernel measures the
// one-hot form, so the tensor-core floor is its target.
//
// Design. The output rows of a feature group (its fg*B one-hot columns)
// are cut into tiles of 256 rows; a block owns one tile and a chunk of the
// data rows, which it walks 64 rows (one stage) at a time:
//   - warpgroups 0 and 1 (consumers) each own 128 of the tile's rows as
//     two 64-row halves, each half one wgmma m64n128k16 accumulator of
//     64 f32 registers a thread. The one-hot is wgmma's A operand in
//     registers, built straight from the staged bins: a thread's fragment
//     holds rows (feature, bin) it knows from its place in the warpgroup,
//     and one compare a byte sets each 0 / 1 bf16. It never touches shared
//     memory. Each 16-row step issues four wgmmas (two halves x the hi
//     and the lo 128 lanes of rhs, both into the SAME accumulator: that is
//     the fold, and it lets a warpgroup keep 128 rows in the registers one
//     64 x 256 accumulator would take, so a block reads rhs for 256 rows);
//   - warpgroup 2 (the producer; one thread) keeps a ring of 4 stages in
//     flight with TMA: the stage's [64, 256] rhs rows as four 64-column
//     boxes in the 128-byte swizzle wgmma reads (B, MN-major), and the
//     bins of the tile's features, each stage under a full and an empty
//     mbarrier;
//   - one block a tile: clusters of 2 blocks sharing each rhs stage by
//     TMA multicast measured ~1.5x slower on the card (PERF.md).
// Blocks run in parallel and in no order, so each (tile, chunk) writes its
// partial tile to a [chunk, tile, 256, 128] buffer and a second launch sums
// the chunks in chunk order: the result is the same bits every run. The
// chunk count fills whole waves of one block per SM.
// What `fg` and `blk` set: `fg` (features per group) sets the padding of a
// group's one-hot rows to whole 256-row tiles, and so which features a tile
// meets; `blk` (rows per block) sets nothing in the kernel: the script pads
// the rows to a multiple of it, and the chunks are whole 64-row stages.
// On the TPU `fg` and `blk` size the resident output and the one-hot of a
// grid step.
//
// Numerics: each product of a one-hot 0/1 and a bf16 value is exact in
// f32; only the order of the f32 additions differs from the plain version
// and the TPU (and the tensor cores' f32 accumulation need not round each
// addition as IEEE does), so the plain comparison is within a tolerance
// relative to the summed magnitudes.

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int kKT = 64;                 // data rows a stage
constexpr int kStages = 4;
constexpr int kTileRows = 256;          // output rows a block
constexpr int kLanes = 128;             // folded output lanes
constexpr int kRhs = 256;               // rhs lanes (hi/lo halves)
constexpr int kBoxCols = 64;            // rhs columns a TMA box (128 bytes)
constexpr int kBoxBytes = kKT * kBoxCols * 2;       // 8 KB
constexpr int kRhsStage = kKT * kRhs * 2;           // 32 KB, four boxes
constexpr int kConsumers = 2;           // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
// wgmma B descriptor strides (MN-major, 128-byte swizzle): the next 64
// columns are the next box; the next 8 data rows are 1024 bytes on
constexpr uint32_t kLbo = kBoxBytes, kSbo = 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

// wait for the phase of parity `parity` to complete; a stage that never
// arrives (a fault) traps after ~10 s instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (int i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (i == 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
        "r"(c1) : "memory");
}

// wgmma shared-memory descriptor of a B tile at `addr` (128-byte swizzle)
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(kLbo >> 4) << 16)
         | (static_cast<uint64_t>(kSbo >> 4) << 32)
         | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// d[64 x 128] += a[64 x 16] (registers, bf16) * B[16 x 128] (smem, bf16);
// B is MN-major (an rhs row is 16 data rows' K, its lanes N contiguous):
// imm-trans-b = 1
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// two bins (bytes 0 and 1 of `v`) against `pat` (the row's bin in both
// bytes): the pair of bf16 one-hot entries, 1.0 = 0x3F80, masked by `live`
__device__ __forceinline__ uint32_t onehot_pair(uint32_t v, uint32_t pat,
                                                uint32_t live) {
  const uint32_t eq = __vcmpeq4(v, pat);          // 0xFF per equal byte
  return __byte_perm(eq, 0u, 0x1100) & live;
}

struct Geometry {
  int f, b, fg, tiles_per_group, nf_box;
  long long rows_per_chunk, n;
};

__global__ void __launch_bounds__(kThreads, 1)
hist_onehot_kernel(const __grid_constant__ CUtensorMap rhs_map,
                   const __grid_constant__ CUtensorMap bins_map,
                   float* __restrict__ partial, const Geometry g,
                   int bins_stage) {
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment for the 128-byte swizzle
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* rhs_s = smem;
  uint8_t* bins_s = smem + kStages * kRhsStage;
  uint64_t* bars = reinterpret_cast<uint64_t*>(bins_s + kStages * bins_stage);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + kStages);

  const int tile = blockIdx.x;
  const int group = tile / g.tiles_per_group;
  const int m0 = (tile % g.tiles_per_group) * kTileRows;   // group-local
  const int j0 = m0 / g.b;                  // first feature the tile meets
  const int feats = min(g.fg, g.f - group * g.fg);
  const long long r0 = (long long)blockIdx.y * g.rows_per_chunk;
  const long long r1 = min(g.n, r0 + g.rows_per_chunk);
  const int nst = (int)((r1 - r0 + kKT - 1) / kKT);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == kConsumers * 128) {
      const uint32_t bytes = kRhsStage + g.nf_box * kKT;
      for (int s = 0; s < nst; ++s) {
        const int st = s % kStages;
        mbar_wait(empty0 + 8 * st, ((s / kStages) & 1) ^ 1);
        const uint32_t full = full0 + 8 * st;
        mbar_expect_tx(full, bytes);
        const int row = (int)(r0 + (long long)s * kKT);
        const uint32_t dst = smem_u32(rhs_s + st * kRhsStage);
        for (int box = 0; box < kRhs / kBoxCols; ++box)
          tma_load(dst + box * kBoxBytes, &rhs_map, box * kBoxCols, row,
                   full);
        tma_load(smem_u32(bins_s + st * bins_stage), &bins_map, row,
                 group * g.fg + j0, full);
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    // this thread's four one-hot rows: half h (64 rows), +0 / +8
    int boff[2][2];
    uint32_t pat[2][2], live[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + wg * 128 + h * 64 + warp * 16 + lane / 4 + 8 * e;
        const int j = m / g.b;
        const int bin = m - j * g.b;
        const bool ok = j < feats;
        boff[h][e] = ok ? (j - j0) * kKT : 0;
        pat[h][e] = (uint32_t)bin * 0x0101u;
        live[h][e] = ok ? 0x3F803F80u : 0u;
      }
    const int col = (lane % 4) * 2;     // the fragment's data-row pair

    float acc[2][64];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;

    for (int s = 0; s < nst; ++s) {
      const int st = s % kStages;
      mbar_wait(full0 + 8 * st, (s / kStages) & 1);
      __syncwarp();   // wgmma wants the warp converged
      const uint8_t* bins = bins_s + st * bins_stage;
      const uint32_t b0 = smem_u32(rhs_s + st * kRhsStage);
#pragma unroll
      for (int kk = 0; kk < kKT / 16; ++kk) {
        // A fragments: {row, cols c..c+1}, {row+8, c..c+1}, {row, c+8..},
        // {row+8, c+8..}
        uint32_t a[2][4];
        const int c = kk * 16 + col;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const uint8_t* p = bins + boff[h][e] + c;
            const uint32_t lo = *reinterpret_cast<const uint16_t*>(p);
            const uint32_t hi = *reinterpret_cast<const uint16_t*>(p + 8);
            a[h][e] = onehot_pair(lo, pat[h][e], live[h][e]);
            a[h][2 + e] = onehot_pair(hi, pat[h][e], live[h][e]);
          }
        wgmma_fence();
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            wgmma_m64n128k16(acc[h], a[h],
                             b_desc(b0 + half * 2 * kBoxBytes + kk * 2048));
        wgmma_commit();
        wgmma_wait<1>();
        if (kk == 0 && s > 0) {
          // every wgmma of the previous stage has completed: free it
          __syncwarp();
          if (lane == 0) mbar_arrive(empty0 + 8 * ((s - 1) % kStages));
        }
      }
    }
    wgmma_wait<0>();
    // accumulator element i: row lane/4 (+8 for i%4 >= 2) of the warp's
    // 16, column 8*(i/4) + 2*(lane%4) + i%2
    float* out = partial + (((size_t)blockIdx.y * gridDim.x + tile)
                            * kTileRows) * kLanes;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wg * 128 + h * 64 + warp * 16 + lane / 4;
#pragma unroll
      for (int i = 0; i < 64; i += 4) {
        const int q = 8 * (i / 4) + col;
        *reinterpret_cast<float2*>(out + (size_t)row * kLanes + q) =
            make_float2(acc[h][i], acc[h][i + 1]);
        *reinterpret_cast<float2*>(out + (size_t)(row + 8) * kLanes + q) =
            make_float2(acc[h][i + 2], acc[h][i + 3]);
      }
    }
  }
}

// out[(g*fg + j)*B + bin, q] = sum over chunks, in chunk order, of the
// partial row j*B + bin of group g.
__global__ void hist_onehot_reduce(const float* __restrict__ partial,
                                   float* __restrict__ out, int f, int b,
                                   int fg, int tiles_per_group, int ntiles,
                                   int nchunk) {
  const long long rows = (long long)f * b;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < rows * kLanes; e += (long long)gridDim.x * blockDim.x) {
    const long long row = e / kLanes;
    const int q = (int)(e % kLanes);
    const int fe = (int)(row / b);
    const int grp = fe / fg;
    const long long prow = (long long)grp * tiles_per_group * kTileRows
                           + (long long)(fe - grp * fg) * b + row % b;
    float acc = 0.f;
    for (int c = 0; c < nchunk; ++c)
      acc += partial[((long long)c * ntiles * kTileRows + prow) * kLanes
                     + q];
    out[e] = acc;
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in the libcuda the process has loaded
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!h) h = dlopen("libcuda.so.1", RTLD_NOW);
    if (h) fn = reinterpret_cast<EncodeTiled>(
        dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

}  // namespace

// The shared memory a launch needs for `nf_box` bins rows a stage.
extern "C" int hist_onehot_smem(int nf_box) {
  const int bins_stage = (nf_box * kKT + 1023) / 1024 * 1024;
  return 1024 + kStages * (kRhsStage + bins_stage) + 2 * kStages * 8;
}

// Returns a cudaError_t (0 = launched). `partial` holds nchunk * ntiles
// * 256 * 128 floats, `out` f * b * 128. n must be a multiple of 16 (the bins' row stride for TMA),
// binsT and rhs 16-byte aligned.
extern "C" int hist_onehot_launch(const void* binsT, const void* rhs,
                                  void* partial, void* out, int f,
                                  long long n, int b, int fg,
                                  int tiles_per_group, int ntiles,
                                  int nchunk, long long rows_per_chunk,
                                  int nf_box, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  EncodeTiled encode = encoder();
  if (!encode) return (int)cudaErrorSharedObjectSymbolNotFound;
  CUtensorMap rhs_map, bins_map;
  {
    const cuuint64_t dims[2] = {(cuuint64_t)kRhs, (cuuint64_t)n};
    const cuuint64_t strides[1] = {(cuuint64_t)kRhs * 2};
    const cuuint32_t box[2] = {kBoxCols, kKT};
    const cuuint32_t estr[2] = {1, 1};
    if (encode(&rhs_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
               const_cast<void*>(rhs), dims, strides, box, estr,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  {
    const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)f};
    const cuuint64_t strides[1] = {(cuuint64_t)n};
    const cuuint32_t box[2] = {kKT, (cuuint32_t)nf_box};
    const cuuint32_t estr[2] = {1, 1};
    if (encode(&bins_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
               const_cast<void*>(binsT), dims, strides, box, estr,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  const int smem = hist_onehot_smem(nf_box);
  cudaError_t err = cudaFuncSetAttribute(
      hist_onehot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  Geometry g{f, b, fg, tiles_per_group, nf_box, rows_per_chunk, n};
  hist_onehot_kernel<<<dim3(ntiles, nchunk), kThreads, smem, st>>>(
      rhs_map, bins_map, static_cast<float*>(partial), g,
      (nf_box * kKT + 1023) / 1024 * 1024);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long cells = (long long)f * b * kLanes;
  const long long want = (cells + 255) / 256;
  hist_onehot_reduce<<<(int)(want < 65535 ? want : 65535), 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), f, b, fg,
      tiles_per_group, ntiles, nchunk);
  return (int)cudaGetLastError();
}
