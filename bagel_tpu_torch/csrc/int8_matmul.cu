// w8a8 matmul for Hopper: int8 activations x int8 weights -> int32, then the
// per-token and per-column scales (and an optional bias) in f32; and the
// per-token activation quantization that feeds it.
//
// int8_matmul_kernel replaces the TPU kernels
// bagel_tpu/ops/int8_matmul.py:_kernel_onek and :_kernel (reached from
// int8_matmul, :64). It computes
//
//   out[m,n] = bf16( ((f32(sum_k xq[m,k] * wq[k,n]) * xs[m]) * ws[n]) + b[n] )
//
// or, in its f32 instance, the same value before the one rounding to bf16
// (a tp rank's partial sum of a row-parallel leaf, rounded once after the
// all-reduce as JAX rounds the whole int32 sum's product); with each f32
// step rounded on its own (__fmul_rn / __fadd_rn: nvcc would
// otherwise contract a*b+c into one FMA), the order of
// bagel_tpu/models/qwen2.py:_linear's w8a8 branch. The int32 sums are
// exact, so the result equals the plain version bit for bit.
//
// quantize_rows_kernel is the per-token quantization of that branch
// (bagel_tpu/models/qwen2.py:146-148, XLA's work in the JAX package):
//   xs[m] = max(max_k |x[m,k]|, 1e-12) / 127,
//   xq[m,k] = clamp(round_half_even(x[m,k] / xs[m]), -127, 127),
// with IEEE division (__fdiv_rn) and round-to-nearest-even
// (__float2int_rn): bit-identical to the JAX expression. One block per row
// reads the bf16 row, takes its absmax, and reads it again (from L1) to
// write the codes: bound by the bytes it moves (2K in, K + 4 out a row).
// Its two halves are kernels of their own for a row split over tensor
// parallelism, where JAX's max runs over the whole row (XLA reduces it
// across the shards): row_absmax_kernel writes each row's absmax of this
// rank's slice (2K in, 4 out), the caller all-reduces it with MAX and makes
// the scale as the plain version does, and quantize_rows_given_kernel
// writes the codes with the scales it is given (2K + 4 in, K out).
//
// Layout: xq [M, K] int8 row-major; wq [K, N] int8 K-MAJOR, i.e. the JAX
// [in, out] leaf as a transposed view of a contiguous [N, K] tensor, made
// once at load (utils/quant.py:to_kmajor); xs [M] f32, ws [N] f32, b [N]
// f32 or null, out [M, N] bf16. Any M; K and N multiples of 16 (TMA's
// 16-byte strides); ragged M, N and K come from TMA's zero fill.
//
// What bounds it on an H100 (1,979 TOPS int8 dense, 3.35 TB/s): at the
// 1024 px denoise shapes (M = 3 x 4096, K, N ~ 3584-18944) 2MNK operations
// against MK + KN + 2MN bytes is ~4000 op/byte: compute-bound (the gate
// projection, 1.67e12 ops, is 0.84 ms at the peak).
//
// Design (Hopper's: TMA, mbarriers, warp specialization, wgmma):
// - A block computes a 128 x 256 output tile: two consumer warpgroups of
//   64 rows, each on wgmma.mma_async m64n256k32 .s32.s8.s8 with both
//   operands in shared memory, and one producer warp (in a third
//   warpgroup, which gives its registers away with setmaxnreg).
// - wgmma takes 8-bit operands only K-major (the transpose bits are for
//   16-bit types), hence the k-major weight: both the xq tile (128 x 128
//   bytes) and the weight tile (256 x 128 bytes) are rows of 128 k bytes
//   with the 128-byte swizzle that TMA writes and the descriptor reads;
//   a k32 step moves the descriptor 32 bytes along the row. No tile is
//   transposed in the kernel.
// - The producer keeps a ring of 4 stages (48 KB each) in flight, each
//   completed on a "full" mbarrier by TMA's byte count; the consumers keep
//   one stage's wgmma group in flight and release the stage before it on
//   its "empty" mbarrier.
// - Output tiles are rasterized in groups of 16 M tiles, so that the
//   blocks resident together share their xq and weight tiles in L2.
// - The epilogue is the plain version's: ((f32(acc) * xs) * ws) + b, each
//   step rounded, then bf16 (or stored as f32 by the f32 instance).
//
// What it leaves on the table: no persistent grid (the epilogue does not
// overlap the next tile's loads), no TMA store of the output, one block an
// SM (the 196 KB ring).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBM = 128;                 // output rows a block: two consumer warpgroups of 64
constexpr int kBN = 256;                 // output columns a block: one m64n256 wgmma
constexpr int kBK = 128;                 // k bytes a stage: one 128-byte swizzled row
constexpr int kStages = 4;
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer's warpgroup
constexpr int kABytes = kBM * kBK;       // 16 KB
constexpr int kBBytes = kBN * kBK;       // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 128;  // alignment slack, ring, barriers
constexpr int kGroupM = 16;              // M tiles of a raster group
constexpr int kQThreads = 256;           // quantize_rows_kernel: threads a row

struct Maps {  // TMA tensor maps of xq [M, K] and of the k-major weight [N, K]
  CUtensorMap a, b;
};

// d (64 x 256, s32) += A (64 x 32, s8, smem, K-major) * B (32 x 256, s8, smem, K-major)
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// --- the GEMM --------------------------------------------------------------

// two neighbouring output values: rounded to bf16, or kept in f32
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
int8_matmul_kernel(const __grid_constant__ Maps maps, const float* __restrict__ xs,
                   const float* __restrict__ ws, const float* __restrict__ bias,
                   OutT* __restrict__ out, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows of 128 B
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t bars = smem_addr(smem + kStages * kStageBytes);
  auto full_bar = [&](int s) { return bars + 8 * s; };
  auto empty_bar = [&](int s) { return bars + 8 * (kStages + s); };

  // this block's output tile, in raster groups of kGroupM M tiles
  const int tiles_m = (M + kBM - 1) / kBM, tiles_n = (N + kBN - 1) / kBN;
  const int per_group = kGroupM * tiles_n;
  const int first_m = (blockIdx.x / per_group) * kGroupM;
  const int group_m = min(tiles_m - first_m, kGroupM);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % group_m) * kBM;
  const int n0 = (in_group / group_m) * kBN;
  const int n_k = (K + kBK - 1) / kBK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar(s), 1);                   // the producer, with TMA's bytes
      mbar_init(empty_bar(s), kConsumers * 128);   // every consumer thread
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {
    // ---- producer: one thread of the last warpgroup, which gives its
    // registers to the consumers (40 + 2 x 232 per thread of each) ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 4 * kConsumers && lane == 0) {
      for (int it = 0; it < n_k; ++it) {
        const int s = it % kStages;
        mbar_wait(empty_bar(s), ((it / kStages) & 1) ^ 1);  // the first round passes
        unsigned char* st = smem + s * kStageBytes;
        mbar_arrive_expect_tx(full_bar(s), kStageBytes);  // boxes count whole, zero fill too
        tma_load_2d(st, &maps.a, full_bar(s), it * kBK, m0);
        tma_load_2d(st + kABytes, &maps.b, full_bar(s), it * kBK, n0);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg takes output rows m0 + 64 wg .. + 63 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = warp / 4;
  int acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;

  for (int it = 0; it < n_k; ++it) {
    const int s = it % kStages;
    mbar_wait(full_bar(s), (it / kStages) & 1);
    const uint32_t a = smem_addr(smem + s * kStageBytes) + wg * 64 * kBK;
    const uint32_t b = smem_addr(smem + s * kStageBytes + kABytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)  // k32 steps: 32 bytes along the swizzled rows
      wgmma_s8_n256(acc, make_desc(a + kk * 32, 16, 1024, kSwizzle128),
                    make_desc(b + kk * 32, 16, 1024, kSwizzle128));
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: release it
    if (it > 0) mbar_arrive(empty_bar((it - 1) % kStages));
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue: ((f32(acc) * xs) * ws) + b, each step rounded, then OutT.
  // Accumulator 4 j + e holds row lane/4 (+ 8 for e >= 2) of this warp's
  // 16, column 8 j + 2 (lane % 4) + e % 2.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = m0 + wg * 64 + (warp % 4) * 16 + lane / 4 + 8 * half;
    if (m >= M) continue;
    const float sx = xs[m];
    OutT* orow = out + static_cast<size_t>(m) * N;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (lane % 4);
      if (n >= N) continue;  // N % 16 == 0: n + 1 < N with n
      float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * half]), sx), ws[n]);
      float v1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * half + 1]), sx), ws[n + 1]);
      if (bias != nullptr) {
        v0 = __fadd_rn(v0, bias[n]);
        v1 = __fadd_rn(v1, bias[n + 1]);
      }
      store2(orow + n, v0, v1);
    }
  }
}

// --- the activation quantization ------------------------------------------

enum QuantMode { kWhole, kAbsmaxOnly, kGivenScale };

// One row of x: kWhole its scale (into xs) and codes, kAbsmaxOnly its
// absmax (into xs), kGivenScale its codes with the scale xs[m].
template <QuantMode Mode>
__device__ __forceinline__ void quantize_row(const __nv_bfloat16* __restrict__ x, long long x_st,
                                             int8_t* __restrict__ xq, float* __restrict__ xs,
                                             int K) {
  __shared__ float red[kQThreads / 32];
  const int m = blockIdx.x, tid = threadIdx.x;
  const __nv_bfloat16* row = x + static_cast<long long>(m) * x_st;
  const int chunks = K / 8;  // 16-byte loads of 8 values
  float scale;
  if (Mode == kGivenScale) {
    scale = xs[m];
  } else {
    float amax = 0.f;
    for (int c = tid; c < chunks; c += kQThreads) {
      const uint4 u = *reinterpret_cast<const uint4*>(row + 8 * c);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(p[i]);
        amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if (tid % 32 == 0) red[tid / 32] = amax;
    __syncthreads();
    amax = red[0];
#pragma unroll
    for (int w = 1; w < kQThreads / 32; ++w) amax = fmaxf(amax, red[w]);
    if (Mode == kAbsmaxOnly) {
      if (tid == 0) xs[m] = amax;
      return;
    }
    scale = __fdiv_rn(fmaxf(amax, 1e-12f), 127.f);
    if (tid == 0) xs[m] = scale;
  }
  int8_t* qrow = xq + static_cast<long long>(m) * K;
  for (int c = tid; c < chunks; c += kQThreads) {
    const uint4 u = *reinterpret_cast<const uint4*>(row + 8 * c);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(p[i]);
      const int q0 = max(-127, min(127, __float2int_rn(__fdiv_rn(f.x, scale))));
      const int q1 = max(-127, min(127, __float2int_rn(__fdiv_rn(f.y, scale))));
      packed[i / 2] |= ((static_cast<uint32_t>(q0) & 0xFFu) | ((static_cast<uint32_t>(q1) & 0xFFu) << 8))
                       << (16 * (i % 2));
    }
    *reinterpret_cast<uint2*>(qrow + 8 * c) = make_uint2(packed[0], packed[1]);
  }
}

__global__ void __launch_bounds__(kQThreads)
quantize_rows_kernel(const __nv_bfloat16* __restrict__ x, long long x_st,
                     int8_t* __restrict__ xq, float* __restrict__ xs, int K) {
  quantize_row<kWhole>(x, x_st, xq, xs, K);
}

__global__ void __launch_bounds__(kQThreads)
row_absmax_kernel(const __nv_bfloat16* __restrict__ x, long long x_st,
                  float* __restrict__ amax, int K) {
  quantize_row<kAbsmaxOnly>(x, x_st, nullptr, amax, K);
}

__global__ void __launch_bounds__(kQThreads)
quantize_rows_given_kernel(const __nv_bfloat16* __restrict__ x, long long x_st,
                           const float* __restrict__ xs, int8_t* __restrict__ xq, int K) {
  quantize_row<kGivenScale>(x, x_st, xq, const_cast<float*>(xs), K);
}

// --- host side -------------------------------------------------------------

// an int8 [rows, K] row-major view (a row stride of K bytes), boxes of
// kBK bytes x box_rows rows with the 128-byte swizzle
int make_rows_map(CUtensorMap* map, const void* base, int K, int rows, int box_rows) {
  return make_map<2>(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, base, {K, rows}, {K}, {kBK, box_rows},
                     true, CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
}

template <typename OutT>
int launch_int8_matmul(const void* xq, const void* xs, const void* wq, const void* ws,
                       const void* bias, void* out, int M, int N, int K, void* stream) {
  Maps maps;
  int err = make_rows_map(&maps.a, xq, K, M, kBM);
  err = err ? err : make_rows_map(&maps.b, wq, K, N, kBN);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(int8_matmul_kernel<OutT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  int8_matmul_kernel<OutT><<<blocks, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      maps, static_cast<const float*>(xs), static_cast<const float*>(ws),
      static_cast<const float*>(bias), static_cast<OutT*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns 0 on success, else cudaGetLastError()'s
// code, or 100000 + the CUresult of a refused tensor map. wq points at the
// contiguous [N, K] codes of the k-major weight. out [M, N] bf16.
int int8_matmul_bf16(const void* xq, const void* xs, const void* wq, const void* ws,
                     const void* bias, void* out, int M, int N, int K, void* stream) {
  return launch_int8_matmul<__nv_bfloat16>(xq, xs, wq, ws, bias, out, M, N, K, stream);
}

// The same with out [M, N] f32: the epilogue's value before its rounding.
int int8_matmul_f32(const void* xq, const void* xs, const void* wq, const void* ws,
                    const void* bias, void* out, int M, int N, int K, void* stream) {
  return launch_int8_matmul<float>(xq, xs, wq, ws, bias, out, M, N, K, stream);
}

// x: M rows of K bf16 values, row stride x_st (elements); xq [M, K] int8,
// xs [M] f32. Same return convention.
int quantize_rows_bf16(const void* x, long long x_st, void* xq, void* xs, int M, int K,
                       void* stream) {
  quantize_rows_kernel<<<M, kQThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), x_st, static_cast<int8_t*>(xq),
      static_cast<float*>(xs), K);
  return static_cast<int>(cudaGetLastError());
}

// amax [M] f32: each row's max |x|. Same return convention.
int row_absmax_bf16(const void* x, long long x_st, void* amax, int M, int K, void* stream) {
  row_absmax_kernel<<<M, kQThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), x_st, static_cast<float*>(amax), K);
  return static_cast<int>(cudaGetLastError());
}

// xq [M, K] int8: the codes of x with the scales xs [M] f32 given. Same
// return convention.
int quantize_rows_given_bf16(const void* x, long long x_st, const void* xs, void* xq, int M,
                             int K, void* stream) {
  quantize_rows_given_kernel<<<M, kQThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), x_st, static_cast<const float*>(xs),
      static_cast<int8_t*>(xq), K);
  return static_cast<int>(cudaGetLastError());
}

const char* int8_matmul_error_string(int code) {
  if (code >= kEncodeError)
    return "cuTensorMapEncodeTiled refused a tensor map (code - 100000 is the CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
