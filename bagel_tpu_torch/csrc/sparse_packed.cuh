// Pieces shared by the block-sparse packed attention kernels of this
// directory: the forward (sparse_packed_attention.cu) and its gradient
// (sparse_packed_attention_bwd.cu). Both walk 128 x 128 tiles of a table
// built on the host (ops/sparse_flash.py kernel_tables), keep bf16 operands
// in shared memory in the layouts wgmma's descriptors read, and apply the
// packed predicate from per-token ids.
//
// A tile of ROWS rows of a [*, D] bf16 operand (Tile below):
// - columns 0..63 (D = 72) or 0..127 (D = 128) in 64-column regions of
//   128-byte rows, written by TMA with the 128-byte swizzle (box 64 x ROWS);
// - D = 72's columns 64..71 in a plain region of 16-byte rows (TMA box
//   8 x ROWS, no swizzle: wgmma's "interleave" layout of 8 x 8 core
//   matrices), then a region of zeros standing for columns 72..79, written
//   once by the block and never by TMA, so that a product over the head dim
//   runs over a depth of 80 (five k16 steps).

#pragma once

#include <cuda_bf16.h>
#include <math.h>

#include "hopper.cuh"

namespace sparse {

using namespace hopper;

constexpr int kBK = 128;           // keys (and query rows) per table tile
constexpr int kFullTile = 1 << 30; // table entry flag: every pair of the tile is visible
constexpr int kRegionCols = 64;    // bf16 columns of a 128-byte swizzled row

constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The packed predicate: query i (ids di, fi, ni) sees key j (dj, fj, nj):
// same_doc & (i >= j | same_fan) & !other_noise. RowIds::sees spells the
// same test out on the query's own ids: ptxas schedules the two spellings
// differently, and each kernel takes the one it measured faster with (the
// forward sees(), the backward visible(); NVIDIA H100 80GB HBM3, PERF.md §6).
__device__ __forceinline__ bool visible(int i, int di, int fi, int ni, int j, int dj, int fj,
                                        int nj) {
  return di != 0 && di == dj && (i >= j || (fi >= 0 && fi == fj)) && !(nj >= 0 && ni != nj);
}

// The ids of one token (ids past S read as padding: document 0, fan and
// noise -1).
struct RowIds {
  int pos, doc, fan, noise;
  __device__ __forceinline__ void load(int p, int S, const int* d, const int* f, const int* n) {
    pos = p;
    doc = p < S ? d[p] : 0;
    fan = p < S ? f[p] : -1;
    noise = p < S ? n[p] : -1;
  }
  // this token as the query: does it see key (j, dk, fk, nk)?
  __device__ __forceinline__ bool sees(int j, int dk, int fk, int nk) const {
    return doc != 0 && doc == dk && (pos >= j || (fan >= 0 && fan == fk)) &&
           !(nk >= 0 && noise != nk);
  }
};

template <int D, int ROWS>
struct Tile {
  static_assert(D == 72 || D == 128, "instantiated head dims");
  static constexpr int kRegions = D / kRegionCols;      // swizzled column regions
  static constexpr bool kTail = D % kRegionCols != 0;   // D = 72: columns 64..71
  static constexpr int kRegion = ROWS * 128;            // bytes of a region
  static constexpr int kTailBytes = ROWS * 16;          // one 8-column chunk
  static constexpr int kTailOff = kRegions * kRegion;
  static constexpr int kZeroOff = kTailOff + kTailBytes;
  static constexpr int kBytes = kTailOff + (kTail ? 2 * kTailBytes : 0);
  static constexpr uint32_t kTx = kTailOff + (kTail ? kTailBytes : 0);  // bytes TMA delivers
  static constexpr int kChunks = 8 * kRegions + (kTail ? 1 : 0);      // 16-byte chunks a row
  static constexpr int kOMain = 32 * kRegions;  // f32 accumulators of an N = D product's main part
  static_assert(kBytes % 1024 == 0, "tiles stay 1024-byte aligned (the swizzle's period)");

  // the 16-byte chunk c (0 .. kChunks - 1) of row `row`
  static __device__ __forceinline__ unsigned char* chunk(unsigned char* t, int row, int c) {
    return c < 8 * kRegions ? t + (c / 8) * kRegion + row * 128 + (c % 8) * 16
                            : t + kTailOff + row * 16;
  }
  // the zero chunk of D = 72 (columns 72..79), written once
  static __device__ __forceinline__ void zero_tail(unsigned char* t, int tid, int nthreads) {
    if (kTail) {
      const uint4 zero = make_uint4(0, 0, 0, 0);
      for (int c = tid; c < kTailBytes / 16; c += nthreads)
        reinterpret_cast<uint4*>(t + kZeroOff)[c] = zero;
    }
  }
  // rows r0 .. r0 + ROWS - 1 of head h from a tensor map and its tail map
  static __device__ __forceinline__ void load(unsigned char* t, const CUtensorMap* map,
                                              const CUtensorMap* tail, uint32_t bar, int h,
                                              int r0) {
#pragma unroll
    for (int r = 0; r < kRegions; ++r)
      tma_load_3d(t + r * kRegion, map, bar, r * kRegionCols, h, r0);
    if (kTail) tma_load_3d(t + kTailOff, tail, bar, kRegionCols, h, r0);
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x 8, f32) += A (64 x 16, bf16 registers) * B (16 x 8, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n8(float (&d)[4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, f32) (+)= A (64 x 16, bf16, smem, K-major) * B (16 x 64, bf16, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// acc (64 x 64, f32) = A B^T over the head dim: A the 64 rows a_row.. of
// tile a (ROWS_A rows), B the 64 rows b_row.. of tile b (ROWS_B rows), both
// K-major (issued and committed, not waited)
template <int D, int ROWS_A, int ROWS_B>
__device__ __forceinline__ void issue_abt(float (&acc)[32], uint32_t a, int a_row, uint32_t b,
                                          int b_row) {
  using TA = Tile<D, ROWS_A>;
  using TB = Tile<D, ROWS_B>;
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < (D + 15) / 16; ++ks) {
    uint64_t da, db;
    if (ks < 4 * TA::kRegions) {  // 128-byte swizzled, K-major: 32 B a k16 step
      const int r = ks / 4, kk = ks % 4;
      da = make_desc(a + r * TA::kRegion + a_row * 128 + kk * 32, 16, 1024, kSwizzle128);
      db = make_desc(b + r * TB::kRegion + b_row * 128 + kk * 32, 16, 1024, kSwizzle128);
    } else {  // D = 72's columns 64..79: interleave, K-major, chunks of 8 columns
      da = make_desc(a + TA::kTailOff + a_row * 16, TA::kTailBytes, 128, kInterleave);
      db = make_desc(b + TB::kTailOff + b_row * 16, TB::kTailBytes, 128, kInterleave);
    }
    wgmma_ss_n64(acc, da, db, ks > 0);
  }
  wgmma_commit();
}

// om/ot (64 x D, f32) += P B: P 64 x 16 KS from registers (k16 step ks in
// pa[ks], the re-packed accumulators of a 64 x 16 KS product), B the rows
// b_row .. b_row + 16 KS - 1 of tile b (ROWS rows), MN-major (issued, not
// committed)
template <int D, int ROWS, int KS>
__device__ __forceinline__ void issue_pb(float (&om)[Tile<D, ROWS>::kOMain], float (&ot)[4],
                                         const uint32_t (&pa)[KS][4], uint32_t b, int b_row) {
  using T = Tile<D, ROWS>;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    // 128-byte swizzled, MN-major: 16 rows of 128 B a step; the next 8 rows
    // 1024 B on (SBO), the next 64 columns a region on (LBO)
    const uint64_t db = make_desc(b + (b_row + 16 * ks) * 128, T::kRegion, 1024, kSwizzle128);
    if constexpr (T::kRegions == 2) {
      wgmma_bf16_rs(om, pa[ks], db);
    } else {
      wgmma_rs_n64(om, pa[ks], db);
    }
    if constexpr (T::kTail) {  // columns 64..71: interleave, MN-major, 16 B a row
      wgmma_rs_n8(ot, pa[ks], make_desc(b + T::kTailOff + (b_row + 16 * ks) * 16, 128, 128,
                                        kInterleave));
    }
  }
}

// --- host side ---------------------------------------------------------------

// A [rows, heads, D] bf16 view with element strides (st, sh, 1), boxes of
// box_cols x 1 x box_rows; 128-byte swizzle or none. Reads past D or rows
// give zeros.
inline int make_view_map(CUtensorMap* map, const void* base, int D, int heads, int rows,
                         long long st, long long sh, int box_cols, int box_rows, bool swizzle) {
  return make_map<3>(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, {D, heads, rows},
                     {sh * 2, st * 2}, {box_cols, 1, box_rows}, swizzle);
}

}  // namespace sparse
