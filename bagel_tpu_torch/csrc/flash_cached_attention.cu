// Flash attention of a new query block over a cached KV buffer, for Hopper.
//
// Replaces the TPU kernel bagel_tpu/ops/flash.py:_flash_kernel (reached from
// flash_cached_attention, bagel_tpu/ops/flash.py:279). It computes the same
// function, not the Pallas grid:
//
//   out[b,i,h,:] = sum_j softmax_j(q[b,i,h,:] . k[b,j,h/G,:] * scale) v[b,j,h/G,:]
//   over the keys j < past[b] + (causal ? i + 1 : valid[b]);
//   rows i >= valid[b], and rows with no visible key, are written as 0.
//
// Layout: q/out [B, T, H, 128], k/v [B, S, KH, 128], bf16, addressed through
// their batch/sequence/head strides (no transposes, no padding of a ragged T:
// the tensor maps' row bound masks the edge). past/valid are int32 [B] on the
// device: a block reads its batch row's live bound itself, so there is no
// host read and a call can be captured in a CUDA graph.
//
// A block of T > 1 (flash_cached_attention_kernel):
// - What bounds it on an H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): the work
//   is 4*D*H*sum_b(rows * visible keys) FLOPs. On the 1024 px denoise call
//   (B=3, T=4098, H=28, ~4130 live keys a row) that is ~0.73 TFLOP against
//   ~0.2 GB of q/k/v/o traffic, ~3600 FLOP/byte: it is bound by operations
//   (0.74 ms). Next to the products, each score costs one exp2 on the SFU
//   (16 a clock per SM): ~0.39 ms at that shape, which the two consumer
//   warpgroups hide behind each other's products.
// - Design (Hopper's: TMA, mbarriers, warp specialization, wgmma), the one
//   of sparse_packed_attention.cu at D = 128, over the cache:
//   * A block takes a 128-row query tile of one (batch row, head): two
//     consumer warpgroups of 64 rows each and one producer warp (in a third
//     warpgroup that gives its registers away with setmaxnreg, so the
//     consumers have 232). 128-key tiles.
//   * The producer loads Q once, then each live tile's K and V into a ring
//     of two 64 KB shared-memory stages with TMA (one 4-D tensor map per
//     operand over the strided view, built on the host per call and passed
//     as a __grid_constant__ parameter; 64-column boxes with the 128-byte
//     swizzle), completed on a "full" mbarrier per stage; the consumers
//     release a stage on its "empty" mbarrier.
//   * The block walks only the tiles below its live bound past + valid,
//     capped at the q tile's causal diagonal: the dead tail of a bucketed
//     buffer costs neither loads nor products. A warpgroup whose own rows
//     end earlier (the causal diagonal, or rows past valid) skips the
//     tiles beyond its rows and only releases their stages.
//   * QK^T: wgmma m64n128k16 with Q and K K-major from shared memory. PV:
//     wgmma with P from registers (the S accumulators re-packed as bf16:
//     their layout is the A fragment's) and V MN-major from shared memory
//     (transposed by the descriptor).
//   * A tile that lies wholly below every valid row's bound of the
//     warpgroup skips the per-element mask: at the denoise shape that is
//     every tile but the last live one.
//   * Stale data: TMA zero-fills only past the tensor's extent (S). Keys in
//     [past + valid, S) of the last live tile hold the buffer's old
//     contents, which may be NaN: their scores are masked (a select, never
//     arithmetic), and each consumer warpgroup zeroes their V rows in shared
//     memory before PV, so 0 x NaN never happens.
//   * No NaN from the softmax: masked scores are -inf, a row that has seen
//     no visible key yet uses 0 as its exponent base (exp2(-inf) = 0, never
//     inf - inf), and rows past valid or without a visible key write 0.
//   * The online softmax state stays in f32 registers; P is rounded to bf16
//     for PV while the row sum uses f32 P, as _flash_kernel does.
// - The ragged last query tile: 4098 rows are 32 full tiles and one of 2
//   rows (TMA zero-fills the other 126). That block walks all the live tiles
//   as a full one does, so at B=3 x 28 heads it costs 84 of 2772 blocks, ~3%
//   of the call, for 0.05% of the rows.
// - What it leaves on the table: QK^T of the next tile is not issued under
//   this tile's softmax, no persistent grid, and each block loads its K/V
//   tiles on its own (the 7 heads of a GQA group and the q tiles of a row
//   share them only in L2). B2's turns at the tensor cores (PV of a tile and
//   QK^T of the next in one turn) made this kernel 20% slower: ptxas
//   serializes the wgmma when O is rescaled while QK^T is in flight.
//
// A decode step (T = 1) takes a second design, flash-decoding written for
// this card (flash_decode_split_kernel + flash_decode_combine_kernel; the
// wrapper dispatches on T on the host):
// - Bound: at T = 1 a query head does 4 D flops a live key, against 4 D
//   bytes of its KV head's K and V: the G = 7 heads of a GQA group together
//   do ~7 flops a byte, far below the card's ~295. The work is bound by the
//   live K/V bytes (10.2 MB for ~5000 keys over 4 KV heads: 3.0 us at
//   3.35 TB/s), and so by how many bytes are in flight, not by the
//   products. The 128-row design above reads each KV head once for each of
//   its 7 query heads and runs only B x H = 28 blocks on 132 SMs.
// - Pack the GQA group into the tile: for one (batch row, KV head) the G
//   query heads are rows 0..G-1 of one m16 query tile (rows G..15 zero),
//   so K and V are read once per KV head. The m16 mma.sync tile wastes
//   9/16 of its rows but the tensor cores are nowhere near the limit here;
//   wgmma's 64-row tile would waste 57/64 and needs a warpgroup per tile,
//   so mma.sync is the tool at this shape.
// - Split the live keys across blocks: the grid is (splits, KH, B), with
//   splits fixed on the host so that B x KH x splits fills the SMs once
//   (33 at B = 1, KH = 4: 132 blocks). Each block reads its row's live
//   length on the device (no host read of past_len) and takes an equal
//   share of its 64-key tiles, [s n / splits, (s+1) n / splits); its 8
//   warps take the share's 32-key halves in turn, each through its own
//   shared-memory buffer (cp.async, K and V in two groups so QK^T starts
//   before V lands; the first half is in flight while Q is read), so a
//   block keeps its whole share (up to 4 tiles, 128 KB) in flight at once
//   and the work left once the bytes land is a half tile a warp.
// - Each warp keeps B1's online softmax; the block adds its warps' states
//   in warp order and writes f32 partials (m, l, acc[G][128]) to a scratch
//   tensor the wrapper allocates per call (no counters, no persistent
//   workspace: the call can be captured in a CUDA graph as it is). A block
//   with no live key writes m = -inf, l = 0 and acc = 0.
// - The combine kernel is launched with programmatic dependent launch: its
//   blocks start while the split kernel runs and wait on the device for its
//   end (griddepcontrol), which takes the launch gap off the path.
// - The combine kernel adds the splits in a fixed order (exp2 of each m
//   against their max; a split with no live key writes m = -inf, l = 0 and
//   acc = 0, and weighs 0), four warps over the splits with eight loads in
//   flight each (a loop of one dependent L2 read a split cost ~0.2 us a
//   split), and writes bf16; a row with no visible key (q_valid = 0)
//   gets 0.
// - Keys past the live bound arrive as zeros (cp.async zero-fill) and are
//   masked: stale NaN in the buffer never reaches a product.
//
// The decode step over an int8 KV cache (B1-kv8: flash_decode_kv8; the JAX
// package has no kernel for it: XLA fuses the int8 load and the scale
// multiply into its decode attention, bagel_tpu/models/qwen2.py:439-452):
// - Bound: the live codes (1 byte an element) and scales (4 bytes a key and
//   KV head), half the bf16 cache's bytes: at 8 serving slots (12107 live
//   keys) 3.9 us at 3.35 TB/s. The first design read each half tile's codes
//   with synchronous loads and wrote them dequantized to shared memory, so a
//   warp waited out a full memory latency for every half tile: 27 us, no
//   faster than the bf16 pair over twice the bytes.
// - The split kernel is a template on the K/V element type; the int8
//   instance stages instead of loading. Each warp owns a ring of two stages
//   in shared memory, one half tile (32 keys) a stage: the K and V codes
//   (16-byte cp.async, 4 KB each) and the keys' K and V scales (4-byte
//   cp.async), copied as they are. The warp's first two half tiles are in
//   flight while Q lands; then, for each half tile, it waits for its stage
//   only, dequantizes the stage's K into one bf16 tile in shared memory,
//   runs QK^T and the softmax from it, dequantizes V into the same tile, runs
//   PV, and hands the stage back to the copy of the half tile two turns on:
//   the next stage's copies fly during this one's products.
// - The tile holds bf16(float(code) * scale), the f32 product rounded to
//   nearest even: bit for bit the view `_kv_dequantize` makes. float(code)
//   takes a byte permute and an add (code_f32), not I2F: at a quarter of the
//   FP32 rate, I2F over the 12.4 M codes of the 8-slot shape kept the
//   conversions ~3 us an SM, and the kernel slower than the bf16 pair. From
//   the tile on, the fragments, the products, the softmax, the warps' order
//   and the combine are the bf16 pair's, so the output is bit-identical to
//   that pair's at the same number of splits on the dequantized view.
// - Keys at or past the live bound are zero-filled by the copies (codes and
//   scales), whose sources are never read: a NaN scale there changes nothing.
// - Shared memory: 2 stages (8448 B each) and one tile (8704 B) a warp, 8
//   warps, Q and the warps' softmax states: 205 KB, one block an SM. The
//   wrapper launches two waves of blocks (8 splits at 8 slots: 17.5 us; the
//   bf16 pair's 5 splits, 21.4 us).
// - What it leaves: each block still walks one row's share; the rows of a
//   serving batch differ ~100x in length, so the long row's blocks set the
//   time (a schedule over the rows' tiles would balance them), and the
//   fixed cost of two dependent kernels (~10 us at one row) stays.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kD = 128;                 // head dim, compiled in
constexpr int kBK = 64;                 // the decode step's key tile
constexpr int kLds = kD + 8;            // smem row pitch (272 B): ldmatrix rows hit distinct banks
constexpr int kChunksPerRow = kD / 8;   // 16-byte chunks per row

using hopper::quad_max;
using hopper::quad_sum;
using hopper::smem_addr;

// 16-byte async copy; src_bytes = 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
               "r"(smem_addr(dst)), "l"(src), "r"(pred ? 16 : 0));
}
// 4-byte async copy (through L1); src_bytes = 0 fills with zeros.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::
               "r"(smem_addr(dst)), "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col); bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// float(code) of byte i of `biased`, a word of four int8 codes with their
// sign bits flipped (code + 128): the byte as the low mantissa bits of 2^23,
// minus 2^23 + 128, exactly; a byte permute and an add, where I2F runs at a
// quarter of the FP32 rate
__device__ __forceinline__ float code_f32(uint32_t biased, int i) {
  return __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 + i)) - 8388736.f;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

struct Strides {  // in elements: batch, sequence, head
  long long b, t, h;
};

// --- T > 1: TMA + wgmma, warp-specialized ----------------------------------

constexpr int kConsumers = 2;                     // consumer warpgroups, 64 query rows each
constexpr int kTileQ = 64 * kConsumers;           // query rows a block
constexpr int kTileK = 128;                       // keys a tile
constexpr int kThreadsT = 128 * (kConsumers + 1); // + the producer's warpgroup
constexpr int kStages = 2;
constexpr int kRegionCols = 64;                   // bf16 columns of a 128-byte swizzled row
constexpr int kQRegion = kTileQ * 128;            // bytes of one 64-column region of Q
constexpr int kKvRegion = kTileK * 128;           // ... of K or V
constexpr int kQBytes = 2 * kQRegion;
constexpr int kStageBytes = 4 * kKvRegion;        // K's two regions, then V's
constexpr int kSmemT = 1024 + kQBytes + kStages * kStageBytes + 128;  // alignment, Q, ring, barriers

struct Maps {  // TMA tensor maps of q [B, T, H, D], k and v [B, S, KH, D]
  CUtensorMap q, k, v;
};

__global__ void __launch_bounds__(kThreadsT, 1)
flash_cached_attention_kernel(const __grid_constant__ Maps maps, __nv_bfloat16* __restrict__ o,
                              Strides os, const int* __restrict__ past_len,
                              const int* __restrict__ q_valid, int T, int S, int group,
                              float scale_log2, int causal) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows of 128 B
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sq = smem;
  unsigned char* stages = smem + kQBytes;
  const uint32_t bars = smem_addr(stages + kStages * kStageBytes);
  auto full_bar = [&](int s) { return bars + 8 * s; };
  auto empty_bar = [&](int s) { return bars + 8 * (kStages + s); };
  const uint32_t q_bar = bars + 16 * kStages;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, q0 = qt * kTileQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int past = past_len[b];
  const int valid = min(q_valid[b], T);
  const int live = min(past + valid, S);  // keys [0, live): the row's cache and its block
  // the keys this q tile can see: [0, bound)
  const int bound = causal ? min(live, past + q0 + kTileQ) : live;
  const int n_tiles = (q0 < valid && bound > 0) ? (bound + kTileK - 1) / kTileK : 0;
  __nv_bfloat16* ob = o + b * os.b + h * os.h;

  if (n_tiles == 0) {  // rows past valid only: write zeros
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int c = tid; c < kTileQ * (kD / 8); c += kThreadsT) {
      const int t = q0 + c / (kD / 8);
      if (t < T) *reinterpret_cast<uint4*>(ob + t * os.t + (c % (kD / 8)) * 8) = zero;
    }
    return;
  }

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar(s), 1);                  // the producer's expect_tx
      mbar_init(empty_bar(s), kConsumers * 128);  // every consumer thread
    }
    mbar_init(q_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {
    // ---- producer: one lane of the last warpgroup, which gives its
    // registers to the consumers (40 + 2 x 232 per thread of each) ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp != 4 * kConsumers || lane != 0) return;
    const int kh = h / group;
    mbar_arrive_expect_tx(q_bar, kQBytes);
    for (int r = 0; r < 2; ++r)
      tma_load_4d(sq + r * kQRegion, &maps.q, q_bar, r * kRegionCols, h, q0, b);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      mbar_wait(empty_bar(s), ((it / kStages) & 1) ^ 1);  // the first round passes
      unsigned char* st = stages + s * kStageBytes;
      mbar_arrive_expect_tx(full_bar(s), kStageBytes);
      for (int r = 0; r < 2; ++r) {
        tma_load_4d(st + r * kKvRegion, &maps.k, full_bar(s), r * kRegionCols, kh, it * kTileK, b);
        tma_load_4d(st + (2 + r) * kKvRegion, &maps.v, full_bar(s), r * kRegionCols, kh,
                    it * kTileK, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg takes query rows q0 + 64 wg .. + 63 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = warp / 4, wt = tid % 128;
  // this thread's two rows (accumulator rows lane/4 and lane/4 + 8) and the
  // key limit of each: key j is visible iff j < lim
  const int row0 = q0 + 64 * wg + 16 * (warp % 4) + lane / 4, row1 = row0 + 8;
  const int lim0 = row0 < valid ? min(causal ? past + row0 + 1 : live, live) : 0;
  const int lim1 = row1 < valid ? min(causal ? past + row1 + 1 : live, live) : 0;
  // every valid row of the warpgroup sees the keys below wg_lo; none sees a
  // key at or past wg_hi
  const int first = q0 + 64 * wg;
  const int wg_hi = first < valid ? min(causal ? past + first + 64 : live, live) : 0;
  const int wg_lo = min(causal ? past + first + 1 : live, live);

  float oacc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) oacc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const uint32_t q_rows = smem_addr(sq) + wg * 64 * 128;  // this warpgroup's rows of region 0
  mbar_wait(q_bar, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages, j0 = it * kTileK;
    mbar_wait(full_bar(s), (it / kStages) & 1);
    unsigned char* st = stages + s * kStageBytes;
    const uint32_t sta = smem_addr(st);
    if (j0 >= wg_hi) {  // past this warpgroup's rows: release the stage only
      mbar_arrive(empty_bar(s));
      continue;
    }
    if (j0 + kTileK > live) {
      // keys at or past `live` are the buffer's stale contents (or TMA's
      // zeros past S): zero their V rows, so that P = 0 never meets a NaN.
      // A swizzled row is still one 128-byte span of each region.
      const uint4 zero = make_uint4(0, 0, 0, 0);
      for (int c = (live - j0) * 16 + wt; c < kTileK * 16; c += 128) {
        const int row = c / 16, ch = c % 16;
        *reinterpret_cast<uint4*>(st + (2 + ch / 8) * kKvRegion + row * 128 + (ch % 8) * 16) = zero;
      }
      fence_async_smem();
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    }

    // S = Q K^T: this warpgroup's 64 rows x 128 keys, 8 k16 steps over the
    // two 64-column regions
    float sacc[64];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const int r = ks / 4, kk = ks % 4;
      wgmma_bf16_ss(sacc, desc_sw128(q_rows + r * kQRegion + kk * 32, 16),
                    desc_sw128(sta + r * kKvRegion + kk * 32, 16), ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);

    // accumulator 4 nt + e holds row lane/4 (e < 2) or lane/4 + 8, key
    // j0 + 8 nt + 2 (lane % 4) + e % 2. The mask, unless every valid row
    // of the warpgroup sees the whole tile.
    if (j0 + kTileK > wg_lo) {
#pragma unroll
      for (int nt = 0; nt < kTileK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + nt * 8 + (lane % 4) * 2 + e;
          if (j >= lim0) sacc[4 * nt + e] = -INFINITY;
          if (j >= lim1) sacc[4 * nt + 2 + e] = -INFINITY;
        }
      }
    }
    // online softmax in base 2: the scale (> 0) goes into the exponent's
    // FFMA, the row max is taken over the raw scores and scaled once
    // (the rows' maxima and sums as trees of four independent chains)
    float mx0[4], mx1[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      mx0[c] = fmaxf(sacc[4 * c], sacc[4 * c + 1]);
      mx1[c] = fmaxf(sacc[4 * c + 2], sacc[4 * c + 3]);
    }
#pragma unroll
    for (int nt = 4; nt < kTileK / 8; ++nt) {
      mx0[nt % 4] = fmaxf(mx0[nt % 4], fmaxf(sacc[4 * nt], sacc[4 * nt + 1]));
      mx1[nt % 4] = fmaxf(mx1[nt % 4], fmaxf(sacc[4 * nt + 2], sacc[4 * nt + 3]));
    }
    const float mn0 =
        fmaxf(m0, quad_max(fmaxf(fmaxf(mx0[0], mx0[1]), fmaxf(mx0[2], mx0[3]))) * scale_log2);
    const float mn1 =
        fmaxf(m1, quad_max(fmaxf(fmaxf(mx1[0], mx1[1]), fmaxf(mx1[2], mx1[3]))) * scale_log2);
    // a row that has seen no visible key yet keeps max -inf: use 0 as the
    // exponent base so that exp2(-inf - base) gives 0, not NaN
    const float base0 = mn0 == -INFINITY ? 0.f : mn0;
    const float base1 = mn1 == -INFINITY ? 0.f : mn1;
    const float alpha0 = fast_exp2(m0 - base0);
    const float alpha1 = fast_exp2(m1 - base1);
    m0 = mn0;
    m1 = mn1;
    float sum0[4] = {0.f, 0.f, 0.f, 0.f}, sum1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kTileK / 8; ++nt) {
      sacc[4 * nt] = fast_exp2(fmaf(sacc[4 * nt], scale_log2, -base0));
      sacc[4 * nt + 1] = fast_exp2(fmaf(sacc[4 * nt + 1], scale_log2, -base0));
      sacc[4 * nt + 2] = fast_exp2(fmaf(sacc[4 * nt + 2], scale_log2, -base1));
      sacc[4 * nt + 3] = fast_exp2(fmaf(sacc[4 * nt + 3], scale_log2, -base1));
      sum0[nt % 4] += sacc[4 * nt] + sacc[4 * nt + 1];
      sum1[nt % 4] += sacc[4 * nt + 2] + sacc[4 * nt + 3];
    }
    // per-thread partial sums; reduced at the end
    l0 = l0 * alpha0 + ((sum0[0] + sum0[1]) + (sum0[2] + sum0[3]));
    l1 = l1 * alpha1 + ((sum1[0] + sum1[1]) + (sum1[2] + sum1[3]));
#pragma unroll
    for (int i = 0; i < 64; i += 4) {
      oacc[i] *= alpha0, oacc[i + 1] *= alpha0, oacc[i + 2] *= alpha1, oacc[i + 3] *= alpha1;
    }

    // O += P V: the S accumulators of keys 16 ks .. 16 ks + 15 re-pack as
    // the bf16 A fragment of k16 step ks
    uint32_t pa[kTileK / 16][4];
#pragma unroll
    for (int ks = 0; ks < kTileK / 16; ++ks) {
      pa[ks][0] = pack_bf16(sacc[8 * ks], sacc[8 * ks + 1]);
      pa[ks][1] = pack_bf16(sacc[8 * ks + 2], sacc[8 * ks + 3]);
      pa[ks][2] = pack_bf16(sacc[8 * ks + 4], sacc[8 * ks + 5]);
      pa[ks][3] = pack_bf16(sacc[8 * ks + 6], sacc[8 * ks + 7]);
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kTileK / 16; ++ks) {
      // V, MN-major, 128-byte swizzled: 16 keys of 128 B a step; the next
      // 8 keys 1024 B on (SBO), the next 64 columns a region on (LBO)
      wgmma_bf16_rs(oacc, pa[ks], desc_sw128(sta + 2 * kKvRegion + ks * 16 * 128, kKvRegion));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(oacc);
    fence_regs(pa);
    mbar_arrive(empty_bar(s));
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  // rows past valid, and rows that saw no key, write 0 whatever their
  // accumulators hold
  const float inv0 = row0 < valid && l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = row1 < valid && l1 > 0.f ? 1.f / l1 : 0.f;
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
    const int col = dt * 8 + (lane % 4) * 2;
    const float* a = oacc + 4 * dt;
    if (row0 < T)
      *reinterpret_cast<__nv_bfloat162*>(ob + row0 * os.t + col) =
          inv0 > 0.f ? __floats2bfloat162_rn(a[0] * inv0, a[1] * inv0) : __floats2bfloat162_rn(0.f, 0.f);
    if (row1 < T)
      *reinterpret_cast<__nv_bfloat162*>(ob + row1 * os.t + col) =
          inv1 > 0.f ? __floats2bfloat162_rn(a[2] * inv1, a[3] * inv1) : __floats2bfloat162_rn(0.f, 0.f);
  }
}

// --- decode (T = 1): split-KV over GQA groups --------------------------------

constexpr int kDecWarps = 8;
constexpr int kDecThreads = kDecWarps * 32;
constexpr int kDecBK = 32;                          // keys a warp takes at a time: half a tile
constexpr int kDecRows = 16;                        // the m16 tile: the group's heads
constexpr int kDecMaxSplits = 256;
constexpr int kDecQBytes = kDecRows * kLds * 2;
constexpr int kDecTileBytes = kDecBK * kLds * 2;    // a half tile of keys in bf16
// int8 (B1-kv8): a warp's ring of stages, each the half tile's K and V codes
// [32][128] and their K and V scales [32], then one bf16 tile
constexpr int kKv8Codes = kDecBK * kD;
constexpr int kKv8StageBytes = 2 * kKv8Codes + 2 * kDecBK * 4;
constexpr int kKv8Stages = 2;
// a warp's shared memory: bf16, its K and V tiles; int8, its ring and one tile
template <typename KV>
__host__ __device__ constexpr int dec_warp_bytes() {
  return std::is_same<KV, int8_t>::value ? kKv8Stages * kKv8StageBytes + kDecTileBytes
                                         : 2 * kDecTileBytes;
}
template <typename KV>
__host__ __device__ constexpr int dec_smem_bytes() {
  return kDecQBytes + kDecWarps * dec_warp_bytes<KV>() + kDecWarps * kDecRows * 2 * 4;
}
constexpr int kCombWarps = 4;                       // the combine kernel's warps
static_assert(kDecThreads % kD == 0, "the block's combine gives each thread one column");
static_assert(kDecRows * kD * 4 <= dec_warp_bytes<__nv_bfloat16>() &&
              kDecRows * kD * 4 <= dec_warp_bytes<int8_t>(),
              "a warp's partial fits in its shared memory");
static_assert(kBK % kDecBK == 0, "a warp takes part of a 64-key tile");
static_assert(dec_smem_bytes<int8_t>() <= 232448, "B1-kv8's block fits an SM");
static_assert(kDecQBytes % 16 == 0 && dec_warp_bytes<int8_t>() % 16 == 0 &&
              kKv8Codes % 16 == 0, "16-byte copies land 16-byte aligned");

// partials: acc [B, KH, splits, G, D] and (m, l) [B, KH, splits, G, 2], f32;
// m in base-2 units (scores x scale x log2 e)
// KV = __nv_bfloat16 (the bf16 cache) or int8_t (codes, with the f32 scales
// k_scale / v_scale [B, S, KH] at strides kss / vss; unread for bf16)
template <typename KV>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                          const KV* __restrict__ k,
                          const KV* __restrict__ v,
                          const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                          float* __restrict__ part_acc, float* __restrict__ part_ml,
                          const int* __restrict__ past_len, const int* __restrict__ q_valid,
                          int S, int group, Strides qs, Strides ks, Strides vs,
                          Strides kss, Strides vss, float scale_log2) {
  constexpr bool kInt8 = std::is_same<KV, int8_t>::value;
  constexpr int kWarpBytes = dec_warp_bytes<KV>();
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  float* sML = reinterpret_cast<float*>(smem + kDecQBytes + kDecWarps * kWarpBytes);

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z, splits = gridDim.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the combine kernel may launch now and wait for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // Q (cp.async group 0, in flight while the live length is read): the
  // group's heads kh G .. kh G + G-1 as rows 0..G-1, the rest zero
  const __nv_bfloat16* qb = q + b * qs.b + static_cast<long long>(kh) * group * qs.h;
  for (int c = tid; c < kDecRows * kChunksPerRow; c += kDecThreads) {
    const int r = c / kChunksPerRow, col = (c % kChunksPerRow) * 8;
    if (r < group)
      cp_async16(sQ + r * kLds + col, qb + r * qs.h + col, true);
    else
      *reinterpret_cast<uint4*>(sQ + r * kLds + col) = make_uint4(0, 0, 0, 0);
  }
  cp_async_commit();

  // the row's live keys [0, lim): at T = 1, causal or not, past + 1 if the
  // row is valid, else none
  const int lim = q_valid[b] > 0 ? min(past_len[b] + 1, S) : 0;
  const int n_tiles = (lim + kBK - 1) / kBK;
  const int t0 = static_cast<int>(static_cast<long long>(split) * n_tiles / splits);
  const int t1 = static_cast<int>(static_cast<long long>(split + 1) * n_tiles / splits);
  const long long slot = (static_cast<long long>(b) * gridDim.y + kh) * splits + split;
  float* pacc = part_acc + slot * group * kD;
  float* pml = part_ml + slot * group * 2;
  if (t0 >= t1) {  // no live key in this split: m = -inf, l = 0, acc = 0
    for (int r = tid; r < group; r += kDecThreads) {
      pml[2 * r] = -INFINITY;
      pml[2 * r + 1] = 0.f;
    }
    for (int i = tid; i < group * kD; i += kDecThreads) pacc[i] = 0.f;
    cp_async_wait<0>();  // no copy may land in shared memory after the block ends
    return;
  }

  unsigned char* wbuf = smem + kDecQBytes + warp * kWarpBytes;
  // bf16: K and V tiles; int8: K, then V, dequantized into one tile
  __nv_bfloat16* sK =
      reinterpret_cast<__nv_bfloat16*>(kInt8 ? wbuf + kKv8Stages * kKv8StageBytes : wbuf);
  __nv_bfloat16* sV = kInt8 ? sK : sK + kDecBK * kLds;
  const KV* kb = k + b * ks.b + kh * ks.h;
  const KV* vb = v + b * vs.b + kh * vs.h;
  constexpr int kParts = kBK / kDecBK;  // warp-sized parts of a tile
  const int first = t0 * kParts + warp, end = t1 * kParts;
  // bf16: keys [32 part, 32 part + 32): K, then V, in two cp.async groups;
  // keys at or past lim arrive as zeros
  auto load_kv = [&](int part) {
    for (int c = lane; c < kDecBK * kChunksPerRow; c += 32) {
      const int r = c / kChunksPerRow, col = (c % kChunksPerRow) * 8;
      const int j = part * kDecBK + r;
      cp_async16(sK + r * kLds + col, j < lim ? kb + j * ks.t + col : kb, j < lim);
    }
    cp_async_commit();
    for (int c = lane; c < kDecBK * kChunksPerRow; c += 32) {
      const int r = c / kChunksPerRow, col = (c % kChunksPerRow) * 8;
      const int j = part * kDecBK + r;
      cp_async16(sV + r * kLds + col, j < lim ? vb + j * vs.t + col : vb, j < lim);
    }
    cp_async_commit();
  };
  // int8: the codes and scales of keys [32 part, 32 part + 32) into stage
  // `st`, as they are, in one cp.async group (an empty group past the
  // warp's last part, so that every turn waits the same way)
  constexpr int kCodeChunks = kD / 16;  // 16-byte chunks of a key's codes
  auto stage = [&](int st) { return wbuf + st * kKv8StageBytes; };
  auto stage_kv = [&](int part, int st) {
    if (part < end) {
      unsigned char* dst = stage(st);
      const float* ksb = k_scale + b * kss.b + kh * kss.h;
      const float* vsb = v_scale + b * vss.b + kh * vss.h;
#pragma unroll
      for (int i = 0; i < kDecBK * kCodeChunks / 32; ++i) {
        const int c = lane + 32 * i, r = c / kCodeChunks, col = (c % kCodeChunks) * 16;
        const int j = part * kDecBK + r;
        const bool live = j < lim;
        cp_async16(dst + r * kD + col, live ? kb + j * ks.t + col : kb, live);
        cp_async16(dst + kKv8Codes + r * kD + col, live ? vb + j * vs.t + col : vb, live);
      }
      const int j = part * kDecBK + lane;
      const bool live = j < lim;
      cp_async4(dst + 2 * kKv8Codes + lane * 4, live ? ksb + j * kss.t : ksb, live);
      cp_async4(dst + 2 * kKv8Codes + kDecBK * 4 + lane * 4, live ? vsb + j * vss.t : vsb, live);
    }
    cp_async_commit();
  };
  // int8: a staged half tile's codes (K or V) times their keys' scales,
  // rounded to bf16, into the warp's tile; a lane takes 16 codes of a key
  auto dequantize = [&](const unsigned char* codes, const float* sc) {
#pragma unroll
    for (int i = 0; i < kDecBK * kCodeChunks / 32; ++i) {
      const int c = lane + 32 * i, r = c / kCodeChunks, col = (c % kCodeChunks) * 16;
      const int4 c16 = *reinterpret_cast<const int4*>(codes + r * kD + col);
      const float scale = sc[r];
      const uint32_t w[4] = {c16.x ^ 0x80808080u, c16.y ^ 0x80808080u, c16.z ^ 0x80808080u,
                             c16.w ^ 0x80808080u};
      uint32_t o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {  // codes 2e, 2e + 1: f32 products, rounded once to bf16
        const int i = (e % 2) * 2;
        o[e] = pack_bf16(code_f32(w[e / 2], i) * scale, code_f32(w[e / 2], i + 1) * scale);
      }
      __nv_bfloat16* dst = sK + r * kLds + col;
      *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<uint4*>(dst + 8) = make_uint4(o[4], o[5], o[6], o[7]);
    }
  };
  if constexpr (kInt8) {
    stage_kv(first, 0);            // group 1
    stage_kv(first + kDecWarps, 1);  // group 2
    cp_async_wait<2>();            // Q has landed (the stages may still be in flight)
  } else if (first < end) {
    load_kv(first);      // groups 1 (K) and 2 (V)
    cp_async_wait<2>();  // Q has landed (K and V may still be in flight)
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
  uint32_t qf[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    ldmatrix_x4(qf[kk], sQ + (lane % 16) * kLds + kk * 16 + (lane / 16) * 8);

  float acc[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  int st = 0;  // int8: the ring's stage of this turn
  for (int part = first; part < end; part += kDecWarps) {
    if constexpr (kInt8) {
      cp_async_wait<1>();  // this part's stage has landed; the next may fly
      __syncwarp();
      dequantize(stage(st), reinterpret_cast<const float*>(stage(st) + 2 * kKv8Codes));
      __syncwarp();
    } else {
      if (part != first) load_kv(part);
      cp_async_wait<1>();
      __syncwarp();
    }

    // S = Q K^T: 16 rows (the group's heads) x 32 keys
    float s[kDecBK / 8][4];
#pragma unroll
    for (int i = 0; i < kDecBK / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kDecBK / 16; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, sK + (np * 16 + lane % 8 + (lane / 16) * 8) * kLds + kk * 16 +
                            ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * np], qf[kk], bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // mask, scale to base 2, online softmax (B1's arithmetic)
    const int j0 = part * kDecBK + (lane % 4) * 2;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kDecBK / 8; ++nt) {
      const int j = j0 + nt * 8;
      s[nt][0] = j < lim ? s[nt][0] * scale_log2 : -INFINITY;
      s[nt][1] = j + 1 < lim ? s[nt][1] * scale_log2 : -INFINITY;
      s[nt][2] = j < lim ? s[nt][2] * scale_log2 : -INFINITY;
      s[nt][3] = j + 1 < lim ? s[nt][3] * scale_log2 : -INFINITY;
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float base0 = mn0 == -INFINITY ? 0.f : mn0;
    const float base1 = mn1 == -INFINITY ? 0.f : mn1;
    const float alpha0 = exp2f(m0 - base0);
    const float alpha1 = exp2f(m1 - base1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kDecBK / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - base0);
      s[nt][1] = exp2f(s[nt][1] - base0);
      s[nt][2] = exp2f(s[nt][2] - base1);
      s[nt][3] = exp2f(s[nt][3] - base1);
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
      acc[dt][0] *= alpha0;
      acc[dt][1] *= alpha0;
      acc[dt][2] *= alpha1;
      acc[dt][3] *= alpha1;
    }

    if constexpr (kInt8) {
      __syncwarp();  // every lane has read K from the tile: V takes its place
      dequantize(stage(st) + kKv8Codes,
                 reinterpret_cast<const float*>(stage(st) + 2 * kKv8Codes + kDecBK * 4));
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    // O += P V, P rounded to bf16 (the row sums above used f32 P)
#pragma unroll
    for (int ks16 = 0; ks16 < kDecBK / 16; ++ks16) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * ks16][0], s[2 * ks16][1]),
          pack_bf16(s[2 * ks16][2], s[2 * ks16][3]),
          pack_bf16(s[2 * ks16 + 1][0], s[2 * ks16 + 1][1]),
          pack_bf16(s[2 * ks16 + 1][2], s[2 * ks16 + 1][3]),
      };
#pragma unroll
      for (int dp = 0; dp < kD / 16; ++dp) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, sV + (ks16 * 16 + lane % 8 + ((lane / 8) % 2) * 8) * kLds +
                                  dp * 16 + (lane / 16) * 8);
        mma_bf16(acc[2 * dp], pa, bf[0], bf[1]);
        mma_bf16(acc[2 * dp + 1], pa, bf[2], bf[3]);
      }
    }
    __syncwarp();  // this warp's buffers are refilled next
    if constexpr (kInt8) {
      stage_kv(part + 2 * kDecWarps, st);  // two turns on, into the stage just read
      st ^= 1;
    }
  }
  if constexpr (kInt8) cp_async_wait<0>();  // no copy may land after the warp's buffer is reused

  // this warp's state into its own (now idle) K/V buffer: acc [G][D], (m, l) [G]
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  float* pw = reinterpret_cast<float*>(wbuf);
  const int row0 = lane / 4, row1 = row0 + 8;
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
    const int col = dt * 8 + (lane % 4) * 2;
    if (row0 < group) pw[row0 * kD + col] = acc[dt][0], pw[row0 * kD + col + 1] = acc[dt][1];
    if (row1 < group) pw[row1 * kD + col] = acc[dt][2], pw[row1 * kD + col + 1] = acc[dt][3];
  }
  if (lane % 4 == 0) {
    float* ml = sML + warp * kDecRows * 2;
    if (row0 < group) ml[2 * row0] = m0, ml[2 * row0 + 1] = l0;
    if (row1 < group) ml[2 * row1] = m1, ml[2 * row1 + 1] = l1;
  }
  __syncthreads();

  // the block's partial: its warps added in warp order; a thread takes
  // column tid % D of rows tid / D, tid / D + kDecThreads / D, ...
  const int d = tid % kD;
  for (int r = tid / kD; r < group; r += kDecThreads / kD) {
    float mmax = -INFINITY;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) mmax = fmaxf(mmax, sML[(w * kDecRows + r) * 2]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float mw = sML[(w * kDecRows + r) * 2];
      if (mw == -INFINITY) continue;  // a warp without a live key
      const float wgt = exp2f(mw - mmax);
      l += wgt * sML[(w * kDecRows + r) * 2 + 1];
      a += wgt * reinterpret_cast<const float*>(smem + kDecQBytes + w * kWarpBytes)[r * kD + d];
    }
    pacc[r * kD + d] = a;
    if (d == 0) pml[2 * r] = mmax, pml[2 * r + 1] = l;
  }
}

// out[b, 0, h, :] from the splits' partials of head h = kh G + r: the
// splits' weights first (in shared memory, a thread a split); then warp w
// adds splits w, w + 4, ... (8 loads in flight), lane l columns 4l..4l+3;
// then the warps' sums in warp order. A split with no live key weighs 0.
__global__ void __launch_bounds__(kCombWarps * 32)
flash_decode_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                            __nv_bfloat16* __restrict__ o, int group, int splits, Strides os) {
  __shared__ float sw[kDecMaxSplits], sl[kDecMaxSplits];
  __shared__ float4 red[kCombWarps][32];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kh = h / group, r = h % group;
  const long long first = (static_cast<long long>(b) * (gridDim.x / group) + kh) * splits;
  const float4* acc = reinterpret_cast<const float4*>(part_acc + (first * group + r) * kD) + lane;
  const long long step = static_cast<long long>(group) * kD / 4;  // float4s from split to split
  // launched early (programmatic dependent launch): wait until the split
  // kernel has ended and its partials are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  float4 x[8];  // the first batch of this warp's splits, in flight with the weights
  auto load_batch = [&](int s0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int s = s0 + i * kCombWarps;
      x[i] = s < splits ? acc[s * step] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  load_batch(warp);
  for (int s = tid; s < splits; s += kCombWarps * 32) {
    sw[s] = part_ml[((first + s) * group + r) * 2];
    sl[s] = part_ml[((first + s) * group + r) * 2 + 1];
  }
  __syncthreads();
  float mmax = -INFINITY;
  for (int s = 0; s < splits; ++s) mmax = fmaxf(mmax, sw[s]);
  __syncthreads();
  for (int s = tid; s < splits; s += kCombWarps * 32)
    sw[s] = sw[s] == -INFINITY ? 0.f : exp2f(sw[s] - mmax);
  __syncthreads();

  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = warp; s0 < splits; s0 += kCombWarps * 8) {
    if (s0 != warp) load_batch(s0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int s = s0 + i * kCombWarps;
      const float w = s < splits ? sw[s] : 0.f;
      a.x += w * x[i].x, a.y += w * x[i].y, a.z += w * x[i].z, a.w += w * x[i].w;
    }
  }
  red[warp][lane] = a;
  __syncthreads();
  if (warp == 0) {
    float l = 0.f;
    for (int s = 0; s < splits; ++s) l += sw[s] * sl[s];
    float4 t = red[0][lane];
#pragma unroll
    for (int w = 1; w < kCombWarps; ++w)
      t.x += red[w][lane].x, t.y += red[w][lane].y, t.z += red[w][lane].z, t.w += red[w][lane].w;
    const float inv = l > 0.f ? 1.f / l : 0.f;  // a row with no visible key writes 0
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(o + b * os.b + h * os.h + 4 * lane);
    dst[0] = __floats2bfloat162_rn(t.x * inv, t.y * inv);
    dst[1] = __floats2bfloat162_rn(t.z * inv, t.w * inv);
  }
}

// The split kernel of element type KV, then the combine kernel, on `stream`
template <typename KV>
int launch_decode(const void* q, const void* k, const void* v, const float* k_scale,
                  const float* v_scale, void* o, void* part_acc, void* part_ml,
                  const int* past_len, const int* q_valid, int B, int S, int H, int KH,
                  int splits, Strides qs, Strides ks, Strides vs, Strides kss, Strides vss,
                  long long o_sb, long long o_sh, float scale, void* stream) {
  if (H % KH != 0 || H / KH > kDecRows || splits < 1 || splits > kDecMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kSmem = dec_smem_bytes<KV>();
  cudaError_t err = cudaFuncSetAttribute(flash_decode_split_kernel<KV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  flash_decode_split_kernel<KV><<<dim3(splits, KH, B), kDecThreads, kSmem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), k_scale, v_scale, static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), past_len, q_valid, S, H / KH, qs, ks, vs, kss, vss,
      scale * 1.4426950408889634f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the combine with programmatic dependent launch: its blocks may start
  // while the split kernel runs and wait for its end on the device
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(H, B);
  config.blockDim = dim3(kCombWarps * 32);
  config.dynamicSmemBytes = 0;
  config.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, flash_decode_combine_kernel,
                           static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
                           static_cast<__nv_bfloat16*>(o), H / KH, splits,
                           Strides{o_sb, 0, o_sh});
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// A block of T > 1 queries: launches on `stream` and returns 0 on success,
// else cudaGetLastError()'s code, or 100000 + the CUresult of a refused
// tensor map.
int flash_cached_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                const int* past_len, const int* q_valid,
                                int B, int T, int S, int H, int KH,
                                long long q_sb, long long q_st, long long q_sh,
                                long long k_sb, long long k_st, long long k_sh,
                                long long v_sb, long long v_st, long long v_sh,
                                long long o_sb, long long o_st, long long o_sh,
                                float scale, int causal, void* stream) {
  using hopper::make_map;
  constexpr CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  Maps maps;
  // [B, rows, heads, D] views: dims (D, heads, rows, B), byte strides
  int err = make_map<4>(&maps.q, bf16, q, {kD, H, T, B}, {q_sh * 2, q_st * 2, q_sb * 2},
                        {kRegionCols, 1, kTileQ, 1});
  if (!err)
    err = make_map<4>(&maps.k, bf16, k, {kD, KH, S, B}, {k_sh * 2, k_st * 2, k_sb * 2},
                      {kRegionCols, 1, kTileK, 1});
  if (!err)
    err = make_map<4>(&maps.v, bf16, v, {kD, KH, S, B}, {v_sh * 2, v_st * 2, v_sb * 2},
                      {kRegionCols, 1, kTileK, 1});
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(flash_cached_attention_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemT);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((T + kTileQ - 1) / kTileQ, H, B);
  flash_cached_attention_kernel<<<grid, kThreadsT, kSmemT, static_cast<cudaStream_t>(stream)>>>(
      maps, static_cast<__nv_bfloat16*>(o), Strides{o_sb, o_st, o_sh}, past_len, q_valid, T, S,
      H / KH, scale * 1.4426950408889634f, causal);
  return static_cast<int>(cudaGetLastError());
}

// The decode step (T = 1): the split kernel, then the combine kernel, on
// `stream`; part_acc holds B*KH*splits*G*128 floats, part_ml
// B*KH*splits*G*2 (G = H / KH <= 16). Returns cudaGetLastError() (0 on
// success).
int flash_decode_bf16(const void* q, const void* k, const void* v, void* o,
                      void* part_acc, void* part_ml, const int* past_len, const int* q_valid,
                      int B, int S, int H, int KH, int splits,
                      long long q_sb, long long q_sh, long long k_sb, long long k_st,
                      long long k_sh, long long v_sb, long long v_st, long long v_sh,
                      long long o_sb, long long o_sh, float scale, void* stream) {
  return launch_decode<__nv_bfloat16>(
      q, k, v, nullptr, nullptr, o, part_acc, part_ml, past_len, q_valid, B, S, H, KH, splits,
      Strides{q_sb, 0, q_sh}, Strides{k_sb, k_st, k_sh}, Strides{v_sb, v_st, v_sh},
      Strides{0, 0, 0}, Strides{0, 0, 0}, o_sb, o_sh, scale, stream);
}

// The decode step over an int8 KV cache (B1-kv8): k/v int8 codes
// [B, S, KH, 128] (strides multiples of 16, 16-byte aligned base), k_scale /
// v_scale f32 [B, S, KH]; otherwise as flash_decode_bf16.
int flash_decode_kv8(const void* q, const void* k, const void* v, const void* k_scale,
                     const void* v_scale, void* o, void* part_acc, void* part_ml,
                     const int* past_len, const int* q_valid, int B, int S, int H, int KH,
                     int splits, long long q_sb, long long q_sh, long long k_sb, long long k_st,
                     long long k_sh, long long v_sb, long long v_st, long long v_sh,
                     long long ks_sb, long long ks_st, long long ks_sh, long long vs_sb,
                     long long vs_st, long long vs_sh, long long o_sb, long long o_sh,
                     float scale, void* stream) {
  return launch_decode<int8_t>(
      q, k, v, static_cast<const float*>(k_scale), static_cast<const float*>(v_scale), o,
      part_acc, part_ml, past_len, q_valid, B, S, H, KH, splits, Strides{q_sb, 0, q_sh},
      Strides{k_sb, k_st, k_sh}, Strides{v_sb, v_st, v_sh}, Strides{ks_sb, ks_st, ks_sh},
      Strides{vs_sb, vs_st, vs_sh}, o_sb, o_sh, scale, stream);
}

const char* flash_cached_attention_error_string(int code) {
  if (code >= hopper::kEncodeError)
    return "cuTensorMapEncodeTiled refused a tensor map (code - 100000 is the CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
