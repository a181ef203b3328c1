// Block-sparse packed attention for Hopper (the forward pass).
//
// Replaces the TPU kernel bagel_tpu/ops/sparse_flash.py:_sparse_kernel
// (reached from sparse_packed_attention, bagel_tpu/ops/sparse_flash.py:233).
// It computes the same function, not the Pallas grid:
//
//   out[i,h,:] = sum_j softmax_j(q[i,h,:] . k[j,h/G,:] * scale) v[j,h/G,:]
//   over the keys j with  same_doc(i,j) & (i >= j | same_fan(i,j)) & !other_noise(i,j):
//     same_doc    = doc[i] == doc[j] && doc[i] != 0      (0 = padding)
//     same_fan    = fan[i] == fan[j] && fan[i] >= 0      (-1 = none)
//     other_noise = noise[j] >= 0 && noise[i] != noise[j]
//   rows with no visible key (padding rows, a q tile with no live key tile)
//   are written as exact 0.
//
// Layout: q/out [S, H, D], k/v [S, KH, D], bf16, addressed through their
// sequence/head strides (the SigLIP tower hands in views of a fused [S, *]
// projection); S is ragged: the tensor maps' bounds mask the edge, so no
// padded copies are made around the call. doc/fan/noise are int32 [S]. D =
// 72 (SigLIP so400m, 1152 / 16 heads) and D = 128 (the LLM's packed training
// shape, GQA 28/4) are instantiated; both run the design below.
//
// What bounds it on an H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): the work
// is 4*D*H*(visible pairs) FLOPs against one read of q/k/v and one write of
// out. On the understanding path (one 980 px image: 4900 patches in a
// 4926-token block, H=16, D=72) that is 1.11e11 FLOP against 45 MB, ~2400
// FLOP/byte: it is bound by operations, at 0.112 ms. Next to the products,
// the softmax's exp2 (16 a clock per SM) costs about as much as QK^T at
// D = 72, so the products alone do not set the pace.
//
// Design (Hopper's: TMA, mbarriers, warp specialization, wgmma):
// - A block takes a 128-row query tile of one head: two consumer
//   warpgroups of 64 rows each and one producer warp (in a third
//   warpgroup). The block walks only its q tile's live 128-key tiles, read
//   from a table [n_q_tiles, n_kv_tiles] that the wrapper builds with
//   block_liveness at 128 x 128; each K/V tile feeds 128 query rows.
// - The producer warp loads Q once, then each live tile's K and V into a
//   ring of shared-memory stages with TMA (cp.async.bulk.tensor, one tensor
//   map per operand and column region, built on the host per call and
//   passed as a __grid_constant__ parameter), completed on a "full"
//   mbarrier per stage; the consumers release a stage on its "empty"
//   mbarrier. Its 32 lanes also copy the key tile's doc/fan/noise ids into
//   the stage (ids past S as padding) and arrive on the full barrier.
// - Shared-memory layouts, legal for wgmma's descriptors:
//   * columns 0..63 (D = 72) or 0..127 (D = 128) in 64-column regions of
//     128-byte rows with the 128-byte swizzle (TMA box 64 x rows, the
//     swizzle TMA writes is the one the descriptor reads); Q and K are
//     read K-major, V MN-major (transposed by the descriptor);
//   * D = 72's columns 64..71 in a plain region of 16-byte rows (TMA box
//     8 x rows, no swizzle: wgmma's "interleave" layout of 8 x 8 core
//     matrices); for Q and K a second such region of zeros stands for
//     columns 72..79, written once at the start and never by TMA, so QK^T
//     runs over a depth of 80 (five k16 steps). The tensor maps' column
//     bound is D: no box reads the next head's columns.
// - QK^T: wgmma m64n128k16, A = Q and B = K from shared memory. PV: wgmma
//   with A = P from registers (the S accumulators re-packed as bf16: their
//   layout is the A fragment's) and B = V from shared memory, N = 64 (D =
//   72, plus an N = 8 product over the plain region) or N = 128.
// - Each table entry carries a flag (bit 30) that the wrapper sets when
//   every (query, key) pair of the tile is visible. Such a tile skips the
//   per-element mask; on the SigLIP path that is every tile but those
//   holding the padded tail.
// - No NaN: masked scores become -inf, a row with no visible key yet uses 0
//   as its exponent base (exp2(-inf) = 0, never inf - inf), and rows that end
//   with no visible key write 0. Keys past S arrive as zeros (TMA's
//   out-of-bounds fill); in a tile without the flag each consumer
//   warpgroup zeroes the V rows of padding keys (doc 0) before PV, so
//   stale NaN there never meets a zero probability (0 * NaN). No query
//   can see such a key, and its masked score never reaches P.
// - The online softmax state (running max, sum, output accumulator) stays
//   in f32 registers; P is rounded to bf16 for the PV product while the row
//   sum uses f32 P, as _sparse_kernel does.
//
// - Per tile a consumer warpgroup runs QK^T, the softmax and PV in turn;
//   the two warpgroups overlap each other. A 128-key tile keeps the
//   per-tile work (barrier waits, row max and sum, the rescale of O) to
//   half of what 64-key tiles cost, and gives each warp 64 scores to work
//   on at once. Scores, P and O live in registers: the producer's
//   warpgroup gives up registers (setmaxnreg) so the consumers have 232.
//
// - For the gradient (sparse_packed_attention_bwd.cu) the epilogue also
//   writes, where asked, each row's logsumexp ([H, S] f32, in nats,
//   converted once from the kernel's base 2; +inf for a row with no
//   visible key) and the output's rounding residual (f32 output minus the
//   bf16 one, in bf16). Null pointers select the kernel's instance without
//   that code (kStats false): the inference path (SigLIP) runs the same
//   epilogue as before, and the output is the same bits either way.
//
// What it leaves on the table: QK^T of the next tile is not issued under
// this tile's softmax (tried with 64-key tiles: slower than without), no
// ping-pong ordering of the two warpgroups,
// and no persistent grid (the 624 blocks of the SigLIP shape run in 4.7
// waves of 132).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sparse_packed.cuh"

namespace {

using namespace sparse;

constexpr int kConsumers = 2;              // consumer warpgroups, 64 query rows each
constexpr int kBQ = 64 * kConsumers;       // query rows per block
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer's warpgroup
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Shape {
  static_assert(D == 72 || D == 128, "instantiated head dims");
  static constexpr int kRegions = D / kRegionCols;       // swizzled column regions
  static constexpr bool kTail = D % kRegionCols != 0;    // D = 72: columns 64..71
  static constexpr int kQkSteps = (D + 15) / 16;         // k16 steps of QK^T (depth 80 or 128)
  static constexpr int kStages = kTail ? 3 : 2;
  // bytes of the shared-memory regions
  static constexpr int kQRegion = kBQ * 128;
  static constexpr int kQTail = kBQ * 16;                // one 8-column chunk of Q
  static constexpr int kKvRegion = kBK * 128;
  static constexpr int kKvTail = kBK * 16;
  // a stage: K regions, V regions, [K tail, K zeros, V tail], ids
  static constexpr int kKTailOff = 2 * kRegions * kKvRegion;
  static constexpr int kVTailOff = kKTailOff + (kTail ? 2 * kKvTail : 0);
  static constexpr int kIdsOff = kVTailOff + (kTail ? kKvTail : 0);
  static constexpr int kStageBytes = round_up(kIdsOff + 3 * kBK * 4, 1024);
  static constexpr int kQBytes = round_up(kRegions * kQRegion + (kTail ? 2 * kQTail : 0), 1024);
  static constexpr int kSmemBytes = 1024 + kQBytes + kStages * kStageBytes + 128;
  // bytes TMA delivers: a stage's K and V, and Q
  static constexpr uint32_t kStageTx = 2 * kRegions * kKvRegion + (kTail ? 2 * kKvTail : 0);
  static constexpr uint32_t kQTx = kRegions * kQRegion + (kTail ? kQTail : 0);
  static constexpr int kOMain = 32 * kRegions;           // f32 accumulators of PV's main product
};

struct Maps {  // one TMA tensor map per operand and column region
  CUtensorMap q, q_tail, k, k_tail, v, v_tail;
};

// --- the kernel ------------------------------------------------------------

// kStats: also write lse and o_lo (the gradient's inputs); the inference
// path takes the instance without them, whose epilogue has no extra code
template <int D, bool kStats>
__global__ void __launch_bounds__(kThreads, 1)
sparse_packed_attention_kernel(const __grid_constant__ Maps maps, __nv_bfloat16* __restrict__ o,
                               long long o_st, long long o_sh, float* __restrict__ lse,
                               __nv_bfloat16* __restrict__ o_lo,
                               const int* __restrict__ doc, const int* __restrict__ fan,
                               const int* __restrict__ noise, const int* __restrict__ live_idx,
                               const int* __restrict__ live_cnt, int S, int group, int nk_tab,
                               float scale_log2) {
  using Sh = Shape<D>;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows of 128 B
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sq = smem;
  unsigned char* stages = smem + Sh::kQBytes;
  const uint32_t bars = smem_addr(stages + Sh::kStages * Sh::kStageBytes);
  auto full_bar = [&](int s) { return bars + 8 * s; };
  auto empty_bar = [&](int s) { return bars + 8 * (Sh::kStages + s); };
  const uint32_t q_bar = bars + 16 * Sh::kStages;

  const int qt = blockIdx.x, h = blockIdx.y, q0 = qt * kBQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_tiles = live_cnt[qt];
  const int* tab = live_idx + static_cast<long long>(qt) * nk_tab;
  __nv_bfloat16* ob = o + h * o_sh;
  __nv_bfloat16* olb = kStats ? o_lo + h * o_sh : nullptr;

  if (n_tiles == 0) {  // no live key tile: every row of the tile is 0 (lse: no pair)
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int c = tid; c < kBQ * (D / 8); c += kThreads) {
      const int t = q0 + c / (D / 8);
      if (t < S) *reinterpret_cast<uint4*>(ob + t * o_st + (c % (D / 8)) * 8) = zero;
      if (kStats && t < S) *reinterpret_cast<uint4*>(olb + t * o_st + (c % (D / 8)) * 8) = zero;
    }
    if (kStats && tid < kBQ && q0 + tid < S)
      lse[static_cast<long long>(h) * S + q0 + tid] = INFINITY;
    return;
  }

  if (tid == 0) {
    for (int s = 0; s < Sh::kStages; ++s) {
      mbar_init(full_bar(s), 32);                  // the producer warp's lanes
      mbar_init(empty_bar(s), kConsumers * 128);   // every consumer thread
    }
    mbar_init(q_bar, 1);
    mbar_init_fence();
  }
  if (Sh::kTail) {  // the zero chunks standing for columns 72..79 of Q and K
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int c = tid; c < Sh::kQTail / 16; c += kThreads)
      reinterpret_cast<uint4*>(sq + Sh::kRegions * Sh::kQRegion + Sh::kQTail)[c] = zero;
    for (int c = tid; c < Sh::kStages * (Sh::kKvTail / 16); c += kThreads) {
      unsigned char* st = stages + (c / (Sh::kKvTail / 16)) * Sh::kStageBytes;
      reinterpret_cast<uint4*>(st + Sh::kKTailOff + Sh::kKvTail)[c % (Sh::kKvTail / 16)] = zero;
    }
    fence_async_smem();
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {
    // ---- producer: one warp of the last warpgroup, which gives its
    // registers to the consumers (40 + 2 x 232 per thread of each) ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp != 4 * kConsumers) return;
    const int kh = h / group;
    if (lane == 0) {
      mbar_arrive_expect_tx(q_bar, Sh::kQTx);
#pragma unroll
      for (int r = 0; r < Sh::kRegions; ++r)
        tma_load_3d(sq + r * Sh::kQRegion, &maps.q, q_bar, r * kRegionCols, h, q0);
      if (Sh::kTail)
        tma_load_3d(sq + Sh::kRegions * Sh::kQRegion, &maps.q_tail, q_bar, kRegionCols, h, q0);
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % Sh::kStages;
      mbar_wait(empty_bar(s), ((it / Sh::kStages) & 1) ^ 1);  // the first round passes
      const int j0 = (tab[it] & ~kFullTile) * kBK;
      unsigned char* st = stages + s * Sh::kStageBytes;
      int* ids = reinterpret_cast<int*>(st + Sh::kIdsOff);  // [doc, fan, noise][kBK]
      for (int e = lane; e < kBK; e += 32) {
        const int j = j0 + e;
        const bool ok = j < S;
        ids[e] = ok ? doc[j] : 0;
        ids[kBK + e] = ok ? fan[j] : -1;
        ids[2 * kBK + e] = ok ? noise[j] : -1;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(full_bar(s), Sh::kStageTx);
#pragma unroll
        for (int r = 0; r < Sh::kRegions; ++r) {
          tma_load_3d(st + r * Sh::kKvRegion, &maps.k, full_bar(s), r * kRegionCols, kh, j0);
          tma_load_3d(st + (Sh::kRegions + r) * Sh::kKvRegion, &maps.v, full_bar(s),
                   r * kRegionCols, kh, j0);
        }
        if (Sh::kTail) {
          tma_load_3d(st + Sh::kKTailOff, &maps.k_tail, full_bar(s), kRegionCols, kh, j0);
          tma_load_3d(st + Sh::kVTailOff, &maps.v_tail, full_bar(s), kRegionCols, kh, j0);
        }
      } else {
        mbar_arrive(full_bar(s));
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg takes query rows q0 + 64 wg .. + 63 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = warp / 4, wt = tid % 128;
  RowIds r0, r1;  // this thread's two rows (accumulator rows lane/4 and lane/4 + 8)
  r0.load(q0 + 64 * wg + 16 * (warp % 4) + lane / 4, S, doc, fan, noise);
  r1.load(r0.pos + 8, S, doc, fan, noise);

  float om[Sh::kOMain], ot[4];
#pragma unroll
  for (int i = 0; i < Sh::kOMain; ++i) om[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) ot[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const uint32_t q_main = smem_addr(sq) + wg * 64 * 128;
  const uint32_t q_tail = smem_addr(sq) + Sh::kRegions * Sh::kQRegion + wg * 64 * 16;
  mbar_wait(q_bar, 0);

  // tile `it`'s stage, once it has landed; in a tile without the full flag
  // the V rows of padding keys are zeroed first (0 * stale NaN would be NaN)
  auto ready = [&](int it) {
    const int s = it % Sh::kStages;
    mbar_wait(full_bar(s), (it / Sh::kStages) & 1);
    unsigned char* st = stages + s * Sh::kStageBytes;
    if (!(tab[it] & kFullTile)) {
      const int* sdoc = reinterpret_cast<const int*>(st + Sh::kIdsOff);
      const uint4 zero = make_uint4(0, 0, 0, 0);
      constexpr int kChunks = 8 * Sh::kRegions + (Sh::kTail ? 1 : 0);  // 16-byte chunks a row
      for (int c = wt; c < kBK * kChunks; c += 128) {
        const int row = c / kChunks, ch = c % kChunks;
        if (sdoc[row] == 0) {
          unsigned char* dst =
              ch < 8 * Sh::kRegions
                  ? st + (Sh::kRegions + ch / 8) * Sh::kKvRegion + row * 128 + (ch % 8) * 16
                  : st + Sh::kVTailOff + row * 16;
          *reinterpret_cast<uint4*>(dst) = zero;
        }
      }
      fence_async_smem();
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    }
  };
  // S = Q K^T of tile `it`, this warpgroup's 64 rows x 128 keys (issued, not waited)
  auto issue_qk = [&](int it, float (&sacc)[kBK / 2]) {
    const uint32_t sta = smem_addr(stages + (it % Sh::kStages) * Sh::kStageBytes);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < Sh::kQkSteps; ++ks) {
      uint64_t da, db;
      if (ks < 4 * Sh::kRegions) {  // 128-byte swizzled, K-major: 32 B a k16 step
        const int r = ks / 4, kk = ks % 4;
        da = make_desc(q_main + r * Sh::kQRegion + kk * 32, 16, 1024, kSwizzle128);
        db = make_desc(sta + r * Sh::kKvRegion + kk * 32, 16, 1024, kSwizzle128);
      } else {  // D = 72's columns 64..79: interleave, K-major, chunks of 8 columns
        da = make_desc(q_tail, Sh::kQTail, 128, kInterleave);
        db = make_desc(sta + Sh::kKTailOff, Sh::kKvTail, 128, kInterleave);
      }
      wgmma_bf16_ss(sacc, da, db, ks > 0);
    }
    wgmma_commit();
  };

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % Sh::kStages;
    const int cur = tab[it];
    ready(it);
    float sacc[kBK / 2];
    issue_qk(it, sacc);
    wgmma_wait<0>();
    fence_regs(sacc);

    unsigned char* st = stages + s * Sh::kStageBytes;
    const uint32_t sta = smem_addr(st);
    const int* sdoc = reinterpret_cast<const int*>(st + Sh::kIdsOff);
    const int* sfan = sdoc + kBK;
    const int* snoise = sfan + kBK;
    const int j0 = (cur & ~kFullTile) * kBK;

    // mask from the ids (unless the whole tile is visible), online softmax;
    // accumulator 4 nt + e holds row lane/4 (e < 2) or lane/4 + 8, key
    // 8 nt + 2 (lane % 4) + e % 2. The scale (> 0) to base 2 goes into the
    // exponent's FFMA: the row max of the raw scores, scaled once.
    if (!(cur & kFullTile)) {
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jl = nt * 8 + (lane % 4) * 2 + e;
          const int j = j0 + jl;
          const int dk = sdoc[jl], fk = sfan[jl], nk = snoise[jl];
          if (!r0.sees(j, dk, fk, nk)) sacc[4 * nt + e] = -INFINITY;
          if (!r1.sees(j, dk, fk, nk)) sacc[4 * nt + 2 + e] = -INFINITY;
        }
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(sacc[4 * nt], sacc[4 * nt + 1]));
      mx1 = fmaxf(mx1, fmaxf(sacc[4 * nt + 2], sacc[4 * nt + 3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0) * scale_log2);
    const float mn1 = fmaxf(m1, quad_max(mx1) * scale_log2);
    // a row that has seen no visible key yet keeps max -inf: use 0 as the
    // exponent base so that exp2(-inf - base) gives 0, not NaN
    const float base0 = mn0 == -INFINITY ? 0.f : mn0;
    const float base1 = mn1 == -INFINITY ? 0.f : mn1;
    const float alpha0 = fast_exp2(m0 - base0);
    const float alpha1 = fast_exp2(m1 - base1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      sacc[4 * nt] = fast_exp2(fmaf(sacc[4 * nt], scale_log2, -base0));
      sacc[4 * nt + 1] = fast_exp2(fmaf(sacc[4 * nt + 1], scale_log2, -base0));
      sacc[4 * nt + 2] = fast_exp2(fmaf(sacc[4 * nt + 2], scale_log2, -base1));
      sacc[4 * nt + 3] = fast_exp2(fmaf(sacc[4 * nt + 3], scale_log2, -base1));
      sum0 += sacc[4 * nt] + sacc[4 * nt + 1];
      sum1 += sacc[4 * nt + 2] + sacc[4 * nt + 3];
    }
    l0 = l0 * alpha0 + sum0;  // per-thread partial sums; reduced at the end
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int i = 0; i < Sh::kOMain; i += 4) {
      om[i] *= alpha0, om[i + 1] *= alpha0, om[i + 2] *= alpha1, om[i + 3] *= alpha1;
    }
    ot[0] *= alpha0, ot[1] *= alpha0, ot[2] *= alpha1, ot[3] *= alpha1;

    // O += P V: the S accumulators of keys 16 ks .. 16 ks + 15 re-pack as
    // the A fragment of k16 step ks
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      pa[ks][0] = pack_bf16(sacc[8 * ks], sacc[8 * ks + 1]);
      pa[ks][1] = pack_bf16(sacc[8 * ks + 2], sacc[8 * ks + 3]);
      pa[ks][2] = pack_bf16(sacc[8 * ks + 4], sacc[8 * ks + 5]);
      pa[ks][3] = pack_bf16(sacc[8 * ks + 6], sacc[8 * ks + 7]);
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      // V, MN-major, 128-byte swizzled: 16 keys of 128 B a step; the next
      // 8 keys 1024 B on (SBO), the next 64 columns a region on (LBO)
      const uint64_t dv = make_desc(sta + Sh::kRegions * Sh::kKvRegion + ks * 16 * 128,
                                    Sh::kKvRegion, 1024, kSwizzle128);
      if constexpr (Sh::kRegions == 2) {
        wgmma_bf16_rs(om, pa[ks], dv);
      } else {
        wgmma_rs_n64(om, pa[ks], dv);
      }
      if constexpr (Sh::kTail) {  // columns 64..71: interleave, MN-major, 16 B a key
        wgmma_rs_n8(ot, pa[ks], make_desc(sta + Sh::kVTailOff + ks * 16 * 16, 128, 128,
                                          kInterleave));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(om);
    fence_regs(ot);
    fence_regs(pa);
    mbar_arrive(empty_bar(s));
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  // a row that saw no key writes 0 whatever its accumulator holds
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  if (kStats && lane % 4 == 0) {
    // each row's logsumexp of its scaled scores, in nats: m and log2(l) are
    // in the kernel's base 2 (scores x scale x log2(e)), converted once; a
    // row with no visible key writes +inf, which the backward reads as "no
    // pair" (exp(s - inf) = 0)
    float* lh = lse + static_cast<long long>(h) * S;
    if (r0.pos < S) lh[r0.pos] = l0 > 0.f ? (m0 + log2f(l0)) * kLn2 : INFINITY;
    if (r1.pos < S) lh[r1.pos] = l1 > 0.f ? (m1 + log2f(l1)) * kLn2 : INFINITY;
  }
  // the output in bf16, and with kStats its rounding residual (the f32
  // output minus the bf16 one, in bf16): the backward's rowsum(dO o O)
  // reads both, as if the output were f32
  auto store = [&](int pos, float x0, float x1, int col) {
    const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
    *reinterpret_cast<__nv_bfloat162*>(ob + pos * o_st + col) = hi;
    if constexpr (kStats)
      *reinterpret_cast<__nv_bfloat162*>(olb + pos * o_st + col) =
          __floats2bfloat162_rn(x0 - __low2float(hi), x1 - __high2float(hi));
  };
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + (lane % 4) * 2;
    const float* a = dt < Sh::kOMain / 4 ? om + 4 * dt : ot;
    if (r0.pos < S) store(r0.pos, a[0] * inv0, a[1] * inv0, col);
    if (r1.pos < S) store(r1.pos, a[2] * inv1, a[3] * inv1, col);
  }
}

// --- host side -------------------------------------------------------------

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, void* o_lo,
           const int* doc, const int* fan, const int* noise, const int* live_idx,
           const int* live_cnt,
           int S, int H, int KH, int nk_tab, long long q_st, long long q_sh, long long k_st,
           long long k_sh, long long v_st, long long v_sh, long long o_st, long long o_sh,
           float scale, cudaStream_t stream) {
  // a runtime call first: it makes the device's primary context current on
  // this thread, which cuTensorMapEncodeTiled needs (autograd's device
  // thread may not have one yet)
  constexpr int smem = Shape<D>::kSmemBytes;
  auto kernel = lse != nullptr ? sparse_packed_attention_kernel<D, true>
                               : sparse_packed_attention_kernel<D, false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  Maps maps;
  int err = 0;
  err = err ? err : make_view_map(&maps.q, q, D, H, S, q_st, q_sh, kRegionCols, kBQ, true);
  err = err ? err : make_view_map(&maps.k, k, D, KH, S, k_st, k_sh, kRegionCols, kBK, true);
  err = err ? err : make_view_map(&maps.v, v, D, KH, S, v_st, v_sh, kRegionCols, kBK, true);
  if (Shape<D>::kTail) {
    err = err ? err : make_view_map(&maps.q_tail, q, D, H, S, q_st, q_sh, 8, kBQ, false);
    err = err ? err : make_view_map(&maps.k_tail, k, D, KH, S, k_st, k_sh, 8, kBK, false);
    err = err ? err : make_view_map(&maps.v_tail, v, D, KH, S, v_st, v_sh, 8, kBK, false);
  } else {
    maps.q_tail = maps.q, maps.k_tail = maps.k, maps.v_tail = maps.v;  // unused
  }
  if (err) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H);
  kernel<<<grid, kThreads, smem, stream>>>(
      maps, static_cast<__nv_bfloat16*>(o), o_st, o_sh, lse, static_cast<__nv_bfloat16*>(o_lo),
      doc, fan, noise, live_idx, live_cnt, S, H / KH, nk_tab, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns 0 on success, else cudaGetLastError()'s
// code, or 100000 + the CUresult of a refused tensor map;
// cudaErrorInvalidValue for a head dim that is not instantiated, or for
// one of lse and o_lo null without the other. `lse`: null, or [H, S] f32
// that receives each row's logsumexp (nats; +inf for a row with no visible
// key); `o_lo`: null, or a second output with o's strides that receives
// the rounding residual of o (f32 output - o, in bf16). The output is the
// same bits either way.
int sparse_packed_attention_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                                 void* o_lo,
                                 const int* doc, const int* fan, const int* noise,
                                 const int* live_idx, const int* live_cnt,
                                 int S, int H, int KH, int D, int nk_tab,
                                 long long q_st, long long q_sh,
                                 long long k_st, long long k_sh,
                                 long long v_st, long long v_sh,
                                 long long o_st, long long o_sh,
                                 float scale, void* stream) {
  if ((lse == nullptr) != (o_lo == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (D) {
    case 72:
      return launch<72>(q, k, v, o, l, o_lo, doc, fan, noise, live_idx, live_cnt, S, H, KH,
                        nk_tab, q_st, q_sh, k_st, k_sh, v_st, v_sh, o_st, o_sh, scale, st);
    case 128:
      return launch<128>(q, k, v, o, l, o_lo, doc, fan, noise, live_idx, live_cnt, S, H, KH,
                         nk_tab, q_st, q_sh, k_st, k_sh, v_st, v_sh, o_st, o_sh, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* sparse_packed_attention_error_string(int code) {
  if (code >= kEncodeError)
    return "cuTensorMapEncodeTiled refused a tensor map (code - 100000 is the CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
