// Block-sparse packed attention for Hopper: the gradient.
//
// The gradient of sparse_packed_attention.cu's function for q, k and v. In
// the JAX package it is XLA's recompute through chunked_packed_attention
// (bagel_tpu/ops/sparse_flash.py:_bwd, the custom_vjp of
// sparse_packed_attention): no Pallas kernel. Here it is the flash
// backward over B3's tile tables, reading the logsumexp that the forward
// stores for each row:
//
//   P  = exp(S - lse),  S = q k^T scale (0 where the pair is not visible)
//   dV = P^T dO                 dP = dO V^T
//   dS = P o (dP - Delta),      Delta = rowsum(dO o O)
//   dQ = dS K scale             dK = dS^T Q scale
//
// summed over the group's query heads for dK and dV (GQA). Layouts: q/dO/O
// [S, H, D] and k/v [S, KH, D] bf16 through their sequence/head strides;
// dq [S, H, D] and dk/dv [S, KH, D] bf16, contiguous; lse and Delta [H, S]
// f32; ids int32 [S]. D = 72 (SigLIP, columns 72..79 padded as the forward
// pads them) and D = 128 (the LLM, GQA 28/4) are instantiated.
//
// What bounds it on an H100 (989 TFLOP/s bf16 dense): five products over
// the visible pairs, 10 D H pairs FLOPs (the recompute of QK^T in both
// kernels and of dP^T in dK/dV makes it 14 D H pairs as issued), against one
// read of q, k, v, O, dO and one write of dq, dk, dv. At the LLM's training
// shape (S = 33280, 6.0% of S^2 visible) that is ~2.4 ms of operations
// against ~0.4 ms of bytes: bound by operations, as the forward is.
//
// Three kernels, launched in this order on one stream:
// - sparse_bwd_delta_kernel: Delta = rowsum(dO o O) in f32, one warp a
//   (row, head); 0 on padding rows (document 0), whatever dO holds there.
//   O is the forward's bf16 output plus its rounding residual (o_lo, which
//   the forward writes when asked): Delta's error reaches every dS of its
//   row with the same sign, and from the bf16 output alone it would be
//   the largest part of the elementwise error of dq and dk.
// - sparse_bwd_dkdv_kernel: one block per (KV head, 128-key tile). It walks
//   the tile's live 128-row query tiles (the transposed table, ascending)
//   for each of its G query heads in turn, 64 query rows a step. Two
//   consumer warpgroups hold 64 keys each; per step each computes
//   S^T = K Q^T and dP^T = V dO^T (wgmma m64n64, K and V from the block's
//   tiles, Q and dO from the step's stage), P^T = exp2(S^T scale log2e -
//   lse log2e) and dS^T = P^T o (dP^T - Delta) in registers, then
//   dV += P^T dO and dK += dS^T Q with P^T and dS^T rounded to bf16 as A
//   from registers (the forward's PV). dK and dV stay in f32 registers over
//   the whole group, in a fixed order, and are written once: no atomics, so
//   the gradient is deterministic.
// - sparse_bwd_dq_kernel: one block per (query head, 128-row tile). It walks
//   the forward's table; each 128-key tile goes in two halves of 64 keys:
//   S = Q K^T, dP = dO V^T, dS = P o (dP - Delta), dQ += dS K.
// Both big kernels are the forward's design: a producer warp feeds a ring
// of shared-memory stages with TMA (128-byte swizzled regions and D = 72's
// interleave tail, sparse_packed.cuh), completed on mbarriers; the
// consumers release a stage on its "empty" mbarrier; setmaxnreg moves the
// producer's registers to the consumers. A tile flagged FULL_TILE skips the
// per-element predicate; other tiles apply it from the staged ids.
//
// No NaN reaches a product: padding tokens (document 0) may hold stale NaN
// in q, k, v and dO. In a tile without the full flag the consumers zero the
// shared-memory rows of padding tokens (Q and dO rows of queries, K and V
// rows of keys) before any product reads them; Delta is 0 there and a row
// with no visible key has lse = +inf (P = 0). dQ of padding queries and
// dK/dV of padding keys are written as exact 0; a tile with no live
// partner writes 0 without reading anything.
//
// What it leaves on the table: no overlap of one step's products with the
// next step's softmax, dQ recomputes S and dP (a second pass over the
// pairs) instead of accumulating dQ across blocks with atomics, and no
// persistent grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sparse_packed.cuh"

namespace {

using namespace sparse;

constexpr int kConsumers = 2;                     // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer's warpgroup
constexpr int kQStep = 64;                        // query rows of a dK/dV step
constexpr float kLog2e = 1.4426950408889634f;

struct Maps {  // one TMA tensor map per operand and column region
  CUtensorMap q, q_tail, g, g_tail, k, k_tail, v, v_tail;
};

template <int D>
struct KvPlan {  // dK/dV: the block's K and V tiles, then a ring of Q/dO steps
  using KV = Tile<D, kBK>;
  using QS = Tile<D, kQStep>;
  static constexpr int kStages = 4;
  static constexpr int kIdsOff = 2 * QS::kBytes;  // lse (base 2), Delta, doc, fan, noise [kQStep]
  static constexpr int kStageBytes = round_up(kIdsOff + 5 * kQStep * 4, 1024);
  static constexpr int kSmemBytes = 1024 + 2 * KV::kBytes + kStages * kStageBytes + 128;
};

template <int D>
struct QPlan {  // dQ: the block's Q and dO tiles, then a ring of K/V tiles
  using QT = Tile<D, kBK>;
  using KV = Tile<D, kBK>;
  static constexpr int kStages = D == 128 ? 2 : 3;
  static constexpr int kIdsOff = 2 * KV::kBytes;  // doc, fan, noise [kBK]
  static constexpr int kStageBytes = round_up(kIdsOff + 3 * kBK * 4, 1024);
  static constexpr int kSmemBytes = 1024 + 2 * QT::kBytes + kStages * kStageBytes + 128;
};

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows of 128 B
  return raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
}

// rows r0 .. r0 + 127 (those < S) of head h of a contiguous [S, heads, D]
// output written as 0
template <int D>
__device__ __forceinline__ void zero_out_rows(__nv_bfloat16* out, long long row_st, int h, int r0,
                                              int S) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int c = threadIdx.x; c < kBK * (D / 8); c += blockDim.x) {
    const int t = r0 + c / (D / 8);
    if (t < S)
      *reinterpret_cast<uint4*>(out + t * row_st + static_cast<long long>(h) * D +
                                (c % (D / 8)) * 8) = zero;
  }
}

// zero the shared-memory rows (of tiles a and b, ROWS rows each) whose
// token is padding, then wait for this warpgroup's 128 threads. Each
// consumer warpgroup zeroes every row it will read (the other may write
// the same zeros): no wait across warpgroups.
template <class T, class Dead>
__device__ __forceinline__ void zero_dead_rows(unsigned char* a, unsigned char* b, int row0,
                                               int rows, int wt, int wg, Dead dead) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int c = wt; c < rows * T::kChunks; c += 128) {
    const int row = row0 + c / T::kChunks, ch = c % T::kChunks;
    if (dead(row)) {
      *reinterpret_cast<uint4*>(T::chunk(a, row, ch)) = zero;
      *reinterpret_cast<uint4*>(T::chunk(b, row, ch)) = zero;
    }
  }
  fence_async_smem();
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// one row's bf16 output pair from the f32 accumulators (x scale), or 0
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b, float scale, bool live) {
  *reinterpret_cast<__nv_bfloat162*>(p) =
      live ? __floats2bfloat162_rn(a * scale, b * scale) : __floats2bfloat162_rn(0.f, 0.f);
}

// --- Delta = rowsum(dO o O) --------------------------------------------------

__global__ void sparse_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o,
                                        const __nv_bfloat16* __restrict__ o_lo, long long o_st,
                                        long long o_sh, const __nv_bfloat16* __restrict__ g,
                                        long long g_st, long long g_sh,
                                        const int* __restrict__ doc, float* __restrict__ delta,
                                        int S, int H, int D) {
  const long long w = static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= static_cast<long long>(S) * H) return;
  const int i = static_cast<int>(w / H), h = static_cast<int>(w % H);
  const long long oi = i * o_st + h * o_sh;
  const __nv_bfloat16* grow = g + i * g_st + h * g_sh;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float oc = __bfloat162float(o[oi + c]) + __bfloat162float(o_lo[oi + c]);
    acc += oc * __bfloat162float(grow[c]);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[static_cast<long long>(h) * S + i] = doc[i] != 0 ? acc : 0.f;
}

// --- dK and dV -----------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
sparse_bwd_dkdv_kernel(const __grid_constant__ Maps maps, __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, const float* __restrict__ lse,
                       const float* __restrict__ delta, const int* __restrict__ doc,
                       const int* __restrict__ fan, const int* __restrict__ noise,
                       const int* __restrict__ t_idx, const int* __restrict__ t_cnt, int S,
                       int KH, int group, int n_tab, float scale_log2, float scale) {
  using P = KvPlan<D>;
  using KV = typename P::KV;
  using QS = typename P::QS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* sk = smem;
  unsigned char* sv = smem + KV::kBytes;
  unsigned char* stages = smem + 2 * KV::kBytes;
  const uint32_t bars = smem_addr(stages + P::kStages * P::kStageBytes);
  auto full_bar = [&](int s) { return bars + 8 * s; };
  auto empty_bar = [&](int s) { return bars + 8 * (P::kStages + s); };
  const uint32_t kv_bar = bars + 16 * P::kStages;

  const int kt = blockIdx.x, kh = blockIdx.y, k0 = kt * kBK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_tiles = t_cnt[kt];
  const int* tab = t_idx + static_cast<long long>(kt) * n_tab;
  const long long row_st = static_cast<long long>(KH) * D;

  if (n_tiles == 0) {  // no query sees a key of this tile: dK = dV = 0
    zero_out_rows<D>(dk, row_st, kh, k0, S);
    zero_out_rows<D>(dv, row_st, kh, k0, S);
    return;
  }

  if (tid == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(full_bar(s), 32);                 // the producer warp's lanes
      mbar_init(empty_bar(s), kConsumers * 128);  // every consumer thread
    }
    mbar_init(kv_bar, 1);
    mbar_init_fence();
  }
  if (KV::kTail) {  // the zero chunks standing for columns 72..79
    KV::zero_tail(sk, tid, kThreads);
    KV::zero_tail(sv, tid, kThreads);
    for (int s = 0; s < P::kStages; ++s) {
      QS::zero_tail(stages + s * P::kStageBytes, tid, kThreads);
      QS::zero_tail(stages + s * P::kStageBytes + QS::kBytes, tid, kThreads);
    }
    fence_async_smem();
  }
  __syncthreads();

  // step n: query head kh G + n / (2 n_tiles), table entry (n / 2) % n_tiles,
  // its half n % 2; a half past S is skipped (by both sides), and m counts
  // the steps that use a stage
  const int steps = group * n_tiles * 2;
  if (warp >= 4 * kConsumers) {
    // ---- producer: one warp of the last warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp != 4 * kConsumers) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_bar, 2 * KV::kTx);
      KV::load(sk, &maps.k, &maps.k_tail, kv_bar, kh, k0);
      KV::load(sv, &maps.v, &maps.v_tail, kv_bar, kh, k0);
    }
    for (int n = 0, m = 0; n < steps; ++n) {
      const int h = kh * group + n / (2 * n_tiles);
      const int q0 = (tab[(n / 2) % n_tiles] & ~kFullTile) * kBK + (n % 2) * kQStep;
      if (q0 >= S) continue;
      const int s = m % P::kStages;
      mbar_wait(empty_bar(s), ((m / P::kStages) & 1) ^ 1);  // the first round passes
      ++m;
      unsigned char* st = stages + s * P::kStageBytes;
      float* slse = reinterpret_cast<float*>(st + P::kIdsOff);
      float* sdelta = slse + kQStep;
      int* sdoc = reinterpret_cast<int*>(sdelta + kQStep);
      for (int e = lane; e < kQStep; e += 32) {
        const int i = q0 + e;
        const bool ok = i < S;
        const long long hi = static_cast<long long>(h) * S + i;
        slse[e] = ok ? lse[hi] * kLog2e : INFINITY;  // base 2, converted once
        sdelta[e] = ok ? delta[hi] : 0.f;
        sdoc[e] = ok ? doc[i] : 0;
        sdoc[kQStep + e] = ok ? fan[i] : -1;
        sdoc[2 * kQStep + e] = ok ? noise[i] : -1;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(full_bar(s), 2 * QS::kTx);
        QS::load(st, &maps.q, &maps.q_tail, full_bar(s), h, q0);
        QS::load(st + QS::kBytes, &maps.g, &maps.g_tail, full_bar(s), h, q0);
      } else {
        mbar_arrive(full_bar(s));
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg takes keys k0 + 64 wg .. + 63 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = warp / 4, wt = tid % 128;
  RowIds kr0, kr1;  // this thread's two keys (accumulator rows lane/4 and lane/4 + 8)
  kr0.load(k0 + 64 * wg + 16 * (warp % 4) + lane / 4, S, doc, fan, noise);
  kr1.load(kr0.pos + 8, S, doc, fan, noise);

  mbar_wait(kv_bar, 0);
  // K and V rows of padding keys (keys past S arrive as zeros)
  zero_dead_rows<KV>(sk, sv, 0, kBK, wt, wg,
                     [&](int row) { return k0 + row < S && doc[k0 + row] == 0; });

  float dkm[KV::kOMain], dkt[4], dvm[KV::kOMain], dvt[4];
#pragma unroll
  for (int i = 0; i < KV::kOMain; ++i) dkm[i] = 0.f, dvm[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) dkt[i] = 0.f, dvt[i] = 0.f;
  const uint32_t k_s = smem_addr(sk), v_s = smem_addr(sv);

  for (int n = 0, m = 0; n < steps; ++n) {
    const int entry = tab[(n / 2) % n_tiles];
    const bool full = entry & kFullTile;
    const int q0 = (entry & ~kFullTile) * kBK + (n % 2) * kQStep;
    if (q0 >= S) continue;
    const int s = m % P::kStages;
    mbar_wait(full_bar(s), (m / P::kStages) & 1);
    ++m;
    unsigned char* st = stages + s * P::kStageBytes;
    const float* slse = reinterpret_cast<const float*>(st + P::kIdsOff);
    const float* sdelta = slse + kQStep;
    const int* sdoc = reinterpret_cast<const int*>(sdelta + kQStep);
    const int* sfan = sdoc + kQStep;
    const int* snoise = sfan + kQStep;
    if (!full)  // Q and dO rows of padding queries
      zero_dead_rows<QS>(st, st + QS::kBytes, 0, kQStep, wt, wg,
                         [&](int row) { return sdoc[row] == 0; });

    const uint32_t q_s = smem_addr(st), g_s = q_s + QS::kBytes;
    float sacc[32], pacc[32];
    issue_abt<D, kBK, kQStep>(sacc, k_s, 64 * wg, q_s, 0);  // S^T = K Q^T
    issue_abt<D, kBK, kQStep>(pacc, v_s, 64 * wg, g_s, 0);  // dP^T = V dO^T
    wgmma_wait<0>();
    fence_regs(sacc);
    fence_regs(pacc);

    // accumulator i holds key row lane/4 (i & 2 == 0) or lane/4 + 8, query
    // column 8 (i / 4) + 2 (lane % 4) + (i & 1); the 8 of k16 step ks re-pack
    // as its A fragment
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      float p[8], ds[8];
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int i = 8 * ks + x;
        const int col = 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
        const RowIds& key = (i & 2) ? kr1 : kr0;
        const bool vis = full || visible(q0 + col, sdoc[col], sfan[col], snoise[col], key.pos,
                                         key.doc, key.fan, key.noise);
        p[x] = vis ? fast_exp2(fmaf(sacc[i], scale_log2, -slse[col])) : 0.f;
        ds[x] = p[x] * (pacc[i] - sdelta[col]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[ks][r] = pack_bf16(p[2 * r], p[2 * r + 1]);
        da[ks][r] = pack_bf16(ds[2 * r], ds[2 * r + 1]);
      }
    }
    wgmma_fence();
    issue_pb<D, kQStep, 4>(dvm, dvt, pa, g_s, 0);  // dV += P^T dO
    issue_pb<D, kQStep, 4>(dkm, dkt, da, q_s, 0);  // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dvm);
    fence_regs(dvt);
    fence_regs(dkm);
    fence_regs(dkt);
    fence_regs(pa);
    fence_regs(da);
    mbar_arrive(empty_bar(s));
  }

  // dK x scale, dV; padding keys write 0
  const long long c0 = static_cast<long long>(kh) * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + (lane % 4) * 2;
    const float* a = dt < KV::kOMain / 4 ? dkm + 4 * dt : dkt;
    const float* b = dt < KV::kOMain / 4 ? dvm + 4 * dt : dvt;
    if (kr0.pos < S) {
      store2(dk + kr0.pos * row_st + c0 + col, a[0], a[1], scale, kr0.doc != 0);
      store2(dv + kr0.pos * row_st + c0 + col, b[0], b[1], 1.f, kr0.doc != 0);
    }
    if (kr1.pos < S) {
      store2(dk + kr1.pos * row_st + c0 + col, a[2], a[3], scale, kr1.doc != 0);
      store2(dv + kr1.pos * row_st + c0 + col, b[2], b[3], 1.f, kr1.doc != 0);
    }
  }
}

// --- dQ ----------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
sparse_bwd_dq_kernel(const __grid_constant__ Maps maps, __nv_bfloat16* __restrict__ dq,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ doc, const int* __restrict__ fan,
                     const int* __restrict__ noise, const int* __restrict__ live_idx,
                     const int* __restrict__ live_cnt, int S, int H, int group, int n_tab,
                     float scale_log2, float scale) {
  using P = QPlan<D>;
  using QT = typename P::QT;
  using KV = typename P::KV;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* sq = smem;
  unsigned char* sg = smem + QT::kBytes;
  unsigned char* stages = smem + 2 * QT::kBytes;
  const uint32_t bars = smem_addr(stages + P::kStages * P::kStageBytes);
  auto full_bar = [&](int s) { return bars + 8 * s; };
  auto empty_bar = [&](int s) { return bars + 8 * (P::kStages + s); };
  const uint32_t q_bar = bars + 16 * P::kStages;

  const int qt = blockIdx.x, h = blockIdx.y, q0 = qt * kBK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_tiles = live_cnt[qt];
  const int* tab = live_idx + static_cast<long long>(qt) * n_tab;
  const long long row_st = static_cast<long long>(H) * D;

  if (n_tiles == 0) {  // no live key tile: dQ = 0
    zero_out_rows<D>(dq, row_st, h, q0, S);
    return;
  }

  if (tid == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(full_bar(s), 32);
      mbar_init(empty_bar(s), kConsumers * 128);
    }
    mbar_init(q_bar, 1);
    mbar_init_fence();
  }
  if (QT::kTail) {
    QT::zero_tail(sq, tid, kThreads);
    QT::zero_tail(sg, tid, kThreads);
    for (int s = 0; s < P::kStages; ++s) {
      KV::zero_tail(stages + s * P::kStageBytes, tid, kThreads);
      KV::zero_tail(stages + s * P::kStageBytes + KV::kBytes, tid, kThreads);
    }
    fence_async_smem();
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp != 4 * kConsumers) return;
    const int kh = h / group;
    if (lane == 0) {
      mbar_arrive_expect_tx(q_bar, 2 * QT::kTx);
      QT::load(sq, &maps.q, &maps.q_tail, q_bar, h, q0);
      QT::load(sg, &maps.g, &maps.g_tail, q_bar, h, q0);
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % P::kStages;
      mbar_wait(empty_bar(s), ((it / P::kStages) & 1) ^ 1);
      const int j0 = (tab[it] & ~kFullTile) * kBK;
      unsigned char* st = stages + s * P::kStageBytes;
      int* ids = reinterpret_cast<int*>(st + P::kIdsOff);  // [doc, fan, noise][kBK]
      for (int e = lane; e < kBK; e += 32) {
        const int j = j0 + e;
        const bool ok = j < S;
        ids[e] = ok ? doc[j] : 0;
        ids[kBK + e] = ok ? fan[j] : -1;
        ids[2 * kBK + e] = ok ? noise[j] : -1;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(full_bar(s), 2 * KV::kTx);
        KV::load(st, &maps.k, &maps.k_tail, full_bar(s), kh, j0);
        KV::load(st + KV::kBytes, &maps.v, &maps.v_tail, full_bar(s), kh, j0);
      } else {
        mbar_arrive(full_bar(s));
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg takes query rows q0 + 64 wg .. + 63 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = warp / 4, wt = tid % 128;
  RowIds r0, r1;  // this thread's two rows
  r0.load(q0 + 64 * wg + 16 * (warp % 4) + lane / 4, S, doc, fan, noise);
  r1.load(r0.pos + 8, S, doc, fan, noise);
  const long long hs = static_cast<long long>(h) * S;
  const float lse0 = r0.pos < S ? lse[hs + r0.pos] * kLog2e : INFINITY;
  const float lse1 = r1.pos < S ? lse[hs + r1.pos] * kLog2e : INFINITY;
  const float del0 = r0.pos < S ? delta[hs + r0.pos] : 0.f;
  const float del1 = r1.pos < S ? delta[hs + r1.pos] : 0.f;

  mbar_wait(q_bar, 0);
  // Q and dO rows of this warpgroup's padding queries
  zero_dead_rows<QT>(sq, sg, 64 * wg, 64, wt, wg,
                     [&](int row) { return q0 + row < S && doc[q0 + row] == 0; });

  float dqm[QT::kOMain], dqt[4];
#pragma unroll
  for (int i = 0; i < QT::kOMain; ++i) dqm[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) dqt[i] = 0.f;
  const uint32_t q_s = smem_addr(sq), g_s = smem_addr(sg);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % P::kStages;
    const int entry = tab[it];
    const bool full = entry & kFullTile;
    const int j0 = (entry & ~kFullTile) * kBK;
    mbar_wait(full_bar(s), (it / P::kStages) & 1);
    unsigned char* st = stages + s * P::kStageBytes;
    const int* sdoc = reinterpret_cast<const int*>(st + P::kIdsOff);
    const int* sfan = sdoc + kBK;
    const int* snoise = sfan + kBK;
    if (!full)  // K and V rows of padding keys
      zero_dead_rows<KV>(st, st + KV::kBytes, 0, kBK, wt, wg,
                         [&](int row) { return sdoc[row] == 0; });
    const uint32_t k_s = smem_addr(st), v_s = k_s + KV::kBytes;

#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      float sacc[32], pacc[32];
      issue_abt<D, kBK, kBK>(sacc, q_s, 64 * wg, k_s, 64 * half);  // S = Q K^T
      issue_abt<D, kBK, kBK>(pacc, g_s, 64 * wg, v_s, 64 * half);  // dP = dO V^T
      wgmma_wait<0>();
      fence_regs(sacc);
      fence_regs(pacc);
      uint32_t da[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        float ds[8];
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const int i = 8 * ks + x;
          const int jl = 64 * half + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
          const bool second = i & 2;
          const RowIds& row = second ? r1 : r0;
          const bool vis = full || visible(row.pos, row.doc, row.fan, row.noise, j0 + jl,
                                           sdoc[jl], sfan[jl], snoise[jl]);
          const float p = vis ? fast_exp2(fmaf(sacc[i], scale_log2, -(second ? lse1 : lse0)))
                              : 0.f;
          ds[x] = p * (pacc[i] - (second ? del1 : del0));
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) da[ks][r] = pack_bf16(ds[2 * r], ds[2 * r + 1]);
      }
      wgmma_fence();
      issue_pb<D, kBK, 4>(dqm, dqt, da, k_s, 64 * half);  // dQ += dS K
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dqm);
      fence_regs(dqt);
      fence_regs(da);
    }
    mbar_arrive(empty_bar(s));
  }

  // dQ x scale; padding queries write 0
  const long long c0 = static_cast<long long>(h) * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + (lane % 4) * 2;
    const float* a = dt < QT::kOMain / 4 ? dqm + 4 * dt : dqt;
    if (r0.pos < S) store2(dq + r0.pos * row_st + c0 + col, a[0], a[1], scale, r0.doc != 0);
    if (r1.pos < S) store2(dq + r1.pos * row_st + c0 + col, a[2], a[3], scale, r1.doc != 0);
  }
}

// --- host side -------------------------------------------------------------

// the maps of one kernel: q and dO in boxes of q_rows rows, k and v of kBK
int make_maps(Maps* m, int D, int S, int H, int KH, int q_rows, const void* q, long long q_st,
              long long q_sh, const void* g, long long g_st, long long g_sh, const void* k,
              long long k_st, long long k_sh, const void* v, long long v_st, long long v_sh) {
  int err = 0;
  err = err ? err : make_view_map(&m->q, q, D, H, S, q_st, q_sh, kRegionCols, q_rows, true);
  err = err ? err : make_view_map(&m->g, g, D, H, S, g_st, g_sh, kRegionCols, q_rows, true);
  err = err ? err : make_view_map(&m->k, k, D, KH, S, k_st, k_sh, kRegionCols, kBK, true);
  err = err ? err : make_view_map(&m->v, v, D, KH, S, v_st, v_sh, kRegionCols, kBK, true);
  if (D % kRegionCols) {
    err = err ? err : make_view_map(&m->q_tail, q, D, H, S, q_st, q_sh, 8, q_rows, false);
    err = err ? err : make_view_map(&m->g_tail, g, D, H, S, g_st, g_sh, 8, q_rows, false);
    err = err ? err : make_view_map(&m->k_tail, k, D, KH, S, k_st, k_sh, 8, kBK, false);
    err = err ? err : make_view_map(&m->v_tail, v, D, KH, S, v_st, v_sh, 8, kBK, false);
  } else {  // unused
    m->q_tail = m->q, m->g_tail = m->g, m->k_tail = m->k, m->v_tail = m->v;
  }
  return err;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* o_lo,
           const void* g, void* dq,
           void* dk, void* dv, const float* lse, float* delta, const int* doc, const int* fan,
           const int* noise, const int* live_idx, const int* live_cnt, const int* t_idx,
           const int* t_cnt, int S, int H, int KH, int n_tab, long long q_st, long long q_sh,
           long long k_st, long long k_sh, long long v_st, long long v_sh, long long o_st,
           long long o_sh, long long g_st, long long g_sh, float scale, cudaStream_t stream) {
  // runtime calls first: they make the device's primary context current on
  // this thread, which cuTensorMapEncodeTiled needs (autograd's device
  // thread, where this runs, may not have one yet)
  constexpr int kv_smem = KvPlan<D>::kSmemBytes, q_smem = QPlan<D>::kSmemBytes;
  cudaError_t e = cudaFuncSetAttribute(sparse_bwd_dkdv_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kv_smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(sparse_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             q_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  Maps kv_maps, q_maps;
  int err = make_maps(&kv_maps, D, S, H, KH, kQStep, q, q_st, q_sh, g, g_st, g_sh, k, k_st, k_sh,
                      v, v_st, v_sh);
  err = err ? err : make_maps(&q_maps, D, S, H, KH, kBK, q, q_st, q_sh, g, g_st, g_sh, k, k_st,
                              k_sh, v, v_st, v_sh);
  if (err) return err;
  const float scale_log2 = scale * kLog2e;
  const long long warps = static_cast<long long>(S) * H;
  sparse_bwd_delta_kernel<<<static_cast<unsigned>((warps + 7) / 8), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(o_lo), o_st, o_sh,
      static_cast<const __nv_bfloat16*>(g),
      g_st, g_sh, doc, delta, S, H, D);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n = (S + kBK - 1) / kBK;
  sparse_bwd_dkdv_kernel<D><<<dim3(n, KH), kThreads, kv_smem, stream>>>(
      kv_maps, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), lse, delta, doc,
      fan, noise, t_idx, t_cnt, S, KH, H / KH, n_tab, scale_log2, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  sparse_bwd_dq_kernel<D><<<dim3(n, H), kThreads, q_smem, stream>>>(
      q_maps, static_cast<__nv_bfloat16*>(dq), lse, delta, doc, fan, noise, live_idx, live_cnt,
      S, H, H / KH, n_tab, scale_log2, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The gradient of sparse_packed_attention_bf16's output for q, k and v:
// dq [S, H, D], dk/dv [S, KH, D] (bf16, contiguous) from the forward's
// output o, its rounding residual o_lo (o's strides) and its
// lse ([H, S] f32, nats), and the output's gradient g (o and g through
// their strides). delta: [H, S] f32 scratch. live_idx /
// live_cnt: the forward's table [n_tab, n_tab] and counts; t_idx / t_cnt:
// its transpose (each key tile's live query tiles, ascending, with the
// same FULL_TILE flags). Three launches on `stream`; returns 0 on success,
// else cudaGetLastError()'s code, or 100000 + the CUresult of a refused
// tensor map; cudaErrorInvalidValue for a head dim that is not
// instantiated.
int sparse_packed_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                                     const void* o_lo, const void* g, void* dq, void* dk, void* dv,
                                     const void* lse, void* delta, const int* doc,
                                     const int* fan, const int* noise, const int* live_idx,
                                     const int* live_cnt, const int* t_idx, const int* t_cnt,
                                     int S, int H, int KH, int D, int n_tab,
                                     long long q_st, long long q_sh, long long k_st,
                                     long long k_sh, long long v_st, long long v_sh,
                                     long long o_st, long long o_sh, long long g_st,
                                     long long g_sh, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  switch (D) {
    case 72:
      return launch<72>(q, k, v, o, o_lo, g, dq, dk, dv, l, d, doc, fan, noise, live_idx,
                        live_cnt, t_idx, t_cnt, S, H, KH, n_tab, q_st, q_sh, k_st, k_sh, v_st,
                        v_sh, o_st, o_sh, g_st, g_sh, scale, st);
    case 128:
      return launch<128>(q, k, v, o, o_lo, g, dq, dk, dv, l, d, doc, fan, noise, live_idx,
                         live_cnt, t_idx, t_cnt, S, H, KH, n_tab, q_st, q_sh, k_st, k_sh, v_st,
                         v_sh, o_st, o_sh, g_st, g_sh, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* sparse_packed_attention_bwd_error_string(int code) {
  if (code >= kEncodeError)
    return "cuTensorMapEncodeTiled refused a tensor map (code - 100000 is the CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
