// Flash attention with int8 QK^T and PV products over a cached KV buffer,
// for Hopper: the w8a8 attention, and the quantization of its q/k/v.
//
// flash_q8_kernel replaces the TPU kernel bagel_tpu/ops/flash.py:_flash_kernel_q8
// (reached from flash_cached_attention(int8_compute=True), :279). Per
// 128-key tile, for each row:
//
//   s     = f32(q8 . k8) * ((qs * ks) * scale), masked as B1 masks
//   m'    = max(m, max_j s);  p = exp(s - m');  alpha = exp(m - m')
//   row_m = max(max_j p, 1e-20);  c = rint(p * (127 / row_m))   (int8 codes)
//   acc   = acc * alpha + f32(c . v8) * (row_m * (vs / 127))
//   l     = l * alpha + f32(sum_j c) * (row_m / 127)
//   out   = bf16(acc / max(l, 1e-20))
//
// so P is requantized per row and per key tile with V's scale folded in,
// and the denominator comes from the same dequantized P as the numerator.
// The result depends on the key tile (row_m is a max over one tile): the
// plain version takes the tile size and is held against this kernel at 128.
//
// q8_absmax_kernel + q8_quantize_kernel replace the wrapper's quantization
// (bagel_tpu/ops/flash.py:351-371, XLA's work in the JAX package), one
// device pass in two launches and no host read:
//   qs[b,h]  = max(max over all T rows and D of |q[b,:,h,:]|, 1e-12) / 127
//   ks[b,kh] = max(max over the live keys [0, past + valid) of |k|, 1e-12) / 127
//   (vs the same over v), codes clamp(rint(x / scale), -127, 127), the
//   IEEE quotient (see code_of) and round half to even: bit-identical to
//   the JAX expression. The first kernel writes each 64-row chunk's absmax; the
//   second reduces a (tensor, batch row, head)'s chunks, then writes the
//   codes of its own chunk. k8 and v8t are sized by the buffer's S (no
//   host read of the live maximum); codes past a row's live keys are 0 up
//   to the end of the 64-key chunk that holds the live end, and unwritten
//   beyond it. Nothing reads them unmasked.
//
// Layouts: q [B, T, H, 128] and k/v [B, S, KH, 128] bf16 through their
// strides; q8 [B, T, H, 128] and k8 [B, S, KH, 128] int8; v8t [B, KH, 128,
// S32] int8 (S32 = S rounded up to 32): V transposed, keys contiguous along
// a row, and within each 32-key group the keys permuted (position p holds
// key pi(p) = (p & ~15) | ((p & 12) >> 1) | ((p & 2) << 2) | (p & 1),
// ops/flash.py:q8_v_order). qs [B, H], ks/vs [B, KH] f32; out [B, T, H, 128]
// bf16.
//
// What bounds them on an H100 (1,979 TOP/s int8 dense, 3.35 TB/s):
// - The attention: at the 1024 px denoise call (B=3, T=4098, H=28, ~4130
//   live keys a row) 0.73e12 operations, 0.37 ms at the peak. But a score
//   costs 512 int8 operations (~0.26 ns at the peak) and also one exp2 on
//   the SFU (16 a clock per SM, ~3.7e12 a second over 132 SMs: ~0.39 ms at
//   that shape), plus its max, scale and requantization: the softmax, not
//   the products, sets the pace. So each step is one instruction where it
//   can be: an int32 score or PV sum becomes f32 by I2FP, a code is P
//   times 127 / row_m plus 1.5 * 2^23 in one FFMA (which rounds to nearest
//   even; the low byte is the code), and the codes of a row are summed
//   four at a time with dp4a. Per tile a consumer thread runs ~780
//   instructions for its 64 scores (70 of them on the SFU), 2 warps on
//   each scheduler.
// - The quantization: bytes. It reads q twice and the live k/v twice (the
//   second kernel walks the chunks in the reverse order, so its first reads
//   find the first kernel's last ones in L2, and starts its loads while
//   the first one ends: programmatic dependent launch) and writes the codes.
//
// Design of flash_q8_kernel (sparse_packed_attention.cu's, with integer wgmma):
// - A block takes a 128-row query tile of one (batch row, head): two
//   consumer warpgroups of 64 rows and one producer warp that loads Q once
//   and each live tile's K and V^T into a ring of four 32 KB stages with TMA
//   (4-D tensor maps, 128-byte swizzle), completed on full/empty mbarriers.
//   The key loop (live tiles only, capped at the causal diagonal) and the
//   full-tile flag are B1's.
// - QK^T: wgmma m64n128k32 .s32.s8.s8, Q and K K-major in shared memory.
// - PV: wgmma takes 8-bit operands only K-major and Hopper has no 8-bit
//   ldmatrix.trans, so V comes transposed from the prep (V^T rows of 128
//   keys are K-major). P comes from registers: the S accumulator of thread
//   (g = lane / 4, t = lane % 4) holds, for rows g and g + 8, keys 2t, 2t+1,
//   8+2t, 9+2t of each 16, while the 8-bit A fragment wants keys 4t..4t+3
//   and 16+4t..16+4t+3 of each 32 (CUTLASS's CLayout_64xN and
//   ALayout_64x32 of cute/atom/mma_traits_sm90_gmma.hpp). The prep's key
//   permutation pi puts into V^T position 4t + e the key that the thread's
//   e-th accumulator holds, so the codes pack without shuffles; the sum
//   over keys does not care about their order.
// - The two warpgroups take turns at the tensor cores (named barriers): a
//   turn issues PV of a tile and then QK^T of the next, which runs under
//   this tile's epilogue, so that one warpgroup's softmax runs under the
//   other's products (12% faster than without turns at the denoise shape).
//   Both walk every tile of the block so that the turns pair up: in a
//   causal block the first warpgroup's last tile is masked whole.
// - Keys past the live end hold code 0, codes the prep left unwritten, or
//   TMA's zeros (past S): their scores are masked, so P's code for them is
//   0, and the integer product of 0 and any code is 0 (no NaN in int8).
//
// What it leaves on the table: the softmax of the next tile does not run
// under this tile's PV (that needs a second S tile in registers, past the
// 232 a consumer thread has with O and the int32 PV sums), and the two
// warpgroups' softmaxes still overlap in part, so the SFU, the issue slots
// and the tensor cores are each busy well under half the time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kD = 128;
constexpr int kConsumers = 2;
constexpr int kTileQ = 64 * kConsumers;   // query rows a block
constexpr int kTileK = 128;               // keys a tile
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kStages = 4;
constexpr int kQBytes = kTileQ * kD;      // int8 rows of 128 bytes
constexpr int kKBytes = kTileK * kD;
constexpr int kVBytes = kD * kTileK;      // V^T: 128 columns of D x 128 keys
constexpr int kStageBytes = kKBytes + kVBytes;
constexpr int kSmemBytes = 1024 + kQBytes + kStages * kStageBytes + 128;
constexpr float kMagicF = 12582912.f;     // 1.5 * 2^23

// the prep
constexpr int kChunk = 64;                // rows (keys) of a prep block
constexpr int kPrepThreads = 256;
constexpr int kRowPasses = kChunk / (kPrepThreads / 16);  // q/k: 16 threads a row of 16 vectors
constexpr int kVecGroups = kPrepThreads / kChunk;         // v: thread groups of one key each
static_assert(kChunk % 32 == 0 && kPrepThreads % kChunk == 0 && 16 % kVecGroups == 0, "prep shape");

struct Strides {  // in elements: batch, sequence, head
  long long b, t, h;
};

struct Maps {  // TMA tensor maps of q8, k8 and v8t
  CUtensorMap q, k, v;
};


// the 4 low bytes of 4 words: bytes 0..3 = a, b, c, d
__device__ __forceinline__ uint32_t low_bytes(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

__global__ void __launch_bounds__(kThreads, 1)
flash_q8_kernel(const __grid_constant__ Maps maps, __nv_bfloat16* __restrict__ o,
                const float* __restrict__ qs, const float* __restrict__ ks,
                const float* __restrict__ vs, const int* __restrict__ past_len,
                const int* __restrict__ q_valid, int T, int S, int H, int KH, float scale,
                int causal) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sq = smem;
  unsigned char* stages = smem + kQBytes;
  const uint32_t bars = smem_addr(stages + kStages * kStageBytes);
  auto full_bar = [&](int s) { return bars + 8 * s; };
  auto empty_bar = [&](int s) { return bars + 8 * (kStages + s); };
  const uint32_t q_bar = bars + 16 * kStages;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, q0 = qt * kTileQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kh = h / (H / KH);
  const int past = past_len[b];
  const int valid = min(q_valid[b], T);
  const int live = min(past + valid, S);
  const int bound = causal ? min(live, past + q0 + kTileQ) : live;
  const int n_tiles = (q0 < valid && bound > 0) ? (bound + kTileK - 1) / kTileK : 0;
  __nv_bfloat16* ob = o + ((static_cast<long long>(b) * T) * H + h) * kD;
  const long long o_row = static_cast<long long>(H) * kD;

  if (n_tiles == 0) {
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int c = tid; c < kTileQ * (kD / 8); c += kThreads) {
      const int t = q0 + c / (kD / 8);
      if (t < T) *reinterpret_cast<uint4*>(ob + t * o_row + (c % (kD / 8)) * 8) = zero;
    }
    return;
  }

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), kConsumers * 128);
    }
    mbar_init(q_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {  // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp != 4 * kConsumers || lane != 0) return;
    mbar_arrive_expect_tx(q_bar, kQBytes);
    tma_load_4d(sq, &maps.q, q_bar, 0, h, q0, b);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      mbar_wait(empty_bar(s), ((it / kStages) & 1) ^ 1);
      unsigned char* st = stages + s * kStageBytes;
      mbar_arrive_expect_tx(full_bar(s), kStageBytes);
      tma_load_4d(st, &maps.k, full_bar(s), 0, kh, it * kTileK, b);
      tma_load_4d(st + kKBytes, &maps.v, full_bar(s), it * kTileK, 0, kh, b);
    }
    return;
  }

  // ---- consumers: warpgroup wg takes query rows q0 + 64 wg .. + 63 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = warp / 4;
  const int row0 = q0 + 64 * wg + 16 * (warp % 4) + lane / 4, row1 = row0 + 8;
  const int lim0 = row0 < valid ? min(causal ? past + row0 + 1 : live, live) : 0;
  const int lim1 = row1 < valid ? min(causal ? past + row1 + 1 : live, live) : 0;
  // every valid row of the warpgroup sees the keys below wg_lo
  const int wg_lo = min(causal ? past + q0 + 64 * wg + 1 : live, live);

  const float cqk = __fmul_rn(__fmul_rn(qs[b * H + h], ks[b * KH + kh]), scale);
  const float c2 = cqk * 1.4426950408889634f;  // scores to base-2 exponent units
  const float vs127 = __fdiv_rn(vs[b * KH + kh], 127.f);

  float oacc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) oacc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // m in base-2 units
  const uint32_t q_rows = smem_addr(sq) + wg * 64 * 128;
  mbar_wait(q_bar, 0);

  // The warpgroups take turns at the tensor cores: a turn issues PV of a
  // tile and QK^T of the next, then passes to the other warpgroup (named
  // barriers 3 + wg), so that one's softmax runs under the other's
  // products. Both walk every tile of the block (a tile past a warpgroup's
  // rows is masked whole), so that the turns pair up.
  const int mine = 3 + wg, other = 4 - wg;
  int si[64];  // S = Q K^T of the tile in flight, int32
  auto issue_qk = [&](int it) {
    mbar_wait(full_bar(it % kStages), (it / kStages) & 1);
    const uint32_t sta = smem_addr(stages + (it % kStages) * kStageBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_s8_ss(si, desc_sw128(q_rows + kk * 32, 16), desc_sw128(sta + kk * 32, 16), kk > 0);
    wgmma_commit();
  };
  issue_qk(0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages, j0 = it * kTileK;
    const uint32_t sta = smem_addr(stages + s * kStageBytes);
    wgmma_wait<0>();  // QK^T of this tile
    fence_regs(si);

    // scores in f32 (exact), masked unless every valid row sees the tile;
    // accumulator 4 nt + e: row lane/4 (e < 2) or lane/4 + 8, key
    // j0 + 8 nt + 2 (lane % 4) + e % 2
    float sf[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sf[i] = __int2float_rn(si[i]);
    if (j0 + kTileK > wg_lo) {
#pragma unroll
      for (int nt = 0; nt < kTileK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + nt * 8 + (lane % 4) * 2 + e;
          if (j >= lim0) sf[4 * nt + e] = -INFINITY;
          if (j >= lim1) sf[4 * nt + 2 + e] = -INFINITY;
        }
      }
    }
    // the rows' maxima as trees of four independent chains
    float mx0[4], mx1[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      mx0[c] = fmaxf(sf[4 * c], sf[4 * c + 1]);
      mx1[c] = fmaxf(sf[4 * c + 2], sf[4 * c + 3]);
    }
#pragma unroll
    for (int nt = 4; nt < kTileK / 8; ++nt) {
      mx0[nt % 4] = fmaxf(mx0[nt % 4], fmaxf(sf[4 * nt], sf[4 * nt + 1]));
      mx1[nt % 4] = fmaxf(mx1[nt % 4], fmaxf(sf[4 * nt + 2], sf[4 * nt + 3]));
    }
    // the tile's largest raw score of each row (-inf: none visible)
    const float t0 = quad_max(fmaxf(fmaxf(mx0[0], mx0[1]), fmaxf(mx0[2], mx0[3])));
    const float t1 = quad_max(fmaxf(fmaxf(mx1[0], mx1[1]), fmaxf(mx1[2], mx1[3])));
    const float mn0 = fmaxf(m0, t0 * c2), mn1 = fmaxf(m1, t1 * c2);
    const float base0 = mn0 == -INFINITY ? 0.f : mn0;  // no key seen yet: exp gives 0, not NaN
    const float base1 = mn1 == -INFINITY ? 0.f : mn1;
    const float alpha0 = fast_exp2(m0 - base0), alpha1 = fast_exp2(m1 - base1);
    m0 = mn0;
    m1 = mn1;
    // row_m: the largest p of the tile, that of the largest score (the same
    // FFMA and exp2 as its p below)
    const float rm0 = fmaxf(fast_exp2(fmaf(t0, c2, -base0)), 1e-20f);
    const float rm1 = fmaxf(fast_exp2(fmaf(t1, c2, -base1)), 1e-20f);
    const float inv0 = __fdiv_rn(127.f, rm0), inv1 = __fdiv_rn(127.f, rm1);
    // code of a score: rint(p * 127 / row_m) in [0, 127], the low byte of
    // p * inv + 1.5 * 2^23 (one FFMA, which rounds to nearest even)
    auto code = [&](float x, float base, float inv) {
      return __float_as_uint(fmaf(fast_exp2(fmaf(x, c2, -base)), inv, kMagicF));
    };
    // the A fragment of k32 step ks: a[0] row g keys 4t..4t+3 (accumulators
    // 16 ks + 0, 1, 4, 5), a[1] row g + 8 (+ 2, 3, 6, 7), a[2] row g keys
    // 16+4t.. (+ 8, 9, 12, 13), a[3] row g + 8 (+ 10, 11, 14, 15); V^T's
    // permutation puts the matching keys there
    uint32_t pa[4][4];
    int cs0 = 0, cs1 = 0;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const float* x = sf + 16 * ks;
      pa[ks][0] = low_bytes(code(x[0], base0, inv0), code(x[1], base0, inv0),
                            code(x[4], base0, inv0), code(x[5], base0, inv0));
      pa[ks][1] = low_bytes(code(x[2], base1, inv1), code(x[3], base1, inv1),
                            code(x[6], base1, inv1), code(x[7], base1, inv1));
      pa[ks][2] = low_bytes(code(x[8], base0, inv0), code(x[9], base0, inv0),
                            code(x[12], base0, inv0), code(x[13], base0, inv0));
      pa[ks][3] = low_bytes(code(x[10], base1, inv1), code(x[11], base1, inv1),
                            code(x[14], base1, inv1), code(x[15], base1, inv1));
      cs0 = __dp4a(static_cast<int>(pa[ks][0]), 0x01010101, cs0);
      cs0 = __dp4a(static_cast<int>(pa[ks][2]), 0x01010101, cs0);
      cs1 = __dp4a(static_cast<int>(pa[ks][1]), 0x01010101, cs1);
      cs1 = __dp4a(static_cast<int>(pa[ks][3]), 0x01010101, cs1);
    }

    // C V^T: 4 k32 steps, A (the codes) from registers
    int pv[64];
    if (wg == 1 || it > 0) asm volatile("bar.sync %0, 256;\n" ::"r"(mine) : "memory");  // my turn
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_s8_rs(pv, pa[ks], desc_sw128(sta + kKBytes + ks * 32, 16), ks > 0);
    wgmma_commit();
    cs0 = quad_sum(cs0);
    cs1 = quad_sum(cs1);
    l0 = __fadd_rn(__fmul_rn(l0, alpha0), __fmul_rn(__int2float_rn(cs0), __fdiv_rn(rm0, 127.f)));
    l1 = __fadd_rn(__fmul_rn(l1, alpha1), __fmul_rn(__int2float_rn(cs1), __fdiv_rn(rm1, 127.f)));
    const float f0 = __fmul_rn(rm0, vs127), f1 = __fmul_rn(rm1, vs127);
    wgmma_wait<0>();
    fence_regs(pv);
    fence_regs(pa);
    mbar_arrive(empty_bar(s));
    // QK^T of the next tile runs under this tile's epilogue (issued once PV
    // is done: the codes' registers are free then)
    if (it + 1 < n_tiles) issue_qk(it + 1);
    if (wg == 0 || it + 1 < n_tiles)  // the other's turn (each turn of one is paired)
      asm volatile("bar.arrive %0, 256;\n" ::"r"(other) : "memory");
    // acc = acc alpha + f32(C V) f; where no row of the warp changed its max
    // (alpha = 1 exactly) the product by alpha is left out: the same bits
    if (__all_sync(0xffffffffu, alpha0 == 1.f && alpha1 == 1.f)) {
#pragma unroll
      for (int i = 0; i < 64; i += 4) {  // |c . v8| <= 127^2 * 128 < 2^22
        oacc[i] = fmaf(__int2float_rn(pv[i]), f0, oacc[i]);
        oacc[i + 1] = fmaf(__int2float_rn(pv[i + 1]), f0, oacc[i + 1]);
        oacc[i + 2] = fmaf(__int2float_rn(pv[i + 2]), f1, oacc[i + 2]);
        oacc[i + 3] = fmaf(__int2float_rn(pv[i + 3]), f1, oacc[i + 3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 64; i += 4) {
        oacc[i] = fmaf(__int2float_rn(pv[i]), f0, oacc[i] * alpha0);
        oacc[i + 1] = fmaf(__int2float_rn(pv[i + 1]), f0, oacc[i + 1] * alpha0);
        oacc[i + 2] = fmaf(__int2float_rn(pv[i + 2]), f1, oacc[i + 2] * alpha1);
        oacc[i + 3] = fmaf(__int2float_rn(pv[i + 3]), f1, oacc[i + 3] * alpha1);
      }
    }
  }

  // rows past valid write 0 whatever their accumulators hold (a full tile
  // skips their mask); a row that saw no key has acc = 0
  const float d0 = fmaxf(l0, 1e-20f), d1 = fmaxf(l1, 1e-20f);
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
    const int col = dt * 8 + (lane % 4) * 2;
    const float* a = oacc + 4 * dt;
    if (row0 < T)
      *reinterpret_cast<__nv_bfloat162*>(ob + row0 * o_row + col) =
          row0 < valid ? __floats2bfloat162_rn(__fdiv_rn(a[0], d0), __fdiv_rn(a[1], d0))
                       : __floats2bfloat162_rn(0.f, 0.f);
    if (row1 < T)
      *reinterpret_cast<__nv_bfloat162*>(ob + row1 * o_row + col) =
          row1 < valid ? __floats2bfloat162_rn(__fdiv_rn(a[2], d1), __fdiv_rn(a[3], d1))
                       : __floats2bfloat162_rn(0.f, 0.f);
  }
}

// --- the prep --------------------------------------------------------------

// One prep task: a chunk of kChunk rows (keys) of one (tensor, batch row,
// head). Tasks are numbered q first ([B][H][nq]), then k ([B][KH][nk]), then
// v (the same); a head's chunks are consecutive.
struct Task {
  int tensor, b, head, chunk, first;  // first: the task number of the head's chunk 0
};

struct PrepArgs {
  const __nv_bfloat16 *q, *k, *v;
  Strides qs, ks, vs;
  int8_t *q8, *k8, *v8t;
  float *qscale, *kscale, *vscale, *part;
  const int *past_len, *q_valid;
  int B, T, S, S32, H, KH, nq, nk;
};

__device__ __forceinline__ Task task_of(const PrepArgs& a, const int task) {
  const int n_q = a.B * a.H * a.nq, n_k = a.B * a.KH * a.nk;
  Task r;
  int n, t = task;
  if (t < n_q) {
    r.tensor = 0, n = a.nq;
  } else {
    r.tensor = t < n_q + n_k ? 1 : 2, n = a.nk;
    t -= r.tensor == 1 ? n_q : n_q + n_k;
  }
  const int heads = r.tensor == 0 ? a.H : a.KH;
  r.chunk = t % n;
  r.head = (t / n) % heads;
  r.b = t / (n * heads);
  r.first = task - r.chunk;
  return r;
}

// the rows of a task's tensor that carry data: q all T rows; k/v the live keys
__device__ __forceinline__ int rows_of(const PrepArgs& a, const Task& w) {
  return w.tensor == 0 ? a.T : min(a.past_len[w.b] + a.q_valid[w.b], a.S);
}

__device__ __forceinline__ const __nv_bfloat16* row_ptr(const PrepArgs& a, const Task& w, int row) {
  const __nv_bfloat16* base = w.tensor == 0 ? a.q : w.tensor == 1 ? a.k : a.v;
  const Strides& st = w.tensor == 0 ? a.qs : w.tensor == 1 ? a.ks : a.vs;
  return base + w.b * st.b + row * st.t + w.head * st.h;
}

// 8 bf16 values (16 bytes) of a row
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

// the block's max of v (every thread's), returned to every thread
__device__ __forceinline__ float block_max(float v) {
  __shared__ float red[kPrepThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < kPrepThreads / 32; ++w) v = fmaxf(v, red[w]);
  return v;
}

// pass 1: each task's absmax over its chunk's data rows (0 if none). The
// rows stay packed bf16 (few registers: 8 blocks an SM keep their loads in
// flight), and |x| and max are exact in bf16.
__global__ void __launch_bounds__(kPrepThreads, 8)
q8_absmax_kernel(const PrepArgs a) {
  // pass 2 may launch now: its blocks load their rows, then wait for this
  // grid's end (griddepcontrol.wait) before they read the partials
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const Task w = task_of(a, blockIdx.x);
  const int rows = rows_of(a, w);
  const int sub = threadIdx.x / 16, vec = threadIdx.x % 16;  // 16 rows of 16 vectors a pass
  uint4 raw[kRowPasses];
#pragma unroll
  for (int i = 0; i < kRowPasses; ++i) {  // every load in flight before the first max
    const int row = w.chunk * kChunk + 16 * i + sub;
    raw[i] = row < rows ? load8(row_ptr(a, w, row) + vec * 8) : make_uint4(0, 0, 0, 0);
  }
  __nv_bfloat162 m2 = __float2bfloat162_rn(0.f);
#pragma unroll
  for (int i = 0; i < kRowPasses; ++i) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw[i]);
#pragma unroll
    for (int e = 0; e < 4; ++e) m2 = __hmax2(m2, __habs2(h[e]));
  }
  const float m = block_max(fmaxf(__low2float(m2), __high2float(m2)));
  if (threadIdx.x == 0) a.part[blockIdx.x] = m;
}

// round half to even of x / s as a code: the low byte of the returned word,
// x / s + 1.5 * 2^23 (the add rounds to nearest even). The quotient is
// IEEE's: with r = RN(1 / s), q = RN(x r) is within an ulp of x / s, and one
// FMA correction RN(q + RN(x - q s) r) is the correctly rounded quotient
// (Markstein's theorem; x - q s is exact in the FMA, and nothing underflows
// wherever the quotient can round to a nonzero code). The clamp to +-127
// of the JAX expression never binds: |x| <= absmax, so |x / s| < 127.5.
__device__ __forceinline__ uint32_t code_of(float x, float s, float r) {
  const float q = __fmul_rn(x, r);
  return __float_as_uint(__fadd_rn(__fmaf_rn(__fmaf_rn(-q, s, x), r, q), kMagicF));
}

// the codes of 8 packed bf16 values, 8 bytes
__device__ __forceinline__ uint2 codes8(const uint4& raw, float s, float r) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t c[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    c[2 * i] = code_of(bf16_lo(w[i]), s, r);
    c[2 * i + 1] = code_of(bf16_hi(w[i]), s, r);
  }
  return make_uint2(low_bytes(c[0], c[1], c[2], c[3]), low_bytes(c[4], c[5], c[6], c[7]));
}

// pass 2: each task loads its chunk's rows, reduces its head's partials to
// the scale (once pass 1 has ended), then writes the chunk's codes. Tasks
// run in the reverse order of pass 1, so the first ones read what pass 1
// left in L2. A k/v chunk wholly past the live keys writes no codes; the
// chunk that holds the live end writes 0 past it.
__global__ void __launch_bounds__(kPrepThreads, 8)
q8_quantize_kernel(const PrepArgs a) {
  __shared__ __align__(16) uint8_t tile[kD][kChunk];  // v: [column][key position]
  const Task w = task_of(a, gridDim.x - 1 - blockIdx.x);
  const int rows = rows_of(a, w), first_row = w.chunk * kChunk;
  const bool is_v = w.tensor == 2;
  // q/k: rows first_row + 16 i + sub, vector vec; v: key first_row + j
  // (a warp's lanes take 32 keys, so that its byte stores to a column of
  // the tile are 32 consecutive bytes), vectors vg + kVecGroups i
  const int sub = threadIdx.x / 16, vec = threadIdx.x % 16;
  const int j = threadIdx.x % kChunk, vg = threadIdx.x / kChunk;
  uint4 raw[kRowPasses];
#pragma unroll
  for (int i = 0; i < kRowPasses; ++i) {
    const int row = is_v ? first_row + j : first_row + 16 * i + sub;
    raw[i] = row < rows ? load8(row_ptr(a, w, row) + (is_v ? vg + kVecGroups * i : vec) * 8)
                        : make_uint4(0, 0, 0, 0);
  }
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // pass 1's partials are visible

  const int n = w.tensor == 0 ? a.nq : a.nk;
  float m = 0.f;
  for (int c = threadIdx.x; c < n; c += kPrepThreads) m = fmaxf(m, a.part[w.first + c]);
  m = block_max(m);
  const float scale = __fdiv_rn(fmaxf(m, 1e-12f), 127.f), rcp = __frcp_rn(scale);
  const int heads = w.tensor == 0 ? a.H : a.KH;
  if (w.chunk == 0 && threadIdx.x == 0)
    (w.tensor == 0 ? a.qscale : w.tensor == 1 ? a.kscale : a.vscale)[w.b * heads + w.head] = scale;
  if (first_row >= rows) return;  // a k/v chunk past the live keys

  if (!is_v) {  // q8 / k8 rows, 8 codes a thread (rows past the data rows: 0)
    const int total = w.tensor == 0 ? a.T : a.S;
    int8_t* dst = w.tensor == 0 ? a.q8 : a.k8;
#pragma unroll
    for (int i = 0; i < kRowPasses; ++i) {
      const int row = first_row + 16 * i + sub;
      if (row >= total) break;
      *reinterpret_cast<uint2*>(dst + ((static_cast<long long>(w.b) * total + row) * heads +
                                       w.head) * kD + vec * 8) =
          row < rows ? codes8(raw[i], scale, rcp) : make_uint2(0, 0);
    }
    return;
  }

  // v8t: key j goes to position pos(j) of its 32-group (q8_v_order's inverse)
  const int pos = (j & ~15) | ((j & 6) << 1) | ((j & 8) >> 2) | (j & 1);
  const bool alive = first_row + j < rows;
#pragma unroll
  for (int i = 0; i < kRowPasses; ++i) {
    const uint2 c = alive ? codes8(raw[i], scale, rcp) : make_uint2(0, 0);
    uint8_t* col = &tile[(vg + kVecGroups * i) * 8][pos];
#pragma unroll
    for (int e = 0; e < 8; ++e) col[e * kChunk] = static_cast<uint8_t>((e < 4 ? c.x : c.y) >> (8 * (e % 4)));
  }
  __syncthreads();
  int8_t* dst = a.v8t + (static_cast<long long>(w.b) * a.KH + w.head) * kD * a.S32;
  for (int c = threadIdx.x; c < kD * (kChunk / 16); c += kPrepThreads) {
    const int col = c / (kChunk / 16), part = c % (kChunk / 16);
    const int p0 = first_row + part * 16;
    if (p0 < a.S32)
      *reinterpret_cast<uint4*>(dst + static_cast<long long>(col) * a.S32 + p0) =
          *reinterpret_cast<const uint4*>(&tile[col][part * 16]);
  }
}

}  // namespace

extern "C" {

// The attention on the prep's codes: launches on `stream` and returns 0 on
// success, else cudaGetLastError()'s code, or 100000 + the CUresult of a
// refused tensor map.
int flash_cached_attention_q8(const void* q8, const void* k8, const void* v8t, void* o,
                              const void* qs, const void* ks, const void* vs,
                              const int* past_len, const int* q_valid,
                              int B, int T, int S, int H, int KH, float scale, int causal,
                              void* stream) {
  constexpr CUtensorMapDataType u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const long long S32 = (S + 31) / 32 * 32;
  Maps maps;
  // q8 [B, T, H, D] and k8 [B, S, KH, D]: dims (D, heads, rows, B), byte strides
  int err = make_map<4>(&maps.q, u8, q8, {kD, H, T, B}, {kD, H * kD, 1LL * T * H * kD},
                        {kD, 1, kTileQ, 1});
  if (!err)
    err = make_map<4>(&maps.k, u8, k8, {kD, KH, S, B}, {kD, KH * kD, 1LL * S * KH * kD},
                      {kD, 1, kTileK, 1});
  if (!err)  // v8t [B, KH, D, S32]: dims (keys, D, KH, B)
    err = make_map<4>(&maps.v, u8, v8t, {S32, kD, KH, B}, {S32, S32 * kD, S32 * kD * KH},
                      {kTileK, kD, 1, 1});
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(flash_q8_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((T + kTileQ - 1) / kTileQ, H, B);
  flash_q8_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      maps, static_cast<__nv_bfloat16*>(o), static_cast<const float*>(qs),
      static_cast<const float*>(ks), static_cast<const float*>(vs), past_len, q_valid, T, S, H,
      KH, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of f32 scratch the prep needs (one absmax a task).
long long flash_q8_prep_scratch(int B, int T, int S, int H, int KH) {
  const long long nq = (T + kChunk - 1) / kChunk, nk = ((S + 31) / 32 * 32 + kChunk - 1) / kChunk;
  return 4 * (B * H * nq + 2 * B * KH * nk);
}

// The quantization of q, k, v for flash_cached_attention_q8: two kernels on
// `stream`; returns cudaGetLastError() (0 on success).
int flash_q8_prep(const void* q, const void* k, const void* v, void* q8, void* k8, void* v8t,
                  void* qscale, void* kscale, void* vscale, void* scratch,
                  const int* past_len, const int* q_valid, int B, int T, int S, int H, int KH,
                  long long q_sb, long long q_st, long long q_sh,
                  long long k_sb, long long k_st, long long k_sh,
                  long long v_sb, long long v_st, long long v_sh, void* stream) {
  PrepArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.qs = Strides{q_sb, q_st, q_sh}, a.ks = Strides{k_sb, k_st, k_sh};
  a.vs = Strides{v_sb, v_st, v_sh};
  a.q8 = static_cast<int8_t*>(q8), a.k8 = static_cast<int8_t*>(k8);
  a.v8t = static_cast<int8_t*>(v8t);
  a.qscale = static_cast<float*>(qscale), a.kscale = static_cast<float*>(kscale);
  a.vscale = static_cast<float*>(vscale), a.part = static_cast<float*>(scratch);
  a.past_len = past_len, a.q_valid = q_valid;
  a.B = B, a.T = T, a.S = S, a.S32 = (S + 31) / 32 * 32, a.H = H, a.KH = KH;
  a.nq = (T + kChunk - 1) / kChunk, a.nk = (a.S32 + kChunk - 1) / kChunk;
  const int tasks = B * H * a.nq + 2 * B * KH * a.nk;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  q8_absmax_kernel<<<tasks, kPrepThreads, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // pass 2 with programmatic dependent launch: its blocks may start while
  // pass 1 runs and wait for its end on the device
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(tasks);
  config.blockDim = dim3(kPrepThreads);
  config.dynamicSmemBytes = 0;
  config.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  e = cudaLaunchKernelEx(&config, q8_quantize_kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

const char* flash_cached_attention_q8_error_string(int code) {
  if (code >= kEncodeError)
    return "cuTensorMapEncodeTiled refused a tensor map (code - 100000 is the CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
