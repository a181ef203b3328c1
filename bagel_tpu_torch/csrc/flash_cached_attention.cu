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
// the kernel masks its own edge). past/valid are int32 [B] on the device.
//
// What bounds it on an H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): the work is
// 4*D*H*sum_b(rows * live keys) FLOPs. On the 1024 px denoise call (B=3,
// T=4098, H=28, ~4130 live keys) that is ~0.73 TFLOP against ~0.2 GB of
// q/k/v/o traffic, ~3600 FLOP/byte: it is compute-bound (bound ~0.74 ms).
//
// Design (a simple one that is right first):
// - One thread block of 4 warps per (64-row query tile, head, batch row);
//   each warp owns 16 query rows for the whole key loop.
// - The block loops over 64-key tiles only up to its live bound past+valid,
//   capped at the tile's causal diagonal, so the dead tail of a bucketed
//   buffer costs neither loads nor math. Keys past the bound load as zeros
//   (cp.async zero-fill), so stale garbage there never reaches a product.
// - K/V tiles stream through double-buffered shared memory with cp.async.
//   QK^T and PV run on the tensor cores with mma.sync m16n8k16 (bf16 in,
//   fp32 accumulate), fragments loaded by ldmatrix (.trans for V).
// - The running max, sum and the output accumulator stay in fp32 registers
//   (online softmax, base-2 exponent); P is rounded to bf16 for the PV
//   product while the row sum uses fp32 P, as _flash_kernel does.
//
// What it leaves on the table: on an H100 SXM (700 W) it runs the 1024 px
// denoise call at ~243 TFLOP/s, a quarter of the bf16 peak. mma.sync cannot
// reach Hopper's full tensor-core rate; wgmma with TMA loads and a
// warp-specialized producer/consumer pipeline (FlashAttention-3 style) is
// the way to the rest. Two blocks per SM (87 KB of shared memory each) hide
// little latency, and the exp/max work is not overlapped with the products.
//
// A decode step (T = 1) takes a second design, flash-decoding written for
// this card (flash_decode_split_kernel + flash_decode_combine_kernel; the
// wrapper dispatches on T on the host):
// - Bound: at T = 1 a query head does 4 D flops a live key, against 4 D
//   bytes of its KV head's K and V: the G = 7 heads of a GQA group together
//   do ~7 flops a byte, far below the card's ~295. The work is bound by the
//   live K/V bytes (10.2 MB for ~5000 keys over 4 KV heads: 3.0 us at
//   3.35 TB/s), and so by how many bytes are in flight, not by the
//   products. The 64-row design above reads each KV head once for each of
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;                 // head dim, compiled in
constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 64;                 // keys per tile
constexpr int kWarps = kBQ / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kLds = kD + 8;            // smem row pitch (272 B): ldmatrix rows hit distinct banks
constexpr int kChunksPerRow = kD / 8;   // 16-byte chunks per row
constexpr int kSmemBytes = (kBQ + 4 * kBK) * kLds * 2;  // q + 2 x (k, v)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
               "r"(smem_addr(dst)), "l"(src), "r"(pred ? 16 : 0));
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

struct Strides {  // in elements: batch, sequence, head
  long long b, t, h;
};

__global__ void __launch_bounds__(kThreads)
flash_cached_attention_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              __nv_bfloat16* __restrict__ o,
                              const int* __restrict__ past_len,
                              const int* __restrict__ q_valid,
                              int T, int S, int group,
                              Strides qs, Strides ks, Strides vs, Strides os,
                              float scale_log2, int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + kBQ * kLds;   // two buffers of kBK rows
  __nv_bfloat16* sV = sK + 2 * kBK * kLds;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const int past = past_len[b];
  const int valid = min(q_valid[b], T);
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + (h / group) * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + (h / group) * vs.h;
  __nv_bfloat16* ob = o + b * os.b + h * os.h;

  // live keys of this tile: [0, bound)
  int bound = past + valid;
  if (causal) bound = min(bound, past + q0 + kBQ);
  bound = min(bound, S);
  const int n_tiles = (q0 < valid && bound > 0) ? (bound + kBK - 1) / kBK : 0;

  if (n_tiles == 0) {  // padding rows only: write zeros
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int c = tid; c < kBQ * kChunksPerRow; c += kThreads) {
      const int t = q0 + c / kChunksPerRow;
      if (t < T)
        *reinterpret_cast<uint4*>(ob + t * os.t + (c % kChunksPerRow) * 8) = zero;
    }
    return;
  }

  // each thread copies 8 of the 1024 16-byte chunks of a 64 x 128 tile
  for (int c = tid; c < kBQ * kChunksPerRow; c += kThreads) {
    const int r = c / kChunksPerRow, col = (c % kChunksPerRow) * 8;
    const bool ok = q0 + r < T;
    cp_async16(sQ + r * kLds + col, ok ? qb + (q0 + r) * qs.t + col : qb, ok);
  }
  cp_async_commit();
  auto load_kv = [&](int tile, int buf) {
    __nv_bfloat16* dk = sK + buf * kBK * kLds;
    __nv_bfloat16* dv = sV + buf * kBK * kLds;
    for (int c = tid; c < kBK * kChunksPerRow; c += kThreads) {
      const int r = c / kChunksPerRow, col = (c % kChunksPerRow) * 8;
      const int j = tile * kBK + r;
      const bool ok = j < bound;
      cp_async16(dk + r * kLds + col, ok ? kb + j * ks.t + col : kb, ok);
      cp_async16(dv + r * kLds + col, ok ? vb + j * vs.t + col : vb, ok);
    }
    cp_async_commit();
  };
  load_kv(0, 0);

  // this thread's two rows (mma accumulator rows lane/4 and lane/4 + 8) and
  // the key limit of each: key j is visible iff j < lim (never past the
  // tile's bound, so keys beyond the buffer end stay invisible)
  const int row0 = q0 + warp * 16 + lane / 4;
  const int row1 = row0 + 8;
  const int lim0 = row0 >= valid ? 0 : min(causal ? past + row0 + 1 : past + valid, bound);
  const int lim1 = row1 >= valid ? 0 : min(causal ? past + row1 + 1 : past + valid, bound);

  uint32_t qf[kD / 16][4];
  float acc[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      load_kv(it + 1, (it + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        ldmatrix_x4(qf[kk], sQ + (warp * 16 + lane % 16) * kLds + kk * 16 + (lane / 16) * 8);
    }
    const __nv_bfloat16* cK = sK + (it & 1) * kBK * kLds;
    const __nv_bfloat16* cV = sV + (it & 1) * kBK * kLds;

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[kBK / 8][4];
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, cK + (np * 16 + lane % 8 + (lane / 16) * 8) * kLds +
                            kk * 16 + ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * np], qf[kk], bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // mask, scale to base 2, online softmax
    const int j0 = it * kBK + (lane % 4) * 2;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      const int j = j0 + nt * 8;
      s[nt][0] = j < lim0 ? s[nt][0] * scale_log2 : -INFINITY;
      s[nt][1] = j + 1 < lim0 ? s[nt][1] * scale_log2 : -INFINITY;
      s[nt][2] = j < lim1 ? s[nt][2] * scale_log2 : -INFINITY;
      s[nt][3] = j + 1 < lim1 ? s[nt][3] * scale_log2 : -INFINITY;
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    // a row that has seen no visible key yet keeps max -inf: use 0 as the
    // exponent base so that exp2(-inf - base) gives 0, not NaN
    const float base0 = mn0 == -INFINITY ? 0.f : mn0;
    const float base1 = mn1 == -INFINITY ? 0.f : mn1;
    const float alpha0 = exp2f(m0 - base0);
    const float alpha1 = exp2f(m1 - base1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - base0);
      s[nt][1] = exp2f(s[nt][1] - base0);
      s[nt][2] = exp2f(s[nt][2] - base1);
      s[nt][3] = exp2f(s[nt][3] - base1);
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * alpha0 + sum0;  // per-thread partial sums; reduced at the end
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
      acc[dt][0] *= alpha0;
      acc[dt][1] *= alpha0;
      acc[dt][2] *= alpha1;
      acc[dt][3] *= alpha1;
    }

    // O += P V: the S accumulators re-pack as bf16 A fragments
#pragma unroll
    for (int ks16 = 0; ks16 < kBK / 16; ++ks16) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * ks16][0], s[2 * ks16][1]),
          pack_bf16(s[2 * ks16][2], s[2 * ks16][3]),
          pack_bf16(s[2 * ks16 + 1][0], s[2 * ks16 + 1][1]),
          pack_bf16(s[2 * ks16 + 1][2], s[2 * ks16 + 1][3]),
      };
#pragma unroll
      for (int dp = 0; dp < kD / 16; ++dp) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, cV + (ks16 * 16 + lane % 8 + ((lane / 8) % 2) * 8) * kLds +
                                  dp * 16 + (lane / 16) * 8);
        mma_bf16(acc[2 * dp], pa, bf[0], bf[1]);
        mma_bf16(acc[2 * dp + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();  // this buffer is refilled by the next iteration's load
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
    const int col = dt * 8 + (lane % 4) * 2;
    if (row0 < T)
      *reinterpret_cast<__nv_bfloat162*>(ob + row0 * os.t + col) =
          __floats2bfloat162_rn(acc[dt][0] * inv0, acc[dt][1] * inv0);
    if (row1 < T)
      *reinterpret_cast<__nv_bfloat162*>(ob + row1 * os.t + col) =
          __floats2bfloat162_rn(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
}

// --- decode (T = 1): split-KV over GQA groups --------------------------------

constexpr int kDecWarps = 8;
constexpr int kDecThreads = kDecWarps * 32;
constexpr int kDecBK = 32;                          // keys a warp takes at a time: half a tile
constexpr int kDecRows = 16;                        // the m16 tile: the group's heads
constexpr int kDecMaxSplits = 256;
constexpr int kDecQBytes = kDecRows * kLds * 2;
constexpr int kDecWarpBytes = 2 * kDecBK * kLds * 2;  // a warp's K and V keys
constexpr int kDecSmemBytes = kDecQBytes + kDecWarps * kDecWarpBytes + kDecWarps * kDecRows * 2 * 4;
constexpr int kCombWarps = 4;                       // the combine kernel's warps
static_assert(kDecThreads % kD == 0, "the block's combine gives each thread one column");
static_assert(kDecRows * kD * 4 <= kDecWarpBytes, "a warp's partial fits in its K/V buffer");
static_assert(kBK % kDecBK == 0, "a warp takes part of a 64-key tile");

// partials: acc [B, KH, splits, G, D] and (m, l) [B, KH, splits, G, 2], f32;
// m in base-2 units (scores x scale x log2 e)
__global__ void __launch_bounds__(kDecThreads)
flash_decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          float* __restrict__ part_acc, float* __restrict__ part_ml,
                          const int* __restrict__ past_len, const int* __restrict__ q_valid,
                          int S, int group, Strides qs, Strides ks, Strides vs,
                          float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  float* sML = reinterpret_cast<float*>(smem + kDecQBytes + kDecWarps * kDecWarpBytes);

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

  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + kDecQBytes + warp * kDecWarpBytes);
  __nv_bfloat16* sV = sK + kDecBK * kLds;
  const __nv_bfloat16* kb = k + b * ks.b + kh * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + kh * vs.h;
  // keys [32 part, 32 part + 32): K, then V, in two cp.async groups; keys at
  // or past lim arrive as zeros
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
  constexpr int kParts = kBK / kDecBK;  // warp-sized parts of a tile
  const int first = t0 * kParts + warp;
  if (first < t1 * kParts) {
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

  for (int part = first; part < t1 * kParts; part += kDecWarps) {
    if (part != first) load_kv(part);
    cp_async_wait<1>();
    __syncwarp();

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

    cp_async_wait<0>();
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
  }

  // this warp's state into its own (now idle) K/V buffer: acc [G][D], (m, l) [G]
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  float* pw = reinterpret_cast<float*>(sK);
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
      a += wgt * reinterpret_cast<const float*>(smem + kDecQBytes + w * kDecWarpBytes)[r * kD + d];
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

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
int flash_cached_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                const int* past_len, const int* q_valid,
                                int B, int T, int S, int H, int KH,
                                long long q_sb, long long q_st, long long q_sh,
                                long long k_sb, long long k_st, long long k_sh,
                                long long v_sb, long long v_st, long long v_sh,
                                long long o_sb, long long o_st, long long o_sh,
                                float scale, int causal, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_cached_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kBQ - 1) / kBQ, H, B);
  flash_cached_attention_kernel<<<grid, kThreads, kSmemBytes,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      past_len, q_valid, T, S, H / KH,
      Strides{q_sb, q_st, q_sh}, Strides{k_sb, k_st, k_sh},
      Strides{v_sb, v_st, v_sh}, Strides{o_sb, o_st, o_sh},
      scale * 1.4426950408889634f, causal);
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
  if (H % KH != 0 || H / KH > kDecRows || splits < 1 || splits > kDecMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(flash_decode_split_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kDecSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  flash_decode_split_kernel<<<dim3(splits, KH, B), kDecThreads, kDecSmemBytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), past_len, q_valid, S, H / KH,
      Strides{q_sb, 0, q_sh}, Strides{k_sb, k_st, k_sh}, Strides{v_sb, v_st, v_sh},
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

const char* flash_cached_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
