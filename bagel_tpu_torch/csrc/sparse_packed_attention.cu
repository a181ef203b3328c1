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
// sequence/head strides (the SigLIP tower hands in views of [S, H*D] with
// strides (H*D, D, 1)); S is ragged: the kernel masks its own edge, so no
// padded copies are made around the call. doc/fan/noise are int32 [S].
// D is a template parameter; D = 72 (SigLIP so400m, 1152 / 16 heads) and
// D = 128 (the LLM's packed training shape, GQA 28/4) are instantiated.
//
// What bounds it on an H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): the work
// is 4*D*H*(visible pairs) FLOPs against one read of q/k/v and one write of
// out. On the understanding path (one 980 px image: 4900 patches in a
// 4926-token block, H=16, D=72) that is 1.11e11 FLOP against 45 MB, ~2400
// FLOP/byte: it is bound by operations, at 0.112 ms.
//
// Design (a simple one that is right first):
// - One thread block of 4 warps per (64-row query tile, head); each warp owns
//   16 query rows for the whole loop. The block walks only its q tile's live
//   64-key tiles, read from a table [n_q_tiles, n_kv_tiles] that the wrapper
//   builds with block_liveness at this tile size (dead tiles cost neither
//   loads nor math). The next tile's entry is read one iteration ahead.
// - Each entry also carries a flag (bit 30) that the wrapper sets when every
//   (query, key) pair of the tile is visible (one document without padding,
//   and wholly below the diagonal or one full/noise split, and no foreign
//   noise key). Such a tile skips the per-element mask: on the SigLIP path
//   that is every tile but those holding the padded tail.
// - K/V tiles and the key tile's three id vectors stream through a ring of
//   shared-memory buffers with cp.async (16-byte rows, 4-byte ids), one
//   commit group per tile: three tiles in flight at D = 72 (79 KB, two
//   blocks per SM), two at D = 128 (87 KB). Rows past S load as zeros, and
//   their doc id 0 masks them.
// - The per-element mask is rebuilt from the ids inside every other live
//   tile.
// - QK^T and PV run on the tensor cores with mma.sync m16n8k16 (bf16 in,
//   fp32 accumulate), fragments by ldmatrix (.trans for V).
// - D = 72: the QK^T depth is zero-padded to 80 in shared memory (columns
//   72..79 of the Q and K tiles are cleared once; cp.async never writes
//   them), so QK^T is five k16 steps. PV keeps exactly 9 n8 output tiles:
//   four ldmatrix.x4.trans pairs and one ldmatrix.x2.trans.
// - Bank conflicts: a 72-element row is 144 B; the tiles use a padded pitch
//   of 88 elements (176 B = 11 16-byte units; 136 elements = 17 units for
//   D = 128). An odd unit count puts the 8 rows of each ldmatrix phase in 8
//   distinct 16-byte bank groups, so ldmatrix reads are conflict-free.
// - No NaN: masked scores become -inf, a row with no visible key yet uses 0
//   as its exponent base (exp2(-inf) = 0, never inf - inf), and rows that end
//   with no visible key write 0. K/V rows of padding keys (doc 0) are zeroed
//   in shared memory before use, so stale NaN there never meets a zero
//   probability in PV (0 * NaN); no query can see such a key.
// - The online softmax state (running max, sum, output accumulator) stays
//   in fp32 registers; P is rounded to bf16 for the PV product while the row
//   sum uses fp32 P, as _sparse_kernel does.
//
// What it leaves on the table: mma.sync cannot reach Hopper's full
// tensor-core rate (wgmma + TMA with a warp-specialized pipeline is the way
// to the rest); at D = 72 the exp and softmax work per tile is large next to
// the products, and each K/V tile feeds only 64 query rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per tile
constexpr int kWarps = kBQ / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kFullTile = 1 << 30;  // table entry flag: every pair visible

template <int D>
struct Shape {
  static_assert(D % 8 == 0, "head dim must be a multiple of 8");
  static constexpr int kDP = (D + 15) / 16 * 16;  // QK^T depth, zero-padded
  static constexpr int kLds = kDP + 8;            // smem row pitch (elements), odd in 16 B units
  static constexpr int kChunks = D / 8;           // 16-byte chunks of a real row
  static constexpr int kDPChunks = kDP / 8;
  static constexpr int kNT = D / 8;               // n8 output tiles of PV
  static constexpr int kKVPerThread = (kBK * kChunks + kThreads - 1) / kThreads;
  // K/V tiles in flight: three at D = 72 (79 KB of shared memory, two
  // blocks per SM); two at D = 128, where a third would leave one block
  static constexpr int kStages = D <= 80 ? 3 : 2;
  static constexpr int kSmemBytes =
      (kBQ + 2 * kStages * kBK) * kLds * 2 + kStages * 3 * kBK * 4;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; pred false fills the destination with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
               "r"(smem_addr(dst)), "l"(src), "r"(pred ? 16 : 0));
}
// 4-byte async copy; pred false writes 0.
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
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
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

struct Strides {  // in elements: sequence, head
  long long t, h;
};

// The ids of one query row, and whether key (position j, ids dk/fk/nk) is
// visible to it.
struct RowIds {
  int pos, doc, fan, noise;
  __device__ __forceinline__ bool sees(int j, int dk, int fk, int nk) const {
    return doc != 0 && doc == dk && (pos >= j || (fan >= 0 && fan == fk)) &&
           !(nk >= 0 && noise != nk);
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads)
sparse_packed_attention_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               __nv_bfloat16* __restrict__ o,
                               const int* __restrict__ doc,
                               const int* __restrict__ fan,
                               const int* __restrict__ noise,
                               const int* __restrict__ live_idx,
                               const int* __restrict__ live_cnt,
                               int S, int group, int nk_tab,
                               Strides qs, Strides ks, Strides vs, Strides os,
                               float scale_log2) {
  using Sh = Shape<D>;
  constexpr int kLds = Sh::kLds;
  constexpr int kStages = Sh::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + kBQ * kLds;  // kStages buffers of kBK rows
  __nv_bfloat16* sV = sK + kStages * kBK * kLds;
  int* sIds = reinterpret_cast<int*>(sV + kStages * kBK * kLds);  // [kStages][doc, fan, noise][kBK]

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const __nv_bfloat16* qb = q + h * qs.h;
  const __nv_bfloat16* kb = k + (h / group) * ks.h;
  const __nv_bfloat16* vb = v + (h / group) * vs.h;
  __nv_bfloat16* ob = o + h * os.h;

  const int n_tiles = live_cnt[qt];
  const int* tab = live_idx + static_cast<long long>(qt) * nk_tab;

  if (n_tiles == 0) {  // no live key tile: every row of the tile is 0
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int c = tid; c < kBQ * Sh::kChunks; c += kThreads) {
      const int t = q0 + c / Sh::kChunks;
      if (t < S) *reinterpret_cast<uint4*>(ob + t * os.t + (c % Sh::kChunks) * 8) = zero;
    }
    return;
  }

  // columns [D, kDP) of the Q tile and every K buffer: zeros, never written again
  if (Sh::kDPChunks > Sh::kChunks) {
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int r = tid; r < kBQ + kStages * kBK; r += kThreads) {
      __nv_bfloat16* row = r < kBQ ? sQ + r * kLds : sK + (r - kBQ) * kLds;
#pragma unroll
      for (int c = Sh::kChunks; c < Sh::kDPChunks; ++c)
        *reinterpret_cast<uint4*>(row + c * 8) = zero;
    }
  }

  for (int c = tid; c < kBQ * Sh::kChunks; c += kThreads) {
    const int r = c / Sh::kChunks, col = (c % Sh::kChunks) * 8;
    const bool ok = q0 + r < S;
    cp_async16(sQ + r * kLds + col, ok ? qb + (q0 + r) * qs.t + col : qb, ok);
  }
  cp_async_commit();
  // One commit group per key tile: its K and V rows and its three id
  // vectors. Thread tid < kBK copies the doc id of key row tid itself, so
  // after its own wait it can read that id without a barrier.
  auto load_kv = [&](int entry, int buf) {
    __nv_bfloat16* dk = sK + buf * kBK * kLds;
    __nv_bfloat16* dv = sV + buf * kBK * kLds;
    const int j0 = (entry & ~kFullTile) * kBK;
    const __nv_bfloat16* kt = kb + j0 * ks.t;
    const __nv_bfloat16* vt = vb + j0 * vs.t;
#pragma unroll
    for (int m = 0; m < Sh::kKVPerThread; ++m) {
      const int c = tid + m * kThreads;
      if (c < kBK * Sh::kChunks) {
        const int r = c / Sh::kChunks, col = (c % Sh::kChunks) * 8;
        const bool ok = j0 + r < S;
        cp_async16(dk + r * kLds + col, ok ? kt + r * ks.t + col : kb, ok);
        cp_async16(dv + r * kLds + col, ok ? vt + r * vs.t + col : vb, ok);
      }
    }
    int* di = sIds + buf * 3 * kBK;
#pragma unroll
    for (int m = 0; m < (3 * kBK + kThreads - 1) / kThreads; ++m) {
      const int e = tid + m * kThreads;
      if (e < 3 * kBK) {
        const int a = e / kBK, j = j0 + e % kBK;
        const int* src = a == 0 ? doc : (a == 1 ? fan : noise);
        const bool ok = j < S;
        cp_async4(di + e, src + (ok ? j : 0), ok);
      }
    }
    cp_async_commit();
  };
  // the first kStages - 1 tiles in flight (an empty group where there is none)
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) load_kv(tab[st], st);
    else cp_async_commit();
  }
  int pf = kStages - 1 < n_tiles ? tab[kStages - 1] : 0;  // the next entry to prefetch

  // this thread's two rows (mma accumulator rows lane/4 and lane/4 + 8)
  RowIds r0, r1;
  r0.pos = q0 + warp * 16 + lane / 4;
  r1.pos = r0.pos + 8;
  r0.doc = r0.pos < S ? doc[r0.pos] : 0;
  r0.fan = r0.pos < S ? fan[r0.pos] : -1;
  r0.noise = r0.pos < S ? noise[r0.pos] : -1;
  r1.doc = r1.pos < S ? doc[r1.pos] : 0;
  r1.fan = r1.pos < S ? fan[r1.pos] : -1;
  r1.noise = r1.pos < S ? noise[r1.pos] : -1;

  uint32_t qf[Sh::kDP / 16][4];
  float acc[Sh::kNT][4];
#pragma unroll
  for (int i = 0; i < Sh::kNT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it % kStages;
    const int cur = tab[it];  // first used after QK^T: its latency hides there
    cp_async_wait<kStages - 2>();  // tile it (and Q) landed; later tiles may be in flight
    const int* sdoc = sIds + buf * 3 * kBK;
    const int* sfan = sdoc + kBK;
    const int* snoise = sfan + kBK;
    __nv_bfloat16* cK = sK + buf * kBK * kLds;
    __nv_bfloat16* cV = sV + buf * kBK * kLds;
    // the barrier that publishes the tile also tells whether it holds a
    // padding key (doc 0); if so, zero that key's K and V rows
    if (__syncthreads_or(tid < kBK && sdoc[tid] == 0)) {
      const uint4 zero = make_uint4(0, 0, 0, 0);
      for (int c = tid; c < kBK * Sh::kChunks; c += kThreads) {
        const int r = c / Sh::kChunks, col = (c % Sh::kChunks) * 8;
        if (sdoc[r] == 0) {
          *reinterpret_cast<uint4*>(cK + r * kLds + col) = zero;
          *reinterpret_cast<uint4*>(cV + r * kLds + col) = zero;
        }
      }
      __syncthreads();
    }
    // every thread is past tile it - 1, so its buffer takes tile it + kStages - 1
    if (it + kStages - 1 < n_tiles) {
      load_kv(pf, (it + kStages - 1) % kStages);
      pf = it + kStages < n_tiles ? tab[it + kStages] : 0;
    } else {
      cp_async_commit();  // an empty group keeps the wait count uniform
    }
    const int j0 = (cur & ~kFullTile) * kBK;
    const bool full = cur & kFullTile;
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < Sh::kDP / 16; ++kk)
        ldmatrix_x4(qf[kk], sQ + (warp * 16 + lane % 16) * kLds + kk * 16 + (lane / 16) * 8);
    }

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[kBK / 8][4];
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < Sh::kDP / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, cK + (np * 16 + lane % 8 + (lane / 16) * 8) * kLds +
                            kk * 16 + ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * np], qf[kk], bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // mask from the ids (unless the whole tile is visible), scale to base
    // 2, online softmax
    float mx0 = -INFINITY, mx1 = -INFINITY;
    if (full) {
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] *= scale_log2;
        mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jl = nt * 8 + (lane % 4) * 2 + e;
          const int j = j0 + jl;
          const int dk = sdoc[jl], fk = sfan[jl], nk = snoise[jl];
          s[nt][e] = r0.sees(j, dk, fk, nk) ? s[nt][e] * scale_log2 : -INFINITY;
          s[nt][2 + e] = r1.sees(j, dk, fk, nk) ? s[nt][2 + e] * scale_log2 : -INFINITY;
        }
        mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
      }
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
    for (int dt = 0; dt < Sh::kNT; ++dt) {
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
      const __nv_bfloat16* vrow = cV + (ks16 * 16 + lane % 8 + ((lane / 8) % 2) * 8) * kLds;
#pragma unroll
      for (int dp = 0; dp < Sh::kNT / 2; ++dp) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vrow + dp * 16 + (lane / 16) * 8);
        mma_bf16(acc[2 * dp], pa, bf[0], bf[1]);
        mma_bf16(acc[2 * dp + 1], pa, bf[2], bf[3]);
      }
      if (Sh::kNT % 2) {  // the odd last n8 tile (D = 72: columns 64..71)
        uint32_t bf[2];
        ldmatrix_x2_trans(bf, vrow + (Sh::kNT - 1) * 8);
        mma_bf16(acc[Sh::kNT - 1], pa, bf[0], bf[1]);
      }
    }
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  // a row that saw no key writes 0 whatever its accumulator holds
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
#pragma unroll
  for (int dt = 0; dt < Sh::kNT; ++dt) {
    const int col = dt * 8 + (lane % 4) * 2;
    if (r0.pos < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + r0.pos * os.t + col) =
          l0 > 0.f ? __floats2bfloat162_rn(acc[dt][0] * inv0, acc[dt][1] * inv0)
                   : __floats2bfloat162_rn(0.f, 0.f);
    if (r1.pos < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + r1.pos * os.t + col) =
          l1 > 0.f ? __floats2bfloat162_rn(acc[dt][2] * inv1, acc[dt][3] * inv1)
                   : __floats2bfloat162_rn(0.f, 0.f);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, const int* doc,
           const int* fan, const int* noise, const int* live_idx, const int* live_cnt,
           int S, int H, int KH, int nk_tab, Strides qs, Strides ks, Strides vs,
           Strides os, float scale, cudaStream_t stream) {
  constexpr int smem = Shape<D>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(sparse_packed_attention_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H);
  sparse_packed_attention_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), doc, fan,
      noise, live_idx, live_cnt, S, H / KH, nk_tab, qs, ks, vs, os,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success);
// cudaErrorInvalidValue for a head dim that is not instantiated.
int sparse_packed_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                 const int* doc, const int* fan, const int* noise,
                                 const int* live_idx, const int* live_cnt,
                                 int S, int H, int KH, int D, int nk_tab,
                                 long long q_st, long long q_sh,
                                 long long k_st, long long k_sh,
                                 long long v_st, long long v_sh,
                                 long long o_st, long long o_sh,
                                 float scale, void* stream) {
  const Strides qs{q_st, q_sh}, ks{k_st, k_sh}, vs{v_st, v_sh}, os{o_st, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 72:
      return launch<72>(q, k, v, o, doc, fan, noise, live_idx, live_cnt, S, H, KH, nk_tab,
                        qs, ks, vs, os, scale, st);
    case 128:
      return launch<128>(q, k, v, o, doc, fan, noise, live_idx, live_cnt, S, H, KH, nk_tab,
                         qs, ks, vs, os, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* sparse_packed_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
