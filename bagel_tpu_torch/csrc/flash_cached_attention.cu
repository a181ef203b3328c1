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

const char* flash_cached_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
