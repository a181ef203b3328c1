// Flash attention with int8 QK^T and PV products over a cached KV buffer,
// for Hopper: the w8a8 attention.
//
// Replaces the TPU kernel bagel_tpu/ops/flash.py:_flash_kernel_q8 (reached
// from flash_cached_attention(int8_compute=True), :279; its q/k/v
// quantization, :351-377, is plain PyTorch in the wrapper,
// bagel_tpu_torch/ops/flash.py:q8_prep). Per 64-key tile, for each row:
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
// plain version takes the tile size and is held against this kernel at 64.
//
// Layout: q8 [B, T, H, 128] int8, k8/v8 [B, S, KH, 128] int8 (the live
// prefix of the cache, contiguous), qs [B*H], ks/vs [B*KH] f32, past/valid
// int32 [B], out [B, T, H, 128] bf16, all contiguous.
//
// What bounds it on an H100 (1,979 TOPS int8 dense): at the 1024 px denoise
// call (B=3, T=4098, H=28, ~4130 live keys) 0.73e12 operations against
// ~0.1 GB of int8 q/k/v and bf16 out: compute-bound, 0.37 ms at the peak.
//
// Design (B1's, with int8 products):
// - One block of 4 warps per (64-row query tile, head, batch row); each warp
//   owns 16 rows; the key loop runs over 64-key tiles up to the live bound
//   (capped at the tile's causal diagonal). Keys past it load as zeros.
// - QK^T: mma.sync m16n8k32 s8 with both operands k-contiguous, as q8 and k8
//   are; fragments by ldmatrix (b16 rows of 16 bytes).
// - PV: mma wants V with keys contiguous per D column, and Hopper has no
//   8-bit ldmatrix.trans. Each V tile is staged as it is (cp.async) and
//   transposed in shared memory with byte permutes, its keys permuted so
//   that the int8 codes of P, which the S accumulators leave as keys
//   {2t, 2t+1, 8+2t, 9+2t} of each 16 in thread t, pack into the A fragment
//   (keys 4t..4t+3) without any shuffle: the product sums over keys in
//   either order.
// - P rounds half to even (__float2int_rn), as jnp.round.
//
// What it leaves on the table: the V transposition and expf per score sit
// on every tile's critical path, with two blocks per SM and mma.sync; wgmma
// with V transposed once when the cache is written would remove the first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 128;
constexpr int kPitch = kD + 16;    // q / k / v staging rows (bytes): ldmatrix without conflicts
constexpr int kPitchVt = kBK + 16; // transposed V rows (bytes)
constexpr int kSmemBytes = kBQ * kPitch + 4 * kBK * kPitch + kD * kPitchVt;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
               "r"(smem_addr(dst)), "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void transpose4x4(uint32_t r0, uint32_t r1, uint32_t r2,
                                             uint32_t r3, uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r0, r1, 0x7362);
  const uint32_t u0 = __byte_perm(r2, r3, 0x5140), u1 = __byte_perm(r2, r3, 0x7362);
  o[0] = __byte_perm(t0, u0, 0x5410);
  o[1] = __byte_perm(t0, u0, 0x7632);
  o[2] = __byte_perm(t1, u1, 0x5410);
  o[3] = __byte_perm(t1, u1, 0x7632);
}
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {  // codes 0..127
  return static_cast<uint32_t>(a) | (static_cast<uint32_t>(b) << 8) |
         (static_cast<uint32_t>(c) << 16) | (static_cast<uint32_t>(d) << 24);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ int quad_sum(int x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__global__ void __launch_bounds__(kThreads)
flash_q8_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                const int8_t* __restrict__ v, __nv_bfloat16* __restrict__ o,
                const float* __restrict__ qs, const float* __restrict__ ks,
                const float* __restrict__ vs, const int* __restrict__ past_len,
                const int* __restrict__ q_valid, int T, int S, int H, int KH,
                float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sQ = smem;
  unsigned char* sK = sQ + kBQ * kPitch;     // two buffers
  unsigned char* sV = sK + 2 * kBK * kPitch; // two staging buffers
  unsigned char* sVt = sV + 2 * kBK * kPitch;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kh = h / (H / KH);

  const int past = past_len[b];
  const int valid = min(q_valid[b], T);
  const int8_t* qb = q + ((size_t)b * T * H + h) * kD;
  const int8_t* kb = k + ((size_t)b * S * KH + kh) * kD;
  const int8_t* vb = v + ((size_t)b * S * KH + kh) * kD;
  __nv_bfloat16* ob = o + ((size_t)b * T * H + h) * kD;
  const size_t q_row = (size_t)H * kD, kv_row = (size_t)KH * kD;

  int bound = past + valid;
  if (causal) bound = min(bound, past + q0 + kBQ);
  bound = min(bound, S);
  const int n_tiles = (q0 < valid && bound > 0) ? (bound + kBK - 1) / kBK : 0;

  if (n_tiles == 0) {
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int c = tid; c < kBQ * (kD / 8); c += kThreads) {
      const int t = q0 + c / (kD / 8);
      if (t < T) *reinterpret_cast<uint4*>(ob + t * q_row + (c % (kD / 8)) * 8) = zero;
    }
    return;
  }

  for (int c = tid; c < kBQ * (kD / 16); c += kThreads) {
    const int r = c / (kD / 16), col = (c % (kD / 16)) * 16;
    const bool ok = q0 + r < T;
    cp_async16(sQ + r * kPitch + col, ok ? qb + (q0 + r) * q_row + col : qb, ok);
  }
  cp_async_commit();
  auto load_kv = [&](int tile, int buf) {
    unsigned char* dk = sK + buf * kBK * kPitch;
    unsigned char* dv = sV + buf * kBK * kPitch;
    for (int c = tid; c < kBK * (kD / 16); c += kThreads) {
      const int r = c / (kD / 16), col = (c % (kD / 16)) * 16;
      const int j = tile * kBK + r;
      const bool ok = j < bound;
      cp_async16(dk + r * kPitch + col, ok ? kb + j * kv_row + col : kb, ok);
      cp_async16(dv + r * kPitch + col, ok ? vb + j * kv_row + col : vb, ok);
    }
    cp_async_commit();
  };
  load_kv(0, 0);

  const int g = lane / 4, t4 = lane % 4;
  const int row0 = q0 + warp * 16 + g;
  const int row1 = row0 + 8;
  const int lim0 = row0 >= valid ? 0 : min(causal ? past + row0 + 1 : past + valid, bound);
  const int lim1 = row1 >= valid ? 0 : min(causal ? past + row1 + 1 : past + valid, bound);
  const float cqk = __fmul_rn(__fmul_rn(qs[b * H + h], ks[b * KH + kh]), scale);
  const float vs127 = __fdiv_rn(vs[b * KH + kh], 127.f);

  uint32_t qf[kD / 32][4];
  float acc[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      load_kv(it + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < kD / 32; ++kk)
        ldmatrix_x4(qf[kk], sQ + (warp * 16 + lane % 16) * kPitch + (2 * kk + lane / 16) * 16);
    }
    // V tile -> sVt[d][key'] with keys permuted within each 16: key'
    // 4t + {0,1,2,3} <- key {2t, 2t+1, 8+2t, 9+2t}
    {
      const unsigned char* cv = sV + buf * kBK * kPitch;
      const int t = lane & 3, hh = (lane >> 2) & 1, c = (lane >> 3) & 1;
      const int key = 32 * c + 16 * hh + 2 * t;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int dq = 2 * (warp + 4 * i) + (lane >> 4);
        const unsigned char* src = cv + dq * 4;
        uint32_t out4[4];
        transpose4x4(*reinterpret_cast<const uint32_t*>(src + key * kPitch),
                     *reinterpret_cast<const uint32_t*>(src + (key + 1) * kPitch),
                     *reinterpret_cast<const uint32_t*>(src + (key + 8) * kPitch),
                     *reinterpret_cast<const uint32_t*>(src + (key + 9) * kPitch), out4);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<uint32_t*>(sVt + (4 * dq + j) * kPitchVt + 32 * c + 16 * hh + 4 * t) =
              out4[j];
      }
    }
    const unsigned char* cK = sK + buf * kBK * kPitch;

    // S = Q K^T: 16 rows x 64 keys per warp, int32
    int si[kBK / 8][4];
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i) si[i][0] = si[i][1] = si[i][2] = si[i][3] = 0;
#pragma unroll
    for (int kk = 0; kk < kD / 32; ++kk) {
#pragma unroll
      for (int p = 0; p < kBK / 16; ++p) {
        uint32_t bf[4];
        ldmatrix_x4(bf, cK + (p * 16 + lane % 8 + (lane / 16) * 8) * kPitch +
                            (2 * kk + (lane / 8) % 2) * 16);
        mma_s8(si[2 * p], qf[kk], bf[0], bf[1]);
        mma_s8(si[2 * p + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // scale, mask, online softmax in f32
    float s[kBK / 8][4];
    const int j0 = it * kBK + t4 * 2;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      const int j = j0 + nt * 8;
      s[nt][0] = j < lim0 ? __fmul_rn(__int2float_rn(si[nt][0]), cqk) : -INFINITY;
      s[nt][1] = j + 1 < lim0 ? __fmul_rn(__int2float_rn(si[nt][1]), cqk) : -INFINITY;
      s[nt][2] = j < lim1 ? __fmul_rn(__int2float_rn(si[nt][2]), cqk) : -INFINITY;
      s[nt][3] = j + 1 < lim1 ? __fmul_rn(__int2float_rn(si[nt][3]), cqk) : -INFINITY;
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float base0 = mn0 == -INFINITY ? 0.f : mn0;  // no key seen yet: exp gives 0, not NaN
    const float base1 = mn1 == -INFINITY ? 0.f : mn1;
    const float alpha0 = expf(m0 - base0);
    const float alpha1 = expf(m1 - base1);
    m0 = mn0;
    m1 = mn1;
    float pm0 = 0.f, pm1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - base0);
      s[nt][1] = expf(s[nt][1] - base0);
      s[nt][2] = expf(s[nt][2] - base1);
      s[nt][3] = expf(s[nt][3] - base1);
      pm0 = fmaxf(pm0, fmaxf(s[nt][0], s[nt][1]));
      pm1 = fmaxf(pm1, fmaxf(s[nt][2], s[nt][3]));
    }
    const float rm0 = fmaxf(quad_max(pm0), 1e-20f);
    const float rm1 = fmaxf(quad_max(pm1), 1e-20f);
    const float inv0 = __fdiv_rn(127.f, rm0), inv1 = __fdiv_rn(127.f, rm1);
    int c[kBK / 8][4];
    int cs0 = 0, cs1 = 0;
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      c[nt][0] = __float2int_rn(__fmul_rn(s[nt][0], inv0));
      c[nt][1] = __float2int_rn(__fmul_rn(s[nt][1], inv0));
      c[nt][2] = __float2int_rn(__fmul_rn(s[nt][2], inv1));
      c[nt][3] = __float2int_rn(__fmul_rn(s[nt][3], inv1));
      cs0 += c[nt][0] + c[nt][1];
      cs1 += c[nt][2] + c[nt][3];
    }
    cs0 = quad_sum(cs0);
    cs1 = quad_sum(cs1);
    l0 = __fadd_rn(__fmul_rn(l0, alpha0), __fmul_rn(__int2float_rn(cs0), __fdiv_rn(rm0, 127.f)));
    l1 = __fadd_rn(__fmul_rn(l1, alpha1), __fmul_rn(__int2float_rn(cs1), __fdiv_rn(rm1, 127.f)));
    const float f0 = __fmul_rn(rm0, vs127), f1 = __fmul_rn(rm1, vs127);

    // the codes as A fragments, per 32-key chunk (see the V permutation)
    uint32_t pa[2][4];
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int n = 4 * cc;
      pa[cc][0] = pack4(c[n][0], c[n][1], c[n + 1][0], c[n + 1][1]);
      pa[cc][1] = pack4(c[n][2], c[n][3], c[n + 1][2], c[n + 1][3]);
      pa[cc][2] = pack4(c[n + 2][0], c[n + 2][1], c[n + 3][0], c[n + 3][1]);
      pa[cc][3] = pack4(c[n + 2][2], c[n + 2][3], c[n + 3][2], c[n + 3][3]);
    }
    __syncthreads();  // sVt complete

    // O = O alpha + f32(C V) * row_m * vs / 127, 16 D columns at a time
#pragma unroll
    for (int dp = 0; dp < kD / 16; ++dp) {
      int pv[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        uint32_t bf[4];
        ldmatrix_x4(bf, sVt + (dp * 16 + lane % 8 + (lane / 16) * 8) * kPitchVt +
                            (2 * cc + (lane / 8) % 2) * 16);
        mma_s8(pv[0], pa[cc], bf[0], bf[1]);
        mma_s8(pv[1], pa[cc], bf[2], bf[3]);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float* a = acc[2 * dp + e];
        a[0] = __fadd_rn(__fmul_rn(a[0], alpha0), __fmul_rn(__int2float_rn(pv[e][0]), f0));
        a[1] = __fadd_rn(__fmul_rn(a[1], alpha0), __fmul_rn(__int2float_rn(pv[e][1]), f0));
        a[2] = __fadd_rn(__fmul_rn(a[2], alpha1), __fmul_rn(__int2float_rn(pv[e][2]), f1));
        a[3] = __fadd_rn(__fmul_rn(a[3], alpha1), __fmul_rn(__int2float_rn(pv[e][3]), f1));
      }
    }
    __syncthreads();  // buffers and sVt are refilled next
  }

  const float d0 = fmaxf(l0, 1e-20f), d1 = fmaxf(l1, 1e-20f);
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
    const int col = dt * 8 + t4 * 2;
    if (row0 < T)
      *reinterpret_cast<__nv_bfloat162*>(ob + row0 * q_row + col) =
          __floats2bfloat162_rn(__fdiv_rn(acc[dt][0], d0), __fdiv_rn(acc[dt][1], d0));
    if (row1 < T)
      *reinterpret_cast<__nv_bfloat162*>(ob + row1 * q_row + col) =
          __floats2bfloat162_rn(__fdiv_rn(acc[dt][2], d1), __fdiv_rn(acc[dt][3], d1));
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
int flash_cached_attention_q8(const void* q, const void* k, const void* v, void* o,
                              const void* qs, const void* ks, const void* vs,
                              const int* past_len, const int* q_valid,
                              int B, int T, int S, int H, int KH, float scale, int causal,
                              void* stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_q8_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kBQ - 1) / kBQ, H, B);
  flash_q8_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<const float*>(qs), static_cast<const float*>(ks),
      static_cast<const float*>(vs), past_len, q_valid, T, S, H, KH, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

const char* flash_cached_attention_q8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
