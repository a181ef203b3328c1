// w8a8 matmul for Hopper: int8 activations x int8 weights -> int32, then the
// per-token and per-column scales (and an optional bias) in f32.
//
// Replaces the TPU kernels bagel_tpu/ops/int8_matmul.py:_kernel_onek and
// :_kernel (reached from int8_matmul, :64). It computes
//
//   out[m,n] = bf16( ((f32(sum_k xq[m,k] * wq[k,n]) * xs[m]) * ws[n]) + b[n] )
//
// with each f32 step rounded on its own (__fmul_rn / __fadd_rn: nvcc would
// otherwise contract a*b+c into one FMA), the order of
// bagel_tpu/models/qwen2.py:_linear's w8a8 branch. The int32 sums are
// exact, so the result equals the plain version bit for bit.
//
// Layout: xq [M, K] int8 row-major, wq [K, N] int8 row-major (the JAX
// [in, out] layout), xs [M] f32, ws [N] f32, b [N] f32 or null, out [M, N]
// bf16. Any M; K and N multiples of 16 (16-byte loads); ragged tiles are
// masked in the kernel.
//
// What bounds it on an H100 (1,979 TOPS int8 dense, 3.35 TB/s): at the
// 1024 px denoise shapes (M = 3 x 4098, K, N ~ 3584-18944) 2MNK operations
// against MK + KN + 2MN bytes is ~4000 op/byte: compute-bound (the gate
// projection, 1.67e12 ops, is 0.84 ms at the peak).
//
// Design (simple and right first):
// - A block of 8 warps computes a 128 x 128 output tile over 64-deep k
//   tiles; each warp owns 32 x 64 of it with mma.sync m16n8k32 (s8 in, s32
//   accumulate).
// - mma wants both operands with k contiguous. xq is; wq has n contiguous,
//   and Hopper has no 8-bit ldmatrix.trans. So each wq tile lands in shared
//   memory as it is (cp.async, double-buffered with the xq tile) and is
//   then transposed shared-to-shared in 4 x 4 byte blocks with byte
//   permutes (prmt) into an [n][k] tile that ldmatrix reads.
// - Both [row][k] tiles use 64-byte rows with an XOR swizzle of the
//   16-byte chunks, which keeps ldmatrix free of bank conflicts.
//
// What it leaves on the table: mma.sync reaches perhaps two thirds of the
// tensor cores' int8 rate; wgmma with TMA and a transposed copy of the
// weights made once at load time (k-major, so no transposition per tile)
// would reach the rest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kPitchB = kBN + 16;  // staging rows of the wq tile (bytes)

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
// c += a (16x32, row) * b (32x8, col); s8 in, s32 accumulate.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte offset of 16-byte chunk c (0..3) of row r in a [rows][64] tile
__device__ __forceinline__ int swz(int r, int c) {
  return r * 64 + ((c ^ (((r >> 1) + (r >> 3)) & 3)) << 4);
}

// rows r0..r3 hold bytes (n0..n3) of four consecutive k; returns in o[j]
// the four k bytes of column n_j
__device__ __forceinline__ void transpose4x4(uint32_t r0, uint32_t r1, uint32_t r2,
                                             uint32_t r3, uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r0, r1, 0x7362);
  const uint32_t u0 = __byte_perm(r2, r3, 0x5140), u1 = __byte_perm(r2, r3, 0x7362);
  o[0] = __byte_perm(t0, u0, 0x5410);
  o[1] = __byte_perm(t0, u0, 0x7632);
  o[2] = __byte_perm(t1, u1, 0x5410);
  o[3] = __byte_perm(t1, u1, 0x7632);
}

__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                   const int8_t* __restrict__ wq, const float* __restrict__ ws,
                   const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                   int M, int N, int K) {
  __shared__ __align__(16) unsigned char sA[2][kBM * kBK];
  __shared__ __align__(16) unsigned char sBn[2][kBK * kPitchB];
  __shared__ __align__(16) unsigned char sBt[kBN * kBK];

  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp % 4) * 32;  // this warp's rows and columns in the tile
  const int wn = (warp / 4) * 64;
  const int n_tiles = (K + kBK - 1) / kBK;

  auto load = [&](int tile, int buf) {
    const int k0 = tile * kBK;
    // xq: 128 rows x 4 chunks
    for (int c = tid; c < kBM * 4; c += kThreads) {
      const int r = c / 4, ch = c % 4;
      const bool ok = m0 + r < M && k0 + ch * 16 < K;
      cp_async16(sA[buf] + swz(r, ch), ok ? xq + (size_t)(m0 + r) * K + k0 + ch * 16 : xq, ok);
    }
    // wq: 64 rows x 8 chunks, as it is
    for (int c = tid; c < kBK * (kBN / 16); c += kThreads) {
      const int r = c / (kBN / 16), ch = c % (kBN / 16);
      const bool ok = k0 + r < K && n0 + ch * 16 < N;
      cp_async16(sBn[buf] + r * kPitchB + ch * 16,
                 ok ? wq + (size_t)(k0 + r) * N + n0 + ch * 16 : wq, ok);
    }
    cp_async_commit();
  };

  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  load(0, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      load(it + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (tid < 128) {  // transpose: warp w takes k rows 16w..16w+15, lane the column quad
      const int ch = tid / 32, nq = tid % 32;
      const unsigned char* src = sBn[buf] + (ch * 16) * kPitchB + nq * 4;
      uint32_t o[4][4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const unsigned char* s = src + b * 4 * kPitchB;
        transpose4x4(*reinterpret_cast<const uint32_t*>(s),
                     *reinterpret_cast<const uint32_t*>(s + kPitchB),
                     *reinterpret_cast<const uint32_t*>(s + 2 * kPitchB),
                     *reinterpret_cast<const uint32_t*>(s + 3 * kPitchB), o[b]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = nq * 4 + j;
        *reinterpret_cast<uint4*>(sBt + swz(n, ch)) = make_uint4(o[0][j], o[1][j], o[2][j], o[3][j]);
      }
    }
    __syncthreads();

    const unsigned char* cA = sA[buf];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(af[mt], cA + swz(wm + mt * 16 + lane % 16, 2 * ks + lane / 16));
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t bf[4];
        ldmatrix_x4(bf, sBt + swz(wn + p * 16 + lane % 8 + (lane / 16) * 8,
                                  2 * ks + (lane / 8) % 2));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_s8(acc[mt][2 * p], af[mt], bf[0], bf[1]);
          mma_s8(acc[mt][2 * p + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // the buffers and sBt are refilled next
  }

  // epilogue: ((f32(acc) * xs) * ws) + b, each step rounded, then bf16
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + mt * 16 + g + half * 8;
      if (m >= M) continue;
      const float sx = xs[m];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = n0 + wn + nt * 8 + 2 * t;
        if (n >= N) continue;
        float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * half]), sx), ws[n]);
        float v1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * half + 1]), sx), ws[n + 1]);
        if (bias != nullptr) {
          v0 = __fadd_rn(v0, bias[n]);
          v1 = __fadd_rn(v1, bias[n + 1]);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * N + n) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
int int8_matmul_bf16(const void* xq, const void* xs, const void* wq, const void* ws,
                     const void* bias, void* out, int M, int N, int K, void* stream) {
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  int8_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const int8_t*>(wq), static_cast<const float*>(ws),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

const char* int8_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
