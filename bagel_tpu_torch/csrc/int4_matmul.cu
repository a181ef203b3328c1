// Fused int4 dequant-matmul for few activation rows (decode), for Hopper.
//
// Replaces the TPU kernel bagel_tpu/ops/int4_matmul.py:_int4_kernel
// (reached from int4_matmul, :144, through _int4_call, :122). It computes
//
//   out[m,n] = bf16( sum_k bf16(x[m,k]) * bf16(f32(nib[k,n] - 8) * scale[k/128,n]) )
//
// with f32 products and sums, the rounding points of the JAX kernel: x in
// bf16, each weight rounded to bf16 after its f32 scale multiply. Packed row
// j of w_p4 holds input rows 2j (low nibble) and 2j+1 (high nibble); one f32
// scale covers 128 input rows (64 packed rows) of a column.
//
// Layout: x [M, in] bf16 row-major (M <= 64), w_p4 [in/2, N] uint8 row-major
// (the JAX [in, out] layout, packed), scale4 [in/128, N] f32, partial
// [splits, M, N] f32 scratch, out [M, N] bf16. in % 128 == 0, N % 16 == 0.
//
// What bounds it on an H100 (3.35 TB/s): it reads in*N/2 bytes of nibbles
// and in*N/32 of scales for 2*M*in*N operations, a few operations a byte at
// decode (M = 1): bandwidth-bound. A decode step's 112 int4 linears read
// ~3.47 GB, ~1.0 ms at the bandwidth.
//
// Design (simple and right first):
// - A block of 8 warps takes 512 output columns (a warp reads one packed
//   row's 512 bytes with one 16-byte load a lane: coalesced) and a range of
//   packed rows; warp w takes rows w, w+8, ..., eight of them loaded before
//   any is used.
// - Split K: the k/v projections have only 512 columns, one column tile, too
//   few blocks for 132 SMs. The wrapper splits the rows, in slices of 8, so
//   that the grid has ~264 blocks. Each block sums its 8 warps in shared
//   memory in a fixed order and writes its partial sums; a second kernel
//   adds the splits in order and rounds to bf16. No atomics: the result is
//   deterministic.
// - Up to 4 activation rows per block (grid z covers more); one row is a
//   template case of its own, for decode's register budget.
//
// What it leaves on the table: the dequantization costs ~10 integer and
// float instructions per weight byte, near the SM's issue rate at the
// bandwidth; a lookup of bf16 pairs, or bf16x2 arithmetic, would halve it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 512;          // columns per block: 32 lanes x 16
constexpr int kRowsPerGroup = 64; // packed rows per scale group

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int MC>
__global__ void __launch_bounds__(kThreads)
int4_partial_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ wp,
                    const float* __restrict__ scale, float* __restrict__ partial,
                    int M, int IN, int N, int per_split) {
  __shared__ float red[kWarps][kBN];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int split = blockIdx.y;
  const int c0 = blockIdx.x * kBN + lane * 16;
  const bool col_ok = c0 < N;
  const int m0 = blockIdx.z * MC;
  const int mc = min(MC, M - m0);
  // this block's packed rows, in slices of one row per warp
  const int row_begin = split * per_split * kWarps;
  const int row_end = min(IN / 2, row_begin + per_split * kWarps);

  float acc[MC][16];
#pragma unroll
  for (int m = 0; m < MC; ++m)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[m][i] = 0.f;

  if (col_ok) {
    int cur_g = -1;
    float sc[16];
    constexpr int kUnroll = 8;  // packed rows a warp has in flight
    for (int base = row_begin; base < row_end; base += kUnroll * kWarps) {
      uint4 w[kUnroll];
#pragma unroll
      for (int r = 0; r < kUnroll; ++r) {
        const int j = base + warp + r * kWarps;
        if (j < row_end) w[r] = __ldg(reinterpret_cast<const uint4*>(wp + (size_t)j * N + c0));
      }
#pragma unroll
      for (int r = 0; r < kUnroll; ++r) {
        const int j = base + warp + r * kWarps;
        if (j >= row_end) break;
        const int g = j / kRowsPerGroup;
        if (g != cur_g) {
          const float4* sp = reinterpret_cast<const float4*>(scale + (size_t)g * N + c0);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 s4 = __ldg(sp + q);
            sc[4 * q] = s4.x, sc[4 * q + 1] = s4.y, sc[4 * q + 2] = s4.z, sc[4 * q + 3] = s4.w;
          }
          cur_g = g;
        }
        float xe[MC], xo[MC];
#pragma unroll
        for (int m = 0; m < MC; ++m) {
          xe[m] = xo[m] = 0.f;
          if (m < mc) {
            const __nv_bfloat162 p =
                *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)(m0 + m) * IN + 2 * j);
            xe[m] = __low2float(p);
            xo[m] = __high2float(p);
          }
        }
        const uint32_t words[4] = {w[r].x, w[r].y, w[r].z, w[r].w};
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int byte = (words[i / 4] >> (8 * (i % 4))) & 0xff;
          const float lo = bf16_round(__fmul_rn(static_cast<float>((byte & 15) - 8), sc[i]));
          const float hi = bf16_round(__fmul_rn(static_cast<float>((byte >> 4) - 8), sc[i]));
#pragma unroll
          for (int m = 0; m < MC; ++m) acc[m][i] = fmaf(xo[m], hi, fmaf(xe[m], lo, acc[m][i]));
        }
      }
    }
  }

  // the 8 warps' sums, added in warp order, one activation row at a time
  for (int m = 0; m < mc; ++m) {
    float4* dst = reinterpret_cast<float4*>(&red[warp][lane * 16]);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      dst[q] = make_float4(acc[m][4 * q], acc[m][4 * q + 1], acc[m][4 * q + 2], acc[m][4 * q + 3]);
    __syncthreads();
    for (int c = threadIdx.x; c < kBN; c += kThreads) {
      const int n = blockIdx.x * kBN + c;
      if (n < N) {
        float s = 0.f;
#pragma unroll
        for (int w2 = 0; w2 < kWarps; ++w2) s += red[w2][c];
        partial[((size_t)split * M + m0 + m) * N + n] = s;
      }
    }
    __syncthreads();
  }
}

__global__ void int4_reduce_kernel(const float* __restrict__ partial, __nv_bfloat16* __restrict__ out,
                                   int MN, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partial[(size_t)k * MN + i];
  out[i] = __float2bfloat16_rn(s);
}

}  // namespace

extern "C" {

// Launches both passes on `stream` and returns cudaGetLastError() (0 on
// success). per_split slices of 8 packed rows per block, splits blocks
// along k.
int int4_matmul_bf16(const void* x, const void* w_p4, const void* scale4, void* partial,
                     void* out, int M, int IN, int N, int per_split, int splits,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const uint8_t*>(w_p4);
  const auto* sc = static_cast<const float*>(scale4);
  auto* part = static_cast<float*>(partial);
  if (M == 1) {
    const dim3 grid((N + kBN - 1) / kBN, splits, 1);
    int4_partial_kernel<1><<<grid, kThreads, 0, s>>>(xb, wp, sc, part, M, IN, N, per_split);
  } else {
    const dim3 grid((N + kBN - 1) / kBN, splits, (M + 3) / 4);
    int4_partial_kernel<4><<<grid, kThreads, 0, s>>>(xb, wp, sc, part, M, IN, N, per_split);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int mn = M * N;
  int4_reduce_kernel<<<(mn + 255) / 256, 256, 0, s>>>(part, static_cast<__nv_bfloat16*>(out),
                                                       mn, splits);
  return static_cast<int>(cudaGetLastError());
}

const char* int4_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
