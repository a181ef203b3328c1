// Fused int4 dequant-matmul for few activation rows (decode), for Hopper.
//
// Replaces the TPU kernel bagel_tpu/ops/int4_matmul.py:_int4_kernel
// (reached from int4_matmul, :144, through _int4_call, :122). It computes
//
//   out[m,n] = bf16( sum_k bf16(x[m,k]) * bf16(f32(nib[k,n] - 8) * scale[k/128,n]) )
//
// with f32 products and sums, the rounding points of the JAX kernel: x in
// bf16, each weight rounded to bf16 after its f32 scale multiply. With a
// bias b[n] it then adds it as JAX's _linear does after the kernel:
// out = bf16(f32(bf16(sum)) + f32(b)). Packed row j of w_p4 holds input rows
// 2j (low nibble) and 2j+1 (high nibble); one f32 scale covers 128 input
// rows (64 packed rows, a "group") of a column.
//
// Layout: x [M, K] bf16 row-major (M <= 64), w_p4 [K/2, N] uint8 row-major
// (the JAX [in, out] layout, packed), scale4 [K/128, N] f32, bias [N] bf16
// or f32 or none, out [M, N] bf16; K % 128 == 0, N % 16 == 0. Scratch: one
// f32 partial-sum slot a block where K is split, and one arrival counter
// per column tile and row group, which must be 0 before the launch and are
// 0 again after it.
//
// What bounds it on an H100: it reads K*N/2 bytes of nibbles and K*N/32 of
// scales for 2*M*K*N operations, a few operations a byte at decode (M = 1):
// the bound is the bytes, 3.35 TB/s. A decode token's 112 int4 linears read
// 3.47 GB, 1.04 ms at that rate. What sets the pace in practice is the
// dequantization's instruction count: at 3.35 TB/s an SM has to turn ~26
// weights a clock into f32 at an issue rate of 128 thread-instructions a
// clock, so every instruction per weight counts.
//
// Design:
// - Dequantization without the conversion pipe (its 16 results a clock per
//   SM held the first version of this kernel to ~0.9 TB/s): the nibbles of
//   a 32-bit word are masked out (w & 0x0F0F0F0F, (w >> 4) & 0x0F0F0F0F)
//   and one byte permute (PRMT) puts a nibble into the mantissa of 2^23, so
//   the word 0x4B00000v is the float 2^23 + v; subtracting 2^23 + 8 gives
//   f32(v - 8) exactly. Then the f32 multiply by the scale, one
//   cvt.rn.bf16x2.f32 rounds the pair (low and high nibble of one byte) to
//   bf16, and a shift and a mask bring each back to f32. About six
//   instructions a weight at M = 1, one of them the FMA.
// - Split K: a block takes one 256-column tile, one group of up to 4
//   activation rows (one row at decode: a template case of its own, for its
//   register budget) and a run of `rps` packed rows of K (16, 32, or a
//   multiple of 64, so that a step of 64 rows never crosses a scale group).
//   The grid is tiles x row groups x splits; ops/int4_matmul.py:grid picks
//   `rps`. Threads are 16 column lanes of 16 columns (one 16-byte load a
//   packed row) by 16 row lanes; a thread loads its next step's weights and
//   scales before it dequantizes the current step's.
// - The block sums its 16 row lanes in shared memory in a fixed order. With
//   one split it writes the output. Otherwise it writes its partial sums into
//   its split's slot, and the last block of the tile to arrive (an arrival
//   counter, after a __threadfence) adds the slots in split order, writes the
//   output and sets the counter back to 0. One launch a call, and the order
//   of the sums does not depend on which block came last: the result is the
//   same bit for bit from call to call.
// - A counter found at or past its tile's split count (a state no launch
//   leaves) traps: the call fails rather than return a wrong result.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColLanes = 16;                          // threads across the columns
constexpr int kRowLanes = kThreads / kColLanes;        // threads down the packed rows
constexpr int kBN = kColLanes * 16;                    // columns per block
constexpr int kStep = 64;                              // packed rows a step: one scale group
constexpr int kRowsPerLane = kStep / kRowLanes;        // a thread's packed rows a step
static_assert(kBN == kThreads, "one column a thread in the block's reduction");

constexpr int kBiasNone = 0, kBiasBf16 = 1;

// 0x4B00000v is the f32 2^23 + v: byte `sel` selects which nibble v
__device__ __forceinline__ float nibble_minus8(uint32_t nibbles, uint32_t sel) {
  return __uint_as_float(__byte_perm(nibbles, 0x4B000000u, sel)) - 8388616.0f;  // 2^23 + 8
}

// One 32-bit word of w_p4 (4 columns) with those columns' scales: the even
// row's (lo) and odd row's (hi) weights, bf16(f32(nib - 8) * scale) as f32.
__device__ __forceinline__ void dequant_word(uint32_t w, const float* s, float (&lo)[4],
                                             float (&hi)[4]) {
  const uint32_t wl = w & 0x0F0F0F0Fu;
  const uint32_t wh = (w >> 4) & 0x0F0F0F0Fu;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t sel = 0x7440u | i;  // byte i of the word, zeros, 0x4B on top
    const __nv_bfloat162 p = __floats2bfloat162_rn(__fmul_rn(nibble_minus8(wl, sel), s[i]),
                                                   __fmul_rn(nibble_minus8(wh, sel), s[i]));
    const uint32_t u = *reinterpret_cast<const uint32_t*>(&p);  // lo in the low half
    lo[i] = __uint_as_float(u << 16);
    hi[i] = __uint_as_float(u & 0xFFFF0000u);
  }
}

__device__ __forceinline__ __nv_bfloat16 finish(float sum, const void* bias, int bias_kind,
                                                int n) {
  const __nv_bfloat16 r = __float2bfloat16_rn(sum);
  if (bias_kind == kBiasNone) return r;
  const float b = bias_kind == kBiasBf16
                      ? __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[n])
                      : static_cast<const float*>(bias)[n];
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(r), b));
}

// the weights are read once: keep them out of L1
__device__ __forceinline__ uint4 load_stream(const uint8_t* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// One step's operands of a thread: its packed rows' 16 bytes and its 16
// columns' scales.
struct Step {
  uint4 w[kRowsPerLane];
  float4 s[4];
};

// grid: (column tiles, row groups of MC activation rows, splits of K)
template <int MC>
__global__ void __launch_bounds__(kThreads, MC == 1 ? 2 : 1)
int4_matmul_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ wp,
                   const float* __restrict__ scale, const void* __restrict__ bias,
                   int bias_kind, float* __restrict__ partial,
                   unsigned int* __restrict__ counters, __nv_bfloat16* __restrict__ out,
                   int M, int K, int N, int rps) {
  __shared__ float red[kRowLanes][kBN];
  __shared__ bool last;

  const int tid = threadIdx.x;
  const int cl = tid % kColLanes, rl = tid / kColLanes;
  const int tile = blockIdx.x, z = blockIdx.y, split = blockIdx.z, splits = gridDim.z;
  const int col = tile * kBN + cl * 16;
  const int mc = min(MC, M - z * MC);
  const int row_begin = split * rps, row_end = min(K / 2, row_begin + rps);
  const int lane_rows = min(rps, kStep);  // rows of a step (rps < 64: the step is rps)
  const __nv_bfloat16* xz = x + static_cast<size_t>(z) * MC * K;

  float acc[MC][16];
#pragma unroll
  for (int m = 0; m < MC; ++m)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[m][i] = 0.f;

  auto load = [&](int row0, Step& st) {
#pragma unroll
    for (int r = 0; r < kRowsPerLane; ++r) {
      const int row = row0 + rl + r * kRowLanes;
      st.w[r] = rl + r * kRowLanes < lane_rows ? load_stream(wp + static_cast<size_t>(row) * N + col)
                                               : make_uint4(0, 0, 0, 0);
    }
    const float4* s4 = reinterpret_cast<const float4*>(scale + static_cast<size_t>(row0 / kStep) * N + col);
#pragma unroll
    for (int q = 0; q < 4; ++q) st.s[q] = __ldg(s4 + q);
  };

  if (col < N) {
    Step cur, next;
    load(row_begin, cur);
    for (int row0 = row_begin; row0 < row_end; row0 += lane_rows) {
      if (row0 + lane_rows < row_end) load(row0 + lane_rows, next);
      const float sc[16] = {cur.s[0].x, cur.s[0].y, cur.s[0].z, cur.s[0].w,
                            cur.s[1].x, cur.s[1].y, cur.s[1].z, cur.s[1].w,
                            cur.s[2].x, cur.s[2].y, cur.s[2].z, cur.s[2].w,
                            cur.s[3].x, cur.s[3].y, cur.s[3].z, cur.s[3].w};
#pragma unroll
      for (int r = 0; r < kRowsPerLane; ++r) {
        const int row = row0 + rl + r * kRowLanes;
        if (rl + r * kRowLanes >= lane_rows) continue;
        float xe[MC], xo[MC];
#pragma unroll
        for (int m = 0; m < MC; ++m) {
          const __nv_bfloat162 p =
              m < mc ? __ldg(reinterpret_cast<const __nv_bfloat162*>(xz + static_cast<size_t>(m) * K) + row)
                     : __floats2bfloat162_rn(0.f, 0.f);
          xe[m] = __low2float(p);
          xo[m] = __high2float(p);
        }
        const uint32_t words[4] = {cur.w[r].x, cur.w[r].y, cur.w[r].z, cur.w[r].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float lo[4], hi[4];
          dequant_word(words[q], sc + 4 * q, lo, hi);
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int m = 0; m < MC; ++m)
              acc[m][4 * q + e] = fmaf(xo[m], hi[e], fmaf(xe[m], lo[e], acc[m][4 * q + e]));
        }
      }
      cur = next;
    }
  }

  // the block's sums over its row lanes, in order; then the output, or this
  // split's slot for the tile's last block to add
  const int tiles = gridDim.x, zt = z * tiles + tile;
  const int n = tile * kBN + tid;
  float* slots = partial + static_cast<size_t>(zt) * splits * MC * kBN;
#pragma unroll
  for (int m = 0; m < MC; ++m) {
    if (m >= mc) break;
    float4* dst = reinterpret_cast<float4*>(&red[rl][cl * 16]);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      dst[q] = make_float4(acc[m][4 * q], acc[m][4 * q + 1], acc[m][4 * q + 2], acc[m][4 * q + 3]);
    __syncthreads();
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < kRowLanes; ++r) s += red[r][tid];
    if (n < N) {
      if (splits == 1)
        out[static_cast<size_t>(z * MC + m) * N + n] = finish(s, bias, bias_kind, n);
      else
        slots[(static_cast<size_t>(split) * MC + m) * kBN + tid] = s;
    }
    __syncthreads();
  }
  if (splits == 1) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned int arrived = atomicAdd(&counters[zt], 1u);
    if (arrived >= static_cast<unsigned int>(splits)) __trap();  // not left by any launch
    last = arrived == static_cast<unsigned int>(splits - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (n < N) {
    for (int m = 0; m < mc; ++m) {
      float s = 0.f;
      for (int k = 0; k < splits; ++k) s += __ldcg(&slots[(static_cast<size_t>(k) * MC + m) * kBN + tid]);
      out[static_cast<size_t>(z * MC + m) * N + n] = finish(s, bias, bias_kind, n);
    }
  }
  if (tid == 0) counters[zt] = 0;  // ready for the next launch
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// rps: packed rows a split (16, 32 or a multiple of 64); the grid is
// N/256 column tiles x row groups ((M + 3) / 4, or 1 at M = 1) x
// ceil(K/2 / rps) splits. bias_kind: 0 none, 1 bf16, 2 f32. With more
// than one split, partial holds tiles x row groups x splits slots of 4 x
// 256 floats (1 x 256 at M = 1) and counters one zeroed int per tile and
// row group.
int int4_matmul_bf16(const void* x, const void* w_p4, const void* scale4, const void* bias,
                     int bias_kind, void* partial, void* counters, void* out, int M, int K,
                     int N, int rps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const uint8_t*>(w_p4);
  const auto* sc = static_cast<const float*>(scale4);
  auto* part = static_cast<float*>(partial);
  auto* cnt = static_cast<unsigned int*>(counters);
  auto* o = static_cast<__nv_bfloat16*>(out);
  const int tiles = (N + kBN - 1) / kBN, splits = (K / 2 + rps - 1) / rps;
  if (M == 1) {
    int4_matmul_kernel<1><<<dim3(tiles, 1, splits), kThreads, 0, s>>>(
        xb, wp, sc, bias, bias_kind, part, cnt, o, M, K, N, rps);
  } else {
    int4_matmul_kernel<4><<<dim3(tiles, (M + 3) / 4, splits), kThreads, 0, s>>>(
        xb, wp, sc, bias, bias_kind, part, cnt, o, M, K, N, rps);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* int4_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
