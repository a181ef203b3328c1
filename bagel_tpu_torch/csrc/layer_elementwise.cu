// The elementwise passes of a Qwen2 MoT decoder layer between its GEMMs, for
// Hopper: three kernels that read the MoT split by row.
//
// They replace no TPU kernel: the JAX package leaves this work to XLA, which
// fuses it (bagel_tpu/models/qwen2.py:_layer_extend). In PyTorch the same
// chain is ~35 kernels a layer (fp32 casts, reductions, the MoT split's
// cats and the copies of its strided slices); ops/layer_elementwise.py holds
// each kernel's plain version, that chain as the port's plain path runs it.
//
//   add_rms_norm_kernel   y = bf16(res + o) (or y = o without res), and
//                         n = bf16(w * bf16(y * rsqrt(mean_f32(y^2) + eps)))
//                         with w the row's expert's weight (f32 or bf16):
//                         the residual add and the next RMSNorm
//                         (ops/norms.py:rms_norm's rounding points).
//   qk_norm_rope_kernel   per head, the fp32 RMSNorm of q and k with the
//                         row's expert's q_norm / k_norm (none where the
//                         config has no QK-norm), then rope from the f32
//                         cos/sin tables (ops/rope.py:apply_rope), one
//                         rounding to bf16; q written contiguous, k and v
//                         into the cache's slots [start, start + T) of each
//                         batch row, start = min(past_len[b], S - T) as
//                         models/qwen2.py:_block_at clamps it.
//   silu_mul_kernel       bf16(bf16(silu_f32(g)) * u): F.silu(gate) * up.
//
// The MoT split by row: a block holds T tokens per batch row; token t < U
// (und_len) takes the und expert, the rest the gen expert. Each tensor
// argument is a Split, one Rows per expert: the row of token (b, t) lies at
// p + b * bs + (t - t0) * rs elements, so an expert's rows may be its own
// compact tensor (t0 = U for gen) or the whole block (t0 = 0), and the
// layer needs no cat and no copy of a strided slice. Every f32 step is
// rounded on its own (__fmul_rn / __fadd_rn: nvcc would otherwise contract
// a*b+c into one FMA), as PyTorch's separate kernels round it; only the
// order of the sums of squares differs from PyTorch's reduction.
//
// What bounds them on an H100: bytes, a few operations a byte at most. At
// the 1024 px denoise (B = 3, T = 4098, d = 3584, f = 18944) add_rms_norm
// moves 4 x 88 MB, qk_norm_rope ~0.23 GB, silu_mul ~1.4 GB: ~0.6 ms a layer
// at 3.35 TB/s, against ~12 GB in PyTorch's chain. Design: one block per
// row (token) for the two norms, each thread one or more 16-byte pieces of
// the row held in registers across the block's reduction, so that each
// input byte is read once; qk_norm_rope gives each head to a half-warp (128
// values, eight a lane: the rotation's partner j +- 64 is in the same lane);
// silu_mul is one 16-byte piece a thread. No kernel allocates or syncs with
// the host: all three are captured into the decode program's CUDA graphs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kHeadDim = 128;        // qk_norm_rope: B1's head dim
constexpr int kRopeThreads = 256;    // qk_norm_rope: 16 half-warps a token
constexpr int kSiluThreads = 256;

struct Rows {  // one expert's rows: token (b, t) at p + b * bs + (t - t0) * rs
  const void* p;
  long long bs, rs;
  long long t0;
};

struct Split {  // [0]: the und expert (t < U), [1]: the gen expert
  Rows e[2];
};

// each field selected on its own: indexing s.e[e] with a run-time e would
// copy the Split out of the parameter space into local memory per thread
template <typename T>
__device__ __forceinline__ T* row_at(const Split& s, int e, int b, int t) {
  const void* p = e ? s.e[1].p : s.e[0].p;
  const long long bs = e ? s.e[1].bs : s.e[0].bs;
  const long long rs = e ? s.e[1].rs : s.e[0].rs;
  const long long t0 = e ? s.e[1].t0 : s.e[0].t0;
  return reinterpret_cast<T*>(const_cast<void*>(p)) + b * bs + (t - t0) * rs;
}

__device__ __forceinline__ float weight_at(const void* w, int bf16_w, int i) {
  return bf16_w ? __bfloat162float(static_cast<const bf16*>(w)[i])
                : static_cast<const float*>(w)[i];
}

// w[c..c+8) as f32, in one or two 16-byte loads (c % 8 == 0)
__device__ __forceinline__ void weights8(const void* w, int bf16_w, int c, float (&out)[8]) {
  if (bf16_w) {
    const uint4 v = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(w) + c);
    const bf16* h = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = __bfloat162float(h[j]);
  } else {
    const float4 a = *reinterpret_cast<const float4*>(static_cast<const float*>(w) + c);
    const float4 b = *reinterpret_cast<const float4*>(static_cast<const float*>(w) + c + 4);
    out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
    out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the sum of v over the block (every thread gets it)
__device__ float block_sum(float v) {
  __shared__ float part[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  const int warps = (blockDim.x + 31) >> 5;
  v = lane < warps ? part[lane] : 0.0f;
  return warp_sum(v);
}

// --- add_rms_norm ------------------------------------------------------------

// One block a row of d values (d % 8 == 0): thread i holds the 16-byte
// pieces i, i + blockDim.x, ... (VPT at most) of y in registers.
template <int VPT>
__global__ void __launch_bounds__(1024)
add_rms_norm_kernel(Split res, Split o, const void* w_und, const void* w_gen, int bf16_w,
                    Split y, Split n, int T, int U, int d, float eps) {
  const int row = blockIdx.x;
  const int b = row / T, t = row % T, e = t >= U;
  const bool has_res = res.e[0].p != nullptr, has_y = y.e[0].p != nullptr;
  const bf16* orow = row_at<const bf16>(o, e, b, t);
  const bf16* rrow = has_res ? row_at<const bf16>(res, e, b, t) : nullptr;
  bf16* yrow = has_y ? row_at<bf16>(y, e, b, t) : nullptr;
  uint4 yv[VPT];
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = (threadIdx.x + i * blockDim.x) * 8;
    if (c >= d) continue;
    yv[i] = *reinterpret_cast<const uint4*>(orow + c);
    bf16* yh = reinterpret_cast<bf16*>(&yv[i]);
    if (has_res) {
      const uint4 rv = *reinterpret_cast<const uint4*>(rrow + c);
      const bf16* rh = reinterpret_cast<const bf16*>(&rv);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        yh[j] = __float2bfloat16_rn(__fadd_rn(__bfloat162float(rh[j]), __bfloat162float(yh[j])));
      if (has_y) *reinterpret_cast<uint4*>(yrow + c) = yv[i];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float f = __bfloat162float(yh[j]);
      ss += f * f;
    }
  }
  // mean as PyTorch's reduction takes it: the sum times f32(1 / d)
  const float r = rsqrtf(__fadd_rn(__fmul_rn(block_sum(ss), 1.0f / d), eps));
  const void* w = e ? w_gen : w_und;
  bf16* nrow = row_at<bf16>(n, e, b, t);
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = (threadIdx.x + i * blockDim.x) * 8;
    if (c >= d) continue;
    const bf16* yh = reinterpret_cast<const bf16*>(&yv[i]);
    float wv[8];
    weights8(w, bf16_w, c, wv);
    uint4 nv;
    bf16* nh = reinterpret_cast<bf16*>(&nv);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float a = __bfloat162float(__float2bfloat16_rn(__fmul_rn(__bfloat162float(yh[j]), r)));
      nh[j] = __float2bfloat16_rn(__fmul_rn(wv[j], a));
    }
    *reinterpret_cast<uint4*>(nrow + c) = nv;
  }
}

// --- qk_norm_rope ------------------------------------------------------------

// One block a token; items 0..H-1 are q heads, H..H+KH-1 k heads (norm
// and rope), the next KH the v heads (a copy), one a half-warp. Lane l of
// a half holds the head's values 4l..4l+3 (first half) and 64+4l..67+4l
// (second half): rotate_half's partner of each is in the lane, and a
// warp's two heads load together (two 8-byte loads a lane).
__global__ void __launch_bounds__(kRopeThreads)
qk_norm_rope_kernel(Split q, Split k, Split v, const void* qn_und, const void* qn_gen,
                    const void* kn_und, const void* kn_gen, int bf16_w,
                    const float* __restrict__ cos, const float* __restrict__ sin,
                    bf16* __restrict__ q_out, bf16* k_buf, long long k_bs, long long k_ss,
                    bf16* v_buf, long long v_bs, long long v_ss,
                    const int* __restrict__ past_len, int S, int T, int U, int H, int KH,
                    float eps) {
  const int row = blockIdx.x;
  const int b = row / T, t = row % T, e = t >= U;
  const int hl = threadIdx.x & 15, half = threadIdx.x >> 4;
  const unsigned mask = 0xFFFFu << (threadIdx.x & 16);  // this half-warp's lanes
  const long long slot = min(static_cast<long long>(past_len[b]), static_cast<long long>(S - T)) + t;
  const int lo = 4 * hl, hi = kHeadDim / 2 + 4 * hl;
  for (int item = half; item < H + 2 * KH; item += kRopeThreads / 16) {
    if (item >= H + KH) {  // v: copied into its slot
      const int head = item - H - KH;
      const bf16* src = row_at<const bf16>(v, e, b, t) + head * kHeadDim;
      bf16* dst = v_buf + b * v_bs + slot * v_ss + head * kHeadDim;
      reinterpret_cast<uint4*>(dst)[hl] = reinterpret_cast<const uint4*>(src)[hl];
      continue;
    }
    const bool is_q = item < H;
    const int head = is_q ? item : item - H;
    const bf16* src =
        (is_q ? row_at<const bf16>(q, e, b, t) : row_at<const bf16>(k, e, b, t)) + head * kHeadDim;
    const uint2 vlo = *reinterpret_cast<const uint2*>(src + lo);
    const uint2 vhi = *reinterpret_cast<const uint2*>(src + hi);
    const float2 a0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&vlo.x));
    const float2 a1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&vlo.y));
    const float2 a2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&vhi.x));
    const float2 a3 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&vhi.y));
    float x[8] = {a0.x, a0.y, a1.x, a1.y, a2.x, a2.y, a3.x, a3.y};
    const void* w = is_q ? (e ? qn_gen : qn_und) : (e ? kn_gen : kn_und);
    if (w != nullptr) {  // fp32 RMSNorm over the head, then the f32 weight
      float ss = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) ss += x[j] * x[j];
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) ss += __shfl_xor_sync(mask, ss, o);
      const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, 1.0f / kHeadDim), eps));
#pragma unroll
      for (int j = 0; j < 8; ++j)
        x[j] = __fmul_rn(weight_at(w, bf16_w, (j < 4 ? lo : hi - 4) + j), __fmul_rn(x[j], r));
    }
    // x * cos + rotate_half(x) * sin, rotate_half(x) = [-x2, x1]
    const float* c = cos + static_cast<long long>(row) * kHeadDim;
    const float* s = sin + static_cast<long long>(row) * kHeadDim;
    const float4 clo = *reinterpret_cast<const float4*>(c + lo);
    const float4 chi = *reinterpret_cast<const float4*>(c + hi);
    const float4 slo = *reinterpret_cast<const float4*>(s + lo);
    const float4 shi = *reinterpret_cast<const float4*>(s + hi);
    const float cl[4] = {clo.x, clo.y, clo.z, clo.w}, ch[4] = {chi.x, chi.y, chi.z, chi.w};
    const float sl[4] = {slo.x, slo.y, slo.z, slo.w}, sh[4] = {shi.x, shi.y, shi.z, shi.w};
    float out[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out[j] = __fadd_rn(__fmul_rn(x[j], cl[j]), __fmul_rn(-x[4 + j], sl[j]));
      out[4 + j] = __fadd_rn(__fmul_rn(x[4 + j], ch[j]), __fmul_rn(x[j], sh[j]));
    }
    bf16* dst = is_q ? q_out + (static_cast<long long>(row) * H + head) * kHeadDim
                     : k_buf + b * k_bs + slot * k_ss + head * kHeadDim;
    __nv_bfloat162 olo[2] = {__floats2bfloat162_rn(out[0], out[1]),
                             __floats2bfloat162_rn(out[2], out[3])};
    __nv_bfloat162 ohi[2] = {__floats2bfloat162_rn(out[4], out[5]),
                             __floats2bfloat162_rn(out[6], out[7])};
    *reinterpret_cast<uint2*>(dst + lo) = *reinterpret_cast<const uint2*>(olo);
    *reinterpret_cast<uint2*>(dst + hi) = *reinterpret_cast<const uint2*>(ohi);
  }
}

// --- silu_mul ----------------------------------------------------------------

// A block covers kSiluThreads 16-byte pieces of one row of f values
// (f % 8 == 0): `chunks` blocks a row.
__global__ void __launch_bounds__(kSiluThreads)
silu_mul_kernel(Split gate, Split up, Split out, int T, int U, int f, int chunks) {
  const int row = blockIdx.x / chunks;
  const int c = ((blockIdx.x % chunks) * kSiluThreads + threadIdx.x) * 8;
  if (c >= f) return;
  const int b = row / T, t = row % T, e = t >= U;
  const uint4 gv = *reinterpret_cast<const uint4*>(row_at<const bf16>(gate, e, b, t) + c);
  const uint4 uv = *reinterpret_cast<const uint4*>(row_at<const bf16>(up, e, b, t) + c);
  const bf16* gh = reinterpret_cast<const bf16*>(&gv);
  const bf16* uh = reinterpret_cast<const bf16*>(&uv);
  uint4 ov;
  bf16* oh = reinterpret_cast<bf16*>(&ov);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float g = __bfloat162float(gh[j]);
    // PyTorch's silu in f32: x / (1 + exp(-x)), IEEE division
    const float sg = __bfloat162float(__float2bfloat16_rn(g / (1.0f + expf(-g))));
    oh[j] = __float2bfloat16_rn(__fmul_rn(sg, __bfloat162float(uh[j])));
  }
  *reinterpret_cast<uint4*>(row_at<bf16>(out, e, b, t) + c) = ov;
}

Split split_of(const long long* a) {  // 8 values: (p, bs, rs, t0) und, then gen
  Split s;
  for (int i = 0; i < 2; ++i) {
    s.e[i].p = reinterpret_cast<const void*>(static_cast<uintptr_t>(a[4 * i]));
    s.e[i].bs = a[4 * i + 1];
    s.e[i].rs = a[4 * i + 2];
    s.e[i].t0 = a[4 * i + 3];
  }
  return s;
}

Split none() {
  Split s = {};
  return s;
}

}  // namespace

extern "C" {

// Each Split argument points at 8 host int64 values: the und expert's
// (pointer, batch stride, row stride, t0), then the gen expert's; strides in
// elements. res and y may be null (no residual add / the sum not written).
// Launches on `stream`; returns 0 or cudaGetLastError()'s code.
int add_rms_norm_bf16(const long long* res, const long long* o, const void* w_und,
                      const void* w_gen, int bf16_w, const long long* y, const long long* n,
                      int B, int T, int U, int d, float eps, void* stream) {
  const int pieces = d / 8;
  const int threads = std::min(1024, (pieces + 31) / 32 * 32);
  const int vpt = (pieces + threads - 1) / threads;
  const Split r = res ? split_of(res) : none(), ys = y ? split_of(y) : none();
  auto st = static_cast<cudaStream_t>(stream);
  if (vpt > 4) return static_cast<int>(cudaErrorInvalidValue);
  if (vpt == 1)
    add_rms_norm_kernel<1><<<B * T, threads, 0, st>>>(r, split_of(o), w_und, w_gen, bf16_w, ys,
                                                      split_of(n), T, U, d, eps);
  else if (vpt == 2)
    add_rms_norm_kernel<2><<<B * T, threads, 0, st>>>(r, split_of(o), w_und, w_gen, bf16_w, ys,
                                                      split_of(n), T, U, d, eps);
  else
    add_rms_norm_kernel<4><<<B * T, threads, 0, st>>>(r, split_of(o), w_und, w_gen, bf16_w, ys,
                                                      split_of(n), T, U, d, eps);
  return static_cast<int>(cudaGetLastError());
}

// q, k, v: Splits of [heads, 128] bf16 rows; qn_* / kn_* the experts' norm
// weights [128] (all null: no QK-norm); cos / sin [B, T, 128] f32; q_out
// [B, T, H, 128] bf16; k_buf / v_buf [B, S, KH, 128] bf16 with the given
// batch and slot strides; past_len [B] int32 on the device.
int qk_norm_rope_bf16(const long long* q, const long long* k, const long long* v,
                      const void* qn_und, const void* qn_gen, const void* kn_und,
                      const void* kn_gen, int bf16_w, const void* cos, const void* sin,
                      void* q_out, void* k_buf, long long k_bs, long long k_ss, void* v_buf,
                      long long v_bs, long long v_ss, const void* past_len, int B, int S, int T,
                      int U, int H, int KH, float eps, void* stream) {
  qk_norm_rope_kernel<<<B * T, kRopeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      split_of(q), split_of(k), split_of(v), qn_und, qn_gen, kn_und, kn_gen, bf16_w,
      static_cast<const float*>(cos), static_cast<const float*>(sin), static_cast<bf16*>(q_out),
      static_cast<bf16*>(k_buf), k_bs, k_ss, static_cast<bf16*>(v_buf), v_bs, v_ss,
      static_cast<const int*>(past_len), S, T, U, H, KH, eps);
  return static_cast<int>(cudaGetLastError());
}

// gate, up, out: Splits of f bf16 values a row.
int silu_mul_bf16(const long long* gate, const long long* up, const long long* out, int B,
                  int T, int U, int f, void* stream) {
  const int chunks = (f / 8 + kSiluThreads - 1) / kSiluThreads;
  silu_mul_kernel<<<B * T * chunks, kSiluThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      split_of(gate), split_of(up), split_of(out), T, U, f, chunks);
  return static_cast<int>(cudaGetLastError());
}

const char* layer_elementwise_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
