// Native threaded image decode + resize pool for the training data path.
//
// The reference feeds images through PIL inside torch DataLoader worker
// processes (data/transforms.py:15-40, dataset_base.py). On this framework's
// host pipeline the JPEG decode + bicubic resize is the dominant CPU cost
// per packed 36k-token step (SURVEY hard part #6). This module does both in
// C++ with a std::thread pool over system libjpeg(-turbo), releasing the
// Python GIL for the whole batch (ctypes calls drop the GIL).
//
// Resize parity: PIL's convolution resampling (Pillow `resize`, BICUBIC
// filter, a = -0.5, support 2.0) with support scaling on downscale
// (antialias) — the same algorithm as Pillow's precompute_coeffs +
// two-pass separable convolution with the intermediate rounded to uint8
// exactly as Pillow's 8bpc path does; coefficients stay float32 vs
// Pillow's 8-bit fixed point, so per-pixel differences are ~1/255.
//
// Build: g++ -O3 -march=native -shared -fPIC imagepool.cc -o libbagelimg.so
//        -ljpeg -lpthread
// Bound via ctypes (bagel_tpu_torch/native/imagepool.py); PIL fallback when the
// toolchain or libjpeg is unavailable.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jmp;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jmp, 1);
}

// ---------------------------------------------------------------------------
// Bicubic convolution resampling (Pillow-compatible)
// ---------------------------------------------------------------------------

inline double bicubic_kernel(double x) {
  // Pillow BICUBIC: Catmull-Rom-style with a = -0.5 (Resample.c)
  const double a = -0.5;
  x = std::abs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

// Per-output-pixel coefficient table (Pillow precompute_coeffs semantics).
struct Coeffs {
  std::vector<int> bounds_lo;   // first source index per output pixel
  std::vector<int> bounds_len;  // taps per output pixel
  std::vector<float> weights;   // ksize taps per output pixel
  int ksize = 0;
};

Coeffs precompute_coeffs(int in_size, int out_size) {
  const double support_base = 2.0;  // bicubic filter support
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = support_base * filterscale;
  const int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;

  Coeffs c;
  c.ksize = ksize;
  c.bounds_lo.resize(out_size);
  c.bounds_len.resize(out_size);
  c.weights.assign(static_cast<size_t>(out_size) * ksize, 0.0f);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int lo = static_cast<int>(center - support + 0.5);
    if (lo < 0) lo = 0;
    int hi = static_cast<int>(center + support + 0.5);
    if (hi > in_size) hi = in_size;
    const int n = hi - lo;
    double total = 0.0;
    std::vector<double> w(n);
    for (int i = 0; i < n; ++i) {
      w[i] = bicubic_kernel((lo + i - center + 0.5) / filterscale);
      total += w[i];
    }
    for (int i = 0; i < n; ++i) {
      c.weights[static_cast<size_t>(xx) * ksize + i] =
          total != 0.0 ? static_cast<float>(w[i] / total) : 0.0f;
    }
    c.bounds_lo[xx] = lo;
    c.bounds_len[xx] = n;
  }
  return c;
}

// Two-pass separable resize: uint8 HWC RGB -> float32 HWC, then normalize.
void resize_norm(const uint8_t* src, int sh, int sw, float* dst, int dh,
                 int dw, const float* mean, const float* stdv) {
  const Coeffs cx = precompute_coeffs(sw, dw);
  const Coeffs cy = precompute_coeffs(sh, dh);

  // pass 1: horizontal, [sh, dw, 3]. Pillow's 8bpc path rounds + clips the
  // intermediate image to uint8 — mirror that (bicubic lobes overshoot, and
  // Pillow clips them here before the vertical pass sees them).
  auto to_u8 = [](float v) -> uint8_t {
    v = std::lround(v);
    return static_cast<uint8_t>(std::min(std::max(v, 0.0f), 255.0f));
  };
  std::vector<uint8_t> tmp(static_cast<size_t>(sh) * dw * 3);
  for (int y = 0; y < sh; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * sw * 3;
    uint8_t* trow = tmp.data() + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      const int lo = cx.bounds_lo[x];
      const int n = cx.bounds_len[x];
      const float* w = cx.weights.data() + static_cast<size_t>(x) * cx.ksize;
      float acc0 = 0, acc1 = 0, acc2 = 0;
      for (int i = 0; i < n; ++i) {
        const uint8_t* p = row + static_cast<size_t>(lo + i) * 3;
        acc0 += w[i] * p[0];
        acc1 += w[i] * p[1];
        acc2 += w[i] * p[2];
      }
      trow[x * 3 + 0] = to_u8(acc0);
      trow[x * 3 + 1] = to_u8(acc1);
      trow[x * 3 + 2] = to_u8(acc2);
    }
  }

  // pass 2: vertical + [-1, 1] normalization
  const float inv255 = 1.0f / 255.0f;
  for (int y = 0; y < dh; ++y) {
    const int lo = cy.bounds_lo[y];
    const int n = cy.bounds_len[y];
    const float* w = cy.weights.data() + static_cast<size_t>(y) * cy.ksize;
    float* drow = dst + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      float acc0 = 0, acc1 = 0, acc2 = 0;
      for (int i = 0; i < n; ++i) {
        const uint8_t* p =
            tmp.data() + (static_cast<size_t>(lo + i) * dw + x) * 3;
        acc0 += w[i] * p[0];
        acc1 += w[i] * p[1];
        acc2 += w[i] * p[2];
      }
      // Pillow clips the convolved value to [0, 255] before uint8 round;
      // mirror that so coefficients overshooting (bicubic lobes) match
      acc0 = std::min(std::max(acc0, 0.0f), 255.0f);
      acc1 = std::min(std::max(acc1, 0.0f), 255.0f);
      acc2 = std::min(std::max(acc2, 0.0f), 255.0f);
      drow[x * 3 + 0] = (acc0 * inv255 - mean[0]) / stdv[0];
      drow[x * 3 + 1] = (acc1 * inv255 - mean[1]) / stdv[1];
      drow[x * 3 + 2] = (acc2 * inv255 - mean[2]) / stdv[2];
    }
  }
}

// Decode one JPEG buffer to tightly-packed RGB8. Returns 0 on success.
int decode_rgb(const uint8_t* buf, long long len, std::vector<uint8_t>* out,
               int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  out->resize(static_cast<size_t>(*w) * *h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row =
        out->data() + static_cast<size_t>(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // namespace

extern "C" {

// Peek dimensions without a full decode (header parse only).
int jpeg_dims(const uint8_t* buf, long long len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  *w = cinfo.image_width;
  *h = cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode + bicubic-resize + normalize a batch of JPEGs across a thread pool.
//   bufs/lens: n JPEG byte buffers
//   th/tw: per-image target height/width
//   outs: n float32 buffers of th[i]*tw[i]*3 (HWC)
//   status: per-image 0 = ok
// Returns the number of failures.
int decode_resize_batch(const uint8_t* const* bufs, const long long* lens,
                        const int* th, const int* tw, int n,
                        float* const* outs, const float* mean,
                        const float* stdv, int n_threads, int* status) {
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  auto worker = [&]() {
    std::vector<uint8_t> rgb;
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      int w = 0, h = 0;
      if (decode_rgb(bufs[i], lens[i], &rgb, &w, &h) != 0) {
        status[i] = 1;
        failures.fetch_add(1);
        continue;
      }
      resize_norm(rgb.data(), h, w, outs[i], th[i], tw[i], mean, stdv);
      status[i] = 0;
    }
  };
  const int nt = std::max(1, std::min(n_threads, n));
  std::vector<std::thread> threads;
  threads.reserve(nt - 1);
  for (int t = 1; t < nt; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
  return failures.load();
}

// Resize-only entry (RGB8 already in memory), for non-JPEG sources.
void resize_bicubic_norm(const uint8_t* src, int sh, int sw, float* dst,
                         int dh, int dw, const float* mean,
                         const float* stdv) {
  resize_norm(src, sh, sw, dst, dh, dw, mean, stdv);
}

}  // extern "C"
