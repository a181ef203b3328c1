// Native host-side packing kernels for the training data path.
//
// The reference's packing loop is pure Python list manipulation over ~36k
// tokens per step (dataset_base.py:306-475). The metadata expansion —
// per-split document/fan/noise/rope arrays and bucket padding — is the
// host-CPU hot loop feeding the device (SURVEY hard part #6). These kernels
// do the expansion in one pass over compact span descriptors.
//
// Build: g++ -O3 -march=native -shared -fPIC packing.cc -o libbagelpack.so
// Bound via ctypes (bagel_tpu_torch/native/__init__.py); Python fallback when the
// toolchain is unavailable.

#include <cstdint>
#include <cstring>

extern "C" {

// span layout (int64 x 7):
//   [0] doc_id      document id for every token of the span
//   [1] fan_id      full-and-noise split id (-1 if causal)
//   [2] noise_id    noise split id (-1 otherwise)
//   [3] n_tokens    span length
//   [4] rope_mode   0 = sequential positions from rope_start, 1 = constant
//   [5] rope_start
//   [6] out_offset  first token slot of this span in the output arrays
//
// Fills doc/fan/noi/pos (int32, length >= max(out_offset + n_tokens)).
// Returns the total number of tokens written.
long long pack_spans(const long long* spans, long long n_spans,
                     int32_t* doc, int32_t* fan, int32_t* noi, int32_t* pos) {
  long long total = 0;
  for (long long s = 0; s < n_spans; ++s) {
    const long long* sp = spans + s * 7;
    const int32_t d = (int32_t)sp[0];
    const int32_t f = (int32_t)sp[1];
    const int32_t nz = (int32_t)sp[2];
    const long long n = sp[3];
    const long long mode = sp[4];
    const int32_t r0 = (int32_t)sp[5];
    const long long off = sp[6];
    for (long long i = 0; i < n; ++i) {
      doc[off + i] = d;
      fan[off + i] = f;
      noi[off + i] = nz;
      pos[off + i] = mode == 0 ? r0 + (int32_t)i : r0;
    }
    long long end = off + n;
    if (end > total) total = end;
  }
  return total;
}

// Contiguous index ranges: out[k] = starts[j] + (k - cum_prefix[j]) for each
// range j of length lens[j]. Used for scatter-index construction (the
// packed_*_indexes lists of the reference).
long long fill_ranges(const long long* starts, const long long* lens,
                      long long n_ranges, int32_t* out) {
  long long k = 0;
  for (long long j = 0; j < n_ranges; ++j) {
    const long long s = starts[j];
    const long long n = lens[j];
    for (long long i = 0; i < n; ++i) out[k++] = (int32_t)(s + i);
  }
  return k;
}

// Dense per-sample attention-mask rasterizer (bool, row-major S x S) from
// token metadata — the host-side twin of ops.attention.train_packed_mask
// for tools/debugging and CPU-side validation.
void build_train_mask(const int32_t* doc, const int32_t* fan,
                      const int32_t* noi, long long s, uint8_t* out) {
  for (long long i = 0; i < s; ++i) {
    const int32_t di = doc[i];
    const int32_t fi = fan[i];
    const int32_t ni = noi[i];
    uint8_t* row = out + i * s;
    for (long long j = 0; j < s; ++j) {
      const bool same_doc = di == doc[j] && di != 0;
      const bool causal = i >= j;
      const bool same_fan = fi == fan[j] && fi >= 0;
      const bool remove_noise = !(noi[j] >= 0 && ni != noi[j]);
      row[j] = same_doc && (causal || same_fan) && remove_noise;
    }
  }
}

}  // extern "C"
