// Native FLAC frame encoder (mono, 16-bit): fixed predictors + Rice coding.
//
// The reference ships no audio codecs (SURVEY §2 — it returns WAV/base64
// only; api/endpoints.py writes .wav files). This framework's OpenAI-
// compatible surface (`POST /v1/audio/speech`) accepts
// `response_format: "flac"`, and this library is the hot path for it:
// losslessly compress the synthesized PCM16 on the serving host without
// any external codec dependency. Python wrapper: audio/flac.py (which
// also carries a numpy fallback producing byte-identical output, and the
// STREAMINFO/MD5 container framing).
//
// Format notes (RFC 9639): fixed-blocksize stream, one CONSTANT /
// VERBATIM / FIXED(0-4) subframe per frame, Rice method 0 with partition
// order 0. Encoder never emits an escaped partition (16-bit input keeps
// order-4 residuals within k<=14); the decoder in audio/flac.py still
// handles escapes for robustness.
//
// Build: g++ -O3 -shared -fPIC flacenc.cpp -o libttsflac.so

#include <cstdint>
#include <cstring>
#include <cstddef>

namespace {

class BitWriter {
 public:
  BitWriter(uint8_t* buf, size_t cap) : buf_(buf), cap_(cap) {}

  void put(uint64_t val, int n) {  // n <= 56
    acc_ = (acc_ << n) | (val & ((n >= 64) ? ~0ull : ((1ull << n) - 1)));
    fill_ += n;
    while (fill_ >= 8) {
      if (len_ >= cap_) { overflow_ = true; fill_ = 0; return; }
      buf_[len_++] = (uint8_t)(acc_ >> (fill_ - 8));
      fill_ -= 8;
    }
  }

  void put_unary(uint32_t q) {  // q zero bits then a one bit
    while (q >= 32) { put(0, 32); q -= 32; }
    put(1, (int)q + 1);
  }

  void align() { if (fill_) put(0, 8 - fill_); }
  size_t len() const { return len_; }
  bool overflow() const { return overflow_; }
  uint8_t* data() const { return buf_; }

 private:
  uint8_t* buf_;
  size_t cap_;
  size_t len_ = 0;
  uint64_t acc_ = 0;
  int fill_ = 0;
  bool overflow_ = false;
};

uint8_t crc8(const uint8_t* p, size_t n) {  // poly 0x07, init 0
  uint8_t c = 0;
  for (size_t i = 0; i < n; ++i) {
    c ^= p[i];
    for (int b = 0; b < 8; ++b) c = (c & 0x80) ? (uint8_t)((c << 1) ^ 0x07) : (uint8_t)(c << 1);
  }
  return c;
}

uint16_t crc16(const uint8_t* p, size_t n) {  // poly 0x8005, init 0
  uint16_t c = 0;
  for (size_t i = 0; i < n; ++i) {
    c ^= (uint16_t)p[i] << 8;
    for (int b = 0; b < 8; ++b) c = (c & 0x8000) ? (uint16_t)((c << 1) ^ 0x8005) : (uint16_t)(c << 1);
  }
  return c;
}

// UTF-8-style coded frame number (RFC 9639 §9.1.5).
int utf8_code(uint64_t v, uint8_t* out) {
  if (v < 0x80) { out[0] = (uint8_t)v; return 1; }
  int extra;
  uint8_t lead;
  if (v < 0x800) { extra = 1; lead = 0xC0; }
  else if (v < 0x10000) { extra = 2; lead = 0xE0; }
  else if (v < 0x200000) { extra = 3; lead = 0xF0; }
  else if (v < 0x4000000) { extra = 4; lead = 0xF8; }
  else { extra = 5; lead = 0xFC; }
  out[0] = (uint8_t)(lead | (v >> (6 * extra)));
  for (int i = 1; i <= extra; ++i)
    out[i] = (uint8_t)(0x80 | ((v >> (6 * (extra - i))) & 0x3F));
  return extra + 1;
}

// Block size header code; returns code, sets need8/need16 for the
// explicit tail field.
int blocksize_code(uint32_t bs, int* need8, int* need16) {
  *need8 = *need16 = 0;
  switch (bs) {
    case 192: return 1;
    case 576: return 2;
    case 1152: return 3;
    case 2304: return 4;
    case 4608: return 5;
    case 256: return 8;
    case 512: return 9;
    case 1024: return 10;
    case 2048: return 11;
    case 4096: return 12;
    case 8192: return 13;
    case 16384: return 14;
    case 32768: return 15;
  }
  if (bs <= 256) { *need8 = 1; return 6; }
  *need16 = 1;
  return 7;
}

int samplerate_code(uint32_t sr, int* tail_bits, uint32_t* tail_val) {
  *tail_bits = 0;
  *tail_val = 0;
  switch (sr) {
    case 88200: return 1;
    case 176400: return 2;
    case 192000: return 3;
    case 8000: return 4;
    case 16000: return 5;
    case 22050: return 6;
    case 24000: return 7;
    case 32000: return 8;
    case 44100: return 9;
    case 48000: return 10;
    case 96000: return 11;
  }
  if (sr % 1000 == 0 && sr / 1000 < 256) { *tail_bits = 8; *tail_val = sr / 1000; return 12; }
  if (sr < 65536) { *tail_bits = 16; *tail_val = sr; return 13; }
  if (sr % 10 == 0 && sr / 10 < 65536) { *tail_bits = 16; *tail_val = sr / 10; return 14; }
  return 0;  // "get from STREAMINFO"
}

uint32_t zigzag(int32_t e) { return ((uint32_t)e << 1) ^ (uint32_t)(e >> 31); }

// Exact Rice cost for parameter k over zigzagged residuals.
uint64_t rice_cost(const uint32_t* u, size_t n, int k) {
  uint64_t bits = (uint64_t)n * (k + 1);
  for (size_t i = 0; i < n; ++i) bits += u[i] >> k;
  return bits;
}

}  // namespace

extern "C" {

// Encode all FLAC frames for mono 16-bit PCM. `scratch` must hold at
// least 6 * block_size int32 (5 residual rows + zigzag row). Returns
// bytes written into `out`, or 0 if `cap` was too small.
size_t flac_encode_frames(const int16_t* pcm, size_t n, uint32_t sample_rate,
                          uint32_t block_size, uint8_t* out, size_t cap,
                          int32_t* scratch) {
  BitWriter bw(out, cap);
  uint64_t frame_idx = 0;
  uint32_t* u = (uint32_t*)(scratch + 5 * (size_t)block_size);

  for (size_t start = 0; start < n; start += block_size, ++frame_idx) {
    const size_t bs = (n - start < block_size) ? (n - start) : block_size;
    const int16_t* x = pcm + start;
    const size_t frame_off = bw.len();

    // ---- frame header (byte aligned through crc8) ----
    int need8, need16;
    const int bsc = blocksize_code((uint32_t)bs, &need8, &need16);
    int sr_tail_bits;
    uint32_t sr_tail_val;
    const int src = samplerate_code(sample_rate, &sr_tail_bits, &sr_tail_val);
    bw.put(0xFF, 8);
    bw.put(0xF8, 8);  // sync tail, reserved 0, fixed blocksize strategy
    bw.put((uint64_t)bsc << 4 | (uint64_t)src, 8);
    bw.put(0x08, 8);  // mono, 16-bit (code 4), reserved 0
    uint8_t nb[8];
    const int nbl = utf8_code(frame_idx, nb);
    for (int i = 0; i < nbl; ++i) bw.put(nb[i], 8);
    if (need8) bw.put(bs - 1, 8);
    if (need16) bw.put(bs - 1, 16);
    if (sr_tail_bits) bw.put(sr_tail_val, sr_tail_bits);
    if (bw.overflow()) return 0;
    bw.put(crc8(bw.data() + frame_off, bw.len() - frame_off), 8);

    // ---- choose subframe ----
    bool constant = true;
    for (size_t i = 1; i < bs && constant; ++i) constant = (x[i] == x[0]);

    if (constant) {
      bw.put(0x00, 8);  // CONSTANT
      bw.put((uint16_t)x[0], 16);
    } else {
      // Fixed-predictor residuals, orders 0..4 (order < bs).
      const int max_order = bs > 4 ? 4 : (int)bs - 1;
      int32_t* res[5];
      uint64_t abs_sum[5];
      for (int o = 0; o <= max_order; ++o) {
        res[o] = scratch + (size_t)o * block_size;
        abs_sum[o] = 0;
      }
      for (size_t i = 0; i < bs; ++i) res[0][i] = x[i];
      for (int o = 1; o <= max_order; ++o)
        for (size_t i = o; i < bs; ++i)
          res[o][i] = res[o - 1][i] - res[o - 1][i - 1];
      for (int o = 0; o <= max_order; ++o)
        for (size_t i = o; i < bs; ++i) {
          int32_t e = res[o][i];
          abs_sum[o] += (uint64_t)(e < 0 ? -(int64_t)e : e);
        }
      int best_o = 0;
      for (int o = 1; o <= max_order; ++o)
        if (abs_sum[o] < abs_sum[best_o]) best_o = o;

      const size_t nres = bs - best_o;
      for (size_t i = 0; i < nres; ++i) u[i] = zigzag(res[best_o][best_o + i]);
      int best_k = 0;
      uint64_t best_bits = rice_cost(u, nres, 0);
      for (int k = 1; k <= 14; ++k) {
        const uint64_t b = rice_cost(u, nres, k);
        if (b < best_bits) { best_bits = b; best_k = k; }
      }
      // subframe = header(8) + warmup(16*order) + residual header(2+4+4) + rice
      const uint64_t fixed_bits = 8 + 16ull * best_o + 10 + best_bits;
      const uint64_t verbatim_bits = 8 + 16ull * bs;

      if (fixed_bits >= verbatim_bits) {
        bw.put(0x02, 8);  // VERBATIM
        for (size_t i = 0; i < bs; ++i) bw.put((uint16_t)x[i], 16);
      } else {
        bw.put((uint64_t)(8 + best_o) << 1, 8);  // FIXED, order best_o
        for (int i = 0; i < best_o; ++i) bw.put((uint16_t)x[i], 16);
        bw.put(0, 2);  // Rice method 0 (4-bit parameters)
        bw.put(0, 4);  // partition order 0
        bw.put(best_k, 4);
        for (size_t i = 0; i < nres; ++i) {
          bw.put_unary(u[i] >> best_k);
          if (best_k) bw.put(u[i], best_k);
        }
      }
    }

    bw.align();
    if (bw.overflow()) return 0;
    bw.put(crc16(bw.data() + frame_off, bw.len() - frame_off), 16);
    if (bw.overflow()) return 0;
  }
  return bw.len();
}

}  // extern "C"
