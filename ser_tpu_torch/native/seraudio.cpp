// Native audio decode for the data-loading hot path, and the word-timing DTW.
//
// The PyTorch port's own copy of the JAX package's native library (the same
// source, so both packages decode to the same bits). The container parse,
// sample conversion, channel mixdown, NaN scrub, and peak normalization run
// in one C++ pass over the file bytes, exposed through a minimal C ABI
// consumed via ctypes (ser_tpu_torch/_internal/utils/native_audio.py), built
// by g++ at first use. Semantics mirror audio_io._decode_wav_bytes +
// _prepare_audio_buffer, except that the peak normalization multiplies by a
// float32 reciprocal where the Python path divides (1 ulp apart at most).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>

namespace {

constexpr uint16_t kFormatPcm = 0x0001;
constexpr uint16_t kFormatFloat = 0x0003;
constexpr uint16_t kFormatExtensible = 0xFFFE;

struct Reader {
  const uint8_t* data;
  size_t size;
  bool u16(size_t off, uint16_t* out) const {
    if (off + 2 > size) return false;
    *out = static_cast<uint16_t>(data[off] | (data[off + 1] << 8));
    return true;
  }
  bool u32(size_t off, uint32_t* out) const {
    if (off + 4 > size) return false;
    *out = static_cast<uint32_t>(data[off]) | (static_cast<uint32_t>(data[off + 1]) << 8) |
           (static_cast<uint32_t>(data[off + 2]) << 16) |
           (static_cast<uint32_t>(data[off + 3]) << 24);
    return true;
  }
};

inline float clamp_finite(float v) { return std::isfinite(v) ? v : 0.0f; }

}  // namespace

extern "C" {

// Decodes a WAV byte buffer to mono, peak-normalized float32 samples.
// Returns 0 on success; caller frees *out_samples with ser_free.
// Error codes: 1 bad container, 2 missing chunks, 3 unsupported format,
// 4 invalid header values, 5 allocation failure, 6 empty audio.
int ser_decode_wav_mono(const uint8_t* bytes, size_t length, float** out_samples,
                        int64_t* out_frames, int32_t* out_rate) {
  Reader r{bytes, length};
  if (length < 12 || std::memcmp(bytes, "RIFF", 4) != 0 ||
      std::memcmp(bytes + 8, "WAVE", 4) != 0) {
    return 1;
  }
  size_t pos = 12;
  uint16_t format_tag = 0, channels = 0, bits = 0;
  uint32_t sample_rate = 0;
  const uint8_t* payload = nullptr;
  size_t payload_len = 0;
  bool have_fmt = false;

  while (pos + 8 <= length) {
    uint32_t chunk_size = 0;
    if (!r.u32(pos + 4, &chunk_size)) break;
    const uint8_t* id = bytes + pos;
    size_t body = pos + 8;
    size_t body_len = chunk_size;
    if (body + body_len > length) body_len = length - body;
    if (std::memcmp(id, "fmt ", 4) == 0 && body_len >= 16) {
      r.u16(body + 0, &format_tag);
      r.u16(body + 2, &channels);
      r.u32(body + 4, &sample_rate);
      r.u16(body + 14, &bits);
      if (format_tag == kFormatExtensible && body_len >= 26) {
        r.u16(body + 24, &format_tag);  // first 2 bytes of SubFormat GUID
      }
      have_fmt = true;
    } else if (std::memcmp(id, "data", 4) == 0) {
      payload = bytes + body;
      payload_len = body_len;
    }
    pos = body + chunk_size + (chunk_size & 1);
  }
  if (!have_fmt || payload == nullptr) return 2;
  if (channels == 0 || sample_rate == 0) return 4;

  size_t bytes_per_sample;
  if (format_tag == kFormatPcm) {
    if (bits != 8 && bits != 16 && bits != 24 && bits != 32) return 3;
    bytes_per_sample = bits / 8;
  } else if (format_tag == kFormatFloat) {
    if (bits != 32 && bits != 64) return 3;
    bytes_per_sample = bits / 8;
  } else {
    return 3;
  }

  const size_t frame_bytes = bytes_per_sample * channels;
  const size_t frames = payload_len / frame_bytes;
  if (frames == 0) return 6;

  float* mono = static_cast<float*>(std::malloc(frames * sizeof(float)));
  if (mono == nullptr) return 5;

  const float inv_channels = 1.0f / static_cast<float>(channels);
  float peak = 0.0f;
  for (size_t f = 0; f < frames; ++f) {
    const uint8_t* frame = payload + f * frame_bytes;
    float acc = 0.0f;
    for (uint16_t c = 0; c < channels; ++c) {
      const uint8_t* s = frame + c * bytes_per_sample;
      float v = 0.0f;
      if (format_tag == kFormatPcm) {
        switch (bits) {
          case 8:
            v = (static_cast<int32_t>(s[0]) - 128) / 128.0f;
            break;
          case 16: {
            int16_t raw = static_cast<int16_t>(s[0] | (s[1] << 8));
            v = raw / 32768.0f;
            break;
          }
          case 24: {
            int32_t raw = s[0] | (s[1] << 8) | (s[2] << 16);
            if (raw >= (1 << 23)) raw -= (1 << 24);
            v = raw / 8388608.0f;
            break;
          }
          case 32: {
            int32_t raw;
            std::memcpy(&raw, s, 4);
            v = static_cast<float>(raw) / 2147483648.0f;
            break;
          }
        }
      } else {  // IEEE float
        if (bits == 32) {
          float raw;
          std::memcpy(&raw, s, 4);
          v = clamp_finite(raw);
        } else {
          double raw;
          std::memcpy(&raw, s, 8);
          v = clamp_finite(static_cast<float>(raw));
        }
      }
      acc += v;
    }
    const float mixed = acc * inv_channels;
    mono[f] = mixed;
    const float mag = std::fabs(mixed);
    if (mag > peak) peak = mag;
  }

  if (peak > 0.0f) {
    const float inv_peak = 1.0f / peak;
    for (size_t f = 0; f < frames; ++f) mono[f] *= inv_peak;
  } else {
    std::memset(mono, 0, frames * sizeof(float));
  }

  *out_samples = mono;
  *out_frames = static_cast<int64_t>(frames);
  *out_rate = static_cast<int32_t>(sample_rate);
  return 0;
}

void ser_free(float* ptr) { std::free(ptr); }

}  // extern "C"

// ---------------------------------------------------------------------------
// DTW path search for word-timing alignment (host hot loop).
//
// The Python wavefront implementation (ser_tpu_torch/models/word_timing.py)
// vectorizes over anti-diagonals in numpy; this native version walks the
// classic row-major dynamic program in one cache-friendly pass. Semantics are
// identical: moves {diagonal, down, right}, boundary column/row at +inf,
// traceback from (N-1, M-1) to (0, 0). Exposed via ctypes
// (ser_tpu_torch/_internal/utils/native_audio.py) with the numpy path as fallback.
// ---------------------------------------------------------------------------

extern "C" {

// cost: row-major (n_rows, n_cols) float64. out_rows/out_cols must hold
// n_rows + n_cols entries; *out_len receives the path length (start→end
// order). Returns 0 on success, 1 on invalid input, 5 on allocation failure.
int ser_dtw_path(const double* cost, int64_t n_rows, int64_t n_cols,
                 int32_t* out_rows, int32_t* out_cols, int64_t* out_len) {
  if (cost == nullptr || n_rows <= 0 || n_cols <= 0) return 1;
  const int64_t width = n_cols + 1;
  double* total = static_cast<double*>(std::malloc(sizeof(double) * 2 * width));
  // Traceback moves: 0 = diagonal, 1 = down (prev row), 2 = right (prev col).
  int8_t* trace = static_cast<int8_t*>(std::malloc(sizeof(int8_t) * n_rows * n_cols));
  if (total == nullptr || trace == nullptr) {
    std::free(total);
    std::free(trace);
    return 5;
  }
  const double inf = std::numeric_limits<double>::infinity();
  double* prev = total;
  double* curr = total + width;
  prev[0] = 0.0;
  for (int64_t j = 1; j < width; ++j) prev[j] = inf;
  for (int64_t i = 1; i <= n_rows; ++i) {
    curr[0] = inf;
    const double* cost_row = cost + (i - 1) * n_cols;
    int8_t* trace_row = trace + (i - 1) * n_cols;
    for (int64_t j = 1; j <= n_cols; ++j) {
      const double diag = prev[j - 1];
      const double down = prev[j];
      const double right = curr[j - 1];
      double best = diag;
      int8_t move = 0;
      if (down < best) { best = down; move = 1; }
      if (right < best) { best = right; move = 2; }
      curr[j] = cost_row[j - 1] + best;
      trace_row[j - 1] = move;
    }
    double* swap = prev; prev = curr; curr = swap;
  }

  int64_t i = n_rows - 1;
  int64_t j = n_cols - 1;
  int64_t length = 0;
  const int64_t capacity = n_rows + n_cols;
  while (length < capacity) {
    out_rows[length] = static_cast<int32_t>(i);
    out_cols[length] = static_cast<int32_t>(j);
    ++length;
    if (i == 0 && j == 0) break;
    const int8_t move = trace[i * n_cols + j];
    if (move == 0) { if (i > 0) --i; if (j > 0) --j; }
    else if (move == 1) { if (i > 0) --i; else if (j > 0) --j; }
    else { if (j > 0) --j; else if (i > 0) --i; }
  }
  // Reverse in place to start→end order.
  for (int64_t k = 0; k < length / 2; ++k) {
    const int32_t tr = out_rows[k]; out_rows[k] = out_rows[length - 1 - k]; out_rows[length - 1 - k] = tr;
    const int32_t tc = out_cols[k]; out_cols[k] = out_cols[length - 1 - k]; out_cols[length - 1 - k] = tc;
  }
  *out_len = length;
  std::free(total);
  std::free(trace);
  return 0;
}

}  // extern "C"
