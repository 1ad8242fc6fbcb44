// Native host-side DSP for the data pipeline: WAV decode + STFT + log-mel.
//
// Copy of efficient_tts_tpu/native/mel_native.cc. Decoding training wavs
// and computing their log-mel features is the data pipeline's hot host
// path; this small C++ library does it, driven from Python through ctypes
// (efficient_tts_tpu_torch/native/__init__.py). The mel filterbank and Hann
// window are supplied by the caller (dsp/filters.py) so the numerics match
// dsp/mel.py:mel_spectrogram_np up to FFT rounding.
//
// Built with g++ at first use into efficient_tts_tpu_torch/_build/.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// iterative radix-2 complex FFT (sizes are powers of two: n_fft = 1024)

struct FFTPlan {
  int n = 0;
  std::vector<int> rev;
  std::vector<float> tw_re, tw_im;  // twiddles per stage, flattened
};

void plan_init(FFTPlan& p, int n) {
  p.n = n;
  p.rev.assign(n, 0);
  int logn = 0;
  while ((1 << logn) < n) ++logn;
  for (int i = 0; i < n; ++i) {
    int r = 0;
    for (int b = 0; b < logn; ++b)
      if (i & (1 << b)) r |= 1 << (logn - 1 - b);
    p.rev[i] = r;
  }
  p.tw_re.clear();
  p.tw_im.clear();
  for (int len = 2; len <= n; len <<= 1) {
    for (int j = 0; j < len / 2; ++j) {
      double ang = -2.0 * M_PI * j / len;
      p.tw_re.push_back(static_cast<float>(std::cos(ang)));
      p.tw_im.push_back(static_cast<float>(std::sin(ang)));
    }
  }
}

void fft_inplace(const FFTPlan& p, float* re, float* im) {
  const int n = p.n;
  for (int i = 0; i < n; ++i) {
    int j = p.rev[i];
    if (i < j) {
      std::swap(re[i], re[j]);
      std::swap(im[i], im[j]);
    }
  }
  size_t tw_off = 0;
  for (int len = 2; len <= n; len <<= 1) {
    const int half = len / 2;
    for (int i = 0; i < n; i += len) {
      for (int j = 0; j < half; ++j) {
        const float wr = p.tw_re[tw_off + j];
        const float wi = p.tw_im[tw_off + j];
        const int a = i + j, b = i + j + half;
        const float xr = re[b] * wr - im[b] * wi;
        const float xi = re[b] * wi + im[b] * wr;
        re[b] = re[a] - xr;
        im[b] = im[a] - xi;
        re[a] += xr;
        im[a] += xi;
      }
    }
    tw_off += half;
  }
}

}  // namespace

extern "C" {

// Parse a RIFF/WAVE buffer (PCM16 or IEEE float32, mono or first channel).
// Returns number of samples written to `out` (caller allocates `max_out`),
// or -1 on parse error. Sample rate goes to *sample_rate; values scaled by
// 1/32768 for PCM16 (matching taco2_data.py:72).
int64_t efts_decode_wav(const uint8_t* buf, int64_t len, float* out,
                        int64_t max_out, int32_t* sample_rate) {
  if (len < 44 || std::memcmp(buf, "RIFF", 4) != 0 ||
      std::memcmp(buf + 8, "WAVE", 4) != 0)
    return -1;
  int64_t pos = 12;
  int16_t fmt = 0, channels = 1, bits = 16;
  int32_t sr = 0;
  const uint8_t* data = nullptr;
  int64_t data_len = 0;
  while (pos + 8 <= len) {
    const char* id = reinterpret_cast<const char*>(buf + pos);
    uint32_t sz;
    std::memcpy(&sz, buf + pos + 4, 4);
    if (std::memcmp(id, "fmt ", 4) == 0 && pos + 8 + 16 <= len) {
      std::memcpy(&fmt, buf + pos + 8, 2);
      std::memcpy(&channels, buf + pos + 10, 2);
      std::memcpy(&sr, buf + pos + 12, 4);
      std::memcpy(&bits, buf + pos + 22, 2);
    } else if (std::memcmp(id, "data", 4) == 0) {
      data = buf + pos + 8;
      data_len = sz;
      if (pos + 8 + data_len > len) data_len = len - pos - 8;
    }
    pos += 8 + sz + (sz & 1);
  }
  if (!data || channels < 1) return -1;
  *sample_rate = sr;
  int64_t n = 0;
  if (fmt == 1 && bits == 16) {
    const int16_t* s = reinterpret_cast<const int16_t*>(data);
    n = data_len / 2 / channels;
    if (n > max_out) n = max_out;
    for (int64_t i = 0; i < n; ++i)
      out[i] = static_cast<float>(s[i * channels]) / 32768.0f;
  } else if (fmt == 3 && bits == 32) {
    const float* s = reinterpret_cast<const float*>(data);
    n = data_len / 4 / channels;
    if (n > max_out) n = max_out;
    for (int64_t i = 0; i < n; ++i) out[i] = s[i * channels];
  } else {
    return -1;
  }
  return n;
}

// Log-mel spectrogram matching dsp/mel.py mel_spectrogram_np:
//  reflect-pad (n_fft-hop)/2, framed windowed rFFT (center=False),
//  magnitude sqrt(re^2+im^2+mag_eps), mel matmul, log(max(x, clip_val)).
// wav: [n]; window: [n_fft] (win padded to n_fft by caller);
// mel_basis: [n_mels, n_fft/2+1]; out: [n_mels, frames].
// Returns frame count, or -1 if n_fft is not a power of two.
int64_t efts_mel_spectrogram(const float* wav, int64_t n, const float* window,
                             const float* mel_basis, int32_t n_fft,
                             int32_t hop, int32_t n_mels, float mag_eps,
                             float clip_val, float* out) {
  if (n_fft & (n_fft - 1)) return -1;
  const int pad = (n_fft - hop) / 2;
  const int64_t padded = n + 2 * pad;
  if (padded < n_fft) return 0;
  const int64_t frames = 1 + (padded - n_fft) / hop;
  const int n_bins = n_fft / 2 + 1;

  static thread_local FFTPlan plan;
  if (plan.n != n_fft) plan_init(plan, n_fft);

  std::vector<float> re(n_fft), im(n_fft), mag(n_bins);
  auto sample = [&](int64_t idx) -> float {
    // reflect padding (numpy 'reflect' mode, no edge duplication)
    int64_t i = idx - pad;
    if (i < 0) i = -i;
    if (i >= n) i = 2 * (n - 1) - i;
    return wav[i];
  };
  for (int64_t f = 0; f < frames; ++f) {
    const int64_t start = f * hop;
    for (int i = 0; i < n_fft; ++i) {
      re[i] = sample(start + i) * window[i];
      im[i] = 0.0f;
    }
    fft_inplace(plan, re.data(), im.data());
    for (int b = 0; b < n_bins; ++b)
      mag[b] = std::sqrt(re[b] * re[b] + im[b] * im[b] + mag_eps);
    for (int m = 0; m < n_mels; ++m) {
      const float* row = mel_basis + static_cast<int64_t>(m) * n_bins;
      float acc = 0.0f;
      for (int b = 0; b < n_bins; ++b) acc += row[b] * mag[b];
      acc = acc < clip_val ? clip_val : acc;
      out[static_cast<int64_t>(m) * frames + f] = std::log(acc);
    }
  }
  return frames;
}

}  // extern "C"
