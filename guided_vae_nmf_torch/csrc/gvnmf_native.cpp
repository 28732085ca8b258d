// gvnmf_native: host-side data loading and feature extraction.
//
// The reference's data path leans on native third-party libraries
// (libsndfile for wav IO, librosa/numpy FFT for STFT; SURVEY §2.9). This
// library replaces the host side of the input pipeline: wav/NIST-SPHERE
// decoding, the batch rows of the offline sweep (decode, end-pad, reflect
// pad, PCM16) and the exact STFT transform (16 kHz, 64 ms hann, 25% hop,
// centered reflect padding, end-pad rule; reference
// python/processing/stft.py:16-63), computed in double precision to match
// the numpy implementation (guided_vae_nmf_torch/dsp/stft.py) within
// float32 rounding.
//
// Exposed as a plain C ABI consumed through ctypes
// (guided_vae_nmf_torch/data/native_loader.py); calls release the GIL, so a
// Python thread pool gets real parallel decode and STFT.
//
// Build: the loader runs `g++ -O3 -fPIC -shared -std=c++17` at first use,
// into the port's build directory.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <complex>
#include <string>

namespace {

constexpr double kPi = 3.14159265358979323846;

// Index into a length-m signal of position idx of its centred reflect
// padding by `half` samples: numpy's "reflect", the mirror extension with
// period 2 (m - 1), which reflects more than once when m <= half.
long reflect_index(long idx, long half, long m) {
  const long period = 2 * (m - 1);
  if (period <= 0) return 0;
  long i = std::labs(idx - half) % period;
  return (i >= m) ? period - i : i;
}

// ---------------------------------------------------------------------------
// Wav / NIST-SPHERE decoding (16-bit PCM -> float64 in [-1, 1))
// ---------------------------------------------------------------------------

struct Audio {
  std::vector<double> samples;  // first channel only
  int fs = 0;
};

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->resize(static_cast<size_t>(n));
  size_t got = std::fread(out->data(), 1, static_cast<size_t>(n), f);
  std::fclose(f);
  return got == static_cast<size_t>(n);
}

uint32_t rd_u32le(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (p[1] << 8) | (p[2] << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}
uint16_t rd_u16le(const uint8_t* p) {
  return static_cast<uint16_t>(p[0] | (p[1] << 8));
}

bool decode_riff(const std::vector<uint8_t>& buf, Audio* out) {
  if (buf.size() < 44 || std::memcmp(buf.data(), "RIFF", 4) != 0 ||
      std::memcmp(buf.data() + 8, "WAVE", 4) != 0)
    return false;
  size_t pos = 12;
  int channels = 1, bits = 16, fs = 0;
  int audio_format = 1;
  const uint8_t* data = nullptr;
  size_t data_len = 0;
  while (pos + 8 <= buf.size()) {
    const uint8_t* chunk = buf.data() + pos;
    uint32_t sz = rd_u32le(chunk + 4);
    // A declared chunk size can exceed what the file actually holds
    // (truncated or hostile input) — clamp every read to the buffer.
    size_t body = std::min<size_t>(sz, buf.size() - pos - 8);
    if (std::memcmp(chunk, "fmt ", 4) == 0 && body >= 16) {
      audio_format = rd_u16le(chunk + 8);
      channels = rd_u16le(chunk + 10);
      fs = static_cast<int>(rd_u32le(chunk + 12));
      bits = rd_u16le(chunk + 22);
    } else if (std::memcmp(chunk, "data", 4) == 0) {
      data = chunk + 8;
      data_len = body;
    }
    pos += 8 + sz + (sz & 1);
  }
  if (!data || fs == 0) return false;
  if (bits < 8 || channels < 1 || channels > 1024) return false;
  out->fs = fs;
  size_t bytes_per = static_cast<size_t>(bits / 8) * channels;
  size_t n = data_len / bytes_per;
  out->samples.resize(n);
  if (audio_format == 1 && bits == 16) {
    for (size_t i = 0; i < n; ++i) {
      int16_t v = static_cast<int16_t>(rd_u16le(data + i * bytes_per));
      out->samples[i] = v / 32768.0;
    }
  } else if (audio_format == 1 && bits == 32) {
    for (size_t i = 0; i < n; ++i) {
      int32_t v = static_cast<int32_t>(rd_u32le(data + i * bytes_per));
      out->samples[i] = v / 2147483648.0;
    }
  } else if (audio_format == 3 && bits == 32) {  // IEEE float
    for (size_t i = 0; i < n; ++i) {
      float v;
      std::memcpy(&v, data + i * bytes_per, 4);
      out->samples[i] = v;
    }
  } else {
    return false;
  }
  return true;
}

bool decode_sphere(const std::vector<uint8_t>& buf, Audio* out) {
  if (buf.size() < 16 || std::memcmp(buf.data(), "NIST_1A", 7) != 0)
    return false;
  // header: "NIST_1A\n   1024\n" + key/value lines
  char size_buf[9] = {0};
  std::memcpy(size_buf, buf.data() + 8, 8);
  long header = std::strtol(size_buf, nullptr, 10);
  if (header <= 16 || static_cast<size_t>(header) > buf.size()) return false;
  std::string head(reinterpret_cast<const char*>(buf.data()),
                   static_cast<size_t>(header));
  auto get_int = [&](const char* key, long def) -> long {
    size_t p = head.find(key);
    if (p == std::string::npos) return def;
    p = head.find("-i", p);
    if (p == std::string::npos) return def;
    return std::strtol(head.c_str() + p + 2, nullptr, 10);
  };
  auto get_str = [&](const char* key) -> std::string {
    size_t p = head.find(key);
    if (p == std::string::npos) return "";
    size_t sp = head.find(' ', p + std::strlen(key) + 1);
    size_t nl = head.find('\n', p);
    if (sp == std::string::npos || nl == std::string::npos || sp > nl)
      return "";
    return head.substr(sp + 1, nl - sp - 1);
  };
  long n = get_int("sample_count", 0);
  long fs = get_int("sample_rate", 16000);
  long nbytes = get_int("sample_n_bytes", 2);
  long channels = get_int("channel_count", 1);
  std::string byte_format = get_str("sample_byte_format");
  if (nbytes != 2 || n <= 0 || channels < 1 || channels > 1024) return false;
  bool little = byte_format != "10";
  const uint8_t* data = buf.data() + header;
  size_t avail = (buf.size() - static_cast<size_t>(header)) / 2;
  // clamp the declared count before the multiply so a hostile
  // sample_count cannot overflow n * channels
  size_t want = std::min(static_cast<size_t>(n), avail);
  size_t total = std::min(want * static_cast<size_t>(channels), avail);
  out->fs = static_cast<int>(fs);
  out->samples.resize(total / channels);
  for (size_t i = 0; i < out->samples.size(); ++i) {
    const uint8_t* p = data + i * channels * 2;  // channel 0
    int16_t v = little
        ? static_cast<int16_t>(p[0] | (p[1] << 8))
        : static_cast<int16_t>(p[1] | (p[0] << 8));
    out->samples[i] = v / 32768.0;
  }
  return true;
}

bool decode(const char* path, Audio* out) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) return false;
  if (buf.size() >= 7 && std::memcmp(buf.data(), "NIST_1A", 7) == 0)
    return decode_sphere(buf, out);
  return decode_riff(buf, out);
}

// ---------------------------------------------------------------------------
// FFT (iterative radix-2, double precision) + STFT
// ---------------------------------------------------------------------------

void fft_inplace(std::complex<double>* a, int n) {
  // bit-reversal permutation
  for (int i = 1, j = 0; i < n; ++i) {
    int bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) std::swap(a[i], a[j]);
  }
  for (int len = 2; len <= n; len <<= 1) {
    double ang = -2.0 * kPi / len;
    std::complex<double> wl(std::cos(ang), std::sin(ang));
    for (int i = 0; i < n; i += len) {
      std::complex<double> w(1.0, 0.0);
      for (int k = 0; k < len / 2; ++k) {
        std::complex<double> u = a[i + k];
        std::complex<double> v = a[i + k + len / 2] * w;
        a[i + k] = u + v;
        a[i + k + len / 2] = u - v;
        w *= wl;
      }
    }
  }
}

struct StftPlan {
  int nfft;
  int hop;
  std::vector<double> window;  // periodic hann
};

StftPlan make_plan(int fs, double wlen_sec, double hop_percent) {
  StftPlan p;
  p.nfft = static_cast<int>(wlen_sec * fs);
  p.hop = static_cast<int>(hop_percent * p.nfft);
  p.window.resize(p.nfft);
  for (int i = 0; i < p.nfft; ++i)
    p.window[i] = 0.5 - 0.5 * std::cos(2.0 * kPi * i / p.nfft);
  return p;
}

// Frame count replicating the reference's float-seconds end-pad rule
// (stft.py:48-53) followed by centered framing.
long frame_count(long n, int fs, double wlen_sec, double hop_percent,
                 const StftPlan& p) {
  double utt_len = static_cast<double>(n) / fs;
  double q = utt_len / wlen_sec / hop_percent;
  long n_eff = n;
  if (std::ceil(q) != std::floor(q)) n_eff += p.hop;
  return 1 + n_eff / p.hop;
}

// Power spectrogram |STFT|^2 as float32, column-major frames:
// out[(frame * bins) + bin], bins = nfft/2 + 1 (frames-major rows so the
// Python side reshapes to (frames, bins) without a copy).
void stft_power(const double* x, long n, int fs, double wlen_sec,
                double hop_percent, float* out) {
  StftPlan p = make_plan(fs, wlen_sec, hop_percent);
  int bins = p.nfft / 2 + 1;
  int half = p.nfft / 2;

  double q = (static_cast<double>(n) / fs) / wlen_sec / hop_percent;
  long n_eff = (std::ceil(q) != std::floor(q)) ? n + p.hop : n;
  long frames = 1 + n_eff / p.hop;

  // padded signal accessor: reflect at both ends of the END-PADDED signal
  // (numpy pads AFTER the zero end-pad, matching dsp.stft ordering)
  auto sample = [&](long idx) -> double {
    const long i = reflect_index(idx, half, n_eff);
    return (i < n) ? x[i] : 0.0;            // zero end-pad region
  };

  std::vector<std::complex<double>> buf(p.nfft);
  for (long f = 0; f < frames; ++f) {
    long start = f * p.hop;
    for (int i = 0; i < p.nfft; ++i)
      buf[i] = std::complex<double>(sample(start + i) * p.window[i], 0.0);
    fft_inplace(buf.data(), p.nfft);
    float* col = out + f * bins;
    for (int b = 0; b < bins; ++b) {
      // match numpy: complex128 -> complex64 cast, then |.|^2 in float32
      float re = static_cast<float>(buf[b].real());
      float im = static_cast<float>(buf[b].imag());
      col[b] = re * re + im * im;
    }
  }
}

}  // namespace

extern "C" {

// Decode a wav/SPHERE file. Returns sample count (first channel), fills
// *fs; caller passes a buffer of at least `capacity` doubles (query with
// capacity=0 first). Returns -1 on error.
long gvnmf_decode(const char* path, double* out, long capacity, int* fs) {
  Audio a;
  if (!decode(path, &a)) return -1;
  *fs = a.fs;
  long n = static_cast<long>(a.samples.size());
  if (out && capacity >= n)
    std::memcpy(out, a.samples.data(), n * sizeof(double));
  return n;
}

long gvnmf_frame_count(long n, int fs, double wlen_sec, double hop_percent) {
  StftPlan p = make_plan(fs, wlen_sec, hop_percent);
  return frame_count(n, fs, wlen_sec, hop_percent, p);
}

// Assemble one utterance into a pre-zeroed int16 row of the sweep's
// device-transport batch: decode, apply the end-pad rule (same
// float-seconds divisibility test as dsp.stft._maybe_end_pad), center
// reflect-pad by nfft/2, quantize to PCM16, and truncate to the row
// capacity L (samples past (n_frames-1)*hop + nfft belong to no frame).
// Fills *n_frames (valid STFT frames) and *t_orig (decoded sample count).
// Thread-safe per row: a Python thread pool assembles a whole batch in
// parallel with the GIL released. Returns 0, or <0 on decode/rate errors.
int gvnmf_assemble_utt(const char* path, int16_t* row, long L,
                       int fs_expected, int nfft, int hop,
                       long* n_frames, long* t_orig) {
  Audio a;
  if (!decode(path, &a)) return -1;
  if (a.fs != fs_expected) return -2;
  const long T = static_cast<long>(a.samples.size());
  if (T == 0) return -1;  // reflect indexing below needs >= 1 sample
  *t_orig = T;

  // end-pad rule, bit-identical double arithmetic to the Python host path
  const double wlen_sec = static_cast<double>(nfft) / fs_expected;
  const double hop_percent = static_cast<double>(hop) / nfft;
  const double utt_len = static_cast<double>(T) / fs_expected;
  const double q = utt_len / wlen_sec / hop_percent;
  const long T2 = (std::ceil(q) != std::floor(q)) ? T + hop : T;
  *n_frames = 1 + T2 / hop;

  const long half = nfft / 2;
  auto x2_at = [&](long i) -> double {  // end-padded signal x2[0..T2)
    return (i < T) ? a.samples[i] : 0.0;
  };
  auto pcm16 = [](double v) -> int16_t {
    double s = std::nearbyint(v * 32768.0);
    if (s > 32767.0) s = 32767.0;
    if (s < -32768.0) s = -32768.0;
    return static_cast<int16_t>(s);
  };
  const long P = T2 + 2 * half;  // reflect-padded length
  const long n_out = std::min(P, L);
  for (long i = 0; i < n_out; ++i)
    row[i] = pcm16(x2_at(reflect_index(i, half, T2)));
  return 0;
}

int gvnmf_bins(int fs, double wlen_sec) {
  return static_cast<int>(wlen_sec * fs) / 2 + 1;
}

// STFT power spectrogram of a float64 signal into a float32 buffer of
// shape (frames, bins) — frames from gvnmf_frame_count, bins from
// gvnmf_bins. Returns 0 on success.
int gvnmf_stft_power(const double* x, long n, int fs, double wlen_sec,
                     double hop_percent, float* out) {
  stft_power(x, n, fs, wlen_sec, hop_percent, out);
  return 0;
}

// Complex STFT of a float64 signal: out_ri is interleaved (frames, bins, 2)
// float32 [re, im] — numpy-compatible complex64 after a view cast. Returns 0.
int gvnmf_stft_complex(const double* x, long n, int fs, double wlen_sec,
                       double hop_percent, float* out_ri) {
  StftPlan p = make_plan(fs, wlen_sec, hop_percent);
  int bins = p.nfft / 2 + 1;
  int half = p.nfft / 2;
  double q = (static_cast<double>(n) / fs) / wlen_sec / hop_percent;
  long n_eff = (std::ceil(q) != std::floor(q)) ? n + p.hop : n;
  long frames = 1 + n_eff / p.hop;
  auto sample = [&](long idx) -> double {
    const long i = reflect_index(idx, half, n_eff);
    return (i < n) ? x[i] : 0.0;
  };
  std::vector<std::complex<double>> buf(p.nfft);
  for (long f = 0; f < frames; ++f) {
    long start = f * p.hop;
    for (int i = 0; i < p.nfft; ++i)
      buf[i] = std::complex<double>(sample(start + i) * p.window[i], 0.0);
    fft_inplace(buf.data(), p.nfft);
    float* col = out_ri + f * bins * 2;
    for (int b = 0; b < bins; ++b) {
      col[2 * b] = static_cast<float>(buf[b].real());
      col[2 * b + 1] = static_cast<float>(buf[b].imag());
    }
  }
  return 0;
}

// Fused loader: decode + cut leading seconds + peak-normalize + STFT power.
// Returns frame count, fills out (frames, bins) up to out_capacity floats;
// -1 on decode error, -2 on unexpected sample rate.
long gvnmf_load_power(const char* path, double cut_sec, int fs_expected,
                      double wlen_sec, double hop_percent, float* out,
                      long out_capacity) {
  Audio a;
  if (!decode(path, &a)) return -1;
  if (a.fs != fs_expected) return -2;
  long cut = static_cast<long>(cut_sec * a.fs);
  if (cut >= static_cast<long>(a.samples.size())) return -1;
  double* x = a.samples.data() + cut;
  long n = static_cast<long>(a.samples.size()) - cut;
  double peak = 0.0;
  for (long i = 0; i < n; ++i) peak = std::max(peak, std::fabs(x[i]));
  if (peak > 0)
    for (long i = 0; i < n; ++i) x[i] /= peak;
  StftPlan p = make_plan(a.fs, wlen_sec, hop_percent);
  long frames = frame_count(n, a.fs, wlen_sec, hop_percent, p);
  int bins = p.nfft / 2 + 1;
  if (frames * bins > out_capacity) return -3;
  stft_power(x, n, a.fs, wlen_sec, hop_percent, out);
  return frames;
}

}  // extern "C"
