// Native batch audio loader for animal2vec-tpu.
//
// Replaces the role libsndfile + torch DataLoader workers play in the
// reference's input path (soundfile decode at nn/audio_tasks.py:317-333,
// num_workers 32 in configs): decode a batch of RIFF/WAVE files, mono-ize,
// zero-mean/unit-variance normalize, and pad-or-crop into a caller-provided
// (N, target_len) float32 buffer, using an internal thread pool. Exposed as
// a plain C ABI consumed through ctypes (runtime/native.py).
//
// Build: make -C animal2vec_tpu/runtime  (g++ -O3 -shared -fPIC)

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <string>
#include <thread>
#include <vector>

namespace {

struct WavData {
  std::vector<float> samples;  // mono
  int sample_rate = 0;
  bool ok = false;
};

uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const uint8_t* p) {
  return (uint16_t)p[0] | ((uint16_t)p[1] << 8);
}

WavData decode_wav(const char* path, int channel) {
  WavData out;
  FILE* f = std::fopen(path, "rb");
  if (!f) return out;
  uint8_t hdr[12];
  if (std::fread(hdr, 1, 12, f) != 12 || std::memcmp(hdr, "RIFF", 4) != 0 ||
      std::memcmp(hdr + 8, "WAVE", 4) != 0) {
    std::fclose(f);
    return out;
  }
  uint16_t fmt_code = 0, channels = 0, bits = 0;
  uint32_t sample_rate = 0;
  bool have_fmt = false;
  for (;;) {
    uint8_t chdr[8];
    if (std::fread(chdr, 1, 8, f) != 8) break;
    uint32_t csize = rd_u32(chdr + 4);
    if (std::memcmp(chdr, "fmt ", 4) == 0) {
      std::vector<uint8_t> raw(csize);
      if (std::fread(raw.data(), 1, csize, f) != csize) break;
      fmt_code = rd_u16(raw.data());
      channels = rd_u16(raw.data() + 2);
      sample_rate = rd_u32(raw.data() + 4);
      bits = rd_u16(raw.data() + 14);
      if (fmt_code == 0xFFFE && csize >= 26) fmt_code = rd_u16(raw.data() + 24);
      have_fmt = true;
    } else if (std::memcmp(chdr, "data", 4) == 0) {
      if (!have_fmt || channels == 0) break;
      std::vector<uint8_t> raw(csize);
      size_t got = std::fread(raw.data(), 1, csize, f);
      size_t bytes_per = bits / 8;
      size_t frames = got / (bytes_per * channels);
      out.samples.resize(frames);
      int ch = channel < channels ? channel : 0;
      const uint8_t* p = raw.data();
      if (fmt_code == 1 && bits == 16) {
        for (size_t i = 0; i < frames; ++i) {
          int16_t v;
          std::memcpy(&v, p + (i * channels + ch) * 2, 2);
          out.samples[i] = (float)v / 32768.0f;
        }
      } else if (fmt_code == 1 && bits == 32) {
        for (size_t i = 0; i < frames; ++i) {
          int32_t v;
          std::memcpy(&v, p + (i * channels + ch) * 4, 4);
          out.samples[i] = (float)v / 2147483648.0f;
        }
      } else if (fmt_code == 1 && bits == 24) {
        for (size_t i = 0; i < frames; ++i) {
          const uint8_t* q = p + (i * channels + ch) * 3;
          int32_t v = (int32_t)q[0] | ((int32_t)q[1] << 8) | ((int32_t)q[2] << 16);
          if (v >= (1 << 23)) v -= (1 << 24);
          out.samples[i] = (float)v / 8388608.0f;
        }
      } else if (fmt_code == 1 && bits == 8) {
        for (size_t i = 0; i < frames; ++i)
          out.samples[i] = ((float)p[(i * channels + ch)] - 128.0f) / 128.0f;
      } else if (fmt_code == 3 && bits == 32) {
        for (size_t i = 0; i < frames; ++i) {
          float v;
          std::memcpy(&v, p + (i * channels + ch) * 4, 4);
          out.samples[i] = v;
        }
      } else {
        break;  // unsupported
      }
      out.sample_rate = (int)sample_rate;
      out.ok = true;
      break;
    } else {
      std::fseek(f, (long)(csize + (csize & 1)), SEEK_CUR);
    }
  }
  std::fclose(f);
  return out;
}

// xorshift for deterministic per-item crop offsets
uint64_t xorshift(uint64_t& s) {
  s ^= s << 13;
  s ^= s >> 7;
  s ^= s << 17;
  return s;
}

void normalize(std::vector<float>& x) {
  if (x.empty()) return;
  double mean = 0;
  for (float v : x) mean += v;
  mean /= (double)x.size();
  double var = 0;
  for (float v : x) var += ((double)v - mean) * ((double)v - mean);
  var /= (double)x.size();
  float inv = 1.0f / std::sqrt((float)var + 1e-5f);
  for (float& v : x) v = ((float)((double)v - mean)) * inv;
}

}  // namespace

extern "C" {

// Decode one file's metadata. Returns 0 on success.
int a2v_wav_info(const char* path, int64_t* frames, int* sample_rate) {
  WavData w = decode_wav(path, 0);
  if (!w.ok) return 1;
  *frames = (int64_t)w.samples.size();
  *sample_rate = w.sample_rate;
  return 0;
}

// Decode a batch of wav files into out[n * target_len] (float32).
//   normalize_flag: zero-mean/unit-var per clip (task.normalize)
//   train_flag: random crop (seeded) vs center crop for long clips
//   valid_lens[i]: number of real (non-padding) samples per row
//   crop_starts[i]: chosen crop offset (for aligned label cropping)
// Returns the number of files that failed to decode (0 = all good).
int a2v_decode_batch(const char** paths, int n, int64_t target_len,
                     int normalize_flag, int train_flag, uint64_t seed,
                     int expected_sr, float* out, int64_t* valid_lens,
                     int64_t* crop_starts, int num_threads) {
  std::atomic<int> failures{0};
  std::atomic<int> next{0};
  if (num_threads <= 0) num_threads = (int)std::thread::hardware_concurrency();
  if (num_threads <= 0) num_threads = 1;
  if (num_threads > n) num_threads = n;

  auto work = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      WavData w = decode_wav(paths[i], 0);
      float* dst = out + (int64_t)i * target_len;
      if (!w.ok || (expected_sr > 0 && w.sample_rate != expected_sr)) {
        std::memset(dst, 0, sizeof(float) * target_len);
        valid_lens[i] = 0;
        crop_starts[i] = 0;
        failures.fetch_add(1);
        continue;
      }
      if (normalize_flag) normalize(w.samples);
      int64_t nsamp = (int64_t)w.samples.size();
      int64_t start = 0;
      if (nsamp > target_len) {
        if (train_flag) {
          uint64_t s = seed * 0x9E3779B97F4A7C15ull + (uint64_t)(i + 1);
          xorshift(s);
          start = (int64_t)(xorshift(s) % (uint64_t)(nsamp - target_len + 1));
        } else {
          start = (nsamp - target_len) / 2;
        }
        std::memcpy(dst, w.samples.data() + start, sizeof(float) * target_len);
        valid_lens[i] = target_len;
      } else {
        std::memcpy(dst, w.samples.data(), sizeof(float) * nsamp);
        std::memset(dst + nsamp, 0, sizeof(float) * (target_len - nsamp));
        valid_lens[i] = nsamp;
      }
      crop_starts[i] = start;
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < num_threads; ++t) threads.emplace_back(work);
  for (auto& t : threads) t.join();
  return failures.load();
}

}  // extern "C"
