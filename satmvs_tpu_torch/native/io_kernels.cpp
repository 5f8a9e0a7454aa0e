// Host-side data-plane routines of satmvs_tpu_torch, loaded through ctypes
// (satmvs_tpu_torch/native/__init__.py).  The port's own copy of the JAX
// package's native library: the same five entry points with the same
// arithmetic, so both packages read, write and normalize alike.
//
// Contents:
//   pfm_read_header / pfm_read  — PFM decode (single pass, endian-aware)
//   pfm_write                   — PFM encode (little endian, scale -1.0)
//   center_image                — per-channel mean/std normalization
//                                 (float64 moments, var = E[x^2] - m^2)
//   tone_map_u8                 — gamma + percentile-stretch tone mapping via
//                                 a 65536-bin histogram
//   downsample_nearest          — strided pyramid level extraction
//
// Build: g++ -O3 -shared -fPIC -std=c++17, at first use, into a hash-named
// file under build/native/.  No external dependencies.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// PFM
// ---------------------------------------------------------------------------

// Parse the PFM header.  Returns 0 on success; fills width/height/channels
// (1 or 3), byte order (1 = little endian), and the data byte offset.
int pfm_read_header(const char* path, int* width, int* height, int* channels,
                    int* little_endian, long* data_offset) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char tag[3] = {0};
  if (std::fscanf(f, "%2s", tag) != 1) { std::fclose(f); return -2; }
  if (tag[0] != 'P' || (tag[1] != 'F' && tag[1] != 'f')) { std::fclose(f); return -3; }
  *channels = (tag[1] == 'F') ? 3 : 1;
  double scale;
  if (std::fscanf(f, "%d %d %lf", width, height, &scale) != 3) {
    std::fclose(f);
    return -4;
  }
  std::fgetc(f);  // single whitespace after the scale line
  *little_endian = scale < 0 ? 1 : 0;
  *data_offset = std::ftell(f);
  std::fclose(f);
  return 0;
}

static void byteswap_f32(float* data, size_t n) {
  auto* p = reinterpret_cast<uint32_t*>(data);
  for (size_t i = 0; i < n; ++i) {
    uint32_t v = p[i];
    p[i] = (v >> 24) | ((v >> 8) & 0xFF00u) | ((v << 8) & 0xFF0000u) | (v << 24);
  }
}

// Read PFM pixel data into `out` (row 0 = TOP row, i.e. already vertically
// flipped from the bottom-up file order).  `out` must hold h*w*c floats.
int pfm_read(const char* path, float* out) {
  int w, h, c, le;
  long off;
  int rc = pfm_read_header(path, &w, &h, &c, &le, &off);
  if (rc != 0) return rc;
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, off, SEEK_SET);
  const size_t row = static_cast<size_t>(w) * c;
  // file stores bottom row first → write rows in reverse
  for (int r = h - 1; r >= 0; --r) {
    if (std::fread(out + static_cast<size_t>(r) * row, sizeof(float), row, f) != row) {
      std::fclose(f);
      return -5;
    }
  }
  std::fclose(f);
  const bool host_le = [] {
    uint16_t probe = 1;
    return *reinterpret_cast<uint8_t*>(&probe) == 1;
  }();
  if ((le == 1) != host_le) byteswap_f32(out, static_cast<size_t>(h) * row);
  return 0;
}

// Write a little-endian PFM (row 0 of `data` = top row).
int pfm_write(const char* path, const float* data, int height, int width,
              int channels) {
  if (channels != 1 && channels != 3) return -3;
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  std::fprintf(f, "%s\n%d %d\n-1.0\n", channels == 3 ? "PF" : "Pf", width, height);
  const size_t row = static_cast<size_t>(width) * channels;
  int rc = 0;
  for (int r = height - 1; r >= 0; --r) {
    if (std::fwrite(data + static_cast<size_t>(r) * row, sizeof(float), row, f) != row) {
      rc = -5;
      break;
    }
  }
  std::fclose(f);
  return rc;
}

// ---------------------------------------------------------------------------
// radiometry / preprocessing
// ---------------------------------------------------------------------------

// In-place per-channel (img - mean) / (std + eps) over the spatial dims
// (the reference's preprocess.center_image).
void center_image(float* img, int height, int width, int channels) {
  const size_t n = static_cast<size_t>(height) * width;
  for (int ch = 0; ch < channels; ++ch) {
    double sum = 0.0, sq = 0.0;
    for (size_t i = 0; i < n; ++i) {
      const double v = img[i * channels + ch];
      sum += v;
      sq += v * v;
    }
    const double mean = sum / n;
    const double var = sq / n - mean * mean;
    const float inv = static_cast<float>(1.0 / (std::sqrt(std::max(var, 0.0)) + 1e-8));
    const float m = static_cast<float>(mean);
    for (size_t i = 0; i < n; ++i) {
      img[i * channels + ch] = (img[i * channels + ch] - m) * inv;
    }
  }
}

// Gamma (1/2.2) + [lo_pct, hi_pct] percentile stretch → [0, 255] uint8.
// Histogram-based percentile (65536 bins over the gamma-mapped range) instead
// of NumPy's full sort — O(n) for 26M-pixel scene tiles.
// The reference's gdal_read_img_tone.
void tone_map_u8(const float* in, uint8_t* out, long n, double lo_pct,
                 double hi_pct) {
  if (n <= 0) return;
  std::vector<float> g(static_cast<size_t>(n));
  float gmin = 1e30f, gmax = -1e30f;
  for (long i = 0; i < n; ++i) {
    const float v = std::pow(std::max(in[i], 0.0f), 1.0f / 2.2f);
    g[i] = v;
    gmin = std::min(gmin, v);
    gmax = std::max(gmax, v);
  }
  const int kBins = 65536;
  std::vector<long> hist(kBins, 0);
  const float scale = (gmax > gmin) ? (kBins - 1) / (gmax - gmin) : 0.0f;
  for (long i = 0; i < n; ++i) {
    hist[static_cast<int>((g[i] - gmin) * scale)]++;
  }
  const long lo_count = static_cast<long>(n * lo_pct / 100.0);
  const long hi_count = static_cast<long>(n * hi_pct / 100.0);
  long acc = 0;
  float lo = gmin, hi = gmax;
  bool lo_set = false;
  for (int b = 0; b < kBins; ++b) {
    acc += hist[b];
    if (!lo_set && acc >= lo_count) {
      lo = gmin + b / scale;
      lo_set = true;
    }
    if (acc >= hi_count) {
      hi = gmin + b / scale;
      break;
    }
  }
  const float inv = (hi > lo) ? 255.0f / (hi - lo) : 0.0f;
  for (long i = 0; i < n; ++i) {
    const float v = (std::clamp(g[i], lo, hi) - lo) * inv;
    out[i] = static_cast<uint8_t>(v + 0.5f);
  }
}

// Strided nearest-neighbor downsample (pyramid level), matching the Python
// build_pyramid semantics (data/preprocess.py).
void downsample_nearest(const float* in, float* out, int height, int width,
                        int step) {
  const int oh = (height + step - 1) / step;
  const int ow = (width + step - 1) / step;
  for (int r = 0; r < oh; ++r) {
    const float* src = in + static_cast<size_t>(r) * step * width;
    float* dst = out + static_cast<size_t>(r) * ow;
    for (int ccol = 0; ccol < ow; ++ccol) dst[ccol] = src[ccol * step];
  }
}

}  // extern "C"
