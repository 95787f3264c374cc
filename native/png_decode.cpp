// Minimal native PNG decoder (8-bit gray / RGB / RGBA / palette-free,
// non-interlaced) on top of zlib — enough for KITTI/TUM image streams.
//
// Rationale: the reference's data path is OpenCV's VideoCapture on the host
// (reference src/vslam.cpp:24,54). Our device pipeline is fed by a *native*
// C++ loader (prefetcher.cpp) that decodes frames off-thread so host decode
// overlaps device compute; this file is its image codec. Grayscale output
// only (the SLAM front-end consumes luminance).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <zlib.h>

namespace {

uint32_t be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
         ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

}  // namespace

extern "C" {

// Parses width/height/channels. Returns 0 on success.
int png_probe(const uint8_t* data, int64_t size, int32_t* w, int32_t* h,
              int32_t* channels) {
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (size < 33 || memcmp(data, sig, 8) != 0) return -1;
  if (memcmp(data + 12, "IHDR", 4) != 0) return -2;
  *w = (int32_t)be32(data + 16);
  *h = (int32_t)be32(data + 20);
  uint8_t depth = data[24], color = data[25], interlace = data[28];
  if (depth != 8 || interlace != 0) return -3;
  switch (color) {
    case 0: *channels = 1; break;
    case 2: *channels = 3; break;
    case 4: *channels = 2; break;
    case 6: *channels = 4; break;
    default: return -4;  // palette unsupported
  }
  return 0;
}

// Decodes to single-channel float32 luminance in [0,1]; out must hold w*h.
int png_decode_gray_f32(const uint8_t* data, int64_t size, float* out,
                        int32_t out_capacity) {
  int32_t w, h, ch;
  int rc = png_probe(data, size, &w, &h, &ch);
  if (rc != 0) return rc;
  if (out_capacity < w * h) return -5;

  // collect IDAT
  std::vector<uint8_t> idat;
  int64_t off = 8;
  while (off + 12 <= size) {
    uint32_t len = be32(data + off);
    const uint8_t* type = data + off + 4;
    if (memcmp(type, "IDAT", 4) == 0)
      idat.insert(idat.end(), data + off + 8, data + off + 8 + len);
    if (memcmp(type, "IEND", 4) == 0) break;
    off += 12 + len;
  }
  if (idat.empty()) return -6;

  const int64_t stride = (int64_t)w * ch;
  std::vector<uint8_t> raw((stride + 1) * (int64_t)h);
  uLongf raw_len = (uLongf)raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), (uLong)idat.size()) != Z_OK)
    return -7;

  std::vector<uint8_t> prev(stride, 0), cur(stride);
  const float inv255 = 1.0f / 255.0f;
  for (int32_t y = 0; y < h; ++y) {
    const uint8_t* row = raw.data() + (int64_t)y * (stride + 1);
    uint8_t filter = row[0];
    const uint8_t* src = row + 1;
    for (int64_t x = 0; x < stride; ++x) {
      int a = x >= ch ? cur[x - ch] : 0;
      int b = prev[x];
      int c = x >= ch ? prev[x - ch] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return -8;
      }
      cur[x] = (uint8_t)v;
    }
    float* orow = out + (int64_t)y * w;
    if (ch == 1) {
      for (int32_t x = 0; x < w; ++x) orow[x] = cur[x] * inv255;
    } else if (ch == 2) {
      for (int32_t x = 0; x < w; ++x) orow[x] = cur[2 * x] * inv255;
    } else {
      for (int32_t x = 0; x < w; ++x) {
        const uint8_t* p = &cur[(int64_t)x * ch];
        orow[x] = (0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2]) * inv255;
      }
    }
    std::swap(prev, cur);
  }
  return 0;
}

// PGM (P5, 8-bit) — trivial native path for synthetic dumps.
int pgm_decode_gray_f32(const uint8_t* data, int64_t size, float* out,
                        int32_t out_capacity, int32_t* w_out, int32_t* h_out) {
  if (size < 10 || data[0] != 'P' || data[1] != '5') return -1;
  int64_t off = 2;
  int vals[3] = {0, 0, 0};
  for (int vi = 0; vi < 3;) {
    while (off < size && (data[off] == ' ' || data[off] == '\n' ||
                          data[off] == '\t' || data[off] == '\r'))
      off++;
    if (off < size && data[off] == '#') {
      while (off < size && data[off] != '\n') off++;
      continue;
    }
    int v = 0;
    while (off < size && data[off] >= '0' && data[off] <= '9')
      v = v * 10 + (data[off++] - '0');
    vals[vi++] = v;
  }
  off++;  // single whitespace after maxval
  int32_t w = vals[0], h = vals[1];
  if (vals[2] != 255 || out_capacity < w * h || off + (int64_t)w * h > size)
    return -2;
  const float inv255 = 1.0f / 255.0f;
  for (int64_t i = 0; i < (int64_t)w * h; ++i) out[i] = data[off + i] * inv255;
  *w_out = w;
  *h_out = h;
  return 0;
}

}  // extern "C"
