// PNG scanline unfilter and RGB expansion for the port's image loader,
// and the loader's fused crop + flip + normalize core.
//
// The decoding part of vfi_tpu/native/vfi_io.cpp, widened to every PNG the
// format allows, without zlib: the Python side
// (vfi_tpu_torch/native/__init__.py) parses the chunks and inflates the
// IDAT stream with Python's standard `zlib` module, so this file needs no
// header beyond the C++ standard library. It undoes the per-scanline
// filters (None, Sub, Up, Average, Paeth) of each Adam7 pass (or of the
// one image when not interlaced) and expands the pixels to 8-bit RGB.
//
// The expansion gives what Pillow's `Image.open(...).convert("RGB")`
// gives, bit for bit, which is not the PNG specification's scaling
// everywhere:
//   gray (colour type 0): 1-bit 0 / 255, 2-bit x 85, 4-bit x 17, 8-bit as
//     is; 16-bit saturates at 255 (Pillow opens it as mode I;16, and its
//     RGB conversion clips: 200 -> 200, 1000 -> 255);
//   RGB (2), gray + alpha (4), RGBA (6): 8-bit as is, 16-bit the high
//     byte; alpha dropped;
//   palette (3), 1/2/4/8-bit: the entry's RGB; an index past the last
//     entry reads black.
// tRNS and every other ancillary chunk is ignored, as Pillow's conversion
// ignores them.
//
// vfi_crop_flip_normalize is the port's copy of vfi_io.cpp's: the same
// constants and order, so the output is bit-equal to the JAX package's,
// except that a window reaching outside the image is refused (vfi_io.cpp
// reads past the image there). vfi_io.cpp is built with -march=native,
// and on a host with fused multiply-add GCC contracts its float(s) *
// inv255 - mean into one (it did on the x86 hosts the tests ran on); the
// copy writes that fused multiply-add out (std::fma), so its output is
// one function on every host and compiler.
//
// Built with a C++ compiler on first use (no nvcc needed); a plain C
// interface loaded with ctypes.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// Adam7 passes: x0, y0, dx, dy. A non-interlaced image is one pass 0 0 1 1.
const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                          {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                          {0, 1, 1, 2}};
const int kPlain[1][4] = {{0, 0, 1, 1}};

inline uint8_t paeth(int a, int b, int c) {
  const int pv = a + b - c;
  const int pa = abs(pv - a), pb = abs(pv - b), pc = abs(pv - c);
  if (pa <= pb && pa <= pc) return uint8_t(a);
  if (pb <= pc) return uint8_t(b);
  return uint8_t(c);
}

int channels_of(int color_type) {
  switch (color_type) {
    case 0: return 1;  // gray
    case 2: return 3;  // RGB
    case 3: return 1;  // palette index
    case 4: return 2;  // gray + alpha
    case 6: return 4;  // RGBA
    default: return -1;
  }
}

bool depth_allowed(int color_type, int depth) {
  switch (color_type) {
    case 0: return depth == 1 || depth == 2 || depth == 4 || depth == 8 ||
                   depth == 16;
    case 3: return depth == 1 || depth == 2 || depth == 4 || depth == 8;
    case 2: case 4: case 6: return depth == 8 || depth == 16;
    default: return false;
  }
}

// Undo the filters of `rows` scanlines of `row_bytes` bytes each (plus a
// filter byte) from src into dst. `unit`: bytes per complete pixel, at
// least 1. Returns false on an unknown filter type.
bool unfilter(const uint8_t* src, size_t row_bytes, size_t rows, size_t unit,
              uint8_t* dst) {
  for (size_t y = 0; y < rows; ++y) {
    const uint8_t filter = src[y * (row_bytes + 1)];
    const uint8_t* s = src + y * (row_bytes + 1) + 1;
    uint8_t* d = dst + y * row_bytes;
    const uint8_t* up = y > 0 ? d - row_bytes : nullptr;
    switch (filter) {
      case 0:  // None
        memcpy(d, s, row_bytes);
        break;
      case 1:  // Sub
        for (size_t i = 0; i < row_bytes; ++i)
          d[i] = uint8_t(s[i] + (i >= unit ? d[i - unit] : 0));
        break;
      case 2:  // Up
        for (size_t i = 0; i < row_bytes; ++i)
          d[i] = uint8_t(s[i] + (up ? up[i] : 0));
        break;
      case 3:  // Average
        for (size_t i = 0; i < row_bytes; ++i) {
          const int a = i >= unit ? d[i - unit] : 0;
          const int b = up ? up[i] : 0;
          d[i] = uint8_t(s[i] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (size_t i = 0; i < row_bytes; ++i) {
          const int a = i >= unit ? d[i - unit] : 0;
          const int b = up ? up[i] : 0;
          const int cc = (up && i >= unit) ? up[i - unit] : 0;
          d[i] = uint8_t(s[i] + paeth(a, b, cc));
        }
        break;
      default:
        return false;
    }
  }
  return true;
}

// Sample k of pixel x of an unfiltered row, at the image's bit depth.
inline int sample(const uint8_t* row, size_t x, int c, int k, int depth) {
  const size_t i = x * size_t(c) + size_t(k);
  if (depth == 8) return row[i];
  if (depth == 16) return (row[2 * i] << 8) | row[2 * i + 1];
  const int per = 8 / depth;
  const int shift = 8 - depth * (int(i % size_t(per)) + 1);
  return (row[i / size_t(per)] >> shift) & ((1 << depth) - 1);
}

}  // namespace

extern "C" {

// raw: the inflated IDAT stream: per pass (seven with Adam7 interlace,
// else one) its scanlines of (1 filter byte + the pass's row bytes),
// raw_len bytes in all. palette: pal_entries RGB triples (colour type 3
// only). out: h * w * 3 bytes of RGB. Returns 0 on success, < 0 on an
// unsupported or malformed image.
int vfi_png_decode_rgb(const uint8_t* raw, size_t raw_len, int w, int h,
                       int color_type, int depth, int interlace,
                       const uint8_t* palette, int pal_entries,
                       uint8_t* out) {
  const int c = channels_of(color_type);
  if (c < 0 || !depth_allowed(color_type, depth)) return -1;
  if (w <= 0 || h <= 0) return -2;
  if (interlace != 0 && interlace != 1) return -7;
  if (color_type == 3 && pal_entries <= 0) return -4;
  const int bits = c * depth;
  const size_t unit = bits >= 8 ? size_t(bits / 8) : 1;
  const int (*passes)[4] = interlace ? kAdam7 : kPlain;
  const int n_passes = interlace ? 7 : 1;

  size_t need = 0;
  for (int p = 0; p < n_passes; ++p) {
    const size_t pw = (size_t(w) + passes[p][2] - 1 - passes[p][0]) /
                      passes[p][2];
    const size_t ph = (size_t(h) + passes[p][3] - 1 - passes[p][1]) /
                      passes[p][3];
    if (pw && ph) need += ph * ((pw * bits + 7) / 8 + 1);
  }
  if (raw_len != need) return -3;

  std::vector<uint8_t> plane;
  const uint8_t* src = raw;
  for (int p = 0; p < n_passes; ++p) {
    const int x0 = passes[p][0], y0 = passes[p][1];
    const int dx = passes[p][2], dy = passes[p][3];
    const size_t pw = (size_t(w) + dx - 1 - x0) / dx;
    const size_t ph = (size_t(h) + dy - 1 - y0) / dy;
    if (!pw || !ph) continue;
    const size_t row_bytes = (pw * bits + 7) / 8;
    plane.resize(row_bytes * ph);
    if (!unfilter(src, row_bytes, ph, unit, plane.data())) return -5;
    src += ph * (row_bytes + 1);
    for (size_t py = 0; py < ph; ++py) {
      const uint8_t* row = plane.data() + py * row_bytes;
      uint8_t* orow = out + (size_t(y0) + py * dy) * size_t(w) * 3;
      for (size_t px = 0; px < pw; ++px) {
        uint8_t* d = orow + (size_t(x0) + px * dx) * 3;
        if (color_type == 3) {
          const int idx = sample(row, px, 1, 0, depth);
          if (idx >= pal_entries) {
            d[0] = d[1] = d[2] = 0;
          } else {
            const uint8_t* e = palette + size_t(idx) * 3;
            d[0] = e[0]; d[1] = e[1]; d[2] = e[2];
          }
        } else if (color_type == 0 || color_type == 4) {
          const int v = sample(row, px, c, 0, depth);
          int g;
          switch (depth) {
            case 1: g = v * 255; break;
            case 2: g = v * 85; break;
            case 4: g = v * 17; break;
            case 8: g = v; break;
            // 16-bit: gray saturates, gray + alpha keeps the high byte
            default: g = color_type == 0 ? (v > 255 ? 255 : v) : v >> 8;
          }
          d[0] = d[1] = d[2] = uint8_t(g);
        } else {
          for (int k = 0; k < 3; ++k) {
            const int v = sample(row, px, c, k, depth);
            d[k] = uint8_t(depth == 16 ? v >> 8 : v);
          }
        }
      }
    }
  }
  return 0;
}

// Crop a crop_h x crop_w window at (top, left) out of an RGB uint8 image
// (h x w x 3), mirror it left to right where hflip, and scale to [0, 1]
// as float(s) * (1 / 255); where imagenet_norm, fma(float(s), 1 / 255,
// -mean) / std per channel instead (one rounding before the division).
// out: crop_h * crop_w * 3 float32. Returns 0, or -1 (nothing written)
// for a window outside the image.
int vfi_crop_flip_normalize(const uint8_t* img, int w, int h, int top,
                            int left, int crop_h, int crop_w, int hflip,
                            int imagenet_norm, float* out) {
  if (top < 0 || left < 0 || crop_h < 0 || crop_w < 0 ||
      top > h - crop_h || left > w - crop_w)
    return -1;
  static const float kMean[3] = {0.485f, 0.456f, 0.406f};
  static const float kStd[3] = {0.229f, 0.224f, 0.225f};
  const float inv255 = 1.0f / 255.0f;
  for (int y = 0; y < crop_h; ++y) {
    const uint8_t* srow = img + (size_t(top + y) * w + left) * 3;
    float* drow = out + size_t(y) * crop_w * 3;
    for (int x = 0; x < crop_w; ++x) {
      const uint8_t* s = srow + size_t(hflip ? crop_w - 1 - x : x) * 3;
      float* d = drow + size_t(x) * 3;
      for (int ch = 0; ch < 3; ++ch) {
        const float v = float(s[ch]);
        d[ch] = imagenet_norm ? std::fma(v, inv255, -kMean[ch]) / kStd[ch]
                              : v * inv255;
      }
    }
  }
  return 0;
}

}  // extern "C"
