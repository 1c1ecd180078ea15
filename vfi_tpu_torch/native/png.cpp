// PNG scanline unfilter and RGB expansion for the port's image loader.
//
// The port's copy of the decoding part of vfi_tpu/native/vfi_io.cpp,
// without zlib: the Python side (vfi_tpu_torch/native/__init__.py) parses
// the chunks and inflates the IDAT stream with Python's standard `zlib`
// module, so this file needs no header beyond the C++ standard library.
// It undoes the per-scanline filters (None, Sub, Up, Average, Paeth) and
// expands the pixels to 8-bit RGB.
//
// Supported: 8-bit, non-interlaced; colour type 0 (gray: three equal
// channels), 2 (RGB), 3 (palette), 4 (gray + alpha: alpha dropped) and
// 6 (RGBA: alpha dropped). Built with a C++ compiler on first use
// (no nvcc needed); a plain C interface loaded with ctypes.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

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

}  // namespace

extern "C" {

// raw: the inflated IDAT stream, h scanlines of (1 filter byte + w * c
// bytes), raw_len bytes in all. palette: pal_entries RGB triples (colour
// type 3 only). out: h * w * 3 bytes of RGB. Returns 0 on success, < 0 on
// an unsupported or malformed image.
int vfi_png_unfilter_rgb(const uint8_t* raw, size_t raw_len, int w, int h,
                         int color_type, const uint8_t* palette,
                         int pal_entries, uint8_t* out) {
  const int c = channels_of(color_type);
  if (c < 0) return -1;
  if (w <= 0 || h <= 0) return -2;
  const size_t stride = size_t(w) * c;
  if (raw_len != (stride + 1) * size_t(h)) return -3;
  if (color_type == 3 && pal_entries <= 0) return -4;

  std::vector<uint8_t> plane(stride * size_t(h));
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = raw + size_t(y) * (stride + 1);
    const uint8_t filter = src[0];
    const uint8_t* s = src + 1;
    uint8_t* d = plane.data() + size_t(y) * stride;
    const uint8_t* up = y > 0 ? d - stride : nullptr;
    switch (filter) {
      case 0:  // None
        memcpy(d, s, stride);
        break;
      case 1:  // Sub
        for (size_t i = 0; i < stride; ++i)
          d[i] = uint8_t(s[i] + (i >= size_t(c) ? d[i - c] : 0));
        break;
      case 2:  // Up
        for (size_t i = 0; i < stride; ++i) d[i] = uint8_t(s[i] + (up ? up[i] : 0));
        break;
      case 3:  // Average
        for (size_t i = 0; i < stride; ++i) {
          const int a = i >= size_t(c) ? d[i - c] : 0;
          const int b = up ? up[i] : 0;
          d[i] = uint8_t(s[i] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (size_t i = 0; i < stride; ++i) {
          const int a = i >= size_t(c) ? d[i - c] : 0;
          const int b = up ? up[i] : 0;
          const int cc = (up && i >= size_t(c)) ? up[i - c] : 0;
          d[i] = uint8_t(s[i] + paeth(a, b, cc));
        }
        break;
      default:
        return -5;
    }
  }

  const size_t npix = size_t(w) * size_t(h);
  for (size_t i = 0; i < npix; ++i) {
    const uint8_t* s = plane.data() + i * c;
    uint8_t* d = out + i * 3;
    switch (color_type) {
      case 0:
      case 4:
        d[0] = d[1] = d[2] = s[0];
        break;
      case 2:
      case 6:
        d[0] = s[0]; d[1] = s[1]; d[2] = s[2];
        break;
      case 3: {
        if (s[0] >= pal_entries) return -6;
        const uint8_t* p = palette + size_t(s[0]) * 3;
        d[0] = p[0]; d[1] = p[1]; d[2] = p[2];
        break;
      }
    }
  }
  return 0;
}

}  // extern "C"
