// Host-side PNG row unfiltering (PNG specification, section 9: filter
// method 0, the five filter types None, Sub, Up, Average and Paeth).
//
// Average and Paeth run in sequence along each row: each byte needs the one
// decoded bpp bytes before it, so numpy cannot vectorise them.  An image
// may mix all five, so the port's PNG decoder
// (rec_attend_tpu_torch/utils/png.py) hands every image here whole.
//
// Built with the C++ compiler by rec_attend_tpu_torch/ops/cuda/build.py and
// called through ctypes; no Python or PyTorch dependencies.

#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

// Unfilter `height` rows of the decompressed stream `in` (each row a filter
// type byte, then `rowbytes` bytes) into `out` (height * rowbytes bytes);
// `bpp` is the bytes per complete pixel, at least 1.  Returns 0, or 1 + the
// index of the first row whose filter type is not 0-4 (its rows and those
// after it are left undecoded).
extern "C" int png_unfilter(const uint8_t* in, int height, int rowbytes,
                            int bpp, uint8_t* out) {
  const uint8_t* prior = nullptr;
  for (int y = 0; y < height; ++y) {
    const uint8_t* src = in + static_cast<int64_t>(y) * (rowbytes + 1);
    uint8_t* row = out + static_cast<int64_t>(y) * rowbytes;
    const int type = src[0];
    ++src;
    switch (type) {
      case 0:
        for (int x = 0; x < rowbytes; ++x) row[x] = src[x];
        break;
      case 1:
        for (int x = 0; x < rowbytes; ++x)
          row[x] = static_cast<uint8_t>(src[x] + (x >= bpp ? row[x - bpp] : 0));
        break;
      case 2:
        for (int x = 0; x < rowbytes; ++x)
          row[x] = static_cast<uint8_t>(src[x] + (prior ? prior[x] : 0));
        break;
      case 3:
        for (int x = 0; x < rowbytes; ++x) {
          const int a = x >= bpp ? row[x - bpp] : 0;
          const int b = prior ? prior[x] : 0;
          row[x] = static_cast<uint8_t>(src[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int x = 0; x < rowbytes; ++x) {
          const int a = x >= bpp ? row[x - bpp] : 0;
          const int b = prior ? prior[x] : 0;
          const int c = (prior && x >= bpp) ? prior[x - bpp] : 0;
          row[x] = static_cast<uint8_t>(src[x] + paeth(a, b, c));
        }
        break;
      default:
        return y + 1;
    }
    prior = row;
  }
  return 0;
}
