// Reverse the PNG scanline filters (PNG spec, section 9.2) of a
// non-interlaced image, every row in turn: None, Sub, Up, Average and Paeth.
// Average and Paeth read the byte just reconstructed to the left, so each
// row is sequential; data/image_io.py calls this when a row uses either.
//
// C ABI for ctypes (data/host_build.py builds it with g++).

#include <cstdint>
#include <cstdlib>

extern "C" {

// in: rows * (stride + 1) bytes, each row led by its filter type byte;
// out: rows * stride bytes. bpp: bytes per pixel (at least 1).
// Returns 0, or 1 + the index of the first row with a filter type above 4.
int64_t png_unfilter(const uint8_t* in, uint8_t* out, int64_t rows, int64_t stride,
                     int64_t bpp) {
  const uint8_t* prev = nullptr;
  for (int64_t r = 0; r < rows; ++r) {
    const uint8_t* f = in + r * (stride + 1);
    const uint8_t type = f[0];
    ++f;
    uint8_t* cur = out + r * stride;
    for (int64_t i = 0; i < stride; ++i) {
      const int a = i >= bpp ? cur[i - bpp] : 0;
      const int b = prev ? prev[i] : 0;
      const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
      int pred;
      switch (type) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: return r + 1;
      }
      cur[i] = static_cast<uint8_t>(f[i] + pred);
    }
    prev = cur;
  }
  return 0;
}

}  // extern "C"
