// PNG scanline unfiltering (PNG spec section 9), the loop of the port's PNG
// decoder (sdface_gan_tpu_torch/data/png.py).  Sub, Average and Paeth read
// the byte already reconstructed to their left, so the loop is serial along
// a row; it runs here rather than in Python or numpy.

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// src: height rows of [filter type byte][stride bytes], as inflated from the
// concatenated IDAT chunks; dst: height * stride bytes.  bpp: bytes per
// pixel (the "left" distance).  Returns 0, -1 if src is too short, or
// 1 + the first row index whose filter type is not 0-4.
int png_unfilter(const uint8_t* src, int64_t src_len, uint8_t* dst, int64_t height,
                 int64_t stride, int64_t bpp) {
  if (height < 0 || stride < 0 || bpp <= 0 || src_len < height * (stride + 1)) return -1;
  const uint8_t* prev = nullptr;
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* in = src + y * (stride + 1);
    const uint8_t type = *in++;
    uint8_t* out = dst + y * stride;
    switch (type) {
      case 0:  // None
        std::memcpy(out, in, static_cast<size_t>(stride));
        break;
      case 1:  // Sub
        for (int64_t i = 0; i < stride; ++i)
          out[i] = static_cast<uint8_t>(in[i] + (i >= bpp ? out[i - bpp] : 0));
        break;
      case 2:  // Up
        for (int64_t i = 0; i < stride; ++i)
          out[i] = static_cast<uint8_t>(in[i] + (prev ? prev[i] : 0));
        break;
      case 3:  // Average
        for (int64_t i = 0; i < stride; ++i) {
          const int left = i >= bpp ? out[i - bpp] : 0;
          const int up = prev ? prev[i] : 0;
          out[i] = static_cast<uint8_t>(in[i] + ((left + up) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          out[i] = static_cast<uint8_t>(in[i] + pred);
        }
        break;
      default:
        return static_cast<int>(1 + y);
    }
    prev = out;
  }
  return 0;
}

}  // extern "C"
