// Run-length-encoded BMP pixel data (BI_RLE8, BI_RLE4), read as PIL 12's
// BmpRleDecoder reads it, so that the port's BMP decoder (data/bmp.py)
// gives what the JAX package's Image.open(...).convert("RGB") gives.  The
// command loop is serial; it runs here rather than in Python.
//
// PIL's reading, kept as it is:
// - an encoded run is cut at the end of its row; RLE4 runs alternate the
//   byte's high and low nibbles;
// - end of line pads the output with zeros to a whole row; end of bitmap
//   stops;
// - a delta escape skips two bytes and then reads its (right, up) pair
//   from the two after them, and pads (right + up * width) zeros;
// - an absolute run of n pixels reads n bytes (RLE8) or n / 2 bytes
//   (RLE4, two pixels each: an odd run loses its last pixel), then skips
//   one byte when the position in the file is odd.
// Output positions are counted from the first row read (the bottom row of
// a bottom-up bitmap); positions never written stay as the caller filled
// them.

#include <cstdint>

extern "C" {

// data/size: the whole file; offset: where the pixel data starts.  out
// receives the first width * height indices.  Returns how many indices
// the commands produced (fewer than width * height: the data ended
// early), or -1 when a delta escape lacks its pair (PIL fails there).
int64_t bmp_rle_decode(const uint8_t* data, int64_t size, int64_t offset, int64_t width,
                       int64_t height, int32_t rle4, uint8_t* out) {
  if (width <= 0 || height <= 0 || offset < 0) return 0;
  const int64_t dest = width * height;
  int64_t len = 0, x = 0, pos = offset;
  auto put = [&](uint8_t v) {
    if (len < dest) out[len] = v;
    ++len;
  };
  while (len < dest) {
    if (pos + 2 > size) break;
    const int pixels = data[pos], byte = data[pos + 1];
    pos += 2;
    if (pixels) {  // encoded run
      int64_t n = pixels;
      if (x + n > width) n = width - x > 0 ? width - x : 0;
      for (int64_t i = 0; i < n; ++i)
        put(static_cast<uint8_t>(!rle4 ? byte : (i % 2 == 0) ? byte >> 4 : byte & 0x0f));
      x += n;
    } else if (byte == 0) {  // end of line
      while (len % width != 0) put(0);
      x = 0;
    } else if (byte == 1) {  // end of bitmap
      break;
    } else if (byte == 2) {  // delta
      if (pos + 2 > size) break;
      pos += 2;
      if (pos + 2 > size) return -1;
      const int64_t right = data[pos], up = data[pos + 1];
      pos += 2;
      for (int64_t i = 0; i < right + up * width; ++i) put(0);
      x = len % width;
    } else {  // absolute run
      const int64_t count = rle4 ? byte / 2 : byte;
      const int64_t avail = pos >= size ? 0 : count < size - pos ? count : size - pos;
      for (int64_t i = 0; i < avail; ++i) {
        const uint8_t b = data[pos + i];
        if (rle4) {
          put(b >> 4);
          put(b & 0x0f);
        } else {
          put(b);
        }
      }
      pos += avail;
      if (avail < count) break;
      x += byte;
      if (pos % 2 != 0) pos += 1;
    }
  }
  return len;
}

}  // extern "C"
