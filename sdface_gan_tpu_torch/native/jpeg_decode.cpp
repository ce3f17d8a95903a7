// JPEG decoding, byte for byte as libjpeg-turbo 3 decodes a file with its
// default settings (what PIL's Image.open(...).convert("RGB") gives): the
// markers and the frame, the ISLOW integer IDCT (jidctint.c), libjpeg's
// upsamplers (jdsample.c) and colour conversion (jdcolor.c), then, for
// four components, PIL's own CMYK -> RGB.  Integer arithmetic only, so
// every compiler gives the same bytes.
//
// Read, at 8 bits with 1, 3 or 4 components:
//   - sequential Huffman (SOF0 / SOF1), here;
//   - progressive Huffman (SOF2), jpeg_progressive.cpp, and libjpeg-turbo's
//     block smoothing of the coefficients its scans leave unrefined
//     (jdcoefct.c, decompress_smooth_data), here;
//   - arithmetic-coded, sequential (SOF9) and progressive (SOF10), with the
//     DAC conditioning, jpeg_arith.cpp;
//   - lossless Huffman (SOF3), predictors 1-7 with any point transform,
//     jpeg_lossless.cpp;
// with restart intervals, one interleaved scan or several, any size.  The
// sampling factors run from 1 to 4 per component, whichever component
// carries the largest; libjpeg's rules pick the upsampler of each ratio:
// the "fancy" triangle filters h2v1 and h2v2 (a component wider than 2
// samples) and h1v2, the integer box for the other whole ratios and for
// every ratio of a lossless file (libjpeg upsamples those without
// context).  Colour spaces as libjpeg's default_decompress_parms picks
// them: a JFIF marker or no marker means YCbCr (lossless files without a
// marker: RGB), an Adobe APP14 marker's transform 0 RGB, component ids
// "RGB" RGB; four components are CMYK, or YCCK where an Adobe marker's
// transform is not 0 (YCCK -> CMYK as jdcolor.c's ycck_cmyk_convert).
// PIL then reads CMYK as Adobe's inverted CMYK and converts it with its
// cmyk2rgb.
//
// JPEG_UNSUPPORTED: the kinds PIL refuses too (precision other than 8
// bits, 2 or more than 4 components, hierarchical and lossless arithmetic
// frames, fractional sampling ratios, a height of 0 left to a DNL marker,
// a lossless restart interval that is not whole MCU rows).  JPEG_CORRUPT: malformed or truncated
// files, and where libjpeg would only warn and go on.
//
//   int jpeg_decode(const uint8_t* data, int64_t size, uint8_t* out,
//                   int64_t out_size, int32_t* height, int32_t* width,
//                   char* err, int64_t err_size)
//
// Parses the file; returns JPEG_OK after writing height x width x 3 RGB
// bytes to ``out`` when ``out_size`` holds them, JPEG_NEED_BUFFER with the
// size set when it does not (call again with a buffer), or an error code
// with a message in ``err``.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "jpeg_common.h"

namespace jpegdec {

const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

}  // namespace jpegdec

namespace {

using namespace jpegdec;

enum { JPEG_OK = 0, JPEG_NEED_BUFFER = 1, JPEG_CORRUPT = -1, JPEG_UNSUPPORTED = -2 };

void build_huffman(Huffman& t, const uint8_t* counts, const uint8_t* symbols, int nsym) {
  memcpy(t.values, symbols, nsym);
  memset(t.fast, 0, sizeof t.fast);
  int32_t code = 0, k = 0;
  for (int len = 1; len <= 16; len++) {
    t.valoffset[len] = k - code;
    if (counts[len - 1]) {
      for (int i = 0; i < counts[len - 1]; i++, k++, code++) {
        if (len <= 9) {
          int shift = 9 - len;
          for (int j = 0; j < (1 << shift); j++)
            t.fast[(code << shift) | j] = static_cast<uint16_t>((len << 8) | symbols[k]);
        }
      }
      t.maxcode[len] = code - 1;
    } else {
      t.maxcode[len] = -1;
    }
    if (code > (1 << len)) throw Corrupt("bad Huffman table");
    code <<= 1;
  }
  t.maxcode[17] = 0x7FFFFFFF;
  t.defined = true;
}

// jidctint.c's constants (CONST_BITS 13, PASS1_BITS 2, FIX(x) of 13 bits).
// The final range limit is libjpeg-turbo's SIMD versions' saturation, which
// equals the C table's for every value a valid stream gives.
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }
inline uint8_t limit(int64_t v) { return static_cast<uint8_t>(std::min<int64_t>(255, std::max<int64_t>(0, v + 128))); }

// libjpeg-turbo decodes with its SIMD ISLOW IDCT, which holds the
// dequantized coefficients, the sums in0 +- in4, in1 + in5 and in3 + in7
// of each pass and the column pass's outputs in 16 bits and its sums of
// products in 32.  Where none of them overflows it equals jidctint.c, and
// this; every valid stream keeps within them, and a block that does not is
// taken as corrupt (corrupt data can give any coefficient).
inline void check_bits(int64_t v, int bits) {
  if (v < -(int64_t(1) << (bits - 1)) || v >= (int64_t(1) << (bits - 1)))
    throw Corrupt("DCT coefficients out of range");
}
inline void check_pass(const int64_t x[8]) {
  check_bits(x[0] + x[4], 16);
  check_bits(x[0] - x[4], 16);
  check_bits(x[1] + x[5], 16);
  check_bits(x[3] + x[7], 16);
}

// One 1-D pass of jidctint.c (the same even and odd parts in both passes):
// eight dequantized inputs -> eight outputs before descaling.
void idct_1d(const int64_t x[8], int64_t out[8]) {
  check_pass(x);
  int64_t z1 = (x[2] + x[6]) * FIX_0_541196100;
  int64_t tmp2 = z1 + x[6] * -FIX_1_847759065;
  int64_t tmp3 = z1 + x[2] * FIX_0_765366865;
  int64_t tmp0 = (x[0] + x[4]) * (int64_t(1) << kConstBits);
  int64_t tmp1 = (x[0] - x[4]) * (int64_t(1) << kConstBits);
  int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  tmp0 = x[7];
  tmp1 = x[5];
  tmp2 = x[3];
  tmp3 = x[1];
  z1 = tmp0 + tmp3;
  int64_t z2 = tmp1 + tmp2, z3 = tmp0 + tmp2, z4 = tmp1 + tmp3;
  int64_t z5 = (z3 + z4) * FIX_1_175875602;
  tmp0 *= FIX_0_298631336;
  tmp1 *= FIX_2_053119869;
  tmp2 *= FIX_3_072711026;
  tmp3 *= FIX_1_501321110;
  z1 *= -FIX_0_899976223;
  z2 *= -FIX_2_562915447;
  z3 = z3 * -FIX_1_961570560 + z5;
  z4 = z4 * -FIX_0_390180644 + z5;
  tmp0 += z1 + z3;
  tmp1 += z2 + z4;
  tmp2 += z2 + z3;
  tmp3 += z1 + z4;
  out[0] = tmp10 + tmp3;
  out[7] = tmp10 - tmp3;
  out[1] = tmp11 + tmp2;
  out[6] = tmp11 - tmp2;
  out[2] = tmp12 + tmp1;
  out[5] = tmp12 - tmp1;
  out[3] = tmp13 + tmp0;
  out[4] = tmp13 - tmp0;
  for (int i = 0; i < 8; i++) check_bits(out[i], 31);  // with room for the rounding
}

// jidctint.c jpeg_idct_islow: columns, then rows, each with libjpeg's
// shortcut for an all-zero AC part (the same result).
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  int64_t x[8], y[8];
  for (int c = 0; c < 8; c++) {
    bool ac = false;
    for (int r = 0; r < 8; r++) {
      x[r] = int64_t(in[8 * r + c]) * q[8 * r + c];
      check_bits(x[r], 16);
      ac = ac || (r && in[8 * r + c]);
    }
    if (!ac) {
      check_bits(x[0] * (1 << kPass1Bits), 16);
      for (int r = 0; r < 8; r++) ws[8 * r + c] = int(x[0] * (1 << kPass1Bits));
      continue;
    }
    idct_1d(x, y);
    for (int r = 0; r < 8; r++) {
      ws[8 * r + c] = int(descale(y[r], kConstBits - kPass1Bits));
      check_bits(ws[8 * r + c], 16);
    }
  }
  for (int r = 0; r < 8; r++) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    bool ac = false;
    for (int c = 0; c < 8; c++) {
      x[c] = w[c];
      ac = ac || (c && w[c]);
    }
    if (!ac) {
      check_pass(x);
      uint8_t v = limit(descale(w[0], kPass1Bits + 3));
      for (int c = 0; c < 8; c++) o[c] = v;
      continue;
    }
    idct_1d(x, y);
    for (int c = 0; c < 8; c++) o[c] = limit(descale(y[c], kConstBits + kPass1Bits + 3));
  }
}

enum class Space { kGrey, kYCbCr, kRGB, kCMYK, kYCCK };

class Decoder {
 public:
  Decoder(const uint8_t* data, int64_t size) : d_(data), n_(size) {}

  // Parse markers and decode every scan up to EOI (or only the frame header
  // when ``header_only``).
  void run(bool header_only) {
    if (n_ < 4 || d_[0] != 0xFF || d_[1] != 0xD8) throw Corrupt("not a JPEG file (no SOI)");
    pos_ = 2;
    for (;;) {
      int marker = next_marker();
      if (marker == 0xD9) break;  // EOI
      if (marker >= 0xD0 && marker <= 0xD7) continue;  // a stray RSTn
      if (marker == 0x01) continue;                    // TEM, no length
      int64_t len = segment_length();
      const uint8_t* seg = d_ + pos_ + 2;
      int64_t seg_len = len - 2;
      if (marker >= 0xC0 && marker <= 0xCF && marker != 0xC4 && marker != 0xC8 &&
          marker != 0xCC) {
        read_frame(marker, seg, seg_len);
        if (header_only) return;
        pos_ += len;
        continue;
      }
      switch (marker) {
        case 0xC8:
          throw Unsupported("JPEG of frame type JPG (0xC8)");
        case 0xC4:
          read_dht(seg, seg_len);
          break;
        case 0xCC:
          read_dac(seg, seg_len);
          break;
        case 0xDB:
          read_dqt(seg, seg_len);
          break;
        case 0xDD:
          if (seg_len != 2) throw Corrupt("bad DRI segment");
          restart_interval_ = (seg[0] << 8) | seg[1];
          break;
        case 0xDC:
          break;  // DNL: skipped, as libjpeg skips it (a height of 0 is refused at SOF)
        case 0xE0:
          if (seg_len >= 14 && !memcmp(seg, "JFIF", 5)) saw_jfif_ = true;
          break;
        case 0xEE:
          if (seg_len >= 12 && !memcmp(seg, "Adobe", 5)) {
            saw_adobe_ = true;
            adobe_transform_ = seg[11];
          }
          break;
        case 0xDA: {
          if (frame_.comps.empty()) throw Corrupt("SOS before SOF");
          if (!scanned_) choose_color_space();
          scanned_ = true;
          pos_ += len;
          read_scan(seg, seg_len);
          continue;
        }
        default:
          // APPn and COM are skipped; libjpeg refuses the reserved markers
          // (RESn, DHP, EXP, JPGn) and a second SOI
          if (!(marker >= 0xE0 && marker <= 0xEF) && marker != 0xFE)
            throw Corrupt("unknown JPEG marker 0x" + std::to_string(marker));
          break;
      }
      pos_ += len;
    }
    if (frame_.comps.empty()) throw Corrupt("no frame (SOF) in the file");
    for (const Component& c : frame_.comps)
      if (!c.scanned) throw Corrupt("a component has no scan");
    smooth_ = frame_.progressive && block_smoothing();
  }

  const Frame& frame() const { return frame_; }

  void render(uint8_t* out) {
    const Frame& f = frame_;
    const size_t npix = static_cast<size_t>(f.width) * f.height;
    std::vector<std::vector<uint8_t>> full(f.comps.size());
    for (size_t ci = 0; ci < f.comps.size(); ci++) {
      const Component& c = f.comps[ci];
      if (f.lossless) {
        full[ci] = upsample(c, c.samples, c.width);
        continue;
      }
      int pw = c.alloc_w * 8;
      std::vector<uint8_t> plane(static_cast<size_t>(c.alloc_h) * 8 * pw);
      const std::vector<int16_t> coef = smooth_ ? smoothed(c) : std::vector<int16_t>();
      const int16_t* blocks = smooth_ ? coef.data() : c.coef.data();
      for (int by = 0; by < c.blocks_h; by++)
        for (int bx = 0; bx < c.blocks_w; bx++)
          idct_islow(&blocks[(static_cast<size_t>(by) * c.alloc_w + bx) * 64], c.q,
                     &plane[static_cast<size_t>(by) * 8 * pw + bx * 8], pw);
      full[ci] = upsample(c, plane, pw);
    }
    if (space_ == Space::kGrey) {
      for (size_t i = 0; i < npix; i++) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = full[0][i];
      return;
    }
    if (space_ == Space::kRGB) {
      for (size_t i = 0; i < npix; i++)
        for (int k = 0; k < 3; k++) out[3 * i + k] = full[k][i];
      return;
    }
    // jdcolor.c build_ycc_rgb_table / ycc_rgb_convert (SCALEBITS 16)
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    const int64_t half = int64_t(1) << 15;
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      cr_r[i] = int((91881 * x + half) >> 16);
      cb_b[i] = int((116130 * x + half) >> 16);
      cr_g[i] = -46802 * x;
      cb_g[i] = -22554 * x + half;
    }
    auto clamp = [](int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); };
    if (space_ == Space::kYCbCr) {
      for (size_t i = 0; i < npix; i++) {
        int y = full[0][i], cb = full[1][i], cr = full[2][i];
        out[3 * i] = clamp(y + cr_r[cr]);
        out[3 * i + 1] = clamp(y + int((cb_g[cb] + cr_g[cr]) >> 16));
        out[3 * i + 2] = clamp(y + cb_b[cb]);
      }
      return;
    }
    // CMYK as libjpeg gives it (YCCK through ycck_cmyk_convert), then PIL:
    // rawmode "CMYK;I" inverts each byte, cmyk2rgb gives
    // nk - nk * x / 255 with nk = 255 - k (MULDIV255's rounding)
    auto pil_rgb = [](int x, int k) {
      int t = (255 - x) * k + 128;
      return static_cast<uint8_t>(k - (((t >> 8) + t) >> 8));
    };
    for (size_t i = 0; i < npix; i++) {
      int cmy[3];
      if (space_ == Space::kYCCK) {
        int y = full[0][i], cb = full[1][i], cr = full[2][i];
        cmy[0] = clamp(255 - (y + cr_r[cr]));
        cmy[1] = clamp(255 - (y + int((cb_g[cb] + cr_g[cr]) >> 16)));
        cmy[2] = clamp(255 - (y + cb_b[cb]));
      } else {
        for (int k = 0; k < 3; k++) cmy[k] = full[k][i];
      }
      const int k = full[3][i];
      for (int j = 0; j < 3; j++) out[3 * i + j] = pil_rgb(cmy[j], k);
    }
  }

 private:
  int next_marker() {
    if (pos_ >= n_ || d_[pos_] != 0xFF) throw Corrupt("expected a marker");
    while (pos_ < n_ && d_[pos_] == 0xFF) pos_++;
    if (pos_ >= n_) throw Corrupt("file ends before EOI (truncated)");
    return d_[pos_++];
  }

  int64_t segment_length() {
    if (pos_ + 2 > n_) throw Corrupt("file ends inside a marker segment (truncated)");
    int64_t len = (d_[pos_] << 8) | d_[pos_ + 1];
    if (len < 2 || pos_ + len > n_) throw Corrupt("file ends inside a marker segment (truncated)");
    return len;
  }

  void read_frame(int marker, const uint8_t* s, int64_t len) {
    if (!frame_.comps.empty()) throw Corrupt("a second SOF");
    if (len < 6) throw Corrupt("bad SOF segment");
    // PIL's own header parser refuses these before libjpeg sees the file
    if (s[0] != 8) throw Unsupported(std::to_string(s[0]) + "-bit JPEG");
    int nc = s[5];
    if (nc != 1 && nc != 3 && nc != 4)
      throw Unsupported("JPEG with " + std::to_string(nc) + " components");
    // libjpeg-turbo reads SOF0-3 and SOF9-10 only
    switch (marker) {
      case 0xC5: case 0xC6: case 0xC7: case 0xCD: case 0xCE: case 0xCF:
        throw Unsupported("hierarchical (differential) JPEG");
      case 0xCB:
        throw Unsupported("lossless arithmetic-coded JPEG (SOF11)");
      default:
        break;
    }
    Frame& f = frame_;
    f.progressive = marker == 0xC2 || marker == 0xCA;
    f.arith = marker >= 0xC9;
    f.lossless = marker == 0xC3;
    f.height = (s[1] << 8) | s[2];
    f.width = (s[3] << 8) | s[4];
    if (f.height == 0) throw Unsupported("JPEG whose height comes in a DNL marker");
    if (f.width == 0) throw Corrupt("JPEG of width 0");
    if (len != 6 + 3 * nc) throw Corrupt("bad SOF segment");
    for (int i = 0; i < nc; i++) {
      Component c;
      c.id = s[6 + 3 * i];
      c.h = s[7 + 3 * i] >> 4;
      c.v = s[7 + 3 * i] & 15;
      c.tq = s[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) throw Corrupt("bad SOF component");
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
      f.comps.push_back(c);
    }
    for (const Component& c : f.comps) {
      f.hmax = std::max(f.hmax, c.h);
      f.vmax = std::max(f.vmax, c.v);
    }
    for (const Component& c : f.comps)
      if (f.hmax % c.h || f.vmax % c.v)
        throw Unsupported("JPEG of fractional sampling ratios (" + std::to_string(c.h) + "x" +
                          std::to_string(c.v) + " against " + std::to_string(f.hmax) + "x" +
                          std::to_string(f.vmax) + ")");
    const int unit = f.lossless ? 1 : 8;  // samples per block side
    f.mcus_w = (f.width + unit * f.hmax - 1) / (unit * f.hmax);
    f.mcus_h = (f.height + unit * f.vmax - 1) / (unit * f.vmax);
    for (Component& c : f.comps) {
      c.width = static_cast<int>((int64_t(f.width) * c.h + f.hmax - 1) / f.hmax);
      c.height = static_cast<int>((int64_t(f.height) * c.v + f.vmax - 1) / f.vmax);
      c.blocks_w = (c.width + unit - 1) / unit;
      c.blocks_h = (c.height + unit - 1) / unit;
      c.alloc_w = f.mcus_w * c.h;
      c.alloc_h = f.mcus_h * c.v;
    }
  }

  // libjpeg's default_decompress_parms, at the first SOS
  void choose_color_space() {
    const std::vector<Component>& c = frame_.comps;
    if (c.size() == 1) {
      space_ = Space::kGrey;
    } else if (c.size() == 4) {
      space_ = saw_adobe_ && adobe_transform_ != 0 ? Space::kYCCK : Space::kCMYK;
    } else if (saw_jfif_) {
      space_ = Space::kYCbCr;
    } else if (saw_adobe_) {
      space_ = adobe_transform_ == 0 ? Space::kRGB : Space::kYCbCr;
    } else if (c[0].id == 'R' && c[1].id == 'G' && c[2].id == 'B') {
      space_ = Space::kRGB;
    } else {
      space_ = frame_.lossless ? Space::kRGB : Space::kYCbCr;
    }
  }

  void read_dht(const uint8_t* s, int64_t len) {
    int64_t p = 0;
    while (p < len) {
      if (p + 17 > len) throw Corrupt("bad DHT segment");
      int tc = s[p] >> 4, th = s[p] & 15;
      if (tc > 1 || th > 3) throw Corrupt("bad DHT table id");
      int nsym = 0;
      for (int i = 0; i < 16; i++) nsym += s[p + 1 + i];
      if (nsym > 256 || p + 17 + nsym > len) throw Corrupt("bad DHT segment");
      build_huffman(huff_[tc][th], s + p + 1, s + p + 17, nsym);
      p += 17 + nsym;
    }
  }

  // jdmarker.c get_dac: the conditioning of arithmetic DC (L, U) and AC (Kx) tables
  void read_dac(const uint8_t* s, int64_t len) {
    if (len % 2) throw Corrupt("bad DAC segment");
    for (int64_t p = 0; p < len; p += 2) {
      int index = s[p], val = s[p + 1];
      if (index >= 32) throw Corrupt("bad DAC table index");
      if (index >= 16) {
        dac_.ac_K[index - 16] = static_cast<uint8_t>(val);
      } else {
        dac_.dc_L[index] = static_cast<uint8_t>(val & 15);
        dac_.dc_U[index] = static_cast<uint8_t>(val >> 4);
        if (dac_.dc_L[index] > dac_.dc_U[index]) throw Corrupt("bad DAC value");
      }
    }
  }

  void read_dqt(const uint8_t* s, int64_t len) {
    int64_t p = 0;
    while (p < len) {
      int pq = s[p] >> 4, tq = s[p] & 15;
      if (pq > 1 || tq > 3) throw Corrupt("bad DQT table id");
      int64_t need = 1 + 64 * (pq + 1);
      if (p + need > len) throw Corrupt("bad DQT segment");
      for (int k = 0; k < 64; k++)
        quant_[tq][kNatural[k]] = pq ? uint16_t((s[p + 1 + 2 * k] << 8) | s[p + 2 + 2 * k])
                                     : s[p + 1 + k];
      quant_defined_[tq] = true;
      p += need;
    }
  }

  void read_scan(const uint8_t* s, int64_t len) {
    Frame& f = frame_;
    if (len < 1) throw Corrupt("bad SOS segment");
    const int ns = s[0];
    if (ns < 1 || ns > 4 || len != 4 + 2 * ns) throw Corrupt("bad SOS segment");
    Scan scan;
    scan.ss = s[1 + 2 * ns];
    scan.se = s[2 + 2 * ns];
    scan.ah = s[3 + 2 * ns] >> 4;
    scan.al = s[3 + 2 * ns] & 15;
    scan.restart_interval = restart_interval_;
    int blocks = 0;
    for (int i = 0; i < ns; i++) {
      int id = s[1 + 2 * i];
      Component* found = nullptr;
      for (Component& c : f.comps)
        if (c.id == id) found = &c;
      if (!found) throw Corrupt("SOS names an unknown component");
      for (const Component* c : scan.comps)
        if (c == found) throw Corrupt("SOS names a component twice");
      scan.comps.push_back(found);
      scan.dc_tab.push_back(s[2 + 2 * i] >> 4);
      scan.ac_tab.push_back(s[2 + 2 * i] & 15);
      blocks += found->h * found->v;
    }
    if (ns > 1 && blocks > 10) throw Corrupt("more than 10 blocks in an MCU");

    // libjpeg's checks of the scan's parameters for the frame's process
    const bool dc_band = scan.ss == 0;
    if (f.lossless) {
      if (scan.ss < 1 || scan.ss > 7 || scan.se != 0 || scan.ah != 0 || scan.al >= 8)
        throw Corrupt("bad lossless scan parameters");
    } else if (f.progressive) {
      bool bad = dc_band ? scan.se != 0 : (scan.ss > scan.se || scan.se > 63 || ns != 1);
      if ((scan.ah != 0 && scan.al != scan.ah - 1) || scan.al > 13) bad = true;
      if (bad) throw Corrupt("bad progressive scan parameters");
    } else if (scan.ss != 0 || scan.se != 63 || scan.ah != 0 || scan.al != 0) {
      throw Corrupt("sequential JPEG scan with progressive parameters");
    }
    for (int i = 0; i < ns; i++) {
      Component* c = scan.comps[i];
      if (f.arith) {
        if (scan.dc_tab[i] > 15 || scan.ac_tab[i] > 15) throw Corrupt("bad arithmetic table");
      } else {
        const bool need_dc = f.lossless || !f.progressive || (dc_band && scan.ah == 0);
        const bool need_ac = !f.lossless && (!f.progressive || !dc_band);
        if (need_dc && (scan.dc_tab[i] > 3 || !huff_[0][scan.dc_tab[i]].defined))
          throw Corrupt("SOS uses an undefined Huffman table");
        if (need_ac && (scan.ac_tab[i] > 3 || !huff_[1][scan.ac_tab[i]].defined))
          throw Corrupt("SOS uses an undefined Huffman table");
        if (need_dc) scan.dc[i] = &huff_[0][scan.dc_tab[i]];
        if (need_ac) scan.ac[i] = &huff_[1][scan.ac_tab[i]];
      }
      if (!f.lossless && !c->latched) {  // jdinput.c latch_quant_tables
        if (!quant_defined_[c->tq]) throw Corrupt("a component's quantization table is missing");
        memcpy(c->q, quant_[c->tq], sizeof c->q);
        c->latched = true;
      }
      if (f.progressive) {  // the progression's bookkeeping (coef_bits)
        if (!dc_band && c->coef_bits[0] < 0) throw Corrupt("AC scan before the DC scan");
        for (int k = scan.ss; k <= scan.se; k++) {
          if (scan.ah != std::max(c->coef_bits[k], 0)) throw Corrupt("bad progression");
          c->coef_bits[k] = scan.al;
        }
      } else if (c->scanned) {
        throw Corrupt("a component is scanned twice");
      }
      if (!c->scanned) {
        if (f.lossless)
          c->samples.assign(static_cast<size_t>(c->width) * c->height, 0);
        else
          c->coef.assign(static_cast<size_t>(c->alloc_w) * c->alloc_h * 64, 0);
      }
      c->scanned = true;
    }
    if (f.lossless)
      pos_ = decode_lossless_scan(d_, n_, pos_, f, scan);
    else if (f.arith)
      pos_ = decode_arith_scan(d_, n_, pos_, f, scan, dac_);
    else if (f.progressive)
      pos_ = decode_progressive_scan(d_, n_, pos_, f, scan);
    else
      pos_ = decode_sequential_scan(scan);
  }

  // Baseline and extended sequential Huffman scans (jdhuff.c).
  int64_t decode_sequential_scan(const Scan& scan) {
    BitReader br(d_, n_, pos_);
    int pred[4] = {0, 0, 0, 0};
    int next_rst = 0;
    auto restart = [&] {
      br.restart(next_rst);
      next_rst = (next_rst + 1) & 7;
      for (int& p : pred) p = 0;
    };
    walk_mcus(frame_, scan, restart, [&](int k, int row, int col) {
      int16_t* b = block_at(scan.comps[k], row, col);
      int t = br.decode(*scan.dc[k]);
      if (t > 15) throw Corrupt("bad DC coefficient length");
      pred[k] += t ? extend(br.get(t), t) : 0;
      b[0] = static_cast<int16_t>(pred[k]);
      const Huffman& ac = *scan.ac[k];
      for (int i = 1; i < 64; i++) {
        int rs = br.decode(ac);
        int r = rs >> 4, sz = rs & 15;
        if (sz) {
          i += r;
          if (i > 63) throw Corrupt("AC coefficients run past the block");
          b[kNatural[i]] = static_cast<int16_t>(extend(br.get(sz), sz));
        } else if (r == 15) {
          i += 15;
        } else {
          break;
        }
      }
    });
    return br.finish();
  }

  // jdcoefct.c smoothing_ok (libjpeg-turbo 2.1 and later): every component
  // has DC data and nonzero quantizers at the ten lowest frequencies, and
  // some component's first nine AC coefficients are not all fully known.
  bool block_smoothing() const {
    static const int kQ[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (const Component& c : frame_.comps) {
      if (!c.latched || c.coef_bits[0] < 0) return false;
      for (int pos : kQ)
        if (c.q[pos] == 0) return false;
      for (int k = 1; k < 10; k++) useful = useful || c.coef_bits[k] != 0;
    }
    return useful;
  }

  // jdcoefct.c decompress_smooth_data (libjpeg-turbo 2.1 and later): each
  // coefficient among the first nine AC that is still zero and not fully
  // known is estimated from the DC values of the 5 x 5 blocks around (T.81
  // K.8 widened), and clamped below 2^Al; where no AC data came at all, a
  // Gaussian-like kernel also sets the first four third-order ones and the
  // DC.  The neighbours are found as libjpeg finds them, one iMCU row at a
  // time (its row count in the last iMCU row and its column registers kept).
  std::vector<int16_t> smoothed(const Component& c) const {
    std::vector<int16_t> out(c.coef);
    const int* bits = c.coef_bits;
    bool change_dc = true;
    for (int k = 1; k < 10; k++) change_dc = change_dc && bits[k] == -1;
    const int64_t Q00 = c.q[0];
    auto dc = [&](int row, int col) {
      return int(c.coef[(static_cast<size_t>(row) * c.alloc_w + col) * 64]);
    };
    const int total = frame_.mcus_h, last_col = c.blocks_w - 1;
    for (int imcu = 0; imcu < total; imcu++) {
      int block_rows = c.v;
      if (imcu == total - 1 && c.blocks_h % c.v) block_rows = c.blocks_h % c.v;
      const int image_block_rows = block_rows * total;
      for (int r = 0; r < block_rows; r++) {
        const int row = imcu * c.v + r, ibr = imcu * block_rows + r;
        const int prev = ibr > 0 ? row - 1 : row, next = ibr < image_block_rows - 1 ? row + 1 : row;
        const int rows[5] = {ibr > 1 ? row - 2 : prev, prev, row, next,
                             ibr < image_block_rows - 2 ? row + 2 : next};
        int DC[26];  // DC[1..25]: five rows of five columns, the block at DC[13]
        for (int i = 0; i < 5; i++)
          for (int j = 1; j <= 5; j++) DC[5 * i + j] = dc(rows[i], 0);
        for (int bx = 0; bx < c.blocks_w; bx++) {
          if (bx == 0 && bx < last_col)
            for (int i = 0; i < 5; i++) DC[5 * i + 4] = DC[5 * i + 5] = dc(rows[i], 1);
          if (bx + 1 < last_col)
            for (int i = 0; i < 5; i++) DC[5 * i + 5] = dc(rows[i], bx + 2);
          int16_t* ws = &out[(static_cast<size_t>(row) * c.alloc_w + bx) * 64];
          auto estimate = [&](int k, int pos, int64_t num, bool clamp) {
            const int al = bits[k];
            if (k && (al == 0 || ws[pos] != 0)) return;
            const int64_t q = c.q[pos];
            int pred = static_cast<int>(((q << 7) + (num < 0 ? -num : num)) / (q << 8));
            if (clamp && al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
            ws[pos] = static_cast<int16_t>(num < 0 ? -pred : pred);
          };
          const int* D = DC;
          if (change_dc) {
            estimate(1, 1, Q00 * (-D[1] - D[2] + D[4] + D[5] - 3 * D[6] + 13 * D[7] - 13 * D[9] +
                                  3 * D[10] - 3 * D[11] + 38 * D[12] - 38 * D[14] + 3 * D[15] -
                                  3 * D[16] + 13 * D[17] - 13 * D[19] + 3 * D[20] - D[21] -
                                  D[22] + D[24] + D[25]), true);
            estimate(2, 8, Q00 * (-D[1] - 3 * D[2] - 3 * D[3] - 3 * D[4] - D[5] - D[6] +
                                  13 * D[7] + 38 * D[8] + 13 * D[9] - D[10] + D[16] -
                                  13 * D[17] - 38 * D[18] - 13 * D[19] + D[20] + D[21] +
                                  3 * D[22] + 3 * D[23] + 3 * D[24] + D[25]), true);
            estimate(3, 16, Q00 * (D[3] + 2 * D[7] + 7 * D[8] + 2 * D[9] - 5 * D[12] -
                                   14 * D[13] - 5 * D[14] + 2 * D[17] + 7 * D[18] + 2 * D[19] +
                                   D[23]), true);
            estimate(4, 9, Q00 * (-D[1] + D[5] + 9 * D[7] - 9 * D[9] - 9 * D[17] + 9 * D[19] +
                                  D[21] - D[25]), true);
            estimate(5, 2, Q00 * (2 * D[7] - 5 * D[8] + 2 * D[9] + D[11] + 7 * D[12] -
                                  14 * D[13] + 7 * D[14] + D[15] + 2 * D[17] - 5 * D[18] +
                                  2 * D[19]), true);
            estimate(6, 3, Q00 * (D[7] - D[9] + 2 * D[12] - 2 * D[14] + D[17] - D[19]), true);
            estimate(7, 10, Q00 * (D[7] - 3 * D[8] + D[9] - D[17] + 3 * D[18] - D[19]), true);
            estimate(8, 17, Q00 * (D[7] - D[9] - 3 * D[12] + 3 * D[14] + D[17] - D[19]), true);
            estimate(9, 24, Q00 * (D[7] + 2 * D[8] + D[9] - D[17] - 2 * D[18] - D[19]), true);
            estimate(0, 0, Q00 * (-2 * D[1] - 6 * D[2] - 8 * D[3] - 6 * D[4] - 2 * D[5] -
                                  6 * D[6] + 6 * D[7] + 42 * D[8] + 6 * D[9] - 6 * D[10] -
                                  8 * D[11] + 42 * D[12] + 152 * D[13] + 42 * D[14] -
                                  8 * D[15] - 6 * D[16] + 6 * D[17] + 42 * D[18] + 6 * D[19] -
                                  6 * D[20] - 2 * D[21] - 6 * D[22] - 8 * D[23] - 6 * D[24] -
                                  2 * D[25]), false);
          } else {
            estimate(1, 1, Q00 * (-7 * D[11] + 50 * D[12] - 50 * D[14] + 7 * D[15]), true);
            estimate(2, 8, Q00 * (-7 * D[3] + 50 * D[8] - 50 * D[18] + 7 * D[23]), true);
            estimate(3, 16, Q00 * (-D[3] + 13 * D[8] - 24 * D[13] + 13 * D[18] - D[23]), true);
            estimate(4, 9, Q00 * (D[10] + D[16] - 10 * D[17] + 10 * D[19] - D[2] - D[20] + D[22] -
                                  D[24] + D[4] - D[6] + 10 * D[7] - 10 * D[9]), true);
            estimate(5, 2, Q00 * (-D[11] + 13 * D[12] - 24 * D[13] + 13 * D[14] - D[15]), true);
          }
          for (int i = 0; i < 5; i++)
            for (int j = 1; j <= 4; j++) DC[5 * i + j] = DC[5 * i + j + 1];
        }
      }
    }
    return out;
  }

  // jdsample.c: fullsize; h2v1 and h2v2 "fancy" for a component wider
  // than 2 samples and h1v2 "fancy", except in a lossless file; the box
  // for every other whole ratio.
  std::vector<uint8_t> upsample(const Component& c, const std::vector<uint8_t>& plane, int pw) {
    const Frame& f = frame_;
    const int W = f.width, H = f.height, cw = c.width, ch = c.height;
    const int rh = f.hmax / c.h, rv = f.vmax / c.v;
    const bool fancy = !f.lossless;
    std::vector<uint8_t> out(static_cast<size_t>(W) * H);
    auto at = [&](int y, int x) { return int(plane[static_cast<size_t>(y) * pw + x]); };
    if (rh == 1 && rv == 1) {
      for (int y = 0; y < H; y++)
        memcpy(&out[static_cast<size_t>(y) * W], &plane[static_cast<size_t>(y) * pw], W);
      return out;
    }
    std::vector<uint8_t> row(static_cast<size_t>(rh) * cw);
    for (int oy = 0; oy < H; oy++) {
      const int y = oy / rv;
      if (fancy && rh == 2 && rv == 1 && cw > 2) {
        // h2v1_fancy_upsample
        for (int x = 0; x < cw; x++) {
          int cur = at(y, x) * 3;
          int left = at(y, x > 0 ? x - 1 : 0), right = at(y, x < cw - 1 ? x + 1 : cw - 1);
          row[2 * x] = static_cast<uint8_t>(x == 0 ? at(y, 0) : (cur + left + 1) >> 2);
          row[2 * x + 1] = static_cast<uint8_t>(x == cw - 1 ? at(y, x) : (cur + right + 2) >> 2);
        }
      } else if (fancy && rh == 1 && rv == 2) {
        // h1v2_fancy_upsample: the nearer row is above for an even output
        // row, below for an odd one (edge rows repeated)
        const int y2 = (oy & 1) ? std::min(y + 1, ch - 1) : std::max(y - 1, 0);
        const int bias = (oy & 1) ? 2 : 1;
        for (int x = 0; x < cw; x++)
          row[x] = static_cast<uint8_t>((at(y, x) * 3 + at(y2, x) + bias) >> 2);
      } else if (fancy && rh == 2 && rv == 2 && cw > 2) {
        // h2v2_fancy_upsample, the rows as h1v2's
        const int y2 = (oy & 1) ? std::min(y + 1, ch - 1) : std::max(y - 1, 0);
        auto colsum = [&](int x) { return at(y, x) * 3 + at(y2, x); };
        for (int x = 0; x < cw; x++) {
          int cur = colsum(x);
          int last = x > 0 ? colsum(x - 1) : cur, next = x < cw - 1 ? colsum(x + 1) : cur;
          row[2 * x] =
              static_cast<uint8_t>(x == 0 ? (cur * 4 + 8) >> 4 : (cur * 3 + last + 8) >> 4);
          row[2 * x + 1] =
              static_cast<uint8_t>(x == cw - 1 ? (cur * 4 + 7) >> 4 : (cur * 3 + next + 7) >> 4);
        }
      } else {
        // h2v1_upsample, h2v2_upsample, int_upsample: each sample repeated
        for (int x = 0; x < cw; x++)
          memset(&row[static_cast<size_t>(x) * rh], at(y, x), rh);
      }
      memcpy(&out[static_cast<size_t>(oy) * W], row.data(), W);
    }
    return out;
  }

  const uint8_t* d_;
  int64_t n_, pos_ = 0;
  Frame frame_;
  Huffman huff_[2][4];
  ArithConditioning dac_;
  uint16_t quant_[4][64] = {};
  bool quant_defined_[4] = {false, false, false, false};
  int restart_interval_ = 0;
  bool saw_jfif_ = false, saw_adobe_ = false, scanned_ = false;
  bool smooth_ = false;
  int adobe_transform_ = -1;
  Space space_ = Space::kYCbCr;
};

void set_error(char* err, int64_t err_size, const char* msg) {
  if (err && err_size > 0) snprintf(err, static_cast<size_t>(err_size), "%s", msg);
}

}  // namespace

extern "C" int jpeg_decode(const uint8_t* data, int64_t size, uint8_t* out, int64_t out_size,
                           int32_t* height, int32_t* width, char* err, int64_t err_size) {
  try {
    Decoder dec(data, size);
    dec.run(out == nullptr);
    const Frame& f = dec.frame();
    *height = f.height;
    *width = f.width;
    if (out == nullptr || out_size < int64_t(f.height) * f.width * 3) return JPEG_NEED_BUFFER;
    dec.render(out);
    return JPEG_OK;
  } catch (const Unsupported& e) {
    set_error(err, err_size, e.what());
    return JPEG_UNSUPPORTED;
  } catch (const Corrupt& e) {
    set_error(err, err_size, e.what());
    return JPEG_CORRUPT;
  } catch (const std::bad_alloc&) {
    set_error(err, err_size, "out of memory");
    return JPEG_CORRUPT;
  }
}
