// Baseline sequential Huffman JPEG decoding, byte for byte as libjpeg-turbo
// decodes it with its default settings (what PIL's Image.open(...).convert
// ("RGB") gives): the ISLOW integer IDCT (jidctint.c), the "fancy" triangle
// upsamplers h2v1 and h2v2 with their rounding biases (jdsample.c; the box
// upsamplers where libjpeg uses them, a component at most 2 samples wide),
// and the fixed-point YCbCr -> RGB tables (jdcolor.c).  Integer arithmetic
// only, so every compiler gives the same bytes.
//
// Accepted: SOF0 / SOF1 at 8 bits, 1 or 3 components, sampling 4:4:4,
// 4:2:2 (h2v1) and 4:2:0 (h2v2), one interleaved scan or one scan per
// component, restart intervals, any size.  A 3-component file is YCbCr
// unless an Adobe APP14 marker says transform 0 or the component ids spell
// "RGB" (libjpeg's rules, a JFIF marker first).  Progressive, lossless,
// arithmetic-coded, 12-bit, CMYK / YCCK files and other samplings return
// JPEG_UNSUPPORTED; malformed or truncated files JPEG_CORRUPT.
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
#include <stdexcept>
#include <string>
#include <vector>

namespace {

enum { JPEG_OK = 0, JPEG_NEED_BUFFER = 1, JPEG_CORRUPT = -1, JPEG_UNSUPPORTED = -2 };

struct Corrupt : std::runtime_error {
  using std::runtime_error::runtime_error;
};
struct Unsupported : std::runtime_error {
  using std::runtime_error::runtime_error;
};

const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Huffman {
  bool defined = false;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t values[256];
  uint16_t fast[1 << 9];  // (length << 8) | symbol for codes of <= 9 bits, else 0
};

struct Component {
  int id, h, v, tq;
  int width, height;              // samples of this component (downsampled)
  int blocks_w, blocks_h;         // blocks that hold samples
  int alloc_w, alloc_h;           // blocks allocated (whole MCUs)
  std::vector<int16_t> coef;      // alloc_h * alloc_w blocks of 64, natural order
  bool scanned = false;
};

struct Frame {
  int width = 0, height = 0, hmax = 1, vmax = 1, mcus_w = 0, mcus_h = 0;
  std::vector<Component> comps;
};

class BitReader {
 public:
  BitReader(const uint8_t* data, int64_t size, int64_t pos) : d_(data), n_(size), pos_(pos) {}

  int64_t pos() const { return pos_; }

  // The bits of the entropy-coded segment; at a marker, zero bits, which
  // a decode may look ahead into but never consume.
  void fill() {
    while (count_ <= 56) {
      uint32_t byte = 0;
      if (!at_marker_) {
        if (pos_ >= n_) throw Corrupt("file ends inside the entropy-coded data");
        byte = d_[pos_];
        if (byte == 0xFF) {
          int64_t next = pos_ + 1;
          while (next < n_ && d_[next] == 0xFF) next++;  // fill bytes
          if (next >= n_) throw Corrupt("file ends inside the entropy-coded data");
          if (d_[next] == 0x00) {
            pos_ = next + 1;
          } else {
            at_marker_ = true;  // leave pos_ on the marker's 0xFF
            byte = 0;
            padding_ += 8;
          }
        } else {
          pos_++;
        }
      } else {
        padding_ += 8;
      }
      bits_ = (bits_ << 8) | byte;
      count_ += 8;
    }
  }

  uint32_t peek(int n) {
    if (count_ < n) fill();
    return static_cast<uint32_t>((bits_ >> (count_ - n)) & ((1ull << n) - 1));
  }

  void skip(int n) {
    count_ -= n;
    if (count_ < padding_) throw Corrupt("entropy-coded data ends early (truncated or corrupt)");
  }

  int get(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    skip(n);
    return static_cast<int>(v);
  }

  int decode(const Huffman& t) {
    uint32_t look = peek(16);
    uint16_t f = t.fast[look >> 7];
    if (f) {
      skip(f >> 8);
      return f & 0xFF;
    }
    for (int len = 10; len <= 16; len++) {
      int32_t code = static_cast<int32_t>(look >> (16 - len));
      if (code <= t.maxcode[len]) {
        skip(len);
        return t.values[code + t.valoffset[len]];
      }
    }
    throw Corrupt("bad Huffman code");
  }

  // Discard the rest of the byte and go past the restart marker RSTn.
  void restart(int expected) {
    bits_ = 0;
    count_ = 0;
    padding_ = 0;
    if (!at_marker_) {
      // a marker must follow the data at once (padding bits are consumed)
      if (pos_ + 1 >= n_ || d_[pos_] != 0xFF) throw Corrupt("restart marker missing");
    }
    int64_t p = pos_ + 1;
    while (p < n_ && d_[p] == 0xFF) p++;
    if (p >= n_ || d_[p] != 0xD0 + expected)
      throw Corrupt("restart marker missing or out of order");
    pos_ = p + 1;
    at_marker_ = false;
  }

  // After the scan: the position of the next marker.
  int64_t finish() const {
    int64_t p = pos_;
    while (p + 1 < n_ && !(d_[p] == 0xFF && d_[p + 1] != 0x00 && d_[p + 1] != 0xFF)) p++;
    return p;
  }

 private:
  const uint8_t* d_;
  int64_t n_, pos_;
  uint64_t bits_ = 0;
  int count_ = 0, padding_ = 0;
  bool at_marker_ = false;
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

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

// One 1-D pass of jidctint.c (the same even and odd parts in both passes):
// eight dequantized inputs -> eight outputs before descaling.
void idct_1d(const int64_t x[8], int64_t out[8]) {
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
      ac = ac || (r && in[8 * r + c]);
    }
    if (!ac) {
      for (int r = 0; r < 8; r++) ws[8 * r + c] = int(x[0] * (1 << kPass1Bits));
      continue;
    }
    idct_1d(x, y);
    for (int r = 0; r < 8; r++) ws[8 * r + c] = int(descale(y[r], kConstBits - kPass1Bits));
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
      uint8_t v = limit(descale(w[0], kPass1Bits + 3));
      for (int c = 0; c < 8; c++) o[c] = v;
      continue;
    }
    idct_1d(x, y);
    for (int c = 0; c < 8; c++) o[c] = limit(descale(y[c], kConstBits + kPass1Bits + 3));
  }
}

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
      switch (marker) {
        case 0xC0:
        case 0xC1:
          read_frame(seg, seg_len);
          if (header_only) return;
          break;
        case 0xC2: case 0xC6: case 0xCA: case 0xCE:
          throw Unsupported("progressive JPEG");
        case 0xC3: case 0xC7: case 0xCB: case 0xCF:
          throw Unsupported("lossless JPEG");
        case 0xC5:
          throw Unsupported("hierarchical JPEG");
        case 0xC9: case 0xCD:
          throw Unsupported("arithmetic-coded JPEG");
        case 0xCC:
          throw Unsupported("arithmetic-coded JPEG (DAC)");
        case 0xC4:
          read_dht(seg, seg_len);
          break;
        case 0xDB:
          read_dqt(seg, seg_len);
          break;
        case 0xDD:
          if (seg_len != 2) throw Corrupt("bad DRI segment");
          restart_interval_ = (seg[0] << 8) | seg[1];
          break;
        case 0xDC:
          throw Unsupported("JPEG with a DNL marker");
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
          if (marker >= 0xC0 && marker <= 0xCF) throw Unsupported("JPEG of this frame type");
          break;  // APPn, COM and the rest: skipped
      }
      pos_ += len;
    }
    if (frame_.comps.empty()) throw Corrupt("no frame (SOF) in the file");
    for (const Component& c : frame_.comps)
      if (!c.scanned) throw Corrupt("a component has no scan");
  }

  const Frame& frame() const { return frame_; }

  void render(uint8_t* out) {
    const Frame& f = frame_;
    std::vector<std::vector<uint8_t>> full(f.comps.size());
    for (size_t ci = 0; ci < f.comps.size(); ci++) {
      const Component& c = f.comps[ci];
      int pw = c.alloc_w * 8;
      std::vector<uint8_t> plane(static_cast<size_t>(c.alloc_h) * 8 * pw);
      const uint16_t* q = quant_[c.tq];
      for (int by = 0; by < c.blocks_h; by++)
        for (int bx = 0; bx < c.blocks_w; bx++)
          idct_islow(&c.coef[(static_cast<size_t>(by) * c.alloc_w + bx) * 64], q,
                     &plane[static_cast<size_t>(by) * 8 * pw + bx * 8], pw);
      full[ci] = upsample(c, plane, pw);
    }
    size_t npix = static_cast<size_t>(f.width) * f.height;
    if (f.comps.size() == 1) {
      for (size_t i = 0; i < npix; i++) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = full[0][i];
      return;
    }
    if (rgb_) {
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
    for (size_t i = 0; i < npix; i++) {
      int y = full[0][i], cb = full[1][i], cr = full[2][i];
      out[3 * i] = clamp(y + cr_r[cr]);
      out[3 * i + 1] = clamp(y + int((cb_g[cb] + cr_g[cr]) >> 16));
      out[3 * i + 2] = clamp(y + cb_b[cb]);
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

  void read_frame(const uint8_t* s, int64_t len) {
    if (!frame_.comps.empty()) throw Corrupt("a second SOF");
    if (len < 6) throw Corrupt("bad SOF segment");
    if (s[0] != 8) throw Unsupported(std::to_string(s[0]) + "-bit JPEG");
    Frame& f = frame_;
    f.height = (s[1] << 8) | s[2];
    f.width = (s[3] << 8) | s[4];
    int nc = s[5];
    if (f.height == 0) throw Unsupported("JPEG whose height comes in a DNL marker");
    if (f.width == 0) throw Corrupt("JPEG of width 0");
    if (nc == 4) throw Unsupported("CMYK / YCCK JPEG");
    if (nc != 1 && nc != 3) throw Unsupported("JPEG with " + std::to_string(nc) + " components");
    if (len != 6 + 3 * nc) throw Corrupt("bad SOF segment");
    for (int i = 0; i < nc; i++) {
      Component c;
      c.id = s[6 + 3 * i];
      c.h = s[7 + 3 * i] >> 4;
      c.v = s[7 + 3 * i] & 15;
      c.tq = s[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) throw Corrupt("bad SOF component");
      f.comps.push_back(c);
    }
    if (nc == 1) {
      f.comps[0].h = f.comps[0].v = 1;  // one component: one block per MCU
    }
    for (const Component& c : f.comps) {
      f.hmax = std::max(f.hmax, c.h);
      f.vmax = std::max(f.vmax, c.v);
    }
    for (const Component& c : f.comps) {
      int rh = f.hmax / c.h, rv = f.vmax / c.v;
      bool ok = f.hmax % c.h == 0 && f.vmax % c.v == 0 &&
                ((rh == 1 && rv == 1) || (rh == 2 && rv == 1) || (rh == 2 && rv == 2));
      if (!ok) throw Unsupported("JPEG chroma sampling other than 4:4:4, 4:2:2 and 4:2:0");
    }
    f.mcus_w = (f.width + 8 * f.hmax - 1) / (8 * f.hmax);
    f.mcus_h = (f.height + 8 * f.vmax - 1) / (8 * f.vmax);
    for (Component& c : f.comps) {
      c.width = static_cast<int>((int64_t(f.width) * c.h + f.hmax - 1) / f.hmax);
      c.height = static_cast<int>((int64_t(f.height) * c.v + f.vmax - 1) / f.vmax);
      c.blocks_w = (c.width + 7) / 8;
      c.blocks_h = (c.height + 7) / 8;
      c.alloc_w = f.mcus_w * c.h;
      c.alloc_h = f.mcus_h * c.v;
    }
  }

  // libjpeg's default_decompress_parms, at the first SOS
  void choose_color_space() {
    const std::vector<Component>& c = frame_.comps;
    if (c.size() != 3) return;
    if (saw_jfif_) {
      rgb_ = false;
    } else if (saw_adobe_) {
      rgb_ = adobe_transform_ == 0;
    } else {
      rgb_ = c[0].id == 'R' && c[1].id == 'G' && c[2].id == 'B';
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
    if (len < 1) throw Corrupt("bad SOS segment");
    int ns = s[0];
    if (ns < 1 || ns > 4 || len != 4 + 2 * ns) throw Corrupt("bad SOS segment");
    std::vector<Component*> comps;
    std::vector<int> dc_tab, ac_tab;
    for (int i = 0; i < ns; i++) {
      int id = s[1 + 2 * i];
      Component* found = nullptr;
      for (Component& c : frame_.comps)
        if (c.id == id) found = &c;
      if (!found) throw Corrupt("SOS names an unknown component");
      comps.push_back(found);
      dc_tab.push_back(s[2 + 2 * i] >> 4);
      ac_tab.push_back(s[2 + 2 * i] & 15);
      if (dc_tab.back() > 3 || ac_tab.back() > 3 || !huff_[0][dc_tab.back()].defined ||
          !huff_[1][ac_tab.back()].defined)
        throw Corrupt("SOS uses an undefined Huffman table");
      if (!quant_defined_[found->tq]) throw Corrupt("a component's quantization table is missing");
    }
    int ss = s[1 + 2 * ns], se = s[2 + 2 * ns], ahal = s[3 + 2 * ns];
    if (ss != 0 || se != 63 || ahal != 0) throw Unsupported("progressive JPEG scan");

    for (Component* c : comps) {
      if (c->scanned) throw Corrupt("a component is scanned twice");
      c->scanned = true;
      c->coef.assign(static_cast<size_t>(c->alloc_w) * c->alloc_h * 64, 0);
    }
    BitReader br(d_, n_, pos_);
    int pred[4] = {0, 0, 0, 0};
    auto block = [&](int k, int16_t* b) {
      int t = br.decode(huff_[0][dc_tab[k]]);
      if (t > 15) throw Corrupt("bad DC coefficient length");
      pred[k] += t ? extend(br.get(t), t) : 0;
      b[0] = static_cast<int16_t>(pred[k]);
      for (int i = 1; i < 64; i++) {
        int rs = br.decode(huff_[1][ac_tab[k]]);
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
    };
    int64_t mcus;
    int mw;
    if (ns == 1) {
      mw = comps[0]->blocks_w;
      mcus = int64_t(mw) * comps[0]->blocks_h;
    } else {
      mw = frame_.mcus_w;
      mcus = int64_t(mw) * frame_.mcus_h;
    }
    int next_rst = 0;
    for (int64_t m = 0; m < mcus; m++) {
      if (restart_interval_ && m && m % restart_interval_ == 0) {
        br.restart(next_rst);
        next_rst = (next_rst + 1) & 7;
        for (int& p : pred) p = 0;
      }
      int my = static_cast<int>(m / mw), mx = static_cast<int>(m % mw);
      if (ns == 1) {
        Component* c = comps[0];
        block(0, &c->coef[(static_cast<size_t>(my) * c->alloc_w + mx) * 64]);
        continue;
      }
      for (int k = 0; k < ns; k++) {
        Component* c = comps[k];
        for (int v = 0; v < c->v; v++)
          for (int h = 0; h < c->h; h++)
            block(k, &c->coef[(static_cast<size_t>(my * c->v + v) * c->alloc_w + mx * c->h + h) * 64]);
      }
    }
    pos_ = br.finish();
  }

  // jdsample.c: fullsize, h2v1 / h2v2 fancy (a component wider than 2
  // samples) or box.
  std::vector<uint8_t> upsample(const Component& c, const std::vector<uint8_t>& plane, int pw) {
    const Frame& f = frame_;
    int W = f.width, H = f.height, cw = c.width, ch = c.height;
    int rh = f.hmax / c.h, rv = f.vmax / c.v;
    std::vector<uint8_t> out(static_cast<size_t>(W) * H);
    auto at = [&](int y, int x) { return int(plane[static_cast<size_t>(y) * pw + x]); };
    if (rh == 1 && rv == 1) {
      for (int y = 0; y < H; y++) memcpy(&out[static_cast<size_t>(y) * W], &plane[static_cast<size_t>(y) * pw], W);
      return out;
    }
    std::vector<uint8_t> row(2 * static_cast<size_t>(cw) + 2);
    bool fancy = cw > 2;
    for (int oy = 0; oy < H; oy++) {
      int y = rv == 2 ? oy / 2 : oy;
      if (!fancy) {
        for (int x = 0; x < cw; x++) row[2 * x] = row[2 * x + 1] = static_cast<uint8_t>(at(y, x));
      } else if (rv == 1) {
        // h2v1_fancy_upsample
        for (int x = 0; x < cw; x++) {
          int cur = at(y, x) * 3;
          int left = at(y, x > 0 ? x - 1 : 0), right = at(y, x < cw - 1 ? x + 1 : cw - 1);
          row[2 * x] = static_cast<uint8_t>(x == 0 ? at(y, 0) : (cur + left + 1) >> 2);
          row[2 * x + 1] = static_cast<uint8_t>(x == cw - 1 ? at(y, x) : (cur + right + 2) >> 2);
        }
      } else {
        // h2v2_fancy_upsample: the nearer row is above for an even output
        // row, below for an odd one (edge rows repeated)
        int y2 = (oy & 1) ? std::min(y + 1, ch - 1) : std::max(y - 1, 0);
        auto colsum = [&](int x) { return at(y, x) * 3 + at(y2, x); };
        for (int x = 0; x < cw; x++) {
          int cur = colsum(x);
          int last = x > 0 ? colsum(x - 1) : cur, next = x < cw - 1 ? colsum(x + 1) : cur;
          row[2 * x] = static_cast<uint8_t>(x == 0 ? (cur * 4 + 8) >> 4 : (cur * 3 + last + 8) >> 4);
          row[2 * x + 1] =
              static_cast<uint8_t>(x == cw - 1 ? (cur * 4 + 7) >> 4 : (cur * 3 + next + 7) >> 4);
        }
      }
      memcpy(&out[static_cast<size_t>(oy) * W], row.data(), W);
    }
    return out;
  }

  const uint8_t* d_;
  int64_t n_, pos_ = 0;
  Frame frame_;
  Huffman huff_[2][4];
  uint16_t quant_[4][64] = {};
  bool quant_defined_[4] = {false, false, false, false};
  int restart_interval_ = 0;
  bool saw_jfif_ = false, saw_adobe_ = false, rgb_ = false, scanned_ = false;
  int adobe_transform_ = -1;
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
