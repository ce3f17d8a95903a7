// What the JPEG decoder's sources share: jpeg_decode.cpp (markers, frame,
// IDCT, upsampling, colour), jpeg_progressive.cpp (progressive Huffman
// scans), jpeg_arith.cpp (arithmetic-coded scans) and jpeg_lossless.cpp
// (lossless scans).  Each entropy decoder reads one scan from the byte
// after its SOS segment and returns where the next marker starts.
#pragma once

#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace jpegdec {

// Malformed or truncated data.
struct Corrupt : std::runtime_error {
  using std::runtime_error::runtime_error;
};
// A kind that PIL (libjpeg-turbo) refuses too.
struct Unsupported : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// Zigzag index -> natural index, with libjpeg's 16 extra entries of 63
// (jutils.c) that absorb a run past the block's end.
extern const int kNatural[80];

struct Huffman {
  bool defined = false;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t values[256];
  uint16_t fast[1 << 9];  // (length << 8) | symbol for codes of <= 9 bits, else 0
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int width = 0, height = 0;      // samples of this component (downsampled)
  int blocks_w = 0, blocks_h = 0; // blocks (lossless: samples) that hold samples
  int alloc_w = 0, alloc_h = 0;   // blocks allocated (whole MCUs)
  std::vector<int16_t> coef;      // DCT: alloc_h * alloc_w blocks of 64, natural order
  std::vector<uint8_t> samples;   // lossless: height * width samples
  uint16_t q[64] = {};            // the quantization table latched at its first scan
  bool latched = false;
  int coef_bits[64] = {};         // progressive: the Al each coefficient has reached, -1 none
  bool scanned = false;
};

struct Frame {
  int width = 0, height = 0, hmax = 1, vmax = 1, mcus_w = 0, mcus_h = 0;
  bool progressive = false, arith = false, lossless = false;
  std::vector<Component> comps;
};

struct Scan {
  std::vector<Component*> comps;
  std::vector<int> dc_tab, ac_tab;
  const Huffman* dc[4] = {nullptr, nullptr, nullptr, nullptr};
  const Huffman* ac[4] = {nullptr, nullptr, nullptr, nullptr};
  int ss = 0, se = 63, ah = 0, al = 0;
  int restart_interval = 0;
};

// The arithmetic conditioning a DAC marker sets (libjpeg's defaults).
struct ArithConditioning {
  uint8_t dc_L[16], dc_U[16], ac_K[16];
  ArithConditioning() {
    memset(dc_L, 0, sizeof dc_L);
    memset(dc_U, 1, sizeof dc_U);
    memset(ac_K, 5, sizeof ac_K);
  }
};

// The bits of a Huffman-coded segment, as libjpeg's jdhuff.c reads them.
class BitReader {
 public:
  BitReader(const uint8_t* data, int64_t size, int64_t pos) : d_(data), n_(size), pos_(pos) {}

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
  int64_t finish() const { return next_marker_at(d_, n_, pos_); }

  static int64_t next_marker_at(const uint8_t* d, int64_t n, int64_t p) {
    while (p + 1 < n && !(d[p] == 0xFF && d[p + 1] != 0x00 && d[p + 1] != 0xFF)) p++;
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

// A block's coefficients (natural order) in the component's block grid.
inline int16_t* block_at(Component* c, int row, int col) {
  return &c->coef[(static_cast<size_t>(row) * c->alloc_w + col) * 64];
}

// libjpeg's MCU order over a scan (the same for every entropy coder of the
// DCT modes): ``restart()`` before each restart interval but the first,
// ``block(k, row, col)`` for each block of the k-th component of the scan.
// One component: its blocks that hold samples, row by row; several: whole
// MCUs, each component's h x v blocks in turn.
template <class Restart, class Block>
void walk_mcus(const Frame& f, const Scan& s, Restart&& restart, Block&& block) {
  const int ns = static_cast<int>(s.comps.size());
  int mw;
  int64_t mcus;
  if (ns == 1) {
    mw = s.comps[0]->blocks_w;
    mcus = int64_t(mw) * s.comps[0]->blocks_h;
  } else {
    mw = f.mcus_w;
    mcus = int64_t(mw) * f.mcus_h;
  }
  for (int64_t m = 0; m < mcus; m++) {
    if (s.restart_interval && m && m % s.restart_interval == 0) restart();
    const int my = static_cast<int>(m / mw), mx = static_cast<int>(m % mw);
    if (ns == 1) {
      block(0, my, mx);
      continue;
    }
    for (int k = 0; k < ns; k++) {
      const Component* c = s.comps[k];
      for (int v = 0; v < c->v; v++)
        for (int h = 0; h < c->h; h++) block(k, my * c->v + v, mx * c->h + h);
    }
  }
}

// The entropy decoders: each returns the position of the marker after the scan.
int64_t decode_progressive_scan(const uint8_t* d, int64_t n, int64_t pos, const Frame& f,
                                const Scan& s);
int64_t decode_arith_scan(const uint8_t* d, int64_t n, int64_t pos, const Frame& f,
                          const Scan& s, const ArithConditioning& dac);
int64_t decode_lossless_scan(const uint8_t* d, int64_t n, int64_t pos, const Frame& f,
                             const Scan& s);

}  // namespace jpegdec
