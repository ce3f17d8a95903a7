// Arithmetic-coded scans (SOF9 sequential, SOF10 progressive), as
// libjpeg-turbo's jdarith.c decodes them: the QM decoder over T.81's
// Table D.2 (jaricom.c), the DC and AC statistics areas with the DC
// context of the previous difference and the DAC conditioning (L, U, Kx),
// every area used by the scan cleared at its start and at each restart
// marker.  Sequential scans decode whole blocks; progressive scans decode
// DC first, DC refinement, AC first and AC refinement bands into the
// component's coefficient buffer, as jpeg_progressive.cpp does for Huffman
// files.  Hitting a marker inside the data is legal here: zero bytes
// follow (T.81 D.2.6).  A magnitude or band overflow, where libjpeg warns
// and leaves the rest of the interval zero, is taken as corrupt.

#include "jpeg_common.h"

namespace jpegdec {

namespace {

// T.81 Table D.2: (Qe << 16) | (Next_Index_MPS << 8) | (Switch_MPS << 7) |
// Next_Index_LPS, with libjpeg's extra state 113 of fixed probability 1/2.
#define V(qe, nlps, nmps, sw) ((int32_t(qe) << 16) | ((nmps) << 8) | ((sw) << 7) | (nlps))
const int32_t kAritab[114] = {
    V(0x5a1d, 1, 1, 1),     V(0x2586, 14, 2, 0),    V(0x1114, 16, 3, 0),    V(0x080b, 18, 4, 0),
    V(0x03d8, 20, 5, 0),    V(0x01da, 23, 6, 0),    V(0x00e5, 25, 7, 0),    V(0x006f, 28, 8, 0),
    V(0x0036, 30, 9, 0),    V(0x001a, 33, 10, 0),   V(0x000d, 35, 11, 0),   V(0x0006, 9, 12, 0),
    V(0x0003, 10, 13, 0),   V(0x0001, 12, 13, 0),   V(0x5a7f, 15, 15, 1),   V(0x3f25, 36, 16, 0),
    V(0x2cf2, 38, 17, 0),   V(0x207c, 39, 18, 0),   V(0x17b9, 40, 19, 0),   V(0x1182, 42, 20, 0),
    V(0x0cef, 43, 21, 0),   V(0x09a1, 45, 22, 0),   V(0x072f, 46, 23, 0),   V(0x055c, 48, 24, 0),
    V(0x0406, 49, 25, 0),   V(0x0303, 51, 26, 0),   V(0x0240, 52, 27, 0),   V(0x01b1, 54, 28, 0),
    V(0x0144, 56, 29, 0),   V(0x00f5, 57, 30, 0),   V(0x00b7, 59, 31, 0),   V(0x008a, 60, 32, 0),
    V(0x0068, 62, 33, 0),   V(0x004e, 63, 34, 0),   V(0x003b, 32, 35, 0),   V(0x002c, 33, 9, 0),
    V(0x5ae1, 37, 37, 1),   V(0x484c, 64, 38, 0),   V(0x3a0d, 65, 39, 0),   V(0x2ef1, 67, 40, 0),
    V(0x261f, 68, 41, 0),   V(0x1f33, 69, 42, 0),   V(0x19a8, 70, 43, 0),   V(0x1518, 72, 44, 0),
    V(0x1177, 73, 45, 0),   V(0x0e74, 74, 46, 0),   V(0x0bfb, 75, 47, 0),   V(0x09f8, 77, 48, 0),
    V(0x0861, 78, 49, 0),   V(0x0706, 79, 50, 0),   V(0x05cd, 48, 51, 0),   V(0x04de, 50, 52, 0),
    V(0x040f, 50, 53, 0),   V(0x0363, 51, 54, 0),   V(0x02d4, 52, 55, 0),   V(0x025c, 53, 56, 0),
    V(0x01f8, 54, 57, 0),   V(0x01a4, 55, 58, 0),   V(0x0160, 56, 59, 0),   V(0x0125, 57, 60, 0),
    V(0x00f6, 58, 61, 0),   V(0x00cb, 59, 62, 0),   V(0x00ab, 61, 63, 0),   V(0x008f, 61, 32, 0),
    V(0x5b12, 65, 65, 1),   V(0x4d04, 80, 66, 0),   V(0x412c, 81, 67, 0),   V(0x37d8, 82, 68, 0),
    V(0x2fe8, 83, 69, 0),   V(0x293c, 84, 70, 0),   V(0x2379, 86, 71, 0),   V(0x1edf, 87, 72, 0),
    V(0x1aa9, 87, 73, 0),   V(0x174e, 72, 74, 0),   V(0x1424, 72, 75, 0),   V(0x119c, 74, 76, 0),
    V(0x0f6b, 74, 77, 0),   V(0x0d51, 75, 78, 0),   V(0x0bb6, 77, 79, 0),   V(0x0a40, 77, 48, 0),
    V(0x5832, 80, 81, 1),   V(0x4d1c, 88, 82, 0),   V(0x438e, 89, 83, 0),   V(0x3bdd, 90, 84, 0),
    V(0x34ee, 91, 85, 0),   V(0x2eae, 92, 86, 0),   V(0x299a, 93, 87, 0),   V(0x2516, 86, 71, 0),
    V(0x5570, 88, 89, 1),   V(0x4ca9, 95, 90, 0),   V(0x44d9, 96, 91, 0),   V(0x3e22, 97, 92, 0),
    V(0x3824, 99, 93, 0),   V(0x32b4, 99, 94, 0),   V(0x2e17, 93, 86, 0),   V(0x56a8, 95, 96, 1),
    V(0x4f46, 101, 97, 0),  V(0x47e5, 102, 98, 0),  V(0x41cf, 103, 99, 0),  V(0x3c3d, 104, 100, 0),
    V(0x375e, 99, 93, 0),   V(0x5231, 105, 102, 0), V(0x4c0f, 106, 103, 0), V(0x4639, 107, 104, 0),
    V(0x415e, 103, 99, 0),  V(0x5627, 105, 106, 1), V(0x50e7, 108, 107, 0), V(0x4b85, 109, 103, 0),
    V(0x5597, 110, 109, 0), V(0x504f, 111, 107, 0), V(0x5a10, 110, 111, 1), V(0x5522, 112, 109, 0),
    V(0x59eb, 112, 111, 1), V(0x5a1d, 113, 113, 0)};
#undef V

constexpr int kDcBins = 64, kAcBins = 256;

class QmDecoder {
 public:
  QmDecoder(const uint8_t* data, int64_t size, int64_t pos) : d_(data), n_(size), pos_(pos) {}

  void reset() {
    c_ = 0;
    a_ = 0;
    ct_ = -16;  // read two bytes into C first
  }

  // One binary decision in statistics bin ``st`` (T.81 D.2.4-D.2.6).
  int decode(uint8_t* st) {
    while (a_ < 0x8000) {
      if (--ct_ < 0) {
        c_ = (c_ << 8) | next_byte();
        if ((ct_ += 8) < 0) {
          if (++ct_ == 0) a_ = 0x8000;  // two initial bytes read: A becomes 0x10000
        }
      }
      a_ <<= 1;
    }
    int sv = *st;
    int32_t qe = kAritab[sv & 0x7F];
    const int nl = qe & 0xFF;
    qe >>= 8;
    const int nm = qe & 0xFF;
    qe >>= 8;
    int64_t temp = a_ - qe;
    a_ = temp;
    temp <<= ct_;
    if (c_ >= temp) {
      c_ -= temp;
      if (a_ < qe) {  // conditional LPS exchange
        a_ = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a_ = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a_ < 0x8000) {
      if (a_ < qe) {  // conditional MPS exchange
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  // Go past the restart marker RSTn (bytes the decoder did not need before
  // it are skipped, as libjpeg skips them with a warning).
  void restart(int expected) {
    int64_t p = at_marker_ ? pos_ : BitReader::next_marker_at(d_, n_, pos_);
    if (p + 1 >= n_ || d_[p] != 0xFF) throw Corrupt("restart marker missing");
    p++;
    while (p < n_ && d_[p] == 0xFF) p++;
    if (p >= n_ || d_[p] != 0xD0 + expected)
      throw Corrupt("restart marker missing or out of order");
    pos_ = p + 1;
    at_marker_ = false;
    reset();
  }

  int64_t finish() const { return at_marker_ ? pos_ : BitReader::next_marker_at(d_, n_, pos_); }

 private:
  int next_byte() {
    if (at_marker_) return 0;
    if (pos_ >= n_) throw Corrupt("file ends inside the entropy-coded data");
    int data = d_[pos_++];
    if (data != 0xFF) return data;
    int64_t p = pos_;
    while (p < n_ && d_[p] == 0xFF) p++;
    if (p >= n_) throw Corrupt("file ends inside the entropy-coded data");
    if (d_[p] == 0) {
      pos_ = p + 1;
      return 0xFF;  // a stuffed zero byte
    }
    pos_ = p - 1;  // on the marker's last 0xFF
    at_marker_ = true;
    return 0;
  }

  const uint8_t* d_;
  int64_t n_, pos_;
  int64_t c_ = 0, a_ = 0;
  int ct_ = -16;
  bool at_marker_ = false;
};

}  // namespace

int64_t decode_arith_scan(const uint8_t* d, int64_t n, int64_t pos, const Frame& f,
                          const Scan& s, const ArithConditioning& dac) {
  QmDecoder qm(d, n, pos);
  const int ns = static_cast<int>(s.comps.size());
  const bool dc_pass = !f.progressive || (s.ss == 0 && s.ah == 0);
  const bool ac_pass = !f.progressive || s.ss != 0;
  uint8_t dc_stats[16][kDcBins], ac_stats[16][kAcBins];
  uint8_t fixed_bin[4] = {113, 0, 0, 0};
  int last_dc[4], dc_context[4];
  auto clear = [&] {
    for (int k = 0; k < ns; k++) {
      if (dc_pass) {
        memset(dc_stats[s.dc_tab[k]], 0, kDcBins);
        last_dc[k] = 0;
        dc_context[k] = 0;
      }
      if (ac_pass) memset(ac_stats[s.ac_tab[k]], 0, kAcBins);
    }
  };
  clear();
  qm.reset();
  int next_rst = 0;
  auto restart = [&] {
    qm.restart(next_rst);
    next_rst = (next_rst + 1) & 7;
    clear();
  };

  // T.81 F.1.4.4.1: a DC difference, its context updated
  auto dc_diff = [&](int k) {
    const int tbl = s.dc_tab[k];
    uint8_t* st = dc_stats[tbl] + dc_context[k];
    if (qm.decode(st) == 0) {
      dc_context[k] = 0;
      return 0;
    }
    const int sign = qm.decode(st + 1);
    st += 2 + sign;
    int m = qm.decode(st);
    if (m != 0) {
      st = dc_stats[tbl] + 20;
      while (qm.decode(st)) {
        if ((m <<= 1) == 0x8000) throw Corrupt("arithmetic-coded magnitude overflows");
        st += 1;
      }
    }
    if (m < ((1 << dac.dc_L[tbl]) >> 1))
      dc_context[k] = 0;
    else if (m > ((1 << dac.dc_U[tbl]) >> 1))
      dc_context[k] = 12 + sign * 4;
    else
      dc_context[k] = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (qm.decode(st)) v |= m;
    v += 1;
    return sign ? -v : v;
  };
  // T.81 F.1.4.4.2: an AC value's sign and magnitude at zigzag index k
  auto ac_value = [&](int tbl, uint8_t* st, int k) {
    const int sign = qm.decode(fixed_bin);
    st += 2;
    int m = qm.decode(st);
    if (m != 0 && qm.decode(st)) {
      m <<= 1;
      st = ac_stats[tbl] + (k <= dac.ac_K[tbl] ? 189 : 217);
      while (qm.decode(st)) {
        if ((m <<= 1) == 0x8000) throw Corrupt("arithmetic-coded magnitude overflows");
        st += 1;
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (qm.decode(st)) v |= m;
    v += 1;
    return sign ? -v : v;
  };
  // the nonzero coefficients of the band ss..se of the first scan over it
  auto ac_band = [&](int tbl, int16_t* b, int ss, int se, int al) {
    for (int k = ss; k <= se; k++) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (qm.decode(st)) break;  // end of block
      while (qm.decode(st + 1) == 0) {
        st += 3;
        if (++k > se) throw Corrupt("arithmetic-coded coefficients run past the band");
      }
      const int v = ac_value(tbl, st, k);
      b[kNatural[k]] = static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(v) << al));
    }
  };

  if (!f.progressive) {
    walk_mcus(f, s, restart, [&](int k, int row, int col) {
      int16_t* b = block_at(s.comps[k], row, col);
      last_dc[k] = (last_dc[k] + dc_diff(k)) & 0xFFFF;
      b[0] = static_cast<int16_t>(last_dc[k]);
      ac_band(s.ac_tab[k], b, 1, 63, 0);
    });
  } else if (s.ss == 0 && s.ah == 0) {  // DC first
    walk_mcus(f, s, restart, [&](int k, int row, int col) {
      last_dc[k] = (last_dc[k] + dc_diff(k)) & 0xFFFF;
      block_at(s.comps[k], row, col)[0] =
          static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(last_dc[k]) << s.al));
    });
  } else if (s.ss == 0) {  // DC refinement
    walk_mcus(f, s, restart, [&](int k, int row, int col) {
      if (qm.decode(fixed_bin))
        block_at(s.comps[k], row, col)[0] |= static_cast<int16_t>(1 << s.al);
    });
  } else if (s.ah == 0) {  // AC first
    walk_mcus(f, s, restart, [&](int, int row, int col) {
      ac_band(s.ac_tab[0], block_at(s.comps[0], row, col), s.ss, s.se, s.al);
    });
  } else {  // AC refinement
    const int tbl = s.ac_tab[0];
    const int p1 = 1 << s.al, m1 = -(1 << s.al);
    walk_mcus(f, s, restart, [&](int, int row, int col) {
      int16_t* b = block_at(s.comps[0], row, col);
      int kex = s.se;  // the previous stage's end of block
      for (; kex > 0; kex--)
        if (b[kNatural[kex]]) break;
      for (int k = s.ss; k <= s.se; k++) {
        uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
        if (k > kex && qm.decode(st)) break;  // end of block
        for (;;) {
          int16_t* coef = &b[kNatural[k]];
          if (*coef) {  // previously nonzero: a correction bit
            if (qm.decode(st + 2))
              *coef = static_cast<int16_t>(*coef < 0 ? *coef + m1 : *coef + p1);
            break;
          }
          if (qm.decode(st + 1)) {  // newly nonzero
            *coef = static_cast<int16_t>(qm.decode(fixed_bin) ? m1 : p1);
            break;
          }
          st += 3;
          if (++k > s.se) throw Corrupt("arithmetic-coded coefficients run past the band");
        }
      }
    });
  }
  return qm.finish();
}

}  // namespace jpegdec
