// Progressive Huffman scans (SOF2), as libjpeg-turbo's jdphuff.c decodes
// them: DC first scans (interleaved or not) and their refinement bits, AC
// first scans with end-of-band runs, and AC refinement scans with their
// correction bits, each restart interval starting afresh.  The scan's
// coefficients add to the component's buffer, which jpeg_decode.cpp turns
// into samples once every scan is read.  Where libjpeg would only warn and
// go on (a band overrun, a refinement coefficient of size other than 1),
// the scan is taken as corrupt.

#include <climits>

#include "jpeg_common.h"

namespace jpegdec {

int64_t decode_progressive_scan(const uint8_t* d, int64_t n, int64_t pos, const Frame& f,
                                const Scan& s) {
  BitReader br(d, n, pos);
  const int al = s.al, ss = s.ss, se = s.se;
  const int p1 = 1 << al, m1 = -(1 << al);  // 1 and -1 in the bit position being coded
  int pred[4] = {0, 0, 0, 0};
  unsigned eobrun = 0;
  int next_rst = 0;
  auto restart = [&] {
    br.restart(next_rst);
    next_rst = (next_rst + 1) & 7;
    for (int& p : pred) p = 0;
    eobrun = 0;
  };

  if (ss == 0 && s.ah == 0) {  // DC first
    walk_mcus(f, s, restart, [&](int k, int row, int col) {
      int t = br.decode(*s.dc[k]);
      if (t > 15) throw Corrupt("bad DC coefficient length");
      int diff = t ? extend(br.get(t), t) : 0;
      if ((pred[k] >= 0 && diff > INT_MAX - pred[k]) || (pred[k] < 0 && diff < INT_MIN - pred[k]))
        throw Corrupt("DC coefficient overflows");
      pred[k] += diff;
      block_at(s.comps[k], row, col)[0] =
          static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(pred[k]) << al));
    });
  } else if (ss == 0) {  // DC refinement: the next bit of each DC value
    walk_mcus(f, s, restart, [&](int k, int row, int col) {
      if (br.get(1)) block_at(s.comps[k], row, col)[0] |= static_cast<int16_t>(p1);
    });
  } else if (s.ah == 0) {  // AC first
    const Huffman& tab = *s.ac[0];
    walk_mcus(f, s, restart, [&](int, int row, int col) {
      if (eobrun > 0) {
        eobrun--;
        return;
      }
      int16_t* b = block_at(s.comps[0], row, col);
      for (int k = ss; k <= se; k++) {
        int rs = br.decode(tab);
        int r = rs >> 4, sz = rs & 15;
        if (sz) {
          k += r;
          if (k > se) throw Corrupt("AC coefficients run past the band");
          const int v = extend(br.get(sz), sz);
          b[kNatural[k]] = static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(v) << al));
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun = 1u << r;
          if (r) eobrun += static_cast<unsigned>(br.get(r));
          eobrun--;  // this band ends here
          break;
        }
      }
    });
  } else {  // AC refinement
    const Huffman& tab = *s.ac[0];
    // a correction bit for an already nonzero coefficient: 1 adds to its magnitude
    auto correct = [&](int16_t* coef) {
      if (br.get(1) && (*coef & p1) == 0)
        *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
    };
    walk_mcus(f, s, restart, [&](int, int row, int col) {
      int16_t* b = block_at(s.comps[0], row, col);
      int k = ss;
      if (eobrun == 0) {
        for (; k <= se; k++) {
          int rs = br.decode(tab);
          int r = rs >> 4, sz = rs & 15, value = 0;
          if (sz) {
            if (sz != 1) throw Corrupt("bad refinement coefficient size");
            value = br.get(1) ? p1 : m1;
          } else if (r != 15) {
            eobrun = 1u << r;
            if (r) eobrun += static_cast<unsigned>(br.get(r));
            break;  // the rest of the band is the end-of-band run's
          }
          // pass the already nonzero coefficients (correcting each) and r
          // zero ones; the newly nonzero one, if any, lands on the next zero
          do {
            int16_t* coef = &b[kNatural[k]];
            if (*coef != 0) {
              correct(coef);
            } else if (--r < 0) {
              break;
            }
            k++;
          } while (k <= se);
          if (value) {
            if (k > se) throw Corrupt("AC refinement runs past the band");
            b[kNatural[k]] = static_cast<int16_t>(value);
          }
        }
      }
      if (eobrun > 0) {
        for (; k <= se; k++) {
          int16_t* coef = &b[kNatural[k]];
          if (*coef != 0) correct(coef);
        }
        eobrun--;
      }
    });
  }
  return br.finish();
}

}  // namespace jpegdec
