// Lossless Huffman scans (SOF3) at 8 bits, as libjpeg-turbo 3 decodes
// them (jdlhuff.c, jddiffct.c, jdlossls.c): each sample's difference
// (category 16 meaning 32768), then, one iMCU row at a time, the
// differences undone with the scan's predictor (1-7) against the row's left
// sample (Ra), the one above (Rb) and the one above-left (Rc).  The first
// row of the scan and of each restart interval predicts from the left,
// its first sample from 2^(P-Pt-1); a row's first sample from the one
// above.  Values wrap at 16 bits; the point transform Pt shifts them left
// into 8-bit samples.  libjpeg resets the predictors when it reads a
// restart marker, before it undoes the iMCU row in which the marker lies;
// so does this.

#include <algorithm>

#include "jpeg_common.h"

namespace jpegdec {

int64_t decode_lossless_scan(const uint8_t* d, int64_t n, int64_t pos, const Frame& f,
                             const Scan& s) {
  const int ns = static_cast<int>(s.comps.size());
  const int psv = s.ss, pt = s.al;
  BitReader br(d, n, pos);

  // MCUs: one sample of a lone component, else each component's h x v
  int mcus_w, mcu_rows, rows_per_imcu;
  if (ns == 1) {
    mcus_w = s.comps[0]->width;
    mcu_rows = s.comps[0]->height;
    rows_per_imcu = s.comps[0]->v;
  } else {
    mcus_w = f.mcus_w;
    mcu_rows = f.mcus_h;
    rows_per_imcu = 1;
  }
  if (s.restart_interval % mcus_w != 0)
    throw Unsupported("lossless JPEG whose restart interval is not a whole number of MCU rows");
  const int restart_rows = s.restart_interval / mcus_w;

  // per component: the differences of one iMCU row, the undone row above
  std::vector<std::vector<int>> diff(ns), prev(ns);
  std::vector<int> first_row(ns, 1);
  for (int k = 0; k < ns; k++) {
    const Component* c = s.comps[k];
    const int w = ns == 1 ? c->width : mcus_w * c->h;
    diff[k].assign(static_cast<size_t>(c->v) * w, 0);
    prev[k].assign(c->width, 0);
  }
  const int initial = 1 << (8 - pt - 1);

  auto undo_row = [&](int k, const int* dr, int y) {
    Component* c = s.comps[k];
    int* up = prev[k].data();
    uint8_t* out = &c->samples[static_cast<size_t>(y) * c->width];
    const int w = c->width;
    if (first_row[k]) {
      int ra = (dr[0] + initial) & 0xFFFF;
      up[0] = ra;
      for (int x = 1; x < w; x++) up[x] = ra = (dr[x] + ra) & 0xFFFF;
      first_row[k] = 0;
    } else {
      int rb = up[0];
      int ra = (dr[0] + rb) & 0xFFFF;
      int rc;
      up[0] = ra;
      for (int x = 1; x < w; x++) {
        rc = rb;
        rb = up[x];
        int p;
        switch (psv) {
          case 1: p = ra; break;
          case 2: p = rb; break;
          case 3: p = rc; break;
          case 4: p = ra + rb - rc; break;
          case 5: p = ra + ((rb - rc) >> 1); break;
          case 6: p = rb + ((ra - rc) >> 1); break;
          default: p = (ra + rb) >> 1; break;
        }
        up[x] = ra = (dr[x] + p) & 0xFFFF;
      }
    }
    for (int x = 0; x < w; x++) out[x] = static_cast<uint8_t>(up[x] << pt);
  };

  auto sample_diff = [&](const Huffman& t) {
    int sz = br.decode(t);
    if (sz > 16) throw Corrupt("bad lossless difference length");
    if (sz == 16) return 32768;
    return sz ? extend(br.get(sz), sz) : 0;
  };

  int next_rst = 0, rows_to_go = restart_rows;
  for (int imcu = 0, mrow = 0; mrow < mcu_rows; imcu++) {
    const int rows = std::min(rows_per_imcu, mcu_rows - mrow);
    for (int r = 0; r < rows; r++, mrow++) {
      if (restart_rows) {
        if (rows_to_go == 0) {
          br.restart(next_rst);
          next_rst = (next_rst + 1) & 7;
          std::fill(first_row.begin(), first_row.end(), 1);
          rows_to_go = restart_rows;
        }
        rows_to_go--;
      }
      for (int mx = 0; mx < mcus_w; mx++) {
        if (ns == 1) {
          diff[0][static_cast<size_t>(r) * mcus_w + mx] = sample_diff(*s.dc[0]);
          continue;
        }
        for (int k = 0; k < ns; k++) {
          const Component* c = s.comps[k];
          const int w = mcus_w * c->h;
          for (int yo = 0; yo < c->v; yo++)
            for (int xo = 0; xo < c->h; xo++)
              diff[k][static_cast<size_t>(yo) * w + mx * c->h + xo] = sample_diff(*s.dc[k]);
        }
      }
    }
    // undo the iMCU row's differences, component by component
    for (int k = 0; k < ns; k++) {
      const Component* c = s.comps[k];
      const int w = ns == 1 ? c->width : mcus_w * c->h;
      const int y0 = imcu * c->v;
      const int nrows = ns == 1 ? rows : std::min(c->v, c->height - y0);
      for (int r = 0; r < nrows; r++) undo_row(k, &diff[k][static_cast<size_t>(r) * w], y0 + r);
    }
  }
  return br.finish();
}

}  // namespace jpegdec
