/* Writes the JPEG kinds that PIL's save cannot: arithmetic-coded,
 * lossless, YCCK, custom samplings and scan scripts.  The image tests
 * (test_torch_port_images_jpeg.py) and images/make_image_fixtures.py build it with gcc against libjpeg's headers and links it to the
 * libjpeg-turbo that PIL bundles (which has arithmetic coding and
 * jpeg_enable_lossless), then runs it:
 *
 *   jpeg_writer OUT.jpg IN.raw WIDTH HEIGHT COMPONENTS [key=value ...]
 *
 * IN.raw holds HEIGHT x WIDTH x COMPONENTS bytes: grey (1), RGB (3) or
 * CMYK (4).  Keys:
 *   quality=Q            libjpeg's quality scaling (default 90)
 *   space=S              the file's colour space: grey, ycc, rgb, cmyk, ycck
 *   sampling=HxV,...     each component's sampling factors
 *   arith=1              arithmetic coding (with a DAC marker)
 *   dac=L,U,K            the DAC conditioning of every table
 *   progressive=1        libjpeg's default progressive scan script
 *   scans=SCRIPT         a scan script: "c,c:Ss:Se:Ah:Al;..." per scan
 *   lossless=PSV,PT      lossless, with its predictor and point transform
 *   restart=N            a restart marker every N MCUs
 *   optimize=1           optimised Huffman tables
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

/* libjpeg-turbo 3's, absent from older headers */
extern void jpeg_enable_lossless(j_compress_ptr cinfo, int predictor_selection_value,
                                 int point_transform);

static jpeg_scan_info scans[64];

static int parse_scans(const char *s) {
  int n = 0;
  while (*s && n < 64) {
    jpeg_scan_info *sc = &scans[n++];
    sc->comps_in_scan = 0;
    for (;;) {
      sc->component_index[sc->comps_in_scan++] = (int)strtol(s, (char **)&s, 10);
      if (*s != ',') break;
      s++;
    }
    if (sscanf(s, ":%d:%d:%d:%d", &sc->Ss, &sc->Se, &sc->Ah, &sc->Al) != 4) return -1;
    while (*s && *s != ';') s++;
    if (*s == ';') s++;
  }
  return n;
}

int main(int argc, char **argv) {
  if (argc < 6) {
    fprintf(stderr, "usage: jpeg_writer OUT IN W H C [key=value ...]\n");
    return 2;
  }
  int w = atoi(argv[3]), h = atoi(argv[4]), nc = atoi(argv[5]);
  size_t n = (size_t)w * h * nc;
  unsigned char *pix = malloc(n);
  FILE *in = fopen(argv[2], "rb");
  if (!pix || !in || fread(pix, 1, n, in) != n) {
    fprintf(stderr, "cannot read %s\n", argv[2]);
    return 1;
  }
  fclose(in);

  struct jpeg_compress_struct c;
  struct jpeg_error_mgr jerr;
  c.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&c);
  FILE *out = fopen(argv[1], "wb");
  if (!out) return 1;
  jpeg_stdio_dest(&c, out);
  c.image_width = w;
  c.image_height = h;
  c.input_components = nc;
  c.in_color_space = nc == 1 ? JCS_GRAYSCALE : nc == 3 ? JCS_RGB : JCS_CMYK;
  jpeg_set_defaults(&c);

  int quality = 90, nscans = 0, psv = 0, pt = 0, progressive = 0;
  const char *sampling = NULL;
  for (int i = 6; i < argc; i++) {
    char *v = strchr(argv[i], '=');
    if (!v) return 2;
    *v++ = 0;
    const char *k = argv[i];
    if (!strcmp(k, "quality")) {
      quality = atoi(v);
    } else if (!strcmp(k, "space")) {
      J_COLOR_SPACE s = !strcmp(v, "grey") ? JCS_GRAYSCALE : !strcmp(v, "ycc") ? JCS_YCbCr
                      : !strcmp(v, "rgb") ? JCS_RGB : !strcmp(v, "cmyk") ? JCS_CMYK : JCS_YCCK;
      jpeg_set_colorspace(&c, s);
    } else if (!strcmp(k, "sampling")) {
      sampling = v;
    } else if (!strcmp(k, "arith")) {
      c.arith_code = atoi(v) != 0;
    } else if (!strcmp(k, "dac")) {
      int L, U, K;
      if (sscanf(v, "%d,%d,%d", &L, &U, &K) != 3) return 2;
      for (int t = 0; t < NUM_ARITH_TBLS; t++) {
        c.arith_dc_L[t] = (UINT8)L;
        c.arith_dc_U[t] = (UINT8)U;
        c.arith_ac_K[t] = (UINT8)K;
      }
    } else if (!strcmp(k, "progressive")) {
      progressive = atoi(v);
    } else if (!strcmp(k, "scans")) {
      nscans = parse_scans(v);
      if (nscans <= 0) return 2;
    } else if (!strcmp(k, "lossless")) {
      if (sscanf(v, "%d,%d", &psv, &pt) != 2) return 2;
    } else if (!strcmp(k, "restart")) {
      c.restart_interval = (unsigned)atoi(v);
    } else if (!strcmp(k, "optimize")) {
      c.optimize_coding = atoi(v) != 0;
    } else {
      fprintf(stderr, "unknown key %s\n", k);
      return 2;
    }
  }
  jpeg_set_quality(&c, quality, TRUE);
  if (sampling) {
    const char *s = sampling;
    for (int ci = 0; ci < c.num_components && *s; ci++) {
      int hs, vs;
      if (sscanf(s, "%dx%d", &hs, &vs) != 2) return 2;
      c.comp_info[ci].h_samp_factor = hs;
      c.comp_info[ci].v_samp_factor = vs;
      while (*s && *s != ',') s++;
      if (*s == ',') s++;
    }
  }
  if (progressive) jpeg_simple_progression(&c);
  if (nscans) {
    c.scan_info = scans;
    c.num_scans = nscans;
  }
  if (psv) jpeg_enable_lossless(&c, psv, pt);

  jpeg_start_compress(&c, TRUE);
  JSAMPROW row;
  while (c.next_scanline < c.image_height) {
    row = pix + (size_t)c.next_scanline * w * nc;
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  fclose(out);
  free(pix);
  return 0;
}
