// WebP decoding, byte for byte as libwebp 1.6 decodes a file into RGBA
// with its default options (what PIL's Image.open(...).convert("RGB")
// gives: PIL reads WebP through libwebp's animation decoder, which decodes
// a still image's one frame with WebPDecode into an RGBA canvas).  Integer
// arithmetic only, so every compiler gives the same bytes.
//
// Container (RIFF): the simple formats "VP8 " and "VP8L", the extended
// format "VP8X" holding one still image, and animated VP8X files (ANIM,
// ANMF), checked as libwebp's demuxer checks them: every frame has an
// image chunk (ALPH only before VP8) and lies inside the canvas.  Of an
// animation the first frame is decoded, as the animation decoder does for
// PIL: a key frame, decoded into a zero-filled canvas at its offset and
// never blended, so the RGB outside it is 0.  ICCP, EXIF, XMP and unknown
// chunks are skipped; an ALPH chunk's header is checked but its alpha is
// not decoded, since the RGB does not depend on it.  A still image's VP8X
// canvas must equal the frame.
//
// Lossy VP8 key frames (RFC 6386): the boolean decoder, segmentation,
// quantizer and loop-filter deltas, 1-8 token partitions, dequantization
// (the Y2 AC factor x 155 / 100, at least 8; the UV DC step at most 132),
// coefficient tokens with probability updates and the skip flag, 16x16,
// 4x4 and chroma intra prediction, the inverse WHT and DCT, the normal and
// simple loop filters with sharpness, interior and hev limits, as libwebp
// applies them (no inner edges on a macroblock without coefficients
// unless it is 4x4-predicted).  Then libwebp's "fancy" 4:2:0 upsampler
// (9-3-3-1 chroma weights) and its 14-bit fixed-point YUV -> RGB.
//
// Lossless VP8L: the header, the predictor (14 modes), cross-color,
// subtract-green and color-indexing (with pixel bundling) transforms, the
// color cache, meta prefix codes, normal and simple prefix codes, LZ77
// back-references with the 120-entry distance map; then ARGB -> RGB.
//
//   int webp_decode(const uint8_t* data, int64_t size, uint8_t* out,
//                   int64_t out_size, int32_t* height, int32_t* width,
//                   char* err, int64_t err_size)
//
// Parses the file; returns WEBP_OK after writing height x width x 3 RGB
// bytes (the canvas) to ``out`` when ``out_size`` holds them,
// WEBP_NEED_BUFFER with the size set when it does not (call again with a
// buffer; only the headers are read then), or WEBP_CORRUPT with a message
// in ``err`` for truncated or corrupt data.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <vector>

namespace {

enum { WEBP_OK = 0, WEBP_NEED_BUFFER = 1, WEBP_CORRUPT = -1 };

struct Corrupt : std::runtime_error {
  using std::runtime_error::runtime_error;
};

inline uint32_t le16(const uint8_t* p) { return p[0] | (uint32_t(p[1]) << 8); }
inline uint32_t le24(const uint8_t* p) { return le16(p) | (uint32_t(p[2]) << 16); }
inline uint32_t le32(const uint8_t* p) { return le24(p) | (uint32_t(p[3]) << 24); }
inline uint8_t clip8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

// ============================================================ VP8 tables
// RFC 6386's tables, with the 4x4 intra modes in libwebp's order.

const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

const uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};

const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};

const uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};

const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a,
    0x38, 0x05, 0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04,
    0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45,
    0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d,
    0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e,
    0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e,
    0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b, 0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e,
    0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d,
    0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70,
};

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};

// 4x4 modes; the 16x16 and chroma modes DC, TM, V, H share the first four.
enum { B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };
const int8_t kYModesIntra4[18] = {-B_DC, 1,  -B_TM, 2,     -B_VE, 3,     4,     6,     -B_HE,
                                  5,     -B_RD, -B_VR, -B_LD, 7,     -B_VL, 8,     -B_HD, -B_HU};

// ================================================ VP8 boolean decoder
// libwebp's reader, one byte at a time: reading past the end yields zero
// bits and sets eof(), which the decoder checks where libwebp does.
class BoolReader {
 public:
  void init(const uint8_t* p, size_t n) {
    buf_ = p;
    end_ = p + n;
    value_ = 0;
    bits_ = -8;
    range_ = 255 - 1;
    eof_ = false;
    load();
  }
  bool eof() const { return eof_; }

  int bit(int prob) {
    if (bits_ < 0) load();
    uint32_t range = range_;  // the true range minus 1
    const uint32_t split = (range * uint32_t(prob)) >> 8;
    const uint32_t value = uint32_t(value_ >> bits_);
    int b;
    if (value > split) {
      range -= split;
      value_ -= uint64_t(split + 1) << bits_;
      b = 1;
    } else {
      range = split + 1;
      b = 0;
    }
    const int shift = 7 ^ (31 ^ __builtin_clz(range));
    range <<= shift;
    bits_ -= shift;
    range_ = range - 1;
    return b;
  }

  uint32_t value(int nbits) {
    uint32_t v = 0;
    while (nbits-- > 0) v |= uint32_t(bit(0x80)) << nbits;
    return v;
  }

  int signed_value(int nbits) {
    const int v = int(value(nbits));
    return bit(0x80) ? -v : v;
  }

 private:
  void load() {
    if (buf_ < end_) {
      bits_ += 8;
      value_ = (value_ << 8) | *buf_++;
    } else if (!eof_) {
      value_ <<= 8;
      bits_ += 8;
      eof_ = true;
    } else {
      bits_ = 0;
    }
  }

  const uint8_t* buf_ = nullptr;
  const uint8_t* end_ = nullptr;
  uint64_t value_ = 0;
  int bits_ = 0;
  uint32_t range_ = 0;
  bool eof_ = false;
};

// ====================================================== VP8 pixel ops
constexpr int BPS = 32;  // stride of the prediction workspace

inline uint8_t avg3(int a, int b, int c) { return uint8_t((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return uint8_t((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  for (int y = 0; y < size; ++y, dst += BPS)
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + dst[-1] - top[-1]);
}

void fill(uint8_t* dst, int size, int v) {
  for (int y = 0; y < size; ++y) memset(dst + y * BPS, v, size);
}

// 16x16 luma (size 16) or 8x8 chroma (size 8) prediction; DC at the
// frame's top and left edges uses what exists, 0x80 with neither.
void predict_block(uint8_t* dst, int size, int mode, bool has_top, bool has_left) {
  const int shift = size == 16 ? 4 : 3;
  switch (mode) {
    case B_DC: {
      int dc = 0;
      if (has_top && has_left) {
        for (int i = 0; i < size; ++i) dc += dst[i - BPS] + dst[i * BPS - 1];
        dc = (dc + size) >> (shift + 1);
      } else if (has_top) {
        for (int i = 0; i < size; ++i) dc += dst[i - BPS];
        dc = (dc + (size >> 1)) >> shift;
      } else if (has_left) {
        for (int i = 0; i < size; ++i) dc += dst[i * BPS - 1];
        dc = (dc + (size >> 1)) >> shift;
      } else {
        dc = 0x80;
      }
      fill(dst, size, dc);
      break;
    }
    case B_TM:
      true_motion(dst, size);
      break;
    case B_VE:
      for (int y = 0; y < size; ++y) memcpy(dst + y * BPS, dst - BPS, size);
      break;
    case B_HE:
      for (int y = 0; y < size; ++y) memset(dst + y * BPS, dst[y * BPS - 1], size);
      break;
    default:
      throw Corrupt("bad intra mode");
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]
void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  const int I = dst[-1], J = dst[BPS - 1], K = dst[2 * BPS - 1], L = dst[3 * BPS - 1];
  switch (mode) {
    case B_DC: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[i * BPS - 1];
      fill(dst, 4, int(dc >> 3));
      break;
    }
    case B_TM:
      true_motion(dst, 4);
      break;
    case B_VE: {
      const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int y = 0; y < 4; ++y) memcpy(dst + y * BPS, v, 4);
      break;
    }
    case B_HE: {
      const int rows[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L), avg3(K, L, L)};
      for (int y = 0; y < 4; ++y) memset(dst + y * BPS, rows[y], 4);
      break;
    }
    case B_RD:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HD:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    case B_HU:
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = uint8_t(L);
      break;
    default:
      throw Corrupt("bad 4x4 intra mode");
  }
}
#undef DST

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// Inverse DCT of one 4x4 block, added to the prediction at dst.
void inverse_dct_add(const int16_t* in, uint8_t* dst) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int a = in[i] + in[8 + i];
    const int b = in[i] - in[8 + i];
    const int c = mul2(in[4 + i]) - mul1(in[12 + i]);
    const int d = mul1(in[4 + i]) + mul2(in[12 + i]);
    tmp[4 * i + 0] = a + d;
    tmp[4 * i + 1] = b + c;
    tmp[4 * i + 2] = b - c;
    tmp[4 * i + 3] = a - d;
  }
  for (int i = 0; i < 4; ++i, dst += BPS) {  // horizontal pass
    const int dc = tmp[i] + 4;
    const int a = dc + tmp[8 + i];
    const int b = dc - tmp[8 + i];
    const int c = mul2(tmp[4 + i]) - mul1(tmp[12 + i]);
    const int d = mul1(tmp[4 + i]) + mul2(tmp[12 + i]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
  }
}

// Inverse Walsh-Hadamard transform of the Y2 block into the DC term of
// each of the 16 luma blocks.
void inverse_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[i] - in[12 + i];
    tmp[i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i, out += 64) {
    const int dc = tmp[4 * i] + 3;
    const int a0 = dc + tmp[4 * i + 3];
    const int a1 = tmp[4 * i + 1] + tmp[4 * i + 2];
    const int a2 = tmp[4 * i + 1] - tmp[4 * i + 2];
    const int a3 = dc - tmp[4 * i + 3];
    out[0] = int16_t((a0 + a1) >> 3);
    out[16] = int16_t((a3 + a2) >> 3);
    out[32] = int16_t((a0 - a1) >> 3);
    out[48] = int16_t((a3 - a2) >> 3);
  }
}

// ------------------------------------------------------- loop filters
inline int abs0(int v) { return v < 0 ? -v : v; }
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }  // [-1020, 1020]
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }      // [-112, 112]

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return abs0(p1 - p0) > thresh || abs0(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * abs0(p0 - q0) + abs0(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * abs0(p0 - q0) + abs0(p1 - q1) > t) return false;
  return abs0(p3 - p2) <= it && abs0(p2 - p1) <= it && abs0(p1 - p0) <= it &&
         abs0(q3 - q2) <= it && abs0(q2 - q1) <= it && abs0(q1 - q0) <= it;
}

// The simple filter across one 16-pixel edge: `step` crosses the edge,
// `along` walks it.
void simple_edge(uint8_t* p, int step, int along, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += along)
    if (needs_filter(p, step, thresh2)) do_filter2(p, step);
}

// The normal filter across one edge: 6 taps on macroblock edges, 4 inside.
void normal_edge(uint8_t* p, int step, int along, int size, int thresh, int ithresh,
                 int hev_thresh, bool mb_edge) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += along) {
    if (!needs_filter2(p, step, thresh2, ithresh)) continue;
    if (hev(p, step, hev_thresh))
      do_filter2(p, step);
    else if (mb_edge)
      do_filter6(p, step);
    else
      do_filter4(p, step);
  }
}

// ======================================================== VP8 decoder
struct FilterInfo {
  int limit = 0;  // 0: not filtered
  int ilevel = 0, hev_thresh = 0;
  bool inner = false;
};

struct Segments {
  bool use = false, update_map = false, absolute_delta = true;
  int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  int proba[3] = {255, 255, 255};
};

struct Quant {
  int y1[2], y2[2], uv[2];
};

using BandProbas = uint8_t[3][11];

class Vp8Decoder {
 public:
  // data: the payload of a "VP8 " chunk (size with its pad byte, chunk_size
  // as declared).
  Vp8Decoder(const uint8_t* data, size_t size, size_t chunk_size) : d_(data), n_(size) {
    if (n_ < 10) throw Corrupt("VP8 frame header truncated");
    const uint32_t bits = le24(d_);
    if (bits & 1) throw Corrupt("VP8 frame is not a key frame");
    if (((bits >> 1) & 7) > 3) throw Corrupt("VP8 profile is not 0-3");
    if (!((bits >> 4) & 1)) throw Corrupt("VP8 frame is not displayable");
    part0_size_ = bits >> 5;
    if (part0_size_ >= chunk_size) throw Corrupt("VP8 first partition size exceeds the chunk");
    if (d_[3] != 0x9d || d_[4] != 0x01 || d_[5] != 0x2a) throw Corrupt("VP8 start code missing");
    width_ = int(le16(d_ + 6) & 0x3fff);
    height_ = int(le16(d_ + 8) & 0x3fff);
    if (width_ == 0 || height_ == 0) throw Corrupt("VP8 frame of zero size");
  }

  int width() const { return width_; }
  int height() const { return height_; }

  void decode(uint8_t* rgb) {
    parse_headers();
    mb_w_ = (width_ + 15) >> 4;
    mb_h_ = (height_ + 15) >> 4;
    ys_ = 16 * mb_w_;
    uvs_ = 8 * mb_w_;
    y_.assign(size_t(ys_) * 16 * mb_h_, 0);
    u_.assign(size_t(uvs_) * 8 * mb_h_, 0);
    v_.assign(size_t(uvs_) * 8 * mb_h_, 0);
    finfo_.assign(size_t(mb_w_) * mb_h_, FilterInfo());
    precompute_filter_strengths();
    decode_frame();
    if (filter_type_ > 0) filter_frame();
    to_rgb(rgb);
  }

 private:
  struct MB {  // non-zero contexts of a column (top) or of the left neighbour
    uint8_t nz = 0, nz_dc = 0;
  };
  struct MBData {
    int16_t coeffs[384];
    uint8_t imodes[16];
    uint8_t uvmode = 0, segment = 0;
    bool is_i4x4 = false, skip = false;
  };

  void parse_headers() {
    const uint8_t* buf = d_ + 10;
    size_t size = n_ - 10;
    if (part0_size_ > size) throw Corrupt("VP8 first partition truncated");
    br_.init(buf, part0_size_);
    buf += part0_size_;
    size -= part0_size_;
    br_.value(1);  // colour space
    br_.value(1);  // clamping type: libwebp always clamps
    parse_segment_header();
    parse_filter_header();
    parse_partitions(buf, size);
    parse_quant();
    br_.value(1);  // refresh entropy probabilities: ignored on a key frame
    parse_proba();
    if (br_.eof()) throw Corrupt("VP8 frame header truncated");
  }

  void parse_segment_header() {
    seg_.use = br_.value(1);
    if (seg_.use) {
      seg_.update_map = br_.value(1);
      if (br_.value(1)) {  // update data
        seg_.absolute_delta = br_.value(1);
        for (int s = 0; s < 4; ++s) seg_.quantizer[s] = br_.value(1) ? br_.signed_value(7) : 0;
        for (int s = 0; s < 4; ++s)
          seg_.filter_strength[s] = br_.value(1) ? br_.signed_value(6) : 0;
      }
      if (seg_.update_map)
        for (int s = 0; s < 3; ++s) seg_.proba[s] = br_.value(1) ? int(br_.value(8)) : 255;
    } else {
      seg_.update_map = false;
    }
  }

  void parse_filter_header() {
    simple_ = br_.value(1);
    level_ = int(br_.value(6));
    sharpness_ = int(br_.value(3));
    use_lf_delta_ = br_.value(1);
    if (use_lf_delta_ && br_.value(1)) {
      for (int i = 0; i < 4; ++i)
        if (br_.value(1)) ref_lf_delta_[i] = br_.signed_value(6);
      for (int i = 0; i < 4; ++i)
        if (br_.value(1)) mode_lf_delta_[i] = br_.signed_value(6);
    }
    filter_type_ = level_ == 0 ? 0 : simple_ ? 1 : 2;
  }

  void parse_partitions(const uint8_t* buf, size_t size) {
    const uint8_t* const end = buf + size;
    num_parts_ = 1 << br_.value(2);
    const size_t last = size_t(num_parts_ - 1);
    if (size < 3 * last) throw Corrupt("VP8 partition sizes truncated");
    const uint8_t* start = buf + 3 * last;
    size_t left = size - 3 * last;
    for (size_t p = 0; p < last; ++p) {
      size_t psize = le24(buf + 3 * p);
      if (psize > left) psize = left;
      parts_[p].init(start, psize);
      start += psize;
      left -= psize;
    }
    parts_[last].init(start, left);
    if (start >= end) throw Corrupt("VP8 token partitions truncated");
  }

  void parse_quant() {
    const int base_q0 = int(br_.value(7));
    int dq[5];  // y1 dc, y2 dc, y2 ac, uv dc, uv ac
    for (int& v : dq) v = br_.value(1) ? br_.signed_value(4) : 0;
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int i = 0; i < 4; ++i) {
      int q;
      if (seg_.use) {
        q = seg_.quantizer[i];
        if (!seg_.absolute_delta) q += base_q0;
      } else {
        if (i > 0) {
          quant_[i] = quant_[0];
          continue;
        }
        q = base_q0;
      }
      Quant& m = quant_[i];
      m.y1[0] = kDcTable[clip(q + dq[0], 127)];
      m.y1[1] = kAcTable[clip(q, 127)];
      m.y2[0] = kDcTable[clip(q + dq[1], 127)] * 2;
      // x * 155 / 100 for x in [0, 284] is (x * 101581) >> 16
      m.y2[1] = (kAcTable[clip(q + dq[2], 127)] * 101581) >> 16;
      if (m.y2[1] < 8) m.y2[1] = 8;
      m.uv[0] = kDcTable[clip(q + dq[3], 117)];
      m.uv[1] = kAcTable[clip(q + dq[4], 127)];
    }
  }

  void parse_proba() {
    for (int t = 0; t < 4; ++t) {
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p)
            bands_[t][b][c][p] = br_.bit(kCoeffsUpdateProba[t][b][c][p])
                                     ? uint8_t(br_.value(8))
                                     : kCoeffsProba0[t][b][c][p];
      for (int n = 0; n < 17; ++n) band_of_[t][n] = &bands_[t][kBands[n]];
    }
    use_skip_proba_ = br_.value(1);
    if (use_skip_proba_) skip_p_ = int(br_.value(8));
  }

  void precompute_filter_strengths() {
    if (filter_type_ == 0) return;
    for (int s = 0; s < 4; ++s) {
      int base = level_;
      if (seg_.use) {
        base = seg_.filter_strength[s];
        if (!seg_.absolute_delta) base += level_;
      }
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        FilterInfo& info = fstrengths_[s][i4x4];
        int level = base;
        if (use_lf_delta_) {
          level += ref_lf_delta_[0];
          if (i4x4) level += mode_lf_delta_[0];
        }
        level = level < 0 ? 0 : level > 63 ? 63 : level;
        if (level > 0) {
          int ilevel = level;
          if (sharpness_ > 0) {
            ilevel >>= sharpness_ > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = ilevel;
          info.limit = 2 * level + ilevel;
          info.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
        } else {
          info.limit = 0;
        }
        info.inner = i4x4;
      }
    }
  }

  void parse_intra_mode(int mb_x, MBData& block) {
    uint8_t* top = intra_t_.data() + 4 * mb_x;
    uint8_t* left = intra_l_;
    if (seg_.update_map) {
      block.segment = !br_.bit(seg_.proba[0]) ? uint8_t(br_.bit(seg_.proba[1]))
                                              : uint8_t(br_.bit(seg_.proba[2]) + 2);
    } else {
      block.segment = 0;
    }
    if (use_skip_proba_) block.skip = br_.bit(skip_p_);
    block.is_i4x4 = !br_.bit(145);
    if (!block.is_i4x4) {
      const int ymode = br_.bit(156) ? (br_.bit(128) ? B_TM : B_HE) : (br_.bit(163) ? B_VE : B_DC);
      block.imodes[0] = uint8_t(ymode);
      memset(top, ymode, 4);
      memset(left, ymode, 4);
    } else {
      uint8_t* modes = block.imodes;
      for (int y = 0; y < 4; ++y) {
        int ymode = left[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* prob = kBModesProba[top[x]][ymode];
          int i = kYModesIntra4[br_.bit(prob[0])];
          while (i > 0) i = kYModesIntra4[2 * i + br_.bit(prob[i])];
          ymode = -i;
          top[x] = uint8_t(ymode);
        }
        memcpy(modes, top, 4);
        modes += 4;
        left[y] = uint8_t(ymode);
      }
    }
    block.uvmode = !br_.bit(142) ? B_DC : !br_.bit(114) ? B_VE : br_.bit(183) ? B_TM : B_HE;
  }

  int large_value(BoolReader& br, const uint8_t* p) {
    int v;
    if (!br.bit(p[3])) {
      v = !br.bit(p[4]) ? 2 : 3 + br.bit(p[5]);
    } else if (!br.bit(p[6])) {
      if (!br.bit(p[7])) {
        v = 5 + br.bit(159);
      } else {
        v = 7 + 2 * br.bit(165);
        v += br.bit(145);
      }
    } else {
      const int bit1 = br.bit(p[8]);
      const int bit0 = br.bit(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.bit(*tab);
      v += 3 + (8 << cat);
    }
    return v;
  }

  // Tokens of one 4x4 block from position n; returns the position after
  // the last token read (16 when the block runs to its end), as libwebp.
  int get_coeffs(BoolReader& br, int type, int ctx, const int* dq, int n, int16_t* out) {
    const uint8_t* p = (*band_of_[type][n])[ctx];
    for (; n < 16; ++n) {
      if (!br.bit(p[0])) return n;  // end of block
      while (!br.bit(p[1])) {       // zeros
        p = (*band_of_[type][++n])[0];
        if (n == 16) return 16;
      }
      const BandProbas& next = *band_of_[type][n + 1];
      int v;
      if (!br.bit(p[2])) {
        v = 1;
        p = next[1];
      } else {
        v = large_value(br, p);
        p = next[2];
      }
      const int s = br.bit(0x80) ? -v : v;
      out[kZigzag[n]] = int16_t(s * dq[n > 0]);
    }
    return 16;
  }

  static uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
    nz_coeffs <<= 2;
    nz_coeffs |= nz > 3 ? 3 : nz > 1 ? 2 : uint32_t(dc_nz);
    return nz_coeffs;
  }

  // Returns whether the macroblock has no non-zero coefficient.
  bool parse_residuals(BoolReader& br, MB& mb, MB& left, MBData& block) {
    const Quant& q = quant_[block.segment];
    int16_t* dst = block.coeffs;
    uint32_t non_zero_y = 0, non_zero_uv = 0;
    int first, ac_type;
    if (!block.is_i4x4) {
      int16_t dc[16] = {0};
      const int ctx = mb.nz_dc + left.nz_dc;
      const int nz = get_coeffs(br, 1, ctx, q.y2, 0, dc);
      mb.nz_dc = left.nz_dc = nz > 0;
      inverse_wht(dc, dst);
      first = 1;
      ac_type = 0;
    } else {
      first = 0;
      ac_type = 3;
    }
    uint8_t tnz = mb.nz & 0x0f;
    uint8_t lnz = left.nz & 0x0f;
    for (int y = 0; y < 4; ++y) {
      int l = lnz & 1;
      uint32_t nz_coeffs = 0;
      for (int x = 0; x < 4; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(br, ac_type, ctx, q.y1, first, dst);
        l = nz > first;
        tnz = uint8_t((tnz >> 1) | (l << 7));
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 4;
      lnz = uint8_t((lnz >> 1) | (l << 7));
      non_zero_y = (non_zero_y << 8) | nz_coeffs;
    }
    uint32_t out_t_nz = tnz;
    uint32_t out_l_nz = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
      uint32_t nz_coeffs = 0;
      tnz = uint8_t(mb.nz >> (4 + ch));
      lnz = uint8_t(left.nz >> (4 + ch));
      for (int y = 0; y < 2; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 2; ++x) {
          const int ctx = l + (tnz & 1);
          const int nz = get_coeffs(br, 2, ctx, q.uv, 0, dst);
          l = nz > 0;
          tnz = uint8_t((tnz >> 1) | (l << 3));
          nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
          dst += 16;
        }
        tnz >>= 2;
        lnz = uint8_t((lnz >> 1) | (l << 5));
      }
      non_zero_uv |= nz_coeffs << (4 * ch);
      out_t_nz |= uint32_t(tnz << 4) << ch;
      out_l_nz |= uint32_t(lnz & 0xf0) << ch;
    }
    mb.nz = uint8_t(out_t_nz);
    left.nz = uint8_t(out_l_nz);
    return !(non_zero_y | non_zero_uv);
  }

  void decode_frame() {
    intra_t_.assign(4 * size_t(mb_w_), B_DC);
    std::vector<MB> mb_info(static_cast<size_t>(mb_w_));
    std::vector<MBData> row(static_cast<size_t>(mb_w_));
    for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
      MB left;
      memset(intra_l_, B_DC, sizeof intra_l_);
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) parse_intra_mode(mb_x, row[size_t(mb_x)]);
      if (br_.eof()) throw Corrupt("VP8 first partition truncated");
      BoolReader& token_br = parts_[mb_y & (num_parts_ - 1)];
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
        MBData& block = row[size_t(mb_x)];
        MB& mb = mb_info[size_t(mb_x)];
        memset(block.coeffs, 0, sizeof block.coeffs);
        bool skip = use_skip_proba_ ? block.skip : false;
        if (!skip) {
          skip = parse_residuals(token_br, mb, left, block);
        } else {
          left.nz = mb.nz = 0;
          if (!block.is_i4x4) left.nz_dc = mb.nz_dc = 0;
        }
        if (filter_type_ > 0) {
          FilterInfo& f = finfo_[size_t(mb_y) * mb_w_ + mb_x];
          f = fstrengths_[block.segment][block.is_i4x4];
          f.inner = f.inner || !skip;
        }
        if (token_br.eof()) throw Corrupt("VP8 token partition truncated");
        reconstruct(mb_x, mb_y, block);
      }
    }
  }

  // Prediction and residuals of one macroblock, in a workspace holding the
  // unfiltered row above and column to the left (127 above the frame, 129
  // left of it), as libwebp's.
  void reconstruct(int mb_x, int mb_y, const MBData& block) {
    uint8_t ws_y[BPS * 17], ws_u[BPS * 9], ws_v[BPS * 9];
    uint8_t* const yd = ws_y + BPS + 8;
    uint8_t* const ud = ws_u + BPS + 8;
    uint8_t* const vd = ws_v + BPS + 8;
    const int x0 = 16 * mb_x, y0 = 16 * mb_y, cx0 = 8 * mb_x, cy0 = 8 * mb_y;
    for (int j = 0; j < 16; ++j)
      yd[j * BPS - 1] = mb_x > 0 ? y_[size_t(y0 + j) * ys_ + x0 - 1] : 129;
    for (int j = 0; j < 8; ++j) {
      ud[j * BPS - 1] = mb_x > 0 ? u_[size_t(cy0 + j) * uvs_ + cx0 - 1] : 129;
      vd[j * BPS - 1] = mb_x > 0 ? v_[size_t(cy0 + j) * uvs_ + cx0 - 1] : 129;
    }
    if (mb_y == 0) {
      memset(yd - BPS - 1, 127, 16 + 4 + 1);
      memset(ud - BPS - 1, 127, 8 + 1);
      memset(vd - BPS - 1, 127, 8 + 1);
    } else {
      const uint8_t* ya = &y_[size_t(y0 - 1) * ys_];
      const uint8_t* ua = &u_[size_t(cy0 - 1) * uvs_];
      const uint8_t* va = &v_[size_t(cy0 - 1) * uvs_];
      yd[-BPS - 1] = mb_x > 0 ? ya[x0 - 1] : 129;
      ud[-BPS - 1] = mb_x > 0 ? ua[cx0 - 1] : 129;
      vd[-BPS - 1] = mb_x > 0 ? va[cx0 - 1] : 129;
      memcpy(yd - BPS, ya + x0, 16);
      memcpy(ud - BPS, ua + cx0, 8);
      memcpy(vd - BPS, va + cx0, 8);
      if (mb_x < mb_w_ - 1)
        memcpy(yd - BPS + 16, ya + x0 + 16, 4);
      else
        memset(yd - BPS + 16, ya[x0 + 15], 4);
    }
    const int16_t* coeffs = block.coeffs;
    if (block.is_i4x4) {
      // the 4x4 blocks of the right column take the macroblock's top-right
      // pixels as theirs
      for (int r = 3; r < 12; r += 4) memcpy(yd + r * BPS + 16, yd - BPS + 16, 4);
      for (int n = 0; n < 16; ++n) {
        uint8_t* dst = yd + (n & 3) * 4 + (n >> 2) * 4 * BPS;
        predict4(dst, block.imodes[n]);
        inverse_dct_add(coeffs + 16 * n, dst);
      }
    } else {
      predict_block(yd, 16, block.imodes[0], mb_y > 0, mb_x > 0);
      for (int n = 0; n < 16; ++n)
        inverse_dct_add(coeffs + 16 * n, yd + (n & 3) * 4 + (n >> 2) * 4 * BPS);
    }
    predict_block(ud, 8, block.uvmode, mb_y > 0, mb_x > 0);
    predict_block(vd, 8, block.uvmode, mb_y > 0, mb_x > 0);
    for (int n = 0; n < 4; ++n) {
      const int off = (n & 1) * 4 + (n >> 1) * 4 * BPS;
      inverse_dct_add(coeffs + 256 + 16 * n, ud + off);
      inverse_dct_add(coeffs + 320 + 16 * n, vd + off);
    }
    for (int j = 0; j < 16; ++j) memcpy(&y_[size_t(y0 + j) * ys_ + x0], yd + j * BPS, 16);
    for (int j = 0; j < 8; ++j) {
      memcpy(&u_[size_t(cy0 + j) * uvs_ + cx0], ud + j * BPS, 8);
      memcpy(&v_[size_t(cy0 + j) * uvs_ + cx0], vd + j * BPS, 8);
    }
  }

  // The loop filter over the reconstructed frame, macroblock by
  // macroblock in raster order: left edge, inner vertical edges, top edge,
  // inner horizontal edges.
  void filter_frame() {
    for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
        const FilterInfo& f = finfo_[size_t(mb_y) * mb_w_ + mb_x];
        const int limit = f.limit;
        if (limit == 0) continue;
        uint8_t* yp = &y_[size_t(16 * mb_y) * ys_ + 16 * mb_x];
        const int ys = ys_;
        if (filter_type_ == 1) {
          if (mb_x > 0) simple_edge(yp, 1, ys, limit + 4);
          if (f.inner)
            for (int k = 4; k < 16; k += 4) simple_edge(yp + k, 1, ys, limit);
          if (mb_y > 0) simple_edge(yp, ys, 1, limit + 4);
          if (f.inner)
            for (int k = 4; k < 16; k += 4) simple_edge(yp + k * ys, ys, 1, limit);
          continue;
        }
        uint8_t* up = &u_[size_t(8 * mb_y) * uvs_ + 8 * mb_x];
        uint8_t* vp = &v_[size_t(8 * mb_y) * uvs_ + 8 * mb_x];
        const int cs = uvs_, il = f.ilevel, ht = f.hev_thresh;
        if (mb_x > 0) {
          normal_edge(yp, 1, ys, 16, limit + 4, il, ht, true);
          normal_edge(up, 1, cs, 8, limit + 4, il, ht, true);
          normal_edge(vp, 1, cs, 8, limit + 4, il, ht, true);
        }
        if (f.inner) {
          for (int k = 4; k < 16; k += 4) normal_edge(yp + k, 1, ys, 16, limit, il, ht, false);
          normal_edge(up + 4, 1, cs, 8, limit, il, ht, false);
          normal_edge(vp + 4, 1, cs, 8, limit, il, ht, false);
        }
        if (mb_y > 0) {
          normal_edge(yp, ys, 1, 16, limit + 4, il, ht, true);
          normal_edge(up, cs, 1, 8, limit + 4, il, ht, true);
          normal_edge(vp, cs, 1, 8, limit + 4, il, ht, true);
        }
        if (f.inner) {
          for (int k = 4; k < 16; k += 4)
            normal_edge(yp + k * ys, ys, 1, 16, limit, il, ht, false);
          normal_edge(up + 4 * cs, cs, 1, 8, limit, il, ht, false);
          normal_edge(vp + 4 * cs, cs, 1, 8, limit, il, ht, false);
        }
      }
    }
  }

  // libwebp's YUV -> RGB: 14-bit fixed-point factors, results in 6 bits
  // of fraction.
  static int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
  static uint8_t clip_yuv(int v) {
    return uint8_t((v & ~16383) == 0 ? (v >> 6) : v < 0 ? 0 : 255);
  }
  static void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
    rgb[0] = clip_yuv(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
    rgb[1] = clip_yuv(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
    rgb[2] = clip_yuv(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
  }

  // libwebp's fancy upsampler for one pair of output rows (or one row when
  // bot_y is null): chroma of the rows above (tu, tv) and below (cu, cv)
  // the pair, weighted 9-3-3-1.
  void upsample_pair(const uint8_t* top_y, const uint8_t* bot_y, const uint8_t* tu,
                     const uint8_t* tv, const uint8_t* cu, const uint8_t* cv, uint8_t* top_dst,
                     uint8_t* bot_dst, int len) const {
    const int last_pair = (len - 1) >> 1;
    int tl_u = tu[0], tl_v = tv[0], l_u = cu[0], l_v = cv[0];
    yuv_to_rgb(top_y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, top_dst);
    if (bot_y)
      yuv_to_rgb(bot_y[0], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2, bot_dst);
    for (int x = 1; x <= last_pair; ++x) {
      const int t_u = tu[x], t_v = tv[x], c_u = cu[x], c_v = cv[x];
      const int avg_u = tl_u + t_u + l_u + c_u + 8, avg_v = tl_v + t_v + l_v + c_v + 8;
      const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3, d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
      const int d03_u = (avg_u + 2 * (tl_u + c_u)) >> 3, d03_v = (avg_v + 2 * (tl_v + c_v)) >> 3;
      yuv_to_rgb(top_y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1,
                 top_dst + 3 * (2 * x - 1));
      yuv_to_rgb(top_y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1, top_dst + 3 * (2 * x));
      if (bot_y) {
        yuv_to_rgb(bot_y[2 * x - 1], (d03_u + l_u) >> 1, (d03_v + l_v) >> 1,
                   bot_dst + 3 * (2 * x - 1));
        yuv_to_rgb(bot_y[2 * x], (d12_u + c_u) >> 1, (d12_v + c_v) >> 1, bot_dst + 3 * (2 * x));
      }
      tl_u = t_u;
      tl_v = t_v;
      l_u = c_u;
      l_v = c_v;
    }
    if (!(len & 1)) {
      yuv_to_rgb(top_y[len - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2,
                 top_dst + 3 * (len - 1));
      if (bot_y)
        yuv_to_rgb(bot_y[len - 1], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2,
                   bot_dst + 3 * (len - 1));
    }
  }

  void to_rgb(uint8_t* rgb) const {
    const int w = width_, h = height_;
    auto yrow = [&](int y) { return &y_[size_t(y) * ys_]; };
    auto urow = [&](int y) { return &u_[size_t(y) * uvs_]; };
    auto vrow = [&](int y) { return &v_[size_t(y) * uvs_]; };
    auto out = [&](int y) { return rgb + size_t(y) * w * 3; };
    upsample_pair(yrow(0), nullptr, urow(0), vrow(0), urow(0), vrow(0), out(0), nullptr, w);
    int y = 1;
    for (; y + 1 < h; y += 2) {
      const int t = (y - 1) >> 1, c = (y + 1) >> 1;
      upsample_pair(yrow(y), yrow(y + 1), urow(t), vrow(t), urow(c), vrow(c), out(y),
                    out(y + 1), w);
    }
    if (!(h & 1)) {
      const int c = (h >> 1) - 1;
      upsample_pair(yrow(h - 1), nullptr, urow(c), vrow(c), urow(c), vrow(c), out(h - 1),
                    nullptr, w);
    }
  }

  const uint8_t* d_;
  size_t n_;
  uint32_t part0_size_ = 0;
  int width_ = 0, height_ = 0, mb_w_ = 0, mb_h_ = 0, ys_ = 0, uvs_ = 0;
  BoolReader br_;
  BoolReader parts_[8];
  int num_parts_ = 1;
  Segments seg_;
  bool simple_ = false, use_lf_delta_ = false, use_skip_proba_ = false;
  int level_ = 0, sharpness_ = 0, filter_type_ = 0, skip_p_ = 0;
  int ref_lf_delta_[4] = {0, 0, 0, 0}, mode_lf_delta_[4] = {0, 0, 0, 0};
  Quant quant_[4];
  BandProbas bands_[4][8];
  const BandProbas* band_of_[4][17];
  FilterInfo fstrengths_[4][2];
  std::vector<uint8_t> intra_t_;
  uint8_t intra_l_[4];
  std::vector<uint8_t> y_, u_, v_;
  std::vector<FilterInfo> finfo_;
};

// ======================================================== VP8L decoder
// LSB-first bit reader: past the end it reads zeros, and eos() says that
// more bits were consumed than the data holds (libwebp's end-of-stream:
// its 64-bit window makes that at least 64 bits).
class LBitReader {
 public:
  LBitReader(const uint8_t* d, size_t n) : d_(d), n_(n) {}

  uint32_t peek(int nbits) const {
    return uint32_t(window() & ((uint64_t(1) << nbits) - 1));
  }
  void skip(int nbits) { pos_ += uint64_t(nbits); }
  uint32_t read(int nbits) {
    const uint32_t v = peek(nbits);
    pos_ += uint64_t(nbits);
    return v;
  }
  bool eos() const { return pos_ > std::max<uint64_t>(8 * uint64_t(n_), 64); }

 private:
  uint64_t window() const {
    const uint64_t byte = pos_ >> 3;
    uint64_t v = 0;
    for (uint64_t i = 0; i < 8 && byte + i < n_; ++i) v |= uint64_t(d_[byte + i]) << (8 * i);
    return v >> (pos_ & 7);
  }

  const uint8_t* d_;
  size_t n_;
  uint64_t pos_ = 0;
};

// A canonical prefix code: a root table of up to 8 bits, codes longer
// than that decoded bit by bit; one used symbol makes a code of no bits.
class PrefixCode {
 public:
  // False when the lengths make no code libwebp accepts.
  bool build(const std::vector<int>& lengths) {
    const int n = int(lengths.size());
    int count[16] = {0};
    for (int len : lengths) ++count[len];
    if (count[0] == n) return false;
    int short_codes = 0;
    for (int len = 1; len < 15; ++len) short_codes += count[len];
    if (short_codes == 1) {  // libwebp's one-symbol code
      for (int s = 0; s < n; ++s)
        if (lengths[size_t(s)] > 0 && lengths[size_t(s)] < 15) single_ = s;
      root_bits_ = 0;
      return true;
    }
    uint32_t kraft = 0;
    for (int len = 1; len <= 15; ++len) kraft += uint32_t(count[len]) << (15 - len);
    if (kraft != 1u << 15) return false;
    int max_len = 0;
    for (int len = 1; len <= 15; ++len) {
      count_[len] = uint16_t(count[len]);
      if (count[len]) max_len = len;
    }
    sorted_.clear();
    for (int len = 1; len <= 15; ++len)
      for (int s = 0; s < n; ++s)
        if (lengths[size_t(s)] == len) sorted_.push_back(uint16_t(s));
    root_bits_ = std::min(max_len, 8);
    table_.assign(size_t(1) << root_bits_, 0);
    uint32_t code = 0;
    size_t k = 0;
    for (int len = 1; len <= 15; ++len, code <<= 1) {
      for (int i = 0; i < count[len]; ++i, ++code, ++k) {
        if (len > root_bits_) continue;
        uint32_t rev = 0;
        for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1) << (len - 1 - b);
        for (uint32_t idx = rev; idx < table_.size(); idx += 1u << len)
          table_[idx] = (uint32_t(len) << 16) | sorted_[k];
      }
    }
    return true;
  }

  int read(LBitReader& br) const {
    if (root_bits_ == 0) return single_;
    const uint32_t e = table_[br.peek(root_bits_)];
    if (e >> 16) {
      br.skip(int(e >> 16));
      return int(e & 0xffff);
    }
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= 15; ++len) {
      code |= int(br.read(1));
      const int cnt = count_[len];
      if (code - first < cnt) return sorted_[size_t(index + code - first)];
      index += cnt;
      first = (first + cnt) << 1;
      code <<= 1;
    }
    throw Corrupt("VP8L prefix code out of range");
  }

 private:
  int root_bits_ = 0, single_ = 0;
  uint16_t count_[16] = {0};
  std::vector<uint32_t> table_;
  std::vector<uint16_t> sorted_;
};

const int kAlphabetSize[5] = {256 + 24, 256, 256, 256, 40};
const uint8_t kCodeLengthCodeOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                          7, 8, 9, 10, 11, 12, 13, 14, 15};

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}
inline int clip255(int a) { return a < 0 ? 0 : a > 255 ? 255 : a; }
inline int channel(uint32_t p, int shift) { return int((p >> shift) & 0xff); }

uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {  // a = T, b = L, c = TL
  int pa_minus_pb = 0;
  for (int s = 0; s < 32; s += 8) {
    const int pb = channel(b, s) - channel(c, s), pa = channel(a, s) - channel(c, s);
    pa_minus_pb += std::abs(pb) - std::abs(pa);
  }
  return pa_minus_pb <= 0 ? a : b;
}
uint32_t clamped_add_subtract_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8)
    out |= uint32_t(clip255(channel(c0, s) + channel(c1, s) - channel(c2, s))) << s;
  return out;
}
uint32_t clamped_add_subtract_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = channel(ave, s), b = channel(c2, s);
    out |= uint32_t(clip255(a + (a - b) / 2)) << s;
  }
  return out;
}

// The 14 predictors of the VP8L predictor transform (14 and 15 as 0):
// left L, top row t (t[0] above, t[-1] above-left, t[1] above-right).
uint32_t predict(int mode, uint32_t L, const uint32_t* t) {
  switch (mode) {
    case 1: return L;
    case 2: return t[0];
    case 3: return t[1];
    case 4: return t[-1];
    case 5: return average2(average2(L, t[1]), t[0]);
    case 6: return average2(L, t[-1]);
    case 7: return average2(L, t[0]);
    case 8: return average2(t[-1], t[0]);
    case 9: return average2(t[0], t[1]);
    case 10: return average2(average2(L, t[-1]), average2(t[0], t[1]));
    case 11: return select_pred(t[0], L, t[-1]);
    case 12: return clamped_add_subtract_full(L, t[0], t[-1]);
    case 13: return clamped_add_subtract_half(L, t[0], t[-1]);
    default: return 0xff000000u;
  }
}

class Vp8lDecoder {
 public:
  // data: the payload of a "VP8L" chunk, with its pad byte.
  Vp8lDecoder(const uint8_t* data, size_t size) : br_(data, size) {
    if (size < 5 || data[0] != 0x2f) throw Corrupt("VP8L signature missing");
    br_.read(8);
    width_ = int(br_.read(14)) + 1;
    height_ = int(br_.read(14)) + 1;
    br_.read(1);  // alpha hint
    if (br_.read(3) != 0) throw Corrupt("VP8L version is not 0");
  }

  int width() const { return width_; }
  int height() const { return height_; }

  void decode(uint8_t* rgb) {
    int xsize = width_;
    while (br_.read(1)) read_transform(&xsize);
    std::vector<uint32_t> argb = decode_image_stream(xsize, height_, true);
    for (size_t i = transforms_.size(); i-- > 0;) argb = inverse_transform(transforms_[i], argb);
    const size_t n = size_t(width_) * height_;
    for (size_t i = 0; i < n; ++i) {
      rgb[3 * i + 0] = uint8_t(argb[i] >> 16);
      rgb[3 * i + 1] = uint8_t(argb[i] >> 8);
      rgb[3 * i + 2] = uint8_t(argb[i]);
    }
  }

 private:
  struct Transform {
    int type = 0, bits = 0, xsize = 0, ysize = 0;
    std::vector<uint32_t> data;
  };
  struct Group {
    PrefixCode codes[5];  // green + lengths + cache, red, blue, alpha, distance
  };
  enum { PREDICTOR = 0, CROSS_COLOR = 1, SUBTRACT_GREEN = 2, COLOR_INDEXING = 3 };

  void check_eos() {
    if (br_.eos()) throw Corrupt("VP8L data truncated");
  }

  void read_transform(int* xsize) {
    Transform t;
    t.type = int(br_.read(2));
    if (seen_ & (1u << t.type)) throw Corrupt("VP8L transform repeated");
    seen_ |= 1u << t.type;
    t.xsize = *xsize;
    t.ysize = height_;
    if (t.type == PREDICTOR || t.type == CROSS_COLOR) {
      t.bits = int(br_.read(3)) + 2;
      t.data = decode_image_stream(subsample(t.xsize, t.bits), subsample(t.ysize, t.bits), false);
    } else if (t.type == COLOR_INDEXING) {
      const int num_colors = int(br_.read(8)) + 1;
      t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
      *xsize = subsample(t.xsize, t.bits);
      const std::vector<uint32_t> deltas = decode_image_stream(num_colors, 1, false);
      t.data.assign(size_t(1) << (8 >> t.bits), 0);  // missing entries: transparent black
      t.data[0] = deltas[0];
      for (size_t i = 1; i < size_t(num_colors); ++i)
        t.data[i] = add_pixels(deltas[i], t.data[i - 1]);
    }
    transforms_.push_back(std::move(t));
  }

  void read_code_lengths(const std::vector<int>& cl_lengths, std::vector<int>& lengths) {
    PrefixCode cl;
    if (!cl.build(cl_lengths)) throw Corrupt("VP8L code length code invalid");
    const int num_symbols = int(lengths.size());
    int max_symbol = num_symbols;
    if (br_.read(1)) {
      const int length_nbits = 2 + 2 * int(br_.read(3));
      max_symbol = 2 + int(br_.read(length_nbits));
      if (max_symbol > num_symbols) throw Corrupt("VP8L code length count too large");
    }
    int symbol = 0, prev = 8;
    while (symbol < num_symbols) {
      if (max_symbol-- == 0) break;
      const int code_len = cl.read(br_);
      if (code_len < 16) {
        lengths[size_t(symbol++)] = code_len;
        if (code_len != 0) prev = code_len;
      } else {
        static const int kExtraBits[3] = {2, 3, 7}, kOffsets[3] = {3, 3, 11};
        const int slot = code_len - 16;
        const int repeat = int(br_.read(kExtraBits[slot])) + kOffsets[slot];
        if (symbol + repeat > num_symbols) throw Corrupt("VP8L code length repeat too long");
        const int len = code_len == 16 ? prev : 0;
        for (int i = 0; i < repeat; ++i) lengths[size_t(symbol++)] = len;
      }
    }
  }

  void read_code(int alphabet_size, PrefixCode& code) {
    std::vector<int> lengths(size_t(alphabet_size), 0);
    if (br_.read(1)) {  // simple code: one or two symbols
      const int num_symbols = int(br_.read(1)) + 1;
      const int first_bits = br_.read(1) ? 8 : 1;
      int s = int(br_.read(first_bits));
      if (s < alphabet_size) lengths[size_t(s)] = 1;
      if (num_symbols == 2) {
        s = int(br_.read(8));
        if (s < alphabet_size) lengths[size_t(s)] = 1;
      }
    } else {
      std::vector<int> cl_lengths(19, 0);
      const int num_codes = int(br_.read(4)) + 4;
      for (int i = 0; i < num_codes; ++i) cl_lengths[kCodeLengthCodeOrder[i]] = int(br_.read(3));
      read_code_lengths(cl_lengths, lengths);
    }
    check_eos();
    if (!code.build(lengths)) throw Corrupt("VP8L prefix code invalid");
  }

  static int copy_value(int symbol, LBitReader& br) {  // lengths and distances
    if (symbol < 4) return symbol + 1;
    const int extra = (symbol - 2) >> 1;
    const int offset = (2 + (symbol & 1)) << extra;
    return offset + int(br.read(extra)) + 1;
  }

  static int plane_code_to_distance(int xsize, int code) {
    if (code > 120) return code - 120;
    const int v = kCodeToPlane[code - 1];
    const int dist = (v >> 4) * xsize + (8 - (v & 0xf));
    return dist >= 1 ? dist : 1;
  }

  // One entropy-coded image: the main image (level 0, which may carry a
  // meta prefix image) or a transform's or the meta codes' sub-image.
  std::vector<uint32_t> decode_image_stream(int xsize, int ysize, bool level0) {
    int cache_bits = 0;
    if (br_.read(1)) {
      cache_bits = int(br_.read(4));
      if (cache_bits < 1 || cache_bits > 11) throw Corrupt("VP8L colour cache size invalid");
    }
    int huff_bits = 0, huff_xsize = 0, num_groups = 1;
    std::vector<uint32_t> huff_image;
    if (level0 && br_.read(1)) {
      huff_bits = 2 + int(br_.read(3));
      huff_xsize = subsample(xsize, huff_bits);
      huff_image = decode_image_stream(huff_xsize, subsample(ysize, huff_bits), false);
      for (uint32_t& p : huff_image) {
        p = (p >> 8) & 0xffff;
        num_groups = std::max(num_groups, int(p) + 1);
      }
    }
    check_eos();
    // Every group's codes are read and checked; only those the meta image
    // uses are kept.
    std::vector<int> slot(size_t(num_groups), -1);
    if (huff_image.empty()) slot[0] = 0;
    int kept = huff_image.empty() ? 1 : 0;
    for (uint32_t p : huff_image)
      if (slot[p] < 0) slot[p] = kept++;
    std::vector<Group> groups(static_cast<size_t>(kept));
    Group scratch;
    const int cache_size = cache_bits ? 1 << cache_bits : 0;
    for (int g = 0; g < num_groups; ++g) {
      Group& grp = slot[size_t(g)] >= 0 ? groups[size_t(slot[size_t(g)])] : scratch;
      for (int j = 0; j < 5; ++j)
        read_code(kAlphabetSize[j] + (j == 0 ? cache_size : 0), grp.codes[j]);
    }

    std::vector<uint32_t> data(size_t(xsize) * ysize);
    std::vector<uint32_t> cache(size_t(cache_size), 0);
    const int hash_shift = 32 - cache_bits;
    auto insert = [&](uint32_t argb) {
      if (cache_size) cache[(argb * 0x1e35a7bdu) >> hash_shift] = argb;
    };
    const size_t total = data.size();
    size_t pos = 0;
    int x = 0, y = 0;
    while (pos < total) {
      const Group& grp =
          huff_bits ? groups[size_t(slot[huff_image[size_t(y >> huff_bits) * huff_xsize +
                                                     (x >> huff_bits)]])]
                    : groups[0];
      const int code = grp.codes[0].read(br_);
      if (code < 256) {
        const int red = grp.codes[1].read(br_);
        const int blue = grp.codes[2].read(br_);
        const int alpha = grp.codes[3].read(br_);
        data[pos] = (uint32_t(alpha) << 24) | (uint32_t(red) << 16) | (uint32_t(code) << 8) |
                    uint32_t(blue);
      } else if (code < 256 + 24) {
        const int length = copy_value(code - 256, br_);
        const int dist_symbol = grp.codes[4].read(br_);
        const int dist = plane_code_to_distance(xsize, copy_value(dist_symbol, br_));
        check_eos();
        if (pos < size_t(dist) || total - pos < size_t(length))
          throw Corrupt("VP8L back-reference out of the image");
        for (int i = 0; i < length; ++i, ++pos) {
          data[pos] = data[pos - size_t(dist)];
          insert(data[pos]);
        }
        x += length;
        while (x >= xsize) {
          x -= xsize;
          ++y;
        }
        continue;
      } else if (code < 256 + 24 + cache_size) {
        data[pos] = cache[size_t(code - 256 - 24)];
      } else {
        throw Corrupt("VP8L symbol out of range");
      }
      insert(data[pos]);
      ++pos;
      if (++x >= xsize) {
        x = 0;
        ++y;
        check_eos();
      }
    }
    check_eos();
    return data;
  }

  std::vector<uint32_t> inverse_transform(const Transform& t, const std::vector<uint32_t>& in) {
    const int w = t.xsize, h = t.ysize;
    std::vector<uint32_t> out(size_t(w) * h);
    if (t.type == SUBTRACT_GREEN) {
      for (size_t i = 0; i < out.size(); ++i) {
        const uint32_t p = in[i], g = (p >> 8) & 0xff;
        const uint32_t rb = ((((p >> 16) & 0xff) + g) & 0xff) << 16 | (((p & 0xff) + g) & 0xff);
        out[i] = (p & 0xff00ff00u) | rb;
      }
    } else if (t.type == PREDICTOR) {
      const int tiles_per_row = subsample(w, t.bits);
      out[0] = add_pixels(in[0], 0xff000000u);
      for (int x = 1; x < w; ++x) out[size_t(x)] = add_pixels(in[size_t(x)], out[size_t(x) - 1]);
      for (int y = 1; y < h; ++y) {
        uint32_t* row = &out[size_t(y) * w];
        const uint32_t* top = row - w;
        const uint32_t* res = &in[size_t(y) * w];
        const uint32_t* modes = &t.data[size_t(y >> t.bits) * tiles_per_row];
        row[0] = add_pixels(res[0], top[0]);
        for (int x = 1; x < w; ++x) {
          const int mode = int((modes[x >> t.bits] >> 8) & 0xf);
          row[x] = add_pixels(res[x], predict(mode, row[x - 1], top + x));
        }
      }
    } else if (t.type == CROSS_COLOR) {
      const int tiles_per_row = subsample(w, t.bits);
      for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
          const uint32_t m = t.data[size_t(y >> t.bits) * tiles_per_row + (x >> t.bits)];
          const int8_t g2r = int8_t(m & 0xff), g2b = int8_t((m >> 8) & 0xff);
          const int8_t r2b = int8_t((m >> 16) & 0xff);
          const uint32_t p = in[size_t(y) * w + x];
          const int8_t green = int8_t((p >> 8) & 0xff);
          int new_red = int((p >> 16) & 0xff);
          int new_blue = int(p & 0xff);
          new_red += (int(g2r) * green) >> 5;
          new_red &= 0xff;
          new_blue += (int(g2b) * green) >> 5;
          new_blue += (int(r2b) * int8_t(new_red)) >> 5;
          new_blue &= 0xff;
          out[size_t(y) * w + x] =
              (p & 0xff00ff00u) | (uint32_t(new_red) << 16) | uint32_t(new_blue);
        }
      }
    } else {  // COLOR_INDEXING
      const int in_w = subsample(w, t.bits);
      const int bits_per_pixel = 8 >> t.bits;
      const int count_mask = (1 << t.bits) - 1;
      const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
      for (int y = 0; y < h; ++y) {
        const uint32_t* src = &in[size_t(y) * in_w];
        uint32_t* dst = &out[size_t(y) * w];
        uint32_t packed = 0;
        for (int x = 0; x < w; ++x) {
          if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
          dst[x] = t.data[packed & bit_mask];
          packed >>= bits_per_pixel;
        }
      }
    }
    return out;
  }

  LBitReader br_;
  int width_ = 0, height_ = 0;
  unsigned seen_ = 0;
  std::vector<Transform> transforms_;
};

// ============================================================ container
// A frame's bitstream: the payload of a "VP8 " or "VP8L" chunk.
struct Bitstream {
  const uint8_t* data = nullptr;
  size_t size = 0;        // the payload with its pad byte, as libwebp's demuxer passes it
  size_t chunk_size = 0;  // the payload's declared size
  bool lossless = false;
  const uint8_t* alpha = nullptr;  // the ALPH payload before a lossy bitstream
  size_t alpha_size = 0;
};

// The image PIL decodes: a still image (the canvas), or the first frame of
// an animation at its offset on the canvas.
struct Image {
  Bitstream frame;
  bool extended = false, animated = false;
  int canvas_w = 0, canvas_h = 0;
  int x = 0, y = 0;  // the frame's offset on an animation's canvas
};

constexpr uint8_t kAnimationFlag = 0x02, kValidFlags = 0x3E;  // alpha, animation, EXIF, ICCP, XMP
constexpr uint64_t kMaxImageArea = uint64_t(1) << 32;

// The frame header the demuxer checks (WebPGetFeatures): its size.
void bitstream_size(const Bitstream& b, int* w, int* h) {
  if (b.lossless) {
    Vp8lDecoder dec(b.data, b.size);
    *w = dec.width();
    *h = dec.height();
  } else {
    Vp8Decoder dec(b.data, b.size, b.chunk_size);
    *w = dec.width();
    *h = dec.height();
  }
}

// An ANMF frame's chunks from ``pos`` to ``end``: ALPH (lossy only), then
// the bitstream, then chunks that are skipped (not another image).
Bitstream parse_frame(const uint8_t* d, size_t pos, size_t end) {
  Bitstream b;
  while (pos < end) {
    if (end - pos < 8) throw Corrupt("ANMF frame truncated");
    const uint8_t* tag = d + pos;
    const uint32_t csize = le32(d + pos + 4);
    const size_t padded = size_t(csize) + (csize & 1);
    if (padded > end - pos - 8) throw Corrupt("chunk overruns its ANMF frame");
    const uint8_t* payload = d + pos + 8;
    const bool image = !memcmp(tag, "VP8 ", 4) || !memcmp(tag, "VP8L", 4);
    if (b.data) {
      if (image || !memcmp(tag, "ALPH", 4) || !memcmp(tag, "ANMF", 4) || !memcmp(tag, "VP8X", 4))
        throw Corrupt("a second image in an ANMF frame");
    } else if (!memcmp(tag, "ALPH", 4)) {
      if (b.alpha) throw Corrupt("two ALPH chunks in an ANMF frame");
      b.alpha = payload;
      b.alpha_size = csize;
    } else if (image) {
      b.data = payload;
      b.size = padded;
      b.chunk_size = csize;
      b.lossless = tag[3] == 'L';
      if (b.lossless && b.alpha) throw Corrupt("ALPH chunk before a VP8L image");
    } else {
      throw Corrupt("ANMF frame without an image chunk first");
    }
    pos += 8 + padded;
  }
  if (!b.data) throw Corrupt("ANMF frame without an image chunk");
  return b;
}

Image parse_container(const uint8_t* d, size_t n) {
  if (n < 12 || memcmp(d, "RIFF", 4) != 0 || memcmp(d + 8, "WEBP", 4) != 0)
    throw Corrupt("not a RIFF WEBP file");
  const uint32_t riff_size = le32(d + 4);
  if (riff_size < 12) throw Corrupt("RIFF size too small");
  if (riff_size > n - 8) throw Corrupt("file truncated (shorter than its RIFF size)");
  const size_t end = 8 + size_t(riff_size);
  Image img;
  Bitstream& still = img.frame;
  bool anim_seen = false, have_frame = false;
  size_t pos = 12;
  for (bool first = true;; first = false) {
    if (img.animated && pos == end) break;
    if (end - pos < 8) throw Corrupt("file truncated before its image chunk");
    const uint8_t* tag = d + pos;
    const uint32_t csize = le32(d + pos + 4);
    if (csize > end - pos - 8) throw Corrupt("chunk truncated");
    const uint8_t* payload = d + pos + 8;
    const size_t padded = size_t(csize) + (csize & 1);
    if (!memcmp(tag, "VP8 ", 4) || !memcmp(tag, "VP8L", 4)) {
      if (img.animated) throw Corrupt("an image chunk outside ANMF in an animated WebP");
      still.data = payload;
      still.chunk_size = csize;
      still.size = std::min<size_t>(padded, end - pos - 8);
      still.lossless = tag[3] == 'L';
      if (still.lossless && still.alpha) throw Corrupt("ALPH chunk before a VP8L image");
      return img;
    }
    if (first && !memcmp(tag, "VP8X", 4)) {
      if (csize < 10) throw Corrupt("VP8X chunk too small");
      if (payload[0] & ~kValidFlags) throw Corrupt("VP8X flags invalid");
      img.extended = true;
      img.animated = payload[0] & kAnimationFlag;
      img.canvas_w = int(le24(payload + 4)) + 1;
      img.canvas_h = int(le24(payload + 7)) + 1;
      if (uint64_t(img.canvas_w) * uint64_t(img.canvas_h) >= kMaxImageArea)
        throw Corrupt("VP8X canvas too large");
    } else if (!img.extended) {
      throw Corrupt("simple WebP file without VP8 or VP8L chunk first");
    } else if (!memcmp(tag, "ANIM", 4) || !memcmp(tag, "ANMF", 4)) {
      if (!img.animated) throw Corrupt("ANIM or ANMF chunk without the VP8X animation flag");
      if (padded > end - pos - 8) throw Corrupt("chunk truncated");
      if (tag[1] == 'N' && tag[2] == 'I') {
        if (padded < 6) throw Corrupt("ANIM chunk too small");
        anim_seen = true;
      } else {
        // ANMF: x / 2, y / 2, width - 1, height - 1 (24 bits each), duration, flags
        if (!anim_seen) throw Corrupt("ANMF chunk before ANIM");
        if (padded < 16) throw Corrupt("ANMF chunk too small");
        const int x = 2 * int(le24(payload)), y = 2 * int(le24(payload + 3));
        if (uint64_t(le24(payload + 6) + 1) * uint64_t(le24(payload + 9) + 1) >= kMaxImageArea)
          throw Corrupt("ANMF frame too large");
        const Bitstream frame = parse_frame(d, pos + 8 + 16, pos + 8 + padded);
        int w, h;  // the bitstream's size, which the demuxer takes over the ANMF's
        bitstream_size(frame, &w, &h);
        if (x + w > img.canvas_w || y + h > img.canvas_h)
          throw Corrupt("ANMF frame outside the canvas");
        if (!have_frame) {
          have_frame = true;
          still = frame;
          img.x = x;
          img.y = y;
        }
      }
    } else if (img.animated && !memcmp(tag, "ALPH", 4)) {
      throw Corrupt("an image chunk outside ANMF in an animated WebP");
    } else if (!memcmp(tag, "VP8X", 4)) {
      throw Corrupt("a second VP8X chunk");
    } else if (!memcmp(tag, "ALPH", 4) && !still.alpha) {
      still.alpha = payload;
      still.alpha_size = csize;
    }  // ICCP, EXIF, XMP and unknown chunks are skipped
    pos += 8 + padded;
    if (pos > end) throw Corrupt("file truncated before its image chunk");
  }
  if (!have_frame) throw Corrupt("animated WebP without frames");
  return img;
}

// The header of an ALPH chunk (its alpha is not decoded: the RGB does not
// depend on it).
void check_alpha(const Bitstream& b, int w, int h) {
  if (b.alpha_size < 1) throw Corrupt("ALPH chunk empty");
  const int v = b.alpha[0];
  const int method = v & 3, pre = (v >> 4) & 3, reserved = (v >> 6) & 3;
  if (method > 1 || pre > 1 || reserved != 0) throw Corrupt("ALPH header invalid");
  if (method == 0 && b.alpha_size - 1 < size_t(w) * h) throw Corrupt("ALPH data truncated");
}

void set_error(char* err, int64_t err_size, const char* msg) {
  if (err && err_size > 0) snprintf(err, static_cast<size_t>(err_size), "%s", msg);
}

}  // namespace

extern "C" int webp_decode(const uint8_t* data, int64_t size, uint8_t* out, int64_t out_size,
                           int32_t* height, int32_t* width, char* err, int64_t err_size) {
  try {
    if (size < 0) throw Corrupt("negative size");
    const Image img = parse_container(data, size_t(size));
    const Bitstream& b = img.frame;
    auto finish = [&](auto& dec) {
      const int w = dec.width(), h = dec.height();
      if (img.extended && !img.animated && (w != img.canvas_w || h != img.canvas_h))
        throw Corrupt("VP8X canvas size differs from the image's");
      if (b.alpha && !b.lossless) check_alpha(b, w, h);
      *height = img.extended ? img.canvas_h : h;
      *width = img.extended ? img.canvas_w : w;
      if (out == nullptr || out_size < int64_t(*height) * *width * 3) return WEBP_NEED_BUFFER;
      if (!img.animated) {
        dec.decode(out);
        return WEBP_OK;
      }
      // libwebp's animation decoder: frame 1 is a key frame, decoded into a
      // zero-filled canvas at its offset, never blended
      std::vector<uint8_t> frame(size_t(w) * h * 3);
      dec.decode(frame.data());
      memset(out, 0, size_t(*height) * *width * 3);
      for (int y = 0; y < h; ++y)
        memcpy(out + (size_t(img.y + y) * *width + img.x) * 3, &frame[size_t(y) * w * 3],
               size_t(w) * 3);
      return WEBP_OK;
    };
    if (b.lossless) {
      Vp8lDecoder dec(b.data, b.size);
      return finish(dec);
    }
    Vp8Decoder dec(b.data, b.size, b.chunk_size);
    return finish(dec);
  } catch (const Corrupt& e) {
    set_error(err, err_size, e.what());
    return WEBP_CORRUPT;
  } catch (const std::bad_alloc&) {
    set_error(err, err_size, "out of memory");
    return WEBP_CORRUPT;
  }
}
