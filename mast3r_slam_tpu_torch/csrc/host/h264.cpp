// H.264 (ISO/IEC 14496-10) video decoder for the port's video input,
// bit-exact against what cv2 5.0.0 (FFmpeg, libavcodec 62.28) gives: the
// decoder's YUV 4:2:0 planes, cropped, then libswscale's unscaled
// conversion to BGR24 as cv2.VideoCapture asks for it (yuv420.h), handed
// back in RGB order.  H.264 fixes every decoded sample, so the decoder
// follows the standard; what is libavcodec's own is what it outputs and
// when (below).
//
// What is decoded: progressive 4:2:0 8-bit I and P pictures coded with
// CAVLC: parameter sets in the decoder configuration or in band (several
// ids, repeated or changed between pictures), frame cropping, the VUI's
// video_full_range_flag and colour description (converted as cv2 converts
// them, yuv420.h); slices with frame_num, picture order count types
// 0, 1 and 2, num_ref_idx_active_override, ref_pic_list_modification over
// short-term references, sliding-window marking and MMCO 1, slice_qp_delta,
// the deblocking controls, several slices a picture; every I and P mb_type
// and sub_mb_type, I_PCM, transform_size_8x8_flag, intra 4x4, 8x8 (with
// reference smoothing), 16x16 and chroma prediction under
// constrained_intra_pred_flag, motion-vector prediction and P_Skip, the
// luma 6-tap and chroma bilinear interpolation with the picture edge
// extended, the 4x4 and 8x8 inverse transforms with flat dequantisation,
// both chroma QP offsets, and the deblocking filter, with libavcodec's one
// shortcut there (Decoder::deblock).  Pictures come out in
// decoding order, as soon as they are decoded: libavcodec holds pictures
// back (has_b_frames) only to reorder them, and a stream whose picture
// order counts do not rise in decoding order is refused, so the frames and
// their order are libavcodec's whatever it holds back.
//
// What is refused (rc 2, NotImplementedError, naming ROADMAP Queue 1 item
// 17 and its parts): CABAC (17b); B, SP and SI slices and picture order
// counts that reorder output (17c); field and MBAFF coding, weighted
// prediction, scaling matrices, chroma formats other than 4:2:0, bit depths
// over 8, qpprime_y_zero_transform_bypass, slice groups, data partitioning,
// redundant pictures, long-term references and MMCO 2-6, gaps in
// frame_num, a picture size that changes, a left crop, colour descriptions
// that libswscale maps or refuses (wide gamuts, log/PQ/HLG transfers,
// matrices other than yuv420.h's, a colour range or matrix that changes
// between sequence parameter sets), a stream that does not start with an
// IDR picture, and more than one picture a sample.
// Corrupt or truncated data, and streams the standard does not allow (a
// prediction from samples that are not available, a reference that is not
// there), are rc 1 (ValueError): libavcodec would conceal them.

#include <algorithm>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <new>
#include <vector>

#include "yuv420.h"

namespace {

using host::clip_u8;

enum { OK = 0, CORRUPT = 1, UNSUPPORTED = 2, NOMEM = 3 };

struct Fail {
    int rc;
    char msg[200];
};

[[noreturn]] void fail(int rc, const char* fmt, ...) __attribute__((format(printf, 2, 3)));
void fail(int rc, const char* fmt, ...) {
    Fail f;
    f.rc = rc;
    va_list ap;
    va_start(ap, fmt);
    vsnprintf(f.msg, sizeof f.msg, fmt, ap);
    va_end(ap);
    throw f;
}

#define ITEM "ROADMAP Queue 1 item 17"
[[noreturn]] void refuse(const char* what, const char* item = ITEM) {
    fail(UNSUPPORTED, "%s is not ported (%s)", what, item);
}

// ---- tables (ISO/IEC 14496-10 clause 9.2 and 8; identical to libavcodec's) --

// coeff_token by nC class (0 <= nC < 2, < 4, < 8, >= 8), index total_coeff * 4
// + trailing_ones
const uint8_t COEFF_TOKEN_LEN[4][68] = {
    {1,  0,  0,  0,  6,  2,  0,  0,  8,  6,  3,  0,  9,  8,  7,  5,  10, 9,  8,  6,
     11, 10, 9,  7,  13, 11, 10, 8,  13, 13, 11, 9,  13, 13, 13, 10, 14, 14, 13, 11,
     14, 14, 14, 13, 15, 15, 14, 14, 15, 15, 15, 14, 16, 15, 15, 15, 16, 16, 16, 15,
     16, 16, 16, 16, 16, 16, 16, 16},
    {2,  0,  0,  0,  6,  2,  0,  0,  6,  5,  3,  0,  7,  6,  6,  4,  8,  6,  6,  4,
     8,  7,  7,  5,  9,  8,  8,  6,  11, 9,  9,  6,  11, 11, 11, 7,  12, 11, 11, 9,
     12, 12, 12, 11, 12, 12, 12, 11, 13, 13, 13, 12, 13, 13, 13, 13, 13, 14, 13, 13,
     14, 14, 14, 13, 14, 14, 14, 14},
    {4,  0,  0,  0,  6,  4,  0,  0,  6,  5,  4,  0,  6,  5,  5,  4,  7,  5,  5,  4,
     7,  5,  5,  4,  7,  6,  6,  4,  7,  6,  6,  4,  8,  7,  7,  5,  8,  8,  7,  6,
     9,  8,  8,  7,  9,  9,  8,  8,  9,  9,  9,  8,  10, 9,  9,  9,  10, 10, 10, 10,
     10, 10, 10, 10, 10, 10, 10, 10},
    {6, 0, 0, 0, 6, 6, 0, 0, 6, 6, 6, 0, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6,
     6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6,
     6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6}};
const uint8_t COEFF_TOKEN_BITS[4][68] = {
    {1,  0,  0,  0,  5,  1,  0,  0,  7,  4,  1,  0,  7,  6,  5,  3,  7,  6,  5,  3,
     7,  6,  5,  4,  15, 6,  5,  4,  11, 14, 5,  4,  8,  10, 13, 4,  15, 14, 9,  4,
     11, 10, 13, 12, 15, 14, 9,  12, 11, 10, 13, 8,  15, 1,  9,  12, 11, 14, 13, 8,
     7,  10, 9,  12, 4,  6,  5,  8},
    {3,  0,  0,  0,  11, 2,  0,  0,  7,  7,  3,  0,  7,  10, 9,  5,  7,  6,  5,  4,
     4,  6,  5,  6,  7,  6,  5,  8,  15, 6,  5,  4,  11, 14, 13, 4,  15, 10, 9,  4,
     11, 14, 13, 12, 8,  10, 9,  8,  15, 14, 13, 12, 11, 10, 9,  12, 7,  11, 6,  8,
     9,  8,  10, 1,  7,  6,  5,  4},
    {15, 0,  0,  0,  15, 14, 0,  0,  11, 15, 13, 0,  8,  12, 14, 12, 15, 10, 11, 11,
     11, 8,  9,  10, 9,  14, 13, 9,  8,  10, 9,  8,  15, 14, 13, 13, 11, 14, 10, 12,
     15, 10, 13, 12, 11, 14, 9,  12, 8,  10, 13, 8,  13, 7,  9,  12, 9,  12, 11, 10,
     5,  8,  7,  6,  1,  4,  3,  2},
    {3,  0,  0,  0,  0,  1,  0,  0,  4,  5,  6,  0,  8,  9,  10, 11, 12, 13, 14, 15,
     16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
     36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55,
     56, 57, 58, 59, 60, 61, 62, 63}};
// coeff_token of chroma DC (nC -1)
const uint8_t CHROMADC_TOKEN_LEN[20] = {2, 0, 0, 0, 6, 1, 0, 0, 6, 6,
                                        3, 0, 6, 7, 7, 6, 6, 8, 8, 7};
const uint8_t CHROMADC_TOKEN_BITS[20] = {1, 0, 0, 0, 7, 1, 0, 0, 4, 6,
                                         1, 0, 3, 3, 2, 5, 2, 3, 2, 0};
// total_zeros by total_coeff - 1, then of chroma DC
const uint8_t TOTAL_ZEROS_LEN[15][16] = {
    {1, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9}, {3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 6, 6, 0},
    {4, 3, 3, 3, 4, 4, 3, 3, 4, 5, 5, 6, 5, 6, 0, 0}, {5, 3, 4, 4, 3, 3, 3, 4, 3, 4, 5, 5, 5, 0, 0, 0},
    {4, 4, 4, 3, 3, 3, 3, 3, 4, 5, 4, 5, 0, 0, 0, 0}, {6, 5, 3, 3, 3, 3, 3, 3, 4, 3, 6, 0, 0, 0, 0, 0},
    {6, 5, 3, 3, 3, 2, 3, 4, 3, 6, 0, 0, 0, 0, 0, 0}, {6, 4, 5, 3, 2, 2, 3, 3, 6, 0, 0, 0, 0, 0, 0, 0},
    {6, 6, 4, 2, 2, 3, 2, 5, 0, 0, 0, 0, 0, 0, 0, 0}, {5, 5, 3, 2, 2, 2, 4, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {4, 4, 3, 3, 1, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}, {4, 4, 2, 1, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {3, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}, {2, 2, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}};
const uint8_t TOTAL_ZEROS_BITS[15][16] = {
    {1, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 1}, {7, 6, 5, 4, 3, 5, 4, 3, 2, 3, 2, 3, 2, 1, 0, 0},
    {5, 7, 6, 5, 4, 3, 4, 3, 2, 3, 2, 1, 1, 0, 0, 0}, {3, 7, 5, 4, 6, 5, 4, 3, 3, 2, 2, 1, 0, 0, 0, 0},
    {5, 4, 3, 7, 6, 5, 4, 3, 2, 1, 1, 0, 0, 0, 0, 0}, {1, 1, 7, 6, 5, 4, 3, 2, 1, 1, 0, 0, 0, 0, 0, 0},
    {1, 1, 5, 4, 3, 3, 2, 1, 1, 0, 0, 0, 0, 0, 0, 0}, {1, 1, 1, 3, 3, 2, 2, 1, 0, 0, 0, 0, 0, 0, 0, 0},
    {1, 0, 1, 3, 2, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0}, {1, 0, 1, 3, 2, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 1, 2, 1, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}, {0, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}, {0, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}};
const uint8_t CHROMADC_ZEROS_LEN[3][4] = {{1, 2, 3, 3}, {1, 2, 2, 0}, {1, 1, 0, 0}};
const uint8_t CHROMADC_ZEROS_BITS[3][4] = {{1, 1, 1, 0}, {1, 1, 0, 0}, {1, 0, 0, 0}};
// run_before by min(zerosLeft, 7) - 1
const uint8_t RUN_BEFORE_LEN[7][16] = {
    {1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}, {1, 2, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {2, 2, 2, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}, {2, 2, 2, 3, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {2, 2, 3, 3, 3, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}, {2, 3, 3, 3, 3, 3, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {3, 3, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11, 0}};
const uint8_t RUN_BEFORE_BITS[7][16] = {
    {1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}, {1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {3, 2, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}, {3, 2, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {3, 2, 3, 2, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}, {3, 0, 1, 3, 2, 5, 4, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {7, 6, 5, 4, 3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0}};
// coded_block_pattern by codeNum (chroma 4:2:0): intra (I_NxN), inter
const uint8_t INTRA_CBP[48] = {47, 31, 15, 0,  23, 27, 29, 30, 7,  11, 13, 14, 39, 43, 45, 46,
                               16, 3,  5,  10, 12, 19, 21, 26, 28, 35, 37, 42, 44, 1,  2,  4,
                               8,  17, 18, 20, 24, 6,  9,  22, 25, 32, 33, 34, 36, 40, 38, 41};
const uint8_t INTER_CBP[48] = {0,  16, 1,  2,  4,  8,  32, 3,  5,  10, 12, 15, 47, 7,  11, 13,
                               14, 6,  9,  31, 35, 37, 42, 44, 33, 34, 36, 40, 39, 43, 45, 46,
                               17, 18, 20, 24, 19, 21, 26, 28, 23, 27, 29, 30, 22, 25, 38, 41};

const uint8_t ZIGZAG4[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t ZIGZAG8[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
// QPc by qPI (Table 8-15)
const uint8_t QPC[52] = {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17,
                         18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 29, 30, 31, 32, 32, 33,
                         34, 34, 35, 35, 36, 36, 37, 37, 37, 38, 38, 38, 39, 39, 39, 39};
// deblocking (Tables 8-16, 8-17) by indexA / indexB
const uint8_t ALPHA[52] = {0,  0,  0,  0,  0,  0,  0,   0,   0,   0,   0,   0,   0,
                           0,  0,  0,  4,  4,  5,  6,   7,   8,   9,   10,  12,  13,
                           15, 17, 20, 22, 25, 28, 32,  36,  40,  45,  50,  56,  63,
                           71, 80, 90, 101, 113, 127, 144, 162, 182, 203, 226, 255, 255};
const uint8_t BETA[52] = {0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  2,  2,
                          2, 3, 3, 3, 3, 4, 4,  4,  6,  6,  7,  7,  8,  8,  9,  9,  10, 10,
                          11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18};
const uint8_t TC0[52][3] = {
    {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 0},  {0, 0, 0},   {0, 0, 0},
    {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 0},  {0, 0, 0},   {0, 0, 0},
    {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 1},   {0, 0, 1},  {0, 0, 1},   {0, 0, 1},
    {0, 1, 1},   {0, 1, 1},   {1, 1, 1},   {1, 1, 1},   {1, 1, 1},  {1, 1, 1},   {1, 1, 2},
    {1, 1, 2},   {1, 1, 2},   {1, 1, 2},   {1, 2, 3},   {1, 2, 3},  {2, 2, 3},   {2, 2, 4},
    {2, 3, 4},   {2, 3, 4},   {3, 3, 5},   {3, 4, 6},   {3, 4, 6},  {4, 5, 7},   {4, 5, 8},
    {4, 6, 9},   {5, 7, 10},  {6, 8, 11},  {6, 8, 13},  {7, 10, 14}, {8, 11, 16}, {9, 12, 18},
    {10, 13, 20}, {11, 15, 23}, {13, 17, 25}};
// flat dequantisation: normAdjust4x4 and normAdjust8x8 by qP % 6 and class
const int DEQ4[6][3] = {{10, 16, 13}, {11, 18, 14}, {13, 20, 16},
                        {14, 23, 18}, {16, 25, 20}, {18, 29, 23}};
const int DEQ8[6][6] = {{20, 18, 32, 19, 25, 24}, {22, 19, 35, 21, 28, 26},
                        {26, 23, 42, 24, 33, 31}, {28, 25, 45, 26, 35, 33},
                        {32, 28, 51, 30, 40, 38}, {36, 32, 58, 34, 46, 43}};

int deq4_class(int pos) {
    int i = pos >> 2, j = pos & 3;
    if (!(i & 1) && !(j & 1)) return 0;
    if ((i & 1) && (j & 1)) return 1;
    return 2;
}

int deq8_class(int pos) {
    int i = pos >> 3, j = pos & 7;
    if (!(i & 3) && !(j & 3)) return 0;
    if ((i & 1) && (j & 1)) return 1;
    if ((i & 3) == 2 && (j & 3) == 2) return 2;
    if ((!(i & 3) && (j & 1)) || ((i & 1) && !(j & 3))) return 3;
    if ((!(i & 3) && (j & 3) == 2) || ((i & 3) == 2 && !(j & 3))) return 4;
    return 5;
}

// ---- variable-length codes -------------------------------------------------

struct Vlc {
    int bits = 0;
    std::vector<uint16_t> lut;  // (symbol << 5) | length, 0 where no code starts
    void build(const uint8_t* len, const uint8_t* code, int n) {
        bits = 0;
        for (int s = 0; s < n; s++) bits = std::max(bits, int(len[s]));
        lut.assign(size_t(1) << bits, 0);
        for (int s = 0; s < n; s++) {
            if (!len[s]) continue;
            int shift = bits - len[s];
            size_t first = size_t(code[s]) << shift;
            for (size_t k = 0; k < (size_t(1) << shift); k++)
                lut[first + k] = uint16_t((s << 5) | len[s]);
        }
    }
};

struct Tables {
    Vlc coeff[4], chroma_dc, zeros[15], chroma_zeros[3], run[7];
    int class8[64], class4[16];
    Tables() {
        for (int c = 0; c < 4; c++) coeff[c].build(COEFF_TOKEN_LEN[c], COEFF_TOKEN_BITS[c], 68);
        chroma_dc.build(CHROMADC_TOKEN_LEN, CHROMADC_TOKEN_BITS, 20);
        for (int t = 0; t < 15; t++) zeros[t].build(TOTAL_ZEROS_LEN[t], TOTAL_ZEROS_BITS[t], 16);
        for (int t = 0; t < 3; t++)
            chroma_zeros[t].build(CHROMADC_ZEROS_LEN[t], CHROMADC_ZEROS_BITS[t], 4);
        for (int t = 0; t < 7; t++) run[t].build(RUN_BEFORE_LEN[t], RUN_BEFORE_BITS[t], 16);
        for (int p = 0; p < 64; p++) class8[p] = deq8_class(p);
        for (int p = 0; p < 16; p++) class4[p] = deq4_class(p);
    }
};

const Tables& tables() {
    static const Tables t;
    return t;
}

// ---- bits of an RBSP ------------------------------------------------------

struct Bits {
    const uint8_t* d;
    int64_t nbytes, nbits, pos = 0;  // nbits: up to the rbsp_stop_one_bit
    Bits(const uint8_t* p, int64_t n) : d(p), nbytes(n), nbits(-1) {
        for (int64_t i = n - 1; i >= 0; i--)
            if (p[i]) {
                nbits = i * 8 + 7 - __builtin_ctz(p[i]);
                break;
            }
        if (nbits < 0) fail(CORRUPT, "a NAL unit without rbsp_stop_one_bit");
    }
    uint32_t peek(int n) const {  // n <= 32; bits past the data read as 0
        uint64_t v = 0;
        int64_t at = pos >> 3;
        for (int i = 0; i < 8; i++) v = (v << 8) | (at + i < nbytes ? d[at + i] : 0);
        return n ? uint32_t((v << (pos & 7)) >> (64 - n)) : 0;
    }
    void skip(int n) {
        pos += n;
        if (pos > nbits) fail(CORRUPT, "data cut short");
    }
    uint32_t u(int n) {
        uint32_t v = peek(n);
        skip(n);
        return v;
    }
    bool flag() { return u(1); }
    uint32_t ue() {
        uint32_t top = peek(32);
        if (!top) fail(CORRUPT, "an Exp-Golomb code of more than 31 leading zeros");
        int lz = __builtin_clz(top);
        if (lz > 15) {
            skip(lz + 1);
            return (1u << lz) - 1 + u(lz);
        }
        skip(2 * lz + 1);
        return (top >> (31 - 2 * lz)) - 1;
    }
    uint32_t ue_max(uint32_t max, const char* what) {
        uint32_t v = ue();
        if (v > max) fail(CORRUPT, "%s %u out of range", what, v);
        return v;
    }
    int32_t se() {
        uint32_t k = ue();
        return (k & 1) ? int32_t((k + 1) >> 1) : -int32_t(k >> 1);
    }
    int vlc(const Vlc& v, const char* what) {
        uint16_t e = v.lut[peek(v.bits)];
        if (!e) fail(CORRUPT, "an invalid %s code", what);
        skip(e & 31);
        return e >> 5;
    }
    bool more() const { return pos < nbits; }
};

// ---- parameter sets ---------------------------------------------------------

struct Sps {
    bool valid = false;
    bool pps_extension = true;  // libavcodec reads the PPS's transform_8x8_mode_flag on
    int log2_max_frame_num = 4, poc_type = 0, log2_max_poc_lsb = 4;
    bool delta_pic_order_always_zero = false;
    int offset_for_non_ref_pic = 0, offset_for_top_to_bottom_field = 0;
    std::vector<int> offset_for_ref_frame;
    int max_num_ref_frames = 0;
    int mbw = 0, mbh = 0;
    int crop[4] = {0, 0, 0, 0};  // left, right, top, bottom in luma samples
    bool full_range = false;
    int matrix = 2;  // matrix_coefficients (2: unspecified)
};

struct Pps {
    bool valid = false;
    int sps_id = 0;
    bool bottom_field_pic_order_in_frame_present = false;
    int num_ref_idx_default = 1;
    int init_qp = 26;
    int chroma_qp_offset[2] = {0, 0};
    bool deblocking_filter_control_present = false, constrained_intra_pred = false;
    bool redundant_pic_cnt_present = false, transform_8x8_mode = false;
};

void skip_hrd(Bits& b) {  // hrd_parameters (E.1.2)
    uint32_t cpb = b.ue_max(31, "cpb_cnt_minus1");
    b.u(8);
    for (uint32_t i = 0; i <= cpb; i++) {
        b.ue();
        b.ue();
        b.u(1);
    }
    b.u(20);
}

Sps parse_sps(Bits& b, int* id) {
    Sps s;
    int profile = b.u(8);
    int constraints = b.u(8);
    b.u(8);  // level_idc
    // libavcodec skips what follows redundant_pic_cnt_present_flag in a PPS
    // of a Baseline, Main or Extended stream with constraint_set0-2 set
    s.pps_extension = !((profile == 66 || profile == 77 || profile == 88) && (constraints & 0xE0));
    *id = b.ue_max(31, "seq_parameter_set_id");
    if (profile == 100 || profile == 110 || profile == 122 || profile == 244 || profile == 44 ||
        profile == 83 || profile == 86 || profile == 118 || profile == 128 || profile == 138 ||
        profile == 139 || profile == 134 || profile == 135) {
        uint32_t chroma_format = b.ue_max(3, "chroma_format_idc");
        if (chroma_format != 1) refuse("a chroma format other than 4:2:0");
        if (b.ue() != 0 || b.ue() != 0) refuse("a bit depth over 8");
        if (b.flag()) refuse("qpprime_y_zero_transform_bypass");
        if (b.flag()) refuse("a scaling matrix");
    }
    s.log2_max_frame_num = b.ue_max(12, "log2_max_frame_num_minus4") + 4;
    s.poc_type = b.ue_max(2, "pic_order_cnt_type");
    if (s.poc_type == 0) {
        s.log2_max_poc_lsb = b.ue_max(12, "log2_max_pic_order_cnt_lsb_minus4") + 4;
    } else if (s.poc_type == 1) {
        s.delta_pic_order_always_zero = b.flag();
        s.offset_for_non_ref_pic = b.se();
        s.offset_for_top_to_bottom_field = b.se();
        int n = b.ue_max(255, "num_ref_frames_in_pic_order_cnt_cycle");
        for (int i = 0; i < n; i++) s.offset_for_ref_frame.push_back(b.se());
    }
    s.max_num_ref_frames = b.ue_max(16, "max_num_ref_frames");
    b.flag();  // gaps_in_frame_num_value_allowed_flag: a gap is refused either way
    s.mbw = b.ue_max(1023, "pic_width_in_mbs_minus1") + 1;
    s.mbh = b.ue_max(1023, "pic_height_in_map_units_minus1") + 1;
    if (s.mbw * s.mbh > (1 << 18))  // 64 Mpixel, the image readers' limit too
        fail(CORRUPT, "a picture of %dx%d macroblocks", s.mbw, s.mbh);
    if (!b.flag()) refuse("field or MBAFF coding (frame_mbs_only_flag 0)");
    b.flag();  // direct_8x8_inference_flag (B slices only)
    if (b.flag()) {
        for (int i = 0; i < 4; i++) s.crop[i] = 2 * b.ue_max(8192, "frame_crop_offset");
        if (s.crop[0] + s.crop[1] >= 16 * s.mbw || s.crop[2] + s.crop[3] >= 16 * s.mbh)
            fail(CORRUPT, "a frame crop larger than the picture");
        if (s.crop[0]) refuse("a left frame crop (libavcodec aligns it)");
    }
    if (b.flag()) {  // vui_parameters
        if (b.flag() && b.u(8) == 255) b.u(32);  // aspect ratio
        if (b.flag()) b.flag();                  // overscan
        if (b.flag()) {                          // video_signal_type
            b.u(3);
            s.full_range = b.flag();
            if (b.flag()) {  // colour description
                int primaries = b.u(8), transfer = b.u(8);
                s.matrix = b.u(8);
                // what cv2 5.0.0 turns by other means than the matrix (libswscale
                // maps wide gamuts and these transfers, or fails), held or refused
                if ((primaries >= 8 && primaries <= 12) || primaries == 22 || primaries > 23)
                    refuse("colour_primaries other than BT.709/601/240M/FCC");
                if (transfer == 9 || transfer == 10 || transfer == 16 || transfer == 18 || transfer > 19)
                    refuse("log, PQ or HLG transfer_characteristics");
                if (!host::yuv_matrix_supported(s.matrix))
                    refuse("matrix_coefficients other than BT.601/709/FCC/240M/2020 NCL");
            }
        }
        if (b.flag()) {  // chroma_loc_info
            b.ue();
            b.ue();
        }
        if (b.flag()) b.u(32), b.u(32), b.u(1);  // timing_info
        bool nal_hrd = b.flag();
        if (nal_hrd) skip_hrd(b);
        bool vcl_hrd = b.flag();
        if (vcl_hrd) skip_hrd(b);
        if (nal_hrd || vcl_hrd) b.flag();  // low_delay_hrd_flag
        b.flag();                          // pic_struct_present_flag
        if (b.flag()) {                    // bitstream_restriction
            b.flag();
            for (int i = 0; i < 6; i++) b.ue();
        }
    }
    s.valid = true;
    return s;
}

Pps parse_pps(Bits& b, const Sps* sps_list, int* id) {
    Pps p;
    *id = b.ue_max(255, "pic_parameter_set_id");
    p.sps_id = b.ue_max(31, "seq_parameter_set_id");
    if (!sps_list[p.sps_id].valid) fail(CORRUPT, "a PPS of SPS %d, not received", p.sps_id);
    if (b.flag()) refuse("CABAC (entropy_coding_mode_flag 1)", ITEM "b");
    p.bottom_field_pic_order_in_frame_present = b.flag();
    if (b.ue() != 0) refuse("slice groups (FMO)");
    p.num_ref_idx_default = b.ue_max(31, "num_ref_idx_l0_default_active_minus1") + 1;
    b.ue_max(31, "num_ref_idx_l1_default_active_minus1");
    if (b.flag()) refuse("weighted prediction");
    b.u(2);  // weighted_bipred_idc (B slices only)
    p.init_qp = 26 + b.se();
    b.se();  // pic_init_qs (SP and SI slices only)
    if (p.init_qp < 0 || p.init_qp > 51) fail(CORRUPT, "pic_init_qp %d", p.init_qp);
    p.chroma_qp_offset[0] = p.chroma_qp_offset[1] = b.se();
    if (p.chroma_qp_offset[0] < -12 || p.chroma_qp_offset[0] > 12)
        fail(CORRUPT, "chroma_qp_index_offset %d", p.chroma_qp_offset[0]);
    p.deblocking_filter_control_present = b.flag();
    p.constrained_intra_pred = b.flag();
    p.redundant_pic_cnt_present = b.flag();
    if (b.more() && sps_list[p.sps_id].pps_extension) {
        p.transform_8x8_mode = b.flag();
        if (b.flag()) refuse("a scaling matrix");
        p.chroma_qp_offset[1] = b.se();
        if (p.chroma_qp_offset[1] < -12 || p.chroma_qp_offset[1] > 12)
            fail(CORRUPT, "second_chroma_qp_index_offset %d", p.chroma_qp_offset[1]);
    }
    p.valid = true;
    return p;
}

// ---- NAL units --------------------------------------------------------------

struct NalRef {
    const uint8_t* p;
    int64_t n;
};

std::vector<NalRef> split_nals(const uint8_t* d, int64_t n, int length_size) {
    std::vector<NalRef> out;
    if (length_size) {
        int64_t at = 0;
        while (at < n) {
            if (at + length_size > n) fail(CORRUPT, "a NAL unit length cut short");
            int64_t len = 0;
            for (int i = 0; i < length_size; i++) len = (len << 8) | d[at + i];
            at += length_size;
            if (len > n - at) fail(CORRUPT, "a NAL unit of %lld bytes past the sample's end",
                                   (long long)len);
            if (len) out.push_back({d + at, len});
            at += len;
        }
        return out;
    }
    // Annex B byte stream: units after 0x000001 start codes, trailing zeros dropped
    int64_t i = 0;
    while (i < n && d[i] == 0) i++;
    if (i == n) return out;
    if (i < 2 || d[i] != 1) fail(CORRUPT, "data before the first start code");
    int64_t start = i + 1;
    for (i = start; i + 2 < n; i++) {
        if (d[i] == 0 && d[i + 1] == 0 && d[i + 2] == 1) {
            int64_t end = i;
            while (end > start && d[end - 1] == 0) end--;
            if (end > start) out.push_back({d + start, end - start});
            start = i + 3;
            i += 2;
        }
    }
    int64_t end = n;
    while (end > start && d[end - 1] == 0) end--;
    if (end > start) out.push_back({d + start, end - start});
    return out;
}

// the RBSP of a NAL unit's payload: emulation_prevention_three_byte removed
void unescape(const uint8_t* p, int64_t n, std::vector<uint8_t>& out) {
    out.clear();
    out.reserve(size_t(n));
    int zeros = 0;
    for (int64_t i = 0; i < n; i++) {
        uint8_t c = p[i];
        if (zeros >= 2 && c <= 3) {
            if (c != 3) fail(CORRUPT, "a start code inside a NAL unit");
            zeros = 0;
            continue;
        }
        out.push_back(c);
        zeros = c ? 0 : zeros + 1;
    }
}

// ---- pictures ---------------------------------------------------------------

struct Frame {
    int id = 0;
    int w = 0, h = 0;  // luma samples, whole macroblocks
    std::vector<uint8_t> px[3];
    int frame_num = 0;
    int crop[4] = {0, 0, 0, 0};
    bool full_range = false;
    int matrix = 2;
    uint8_t* plane(int c) { return px[c].data(); }
    int stride(int c) const { return c ? w / 2 : w; }
};

enum Kind : uint8_t { P_INTER, I_4x4, I_8x8, I_16x16, I_PCM };

struct Mb {
    int slice = -1;
    Kind kind = P_INTER;
    bool t8 = false;
    int qp = 0;               // QPY (0 for I_PCM in deblocking)
    uint8_t nz[24] = {0};     // total_coeff: luma raster 4x4, then Cb, Cr 2x2
    int8_t ipred[16] = {0};   // Intra4x4/8x8PredMode by raster 4x4; -1 other kinds
    int16_t mv[16][2] = {{0}};
    int8_t ref[16] = {0};     // -1 intra
    int refpic[16] = {0};     // the id of the picture referenced
    uint16_t coded = 0;       // raster 4x4 blocks with coefficients (deblocking)
    uint8_t cbp = 0;          // coded_block_pattern as coded
    bool intra() const { return kind != P_INTER; }
};

struct SliceInfo {
    int dbk_idc = 0, alpha = 0, beta = 0;
};

struct Residual {
    int luma[16][16];   // levels by raster 4x4 block and raster position
    int luma8[4][64];
    int dc[16];         // Intra16x16 DC levels by raster position
    int cdc[2][4];
    int cac[2][4][16];
};

inline int median3(int a, int b, int c) { return std::max(std::min(a, b), std::min(std::max(a, b), c)); }
inline int clip3(int lo, int hi, int v) { return v < lo ? lo : v > hi ? hi : v; }

// z-order index of 4x4 block (bx, by) within a macroblock
inline int zidx(int bx, int by) { return ((by >> 1) << 3) | ((bx >> 1) << 2) | ((by & 1) << 1) | (bx & 1); }
inline int zx(int blk) { return ((blk >> 2) & 1) * 2 + (blk & 1); }
inline int zy(int blk) { return ((blk >> 3) & 1) * 2 + ((blk >> 1) & 1); }

void idct4_add(int* c, uint8_t* dst, int stride) {
    int t[16];
    for (int i = 0; i < 4; i++) {  // rows
        const int* d = c + 4 * i;
        int e0 = d[0] + d[2], e1 = d[0] - d[2], e2 = (d[1] >> 1) - d[3], e3 = d[1] + (d[3] >> 1);
        t[4 * i + 0] = e0 + e3;
        t[4 * i + 1] = e1 + e2;
        t[4 * i + 2] = e1 - e2;
        t[4 * i + 3] = e0 - e3;
    }
    for (int j = 0; j < 4; j++) {  // columns
        int f0 = t[j], f1 = t[4 + j], f2 = t[8 + j], f3 = t[12 + j];
        int g0 = f0 + f2, g1 = f0 - f2, g2 = (f1 >> 1) - f3, g3 = f1 + (f3 >> 1);
        int r[4] = {g0 + g3, g1 + g2, g1 - g2, g0 - g3};
        for (int i = 0; i < 4; i++) {
            uint8_t* p = dst + i * stride + j;
            *p = clip_u8(*p + ((r[i] + 32) >> 6));
        }
    }
}

void idct8_1d(const int* d, int s, int* o, int os) {
    int a0 = d[0] + d[4 * s], a4 = d[0] - d[4 * s];
    int a2 = (d[2 * s] >> 1) - d[6 * s], a6 = d[2 * s] + (d[6 * s] >> 1);
    int b0 = a0 + a6, b2 = a4 + a2, b4 = a4 - a2, b6 = a0 - a6;
    int d1 = d[s], d3 = d[3 * s], d5 = d[5 * s], d7 = d[7 * s];
    int a1 = -d3 + d5 - d7 - (d7 >> 1);
    int a3 = d1 + d7 - d3 - (d3 >> 1);
    int a5 = -d1 + d7 + d5 + (d5 >> 1);
    int a7 = d3 + d5 + d1 + (d1 >> 1);
    int b1 = a1 + (a7 >> 2), b7 = a7 - (a1 >> 2), b3 = a3 + (a5 >> 2), b5 = (a3 >> 2) - a5;
    o[0] = b0 + b7;
    o[os] = b2 + b5;
    o[2 * os] = b4 + b3;
    o[3 * os] = b6 + b1;
    o[4 * os] = b6 - b1;
    o[5 * os] = b4 - b3;
    o[6 * os] = b2 - b5;
    o[7 * os] = b0 - b7;
}

void idct8_add(const int* c, uint8_t* dst, int stride) {
    int t[64], r[64];
    for (int i = 0; i < 8; i++) idct8_1d(c + 8 * i, 1, t + 8 * i, 1);  // rows
    for (int j = 0; j < 8; j++) idct8_1d(t + j, 8, r + j, 8);          // columns
    for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++) {
            uint8_t* p = dst + i * stride + j;
            *p = clip_u8(*p + ((r[8 * i + j] + 32) >> 6));
        }
}

// Intra 4x4 and 8x8 prediction (8.3.1.2, 8.3.2.2) from top[-1..2N-1] and
// left[-1..N-1] (index +1), the 8x8 ones already smoothed
void intra_nxn(int N, int mode, const int* top, const int* left, bool has_top, bool has_left,
               uint8_t* dst, int stride) {
    auto T = [&](int x) { return top[x + 1]; };   // p[x, -1], x >= -1
    auto L = [&](int y) { return left[y + 1]; };  // p[-1, y], y >= -1
    int sh = N == 4 ? 3 : 4;
    for (int y = 0; y < N; y++)
        for (int x = 0; x < N; x++) {
            int v = 0;
            switch (mode) {
            case 0: v = T(x); break;
            case 1: v = L(y); break;
            case 2: {
                int s = 0;
                if (has_top && has_left) {
                    for (int k = 0; k < N; k++) s += T(k) + L(k);
                    v = (s + N) >> sh;
                } else if (has_top) {
                    for (int k = 0; k < N; k++) s += T(k);
                    v = (s + N / 2) >> (sh - 1);
                } else if (has_left) {
                    for (int k = 0; k < N; k++) s += L(k);
                    v = (s + N / 2) >> (sh - 1);
                } else {
                    v = 128;
                }
                break;
            }
            case 3:
                v = (x == N - 1 && y == N - 1) ? (T(2 * N - 2) + 3 * T(2 * N - 1) + 2) >> 2
                                               : (T(x + y) + 2 * T(x + y + 1) + T(x + y + 2) + 2) >> 2;
                break;
            case 4:
                if (x > y) v = (T(x - y - 2) + 2 * T(x - y - 1) + T(x - y) + 2) >> 2;
                else if (x < y) v = (L(y - x - 2) + 2 * L(y - x - 1) + L(y - x) + 2) >> 2;
                else v = (T(0) + 2 * T(-1) + L(0) + 2) >> 2;
                break;
            case 5: {
                int z = 2 * x - y;
                if (z >= 0 && !(z & 1)) v = (T(x - (y >> 1) - 1) + T(x - (y >> 1)) + 1) >> 1;
                else if (z > 0) v = (T(x - (y >> 1) - 2) + 2 * T(x - (y >> 1) - 1) + T(x - (y >> 1)) + 2) >> 2;
                else if (z == -1) v = (L(0) + 2 * L(-1) + T(0) + 2) >> 2;
                else v = (L(y - 2 * x - 1) + 2 * L(y - 2 * x - 2) + L(y - 2 * x - 3) + 2) >> 2;
                break;
            }
            case 6: {
                int z = 2 * y - x;
                if (z >= 0 && !(z & 1)) v = (L(y - (x >> 1) - 1) + L(y - (x >> 1)) + 1) >> 1;
                else if (z > 0) v = (L(y - (x >> 1) - 2) + 2 * L(y - (x >> 1) - 1) + L(y - (x >> 1)) + 2) >> 2;
                else if (z == -1) v = (L(0) + 2 * L(-1) + T(0) + 2) >> 2;
                else v = (T(x - 2 * y - 1) + 2 * T(x - 2 * y - 2) + T(x - 2 * y - 3) + 2) >> 2;
                break;
            }
            case 7:
                v = (y & 1) ? (T(x + (y >> 1)) + 2 * T(x + (y >> 1) + 1) + T(x + (y >> 1) + 2) + 2) >> 2
                            : (T(x + (y >> 1)) + T(x + (y >> 1) + 1) + 1) >> 1;
                break;
            default: {
                int z = x + 2 * y;
                if (z < 2 * N - 3 && !(z & 1)) v = (L(y + (x >> 1)) + L(y + (x >> 1) + 1) + 1) >> 1;
                else if (z < 2 * N - 3) v = (L(y + (x >> 1)) + 2 * L(y + (x >> 1) + 1) + L(y + (x >> 1) + 2) + 2) >> 2;
                else if (z == 2 * N - 3) v = (L(N - 2) + 3 * L(N - 1) + 2) >> 2;
                else v = L(N - 1);
            }
            }
            dst[y * stride + x] = uint8_t(v);
        }
}

// ---- the decoder ---------------------------------------------------------------

struct Decoder {
    Sps sps_list[32];
    Pps pps_list[256];
    int length_size = 0;  // 0: Annex B samples
    int next_id = 1;
    int colour = -1;      // the colour description of every SPS: full range, matrix
    // the stream's geometry, from its first picture
    int mbw = 0, mbh = 0;
    // the sequence so far
    std::vector<std::shared_ptr<Frame>> refs;  // short-term references
    std::shared_ptr<Frame> out;                // the last picture output
    bool started = false;                      // an IDR picture decoded since the last reset
    bool broken = false;                       // a corrupt picture since then, or the reset
    int prev_ref_frame_num = 0, prev_frame_num = 0, prev_frame_num_offset = 0;
    int prev_poc_msb = 0, prev_poc_lsb = 0;
    int last_poc = 0;
    // the picture being decoded
    std::shared_ptr<Frame> cur;
    const Sps* sps = nullptr;
    const Pps* pps = nullptr;
    int pps_id = -1;
    std::vector<Mb> mbs;
    std::vector<SliceInfo> slices;
    int decoded_mbs = 0;
    int pic_frame_num = 0, pic_ref_idc = 0, pic_idr_id = 0, pic_poc = 0;
    bool pic_idr = false;
    std::vector<int> mmcos, pic_mmcos;  // MMCO 1's differences: a slice's, the picture's
    // the slice being decoded
    int slice_num = 0, slice_type = 2, qp = 26;
    std::vector<Frame*> list;
    std::vector<uint8_t> rbsp;
    Residual res;

    // -- parameter sets ----------------------------------------------------------

    void parameter_set(const NalRef& nal) {
        int type = nal.p[0] & 31;
        unescape(nal.p + 1, nal.n - 1, rbsp);
        Bits b(rbsp.data(), int64_t(rbsp.size()));
        int id;
        if (type == 7) {
            Sps s = parse_sps(b, &id);
            // cv2 converts frames after a change of range or matrix by what it
            // saw first or last (and an AVI's frames before it too): refused
            int c = (s.full_range ? 256 : 0) + s.matrix;
            if (colour >= 0 && c != colour)
                refuse("a colour range or matrix that changes between sequence parameter sets");
            colour = c;
            sps_list[id] = s;
        } else {
            Pps p = parse_pps(b, sps_list, &id);
            pps_list[id] = p;
        }
    }

    // the parameter sets among NAL units (Annex B, or behind the stream's
    // lengths); whether an IDR slice is among them
    bool headers(const uint8_t* d, int64_t n, int lengths) {
        bool idr = false;
        for (const NalRef& nal : split_nals(d, n, lengths)) {
            int type = nal.p[0] & 31;
            if (nal.p[0] & 0x80) fail(CORRUPT, "forbidden_zero_bit set");
            if (type == 7 || type == 8) parameter_set(nal);
            idr |= type == 5;
        }
        return idr;
    }

    // -- a sample -----------------------------------------------------------------

    // decode one sample: returns its index if a picture is output, else -1
    int64_t decode(const uint8_t* d, int64_t n, int64_t sample) {
        bool have_pic = false, pic_done = false;
        for (const NalRef& nal : split_nals(d, n, length_size)) {
            if (nal.p[0] & 0x80) fail(CORRUPT, "forbidden_zero_bit set");
            int type = nal.p[0] & 31, ref_idc = nal.p[0] >> 5;
            bool ends = type == 7 || type == 8 || type == 9 || type == 10 || type == 11;
            if (have_pic && !pic_done && ends) {  // the picture ends before these units
                finish_picture();
                pic_done = true;
            }
            if (type == 7 || type == 8) {
                parameter_set(nal);
            } else if (type == 1 || type == 5) {
                if (pic_done) refuse("a sample of more than one picture");
                unescape(nal.p + 1, nal.n - 1, rbsp);
                Bits b(rbsp.data(), int64_t(rbsp.size()));
                slice(b, type == 5, ref_idc, &have_pic);
            } else if (type >= 2 && type <= 4) {
                refuse("data partitioning");
            }
            // SEI, access unit delimiters, filler data, SPS extensions and
            // other NAL units: skipped
        }
        if (!have_pic) return -1;
        if (!pic_done) finish_picture();
        return sample;
    }

    // -- slices ---------------------------------------------------------------------

    void slice(Bits& b, bool idr, int ref_idc, bool* have_pic) {
        uint32_t first_mb = b.ue();
        uint32_t type = b.ue_max(9, "slice_type") % 5;
        if (type == 1) refuse("B slices", ITEM "c");
        if (type == 3 || type == 4) refuse("SP and SI slices", ITEM "c");
        int id = b.ue_max(255, "pic_parameter_set_id");
        if (!pps_list[id].valid) fail(CORRUPT, "a slice of PPS %d, not received", id);
        const Pps* p = &pps_list[id];
        const Sps* s = &sps_list[p->sps_id];
        int frame_num = b.u(s->log2_max_frame_num);
        int idr_id = idr ? int(b.ue_max(65535, "idr_pic_id")) : 0;
        int poc_lsb = 0, delta_bottom = 0, delta[2] = {0, 0};
        if (s->poc_type == 0) {
            poc_lsb = b.u(s->log2_max_poc_lsb);
            if (p->bottom_field_pic_order_in_frame_present) delta_bottom = b.se();
        } else if (s->poc_type == 1 && !s->delta_pic_order_always_zero) {
            delta[0] = b.se();
            if (p->bottom_field_pic_order_in_frame_present) delta[1] = b.se();
        }
        if (p->redundant_pic_cnt_present && b.ue() != 0) refuse("redundant pictures");
        if (!*have_pic) {
            if (first_mb != 0) refuse("a picture whose first slice does not start at its top");
            start_picture(s, p, id, idr, ref_idc, frame_num, idr_id, poc_lsb, delta_bottom, delta);
            *have_pic = true;
        } else if (id != pps_id || idr != pic_idr || frame_num != pic_frame_num ||
                   (ref_idc != 0) != (pic_ref_idc != 0) || idr_id != pic_idr_id ||
                   poc_of(s, idr, ref_idc, frame_num, poc_lsb, delta_bottom, delta, false) != pic_poc) {
            refuse("a sample of more than one picture");
        }
        if (int(first_mb) != decoded_mbs)
            fail(CORRUPT, "a slice at macroblock %u where %d was next", first_mb, decoded_mbs);
        slice_type = type;
        int num_ref = p->num_ref_idx_default;
        if (type == 0) {
            if (b.flag()) num_ref = b.ue_max(31, "num_ref_idx_l0_active_minus1") + 1;
            if (num_ref > 16) fail(CORRUPT, "%d active references in a frame", num_ref);
            build_list(num_ref);
            if (b.flag()) modify_list(b);
        }
        if (ref_idc) {  // dec_ref_pic_marking
            if (idr) {
                b.flag();  // no_output_of_prior_pics_flag: prior pictures are out already
                if (b.flag()) refuse("long-term references");
            } else if (b.flag()) {
                mmcos.clear();
                for (;;) {
                    uint32_t op = b.ue_max(6, "memory_management_control_operation");
                    if (op == 0) break;
                    if (op != 1) refuse("MMCO 2-6 (long-term references, MMCO 5)");
                    mmcos.push_back(int(b.ue_max(1u << 17, "difference_of_pic_nums_minus1")) + 1);
                }
                if (!slices.empty() && mmcos != pic_mmcos)
                    fail(CORRUPT, "slices of one picture that mark references differently");
                pic_mmcos = mmcos;
            } else if (!slices.empty() && !pic_mmcos.empty()) {
                fail(CORRUPT, "slices of one picture that mark references differently");
            }
        }
        int qp_delta = b.se();
        qp = p->init_qp + qp_delta;
        if (qp < 0 || qp > 51) fail(CORRUPT, "slice QP %d", qp);
        SliceInfo info;
        if (p->deblocking_filter_control_present) {
            info.dbk_idc = b.ue_max(2, "disable_deblocking_filter_idc");
            if (info.dbk_idc != 1) {
                info.alpha = 2 * b.se();
                info.beta = 2 * b.se();
                if (info.alpha < -12 || info.alpha > 12 || info.beta < -12 || info.beta > 12)
                    fail(CORRUPT, "deblocking offsets %d, %d", info.alpha, info.beta);
            }
        }
        slice_num = int(slices.size());
        slices.push_back(info);
        slice_data(b);
    }


    int poc_of(const Sps* s, bool idr, int ref_idc, int frame_num, int poc_lsb, int delta_bottom,
               const int* delta, bool commit) {
        int poc = 0;
        if (s->poc_type == 0) {
            int msb_prev = idr ? 0 : prev_poc_msb, lsb_prev = idr ? 0 : prev_poc_lsb;
            int max_lsb = 1 << s->log2_max_poc_lsb, msb;
            if (poc_lsb < lsb_prev && lsb_prev - poc_lsb >= max_lsb / 2) msb = msb_prev + max_lsb;
            else if (poc_lsb > lsb_prev && poc_lsb - lsb_prev > max_lsb / 2) msb = msb_prev - max_lsb;
            else msb = msb_prev;
            int top = msb + poc_lsb;
            poc = std::min(top, top + delta_bottom);
            if (commit && ref_idc) {
                prev_poc_msb = msb;
                prev_poc_lsb = poc_lsb;
            }
        } else {
            int max_fn = 1 << s->log2_max_frame_num;
            int offset = idr ? 0 : prev_frame_num_offset + (prev_frame_num > frame_num ? max_fn : 0);
            if (s->poc_type == 1) {
                int n = int(s->offset_for_ref_frame.size());
                int abs_fn = n ? offset + frame_num : 0;
                if (!ref_idc && abs_fn > 0) abs_fn--;
                int expected = 0;
                if (abs_fn > 0) {
                    int delta_cycle = 0;
                    for (int o : s->offset_for_ref_frame) delta_cycle += o;
                    int cycles = (abs_fn - 1) / n, in_cycle = (abs_fn - 1) % n;
                    expected = cycles * delta_cycle;
                    for (int i = 0; i <= in_cycle; i++) expected += s->offset_for_ref_frame[i];
                }
                if (!ref_idc) expected += s->offset_for_non_ref_pic;
                int top = expected + delta[0];
                int bottom = top + s->offset_for_top_to_bottom_field + delta[1];
                poc = std::min(top, bottom);
            } else {
                poc = idr ? 0 : ref_idc ? 2 * (offset + frame_num) : 2 * (offset + frame_num) - 1;
            }
            if (commit) prev_frame_num_offset = offset;
        }
        if (commit) prev_frame_num = frame_num;
        return poc;
    }

    void start_picture(const Sps* s, const Pps* p, int id, bool idr, int ref_idc, int frame_num,
                       int idr_id, int poc_lsb, int delta_bottom, const int* delta) {
        if (!idr && !started) {
            if (broken) fail(CORRUPT, "a picture after a corrupt one, before an IDR picture");
            refuse("a stream or sync sample that does not start with an IDR picture");
        }
        if (mbw && (s->mbw != mbw || s->mbh != mbh)) refuse("a picture size that changes");
        mbw = s->mbw;
        mbh = s->mbh;
        if (idr) {
            if (frame_num != 0) fail(CORRUPT, "an IDR picture of frame_num %d", frame_num);
            refs.clear();
            prev_ref_frame_num = 0;
        } else {
            int max_fn = 1 << s->log2_max_frame_num;
            if (frame_num != (prev_ref_frame_num + 1) % max_fn) {
                if (frame_num == prev_ref_frame_num)
                    fail(CORRUPT, "frame_num %d repeats the previous reference's", frame_num);
                refuse("gaps in frame_num");
            }
        }
        int poc = poc_of(s, idr, ref_idc, frame_num, poc_lsb, delta_bottom, delta, true);
        if (!idr && poc <= last_poc)
            refuse("picture order counts that reorder output (B-frame style)", ITEM "c");
        last_poc = poc;
        started = true;
        sps = s;
        pps = p;
        pps_id = id;
        pic_idr = idr;
        pic_ref_idc = ref_idc;
        pic_frame_num = frame_num;
        pic_idr_id = idr_id;
        pic_poc = poc;
        pic_mmcos.clear();
        cur = std::make_shared<Frame>();
        cur->id = next_id++;
        cur->w = 16 * mbw;
        cur->h = 16 * mbh;
        for (int c = 0; c < 3; c++) cur->px[c].assign(size_t(cur->w) * cur->h / (c ? 4 : 1), 0);
        cur->frame_num = frame_num;
        std::copy(s->crop, s->crop + 4, cur->crop);
        cur->full_range = s->full_range;
        cur->matrix = s->matrix;
        mbs.assign(size_t(mbw) * mbh, Mb());
        slices.clear();
        decoded_mbs = 0;
    }

    void build_list(int num_ref) {
        std::vector<Frame*> all;
        for (auto& f : refs) all.push_back(f.get());
        int max_fn = 1 << sps->log2_max_frame_num;
        auto pic_num = [&](const Frame* f) {
            return f->frame_num > pic_frame_num ? f->frame_num - max_fn : f->frame_num;
        };
        std::stable_sort(all.begin(), all.end(),
                         [&](const Frame* a, const Frame* b) { return pic_num(a) > pic_num(b); });
        if (int(all.size()) < num_ref)
            fail(CORRUPT, "%d active references where %d pictures are held", num_ref,
                 int(all.size()));
        all.resize(size_t(num_ref));
        list = all;
    }

    void modify_list(Bits& b) {
        int max_fn = 1 << sps->log2_max_frame_num;
        int pred = pic_frame_num;  // CurrPicNum
        int n = int(list.size());
        for (int idx = 0;; idx++) {
            uint32_t op = b.ue_max(5, "modification_of_pic_nums_idc");
            if (op == 3) break;
            if (op == 2) refuse("long-term references");
            if (op > 3) refuse("inter-view reference list modification");
            if (idx >= n) fail(CORRUPT, "more reference list modifications than references");
            int diff = int(b.ue_max(uint32_t(max_fn - 1), "abs_diff_pic_num_minus1")) + 1;
            int no_wrap = op == 0 ? pred - diff : pred + diff;
            if (no_wrap < 0) no_wrap += max_fn;
            if (no_wrap >= max_fn) no_wrap -= max_fn;
            pred = no_wrap;
            int pic_num = no_wrap > pic_frame_num ? no_wrap - max_fn : no_wrap;
            Frame* pick = nullptr;
            for (auto& f : refs) {
                int pn = f->frame_num > pic_frame_num ? f->frame_num - max_fn : f->frame_num;
                if (pn == pic_num) pick = f.get();
            }
            if (!pick) fail(CORRUPT, "a reference list modification to a picture not held");
            std::vector<Frame*> next(list.begin(), list.begin() + idx);
            next.push_back(pick);
            for (int k = idx; k < n; k++)
                if (list[k] != pick) next.push_back(list[k]);
            next.resize(size_t(n));
            list = next;
        }
    }

    bool avail(int mx, int my) const {
        return mx >= 0 && my >= 0 && mx < mbw && my < mbh && mbs[size_t(my) * mbw + mx].slice == slice_num;
    }
    bool avail_intra(int mx, int my) const {
        return avail(mx, my) && (!pps->constrained_intra_pred || mbs[size_t(my) * mbw + mx].intra());
    }

    void slice_data(Bits& b) {
        int total = mbw * mbh;
        for (;;) {
            if (slice_type == 0) {
                uint32_t run = b.ue();
                if (run > uint32_t(total - decoded_mbs)) fail(CORRUPT, "mb_skip_run past the picture");
                for (uint32_t k = 0; k < run; k++) macroblock(b, true);
                if (run && !b.more()) break;
            }
            if (decoded_mbs >= total) fail(CORRUPT, "macroblocks past the picture's last");
            macroblock(b, false);
            if (!b.more()) break;
        }
    }

    // -- macroblocks -----------------------------------------------------------------

    int mb_qp_delta(Bits& b) {
        int dq = b.se();
        if (dq < -26 || dq > 25) fail(CORRUPT, "mb_qp_delta %d", dq);
        qp = (qp + dq + 52) % 52;
        return qp;
    }

    // total_coeff of the 4x4 block at (bx, by) of macroblock (mx, my) relative
    // coordinates: -1 if not available
    int nz_at(int mx, int my, int bx, int by, int plane) const {
        int n = plane ? 2 : 4;
        if (bx < 0) { mx--; bx += n; }
        if (by < 0) { my--; by += n; }
        if (!avail(mx, my)) return -1;
        const Mb& m = mbs[size_t(my) * mbw + mx];
        return plane ? m.nz[16 + 4 * (plane - 1) + by * 2 + bx] : m.nz[by * 4 + bx];
    }

    int nc(int mx, int my, int bx, int by, int plane) const {
        int a = nz_at(mx, my, bx - 1, by, plane), b = nz_at(mx, my, bx, by - 1, plane);
        if (a >= 0 && b >= 0) return (a + b + 1) >> 1;
        if (a >= 0) return a;
        if (b >= 0) return b;
        return 0;
    }

    // residual_block_cavlc: levels into coef[start + scan position]
    int block(Bits& b, int nC, int max_coeff, int* coef) {
        const Tables& t = tables();
        int sym;
        if (nC < 0) sym = b.vlc(t.chroma_dc, "coeff_token");
        else sym = b.vlc(t.coeff[nC < 2 ? 0 : nC < 4 ? 1 : nC < 8 ? 2 : 3], "coeff_token");
        int total = sym >> 2, ones = sym & 3;
        if (total > max_coeff) fail(CORRUPT, "%d coefficients in a block of %d", total, max_coeff);
        for (int i = 0; i < max_coeff; i++) coef[i] = 0;
        if (!total) return 0;
        int level[16];
        int suffix_len = total > 10 && ones < 3 ? 1 : 0;
        for (int i = 0; i < total; i++) {
            if (i < ones) {
                level[i] = b.flag() ? -1 : 1;
                continue;
            }
            int prefix = 0;
            while (!b.flag())
                if (++prefix > 25) fail(CORRUPT, "a level_prefix over 25");
            int code = std::min(15, prefix) << suffix_len;
            if (suffix_len > 0 || prefix >= 14) {
                int size = prefix == 14 && suffix_len == 0 ? 4 : prefix >= 15 ? prefix - 3 : suffix_len;
                if (size) code += int(b.u(size));
            }
            if (prefix >= 15 && suffix_len == 0) code += 15;
            if (prefix >= 16) code += (1 << (prefix - 3)) - 4096;
            if (i == ones && ones < 3) code += 2;
            level[i] = (code & 1) ? (-code - 1) >> 1 : (code + 2) >> 1;
            if (suffix_len == 0) suffix_len = 1;
            if (std::abs(level[i]) > (3 << (suffix_len - 1)) && suffix_len < 6) suffix_len++;
        }
        int zeros = 0;
        if (total < max_coeff) {
            zeros = max_coeff == 4 ? b.vlc(t.chroma_zeros[total - 1], "total_zeros")
                                   : b.vlc(t.zeros[total - 1], "total_zeros");
            if (zeros > max_coeff - total) fail(CORRUPT, "total_zeros %d", zeros);
        }
        int pos = total + zeros - 1;
        for (int i = 0; i < total; i++) {
            int run = 0;
            if (zeros > 0 && i < total - 1) {
                run = b.vlc(t.run[std::min(zeros, 7) - 1], "run_before");
                if (run > zeros) fail(CORRUPT, "run_before %d over %d zeros", run, zeros);
            }
            coef[pos] = level[i];
            zeros -= run;
            pos -= run + 1;
        }
        return total;
    }

    void residual(Bits& b, Mb& m, int mx, int my, int cbp, bool i16) {
        int lv[16];
        m.cbp = uint8_t(cbp);
        if (i16) {
            block(b, nc(mx, my, 0, 0, 0), 16, lv);
            for (int k = 0; k < 16; k++) res.dc[ZIGZAG4[k]] = lv[k];
        }
        for (int b8 = 0; b8 < 4; b8++) {
            for (int i4 = 0; i4 < 4; i4++) {
                int blk = 4 * b8 + i4, bx = zx(blk), by = zy(blk);
                int* dst = res.luma[by * 4 + bx];
                int n = 0;
                if (cbp & (1 << b8)) {
                    if (i16) {
                        n = block(b, nc(mx, my, bx, by, 0), 15, lv);
                        dst[0] = 0;
                        for (int k = 0; k < 15; k++) dst[ZIGZAG4[k + 1]] = lv[k];
                    } else {
                        n = block(b, nc(mx, my, bx, by, 0), 16, lv);
                        if (m.t8) {
                            for (int k = 0; k < 16; k++) res.luma8[b8][ZIGZAG8[4 * k + i4]] = lv[k];
                        } else {
                            for (int k = 0; k < 16; k++) dst[ZIGZAG4[k]] = lv[k];
                        }
                    }
                } else {
                    std::fill(dst, dst + 16, 0);
                    if (m.t8) std::fill(res.luma8[b8], res.luma8[b8] + 64, 0);
                }
                m.nz[by * 4 + bx] = uint8_t(n);
            }
        }
        for (int c = 0; c < 2; c++) {
            if (cbp & 0x30) {
                block(b, -1, 4, lv);
                for (int k = 0; k < 4; k++) res.cdc[c][k] = lv[k];
            } else {
                std::fill(res.cdc[c], res.cdc[c] + 4, 0);
            }
        }
        for (int c = 0; c < 2; c++)
            for (int k = 0; k < 4; k++) {
                int* dst = res.cac[c][k];
                std::fill(dst, dst + 16, 0);
                int n = 0;
                if ((cbp >> 4) == 2) {
                    n = block(b, nc(mx, my, k & 1, k >> 1, c + 1), 15, lv);
                    for (int i = 0; i < 15; i++) dst[ZIGZAG4[i + 1]] = lv[i];
                }
                m.nz[16 + 4 * c + k] = uint8_t(n);
            }
        // deblocking's coded blocks: 4x4 blocks, or whole 8x8 blocks of an 8x8 transform
        m.coded = 0;
        for (int k = 0; k < 16; k++)
            if (m.nz[k]) m.coded |= uint16_t(1 << k);
        if (m.t8)
            for (int b8 = 0; b8 < 4; b8++) {
                uint16_t mask = uint16_t(0x33 << ((b8 & 1) * 2 + (b8 >> 1) * 8));
                if (m.coded & mask) m.coded |= mask;
            }
    }

    // -- reconstruction -------------------------------------------------------------

    void add_luma4(int* lv, int q, uint8_t* dst, int stride, bool has_dc, int dc) {
        int c[16];
        bool any = has_dc && dc;
        for (int k = 0; k < 16; k++) {
            c[k] = lv[k] * (DEQ4[q % 6][tables().class4[k]] << (q / 6));
            any |= lv[k] != 0;
        }
        if (has_dc) c[0] = dc;
        if (any) idct4_add(c, dst, stride);
    }

    void add_luma8(int* lv, int q, uint8_t* dst, int stride) {
        int c[64];
        bool any = false;
        for (int k = 0; k < 64; k++) {
            int ls = 16 * DEQ8[q % 6][tables().class8[k]];
            c[k] = q >= 36 ? lv[k] * (ls << (q / 6 - 6))
                           : (lv[k] * ls + (1 << (5 - q / 6))) >> (6 - q / 6);
            any |= lv[k] != 0;
        }
        if (any) idct8_add(c, dst, stride);
    }

    void luma_dc(int q, int* dcy) {
        int t[16], f[16];
        for (int i = 0; i < 4; i++) {
            const int* c = res.dc + 4 * i;
            t[4 * i + 0] = c[0] + c[1] + c[2] + c[3];
            t[4 * i + 1] = c[0] + c[1] - c[2] - c[3];
            t[4 * i + 2] = c[0] - c[1] - c[2] + c[3];
            t[4 * i + 3] = c[0] - c[1] + c[2] - c[3];
        }
        for (int j = 0; j < 4; j++) {
            int a = t[j], b = t[4 + j], c = t[8 + j], d = t[12 + j];
            f[j] = a + b + c + d;
            f[4 + j] = a + b - c - d;
            f[8 + j] = a - b - c + d;
            f[12 + j] = a - b + c - d;
        }
        int ls = 16 * DEQ4[q % 6][0];
        for (int k = 0; k < 16; k++)
            dcy[k] = q >= 36 ? f[k] * (ls << (q / 6 - 6)) : (f[k] * ls + (1 << (5 - q / 6))) >> (6 - q / 6);
    }

    void chroma_residual(const Mb& m, int mx, int my) {
        for (int c = 0; c < 2; c++) {
            int qc = QPC[clip3(0, 51, m.qp + pps->chroma_qp_offset[c])];
            const int* d = res.cdc[c];
            int f[4] = {d[0] + d[1] + d[2] + d[3], d[0] - d[1] + d[2] - d[3],
                        d[0] + d[1] - d[2] - d[3], d[0] - d[1] - d[2] + d[3]};
            int ls = 16 * DEQ4[qc % 6][0];
            int stride = cur->stride(c + 1);
            uint8_t* base = cur->plane(c + 1) + size_t(8 * my) * stride + 8 * mx;
            for (int k = 0; k < 4; k++) {
                int dc = (f[k] * (ls << (qc / 6))) >> 5;
                add_luma4(res.cac[c][k], qc, base + (k >> 1) * 4 * stride + (k & 1) * 4, stride,
                          true, dc);
            }
        }
    }

    // the unfiltered neighbours of an NxN luma block at (x, y) in the picture
    void gather(int x, int y, int N, bool has_top, bool has_left, bool has_tl, bool has_tr,
                int* top, int* left) {
        const uint8_t* P = cur->plane(0);
        int W = cur->w;
        if (has_top) {
            for (int k = 0; k < N; k++) top[k + 1] = P[size_t(y - 1) * W + x + k];
            for (int k = N; k < 2 * N; k++)
                top[k + 1] = has_tr ? P[size_t(y - 1) * W + x + k] : top[N];
        }
        if (has_left)
            for (int k = 0; k < N; k++) left[k + 1] = P[size_t(y + k) * W + x - 1];
        if (has_tl) top[0] = left[0] = P[size_t(y - 1) * W + x - 1];
    }

    void intra_block(int mx, int my, int bx, int by, int N, int mode) {
        // availability of the neighbouring samples (bx, by in 4x4 units)
        int s = N / 4;
        auto inside_done = [&](int nx, int ny) {  // a block of this MB decoded before (bx, by)
            if (N == 4) return zidx(nx, ny) < zidx(bx, by);
            return (ny / 2) * 2 + nx / 2 < (by / 2) * 2 + bx / 2;
        };
        auto nb = [&](int nx, int ny) {  // 4x4 units relative to this MB
            if (ny < 0) {
                if (nx < 0) return avail_intra(mx - 1, my - 1);
                if (nx >= 4) return avail_intra(mx + 1, my - 1);
                return avail_intra(mx, my - 1);
            }
            if (nx < 0) return avail_intra(mx - 1, my);
            if (nx >= 4) return false;
            return inside_done(nx, ny);
        };
        bool has_top = nb(bx, by - 1), has_left = nb(bx - 1, by), has_tl = nb(bx - 1, by - 1);
        bool has_tr = nb(bx + s, by - 1);
        bool need_top = mode == 0 || mode == 3 || mode == 4 || mode == 5 || mode == 6 || mode == 7;
        bool need_left = mode == 1 || mode == 4 || mode == 5 || mode == 6 || mode == 8;
        bool need_tl = mode == 4 || mode == 5 || mode == 6;
        if ((need_top && !has_top) || (need_left && !has_left) || (need_tl && !has_tl))
            fail(CORRUPT, "intra %dx%d mode %d from samples not available", N, N, mode);
        int top[17] = {0}, left[9] = {0};
        int x = 16 * mx + 4 * bx, y = 16 * my + 4 * by;
        gather(x, y, N, has_top, has_left, has_tl, has_tr, top, left);
        if (N == 8) {  // reference sample filtering (8.3.2.2.1)
            int ft[17], fl[9];
            std::copy(top, top + 17, ft);
            std::copy(left, left + 9, fl);
            if (has_top) {
                ft[1] = has_tl ? (top[0] + 2 * top[1] + top[2] + 2) >> 2 : (3 * top[1] + top[2] + 2) >> 2;
                for (int k = 1; k < 15; k++) ft[k + 1] = (top[k] + 2 * top[k + 1] + top[k + 2] + 2) >> 2;
                ft[16] = (top[15] + 3 * top[16] + 2) >> 2;
            }
            if (has_tl) {
                if (has_top && has_left) ft[0] = (top[1] + 2 * top[0] + left[1] + 2) >> 2;
                else if (has_top) ft[0] = (3 * top[0] + top[1] + 2) >> 2;
                else if (has_left) ft[0] = (3 * top[0] + left[1] + 2) >> 2;
                fl[0] = ft[0];
            }
            if (has_left) {
                fl[1] = has_tl ? (left[0] + 2 * left[1] + left[2] + 2) >> 2 : (3 * left[1] + left[2] + 2) >> 2;
                for (int k = 1; k < 7; k++) fl[k + 1] = (left[k] + 2 * left[k + 1] + left[k + 2] + 2) >> 2;
                fl[8] = (left[7] + 3 * left[8] + 2) >> 2;
            }
            std::copy(ft, ft + 17, top);
            std::copy(fl, fl + 9, left);
        }
        intra_nxn(N, mode, top, left, has_top, has_left, cur->plane(0) + size_t(y) * cur->w + x,
                  cur->w);
    }

    void intra16(int mx, int my, int mode) {
        bool top = avail_intra(mx, my - 1), left = avail_intra(mx - 1, my);
        bool tl = avail_intra(mx - 1, my - 1);
        if ((mode == 0 && !top) || (mode == 1 && !left) || (mode == 3 && !(top && left && tl)))
            fail(CORRUPT, "intra 16x16 mode %d from samples not available", mode);
        int W = cur->w;
        uint8_t* d = cur->plane(0) + size_t(16 * my) * W + 16 * mx;
        predict_plane(d, W, 16, mode == 0 ? 0 : mode == 1 ? 1 : mode == 2 ? 2 : 3, top, left);
    }

    // 16x16 luma (n 16) or 8x8 chroma (n 8): mode 0 V, 1 H, 2 DC, 3 plane
    void predict_plane(uint8_t* d, int W, int n, int mode, bool top, bool left) {
        const uint8_t* T = d - W;
        auto L = [&](int y) { return int(d[y * W - 1]); };
        if (mode == 0) {
            for (int y = 0; y < n; y++) memcpy(d + y * W, T, size_t(n));
        } else if (mode == 1) {
            for (int y = 0; y < n; y++) memset(d + y * W, L(y), size_t(n));
        } else if (mode == 3) {
            int h = 0, v = 0, half = n / 2;
            for (int k = 0; k < half; k++) {
                h += (k + 1) * (T[half + k] - (half - 2 - k >= 0 ? T[half - 2 - k] : T[-1]));
                v += (k + 1) * (L(half + k) - (half - 2 - k >= 0 ? L(half - 2 - k) : T[-1]));
            }
            int a = 16 * (L(n - 1) + T[n - 1]);
            int b = n == 16 ? (5 * h + 32) >> 6 : (34 * h + 32) >> 6;
            int c = n == 16 ? (5 * v + 32) >> 6 : (34 * v + 32) >> 6;
            for (int y = 0; y < n; y++)
                for (int x = 0; x < n; x++)
                    d[y * W + x] = clip_u8((a + b * (x - half + 1) + c * (y - half + 1) + 16) >> 5);
        } else if (n == 16) {
            int s = 0, v;
            if (top && left) {
                for (int k = 0; k < 16; k++) s += T[k] + L(k);
                v = (s + 16) >> 5;
            } else if (left) {
                for (int k = 0; k < 16; k++) s += L(k);
                v = (s + 8) >> 4;
            } else if (top) {
                for (int k = 0; k < 16; k++) s += T[k];
                v = (s + 8) >> 4;
            } else {
                v = 128;
            }
            for (int y = 0; y < 16; y++) memset(d + y * W, v, 16);
        } else {  // chroma DC, a 4x4 block at a time (8.3.4.1-3)
            for (int by = 0; by < 2; by++)
                for (int bx = 0; bx < 2; bx++) {
                    int st = 0, sl = 0;
                    for (int k = 0; k < 4; k++) {
                        st += top ? T[4 * bx + k] : 0;
                        sl += left ? L(4 * by + k) : 0;
                    }
                    int v;
                    bool both_first = (bx == 0 && by == 0) || (bx == 1 && by == 1);
                    if (both_first && top && left) v = (st + sl + 4) >> 3;
                    else if (both_first && top) v = (st + 2) >> 2;
                    else if (both_first && left) v = (sl + 2) >> 2;
                    else if (bx == 1 && by == 0 && top) v = (st + 2) >> 2;
                    else if (bx == 1 && by == 0 && left) v = (sl + 2) >> 2;
                    else if (bx == 0 && by == 1 && left) v = (sl + 2) >> 2;
                    else if (bx == 0 && by == 1 && top) v = (st + 2) >> 2;
                    else v = 128;
                    for (int y = 0; y < 4; y++) memset(d + (4 * by + y) * W + 4 * bx, v, 4);
                }
        }
    }

    void intra_chroma(int mx, int my, int mode) {
        bool top = avail_intra(mx, my - 1), left = avail_intra(mx - 1, my);
        bool tl = avail_intra(mx - 1, my - 1);
        // intra_chroma_pred_mode: 0 DC, 1 horizontal, 2 vertical, 3 plane
        if ((mode == 1 && !left) || (mode == 2 && !top) || (mode == 3 && !(top && left && tl)))
            fail(CORRUPT, "intra chroma mode %d from samples not available", mode);
        int as_plane = mode == 0 ? 2 : mode == 1 ? 1 : mode == 2 ? 0 : 3;
        for (int c = 1; c < 3; c++) {
            int W = cur->stride(c);
            predict_plane(cur->plane(c) + size_t(8 * my) * W + 8 * mx, W, 8, as_plane, top, left);
        }
    }

    // -- inter prediction ----------------------------------------------------------

    void mc(const Frame* ref, int x, int y, int w, int h, int mvx, int mvy) {
        int W = cur->w, H = cur->h;
        const uint8_t* R = ref->px[0].data();
        auto G = [&](int xx, int yy) {
            return int(R[size_t(clip3(0, H - 1, yy)) * W + clip3(0, W - 1, xx)]);
        };
        int xi = x + (mvx >> 2), yi = y + (mvy >> 2), fx = mvx & 3, fy = mvy & 3;
        uint8_t* dst = cur->plane(0) + size_t(y) * W + x;
        // the window of integer samples each output needs: (-2..+3) around
        int win[21 + 5][21 + 5];
        for (int j = 0; j < h + 5; j++)
            for (int i = 0; i < w + 5; i++) win[j][i] = G(xi + i - 2, yi + j - 2);
        auto S = [&](int i, int j) { return win[j + 2][i + 2]; };
        auto tap = [](int a, int b, int c, int d, int e, int f) { return a - 5 * b + 20 * c + 20 * d - 5 * e + f; };
        auto b1 = [&](int i, int j) { return tap(S(i - 2, j), S(i - 1, j), S(i, j), S(i + 1, j), S(i + 2, j), S(i + 3, j)); };
        auto h1 = [&](int i, int j) { return tap(S(i, j - 2), S(i, j - 1), S(i, j), S(i, j + 1), S(i, j + 2), S(i, j + 3)); };
        auto hb = [&](int i, int j) { return int(clip_u8((b1(i, j) + 16) >> 5)); };  // b at (i+1/2, j)
        auto hh = [&](int i, int j) { return int(clip_u8((h1(i, j) + 16) >> 5)); };  // h at (i, j+1/2)
        auto hj = [&](int i, int j) {
            int v = tap(b1(i, j - 2), b1(i, j - 1), b1(i, j), b1(i, j + 1), b1(i, j + 2), b1(i, j + 3));
            return int(clip_u8((v + 512) >> 10));
        };
        for (int j = 0; j < h; j++)
            for (int i = 0; i < w; i++) {
                int v;
                switch (fy * 4 + fx) {
                case 0: v = S(i, j); break;
                case 1: v = (S(i, j) + hb(i, j) + 1) >> 1; break;
                case 2: v = hb(i, j); break;
                case 3: v = (S(i + 1, j) + hb(i, j) + 1) >> 1; break;
                case 4: v = (S(i, j) + hh(i, j) + 1) >> 1; break;
                case 5: v = (hb(i, j) + hh(i, j) + 1) >> 1; break;
                case 6: v = (hb(i, j) + hj(i, j) + 1) >> 1; break;
                case 7: v = (hb(i, j) + hh(i + 1, j) + 1) >> 1; break;
                case 8: v = hh(i, j); break;
                case 9: v = (hh(i, j) + hj(i, j) + 1) >> 1; break;
                case 10: v = hj(i, j); break;
                case 11: v = (hj(i, j) + hh(i + 1, j) + 1) >> 1; break;
                case 12: v = (S(i, j + 1) + hh(i, j) + 1) >> 1; break;
                case 13: v = (hh(i, j) + hb(i, j + 1) + 1) >> 1; break;
                case 14: v = (hj(i, j) + hb(i, j + 1) + 1) >> 1; break;
                default: v = (hh(i + 1, j) + hb(i, j + 1) + 1) >> 1; break;
                }
                dst[size_t(j) * W + i] = uint8_t(v);
            }
        // chroma: eighth-sample bilinear
        int cw = W / 2, ch = H / 2;
        int cx = x / 2, cy = y / 2, fxc = mvx & 7, fyc = mvy & 7;
        int xc = cx + (mvx >> 3), yc = cy + (mvy >> 3);
        for (int c = 1; c < 3; c++) {
            const uint8_t* Rc = ref->px[c].data();
            auto C = [&](int xx, int yy) {
                return int(Rc[size_t(clip3(0, ch - 1, yy)) * cw + clip3(0, cw - 1, xx)]);
            };
            uint8_t* dc = cur->plane(c) + size_t(cy) * cw + cx;
            for (int j = 0; j < h / 2; j++)
                for (int i = 0; i < w / 2; i++) {
                    int A = C(xc + i, yc + j), B = C(xc + i + 1, yc + j);
                    int Cc = C(xc + i, yc + j + 1), D = C(xc + i + 1, yc + j + 1);
                    dc[size_t(j) * cw + i] = uint8_t(((8 - fxc) * (8 - fyc) * A + fxc * (8 - fyc) * B +
                                                      (8 - fxc) * fyc * Cc + fxc * fyc * D + 32) >> 6);
                }
        }
    }

    struct Nb {
        bool avail;
        int ref;
        int mv[2];
    };

    // the neighbouring partition covering luma sample (x, y) relative to
    // macroblock (mx, my); `done` marks this macroblock's 4x4 blocks decoded
    Nb neighbour(int mx, int my, int x, int y, const Mb& m, uint16_t done) const {
        Nb n{false, -1, {0, 0}};
        const Mb* src;
        int bx, by;
        if (y < 0) {
            int nmx = x < 0 ? mx - 1 : x >= 16 ? mx + 1 : mx;
            if (!avail(nmx, my - 1)) return n;
            src = &mbs[size_t(my - 1) * mbw + nmx];
            bx = ((x + 16) & 15) >> 2;
            by = 3;
        } else if (x < 0) {
            if (!avail(mx - 1, my)) return n;
            src = &mbs[size_t(my) * mbw + mx - 1];
            bx = 3;
            by = y >> 2;
        } else {
            if (x >= 16) return n;
            bx = x >> 2;
            by = y >> 2;
            if (!(done & (1 << (by * 4 + bx)))) return n;
            src = &m;
        }
        n.avail = true;
        int k = by * 4 + bx;
        if (src->intra()) return n;
        n.ref = src->ref[k];
        n.mv[0] = src->mv[k][0];
        n.mv[1] = src->mv[k][1];
        return n;
    }

    // mvpLX of a partition at (x, y) of w x h in macroblock (mx, my) (8.4.1.3)
    void mvp(int mx, int my, int x, int y, int w, int h, int ref, const Mb& m, uint16_t done,
             int* out) {
        Nb A = neighbour(mx, my, x - 1, y, m, done);
        Nb B = neighbour(mx, my, x, y - 1, m, done);
        Nb C = neighbour(mx, my, x + w, y - 1, m, done);
        if (!C.avail) C = neighbour(mx, my, x - 1, y - 1, m, done);
        if (w == 16 && h == 8) {
            const Nb& d = y == 0 ? B : A;
            if (d.ref == ref) {
                out[0] = d.mv[0];
                out[1] = d.mv[1];
                return;
            }
        } else if (w == 8 && h == 16) {
            const Nb& d = x == 0 ? A : C;
            if (d.ref == ref) {
                out[0] = d.mv[0];
                out[1] = d.mv[1];
                return;
            }
        }
        if (!B.avail && !C.avail && A.avail) B = C = A;
        int match = (A.ref == ref) + (B.ref == ref) + (C.ref == ref);
        if (match == 1) {
            const Nb& d = A.ref == ref ? A : B.ref == ref ? B : C;
            out[0] = d.mv[0];
            out[1] = d.mv[1];
            return;
        }
        for (int c = 0; c < 2; c++) out[c] = median3(A.mv[c], B.mv[c], C.mv[c]);
    }

    void set_motion(Mb& m, int x, int y, int w, int h, int ref, const int* mv, uint16_t* done) {
        for (int by = y / 4; by < (y + h) / 4; by++)
            for (int bx = x / 4; bx < (x + w) / 4; bx++) {
                int k = by * 4 + bx;
                m.mv[k][0] = int16_t(mv[0]);
                m.mv[k][1] = int16_t(mv[1]);
                m.ref[k] = int8_t(ref);
                m.refpic[k] = list[size_t(ref)]->id;
                *done |= uint16_t(1 << k);
            }
    }

    int ref_idx(Bits& b, int num_ref) {
        if (num_ref == 2) return b.flag() ? 0 : 1;
        return int(b.ue_max(uint32_t(num_ref - 1), "ref_idx_l0"));
    }

    void mvd(Bits& b, int* d) {
        d[0] = b.se();
        d[1] = b.se();
        if (std::abs(d[0]) > 8192 || std::abs(d[1]) > 8192) fail(CORRUPT, "an mvd out of range");
    }

    void motion_add(int* mv, const int* pred, const int* d) {
        for (int c = 0; c < 2; c++) {
            mv[c] = pred[c] + d[c];
            if (mv[c] < -16384 || mv[c] > 16383) fail(CORRUPT, "a motion vector out of range");
        }
    }

    // -- one macroblock -------------------------------------------------------------

    void macroblock(Bits& b, bool skipped) {
        int addr = decoded_mbs++;
        int mx = addr % mbw, my = addr / mbw;
        Mb& m = mbs[size_t(addr)];
        m = Mb();
        m.slice = slice_num;
        std::fill(m.ipred, m.ipred + 16, int8_t(-1));
        if (skipped) {  // P_Skip
            m.qp = qp;
            uint16_t done = 0;
            Nb A = neighbour(mx, my, -1, 0, m, 0), B = neighbour(mx, my, 0, -1, m, 0);
            int mv[2] = {0, 0};
            if (A.avail && B.avail && !(A.ref == 0 && !A.mv[0] && !A.mv[1]) &&
                !(B.ref == 0 && !B.mv[0] && !B.mv[1]))
                mvp(mx, my, 0, 0, 16, 16, 0, m, 0, mv);
            set_motion(m, 0, 0, 16, 16, 0, mv, &done);
            mc(list[0], 16 * mx, 16 * my, 16, 16, mv[0], mv[1]);
            return;
        }
        int mb_type = int(b.ue_max(slice_type == 0 ? 30 : 25, "mb_type"));
        if (slice_type == 0 && mb_type < 5) {
            inter_mb(b, m, mx, my, mb_type);
            return;
        }
        if (slice_type == 0) mb_type -= 5;
        if (mb_type == 25) {
            pcm(b, m, mx, my);
            return;
        }
        if (mb_type == 0) {
            m.t8 = pps->transform_8x8_mode && b.flag();
            m.kind = m.t8 ? I_8x8 : I_4x4;
            int n = m.t8 ? 4 : 16;
            int modes[16];
            for (int k = 0; k < n; k++) {
                int blk = m.t8 ? 4 * k : k;
                int bx = zx(blk), by = zy(blk);
                int pred = predicted_mode(mx, my, bx, by, m);
                int mode = pred;
                if (!b.flag()) {
                    int rem = int(b.u(3));
                    mode = rem < pred ? rem : rem + 1;
                }
                modes[k] = mode;
                int s = m.t8 ? 2 : 1;
                for (int y = by; y < by + s; y++)
                    for (int x = bx; x < bx + s; x++) m.ipred[y * 4 + x] = int8_t(mode);
            }
            int cmode = int(b.ue_max(3, "intra_chroma_pred_mode"));
            int cbp = INTRA_CBP[b.ue_max(47, "coded_block_pattern")];
            m.qp = qp;
            if (cbp) m.qp = mb_qp_delta(b);
            residual(b, m, mx, my, cbp, false);
            int W = cur->w;
            for (int k = 0; k < n; k++) {
                int blk = m.t8 ? 4 * k : k;
                int bx = zx(blk), by = zy(blk);
                intra_block(mx, my, bx, by, m.t8 ? 8 : 4, modes[k]);
                uint8_t* dst = cur->plane(0) + size_t(16 * my + 4 * by) * W + 16 * mx + 4 * bx;
                if (m.t8) add_luma8(res.luma8[k], m.qp, dst, W);
                else add_luma4(res.luma[by * 4 + bx], m.qp, dst, W, false, 0);
            }
            intra_chroma(mx, my, cmode);
            chroma_residual(m, mx, my);
            return;
        }
        // Intra_16x16
        m.kind = I_16x16;
        int t = mb_type - 1;
        int mode = t % 4, cbp = (((t / 4) % 3) << 4) | (t >= 12 ? 15 : 0);
        int cmode = int(b.ue_max(3, "intra_chroma_pred_mode"));
        m.qp = mb_qp_delta(b);
        residual(b, m, mx, my, cbp, true);
        intra16(mx, my, mode);
        int dcy[16];
        luma_dc(m.qp, dcy);
        int W = cur->w;
        for (int k = 0; k < 16; k++) {
            int bx = k & 3, by = k >> 2;
            add_luma4(res.luma[k], m.qp, cur->plane(0) + size_t(16 * my + 4 * by) * W + 16 * mx + 4 * bx,
                      W, true, dcy[k]);
        }
        intra_chroma(mx, my, cmode);
        chroma_residual(m, mx, my);
    }

    // Intra4x4PredMode / Intra8x8PredMode predicted for block (bx, by) (8.3.1.1)
    int predicted_mode(int mx, int my, int bx, int by, const Mb& m) const {
        auto mode_at = [&](int nx, int ny, bool* dc) {
            int amx = mx, amy = my;
            if (nx < 0) { amx--; nx += 4; }
            if (ny < 0) { amy--; ny += 4; }
            if (amx == mx && amy == my) return int(m.ipred[ny * 4 + nx]);
            if (!avail(amx, amy)) { *dc = true; return 2; }
            const Mb& n = mbs[size_t(amy) * mbw + amx];
            if (!n.intra() && pps->constrained_intra_pred) { *dc = true; return 2; }
            if (n.kind != I_4x4 && n.kind != I_8x8) return 2;
            return int(n.ipred[ny * 4 + nx]);
        };
        bool dc = false;
        int a = mode_at(bx - 1, by, &dc), b = mode_at(bx, by - 1, &dc);
        return dc ? 2 : std::min(a, b);
    }

    void pcm(Bits& b, Mb& m, int mx, int my) {
        m.kind = I_PCM;
        m.qp = 0;  // QPY for deblocking; the slice's QP carries on
        b.skip(int((8 - (b.pos & 7)) & 7));
        for (int c = 0; c < 3; c++) {
            int n = c ? 8 : 16, W = cur->stride(c);
            uint8_t* d = cur->plane(c) + size_t(n * my) * W + n * mx;
            for (int y = 0; y < n; y++)
                for (int x = 0; x < n; x++) d[y * W + x] = uint8_t(b.u(8));
        }
        std::fill(m.nz, m.nz + 24, uint8_t(16));
        m.coded = 0xFFFF;
    }

    void inter_mb(Bits& b, Mb& m, int mx, int my, int mb_type) {
        m.kind = P_INTER;
        int num_ref = int(list.size());
        uint16_t done = 0;
        bool small_parts = false;
        struct Part {
            int x, y, w, h, ref, d[2];
        };
        std::vector<Part> parts;
        if (mb_type < 3) {
            int n = mb_type == 0 ? 1 : 2;
            int w = mb_type == 2 ? 8 : 16, h = mb_type == 1 ? 8 : 16;
            int refs[2] = {0, 0};
            for (int k = 0; k < n; k++) refs[k] = num_ref > 1 ? ref_idx(b, num_ref) : 0;
            for (int k = 0; k < n; k++) {
                Part p{mb_type == 2 ? 8 * k : 0, mb_type == 1 ? 8 * k : 0, w, h, refs[k], {0, 0}};
                mvd(b, p.d);
                parts.push_back(p);
            }
        } else {
            int sub[4], refs[4] = {0, 0, 0, 0};
            for (int k = 0; k < 4; k++) sub[k] = int(b.ue_max(3, "sub_mb_type"));
            if (num_ref > 1 && mb_type == 3)
                for (int k = 0; k < 4; k++) refs[k] = ref_idx(b, num_ref);
            for (int k = 0; k < 4; k++) {
                int x8 = (k & 1) * 8, y8 = (k >> 1) * 8;
                int w = sub[k] == 0 || sub[k] == 1 ? 8 : 4, h = sub[k] == 0 || sub[k] == 2 ? 8 : 4;
                if (sub[k]) small_parts = true;
                for (int y = 0; y < 8; y += h)
                    for (int x = 0; x < 8; x += w) {
                        Part p{x8 + x, y8 + y, w, h, refs[k], {0, 0}};
                        mvd(b, p.d);
                        parts.push_back(p);
                    }
            }
        }
        for (const Part& p : parts) {
            int pred[2], mv[2];
            mvp(mx, my, p.x, p.y, p.w, p.h, p.ref, m, done, pred);
            motion_add(mv, pred, p.d);
            set_motion(m, p.x, p.y, p.w, p.h, p.ref, mv, &done);
            mc(list[size_t(p.ref)], 16 * mx + p.x, 16 * my + p.y, p.w, p.h, mv[0], mv[1]);
        }
        int cbp = INTER_CBP[b.ue_max(47, "coded_block_pattern")];
        if ((cbp & 15) && pps->transform_8x8_mode && !small_parts) m.t8 = b.flag();
        m.qp = qp;
        if (cbp) m.qp = mb_qp_delta(b);
        residual(b, m, mx, my, cbp, false);
        int W = cur->w;
        for (int k = 0; k < 16; k++) {
            int bx = k & 3, by = k >> 2;
            uint8_t* dst = cur->plane(0) + size_t(16 * my + 4 * by) * W + 16 * mx + 4 * bx;
            if (m.t8) {
                if (!(bx & 1) && !(by & 1)) add_luma8(res.luma8[(by >> 1) * 2 + (bx >> 1)], m.qp, dst, W);
            } else {
                add_luma4(res.luma[k], m.qp, dst, W, false, 0);
            }
        }
        chroma_residual(m, mx, my);
    }

    // -- the end of a picture ---------------------------------------------------------

    void finish_picture() {
        if (decoded_mbs != mbw * mbh)
            fail(CORRUPT, "a picture of %d macroblocks where %d were decoded", mbw * mbh, decoded_mbs);
        deblock();
        if (pic_ref_idc) {
            int max_fn = 1 << sps->log2_max_frame_num;
            for (int d : pic_mmcos) {
                int pic_num = pic_frame_num - d;
                auto it = std::find_if(refs.begin(), refs.end(), [&](const std::shared_ptr<Frame>& f) {
                    int pn = f->frame_num > pic_frame_num ? f->frame_num - max_fn : f->frame_num;
                    return pn == pic_num;
                });
                if (it == refs.end()) fail(CORRUPT, "MMCO 1 of a picture not held");
                refs.erase(it);
            }
            if (pic_mmcos.empty() && !pic_idr &&
                int(refs.size()) >= std::max(sps->max_num_ref_frames, 1)) {
                // sliding window: the short-term reference of the smallest FrameNumWrap
                auto wrap = [&](const std::shared_ptr<Frame>& f) {
                    return f->frame_num > pic_frame_num ? f->frame_num - max_fn : f->frame_num;
                };
                auto oldest = std::min_element(refs.begin(), refs.end(),
                                               [&](auto& a, auto& b) { return wrap(a) < wrap(b); });
                refs.erase(oldest);
            }
            if (int(refs.size()) + 1 > std::max(sps->max_num_ref_frames, 1))
                fail(CORRUPT, "more reference frames than max_num_ref_frames");
            refs.push_back(cur);
            prev_ref_frame_num = pic_frame_num;
        }
        out = cur;
        cur.reset();
        list.clear();
    }

    // -- deblocking (8.7) ---------------------------------------------------------------

    static void filter_edge(uint8_t* p, int step, int across, int n, const int* bs, int bs_len,
                            int qpav, const SliceInfo& s, bool chroma) {
        // p: the first q0 sample; `across` steps from q0 to q1 (p0 is -across);
        // `step` steps along the edge; n samples along it, bs[k] for
        // each n / 4 of them
        int ia = clip3(0, 51, qpav + s.alpha), ib = clip3(0, 51, qpav + s.beta);
        int alpha = ALPHA[ia], beta = BETA[ib];
        for (int k = 0; k < n; k++) {
            int strength = bs[k * bs_len / n];
            if (!strength) continue;
            uint8_t* q = p + k * step;
            int p0 = q[-across], p1 = q[-2 * across], q0 = q[0], q1 = q[across];
            if (!(std::abs(p0 - q0) < alpha && std::abs(p1 - p0) < beta && std::abs(q1 - q0) < beta))
                continue;
            if (chroma) {
                if (strength < 4) {
                    int tc = TC0[ia][strength - 1] + 1;
                    int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
                    q[-across] = clip_u8(p0 + delta);
                    q[0] = clip_u8(q0 - delta);
                } else {
                    q[-across] = uint8_t((2 * p1 + p0 + q1 + 2) >> 2);
                    q[0] = uint8_t((2 * q1 + q0 + p1 + 2) >> 2);
                }
                continue;
            }
            int p2 = q[-3 * across], q2 = q[2 * across];
            int ap = std::abs(p2 - p0), aq = std::abs(q2 - q0);
            if (strength < 4) {
                int tc0 = TC0[ia][strength - 1];
                int tc = tc0 + (ap < beta) + (aq < beta);
                int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
                q[-across] = clip_u8(p0 + delta);
                q[0] = clip_u8(q0 - delta);
                if (ap < beta) q[-2 * across] = uint8_t(p1 + clip3(-tc0, tc0, (p2 + ((p0 + q0 + 1) >> 1) - (p1 << 1)) >> 1));
                if (aq < beta) q[across] = uint8_t(q1 + clip3(-tc0, tc0, (q2 + ((p0 + q0 + 1) >> 1) - (q1 << 1)) >> 1));
            } else {
                int p3 = q[-4 * across], q3 = q[3 * across];
                bool small = std::abs(p0 - q0) < ((alpha >> 2) + 2);
                if (ap < beta && small) {
                    q[-across] = uint8_t((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
                    q[-2 * across] = uint8_t((p2 + p1 + p0 + q0 + 2) >> 2);
                    q[-3 * across] = uint8_t((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
                } else {
                    q[-across] = uint8_t((2 * p1 + p0 + q1 + 2) >> 2);
                }
                if (aq < beta && small) {
                    q[0] = uint8_t((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3);
                    q[across] = uint8_t((p0 + q0 + q1 + q2 + 2) >> 2);
                    q[2 * across] = uint8_t((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3);
                } else {
                    q[0] = uint8_t((2 * q1 + q0 + p1 + 2) >> 2);
                }
            }
        }
    }

    // bS of the 4x4 blocks kp (of p) and kq (of q) across an edge (8.7.2.1)
    static int strength(const Mb& P, int kp, const Mb& Q, int kq, bool mb_edge) {
        if (P.intra() || Q.intra()) return mb_edge ? 4 : 3;
        if (((P.coded >> kp) & 1) || ((Q.coded >> kq) & 1)) return 2;
        if (P.refpic[kp] != Q.refpic[kq]) return 1;
        if (std::abs(P.mv[kp][0] - Q.mv[kq][0]) >= 4 || std::abs(P.mv[kp][1] - Q.mv[kq][1]) >= 4)
            return 1;
        return 0;
    }

    // libavcodec filters as the standard does, but for one shortcut: where
    // both chroma QP offsets are equal it takes h264_filter_mb_fast, which
    // on x86 gives an inter macroblock with the 8x8 transform and
    // coded_block_pattern bits 0-2 set bS 2 on all its edges (4 where the
    // neighbour is intra) without looking at the coefficients: exact under
    // CABAC, not under CAVLC, where a coded 8x8 block may hold only zeros
    void deblock() {
        bool fast = pps->chroma_qp_offset[0] == pps->chroma_qp_offset[1];
        for (int my = 0; my < mbh; my++)
            for (int mx = 0; mx < mbw; mx++) {
                const Mb& Q = mbs[size_t(my) * mbw + mx];
                const SliceInfo& s = slices[size_t(Q.slice)];
                if (s.dbk_idc == 1) continue;
                bool all2 = fast && !Q.intra() && Q.t8 && (Q.cbp & 7) == 7;
                for (int dir = 0; dir < 2; dir++) {  // vertical edges, then horizontal
                    for (int e = 0; e < 4; e++) {
                        if (e && Q.t8 && (e & 1)) continue;
                        const Mb* P = &Q;
                        if (e == 0) {
                            int pmx = dir ? mx : mx - 1, pmy = dir ? my - 1 : my;
                            if (pmx < 0 || pmy < 0) continue;
                            P = &mbs[size_t(pmy) * mbw + pmx];
                            if (s.dbk_idc == 2 && P->slice != Q.slice) continue;
                        }
                        int bs[4];
                        bool any = false;
                        for (int k = 0; k < 4; k++) {
                            int kq = dir ? e * 4 + k : k * 4 + e;
                            int kp = e ? (dir ? kq - 4 : kq - 1) : (dir ? 12 + k : k * 4 + 3);
                            bs[k] = all2 ? (e == 0 && P->intra() ? 4 : 2) : strength(*P, kp, Q, kq, e == 0);
                            any |= bs[k] != 0;
                        }
                        if (!any) continue;
                        int qpp = P->kind == I_PCM ? 0 : P->qp, qpq = Q.kind == I_PCM ? 0 : Q.qp;
                        int W = cur->w;
                        uint8_t* y = cur->plane(0) + size_t(16 * my + (dir ? 4 * e : 0)) * W + 16 * mx +
                                     (dir ? 0 : 4 * e);
                        filter_edge(y, dir ? 1 : W, dir ? W : 1, 16, bs, 4, (qpp + qpq + 1) >> 1, s, false);
                        if (e & 1) continue;  // chroma edges: luma edges 0 and 8
                        for (int c = 0; c < 2; c++) {
                            int off = pps->chroma_qp_offset[c];
                            int cp = QPC[clip3(0, 51, qpp + off)], cq = QPC[clip3(0, 51, qpq + off)];
                            int CW = cur->stride(c + 1);
                            uint8_t* d = cur->plane(c + 1) + size_t(8 * my + (dir ? 2 * e : 0)) * CW +
                                         8 * mx + (dir ? 0 : 2 * e);
                            filter_edge(d, dir ? 1 : CW, dir ? CW : 1, 8, bs, 4, (cp + cq + 1) >> 1, s, true);
                        }
                    }
                }
            }
    }

    // -- output ---------------------------------------------------------------------

    void out_size(int* wh) const {
        const Frame* f = out.get();
        if (f) {
            wh[0] = f->w - f->crop[0] - f->crop[1];
            wh[1] = f->h - f->crop[2] - f->crop[3];
            return;
        }
        wh[0] = wh[1] = 0;
        for (const Sps& s : sps_list)
            if (s.valid) {
                wh[0] = 16 * s.mbw - s.crop[0] - s.crop[1];
                wh[1] = 16 * s.mbh - s.crop[2] - s.crop[3];
                return;
            }
    }

    void to_rgb(uint8_t* rgb) const {
        Frame* f = out.get();
        int wh[2];
        out_size(wh);
        int cs = f->stride(1);
        host::yuv420_to_rgb(f->plane(0) + size_t(f->crop[2]) * f->w + f->crop[0], f->w,
                            f->plane(1) + size_t(f->crop[2] / 2) * cs + f->crop[0] / 2,
                            f->plane(2) + size_t(f->crop[2] / 2) * cs + f->crop[0] / 2, cs, wh[0],
                            wh[1], host::yuv_coeffs(f->matrix, f->full_range), rgb);
    }

    void reset() {  // a seek: libavcodec's flush
        refs.clear();
        out.reset();
        cur.reset();
        started = false;
        last_poc = 0;
    }
};

void copy_msg(char* err, int errlen, const char* msg) {
    if (err && errlen > 0) {
        strncpy(err, msg, size_t(errlen) - 1);
        err[errlen - 1] = 0;
    }
}

template <class F>
int guarded(Decoder* d, char* err, int errlen, F&& body) {
    try {
        body();
        return OK;
    } catch (const Fail& f) {
        if (d) {
            d->reset();
            d->broken = f.rc == CORRUPT;
        }
        copy_msg(err, errlen, f.msg);
        return f.rc;
    } catch (const std::bad_alloc&) {
        if (d) d->reset();
        copy_msg(err, errlen, "out of memory");
        return NOMEM;
    }
}

}  // namespace

extern "C" {

// 0: ok; 1: corrupt or truncated; 2: a stream not decoded here; 3: out of memory.

// A decoder for a stream whose samples hold NAL units behind big-endian
// lengths of `length_size` bytes (1, 2 or 4: avcC), or, with 0, Annex B
// byte streams.  `cfg` is Annex B NAL units whose parameter sets are read
// (the avcC's, or an AVI stream's first sample; other units are skipped).
int h264_open(const uint8_t* cfg, int64_t n, int length_size, void** state, char* err,
              int errlen) {
    Decoder* d = nullptr;
    int rc = guarded(nullptr, err, errlen, [&] {
        tables();
        if (length_size != 0 && length_size != 1 && length_size != 2 && length_size != 4)
            fail(CORRUPT, "a NAL unit length of %d bytes", length_size);
        d = new Decoder();
        d->length_size = length_size;
        if (n > 0) d->headers(cfg, n, 0);
    });
    if (rc != OK) {
        delete d;
        return rc;
    }
    *state = d;
    return OK;
}

// The size of the last picture output (before one: of the first SPS held):
// wh[0] width, wh[1] height, 0 without either.
int h264_size(void* state, int* wh) {
    static_cast<Decoder*>(state)->out_size(wh);
    return OK;
}

// Decode one sample (an access unit).  *shown is `sample` if libavcodec
// outputs a picture for it, -1 if it holds none.
int h264_decode(void* state, const uint8_t* data, int64_t n, int64_t sample, int64_t* shown,
                char* err, int errlen) {
    Decoder* d = static_cast<Decoder*>(state);
    *shown = -1;
    return guarded(d, err, errlen, [&] { *shown = d->decode(data, n, sample); });
}

// The last picture output, cropped, as height x width x 3 RGB into `rgb`;
// 1 if there is none.
int h264_rgb(void* state, uint8_t* rgb) {
    Decoder* d = static_cast<Decoder*>(state);
    if (!d->out) return CORRUPT;
    d->to_rgb(rgb);
    return OK;
}

// Read the parameter sets of a sample (a sync sample's, checked before
// decoding); other units are skipped.  *idr is 1 if it holds an IDR slice.
int h264_headers(void* state, const uint8_t* data, int64_t n, int* idr, char* err, int errlen) {
    Decoder* d = static_cast<Decoder*>(state);
    return guarded(nullptr, err, errlen, [&] { *idr = d->headers(data, n, d->length_size); });
}

// Forget every picture (a seek); the parameter sets stay.
int h264_reset(void* state) {
    Decoder* d = static_cast<Decoder*>(state);
    d->reset();
    d->broken = false;
    return OK;
}

int h264_close(void* state) {
    delete static_cast<Decoder*>(state);
    return OK;
}

}  // extern "C"
