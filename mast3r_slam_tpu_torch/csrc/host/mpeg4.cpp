// MPEG-4 Part 2 (ISO/IEC 14496-2) video decoder for the port's video input,
// bit-exact against what cv2 5.0.0 (FFmpeg, libavcodec 62.28) gives: the
// decoder's YUV 4:2:0 planes, then libswscale's unscaled yuv420p -> BGR24
// conversion (BT.601 limited range) as cv2.VideoCapture asks for it, handed
// back in RGB order.
//
// What is decoded: the Simple Profile streams that libavcodec's encoder
// writes (and so cv2.VideoWriter with mp4v/XVID/DIVX/FMP4): rectangular
// progressive VOLs with H.263 quantisation, I- and P-VOPs, intra DC/AC
// prediction, 16x16 half-pel motion compensation with vop_rounding_type and
// unrestricted vectors, not-coded macroblocks and not-coded VOPs.  The
// arithmetic is libavcodec's as it runs on x86-64 without the bit-exact
// flag, which cv2 does not set: the simple IDCT as its SSE2 version
// computes it, dct_unquantize_h263_intra, the hpel put functions (the
// 8-wide no-rounding halves not bit-exact), and mpeg_motion_internal's edge
// emulation at the macroblock-aligned picture edge.  Each was held against
// cv2's own libavcodec on streams cv2 writes and on random valid streams
// (tests/torch_video_files.py).
//
// What is refused (rc 2, NotImplementedError): B-VOPs and S-VOPs, quarter
// pel, sprites/GMC, interlace, MPEG quantisation matrices, data
// partitioning and reversible VLC, resync markers (and the pattern of one
// inside a VOP, where libavcodec would start a video packet whatever
// resync_marker_disable says), shapes other than
// rectangular, N-bit video, complexity estimation, scalability, newpred,
// reduced resolution, four motion vectors a macroblock, short video
// headers, VOPs before a VOL, odd frame heights (libswscale scales those
// through another path) and frames smaller than 16x16, and streams whose
// user data does not name the libavcodec encoder (libavcodec changes its
// decoding for other encoders' known bugs).  Corrupt or truncated data is
// rc 1 (ValueError).

#include <algorithm>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

#include "idct.h"
#include "yuv420.h"

namespace {

using host::clip_u8;
using host::idct;

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

const char* const ITEM = "(ROADMAP Queue 1 item 17)";

// ---- tables (ISO/IEC 14496-2 Annex B; identical to libavcodec's) ----------

const uint8_t ZIGZAG[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
const uint8_t ALT_H[64] = {
    0,  1,  2,  3,  8,  9,  16, 17, 10, 11, 4,  5,  6,  7,  15, 14,
    13, 12, 19, 18, 24, 25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29,
    30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37, 38, 39, 44, 45,
    46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63};
const uint8_t ALT_V[64] = {
    0,  8,  16, 24, 1,  9,  2,  10, 17, 25, 32, 40, 48, 56, 57, 49,
    41, 33, 26, 18, 3,  11, 4,  12, 19, 27, 34, 42, 50, 58, 35, 43,
    51, 59, 20, 28, 5,  13, 6,  14, 21, 29, 36, 44, 52, 60, 37, 45,
    53, 61, 22, 30, 7,  15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63};

const uint8_t Y_DC_SCALE[32] = {0,  8,  8,  8,  8,  10, 12, 14, 16, 17, 18,
                                19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
                                30, 31, 32, 34, 36, 38, 40, 42, 44, 46};
const uint8_t C_DC_SCALE[32] = {0,  8,  8,  8,  8,  9,  9,  10, 10, 11, 11,
                                12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17,
                                17, 18, 18, 19, 20, 21, 22, 23, 24, 25};

// {code, length}; the index is the symbol
const uint16_t INTRA_MCBPC[9][2] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}, {1, 4},
                                    {1, 6}, {2, 6}, {3, 6}, {1, 9}};
// symbol = (type << 2) | cbpc; types 0 inter, 1 intra, 2 inter+q, 3 intra+q,
// 4 inter4v; 20 is stuffing
const uint16_t INTER_MCBPC[21][2] = {
    {1, 1}, {3, 4}, {2, 4}, {5, 6}, {3, 5}, {4, 8}, {3, 8}, {3, 7}, {3, 3}, {7, 7}, {6, 7},
    {5, 9}, {4, 6}, {4, 9}, {3, 9}, {2, 9}, {2, 3}, {5, 7}, {4, 7}, {5, 8}, {1, 9}};
const uint16_t CBPY[16][2] = {{3, 4}, {5, 5}, {4, 5},  {9, 4}, {3, 5}, {7, 4},
                              {2, 6}, {11, 4}, {2, 5}, {3, 6}, {5, 4}, {10, 4},
                              {4, 4}, {8, 4}, {6, 4},  {3, 2}};
const uint16_t MV[33][2] = {
    {1, 1},   {1, 2},   {1, 3},   {1, 4},   {3, 6},   {5, 7},   {4, 7},
    {3, 7},   {11, 9},  {10, 9},  {9, 9},   {17, 10}, {16, 10}, {15, 10},
    {14, 10}, {13, 10}, {12, 10}, {11, 10}, {10, 10}, {9, 10},  {8, 10},
    {7, 10},  {6, 10},  {5, 10},  {4, 10},  {7, 11},  {6, 11},  {5, 11},
    {4, 11},  {3, 11},  {2, 11},  {3, 12},  {2, 12}};
const uint16_t DC_LUM[13][2] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3}, {1, 4}, {1, 5},
                                {1, 6}, {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}};
const uint16_t DC_CHROM[13][2] = {{3, 2}, {2, 2}, {1, 2}, {1, 3}, {1, 4}, {1, 5}, {1, 6},
                                  {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}, {1, 12}};

// TCOEF: 102 (last, run, level) codes in the order last, run, level, then
// the escape (index 102).  The runs' level counts give the order.
const uint16_t INTER_TCOEF[103][2] = {
    {0x2, 2},   {0xf, 4},   {0x15, 6},  {0x17, 7},  {0x1f, 8},  {0x25, 9},  {0x24, 9},
    {0x21, 10}, {0x20, 10}, {0x7, 11},  {0x6, 11},  {0x20, 11}, {0x6, 3},   {0x14, 6},
    {0x1e, 8},  {0xf, 10},  {0x21, 11}, {0x50, 12}, {0xe, 4},   {0x1d, 8},  {0xe, 10},
    {0x51, 12}, {0xd, 5},   {0x23, 9},  {0xd, 10},  {0xc, 5},   {0x22, 9},  {0x52, 12},
    {0xb, 5},   {0xc, 10},  {0x53, 12}, {0x13, 6},  {0xb, 10},  {0x54, 12}, {0x12, 6},
    {0xa, 10},  {0x11, 6},  {0x9, 10},  {0x10, 6},  {0x8, 10},  {0x16, 7},  {0x55, 12},
    {0x15, 7},  {0x14, 7},  {0x1c, 8},  {0x1b, 8},  {0x21, 9},  {0x20, 9},  {0x1f, 9},
    {0x1e, 9},  {0x1d, 9},  {0x1c, 9},  {0x1b, 9},  {0x1a, 9},  {0x22, 11}, {0x23, 11},
    {0x56, 12}, {0x57, 12}, {0x7, 4},   {0x19, 9},  {0x5, 11},  {0xf, 6},   {0x4, 11},
    {0xe, 6},   {0xd, 6},   {0xc, 6},   {0x13, 7},  {0x12, 7},  {0x11, 7},  {0x10, 7},
    {0x1a, 8},  {0x19, 8},  {0x18, 8},  {0x17, 8},  {0x16, 8},  {0x15, 8},  {0x14, 8},
    {0x13, 8},  {0x18, 9},  {0x17, 9},  {0x16, 9},  {0x15, 9},  {0x14, 9},  {0x13, 9},
    {0x12, 9},  {0x11, 9},  {0x7, 10},  {0x6, 10},  {0x5, 10},  {0x4, 10},  {0x24, 11},
    {0x25, 11}, {0x26, 11}, {0x27, 11}, {0x58, 12}, {0x59, 12}, {0x5a, 12}, {0x5b, 12},
    {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12}, {0x3, 7}};
const uint8_t INTER_LEVELS[2][41] = {
    {12, 6, 4, 3, 3, 3, 3, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1},
    {3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1}};
const uint16_t INTRA_TCOEF[103][2] = {
    {0x2, 2},   {0x6, 3},   {0xf, 4},   {0xd, 5},   {0xc, 5},   {0x15, 6},  {0x13, 6},
    {0x12, 6},  {0x17, 7},  {0x1f, 8},  {0x1e, 8},  {0x1d, 8},  {0x25, 9},  {0x24, 9},
    {0x23, 9},  {0x21, 9},  {0x21, 10}, {0x20, 10}, {0xf, 10},  {0xe, 10},  {0x7, 11},
    {0x6, 11},  {0x20, 11}, {0x21, 11}, {0x50, 12}, {0x51, 12}, {0x52, 12}, {0xe, 4},
    {0x14, 6},  {0x16, 7},  {0x1c, 8},  {0x20, 9},  {0x1f, 9},  {0xd, 10},  {0x22, 11},
    {0x53, 12}, {0x55, 12}, {0xb, 5},   {0x15, 7},  {0x1e, 9},  {0xc, 10},  {0x56, 12},
    {0x11, 6},  {0x1b, 8},  {0x1d, 9},  {0xb, 10},  {0x10, 6},  {0x22, 9},  {0xa, 10},
    {0xd, 6},   {0x1c, 9},  {0x8, 10},  {0x12, 7},  {0x1b, 9},  {0x54, 12}, {0x14, 7},
    {0x1a, 9},  {0x57, 12}, {0x19, 8},  {0x9, 10},  {0x18, 8},  {0x23, 11}, {0x17, 8},
    {0x19, 9},  {0x18, 9},  {0x7, 10},  {0x58, 12}, {0x7, 4},   {0xc, 6},   {0x16, 8},
    {0x17, 9},  {0x6, 10},  {0x5, 11},  {0x4, 11},  {0x59, 12}, {0xf, 6},   {0x16, 9},
    {0x5, 10},  {0xe, 6},   {0x4, 10},  {0x11, 7},  {0x24, 11}, {0x10, 7},  {0x25, 11},
    {0x13, 7},  {0x5a, 12}, {0x15, 8},  {0x5b, 12}, {0x14, 8},  {0x13, 8},  {0x1a, 8},
    {0x15, 9},  {0x14, 9},  {0x13, 9},  {0x12, 9},  {0x11, 9},  {0x26, 11}, {0x27, 11},
    {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12}, {0x3, 7}};
const uint8_t INTRA_LEVELS[2][41] = {
    {27, 10, 5, 4, 3, 3, 3, 3, 2, 2, 1, 1, 1, 1, 1},
    {8, 3, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1}};

// A VLC as a direct lookup on the next `bits` bits: the symbol and its length.
struct Vlc {
    int bits = 0;
    std::vector<int16_t> sym;
    std::vector<uint8_t> len;
    Vlc(const uint16_t (*codes)[2], int n, int bits_) : bits(bits_) {
        sym.assign(size_t(1) << bits, -1);
        len.assign(size_t(1) << bits, 0);
        for (int s = 0; s < n; s++) {
            int code = codes[s][0], l = codes[s][1];
            if (l == 0) continue;
            int shift = bits - l;
            for (int k = 0; k < (1 << shift); k++) {
                sym[(code << shift) | k] = int16_t(s);
                len[(code << shift) | k] = uint8_t(l);
            }
        }
    }
};

// A TCOEF table: symbol -> (last, run, level), and the escape's maxima.
struct RunLevel {
    Vlc vlc;
    uint8_t last[102], run[102], level[102];
    uint8_t max_level[2][64];
    uint8_t max_run[2][64];
    RunLevel(const uint16_t (*codes)[2], const uint8_t (*levels)[41]) : vlc(codes, 103, 12) {
        memset(max_level, 0, sizeof max_level);
        memset(max_run, 0, sizeof max_run);
        int s = 0;
        for (int l = 0; l < 2; l++)
            for (int r = 0; r < 41 && levels[l][r]; r++)
                for (int v = 1; v <= levels[l][r]; v++, s++) {
                    last[s] = uint8_t(l);
                    run[s] = uint8_t(r);
                    level[s] = uint8_t(v);
                    max_level[l][r] = std::max<uint8_t>(max_level[l][r], uint8_t(v));
                    max_run[l][v] = std::max<uint8_t>(max_run[l][v], uint8_t(r));
                }
        if (s != 102) fail(CORRUPT, "a TCOEF table of %d entries", s);
    }
};

struct Tables {
    Vlc intra_mcbpc{INTRA_MCBPC, 9, 9};
    Vlc inter_mcbpc{INTER_MCBPC, 21, 9};
    Vlc cbpy{CBPY, 16, 6};
    Vlc mv{MV, 33, 12};
    Vlc dc_lum{DC_LUM, 13, 11};
    Vlc dc_chrom{DC_CHROM, 13, 12};
    RunLevel intra{INTRA_TCOEF, INTRA_LEVELS};
    RunLevel inter{INTER_TCOEF, INTER_LEVELS};
};

const Tables& tables() {
    static const Tables t;
    return t;
}

// ---- bits ---------------------------------------------------------------------

struct Bits {
    const uint8_t* p;
    int64_t nbits;
    int64_t pos = 0;
    Bits(const uint8_t* data, int64_t n) : p(data), nbits(n * 8) {}
    // the next n <= 25 bits; past the end reads zeros, as libavcodec's padding
    uint32_t show(int n) const {
        uint32_t v = 0;
        int64_t byte = pos >> 3;
        for (int k = 0; k < 4; k++) {
            int64_t b = byte + k;
            v = (v << 8) | (b < nbits / 8 ? p[b] : 0);
        }
        return (v << (pos & 7)) >> (32 - n);
    }
    void skip(int n) { pos += n; }
    uint32_t get(int n) {
        if (n == 0) return 0;
        uint32_t v = show(n);
        pos += n;
        return v;
    }
    int get1() { return int(get(1)); }
    int left() const { return int(std::min<int64_t>(nbits - pos, 1 << 30)); }
    void need(const char* what) const {
        if (pos > nbits) fail(CORRUPT, "truncated MPEG-4 data in %s", what);
    }
    int vlc(const Vlc& t) {
        uint32_t k = show(t.bits);
        int s = t.sym[k];
        if (s < 0) return -1;
        pos += t.len[k];
        return s;
    }
    void marker(const char* what) {
        if (!get1()) fail(CORRUPT, "missing marker bit in %s", what);
    }
    void align() { pos = (pos + 7) & ~int64_t(7); }
};

int sign_extend(int v, int bits) {
    int shift = 32 - bits;
    return int(uint32_t(v) << shift) >> shift;
}

int mid_pred(int a, int b, int c) {
    return std::max(std::min(a, b), std::min(std::max(a, b), c));
}

int rounded_div(int a, int b) { return (a >= 0 ? a + (b >> 1) : a - (b >> 1)) / b; }

// ---- the decoder ----------------------------------------------------------------

struct Plane {
    int w = 0, h = 0;  // allocated: whole macroblocks
    std::vector<uint8_t> px;
    uint8_t* at(int x, int y) { return px.data() + size_t(y) * w + x; }
};

struct Picture {
    Plane p[3];
    void alloc(int mbw, int mbh) {
        for (int c = 0; c < 3; c++) {
            int s = c ? 8 : 16;
            p[c].w = mbw * s;
            p[c].h = mbh * s;
            p[c].px.assign(size_t(p[c].w) * p[c].h, 0);
        }
    }
};

struct Decoder {
    // the VOL
    bool have_vol = false;
    int width = 0, height = 0, mbw = 0, mbh = 0;
    int time_increment_bits = 1;
    bool encoder_known = false;
    // the reference and the picture being decoded
    Picture ref, cur;
    bool have_ref = false;
    // prediction state (libavcodec's dc_val/ac_val/motion_val with a border)
    int bstride = 0;                // luma 8x8 grid: (2 * mbh + 1) rows of 2 * mbw + 2
    std::vector<int16_t> dc[3];     // luma on the 8x8 grid, chroma one a macroblock
    std::vector<int16_t> ac[3];     // 16 a block: [1..7] left column, [9..15] top row
    std::vector<int16_t> mv;        // 2 a luma block
    std::vector<uint8_t> qtab;      // qscale a macroblock
    std::vector<uint8_t> mbintra;   // the macroblock's entries hold intra values
    int cstride = 0;                // chroma grid: (mbh + 1) rows of mbw + 2
    // the VOP
    int qscale = 1, f_code = 1, rounding = 0;
    bool ac_pred = false;
    bool coded = false;  // the last VOP gave a frame (vop_coded 1)
    int16_t block[6][64];
    int last_index[6];

    int lidx(int bx, int by) const { return (by + 1) * bstride + bx + 1; }
    int cidx(int mx, int my) const { return (my + 1) * cstride + mx + 1; }

    void setup(int w, int h) {
        if (h & 1) fail(UNSUPPORTED, "a frame of odd height %d %s", h, ITEM);
        if (w <= 16 || h <= 16)
            fail(UNSUPPORTED, "a frame of %dx%d, one macroblock across %s", w, h, ITEM);
        if (int64_t(w) * h > (int64_t(1) << 26)) fail(CORRUPT, "a VOL of %dx%d", w, h);
        width = w;
        height = h;
        mbw = (w + 15) / 16;
        mbh = (h + 15) / 16;
        ref.alloc(mbw, mbh);
        cur.alloc(mbw, mbh);
        have_ref = false;
        bstride = 2 * mbw + 2;
        cstride = mbw + 2;
        size_t nl = size_t(2 * mbh + 1) * bstride, nc = size_t(mbh + 1) * cstride;
        dc[0].assign(nl, 1024);
        ac[0].assign(nl * 16, 0);
        for (int c = 1; c < 3; c++) {
            dc[c].assign(nc, 1024);
            ac[c].assign(nc * 16, 0);
        }
        mv.assign(nl * 2, 0);
        qtab.assign(size_t(mbw) * mbh, 0);
        mbintra.assign(size_t(mbw) * mbh, 1);
    }

    // -- headers --

    void user_data(Bits& b) {
        char text[256];
        int n = 0;
        while (n < 255 && b.left() >= 8 && b.show(24) != 1) text[n++] = char(b.get(8));
        text[n] = 0;
        int v1, v2, v3;
        if (strncmp(text, "Lavc", 4) == 0 && sscanf(text, "Lavc%d.%d.%d", &v1, &v2, &v3) == 3 &&
            v1 >= 0 && v1 <= 255 && v2 >= 0 && v2 <= 255 && v3 >= 0 && v3 <= 255) {
            int build = (v1 << 16) + (v2 << 8) + v3;
            // libavcodec's own-encoder workarounds (ff_mpeg4_workaround_bugs)
            // stop at build 4712; FF_BUG_IEDGE covers 3621477..3752551
            bool iedge = (build & 0xFF) >= 100 && build > 3621476 && build < 3752552 &&
                         (build < 3752037 || build > 3752191);
            if (build > 4712 && !iedge) encoder_known = true;
        }
    }

    void vol(Bits& b) {
        b.get1();  // random_accessible_vol
        int vo_type = int(b.get(8));
        int verid = 1;
        if (b.get1()) {
            verid = int(b.get(4));
            b.get(3);
        }
        if (b.get(4) == 15) b.get(16);  // extended pixel aspect ratio
        int low_delay = vo_type == 1 || vo_type == 17;
        if (b.get1()) {  // vol_control_parameters
            if (b.get(2) != 1) fail(UNSUPPORTED, "a chroma format other than 4:2:0 %s", ITEM);
            low_delay = b.get1();
            if (b.get1()) {  // vbv parameters
                b.get(15); b.marker("vbv"); b.get(15); b.marker("vbv");
                b.get(15); b.marker("vbv"); b.get(3); b.get(11); b.marker("vbv");
                b.get(15); b.marker("vbv");
            }
        }
        if (!low_delay) fail(UNSUPPORTED, "a VOL that allows B-VOPs (low_delay 0) %s", ITEM);
        int shape = int(b.get(2));
        if (shape != 0) fail(UNSUPPORTED, "a video object layer shape %d (not rectangular) %s",
                             shape, ITEM);
        b.marker("VOL");
        int res = int(b.get(16));
        if (res == 0) fail(CORRUPT, "a VOL with vop_time_increment_resolution 0");
        // av_log2(res - 1) + 1, at least 1
        time_increment_bits = res > 1 ? 32 - __builtin_clz(unsigned(res - 1)) : 1;
        b.marker("VOL");
        if (b.get1()) b.get(time_increment_bits);  // fixed_vop_rate
        b.marker("VOL width");
        int w = int(b.get(13));
        b.marker("VOL width");
        int h = int(b.get(13));
        b.marker("VOL height");
        if (b.get1()) fail(UNSUPPORTED, "interlaced video %s", ITEM);
        b.get1();  // obmc_disable
        if (b.get(verid == 1 ? 1 : 2)) fail(UNSUPPORTED, "sprites or GMC %s", ITEM);
        if (b.get1()) fail(UNSUPPORTED, "N-bit video (not_8_bit) %s", ITEM);
        if (b.get1()) fail(UNSUPPORTED, "MPEG quantisation matrices (quant_type 1) %s", ITEM);
        if (verid != 1 && b.get1()) fail(UNSUPPORTED, "quarter-pel motion %s", ITEM);
        if (!b.get1()) fail(UNSUPPORTED, "complexity estimation headers %s", ITEM);
        if (!b.get1()) fail(UNSUPPORTED, "resync markers (resync_marker_disable 0) %s", ITEM);
        if (b.get1()) fail(UNSUPPORTED, "data partitioning %s", ITEM);
        if (verid != 1) {
            if (b.get1()) fail(UNSUPPORTED, "newpred %s", ITEM);
            if (b.get1()) fail(UNSUPPORTED, "reduced-resolution VOPs %s", ITEM);
        }
        if (b.get1()) fail(UNSUPPORTED, "scalability %s", ITEM);
        b.need("the VOL header");
        if (!have_vol || w != width || h != height) {
            if (have_vol) fail(UNSUPPORTED, "a VOL that changes the frame size %s", ITEM);
            setup(w, h);
        }
        have_vol = true;
    }

    // The headers of a configuration or a sample up to its first VOP; true
    // and the reader at the VOP's first bit if one follows.
    bool headers(Bits& b) {
        for (;;) {
            b.align();
            while (b.left() >= 32 && b.show(24) != 1) b.skip(8);
            if (b.left() < 32) return false;
            b.skip(24);
            int code = int(b.get(8));
            if (code <= 0x1F) continue;  // video_object_start_code
            if (code >= 0x20 && code <= 0x2F) {
                vol(b);
            } else if (code == 0xB2) {
                user_data(b);
            } else if (code == 0xB6) {
                return true;
            } else if (code == 0xB0 || code == 0xB1 || code == 0xB3 || code == 0xB5) {
                continue;  // VOS, VOS end, GOV and visual object: nothing to keep
            } else {
                fail(UNSUPPORTED, "an MPEG-4 start code 0x%02X %s", code, ITEM);
            }
        }
    }

    // -- macroblocks --

    int decode_dc(Bits& b, int n) {
        const Tables& T = tables();
        int size = b.vlc(n < 4 ? T.dc_lum : T.dc_chrom);
        if (size < 0) fail(CORRUPT, "bad DC size code");
        if (size == 0) return 0;
        int v = int(b.get(size));
        if (!(v >> (size - 1))) v -= (1 << size) - 1;  // get_xbits
        if (size > 8) b.marker("DC");
        return v;
    }

    // ff_mpeg4_pred_dc: the predicted quantised DC, its direction (0 left,
    // 1 top), and the stored value for the next blocks
    int pred_dc(int n, int mx, int my, int level, int* dir) {
        int16_t *dv, a, bb, c;
        int scale = n < 4 ? Y_DC_SCALE[qscale] : C_DC_SCALE[qscale];
        if (n < 4) {
            int bx = 2 * mx + (n & 1), by = 2 * my + (n >> 1);
            dv = &dc[0][lidx(bx, by)];
            a = dv[-1];
            bb = dv[-1 - bstride];
            c = dv[-bstride];
        } else {
            dv = &dc[n - 3][cidx(mx, my)];
            a = dv[-1];
            bb = dv[-1 - cstride];
            c = dv[-cstride];
        }
        // the first slice line (no resync markers: the VOP's first row)
        if (my == 0 && n != 3) {
            if (n != 2) bb = c = 1024;
            if (n != 1 && mx == 0) bb = a = 1024;
        }
        if (mx == 0 && my == 1 && (n == 0 || n == 4 || n == 5)) bb = 1024;
        int pred;
        if (std::abs(a - bb) < std::abs(bb - c)) {
            pred = c;
            *dir = 1;
        } else {
            pred = a;
            *dir = 0;
        }
        pred = (pred + (scale >> 1)) / scale;
        level += pred;
        // libavcodec takes a negative result for an error code (mpeg4_decode_dc)
        if (level < 0) fail(CORRUPT, "a negative intra DC level");
        int stored = level * scale;
        if (stored & ~2047) stored = stored < 0 ? 0 : 2047;
        *dv = int16_t(stored);
        return level;
    }

    void pred_ac(int16_t* blk, int n, int mx, int my, int dir) {
        int16_t* av;
        int16_t* left;
        int16_t* top;
        if (n < 4) {
            int bx = 2 * mx + (n & 1), by = 2 * my + (n >> 1);
            av = &ac[0][size_t(lidx(bx, by)) * 16];
            left = av - 16;
            top = av - 16 * bstride;
        } else {
            av = &ac[n - 3][size_t(cidx(mx, my)) * 16];
            left = av - 16;
            top = av - 16 * cstride;
        }
        if (ac_pred) {
            if (dir == 0) {
                int q = mx > 0 ? qtab[my * mbw + mx - 1] : 0;
                if (mx == 0 || qscale == q || n == 1 || n == 3) {
                    for (int i = 1; i < 8; i++) blk[i << 3] += left[i];
                } else {
                    for (int i = 1; i < 8; i++) blk[i << 3] += rounded_div(left[i] * q, qscale);
                }
            } else {
                int q = my > 0 ? qtab[(my - 1) * mbw + mx] : 0;
                if (my == 0 || qscale == q || n == 2 || n == 3) {
                    for (int i = 1; i < 8; i++) blk[i] += top[i + 8];
                } else {
                    for (int i = 1; i < 8; i++) blk[i] += rounded_div(top[i + 8] * q, qscale);
                }
            }
        }
        for (int i = 1; i < 8; i++) av[i] = blk[i << 3];
        for (int i = 1; i < 8; i++) av[8 + i] = blk[i];
    }

    void decode_block(Bits& b, int n, bool coded, bool intra, int mx, int my) {
        const Tables& T = tables();
        int16_t* blk = block[n];
        int i = -1, dir = 0, qmul = 1, qadd = 0;
        const RunLevel* rl = &T.intra;
        const uint8_t* scan = ZIGZAG;
        if (intra) {
            blk[0] = int16_t(pred_dc(n, mx, my, decode_dc(b, n), &dir));
            i = 0;
            if (ac_pred) scan = dir == 0 ? ALT_V : ALT_H;
        } else {
            if (!coded) {
                last_index[n] = -1;
                return;
            }
            rl = &T.inter;
            qmul = qscale << 1;
            qadd = (qscale - 1) | 1;
        }
        if (coded) {
            for (;;) {
                int s = b.vlc(rl->vlc);
                if (s < 0) fail(CORRUPT, "bad TCOEF code");
                int last, run, level;
                if (s == 102) {  // escape
                    if (b.get1()) {
                        if (b.get1()) {  // third escape: fixed-length
                            last = b.get1();
                            run = int(b.get(6));
                            b.marker("escape");
                            level = sign_extend(int(b.get(12)), 12);
                            b.marker("escape");
                            level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
                            if (unsigned(level + 2048) > 4095) level = level < 0 ? -2048 : 2047;
                            i += run + 1;
                        } else {  // second escape: run offset
                            s = b.vlc(rl->vlc);
                            if (s < 0 || s == 102) fail(CORRUPT, "bad TCOEF escape");
                            last = rl->last[s];
                            run = rl->run[s] + rl->max_run[last][rl->level[s]] + 1;
                            level = rl->level[s] * qmul + qadd;
                            if (b.get1()) level = -level;
                            i += run + 1;
                        }
                    } else {  // first escape: level offset
                        s = b.vlc(rl->vlc);
                        if (s < 0 || s == 102) fail(CORRUPT, "bad TCOEF escape");
                        last = rl->last[s];
                        run = rl->run[s];
                        level = (rl->level[s] + rl->max_level[last][run]) * qmul + qadd;
                        if (b.get1()) level = -level;
                        i += run + 1;
                    }
                } else {
                    last = rl->last[s];
                    run = rl->run[s];
                    level = rl->level[s] * qmul + qadd;
                    if (b.get1()) level = -level;
                    i += run + 1;
                }
                if (i > 63 || (i == 63 && !last)) fail(CORRUPT, "AC coefficients past the block");
                blk[scan[i]] = int16_t(level);
                if (last) break;
            }
            b.need("a block");
        }
        if (intra) {
            pred_ac(blk, n, mx, my, dir);
            if (ac_pred) i = 63;
        }
        last_index[n] = i;
    }

    void clean_intra(int mx, int my) {
        for (int k = 0; k < 4; k++) {
            int idx = lidx(2 * mx + (k & 1), 2 * my + (k >> 1));
            dc[0][idx] = 1024;
            memset(&ac[0][size_t(idx) * 16], 0, 16 * sizeof(int16_t));
        }
        for (int c = 1; c < 3; c++) {
            int idx = cidx(mx, my);
            dc[c][idx] = 1024;
            memset(&ac[c][size_t(idx) * 16], 0, 16 * sizeof(int16_t));
        }
        mbintra[my * mbw + mx] = 0;
    }

    void put_intra(int mx, int my) {
        int ys = Y_DC_SCALE[qscale], cs = C_DC_SCALE[qscale];
        int qmul = qscale << 1, qadd = (qscale - 1) | 1;
        for (int n = 0; n < 6; n++) {
            int16_t* blk = block[n];
            blk[0] = int16_t(blk[0] * (n < 4 ? ys : cs));
            for (int k = 1; k < 64; k++) {
                int level = blk[k];
                if (level) blk[k] = int16_t(level < 0 ? level * qmul - qadd : level * qmul + qadd);
            }
            uint8_t* dst;
            int stride;
            if (n < 4) {
                dst = cur.p[0].at(16 * mx + 8 * (n & 1), 16 * my + 8 * (n >> 1));
                stride = cur.p[0].w;
            } else {
                dst = cur.p[n - 3].at(8 * mx, 8 * my);
                stride = cur.p[n - 3].w;
            }
            idct(blk, dst, stride, false);
        }
    }

    // The motion vector predictor of luma block 0 (ff_h263_pred_motion).
    void pred_motion(int mx, int my, int* px, int* py) {
        int idx = lidx(2 * mx, 2 * my);
        const int16_t* A = &mv[size_t(idx - 1) * 2];
        if (my == 0) {  // the first slice line
            if (mx == 0) {
                *px = *py = 0;
            } else {
                *px = A[0];
                *py = A[1];
            }
            return;
        }
        const int16_t* B = &mv[size_t(idx - bstride) * 2];
        const int16_t* C = &mv[size_t(idx - bstride + 2) * 2];
        *px = mid_pred(A[0], B[0], C[0]);
        *py = mid_pred(A[1], B[1], C[1]);
    }

    int decode_motion(Bits& b, int pred) {
        int code = b.vlc(tables().mv);
        if (code < 0) fail(CORRUPT, "bad motion vector code");
        if (code == 0) return pred;
        int sign = b.get1();
        int shift = f_code - 1;
        int val = code;
        if (shift) {
            val = (val - 1) << shift;
            val |= int(b.get(shift));
            val++;
        }
        if (sign) val = -val;
        val += pred;
        return sign_extend(val, 5 + f_code);
    }

    // put a w x h block at half-pel position dxy (libavcodec's hpel put
    // functions).  Without rounding, the 8-wide (chroma) horizontal and
    // vertical halves are what libavcodec computes unless the caller asks
    // for bit-exact decoding (cv2 does not): a rounded average after a
    // saturating decrement of the left pixel, or of the odd row of each
    // pair, which differs from (a + b) >> 1 where that pixel is 0.  The
    // 16-wide (luma) ones are exact.
    static void hpel(uint8_t* dst, int ds, const uint8_t* src, int ss, int w, int h, int dxy,
                     bool no_rnd) {
        for (int y = 0; y < h; y++) {
            const uint8_t* s0 = src + y * ss;
            const uint8_t* s1 = s0 + ss;
            for (int x = 0; x < w; x++) {
                int v;
                if (dxy == 0) {
                    v = s0[x];
                } else if (dxy == 3) {
                    v = (s0[x] + s0[x + 1] + s1[x] + s1[x + 1] + (no_rnd ? 1 : 2)) >> 2;
                } else {
                    int a = s0[x], b = dxy == 1 ? s0[x + 1] : s1[x];
                    if (no_rnd && w == 8) {
                        if (dxy == 1 || (y & 1))
                            a = a > 0 ? a - 1 : 0;
                        else
                            b = b > 0 ? b - 1 : 0;
                    }
                    v = (a + b + (no_rnd && w != 8 ? 0 : 1)) >> 1;
                }
                dst[y * ds + x] = uint8_t(v);
            }
        }
    }

    // ff_emulated_edge_mc: a bw x bh block at (sx, sy) of a w x h picture,
    // its outside replicated from the nearest edge pixel
    static void emulate(uint8_t* buf, int bs, Plane& p, int bw, int bh, int sx, int sy, int w,
                        int h) {
        for (int y = 0; y < bh; y++) {
            int yy = std::min(std::max(sy + y, 0), h - 1);
            for (int x = 0; x < bw; x++) {
                int xx = std::min(std::max(sx + x, 0), w - 1);
                buf[y * bs + x] = p.px[size_t(yy) * p.w + xx];
            }
        }
    }

    void motion(int mx, int my, int vx, int vy) {
        bool no_rnd = rounding != 0;
        int dxy = ((vy & 1) << 1) | (vx & 1);
        int sx = mx * 16 + (vx >> 1), sy = my * 16 + (vy >> 1);
        int uvdxy = dxy | (vy & 2) | ((vx & 2) >> 1);
        int usx = sx >> 1, usy = sy >> 1;
        int hedge = mbw * 16, vedge = mbh * 16;
        uint8_t ebuf[17 * 17], ubuf[9 * 9], vbuf[9 * 9];
        const uint8_t *py, *pu, *pv;
        int ys = ref.p[0].w, cs = ref.p[1].w;
        int yss = ys, css = cs;
        if (unsigned(sx) > unsigned(std::max(hedge - (vx & 1) - 16, 0)) ||
            unsigned(sy) > unsigned(std::max(vedge - (vy & 1) - 16, 0))) {
            emulate(ebuf, 17, ref.p[0], 17, 17, sx, sy, hedge, vedge);
            emulate(ubuf, 9, ref.p[1], 9, 9, usx, usy, hedge >> 1, vedge >> 1);
            emulate(vbuf, 9, ref.p[2], 9, 9, usx, usy, hedge >> 1, vedge >> 1);
            py = ebuf;
            pu = ubuf;
            pv = vbuf;
            yss = 17;
            css = 9;
        } else {
            py = ref.p[0].at(sx, sy);
            pu = ref.p[1].at(usx, usy);
            pv = ref.p[2].at(usx, usy);
        }
        hpel(cur.p[0].at(16 * mx, 16 * my), ys, py, yss, 16, 16, dxy, no_rnd);
        hpel(cur.p[1].at(8 * mx, 8 * my), cs, pu, css, 8, 8, uvdxy, no_rnd);
        hpel(cur.p[2].at(8 * mx, 8 * my), cs, pv, css, 8, 8, uvdxy, no_rnd);
    }

    void add_inter(int mx, int my) {
        for (int n = 0; n < 6; n++) {
            if (last_index[n] < 0) continue;
            if (n < 4)
                idct(block[n], cur.p[0].at(16 * mx + 8 * (n & 1), 16 * my + 8 * (n >> 1)),
                     cur.p[0].w, true);
            else
                idct(block[n], cur.p[n - 3].at(8 * mx, 8 * my), cur.p[n - 3].w, true);
        }
    }

    void set_mv(int mx, int my, int vx, int vy) {
        for (int k = 0; k < 4; k++) {
            int idx = lidx(2 * mx + (k & 1), 2 * my + (k >> 1));
            mv[size_t(idx) * 2] = int16_t(vx);
            mv[size_t(idx) * 2 + 1] = int16_t(vy);
        }
    }

    void dquant(Bits& b) {
        static const int D[4] = {-1, -2, 1, 2};
        qscale = std::min(std::max(qscale + D[b.get(2)], 1), 31);
    }

    void intra_mb(Bits& b, int mx, int my, int cbpc) {
        const Tables& T = tables();
        ac_pred = b.get1();
        int cbpy = b.vlc(T.cbpy);
        if (cbpy < 0) fail(CORRUPT, "bad CBPY code");
        if (cbpc & 4) dquant(b);
        int cbp = (cbpc & 3) | (cbpy << 2);
        qtab[my * mbw + mx] = uint8_t(qscale);
        memset(block, 0, sizeof block);
        for (int n = 0; n < 6; n++) decode_block(b, n, (cbp >> (5 - n)) & 1, true, mx, my);
        set_mv(mx, my, 0, 0);
        put_intra(mx, my);
        mbintra[my * mbw + mx] = 1;
    }

    void vop(Bits& b) {
        if (!have_vol) fail(UNSUPPORTED, "a VOP before any VOL %s", ITEM);
        if (!encoder_known)
            fail(UNSUPPORTED, "a stream without libavcodec's encoder user data %s", ITEM);
        int type = int(b.get(2));
        if (type == 2) fail(UNSUPPORTED, "B-VOPs %s", ITEM);
        if (type == 3) fail(UNSUPPORTED, "S-VOPs (sprites, GMC) %s", ITEM);
        while (b.get1()) {
            if (b.left() <= 0) fail(CORRUPT, "truncated VOP header");
        }
        b.marker("VOP time");
        b.get(time_increment_bits);
        b.marker("VOP time");
        if (!b.get1()) {  // vop_coded 0: libavcodec outputs no frame
            b.need("the VOP header");
            coded = false;
            return;
        }
        rounding = type == 1 ? b.get1() : 0;
        // intra_dc_vlc_thr 0: the intra DC always through its own VLC
        if (b.get(3)) fail(UNSUPPORTED, "intra DC coded as an AC coefficient %s", ITEM);
        qscale = int(b.get(5));
        if (qscale == 0) fail(CORRUPT, "a VOP quantiser of 0");
        if (type == 1) {
            f_code = int(b.get(3));
            if (f_code == 0) fail(CORRUPT, "a VOP fcode of 0");
            if (!have_ref) fail(CORRUPT, "a P-VOP without a reference frame");
        }
        b.need("the VOP header");
        const Tables& T = tables();
        for (int my = 0; my < mbh; my++) {
            for (int mx = 0; mx < mbw; mx++) {
                if (type == 0) {
                    int cbpc;
                    do {
                        cbpc = b.vlc(T.intra_mcbpc);
                        if (cbpc < 0) fail(CORRUPT, "bad MCBPC code at macroblock %d,%d", mx, my);
                    } while (cbpc == 8);
                    intra_mb(b, mx, my, cbpc);
                } else {
                    int cbpc;
                    bool skipped = false;
                    do {
                        if (b.get1()) {
                            skipped = true;
                            break;
                        }
                        cbpc = b.vlc(T.inter_mcbpc);
                        if (cbpc < 0) fail(CORRUPT, "bad MCBPC code at macroblock %d,%d", mx, my);
                    } while (cbpc == 20);
                    if (skipped) {
                        qtab[my * mbw + mx] = uint8_t(qscale);
                        set_mv(mx, my, 0, 0);
                        if (mbintra[my * mbw + mx]) clean_intra(mx, my);
                        motion(mx, my, 0, 0);
                    } else {
                        int type_mb = cbpc >> 2;  // 0 inter, 1 intra, 2 inter+q, 3 intra+q, 4 4MV
                        if (type_mb == 1 || type_mb == 3) {
                            intra_mb(b, mx, my, (cbpc & 3) | (type_mb == 3 ? 4 : 0));
                        } else {
                            if (type_mb == 4)
                                fail(UNSUPPORTED, "four motion vectors a macroblock %s", ITEM);
                            int cbpy = b.vlc(T.cbpy);
                            if (cbpy < 0) fail(CORRUPT, "bad CBPY code");
                            cbpy ^= 0xF;
                            if (type_mb == 2) dquant(b);
                            qtab[my * mbw + mx] = uint8_t(qscale);
                            int px, py;
                            pred_motion(mx, my, &px, &py);
                            int vx = decode_motion(b, px);
                            int vy = decode_motion(b, py);
                            set_mv(mx, my, vx, vy);
                            int cbp = (cbpc & 3) | (cbpy << 2);
                            memset(block, 0, sizeof block);
                            for (int n = 0; n < 6; n++)
                                decode_block(b, n, (cbp >> (5 - n)) & 1, false, mx, my);
                            if (mbintra[my * mbw + mx]) clean_intra(mx, my);
                            motion(mx, my, vx, vy);
                            add_inter(mx, my);
                        }
                    }
                }
                b.need("a macroblock");
                if (my * mbw + mx + 1 < mbw * mbh && resync_marker(b, type))
                    fail(UNSUPPORTED, "a resync marker inside a VOP %s", ITEM);
            }
        }
        // what libavcodec's encoder ends a VOP with: a 0, then 1s to the
        // byte; other data after the last macroblock would take libavcodec
        // through its error handling, which is not ported
        int64_t rest = b.nbits - b.pos;
        if (rest < 1 || rest > 8 || b.show(int(rest)) != (1u << (rest - 1)) - 1)
            fail(CORRUPT, "data after the VOP's last macroblock");
        coded = true;
        std::swap(ref, cur);
        have_ref = true;
    }

    // libavcodec's mpeg4_is_resync after each macroblock, whatever
    // resync_marker_disable says: past MCBPC stuffing, a 0 and 1s to the
    // byte, then a resync marker (16 zeros, 15 + fcode in a P-VOP, and a 1)
    // end the slice there and start a video packet.  Valid macroblock data
    // never holds one.
    bool resync_marker(const Bits& b, int type) const {
        static const uint16_t prefix[8] = {0x7F00, 0x7E00, 0x7C00, 0x7800,
                                           0x7000, 0x6000, 0x4000, 0x0000};
        Bits g = b;
        while (g.show(16) <= 0xFF && (g.show(16) >> (7 - type)) == 1) g.skip(9 + type);
        if (g.pos + 8 >= g.nbits || g.show(16) != prefix[g.pos & 7]) return false;
        g.skip(1);
        g.align();
        int len = 0;
        while (len < 32 && !g.get1()) len++;
        return len >= (type == 0 ? 16 : 15 + f_code);
    }

    // the reference frame as RGB (yuv420.h; limited range)
    void to_rgb(uint8_t* out) const {
        const Plane &Y = ref.p[0], &U = ref.p[1], &V = ref.p[2];
        host::yuv420_to_rgb(Y.px.data(), Y.w, U.px.data(), V.px.data(), U.w, width, height,
                            host::yuv_coeffs(2, false), out);
    }
};

void copy_msg(char* err, int errlen, const char* msg) {
    if (err && errlen > 0) {
        strncpy(err, msg, size_t(errlen) - 1);
        err[errlen - 1] = 0;
    }
}

}  // namespace

extern "C" {

// 0: ok; 1: corrupt or truncated; 2: a stream not decoded here; 3: out of memory.

// A decoder for a stream whose configuration (VOS/VOL headers, may be
// empty: then they come in band) is `cfg`; *state receives it.
int mpeg4_open(const uint8_t* cfg, int64_t n, void** state, char* err, int errlen) {
    Decoder* d = nullptr;
    try {
        tables();
        d = new Decoder();
        if (n > 0) {
            Bits b(cfg, n);
            if (d->headers(b)) fail(CORRUPT, "a VOP in the decoder configuration");
        }
        *state = d;
        return OK;
    } catch (const Fail& f) {
        delete d;
        copy_msg(err, errlen, f.msg);
        return f.rc;
    } catch (const std::bad_alloc&) {
        delete d;
        copy_msg(err, errlen, "out of memory");
        return NOMEM;
    }
}

// The frame size once a VOL has been read: wh[0] width, wh[1] height (0 before).
int mpeg4_size(void* state, int* wh) {
    Decoder* d = static_cast<Decoder*>(state);
    wh[0] = d->have_vol ? d->width : 0;
    wh[1] = d->have_vol ? d->height : 0;
    return OK;
}

// Decode one sample.  *shown is 1 if libavcodec outputs a frame for it, 0
// for a not-coded VOP (the reference stays).
int mpeg4_decode(void* state, const uint8_t* data, int64_t n, int* shown, char* err,
                 int errlen) {
    Decoder* d = static_cast<Decoder*>(state);
    *shown = 0;
    try {
        Bits b(data, n);
        if (!d->headers(b)) fail(CORRUPT, "a sample without a VOP");
        d->vop(b);
        *shown = d->coded ? 1 : 0;
        return OK;
    } catch (const Fail& f) {
        d->have_ref = false;
        copy_msg(err, errlen, f.msg);
        return f.rc;
    } catch (const std::bad_alloc&) {
        d->have_ref = false;
        copy_msg(err, errlen, "out of memory");
        return NOMEM;
    }
}

// The last frame shown, as height x width x 3 RGB into `rgb`; 1 if there is none.
int mpeg4_rgb(void* state, uint8_t* rgb) {
    Decoder* d = static_cast<Decoder*>(state);
    if (!d->have_ref) return CORRUPT;
    d->to_rgb(rgb);
    return OK;
}

// Forget the reference frame (a seek); the VOL stays.
int mpeg4_reset(void* state) {
    static_cast<Decoder*>(state)->have_ref = false;
    return OK;
}

int mpeg4_close(void* state) {
    delete static_cast<Decoder*>(state);
    return OK;
}

}  // extern "C"
