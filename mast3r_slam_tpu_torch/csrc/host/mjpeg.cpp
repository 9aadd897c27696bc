// Motion-JPEG video decoder for the port's video input, bit-exact against
// what cv2 5.0.0 (FFmpeg, libavcodec 62.28) gives: libavcodec's mjpeg
// decoder (mjpegdec.c) into its yuvj420p, yuvj422p or gray planes, then
// libswscale's unscaled conversion to BGR24 (full range, BT.601) as
// cv2.VideoCapture asks for it, handed back in RGB order.  It is separate
// from jpeg.cpp, the image decoder, which is exact against libjpeg-turbo
// (ISLOW IDCT, fancy upsampling, libjpeg's resync and corrupt-data rules):
// libavcodec differs from libjpeg in each of these.
//
// What is decoded, as mjpegdec.c decodes it: a sample's markers up to its
// EOI (bytes between segments skipped, data after the EOI ignored, a
// missing EOI after a scan emulated), APPn and COM segments, DQT (8- and
// 16-bit tables, kept from sample to sample), DHT (kept from sample to
// sample; before any, libavcodec's default tables, which are the standard
// ones of ITU-T T.81 Annex K.3, so that frames without a DHT, as UVC cameras
// write them, decode), DRI with RSTn, SOF0/SOF1 at 8 bits, interleaved and
// non-interleaved SOS; the DC predictor holds the dequantised value and
// starts at 1024 (4 << bits) at each scan and restart, dequantisation wraps
// to 16 bits, the simple IDCT (idct.h) writes each block whose top-left
// lies in the picture, and the picture is cropped from the MCU grid.
// Samplings: 4:2:0 (yuvj420p) and 4:2:2 (yuvj422p) at even heights, and
// one component (gray) at any size; libswscale converts 4:4:4, 4:4:0 and
// 4:1:1 through its scaler's chroma filters, which are not modelled.
//
// What is refused (rc 2, NotImplementedError naming ROADMAP Queue 1 item
// 17f): progressive (SOF2), lossless (SOF3), arithmetic (SOF9-11) and
// hierarchical coding, JPEG-LS, samples other than 8 bits, samplings and
// component layouts other than the three above (and odd heights in colour,
// which libswscale converts through its scaler), frames whose height is
// under 3/4 of the container's (libavcodec reads them as interlaced field
// pairs, AVI1), a frame size or sampling that changes, and the comments
// libavcodec acts on (CS=ITU601, AVID, MULTISCOPE II, the Intel and Metasoft
// ones that flip the picture).  Corrupt or truncated data is rc 1
// (ValueError): where libavcodec would conceal, skip or drop, the port
// raises.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "idct.h"
#include "nal.h"
#include "yuv420.h"

namespace {

using host::CORRUPT;
using host::fail;
using host::OK;
using host::UNSUPPORTED;

const char* const ITEM = "(ROADMAP Queue 1 item 17f)";

#define refuse(fmt, ...) fail(UNSUPPORTED, fmt " is not ported " "%s", ##__VA_ARGS__, ITEM)

enum {
    SOF0 = 0xC0, SOF1 = 0xC1, SOF2 = 0xC2, SOF3 = 0xC3, DHT = 0xC4, SOF15 = 0xCF,
    RST0 = 0xD0, RST7 = 0xD7, SOI = 0xD8, EOI = 0xD9, SOS = 0xDA, DQT = 0xDB, DRI = 0xDD,
    SOF48 = 0xF7, LSE = 0xF8, COM = 0xFE
};

const uint8_t NATURAL[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// libavcodec's default tables (jpegtables.c: T.81 Annex K.3): counts of
// codes of 1..16 bits, then the symbols
const uint8_t DC_LUM_BITS[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t DC_CHROM_BITS[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t DC_VALS[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t AC_LUM_BITS[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t AC_LUM_VALS[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t AC_CHROM_BITS[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t AC_CHROM_VALS[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// A Huffman table as libavcodec builds it (ff_mjpeg_build_vlc: canonical
// codes in the order of the symbols); a bit pattern no code starts is -1.
struct Huffman {
    bool defined = false;
    uint8_t vals[256] = {};
    int maxcode[18] = {};    // largest code of each length, -1 if none
    int valoffset[18] = {};  // vals index of a code of each length, minus the code
    uint16_t fast[512] = {};  // 9-bit lookahead: (length << 8) | symbol, 0 if longer

    void build(const uint8_t* counts, const uint8_t* symbols, int n) {
        memcpy(vals, symbols, size_t(n));
        memset(fast, 0, sizeof fast);
        int code = 0, k = 0;
        for (int len = 1; len <= 16; len++) {
            valoffset[len] = k - code;
            for (int i = 0; i < counts[len - 1]; i++, k++, code++) {
                if (code >= (1 << len)) fail(CORRUPT, "a DHT whose code lengths overflow");
                if (len <= 9)
                    for (int p = code << (9 - len); p < (code + 1) << (9 - len); p++)
                        fast[p] = uint16_t((len << 8) | symbols[k]);
            }
            maxcode[len] = counts[len - 1] ? code - 1 : -1;
            code <<= 1;
        }
        defined = true;
    }
};

// The entropy-coded bits of a scan after libavcodec's unescaping (an FF00
// read as FF; RSTn markers left in; the data ends at any other marker).
// Reading past the end is corruption: libavcodec reads zeros there.
struct Bits {
    const uint8_t* d;
    int64_t n, pos = 0;  // bits
    Bits(const uint8_t* p, int64_t nbytes) : d(p), n(nbytes * 8) {}
    uint32_t peek(int k) const {  // k <= 25; bits past the end read as 0
        uint32_t v = 0;
        int64_t at = pos >> 3;
        for (int i = 0; i < 4; i++) v = (v << 8) | (at + i < (n >> 3) ? d[at + i] : 0);
        return (v << (pos & 7)) >> (32 - k);
    }
    void skip(int k) {
        pos += k;
        if (pos > n) fail(CORRUPT, "scan data cut short");
    }
    int get(int k) {
        if (!k) return 0;
        uint32_t v = peek(k);
        skip(k);
        return int(v);
    }
    int left() const { return int(n - pos); }
    int xbits(int k) {  // get_xbits: the JPEG sign extension
        if (!k) return 0;
        int v = get(k);
        return v >> (k - 1) ? v : v - (1 << k) + 1;
    }
    int decode(const Huffman& h) {
        uint32_t look = peek(9);
        if (uint16_t f = h.fast[look]) {
            skip(f >> 8);
            return f & 0xFF;
        }
        uint32_t bits16 = peek(16);
        for (int len = 10; len <= 16; len++) {
            int code = int(bits16 >> (16 - len));
            if (code <= h.maxcode[len]) {
                skip(len);
                return h.vals[h.valoffset[len] + code];
            }
        }
        return -1;
    }
};

struct Component {
    int id, h, v, tq;
};

struct Plane {
    int w = 0, h = 0;  // allocated: whole MCUs
    std::vector<uint8_t> px;
};

struct Decoder {
    int orig_w, orig_h;  // the container's frame size (libavcodec's coded size at open)
    uint16_t quant[4][64] = {};
    bool quant_defined[4] = {};
    Huffman dc[4], ac[4];
    // the frame being decoded
    int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1, mbw = 0, mbh = 0;
    Component comp[4];
    Plane plane[3];
    int restart_interval = 0, restart_count = 0;
    bool scanned[3] = {}, in_frame = false;
    // the last frame output, and the first one's layout, which stays
    bool have = false, broken = false;
    int out_w = 0, out_h = 0, out_kind = -1;  // kind: 0 gray, 1 4:2:0, 2 4:2:2
    Plane out[3];

    Decoder(int w, int h) : orig_w(w), orig_h(h) {
        dc[0].build(DC_LUM_BITS, DC_VALS, 12);
        dc[1].build(DC_CHROM_BITS, DC_VALS, 12);
        ac[0].build(AC_LUM_BITS, AC_LUM_VALS, 162);
        ac[1].build(AC_CHROM_BITS, AC_CHROM_VALS, 162);
    }

    void reset() { have = false; }  // a seek: the tables stay, as avcodec_flush_buffers keeps them

    static int be16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

    void dqt(const uint8_t* p, int len) {
        int at = 2;
        while (len - at >= 65) {
            int pr = p[at] >> 4, index = p[at] & 15;
            if (pr > 1) fail(CORRUPT, "a DQT of precision %d", pr);
            if (index >= 4) fail(CORRUPT, "a DQT of index %d", index);
            if (at + 1 + 64 * (1 + pr) > len) fail(CORRUPT, "a DQT cut short");
            for (int i = 0; i < 64; i++)
                quant[index][i] = uint16_t(pr ? be16(p + at + 1 + 2 * i) : p[at + 1 + i]);
            quant_defined[index] = true;
            at += 1 + 64 * (1 + pr);
        }
    }

    void dht(const uint8_t* p, int len) {
        int at = 2;
        while (at < len) {
            if (len - at < 17) fail(CORRUPT, "a DHT cut short");
            int cls = p[at] >> 4, index = p[at] & 15;
            if (cls >= 2 || index >= 4) fail(CORRUPT, "a DHT of class %d, index %d", cls, index);
            int n = 0;
            for (int i = 1; i <= 16; i++) n += p[at + i];
            if (len - at - 17 < n || n > 256) fail(CORRUPT, "a DHT of %d codes cut short", n);
            (cls ? ac : dc)[index].build(p + at + 1, p + at + 17, n);
            at += 17 + n;
        }
    }

    void com(const uint8_t* p, int len) {
        // mjpeg_decode_com: the text up to a NUL, a last newline dropped
        std::string text(reinterpret_cast<const char*>(p + 2), size_t(len - 2));
        if (!text.empty() && text.back() == '\n') text.pop_back();
        text = text.c_str();
        if (!text.compare(0, 4, "AVID") || text == "CS=ITU601" || text == "MULTISCOPE II" ||
            !text.compare(0, 32, "Intel(R) JPEG Library, version 1") ||
            !text.compare(0, 20, "Metasoft MJPEG Codec"))
            refuse("a JPEG comment %.40s that libavcodec acts on", text.c_str());
    }

    void sof(int marker, const uint8_t* p, int len, int64_t packet) {
        if (marker != SOF0 && marker != SOF1) {
            const char* what = marker == 0xC2 || marker == 0xC6 || marker == 0xCA ? "progressive"
                               : marker == 0xC3 || marker == 0xC7 || marker == 0xCB
                                   ? "lossless"
                                   : marker >= 0xC9 ? "arithmetic-coded" : "hierarchical";
            refuse("%s Motion-JPEG (SOF%d)", what, marker - SOF0);
        }
        if (len < 8) fail(CORRUPT, "a SOF cut short");
        int bits = p[2], h = be16(p + 3), w = be16(p + 5), nc = p[7];
        if (bits < 1 || bits > 16) fail(CORRUPT, "a SOF of %d bits", bits);
        if (bits != 8) refuse("Motion-JPEG of %d-bit samples", bits);
        // av_image_check_size
        if (w <= 0 || h <= 0 || uint64_t(w + 128) * uint64_t(h + 128) >= (INT32_MAX / 8))
            fail(CORRUPT, "a frame of %dx%d pixels", w, h);
        if ((w + 7) / 8 * int64_t((h + 7) / 8) > packet * 4)
            fail(CORRUPT, "a %dx%d frame in a sample of %lld bytes", w, h, (long long)packet);
        if (nc <= 0 || nc > 4) fail(CORRUPT, "a SOF of %d components", nc);
        if (len != 8 + 3 * nc) fail(CORRUPT, "a SOF of length %d for %d components", len, nc);
        hmax = vmax = 1;
        for (int i = 0; i < nc; i++) {
            const uint8_t* c = p + 8 + 3 * i;
            comp[i] = {c[0], c[1] >> 4, c[1] & 15, c[2]};
            if (comp[i].tq >= 4) fail(CORRUPT, "a quantisation table index %d", comp[i].tq);
            if (!comp[i].h || !comp[i].v) fail(CORRUPT, "a sampling factor of 0");
            hmax = std::max(hmax, comp[i].h);
            vmax = std::max(vmax, comp[i].v);
        }
        // the decoder's pixel format (mjpegdec.c's pix_fmt_id, halved where
        // every factor is even)
        uint32_t id = 0;
        for (int i = 0; i < nc; i++) id |= uint32_t(comp[i].h << 4 | comp[i].v) << (24 - 8 * i);
        if (!(id & 0xD0D0D0D0)) id -= (id & 0xF0F0F0F0) >> 1;
        if (!(id & 0x0D0D0D0D)) id -= (id & 0x0F0F0F0F) >> 1;
        int kind = nc == 1 ? 0 : nc == 3 && id == 0x22111100 ? 1 : nc == 3 && id == 0x21111100 ? 2 : -1;
        if (kind < 0) {
            const char* name = id == 0x11111100 ? "4:4:4" : id == 0x12111100 ? "4:4:0"
                               : id == 0x41111100 ? "4:1:1" : "this";
            refuse("Motion-JPEG of %s sampling (%d components, factors 0x%08x)", name, nc,
                   unsigned(id));
        }
        if (kind && comp[0].id == 'Q' && comp[1].id == 'F' && comp[2].id == 'A')
            refuse("Motion-JPEG of QFA components (libavcodec reads them as RGB)");
        if (kind && (h & 1))
            refuse("a colour Motion-JPEG frame of odd height %d (libswscale scales it)", h);
        if (orig_h > 0 && h < orig_h * 3 / 4)
            refuse("a %d-row frame in a %d-row track (libavcodec reads AVI1 interlaced "
                   "field pairs)", h, orig_h);
        if (out_kind >= 0 && (w != out_w || h != out_h || kind != out_kind))
            refuse("a Motion-JPEG frame size or sampling that changes (%dx%d to %dx%d)", out_w,
                   out_h, w, h);
        width = w;
        height = h;
        ncomp = nc;
        mbw = (w + 8 * hmax - 1) / (8 * hmax);
        mbh = (h + 8 * vmax - 1) / (8 * vmax);
        for (int i = 0; i < nc; i++) {
            plane[i].w = mbw * comp[i].h * 8;
            plane[i].h = mbh * comp[i].v * 8;
            plane[i].px.assign(size_t(plane[i].w) * plane[i].h, 0);
            scanned[i] = false;
        }
        out_w = w;
        out_h = h;
        out_kind = kind;
    }

    // handle_rstn: after an interval's last MCU, its RSTn (none need follow
    // the scan's last MCU)
    void restart(Bits& b, int nscan, int* last_dc, bool last) {
        if (!restart_interval) return;
        if (--restart_count) return;
        int i = 8 + int((-b.pos) & 7);
        uint32_t s = b.left() >= i ? b.peek(i) : 0;
        if (b.left() >= i && (s == (1u << i) - 1 || s == 0xFF)) {
            int64_t back = b.pos;
            b.pos = (b.pos + 7) & ~int64_t(7);
            while (b.left() >= 8 && b.peek(8) == 0xFF) b.skip(8);
            if (b.left() >= 8 && (b.get(8) & 0xF8) == RST0) {
                for (int c = 0; c < nscan; c++) last_dc[c] = 1024;
                return;
            }
            b.pos = back;
        }
        if (!last) fail(CORRUPT, "a restart marker missing after %d MCUs", restart_interval);
    }

    void block(Bits& b, int16_t* blk, const Huffman& hd, const Huffman& ha, const uint16_t* q,
               int& last_dc) {
        int code = b.decode(hd);
        if (code < 0 || code > 16) fail(CORRUPT, "a bad DC code");
        int val = int(uint32_t(b.xbits(code)) * uint32_t(q[0]) + uint32_t(last_dc));
        last_dc = val;
        blk[0] = int16_t(std::min(std::max(val, -32768), 32767));
        for (int i = 0; i < 63;) {
            int rs = b.decode(ha);
            if (rs < 0) fail(CORRUPT, "a bad AC code");
            if (!rs) break;  // EOB
            i += (rs >> 4) + 1;
            if (int size = rs & 15) {
                int level = b.xbits(size);
                if (i > 63) fail(CORRUPT, "AC coefficients past the block's 64");
                blk[NATURAL[i]] = int16_t(uint16_t(level * q[i]));
            }
        }
    }

    void sos(const uint8_t* p, int len, const uint8_t* data, int64_t n) {
        if (!in_frame) fail(CORRUPT, "a scan before the frame header");
        int ns = len >= 3 ? p[2] : 0;
        if (ns == 0 || ns > 4) fail(CORRUPT, "a scan of %d components", ns);
        if (len != 6 + 2 * ns) fail(CORRUPT, "a SOS of length %d for %d components", len, ns);
        int ci[4];
        const Huffman *hd[4], *ha[4];
        for (int i = 0; i < ns; i++) {
            int id = p[3 + 2 * i], td = p[4 + 2 * i] >> 4, ta = p[4 + 2 * i] & 15;
            int c = 0;
            while (c < ncomp && comp[c].id != id) c++;
            if (c == ncomp) fail(CORRUPT, "a scan of component %d, not in the frame", id);
            if (td >= 4 || ta >= 4 || !dc[td].defined || !ac[ta].defined)
                fail(CORRUPT, "a scan naming an undefined Huffman table");
            if (!quant_defined[comp[c].tq])
                fail(CORRUPT, "a scan whose quantisation table %d was never defined", comp[c].tq);
            if (scanned[c]) fail(CORRUPT, "component %d coded in two scans", id);
            scanned[c] = true;
            ci[i] = c;
            hd[i] = &dc[td];
            ha[i] = &ac[ta];
        }
        int sw = mbw, sh = mbh, hs[4], vs[4];
        for (int i = 0; i < ns; i++) {
            hs[i] = comp[ci[i]].h;
            vs[i] = comp[ci[i]].v;
        }
        if (ns == 1) {  // non-interleaved: an MCU is one block
            int h = hmax / hs[0], v = vmax / vs[0];
            sw = (width + 8 * h - 1) / (8 * h);
            sh = (height + 8 * v - 1) / (8 * v);
            hs[0] = vs[0] = 1;
        }
        int cw = out_kind == 0 ? width : (width + 1) / 2;
        int ch = out_kind == 1 ? (height + 1) / 2 : height;
        Bits b(data, n);
        restart_count = 0;
        int last_dc[4] = {1024, 1024, 1024, 1024};
        alignas(16) int16_t blk[64];
        for (int my = 0; my < sh; my++)
            for (int mx = 0; mx < sw; mx++) {
                if (restart_interval && !restart_count) restart_count = restart_interval;
                for (int i = 0; i < ns; i++) {
                    int c = ci[i];
                    Plane& P = plane[c];
                    for (int y = 0; y < vs[i]; y++)
                        for (int x = 0; x < hs[i]; x++) {
                            memset(blk, 0, sizeof blk);
                            block(b, blk, *hd[i], *ha[i], quant[comp[c].tq], last_dc[i]);
                            int px = 8 * (hs[i] * mx + x), py = 8 * (vs[i] * my + y);
                            if (px < (c ? cw : width) && py < (c ? ch : height))
                                host::idct(blk, &P.px[size_t(py) * P.w + px], P.w, false);
                        }
                }
                restart(b, ns, last_dc, my == sh - 1 && mx == sw - 1);
            }
    }

    // ff_mjpeg_find_marker's unescaping of a scan's data: FF00 is FF, FF
    // fill bytes before a marker drop, RSTn stay, any other marker ends it
    // (*stop: the FF of that marker, or the end)
    static int64_t unescape(const uint8_t* src, const uint8_t* end, std::vector<uint8_t>& out,
                            const uint8_t** stop) {
        out.clear();
        const uint8_t* ptr = src;
        auto copy = [&](int64_t skip) {
            int64_t length = (ptr - src) - skip;
            if (length > 0) {
                out.insert(out.end(), src, src + length);
                src = ptr;
            }
        };
        while (ptr < end) {
            uint8_t x = *ptr++;
            if (x == 0xFF) {
                int64_t skip = 0;
                while (ptr < end && x == 0xFF) {
                    x = *ptr++;
                    skip++;
                }
                if (skip > 1) {
                    copy(skip);
                    src--;
                }
                if (x < RST0 || x > RST7) {
                    copy(1);
                    if (x) {
                        *stop = ptr - 2;
                        return int64_t(out.size());
                    }
                }
            }
        }
        if (src < ptr) copy(0);
        *stop = ptr;
        return int64_t(out.size());
    }

    // One sample: true if libavcodec outputs a frame for it (not for an
    // empty sample: an AVI chunk of no bytes, which FFmpeg's demuxer skips)
    bool decode(const uint8_t* buf, int64_t n) {
        if (n == 0) return false;
        const uint8_t *at = buf, *end = buf + n;
        in_frame = false;
        int scans = 0;
        std::vector<uint8_t> unescaped;
        for (;;) {
            // find_marker: the next FF followed by a code from SOF0 to COM
            int marker = -1;
            while (end - at > 1) {
                uint8_t v = *at++;
                if (v == 0xFF && *at >= SOF0 && *at <= COM) {
                    marker = *at++;
                    break;
                }
            }
            if (marker < 0) break;
            if (marker == EOI) {
                if (!in_frame) continue;  // "Found EOI before any SOF, ignoring"
                break;
            }
            if (marker == SOI) {
                restart_interval = restart_count = 0;
                continue;
            }
            if (marker >= RST0 && marker <= RST7) continue;
            // a segment: its length, then its body
            if (end - at < 2) fail(CORRUPT, "a marker segment cut short");
            int len = be16(at);
            if (len < 2 || end - at < len) fail(CORRUPT, "marker 0x%02x's segment cut short", marker);
            if (marker == SOS) {
                scans++;
                const uint8_t* stop;
                int64_t m = unescape(at + len, end, unescaped, &stop);
                sos(at, len, unescaped.data(), m);
                at = stop;
                continue;
            }
            if (marker == DQT) dqt(at, len);
            else if (marker == DHT) dht(at, len);
            else if (marker == COM) com(at, len);
            else if (marker == DRI) {
                if (len != 4) fail(CORRUPT, "a DRI of length %d", len);
                restart_interval = be16(at + 2);
                restart_count = 0;
            } else if ((marker >= SOF0 && marker <= SOF15 && marker != DHT && marker != 0xC8 &&
                        marker != 0xCC) ||
                       marker == SOF48 || marker == LSE) {
                if (marker == SOF48 || marker == LSE) refuse("JPEG-LS Motion-JPEG");
                if (in_frame) fail(CORRUPT, "a second frame header in one sample");
                sof(marker, at, len, n);
                in_frame = true;
            }
            at += len;
        }
        if (!in_frame || !scans) fail(CORRUPT, "a sample without a JPEG frame and its scans");
        for (int i = 0; i < ncomp; i++)
            if (!scanned[i]) fail(CORRUPT, "component %d coded in no scan", comp[i].id);
        for (int i = 0; i < ncomp; i++) std::swap(out[i], plane[i]);
        have = true;
        return true;
    }

    void to_rgb(uint8_t* rgb) const {
        if (out_kind == 0) {
            for (int y = 0; y < out_h; y++) {
                const uint8_t* row = &out[0].px[size_t(y) * out[0].w];
                uint8_t* o = rgb + size_t(y) * out_w * 3;
                for (int x = 0; x < out_w; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = row[x];
            }
            return;
        }
        host::yuv_to_rgb(out[0].px.data(), out[0].w, out[1].px.data(), out[2].px.data(), out[1].w,
                         out_w, out_h, out_kind == 1 ? 1 : 0, host::yuv_coeffs(2, true), rgb);
    }
};

}  // namespace

extern "C" {

// 0: ok; 1: corrupt or truncated; 2: a stream not decoded here; 3: out of memory.

// A decoder for a track whose container gives frames of width x height
// (libavcodec's coded size at open, 0 if unknown); *state receives it.
int mjpeg_open(int width, int height, void** state, char* err, int errlen) {
    return host::guarded<Decoder>(nullptr, err, errlen,
                                  [&] { *state = new Decoder(width, height); });
}

// The size of the last frame output (before one, the container's): wh[0]
// width, wh[1] height.
int mjpeg_size(void* state, int* wh) {
    Decoder* d = static_cast<Decoder*>(state);
    wh[0] = d->out_kind >= 0 ? d->out_w : d->orig_w;
    wh[1] = d->out_kind >= 0 ? d->out_h : d->orig_h;
    return OK;
}

// Decode one sample.  *shown is 1 if libavcodec outputs a frame for it, 0
// for an empty sample.
int mjpeg_decode(void* state, const uint8_t* data, int64_t n, int* shown, char* err,
                 int errlen) {
    Decoder* d = static_cast<Decoder*>(state);
    *shown = 0;
    return host::guarded(d, err, errlen, [&] { *shown = d->decode(data, n) ? 1 : 0; });
}

// The last frame output, as height x width x 3 RGB into `rgb`; 1 if there is none.
int mjpeg_rgb(void* state, uint8_t* rgb) {
    Decoder* d = static_cast<Decoder*>(state);
    if (!d->have) return CORRUPT;
    d->to_rgb(rgb);
    return OK;
}

// Forget the last frame (a seek); the quantisation and Huffman tables stay.
int mjpeg_reset(void* state) {
    static_cast<Decoder*>(state)->reset();
    return OK;
}

int mjpeg_close(void* state) {
    delete static_cast<Decoder*>(state);
    return OK;
}

}  // extern "C"
