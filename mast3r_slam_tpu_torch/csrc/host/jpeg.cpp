// JPEG decoding for the port's image readers and session server, which run
// where neither cv2 nor PIL is installed.  Built into the port's host
// library beside preprocess.cpp by mast3r_slam_tpu_torch/utils/native.py;
// two plain C entry points:
//
//   jpeg_info    width, height, components and EXIF orientation from the
//                headers, and whether the stream's coding is decoded here;
//   jpeg_decode  the image as (H, W, 3) uint8 RGB, as cv2.imdecode's
//                IMREAD_COLOR gives it (in RGB order), or as (H, W) uint8
//                gray, as its IMREAD_GRAYSCALE gives it.
//
// Decoded: sequential (SOF0, SOF1) and progressive (SOF2) Huffman coding and
// sequential (SOF9) and progressive (SOF10) arithmetic coding at 8 bits, 1,
// 3 or 4 components, sampling factors up to 2x2 at integral ratios (4:4:4,
// 4:2:2, 4:4:0, 4:2:0), interleaved and single-component scans, restart
// intervals, any width and height.  A progressive stream's scans (DC first
// and refinement, AC first and refinement) accumulate into the same
// coefficient buffers that the sequential scans fill, whatever the entropy
// coding, and all end in the same output stage.  The arithmetic decoder is
// libjpeg's (jdarith.c: the QM coder of ITU T.81 Annex D, the statistics of
// F.1.4 and G.1.3, the DAC marker's conditioning), with its behaviour on
// bad data: a spectral or magnitude overflow leaves the rest of the restart
// interval as it stands.  A progressive stream whose scans stop early is
// smoothed as libjpeg-turbo smooths it (smooth_block).  The arithmetic
// follows libjpeg (the decoder behind cv2.imdecode) where it chooses: the
// ISLOW integer IDCT as libjpeg-turbo's x86 SIMD code computes it (its
// 16-bit lanes decide what a corrupt block gives), "fancy" triangle
// upsampling of the chroma with its rounding biases and edge replication,
// the fixed-point YCbCr->RGB, RGB->gray and YCCK->CMYK tables, and
// OpenCV's own CMYK->BGR and CMYK->gray, so the pixels equal cv2's.
//
// Lossless coding (SOF3, Huffman, T.81 Annex H) at 2 to 8 bits is decoded
// as libjpeg-turbo's jdlossls.c / jddiffct.c decode it: predictors 1-7, the
// point transform shifted back, the samples cut to 8 bits (never scaled up
// from fewer), the first row of each iMCU row in which a restart came
// predicted as a first row, and chroma replicated, not filtered.  cv2 reads
// it with no colour conversion: gray through IMREAD_GRAYSCALE, three
// components without JFIF's marker (or with Adobe's transform 0) as RGB and
// four as CMYK through IMREAD_COLOR.
//
// Refused as cv2 refuses them, since cv2.imdecode returns nothing for them
// (return 4): hierarchical coding, lossless arithmetic coding (SOF11), DCT
// samples other than 8 bits, lossless samples over 8 bits, and the lossless
// reads that would need a colour conversion.  Refused as gaps (return 2):
// sampling factors above 2 in DCT coding, factors at a non-integral ratio,
// and a height that comes in a DNL marker.  Truncated or corrupt streams
// return 1.  Every read is bounds-checked: the bytes and the sizes come
// from the client.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Corrupt : std::runtime_error {
  using std::runtime_error::runtime_error;
};
struct Unsupported : std::runtime_error {
  using std::runtime_error::runtime_error;
};
struct Refused : std::runtime_error {  // what cv2.imdecode returns nothing for
  using std::runtime_error::runtime_error;
};

const char* const kCv2Refuses = ": cv2 returns nothing for it";

// libjpeg-turbo's SAVED_COEFS (jdcoefct.c, 10 since 2.1): block smoothing
// reads the DC and the first nine AC coefficients of each block
constexpr int kSavedCoefs = 10;

// zigzag position -> natural (row-major) position, with libjpeg's 16 extra
// entries: a run that corrupt data carries past the band's end writes the
// last coefficient, as libjpeg writes it
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool defined = false;
  uint8_t vals[256] = {};
  int maxcode[18] = {};   // largest code of each length, -1 if none
  int valoffset[18] = {};  // vals index of a code of each length, minus the code
  uint16_t fast[512] = {};  // 9-bit lookahead: (length << 8) | symbol, 0 if longer

  void build(const uint8_t* counts, const uint8_t* symbols, int n) {
    memcpy(vals, symbols, n);
    int code = 0, k = 0;
    memset(fast, 0, sizeof(fast));
    for (int len = 1; len <= 16; ++len) {
      valoffset[len] = k - code;
      for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
        if (code >= (1 << len)) throw Corrupt("bad Huffman table");
        if (len <= 9) {
          int lo = code << (9 - len), hi = (code + 1) << (9 - len);
          for (int p = lo; p < hi; ++p) fast[p] = uint16_t((len << 8) | symbols[k]);
        }
      }
      maxcode[len] = counts[len - 1] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
  }
};

// The entropy-coded bits of a scan: 0xFF00 is a stuffed 0xFF, any other
// 0xFF marker ends the data.  Past the end the reader feeds zeros and
// counts them; a decode that consumed any of them was truncated.
struct BitReader {
  const uint8_t* d;
  size_t n, pos;
  uint64_t acc = 0;
  int cnt = 0;
  bool at_marker = false;
  bool past_end = false;  // zeros fed because the bytes ran out, with no marker
  int64_t fed_zeros = 0;  // bits fed past the data

  BitReader(const uint8_t* data, size_t size, size_t start) : d(data), n(size), pos(start) {}

  void fill() {
    while (cnt <= 56) {
      uint64_t b = 0;
      if (!at_marker && pos < n) {
        b = d[pos];
        if (b == 0xFF) {
          if (pos + 1 < n && d[pos + 1] == 0x00) {
            pos += 2;
          } else {
            at_marker = true;  // pos stays on the marker
            b = 0;
            fed_zeros += 8;
          }
        } else {
          pos += 1;
        }
      } else {
        fed_zeros += 8;
        past_end = past_end || !at_marker;
      }
      acc |= b << (56 - cnt);
      cnt += 8;
    }
  }
  uint32_t peek(int k) {
    if (cnt < k) fill();
    return uint32_t(acc >> (64 - k));
  }
  void skip(int k) {
    acc <<= k;
    cnt -= k;
  }
  int get(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    skip(k);
    return int(v);
  }
  // bits of real data left unread in the buffer (negative: zeros were read)
  int64_t real_left() const { return int64_t(cnt) - fed_zeros; }
  // zeros past a marker are libjpeg's insufficient data; past the bytes' end
  // (no marker) the stream is truncated
  bool insufficient() const {
    if (real_left() >= 0) return false;
    if (past_end) throw Corrupt("truncated JPEG: the entropy-coded data ends early");
    return true;
  }
  // move to the marker that ends the data (skipping any bytes before it):
  // restart markers and the scan's end are byte aligned, and the bits
  // left in the buffer are padding
  void to_marker() {
    while (!at_marker && pos + 1 < n && !(d[pos] == 0xFF && d[pos + 1] != 0x00)) ++pos;
    if (!at_marker && pos + 1 >= n) pos = n;
  }
  int decode(const Huffman& h) {
    uint32_t p9 = peek(16) >> 7;
    uint16_t f = h.fast[p9];
    if (f) {
      skip(f >> 8);
      return f & 0xFF;
    }
    uint32_t p16 = peek(16);
    for (int len = 10; len <= 16; ++len) {
      int code = int(p16 >> (16 - len));
      if (code <= h.maxcode[len]) {
        skip(len);
        int idx = h.valoffset[len] + code;
        if (idx < 0 || idx > 255) throw Corrupt("bad Huffman code");
        return h.vals[idx];
      }
    }
    skip(16);  // no code: libjpeg takes 17 bits for symbol 0
    get(1);
    return 0;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// Where libjpeg's next_marker finds the marker at or after p: the first
// 0xFF of a run that ends in a code other than 0x00 (0xFF00 pairs and any
// other bytes skipped); n if there is none.
size_t next_marker_at(const uint8_t* d, size_t n, size_t p) {
  while (true) {
    while (p < n && d[p] != 0xFF) ++p;
    size_t q = p + 1;
    while (q < n && d[q] == 0xFF) ++q;
    if (q >= n) return n;
    if (d[q] != 0x00) return p;
    p = q + 1;
  }
}

// libjpeg's read_restart_marker and jpeg_resync_to_restart (jdmarker.c)
// from the marker at p (n: none before the data's end): the RSTn expected,
// or an RSTn three or more intervals away, is taken; an RSTn of the next
// two intervals, or any other marker from SOF0 up, is left unread, and the
// intervals up to it decode from zero bits; an RSTn of the two previous
// intervals, or a code below SOF0, is passed and the next marker decided
// again.  Returns whether the marker was taken; [*at, *end) is the marker.
bool resync_to_restart(const uint8_t* d, size_t n, size_t p, int expected, size_t* at,
                       size_t* end) {
  for (;;) {
    if (p >= n) throw Corrupt("JPEG restart marker missing");
    size_t q = p + 1;
    while (q < n && d[q] == 0xFF) ++q;
    if (q >= n) throw Corrupt("JPEG restart marker missing");
    const int code = d[q], k = code - 0xD0;
    *at = p;
    *end = q + 1;
    if (code >= 0xC0 && (code < 0xD0 || code > 0xD7)) return false;
    if (code >= 0xC0) {
      if (k == ((expected + 1) & 7) || k == ((expected + 2) & 7)) return false;
      if (k != ((expected + 7) & 7) && k != ((expected + 6) & 7)) return true;
    }
    p = next_marker_at(d, n, q + 1);
  }
}

// T.81 Table D.2 as libjpeg's jaricom.c packs it: Qe << 16, Next_Index_MPS
// << 8, Switch_MPS << 7, Next_Index_LPS.  Entry 113 is the fixed estimate
// of 0.5 (T.851) that sign and refinement bits are coded with.
#define ARI(qe, lps, mps, sw) ((uint32_t(qe) << 16) | (uint32_t(mps) << 8) | ((sw) << 7) | (lps))
const uint32_t kAriTab[114] = {
    ARI(0x5a1d, 1, 1, 1),     ARI(0x2586, 14, 2, 0),    ARI(0x1114, 16, 3, 0),
    ARI(0x080b, 18, 4, 0),    ARI(0x03d8, 20, 5, 0),    ARI(0x01da, 23, 6, 0),
    ARI(0x00e5, 25, 7, 0),    ARI(0x006f, 28, 8, 0),    ARI(0x0036, 30, 9, 0),
    ARI(0x001a, 33, 10, 0),   ARI(0x000d, 35, 11, 0),   ARI(0x0006, 9, 12, 0),
    ARI(0x0003, 10, 13, 0),   ARI(0x0001, 12, 13, 0),   ARI(0x5a7f, 15, 15, 1),
    ARI(0x3f25, 36, 16, 0),   ARI(0x2cf2, 38, 17, 0),   ARI(0x207c, 39, 18, 0),
    ARI(0x17b9, 40, 19, 0),   ARI(0x1182, 42, 20, 0),   ARI(0x0cef, 43, 21, 0),
    ARI(0x09a1, 45, 22, 0),   ARI(0x072f, 46, 23, 0),   ARI(0x055c, 48, 24, 0),
    ARI(0x0406, 49, 25, 0),   ARI(0x0303, 51, 26, 0),   ARI(0x0240, 52, 27, 0),
    ARI(0x01b1, 54, 28, 0),   ARI(0x0144, 56, 29, 0),   ARI(0x00f5, 57, 30, 0),
    ARI(0x00b7, 59, 31, 0),   ARI(0x008a, 60, 32, 0),   ARI(0x0068, 62, 33, 0),
    ARI(0x004e, 63, 34, 0),   ARI(0x003b, 32, 35, 0),   ARI(0x002c, 33, 9, 0),
    ARI(0x5ae1, 37, 37, 1),   ARI(0x484c, 64, 38, 0),   ARI(0x3a0d, 65, 39, 0),
    ARI(0x2ef1, 67, 40, 0),   ARI(0x261f, 68, 41, 0),   ARI(0x1f33, 69, 42, 0),
    ARI(0x19a8, 70, 43, 0),   ARI(0x1518, 72, 44, 0),   ARI(0x1177, 73, 45, 0),
    ARI(0x0e74, 74, 46, 0),   ARI(0x0bfb, 75, 47, 0),   ARI(0x09f8, 77, 48, 0),
    ARI(0x0861, 78, 49, 0),   ARI(0x0706, 79, 50, 0),   ARI(0x05cd, 48, 51, 0),
    ARI(0x04de, 50, 52, 0),   ARI(0x040f, 50, 53, 0),   ARI(0x0363, 51, 54, 0),
    ARI(0x02d4, 52, 55, 0),   ARI(0x025c, 53, 56, 0),   ARI(0x01f8, 54, 57, 0),
    ARI(0x01a4, 55, 58, 0),   ARI(0x0160, 56, 59, 0),   ARI(0x0125, 57, 60, 0),
    ARI(0x00f6, 58, 61, 0),   ARI(0x00cb, 59, 62, 0),   ARI(0x00ab, 61, 63, 0),
    ARI(0x008f, 61, 32, 0),   ARI(0x5b12, 65, 65, 1),   ARI(0x4d04, 80, 66, 0),
    ARI(0x412c, 81, 67, 0),   ARI(0x37d8, 82, 68, 0),   ARI(0x2fe8, 83, 69, 0),
    ARI(0x293c, 84, 70, 0),   ARI(0x2379, 86, 71, 0),   ARI(0x1edf, 87, 72, 0),
    ARI(0x1aa9, 87, 73, 0),   ARI(0x174e, 72, 74, 0),   ARI(0x1424, 72, 75, 0),
    ARI(0x119c, 74, 76, 0),   ARI(0x0f6b, 74, 77, 0),   ARI(0x0d51, 75, 78, 0),
    ARI(0x0bb6, 77, 79, 0),   ARI(0x0a40, 77, 48, 0),   ARI(0x5832, 80, 81, 1),
    ARI(0x4d1c, 88, 82, 0),   ARI(0x438e, 89, 83, 0),   ARI(0x3bdd, 90, 84, 0),
    ARI(0x34ee, 91, 85, 0),   ARI(0x2eae, 92, 86, 0),   ARI(0x299a, 93, 87, 0),
    ARI(0x2516, 86, 71, 0),   ARI(0x5570, 88, 89, 1),   ARI(0x4ca9, 95, 90, 0),
    ARI(0x44d9, 96, 91, 0),   ARI(0x3e22, 97, 92, 0),   ARI(0x3824, 99, 93, 0),
    ARI(0x32b4, 99, 94, 0),   ARI(0x2e17, 93, 86, 0),   ARI(0x56a8, 95, 96, 1),
    ARI(0x4f46, 101, 97, 0),  ARI(0x47e5, 102, 98, 0),  ARI(0x41cf, 103, 99, 0),
    ARI(0x3c3d, 104, 100, 0), ARI(0x375e, 99, 93, 0),   ARI(0x5231, 105, 102, 0),
    ARI(0x4c0f, 106, 103, 0), ARI(0x4639, 107, 104, 0), ARI(0x415e, 103, 99, 0),
    ARI(0x5627, 105, 106, 1), ARI(0x50e7, 108, 107, 0), ARI(0x4b85, 109, 103, 0),
    ARI(0x5597, 110, 109, 0), ARI(0x504f, 111, 107, 0), ARI(0x5a10, 110, 111, 1),
    ARI(0x5522, 112, 109, 0), ARI(0x59eb, 112, 111, 1), ARI(0x5a1d, 113, 113, 0)};
#undef ARI
constexpr uint8_t kFixedBin = 113;

// libjpeg's QM decoder (jdarith.c arith_decode): C holds the code base and
// the bits read ahead, split by ct.  0xFF00 is a stuffed 0xFF; at a marker
// the decoder is fed zeros, which arithmetic coding allows; data that ends
// with no marker is truncated (cv2 returns nothing then).
struct ArithDecoder {
  const uint8_t* d;
  size_t n, pos;
  int64_t c = 0, a = 0;
  int ct = -16;             // -1 after a spectral or magnitude overflow
  bool at_marker = false;   // the data met a marker: zeros from there on
  size_t marker_at = 0;     // that marker's first 0xFF
  size_t marker_end = 0;    // past its code
  int marker_code = 0;

  ArithDecoder(const uint8_t* data, size_t size, size_t start) : d(data), n(size), pos(start) {}

  int next_byte() {
    if (pos >= n) throw Corrupt("truncated JPEG: the arithmetic-coded data ends early");
    return d[pos++];
  }

  int decode(uint8_t* st) {
    while (a < 0x8000) {  // renormalisation and data input (D.2.6)
      if (--ct < 0) {
        int data = 0;
        if (!at_marker) {
          const size_t at = pos;
          data = next_byte();
          if (data == 0xFF) {
            do data = next_byte(); while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;
            } else {
              at_marker = true;
              marker_at = at;
              marker_end = pos;
              marker_code = data;
              data = 0;
            }
          }
        }
        c = (c << 8) | data;
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;  // two bytes in: A starts at 0x10000
      }
      a <<= 1;
    }
    int sv = *st;
    uint32_t qe = kAriTab[sv & 0x7F];
    const uint8_t nl = qe & 0xFF;
    qe >>= 8;
    const uint8_t nm = qe & 0xFF;
    qe >>= 8;
    int64_t temp = a - qe;  // decision and estimation (D.2.4, D.2.5)
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  // process_restart: the marker the data met, else the next one, resynced
  // to (resync_to_restart); the decoder reset.  A marker left unread feeds
  // zeros to the intervals up to it.
  void restart(int expected) {
    size_t p = at_marker ? marker_at : next_marker_at(d, n, pos);
    size_t end;
    if (resync_to_restart(d, n, p, expected, &marker_at, &end)) {
      pos = end;
      at_marker = false;
    } else {
      at_marker = true;
      marker_end = end;
      marker_code = d[end - 1];
    }
    c = a = 0;
    ct = -16;
  }

  // where the marker after the scan's data begins
  size_t scan_end() const { return at_marker ? marker_at : next_marker_at(d, n, pos); }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int vd = 1;             // the vertical factor as declared (smoothing's block rows an iMCU row)
  int td = 0, ta = 0;     // Huffman tables of the current scan
  int bw = 0, bh = 0;     // blocks a row and column, MCU-padded
  int dw = 0, dh = 0;     // downsampled width and height (real samples)
  std::vector<int16_t> coef;  // bh * bw blocks of 64, natural order
  std::vector<int32_t> diff;  // lossless: bh x bw samples' differences,
  std::vector<uint16_t> samp;  // their samples (16 bits, as libjpeg keeps them)
  std::vector<uint8_t> out8;   // and the samples as output (shifted by Pt, cut to 8 bits)
  int64_t pred = 0;
  int dc_context = 0;     // arithmetic coding: the DC statistics' conditioning (F.1.4.4.1.2)
  bool scanned = false;
  bool latched = false;   // the quantisation table, copied at the first scan as libjpeg does
  uint16_t qt[64] = {};   // natural order
  int coef_bits[64];      // progressive: the Al of each coefficient's last scan, -1 before
  int prev_bits[kSavedCoefs];  // coef_bits before the component's last scan (0 before the first)
  Component() {
    std::fill(coef_bits, coef_bits + 64, -1);
    std::fill(prev_bits, prev_bits + kSavedCoefs, -1);
  }
};

struct Decoder {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart = 0;
  bool frame = false, adobe = false, jfif = false;
  bool progressive = false, any_scan = false;
  int scans = 0;          // DCT scans read
  // libjpeg-turbo's last_good_iMCU_row: the iMCU row of the last MCU of the
  // last scan that came (before its restart) with the data not yet at a marker;
  // smoothing takes the rows after it from the bits before that scan
  int last_good_row = 0;
  bool arithmetic = false, lossless = false;
  int precision = 8;
  int unit = 8;           // samples a block is wide: 8, or 1 for lossless coding
  // arithmetic coding's conditioning (DAC; T.81 F.1.4.4: L 0, U 1, Kx 5
  // unless set) and its statistics bins, as libjpeg sizes them
  uint8_t dac_L[16], dac_U[16], dac_K[16];
  uint8_t dc_stats[16][64], ac_stats[16][256];
  uint8_t fixed_bin = kFixedBin;
  int adobe_transform = -1;
  int orientation = 1;
  uint16_t quant[4][64] = {};
  bool quant_defined[4] = {};
  Huffman dc[4], ac[4];
  Component comp[4];
  bool allocate = false;

  Decoder(const uint8_t* data, size_t size) : d(data), n(size) {
    std::fill(dac_L, dac_L + 16, 0);
    std::fill(dac_U, dac_U + 16, 1);
    std::fill(dac_K, dac_K + 16, 5);
  }

  int u8() {
    if (pos >= n) throw Corrupt("truncated JPEG header");
    return d[pos++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  // the next marker's code, skipping fill bytes and, as libjpeg does, any
  // bytes before them
  int marker() {
    for (;;) {  // libjpeg's next_marker: a stuffed 0xFF00 is passed too
      while (u8() != 0xFF) {
      }
      int m;
      do m = u8(); while (m == 0xFF);
      if (m) return m;
    }
  }

  void read_exif(size_t at, size_t len) {
    // APP1 "Exif\0\0" then a TIFF header; only IFD0's orientation is read,
    // and a malformed one is ignored
    if (len < 14 || memcmp(d + at, "Exif\0\0", 6) != 0) return;
    const uint8_t* t = d + at + 6;
    size_t tn = len - 6;
    bool le;
    if (t[0] == 'I' && t[1] == 'I') le = true;
    else if (t[0] == 'M' && t[1] == 'M') le = false;
    else return;
    auto r16 = [&](size_t o) -> uint32_t {
      return le ? uint32_t(t[o] | (t[o + 1] << 8)) : uint32_t((t[o] << 8) | t[o + 1]);
    };
    auto r32 = [&](size_t o) -> uint32_t {
      return le ? (r16(o) | (r16(o + 2) << 16)) : ((r16(o) << 16) | r16(o + 2));
    };
    size_t ifd = r32(4);
    if (ifd + 2 > tn) return;
    uint32_t entries = r16(ifd);
    for (uint32_t i = 0; i < entries; ++i) {
      size_t e = ifd + 2 + 12 * size_t(i);
      if (e + 12 > tn) return;
      if (r16(e) == 0x0112 && r16(e + 2) == 3 && r32(e + 4) == 1) {
        uint32_t o = r16(e + 8);
        if (o >= 1 && o <= 8) orientation = int(o);
        return;
      }
    }
  }

  void read_frame(int m) {
    if (frame) throw Corrupt("second JPEG frame header");
    progressive = m == 0xC2 || m == 0xCA;
    arithmetic = m == 0xC9 || m == 0xCA;
    lossless = m == 0xC3;
    unit = lossless ? 1 : 8;
    size_t len = size_t(u16());
    size_t end = pos + len - 2;
    if (len < 8 || end > n) throw Corrupt("bad JPEG frame header");
    precision = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    // libjpeg-turbo reads lossless samples of 2 to 16 bits and DCT ones of
    // 8 or 12, but cv2 reads 8-bit samples (and fewer, lossless) alone
    if (lossless ? (precision < 2 || precision > 8) : precision != 8)
      throw Refused(std::string(lossless ? "lossless JPEG" : "JPEG") + " of " +
                    std::to_string(precision) + "-bit samples" + kCv2Refuses);
    if (height == 0) throw Unsupported("JPEG whose height comes in a DNL marker");
    if (width == 0) throw Corrupt("JPEG of width 0");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      throw Corrupt("JPEG of " + std::to_string(ncomp) + " components");
    if (len != size_t(8 + 3 * ncomp)) throw Corrupt("bad JPEG frame header length");
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        throw Corrupt("bad JPEG component header");
      if (!lossless && (c.h > 2 || c.v > 2))  // lossless chroma is replicated, at any factor
        throw Unsupported("JPEG sampling factors above 2");
      c.vd = c.v;
    }
    if (ncomp == 1) comp[0].h = comp[0].v = 1;  // one component: a block an MCU
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; ++i) {
      if (comp[i].h > hmax) hmax = comp[i].h;
      if (comp[i].v > vmax) vmax = comp[i].v;
    }
    for (int i = 0; i < ncomp; ++i)
      if (hmax % comp[i].h || vmax % comp[i].v)
        throw Unsupported("JPEG sampling factors at a non-integral ratio");
    mcux = (width + unit * hmax - 1) / (unit * hmax);
    mcuy = (height + unit * vmax - 1) / (unit * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = int((int64_t(width) * c.h + hmax - 1) / hmax);
      c.dh = int((int64_t(height) * c.v + vmax - 1) / vmax);
      if (!allocate) continue;
      const size_t units = size_t(c.bw) * c.bh;
      if (lossless) {
        c.diff.assign(units, 0);
        c.samp.assign(units, 0);
        c.out8.assign(units, 0);
      } else {
        c.coef.assign(units * 64, 0);
      }
    }
    frame = true;
  }

  void read_dqt() {
    size_t len = size_t(u16());
    size_t end = pos + len - 2;
    if (len < 2 || end > n) throw Corrupt("bad JPEG quantisation table");
    while (pos < end) {
      int pq = u8();
      int t = pq & 15, p = pq >> 4;
      if (t > 3 || p > 1) throw Corrupt("bad JPEG quantisation table");
      if (pos + (p ? 128 : 64) > end) throw Corrupt("bad JPEG quantisation table");
      for (int k = 0; k < 64; ++k) quant[t][kNatural[k]] = uint16_t(p ? u16() : u8());
      quant_defined[t] = true;
    }
    if (pos != end) throw Corrupt("bad JPEG quantisation table");
  }

  void read_dht() {
    size_t len = size_t(u16());
    size_t end = pos + len - 2;
    if (len < 2 || end > n) throw Corrupt("bad JPEG Huffman table");
    while (pos < end) {
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) throw Corrupt("bad JPEG Huffman table");
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i] = uint8_t(u8());
      if (total > 256 || pos + total > end) throw Corrupt("bad JPEG Huffman table");
      (tc ? ac[th] : dc[th]).build(counts, d + pos, total);
      pos += total;
    }
    if (pos != end) throw Corrupt("bad JPEG Huffman table");
  }

  // DAC: arithmetic coding's conditioning of a DC table (L, U) or an AC
  // table (Kx), checked as libjpeg's get_dac checks it
  void read_dac() {
    size_t len = size_t(u16());
    if (len < 2 || pos + len - 2 > n) throw Corrupt("bad JPEG DAC segment");
    int64_t left = int64_t(len) - 2;
    while (left > 0) {
      const int index = u8(), val = u8();
      left -= 2;
      if (index >= 32) throw Corrupt("bad JPEG DAC table index");
      if (index >= 16) {
        dac_K[index - 16] = uint8_t(val);
      } else {
        dac_L[index] = uint8_t(val & 15);
        dac_U[index] = uint8_t(val >> 4);
        if (dac_L[index] > dac_U[index]) throw Corrupt("bad JPEG DAC value");
      }
    }
    if (left != 0) throw Corrupt("bad JPEG DAC segment length");
  }

  // the DC prediction, refused where libjpeg's int would overflow
  static void add_dc(Component& c, int diff) {
    c.pred += diff;
    if (c.pred > INT32_MAX || c.pred < INT32_MIN) throw Corrupt("bad JPEG DC coefficient");
  }

  void decode_block(BitReader& br, Component& c, int16_t* blk) {
    const Huffman& dct = dc[c.td];
    const Huffman& act = ac[c.ta];
    int s = br.decode(dct);
    if (s > 15) throw Corrupt("bad JPEG DC coefficient");
    add_dc(c, s ? extend(br.get(s), s) : 0);
    blk[0] = int16_t(c.pred);
    for (int k = 1; k < 64; ++k) {
      int rs = br.decode(act);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = int16_t(extend(br.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  // The four progressive scan kinds, after libjpeg's jdphuff.c.  Values
  // shifted left by Al wrap to 16 bits as libjpeg's JCOEF does.
  static int16_t shifted(int64_t v, int al) { return int16_t(int32_t(uint32_t(v) << al)); }

  void dc_first(BitReader& br, Component& c, int16_t* blk, int al) {
    int s = br.decode(dc[c.td]);
    if (s > 15) throw Corrupt("bad JPEG DC coefficient");
    add_dc(c, s ? extend(br.get(s), s) : 0);
    blk[0] = shifted(c.pred, al);
  }

  static void dc_refine(BitReader& br, int16_t* blk, int al) {
    if (br.get(1)) blk[0] = int16_t(blk[0] | (1 << al));
  }

  // eobrun: blocks of the band left with no further coefficient
  void ac_first(BitReader& br, Component& c, int16_t* blk, int ss, int se, int al,
                int& eobrun) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    const Huffman& act = ac[c.ta];
    for (int k = ss; k <= se; ++k) {
      int rs = br.decode(act);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = shifted(extend(br.get(s), s), al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = (1 << r) - 1 + br.get(r);  // this block ends the run's first
        break;
      }
    }
  }

  // A correction bit for a coefficient already nonzero: 1 moves it one
  // step of 1 << Al away from zero, unless that bit is already set.
  static void correct(BitReader& br, int16_t& co, int al) {
    if (br.get(1) && (co & (1 << al)) == 0) co = int16_t(co >= 0 ? co + (1 << al) : co - (1 << al));
  }

  void ac_refine(BitReader& br, Component& c, int16_t* blk, int ss, int se, int al,
                 int& eobrun) {
    int k = ss;
    if (eobrun == 0) {
      const Huffman& act = ac[c.ta];
      for (; k <= se; ++k) {
        int rs = br.decode(act);
        int r = rs >> 4, s = rs & 15;
        if (s) {  // a newly nonzero coefficient: its size is 1 (libjpeg reads one bit
                  // whatever the size says), its sign the next bit
          s = br.get(1) ? (1 << al) : -(1 << al);
        } else if (r != 15) {
          eobrun = (1 << r) + br.get(r);
          break;
        }
        // pass r zero coefficients (16 for a ZRL), correcting each nonzero one
        // on the way; a new coefficient lands on the zero after them
        for (; k <= se; ++k) {
          int16_t& co = blk[kNatural[k]];
          if (co != 0) correct(br, co, al);
          else if (--r < 0) break;
        }
        if (s) blk[kNatural[k]] = int16_t(s);
      }
    }
    if (eobrun > 0) {  // inside the run: a correction bit for each nonzero coefficient left
      for (; k <= se; ++k) {
        int16_t& co = blk[kNatural[k]];
        if (co != 0) correct(br, co, al);
      }
      --eobrun;
    }
  }

  // Arithmetic coding, after libjpeg's jdarith.c.  A spectral or magnitude
  // overflow sets ct to -1 (libjpeg warns, JWRN_ARITH_BAD_CODE), and every
  // later block of the restart interval is left as it stands.

  // F.1.4.4.1 / F.2.4.1: a DC difference, its bins chosen by the
  // component's last one; false on a magnitude overflow
  bool arith_dc_diff(ArithDecoder& ad, Component& c, int& v) {
    uint8_t* const stats = dc_stats[c.td];
    uint8_t* st = stats + c.dc_context;
    v = 0;
    if (ad.decode(st) == 0) {
      c.dc_context = 0;
      return true;
    }
    const int sign = ad.decode(st + 1);
    st += 2 + sign;
    int m = ad.decode(st);
    if (m) {
      st = stats + 20;  // X1
      while (ad.decode(st)) {
        if ((m <<= 1) == 0x8000) {
          ad.ct = -1;
          return false;
        }
        st += 1;
      }
    }
    if (m < ((1 << dac_L[c.td]) >> 1))
      c.dc_context = 0;
    else if (m > ((1 << dac_U[c.td]) >> 1))
      c.dc_context = 12 + 4 * sign;
    else
      c.dc_context = 4 + 4 * sign;
    v = m;
    st += 14;
    while (m >>= 1)
      if (ad.decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    return true;
  }

  // F.1.4.4.2: the sign and magnitude of a nonzero AC coefficient at
  // zigzag position k, st its bins' base (3 (k - 1)); false on an overflow
  bool arith_ac_value(ArithDecoder& ad, uint8_t* stats, uint8_t* st, int k, int tbl, int& v) {
    const int sign = ad.decode(&fixed_bin);
    st += 2;
    int m = ad.decode(st);
    if (m && ad.decode(st)) {
      m <<= 1;
      st = stats + (k <= dac_K[tbl] ? 189 : 217);  // X2
      while (ad.decode(st)) {
        if ((m <<= 1) == 0x8000) {
          ad.ct = -1;
          return false;
        }
        st += 1;
      }
    }
    v = m;
    st += 14;
    while (m >>= 1)
      if (ad.decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    return true;
  }

  // the coefficients of band ss..se, first coded (sequential: 1..63, al 0);
  // their zero runs and ends of block decided position by position
  void arith_ac_band(ArithDecoder& ad, Component& c, int16_t* blk, int ss, int se, int al) {
    uint8_t* const stats = ac_stats[c.ta];
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = stats + 3 * (k - 1);
      if (ad.decode(st)) break;  // end of block
      while (ad.decode(st + 1) == 0) {
        st += 3;
        if (++k > se) {  // spectral overflow
          ad.ct = -1;
          return;
        }
      }
      int v;
      if (!arith_ac_value(ad, stats, st, k, c.ta, v)) return;
      blk[kNatural[k]] = int16_t(int32_t(uint32_t(v) << al));
    }
  }

  void arith_block(ArithDecoder& ad, Component& c, int16_t* blk) {
    if (ad.ct == -1) return;
    int v;
    if (!arith_dc_diff(ad, c, v)) return;
    c.pred = (c.pred + v) & 0xFFFF;
    blk[0] = int16_t(uint16_t(c.pred));
    arith_ac_band(ad, c, blk, 1, 63, 0);
  }

  void arith_dc_first(ArithDecoder& ad, Component& c, int16_t* blk, int al) {
    if (ad.ct == -1) return;
    int v;
    if (!arith_dc_diff(ad, c, v)) return;
    c.pred += v;
    blk[0] = shifted(c.pred, al);
  }

  void arith_dc_refine(ArithDecoder& ad, int16_t* blk, int al) {
    if (ad.decode(&fixed_bin)) blk[0] = int16_t(blk[0] | (1 << al));
  }

  void arith_ac_first(ArithDecoder& ad, Component& c, int16_t* blk, int ss, int se, int al) {
    if (ad.ct == -1) return;
    arith_ac_band(ad, c, blk, ss, se, al);
  }

  // G.1.3.3: past the last coefficient already nonzero (EOBx) an end of
  // block may come; a nonzero coefficient takes a correction bit, a zero
  // one a decision whether it becomes +-1 << al
  void arith_ac_refine(ArithDecoder& ad, Component& c, int16_t* blk, int ss, int se, int al) {
    if (ad.ct == -1) return;
    uint8_t* const stats = ac_stats[c.ta];
    const int p1 = 1 << al, m1 = -p1;
    int kex = se;
    while (kex > 0 && !blk[kNatural[kex]]) --kex;
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = stats + 3 * (k - 1);
      if (k > kex && ad.decode(st)) break;
      while (true) {
        int16_t& co = blk[kNatural[k]];
        if (co) {
          if (ad.decode(st + 2)) co = int16_t(co < 0 ? co + m1 : co + p1);
          break;
        }
        if (ad.decode(st + 1)) {
          co = int16_t(ad.decode(&fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) {
          ad.ct = -1;
          return;
        }
      }
    }
  }

  // the statistics a scan starts with and each restart resets (libjpeg's
  // start_pass and process_restart)
  void reset_arith_stats(Component* const* sc, int ns, int ss, int ah) {
    for (int i = 0; i < ns; ++i) {
      Component& c = *sc[i];
      if (!progressive || (ss == 0 && ah == 0)) {
        memset(dc_stats[c.td], 0, sizeof(dc_stats[0]));
        c.pred = 0;
        c.dc_context = 0;
      }
      if (!progressive || ss) memset(ac_stats[c.ta], 0, sizeof(ac_stats[0]));
    }
  }

  // process_restart's marker (resync_to_restart): br moved past it if it
  // is taken (true), else onto it, which feeds zero bits; bits left in the
  // buffer are padding.  A DCT scan's bits past the data's end are a
  // truncated stream.
  bool restart_marker(BitReader& br, int expected) {
    if (!lossless) br.insufficient();
    size_t p = br.at_marker ? br.pos : next_marker_at(d, n, br.pos);
    size_t at, end;
    const bool taken = resync_to_restart(d, n, p, expected, &at, &end);
    br = BitReader(d, n, taken ? end : at);
    return taken;
  }

  // one scan's entropy-coded data, from pos to the marker after it
  void read_scan() {
    if (!frame) throw Corrupt("JPEG scan before the frame header");
    size_t len = size_t(u16());
    if (len < 6 || pos + len - 2 > n) throw Corrupt("bad JPEG scan header");
    int ns = u8();
    if (ns < 1 || ns > ncomp || len != size_t(6 + 2 * ns)) throw Corrupt("bad JPEG scan header");
    Component* sc[4];
    for (int i = 0; i < ns; ++i) {
      int id = u8(), t = u8();
      Component* c = nullptr;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == id) c = &comp[j];
      for (int j = 0; j < i; ++j)
        if (sc[j] == c) c = nullptr;
      if (!c) throw Corrupt("bad JPEG scan component");
      c->td = t >> 4;
      c->ta = t & 15;
      // Huffman coding has four tables of each kind (lossless coding uses DC
      // ones alone), arithmetic coding sixteen conditioning tables
      if (!arithmetic && (c->td > 3 || (!lossless && c->ta > 3)))
        throw Corrupt("bad JPEG scan component");
      sc[i] = c;
    }
    if (ns > 1) {  // libjpeg's D_MAX_BLOCKS_IN_MCU
      int blocks = 0;
      for (int i = 0; i < ns; ++i) blocks += sc[i]->h * sc[i]->v;
      if (blocks > 10) throw Corrupt("JPEG MCU of more than 10 blocks");
    }
    const int ss = u8(), se = u8(), a = u8();
    const int ah = a >> 4, al = a & 15;
    if (lossless) {
      // libjpeg-turbo's checks (jdlossls.c): a predictor 1-7, Se 0, no
      // successive approximation, a point transform below the precision
      if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= precision)
        throw Corrupt("bad lossless JPEG scan parameters");
      for (int i = 0; i < ns; ++i)
        if (!dc[sc[i]->td].defined) throw Corrupt("JPEG scan uses an undefined Huffman table");
      read_lossless_scan(sc, ns, ss, al);
      for (int i = 0; i < ns; ++i) sc[i]->scanned = true;
      any_scan = true;
      return;
    }
    enum Kind { SEQUENTIAL, DC_FIRST, DC_REFINE, AC_FIRST, AC_REFINE } kind = SEQUENTIAL;
    if (!progressive) {
      // libjpeg only warns of other parameters; the Huffman decoder here
      // refuses them, the arithmetic one decodes the whole band as libjpeg does
      if (!arithmetic && (ss != 0 || se != 63 || a != 0))
        throw Corrupt("bad JPEG sequential scan parameters");
    } else {
      // libjpeg's checks (jdphuff.c start_pass_phuff_decoder, jdarith.c
      // start_pass): a DC band alone, an AC band of one component, a
      // refinement one bit below the last
      bool bad = ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1);
      if ((ah != 0 && al != ah - 1) || al > 13) bad = true;
      if (bad) throw Corrupt("bad JPEG progressive scan parameters");
      kind = ss == 0 ? (ah ? DC_REFINE : DC_FIRST) : (ah ? AC_REFINE : AC_FIRST);
    }
    for (int i = 0; i < ns; ++i) {
      Component* c = sc[i];
      bool need_dc = kind == SEQUENTIAL || kind == DC_FIRST;
      bool need_ac = kind == SEQUENTIAL || kind == AC_FIRST || kind == AC_REFINE;
      if (!arithmetic &&
          ((need_dc && !dc[c->td].defined) || (need_ac && !ac[c->ta].defined)))
        throw Corrupt("JPEG scan uses an undefined Huffman table");
      if (!c->latched) {
        if (!quant_defined[c->tq])
          throw Corrupt("JPEG component uses an undefined quantisation table");
        memcpy(c->qt, quant[c->tq], sizeof(c->qt));
        c->latched = true;
      }
      // the progression's state (libjpeg warns of an out-of-order one and goes on)
      if (progressive) {
        for (int k = std::min(ss, 1); k <= std::min(std::max(se, 9), kSavedCoefs - 1); ++k)
          c->prev_bits[k] = scans ? c->coef_bits[k] : 0;
        for (int k = ss; k <= se; ++k) c->coef_bits[k] = al;
      }
      c->pred = 0;
    }
    int eobrun = 0;
    BitReader br(d, n, pos);
    ArithDecoder ad(d, n, pos);
    if (arithmetic) reset_arith_stats(sc, ns, ss, ah);
    int64_t units;  // MCUs of this scan
    int ux = 0;
    if (ns == 1) {
      Component& c = *sc[0];
      ux = (c.dw + 7) / 8;
      units = int64_t(ux) * ((c.dh + 7) / 8);
    } else {
      units = int64_t(mcux) * mcuy;
    }
    int next_rst = 0;
    // Huffman data that met a marker: libjpeg's insufficient_data, the
    // MCUs left as they stand up to a restart marker taken
    bool insufficient = false;
    last_good_row = 0;
    auto unit_row = [&](int64_t v) {  // the iMCU row of unit v
      return int(ns > 1 ? v / mcux : v / ux / sc[0]->vd);
    };
    ++scans;
    for (int64_t u = 0; u < units; ++u) {
      if (!insufficient) last_good_row = unit_row(u);
      if (restart && u > 0 && u % restart == 0) {
        if (arithmetic) {
          ad.restart(next_rst);
          reset_arith_stats(sc, ns, ss, ah);
        } else if (restart_marker(br, next_rst)) {
          insufficient = false;
        }
        next_rst = (next_rst + 1) & 7;
        for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
        eobrun = 0;
      }
      if (insufficient) continue;
      auto block = [&](Component& c, int16_t* blk) {
        if (arithmetic) {
          switch (kind) {
            case SEQUENTIAL: arith_block(ad, c, blk); break;
            case DC_FIRST: arith_dc_first(ad, c, blk, al); break;
            case DC_REFINE: arith_dc_refine(ad, blk, al); break;
            case AC_FIRST: arith_ac_first(ad, c, blk, ss, se, al); break;
            case AC_REFINE: arith_ac_refine(ad, c, blk, ss, se, al); break;
          }
          return;
        }
        switch (kind) {
          case SEQUENTIAL: decode_block(br, c, blk); break;
          case DC_FIRST: dc_first(br, c, blk, al); break;
          case DC_REFINE: dc_refine(br, blk, al); break;
          case AC_FIRST: ac_first(br, c, blk, ss, se, al, eobrun); break;
          case AC_REFINE: ac_refine(br, c, blk, ss, se, al, eobrun); break;
        }
      };
      if (ns == 1) {
        Component& c = *sc[0];
        int by = int(u / ux), bx = int(u % ux);
        block(c, c.coef.data() + (size_t(by) * c.bw + bx) * 64);
      } else {
        int my = int(u / mcux), mx = int(u % mcux);
        for (int i = 0; i < ns; ++i) {
          Component& c = *sc[i];
          for (int yy = 0; yy < c.v; ++yy)
            for (int xx = 0; xx < c.h; ++xx) {
              size_t b = size_t(my * c.v + yy) * c.bw + size_t(mx * c.h + xx);
              block(c, c.coef.data() + b * 64);
            }
        }
      }
      if (!arithmetic) insufficient = br.insufficient();
    }
    if (arithmetic) {
      pos = ad.scan_end();
    } else {
      br.insufficient();
      br.to_marker();
      pos = br.pos;
    }
    for (int i = 0; i < ns; ++i) sc[i]->scanned = true;
    any_scan = true;
  }

  // A lossless scan (T.81 Annex H), after libjpeg-turbo's jdlhuff.c and
  // jddiffct.c: each sample's difference (category 16 meaning 32768), then
  // each component's rows undifferenced as libjpeg does it, an iMCU row at
  // a time: a restart read while an iMCU row's MCU rows are decoded makes
  // the first row undifferenced after them a first row, predicted from
  // 1 << (P - Pt - 1) and its left neighbour.  Data that meets a marker
  // early is libjpeg's insufficient data: zero bits to the end of that MCU
  // row, then zero differences, each later MCU row resetting the
  // predictors as a restart does, until a restart marker.
  void read_lossless_scan(Component* const* sc, int ns, int predictor, int pt) {
    const int per_row = ns == 1 ? sc[0]->dw : mcux;  // MCUs a row
    const int mcu_rows = ns == 1 ? sc[0]->dh : mcuy;
    if (restart % per_row)
      throw Corrupt("lossless JPEG restart interval of part of an MCU row");
    const int rows_per_restart = restart / per_row;
    // the iMCU rows in which a restart came (a non-interleaved scan's iMCU
    // row is its component's v MCU rows, the factor as declared)
    const int imcu_mcu_rows = ns == 1 ? sc[0]->vd : 1;
    std::vector<char> reset(size_t(mcu_rows / imcu_mcu_rows + 1), 0);
    reset[0] = 1;
    BitReader br(d, n, pos);
    int rows_to_go = rows_per_restart, next_rst = 0;
    bool insufficient = false;
    auto diff = [&](const Huffman& h) {
      const int s = br.decode(h);
      if (s == 0) return 0;
      if (s == 16) return 32768;
      if (s > 16) throw Corrupt("bad lossless JPEG difference category");
      return extend(br.get(s), s);
    };
    for (int r = 0; r < mcu_rows; ++r) {
      if (restart && rows_to_go == 0) {
        if (restart_marker(br, next_rst)) insufficient = false;
        next_rst = (next_rst + 1) & 7;
        reset[size_t(r / imcu_mcu_rows)] = 1;
        rows_to_go = rows_per_restart;
      }
      if (insufficient) {  // the differences stay zero
        reset[size_t(r / imcu_mcu_rows)] = 1;
        if (restart) --rows_to_go;
        continue;
      }
      for (int x = 0; x < per_row; ++x) {
        if (ns == 1) {
          Component& c = *sc[0];
          c.diff[size_t(r) * c.bw + x] = diff(dc[c.td]);
          continue;
        }
        for (int i = 0; i < ns; ++i) {
          Component& c = *sc[i];
          for (int yy = 0; yy < c.v; ++yy)
            for (int xx = 0; xx < c.h; ++xx)
              c.diff[size_t(r * c.v + yy) * c.bw + size_t(x * c.h + xx)] = diff(dc[c.td]);
        }
      }
      insufficient = br.insufficient();
      if (restart) --rows_to_go;
    }
    br.to_marker();
    pos = br.pos;
    const int initial = 1 << (precision - pt - 1);
    for (int i = 0; i < ns; ++i) {
      Component& c = *sc[i];
      const int rows_a_imcu = ns == 1 ? c.vd : c.v;  // the component's rows an iMCU row
      bool first = true;
      for (int y = 0; y < c.dh; ++y) {
        if (y % rows_a_imcu == 0 && reset[size_t(y / rows_a_imcu)]) first = true;
        const int32_t* df = c.diff.data() + size_t(y) * c.bw;
        uint16_t* o = c.samp.data() + size_t(y) * c.bw;
        if (first) {
          int ra = (df[0] + initial) & 0xFFFF;
          o[0] = uint16_t(ra);
          for (int x = 1; x < c.dw; ++x) o[x] = uint16_t(ra = (df[x] + ra) & 0xFFFF);
          first = false;
        } else {
          const uint16_t* up = o - c.bw;
          int rb = up[0], ra = (df[0] + rb) & 0xFFFF;
          o[0] = uint16_t(ra);
          for (int x = 1; x < c.dw; ++x) {
            const int rc = rb;
            rb = up[x];
            int p;
            switch (predictor) {
              case 1: p = ra; break;
              case 2: p = rb; break;
              case 3: p = rc; break;
              case 4: p = ra + rb - rc; break;
              case 5: p = ra + ((rb - rc) >> 1); break;
              case 6: p = rb + ((ra - rc) >> 1); break;
              default: p = (ra + rb) >> 1; break;
            }
            o[x] = uint16_t(ra = (df[x] + p) & 0xFFFF);
          }
        }
        uint8_t* o8 = c.out8.data() + size_t(y) * c.bw;
        for (int x = 0; x < c.dw; ++x) o8[x] = uint8_t(o[x] << pt);  // jdlossls.c's scaler
      }
    }
  }

  // markers up to and including the frame header (info), or to EOI
  void parse(bool full) {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) throw Corrupt("not a JPEG stream (no SOI)");
    pos = 2;
    while (true) {
      if (full && pos >= n && all_scanned()) return;  // the EOI alone is missing
      int m = marker();
      if (m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC3 || m == 0xC9 || m == 0xCA) {
        read_frame(m);
        if (!full) return;
      } else if (m == 0xC5 || m == 0xC6 || m == 0xC7 || m == 0xCD || m == 0xCE || m == 0xCF) {
        throw Refused(std::string("hierarchical JPEG (SOF") + std::to_string(m - 0xC0) + ")" +
                      kCv2Refuses);
      } else if (m == 0xCB) {
        throw Refused(std::string("arithmetic-coded lossless JPEG (SOF11)") + kCv2Refuses);
      } else if (m == 0xCC) {
        read_dac();
      } else if (m == 0xC4) {
        read_dht();
      } else if (m == 0xDB) {
        read_dqt();
      } else if (m == 0xDD) {
        if (u16() != 4) throw Corrupt("bad JPEG restart interval");
        restart = u16();
      } else if (m == 0xDA) {
        read_scan();
      } else if (m == 0xD9) {
        if (!frame || (full && !all_scanned())) throw Corrupt("JPEG ends before its image data");
        return;
      } else if (m >= 0xD0 && m <= 0xD7) {
        // a restart marker outside a scan carries nothing
      } else if (m == 0xDC) {
        throw Unsupported("JPEG with a DNL marker");
      } else if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE || (m >= 0xF0 && m <= 0xFD)) {
        size_t len = size_t(u16());
        if (len < 2 || pos + len - 2 > n) throw Corrupt("bad JPEG segment length");
        size_t at = pos, body = len - 2;
        if (m == 0xE0 && body >= 5 && memcmp(d + at, "JFIF\0", 5) == 0) jfif = true;
        if (m == 0xEE && body >= 12 && memcmp(d + at, "Adobe", 5) == 0) {
          adobe = true;
          adobe_transform = d[at + 11];
        }
        if (m == 0xE1) read_exif(at, body);
        pos += body;
      } else {
        throw Corrupt("unexpected JPEG marker");
      }
    }
  }

  // sequential: every component has its scan; progressive: any scan was
  // read, and later ones may be missing (libjpeg decodes what came)
  bool all_scanned() const {
    if (!frame) return false;
    if (progressive) return any_scan;
    for (int i = 0; i < ncomp; ++i)
      if (!comp[i].scanned) return false;
    return true;
  }

  // libjpeg-turbo's smoothing_ok (jdcoefct.c): cv2 smooths the blocks of a
  // progressive image (do_block_smoothing is on by default) when every
  // component has been scanned with nonzero quantisers at the first
  // kSavedCoefs positions and a known DC, and one of the first nine AC
  // coefficients of some component still lacks bits
  bool smoothing_ok() const {
    if (!progressive) return false;
    bool useful = false;
    for (int i = 0; i < ncomp; ++i) {
      const Component& c = comp[i];
      if (!c.latched || c.coef_bits[0] < 0) return false;
      for (int k = 0; k < kSavedCoefs; ++k)
        if (c.qt[kNatural[k]] == 0) return false;
      for (int k = 1; k < kSavedCoefs; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  bool is_rgb() const {
    // libjpeg's guess of the colour space of 3 components (lossless: RGB
    // unless a marker says otherwise, whatever the ids)
    if (jfif) return false;
    if (adobe) return adobe_transform == 0;
    return lossless || (comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B');
  }

  // libjpeg's guess for 4 components: an Adobe transform other than 0
  // means YCCK, anything else CMYK
  bool is_ycck() const { return adobe && adobe_transform != 0; }
};

// jpeg_idct_islow as libjpeg-turbo's x86 SIMD code computes it
// (jidctint-sse2.asm / -avx2.asm, which cv2's build runs): the algorithm of
// jidctint.c (CONST_BITS 13, PASS1_BITS 2) regrouped into pairwise
// products, on 16-bit lanes.  For the coefficients of any real image it
// equals the C code; where a corrupt stream's coefficients overflow, the
// lanes wrap and saturate as the SIMD code's do: coefficient times
// quantiser kept to 16 bits, the sums in0 + in4, in0 - in4, in7 + in3 and
// in5 + in1 wrapped to 16 bits, the 32-bit products wrapped, each pass's
// result saturated to 16 bits, and the output saturated to 0..255.  A block
// whose rows 1-7 are all zero takes pass 1's shortcut (the DC row times 4,
// wrapped to 16 bits).  Two more skips give what the full pass gives: a
// column whose dequantised rows 1-7 are zero is its DC times 4, saturated,
// and a row of the workspace whose entries 1-7 are zero is its entry 0
// descaled by 5 bits.
namespace islow {

constexpr int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                  F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                  F2562 = 20995, F3072 = 25172;

inline int16_t wrap16(int32_t x) { return int16_t(uint16_t(uint32_t(x))); }
inline int16_t sat16(int32_t x) { return int16_t(x < -32768 ? -32768 : (x > 32767 ? 32767 : x)); }
// pmaddwd: a * fa + b * fb of 16-bit lanes into a 32-bit one (wrapping)
inline int32_t madd(int16_t a, int32_t fa, int16_t b, int32_t fb) {
  return int32_t(uint32_t(int32_t(a) * fa) + uint32_t(int32_t(b) * fb));
}
inline int32_t add(int32_t a, int32_t b) { return int32_t(uint32_t(a) + uint32_t(b)); }
inline int32_t sub(int32_t a, int32_t b) { return int32_t(uint32_t(a) - uint32_t(b)); }

// one 1-D pass over in[0], in[step], ..., in[7 step]: the eight sums
// before their descaling, in output order
inline void pass(const int16_t* in, int step, int32_t* o) {
  const int16_t i0 = in[0], i1 = in[step], i2 = in[2 * step], i3 = in[3 * step],
                i4 = in[4 * step], i5 = in[5 * step], i6 = in[6 * step], i7 = in[7 * step];
  // even part: tmp3 = z2 (0.541 + 0.765) + z3 0.541, tmp2 = z2 0.541 + z3 (0.541 - 1.848)
  const int32_t tmp3 = madd(i2, F0541 + F0765, i6, F0541);
  const int32_t tmp2 = madd(i2, F0541, i6, F0541 - F1847);
  const int32_t tmp0 = int32_t(uint32_t(int32_t(wrap16(i0 + i4))) << 13);
  const int32_t tmp1 = int32_t(uint32_t(int32_t(wrap16(i0 - i4))) << 13);
  const int32_t tmp10 = add(tmp0, tmp3), tmp13 = sub(tmp0, tmp3);
  const int32_t tmp11 = add(tmp1, tmp2), tmp12 = sub(tmp1, tmp2);
  // odd part, z3 = in7 + in3 and z4 = in5 + in1 in 16 bits
  const int16_t z3 = wrap16(i7 + i3), z4 = wrap16(i5 + i1);
  const int32_t z3m = madd(z3, F1175 - F1961, z4, F1175);
  const int32_t z4m = madd(z3, F1175, z4, F1175 - F0390);
  const int32_t o0 = add(madd(i7, F0298 - F0899, i1, -F0899), z3m);
  const int32_t o3 = add(madd(i7, -F0899, i1, F1501 - F0899), z4m);
  const int32_t o1 = add(madd(i5, F2053 - F2562, i3, -F2562), z4m);
  const int32_t o2 = add(madd(i5, -F2562, i3, F3072 - F2562), z3m);
  o[0] = add(tmp10, o3);
  o[7] = sub(tmp10, o3);
  o[1] = add(tmp11, o2);
  o[6] = sub(tmp11, o2);
  o[2] = add(tmp12, o1);
  o[5] = sub(tmp12, o1);
  o[3] = add(tmp13, o0);
  o[4] = sub(tmp13, o0);
}

}  // namespace islow

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  using namespace islow;
  int16_t dq[64], ws[64];
  for (int k = 0; k < 64; ++k) dq[k] = wrap16(int32_t(in[k]) * int32_t(q[k]));
  bool ac_zero = true;
  for (int k = 8; k < 64 && ac_zero; ++k) ac_zero = in[k] == 0;
  if (ac_zero) {
    for (int c = 0; c < 8; ++c) {
      const int16_t v = wrap16(int32_t(uint32_t(int32_t(dq[c])) << 2));
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = v;
    }
  } else {
    int32_t o[8];
    for (int c = 0; c < 8; ++c) {
      const int16_t* d = dq + c;
      if (!d[8] && !d[16] && !d[24] && !d[32] && !d[40] && !d[48] && !d[56]) {
        const int16_t v = sat16(int32_t(d[0]) * 4);
        for (int r = 0; r < 8; ++r) ws[r * 8 + c] = v;
        continue;
      }
      pass(d, 8, o);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = sat16(add(o[r], 1 << 10) >> 11);
    }
  }
  int32_t o[8];
  for (int r = 0; r < 8; ++r) {
    const int16_t* w = ws + r * 8;
    uint8_t* op = out + size_t(r) * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      const int v = (int32_t(w[0]) + 16) >> 5;
      memset(op, (v < -128 ? -128 : (v > 127 ? 127 : v)) + 128, 8);
      continue;
    }
    pass(w, 1, o);
    for (int k = 0; k < 8; ++k) {
      const int v = sat16(add(o[k], 1 << 17) >> 18);
      op[k] = uint8_t((v < -128 ? -128 : (v > 127 ? 127 : v)) + 128);
    }
  }
}

// One component's samples at full size (width x height): its plane
// (bw*8 x bh*8) upsampled as libjpeg's jdsample.c does with fancy
// upsampling: h2v1, h1v2 and h2v2 triangle filters, context rows
// replicated at the top and below the last real row; libjpeg-turbo
// replicates samples instead where the component is at most 2 samples wide
// under horizontal upsampling.
void upsample(const Component& c, const std::vector<uint8_t>& plane, int hr, int vr,
              int width, int height, uint8_t* out) {
  const int pw = c.bw * 8;
  const int dw = c.dw;
  auto row = [&](int r) {  // a context row, replicated past the real rows
    if (r < 0) r = 0;
    if (r > c.dh - 1) r = c.dh - 1;
    return plane.data() + size_t(r) * pw;
  };
  std::vector<uint8_t> tmp(size_t(2) * dw + 2);
  for (int y = 0; y < height; ++y) {
    uint8_t* o = out + size_t(y) * width;
    const int in_r = y / vr;
    if (hr == 1 && vr == 1) {
      memcpy(o, plane.data() + size_t(y) * pw, width);
    } else if (hr == 2 && dw <= 2) {
      const uint8_t* ip = plane.data() + size_t(in_r) * pw;
      for (int x = 0; x < width; ++x) o[x] = ip[x >> 1];
    } else if (hr == 2 && vr == 1) {
      const uint8_t* ip = plane.data() + size_t(in_r) * pw;
      uint8_t* t = tmp.data();
      int inv = ip[0];
      t[0] = uint8_t(inv);
      t[1] = uint8_t((inv * 3 + ip[1] + 2) >> 2);
      for (int col = 1; col < dw - 1; ++col) {
        inv = ip[col] * 3;
        t[2 * col] = uint8_t((inv + ip[col - 1] + 1) >> 2);
        t[2 * col + 1] = uint8_t((inv + ip[col + 1] + 2) >> 2);
      }
      if (dw > 1) {
        inv = ip[dw - 1];
        t[2 * dw - 2] = uint8_t((inv * 3 + ip[dw - 2] + 1) >> 2);
        t[2 * dw - 1] = uint8_t(inv);
      }
      memcpy(o, t, width);
    } else if (hr == 1 && vr == 2) {
      const int v = y & 1;
      const uint8_t* i0 = row(in_r);
      const uint8_t* i1 = row(v == 0 ? in_r - 1 : in_r + 1);
      const int bias = v == 0 ? 1 : 2;
      for (int x = 0; x < width; ++x) o[x] = uint8_t((i0[x] * 3 + i1[x] + bias) >> 2);
    } else {  // h2v2
      const int v = y & 1;
      const uint8_t* i0 = row(in_r);
      const uint8_t* i1 = row(v == 0 ? in_r - 1 : in_r + 1);
      uint8_t* t = tmp.data();
      int thiscol = i0[0] * 3 + i1[0];
      int nextcol = i0[1] * 3 + i1[1];
      t[0] = uint8_t((thiscol * 4 + 8) >> 4);
      t[1] = uint8_t((thiscol * 3 + nextcol + 7) >> 4);
      int lastcol = thiscol;
      thiscol = nextcol;
      for (int col = 1; col < dw - 1; ++col) {
        nextcol = i0[col + 1] * 3 + i1[col + 1];
        t[2 * col] = uint8_t((thiscol * 3 + lastcol + 8) >> 4);
        t[2 * col + 1] = uint8_t((thiscol * 3 + nextcol + 7) >> 4);
        lastcol = thiscol;
        thiscol = nextcol;
      }
      if (dw > 1) {
        t[2 * dw - 2] = uint8_t((thiscol * 3 + lastcol + 8) >> 4);
        t[2 * dw - 1] = uint8_t((thiscol * 4 + 7) >> 4);
      }
      memcpy(o, t, width);
    }
  }
}

// jdcolor.c's fixed-point YCbCr->RGB tables (SCALEBITS 16, x = i - 128)
// and RGB->Y tables (rgb_gray_convert's, the half added to blue's)
struct ColourTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  int64_t r_y[256], g_y[256], b_y[256];
  ColourTables() {
    constexpr int SB = 16;
    constexpr int64_t HALF = int64_t(1) << (SB - 1);
    auto fix = [](double x) { return int64_t(x * (1 << SB) + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + HALF) >> SB);
      cb_b[i] = int((fix(1.77200) * x + HALF) >> SB);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + HALF;
      r_y[i] = fix(0.29900) * i;
      g_y[i] = fix(0.58700) * i;
      b_y[i] = fix(0.11400) * i + HALF;
    }
  }
};

inline uint8_t clamp255(int x) { return uint8_t(x < 0 ? 0 : (x > 255 ? 255 : x)); }

// Block smoothing, after libjpeg-turbo's decompress_smooth_data
// (jdcoefct.c, 2.1 and later).  A coefficient among the first nine AC
// positions that is still zero and short of bits is predicted from the DC
// values of the 5x5 blocks around its block on the component's grid; while
// no AC scan has arrived, the DC is predicted too, and the higher-order
// terms of the 5x5 fit are used.  Each weight row below is that fit's
// numerator over DC01..DC25 (row-major, the block at DC13).
struct SmoothTerm {
  int zz;       // zigzag index: coef_bits[zz] says how many low bits are missing
  int pos;      // natural position
  int ac[25];   // weights while some AC coefficient is known
  int dc[25];   // weights while only the DC is (change_dc)
};

const SmoothTerm kSmoothTerms[9] = {
    {1, 1,  // AC01
     {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -7, 50, 0, -50, 7, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
     {-1, -1, 0, 1, 1, -3, 13, 0, -13, 3, -3, 38, 0, -38, 3, -3, 13, 0, -13, 3, -1, -1, 0, 1, 1}},
    {2, 8,  // AC10
     {0, 0, -7, 0, 0, 0, 0, 50, 0, 0, 0, 0, 0, 0, 0, 0, 0, -50, 0, 0, 0, 0, 7, 0, 0},
     {-1, -3, -3, -3, -1, -1, 13, 38, 13, -1, 0, 0, 0, 0, 0, 1, -13, -38, -13, 1, 1, 3, 3, 3, 1}},
    {3, 16,  // AC20
     {0, 0, -1, 0, 0, 0, 0, 13, 0, 0, 0, 0, -24, 0, 0, 0, 0, 13, 0, 0, 0, 0, -1, 0, 0},
     {0, 0, 1, 0, 0, 0, 2, 7, 2, 0, 0, -5, -14, -5, 0, 0, 2, 7, 2, 0, 0, 0, 1, 0, 0}},
    {4, 9,  // AC11
     {0, -1, 0, 1, 0, -1, 10, 0, -10, 1, 0, 0, 0, 0, 0, 1, -10, 0, 10, -1, 0, 1, 0, -1, 0},
     {-1, 0, 0, 0, 1, 0, 9, 0, -9, 0, 0, 0, 0, 0, 0, 0, -9, 0, 9, 0, 1, 0, 0, 0, -1}},
    {5, 2,  // AC02
     {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -1, 13, -24, 13, -1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
     {0, 0, 0, 0, 0, 0, 2, -5, 2, 0, 1, 7, -14, 7, 1, 0, 2, -5, 2, 0, 0, 0, 0, 0, 0}},
    {6, 3,  // AC03: only while change_dc
     {},
     {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, 2, 0, -2, 0, 0, 1, 0, -1, 0, 0, 0, 0, 0, 0}},
    {7, 10,  // AC12
     {},
     {0, 0, 0, 0, 0, 0, 1, -3, 1, 0, 0, 0, 0, 0, 0, 0, -1, 3, -1, 0, 0, 0, 0, 0, 0}},
    {8, 17,  // AC21
     {},
     {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, -3, 0, 3, 0, 0, 1, 0, -1, 0, 0, 0, 0, 0, 0}},
    {9, 24,  // AC30
     {},
     {0, 0, 0, 0, 0, 0, 1, 2, 1, 0, 0, 0, 0, 0, 0, 0, -1, -2, -1, 0, 0, 0, 0, 0, 0}},
};

const int kSmoothDC[25] = {-2, -6, -8,  -6, -2, -6, 6,  42,  6,  -6, -8, 42, 152,
                           42, -8, -6, 6,   42, 6,  -6, -2, -6, -8, -6, -2};

// libjpeg-turbo's rounding of a prediction: num / (q * 256) to the
// nearest, ties away from zero, by magnitude; clipped below 1 << al where
// the coefficient's top bits are known (al > 0)
inline int smooth_pred(int64_t num, int64_t q, int al, bool clip) {
  int pred = int(((q << 7) + (num < 0 ? -num : num)) / (q << 8));
  if (clip && al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  return num < 0 ? -pred : pred;
}

// A block row that smoothing outputs, and the block rows libjpeg reads as
// its 5x5 neighbours' (two above, itself, two below).
struct SmoothRow {
  int row;
  int around[5];
};

// The block rows of a component that smoothing outputs, as libjpeg walks
// them: iMCU rows of vd block rows, the edge rows repeated at the top and
// bottom of the image.  libjpeg counts the image's block rows as (block
// rows in this iMCU row) x (iMCU rows), which at the last iMCU row of a
// component with vd = 2 and an odd number of block rows is not the true
// count; the neighbours it then takes are kept as it takes them.
std::vector<SmoothRow> smooth_rows(const Decoder& dec, const Component& c) {
  int vmax = 1;
  for (int i = 0; i < dec.ncomp; ++i) vmax = std::max(vmax, dec.comp[i].vd);
  const int imcu_rows = (dec.height + 8 * vmax - 1) / (8 * vmax);
  const int hb = (c.dh + 7) / 8;  // height_in_blocks
  std::vector<SmoothRow> rows;
  for (int r = 0; r < imcu_rows; ++r) {
    int block_rows = c.vd;
    if (r == imcu_rows - 1 && hb % c.vd) block_rows = hb % c.vd;
    const int image_block_rows = block_rows * imcu_rows;
    for (int br = 0; br < block_rows; ++br) {
      const int ibr = r * block_rows + br, row = r * c.vd + br;
      const int prev = ibr > 0 ? row - 1 : row;
      const int pprev = ibr > 1 ? row - 2 : prev;
      const int next = ibr < image_block_rows - 1 ? row + 1 : row;
      const int nnext = ibr < image_block_rows - 2 ? row + 2 : next;
      rows.push_back({row, {pprev, prev, row, next, nnext}});
    }
  }
  return rows;
}

// One block's coefficients after smoothing, into ws (64, natural order).
// bits holds the coefficients' Al as smoothing takes them, dc the 25 DC
// values around the block.
void smooth_block(const Component& c, const int* bits, const int16_t* blk, const int* dc,
                  bool change_dc, int16_t* ws) {
  memcpy(ws, blk, 64 * sizeof(int16_t));
  const int64_t q00 = c.qt[0];
  for (const SmoothTerm& t : kSmoothTerms) {
    if (t.zz > 5 && !change_dc) break;  // AC03 to AC30 only while change_dc
    const int al = bits[t.zz];
    if (al == 0 || ws[t.pos] != 0) continue;
    const int* w = change_dc ? t.dc : t.ac;
    int64_t sum = 0;
    for (int k = 0; k < 25; ++k) sum += int64_t(w[k]) * dc[k];
    ws[t.pos] = int16_t(smooth_pred(q00 * sum, c.qt[t.pos], al, true));
  }
  if (change_dc) {
    int64_t sum = 0;
    for (int k = 0; k < 25; ++k) sum += int64_t(kSmoothDC[k]) * dc[k];
    ws[0] = int16_t(smooth_pred(q00 * sum, q00, 0, false));
  }
}

// One component's IDCT into its plane (bw*8 x bh*8 samples), its blocks
// smoothed where libjpeg-turbo smooths them.  Smoothing covers the blocks
// of the image (width_in_blocks x height_in_blocks), which are all the
// output reads.
void idct_component(const Decoder& dec, const Component& c, bool smooth, uint8_t* plane) {
  const int pw = c.bw * 8;
  auto out = [&](int by, int bx) { return plane + size_t(by) * 8 * pw + size_t(bx) * 8; };
  auto block = [&](int by, int bx) { return c.coef.data() + (size_t(by) * c.bw + bx) * 64; };
  if (!smooth) {
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx) idct_islow(block(by, bx), c.qt, out(by, bx), pw);
    return;
  }
  // the rows after the last good one take the bits before the last scan
  int prev[kSavedCoefs];
  for (int k = 0; k < kSavedCoefs; ++k) prev[k] = dec.scans > 1 ? c.prev_bits[k] : -1;
  auto no_ac = [](const int* bits) {  // DC interpolation while no AC has bits
    for (int k = 1; k < kSavedCoefs; ++k)
      if (bits[k] != -1) return false;
    return true;
  };
  const int wb = (c.dw + 7) / 8;  // width_in_blocks
  // a DC past the rows decoded (a padding row of a declared factor the
  // decoder folds away) was never coded: libjpeg's buffer holds zero there
  auto dc_at = [&](int by, int bx) -> int {
    bx = std::min(std::max(bx, 0), wb - 1);
    return by < c.bh ? block(by, bx)[0] : 0;
  };
  int16_t ws[64];
  int dc[25];
  for (const SmoothRow& sr : smooth_rows(dec, c)) {
    const int* bits = sr.row / c.vd > dec.last_good_row ? prev : c.coef_bits;
    const bool change_dc = no_ac(bits);
    for (int bx = 0; bx < wb; ++bx) {
      for (int r = 0; r < 5; ++r)
        for (int k = 0; k < 5; ++k) dc[r * 5 + k] = dc_at(sr.around[r], bx + k - 2);
      smooth_block(c, bits, block(sr.row, bx), dc, change_dc, ws);
      idct_islow(ws, c.qt, out(sr.row, bx), pw);
    }
  }
}

// The lossless reads cv2 makes: libjpeg-turbo converts no colour in lossless
// mode (jdcolor.c), so a gray read needs one component, a colour read RGB
// (three components; JFIF's marker or an Adobe transform other than 0 makes
// them YCbCr) or CMYK (four; Adobe's transform other than 0 makes them
// YCCK), and OpenCV turns CMYK into BGR or gray itself.
void lossless_colour_space(const Decoder& dec, bool gray) {
  const int nc = dec.ncomp;
  if (nc == 1 && !gray)
    throw Refused(std::string("a colour read of a one-component lossless JPEG") + kCv2Refuses);
  if (nc == 3 && !dec.is_rgb())
    throw Refused(std::string("lossless JPEG of YCbCr components") + kCv2Refuses);
  if (nc == 3 && gray)
    throw Refused(std::string("a gray read of a three-component lossless JPEG") + kCv2Refuses);
  if (nc == 4 && dec.is_ycck())
    throw Refused(std::string("lossless JPEG of YCCK components") + kCv2Refuses);
}

// The image as cv2.imdecode returns it: (H, W, 3) RGB for IMREAD_COLOR
// (in RGB order), (H, W) for IMREAD_GRAYSCALE.  libjpeg's output colour
// space is cv2's choice: gray for a gray read of 1 or 3 components (the Y
// plane of YCbCr, rgb_gray_convert of RGB), RGB for a colour read, and
// CMYK for 4 components either way (YCCK converted to CMYK), which OpenCV
// then turns into BGR or gray itself (icvCvt_CMYK2BGR_8u_C4C3R,
// icvCvt_CMYK2Gray_8u_C4C1R).
void to_output(Decoder& dec, bool gray, uint8_t* out) {
  const int W = dec.width, H = dec.height;
  const size_t npix = size_t(W) * H;
  const bool smooth = dec.smoothing_ok();
  // a gray read of YCbCr needs the Y component alone (component_needed)
  const bool y_only = gray && dec.ncomp == 3 && !dec.is_rgb();
  const int used = dec.ncomp == 1 || y_only ? 1 : dec.ncomp;
  if (dec.lossless) lossless_colour_space(dec, gray);
  std::vector<std::vector<uint8_t>> full(used);
  for (int i = 0; i < used; ++i) {
    Component& c = dec.comp[i];
    full[i].resize(npix);
    // lossless: no IDCT, and the samples replicated (libjpeg's min_DCT_scaled_size
    // of 1 turns fancy upsampling off)
    if (dec.lossless) {
      const int hr = dec.hmax / c.h, vr = dec.vmax / c.v;
      for (int y = 0; y < H; ++y) {
        const uint8_t* ip = c.out8.data() + size_t(y / vr) * c.bw;
        uint8_t* o = full[i].data() + size_t(y) * W;
        for (int x = 0; x < W; ++x) o[x] = ip[x / hr];
      }
      continue;
    }
    std::vector<uint8_t> plane(size_t(c.bw) * 8 * c.bh * 8);
    idct_component(dec, c, smooth, plane.data());
    upsample(c, plane, dec.hmax / c.h, dec.vmax / c.v, W, H, full[i].data());
  }
  static const ColourTables t;
  if (used == 1) {
    const uint8_t* Y = full[0].data();
    if (gray) {
      memcpy(out, Y, npix);
    } else {
      for (size_t p = 0; p < npix; ++p) out[3 * p] = out[3 * p + 1] = out[3 * p + 2] = Y[p];
    }
    return;
  }
  const uint8_t *c0 = full[0].data(), *c1 = full[1].data(), *c2 = full[2].data();
  if (dec.ncomp == 3 && dec.is_rgb()) {
    for (size_t p = 0; p < npix; ++p) {
      if (gray)
        out[p] = uint8_t((t.r_y[c0[p]] + t.g_y[c1[p]] + t.b_y[c2[p]]) >> 16);
      else
        for (int k = 0; k < 3; ++k) out[3 * p + k] = full[k][p];
    }
    return;
  }
  if (dec.ncomp == 3) {
    for (size_t p = 0; p < npix; ++p) {
      int y = c0[p], cb = c1[p], cr = c2[p];
      out[3 * p] = clamp255(y + t.cr_r[cr]);
      out[3 * p + 1] = clamp255(y + int((t.cb_g[cb] + t.cr_g[cr]) >> 16));
      out[3 * p + 2] = clamp255(y + t.cb_b[cb]);
    }
    return;
  }
  const uint8_t* c3 = full[3].data();
  const bool ycck = dec.is_ycck();
  for (size_t p = 0; p < npix; ++p) {
    int C = c0[p], M = c1[p], Y = c2[p];
    const int K = c3[p];
    if (ycck) {  // jdcolor.c ycck_cmyk_convert: 255 - the YCbCr->RGB of the first three
      const int y = C, cb = M, cr = Y;
      C = clamp255(255 - (y + t.cr_r[cr]));
      M = clamp255(255 - (y + int((t.cb_g[cb] + t.cr_g[cr]) >> 16)));
      Y = clamp255(255 - (y + t.cb_b[cb]));
    }
    // OpenCV's CMYK (Adobe's, stored inverted) to RGB
    const int r = K - (((255 - C) * K) >> 8);
    const int g = K - (((255 - M) * K) >> 8);
    const int b = K - (((255 - Y) * K) >> 8);
    if (gray) {  // OpenCV's descale(b*cB + g*cG + r*cR, 14) with cR 4899, cG 9617, cB 1868
      out[p] = uint8_t((b * 1868 + g * 9617 + r * 4899 + (1 << 13)) >> 14);
    } else {
      out[3 * p] = uint8_t(r);
      out[3 * p + 1] = uint8_t(g);
      out[3 * p + 2] = uint8_t(b);
    }
  }
}

void set_error(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) snprintf(err, size_t(errlen), "%s", msg);
}

}  // namespace

extern "C" {

// 0: ok; 1: corrupt or truncated; 2: a coding not decoded here; 3: out of
// memory; 4: a stream cv2.imdecode returns nothing for.
// info[0..3] = width, height, components, EXIF orientation (1..8).
int jpeg_info(const uint8_t* data, int64_t size, int* info, char* err, int errlen) {
  try {
    Decoder dec(data, size_t(size));
    dec.parse(false);
    info[0] = dec.width;
    info[1] = dec.height;
    info[2] = dec.ncomp;
    info[3] = dec.orientation;
    return 0;
  } catch (const Unsupported& e) {
    set_error(err, errlen, e.what());
    return 2;
  } catch (const Refused& e) {
    set_error(err, errlen, e.what());
    return 4;
  } catch (const Corrupt& e) {
    set_error(err, errlen, e.what());
    return 1;
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
    return 3;
  }
}

// Decode into out, height x width x 3 RGB or, with gray, height x width,
// whose size the caller took from jpeg_info; a stream whose frame
// disagrees with it is refused.
int jpeg_decode(const uint8_t* data, int64_t size, int width, int height, int gray,
                uint8_t* out, char* err, int errlen) {
  try {
    Decoder probe(data, size_t(size));
    probe.parse(false);
    if (probe.width != width || probe.height != height)
      throw Corrupt("JPEG size differs from the buffer's");
    Decoder dec(data, size_t(size));
    dec.allocate = true;
    dec.parse(true);
    to_output(dec, gray != 0, out);
    return 0;
  } catch (const Unsupported& e) {
    set_error(err, errlen, e.what());
    return 2;
  } catch (const Refused& e) {
    set_error(err, errlen, e.what());
    return 4;
  } catch (const Corrupt& e) {
    set_error(err, errlen, e.what());
    return 1;
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
    return 3;
  }
}

}  // extern "C"
