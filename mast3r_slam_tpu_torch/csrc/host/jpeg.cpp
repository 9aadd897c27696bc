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
// Decoded: sequential (SOF0, SOF1) and progressive (SOF2) Huffman coding at
// 8 bits, 1, 3 or 4 components, sampling factors up to 2x2 at integral
// ratios (4:4:4, 4:2:2, 4:4:0, 4:2:0), interleaved and single-component
// scans, restart intervals, any width and height.  A progressive stream's
// scans (DC first and refinement, AC first and refinement with the
// end-of-band run) accumulate into the same coefficient buffers that the
// sequential scans fill, and both end in the same output stage.  A
// progressive stream whose scans stop early is smoothed as libjpeg-turbo
// smooths it (smooth_block).  The arithmetic follows libjpeg (the decoder
// behind cv2.imdecode) where it chooses: the ISLOW integer IDCT with its
// range limit, "fancy" triangle upsampling of the chroma with its rounding
// biases and edge replication, the fixed-point YCbCr->RGB, RGB->gray and
// YCCK->CMYK tables, and OpenCV's own CMYK->BGR and CMYK->gray, so the
// pixels equal cv2's.  Lossless, hierarchical and arithmetic coding and
// 12-bit samples are refused (return 2); truncated or corrupt streams
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

const char* const kOtherCodings = " is not decoded (ROADMAP Queue 1, item 13c)";

// libjpeg-turbo's SAVED_COEFS (jdcoefct.c, 10 since 2.1): block smoothing
// reads the DC and the first nine AC coefficients of each block
constexpr int kSavedCoefs = 10;

// zigzag position -> natural (row-major) position
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

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
  void check() const {
    if (real_left() < 0) throw Corrupt("truncated JPEG: the entropy-coded data ends early");
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
    throw Corrupt("bad Huffman code");
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int vd = 1;             // the vertical factor as declared (smoothing's block rows an iMCU row)
  int td = 0, ta = 0;     // Huffman tables of the current scan
  int bw = 0, bh = 0;     // blocks a row and column, MCU-padded
  int dw = 0, dh = 0;     // downsampled width and height (real samples)
  std::vector<int16_t> coef;  // bh * bw blocks of 64, natural order
  int64_t pred = 0;
  bool scanned = false;
  bool latched = false;   // the quantisation table, copied at the first scan as libjpeg does
  uint16_t qt[64] = {};   // natural order
  int coef_bits[64];      // progressive: the Al of each coefficient's last scan, -1 before
  Component() { std::fill(coef_bits, coef_bits + 64, -1); }
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
  int adobe_transform = -1;
  int orientation = 1;
  uint16_t quant[4][64] = {};
  bool quant_defined[4] = {};
  Huffman dc[4], ac[4];
  Component comp[4];
  bool allocate = false;

  Decoder(const uint8_t* data, size_t size) : d(data), n(size) {}

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
    while (u8() != 0xFF) {
    }
    int m;
    do m = u8(); while (m == 0xFF);
    return m;
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
    progressive = m == 0xC2;
    size_t len = size_t(u16());
    size_t end = pos + len - 2;
    if (len < 8 || end > n) throw Corrupt("bad JPEG frame header");
    int precision = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    if (precision != 8)
      throw Unsupported("JPEG of " + std::to_string(precision) + "-bit samples" + kOtherCodings);
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
      if (c.h > 2 || c.v > 2)
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
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = int((int64_t(width) * c.h + hmax - 1) / hmax);
      c.dh = int((int64_t(height) * c.v + vmax - 1) / vmax);
      if (allocate) c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
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
        if (k > 63) throw Corrupt("bad JPEG AC run");
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
        if (k > se) throw Corrupt("bad JPEG AC run");
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
        if (s) {
          if (k > se) throw Corrupt("bad JPEG AC refinement run");
          blk[kNatural[k]] = int16_t(s);
        }
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
      if (c->td > 3 || c->ta > 3) throw Corrupt("bad JPEG scan component");
      sc[i] = c;
    }
    if (ns > 1) {  // libjpeg's D_MAX_BLOCKS_IN_MCU
      int blocks = 0;
      for (int i = 0; i < ns; ++i) blocks += sc[i]->h * sc[i]->v;
      if (blocks > 10) throw Corrupt("JPEG MCU of more than 10 blocks");
    }
    const int ss = u8(), se = u8(), a = u8();
    const int ah = a >> 4, al = a & 15;
    enum Kind { SEQUENTIAL, DC_FIRST, DC_REFINE, AC_FIRST, AC_REFINE } kind = SEQUENTIAL;
    if (!progressive) {
      if (ss != 0 || se != 63 || a != 0) throw Corrupt("bad JPEG sequential scan parameters");
    } else {
      // libjpeg's checks (jdphuff.c start_pass_phuff_decoder): a DC band alone,
      // an AC band of one component, a refinement one bit below the last
      bool bad = ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1);
      if ((ah != 0 && al != ah - 1) || al > 13) bad = true;
      if (bad) throw Corrupt("bad JPEG progressive scan parameters");
      kind = ss == 0 ? (ah ? DC_REFINE : DC_FIRST) : (ah ? AC_REFINE : AC_FIRST);
    }
    for (int i = 0; i < ns; ++i) {
      Component* c = sc[i];
      bool need_dc = kind == SEQUENTIAL || kind == DC_FIRST;
      bool need_ac = kind == SEQUENTIAL || kind == AC_FIRST || kind == AC_REFINE;
      if ((need_dc && !dc[c->td].defined) || (need_ac && !ac[c->ta].defined))
        throw Corrupt("JPEG scan uses an undefined Huffman table");
      if (!c->latched) {
        if (!quant_defined[c->tq])
          throw Corrupt("JPEG component uses an undefined quantisation table");
        memcpy(c->qt, quant[c->tq], sizeof(c->qt));
        c->latched = true;
      }
      // the progression's state (libjpeg warns of an out-of-order one and goes on)
      if (progressive)
        for (int k = ss; k <= se; ++k) c->coef_bits[k] = al;
      c->pred = 0;
    }
    int eobrun = 0;
    BitReader br(d, n, pos);
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
    for (int64_t u = 0; u < units; ++u) {
      if (restart && u > 0 && u % restart == 0) {
        br.check();
        br.to_marker();
        if (br.pos + 1 >= n || d[br.pos] != 0xFF) throw Corrupt("JPEG restart marker missing");
        size_t p = br.pos + 1;
        while (p < n && d[p] == 0xFF) ++p;
        if (p >= n || d[p] != 0xD0 + next_rst) throw Corrupt("JPEG restart marker missing");
        br = BitReader(d, n, p + 1);
        next_rst = (next_rst + 1) & 7;
        for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
        eobrun = 0;
      }
      auto block = [&](Component& c, int16_t* blk) {
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
    }
    br.check();
    br.to_marker();
    pos = br.pos;
    for (int i = 0; i < ns; ++i) sc[i]->scanned = true;
    any_scan = true;
  }

  // markers up to and including the frame header (info), or to EOI
  void parse(bool full) {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) throw Corrupt("not a JPEG stream (no SOI)");
    pos = 2;
    while (true) {
      if (full && pos >= n && all_scanned()) return;  // the EOI alone is missing
      int m = marker();
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        read_frame(m);
        if (!full) return;
      } else if (m == 0xC5 || m == 0xC6 || m == 0xC7 || m == 0xCD || m == 0xCE || m == 0xCF) {
        throw Unsupported(std::string("hierarchical JPEG (SOF") + std::to_string(m - 0xC0) +
                          ")" + kOtherCodings);
      } else if (m == 0xC3 || m == 0xCB) {
        throw Unsupported(std::string("lossless JPEG (SOF") + std::to_string(m - 0xC0) + ")" +
                          kOtherCodings);
      } else if (m == 0xC9 || m == 0xCA || m == 0xCC) {
        throw Unsupported(std::string("arithmetic-coded JPEG (") +
                          (m == 0xCC ? std::string("DAC") : "SOF" + std::to_string(m - 0xC0)) +
                          ")" + kOtherCodings);
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
    // libjpeg's guess of the colour space of 3 components
    if (jfif) return false;
    if (adobe) return adobe_transform == 0;
    return comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
  }

  // libjpeg's guess for 4 components: an Adobe transform other than 0
  // means YCCK, anything else CMYK
  bool is_ycck() const { return adobe && adobe_transform != 0; }
};

// libjpeg's post-IDCT range limit: the descaled value plus 128, clamped,
// indexed modulo 1024 (a corrupt block wraps rather than reads outside)
inline uint8_t idct_limit(int32_t x) {
  int v = x & 1023;
  if (v < 128) return uint8_t(v + 128);
  if (v < 512) return 255;
  if (v < 896) return 0;
  return uint8_t(v - 896);
}

// jpeg_idct_islow of libjpeg's jidctint.c (CONST_BITS 13, PASS1_BITS 2)
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  constexpr int CB = 13, P1 = 2;
  constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                    F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069,
                    F2053 = 16819, F2562 = 20995, F3072 = 25172;
  auto descale = [](int64_t x, int n) { return int32_t((x + (int64_t(1) << (n - 1))) >> n); };
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int32_t dcval = int64_t(ip[0]) * qp[0] * (1 << P1);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dcval;
      continue;
    }
    int64_t z2 = int64_t(ip[16]) * qp[16], z3 = int64_t(ip[48]) * qp[48];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
    z2 = int64_t(ip[0]) * qp[0];
    z3 = int64_t(ip[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << CB), tmp1 = (z2 - z3) * (int64_t(1) << CB);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int64_t(ip[56]) * qp[56];
    tmp1 = int64_t(ip[40]) * qp[40];
    tmp2 = int64_t(ip[24]) * qp[24];
    tmp3 = int64_t(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    ws[0 * 8 + c] = descale(tmp10 + tmp3, CB - P1);
    ws[7 * 8 + c] = descale(tmp10 - tmp3, CB - P1);
    ws[1 * 8 + c] = descale(tmp11 + tmp2, CB - P1);
    ws[6 * 8 + c] = descale(tmp11 - tmp2, CB - P1);
    ws[2 * 8 + c] = descale(tmp12 + tmp1, CB - P1);
    ws[5 * 8 + c] = descale(tmp12 - tmp1, CB - P1);
    ws[3 * 8 + c] = descale(tmp13 + tmp0, CB - P1);
    ws[4 * 8 + c] = descale(tmp13 - tmp0, CB - P1);
  }
  for (int r = 0; r < 8; ++r) {
    const int32_t* w = ws + r * 8;
    uint8_t* op = out + size_t(r) * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = idct_limit(descale(w[0], P1 + 3));
      for (int k = 0; k < 8; ++k) op[k] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
    int64_t tmp0 = (w[0] + w[4]) * (int64_t(1) << CB), tmp1 = (w[0] - w[4]) * (int64_t(1) << CB);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int S = CB + P1 + 3;
    op[0] = idct_limit(descale(tmp10 + tmp3, S));
    op[7] = idct_limit(descale(tmp10 - tmp3, S));
    op[1] = idct_limit(descale(tmp11 + tmp2, S));
    op[6] = idct_limit(descale(tmp11 - tmp2, S));
    op[2] = idct_limit(descale(tmp12 + tmp1, S));
    op[5] = idct_limit(descale(tmp12 - tmp1, S));
    op[3] = idct_limit(descale(tmp13 + tmp0, S));
    op[4] = idct_limit(descale(tmp13 - tmp0, S));
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
// dc holds the 25 DC values around the block.
void smooth_block(const Component& c, const int16_t* blk, const int* dc, bool change_dc,
                  int16_t* ws) {
  memcpy(ws, blk, 64 * sizeof(int16_t));
  const int64_t q00 = c.qt[0];
  for (const SmoothTerm& t : kSmoothTerms) {
    if (t.zz > 5 && !change_dc) break;  // AC03 to AC30 only while change_dc
    const int al = c.coef_bits[t.zz];
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
  bool change_dc = true;
  for (int k = 1; k < kSavedCoefs; ++k)
    if (c.coef_bits[k] != -1) change_dc = false;
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
    for (int bx = 0; bx < wb; ++bx) {
      for (int r = 0; r < 5; ++r)
        for (int k = 0; k < 5; ++k) dc[r * 5 + k] = dc_at(sr.around[r], bx + k - 2);
      smooth_block(c, block(sr.row, bx), dc, change_dc, ws);
      idct_islow(ws, c.qt, out(sr.row, bx), pw);
    }
  }
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
  std::vector<std::vector<uint8_t>> full(used);
  for (int i = 0; i < used; ++i) {
    Component& c = dec.comp[i];
    std::vector<uint8_t> plane(size_t(c.bw) * 8 * c.bh * 8);
    idct_component(dec, c, smooth, plane.data());
    full[i].resize(npix);
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

// 0: ok; 1: corrupt or truncated; 2: a coding this decoder refuses.
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
  } catch (const Corrupt& e) {
    set_error(err, errlen, e.what());
    return 1;
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
    return 3;
  }
}

}  // extern "C"
