// The simple IDCT of libavcodec as it runs on x86-64 without the
// bit-exact flag, which cv2 does not set: simple_idct_template.c's
// arithmetic (8 bits) as its SSE2 version computes it, on coefficients in
// natural order (libavcodec's FF_IDCT_PERM_TRANSPOSE scan, undone).  A row
// with AC terms saturates its outputs to 16 bits where the C code wraps
// them, and the column pass adds its rounding bias to the first input in
// 16 bits, wrapping.  Both only matter for coefficients far beyond what
// 8-bit pictures give; the random streams of tests/torch_video_files.py
// and tests/torch_mjpeg_files.py reach them.  Shared by the host library's
// MPEG-4 Part 2 (mpeg4.cpp) and Motion-JPEG (mjpeg.cpp) decoders: both
// reach libavcodec's idct_put through the same IDCTDSPContext.
#pragma once

#include <algorithm>
#include <cstdint>

#include "yuv420.h"

namespace host {

inline constexpr int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873, W6 = 8867,
                     W7 = 4520;
inline constexpr int ROW_SHIFT = 11, COL_SHIFT = 20, DC_SHIFT = 3;

inline void idct_row(int16_t* row) {
    bool ac = false;
    for (int k = 1; k < 8; k++) ac |= row[k] != 0;
    if (!ac) {
        int16_t v = int16_t(uint16_t(row[0] * (1 << DC_SHIFT)));
        for (int k = 0; k < 8; k++) row[k] = v;
        return;
    }
    uint32_t a0 = uint32_t(W4) * uint32_t(int(row[0])) + (1u << (ROW_SHIFT - 1));
    uint32_t a1 = a0, a2 = a0, a3 = a0;
    a0 += uint32_t(W2) * uint32_t(int(row[2]));
    a1 += uint32_t(W6) * uint32_t(int(row[2]));
    a2 -= uint32_t(W6) * uint32_t(int(row[2]));
    a3 -= uint32_t(W2) * uint32_t(int(row[2]));
    auto mul = [](int w, int16_t x) { return uint32_t(w) * uint32_t(int(x)); };
    uint32_t b0 = mul(W1, row[1]) + mul(W3, row[3]);
    uint32_t b1 = mul(W3, row[1]) + mul(-W7, row[3]);
    uint32_t b2 = mul(W5, row[1]) + mul(-W1, row[3]);
    uint32_t b3 = mul(W7, row[1]) + mul(-W5, row[3]);
    if (row[4] | row[5] | row[6] | row[7]) {
        a0 += mul(W4, row[4]) + mul(W6, row[6]);
        a1 += -mul(W4, row[4]) - mul(W2, row[6]);
        a2 += -mul(W4, row[4]) + mul(W2, row[6]);
        a3 += mul(W4, row[4]) - mul(W6, row[6]);
        b0 += mul(W5, row[5]) + mul(W7, row[7]);
        b1 += mul(-W1, row[5]) + mul(-W5, row[7]);
        b2 += mul(W7, row[5]) + mul(W3, row[7]);
        b3 += mul(W3, row[5]) + mul(-W1, row[7]);
    }
    auto out = [](uint32_t v) {
        return int16_t(std::min(std::max(int(v) >> ROW_SHIFT, -32768), 32767));
    };
    row[0] = out(a0 + b0);
    row[7] = out(a0 - b0);
    row[1] = out(a1 + b1);
    row[6] = out(a1 - b1);
    row[2] = out(a2 + b2);
    row[5] = out(a2 - b2);
    row[3] = out(a3 + b3);
    row[4] = out(a3 - b3);
}

// The column pass into 8 values a column: out[r] = (a +/- b) >> COL_SHIFT.
inline void idct_col(const int16_t* col, int out[8]) {
    auto mul = [](int w, int16_t x) { return uint32_t(w) * uint32_t(int(x)); };
    int16_t c0 = int16_t(uint16_t(col[0] + ((1 << (COL_SHIFT - 1)) / W4)));
    uint32_t a0 = uint32_t(W4) * uint32_t(int(c0));
    uint32_t a1 = a0, a2 = a0, a3 = a0;
    a0 += mul(W2, col[16]);
    a1 += mul(W6, col[16]);
    a2 += mul(-W6, col[16]);
    a3 += mul(-W2, col[16]);
    uint32_t b0 = mul(W1, col[8]) + mul(W3, col[24]);
    uint32_t b1 = mul(W3, col[8]) + mul(-W7, col[24]);
    uint32_t b2 = mul(W5, col[8]) + mul(-W1, col[24]);
    uint32_t b3 = mul(W7, col[8]) + mul(-W5, col[24]);
    a0 += mul(W4, col[32]);
    a1 += mul(-W4, col[32]);
    a2 += mul(-W4, col[32]);
    a3 += mul(W4, col[32]);
    b0 += mul(W5, col[40]);
    b1 += mul(-W1, col[40]);
    b2 += mul(W7, col[40]);
    b3 += mul(W3, col[40]);
    a0 += mul(W6, col[48]);
    a1 += mul(-W2, col[48]);
    a2 += mul(W2, col[48]);
    a3 += mul(-W6, col[48]);
    b0 += mul(W7, col[56]);
    b1 += mul(-W5, col[56]);
    b2 += mul(W3, col[56]);
    b3 += mul(-W1, col[56]);
    out[0] = int(a0 + b0) >> COL_SHIFT;
    out[1] = int(a1 + b1) >> COL_SHIFT;
    out[2] = int(a2 + b2) >> COL_SHIFT;
    out[3] = int(a3 + b3) >> COL_SHIFT;
    out[4] = int(a3 - b3) >> COL_SHIFT;
    out[5] = int(a2 - b2) >> COL_SHIFT;
    out[6] = int(a1 - b1) >> COL_SHIFT;
    out[7] = int(a0 - b0) >> COL_SHIFT;
}

inline void idct(int16_t* block, uint8_t* dst, int stride, bool add) {
    for (int r = 0; r < 8; r++) idct_row(block + 8 * r);
    for (int c = 0; c < 8; c++) {
        int v[8];
        idct_col(block + c, v);
        for (int r = 0; r < 8; r++) {
            uint8_t& d = dst[r * stride + c];
            d = clip_u8(add ? d + v[r] : v[r]);
        }
    }
}

}  // namespace host
