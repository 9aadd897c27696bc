// libswscale's scaled conversion of 4:2:0 samples of 9 or 10 bits
// (yuv420p9, yuv420p10) to BGR24 at the frame's own size under
// SWS_BICUBIC, as cv2.VideoCapture asks for it, written as RGB.
//
// libswscale has no unscaled converter for these formats, so it runs its
// scaler (as libswscale 9.5, FFmpeg 8.1, runs it on x86-64):
//   - the input stage: each sample to a 15-bit intermediate, v << (15 - depth)
//     (hScale16To15 through the 1:1 filters, luma and half-width chroma);
//   - chroma nearest across the columns: packed RGB output takes one chroma
//     sample for two pixels, so the horizontal chroma filter is 1:1 too;
//   - chroma interpolated down the rows: the vertical filter that initFilter
//     builds for a 2x upsample (bicubic, B = 0, C = 0.6; chroma sited between
//     the luma rows), its taps cut where they fall near zero, aligned to 2
//     (the MMX vertical scaler), folded in at the first and last rows and
//     normalised to 4096 with the error carried from tap to tap;
//   - the packed output: every row but the last two through the MMXEXT
//     functions (a rounder of 4 plus pmulhw of each tap, then the pmulhw
//     colour matrix of yuv420.h's coefficients), the last two through the C
//     functions and ff_yuv2rgb_c_init_tables' tables.  Which function a row
//     takes follows packed_vscale: yuv2packed1 where the chroma filter has
//     one tap, or two that sum to 4096 without a negative one (the MMX one
//     takes the upper line alone below a weight of 2048, else the average of
//     both), yuv2packedX otherwise.
// scripts/sweep_yuv10_conversion.py holds this against cv2's own libswscale.
#pragma once

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <vector>

#include "yuv420.h"

namespace host {

// initFilter's filter from `src_n` samples to `dst_n` at step `inc` (16.16)
// under SWS_BICUBIC (B = 0, C = 0.6), the samples sited at `src_pos` and
// `dst_pos` (1/256 of a sample, get_local_pos's): `size` taps an output
// from sample pos[i], coeff[i * size + k], summing to `one`; `align` the
// x86 scalers' multiple of taps (4 across, 2 down)
struct SwsFilter {
    int size = 0;
    std::vector<int> pos;
    std::vector<int> coeff;
};

inline SwsFilter sws_filter(int64_t inc, int src_n, int dst_n, int align, int64_t one, int src_pos, int dst_pos) {
    const int64_t fone = int64_t(1) << 54;
    int fs;
    std::vector<int64_t> f;
    std::vector<int> pos(static_cast<size_t>(dst_n));
    if (std::llabs(inc - 0x10000) < 10 && src_pos == dst_pos) {  // unscaled
        fs = 1;
        f.assign(size_t(dst_n), fone);
        for (int i = 0; i < dst_n; i++) pos[size_t(i)] = i;
    } else {  // bicubic, upscaling or at 1:1
        fs = std::max(std::min(5, src_n - 2), 1);
        f.assign(size_t(dst_n) * fs, 0);
        const int64_t B = 0, C = int64_t(0.6 * (1 << 24));
        int64_t in_src = ((dst_pos * inc) >> 7) - ((src_pos * int64_t(0x10000)) >> 7);
        for (int i = 0; i < dst_n; i++) {
            int64_t xx = (in_src - (fs - 2) * (int64_t(1) << 16)) / (1 << 17);
            pos[size_t(i)] = int(xx);
            for (int j = 0; j < fs; j++, xx++) {
                int64_t d = std::llabs(xx * (1 << 17) - in_src) << 13, coeff = 0;
                if (d < int64_t(1) << 31) {
                    int64_t dd = (d * d) >> 30, ddd = (dd * d) >> 30;
                    if (d < int64_t(1) << 30)
                        coeff = (12 * (1 << 24) - 9 * B - 6 * C) * ddd + (-18 * (1 << 24) + 12 * B + 6 * C) * dd +
                                (6 * (1 << 24) - 2 * B) * (int64_t(1) << 30);
                    else
                        coeff = (-B - 6 * C) * ddd + (6 * B + 30 * C) * dd + (-12 * B - 48 * C) * d +
                                (8 * B + 24 * C) * (int64_t(1) << 30);
                }
                f[size_t(i) * fs + j] = coeff;
            }
            in_src += 2 * inc;
        }
    }
    // near-zero taps cut: shifted out on the left, counted on the right
    const double cutoff = 0.002 * double(fone);
    int min_size = 0;
    for (int i = dst_n - 1; i >= 0; i--) {
        int64_t* r = &f[size_t(i) * fs];
        int n = fs;
        int64_t cut = 0;
        for (int j = 0; j < fs; j++) {
            cut += std::llabs(r[0]);
            if (double(cut) > cutoff) break;
            if (i < dst_n - 1 && pos[size_t(i)] >= pos[size_t(i) + 1]) break;
            for (int k = 1; k < fs; k++) r[k - 1] = r[k];
            r[fs - 1] = 0;
            pos[size_t(i)]++;
        }
        cut = 0;
        for (int j = fs - 1; j > 0; j--) {
            cut += std::llabs(r[j]);
            if (double(cut) > cutoff) break;
            n--;
        }
        min_size = std::max(min_size, n);
    }
    if (min_size == 1 && align == 2) align = 1;  // the MMX vertical scaler's unscaled case
    int size = (min_size + align - 1) & ~(align - 1);
    std::vector<int64_t> g(size_t(dst_n) * size, 0);
    for (int i = 0; i < dst_n; i++)
        for (int j = 0; j < size && j < fs; j++) g[size_t(i) * size + j] = f[size_t(i) * fs + j];
    // the borders: taps before the first sample or past the last folded in
    for (int i = 0; i < dst_n; i++) {
        int64_t* r = &g[size_t(i) * size];
        int& p = pos[size_t(i)];
        if (p < 0) {
            for (int j = 1; j < size; j++) {
                int left = std::max(j + p, 0);
                r[left] += r[j];
                r[j] = 0;
            }
            p = 0;
        }
        if (p + size > src_n) {
            int shift = p + std::min(size - src_n, 0);
            int64_t acc = 0;
            for (int j = size - 1; j >= 0; j--)
                if (p + j >= src_n) {
                    acc += r[j];
                    r[j] = 0;
                }
            for (int j = size - 1; j >= 0; j--) r[j] = j < shift ? 0 : r[j - shift];
            p -= shift;
            r[src_n - 1 - p] += acc;
        }
    }
    SwsFilter out;
    out.size = size;
    out.pos = pos;
    out.coeff.resize(size_t(dst_n) * size);
    for (int i = 0; i < dst_n; i++) {
        int64_t sum = 0, error = 0;
        for (int j = 0; j < size; j++) sum += g[size_t(i) * size + j];
        sum = (sum + one / 2) / one;
        if (!sum) sum = 1;
        for (int j = 0; j < size; j++) {
            int64_t v = g[size_t(i) * size + j] + error;
            int64_t q = (v >= 0 ? v + (sum >> 1) : v - (sum >> 1)) / sum;  // ROUNDED_DIV
            out.coeff[size_t(i) * size + j] = int(q);
            error = v - q * sum;
        }
    }
    return out;
}

// ff_yuv2rgb_c_init_tables for 24-bit output: the clipped luma table and
// each chroma component's offset into it
struct SwsTables {
    uint8_t y[2048];
    int yoffs;
    int64_t crv, cbu, cgu, cgv;
    int r(int v) const { return yoffs - int(crv >> 9) + int((int64_t(v) * crv) >> 16); }
    int g(int u, int v) const {
        return yoffs - int(cgu >> 9) + int((int64_t(u) * cgu) >> 16) - int(cgv >> 9) + int((int64_t(v) * cgv) >> 16);
    }
    int b(int u) const { return yoffs - int(cbu >> 9) + int((int64_t(u) * cbu) >> 16); }
};

inline SwsTables sws_tables(int matrix, bool full_range) {
    const int64_t* t = yuv_matrix_table(matrix);
    int64_t crv = t[0], cbu = t[1], cgu = -t[2], cgv = -t[3], cy = 1 << 16, oy = 0;
    if (!full_range) {
        cy = cy * 255 / 219;
        oy = 16 << 16;
    } else {
        crv = crv * 224 / 255;
        cbu = cbu * 224 / 255;
        cgu = cgu * 224 / 255;
        cgv = cgv * 224 / 255;
    }
    SwsTables s;
    s.yoffs = (full_range ? 384 : 326) + 512;
    int64_t yb = -(int64_t(384) << 16) - 512 * cy - oy;
    for (int i = 0; i < 2048; i++, yb += cy) s.y[i] = clip_u8(int((yb + 0x8000) >> 16));
    s.crv = (crv * 65536 + 0x8000) / cy;
    s.cbu = (cbu * 65536 + 0x8000) / cy;
    s.cgu = (cgu * 65536 + 0x8000) / cy;
    s.cgv = (cgv * 65536 + 0x8000) / cy;
    return s;
}

// get_local_pos of a 4:2:0 chroma site along one axis (1/256 of a luma
// sample from the top-left luma sample: 0, 128 or 256), in chroma samples
inline int sws_chroma_pos(int luma_pos) { return (luma_pos + 128) >> 1; }

// planes of `width` x `height` samples of `depth` bits (width and height
// even; chroma halved both ways) with strides ys / cs in samples, the
// chroma sited at `chroma_loc` (chroma_sample_loc_type, 0-5: cv2 passes
// the frame's site as src_h_chr_pos / src_v_chr_pos, libavcodec's HEVC
// decoder type 0 where the VUI names none)
inline void yuv420_high_to_rgb(const uint16_t* Y, int ys, const uint16_t* U, const uint16_t* V, int cs,
                               int width, int height, int depth, int matrix, bool full_range, int chroma_loc,
                               uint8_t* out) {
    const int sh = 15 - depth, cw = width / 2, ch = height / 2;
    const YuvCoeffs c = yuv_coeffs(matrix, full_range);
    const SwsTables t = sws_tables(matrix, full_range);
    // the sites: 0 left, 1 centre, 2 top-left, 3 top, 4 bottom-left, 5 bottom
    const int hpos = chroma_loc & 1 ? 128 : 0, vpos = chroma_loc < 2 ? 128 : chroma_loc < 4 ? 0 : 256;
    // chroma across: to half-width rows of 15 bits (hScale16To15), 1:1 but
    // for the site; packed RGB rows take one chroma sample for two pixels
    const SwsFilter fh = sws_filter(0x10000, cw, cw, 4, 1 << 14, sws_chroma_pos(hpos), 128);
    // chroma down: the 2x upsample to every row
    const SwsFilter fv = sws_filter(((int64_t(ch) << 16) + (height >> 1)) / height, ch, height, 2, 1 << 12,
                                    sws_chroma_pos(vpos), 128);
    std::vector<int> u15(size_t(cw) * ch), v15(size_t(cw) * ch);
    for (int y = 0; y < ch; y++)
        for (int x = 0; x < cw; x++) {
            const int* cf = &fh.coeff[size_t(x) * fh.size];
            const uint16_t* ur = U + size_t(y) * cs + fh.pos[size_t(x)];
            const uint16_t* vr = V + size_t(y) * cs + fh.pos[size_t(x)];
            int su = 0, sv = 0;
            for (int k = 0; k < fh.size; k++) {
                su += ur[k] * cf[k];
                sv += vr[k] * cf[k];
            }
            u15[size_t(y) * cw + x] = std::min(su >> (depth - 1), 32767);
            v15[size_t(y) * cw + x] = std::min(sv >> (depth - 1), 32767);
        }
    auto mulhi = [](int a, int b) { return (a * b) >> 16; };  // pmulhw
    std::vector<int> uu(static_cast<size_t>(cw)), vv(static_cast<size_t>(cw));
    for (int y = 0; y < height; y++) {
        const int* cf = &fv.coeff[size_t(y) * fv.size];
        const int p = fv.pos[size_t(y)];
        const bool one = fv.size == 1 || (fv.size == 2 && cf[0] + cf[1] == 4096 && cf[1] >= 0);
        const int alpha = fv.size == 1 ? 0 : cf[1];
        const bool mmx = y < height - 2;  // libswscale's last two rows run its C functions
        // chroma at 8 bits << 3 (MMX rows) or at 8 bits (C rows)
        for (int x = 0; x < cw; x++) {
            auto line = [&](const std::vector<int>& P, int k) { return P[size_t(std::min(p + k, ch - 1)) * cw + x]; };
            int u, v;
            if (one) {
                int u0 = line(u15, 0), v0 = line(v15, 0), u1 = alpha ? line(u15, 1) : u0, v1 = alpha ? line(v15, 1) : v0;
                if (mmx) {  // psraw 4, or paddw then psrlw 5 (a 16-bit sum, shifted as unsigned)
                    u = alpha < 2048 ? u0 >> 4 : ((u0 + u1) & 0xFFFF) >> 5;
                    v = alpha < 2048 ? v0 >> 4 : ((v0 + v1) & 0xFFFF) >> 5;
                } else if (alpha < 2048) {
                    u = (u0 + 64) >> 7;
                    v = (v0 + 64) >> 7;
                } else {
                    u = (u0 * (4096 - alpha) + u1 * alpha + (1 << 18)) >> 19;
                    v = (v0 * (4096 - alpha) + v1 * alpha + (1 << 18)) >> 19;
                }
            } else if (mmx) {
                u = v = 4;
                for (int k = 0; k < fv.size; k++) {
                    u += mulhi(line(u15, k), cf[k]);
                    v += mulhi(line(v15, k), cf[k]);
                }
            } else {
                u = v = 1 << 18;
                for (int k = 0; k < fv.size; k++) {
                    u += line(u15, k) * cf[k];
                    v += line(v15, k) * cf[k];
                }
                u >>= 19;
                v >>= 19;
            }
            uu[size_t(x)] = u;
            vv[size_t(x)] = v;
        }
        const uint16_t* yr = Y + size_t(y) * ys;
        uint8_t* o = out + size_t(y) * width * 3;
        for (int x = 0; x < width; x++) {
            int u = uu[size_t(x >> 1)], v = vv[size_t(x >> 1)], l = std::min(int(yr[x]) << sh, 32767);
            if (mmx) {
                int yy = mulhi((one ? l >> 4 : 4 + (l >> 4)) - c.y_offset, c.y);
                u -= 1024;
                v -= 1024;
                o[3 * x + 0] = clip_u8(yy + mulhi(v, c.vr));
                o[3 * x + 1] = clip_u8(yy + mulhi(u, c.ug) + mulhi(v, c.vg));
                o[3 * x + 2] = clip_u8(yy + mulhi(u, c.ub));
            } else {
                int yy = (l + 64) >> 7;
                u = u < 0 ? 0 : u > 255 ? 255 : u;
                v = v < 0 ? 0 : v > 255 ? 255 : v;
                o[3 * x + 0] = t.y[t.r(v) + yy];
                o[3 * x + 1] = t.y[t.g(u, v) + yy];
                o[3 * x + 2] = t.y[t.b(u) + yy];
            }
        }
    }
}

}  // namespace host
