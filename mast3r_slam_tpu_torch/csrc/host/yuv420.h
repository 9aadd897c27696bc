// libswscale's yuv420p -> BGR24 conversion as cv2.VideoCapture asks for it
// (the SIMD path cv2 runs on x86-64: pmulhw on samples shifted up by 3),
// written as RGB, and its yuv422p one.  Shared by the host library's video
// decoders (mpeg4.cpp, h264.cpp, hevc.cpp, mjpeg.cpp).
//
// The six 16-bit coefficients are ff_yuv2rgb_c_init_tables' from
// libswscale's table for the stream's matrix_coefficients (cv2 5.0.0 hands
// libswscale the frame's colour space: BT.709, FCC, SMPTE 240M, BT.2020,
// else BT.601) and its range: limited range scales luma by 255/219 from
// 16, full range (yuvj420p, which libavcodec's H.264 decoder outputs for
// video_full_range_flag 1) scales chroma by 224/255.  Each class and range
// held against cv2 5.0.0 on all 2^24 (Y, U, V) at even heights; yuvj422p
// (Motion-JPEG's 4:2:2) too, at every width from 1 to 39 and more.
#pragma once

#include <cstddef>
#include <cstdint>

namespace host {

inline uint8_t clip_u8(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

// matrix_coefficients (ISO/IEC 23091-2) cv2 converts with: 1, 4, 7, 9 by
// their own table, 0, 2, 3, 5, 6 as BT.601; others libswscale refuses
inline bool yuv_matrix_supported(int matrix) { return matrix <= 7 || matrix == 9; }

struct YuvCoeffs {
    int y, y_offset, vr, ug, vg, ub;
};

// ff_yuv2rgb_coeffs of the matrix's class: crv, cbu, -cgu, -cgv (16.16)
inline const int64_t* yuv_matrix_table(int matrix) {
    static const int64_t table[5][4] = {{104597, 132201, 25675, 53279},   // BT.601
                                        {117489, 138438, 13975, 34925},   // BT.709
                                        {104448, 132798, 24759, 53109},   // FCC
                                        {117579, 136230, 16907, 35559},   // SMPTE 240M
                                        {110013, 140363, 12277, 42626}};  // BT.2020
    return table[matrix == 1 ? 1 : matrix == 4 ? 2 : matrix == 7 ? 3 : matrix == 9 ? 4 : 0];
}

inline YuvCoeffs yuv_coeffs(int matrix, bool full_range) {
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
    auto round16 = [](int64_t f) {  // roundToInt16
        int64_t r = (f + (1 << 15)) >> 16;
        return int(r < -32768 ? -32768 : r > 32767 ? 32767 : r);
    };
    return {round16(cy * 8192), round16(oy * 8), round16(crv * 8192),
            round16(cgu * 8192), round16(cgv * 8192), round16(cbu * 8192)};
}

// planes of `width` x `height` (even) 8-bit samples (held in uint8_t, or
// uint16_t by the HEVC decoder) with strides ys / cs, the chroma halved
// across and, for `vshift` 1, down (4:2:0; 0: 4:2:2, which libswscale
// converts with the same arithmetic, yuv422p's special converter)
template <class T>
inline void yuv_to_rgb(const T* Y, int ys, const T* U, const T* V, int cs,
                       int width, int height, int vshift, const YuvCoeffs& c, uint8_t* out) {
    for (int y = 0; y < height; y++) {
        const T* yr = Y + size_t(y) * ys;
        const T* ur = U + size_t(y >> vshift) * cs;
        const T* vr = V + size_t(y >> vshift) * cs;
        uint8_t* o = out + size_t(y) * width * 3;
        for (int x = 0; x < width; x++) {
            int yy = (((int(yr[x]) << 3) - c.y_offset) * c.y) >> 16;
            int u = (int(ur[x >> 1]) << 3) - 1024, v = (int(vr[x >> 1]) << 3) - 1024;
            o[3 * x + 0] = clip_u8(yy + ((v * c.vr) >> 16));
            o[3 * x + 1] = clip_u8(yy + ((u * c.ug) >> 16) + ((v * c.vg) >> 16));
            o[3 * x + 2] = clip_u8(yy + ((u * c.ub) >> 16));
        }
    }
}

template <class T>
inline void yuv420_to_rgb(const T* Y, int ys, const T* U, const T* V, int cs,
                          int width, int height, const YuvCoeffs& c, uint8_t* out) {
    yuv_to_rgb(Y, ys, U, V, cs, width, height, 1, c, out);
}

}  // namespace host
