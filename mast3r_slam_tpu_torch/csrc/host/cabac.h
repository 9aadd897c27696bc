// The CABAC arithmetic decoding engine that H.264 (ISO/IEC 14496-10 clause
// 9.3.3.2) and HEVC (ISO/IEC 23008-2 clause 9.3.4.3) share: the same
// rangeTabLPS, transIdxLPS, renormalisation, bypass and terminate bins, and
// the same context initialisation from a slope and an offset.  Shared by the
// host library's video decoders (h264.cpp, hevc.cpp); each keeps its own
// context tables and context selection.
//
// `B` is the decoder's RBSP reader: `int bit()` gives the next bit (and
// fails past the data).
#pragma once

#include <algorithm>
#include <cstdint>

namespace host {

// rangeTabLPS by pStateIdx and qCodIRangeIdx (H.264 Table 9-44, HEVC Table 9-52)
const uint8_t RANGE_LPS[64][4] = {
    {128, 176, 208, 240}, {128, 167, 197, 227}, {128, 158, 187, 216}, {123, 150, 178, 205},
    {116, 142, 169, 195}, {111, 135, 160, 185}, {105, 128, 152, 175}, {100, 122, 144, 166},
    {95, 116, 137, 158}, {90, 110, 130, 150}, {85, 104, 123, 142}, {81, 99, 117, 135},
    {77, 94, 111, 128}, {73, 89, 105, 122}, {69, 85, 100, 116}, {66, 80, 95, 110},
    {62, 76, 90, 104}, {59, 72, 86, 99}, {56, 69, 81, 94}, {53, 65, 77, 89},
    {51, 62, 73, 85}, {48, 59, 69, 80}, {46, 56, 66, 76}, {43, 53, 63, 72},
    {41, 50, 59, 69}, {39, 48, 56, 65}, {37, 45, 54, 62}, {35, 43, 51, 59},
    {33, 41, 48, 56}, {32, 39, 46, 53}, {30, 37, 43, 50}, {29, 35, 41, 48},
    {27, 33, 39, 45}, {26, 31, 37, 43}, {24, 30, 35, 41}, {23, 28, 33, 39},
    {22, 27, 32, 37}, {21, 26, 30, 35}, {20, 24, 29, 33}, {19, 23, 27, 31},
    {18, 22, 26, 30}, {17, 21, 25, 28}, {16, 20, 23, 27}, {15, 19, 22, 25},
    {14, 18, 21, 24}, {14, 17, 20, 23}, {13, 16, 19, 22}, {12, 15, 18, 21},
    {12, 14, 17, 20}, {11, 14, 16, 19}, {11, 13, 15, 18}, {10, 12, 15, 17},
    {10, 12, 14, 16}, {9, 11, 13, 15}, {9, 11, 12, 14}, {8, 10, 12, 14},
    {8, 9, 11, 13}, {7, 9, 11, 12}, {7, 9, 10, 12}, {7, 8, 10, 11},
    {6, 8, 9, 11}, {6, 7, 9, 10}, {6, 7, 8, 9}, {2, 2, 2, 2}};
// transIdxLPS (H.264 Table 9-45, HEVC Table 9-53); transIdxMPS is min(pStateIdx + 1, 62)
const uint8_t TRANS_LPS[64] = {
    0,  0,  1,  2,  2,  4,  4,  5,  6,  7,  8,  9,  9,  11, 11, 12, 13, 13, 15, 15, 16, 16,
    18, 18, 19, 19, 21, 21, 22, 22, 23, 24, 24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30,
    31, 32, 32, 33, 33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63};

// A context's pStateIdx << 1 | valMPS from its slope m and offset n at
// slice QP q (0-51): preCtxState = Clip3(1, 126, ((m * q) >> 4) + n)
inline uint8_t cabac_state(int m, int n, int q) {
    int pre = std::min(std::max(((m * q) >> 4) + n, 1), 126);
    return pre <= 63 ? uint8_t((63 - pre) << 1) : uint8_t(((pre - 64) << 1) | 1);
}

template <class B>
struct CabacEngine {
    uint32_t range = 0, offset = 0;
    B* b = nullptr;

    // initialisation of the decoding engine: false if codIOffset is 510 or 511
    bool start(B& bits) {
        b = &bits;
        range = 510;
        offset = 0;
        for (int i = 0; i < 9; i++) offset = (offset << 1) | uint32_t(bits.bit());
        return offset < 510;
    }
    void renorm() {
        while (range < 256) {
            range <<= 1;
            offset = (offset << 1) | uint32_t(b->bit());
        }
    }
    int decide(uint8_t& st) {
        int p = st >> 1, mps = st & 1, bin;
        uint32_t lps = RANGE_LPS[p][(range >> 6) & 3];
        range -= lps;
        if (offset >= range) {
            bin = !mps;
            offset -= range;
            range = lps;
            st = uint8_t((TRANS_LPS[p] << 1) | (p == 0 ? !mps : mps));
        } else {
            bin = mps;
            st = uint8_t((std::min(p + 1, 62) << 1) | mps);
        }
        renorm();
        return bin;
    }
    int bypass() {
        offset = (offset << 1) | uint32_t(b->bit());
        if (offset >= range) {
            offset -= range;
            return 1;
        }
        return 0;
    }
    // a terminating bin (H.264's end_of_slice_flag and I_PCM's, HEVC's
    // end_of_slice_segment_flag and end_of_subset_one_bit): no
    // renormalisation after a 1
    int terminate() {
        range -= 2;
        if (offset >= range) return 1;
        renorm();
        return 0;
    }
    // the bypass suffix of a kth-order Exp-Golomb code; -1 if its prefix
    // runs past 24 ones
    int exp_golomb_bypass(int k) {
        int v = 0;
        while (bypass()) {
            v += 1 << k;
            if (++k > 24) return -1;
        }
        while (k--) v += bypass() << k;
        return v;
    }
};

}  // namespace host
