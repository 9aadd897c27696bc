// HEVC (ISO/IEC 23008-2, ITU-T H.265) video decoder for the port's video
// input, bit-exact against what cv2 5.0.0 (FFmpeg, libavcodec 62.28) gives:
// the decoder's YUV 4:2:0 planes, cropped, then libswscale's conversion to
// BGR24 as cv2.VideoCapture asks for it (at 8 bits its unscaled converter,
// yuv420.h; at 9 and 10 bits its scaler, swscale.h, with the chroma site
// libavcodec reports), handed back in RGB order.  HEVC fixes every decoded
// sample, so the decoder follows the standard; where libavcodec departs
// from it, the decoder does as libavcodec does: its in-loop filters run CTB by CTB in its order, with
// its tc/beta offsets, its chroma QP clip and its SAO slice edges
// (Decoder::loop_filters, deblock_ctb, sao_ctb), and a slice that disables
// deblocking by override keeps the offsets of the header before it.  The
// arithmetic decoder is the one H.264 uses (cabac.h); the NAL unit reader
// is shared too (nal.h).
//
// What is decoded: Main and Main 10 profile 4:2:0 I, P and B pictures at 8,
// 9 and 10 bits (samples held in 16 bits; the QP offset, the shifts of
// scaling, transform, prediction and weights, and the thresholds and clips
// of intra prediction, deblocking and SAO at the bit depth, with libavcodec's
// x86 code where it departs from the C code: at 10 bits its inter
// prediction saturates and its residual add wraps in 16 bits, at 9 bits,
// which it runs in C, a prediction list 0 stores wraps), with
// leading pictures: RADL pictures, RASL pictures (left out, neither decoded
// nor output, where their CRA or BLA picture opens decoding, as libavcodec's
// max_ra leaves them out: at the stream's start, after a seek's reset, after
// any BLA picture) and BLA pictures (NoRaslOutputFlag, PicOrderCntMsb 0).
// Parameter sets in the decoder configuration (hvcC, or an AVI stream's
// first sample) or in band, with the VUI's video_full_range_flag and colour
// description (converted as cv2 converts them), st_ref_pic_set with
// inter-RPS prediction, the conformance window (right and bottom); slice
// segment headers with pic_output_flag, the short-term RPS in the SPS or the
// header, num_ref_idx_active_override for both lists, list modification
// (list_entry_l0/l1), RefPicList0 and RefPicList1, mvd_l1_zero_flag,
// cabac_init_flag, collocated_from_l0_flag and collocated_ref_idx,
// pred_weight_table for both lists (weighted_pred_flag in P slices,
// weighted_bipred_flag in B), slice QP and chroma QP offsets, the deblocking
// controls, the SAO flags and entry points; several slices a picture, I, P
// and B slices mixed; for an IRAP picture that opens decoding, the pictures
// its RPS names generated without samples (8.3.3), as they fill the DPB;
// CABAC with
// wavefront parallel processing (the contexts saved after the second CTU
// of a row, end_of_subset_one_bit); the coding quadtree with CTBs cut by
// the picture's right and bottom edges; every CU and PU partition (AMP
// too), cu_skip_flag, inter_pred_idc, merge (spatial, temporal from the
// collocated picture's 16x16 motion in either list, combined bi-predictive,
// zero; the parallel merge level; no bi-prediction for an 8x4 or 4x8 block)
// and AMVP in both lists (scaled across lists by POC distance); the
// transform tree with cu_qp_delta, residual_coding with sign data hiding
// and transform_skip; intra prediction (35 modes, reference substitution,
// filtering, strong intra smoothing, the DC/H/V boundary filters) under
// constrained_intra_pred; 8-tap luma and 4-tap chroma interpolation with
// the picture edge extended, the default bi-predictive average, explicit
// weighted uni- and bi-prediction; flat
// dequantisation, the 4x4 DST and 4- to 32-point inverse DCT with 16-bit
// clipping between stages; the deblocking filter (bS of bi-predicted blocks
// by reference pictures and both pairings of their vectors, as
// libavcodec's boundary_strength) and SAO (band and edge);
// RPS marking and the DPB's output (Decoder::bump: held back by
// sps_max_num_reorder_pics, sps_max_latency_increase_plus1 and
// sps_max_dec_pic_buffering, pic_output_flag), drained at the end.
//
// What is refused (rc 2, NotImplementedError, naming ROADMAP Queue 1 item
// 17): bit depths over 10, luma and chroma of different depths (which
// libavcodec does not decode), a bit depth or chroma site that changes, an
// IDR picture of the POC of a picture generated for the RPS of the CRA or
// BLA picture that opened decoding (libavcodec drops it: Queue 3 item 27),
// chroma formats other than 4:2:0, scaling lists,
// PCM, transquant bypass, tiles, dependent slice segments, long-term
// references, range and other SPS/PPS extensions, multi-layer streams
// (nuh_layer_id > 0), end of sequence or bitstream NAL units (and with them
// a CRA picture after one, which would open decoding), a conformance window
// cropping the left or
// top, a picture size or colour that changes, colour descriptions that
// libswscale maps or refuses (BT.2020 primaries among them, which HDR video
// carries), a picture whose first slice disables
// deblocking by override while a later one enables it (libavcodec then
// filters with an earlier picture's offsets), a stream that does not start
// with an IRAP picture (a leading picture first too), and more than one
// picture a sample.  Corrupt or truncated data
// and streams the standard does not allow are rc 1 (ValueError):
// libavcodec would conceal them.

#include <algorithm>
#include <climits>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <memory>
#include <new>
#include <vector>

#include "cabac.h"
#include "nal.h"
#include "swscale.h"
#include "yuv420.h"

namespace {

using namespace host;

#define ITEM "ROADMAP Queue 1 item 17"
[[noreturn]] void refuse(const char* what) { fail(UNSUPPORTED, "HEVC %s is not ported (%s)", what, ITEM); }

inline int clip3(int lo, int hi, int v) { return v < lo ? lo : v > hi ? hi : v; }

// ---- CABAC contexts (9.3.2.2, Tables 9-5 to 9-37): initValue by initType ---------

// the contexts of each syntax element, in this order (offsets below)
enum Ctx {
    SAO_MERGE = 0,             // 1
    SAO_TYPE = 1,              // 1
    SPLIT_CU = 2,              // 3
    TQ_BYPASS = 5,             // 1
    CU_SKIP = 6,               // 3
    CU_QP_DELTA = 9,           // 2
    PRED_MODE = 11,            // 1
    PART_MODE = 12,            // 4
    PREV_INTRA = 16,           // 1
    CHROMA_MODE = 17,          // 1
    MERGE_FLAG = 18,           // 1
    MERGE_IDX = 19,            // 1
    INTER_PRED = 20,           // 5
    REF_IDX = 25,              // 2
    MVD_GT0 = 27,              // 1
    MVD_GT1 = 28,              // 1
    MVP_FLAG = 29,             // 1
    RQT_ROOT_CBF = 30,         // 1
    SPLIT_TRANSFORM = 31,      // 3
    CBF_LUMA = 34,             // 2
    CBF_CHROMA = 36,           // 4
    TRANSFORM_SKIP = 40,       // 2
    LAST_X = 42,               // 18
    LAST_Y = 60,               // 18
    CODED_SUB_BLOCK = 78,      // 4
    SIG_COEFF = 82,            // 42
    GT1 = 124,                 // 24
    GT2 = 148,                 // 6
    NUM_CTX = 154
};

const uint8_t CTX_INIT[3][NUM_CTX] = {
    {153, 200, 139, 141, 157, 154, 154, 154, 154, 154, 154, 154, 184, 154, 154, 154, 184, 63,
     154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 153, 138, 138, 111, 141,
     94,  138, 182, 154, 139, 139, 110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143,
     127, 111, 79,  108, 123, 63,  110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143,
     127, 111, 79,  108, 123, 63,  91,  171, 134, 141, 111, 111, 125, 110, 110, 94,  124, 108,
     124, 107, 125, 141, 179, 153, 125, 107, 125, 141, 179, 153, 125, 107, 125, 141, 179, 153,
     125, 140, 139, 182, 182, 152, 136, 152, 136, 153, 136, 139, 111, 136, 139, 111, 140, 92,
     137, 138, 140, 152, 138, 139, 153, 74,  149, 92,  139, 107, 122, 152, 140, 179, 166, 182,
     140, 227, 122, 197, 138, 153, 136, 167, 152, 152},
    {153, 185, 107, 139, 126, 154, 197, 185, 201, 154, 154, 149, 154, 139, 154, 154, 154, 152,
     110, 122, 95,  79,  63,  31,  31,  153, 153, 140, 198, 168, 79,  124, 138, 94,  153, 111,
     149, 107, 167, 154, 139, 139, 125, 110, 94,  110, 95,  79,  125, 111, 110, 78,  110, 111,
     111, 95,  94,  108, 123, 108, 125, 110, 94,  110, 95,  79,  125, 111, 110, 78,  110, 111,
     111, 95,  94,  108, 123, 108, 121, 140, 61,  154, 155, 154, 139, 153, 139, 123, 123, 63,
     153, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153,
     154, 170, 153, 123, 123, 107, 121, 107, 121, 167, 151, 183, 140, 151, 183, 140, 154, 196,
     196, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121, 136, 137, 169, 194, 166, 167,
     154, 167, 137, 182, 107, 167, 91,  122, 107, 167},
    {153, 160, 107, 139, 126, 154, 197, 185, 201, 154, 154, 134, 154, 139, 154, 154, 183, 152,
     154, 137, 95,  79,  63,  31,  31,  153, 153, 169, 198, 168, 79,  224, 167, 122, 153, 111,
     149, 92,  167, 154, 139, 139, 125, 110, 124, 110, 95,  94,  125, 111, 111, 79,  125, 126,
     111, 111, 79,  108, 123, 93,  125, 110, 124, 110, 95,  94,  125, 111, 111, 79,  125, 126,
     111, 111, 79,  108, 123, 93,  121, 140, 61,  154, 170, 154, 139, 153, 139, 123, 123, 63,
     124, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153,
     154, 170, 153, 138, 138, 122, 121, 122, 121, 167, 151, 183, 140, 151, 183, 140, 154, 196,
     167, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121, 136, 122, 169, 208, 166, 167,
     154, 152, 167, 182, 107, 167, 91,  107, 107, 167}};

// sig_coeff_flag's sigCtx of a 4x4 block's positions (9.3.4.2.5)
const uint8_t CTX_IDX_MAP[16] = {0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8};

// ---- reconstruction tables ------------------------------------------------------

// intraPredAngle of modes 2-34 and invAngle of modes 11-25 (8.4.4.2.6)
const int INTRA_ANGLE[35] = {0,   0,   32,  26,  21,  17,  13,  9,   5,   2,   0,   -2,
                             -5,  -9,  -13, -17, -21, -26, -32, -26, -21, -17, -13, -9,
                             -5,  -2,  0,   2,   5,   9,   13,  17,  21,  26,  32};
const int INV_ANGLE[35] = {0,     0,     0,    0,    0,    0,    0,    0,     0,    0,    0,    -4096,
                           -1638, -910,  -630, -482, -390, -315, -256, -315,  -390, -482, -630, -910,
                           -1638, -4096, 0,    0,    0,    0,    0,    0,     0,    0,    0};
// the magnitudes of the 32-point transMatrix (8.6.4.2) by angle j (of pi/64), j = 0..32
const int DCT_MAG[33] = {64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73, 70, 67, 64,
                         61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22, 18, 13, 9,  4,  0};
const int DST4[4][4] = {{29, 55, 74, 84}, {74, 74, 0, -74}, {84, -29, -74, 55}, {55, -84, 74, -29}};
const int LEVEL_SCALE[6] = {40, 45, 51, 57, 64, 72};
// luma 8-tap and chroma 4-tap interpolation filters (8.5.3.3.3)
const int LUMA_FILTER[4][8] = {{0, 0, 0, 64, 0, 0, 0, 0},
                               {-1, 4, -10, 58, 17, -5, 1, 0},
                               {-1, 4, -11, 40, 40, -11, 4, -1},
                               {0, 1, -5, 17, 58, -10, 4, -1}};
const int CHROMA_FILTER[8][4] = {{0, 64, 0, 0},     {-2, 58, 10, -2}, {-4, 54, 16, -2},
                                 {-6, 46, 28, -4},  {-4, 36, 36, -4}, {-4, 28, 46, -6},
                                 {-2, 16, 54, -4},  {-2, 10, 58, -2}};
// deblocking: beta' by Q (0-51) and tc' by Q (0-53) (Table 8-12)
const uint8_t BETA_TABLE[52] = {0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  6,  7,
                                8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32,
                                34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64};
const uint8_t TC_TABLE[54] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  0,
                              1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2,  2,  3,  3,  3,  3,  4,
                              4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24};
// QpC by qPi 30-43 (Table 8-10, ChromaArrayType 1)
const uint8_t QPC_TABLE[14] = {29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37};

inline int chroma_qp_of(int qpi) { return qpi < 30 ? qpi : qpi > 43 ? qpi - 6 : QPC_TABLE[qpi - 30]; }

struct Tables {
    int16_t dct[32][32];  // transMatrix of the 32-point transform; the N-point's row k is row k * 32 / N
    // scan orders (6.5.3-6.5.5) by log2 block size 0-3 and scanIdx 0-2: (x, y)
    uint8_t scan[4][3][64][2];
    Tables() {
        for (int k = 0; k < 32; k++)
            for (int n = 0; n < 32; n++) {
                int j = ((2 * n + 1) * k) % 128, f = j % 64;
                if (f > 32) f = 64 - f;
                int v = k == 0 ? 64 : DCT_MAG[f];
                dct[k][n] = int16_t((j > 32 && j < 96) ? -v : v);
            }
        for (int lg = 0; lg < 4; lg++) {
            int s = 1 << lg, i = 0, x = 0, y = 0;
            while (i < s * s) {  // up-right diagonal
                while (y >= 0) {
                    if (x < s && y < s) {
                        scan[lg][0][i][0] = uint8_t(x);
                        scan[lg][0][i][1] = uint8_t(y);
                        i++;
                    }
                    y--;
                    x++;
                }
                y = x;
                x = 0;
            }
            for (i = 0; i < s * s; i++) {
                scan[lg][1][i][0] = uint8_t(i % s);  // horizontal
                scan[lg][1][i][1] = uint8_t(i / s);
                scan[lg][2][i][0] = uint8_t(i / s);  // vertical
                scan[lg][2][i][1] = uint8_t(i % s);
            }
        }
    }
};

const Tables& tables() {
    static const Tables t;
    return t;
}

// ---- parameter sets (7.3.2) ---------------------------------------------------------

struct StRps {  // a short-term reference picture set (7.4.8)
    int num_negative = 0, num_positive = 0;
    int delta_poc[32];  // the num_negative S0 entries, then the num_positive S1 entries
    bool used[32];
    int count() const { return num_negative + num_positive; }
};

struct Sps {
    bool valid = false;
    int max_sub_layers = 1;
    int width = 0, height = 0;  // pic_width/height_in_luma_samples
    int crop_right = 0, crop_bottom = 0;  // luma samples
    int log2_max_poc_lsb = 4;
    int max_dec_pic_buffering = 1, num_reorder = 0, max_latency_increase_plus1 = 0;  // HighestTid's
    int log2_min_cb = 3, log2_ctb = 4, log2_min_tb = 2, log2_max_tb = 4;
    int max_th_depth_inter = 0, max_th_depth_intra = 0;
    bool amp = false, sao = false, temporal_mvp = false, strong_intra_smoothing = false;
    std::vector<StRps> rps;
    bool full_range = false;
    int matrix = 2;
    int bit_depth = 8;  // BitDepthY = BitDepthC
    int chroma_loc = 0;  // chroma_sample_loc_type_top_field (0 without chroma_loc_info, as libavcodec takes it)
    // derived
    int ctb_w = 0, ctb_h = 0;
    int qp_offset() const { return 6 * (bit_depth - 8); }  // QpBdOffsetY = QpBdOffsetC
};

struct Pps {
    bool valid = false;
    int sps_id = 0;
    bool dependent_slices = false, output_flag_present = false;
    int num_extra_slice_header_bits = 0;
    bool sign_data_hiding = false, cabac_init_present = false;
    int num_ref_idx_default[2] = {1, 1};
    int init_qp = 26;
    bool constrained_intra_pred = false, transform_skip = false, cu_qp_delta = false;
    int diff_cu_qp_delta_depth = 0;
    int cb_qp_offset = 0, cr_qp_offset = 0;
    bool slice_chroma_qp_offsets_present = false, weighted_pred = false, weighted_bipred = false;
    bool entropy_coding_sync = false, loop_filter_across_slices = false;
    bool deblocking_override_enabled = false, deblocking_disabled = false;
    int beta_offset = 0, tc_offset = 0;  // *_div2 * 2
    bool lists_modification_present = false;
    int log2_parallel_merge_level = 2;
    bool slice_header_extension = false;
};

void profile_tier_level(Bits& b, bool profile_present, int max_sub_layers_minus1) {
    if (profile_present) {
        b.u(8);   // general_profile_space, tier_flag, profile_idc
        b.u(32);  // general_profile_compatibility_flag[32]
        b.u(32);  // progressive, interlaced, non_packed, frame_only + 44 bits
        b.u(16);
    }
    b.u(8);  // general_level_idc
    bool sub_profile[8] = {false}, sub_level[8] = {false};
    for (int i = 0; i < max_sub_layers_minus1; i++) {
        sub_profile[i] = b.flag();
        sub_level[i] = b.flag();
    }
    if (max_sub_layers_minus1 > 0)
        for (int i = max_sub_layers_minus1; i < 8; i++) b.u(2);  // reserved_zero_2bits
    for (int i = 0; i < max_sub_layers_minus1; i++) {
        if (sub_profile[i]) {
            b.u(8);
            b.u(32);
            b.u(32);
            b.u(16);
        }
        if (sub_level[i]) b.u(8);
    }
}

void sub_layer_hrd(Bits& b, int cpb_cnt, bool sub_pic) {
    for (int i = 0; i < cpb_cnt; i++) {
        b.ue();  // bit_rate_value_minus1
        b.ue();  // cpb_size_value_minus1
        if (sub_pic) {
            b.ue();
            b.ue();
        }
        b.flag();  // cbr_flag
    }
}

void hrd_parameters(Bits& b, bool common, int max_sub_layers_minus1) {  // E.2.2
    bool nal = false, vcl = false, sub_pic = false;
    if (common) {
        nal = b.flag();
        vcl = b.flag();
        if (nal || vcl) {
            sub_pic = b.flag();
            if (sub_pic) {
                b.u(8);
                b.u(5);
                b.flag();
                b.u(5);
            }
            b.u(4);  // bit_rate_scale
            b.u(4);  // cpb_size_scale
            if (sub_pic) b.u(4);
            b.u(5);
            b.u(5);
            b.u(5);
        }
    }
    for (int i = 0; i <= max_sub_layers_minus1; i++) {
        bool fixed_general = b.flag(), fixed_within = true, low_delay = false;
        if (!fixed_general) fixed_within = b.flag();
        if (fixed_within) b.ue();  // elemental_duration_in_tc_minus1
        else low_delay = b.flag();
        int cpb_cnt = 1;
        if (!low_delay) cpb_cnt = int(b.ue_max(31, "cpb_cnt_minus1")) + 1;
        if (nal) sub_layer_hrd(b, cpb_cnt, sub_pic);
        if (vcl) sub_layer_hrd(b, cpb_cnt, sub_pic);
    }
}

// st_ref_pic_set(idx) (7.3.7), its pictures derived as 7.4.8 derives them;
// `sets` holds the SPS's sets 0..idx-1
StRps st_ref_pic_set(Bits& b, int idx, int num_in_sps, const std::vector<StRps>& sets) {
    StRps r;
    bool inter = idx != 0 && b.flag();
    if (inter) {
        int delta_idx = 1;
        if (idx == num_in_sps) delta_idx = int(b.ue_max(uint32_t(idx - 1), "delta_idx_minus1")) + 1;
        int sign = b.flag();
        int abs_delta = int(b.ue_max(32767, "abs_delta_rps_minus1")) + 1;
        int delta_rps = sign ? -abs_delta : abs_delta;
        const StRps& ref = sets[size_t(idx - delta_idx)];
        int n = ref.count();
        bool used[33], use_delta[33];
        for (int j = 0; j <= n; j++) {
            used[j] = b.flag();
            use_delta[j] = used[j] ? true : b.flag();
        }
        int i = 0;
        for (int j = ref.num_positive - 1; j >= 0; j--) {
            int d = ref.delta_poc[ref.num_negative + j] + delta_rps;
            if (d < 0 && use_delta[ref.num_negative + j]) {
                r.delta_poc[i] = d;
                r.used[i++] = used[ref.num_negative + j];
            }
        }
        if (delta_rps < 0 && use_delta[n]) {
            r.delta_poc[i] = delta_rps;
            r.used[i++] = used[n];
        }
        for (int j = 0; j < ref.num_negative; j++) {
            int d = ref.delta_poc[j] + delta_rps;
            if (d < 0 && use_delta[j]) {
                if (i >= 16) fail(CORRUPT, "a reference picture set of more than 16 pictures");
                r.delta_poc[i] = d;
                r.used[i++] = used[j];
            }
        }
        r.num_negative = i;
        int s1[33];
        bool u1[33];
        int k = 0;
        for (int j = ref.num_negative - 1; j >= 0; j--) {
            int d = ref.delta_poc[j] + delta_rps;
            if (d > 0 && use_delta[j]) {
                s1[k] = d;
                u1[k++] = used[j];
            }
        }
        if (delta_rps > 0 && use_delta[n]) {
            s1[k] = delta_rps;
            u1[k++] = used[n];
        }
        for (int j = 0; j < ref.num_positive; j++) {
            int d = ref.delta_poc[ref.num_negative + j] + delta_rps;
            if (d > 0 && use_delta[ref.num_negative + j]) {
                s1[k] = d;
                u1[k++] = used[ref.num_negative + j];
            }
        }
        if (i + k > 16) fail(CORRUPT, "a reference picture set of more than 16 pictures");
        for (int j = 0; j < k; j++) {
            r.delta_poc[i + j] = s1[j];
            r.used[i + j] = u1[j];
        }
        r.num_positive = k;
    } else {
        r.num_negative = int(b.ue_max(16, "num_negative_pics"));
        r.num_positive = int(b.ue_max(16, "num_positive_pics"));
        if (r.count() > 16) fail(CORRUPT, "a reference picture set of more than 16 pictures");
        int poc = 0;
        for (int i = 0; i < r.num_negative; i++) {
            poc -= int(b.ue_max(32767, "delta_poc_s0_minus1")) + 1;
            r.delta_poc[i] = poc;
            r.used[i] = b.flag();
        }
        poc = 0;
        for (int i = 0; i < r.num_positive; i++) {
            poc += int(b.ue_max(32767, "delta_poc_s1_minus1")) + 1;
            r.delta_poc[r.num_negative + i] = poc;
            r.used[r.num_negative + i] = b.flag();
        }
    }
    return r;
}

Sps parse_sps(Bits& b, int* id) {
    Sps s;
    b.u(4);  // sps_video_parameter_set_id
    int max_sub_layers_minus1 = int(b.u(3));
    if (max_sub_layers_minus1 > 6) fail(CORRUPT, "sps_max_sub_layers_minus1 %d", max_sub_layers_minus1);
    s.max_sub_layers = max_sub_layers_minus1 + 1;
    b.flag();  // sps_temporal_id_nesting_flag
    profile_tier_level(b, true, max_sub_layers_minus1);
    *id = int(b.ue_max(15, "sps_seq_parameter_set_id"));
    int chroma_format = int(b.ue_max(3, "chroma_format_idc"));
    if (chroma_format != 1) refuse("with a chroma format other than 4:2:0");
    s.width = int(b.ue_max(16888, "pic_width_in_luma_samples"));
    s.height = int(b.ue_max(16888, "pic_height_in_luma_samples"));
    if (!s.width || !s.height) fail(CORRUPT, "a picture of %dx%d samples", s.width, s.height);
    if (b.flag()) {  // conformance_window_flag (offsets in chroma samples)
        int left = 2 * int(b.ue_max(8192, "conf_win_left_offset"));
        s.crop_right = 2 * int(b.ue_max(8192, "conf_win_right_offset"));
        int top = 2 * int(b.ue_max(8192, "conf_win_top_offset"));
        s.crop_bottom = 2 * int(b.ue_max(8192, "conf_win_bottom_offset"));
        if (left + s.crop_right >= s.width || top + s.crop_bottom >= s.height)
            fail(CORRUPT, "a conformance window larger than the picture");
        if (left || top) refuse("with a conformance window cropping the left or top");
    }
    int depth_luma = int(b.ue_max(8, "bit_depth_luma_minus8")) + 8;
    int depth_chroma = int(b.ue_max(8, "bit_depth_chroma_minus8")) + 8;
    // libavcodec outputs yuv420p, yuv420p9 and yuv420p10 (Main, Main 10); it
    // decodes no stream whose luma and chroma depths differ
    if (depth_luma != depth_chroma) refuse("with luma and chroma of different bit depths");
    if (depth_luma > 10) refuse("with a bit depth over 10");
    s.bit_depth = depth_luma;
    s.log2_max_poc_lsb = int(b.ue_max(12, "log2_max_pic_order_cnt_lsb_minus4")) + 4;
    bool ordering_all = b.flag();  // sps_sub_layer_ordering_info_present_flag
    for (int i = ordering_all ? 0 : max_sub_layers_minus1; i <= max_sub_layers_minus1; i++) {
        s.max_dec_pic_buffering = int(b.ue_max(15, "sps_max_dec_pic_buffering_minus1")) + 1;
        s.num_reorder = int(b.ue_max(15, "sps_max_num_reorder_pics"));
        s.max_latency_increase_plus1 = int(b.ue());
    }
    if (s.num_reorder > s.max_dec_pic_buffering - 1)
        fail(CORRUPT, "sps_max_num_reorder_pics %d over the DPB", s.num_reorder);
    s.log2_min_cb = int(b.ue_max(3, "log2_min_luma_coding_block_size_minus3")) + 3;
    s.log2_ctb = s.log2_min_cb + int(b.ue_max(3, "log2_diff_max_min_luma_coding_block_size"));
    s.log2_min_tb = int(b.ue_max(3, "log2_min_luma_transform_block_size_minus2")) + 2;
    s.log2_max_tb = s.log2_min_tb + int(b.ue_max(3, "log2_diff_max_min_luma_transform_block_size"));
    if (s.log2_ctb < 4 || s.log2_ctb > 6 || s.log2_max_tb > 5 || s.log2_max_tb > s.log2_ctb ||
        s.log2_min_tb >= s.log2_min_cb)
        fail(CORRUPT, "block sizes CTB %d, CB %d, TB %d-%d", 1 << s.log2_ctb, 1 << s.log2_min_cb,
             1 << s.log2_min_tb, 1 << s.log2_max_tb);
    if (s.width % (1 << s.log2_min_cb) || s.height % (1 << s.log2_min_cb))
        fail(CORRUPT, "a picture size not a multiple of the minimum coding block");
    s.max_th_depth_inter = int(b.ue_max(uint32_t(s.log2_ctb - s.log2_min_tb), "max_transform_hierarchy_depth_inter"));
    s.max_th_depth_intra = int(b.ue_max(uint32_t(s.log2_ctb - s.log2_min_tb), "max_transform_hierarchy_depth_intra"));
    if (b.flag()) refuse("with scaling lists");
    s.amp = b.flag();
    s.sao = b.flag();
    if (b.flag()) refuse("with PCM");
    int num_sets = int(b.ue_max(64, "num_short_term_ref_pic_sets"));
    for (int i = 0; i < num_sets; i++) s.rps.push_back(st_ref_pic_set(b, i, num_sets, s.rps));
    if (b.flag()) refuse("with long-term reference pictures");
    s.temporal_mvp = b.flag();
    s.strong_intra_smoothing = b.flag();
    if (b.flag()) {  // vui_parameters (E.2.1)
        if (b.flag() && b.u(8) == 255) b.u(32);  // aspect_ratio_info
        if (b.flag()) b.flag();                  // overscan
        if (b.flag()) {                          // video_signal_type
            b.u(3);
            s.full_range = b.flag();
            if (b.flag()) {  // colour_description
                int primaries = b.u(8), transfer = b.u(8);
                s.matrix = b.u(8);
                // what cv2 5.0.0 turns by other means than the matrix (libswscale
                // maps wide gamuts and these transfers, or fails), as h264.cpp refuses it
                if ((primaries >= 8 && primaries <= 12) || primaries == 22 || primaries > 23)
                    refuse("with colour_primaries other than BT.709/601/240M/FCC");
                if (transfer == 9 || transfer == 10 || transfer == 16 || transfer == 18 || transfer > 19)
                    refuse("with log, PQ or HLG transfer_characteristics");
                if (!host::yuv_matrix_supported(s.matrix))
                    refuse("with matrix_coefficients other than BT.601/709/FCC/240M/2020 NCL");
            }
        }
        if (b.flag()) {  // chroma_loc_info: libavcodec reports the top field's site, which
                         // libswscale's conversion reads beyond 8 bits
            s.chroma_loc = int(b.ue_max(5, "chroma_sample_loc_type_top_field"));
            b.ue_max(5, "chroma_sample_loc_type_bottom_field");
        }
        b.flag();  // neutral_chroma_indication_flag
        if (b.flag()) refuse("with field_seq_flag");
        b.flag();  // frame_field_info_present_flag
        if (b.flag())
            for (int i = 0; i < 4; i++) b.ue();  // default display window (libavcodec ignores it)
        if (b.flag()) {  // vui_timing_info
            b.u(32);
            b.u(32);
            if (b.flag()) b.ue();  // num_ticks_poc_diff_one_minus1
            if (b.flag()) hrd_parameters(b, true, max_sub_layers_minus1);
        }
        if (b.flag()) {  // bitstream_restriction
            b.flag();
            b.flag();
            b.flag();
            for (int i = 0; i < 5; i++) b.ue();
        }
    }
    if (b.flag()) {  // sps_extension_present_flag
        if (b.u(8)) refuse("with SPS extensions (range, multilayer, 3D, SCC)");
    }
    s.ctb_w = (s.width + (1 << s.log2_ctb) - 1) >> s.log2_ctb;
    s.ctb_h = (s.height + (1 << s.log2_ctb) - 1) >> s.log2_ctb;
    s.valid = true;
    return s;
}

Pps parse_pps(Bits& b, const Sps* sps_list, int* id) {
    Pps p;
    *id = int(b.ue_max(63, "pps_pic_parameter_set_id"));
    p.sps_id = int(b.ue_max(15, "pps_seq_parameter_set_id"));
    if (!sps_list[p.sps_id].valid) fail(CORRUPT, "a PPS of SPS %d, not received", p.sps_id);
    const Sps& s = sps_list[p.sps_id];
    p.dependent_slices = b.flag();
    p.output_flag_present = b.flag();
    p.num_extra_slice_header_bits = int(b.u(3));
    p.sign_data_hiding = b.flag();
    p.cabac_init_present = b.flag();
    p.num_ref_idx_default[0] = int(b.ue_max(14, "num_ref_idx_l0_default_active_minus1")) + 1;
    p.num_ref_idx_default[1] = int(b.ue_max(14, "num_ref_idx_l1_default_active_minus1")) + 1;
    p.init_qp = 26 + b.se_range(-26 - s.qp_offset(), 25, "init_qp_minus26");
    p.constrained_intra_pred = b.flag();
    p.transform_skip = b.flag();
    p.cu_qp_delta = b.flag();
    if (p.cu_qp_delta)
        p.diff_cu_qp_delta_depth = int(b.ue_max(uint32_t(s.log2_ctb - s.log2_min_cb), "diff_cu_qp_delta_depth"));
    p.cb_qp_offset = b.se_range(-12, 12, "pps_cb_qp_offset");
    p.cr_qp_offset = b.se_range(-12, 12, "pps_cr_qp_offset");
    p.slice_chroma_qp_offsets_present = b.flag();
    p.weighted_pred = b.flag();
    p.weighted_bipred = b.flag();
    if (b.flag()) refuse("with transquant bypass");
    if (b.flag()) refuse("with tiles");
    p.entropy_coding_sync = b.flag();
    p.loop_filter_across_slices = b.flag();
    if (b.flag()) {  // deblocking_filter_control_present_flag
        p.deblocking_override_enabled = b.flag();
        p.deblocking_disabled = b.flag();
        if (!p.deblocking_disabled) {
            p.beta_offset = 2 * b.se_range(-6, 6, "pps_beta_offset_div2");
            p.tc_offset = 2 * b.se_range(-6, 6, "pps_tc_offset_div2");
        }
    }
    if (b.flag()) refuse("with scaling lists");
    p.lists_modification_present = b.flag();
    p.log2_parallel_merge_level = int(b.ue_max(uint32_t(s.log2_ctb - 2), "log2_parallel_merge_level_minus2")) + 2;
    p.slice_header_extension = b.flag();
    if (b.flag()) {  // pps_extension_present_flag
        if (b.u(8)) refuse("with PPS extensions (range, multilayer, 3D, SCC)");
    }
    p.valid = true;
    return p;
}

// ---- NAL units ----------------------------------------------------------------

enum NalType {
    TRAIL_N = 0, TRAIL_R = 1, TSA_N = 2, TSA_R = 3, STSA_N = 4, STSA_R = 5, RADL_N = 6,
    RADL_R = 7, RASL_N = 8, RASL_R = 9, BLA_W_LP = 16, BLA_W_RADL = 17, BLA_N_LP = 18, IDR_W_RADL = 19,
    IDR_N_LP = 20, CRA_NUT = 21, VPS_NUT = 32, SPS_NUT = 33, PPS_NUT = 34, AUD_NUT = 35,
    EOS_NUT = 36, EOB_NUT = 37, FD_NUT = 38
};

// ---- pictures ---------------------------------------------------------------

struct Mv {
    int16_t x = 0, y = 0;
    bool operator==(const Mv& o) const { return x == o.x && y == o.y; }
    bool operator!=(const Mv& o) const { return !(*this == o); }
};

// the motion of a 4x4 block: what merge, AMVP, the deblocking filter and a
// later picture's TMVP read
struct Motion {
    Mv mv[2];
    int8_t ref_idx[2] = {-1, -1};
    int32_t ref_poc[2] = {0, 0};  // the POC of the picture ref_idx names in its slice's list
    uint8_t pred = 0;             // predFlagL0 | predFlagL1 << 1; 0: intra, or not decoded
    bool uses(int l) const { return (pred >> l) & 1; }
    // the same prediction flags, and the same vectors and reference indices where used
    bool same(const Motion& o) const {
        if (pred != o.pred) return false;
        for (int l = 0; l < 2; l++)
            if (uses(l) && (ref_idx[l] != o.ref_idx[l] || mv[l] != o.mv[l])) return false;
        return true;
    }
};

struct Frame {
    int w = 0, h = 0;  // pic_width/height_in_luma_samples
    std::vector<uint16_t> px[3];  // samples of the SPS's bit depth
    std::vector<Motion> motion;  // by 4x4 block, raster
    int poc = 0;
    bool ref = false, output = false;  // short-term reference; needed for output
    bool missing = false;  // generated for the RPS of an IRAP picture that opens decoding (8.3.3): no samples
    int latency = 0;                    // PicLatencyCount
    int64_t sample = -1;                // the sample it came in
    int crop_right = 0, crop_bottom = 0;
    bool full_range = false;
    int matrix = 2;
    int bit_depth = 8, chroma_loc = 0;
    uint16_t* plane(int c) { return px[c].data(); }
    int stride(int c) const { return c ? w / 2 : w; }
    const Motion& mot(int x, int y) const { return motion[size_t(y >> 2) * (w >> 2) + (x >> 2)]; }
};

struct Sao {
    uint8_t type[3] = {0, 0, 0};  // 0 not applied, 1 band, 2 edge
    uint8_t band[3] = {0, 0, 0};  // sao_band_position
    uint8_t eo_class[3] = {0, 0, 0};
    int8_t offset[3][5] = {{0}};  // SaoOffsetVal
};

struct Slice {
    int address = 0;  // slice_segment_address (SliceAddrRs: no dependent segments)
    int type = 2;     // 0 B, 1 P, 2 I
    bool pic_output = true;  // the picture's (pic_output_flag)
    bool temporal_mvp = false, sao_luma = false, sao_chroma = false;
    int num_ref[2] = {0, 0};
    int list[2][16];     // RefPicList0/1 as indices into the decoder's DPB
    int ref_poc[2][16];
    bool mvd_l1_zero = false, cabac_init = false;
    int collocated_list = 0, collocated_ref_idx = 0;
    bool no_backward = true;  // NoBackwardPredFlag: no reference after the picture in output order
    int max_merge = 5;
    int qp = 26, cb_qp_offset = 0, cr_qp_offset = 0;
    bool deblocking_disabled = false, lf_across = false;
    int beta_offset = 0, tc_offset = 0;
    int num_entry = 0;
    std::vector<int64_t> entry_size;
    // explicit weighted prediction: log2WD-6 denominators, weights, offsets by list and reference
    bool weighted = false;
    int luma_denom = 0, chroma_denom = 0;
    int lw[2][16], lo[2][16], cw[2][16][2], co[2][16][2];
};

// MinTbAddrZs at 4x4 granularity (6.5.2): the CTB's raster address, then
// the z-order of the 4x4 block within it
int zscan_in_ctb(int x4, int y4) {
    int z = 0;
    for (int i = 0; i < 4; i++) z |= (((x4 >> i) & 1) << (2 * i)) | (((y4 >> i) & 1) << (2 * i + 1));
    return z;
}

struct Decoder {
    int length_size = 0;
    Sps sps_list[16];
    Pps pps_list[64];
    Sps sps;  // active
    Pps pps;
    bool have_sps = false;  // a sequence was activated (size, depth and colour fixed)
    int bd = 8, maxv = 255, qp_off = 0;  // the active SPS's BitDepth, its largest sample, QpBdOffset
    bool started = false;   // an IRAP picture opened the stream (or the reset)
    bool broken = false;
    int prev_tid0_poc = 0;
    std::vector<std::shared_ptr<Frame>> dpb;
    std::shared_ptr<Frame> cur, out;
    std::deque<std::shared_ptr<Frame>> out_queue;
    int64_t cur_sample = -1;
    std::vector<uint8_t> rbsp;
    std::vector<int64_t> removed;

    // the current picture's slices and per-block state
    std::vector<Slice> slices;
    Slice* sh = nullptr;
    int w4 = 0, h4 = 0;
    std::vector<int32_t> zs;         // MinTbAddrZs by 4x4 block
    std::vector<int16_t> ctb_slice;  // index into slices by CTB, -1 before decoded
    std::vector<Sao> sao_params;     // by CTB
    struct Blk {                     // by 4x4 block
        uint8_t intra = 0, skip = 0, depth = 0, mode = 1, nz = 0;
        int8_t qp = 0;
        uint8_t edge_v = 0, edge_h = 0;  // its left / top edge: 1 transform, 2 prediction block edge
    };
    std::vector<Blk> blk;

    // CABAC and the slice data's state
    host::CabacEngine<Bits> cab;
    uint8_t ctx[NUM_CTX], wpp_ctx[NUM_CTX];
    int wpp_saved_row = -1;
    int ctb_addr = 0;
    int qp_y = 26, last_qp = 26, qp_pred = 26;
    bool qg_first = true;  // the first quantization group of the slice or CTB row (WPP)
    bool cu_qp_delta_coded = false;
    int cu_qp_delta = 0;
    int min_qg_log2 = 6;
    int intra_modes[4] = {1, 1, 1, 1}, chroma_mode = 1;
    bool cu_intra = false, cu_skip = false, merge_2nx2n = false;
    int part = 0;

    // -- parameter sets --------------------------------------------------------

    void parameter_set(const NalRef& nal, int type) {
        unescape(nal.p + 2, nal.n - 2, rbsp, nullptr);
        Bits b(rbsp.data(), int64_t(rbsp.size()));
        if (type == SPS_NUT) {
            int id;
            Sps s = parse_sps(b, &id);
            sps_list[id] = s;
        } else if (type == PPS_NUT) {
            int id;
            Pps p = parse_pps(b, sps_list, &id);
            pps_list[id] = p;
        }
    }

    // the NAL units of a sample: parameter sets read, slices decoded
    struct Nal {
        NalRef ref;
        int type, tid;
    };
    std::vector<Nal> nals_of(const uint8_t* d, int64_t n, int lsize) {
        std::vector<Nal> out;
        for (const NalRef& r : split_nals(d, n, lsize)) {
            if (r.n < 2) fail(CORRUPT, "a NAL unit of %lld byte", (long long)r.n);
            if (r.p[0] & 0x80) fail(CORRUPT, "forbidden_zero_bit set");
            int type = (r.p[0] >> 1) & 63, layer = ((r.p[0] & 1) << 5) | (r.p[1] >> 3), tid = (r.p[1] & 7) - 1;
            if (tid < 0) fail(CORRUPT, "nuh_temporal_id_plus1 0");
            if (layer) refuse("with nuh_layer_id over 0 (multi-layer streams)");
            out.push_back({r, type, tid});
        }
        return out;
    }

    static bool is_irap(int type) { return type >= 16 && type <= 23; }

    // read the parameter sets of a sample; whether it holds an IRAP picture
    bool headers(const uint8_t* d, int64_t n, int lsize) {
        bool irap = false;
        for (const Nal& nal : nals_of(d, n, lsize)) {
            if (nal.type == SPS_NUT || nal.type == PPS_NUT) parameter_set(nal.ref, nal.type);
            if (nal.type <= 31 && is_irap(nal.type)) irap = true;
        }
        return irap;
    }

    int64_t decode(const uint8_t* d, int64_t n, int64_t sample) {
        bool have_pic = false;
        cur_sample = sample;
        for (const Nal& nal : nals_of(d, n, length_size)) {
            int t = nal.type;
            if (t == SPS_NUT || t == PPS_NUT) {
                if (have_pic) finish_picture(), have_pic = false, cur_done = true;
                parameter_set(nal.ref, t);
            } else if (t == EOS_NUT || t == EOB_NUT) {
                refuse("with end of sequence or bitstream NAL units");
            } else if (t <= 31) {
                if (t > 21 || (t > 9 && t < 16)) continue;  // reserved: skipped as libavcodec skips them
                unescape(nal.ref.p + 2, nal.ref.n - 2, rbsp, &removed);
                Bits b(rbsp.data(), int64_t(rbsp.size()));
                slice_nal(b, t, nal.tid, &have_pic);
            }
            // VPS, SEI, access unit delimiters, filler data, reserved: skipped
        }
        if (have_pic) finish_picture();
        cur_done = false;
        return pop_output();
    }
    bool cur_done = false;  // the sample's picture ended before more parameter sets

    int64_t pop_output() {
        if (out_queue.empty()) return -1;
        out = out_queue.front();
        out_queue.pop_front();
        return out->sample;
    }

    // -- the slice segment header (7.3.6) ------------------------------------------

    static bool is_bla(int type) { return type >= BLA_W_LP && type <= BLA_N_LP; }
    static bool is_rasl(int type) { return type == RASL_N || type == RASL_R; }

    void slice_nal(Bits& b, int type, int tid, bool* have_pic) {
        bool first = b.flag();
        bool irap = is_irap(type), idr = type == IDR_W_RADL || type == IDR_N_LP;
        bool no_output_of_prior = irap ? b.flag() : false;
        int pps_id = int(b.ue_max(63, "slice_pic_parameter_set_id"));
        if (!pps_list[pps_id].valid) fail(CORRUPT, "a slice of PPS %d, not received", pps_id);
        if (first) {
            stale_first = false;
            skipping = false;
            if (*have_pic || cur_done) refuse("with more than one picture a sample");
            if (!started && !irap) refuse("streams that do not start with an IRAP picture");
            activate(pps_list[pps_id]);
        } else {
            if (skipping) return;  // a slice of a RASL picture left out
            if (!*have_pic) fail(CORRUPT, "a slice segment without the picture's first");
            if (pps_id != active_pps_id) fail(CORRUPT, "slices of one picture under two PPSs");
        }
        Slice s;
        const Sps& S = sps;
        const Pps& P = pps;
        if (!first) {
            if (P.dependent_slices && b.flag()) refuse("dependent slice segments");
            int bits_n = 0;
            while ((1 << bits_n) < S.ctb_w * S.ctb_h) bits_n++;
            s.address = int(b.u(bits_n));
            if (s.address >= S.ctb_w * S.ctb_h || s.address <= ctb_addr_last)
                fail(CORRUPT, "slice_segment_address %d out of order", s.address);
        }
        b.u(P.num_extra_slice_header_bits);
        s.type = int(b.ue_max(2, "slice_type"));
        if (irap && s.type != 2) fail(CORRUPT, "an IRAP picture with a P or B slice");
        if (P.output_flag_present) s.pic_output = b.flag();
        int poc_lsb = 0;
        StRps rps;
        if (!idr) {
            poc_lsb = int(b.u(S.log2_max_poc_lsb));
            bool sps_set = b.flag();
            int n = int(S.rps.size());
            if (!sps_set) {
                rps = st_ref_pic_set(b, n, n, S.rps);
            } else {
                if (!n) fail(CORRUPT, "short_term_ref_pic_set_sps_flag without sets in the SPS");
                int bits_n = 0;
                while ((1 << bits_n) < n) bits_n++;
                int idx = int(b.u(bits_n));
                if (idx >= n) fail(CORRUPT, "short_term_ref_pic_set_idx %d", idx);
                rps = S.rps[size_t(idx)];
            }
            if (S.temporal_mvp) s.temporal_mvp = b.flag();
        }
        if (first) {
            int poc = picture_order(type, poc_lsb);
            // libavcodec's max_ra: the RASL pictures of a CRA or BLA picture
            // that opens decoding (the stream's first, after a seek's flush, or
            // any BLA) are neither decoded nor output
            if (idr || is_bla(type)) max_ra = INT_MAX;
            if (max_ra == INT_MAX) {
                if (type == CRA_NUT || is_bla(type)) max_ra = poc;
                else if (idr) max_ra = INT_MIN;
            }
            if (is_rasl(type) && poc <= max_ra) {
                skipping = true;
                return;
            }
            if (type == RASL_R && poc > max_ra) max_ra = INT_MIN;
            start_picture(type, tid, poc, rps, s.pic_output, no_output_of_prior);
        }
        if (S.sao) {
            s.sao_luma = b.flag();
            s.sao_chroma = b.flag();
        }
        if (s.type != 2) {
            int nl = s.type == 0 ? 2 : 1;
            s.num_ref[0] = P.num_ref_idx_default[0];
            if (nl == 2) s.num_ref[1] = P.num_ref_idx_default[1];
            if (b.flag()) {  // num_ref_idx_active_override_flag
                s.num_ref[0] = int(b.ue_max(14, "num_ref_idx_l0_active_minus1")) + 1;
                if (nl == 2) s.num_ref[1] = int(b.ue_max(14, "num_ref_idx_l1_active_minus1")) + 1;
            }
            int total = int(curr_before.size() + curr_after.size());
            if (!total) fail(CORRUPT, "a P or B slice without reference pictures");
            int entries[2][16];
            bool modified[2] = {false, false};
            if (P.lists_modification_present && total > 1) {
                int bits_n = 0;
                while ((1 << bits_n) < total) bits_n++;
                for (int l = 0; l < nl; l++) {
                    modified[l] = b.flag();
                    if (modified[l])
                        for (int i = 0; i < s.num_ref[l]; i++) {
                            entries[l][i] = int(b.u(bits_n));
                            if (entries[l][i] >= total) fail(CORRUPT, "list_entry_l%d %d", l, entries[l][i]);
                        }
                }
            }
            // RefPicList0 (8.3.4): StCurrBefore then StCurrAfter, repeated;
            // RefPicList1: StCurrAfter then StCurrBefore
            for (int l = 0; l < nl; l++) {
                int temp[32], nt = std::max(s.num_ref[l], total), k = 0;
                const std::vector<int>& a = l ? curr_after : curr_before;
                const std::vector<int>& c = l ? curr_before : curr_after;
                while (k < nt) {
                    for (int v : a)
                        if (k < nt) temp[k++] = v;
                    for (int v : c)
                        if (k < nt) temp[k++] = v;
                }
                for (int i = 0; i < s.num_ref[l]; i++) {
                    s.list[l][i] = temp[modified[l] ? entries[l][i] : i];
                    const Frame& r = *dpb[size_t(s.list[l][i])];
                    if (r.missing) fail(CORRUPT, "a reference picture of POC %d missing", r.poc);
                    s.ref_poc[l][i] = r.poc;
                    if (r.poc > cur->poc) s.no_backward = false;
                }
            }
            if (nl == 2) s.mvd_l1_zero = b.flag();
            if (P.cabac_init_present) s.cabac_init = b.flag();
            if (s.temporal_mvp) {
                if (nl == 2) s.collocated_list = b.flag() ? 0 : 1;  // collocated_from_l0_flag
                if (s.num_ref[s.collocated_list] > 1)
                    s.collocated_ref_idx =
                        int(b.ue_max(uint32_t(s.num_ref[s.collocated_list] - 1), "collocated_ref_idx"));
            }
            if ((P.weighted_pred && s.type == 1) || (P.weighted_bipred && s.type == 0)) pred_weight_table(b, s);
            s.max_merge = 5 - int(b.ue_max(4, "five_minus_max_num_merge_cand"));
        }
        s.qp = P.init_qp + b.se_range(-qp_off - P.init_qp, 51 - P.init_qp, "slice_qp_delta");
        if (P.slice_chroma_qp_offsets_present) {
            s.cb_qp_offset = b.se_range(-12, 12, "slice_cb_qp_offset");
            s.cr_qp_offset = b.se_range(-12, 12, "slice_cr_qp_offset");
            if (std::abs(P.cb_qp_offset + s.cb_qp_offset) > 12 || std::abs(P.cr_qp_offset + s.cr_qp_offset) > 12)
                fail(CORRUPT, "chroma QP offsets beyond 12");
        }
        // libavcodec keeps the offsets of the last slice header that set them
        // where an override disables the filter: they still steer its
        // neighbours' chroma edges (deblock_ctb)
        s.deblocking_disabled = P.deblocking_disabled;
        s.beta_offset = P.beta_offset;
        s.tc_offset = P.tc_offset;
        if (P.deblocking_override_enabled && b.flag()) {
            s.deblocking_disabled = b.flag();
            if (!s.deblocking_disabled) {
                s.beta_offset = 2 * b.se_range(-6, 6, "slice_beta_offset_div2");
                s.tc_offset = 2 * b.se_range(-6, 6, "slice_tc_offset_div2");
            } else {
                s.beta_offset = last_beta;
                s.tc_offset = last_tc;
                if (first) stale_first = true;
            }
        }
        if (!first && stale_first && !s.deblocking_disabled)
            refuse("with a picture's first slice disabling deblocking and a later one enabling it "
                   "(libavcodec's filter then reads an earlier picture's offsets)");
        last_beta = s.beta_offset;
        last_tc = s.tc_offset;
        s.lf_across = P.loop_filter_across_slices;
        if (P.loop_filter_across_slices && (s.sao_luma || s.sao_chroma || !s.deblocking_disabled))
            s.lf_across = b.flag();
        if (P.entropy_coding_sync) {
            s.num_entry = int(b.ue_max(uint32_t(S.ctb_h - 1), "num_entry_point_offsets"));
            if (s.num_entry) {
                int len = int(b.ue_max(31, "offset_len_minus1")) + 1;
                for (int i = 0; i < s.num_entry; i++) s.entry_size.push_back(int64_t(b.u(len)) + 1);
            }
        }
        if (P.slice_header_extension) {
            int n = int(b.ue_max(256, "slice_segment_header_extension_length"));
            b.skip(8 * n);
        }
        if (!b.flag()) fail(CORRUPT, "a slice header without its alignment bit");  // byte_alignment()
        while (b.pos & 7)
            if (b.flag()) fail(CORRUPT, "a slice header's alignment bits not zero");
        *have_pic = true;
        slices.push_back(s);
        sh = &slices.back();
        slice_data(b);
    }
    bool skipping = false;  // the picture is a RASL picture left out
    int max_ra = INT_MAX;

    void pred_weight_table(Bits& b, Slice& s) {
        s.weighted = true;
        s.luma_denom = int(b.ue_max(7, "luma_log2_weight_denom"));
        s.chroma_denom = s.luma_denom + b.se();
        if (s.chroma_denom < 0 || s.chroma_denom > 7) fail(CORRUPT, "ChromaLog2WeightDenom %d", s.chroma_denom);
        for (int l = 0; l < (s.type == 0 ? 2 : 1); l++) {
            bool lf[16], cf[16];
            for (int i = 0; i < s.num_ref[l]; i++) lf[i] = b.flag();
            for (int i = 0; i < s.num_ref[l]; i++) cf[i] = b.flag();
            for (int i = 0; i < s.num_ref[l]; i++) {
                s.lw[l][i] = 1 << s.luma_denom;
                s.lo[l][i] = 0;
                if (lf[i]) {
                    s.lw[l][i] += b.se_range(-128, 127, "delta_luma_weight");
                    s.lo[l][i] = b.se_range(-128, 127, "luma_offset");
                }
                for (int j = 0; j < 2; j++) {
                    s.cw[l][i][j] = 1 << s.chroma_denom;
                    s.co[l][i][j] = 0;
                    if (cf[i]) {
                        s.cw[l][i][j] += b.se_range(-128, 127, "delta_chroma_weight");
                        int delta = b.se_range(-512, 511, "delta_chroma_offset");
                        s.co[l][i][j] = clip3(-128, 127, (128 + delta - ((128 * s.cw[l][i][j]) >> s.chroma_denom)));
                    }
                }
            }
        }
    }

    // -- a picture's start: parameter sets, POC, RPS, the DPB (8.1.3, 8.3, C.5.2) --------

    int active_pps_id = -1;
    int last_beta = 0, last_tc = 0;  // libavcodec's slice header fields, kept across headers
    bool stale_first = false;        // the picture's first slice disabled deblocking by override
    int ctb_addr_last = -1;
    std::vector<int> curr_before, curr_after;  // RefPicSetStCurrBefore/After as DPB indices

    void activate(const Pps& p) {
        const Sps& s = sps_list[p.sps_id];
        if (!s.valid) fail(CORRUPT, "a PPS of SPS %d, not received", p.sps_id);
        if (have_sps && (s.width != sps.width || s.height != sps.height ||
                         s.crop_right != sps.crop_right || s.crop_bottom != sps.crop_bottom))
            refuse("with a picture size that changes");
        if (have_sps && (s.full_range != sps.full_range || s.matrix != sps.matrix ||
                         (s.bit_depth > 8 && s.chroma_loc != sps.chroma_loc)))
            refuse("with a colour range, matrix or chroma site that changes");
        if (have_sps && s.bit_depth != sps.bit_depth) refuse("with a bit depth that changes");
        sps = s;
        bd = s.bit_depth;
        maxv = (1 << bd) - 1;
        qp_off = s.qp_offset();
        pps = p;
        have_sps = true;
        for (int i = 0; i < 64; i++)
            if (&pps_list[i] == &p) active_pps_id = i;
    }

    // PicOrderCntVal (8.3.1): PicOrderCntMsb 0 for an IRAP picture with
    // NoRaslOutputFlag (an IDR or BLA picture, a CRA picture that opens
    // decoding), else from prevTid0Pic
    int picture_order(int type, int poc_lsb) const {
        bool idr = type == IDR_W_RADL || type == IDR_N_LP;
        if (idr || is_bla(type) || (type == CRA_NUT && !started)) return poc_lsb;
        int max_lsb = 1 << sps.log2_max_poc_lsb;
        int prev_lsb = prev_tid0_poc & (max_lsb - 1), prev_msb = prev_tid0_poc - prev_lsb;
        if (poc_lsb < prev_lsb && prev_lsb - poc_lsb >= max_lsb / 2) return prev_msb + max_lsb + poc_lsb;
        if (poc_lsb > prev_lsb && poc_lsb - prev_lsb > max_lsb / 2) return prev_msb - max_lsb + poc_lsb;
        return prev_msb + poc_lsb;
    }

    void start_picture(int type, int tid, int poc, const StRps& rps, bool pic_output, bool no_output_of_prior) {
        bool irap = is_irap(type), idr = type == IDR_W_RADL || type == IDR_N_LP;
        // NoRaslOutputFlag: every IDR and BLA picture, and a CRA picture that
        // opens the stream or follows a reset
        bool no_rasl = irap && (idr || is_bla(type) || !started);
        // prevTid0Pic: not a RASL, RADL or sub-layer non-reference picture
        bool sub_layer_nonref = (type <= 14 && !(type & 1)) || (type >= RADL_N && type <= RASL_R);
        if (tid == 0 && !sub_layer_nonref) prev_tid0_poc = poc;
        // RPS marking (8.3.2): what the set does not name is no longer a
        // reference; after an IRAP picture with NoRaslOutputFlag none is, and
        // the pictures its set names are generated, without samples (8.3.3)
        curr_before.clear();
        curr_after.clear();
        // libavcodec drops an IDR picture whose POC equals that of a picture
        // still generated for the RPS of the CRA or BLA picture that opened
        // decoding (a duplicate POC): it and what follows read otherwise
        if (idr)
            for (auto& f : dpb)
                if (f->missing && f->poc == poc)
                    refuse("with an IDR picture of the POC of a picture generated for the RPS of the "
                           "CRA or BLA picture that opened decoding (ROADMAP Queue 3 item 27)");
        if (no_rasl) {
            for (auto& f : dpb) f->ref = false;
        } else {
            std::vector<bool> keep(dpb.size(), false);
            for (int i = 0; i < rps.count(); i++) {
                int want = poc + rps.delta_poc[i];
                int found = -1;
                for (size_t k = 0; k < dpb.size(); k++)
                    if (dpb[k]->ref && dpb[k]->poc == want) found = int(k);
                if (found >= 0) keep[size_t(found)] = true;
                if (rps.used[i]) {
                    if (found < 0) fail(CORRUPT, "reference picture of POC %d missing", want);
                    (i < rps.num_negative ? curr_before : curr_after).push_back(found);
                }
            }
            for (size_t k = 0; k < dpb.size(); k++) dpb[k]->ref = keep[k];
        }
        // C.5.2.2: output and removal of pictures before the current one
        if (irap && no_rasl && started) {
            if (no_output_of_prior) {
                for (auto& f : dpb) f->output = false;
            } else {
                while (bump()) {
                }
            }
        }
        compact_dpb();
        if (no_rasl && !idr)
            for (int i = 0; i < rps.count(); i++) {
                if (rps.used[i]) fail(CORRUPT, "an IRAP picture predicted from another");
                auto g = std::make_shared<Frame>();
                g->poc = poc + rps.delta_poc[i];
                g->ref = g->missing = true;
                dpb.push_back(g);
            }
        while (true) {
            int waiting = 0, late = 0;
            for (auto& f : dpb) {
                waiting += f->output;
                late += f->output && sps.max_latency_increase_plus1 &&
                        f->latency >= sps.num_reorder + sps.max_latency_increase_plus1 - 1;
            }
            if (!(waiting > sps.num_reorder || late || int(dpb.size()) >= sps.max_dec_pic_buffering)) break;
            if (!bump()) break;
            compact_dpb();
        }
        started = true;
        // the current picture
        cur = std::make_shared<Frame>();
        Frame& f = *cur;
        f.w = sps.width;
        f.h = sps.height;
        for (int c = 0; c < 3; c++) f.px[c].assign(size_t(f.stride(c)) * (c ? f.h / 2 : f.h), 0);
        f.motion.assign(size_t(f.w / 4) * (f.h / 4), Motion());
        f.poc = poc;
        f.sample = cur_sample;
        f.crop_right = sps.crop_right;
        f.crop_bottom = sps.crop_bottom;
        f.full_range = sps.full_range;
        f.matrix = sps.matrix;
        f.bit_depth = sps.bit_depth;
        f.chroma_loc = sps.chroma_loc;
        f.output = pic_output;
        // the picture's per-block state
        slices.clear();
        slices.reserve(size_t(sps.ctb_w * sps.ctb_h));
        w4 = f.w / 4;
        h4 = f.h / 4;
        blk.assign(size_t(w4) * h4, Blk());
        ctb_slice.assign(size_t(sps.ctb_w * sps.ctb_h), -1);
        sao_params.assign(size_t(sps.ctb_w * sps.ctb_h), Sao());
        zs.resize(size_t(w4) * h4);
        int cm = (1 << (sps.log2_ctb - 2)) - 1;
        for (int y = 0; y < h4; y++)
            for (int x = 0; x < w4; x++)
                zs[size_t(y) * w4 + x] =
                    (((y >> (sps.log2_ctb - 2)) * sps.ctb_w + (x >> (sps.log2_ctb - 2))) << (2 * (sps.log2_ctb - 2))) +
                    zscan_in_ctb(x & cm, y & cm);
        ctb_addr_last = -1;
    }

    void compact_dpb() {
        std::vector<std::shared_ptr<Frame>> keep;
        std::vector<int> map(dpb.size(), -1);
        for (size_t k = 0; k < dpb.size(); k++)
            if (dpb[k]->ref || dpb[k]->output) {
                map[k] = int(keep.size());
                keep.push_back(dpb[k]);
            }
        for (int& v : curr_before) v = map[size_t(v)];
        for (int& v : curr_after) v = map[size_t(v)];
        dpb.swap(keep);
    }

    // the "bumping" process (C.5.2.4): the waiting picture of the smallest POC out
    bool bump() {
        Frame* best = nullptr;
        std::shared_ptr<Frame> pick;
        for (auto& f : dpb)
            if (f->output && (!best || f->poc < best->poc)) {
                best = f.get();
                pick = f;
            }
        if (!best) return false;
        best->output = false;
        out_queue.push_back(pick);
        return true;
    }

    void finish_picture() {
        if (!cur) return;
        for (int a = 0; a < sps.ctb_w * sps.ctb_h; a++)
            if (ctb_slice[size_t(a)] < 0) fail(CORRUPT, "a picture with CTBs missing");
        loop_filters();
        // C.5.2.3: the current picture into the DPB, then the additional bumping
        for (auto& f : dpb)
            if (f->output) f->latency++;
        cur->ref = true;
        cur->latency = 0;
        dpb.push_back(cur);
        cur.reset();
        while (true) {
            int waiting = 0, late = 0;
            for (auto& f : dpb) {
                waiting += f->output;
                late += f->output && sps.max_latency_increase_plus1 &&
                        f->latency >= sps.num_reorder + sps.max_latency_increase_plus1 - 1;
            }
            if (!(waiting > sps.num_reorder || late)) break;
            if (!bump()) break;
        }
    }

    int64_t drain() {
        if (out_queue.empty()) bump();
        return pop_output();
    }

    void reset() {  // a seek: libavcodec's flush (the parameter sets stay)
        dpb.clear();
        cur.reset();
        out.reset();
        out_queue.clear();
        started = false;
        prev_tid0_poc = 0;
        cur_done = false;
        max_ra = INT_MAX;
    }

    // -- slice data (7.3.8.1) --------------------------------------------------------

    Blk& B(int x, int y) { return blk[size_t(y >> 2) * w4 + (x >> 2)]; }
    int dec(int c) { return cab.decide(ctx[c]); }
    int byp() { return cab.bypass(); }

    // z-scan order availability (6.4.1) of luma location (xn, yn) from (xc, yc):
    // inside the picture, decoded before it, in the same slice
    bool avail(int xc, int yc, int xn, int yn) const {
        if (xn < 0 || yn < 0 || xn >= sps.width || yn >= sps.height) return false;
        if (zs[size_t(yn >> 2) * w4 + (xn >> 2)] > zs[size_t(yc >> 2) * w4 + (xc >> 2)]) return false;
        int a = (yn >> sps.log2_ctb) * sps.ctb_w + (xn >> sps.log2_ctb);
        int c = (yc >> sps.log2_ctb) * sps.ctb_w + (xc >> sps.log2_ctb);
        return ctb_slice[size_t(a)] >= 0 && ctb_slice[size_t(a)] == ctb_slice[size_t(c)];
    }

    void init_contexts() {
        // initType (9.3.2.2): 0 I; P 1, or 2 with cabac_init_flag; B 2, or 1 with it
        int init_type = sh->type == 2 ? 0 : (sh->type == 1) == sh->cabac_init ? 2 : 1;
        int q = clip3(0, 51, sh->qp);
        for (int i = 0; i < NUM_CTX; i++) {
            int v = CTX_INIT[init_type][i];
            ctx[i] = host::cabac_state((v >> 4) * 5 - 45, ((v & 15) << 3) - 16, q);
        }
    }

    void start_engine(Bits& b) {
        if (!cab.start(b)) fail(CORRUPT, "a CABAC ivlOffset of %u", cab.offset);
    }

    // the byte of the NAL unit (after its header) that RBSP byte r was
    int64_t nal_byte(int64_t r, bool with_one_before) const {
        int64_t n = 0;
        for (int64_t e : removed) n += e < r || (with_one_before && e == r);
        return r + n;
    }

    void slice_data(Bits& b) {
        const Sps& S = sps;
        int n_ctb = S.ctb_w * S.ctb_h;
        int slice_idx = int(slices.size()) - 1;
        int64_t data_start = b.pos >> 3, expect = 0;
        init_contexts();
        start_engine(b);
        last_qp = qp_y = sh->qp;
        qg_first = true;
        min_qg_log2 = S.log2_ctb - pps.diff_cu_qp_delta_depth;
        int substream = 0;
        ctb_addr = sh->address;
        for (;;) {
            int rx = ctb_addr % S.ctb_w, ry = ctb_addr / S.ctb_w;
            if (ctb_slice[size_t(ctb_addr)] >= 0) fail(CORRUPT, "CTB %d decoded twice", ctb_addr);
            ctb_slice[size_t(ctb_addr)] = int16_t(slice_idx);
            if (pps.entropy_coding_sync && rx == 0) qg_first = true;
            if (sh->sao_luma || sh->sao_chroma) sao_syntax(rx, ry);
            coding_quadtree(rx << S.log2_ctb, ry << S.log2_ctb, S.log2_ctb, 0);
            bool end = cab.terminate();  // end_of_slice_segment_flag
            ctb_addr_last = ctb_addr;
            ctb_addr++;
            if (pps.entropy_coding_sync && rx == 1) {  // the storage process after a row's second CTU
                memcpy(wpp_ctx, ctx, sizeof ctx);
                wpp_saved_row = ry;
                wpp_saved_slice = slice_idx;
            }
            if (end) break;
            if (ctb_addr >= n_ctb) fail(CORRUPT, "a slice past the picture's end");
            if (pps.entropy_coding_sync && ctb_addr % S.ctb_w == 0) {
                if (!cab.terminate()) fail(CORRUPT, "end_of_subset_one_bit 0");
                b.align();  // byte_alignment(): the flush's last bit was its one
                if (substream >= sh->num_entry) fail(CORRUPT, "more substreams than entry points");
                expect += sh->entry_size[size_t(substream)];
                // entry_point_offset_minus1 counts the emulation prevention bytes
                int64_t lo = nal_byte(b.pos >> 3, false) - nal_byte(data_start, true);
                int64_t hi = nal_byte(b.pos >> 3, true) - nal_byte(data_start, false);
                if (expect < lo || expect > hi)
                    fail(CORRUPT, "entry point %d at byte %lld of the slice data, not %lld", substream,
                         (long long)expect, (long long)lo);
                substream++;
                // the synchronisation (9.3.1): from the CTU above-right if it is in the slice
                if (S.ctb_w > 1 && wpp_saved_row == ctb_addr / S.ctb_w - 1 && wpp_saved_slice == slice_idx)
                    memcpy(ctx, wpp_ctx, sizeof ctx);
                else
                    init_contexts();
                start_engine(b);
            }
        }
        if (substream != sh->num_entry) fail(CORRUPT, "%d entry points for %d substreams", sh->num_entry, substream + 1);
    }
    int wpp_saved_slice = -1;

    // sao() (7.3.8.3)
    void sao_syntax(int rx, int ry) {
        int a = ctb_addr, W = sps.ctb_w;
        Sao& p = sao_params[size_t(a)];
        bool merge_left = false, merge_up = false;
        if (rx > 0 && a - 1 >= sh->address) merge_left = dec(SAO_MERGE);
        if (ry > 0 && !merge_left && a - W >= sh->address) merge_up = dec(SAO_MERGE);
        if (merge_left || merge_up) {
            p = sao_params[size_t(merge_left ? a - 1 : a - W)];
            return;
        }
        for (int c = 0; c < 3; c++) {
            if (!(c ? sh->sao_chroma : sh->sao_luma)) {
                p.type[c] = 0;
                continue;
            }
            if (c < 2) p.type[c] = !dec(SAO_TYPE) ? 0 : !byp() ? 1 : 2;
            else p.type[2] = p.type[1];
            if (!p.type[c]) continue;
            int abs_v[4];
            int cmax = (1 << (std::min(bd, 10) - 5)) - 1;  // sao_offset_abs: TR, cMax by the bit depth
            for (int i = 0; i < 4; i++) {
                int v = 0;
                while (v < cmax && byp()) v++;
                abs_v[i] = v;
            }
            if (p.type[c] == 1) {
                for (int i = 0; i < 4; i++) p.offset[c][i + 1] = int8_t(abs_v[i] && byp() ? -abs_v[i] : abs_v[i]);
                int band = 0;
                for (int i = 0; i < 5; i++) band = (band << 1) | byp();
                p.band[c] = uint8_t(band);
            } else {
                if (c < 2) p.eo_class[c] = uint8_t((byp() << 1) | byp());
                else p.eo_class[2] = p.eo_class[1];
                p.offset[c][1] = int8_t(abs_v[0]);
                p.offset[c][2] = int8_t(abs_v[1]);
                p.offset[c][3] = int8_t(-abs_v[2]);
                p.offset[c][4] = int8_t(-abs_v[3]);
            }
            p.offset[c][0] = 0;
        }
    }

    // -- coding quadtree and coding unit (7.3.8.4-7.3.8.5) ------------------------------

    enum Part { PART_2Nx2N, PART_2NxN, PART_Nx2N, PART_NxN, PART_2NxnU, PART_2NxnD, PART_nLx2N, PART_nRx2N };

    void start_qg(int x0, int y0) {  // a quantization group: qPY_PRED (8.6.1)
        int prev = qg_first ? sh->qp : last_qp;
        qg_first = false;
        int mask = (1 << sps.log2_ctb) - 1;
        int qa = (x0 & mask) ? B(x0 - 1, y0).qp : prev;
        int qb = (y0 & mask) ? B(x0, y0 - 1).qp : prev;
        qp_pred = (qa + qb + 1) >> 1;
        cu_qp_delta_coded = false;
        cu_qp_delta = 0;
    }

    void coding_quadtree(int x0, int y0, int log2, int depth) {
        const Sps& S = sps;
        int size = 1 << log2;
        bool split;
        if (x0 + size <= S.width && y0 + size <= S.height && log2 > S.log2_min_cb) {
            int c = (avail(x0, y0, x0 - 1, y0) && B(x0 - 1, y0).depth > depth) +
                    (avail(x0, y0, x0, y0 - 1) && B(x0, y0 - 1).depth > depth);
            split = dec(SPLIT_CU + c);
        } else {
            split = log2 > S.log2_min_cb;
        }
        if (log2 == min_qg_log2 || (log2 > min_qg_log2 && !split)) start_qg(x0, y0);
        if (split) {
            int h = size >> 1;
            coding_quadtree(x0, y0, log2 - 1, depth + 1);
            if (x0 + h < S.width) coding_quadtree(x0 + h, y0, log2 - 1, depth + 1);
            if (y0 + h < S.height) coding_quadtree(x0, y0 + h, log2 - 1, depth + 1);
            if (x0 + h < S.width && y0 + h < S.height) coding_quadtree(x0 + h, y0 + h, log2 - 1, depth + 1);
        } else {
            coding_unit(x0, y0, log2, depth);
        }
    }

    // QpY from qPY_PRED + CuQpDeltaVal (8.6.1)
    int wrap_qp(int v) const { return (v + 52 + 2 * qp_off) % (52 + qp_off) - qp_off; }

    template <class F>
    void each_blk(int x0, int y0, int w, int h, F&& f) {
        for (int y = y0; y < y0 + h; y += 4)
            for (int x = x0; x < x0 + w; x += 4) f(B(x, y));
    }

    int part_mode(int log2) {
        if (dec(PART_MODE)) return PART_2Nx2N;
        if (log2 == sps.log2_min_cb) {
            if (cu_intra) return PART_NxN;
            if (dec(PART_MODE + 1)) return PART_2NxN;
            if (log2 == 3) return PART_Nx2N;
            return dec(PART_MODE + 2) ? PART_Nx2N : PART_NxN;
        }
        if (!sps.amp) return dec(PART_MODE + 1) ? PART_2NxN : PART_Nx2N;
        if (dec(PART_MODE + 1)) {
            if (dec(PART_MODE + 3)) return PART_2NxN;
            return byp() ? PART_2NxnD : PART_2NxnU;
        }
        if (dec(PART_MODE + 3)) return PART_Nx2N;
        return byp() ? PART_nRx2N : PART_nLx2N;
    }

    void coding_unit(int x0, int y0, int log2, int depth) {
        const Sps& S = sps;
        int size = 1 << log2;
        cu_skip = false;
        cu_intra = sh->type == 2;
        part = PART_2Nx2N;
        merge_2nx2n = false;
        qp_y = wrap_qp(qp_pred + cu_qp_delta);
        if (sh->type != 2) {
            int c = (avail(x0, y0, x0 - 1, y0) && B(x0 - 1, y0).skip) + (avail(x0, y0, x0, y0 - 1) && B(x0, y0 - 1).skip);
            cu_skip = dec(CU_SKIP + c);
        }
        each_blk(x0, y0, size, size, [&](Blk& b) {
            b = Blk();
            b.depth = uint8_t(depth);
            b.skip = cu_skip;
            b.qp = int8_t(qp_y);
        });
        bool transform = false;
        if (cu_skip) {
            prediction_unit(x0, y0, log2, x0, y0, size, size, 0);
        } else {
            if (sh->type != 2) cu_intra = dec(PRED_MODE);
            if (!cu_intra || log2 == S.log2_min_cb) part = part_mode(log2);
            each_blk(x0, y0, size, size, [&](Blk& b) { b.intra = cu_intra; });
            if (cu_intra) {
                intra_modes_syntax(x0, y0, log2);
            } else {
                int h = size / 2, q = size / 4;
                switch (part) {
                    case PART_2Nx2N: prediction_unit(x0, y0, log2, x0, y0, size, size, 0); break;
                    case PART_2NxN:
                        prediction_unit(x0, y0, log2, x0, y0, size, h, 0);
                        prediction_unit(x0, y0, log2, x0, y0 + h, size, h, 1);
                        break;
                    case PART_Nx2N:
                        prediction_unit(x0, y0, log2, x0, y0, h, size, 0);
                        prediction_unit(x0, y0, log2, x0 + h, y0, h, size, 1);
                        break;
                    case PART_2NxnU:
                        prediction_unit(x0, y0, log2, x0, y0, size, q, 0);
                        prediction_unit(x0, y0, log2, x0, y0 + q, size, size - q, 1);
                        break;
                    case PART_2NxnD:
                        prediction_unit(x0, y0, log2, x0, y0, size, size - q, 0);
                        prediction_unit(x0, y0, log2, x0, y0 + size - q, size, q, 1);
                        break;
                    case PART_nLx2N:
                        prediction_unit(x0, y0, log2, x0, y0, q, size, 0);
                        prediction_unit(x0, y0, log2, x0 + q, y0, size - q, size, 1);
                        break;
                    case PART_nRx2N:
                        prediction_unit(x0, y0, log2, x0, y0, size - q, size, 0);
                        prediction_unit(x0, y0, log2, x0 + size - q, y0, q, size, 1);
                        break;
                    default:  // PART_NxN
                        prediction_unit(x0, y0, log2, x0, y0, h, h, 0);
                        prediction_unit(x0, y0, log2, x0 + h, y0, h, h, 1);
                        prediction_unit(x0, y0, log2, x0, y0 + h, h, h, 2);
                        prediction_unit(x0, y0, log2, x0 + h, y0 + h, h, h, 3);
                }
            }
            bool root_cbf = true;
            if (!cu_intra && !(part == PART_2Nx2N && merge_2nx2n)) root_cbf = dec(RQT_ROOT_CBF);
            if (root_cbf) {
                int max_depth = cu_intra ? S.max_th_depth_intra + (part == PART_NxN) : S.max_th_depth_inter;
                transform_tree(x0, y0, x0, y0, log2, 0, 0, max_depth, false, false);
                transform = true;
            }
        }
        if (!transform) mark_tu(x0, y0, size, false);
        each_blk(x0, y0, size, size, [&](Blk& b) { b.qp = int8_t(qp_y); });
        last_qp = qp_y;
    }

    void mark_tu(int x0, int y0, int size, bool nz) {
        each_blk(x0, y0, size, size, [&](Blk& b) { b.nz = nz; });
        for (int k = 0; k < size; k += 4) {
            if (y0 + k < sps.height) B(x0, y0 + k).edge_v |= 1;
            if (x0 + k < sps.width) B(x0 + k, y0).edge_h |= 1;
        }
    }

    // intra luma modes of the CU's prediction blocks (8.4.2) and its chroma mode (8.4.3)
    void intra_modes_syntax(int x0, int y0, int log2) {
        int n = part == PART_NxN ? 4 : 1, pb = part == PART_NxN ? (1 << log2) / 2 : 1 << log2;
        bool prev[4];
        for (int i = 0; i < n; i++) prev[i] = dec(PREV_INTRA);
        for (int i = 0; i < n; i++) {
            int x = x0 + (i & 1) * pb, y = y0 + (i >> 1) * pb;
            int a = avail(x, y, x - 1, y) && B(x - 1, y).intra ? B(x - 1, y).mode : 1;
            int bm = 1;
            if (avail(x, y, x, y - 1) && B(x, y - 1).intra && ((y - 1) >> sps.log2_ctb) == (y >> sps.log2_ctb))
                bm = B(x, y - 1).mode;
            int cand[3];
            if (a == bm) {
                if (a < 2) {
                    cand[0] = 0;
                    cand[1] = 1;
                    cand[2] = 26;
                } else {
                    cand[0] = a;
                    cand[1] = 2 + ((a + 29) % 32);
                    cand[2] = 2 + ((a - 2 + 1) % 32);
                }
            } else {
                cand[0] = a;
                cand[1] = bm;
                cand[2] = (a != 0 && bm != 0) ? 0 : (a != 1 && bm != 1) ? 1 : 26;
            }
            int mode;
            if (prev[i]) {
                int idx = 0;
                while (idx < 2 && byp()) idx++;
                mode = cand[idx];
            } else {
                int rem = 0;
                for (int k = 0; k < 5; k++) rem = (rem << 1) | byp();
                std::sort(cand, cand + 3);
                mode = rem;
                for (int k = 0; k < 3; k++)
                    if (mode >= cand[k]) mode++;
            }
            intra_modes[i] = mode;
            each_blk(x, y, pb, pb, [&](Blk& b) { b.mode = uint8_t(mode); });
        }
        int cm = !dec(CHROMA_MODE) ? 4 : (byp() << 1) | byp();
        int luma = intra_modes[0];
        static const int fixed[4] = {0, 26, 10, 1};
        chroma_mode = cm == 4 ? luma : fixed[cm] == luma ? 34 : fixed[cm];
    }

    // -- transform tree and unit (7.3.8.8-7.3.8.10) --------------------------------------

    void transform_tree(int x0, int y0, int xb, int yb, int log2, int depth, int blk_idx, int max_depth,
                        bool parent_cb, bool parent_cr) {
        const Sps& S = sps;
        bool intra_split = cu_intra && part == PART_NxN;
        bool split;
        if (log2 <= S.log2_max_tb && log2 > S.log2_min_tb && depth < max_depth && !(intra_split && depth == 0)) {
            split = dec(SPLIT_TRANSFORM + 5 - log2);
        } else {
            bool inter_split = S.max_th_depth_inter == 0 && !cu_intra && part != PART_2Nx2N && depth == 0;
            split = log2 > S.log2_max_tb || (intra_split && depth == 0) || inter_split;
        }
        bool cb = parent_cb, cr = parent_cr;
        if (log2 > 2) {
            cb = (depth == 0 || parent_cb) ? dec(CBF_CHROMA + depth) : false;
            cr = (depth == 0 || parent_cr) ? dec(CBF_CHROMA + depth) : false;
        }
        if (split) {
            int h = 1 << (log2 - 1);
            transform_tree(x0, y0, x0, y0, log2 - 1, depth + 1, 0, max_depth, cb, cr);
            transform_tree(x0 + h, y0, x0, y0, log2 - 1, depth + 1, 1, max_depth, cb, cr);
            transform_tree(x0, y0 + h, x0, y0, log2 - 1, depth + 1, 2, max_depth, cb, cr);
            transform_tree(x0 + h, y0 + h, x0, y0, log2 - 1, depth + 1, 3, max_depth, cb, cr);
            return;
        }
        bool cbf_luma = true;
        if (cu_intra || depth != 0 || cb || cr) cbf_luma = dec(CBF_LUMA + (depth == 0 ? 1 : 0));
        transform_unit(x0, y0, xb, yb, log2, blk_idx, cbf_luma, cb, cr);
    }

    void transform_unit(int x0, int y0, int xb, int yb, int log2, int blk_idx, bool cbf_luma, bool cb, bool cr) {
        mark_tu(x0, y0, 1 << log2, cbf_luma);
        if ((cbf_luma || cb || cr) && pps.cu_qp_delta && !cu_qp_delta_coded) {
            int v = 0;
            while (v < 5 && dec(CU_QP_DELTA + (v > 0))) v++;
            if (v == 5) {
                int k = 0;
                while (byp()) {
                    v += 1 << k;
                    if (++k > 6) fail(CORRUPT, "cu_qp_delta_abs too long");
                }
                while (k--) v += byp() << k;
            }
            if (v && byp()) v = -v;
            if (v < -(26 + qp_off / 2) || v > 25 + qp_off / 2) fail(CORRUPT, "CuQpDeltaVal %d", v);
            cu_qp_delta_coded = true;
            cu_qp_delta = v;
            qp_y = wrap_qp(qp_pred + cu_qp_delta);
        }
        if (cu_intra) intra_predict(x0, y0, log2, 0, B(x0, y0).mode);
        if (cbf_luma) residual(x0, y0, log2, 0);
        if (log2 > 2 || blk_idx == 3) {
            int xc = (log2 > 2 ? x0 : xb) / 2, yc = (log2 > 2 ? y0 : yb) / 2, lc = log2 > 2 ? log2 - 1 : 2;
            for (int c = 1; c <= 2; c++) {
                if (cu_intra) intra_predict(xc, yc, lc, c, chroma_mode);
                if (c == 1 ? cb : cr) residual(xc, yc, lc, c);
            }
        }
    }

    // -- prediction units (7.3.8.6), merge and AMVP (8.5.3.2) ------------------------------

    const Motion& mot(int x, int y) const { return cur->mot(x, y); }

    // prediction block availability (6.4.2) of (xn, yn) for the block at (xp, yp)
    bool pb_avail(int xc, int yc, int ncb, int xp, int yp, int w, int h, int part_idx, int xn, int yn) {
        bool same_cb = xc <= xn && yc <= yn && xc + ncb > xn && yc + ncb > yn;
        bool a;
        if (!same_cb) a = avail(xp, yp, xn, yn);
        else a = !((w << 1) == ncb && (h << 1) == ncb && part_idx == 1 && yc + h <= yn && xc + w > xn);
        return a && mot(xn, yn).pred;
    }

    // the temporal candidate (8.5.3.2.8) for list X: the collocated picture's
    // compressed motion, its list chosen as libavcodec's
    // derive_temporal_colocated_mvs chooses it
    bool temporal(int xp, int yp, int w, int h, int ref_idx, int X, Mv* out) {
        if (!sh->temporal_mvp) return false;
        const Frame& col = *dpb[size_t(sh->list[sh->collocated_list][sh->collocated_ref_idx])];
        int target = sh->ref_poc[X][ref_idx];
        auto from = [&](int x, int y) {
            const Motion& m = col.mot((x >> 4) << 4, (y >> 4) << 4);
            if (!m.pred) return false;
            // one list: that one; both: list X when no reference follows the
            // picture (NoBackwardPredFlag), else the list collocated_from_l0_flag names
            int l = m.pred != 3 ? m.pred - 1 : sh->no_backward ? X : sh->collocated_list ? 0 : 1;
            int col_diff = col.poc - m.ref_poc[l], cur_diff = cur->poc - target;
            *out = m.mv[l];
            if (col_diff != cur_diff && col_diff) scale(out, col_diff, cur_diff);
            return true;
        };
        int xbr = xp + w, ybr = yp + h;
        if ((yp >> sps.log2_ctb) == (ybr >> sps.log2_ctb) && ybr < sps.height && xbr < sps.width && from(xbr, ybr))
            return true;
        return from(xp + (w >> 1), yp + (h >> 1));
    }

    // libavcodec's mv_scale (the standard's distScaleFactor scaling)
    static void scale(Mv* mv, int td, int tb) {
        td = clip3(-128, 127, td);
        tb = clip3(-128, 127, tb);
        if (!td) td = 1;
        int tx = (0x4000 + std::abs(td / 2)) / td;
        int f = clip3(-4096, 4095, (tb * tx + 32) >> 6);
        int x = f * mv->x, y = f * mv->y;
        mv->x = int16_t(clip3(-32768, 32767, (x + 127 + (x < 0)) >> 8));
        mv->y = int16_t(clip3(-32768, 32767, (y + 127 + (y < 0)) >> 8));
    }

    // the candidate's reference POCs from the slice's lists
    void set_pocs(Motion& m) const {
        for (int l = 0; l < 2; l++)
            if (m.uses(l)) m.ref_poc[l] = sh->ref_poc[l][m.ref_idx[l]];
    }

    // the merge candidate list (8.5.3.2.2-8.5.3.2.5) as libavcodec builds it
    Motion merge(int xc, int yc, int ncb, int xp, int yp, int w, int h, int part_idx, int merge_idx) {
        int plevel = pps.log2_parallel_merge_level;
        int orig_w = w, orig_h = h;
        if (plevel > 2 && ncb == 8) {  // singleMCLFlag
            xp = xc;
            yp = yc;
            w = h = ncb;
            part_idx = 0;
        }
        bool b_slice = sh->type == 0;
        Motion cand[6];
        int n = 0, max = sh->max_merge;
        auto same_mer = [&](int xn, int yn) { return (xp >> plevel) == (xn >> plevel) && (yp >> plevel) == (yn >> plevel); };
        auto get = [&](int xn, int yn, bool excluded, const Motion** m) {
            *m = nullptr;
            if (excluded || same_mer(xn, yn) || !pb_avail(xc, yc, ncb, xp, yp, w, h, part_idx, xn, yn)) return false;
            *m = &mot(xn, yn);
            return true;
        };
        const Motion *a1, *b1, *b0, *a0, *b2;
        bool vert2 = part == PART_Nx2N || part == PART_nLx2N || part == PART_nRx2N;
        bool horz2 = part == PART_2NxN || part == PART_2NxnU || part == PART_2NxnD;
        // availableN (after the merge level and partition rules), then the
        // comparisons, which read availableN, not whether N was pruned
        bool aa1 = get(xp - 1, yp + h - 1, vert2 && part_idx == 1, &a1);
        bool ab1 = get(xp + w - 1, yp - 1, horz2 && part_idx == 1, &b1);
        bool ab0 = get(xp + w, yp - 1, false, &b0);
        bool aa0 = get(xp - 1, yp + h, false, &a0);
        bool ab2 = get(xp - 1, yp - 1, false, &b2);
        bool fa1 = aa1;
        bool fb1 = ab1 && !(aa1 && a1->same(*b1));
        bool fb0 = ab0 && !(ab1 && b1->same(*b0));
        bool fa0 = aa0 && !(aa1 && a1->same(*a0));
        bool fb2 = ab2 && !(aa1 && a1->same(*b2)) && !(ab1 && b1->same(*b2)) && fa0 + fa1 + fb0 + fb1 != 4;
        if (fa1) cand[n++] = *a1;
        if (fb1) cand[n++] = *b1;
        if (fb0) cand[n++] = *b0;
        if (fa0) cand[n++] = *a0;
        if (fb2) cand[n++] = *b2;
        if (merge_idx >= n && n < max) {
            Mv col[2];
            bool c0 = temporal(xp, yp, w, h, 0, 0, &col[0]);
            bool c1 = b_slice && temporal(xp, yp, w, h, 0, 1, &col[1]);
            if (c0 || c1) {
                Motion& m = cand[n++];
                m = Motion();
                m.pred = uint8_t(c0 | (c1 << 1));
                for (int l = 0; l < 2; l++)
                    if (m.uses(l)) {
                        m.ref_idx[l] = 0;
                        m.mv[l] = col[l];
                    }
                set_pocs(m);
            }
        }
        // combined bi-predictive candidates (8.5.3.2.4), l0CandIdx and
        // l1CandIdx by combIdx as Table 8-7 orders them
        static const int L0_CAND[12] = {0, 1, 0, 2, 1, 2, 0, 3, 1, 3, 2, 3};
        static const int L1_CAND[12] = {1, 0, 2, 0, 2, 1, 3, 0, 3, 1, 3, 2};
        int orig = n;
        if (merge_idx >= n && b_slice && orig > 1 && orig < max)
            for (int k = 0; n < max && k < orig * (orig - 1); k++) {
                const Motion &l0 = cand[L0_CAND[k]], &l1 = cand[L1_CAND[k]];
                if (l0.uses(0) && l1.uses(1) && (l0.ref_poc[0] != l1.ref_poc[1] || l0.mv[0] != l1.mv[1])) {
                    Motion& m = cand[n++];
                    m = Motion();
                    m.pred = 3;
                    m.ref_idx[0] = l0.ref_idx[0];
                    m.ref_idx[1] = l1.ref_idx[1];
                    m.mv[0] = l0.mv[0];
                    m.mv[1] = l1.mv[1];
                    set_pocs(m);
                }
            }
        // zero candidates (8.5.3.2.5)
        int num_zero = b_slice ? std::min(sh->num_ref[0], sh->num_ref[1]) : sh->num_ref[0];
        for (int zero = 0; merge_idx >= n && n < max; zero++) {
            Motion& m = cand[n++];
            m = Motion();
            m.pred = b_slice ? 3 : 1;
            for (int l = 0; l < 2; l++)
                if (m.uses(l)) m.ref_idx[l] = int8_t(zero < num_zero ? zero : 0);
            set_pocs(m);
        }
        Motion m = cand[merge_idx];
        if (m.pred == 3 && orig_w + orig_h == 12) {  // no bi-prediction for an 8x4 or 4x8 block
            m.pred = 1;
            m.ref_idx[1] = -1;
        }
        return m;
    }

    // the motion vector predictor of list X (8.5.3.2.6-8.5.3.2.7) as
    // libavcodec's ff_hevc_luma_mv_mvp_mode derives it
    Mv amvp(int xc, int yc, int ncb, int xp, int yp, int w, int h, int part_idx, int X, int ref_idx, int mvp_flag) {
        int Y = !X, target = sh->ref_poc[X][ref_idx];
        auto av = [&](int xn, int yn) { return pb_avail(xc, yc, ncb, xp, yp, w, h, part_idx, xn, yn); };
        // a neighbour predicting from the target picture, by list X then Y
        auto same = [&](int xn, int yn, Mv* out) {
            const Motion& m = mot(xn, yn);
            for (int l : {X, Y})
                if (m.uses(l) && m.ref_poc[l] == target) {
                    *out = m.mv[l];
                    return true;
                }
            return false;
        };
        // any of its vectors, by list X then Y, scaled by POC distance
        auto scaled = [&](int xn, int yn, Mv* out) {
            const Motion& m = mot(xn, yn);
            int l = m.uses(X) ? X : Y;
            *out = m.mv[l];
            if (m.ref_poc[l] != target) {
                int td = cur->poc - m.ref_poc[l];
                scale(out, td ? td : 1, cur->poc - target);
            }
        };
        int ax[2] = {xp - 1, xp - 1}, ay[2] = {yp + h, yp + h - 1};
        bool aa[2] = {av(ax[0], ay[0]), av(ax[1], ay[1])};
        bool is_scaled = aa[0] || aa[1];
        bool fa = false, fb = false;
        Mv mva, mvb;
        for (int k = 0; k < 2 && !fa; k++) fa = aa[k] && same(ax[k], ay[k], &mva);
        for (int k = 0; k < 2 && !fa; k++)
            if (aa[k]) {
                scaled(ax[k], ay[k], &mva);
                fa = true;
            }
        int bx[3] = {xp + w, xp + w - 1, xp - 1}, by[3] = {yp - 1, yp - 1, yp - 1};
        bool ba[3] = {av(bx[0], by[0]), av(bx[1], by[1]), av(bx[2], by[2])};
        for (int k = 0; k < 3 && !fb; k++) fb = ba[k] && same(bx[k], by[k], &mvb);
        if (!is_scaled && fb) {
            fa = true;
            mva = mvb;
        }
        if (!is_scaled) {
            fb = false;
            for (int k = 0; k < 3 && !fb; k++)
                if (ba[k]) {
                    scaled(bx[k], by[k], &mvb);
                    fb = true;
                }
        }
        Mv list[2];
        int n = 0;
        if (fa) list[n++] = mva;
        if (fb && (!fa || mva != mvb)) list[n++] = mvb;
        if (n < 2 && mvp_flag == n) {
            Mv col;
            if (temporal(xp, yp, w, h, ref_idx, X, &col)) list[n++] = col;
        }
        while (n < 2) list[n++] = Mv();
        return list[mvp_flag];
    }

    int mvd_component(bool gt0, bool gt1) {
        if (!gt0) return 0;
        int v = 1;
        if (gt1) {
            int e = cab.exp_golomb_bypass(1);
            if (e < 0) fail(CORRUPT, "abs_mvd_minus2 too long");
            v = 2 + e;
        }
        if (v > 32768) fail(CORRUPT, "an mvd of %d", v);
        return byp() ? -v : v;
    }

    Mv mvd_coding() {  // 7.3.8.9
        bool g0x = dec(MVD_GT0), g0y = dec(MVD_GT0);
        bool g1x = g0x && dec(MVD_GT1), g1y = g0y && dec(MVD_GT1);
        Mv d;
        d.x = int16_t(uint16_t(mvd_component(g0x, g1x)));
        d.y = int16_t(uint16_t(mvd_component(g0y, g1y)));
        return d;
    }

    int ref_idx(int num_ref) {
        int ref = 0;
        if (num_ref > 1) {
            int max = num_ref - 1;
            while (ref < std::min(max, 2) && dec(REF_IDX + ref)) ref++;
            if (ref == 2)
                while (ref < max && byp()) ref++;
        }
        return ref;
    }

    void prediction_unit(int xc, int yc, int log2, int xp, int yp, int w, int h, int part_idx) {
        int ncb = 1 << log2;
        Motion m;
        bool merge_flag = cu_skip || dec(MERGE_FLAG);
        if (merge_flag) {
            int idx = 0;
            if (sh->max_merge > 1 && dec(MERGE_IDX)) {
                idx = 1;
                while (idx < sh->max_merge - 1 && byp()) idx++;
            }
            if (part == PART_2Nx2N) merge_2nx2n = true;
            m = merge(xc, yc, ncb, xp, yp, w, h, part_idx, idx);
        } else {
            // inter_pred_idc (9.3.4.2.2): one bin for an 8x4 or 4x8 block (no
            // bi-prediction), else a first by the CU's depth
            int dir = 1;  // 1 PRED_L0, 2 PRED_L1, 3 PRED_BI
            if (sh->type == 0) {
                if (w + h != 12 && dec(INTER_PRED + B(xc, yc).depth)) dir = 3;
                else dir = 1 + dec(INTER_PRED + 4);
            }
            for (int l = 0; l < 2; l++) {
                if (!((dir >> l) & 1)) continue;
                int ref = ref_idx(sh->num_ref[l]);
                Mv d;
                if (!(l == 1 && dir == 3 && sh->mvd_l1_zero)) d = mvd_coding();
                int flag = dec(MVP_FLAG);
                Mv pr = amvp(xc, yc, ncb, xp, yp, w, h, part_idx, l, ref, flag);
                m.ref_idx[l] = int8_t(ref);
                m.mv[l].x = int16_t(uint16_t(pr.x + d.x));  // (mvp + mvd) mod 2^16 (8.5.3.2.1)
                m.mv[l].y = int16_t(uint16_t(pr.y + d.y));
            }
            m.pred = uint8_t(dir);
            set_pocs(m);
        }
        for (int y = yp; y < yp + h; y += 4)
            for (int x = xp; x < xp + w; x += 4) cur->motion[size_t(y >> 2) * w4 + (x >> 2)] = m;
        for (int k = 0; k < h; k += 4) B(xp, yp + k).edge_v |= 2;
        for (int k = 0; k < w; k += 4) B(xp + k, yp).edge_h |= 2;
        motion_compensate(xp, yp, w, h, m);
    }

    // -- inter prediction samples (8.5.3.3) --------------------------------------------

    // the 14-bit prediction of component c's block from `ref` at vector mv:
    // 8-tap luma and 4-tap chroma filters, the picture's edge extended.  The
    // separable case's second stage is saturated to 16 bits as x86's
    // packssdw leaves it (libavcodec's SIMD code, at 8 and 10 bits); at 9
    // bits, which have only its C code, it is wrapped to 16 bits where that
    // code stores it (`stored`: list 0's of a bi-predicted block) and kept
    // whole where it sums it at once (uni-prediction, list 1's)
    static void predict(const Frame& ref, Mv mv, int c, int xp, int yp, int w, int h, int32_t* pred,
                        bool stored) {
        const int bd = ref.bit_depth, shift1 = bd - 8;
        static thread_local int16_t tmp[(64 + 7) * 64], blk[(64 + 7) * (64 + 7)];
        int sub = c ? 1 : 0;
        int bw = w >> sub, bh = h >> sub, W = ref.stride(c), H = c ? ref.h / 2 : ref.h;
        int frac_bits = c ? 3 : 2, taps = c ? 4 : 8, back = c ? 1 : 3;
        int mx = mv.x, my = mv.y;
        int fx = mx & ((1 << frac_bits) - 1), fy = my & ((1 << frac_bits) - 1);
        int x0 = (xp >> sub) + (mx >> frac_bits), y0 = (yp >> sub) + (my >> frac_bits);
        const uint16_t* src = ref.px[c].data();
        int pw = bw + taps - 1, ph = bh + taps - 1;
        for (int y = 0; y < ph; y++) {
            const uint16_t* row = src + size_t(clip3(0, H - 1, y0 + y - back)) * W;
            for (int x = 0; x < pw; x++) blk[y * pw + x] = row[clip3(0, W - 1, x0 + x - back)];
        }
        const int16_t* org = blk + back * pw + back;  // the block's own top-left sample
        const int* fxs = c ? CHROMA_FILTER[fx] : LUMA_FILTER[fx];
        const int* fys = c ? CHROMA_FILTER[fy] : LUMA_FILTER[fy];
        if (!fx && !fy) {
            for (int y = 0; y < bh; y++)
                for (int x = 0; x < bw; x++) pred[y * bw + x] = int16_t(org[y * pw + x] << (14 - bd));
        } else if (!fy) {
            for (int y = 0; y < bh; y++)
                for (int x = 0; x < bw; x++) {
                    int s = 0;
                    for (int i = 0; i < taps; i++) s += fxs[i] * org[y * pw + x + i - back];
                    pred[y * bw + x] = int16_t(s >> shift1);
                }
        } else if (!fx) {
            for (int y = 0; y < bh; y++)
                for (int x = 0; x < bw; x++) {
                    int s = 0;
                    for (int i = 0; i < taps; i++) s += fys[i] * org[(y + i - back) * pw + x];
                    pred[y * bw + x] = int16_t(s >> shift1);
                }
        } else {
            for (int y = 0; y < ph; y++)
                for (int x = 0; x < bw; x++) {
                    int s = 0;
                    for (int i = 0; i < taps; i++) s += fxs[i] * blk[y * pw + x + i];
                    tmp[y * bw + x] = int16_t(s >> shift1);
                }
            for (int y = 0; y < bh; y++)
                for (int x = 0; x < bw; x++) {
                    int s = 0;
                    for (int i = 0; i < taps; i++) s += fys[i] * tmp[(y + i) * bw + x];
                    pred[y * bw + x] = bd != 9 ? clip3(-32768, 32767, s >> 6) : stored ? int16_t(uint16_t(s >> 6)) : s >> 6;
                }
        }
    }

    void motion_compensate(int xp, int yp, int w, int h, const Motion& m) {
        static thread_local int32_t pred[2][64 * 64];
        const Slice& S = *sh;
        for (int c = 0; c < 3; c++) {
            int sub = c ? 1 : 0, bw = w >> sub, bh = h >> sub, W = cur->stride(c);
            for (int l = 0; l < 2; l++)
                if (m.uses(l))
                    predict(*dpb[size_t(S.list[l][m.ref_idx[l]])], m.mv[l], c, xp, yp, w, h, pred[l],
                            l == 0 && m.pred == 3);
            uint16_t* dst = cur->plane(c) + size_t(yp >> sub) * W + (xp >> sub);
            int log2wd = (c ? S.chroma_denom : S.luma_denom) + 14 - bd;
            auto weight = [&](int l) { return c ? S.cw[l][m.ref_idx[l]][c - 1] : S.lw[l][m.ref_idx[l]]; };
            auto offset = [&](int l) {  // scaled to the bit depth (8.5.3.3.4.3)
                return (c ? S.co[l][m.ref_idx[l]][c - 1] : S.lo[l][m.ref_idx[l]]) * (1 << (bd - 8));
            };
            auto pel = [&](int v) { return uint16_t(clip3(0, maxv, v)); };
            if (m.pred != 3) {
                const int32_t* p = pred[m.pred - 1];
                if (S.weighted) {  // explicit weighted prediction (8.5.3.3.4.3)
                    int wt = weight(m.pred - 1), o = offset(m.pred - 1);
                    for (int y = 0; y < bh; y++)
                        for (int x = 0; x < bw; x++)
                            dst[size_t(y) * W + x] = pel(((p[y * bw + x] * wt + (1 << (log2wd - 1))) >> log2wd) + o);
                } else {
                    int sh = 14 - bd;
                    for (int y = 0; y < bh; y++)
                        for (int x = 0; x < bw; x++) dst[size_t(y) * W + x] = pel((p[y * bw + x] + (1 << (sh - 1))) >> sh);
                }
            } else if (S.weighted) {  // both lists, explicit weights, (o0 + o1 + 1) >> 1 rounding
                int w0 = weight(0), w1 = weight(1), o = (offset(0) + offset(1) + 1) << log2wd;
                for (int y = 0; y < bh; y++)
                    for (int x = 0; x < bw; x++) {
                        int i = y * bw + x;
                        dst[size_t(y) * W + x] = pel((pred[0][i] * w0 + pred[1][i] * w1 + o) >> (log2wd + 1));
                    }
            } else {
                // the default average (x86's paddsw saturates the sum to 16
                // bits where libavcodec's C code does not: the clip after the
                // shift hides which)
                int sh = 15 - bd;
                for (int y = 0; y < bh; y++)
                    for (int x = 0; x < bw; x++) {
                        int i = y * bw + x;
                        dst[size_t(y) * W + x] = pel((pred[0][i] + pred[1][i] + (1 << (sh - 1))) >> sh);
                    }
            }
        }
    }

    // -- intra prediction (8.4.4.2) ---------------------------------------------------------

    // the samples of TB (x0, y0) of component c (its own coordinates), 1 << log2 square
    void intra_predict(int x0, int y0, int log2, int c, int mode) {
        int n = 1 << log2, sub = c ? 1 : 0;
        int W = cur->stride(c);
        uint16_t* pl = cur->plane(c);
        int xl = x0 << sub, yl = y0 << sub;  // luma location of the block
        // p[-1][2n-1..-1] as left[0..2n] (left[2n] the corner), p[0..2n-1][-1] as top[0..2n-1]
        int ref[4 * 64 + 1];
        bool have[4 * 64 + 1];
        int unit = c ? 2 : 4;  // samples a 4x4 luma block covers
        int total = 4 * n + 1;
        // index 0 is p[-1][2n-1] (bottom-left), 2n is p[-1][-1], 4n is p[2n-1][-1]
        bool any = false;
        auto usable = [&](int xs, int ys) {  // a neighbouring sample (component coordinates)
            int xn = xs * (1 << sub), yn = ys * (1 << sub);
            if (!avail(xl, yl, xn, yn)) return false;
            return !pps.constrained_intra_pred || B(xn, yn).intra;
        };
        for (int i = 0; i < 2 * n; i += unit) {  // left column, bottom to top
            int ys = y0 + 2 * n - 1 - i;
            bool ok = usable(x0 - 1, ys);
            for (int k = 0; k < unit; k++) {
                have[i + k] = ok;
                if (ok) ref[i + k] = pl[size_t(ys - k) * W + x0 - 1];
            }
            any |= ok;
        }
        have[2 * n] = usable(x0 - 1, y0 - 1);
        if (have[2 * n]) ref[2 * n] = pl[size_t(y0 - 1) * W + x0 - 1];
        any |= have[2 * n];
        for (int i = 0; i < 2 * n; i += unit) {  // top row, left to right
            bool ok = usable(x0 + i, y0 - 1);
            for (int k = 0; k < unit; k++) {
                have[2 * n + 1 + i + k] = ok;
                if (ok) ref[2 * n + 1 + i + k] = pl[size_t(y0 - 1) * W + x0 + i + k];
            }
            any |= ok;
        }
        // substitution (8.4.4.2.2)
        if (!any) {
            for (int i = 0; i < total; i++) ref[i] = 1 << (bd - 1);
        } else {
            if (!have[0]) {
                int i = 1;
                while (!have[i]) i++;
                ref[0] = ref[i];
            }
            for (int i = 1; i < total; i++)
                if (!have[i]) ref[i] = ref[i - 1];
        }
        auto L = [&](int y) { return ref[2 * n - 1 - y]; };  // p[-1][y], y = -1..2n-1
        auto T = [&](int x) { return ref[2 * n + 1 + x]; };  // p[x][-1], x = -1..2n-1
        // filtering (8.4.4.2.3)
        int left[129], top[129];  // left[y + 1] = p[-1][y], top[x + 1] = p[x][-1]
        for (int k = -1; k < 2 * n; k++) {
            left[k + 1] = L(k);
            top[k + 1] = T(k);
        }
        if (c == 0 && mode != 1 && n != 4) {
            int dist = std::min(std::abs(mode - 26), std::abs(mode - 10));
            int thres = n == 8 ? 7 : n == 16 ? 1 : 0;
            if (dist > thres) {
                int fl[129], ft[129];
                int flat = 1 << (bd - 5);
                bool strong = sps.strong_intra_smoothing && n == 32 &&
                              std::abs(L(-1) + T(2 * n - 1) - 2 * T(n - 1)) < flat &&
                              std::abs(L(-1) + L(2 * n - 1) - 2 * L(n - 1)) < flat;
                if (strong) {
                    fl[0] = ft[0] = L(-1);
                    for (int k = 0; k < 63; k++) {
                        fl[k + 1] = ((63 - k) * L(-1) + (k + 1) * L(63) + 32) >> 6;
                        ft[k + 1] = ((63 - k) * T(-1) + (k + 1) * T(63) + 32) >> 6;
                    }
                    fl[64] = L(63);
                    ft[64] = T(63);
                } else {
                    fl[0] = ft[0] = (L(0) + 2 * L(-1) + T(0) + 2) >> 2;
                    for (int k = 0; k < 2 * n - 1; k++) {
                        fl[k + 1] = (L(k + 1) + 2 * L(k) + L(k - 1) + 2) >> 2;
                        ft[k + 1] = (T(k + 1) + 2 * T(k) + T(k - 1) + 2) >> 2;
                    }
                    fl[2 * n] = L(2 * n - 1);
                    ft[2 * n] = T(2 * n - 1);
                }
                memcpy(left, fl, sizeof(int) * (2 * n + 1));
                memcpy(top, ft, sizeof(int) * (2 * n + 1));
            }
        }
        uint16_t* dst = pl + size_t(y0) * W + x0;
        if (mode == 0) {  // planar
            for (int y = 0; y < n; y++)
                for (int x = 0; x < n; x++)
                    dst[size_t(y) * W + x] = uint16_t(((n - 1 - x) * left[y + 1] + (x + 1) * top[n + 1] +
                                                      (n - 1 - y) * top[x + 1] + (y + 1) * left[n + 1] + n) >>
                                                     (log2 + 1));
        } else if (mode == 1) {  // DC
            int sum = n;
            for (int k = 0; k < n; k++) sum += top[k + 1] + left[k + 1];
            int dc = sum >> (log2 + 1);
            for (int y = 0; y < n; y++)
                for (int x = 0; x < n; x++) dst[size_t(y) * W + x] = uint16_t(dc);
            if (c == 0 && n < 32) {
                dst[0] = uint16_t((left[1] + 2 * dc + top[1] + 2) >> 2);
                for (int x = 1; x < n; x++) dst[x] = uint16_t((top[x + 1] + 3 * dc + 2) >> 2);
                for (int y = 1; y < n; y++) dst[size_t(y) * W] = uint16_t((left[y + 1] + 3 * dc + 2) >> 2);
            }
        } else {  // angular
            int angle = INTRA_ANGLE[mode];
            bool vert = mode >= 18;
            const int* main = vert ? top : left;  // main[k + 1] = p along the main direction at k
            const int* side = vert ? left : top;
            int refa[3 * 64 + 1];
            int* r = refa + 64;  // r[k], k = -n..2n
            for (int k = 0; k <= n; k++) r[k] = main[k];  // r[0] = p[-1][-1]
            if (angle < 0) {
                if ((n * angle) >> 5 < -1)
                    for (int k = (n * angle) >> 5; k <= -1; k++) r[k] = side[((k * INV_ANGLE[mode] + 128) >> 8)];
            } else {
                for (int k = n + 1; k <= 2 * n; k++) r[k] = main[k];
            }
            for (int j = 0; j < n; j++) {  // j: y for vertical modes, x for horizontal
                int pos = (j + 1) * angle, idx = pos >> 5, fr = pos & 31;
                for (int i = 0; i < n; i++) {
                    int v = fr ? ((32 - fr) * r[i + idx + 1] + fr * r[i + idx + 2] + 16) >> 5 : r[i + idx + 1];
                    if (vert) dst[size_t(j) * W + i] = uint16_t(v);
                    else dst[size_t(i) * W + j] = uint16_t(v);
                }
            }
            if (c == 0 && n < 32) {
                if (mode == 26)
                    for (int y = 0; y < n; y++) dst[size_t(y) * W] = uint16_t(clip3(0, maxv, top[1] + ((left[y + 1] - left[0]) >> 1)));
                if (mode == 10)
                    for (int x = 0; x < n; x++) dst[x] = uint16_t(clip3(0, maxv, left[1] + ((top[x + 1] - top[0]) >> 1)));
            }
        }
    }

    // -- residual coding (7.3.8.11), scaling and transformation (8.6) -----------------------

    int chroma_qp(int c) const {  // QpCb or QpCr (8.6.1), without QpBdOffsetC
        int off = c == 1 ? pps.cb_qp_offset + sh->cb_qp_offset : pps.cr_qp_offset + sh->cr_qp_offset;
        return chroma_qp_of(clip3(-qp_off, 57, qp_y + off));
    }

    int last_prefix(int base, int log2, int c) {
        int off = c ? 15 : 3 * (log2 - 2) + ((log2 - 1) >> 2), shift = c ? log2 - 2 : (log2 + 1) >> 2;
        int max = (log2 << 1) - 1, i = 0;
        while (i < max && dec(base + off + (i >> shift))) i++;
        return i;
    }
    int last_value(int prefix) {
        if (prefix <= 3) return prefix;
        int nb = (prefix >> 1) - 1, suffix = 0;
        for (int i = 0; i < nb; i++) suffix = (suffix << 1) | byp();
        return (1 << nb) * (2 + (prefix & 1)) + suffix;
    }

    int abs_level_remaining(int rice) {
        int prefix = 0;
        while (prefix < 32 && byp()) prefix++;
        if (prefix == 32) fail(CORRUPT, "coeff_abs_level_remaining too long");
        if (prefix <= 3) {
            int s = 0;
            for (int i = 0; i < rice; i++) s = (s << 1) | byp();
            return (prefix << rice) + s;
        }
        int n = prefix - 3 + rice;
        if (n > 22) fail(CORRUPT, "coeff_abs_level_remaining too long");
        int s = 0;
        for (int i = 0; i < n; i++) s = (s << 1) | byp();
        return (((1 << (prefix - 3)) + 2) << rice) + s;
    }

    // a transform block of component c at (x0, y0) (its own coordinates): levels
    // decoded, scaled, transformed and added to the prediction in the picture
    void residual(int x0, int y0, int log2, int c) {
        const Tables& T = tables();
        int n = 1 << log2;
        bool ts = pps.transform_skip && log2 == 2 && dec(TRANSFORM_SKIP + (c ? 1 : 0));
        int px = last_prefix(LAST_X, log2, c), py = last_prefix(LAST_Y, log2, c);
        int lx = last_value(px), ly = last_value(py);
        int scan_idx = 0;
        if (cu_intra && (log2 == 2 || (log2 == 3 && c == 0))) {
            int m = c ? chroma_mode : B(x0, y0).mode;
            scan_idx = (m >= 6 && m <= 14) ? 2 : (m >= 22 && m <= 30) ? 1 : 0;
        }
        if (scan_idx == 2) std::swap(lx, ly);
        if (lx >= n || ly >= n) fail(CORRUPT, "a last significant coefficient outside the block");
        int lsb = log2 - 2;  // sub-blocks a side, log2
        const uint8_t(*sb_scan)[2] = T.scan[lsb][scan_idx];
        const uint8_t(*pos_scan)[2] = T.scan[2][scan_idx];
        int last_sb = -1, last_pos = -1;
        for (int i = (1 << (2 * lsb)) - 1; i >= 0 && last_sb < 0; i--)
            if (sb_scan[i][0] == (lx >> 2) && sb_scan[i][1] == (ly >> 2)) last_sb = i;
        for (int k = 15; k >= 0; k--)
            if (pos_scan[k][0] == (lx & 3) && pos_scan[k][1] == (ly & 3)) last_pos = k;
        int64_t level[32 * 32];
        for (int i = 0; i < n * n; i++) level[i] = 0;
        uint8_t csbf[8][8] = {{0}};
        int qp = (c ? chroma_qp(c) : qp_y) + qp_off;  // Qp'
        int64_t scale = int64_t(LEVEL_SCALE[qp % 6]) << (qp / 6);
        int bd_shift = bd + log2 - 5;
        int greater1_ctx = 1;
        bool hide = pps.sign_data_hiding;
        int max_x = 0, max_y = 0;
        for (int i = last_sb; i >= 0; i--) {
            int xs = sb_scan[i][0], ys = sb_scan[i][1];
            bool infer_dc = false;
            bool coded;
            if (i < last_sb && i > 0) {
                int right = xs < (1 << lsb) - 1 ? csbf[xs + 1][ys] : 0, below = ys < (1 << lsb) - 1 ? csbf[xs][ys + 1] : 0;
                coded = dec(CODED_SUB_BLOCK + (c ? 2 : 0) + std::min(right + below, 1));
                infer_dc = true;
            } else {
                coded = true;
            }
            csbf[xs][ys] = coded;
            int prev_csbf = (xs < (1 << lsb) - 1 ? csbf[xs + 1][ys] : 0) | ((ys < (1 << lsb) - 1 ? csbf[xs][ys + 1] : 0) << 1);
            int sig[16], ns = 0;  // scan positions of the significant coefficients, high to low
            if (i == last_sb) sig[ns++] = last_pos;
            for (int k = (i == last_sb ? last_pos - 1 : 15); k >= 0; k--) {
                if (!coded) break;
                int xc = (xs << 2) + pos_scan[k][0], yc = (ys << 2) + pos_scan[k][1];
                if (k > 0 || !infer_dc) {
                    int sc;
                    if (log2 == 2) {
                        sc = CTX_IDX_MAP[(yc << 2) + xc];
                    } else if (xc + yc == 0) {
                        sc = 0;
                    } else {
                        int xp = xc & 3, yp = yc & 3;
                        if (prev_csbf == 0) sc = xp + yp == 0 ? 2 : xp + yp < 3 ? 1 : 0;
                        else if (prev_csbf == 1) sc = yp == 0 ? 2 : yp == 1 ? 1 : 0;
                        else if (prev_csbf == 2) sc = xp == 0 ? 2 : xp == 1 ? 1 : 0;
                        else sc = 2;
                        if (c == 0) {
                            if (i > 0) sc += 3;
                            sc += log2 == 3 ? (scan_idx == 0 ? 9 : 15) : 21;
                        } else {
                            sc += log2 == 3 ? 9 : 12;
                        }
                    }
                    if (dec(SIG_COEFF + (c ? 27 : 0) + sc)) {
                        sig[ns++] = k;
                        infer_dc = false;
                    }
                } else {
                    sig[ns++] = 0;  // inferred: the sub-block's DC
                }
            }
            if (!ns) continue;
            int ctx_set = (i > 0 && c == 0) ? 2 : 0;
            if (i != last_sb && greater1_ctx == 0) ctx_set++;
            greater1_ctx = 1;
            int g1[8], first_g1 = -1;
            for (int m = 0; m < std::min(ns, 8); m++) {
                g1[m] = dec(GT1 + (c ? 16 : 0) + (ctx_set << 2) + greater1_ctx);
                if (g1[m]) {
                    greater1_ctx = 0;
                    if (first_g1 < 0) first_g1 = m;
                } else if (greater1_ctx > 0 && greater1_ctx < 3) {
                    greater1_ctx++;
                }
            }
            if (first_g1 >= 0) g1[first_g1] += dec(GT2 + (c ? 4 : 0) + ctx_set);
            bool hidden = hide && sig[0] - sig[ns - 1] > 3;
            int signs[16];
            for (int m = 0; m < ns; m++) signs[m] = (hidden && m == ns - 1) ? 0 : byp();
            int rice = 0;
            int64_t sum = 0;
            for (int m = 0; m < ns; m++) {
                int64_t v = m < 8 ? 1 + g1[m] : 1;
                if (v == (m < 8 ? (m == first_g1 ? 3 : 2) : 1)) {
                    v += abs_level_remaining(rice);
                    if (v > 3 * (1 << rice)) rice = std::min(rice + 1, 4);
                }
                sum += v;
                if (signs[m]) v = -v;
                if (hidden && m == ns - 1 && (sum & 1)) v = -v;
                int xc = (xs << 2) + pos_scan[sig[m]][0], yc = (ys << 2) + pos_scan[sig[m]][1];
                level[yc * n + xc] = v;
                max_x = std::max(max_x, xc);
                max_y = std::max(max_y, yc);
            }
        }
        // scaling (8.6.3): flat m = 16, clipped to 16 bits
        int32_t d[32 * 32];
        int64_t add = int64_t(1) << (bd_shift - 1);
        for (int i = 0; i < n * n; i++) {
            int64_t v = level[i] ? (level[i] * scale * 16 + add) >> bd_shift : 0;
            d[i] = int32_t(v < -32768 ? -32768 : v > 32767 ? 32767 : v);
        }
        int32_t r[32 * 32];
        if (ts) {
            for (int i = 0; i < 16; i++) r[i] = (d[i] + (1 << (12 - bd))) >> (13 - bd);  // (d << 7 + 2^(19-bd)) >> (20-bd)
        } else {
            transform(d, r, log2, cu_intra && c == 0 && log2 == 2, max_x, max_y, bd);
        }
        int W = cur->stride(c);
        uint16_t* dst = cur->plane(c) + size_t(y0) * W + x0;
        // libavcodec's add_residual: its 10-bit SIMD code sums in 16 bits
        // (paddw, wrapping) before the clip; below 10 bits no sum leaves 16
        // bits (the transform's last shift is 11 or 12)
        for (int y = 0; y < n; y++)
            for (int x = 0; x < n; x++) {
                int v = int16_t(uint16_t(dst[size_t(y) * W + x] + r[y * n + x]));
                dst[size_t(y) * W + x] = uint16_t(clip3(0, maxv, v));
            }
    }

    // the two-stage inverse transform (8.6.4.2): columns, 16-bit clip, rows
    static void transform(const int32_t* d, int32_t* r, int log2, bool dst4, int max_x, int max_y, int bd) {
        const Tables& T = tables();
        int n = 1 << log2, step = 32 >> log2;
        auto coef = [&](int k, int i) { return dst4 ? DST4[k][i] : int(T.dct[k * step][i]); };
        int32_t g[32 * 32];
        for (int x = 0; x < n; x++) {
            for (int y = 0; y < n; y++) {
                if (x > max_x) {
                    g[y * n + x] = 0;
                    continue;
                }
                int64_t e = 0;
                for (int k = 0; k <= max_y; k++) e += int64_t(coef(k, y)) * d[k * n + x];
                e = (e + 64) >> 7;
                g[y * n + x] = int32_t(e < -32768 ? -32768 : e > 32767 ? 32767 : e);
            }
        }
        for (int y = 0; y < n; y++)
            for (int x = 0; x < n; x++) {
                int64_t e = 0;
                for (int k = 0; k <= max_x; k++) e += int64_t(coef(k, x)) * g[y * n + k];
                e = (e + (1 << (19 - bd))) >> (20 - bd);
                r[y * n + x] = int32_t(e < -32768 ? -32768 : e > 32767 ? 32767 : e);  // libavcodec's int16 store
            }
    }

    // -- deblocking filter (8.7.2), as libavcodec filters -----------------------------------

    const Slice& slice_at(int x, int y) const {
        return slices[size_t(ctb_slice[size_t((y >> sps.log2_ctb) * sps.ctb_w + (x >> sps.log2_ctb))])];
    }
    int slice_idx_at(int x, int y) const {
        return ctb_slice[size_t((y >> sps.log2_ctb) * sps.ctb_w + (x >> sps.log2_ctb))];
    }

    // bS of the edge between the 4x4 blocks holding (xp, yp) and (xq, yq)
    int strength(int xp, int yp, int xq, int yq, uint8_t flags) {
        if (!flags) return 0;
        const Slice& sq = slice_at(xq, yq);
        if (sq.deblocking_disabled) return 0;
        if (slice_idx_at(xp, yp) != slice_idx_at(xq, yq) && !sq.lf_across) return 0;
        const Blk &P = B(xp, yp), &Q = B(xq, yq);
        if (P.intra || Q.intra) return 2;
        if ((flags & 1) && (P.nz || Q.nz)) return 1;
        return motion_strength(mot(xp, yp), mot(xq, yq));
    }

    // bS 1 or 0 of two inter blocks (8.7.2.4) as libavcodec's
    // boundary_strength finds it: their reference pictures compared (by
    // POC), then their vectors, both pairings of two lists' where the
    // pictures allow either
    static int motion_strength(const Motion& p, const Motion& q) {
        auto far = [](const Mv& a, const Mv& b) { return std::abs(a.x - b.x) >= 4 || std::abs(a.y - b.y) >= 4; };
        if (p.pred == 3 && q.pred == 3) {
            int p0 = p.ref_poc[0], p1 = p.ref_poc[1], q0 = q.ref_poc[0], q1 = q.ref_poc[1];
            if (p0 == q0 && p0 == p1 && q0 == q1)
                return (far(p.mv[0], q.mv[0]) || far(p.mv[1], q.mv[1])) &&
                       (far(p.mv[1], q.mv[0]) || far(p.mv[0], q.mv[1]));
            if (p0 == q0 && p1 == q1) return far(p.mv[0], q.mv[0]) || far(p.mv[1], q.mv[1]);
            if (p1 == q0 && p0 == q1) return far(p.mv[1], q.mv[0]) || far(p.mv[0], q.mv[1]);
            return 1;
        }
        if (p.pred == 3 || q.pred == 3) return 1;  // one vector against two
        int lp = p.pred - 1, lq = q.pred - 1;
        if (p.ref_poc[lp] != q.ref_poc[lq]) return 1;
        return far(p.mv[lp], q.mv[lq]);
    }

    // beta and tc at the bit depth (tc' and beta' << (BitDepth - 8)); samples up to maxv
    static void filter_luma(uint16_t* pix, int xstride, int ystride, int beta, const int tc_[2], int maxv) {
        auto clip = [maxv](int v) { return uint16_t(clip3(0, maxv, v)); };
        for (int j = 0; j < 2; j++, pix += 4 * ystride) {
            int tc = tc_[j];
            auto P = [&](int i, int k) -> uint16_t& { return pix[k * ystride - (i + 1) * xstride]; };
            auto Q = [&](int i, int k) -> uint16_t& { return pix[k * ystride + i * xstride]; };
            int dp0 = std::abs(P(2, 0) - 2 * P(1, 0) + P(0, 0)), dq0 = std::abs(Q(2, 0) - 2 * Q(1, 0) + Q(0, 0));
            int dp3 = std::abs(P(2, 3) - 2 * P(1, 3) + P(0, 3)), dq3 = std::abs(Q(2, 3) - 2 * Q(1, 3) + Q(0, 3));
            int d0 = dp0 + dq0, d3 = dp3 + dq3;
            if (d0 + d3 >= beta) continue;
            int tc25 = (tc * 5 + 1) >> 1;
            bool strong = std::abs(P(3, 0) - P(0, 0)) + std::abs(Q(3, 0) - Q(0, 0)) < (beta >> 3) &&
                          std::abs(P(0, 0) - Q(0, 0)) < tc25 &&
                          std::abs(P(3, 3) - P(0, 3)) + std::abs(Q(3, 3) - Q(0, 3)) < (beta >> 3) &&
                          std::abs(P(0, 3) - Q(0, 3)) < tc25 && (d0 << 1) < (beta >> 2) && (d3 << 1) < (beta >> 2);
            if (strong) {
                int tc2 = tc << 1;
                for (int k = 0; k < 4; k++) {
                    int p3 = P(3, k), p2 = P(2, k), p1 = P(1, k), p0 = P(0, k);
                    int q0 = Q(0, k), q1 = Q(1, k), q2 = Q(2, k), q3 = Q(3, k);
                    P(0, k) = uint16_t(p0 + clip3(-tc2, tc2, ((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3) - p0));
                    P(1, k) = uint16_t(p1 + clip3(-tc2, tc2, ((p2 + p1 + p0 + q0 + 2) >> 2) - p1));
                    P(2, k) = uint16_t(p2 + clip3(-tc2, tc2, ((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3) - p2));
                    Q(0, k) = uint16_t(q0 + clip3(-tc2, tc2, ((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3) - q0));
                    Q(1, k) = uint16_t(q1 + clip3(-tc2, tc2, ((p0 + q0 + q1 + q2 + 2) >> 2) - q1));
                    Q(2, k) = uint16_t(q2 + clip3(-tc2, tc2, ((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3) - q2));
                }
            } else {
                int side = (beta + (beta >> 1)) >> 3;
                bool np = dp0 + dp3 < side, nq = dq0 + dq3 < side;
                int tc_2 = tc >> 1;
                for (int k = 0; k < 4; k++) {
                    int p2 = P(2, k), p1 = P(1, k), p0 = P(0, k), q0 = Q(0, k), q1 = Q(1, k), q2 = Q(2, k);
                    int delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
                    if (std::abs(delta) >= tc * 10) continue;
                    delta = clip3(-tc, tc, delta);
                    P(0, k) = clip(p0 + delta);
                    Q(0, k) = clip(q0 - delta);
                    if (np) P(1, k) = clip(p1 + clip3(-tc_2, tc_2, (((p2 + p0 + 1) >> 1) - p1 + delta) >> 1));
                    if (nq) Q(1, k) = clip(q1 + clip3(-tc_2, tc_2, (((q2 + q0 + 1) >> 1) - q1 - delta) >> 1));
                }
            }
        }
    }

    static void filter_chroma(uint16_t* pix, int xstride, int ystride, const int tc_[2], int maxv) {
        for (int j = 0; j < 2; j++, pix += 4 * ystride) {
            int tc = tc_[j];
            if (tc <= 0) continue;
            for (int k = 0; k < 4; k++) {
                uint16_t* q = pix + k * ystride;
                int p1 = q[-2 * xstride], p0 = q[-xstride], q0 = q[0], q1 = q[xstride];
                int delta = clip3(-tc, tc, ((((q0 - p0) * 4) + p1 - q1 + 4) >> 3));
                q[-xstride] = uint16_t(clip3(0, maxv, p0 + delta));
                q[0] = uint16_t(clip3(0, maxv, q0 - delta));
            }
        }
    }

    // libavcodec's chroma tc: the PPS's offset only, qPi clipped to 0-57 (at
    // every bit depth), tc' scaled to the depth
    int chroma_tc(int qp, int c, int tc_offset) const {
        int qpi = clip3(0, 57, qp + (c == 1 ? pps.cb_qp_offset : pps.cr_qp_offset));
        return TC_TABLE[clip3(0, 53, chroma_qp_of(qpi) + 2 + tc_offset)] << (bd - 8);
    }

    // The picture's CTBs in raster order as libavcodec's deblocking_filter_CTB
    // filters each (edges of the luma 8x8 grid, chroma on the 16x16 grid with
    // bS 2): the result is the standard's but for the tc and beta offsets.
    // libavcodec keeps one tc_offset/beta_offset variable through a CTB's
    // loops: a horizontal luma edge left of the CTB (its last 8 columns,
    // filtered with the CTB) sets it to the left CTB's slice's offsets, which
    // the next vertical edges then keep; each chroma plane's horizontal edges
    // start from the left CTB's offset, the second half of the first 16
    // columns and all later ones take the CTB's own, and its vertical edges
    // take whatever the last loop left.
    void boundary_strengths() {
        const int W = sps.width, H = sps.height;
        // bS of every edge on the 8x8 grid, 4 samples long, before any filtering
        bs_v.assign(size_t(w4) * h4, 0);
        bs_h.assign(size_t(w4) * h4, 0);
        for (int y = 0; y < H; y += 4)
            for (int x = 0; x < W; x += 4) {
                size_t i = size_t(y >> 2) * w4 + (x >> 2);
                if (x && !(x & 7)) bs_v[i] = uint8_t(strength(x - 1, y, x, y, B(x, y).edge_v));
                if (y && !(y & 7)) bs_h[i] = uint8_t(strength(x, y - 1, x, y, B(x, y).edge_h));
            }
    }
    std::vector<uint8_t> bs_v, bs_h;

    void deblock_ctb(int x0, int y0) {
        const int W = sps.width, H = sps.height, ctb = 1 << sps.log2_ctb;
        auto bsv = [&](int x, int y) { return int(bs_v[size_t(y >> 2) * w4 + (x >> 2)]); };
        auto bsh = [&](int x, int y) { return int(bs_h[size_t(y >> 2) * w4 + (x >> 2)]); };
        auto qpy = [&](int x, int y) { return int(B(x, y).qp); };
        const Slice& cs = slice_at(x0, y0);
        int cur_tc = cs.tc_offset, cur_beta = cs.beta_offset, left_tc = 0, left_beta = 0;
        if (x0) {
            left_tc = slice_at(x0 - 1, y0).tc_offset;
            left_beta = slice_at(x0 - 1, y0).beta_offset;
        }
        int x_end = std::min(x0 + ctb, W), y_end = std::min(y0 + ctb, H);
        int tc_offset = cur_tc, beta_offset = cur_beta;
        int x_end2 = x_end == W ? x_end : x_end - 8;
        uint16_t* Y = cur->plane(0);
        const int sc = bd - 8;  // beta' and tc' to the bit depth
        for (int y = y0; y < y_end; y += 8) {
            for (int x = x0 ? x0 : 8; x < x_end; x += 8) {  // vertical luma edges
                int b0 = bsv(x, y), b1 = bsv(x, y + 4);
                if (!b0 && !b1) continue;
                int qp = (qpy(x - 1, y) + qpy(x, y) + 1) >> 1;
                int beta = BETA_TABLE[clip3(0, 51, qp + beta_offset)] << sc;
                int tc[2] = {b0 ? TC_TABLE[clip3(0, 53, qp + 2 * (b0 - 1) + tc_offset)] << sc : 0,
                             b1 ? TC_TABLE[clip3(0, 53, qp + 2 * (b1 - 1) + tc_offset)] << sc : 0};
                filter_luma(Y + size_t(y) * W + x, 1, W, beta, tc, maxv);
            }
            if (!y) continue;
            for (int x = x0 ? x0 - 8 : 0; x < x_end2; x += 8) {  // horizontal luma edges
                int b0 = bsh(x, y), b1 = bsh(x + 4, y);
                if (!b0 && !b1) continue;
                int qp = (qpy(x, y - 1) + qpy(x, y) + 1) >> 1;
                tc_offset = x >= x0 ? cur_tc : left_tc;
                beta_offset = x >= x0 ? cur_beta : left_beta;
                int beta = BETA_TABLE[clip3(0, 51, qp + beta_offset)] << sc;
                int tc[2] = {b0 ? TC_TABLE[clip3(0, 53, qp + 2 * (b0 - 1) + tc_offset)] << sc : 0,
                             b1 ? TC_TABLE[clip3(0, 53, qp + 2 * (b1 - 1) + tc_offset)] << sc : 0};
                filter_luma(Y + size_t(y) * W + x, W, 1, beta, tc, maxv);
            }
        }
        for (int c = 1; c <= 2; c++) {
            uint16_t* C = cur->plane(c);
            int CW = cur->stride(c);
            int x_end2c = x_end == W ? x_end : x_end - 16;
            for (int y = y0; y < y_end; y += 16) {  // bands of 16 luma rows
                for (int x = x0 ? x0 : 16; x < x_end; x += 16) {  // vertical chroma edges
                    int b0 = bsv(x, y), b1 = y + 8 < H ? bsv(x, y + 8) : 0;
                    if (b0 != 2 && b1 != 2) continue;
                    int tc[2] = {b0 == 2 ? chroma_tc((qpy(x - 1, y) + qpy(x, y) + 1) >> 1, c, tc_offset) : 0,
                                 b1 == 2 ? chroma_tc((qpy(x - 1, y + 8) + qpy(x, y + 8) + 1) >> 1, c, tc_offset) : 0};
                    filter_chroma(C + size_t(y / 2) * CW + x / 2, 1, CW, tc, maxv);
                }
                if (!y) continue;
                tc_offset = x0 ? left_tc : cur_tc;
                for (int x = x0 ? x0 - 16 : 0; x < x_end2c; x += 16) {  // horizontal chroma edges
                    int b0 = bsh(x, y), b1 = x + 8 < W ? bsh(x + 8, y) : 0;
                    if (b0 != 2 && b1 != 2) continue;
                    int tc[2] = {b0 == 2 ? chroma_tc((qpy(x, y - 1) + qpy(x, y) + 1) >> 1, c, tc_offset) : 0,
                                 b1 == 2 ? chroma_tc((qpy(x + 8, y - 1) + qpy(x + 8, y) + 1) >> 1, c, cur_tc) : 0};
                    filter_chroma(C + size_t(y / 2) * CW + x / 2, CW, 1, tc, maxv);
                }
            }
        }
    }

    // -- the in-loop filters in libavcodec's order (8.7) ---------------------------------

    // libavcodec filters while it decodes: after each CTB it deblocks the CTB
    // above-left of it (ff_hevc_hls_filters), and SAO lags one more CTB
    // (ff_hevc_hls_filter); SAO works in place, reading the neighbours it has
    // already filtered from the copies it kept of their deblocked borders, the
    // others from the picture as it stands.  Most samples it reads are then
    // final, but not all: with 16x16 CTBs the chroma edge along the top of a
    // CTB is deblocked with the CTB to its right, after the SAO of the CTBs
    // around it that read those samples.  The filters are run here in that
    // order, so that every sample reads what libavcodec's reads.
    void loop_filters() {
        boundary_strengths();
        int ctb = 1 << sps.log2_ctb, n = sps.ctb_w * sps.ctb_h;
        sao_on = false;
        if (sps.sao)
            for (const Slice& s : slices) sao_on |= s.sao_luma || s.sao_chroma;
        if (sao_on)
            for (int c = 0; c < 3; c++) {
                int sub = c ? 1 : 0;
                hbuf[c].assign(size_t(2 * sps.ctb_h) * (sps.width >> sub), 0);
                vbuf[c].assign(size_t(2 * sps.ctb_w) * (sps.height >> sub), 0);
                applied[c].assign(size_t(n), 0);
            }
        for (int a = 0; a < n; a++) {
            int x = (a % sps.ctb_w) * ctb, y = (a / sps.ctb_w) * ctb;
            bool x_end = x >= sps.width - ctb, y_end = y >= sps.height - ctb;
            if (y && x) filter_ctb(x - ctb, y - ctb);
            if (y && x_end) filter_ctb(x, y - ctb);
            if (x && y_end) filter_ctb(x - ctb, y);
        }
        filter_ctb((sps.ctb_w - 1) * ctb, (sps.ctb_h - 1) * ctb);
    }
    bool sao_on = false;
    std::vector<uint16_t> hbuf[3], vbuf[3];
    std::vector<uint8_t> applied[3];

    void filter_ctb(int x, int y) {  // ff_hevc_hls_filter
        int ctb = 1 << sps.log2_ctb;
        bool x_end = x >= sps.width - ctb, y_end = y >= sps.height - ctb;
        deblock_ctb(x, y);
        if (!sao_on) return;
        if (y && x) sao_ctb(x - ctb, y - ctb);
        if (x && y_end) sao_ctb(x - ctb, y);
        if (y && x_end) sao_ctb(x, y - ctb);
        if (x_end && y_end) sao_ctb(x, y);
    }

    // SAO of one CTB (8.7.3): libavcodec's sao_filter_CTB, which also leaves a
    // sample unchanged where a neighbour its class reads lies in another slice
    // and the CTB's own slice has slice_loop_filter_across_slices_enabled_flag
    // 0, whichever slice comes first (the standard reads the later slice's
    // flag for neighbours after it)
    void sao_ctb(int xl, int yl) {
        static const int DX[4][2] = {{-1, 1}, {0, 0}, {-1, 1}, {1, -1}}, DY[4][2] = {{0, 0}, {-1, 1}, {-1, 1}, {-1, 1}};
        static const int EDGE_IDX[5] = {1, 2, 0, 3, 4};
        int rx = xl >> sps.log2_ctb, ry = yl >> sps.log2_ctb, a = ry * sps.ctb_w + rx;
        const Sao& p = sao_params[size_t(a)];
        int own = ctb_slice[size_t(a)];
        bool across = slices[size_t(own)].lf_across;
        for (int c = 0; c < 3; c++) {
            if (!p.type[c]) continue;
            int sub = c ? 1 : 0, W = cur->stride(c), H = c ? cur->h / 2 : cur->h, ctb = (1 << sps.log2_ctb) >> sub;
            uint16_t* pl = cur->plane(c);
            int x0 = rx * ctb, y0 = ry * ctb, w = std::min(ctb, W - x0), h = std::min(ctb, H - y0);
            // the CTB's deblocked borders, kept for its neighbours (copy_CTB_to_hv)
            uint16_t* hb = hbuf[c].data();
            uint16_t* vb = vbuf[c].data();
            auto at = [&](int x, int y) { return pl[size_t(y) * W + x]; };
            // the source with a border of one sample, as libavcodec assembles it
            static thread_local std::vector<int> src;
            int sw = w + 2;
            src.assign(size_t(sw) * (h + 2), 0);
            auto S = [&](int x, int y) -> int& { return src[size_t(y + 1) * sw + (x + 1)]; };
            for (int y = 0; y < h; y++)
                for (int x = 0; x < w; x++) S(x, y) = at(x0 + x, y0 + y);
            auto done = [&](int cx, int cy) { return applied[c][size_t(cy * sps.ctb_w + cx)] != 0; };
            if (ry > 0) {
                for (int x = -1; x <= w; x++) {
                    int cx = x < 0 ? rx - 1 : x >= w ? rx + 1 : rx;
                    if (cx < 0 || cx >= sps.ctb_w || x0 + x >= W) continue;
                    S(x, -1) = done(cx, ry - 1) ? hb[size_t(2 * ry - 1) * W + x0 + x] : at(x0 + x, y0 - 1);
                }
            }
            if (y0 + h < H) {
                for (int x = -1; x <= w; x++) {
                    int cx = x < 0 ? rx - 1 : x >= w ? rx + 1 : rx;
                    if (cx < 0 || cx >= sps.ctb_w || x0 + x >= W) continue;
                    S(x, h) = done(cx, ry + 1) ? hb[size_t(2 * ry + 2) * W + x0 + x] : at(x0 + x, y0 + h);
                }
            }
            if (rx > 0)
                for (int y = 0; y < h; y++)
                    S(-1, y) = done(rx - 1, ry) ? vb[size_t(2 * rx - 1) * H + y0 + y] : at(x0 - 1, y0 + y);
            if (x0 + w < W)
                for (int y = 0; y < h; y++)
                    S(w, y) = done(rx + 1, ry) ? vb[size_t(2 * rx + 2) * H + y0 + y] : at(x0 + w, y0 + y);
            for (int x = 0; x < w; x++) {
                hb[size_t(2 * ry) * W + x0 + x] = uint16_t(S(x, 0));
                hb[size_t(2 * ry + 1) * W + x0 + x] = uint16_t(S(x, h - 1));
            }
            for (int y = 0; y < h; y++) {
                vb[size_t(2 * rx) * H + y0 + y] = uint16_t(S(0, y));
                vb[size_t(2 * rx + 1) * H + y0 + y] = uint16_t(S(w - 1, y));
            }
            applied[c][size_t(a)] = 1;
            if (p.type[c] == 1) {
                int table[32] = {0};
                for (int k = 0; k < 4; k++) table[(k + p.band[c]) & 31] = k + 1;
                for (int y = 0; y < h; y++)
                    for (int x = 0; x < w; x++) {
                        int v = S(x, y);
                        pl[size_t(y0 + y) * W + x0 + x] = uint16_t(clip3(0, maxv, v + p.offset[c][table[v >> (bd - 5)]]));
                    }
                continue;
            }
            int cls = p.eo_class[c];
            for (int y = 0; y < h; y++)
                for (int x = 0; x < w; x++) {
                    int ax = x + DX[cls][0], ay = y + DY[cls][0], bx = x + DX[cls][1], by = y + DY[cls][1];
                    int gax = x0 + ax, gay = y0 + ay, gbx = x0 + bx, gby = y0 + by;
                    if (gax < 0 || gay < 0 || gbx < 0 || gby < 0 || gax >= W || gbx >= W || gay >= H || gby >= H) continue;
                    if (!across && (ctb_slice[size_t((gay / ctb) * sps.ctb_w + gax / ctb)] != own ||
                                    ctb_slice[size_t((gby / ctb) * sps.ctb_w + gbx / ctb)] != own))
                        continue;
                    int v = S(x, y), va = S(ax, ay), vb2 = S(bx, by);
                    int e = 2 + (v > va) - (v < va) + (v > vb2) - (v < vb2);
                    pl[size_t(y0 + y) * W + x0 + x] = uint16_t(clip3(0, maxv, v + p.offset[c][EDGE_IDX[e]]));
                }
        }
    }

    // -- output ---------------------------------------------------------------------

    void out_size(int* wh) const {
        const Frame* f = out.get();
        if (f) {
            wh[0] = f->w - f->crop_right;
            wh[1] = f->h - f->crop_bottom;
            return;
        }
        wh[0] = wh[1] = 0;
        const Sps* s = have_sps ? &sps : nullptr;
        for (int i = 0; i < 16 && !s; i++)
            if (sps_list[i].valid) s = &sps_list[i];
        if (s) {
            wh[0] = s->width - s->crop_right;
            wh[1] = s->height - s->crop_bottom;
        }
    }

    // cv2's BGR24 (as RGB): libswscale's unscaled converter at 8 bits
    // (yuv420.h), its scaler above (swscale.h)
    void to_rgb(uint8_t* rgb) const {
        Frame* f = out.get();
        int wh[2];
        out_size(wh);
        if (f->bit_depth > 8)
            host::yuv420_high_to_rgb(f->plane(0), f->w, f->plane(1), f->plane(2), f->stride(1), wh[0], wh[1],
                                     f->bit_depth, f->matrix, f->full_range, f->chroma_loc, rgb);
        else
            host::yuv420_to_rgb(f->plane(0), f->w, f->plane(1), f->plane(2), f->stride(1), wh[0], wh[1],
                                host::yuv_coeffs(f->matrix, f->full_range), rgb);
    }
};

}  // namespace

extern "C" {

// 0: ok; 1: corrupt or truncated; 2: a stream not decoded here; 3: out of memory.

// A decoder for a stream whose samples hold NAL units behind big-endian
// lengths of `length_size` bytes (1, 2 or 4: hvcC), or, with 0, Annex B
// byte streams.  `cfg` is Annex B NAL units whose parameter sets are read
// (the hvcC's arrays, or an AVI stream's first sample; other units are skipped).
int hevc_open(const uint8_t* cfg, int64_t n, int length_size, void** state, char* err, int errlen) {
    Decoder* d = nullptr;
    int rc = guarded<Decoder>(nullptr, err, errlen, [&] {
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

// The size of the last picture output (before one: of the active or first
// SPS held): wh[0] width, wh[1] height, 0 without either.
int hevc_size(void* state, int* wh) {
    static_cast<Decoder*>(state)->out_size(wh);
    return OK;
}

// Decode one sample (an access unit) of index `sample`.  *shown is the index
// of the sample whose picture comes out next (the DPB's output process
// releases pictures in POC order; one a call, the rest at the next calls),
// -1 if none.
int hevc_decode(void* state, const uint8_t* data, int64_t n, int64_t sample, int64_t* shown, char* err,
                int errlen) {
    Decoder* d = static_cast<Decoder*>(state);
    *shown = -1;
    return guarded(d, err, errlen, [&] { *shown = d->decode(data, n, sample); });
}

// At the end of the stream: output the next picture held back; *shown its
// sample, -1 when none is left.
int hevc_drain(void* state, int64_t* shown) {
    *shown = static_cast<Decoder*>(state)->drain();
    return OK;
}

// The output delay: info[0] pictures waiting for output before the next
// comes out (the active SPS's sps_max_num_reorder_pics at its highest
// sub-layer; 0 before a picture), info[1] the same, info[2] 1.  libavcodec's
// HEVC decoder outputs by the SPS alone, not by has_b_frames: `set` is ignored.
int hevc_delay(void* state, int set, int* info) {
    Decoder* d = static_cast<Decoder*>(state);
    (void)set;
    info[0] = info[1] = d->have_sps ? d->sps.num_reorder : 0;
    info[2] = 1;
    return OK;
}

// The last picture output, cropped, as height x width x 3 RGB into `rgb`;
// 1 if there is none.
int hevc_rgb(void* state, uint8_t* rgb) {
    Decoder* d = static_cast<Decoder*>(state);
    if (!d->out) return CORRUPT;
    d->to_rgb(rgb);
    return OK;
}

// Read the parameter sets of a sample (a sync sample's, checked before
// decoding); other units are skipped.  *irap is 1 if it holds an IRAP slice.
int hevc_headers(void* state, const uint8_t* data, int64_t n, int* irap, char* err, int errlen) {
    Decoder* d = static_cast<Decoder*>(state);
    return guarded<Decoder>(nullptr, err, errlen, [&] { *irap = d->headers(data, n, d->length_size); });
}

// Forget every picture (a seek); the parameter sets stay.
int hevc_reset(void* state) {
    Decoder* d = static_cast<Decoder*>(state);
    d->reset();
    d->broken = false;
    return OK;
}

int hevc_close(void* state) {
    delete static_cast<Decoder*>(state);
    return OK;
}

// libswscale's conversion of `width` x `height` 4:2:0 planes of `depth` (9
// or 10) bits, packed (strides width and width / 2), to RGB (swscale.h):
// what cv2 makes of a Main 10 picture of matrix_coefficients `matrix`, its
// chroma sited at chroma_sample_loc_type `chroma_loc`.
int yuv420_high_rgb(const uint16_t* y, const uint16_t* u, const uint16_t* v, int width, int height, int depth,
                    int matrix, int full_range, int chroma_loc, uint8_t* rgb) {
    if (width < 2 || height < 2 || (width | height) & 1 || depth < 9 || depth > 10 || chroma_loc < 0 ||
        chroma_loc > 5)
        return UNSUPPORTED;
    host::yuv420_high_to_rgb(y, width, u, v, width / 2, width, height, depth, matrix, full_range != 0, chroma_loc,
                             rgb);
    return OK;
}

}  // extern "C"
