// What the host library's NAL-unit video decoders (h264.cpp, hevc.cpp)
// share around their syntax: the error codes and the exception that
// carries one to the C interface, the RBSP bit reader, the split of a
// sample into NAL units (length-prefixed or Annex B) and the removal of
// emulation prevention bytes.
#pragma once

#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <vector>

namespace host {

// 0: ok; 1: corrupt or truncated (ValueError); 2: a stream not decoded here
// (NotImplementedError); 3: out of memory
enum { OK = 0, CORRUPT = 1, UNSUPPORTED = 2, NOMEM = 3 };

struct Fail {
    int rc;
    char msg[200];
};

[[noreturn]] inline void fail(int rc, const char* fmt, ...) __attribute__((format(printf, 2, 3)));
inline void fail(int rc, const char* fmt, ...) {
    Fail f;
    f.rc = rc;
    va_list ap;
    va_start(ap, fmt);
    vsnprintf(f.msg, sizeof f.msg, fmt, ap);
    va_end(ap);
    throw f;
}

inline void copy_msg(char* err, int errlen, const char* msg) {
    if (err && errlen > 0) {
        strncpy(err, msg, size_t(errlen) - 1);
        err[errlen - 1] = 0;
    }
}

// `body` under the C interface's contract: a Fail or an allocation failure
// becomes its code and message, and resets the decoder `d` (if any)
template <class D, class F>
int guarded(D* d, char* err, int errlen, F&& body) {
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
    void skip(int64_t n) {
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
    int32_t se_range(int lo, int hi, const char* what) {
        int32_t v = se();
        if (v < lo || v > hi) fail(CORRUPT, "%s %d out of range", what, v);
        return v;
    }
    bool more() const { return pos < nbits; }
    int bit() {  // CABAC's reads, which end on the rbsp_stop_one_bit
        if (pos > nbits) fail(CORRUPT, "data cut short");
        int v = (d[pos >> 3] >> (7 - (pos & 7))) & 1;
        pos++;
        return v;
    }
    void align() { pos = (pos + 7) & ~int64_t(7); }
};

// ---- NAL units --------------------------------------------------------------

struct NalRef {
    const uint8_t* p;
    int64_t n;
};

// a sample's NAL units: behind big-endian lengths of `length_size` bytes, or
// (0) after Annex B start codes, trailing zeros dropped
inline std::vector<NalRef> split_nals(const uint8_t* d, int64_t n, int length_size) {
    std::vector<NalRef> out;
    if (length_size) {
        int64_t at = 0;
        while (at < n) {
            if (at + length_size > n) fail(CORRUPT, "a NAL unit length cut short");
            int64_t len = 0;
            for (int i = 0; i < length_size; i++) len = (len << 8) | d[at + i];
            at += length_size;
            if (len > n - at) fail(CORRUPT, "a NAL unit of %lld bytes past the sample's end", (long long)len);
            if (len) out.push_back({d + at, len});
            at += len;
        }
        return out;
    }
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

// the RBSP of a NAL unit's payload: emulation_prevention_three_byte removed;
// `removed` (if given) gets the RBSP position of the byte each one stood before
inline void unescape(const uint8_t* p, int64_t n, std::vector<uint8_t>& out,
                     std::vector<int64_t>* removed = nullptr) {
    out.clear();
    out.reserve(size_t(n));
    if (removed) removed->clear();
    int zeros = 0;
    for (int64_t i = 0; i < n; i++) {
        uint8_t c = p[i];
        if (zeros >= 2 && c <= 3) {
            if (c != 3) fail(CORRUPT, "a start code inside a NAL unit");
            if (removed) removed->push_back(int64_t(out.size()));
            zeros = 0;
            continue;
        }
        out.push_back(c);
        zeros = c ? 0 : zeros + 1;
    }
}

}  // namespace host
