// Zstandard decoder (RFC 8878) with crc32c and xxh64 (C ABI, loaded via
// ctypes; built by ance_tpu_torch/utils/native_build.py).
//
// Reads the JAX package's orbax checkpoints, whose OCDBT nodes and zarr
// chunks are zstd frames, without a zstd library. Decompression only:
//
//   * frames: header, window descriptor, single segment, content size,
//     dictionary id 0 only, optional xxh64 content checksum (checked);
//   * raw, RLE and compressed blocks;
//   * literals: raw, RLE, Huffman with 1 or 4 streams, treeless (the
//     previous block's Huffman table);
//   * sequences: predefined, RLE, FSE and repeat modes, repeat offsets;
//   * skippable frames and any number of frames in a row.
//
// The whole output of a call is one flat buffer the caller sizes, so a
// match reads back into it directly (the window is the frame's output so
// far). A corrupt input returns -1 with a message naming the byte offset
// and the check that failed; a buffer too small returns -2. No call
// returns fewer bytes than the frames declare.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Corrupt {
    std::string what;
};

[[noreturn]] void fail(size_t at, const char* what) {
    char buf[256];
    std::snprintf(buf, sizeof buf, "byte %zu: %s", at, what);
    throw Corrupt{buf};
}

struct TooSmall {};

inline int highbit(uint64_t v) { return 63 - __builtin_clzll(v); }

inline uint32_t rd32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

inline uint64_t rd64(const uint8_t* p) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    return v;
}

// ---- xxh64 --------------------------------------------------------------

constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t xround(uint64_t acc, uint64_t in) {
    return rotl(acc + in * P2, 31) * P1;
}

inline uint64_t xmerge(uint64_t acc, uint64_t v) {
    return (acc ^ xround(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
    const uint8_t* end = p + n;
    uint64_t h;
    if (n >= 32) {
        uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed,
                 v4 = seed - P1;
        const uint8_t* limit = end - 32;
        do {
            v1 = xround(v1, rd64(p));
            v2 = xround(v2, rd64(p + 8));
            v3 = xround(v3, rd64(p + 16));
            v4 = xround(v4, rd64(p + 24));
            p += 32;
        } while (p <= limit);
        h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
        h = xmerge(h, v1);
        h = xmerge(h, v2);
        h = xmerge(h, v3);
        h = xmerge(h, v4);
    } else {
        h = seed + P5;
    }
    h += n;
    for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, rd64(p)), 27) * P1 + P4;
    if (p + 4 <= end) {
        h = rotl(h ^ (uint64_t(rd32(p)) * P1), 23) * P2 + P3;
        p += 4;
    }
    for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    h ^= h >> 32;
    return h;
}

// ---- crc32c (Castagnoli), slicing by 8 ----------------------------------

struct Crc32cTable {
    uint32_t t[8][256];
    Crc32cTable() {
        for (uint32_t i = 0; i < 256; ++i) {
            uint32_t c = i;
            for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
            t[0][i] = c;
        }
        for (uint32_t i = 0; i < 256; ++i)
            for (int s = 1; s < 8; ++s) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xff];
    }
};

const Crc32cTable& crc_table() {
    static const Crc32cTable table;
    return table;
}

uint32_t crc32c(const uint8_t* p, size_t n, uint32_t crc) {
    const auto& t = crc_table().t;
    crc = ~crc;
    for (; n >= 8; n -= 8, p += 8) {
        uint64_t v = rd64(p) ^ crc;
        crc = t[7][v & 0xff] ^ t[6][(v >> 8) & 0xff] ^ t[5][(v >> 16) & 0xff] ^
              t[4][(v >> 24) & 0xff] ^ t[3][(v >> 32) & 0xff] ^
              t[2][(v >> 40) & 0xff] ^ t[1][(v >> 48) & 0xff] ^ t[0][v >> 56];
    }
    for (; n; --n, ++p) crc = (crc >> 8) ^ t[0][(crc ^ *p) & 0xff];
    return ~crc;
}

// ---- bit readers ----------------------------------------------------------

// Little-endian bits read forward (FSE table descriptions).
struct ForwardBits {
    const uint8_t* p;
    size_t n;       // bytes
    size_t base;    // input offset of p, for messages
    size_t bit = 0;
    uint32_t read(int nb) {
        if (bit + nb > n * 8) fail(base + n, "FSE table description runs past its section");
        uint32_t v = 0;
        for (int i = 0; i < nb; ++i, ++bit) v |= uint32_t((p[bit >> 3] >> (bit & 7)) & 1) << i;
        return v;
    }
    size_t bytes_used() const { return (bit + 7) >> 3; }
};

// A zstd backward bitstream: the last byte's highest set bit marks its end;
// bits are read from the end towards the start; bits before the start
// read as zero (and leave ``pos`` negative, which callers check).
struct BackBits {
    const uint8_t* p;
    size_t n;
    int64_t pos;  // bits left before the read head
    BackBits(const uint8_t* p_, size_t n_, size_t at) : p(p_), n(n_) {
        if (n == 0) fail(at, "empty bitstream");
        uint8_t last = p[n - 1];
        if (last == 0) fail(at + n - 1, "bitstream's last byte has no end mark");
        pos = int64_t(n) * 8 - (8 - highbit(last));
    }
    inline uint64_t window(int64_t bitpos) const {  // 64 bits from bitpos, zero past the end
        size_t byte = size_t(bitpos >> 3);
        uint64_t v;
        if (byte + 8 <= n) {
            v = rd64(p + byte);
        } else {
            uint8_t tmp[8] = {0, 0, 0, 0, 0, 0, 0, 0};
            std::memcpy(tmp, p + byte, n - byte);
            std::memcpy(&v, tmp, 8);
        }
        return v >> (bitpos & 7);
    }
    inline uint64_t read(int nb) {  // nb <= 56
        if (nb == 0) return 0;
        pos -= nb;
        if (pos >= 0) return window(pos) & ((uint64_t(1) << nb) - 1);
        int64_t have = pos + nb;  // bits still above 0
        if (have <= 0) return 0;
        return (window(0) & ((uint64_t(1) << have) - 1)) << (-pos);
    }
};

// ---- FSE ---------------------------------------------------------------

struct FseTable {
    int log = -1;  // -1: none yet
    std::vector<uint8_t> symbol;
    std::vector<uint8_t> bits;
    std::vector<uint16_t> base;
};

void fse_build(FseTable& t, const int16_t* norm, int nsym, int log, size_t at) {
    const uint32_t size = 1u << log;
    t.log = log;
    t.symbol.assign(size, 0);
    t.bits.assign(size, 0);
    t.base.assign(size, 0);
    std::vector<uint16_t> next(nsym > 0 ? nsym : 1, 0);
    uint32_t high = size;
    for (int s = 0; s < nsym; ++s)
        if (norm[s] == -1) {
            if (high == 0) fail(at, "FSE table has more cells than its size");
            t.symbol[--high] = uint8_t(s);
            next[s] = 1;
        }
    const uint32_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
    uint32_t pos = 0;
    for (int s = 0; s < nsym; ++s) {
        if (norm[s] <= 0) continue;
        next[s] = uint16_t(norm[s]);
        for (int i = 0; i < norm[s]; ++i) {
            t.symbol[pos] = uint8_t(s);
            do {
                pos = (pos + step) & mask;
            } while (pos >= high);
        }
    }
    if (pos != 0) fail(at, "FSE distribution does not fill its table");
    for (uint32_t i = 0; i < size; ++i) {
        uint32_t d = next[t.symbol[i]]++;
        int nb = log - highbit(d);
        t.bits[i] = uint8_t(nb);
        t.base[i] = uint16_t((d << nb) - size);
    }
}

// Reads an FSE table description; returns the bytes it took.
size_t fse_read(FseTable& t, const uint8_t* p, size_t n, size_t at, int max_log, int max_sym) {
    ForwardBits in{p, n, at};
    int log = int(in.read(4)) + 5;
    if (log > max_log) fail(at, "FSE accuracy log above the maximum");
    int32_t remaining = 1 << log;
    int16_t norm[256];
    int sym = 0;
    while (remaining > 0 && sym <= max_sym) {
        int nb = highbit(uint64_t(remaining) + 1) + 1;
        uint32_t val = in.read(nb);
        uint32_t lower = (1u << (nb - 1)) - 1;
        uint32_t threshold = (1u << nb) - 1 - (uint32_t(remaining) + 1);
        if ((val & lower) < threshold) {
            in.bit -= 1;
            val &= lower;
        } else if (val > lower) {
            val -= threshold;
        }
        int proba = int(val) - 1;
        remaining -= proba < 0 ? -proba : proba;
        norm[sym++] = int16_t(proba);
        if (proba == 0) {
            uint32_t rep = in.read(2);
            for (;;) {
                for (uint32_t i = 0; i < rep && sym <= max_sym; ++i) norm[sym++] = 0;
                if (rep != 3) break;
                rep = in.read(2);
            }
        }
    }
    if (remaining != 0) fail(at, "FSE probabilities do not sum to the table size");
    if (sym > max_sym + 1) fail(at, "FSE table names a symbol above the maximum");
    fse_build(t, norm, sym, log, at);
    return in.bytes_used();
}

void fse_rle(FseTable& t, uint8_t s) {
    t.log = 0;
    t.symbol.assign(1, s);
    t.bits.assign(1, 0);
    t.base.assign(1, 0);
}

// ---- Huffman -------------------------------------------------------------

struct HufTable {
    int max_bits = 0;  // 0: none yet
    std::vector<uint8_t> symbol;
    std::vector<uint8_t> bits;
};

// Builds the table from the weights of every symbol but the last.
void huf_from_weights(HufTable& t, const uint8_t* w, int nw, size_t at) {
    if (nw + 1 > 256) fail(at, "Huffman table with more than 256 symbols");
    uint64_t sum = 0;
    for (int i = 0; i < nw; ++i) {
        if (w[i] > 11) fail(at, "Huffman weight above 11");
        if (w[i]) sum += uint64_t(1) << (w[i] - 1);
    }
    if (sum == 0) fail(at, "Huffman weights are all zero");
    int max_bits = highbit(sum) + 1;
    uint64_t left = (uint64_t(1) << max_bits) - sum;
    if (left & (left - 1)) fail(at, "Huffman weights leave no power of two for the last");
    if (max_bits > 11) fail(at, "Huffman code longer than 11 bits");
    int last = highbit(left) + 1;
    uint8_t nbits[256];
    for (int i = 0; i < nw; ++i) nbits[i] = w[i] ? uint8_t(max_bits + 1 - w[i]) : 0;
    nbits[nw] = uint8_t(max_bits + 1 - last);
    int nsym = nw + 1;
    uint32_t size = 1u << max_bits;
    t.max_bits = max_bits;
    t.symbol.assign(size, 0);
    t.bits.assign(size, 0);
    uint32_t count[13] = {0}, start[13] = {0};
    for (int i = 0; i < nsym; ++i) count[nbits[i]]++;
    start[max_bits] = 0;
    for (int b = max_bits; b >= 1; --b) {
        start[b - 1] = start[b] + count[b] * (1u << (max_bits - b));
        if (start[b - 1] > size) fail(at, "Huffman code lengths overfill the table");
        std::memset(&t.bits[start[b]], b, start[b - 1] - start[b]);
    }
    if (start[0] != size) fail(at, "Huffman code lengths do not fill the table");
    for (int i = 0; i < nsym; ++i) {
        if (!nbits[i]) continue;
        uint32_t len = 1u << (max_bits - nbits[i]);
        std::memset(&t.symbol[start[nbits[i]]], i, len);
        start[nbits[i]] += len;
    }
}

// Reads a Huffman tree description; returns the bytes it took.
size_t huf_read(HufTable& t, const uint8_t* p, size_t n, size_t at) {
    if (n < 1) fail(at, "missing Huffman tree description");
    uint8_t hb = p[0];
    uint8_t w[256];
    int nw = 0;
    size_t used;
    if (hb >= 128) {
        nw = hb - 127;
        used = 1 + size_t(nw + 1) / 2;
        if (used > n) fail(at, "Huffman weights run past the literals section");
        for (int i = 0; i < nw; ++i) {
            uint8_t b = p[1 + i / 2];
            w[i] = (i & 1) ? (b & 15) : (b >> 4);
        }
    } else {
        used = 1 + size_t(hb);
        if (used > n) fail(at, "Huffman weights run past the literals section");
        FseTable ft;
        size_t hdr = fse_read(ft, p + 1, hb, at + 1, 6, 255);
        if (hdr >= hb) fail(at + 1, "FSE-compressed Huffman weights have no bitstream");
        BackBits bs(p + 1 + hdr, hb - hdr, at + 1 + hdr);
        uint32_t s1 = uint32_t(bs.read(ft.log)), s2 = uint32_t(bs.read(ft.log));
        for (;;) {
            if (nw >= 255) fail(at, "too many FSE-compressed Huffman weights");
            w[nw++] = ft.symbol[s1];
            s1 = ft.base[s1] + uint32_t(bs.read(ft.bits[s1]));
            if (bs.pos < 0) {
                if (nw >= 255) fail(at, "too many FSE-compressed Huffman weights");
                w[nw++] = ft.symbol[s2];
                break;
            }
            if (nw >= 255) fail(at, "too many FSE-compressed Huffman weights");
            w[nw++] = ft.symbol[s2];
            s2 = ft.base[s2] + uint32_t(bs.read(ft.bits[s2]));
            if (bs.pos < 0) {
                if (nw >= 255) fail(at, "too many FSE-compressed Huffman weights");
                w[nw++] = ft.symbol[s1];
                break;
            }
        }
    }
    huf_from_weights(t, w, nw, at);
    return used;
}

// One backward Huffman stream decoding ``count`` symbols into ``out``.
// The next ``max_bits`` bits of the stream index the table, which gives
// the symbol and the bits its code takes. While at least 57 bits remain,
// ``four`` decodes four symbols from one 64-bit load; ``finish`` decodes
// the rest and checks that the stream ends with the last symbol.
struct HufCursor {
    BackBits bs;
    int64_t pos;
    uint8_t* out;
    size_t count, i = 0, at;
    HufCursor(const uint8_t* p, size_t n, size_t at_, uint8_t* out_, size_t count_)
        : bs(p, n, at_), pos(bs.pos), out(out_), count(count_), at(at_) {}
    bool fast() const { return pos >= 57 && i + 4 <= count; }
    inline void four(const uint8_t* sym, const uint8_t* bits, int mb) {
        const int64_t start = pos - 57;
        uint64_t w = (rd64(bs.p + (start >> 3)) >> (start & 7)) << 7;
        for (int k = 0; k < 4; ++k) {
            const uint32_t v = uint32_t(w >> (64 - mb));
            out[i++] = sym[v];
            const int nb = bits[v];
            w <<= nb;
            pos -= nb;
        }
    }
    void finish(const HufTable& t) {
        const int mb = t.max_bits;
        const uint32_t mask = (1u << mb) - 1;
        while (fast()) four(t.symbol.data(), t.bits.data(), mb);
        for (; i < count; ++i) {
            uint32_t v;
            if (pos >= mb) {
                v = uint32_t(bs.window(pos - mb)) & mask;
            } else if (pos > 0) {
                v = (uint32_t(bs.window(0)) & ((1u << pos) - 1)) << (mb - pos);
            } else {
                v = 0;
            }
            out[i] = t.symbol[v];
            pos -= t.bits[v];
        }
        if (pos != 0) fail(at, "Huffman stream length disagrees with its symbol count");
    }
};

// The four streams of a literals section, decoded in lockstep while each
// has bits for a 64-bit load (independent streams keep the core busy).
void huf_four_streams(const HufTable& t, HufCursor* c) {
    const uint8_t* sym = t.symbol.data();
    const uint8_t* bits = t.bits.data();
    const int mb = t.max_bits;
    while (c[0].fast() && c[1].fast() && c[2].fast() && c[3].fast()) {
        c[0].four(sym, bits, mb);
        c[1].four(sym, bits, mb);
        c[2].four(sym, bits, mb);
        c[3].four(sym, bits, mb);
    }
    for (int k = 0; k < 4; ++k) c[k].finish(t);
}

// ---- sequences -------------------------------------------------------

const uint32_t LL_BASE[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  12,   13,   14,   15,   16,
                              17, 18, 19, 20, 21, 22, 23, 24,  25,  26,   27,   28,   29,   30,
                              31, 32, 33, 34, 35, 37, 39, 41,  43,  47,   51,   59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

// Per-frame state that later blocks reuse.
struct FrameState {
    HufTable huf;
    FseTable ll, of, ml;
    uint32_t rep[3] = {1, 4, 8};
    std::vector<uint8_t> literals;
};

size_t read_table(FseTable& t, int mode, const int16_t* def, int def_n, int def_log, int max_log,
                  int max_sym, const uint8_t* p, size_t n, size_t at, const char* name) {
    char msg[128];
    switch (mode) {
        case 0:
            fse_build(t, def, def_n, def_log, at);
            return 0;
        case 1:
            if (n < 1) fail(at, "missing RLE symbol of a sequence table");
            if (p[0] > max_sym) {
                std::snprintf(msg, sizeof msg, "%s RLE symbol above the maximum", name);
                fail(at, msg);
            }
            fse_rle(t, p[0]);
            return 1;
        case 2:
            return fse_read(t, p, n, at, max_log, max_sym);
        default:
            if (t.log < 0) {
                std::snprintf(msg, sizeof msg, "%s table repeated with none before it", name);
                fail(at, msg);
            }
            return 0;
    }
}

// Decodes one compressed block of ``n`` bytes at ``p`` (input offset
// ``at``) onto ``out`` at ``*pos`` (``frame_start``: where the frame's
// output begins; ``cap``: the buffer's size).
void decode_block(FrameState& fs, const uint8_t* p, size_t n, size_t at, uint8_t* out,
                  size_t* pos, size_t frame_start, size_t cap) {
    if (n < 1) fail(at, "empty compressed block");
    // literals section
    const uint8_t b0 = p[0];
    const int ltype = b0 & 3, sfmt = (b0 >> 2) & 3;
    size_t regen = 0, csize = 0, hdr = 0;
    int streams = 1;
    if (ltype < 2) {
        if (sfmt == 0 || sfmt == 2) {
            regen = b0 >> 3;
            hdr = 1;
        } else if (sfmt == 1) {
            if (n < 2) fail(at, "truncated literals header");
            regen = (b0 >> 4) + (size_t(p[1]) << 4);
            hdr = 2;
        } else {
            if (n < 3) fail(at, "truncated literals header");
            regen = (b0 >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
            hdr = 3;
        }
    } else {
        streams = sfmt == 0 ? 1 : 4;
        hdr = sfmt < 2 ? 3 : sfmt == 2 ? 4 : 5;
        if (n < hdr) fail(at, "truncated literals header");
        uint64_t v = 0;
        for (size_t i = 0; i < hdr; ++i) v |= uint64_t(p[i]) << (8 * i);
        int fieldbits = sfmt < 2 ? 10 : sfmt == 2 ? 14 : 18;
        regen = (v >> 4) & ((uint64_t(1) << fieldbits) - 1);
        csize = (v >> (4 + fieldbits)) & ((uint64_t(1) << fieldbits) - 1);
    }
    if (regen > 131072) fail(at, "literals section above 128 KiB");
    fs.literals.resize(regen);
    uint8_t* lit = fs.literals.data();
    size_t q = hdr;
    if (ltype == 0) {
        if (q + regen > n) fail(at, "raw literals run past the block");
        std::memcpy(lit, p + q, regen);
        q += regen;
    } else if (ltype == 1) {
        if (q + 1 > n) fail(at, "RLE literals run past the block");
        std::memset(lit, p[q], regen);
        q += 1;
    } else {
        if (q + csize > n) fail(at + q, "compressed literals run past the block");
        const uint8_t* c = p + q;
        size_t cn = csize, cat = at + q;
        if (ltype == 2) {
            size_t used = huf_read(fs.huf, c, cn, cat);
            c += used;
            cn -= used;
            cat += used;
        } else if (fs.huf.max_bits == 0) {
            fail(at, "treeless literals with no Huffman table before them");
        }
        if (streams == 1) {
            HufCursor(c, cn, cat, lit, regen).finish(fs.huf);
        } else {
            if (cn < 10) fail(cat, "four Huffman streams in fewer than 10 bytes");
            size_t s1 = c[0] | (size_t(c[1]) << 8), s2 = c[2] | (size_t(c[3]) << 8),
                   s3 = c[4] | (size_t(c[5]) << 8);
            if (6 + s1 + s2 + s3 > cn) fail(cat, "Huffman jump table runs past the literals");
            size_t s4 = cn - 6 - s1 - s2 - s3;
            size_t per = (regen + 3) / 4;
            if (3 * per > regen) fail(cat, "too few literals for four Huffman streams");
            const uint8_t* sp = c + 6;
            size_t sat = cat + 6;
            HufCursor cur[4] = {
                {sp, s1, sat, lit, per},
                {sp + s1, s2, sat + s1, lit + per, per},
                {sp + s1 + s2, s3, sat + s1 + s2, lit + 2 * per, per},
                {sp + s1 + s2 + s3, s4, sat + s1 + s2 + s3, lit + 3 * per, regen - 3 * per}};
            huf_four_streams(fs.huf, cur);
        }
        q += csize;
    }
    // sequences section
    if (q >= n) fail(at + q, "missing sequences section");
    size_t nseq = p[q];
    if (nseq < 128) {
        q += 1;
    } else if (nseq < 255) {
        if (q + 2 > n) fail(at + q, "truncated sequence count");
        nseq = ((nseq - 128) << 8) + p[q + 1];
        q += 2;
    } else {
        if (q + 3 > n) fail(at + q, "truncated sequence count");
        nseq = p[q + 1] + (size_t(p[q + 2]) << 8) + 0x7F00;
        q += 3;
    }
    size_t o = *pos;
    size_t li = 0;  // literals consumed
    if (nseq > 0) {
        if (q >= n) fail(at + q, "missing sequence compression modes");
        uint8_t modes = p[q];
        if (modes & 3) fail(at + q, "reserved bits of the sequence modes set");
        q += 1;
        q += read_table(fs.ll, modes >> 6, LL_DEFAULT, 36, 6, 9, 35, p + q, n - q, at + q,
                        "literal length");
        q += read_table(fs.of, (modes >> 4) & 3, OF_DEFAULT, 29, 5, 8, 31, p + q, n - q, at + q,
                        "offset");
        q += read_table(fs.ml, (modes >> 2) & 3, ML_DEFAULT, 53, 6, 9, 52, p + q, n - q, at + q,
                        "match length");
        if (q >= n) fail(at + q, "missing sequences bitstream");
        BackBits bs(p + q, n - q, at + q);
        uint32_t sll = uint32_t(bs.read(fs.ll.log)), sof = uint32_t(bs.read(fs.of.log)),
                 sml = uint32_t(bs.read(fs.ml.log));
        uint32_t* rep = fs.rep;
        for (size_t s = 0; s < nseq; ++s) {
            uint8_t ofc = fs.of.symbol[sof], llc = fs.ll.symbol[sll], mlc = fs.ml.symbol[sml];
            if (llc > 35 || mlc > 52 || ofc > 31) fail(at + q, "sequence code above the maximum");
            uint32_t ofv = (uint32_t(1) << ofc) + uint32_t(bs.read(ofc));
            uint32_t ml = ML_BASE[mlc] + uint32_t(bs.read(ML_BITS[mlc]));
            uint32_t ll = LL_BASE[llc] + uint32_t(bs.read(LL_BITS[llc]));
            if (s + 1 < nseq) {
                sll = fs.ll.base[sll] + uint32_t(bs.read(fs.ll.bits[sll]));
                sml = fs.ml.base[sml] + uint32_t(bs.read(fs.ml.bits[sml]));
                sof = fs.of.base[sof] + uint32_t(bs.read(fs.of.bits[sof]));
            }
            uint32_t offset;
            if (ofv > 3) {
                offset = ofv - 3;
                rep[2] = rep[1];
                rep[1] = rep[0];
                rep[0] = offset;
            } else {
                uint32_t idx = ofv - 1 + (ll == 0 ? 1 : 0);
                if (idx == 0) {
                    offset = rep[0];
                } else {
                    offset = idx < 3 ? rep[idx] : rep[0] - 1;
                    if (offset == 0) fail(at + q, "repeat offset of zero");
                    if (idx > 1) rep[2] = rep[1];
                    rep[1] = rep[0];
                    rep[0] = offset;
                }
            }
            if (li + ll > regen) fail(at + q, "sequence takes more literals than the block has");
            if (o + ll + ml > cap) throw TooSmall{};
            std::memcpy(out + o, lit + li, ll);
            o += ll;
            li += ll;
            if (offset > o - frame_start) fail(at + q, "match offset reaches before the frame");
            uint8_t* d = out + o;
            const uint8_t* src = d - offset;
            if (offset >= ml) {
                std::memcpy(d, src, ml);
            } else if (offset >= 8) {
                for (uint32_t i = 0; i < ml; i += 8) std::memcpy(d + i, src + i, ml - i < 8 ? ml - i : 8);
            } else {
                for (uint32_t i = 0; i < ml; ++i) d[i] = src[i];
            }
            o += ml;
        }
        if (bs.pos != 0) fail(at + q, "sequences bitstream length disagrees with its count");
    } else if (q != n) {
        fail(at + q, "bytes after a block with no sequences");
    }
    size_t rest = regen - li;
    if (o + rest > cap) throw TooSmall{};
    std::memcpy(out + o, lit + li, rest);
    o += rest;
    if (o - *pos > 131072) fail(at, "block decodes to more than 128 KiB");
    *pos = o;
}

struct FrameHeader {
    size_t header_bytes = 0;
    bool checksum = false;
    bool single = false;
    int64_t content = -1;  // -1: not declared
    uint64_t window = 0;
};

FrameHeader read_header(const uint8_t* p, size_t n, size_t at) {
    FrameHeader h;
    if (n < 5) fail(at, "truncated frame header");
    uint8_t d = p[4];
    int fcs_flag = d >> 6;
    h.single = (d >> 5) & 1;
    if (d & 8) fail(at + 4, "reserved bit of the frame header set");
    h.checksum = (d >> 2) & 1;
    int did = d & 3;
    size_t q = 5;
    if (!h.single) {
        if (q >= n) fail(at, "truncated frame header");
        uint8_t wd = p[q++];
        int exponent = wd >> 3, mantissa = wd & 7;
        uint64_t base = uint64_t(1) << (10 + exponent);
        h.window = base + (base / 8) * mantissa;
    }
    static const int did_bytes[4] = {0, 1, 2, 4};
    static const int fcs_bytes[4] = {0, 2, 4, 8};
    size_t nd = did_bytes[did], nf = fcs_bytes[fcs_flag];
    if (fcs_flag == 0 && h.single) nf = 1;
    if (q + nd + nf > n) fail(at, "truncated frame header");
    uint64_t dict = 0;
    for (size_t i = 0; i < nd; ++i) dict |= uint64_t(p[q + i]) << (8 * i);
    if (dict != 0) fail(at, "frame needs a dictionary (only dictionary id 0 is read)");
    q += nd;
    if (nf) {
        uint64_t fcs = 0;
        for (size_t i = 0; i < nf; ++i) fcs |= uint64_t(p[q + i]) << (8 * i);
        if (nf == 2) fcs += 256;
        h.content = int64_t(fcs);
        q += nf;
    }
    if (h.single) h.window = h.content < 0 ? 0 : uint64_t(h.content);
    h.header_bytes = q;
    return h;
}

const uint32_t ZSTD_MAGIC = 0xFD2FB528u;

inline bool skippable(uint32_t magic) { return (magic & 0xFFFFFFF0u) == 0x184D2A50u; }

// Walks the frames' headers; returns the sum of declared content sizes, or
// -1 when a frame does not declare its own.
int64_t content_size(const uint8_t* src, size_t n) {
    size_t at = 0;
    int64_t total = 0;
    bool known = true;
    while (at < n) {
        if (n - at < 4) fail(at, "truncated frame magic");
        uint32_t magic = rd32(src + at);
        if (skippable(magic)) {
            if (n - at < 8) fail(at, "truncated skippable frame");
            uint64_t len = rd32(src + at + 4);
            if (len > n - at - 8) fail(at, "skippable frame runs past the input");
            at += 8 + len;
            continue;
        }
        if (magic != ZSTD_MAGIC) fail(at, "not a zstd frame (bad magic number)");
        FrameHeader h = read_header(src + at, n - at, at);
        if (h.content < 0) known = false;
        else total += h.content;
        size_t q = at + h.header_bytes;
        for (;;) {
            if (n - q < 3) fail(q, "truncated block header");
            uint32_t bh = src[q] | (uint32_t(src[q + 1]) << 8) | (uint32_t(src[q + 2]) << 16);
            uint32_t type = (bh >> 1) & 3, size = bh >> 3;
            size_t body = type == 1 ? 1 : size;
            if (type == 3) fail(q, "reserved block type");
            if (body > n - q - 3) fail(q, "block runs past the input");
            q += 3 + body;
            if (bh & 1) break;
        }
        if (h.checksum) q += 4;
        if (q > n) fail(n, "truncated content checksum");
        at = q;
    }
    return known ? total : -1;
}

size_t decode_all(const uint8_t* src, size_t n, uint8_t* out, size_t cap) {
    size_t at = 0, o = 0;
    FrameState fs;
    while (at < n) {
        if (n - at < 4) fail(at, "truncated frame magic");
        uint32_t magic = rd32(src + at);
        if (skippable(magic)) {
            if (n - at < 8) fail(at, "truncated skippable frame");
            uint64_t len = rd32(src + at + 4);
            if (len > n - at - 8) fail(at, "skippable frame runs past the input");
            at += 8 + len;
            continue;
        }
        if (magic != ZSTD_MAGIC) fail(at, "not a zstd frame (bad magic number)");
        const size_t frame_at = at;
        FrameHeader h = read_header(src + at, n - at, at);
        fs.huf.max_bits = 0;
        fs.ll.log = fs.of.log = fs.ml.log = -1;
        fs.rep[0] = 1;
        fs.rep[1] = 4;
        fs.rep[2] = 8;
        const size_t frame_start = o;
        size_t q = at + h.header_bytes;
        const uint64_t block_max = h.window && h.window < 131072 ? h.window : 131072;
        // a frame that declares its size may not write past it
        const bool bounded = h.content >= 0 && frame_start + uint64_t(h.content) <= cap;
        const size_t fcap = bounded ? frame_start + size_t(h.content) : cap;
        try {
        for (;;) {
            if (n - q < 3) fail(q, "truncated block header");
            uint32_t bh = src[q] | (uint32_t(src[q + 1]) << 8) | (uint32_t(src[q + 2]) << 16);
            bool last = bh & 1;
            uint32_t type = (bh >> 1) & 3, size = bh >> 3;
            size_t bq = q + 3;
            if (type == 3) fail(q, "reserved block type");
            if (type != 1 && size > n - bq) fail(q, "block runs past the input");
            if (size > block_max && type != 2) fail(q, "block larger than its maximum size");
            if (type == 0) {
                if (o + size > fcap) throw TooSmall{};
                std::memcpy(out + o, src + bq, size);
                o += size;
                q = bq + size;
            } else if (type == 1) {
                if (n - bq < 1) fail(q, "block runs past the input");
                if (o + size > fcap) throw TooSmall{};
                std::memset(out + o, src[bq], size);
                o += size;
                q = bq + 1;
            } else {
                if (size > block_max) fail(q, "compressed block larger than its maximum size");
                decode_block(fs, src + bq, size, bq, out, &o, frame_start, fcap);
                q = bq + size;
            }
            if (last) break;
        }
        } catch (const TooSmall&) {
            if (bounded) fail(frame_at, "frame decodes to more than its declared content size");
            throw;
        }
        const size_t produced = o - frame_start;
        if (h.content >= 0 && uint64_t(h.content) != produced) {
            char msg[160];
            std::snprintf(msg, sizeof msg,
                          "frame declares %lld content bytes and decodes to %zu",
                          (long long)h.content, produced);
            fail(frame_at, msg);
        }
        if (h.checksum) {
            if (n - q < 4) fail(q, "truncated content checksum");
            uint32_t want = rd32(src + q);
            uint32_t got = uint32_t(xxh64(out + frame_start, produced, 0));
            if (want != got) {
                char msg[160];
                std::snprintf(msg, sizeof msg,
                              "content checksum mismatch (xxh64 low bits %08x, frame says %08x)",
                              got, want);
                fail(q, msg);
            }
            q += 4;
        }
        at = q;
    }
    return o;
}

void set_error(char* err, size_t errcap, const std::string& msg) {
    if (!err || !errcap) return;
    size_t k = msg.size() < errcap - 1 ? msg.size() : errcap - 1;
    std::memcpy(err, msg.data(), k);
    err[k] = 0;
}

}  // namespace

extern "C" {

// Sum of the frames' declared content sizes; -1 when a frame declares none;
// -3 on a malformed frame sequence (message in ``err``).
int64_t zstd_content_size(const uint8_t* src, size_t n, char* err, size_t errcap) {
    try {
        return content_size(src, n);
    } catch (const Corrupt& c) {
        set_error(err, errcap, c.what);
        return -3;
    }
}

// Decodes every frame of ``src`` into ``dst``: the bytes written, -1 on a
// corrupt input (message in ``err``), -2 when ``cap`` is too small.
int64_t zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap, char* err,
                        size_t errcap) {
    try {
        return int64_t(decode_all(src, n, dst, cap));
    } catch (const Corrupt& c) {
        set_error(err, errcap, c.what);
        return -1;
    } catch (const TooSmall&) {
        return -2;
    } catch (const std::bad_alloc&) {
        set_error(err, errcap, "out of memory");
        return -1;
    }
}

uint32_t zstd_crc32c(const uint8_t* p, size_t n, uint32_t crc) { return crc32c(p, n, crc); }

}  // extern "C"
