// Negative mining's two host passes (C ABI, bound by ctypes in
// ance_tpu_torch/utils/mining_native.py; built by
// ance_tpu_torch/utils/native_build.py; called by
// ance_tpu_torch/train/ann_gen.py::mine_negatives).
//
//   * shuffle_orders: CPython's random.Random.shuffle over range(k), once a
//     row in row order, drawn from the generator's own MT19937 state
//     (getstate() in, setstate() out), so the orders and every later draw
//     are Python's;
//   * select_negatives: each row's neighbor ids walked in its order (or
//     its first n + 1 columns) and looked up as passage ids, the positive
//     skipped and scored for the MRR probe, repeats dropped, as the JAX
//     package's mine_negatives loop does.

#include <cstdint>

namespace {

constexpr int N = 624, M = 397;
constexpr uint32_t MATRIX_A = 0x9908b0dfU, UPPER = 0x80000000U,
                   LOWER = 0x7fffffffU;

struct MT {
    uint32_t mt[N];
    int64_t pos;

    // CPython's genrand_uint32 (Modules/_randommodule.c).
    uint32_t next() {
        if (pos >= N) {
            int kk = 0;
            uint32_t y;
            for (; kk < N - M; kk++) {
                y = (mt[kk] & UPPER) | (mt[kk + 1] & LOWER);
                mt[kk] = mt[kk + M] ^ (y >> 1) ^ ((y & 1U) ? MATRIX_A : 0U);
            }
            for (; kk < N - 1; kk++) {
                y = (mt[kk] & UPPER) | (mt[kk + 1] & LOWER);
                mt[kk] = mt[kk + (M - N)] ^ (y >> 1)
                         ^ ((y & 1U) ? MATRIX_A : 0U);
            }
            y = (mt[N - 1] & UPPER) | (mt[0] & LOWER);
            mt[N - 1] = mt[M - 1] ^ (y >> 1) ^ ((y & 1U) ? MATRIX_A : 0U);
            pos = 0;
        }
        uint32_t y = mt[pos++];
        y ^= (y >> 11);
        y ^= (y << 7) & 0x9d2c5680U;
        y ^= (y << 15) & 0xefc60000U;
        y ^= (y >> 18);
        return y;
    }

    // Random._randbelow_with_getrandbits(n) for 2 <= n < 2**31: draw
    // n.bit_length() bits (getrandbits: the word's top bits) until < n.
    uint32_t below(uint32_t n) {
        int shift = __builtin_clz(n);  // 32 - n.bit_length()
        uint32_t r = next() >> shift;
        while (r >= n) r = next() >> shift;
        return r;
    }
};

}  // namespace

extern "C" {

// out[r] = range(k) shuffled, for r in [0, rows). ``mt`` and ``*pos`` are
// the generator's 624 words and index, updated in place.
void shuffle_orders(uint32_t* mt, int64_t* pos, int32_t* out, int64_t rows,
                    int64_t k) {
    MT gen;
    for (int i = 0; i < N; i++) gen.mt[i] = mt[i];
    gen.pos = *pos;
    for (int64_t r = 0; r < rows; r++) {
        int32_t* x = out + r * k;
        for (int64_t i = 0; i < k; i++) x[i] = (int32_t)i;
        for (int64_t i = k - 1; i > 0; i--) {
            uint32_t j = gen.below((uint32_t)(i + 1));
            int32_t t = x[i];
            x[i] = x[j];
            x[j] = t;
        }
    }
    for (int i = 0; i < N; i++) mt[i] = gen.mt[i];
    *pos = gen.pos;
}

// Row r of the mined rows is neighbors[rows[r]] (k ids a row), walked in
// order[r] (all k), or, with ``order`` null, in its first ``walk`` columns.
// Each id walked is looked up in ``p2id`` (n_ids entries; a negative id
// counts from the end) and counts a rank; the positive pos[r] adds
// 1 / rank to *mrr when rank <= 10 and is skipped; a pid already kept is
// skipped; the walk stops at the first new pid once n (>= 0) are kept.
// out[r, :counts[r]] are the kept pids; the probe's terms are added in row
// order, as the JAX package's loop adds them. Returns -1, or r * k + c at the first
// id out of range, neighbors[rows[r], c] (the outputs then hold nothing to
// use).
int64_t select_negatives(const int64_t* neighbors, int64_t k,
                         const int64_t* rows, int64_t n_rows,
                         const int32_t* order, int64_t walk,
                         const int64_t* p2id, int64_t n_ids,
                         const int64_t* pos, int64_t n, int64_t* out,
                         int32_t* counts, double* mrr) {
    if (order) walk = k;
    double sum = *mrr;
    for (int64_t r = 0; r < n_rows; r++) {
        const int64_t* row = neighbors + rows[r] * k;
        const int32_t* ord = order ? order + r * k : nullptr;
        int64_t* kept = out + r * n;
        int64_t count = 0;
        // the walk rarely passes n + 4: start those lookups' misses at once
        for (int64_t t = 0; t < walk && t < n + 4; t++) {
            int64_t idx = row[ord ? ord[t] : t];
            __builtin_prefetch(p2id + (idx < 0 ? idx + n_ids : idx));
        }
        for (int64_t t = 0; t < walk; t++) {
            int64_t col = ord ? ord[t] : t;
            int64_t idx = row[col];
            if (idx < 0) idx += n_ids;
            if (idx < 0 || idx >= n_ids) return r * k + col;
            int64_t pid = p2id[idx];
            int64_t rank = t + 1;
            if (pid == pos[r]) {
                if (rank <= 10) sum += 1.0 / (double)rank;
                continue;
            }
            bool seen = false;
            for (int64_t i = 0; i < count && !seen; i++) seen = kept[i] == pid;
            if (seen) continue;
            if (count >= n) break;
            kept[count++] = pid;
        }
        counts[r] = (int32_t)count;
    }
    *mrr = sum;
    return -1;
}

}  // extern "C"
