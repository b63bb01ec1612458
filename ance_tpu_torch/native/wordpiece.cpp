// Native WordPiece tokenizer core (C ABI, loaded via ctypes; the port's own copy,
// built by ance_tpu_torch/utils/native_build.py).
//
// Replaces the HF Rust tokenizer the reference depends on for offline corpus
// tokenization (reference tokenization_seed_encoder.py:25; SURVEY.md §2.3).
// Handles the ASCII fast path of BERT basic tokenization (lowercase,
// punctuation split, whitespace split, control-char removal) plus greedy
// longest-match-first WordPiece. Non-ASCII inputs are routed to the Python
// reference implementation by the wrapper, keeping behavior identical.

#include <cctype>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Vocab {
    std::unordered_map<std::string, int> table;
    int unk_id;
    bool lowercase;
    int max_chars_per_word = 100;
};

inline bool is_ascii_punct(unsigned char c) {
    return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
           (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

inline bool is_ws(unsigned char c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\r';
}

// Unicode category Cc in ASCII (C0 and DEL) less the whitespace: the
// Python path drops these characters
inline bool is_control(unsigned char c) {
    return (c < 32 && !is_ws(c)) || c == 127;
}

// Greedy longest-match-first WordPiece of one word into ids.
void wordpiece(const Vocab& v, const std::string& word,
               std::vector<int>& out) {
    if ((int)word.size() > v.max_chars_per_word) {
        out.push_back(v.unk_id);
        return;
    }
    size_t start = 0;
    std::vector<int> pieces;
    std::string sub;
    while (start < word.size()) {
        size_t end = word.size();
        int cur = -1;
        while (start < end) {
            sub.assign(start > 0 ? "##" : "");
            sub.append(word, start, end - start);
            auto it = v.table.find(sub);
            if (it != v.table.end()) { cur = it->second; break; }
            --end;
        }
        if (cur < 0) { out.push_back(v.unk_id); return; }
        pieces.push_back(cur);
        start = end;
    }
    out.insert(out.end(), pieces.begin(), pieces.end());
}

}  // namespace

extern "C" {

void* wp_create(const char** tokens, int n, int unk_id, int lowercase) {
    auto* v = new Vocab();
    v->table.reserve(n * 2);
    for (int i = 0; i < n; ++i) v->table.emplace(tokens[i], i);
    v->unk_id = unk_id;
    v->lowercase = lowercase != 0;
    return v;
}

void wp_free(void* handle) { delete static_cast<Vocab*>(handle); }

// Encode ASCII text of len bytes into token ids (no special tokens); an
// embedded NUL is dropped like any control byte, not an end of text.
// Returns the number of ids produced, or -1 if out buffer is too small.
int wp_encode(void* handle, const char* text, int len, int* out,
              int max_out) {
    const Vocab& v = *static_cast<Vocab*>(handle);
    std::vector<int> ids;
    std::string word;
    word.reserve(32);

    auto flush = [&]() {
        if (!word.empty()) { wordpiece(v, word, ids); word.clear(); }
    };

    for (int i = 0; i < len; ++i) {
        unsigned char c = (unsigned char)text[i];
        if (c == 0 || is_control(c)) continue;
        if (is_ws(c)) { flush(); continue; }
        if (is_ascii_punct(c)) {
            flush();
            word.push_back((char)c);
            flush();
            continue;
        }
        word.push_back(v.lowercase ? (char)std::tolower(c) : (char)c);
    }
    flush();

    if ((int)ids.size() > max_out) return -1;
    std::memcpy(out, ids.data(), ids.size() * sizeof(int));
    return (int)ids.size();
}

}  // extern "C"
