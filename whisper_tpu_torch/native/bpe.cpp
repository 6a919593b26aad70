// Copy of whisper_tpu/native/bpe.cpp, unchanged below this header, so that
// whisper_tpu_torch builds its host library from its own tree.

// Byte-level BPE merge core (tiktoken-equivalent hot path).
//
// The reference stack delegates BPE to the Rust `tiktoken` crate
// (reference whisper/tokenizer.py:135,357-363).  Here the rank table and the
// greedy lowest-rank merge loop live in C++; Unicode pre-tokenization
// (the pat_str split) stays in Python where the `regex` module provides
// \p{L}/\p{N} classes.  Exposed through a small C ABI consumed via ctypes.
//
// Build: part of libwhisper_native.so (see Makefile in this directory).

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct BytesHash {
    size_t operator()(const std::string& s) const {
        // FNV-1a
        uint64_t h = 1469598103934665603ull;
        for (unsigned char c : s) {
            h ^= c;
            h *= 1099511628211ull;
        }
        return static_cast<size_t>(h);
    }
};

struct Encoder {
    std::unordered_map<std::string, int32_t, BytesHash> ranks;
};

// Greedy BPE: repeatedly merge the adjacent pair whose concatenation has the
// lowest rank, until no adjacent pair is a known token.  Pieces produced by
// pre-tokenization are short (a word or run of punctuation), so the simple
// O(n^2) scan beats heap bookkeeping in practice.
int encode_piece(const Encoder& enc, const uint8_t* piece, int len, int32_t* out,
                 int out_cap) {
    if (len == 0) return 0;
    {
        // whole piece may be a token already
        std::string whole(reinterpret_cast<const char*>(piece), len);
        auto it = enc.ranks.find(whole);
        if (it != enc.ranks.end()) {
            if (out_cap < 1) return -1;
            out[0] = it->second;
            return 1;
        }
    }

    // boundaries[i] = start byte offset of part i; parts are [b[i], b[i+1])
    std::vector<int> bounds(len + 1);
    for (int i = 0; i <= len; ++i) bounds[i] = i;

    std::string scratch;
    auto pair_rank = [&](int i) -> int64_t {
        // rank of merging parts i and i+1, or INT64_MAX if unknown
        scratch.assign(reinterpret_cast<const char*>(piece) + bounds[i],
                       bounds[i + 2] - bounds[i]);
        auto it = enc.ranks.find(scratch);
        return it == enc.ranks.end() ? INT64_MAX : it->second;
    };

    int n_parts = len;
    while (n_parts > 1) {
        int64_t best_rank = INT64_MAX;
        int best_i = -1;
        for (int i = 0; i < n_parts - 1; ++i) {
            int64_t r = pair_rank(i);
            if (r < best_rank) {
                best_rank = r;
                best_i = i;
            }
        }
        if (best_i < 0) break;
        // merge parts best_i and best_i+1: drop boundary best_i+1
        bounds.erase(bounds.begin() + best_i + 1);
        --n_parts;
    }

    if (n_parts > out_cap) return -1;
    for (int i = 0; i < n_parts; ++i) {
        scratch.assign(reinterpret_cast<const char*>(piece) + bounds[i],
                       bounds[i + 1] - bounds[i]);
        auto it = enc.ranks.find(scratch);
        if (it == enc.ranks.end()) return -2;  // byte-level vocab must cover all
        out[i] = it->second;
    }
    return n_parts;
}

}  // namespace

extern "C" {

void* bpe_new() { return new Encoder(); }

void bpe_free(void* h) { delete static_cast<Encoder*>(h); }

// Bulk-load the rank table: `data` is the concatenation of all token byte
// strings, `offsets` has n+1 entries delimiting each token, `ranks` the ids.
void bpe_load(void* h, const uint8_t* data, const int32_t* offsets,
              const int32_t* ranks, int32_t n) {
    Encoder* enc = static_cast<Encoder*>(h);
    enc->ranks.reserve(static_cast<size_t>(n) * 2);
    for (int32_t i = 0; i < n; ++i) {
        enc->ranks.emplace(
            std::string(reinterpret_cast<const char*>(data) + offsets[i],
                        offsets[i + 1] - offsets[i]),
            ranks[i]);
    }
}

// Encode one pre-tokenized piece.  Returns token count, -1 if out_cap too
// small, -2 if a part is missing from the vocab (corrupt rank table).
int32_t bpe_encode_piece(void* h, const uint8_t* piece, int32_t len,
                         int32_t* out, int32_t out_cap) {
    return encode_piece(*static_cast<Encoder*>(h), piece, len, out, out_cap);
}

}  // extern "C"
