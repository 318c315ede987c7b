// CLIP BPE merge loop, native core: the port's copy of the JAX package's
// native/bpe.cpp, built by tokenizer/bpe_native.py with g++ into the kernel
// build directory and called through ctypes.
//
// Contract: the Python side maps every base symbol and merged token to its
// vocab id and flattens the merge table to three parallel arrays
// (left_id, right_id, merged_id) ordered by rank.  encode_word() runs the
// greedy lowest-rank merge loop over a word's symbol ids.

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct MergeTable {
    // (left<<32 | right) -> {rank, merged_id}
    std::unordered_map<uint64_t, std::pair<int32_t, int32_t>> map;
};

inline uint64_t pack(int32_t a, int32_t b) {
    return (static_cast<uint64_t>(static_cast<uint32_t>(a)) << 32) |
           static_cast<uint32_t>(b);
}

}  // namespace

extern "C" {

// Build a merge table; returns an opaque handle.
void* bpe_new_table(const int32_t* left, const int32_t* right,
                    const int32_t* merged, int32_t n) {
    auto* t = new MergeTable();
    t->map.reserve(static_cast<size_t>(n) * 2);
    for (int32_t i = 0; i < n; ++i) {
        t->map.emplace(pack(left[i], right[i]),
                       std::make_pair(i, merged[i]));
    }
    return t;
}

void bpe_free_table(void* handle) { delete static_cast<MergeTable*>(handle); }

// Greedy BPE over one word.  syms: initial symbol ids (chars + trailing
// </w>-variant).  Writes merged ids into out (capacity out_cap); returns the
// number of output ids, or -1 if out_cap is too small.
int32_t bpe_encode_word(void* handle, const int32_t* syms, int32_t n,
                        int32_t* out, int32_t out_cap) {
    auto* t = static_cast<MergeTable*>(handle);
    std::vector<int32_t> word(syms, syms + n);

    while (word.size() > 1) {
        int32_t best_rank = INT32_MAX;
        int32_t best_pos = -1;
        int32_t best_merged = -1;
        for (size_t i = 0; i + 1 < word.size(); ++i) {
            auto it = t->map.find(pack(word[i], word[i + 1]));
            if (it != t->map.end() && it->second.first < best_rank) {
                best_rank = it->second.first;
                best_pos = static_cast<int32_t>(i);
                best_merged = it->second.second;
            }
        }
        if (best_pos < 0) break;
        // merge ALL occurrences of this pair left-to-right (CLIP semantics)
        std::vector<int32_t> next;
        next.reserve(word.size());
        int32_t a = word[best_pos], b = word[best_pos + 1];
        for (size_t i = 0; i < word.size();) {
            if (i + 1 < word.size() && word[i] == a && word[i + 1] == b) {
                next.push_back(best_merged);
                i += 2;
            } else {
                next.push_back(word[i]);
                i += 1;
            }
        }
        word.swap(next);
    }

    if (static_cast<int32_t>(word.size()) > out_cap) return -1;
    std::memcpy(out, word.data(), word.size() * sizeof(int32_t));
    return static_cast<int32_t>(word.size());
}

}  // extern "C"
