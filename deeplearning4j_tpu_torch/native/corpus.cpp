// Native corpus pipeline — tokenization + vocab construction + indexing.
//
// The runtime-side analog of the reference's text pipeline
// (text/tokenization/ + VocabConstructor.java, 612 LoC, which fans out
// Java worker threads because per-token JVM work was the bottleneck).
// Here the whole pass — read, tokenize, hash-count, frequency-sort,
// re-index — runs in C++ behind a ctypes boundary; Python sees only
// numpy arrays. A pure-Python dict/Counter pass over a multi-GB corpus
// is 10-30x slower and holds the GIL the whole time.
//
// Contract (must match nlp/vocab.VocabConstructor): vocabulary sorted by
// (count desc, word asc); tokens split on ASCII whitespace; optional
// lowercasing.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 corpus.cpp -o libdl4jcorpus.so
// (native/__init__.py does this on first use, into the package's _build/
// directory, keyed by a hash of this source).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Corpus {
    // token stream as indices into `words` (pre-filter ids)
    std::vector<int64_t> stream;
    std::vector<int64_t> sentence_offsets;  // start of each sentence
    std::vector<std::string> words;         // first-seen order
    std::vector<int64_t> counts;            // aligned with words

    // filtered+sorted view (built per min_count)
    int64_t cached_min_count = -1;
    std::vector<int64_t> rank;      // pre-filter id -> vocab index or -1
    std::vector<int64_t> vocab_ids; // vocab index -> pre-filter id

    // GloVe co-occurrence view (built per min_count/window/symmetric)
    int64_t cooc_min_count = -1, cooc_window = -1, cooc_symmetric = -1;
    std::vector<int32_t> cooc_rows, cooc_cols;
    std::vector<float> cooc_vals;
};

inline bool is_space(char c) {
    return c == ' ' || c == '\t' || c == '\r' || c == '\n' || c == '\v'
        || c == '\f';
}

void build_ranks(Corpus* c, int64_t min_count) {
    if (c->cached_min_count == min_count) return;
    std::vector<int64_t> keep;
    keep.reserve(c->words.size());
    for (int64_t i = 0; i < (int64_t)c->words.size(); ++i)
        if (c->counts[i] >= min_count) keep.push_back(i);
    // (count desc, word asc) — the VocabConstructor ordering
    std::sort(keep.begin(), keep.end(), [&](int64_t a, int64_t b) {
        if (c->counts[a] != c->counts[b]) return c->counts[a] > c->counts[b];
        return c->words[a] < c->words[b];
    });
    c->rank.assign(c->words.size(), -1);
    for (int64_t r = 0; r < (int64_t)keep.size(); ++r)
        c->rank[keep[r]] = r;
    c->vocab_ids = std::move(keep);
    c->cached_min_count = min_count;
}

}  // namespace

extern "C" {

// Tokenize + count a whole file. Returns an opaque handle (nullptr on
// I/O failure). newline = sentence boundary.
void* corpus_open(const char* path, int lowercase) {
    std::ifstream f(path, std::ios::binary);
    if (!f) return nullptr;
    auto* c = new Corpus();
    std::unordered_map<std::string, int64_t> ids;
    std::string line, tok;
    while (std::getline(f, line)) {
        c->sentence_offsets.push_back((int64_t)c->stream.size());
        size_t i = 0, n = line.size();
        while (i < n) {
            while (i < n && is_space(line[i])) ++i;
            size_t j = i;
            while (j < n && !is_space(line[j])) ++j;
            if (j > i) {
                tok.assign(line, i, j - i);
                if (lowercase)
                    for (auto& ch : tok)
                        if (ch >= 'A' && ch <= 'Z') ch += 32;
                auto it = ids.find(tok);
                int64_t id;
                if (it == ids.end()) {
                    id = (int64_t)c->words.size();
                    ids.emplace(tok, id);
                    c->words.push_back(tok);
                    c->counts.push_back(0);
                } else {
                    id = it->second;
                }
                ++c->counts[id];
                c->stream.push_back(id);
            }
            i = j;
        }
    }
    c->sentence_offsets.push_back((int64_t)c->stream.size());
    return c;
}

void corpus_close(void* h) { delete static_cast<Corpus*>(h); }

int64_t corpus_total_tokens(void* h) {
    return (int64_t)static_cast<Corpus*>(h)->stream.size();
}

int64_t corpus_num_sentences(void* h) {
    return (int64_t)static_cast<Corpus*>(h)->sentence_offsets.size() - 1;
}

int64_t corpus_vocab_size(void* h, int64_t min_count) {
    auto* c = static_cast<Corpus*>(h);
    build_ranks(c, min_count);
    return (int64_t)c->vocab_ids.size();
}

// Byte length of the '\n'-joined vocab dump (for buffer sizing).
int64_t corpus_vocab_bytes(void* h, int64_t min_count) {
    auto* c = static_cast<Corpus*>(h);
    build_ranks(c, min_count);
    int64_t total = 0;
    for (int64_t id : c->vocab_ids) total += (int64_t)c->words[id].size() + 1;
    return total;
}

// Write words ('\n'-joined, vocab order) into buf and counts into
// counts_out [vocab_size]. Returns bytes written, or -1 if buf too small.
int64_t corpus_vocab_dump(void* h, int64_t min_count, char* buf,
                          int64_t buf_len, int64_t* counts_out) {
    auto* c = static_cast<Corpus*>(h);
    build_ranks(c, min_count);
    int64_t off = 0;
    for (int64_t r = 0; r < (int64_t)c->vocab_ids.size(); ++r) {
        const std::string& w = c->words[c->vocab_ids[r]];
        if (off + (int64_t)w.size() + 1 > buf_len) return -1;
        std::memcpy(buf + off, w.data(), w.size());
        off += (int64_t)w.size();
        buf[off++] = '\n';
        counts_out[r] = c->counts[c->vocab_ids[r]];
    }
    return off;
}

// Re-index the token stream against the (min_count-filtered) vocab:
// tokens_out [total_tokens] gets the vocab index or -1 (filtered word);
// offsets_out [num_sentences + 1] gets sentence start offsets.
void corpus_index(void* h, int64_t min_count, int32_t* tokens_out,
                  int64_t* offsets_out) {
    auto* c = static_cast<Corpus*>(h);
    build_ranks(c, min_count);
    for (size_t i = 0; i < c->stream.size(); ++i)
        tokens_out[i] = (int32_t)c->rank[c->stream[i]];
    for (size_t i = 0; i < c->sentence_offsets.size(); ++i)
        offsets_out[i] = c->sentence_offsets[i];
}

// -- GloVe co-occurrence accumulation ---------------------------------------
// Forward-window scan with 1/distance weighting over the min_count-filtered
// sentence stream (the AbstractCoOccurrences.java:322-374 semantics: for
// each position x, partners j in (x, x+window]; weight 1/(j-x); symmetric
// mirrors each increment). One C++ pass replaces the reference's
// multi-threaded CountMap shuffling; Python receives COO arrays.

int64_t corpus_cooc_build(void* h, int64_t min_count, int64_t window,
                          int symmetric) {
    auto* c = static_cast<Corpus*>(h);
    if (c->cooc_min_count == min_count && c->cooc_window == window &&
        c->cooc_symmetric == symmetric)
        return (int64_t)c->cooc_vals.size();
    build_ranks(c, min_count);
    const int64_t V = (int64_t)c->vocab_ids.size();
    std::unordered_map<int64_t, double> acc;
    std::vector<int64_t> sent;
    for (size_t s = 0; s + 1 < c->sentence_offsets.size(); ++s) {
        sent.clear();
        for (int64_t t = c->sentence_offsets[s];
             t < c->sentence_offsets[s + 1]; ++t) {
            int64_t r = c->rank[c->stream[t]];
            if (r >= 0) sent.push_back(r);  // filtered words drop out
        }
        const int64_t n = (int64_t)sent.size();
        for (int64_t x = 0; x < n; ++x) {
            int64_t stop = std::min(x + window + 1, n);
            for (int64_t j = x + 1; j < stop; ++j) {
                double w = 1.0 / (double)(j - x);
                acc[sent[x] * V + sent[j]] += w;
                if (symmetric) acc[sent[j] * V + sent[x]] += w;
            }
        }
    }
    c->cooc_rows.clear(); c->cooc_cols.clear(); c->cooc_vals.clear();
    c->cooc_rows.reserve(acc.size());
    c->cooc_cols.reserve(acc.size());
    c->cooc_vals.reserve(acc.size());
    for (const auto& kv : acc) {
        c->cooc_rows.push_back((int32_t)(kv.first / V));
        c->cooc_cols.push_back((int32_t)(kv.first % V));
        c->cooc_vals.push_back((float)kv.second);
    }
    c->cooc_min_count = min_count;
    c->cooc_window = window;
    c->cooc_symmetric = symmetric;
    return (int64_t)c->cooc_vals.size();
}

void corpus_cooc_dump(void* h, int32_t* rows_out, int32_t* cols_out,
                      float* vals_out) {
    auto* c = static_cast<Corpus*>(h);
    std::memcpy(rows_out, c->cooc_rows.data(),
                c->cooc_rows.size() * sizeof(int32_t));
    std::memcpy(cols_out, c->cooc_cols.data(),
                c->cooc_cols.size() * sizeof(int32_t));
    std::memcpy(vals_out, c->cooc_vals.data(),
                c->cooc_vals.size() * sizeof(float));
}

}  // extern "C"
