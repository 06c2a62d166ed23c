// Native text kernels for the host hot loops of ingest and query encoding:
// per-token hashing, tf aggregation, sentence splitting and n-gram
// diagnostics.
//
// Semantics mirror advanced_rag_tpu_torch/index/text.py EXACTLY on ASCII
// text: the same tokenizer ([a-z0-9]+ on ascii-lowered text), the same
// stopword list, the same blake2b(digest_size=8) little-endian term hash and
// the same round-half-to-even query pruning, so indexes built by either path
// are interchangeable (checkpoints stay portable).  Every non-ASCII byte is a
// separator here, while Python's str.lower() maps a few non-ASCII letters to
// ASCII (U+212A KELVIN SIGN -> 'k'), so callers send ASCII text only.  The
// Python modules remain the reference implementation.
//
// Built at first use by advanced_rag_tpu_torch/native/__init__.py:
//   g++ -O3 -shared -fPIC -std=c++17 text_native.cpp -o build/native/<name>.so
// and loaded through ctypes.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>
#include <algorithm>
#include <cmath>

// ---------------------------------------------------------------------------
// blake2b — compact implementation after RFC 7693 (public-domain reference),
// specialized for digest_size=8, no key.
// ---------------------------------------------------------------------------

namespace blake2 {

static const uint64_t IV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
    0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};

static const uint8_t SIGMA[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3}};

static inline uint64_t rotr64(uint64_t x, int n) {
  return (x >> n) | (x << (64 - n));
}

static inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;  // little-endian hosts only (x86/arm)
}

struct State {
  uint64_t h[8];
  uint8_t buf[128];
  size_t buflen;
  uint64_t t;
};

static inline void G(uint64_t* v, int a, int b, int c, int d, uint64_t x,
                     uint64_t y) {
  v[a] = v[a] + v[b] + x;
  v[d] = rotr64(v[d] ^ v[a], 32);
  v[c] = v[c] + v[d];
  v[b] = rotr64(v[b] ^ v[c], 24);
  v[a] = v[a] + v[b] + y;
  v[d] = rotr64(v[d] ^ v[a], 16);
  v[c] = v[c] + v[d];
  v[b] = rotr64(v[b] ^ v[c], 63);
}

static void compress(State& S, const uint8_t* block, bool last) {
  uint64_t m[16], v[16];
  for (int i = 0; i < 16; ++i) m[i] = load64(block + 8 * i);
  for (int i = 0; i < 8; ++i) v[i] = S.h[i];
  for (int i = 0; i < 8; ++i) v[8 + i] = IV[i];
  v[12] ^= S.t;          // low counter (messages < 2^64)
  if (last) v[14] = ~v[14];
  for (int r = 0; r < 12; ++r) {
    const uint8_t* s = SIGMA[r];
    G(v, 0, 4, 8, 12, m[s[0]], m[s[1]]);
    G(v, 1, 5, 9, 13, m[s[2]], m[s[3]]);
    G(v, 2, 6, 10, 14, m[s[4]], m[s[5]]);
    G(v, 3, 7, 11, 15, m[s[6]], m[s[7]]);
    G(v, 0, 5, 10, 15, m[s[8]], m[s[9]]);
    G(v, 1, 6, 11, 12, m[s[10]], m[s[11]]);
    G(v, 2, 7, 8, 13, m[s[12]], m[s[13]]);
    G(v, 3, 4, 9, 14, m[s[14]], m[s[15]]);
  }
  for (int i = 0; i < 8; ++i) S.h[i] ^= v[i] ^ v[8 + i];
}

// blake2b(data, digest_size=8) -> first 8 bytes as little-endian u64
static uint64_t hash64(const char* data, size_t len) {
  State S;
  for (int i = 0; i < 8; ++i) S.h[i] = IV[i];
  S.h[0] ^= 0x01010000ULL ^ 8ULL;  // param block: digest_len=8, fanout=depth=1
  S.buflen = 0;
  S.t = 0;
  const uint8_t* p = reinterpret_cast<const uint8_t*>(data);
  // full blocks (keep the final <=128 bytes for the last-block flag)
  while (len > 128) {
    S.t += 128;
    compress(S, p, false);
    p += 128;
    len -= 128;
  }
  uint8_t block[128];
  std::memset(block, 0, sizeof(block));
  std::memcpy(block, p, len);
  S.t += len;
  compress(S, block, true);
  return S.h[0];  // little-endian first 8 bytes == h[0] on LE hosts
}

}  // namespace blake2

// ---------------------------------------------------------------------------
// tokenizer — mirrors text.py: ascii-lower, [a-z0-9]+ runs, stopword drop
// ---------------------------------------------------------------------------

static const char* STOPWORDS[] = {
    "a", "an", "and", "are", "as", "at", "be", "by", "for", "from", "has",
    "he", "in", "is", "it", "its", "of", "on", "that", "the", "to", "was",
    "were", "will", "with", "this", "those", "these", "you", "your", "i",
    "we", "they", "them", "then", "than", "or", "not", "no", "but", "if",
    "so", "do", "does", "did", "done"};

static const std::unordered_set<std::string>& stopword_set() {
  static const std::unordered_set<std::string>* s = [] {
    auto* set = new std::unordered_set<std::string>();
    for (const char* w : STOPWORDS) set->insert(w);
    return set;
  }();
  return *s;
}

static inline bool is_token_char(unsigned char c, unsigned char& lowered) {
  if (c >= 'a' && c <= 'z') { lowered = c; return true; }
  if (c >= 'A' && c <= 'Z') { lowered = c + 32; return true; }
  if (c >= '0' && c <= '9') { lowered = c; return true; }
  return false;
}

template <typename Fn>
static void for_each_token(const char* text, int64_t len, Fn&& fn) {
  std::string tok;
  tok.reserve(32);
  const auto& stop = stopword_set();
  for (int64_t i = 0; i <= len; ++i) {
    unsigned char lowered;
    if (i < len && is_token_char(static_cast<unsigned char>(text[i]), lowered)) {
      tok.push_back(static_cast<char>(lowered));
    } else if (!tok.empty()) {
      if (stop.find(tok) == stop.end()) fn(tok);
      tok.clear();
    }
  }
}

// ---------------------------------------------------------------------------
// exports
// ---------------------------------------------------------------------------

extern "C" {

// Mirrors text.py::encode_documents. texts = concatenated UTF-8 buffer,
// offsets[n_docs+1]. Fills doc_idx [n,doc_nnz] (-1 pad), doc_tf, doc_len,
// and ADDS into df_delta [vocab_size].
void art_encode_documents(const char* buf, const int64_t* offsets,
                          int64_t n_docs, int32_t vocab_size, int32_t doc_nnz,
                          int32_t* doc_idx, float* doc_tf, float* doc_len,
                          int32_t* df_delta) {
  struct Entry { int32_t count; int32_t first; };
  std::unordered_map<int32_t, Entry> counts;
  std::vector<std::pair<int32_t, Entry>> items;
  for (int64_t d = 0; d < n_docs; ++d) {
    const char* text = buf + offsets[d];
    int64_t len = offsets[d + 1] - offsets[d];
    counts.clear();
    int32_t n_tokens = 0;
    for_each_token(text, len, [&](const std::string& tok) {
      int32_t id = static_cast<int32_t>(
          blake2::hash64(tok.data(), tok.size()) %
          static_cast<uint64_t>(vocab_size));
      auto it = counts.find(id);
      if (it == counts.end()) counts.emplace(id, Entry{1, n_tokens});
      else it->second.count += 1;
      ++n_tokens;
    });
    doc_len[d] = static_cast<float>(n_tokens);
    items.assign(counts.begin(), counts.end());
    // Counter.most_common order: count desc, first-seen asc (stable)
    std::sort(items.begin(), items.end(),
              [](const auto& a, const auto& b) {
                if (a.second.count != b.second.count)
                  return a.second.count > b.second.count;
                return a.second.first < b.second.first;
              });
    int32_t keep = std::min<int64_t>(doc_nnz, (int64_t)items.size());
    for (int32_t j = 0; j < keep; ++j) {
      doc_idx[d * doc_nnz + j] = items[j].first;
      doc_tf[d * doc_nnz + j] = static_cast<float>(items[j].second.count);
      df_delta[items[j].first] += 1;
    }
  }
}

// Mirrors text.py::encode_queries (drop_ratio prunes lowest-tf fraction).
// keep = round(n * (1 - drop_ratio)) in double, ties to even as Python's
// round(): std::nearbyint under the default rounding mode.
void art_encode_queries(const char* buf, const int64_t* offsets,
                        int64_t n_queries, int32_t vocab_size,
                        int32_t query_nnz, double drop_ratio, int32_t* q_idx,
                        float* q_tf) {
  struct Entry { int32_t count; int32_t first; };
  std::unordered_map<int32_t, Entry> counts;
  std::vector<std::pair<int32_t, Entry>> items;
  for (int64_t d = 0; d < n_queries; ++d) {
    const char* text = buf + offsets[d];
    int64_t len = offsets[d + 1] - offsets[d];
    counts.clear();
    int32_t n_tokens = 0;
    for_each_token(text, len, [&](const std::string& tok) {
      int32_t id = static_cast<int32_t>(
          blake2::hash64(tok.data(), tok.size()) %
          static_cast<uint64_t>(vocab_size));
      auto it = counts.find(id);
      if (it == counts.end()) counts.emplace(id, Entry{1, n_tokens});
      else it->second.count += 1;
      ++n_tokens;
    });
    items.assign(counts.begin(), counts.end());
    std::sort(items.begin(), items.end(),
              [](const auto& a, const auto& b) {
                if (a.second.count != b.second.count)
                  return a.second.count > b.second.count;
                return a.second.first < b.second.first;
              });
    int64_t n_items = (int64_t)items.size();
    if (drop_ratio > 0.0 && n_items > 1) {
      int64_t keep = std::max<int64_t>(
          1, (int64_t)std::nearbyint((double)n_items * (1.0 - drop_ratio)));
      n_items = std::min(n_items, keep);
    }
    n_items = std::min<int64_t>(n_items, query_nnz);
    for (int64_t j = 0; j < n_items; ++j) {
      q_idx[d * query_nnz + j] = items[j].first;
      q_tf[d * query_nnz + j] = static_cast<float>(items[j].second.count);
    }
  }
}

static inline bool is_space_py(unsigned char c) {
  // python re \s on ASCII = [ \t\n\r\f\v] PLUS the file/group/
  // record/unit separators \x1c-\x1f (unicode whitespace); C isspace
  // misses the latter, which shows up in converted legacy/PDF text
  return std::isspace(c) != 0 || (c >= 0x1c && c <= 0x1f);
}

// Chunker hot loop (pipeline/chunking.py): sentence splitting + per-
// sentence token counts in ONE pass.  Splitting mirrors diagnostics.py
// _SENT_RE = r"(?<=[.!?])\s+|\n\n+" exactly:
//   (a) after [.!?], a whitespace run is a delimiter (greedy \s+);
//   (b) a run of >= 2 CONSECUTIVE '\n' is a delimiter (only \n — a
//       "\n \n" mix does NOT split, matching the regex).
// Pieces are whitespace-stripped; empty pieces dropped.  Outputs byte
// [start, end) offsets into the original text plus the count of
// [a-zA-Z0-9']+ tokens per sentence (what the packer needs — it never
// materializes the token strings).
int32_t art_split_sentences(const char* text, int64_t len,
                            int64_t* starts, int64_t* ends,
                            int32_t* tok_counts, int32_t max_sents) {
  int32_t n = 0;
  int64_t i = 0;
  while (i < len && n < max_sents) {
    // skip leading whitespace of the piece
    while (i < len && is_space_py(static_cast<unsigned char>(text[i]))) ++i;
    if (i >= len) break;
    int64_t start = i;
    int64_t end = i;           // one past the last non-space char seen
    int32_t tokens = 0;
    bool in_tok = false;
    while (i < len) {
      unsigned char c = static_cast<unsigned char>(text[i]);
      unsigned char lowered;
      // diagnostics.tokenize_words rule [a-zA-Z0-9']+ — the apostrophe
      // belongs to the word class here (unlike the BM25 tokenizer)
      bool tok_char = is_token_char(c, lowered) || c == '\'';
      if (tok_char && !in_tok) { ++tokens; in_tok = true; }
      if (!tok_char) in_tok = false;
      if (!is_space_py(c)) { end = i + 1; ++i; continue; }
      // whitespace: delimiter checks against the PRECEDING char
      unsigned char prev = static_cast<unsigned char>(text[i - 1]);
      bool after_punct = (prev == '.' || prev == '!' || prev == '?');
      // count consecutive leading '\n' in this whitespace run
      int64_t j = i;
      int nl = 0;
      while (j < len && text[j] == '\n') { ++nl; ++j; }
      if (after_punct || nl >= 2) {
        // consume the whole \s+ run when rule (a) applies; rule (b)
        // alone consumes only the newline run (regex alternation)
        if (after_punct) {
          while (i < len &&
                 is_space_py(static_cast<unsigned char>(text[i]))) ++i;
        } else {
          i = j;
        }
        break;
      }
      ++i;  // interior whitespace: part of the sentence
    }
    if (end > start) {
      starts[n] = start;
      ends[n] = end;
      tok_counts[n] = tokens;
      ++n;
    }
  }
  return n;
}

// Diagnostics hot loop: token count, shannon entropy (normalized by
// log2(vocab)), 1/2/3-gram redundancy.  Token stream here KEEPS
// stopwords?  No — mirrors pipeline/diagnostics.py tokenize_words which
// keeps all [a-zA-Z0-9']+ words; we approximate with the same token rule
// minus stopword dropping (flag selects).
void art_text_stats(const char* text, int64_t len, int32_t drop_stopwords,
                    double* out /* [6]: tokens, entropy, r1, r2, r3, distinct */) {
  std::vector<uint64_t> hashes;
  hashes.reserve(256);
  std::string tok;
  const auto& stop = stopword_set();
  for (int64_t i = 0; i <= len; ++i) {
    unsigned char lowered;
    if (i < len && is_token_char(static_cast<unsigned char>(text[i]), lowered)) {
      tok.push_back(static_cast<char>(lowered));
    } else if (!tok.empty()) {
      if (!drop_stopwords || stop.find(tok) == stop.end())
        hashes.push_back(blake2::hash64(tok.data(), tok.size()));
      tok.clear();
    }
  }
  const int64_t n = (int64_t)hashes.size();
  out[0] = (double)n;
  if (n == 0) { out[1] = out[2] = out[3] = out[4] = out[5] = 0.0; return; }

  std::unordered_map<uint64_t, int64_t> uni;
  for (uint64_t h : hashes) uni[h] += 1;
  out[5] = (double)uni.size();
  double entropy = 0.0;
  if (uni.size() > 1) {
    for (const auto& kv : uni) {
      double p = (double)kv.second / (double)n;
      entropy -= p * std::log2(p);
    }
    entropy /= std::log2((double)uni.size());
  }
  out[1] = entropy;

  for (int g = 1; g <= 3; ++g) {
    if (n < g) { out[1 + g] = 0.0; continue; }
    std::unordered_set<uint64_t> grams;
    int64_t total = n - g + 1;
    for (int64_t i = 0; i < total; ++i) {
      uint64_t h = 1469598103934665603ULL;  // FNV over the hash window
      for (int j = 0; j < g; ++j) {
        uint64_t x = hashes[i + j];
        for (int b = 0; b < 8; ++b) {
          h ^= (x >> (8 * b)) & 0xff;
          h *= 1099511628211ULL;
        }
      }
      grams.insert(h);
    }
    out[1 + g] = 1.0 - (double)grams.size() / (double)total;
  }
}

// Per-chunk quick stats (pipeline/chunking.py _quick_stats): token
// count, normalized shannon entropy, distinct count — no n-grams, no
// BLAKE2 (FNV-1a groups equal tokens just as well), apostrophe included
// in the word class to match diagnostics.tokenize_words exactly.
void art_quick_stats(const char* text, int64_t len,
                     double* out /* [3]: tokens, entropy, distinct */) {
  std::unordered_map<uint64_t, int64_t> uni;
  uni.reserve(256);
  uint64_t h = 1469598103934665603ULL;
  bool in_tok = false;
  int64_t n = 0;
  for (int64_t i = 0; i <= len; ++i) {
    unsigned char lowered = 0;
    bool tok_char = false;
    if (i < len) {
      unsigned char c = static_cast<unsigned char>(text[i]);
      tok_char = is_token_char(c, lowered);
      if (!tok_char && c == '\'') { tok_char = true; lowered = c; }
    }
    if (tok_char) {
      h ^= lowered;
      h *= 1099511628211ULL;
      in_tok = true;
    } else if (in_tok) {
      uni[h] += 1;
      ++n;
      h = 1469598103934665603ULL;
      in_tok = false;
    }
  }
  out[0] = (double)n;
  out[2] = (double)uni.size();
  double entropy = 0.0;
  if (n > 0 && uni.size() > 1) {
    for (const auto& kv : uni) {
      double p = (double)kv.second / (double)n;
      entropy -= p * std::log2(p);
    }
    entropy /= std::log2((double)uni.size());
  }
  out[1] = entropy;
}

// Whole-document analyzer (pipeline/diagnostics.py analyze_document):
// tokens / entropy / 1-3-gram redundancy / distinct / sentence count /
// adjacent-sentence Jaccard coherence / per-lexicon hit rates / top-20
// token byte-ranges — all in two text passes.  Token rule matches
// tokenize_words exactly ([a-zA-Z0-9']+, lowercased); ties in the
// top-20 break by first occurrence like Counter.most_common.
void art_analyze_document(
    const char* text, int64_t len,
    const char* lex_buf, const int64_t* lex_offsets, int64_t n_lex_words,
    const int32_t* lex_ids, int32_t n_lexicons,
    double* out,  // [8 + n_lexicons]: tokens, entropy, r1, r2, r3,
                  // distinct, n_sents, coherence, lex_hits...
    int64_t* top_off, int64_t* top_len, int64_t* top_cnt /* [20] */) {
  struct TokInfo {
    int64_t count = 0;
    int64_t first = 0;   // first-occurrence token index (tie order)
    int64_t off = 0;     // first-occurrence byte offset
    int64_t tlen = 0;
  };
  auto tok_char = [](unsigned char c, unsigned char& lowered) {
    if (is_token_char(c, lowered)) return true;
    if (c == '\'') { lowered = c; return true; }
    return false;
  };

  // pass 1: tokens -> hashes, counts, first occurrences
  std::vector<uint64_t> hashes;
  hashes.reserve(1024);
  std::unordered_map<uint64_t, TokInfo> uni;
  uni.reserve(512);
  uint64_t h = 1469598103934665603ULL;
  int64_t tok_start = -1;
  for (int64_t i = 0; i <= len; ++i) {
    unsigned char lowered = 0;
    bool in = i < len &&
              tok_char(static_cast<unsigned char>(text[i]), lowered);
    if (in) {
      if (tok_start < 0) tok_start = i;
      h ^= lowered;
      h *= 1099511628211ULL;
    } else if (tok_start >= 0) {
      auto& info = uni[h];
      if (info.count == 0) {
        info.first = (int64_t)hashes.size();
        info.off = tok_start;
        info.tlen = i - tok_start;
      }
      info.count += 1;
      hashes.push_back(h);
      h = 1469598103934665603ULL;
      tok_start = -1;
    }
  }
  const int64_t n = (int64_t)hashes.size();
  out[0] = (double)n;
  out[5] = (double)uni.size();
  for (int g = 0; g < 3; ++g) out[2 + g] = 0.0;
  out[1] = 0.0;
  for (int k = 0; k < 20; ++k) { top_off[k] = -1; top_len[k] = 0; top_cnt[k] = 0; }
  for (int32_t l = 0; l < n_lexicons; ++l) out[8 + l] = 0.0;
  if (n == 0) { out[6] = 0.0; out[7] = 1.0; return; }

  double entropy = 0.0;
  if (uni.size() > 1) {
    for (const auto& kv : uni) {
      double p = (double)kv.second.count / (double)n;
      entropy -= p * std::log2(p);
    }
    entropy /= std::log2((double)uni.size());
  }
  out[1] = entropy;

  for (int g = 1; g <= 3; ++g) {
    if (n < g) { out[1 + g] = 0.0; continue; }
    std::unordered_set<uint64_t> grams;
    grams.reserve(n);
    int64_t total = n - g + 1;
    for (int64_t i = 0; i < total; ++i) {
      uint64_t gh = 1469598103934665603ULL;
      for (int j = 0; j < g; ++j) {
        uint64_t x = hashes[i + j];
        for (int b = 0; b < 8; ++b) {
          gh ^= (x >> (8 * b)) & 0xff;
          gh *= 1099511628211ULL;
        }
      }
      grams.insert(gh);
    }
    out[1 + g] = 1.0 - (double)grams.size() / (double)total;
  }

  // lexicon hit rates: hash each lexicon word with the same FNV
  std::vector<std::unordered_set<uint64_t>> lex_sets(n_lexicons);
  for (int64_t w = 0; w < n_lex_words; ++w) {
    uint64_t wh = 1469598103934665603ULL;
    for (int64_t p = lex_offsets[w]; p < lex_offsets[w + 1]; ++p) {
      wh ^= static_cast<unsigned char>(lex_buf[p]);
      wh *= 1099511628211ULL;
    }
    int32_t lid = lex_ids[w];
    if (lid >= 0 && lid < n_lexicons) lex_sets[lid].insert(wh);
  }
  for (const auto& kv : uni) {
    for (int32_t l = 0; l < n_lexicons; ++l) {
      if (lex_sets[l].count(kv.first))
        out[8 + l] += (double)kv.second.count;
    }
  }
  for (int32_t l = 0; l < n_lexicons; ++l) out[8 + l] /= (double)n;

  // pass 2: sentences (same rules as art_split_sentences) + coherence
  int64_t sents = 0;
  double sim_sum = 0.0;
  int64_t sim_cnt = 0;
  std::unordered_set<uint64_t> prev_set, cur_set;
  bool have_prev = false;
  int64_t i = 0;
  while (i < len) {
    while (i < len && is_space_py(static_cast<unsigned char>(text[i]))) ++i;
    if (i >= len) break;
    int64_t end = i;
    cur_set.clear();
    uint64_t th = 1469598103934665603ULL;
    bool in_tok = false;
    while (i < len) {
      unsigned char c = static_cast<unsigned char>(text[i]);
      unsigned char lowered = 0;
      bool tc = tok_char(c, lowered);
      if (tc) { th ^= lowered; th *= 1099511628211ULL; in_tok = true; }
      else if (in_tok) {
        cur_set.insert(th);
        th = 1469598103934665603ULL;
        in_tok = false;
      }
      if (!is_space_py(c)) { end = i + 1; ++i; continue; }
      unsigned char prev = static_cast<unsigned char>(text[i - 1]);
      bool after_punct = (prev == '.' || prev == '!' || prev == '?');
      int64_t j = i;
      int nl = 0;
      while (j < len && text[j] == '\n') { ++nl; ++j; }
      if (after_punct || nl >= 2) {
        if (after_punct) {
          while (i < len &&
                 is_space_py(static_cast<unsigned char>(text[i]))) ++i;
        } else {
          i = j;
        }
        break;
      }
      ++i;
    }
    if (in_tok) cur_set.insert(th);
    if (end > 0) {
      ++sents;
      if (have_prev) {
        int64_t inter = 0;
        for (uint64_t x : cur_set) inter += (int64_t)prev_set.count(x);
        int64_t uni_sz = (int64_t)(prev_set.size() + cur_set.size()) - inter;
        sim_sum += uni_sz > 0 ? (double)inter / (double)uni_sz : 0.0;
        ++sim_cnt;
      }
      prev_set.swap(cur_set);
      have_prev = true;
    }
  }
  out[6] = (double)sents;
  out[7] = sim_cnt > 0 ? sim_sum / (double)sim_cnt : 1.0;

  // top-20 tokens by (count desc, first occurrence asc)
  std::vector<const std::pair<const uint64_t, TokInfo>*> items;
  items.reserve(uni.size());
  for (const auto& kv : uni) items.push_back(&kv);
  size_t topn = items.size() < 20 ? items.size() : 20;
  std::partial_sort(
      items.begin(), items.begin() + topn, items.end(),
      [](const auto* a, const auto* b) {
        if (a->second.count != b->second.count)
          return a->second.count > b->second.count;
        return a->second.first < b->second.first;
      });
  for (size_t k = 0; k < topn; ++k) {
    top_off[k] = items[k]->second.off;
    top_len[k] = items[k]->second.tlen;
    top_cnt[k] = items[k]->second.count;
  }
}

}  // extern "C"
