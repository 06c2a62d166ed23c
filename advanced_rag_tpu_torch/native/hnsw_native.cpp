// HNSW baseline (clean-room, Malkov & Yashunin 2016 algorithm) — CPU.
//
// This is NOT part of the serving path.  The reference delegates ANN to
// Milvus's HNSW (M=16, efConstruction=200, ef=64 — reference
// indexing.py:150-153); the port serves from the device-resident
// exact/SQ8/IVF/PQ tiers.  The north-star metric is "recall@10 vs HNSW at
// equal memory" (BASELINE.json), so the baseline to compare AGAINST is
// implemented here (advanced_rag_tpu_torch/baselines/hnsw.py loads it).
//
// Scale: 1M-row builds rest on two things —
//   * SIMD distances: the dot-product loop vectorizes under
//     -O3 -march=native (the pragma below keeps it honest at other
//     -march levels), and
//   * parallel insertion: OpenMP over inserts with one spinlock per
//     node's link lists (the hnswlib-style concurrency discipline,
//     re-derived: writers hold the node lock; readers copy the list
//     under the lock), per-thread visited-tag scratch, and
//     DETERMINISTIC per-node levels (splitmix64 of (seed, i)) so the
//     level structure is schedule-independent.
//   On a single-core host the OpenMP build degrades to the sequential
//   path with negligible overhead.
//
// Layout: contiguous float vectors; level-0 links in one flat
// [N, 2M] int32 array; upper-level links in per-node heap blocks.
// Distances are negative inner product (vectors pre-normalized by the
// caller for cosine) so "smaller is closer" throughout.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <mutex>
#include <queue>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

struct HnswIndex;

}  // extern "C" (forward declaration only; definitions below)

namespace {

using std::size_t;

struct Neighbor {
  float dist;
  int32_t id;
};
struct NearCmp {  // min-heap on dist via greater-than comparator
  bool operator()(const Neighbor& a, const Neighbor& b) const {
    return a.dist > b.dist;
  }
};
struct FarCmp {  // max-heap on dist
  bool operator()(const Neighbor& a, const Neighbor& b) const {
    return a.dist < b.dist;
  }
};

// splitmix64: deterministic level assignment independent of thread
// schedule (each node's level is a pure function of (seed, id))
inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

// per-thread search scratch: visited-tag epochs + a link copy buffer
struct Scratch {
  std::vector<uint32_t> tag;
  uint32_t cur = 0;
  std::vector<int32_t> nbuf;
};

}  // namespace

struct HnswIndex {
  int64_t n = 0;
  int32_t dim = 0;
  int32_t M = 16;
  int32_t M0 = 32;          // level-0 degree = 2M
  int32_t ef_construction = 200;
  double mult = 0.0;        // 1 / ln(M)
  int32_t max_level = -1;
  int32_t entry = -1;

  std::vector<float> data;            // [n, dim]
  std::vector<int32_t> level_of;      // [n]
  std::vector<int32_t> links0;        // [n, M0], -1 padded
  std::vector<int32_t> n_links0;      // [n]
  // upper levels: per node, levels 1..level_of[i] each M slots
  std::vector<std::vector<int32_t>> upper;    // flat [levels * M]
  std::vector<std::vector<int32_t>> n_upper;  // [levels]

  std::unique_ptr<std::atomic<uint8_t>[]> locks;  // per-node spinlocks
  std::mutex entry_mutex;                         // entry/max_level

  inline const float* vec(int32_t i) const { return data.data() + (size_t)i * dim; }

  inline float dist(const float* __restrict a,
                    const float* __restrict b) const {
    float acc = 0.f;
#pragma omp simd reduction(+ : acc)
    for (int32_t j = 0; j < dim; ++j) acc += a[j] * b[j];
    return -acc;  // negative IP: smaller = closer
  }

  inline void lock(int32_t i) {
    while (locks[i].exchange(1, std::memory_order_acquire)) {
      // spin; inserts hold locks for O(M) work only
    }
  }
  inline void unlock(int32_t i) {
    locks[i].store(0, std::memory_order_release);
  }

  inline int32_t* links(int32_t node, int32_t level, int32_t* cap) {
    if (level == 0) {
      *cap = M0;
      return links0.data() + (size_t)node * M0;
    }
    *cap = M;
    return upper[node].data() + (size_t)(level - 1) * M;
  }
  inline int32_t& link_count(int32_t node, int32_t level) {
    return level == 0 ? n_links0[node] : n_upper[node][level - 1];
  }

  // snapshot a node's neighbor list under its lock (concurrent inserts
  // rewrite lists in place; readers must never see a torn list)
  inline int32_t copy_links(int32_t node, int32_t level, int32_t* buf) {
    lock(node);
    int32_t cap;
    const int32_t* nb = links(node, level, &cap);
    int32_t cnt = link_count(node, level);
    std::memcpy(buf, nb, (size_t)cnt * sizeof(int32_t));
    unlock(node);
    return cnt;
  }

  // greedy single-entry descent at one level
  int32_t greedy(const float* q, int32_t start, int32_t level, Scratch& s) {
    int32_t cur = start;
    float cur_d = dist(q, vec(cur));
    bool changed = true;
    while (changed) {
      changed = false;
      int32_t cnt = copy_links(cur, level, s.nbuf.data());
      for (int32_t t = 0; t < cnt; ++t) {
        int32_t v = s.nbuf[t];
        if (v < 0) continue;
        float d = dist(q, vec(v));
        if (d < cur_d) {
          cur_d = d;
          cur = v;
          changed = true;
        }
      }
    }
    return cur;
  }

  // best-first beam search at one level -> up to ef closest (ascending)
  std::vector<Neighbor> search_layer(const float* q, int32_t start,
                                     int32_t ef, int32_t level, Scratch& s) {
    if (++s.cur == 0) {  // epoch wraparound: reset tags
      std::fill(s.tag.begin(), s.tag.end(), 0);
      s.cur = 1;
    }
    std::priority_queue<Neighbor, std::vector<Neighbor>, NearCmp> cand;
    std::priority_queue<Neighbor, std::vector<Neighbor>, FarCmp> best;
    float d0 = dist(q, vec(start));
    cand.push({d0, start});
    best.push({d0, start});
    s.tag[start] = s.cur;
    while (!cand.empty()) {
      Neighbor c = cand.top();
      if (c.dist > best.top().dist && (int32_t)best.size() >= ef) break;
      cand.pop();
      int32_t cnt = copy_links(c.id, level, s.nbuf.data());
      for (int32_t t = 0; t < cnt; ++t) {
        int32_t v = s.nbuf[t];
        if (v < 0 || s.tag[v] == s.cur) continue;
        s.tag[v] = s.cur;
        float d = dist(q, vec(v));
        if ((int32_t)best.size() < ef || d < best.top().dist) {
          cand.push({d, v});
          best.push({d, v});
          if ((int32_t)best.size() > ef) best.pop();
        }
      }
    }
    std::vector<Neighbor> out(best.size());
    for (size_t t = out.size(); t-- > 0;) {
      out[t] = best.top();
      best.pop();
    }
    return out;  // ascending by distance
  }

  // paper's select-neighbors heuristic (keeps diverse links)
  void select_heuristic(std::vector<Neighbor>& cand, int32_t m) {
    if ((int32_t)cand.size() <= m) return;
    std::vector<Neighbor> kept;
    kept.reserve(m);
    for (const Neighbor& c : cand) {
      if ((int32_t)kept.size() >= m) break;
      bool ok = true;
      for (const Neighbor& k : kept) {
        if (dist(vec(c.id), vec(k.id)) < c.dist) {
          ok = false;  // closer to an already-kept neighbor than to q
          break;
        }
      }
      if (ok) kept.push_back(c);
    }
    // backfill with nearest remaining if the heuristic over-pruned
    for (const Neighbor& c : cand) {
      if ((int32_t)kept.size() >= m) break;
      bool dup = false;
      for (const Neighbor& k : kept) dup |= (k.id == c.id);
      if (!dup) kept.push_back(c);
    }
    cand.swap(kept);
  }

  void connect(int32_t a, int32_t b, int32_t level) {
    lock(a);
    int32_t cap;
    int32_t* nb = links(a, level, &cap);
    int32_t& cnt = link_count(a, level);
    if (cnt < cap) {
      nb[cnt] = b;   // slot write BEFORE count bump: no torn reads
      ++cnt;
      unlock(a);
      return;
    }
    // over-full: re-select among existing + new by the heuristic
    std::vector<Neighbor> cand;
    cand.reserve(cnt + 1);
    const float* va = vec(a);
    cand.push_back({dist(va, vec(b)), b});
    for (int32_t t = 0; t < cnt; ++t)
      cand.push_back({dist(va, vec(nb[t])), nb[t]});
    std::sort(cand.begin(), cand.end(),
              [](const Neighbor& x, const Neighbor& y) { return x.dist < y.dist; });
    select_heuristic(cand, cap);
    cnt = (int32_t)cand.size();
    for (int32_t t = 0; t < cnt; ++t) nb[t] = cand[t].id;
    unlock(a);
  }

  void insert(int32_t i, Scratch& s) {
    int32_t level = level_of[i];
    const float* q = vec(i);
    int32_t cur, ml;
    {
      std::lock_guard<std::mutex> g(entry_mutex);
      cur = entry;
      ml = max_level;
    }
    for (int32_t l = ml; l > level; --l) cur = greedy(q, cur, l, s);
    for (int32_t l = std::min(level, ml); l >= 0; --l) {
      std::vector<Neighbor> w = search_layer(q, cur, ef_construction, l, s);
      cur = w.front().id;
      int32_t m = (l == 0) ? M0 : M;
      std::vector<Neighbor> sel = w;
      select_heuristic(sel, std::min<int32_t>(m, M));
      lock(i);
      int32_t cap;
      int32_t* nb = links(i, l, &cap);
      int32_t& cnt = link_count(i, l);
      for (const Neighbor& v : sel) {
        if (cnt < cap) nb[cnt++] = v.id;
      }
      unlock(i);
      for (const Neighbor& v : sel) connect(v.id, i, l);
    }
    if (level > ml) {
      std::lock_guard<std::mutex> g(entry_mutex);
      if (level > max_level) {
        max_level = level;
        entry = i;
      }
    }
  }
};

extern "C" {

HnswIndex* art_hnsw_build(const float* vectors, int64_t n, int32_t dim,
                          int32_t M, int32_t ef_construction,
                          uint64_t seed) {
  auto* idx = new HnswIndex();
  idx->n = n;
  idx->dim = dim;
  idx->M = M;
  idx->M0 = 2 * M;
  idx->ef_construction = ef_construction;
  idx->mult = 1.0 / std::log((double)M);
  idx->data.assign(vectors, vectors + (size_t)n * dim);
  idx->level_of.assign(n, 0);
  idx->links0.assign((size_t)n * idx->M0, -1);
  idx->n_links0.assign(n, 0);
  idx->upper.resize(n);
  idx->n_upper.resize(n);
  idx->locks.reset(new std::atomic<uint8_t>[n]);
  for (int64_t i = 0; i < n; ++i)
    idx->locks[i].store(0, std::memory_order_relaxed);

  // deterministic exponential levels: pure function of (seed, id)
  for (int64_t i = 0; i < n; ++i) {
    double u = (double)(splitmix64(seed ^ (uint64_t)i) >> 11) * 0x1p-53;
    u = std::max(u, 1e-12);
    int32_t level = (int32_t)(-std::log(u) * idx->mult);
    idx->level_of[i] = level;
    if (level > 0) {
      idx->upper[i].assign((size_t)level * M, -1);
      idx->n_upper[i].assign(level, 0);
    }
  }
  if (n == 0) return idx;
  idx->entry = 0;
  idx->max_level = idx->level_of[0];

#ifdef _OPENMP
#pragma omp parallel
  {
    Scratch s;
    s.tag.assign(n, 0);
    s.nbuf.assign(std::max(idx->M0, idx->M), -1);
#pragma omp for schedule(dynamic, 64)
    for (int64_t i = 1; i < n; ++i) idx->insert((int32_t)i, s);
  }
#else
  {
    Scratch s;
    s.tag.assign(n, 0);
    s.nbuf.assign(std::max(idx->M0, idx->M), -1);
    for (int64_t i = 1; i < n; ++i) idx->insert((int32_t)i, s);
  }
#endif
  return idx;
}

void art_hnsw_search(HnswIndex* idx, const float* queries, int64_t nq,
                     int32_t k, int32_t ef, int32_t* out_ids,
                     float* out_scores) {
  if (ef < k) ef = k;
#ifdef _OPENMP
#pragma omp parallel
#endif
  {
    Scratch s;
    s.tag.assign(idx->n, 0);
    s.nbuf.assign(std::max(idx->M0, idx->M), -1);
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 8)
#endif
    for (int64_t qi = 0; qi < nq; ++qi) {
      const float* q = queries + (size_t)qi * idx->dim;
      int32_t cur = idx->entry;
      for (int32_t l = idx->max_level; l > 0; --l)
        cur = idx->greedy(q, cur, l, s);
      std::vector<Neighbor> w = idx->search_layer(q, cur, ef, 0, s);
      for (int32_t j = 0; j < k; ++j) {
        if (j < (int32_t)w.size()) {
          out_ids[qi * k + j] = w[j].id;
          out_scores[qi * k + j] = -w[j].dist;  // back to inner product
        } else {
          out_ids[qi * k + j] = -1;
          out_scores[qi * k + j] = -1e30f;
        }
      }
    }
  }
}

// Graph persistence: a 1M-row build is minutes of CPU or more; cache
// it so a re-run pays the build exactly once.  Self-contained binary: header + levels
// + links + vectors.
int32_t art_hnsw_save(HnswIndex* idx, const char* path) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  const uint64_t magic = 0x41525448'4e535731ULL;  // "ARTHNSW1"
  int64_t hdr[8] = {(int64_t)magic, idx->n, idx->dim, idx->M,
                    idx->ef_construction, idx->max_level, idx->entry, 0};
  bool ok = fwrite(hdr, sizeof(hdr), 1, f) == 1;
  ok &= fwrite(idx->level_of.data(), 4, idx->n, f) == (size_t)idx->n;
  ok &= fwrite(idx->n_links0.data(), 4, idx->n, f) == (size_t)idx->n;
  ok &= fwrite(idx->links0.data(), 4, idx->links0.size(), f) ==
        idx->links0.size();
  for (int64_t i = 0; i < idx->n && ok; ++i) {
    int32_t lv = idx->level_of[i];
    if (lv > 0) {
      ok &= fwrite(idx->n_upper[i].data(), 4, lv, f) == (size_t)lv;
      ok &= fwrite(idx->upper[i].data(), 4, (size_t)lv * idx->M, f) ==
            (size_t)lv * idx->M;
    }
  }
  ok &= fwrite(idx->data.data(), 4, idx->data.size(), f) ==
        idx->data.size();
  fclose(f);
  return ok ? 0 : -1;
}

HnswIndex* art_hnsw_load(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  int64_t hdr[8];
  if (fread(hdr, sizeof(hdr), 1, f) != 1 ||
      (uint64_t)hdr[0] != 0x41525448'4e535731ULL) {
    fclose(f);
    return nullptr;
  }
  auto* idx = new HnswIndex();
  idx->n = hdr[1];
  idx->dim = (int32_t)hdr[2];
  idx->M = (int32_t)hdr[3];
  idx->M0 = 2 * idx->M;
  idx->ef_construction = (int32_t)hdr[4];
  idx->max_level = (int32_t)hdr[5];
  idx->entry = (int32_t)hdr[6];
  idx->mult = 1.0 / std::log((double)idx->M);
  int64_t n = idx->n;
  idx->level_of.resize(n);
  idx->n_links0.resize(n);
  idx->links0.resize((size_t)n * idx->M0);
  bool ok = fread(idx->level_of.data(), 4, n, f) == (size_t)n;
  ok &= fread(idx->n_links0.data(), 4, n, f) == (size_t)n;
  ok &= fread(idx->links0.data(), 4, idx->links0.size(), f) ==
        idx->links0.size();
  idx->upper.resize(n);
  idx->n_upper.resize(n);
  for (int64_t i = 0; i < n && ok; ++i) {
    int32_t lv = idx->level_of[i];
    if (lv > 0) {
      idx->n_upper[i].resize(lv);
      idx->upper[i].resize((size_t)lv * idx->M);
      ok &= fread(idx->n_upper[i].data(), 4, lv, f) == (size_t)lv;
      ok &= fread(idx->upper[i].data(), 4, (size_t)lv * idx->M, f) ==
            (size_t)lv * idx->M;
    }
  }
  idx->data.resize((size_t)n * idx->dim);
  ok &= fread(idx->data.data(), 4, idx->data.size(), f) ==
        idx->data.size();
  fclose(f);
  if (!ok) {
    delete idx;
    return nullptr;
  }
  idx->locks.reset(new std::atomic<uint8_t>[n]);
  for (int64_t i = 0; i < n; ++i)
    idx->locks[i].store(0, std::memory_order_relaxed);
  return idx;
}

int64_t art_hnsw_memory_bytes(HnswIndex* idx) {
  // graph-only memory (excl. raw vectors), to support the equal-memory
  // accounting: vectors are counted separately by the caller
  int64_t b = (int64_t)idx->links0.size() * 4 + (int64_t)idx->n * 8;
  for (const auto& u : idx->upper) b += (int64_t)u.size() * 4;
  return b;
}

int32_t art_hnsw_max_level(HnswIndex* idx) { return idx->max_level; }

// the graph's rows and width, for checking a loaded file against the
// vectors it is meant to index
int64_t art_hnsw_rows(HnswIndex* idx) { return idx->n; }

int32_t art_hnsw_dim(HnswIndex* idx) { return idx->dim; }

void art_hnsw_free(HnswIndex* idx) { delete idx; }

}  // extern "C"
