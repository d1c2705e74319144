// Host-side native runtime: patch-graph neighbour links and a
// bag-of-binary-words retrieval database, behind a C interface loaded with
// ctypes (`native/__init__.py`, which builds this file with c++ at first
// use). The same source as the JAX package's `native/graphlib.cpp`:
//
//   * graph_neighbors    prev/next edge links per patch ordered by target
//                        frame (stable)
//   * edge_capacity      the worst-case live-edge count of a config
//   * binary retrieval   an inverted file over 16-bit words of 256-bit LSH
//                        codes with TF-IDF-style scores (the "dbow"
//                        retrieval backend), and a mutual-best Hamming
//                        matcher

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// neighbor links: for each edge, the prev/next edge with the same patch id,
// ordered by target frame (ties keep insertion order); -1 when absent.
// ---------------------------------------------------------------------------
void graph_neighbors(const int64_t* kk, const int64_t* jj, int64_t n,
                     int64_t* ix, int64_t* jx) {
  std::unordered_map<int64_t, std::vector<int64_t>> groups;
  groups.reserve(n / 4 + 1);
  for (int64_t e = 0; e < n; e++) groups[kk[e]].push_back(e);

  for (auto& [key, idx] : groups) {
    std::stable_sort(idx.begin(), idx.end(),
                     [jj](int64_t a, int64_t b) { return jj[a] < jj[b]; });
    const int64_t m = (int64_t)idx.size();
    for (int64_t r = 0; r < m; r++) {
      ix[idx[r]] = (r > 0) ? idx[r - 1] : -1;
      jx[idx[r]] = (r < m - 1) ? idx[r + 1] : -1;
    }
  }
}

// ---------------------------------------------------------------------------
// edge lifecycle simulation: exact worst-case live-edge count for a config
// (used to size the fixed edge table; mirrors utils/config.edge_capacity).
// ---------------------------------------------------------------------------
int64_t edge_capacity(int64_t M, int64_t lifetime, int64_t removal_window) {
  std::vector<std::pair<int64_t, int64_t>> per_frame;  // (source, count)
  int64_t max_active = 0;
  for (int64_t nf = 1; nf < 4 * (lifetime + removal_window); nf++) {
    int64_t forw = M * std::min(nf - 1, lifetime - 1);
    int64_t back = M * std::min(lifetime, nf);
    per_frame.push_back({nf - 1, forw + back});
    std::vector<std::pair<int64_t, int64_t>> kept;
    int64_t total = 0;
    for (auto& [s, c] : per_frame)
      if (s >= nf - removal_window) { kept.push_back({s, c}); total += c; }
    per_frame.swap(kept);
    max_active = std::max(max_active, total);
  }
  return max_active + M * (2 * lifetime - 1);
}

// ---------------------------------------------------------------------------
// binary bag-of-words retrieval (inverted file over 16-bit words of 256-bit
// codes, TF-IDF-ish scoring). Codes are produced on the caller side (LSH
// signs of float descriptors).
// ---------------------------------------------------------------------------
struct RetrievalDB {
  // word -> list of (image id, count)
  static const int WORDS_PER_CODE = 16;  // 256 bits -> 16 x 16-bit words
  std::unordered_map<uint32_t, std::vector<std::pair<int32_t, float>>> inv;
  std::unordered_map<int32_t, float> norms;
  std::vector<int32_t> ids;
};

void* retrieval_create() { return new RetrievalDB(); }

void retrieval_destroy(void* db) { delete (RetrievalDB*)db; }

// codes: [n_desc, 32] uint8 (256-bit codes) for one image
void retrieval_insert(void* dbp, int32_t image_id, const uint8_t* codes,
                      int64_t n_desc) {
  RetrievalDB* db = (RetrievalDB*)dbp;
  std::unordered_map<uint32_t, float> hist;
  for (int64_t d = 0; d < n_desc; d++) {
    const uint8_t* c = codes + 32 * d;
    for (int w = 0; w < RetrievalDB::WORDS_PER_CODE; w++) {
      uint32_t word = (uint32_t)(w << 16) |
                      (uint32_t)(c[2 * w] | (c[2 * w + 1] << 8));
      hist[word] += 1.0f;
    }
  }
  float norm = 0.f;
  for (auto& [w, cnt] : hist) norm += cnt * cnt;
  norm = std::sqrt(std::max(norm, 1e-12f));
  for (auto& [w, cnt] : hist) db->inv[w].push_back({image_id, cnt / norm});
  db->norms[image_id] = 1.0f;
  db->ids.push_back(image_id);
}

// query: best match with id <= max_id (exclusive window); returns best id or
// -1; score written to *score
int32_t retrieval_query(void* dbp, const uint8_t* codes, int64_t n_desc,
                        int32_t max_id, float* score) {
  RetrievalDB* db = (RetrievalDB*)dbp;
  std::unordered_map<uint32_t, float> hist;
  for (int64_t d = 0; d < n_desc; d++) {
    const uint8_t* c = codes + 32 * d;
    for (int w = 0; w < RetrievalDB::WORDS_PER_CODE; w++) {
      uint32_t word = (uint32_t)(w << 16) |
                      (uint32_t)(c[2 * w] | (c[2 * w + 1] << 8));
      hist[word] += 1.0f;
    }
  }
  float norm = 0.f;
  for (auto& [w, cnt] : hist) norm += cnt * cnt;
  norm = std::sqrt(std::max(norm, 1e-12f));

  std::unordered_map<int32_t, float> scores;
  for (auto& [w, cnt] : hist) {
    auto it = db->inv.find(w);
    if (it == db->inv.end()) continue;
    for (auto& [img, tf] : it->second)
      if (img < max_id) scores[img] += (cnt / norm) * tf;
  }
  int32_t best = -1;
  float best_s = -1.f;
  for (auto& [img, s] : scores)
    if (s > best_s) { best_s = s; best = img; }
  *score = best_s;
  return best;
}

// brute-force hamming matcher between two code sets; returns match count,
// fills (idx0, idx1) up to max_matches with mutual-best pairs under
// max_distance.
int64_t hamming_match(const uint8_t* c0, int64_t n0, const uint8_t* c1,
                      int64_t n1, int32_t max_distance, int32_t* idx0,
                      int32_t* idx1, int64_t max_matches) {
  std::vector<int32_t> best01(n0, -1), best10(n1, -1);
  std::vector<int32_t> d01(n0, 1 << 30), d10(n1, 1 << 30);
  for (int64_t i = 0; i < n0; i++) {
    const uint64_t* a = (const uint64_t*)(c0 + 32 * i);
    for (int64_t j = 0; j < n1; j++) {
      const uint64_t* b = (const uint64_t*)(c1 + 32 * j);
      int32_t d = 0;
      for (int w = 0; w < 4; w++) d += __builtin_popcountll(a[w] ^ b[w]);
      if (d < d01[i]) { d01[i] = d; best01[i] = (int32_t)j; }
      if (d < d10[j]) { d10[j] = d; best10[j] = (int32_t)i; }
    }
  }
  int64_t m = 0;
  for (int64_t i = 0; i < n0 && m < max_matches; i++) {
    int32_t j = best01[i];
    if (j >= 0 && best10[j] == (int32_t)i && d01[i] <= max_distance) {
      idx0[m] = (int32_t)i;
      idx1[m] = j;
      m++;
    }
  }
  return m;
}

}  // extern "C"
