// Native CPU leaf-search comparator: the benchmark's honest denominator.
//
// Role: stand-in for the reference's tantivy leaf hot loop
// (`quickwit-search/src/leaf.rs:657-875`) which cannot be built in this
// image (no Rust toolchain). Implements the SAME leaf computation the TPU
// kernels run for posting-space term queries — BM25 scoring (tantivy
// k1=1.2, b=0.75), top-k, date-histogram and terms aggregation over fast
// columns — as a tight single-threaded C++ loop over the same memory
// layout the engine holds (padded postings + dense columns). This is a
// FAVORABLE CPU baseline: it reads pre-decoded, pre-ordinalized arrays
// with no posting decompression, no term-dictionary walk, and no
// document-store access, so a real tantivy leaf does strictly more work
// per query.
//
// Built on demand with the baked-in g++ (ctypes ABI, no Python API).

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {
constexpr float kK1 = 1.2f;
constexpr float kB = 0.75f;

// fixed-size min-heap on (score, -doc) — tantivy's TopCollector shape
struct Hit {
  float score;
  int32_t doc;
  bool operator<(const Hit& o) const {
    // heap of the WORST kept hit on top: higher score = better,
    // lower doc breaks ties (matches the engine's doc-asc tie-break)
    if (score != o.score) return score > o.score;
    return doc < o.doc;
  }
};

inline float Bm25(float tf, float norm, float inv_avg, float idf_gain) {
  const float denom = tf + kK1 * (1.0f - kB + kB * norm * inv_avg);
  return idf_gain * tf / std::max(denom, 1e-9f);
}

// Merge-advance a sorted posting list to `doc`; returns its tf or 0.
// Pad entries (ids < 0 or >= num_docs) never equal a real doc id.
inline float TfAt(const int32_t* ids, const int32_t* tfs, int64_t n,
                  int64_t* cursor, int32_t doc) {
  int64_t i = *cursor;
  while (i < n && ids[i] >= 0 && ids[i] < doc) ++i;
  *cursor = i;
  return (i < n && ids[i] == doc) ? static_cast<float>(tfs[i]) : 0.0f;
}
}  // namespace

extern "C" {

// One leaf search of a single-term query with optional aggregations.
//   ids/tfs:        padded posting arrays (pad entries: ids >= num_docs)
//   norms:          dense per-doc fieldnorm (token count)
//   ts_values/ts_present: histogram operand column (int64) or null
//   ord_col:        terms-agg ordinal column (-1 = missing) or null
//   k:              top-k size (0 = count/agg only, no scoring)
// Outputs (caller-allocated): hist_out[n_hist], terms_out[n_terms],
//   topk_scores/topk_docs[k], count_out[1].
void leaf_term_aggs(const int32_t* ids, const int32_t* tfs, int64_t n_post,
                    const int32_t* norms, int64_t num_docs,
                    const int64_t* ts_values, const uint8_t* ts_present,
                    int64_t origin, int64_t interval, int32_t n_hist,
                    const int32_t* ord_col, int32_t n_terms,
                    double idf, double avg_len, int32_t k,
                    int64_t* hist_out, int64_t* terms_out,
                    float* topk_scores, int32_t* topk_docs,
                    int64_t* count_out) {
  const float idf_gain = static_cast<float>(idf) * (kK1 + 1.0f);
  const float inv_avg = 1.0f / std::max(static_cast<float>(avg_len), 1e-9f);
  int64_t count = 0;

  std::vector<Hit> heap;
  heap.reserve(k > 0 ? k : 1);

  for (int64_t i = 0; i < n_post; ++i) {
    const int32_t doc = ids[i];
    if (doc < 0 || doc >= num_docs) continue;  // pad slot
    ++count;
    if (k > 0) {
      const float score = Bm25(static_cast<float>(tfs[i]),
                               static_cast<float>(norms[doc]),
                               inv_avg, idf_gain);
      if (static_cast<int32_t>(heap.size()) < k) {
        heap.push_back({score, doc});
        std::push_heap(heap.begin(), heap.end());
      } else if (Hit{score, doc} < heap.front()) {
        std::pop_heap(heap.begin(), heap.end());
        heap.back() = {score, doc};
        std::push_heap(heap.begin(), heap.end());
      }
    }
    if (n_hist > 0 && ts_present != nullptr && ts_present[doc]) {
      const int64_t idx = (ts_values[doc] - origin) / interval;
      if (idx >= 0 && idx < n_hist) ++hist_out[idx];
    }
    if (n_terms > 0 && ord_col != nullptr) {
      const int32_t ord = ord_col[doc];
      if (ord >= 0 && ord < n_terms) ++terms_out[ord];
    }
  }
  if (k > 0) {
    std::sort_heap(heap.begin(), heap.end());  // best-first
    for (size_t i = 0; i < heap.size(); ++i) {
      topk_scores[i] = heap[i].score;
      topk_docs[i] = heap[i].doc;
    }
    for (int32_t i = static_cast<int32_t>(heap.size()); i < k; ++i) {
      topk_scores[i] = -1.0f;
      topk_docs[i] = -1;
    }
  }
  *count_out = count;
}

// One leaf search of a boolean query: scored MUST term AND'ed with a
// timestamp range filter, plus up to two optional scored SHOULD terms
// (pure OR — they widen scores, never the match set). The c2 benchmark
// shape. All posting lists are doc-id-sorted with pads outside
// [0, num_docs); range bounds are INCLUSIVE and pre-resolved by the
// caller into the column's on-disk domain (raw values, or scaled deltas
// for FOR-packed columns — comparisons are domain-invariant).
//   must_*:   scored conjunctive term postings + its field's norms
//   s1_*/s2_*: should-term postings (n == 0 disables a slot); both share
//              one field (norms + avg_len), per-term idf
//   ts_*:     range operand column (int64) + present bytes
// Outputs (caller-allocated): topk_scores/topk_docs[k], count_out[1].
void leaf_bool_range(const int32_t* must_ids, const int32_t* must_tfs,
                     int64_t n_must, const int32_t* must_norms,
                     double must_idf, double must_avg_len,
                     const int32_t* s1_ids, const int32_t* s1_tfs,
                     int64_t n_s1,
                     const int32_t* s2_ids, const int32_t* s2_tfs,
                     int64_t n_s2,
                     const int32_t* should_norms, double s1_idf,
                     double s2_idf, double should_avg_len,
                     const int64_t* ts_values, const uint8_t* ts_present,
                     int64_t lo, int64_t hi,
                     int64_t num_docs, int32_t k,
                     float* topk_scores, int32_t* topk_docs,
                     int64_t* count_out) {
  const float must_gain = static_cast<float>(must_idf) * (kK1 + 1.0f);
  const float s1_gain = static_cast<float>(s1_idf) * (kK1 + 1.0f);
  const float s2_gain = static_cast<float>(s2_idf) * (kK1 + 1.0f);
  const float must_inv_avg =
      1.0f / std::max(static_cast<float>(must_avg_len), 1e-9f);
  const float should_inv_avg =
      1.0f / std::max(static_cast<float>(should_avg_len), 1e-9f);
  int64_t count = 0;
  int64_t c1 = 0, c2 = 0;  // merge cursors into the should lists

  std::vector<Hit> heap;
  heap.reserve(k > 0 ? k : 1);

  for (int64_t i = 0; i < n_must; ++i) {
    const int32_t doc = must_ids[i];
    if (doc < 0 || doc >= num_docs) continue;  // pad slot
    if (!ts_present[doc]) continue;
    const int64_t v = ts_values[doc];
    if (v < lo || v > hi) continue;
    ++count;
    if (k <= 0) continue;
    float score = Bm25(static_cast<float>(must_tfs[i]),
                       static_cast<float>(must_norms[doc]),
                       must_inv_avg, must_gain);
    const float snorm = static_cast<float>(should_norms[doc]);
    const float tf1 = TfAt(s1_ids, s1_tfs, n_s1, &c1, doc);
    if (tf1 > 0.0f) score += Bm25(tf1, snorm, should_inv_avg, s1_gain);
    const float tf2 = TfAt(s2_ids, s2_tfs, n_s2, &c2, doc);
    if (tf2 > 0.0f) score += Bm25(tf2, snorm, should_inv_avg, s2_gain);
    if (static_cast<int32_t>(heap.size()) < k) {
      heap.push_back({score, doc});
      std::push_heap(heap.begin(), heap.end());
    } else if (Hit{score, doc} < heap.front()) {
      std::pop_heap(heap.begin(), heap.end());
      heap.back() = {score, doc};
      std::push_heap(heap.begin(), heap.end());
    }
  }
  if (k > 0) {
    std::sort_heap(heap.begin(), heap.end());  // best-first
    for (size_t i = 0; i < heap.size(); ++i) {
      topk_scores[i] = heap[i].score;
      topk_docs[i] = heap[i].doc;
    }
    for (int32_t i = static_cast<int32_t>(heap.size()); i < k; ++i) {
      topk_scores[i] = -1.0f;
      topk_docs[i] = -1;
    }
  }
  *count_out = count;
}

}  // extern "C"
