// Native inverted-index builder — the indexing hot loop.
//
// Role of tantivy's segment writer driven by the reference's Indexer actor
// (`indexer.rs:362`: tokenize -> term hash -> postings accumulation), which
// is native Rust in the reference. Python feeds a concatenated UTF-8 buffer
// of field values with (value -> doc) mapping; this builds:
//   - the sorted term dictionary (blob + offsets + df)
//   - postings arenas (doc ids + term freqs, padded to POSTING_PAD with the
//     out-of-bounds sentinel, matching index/format.py's layout)
//   - optional per-(posting) position lists (record="position" fields)
//   - per-doc fieldnorms (token counts)
//
// Tokenizer parity: byte-for-byte identical to query/tokenizers.py
// `default` — word chars are [0-9A-Za-z], U+00C0..U+024F, U+0400..U+04FF;
// tokens lowercase (ASCII +0x20; Latin-1 supplement/Extended-A/B and
// Cyrillic per Unicode simple case folding); tokens longer than 255 chars
// are dropped. CPython C API only (no pybind11 in this image).

#include <Python.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kPostingPad = 128;
constexpr int kMaxTokenLen = 255;  // in codepoints

inline bool is_word_cp(uint32_t cp) {
  if ((cp >= '0' && cp <= '9') || (cp >= 'A' && cp <= 'Z') ||
      (cp >= 'a' && cp <= 'z'))
    return true;
  if (cp >= 0x00C0 && cp <= 0x024F) return true;  // latin supplement/ext A+B
  if (cp >= 0x0400 && cp <= 0x04FF) return true;  // cyrillic
  return false;
}

// Unicode simple lowercase for the ranges is_word_cp admits.
inline uint32_t lower_cp(uint32_t cp) {
  if (cp >= 'A' && cp <= 'Z') return cp + 0x20;
  if (cp >= 0x00C0 && cp <= 0x00DE && cp != 0x00D7) return cp + 0x20;
  if (cp >= 0x0100 && cp <= 0x0137) return cp | 1;            // pairs
  if (cp >= 0x0139 && cp <= 0x0148) return ((cp - 1) | 1) + 1;  // odd pairs
  if (cp >= 0x014A && cp <= 0x0177) return cp | 1;
  if (cp == 0x0178) return 0x00FF;
  if (cp >= 0x0179 && cp <= 0x017E) return ((cp - 1) | 1) + 1;
  if (cp >= 0x0182 && cp <= 0x0185) return cp | 1;
  if (cp >= 0x01A0 && cp <= 0x01A5) return cp | 1;
  if (cp >= 0x01B3 && cp <= 0x01B6) return ((cp - 1) | 1) + 1;
  if (cp >= 0x01CD && cp <= 0x01DC) return ((cp - 1) | 1) + 1;
  if (cp >= 0x01DE && cp <= 0x01EF) return cp | 1;
  if (cp >= 0x01F4 && cp <= 0x01F5) return 0x01F5;
  if (cp >= 0x01F8 && cp <= 0x021F) return cp | 1;
  if (cp >= 0x0222 && cp <= 0x0233) return cp | 1;
  if (cp >= 0x0410 && cp <= 0x042F) return cp + 0x20;  // А-Я
  if (cp >= 0x0400 && cp <= 0x040F) return cp + 0x50;  // Ѐ-Џ
  if (cp >= 0x0460 && cp <= 0x0481) return cp | 1;
  if (cp >= 0x048A && cp <= 0x04BF) return cp | 1;
  if (cp >= 0x04C1 && cp <= 0x04CE) return ((cp - 1) | 1) + 1;
  if (cp >= 0x04D0 && cp <= 0x04FF) return cp | 1;
  return cp;
}

inline void append_utf8(std::string& out, uint32_t cp) {
  if (cp < 0x80) {
    out.push_back(static_cast<char>(cp));
  } else if (cp < 0x800) {
    out.push_back(static_cast<char>(0xC0 | (cp >> 6)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    out.push_back(static_cast<char>(0xE0 | (cp >> 12)));
    out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else {
    out.push_back(static_cast<char>(0xF0 | (cp >> 18)));
    out.push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  }
}

// Decode the next UTF-8 codepoint; on malformed input consume 1 byte and
// return 0xFFFD (matches Python's handling of already-valid str: malformed
// input cannot occur from CPython-encoded buffers).
inline uint32_t next_cp(const uint8_t* buf, size_t len, size_t& i) {
  uint8_t b0 = buf[i];
  if (b0 < 0x80) { i += 1; return b0; }
  if ((b0 >> 5) == 0x6 && i + 1 < len) {
    uint32_t cp = ((b0 & 0x1F) << 6) | (buf[i + 1] & 0x3F);
    i += 2; return cp;
  }
  if ((b0 >> 4) == 0xE && i + 2 < len) {
    uint32_t cp = ((b0 & 0x0F) << 12) | ((buf[i + 1] & 0x3F) << 6) |
                  (buf[i + 2] & 0x3F);
    i += 3; return cp;
  }
  if ((b0 >> 3) == 0x1E && i + 3 < len) {
    uint32_t cp = ((b0 & 0x07) << 18) | ((buf[i + 1] & 0x3F) << 12) |
                  ((buf[i + 2] & 0x3F) << 6) | (buf[i + 3] & 0x3F);
    i += 4; return cp;
  }
  i += 1;
  return 0xFFFD;
}

struct Posting {
  int32_t doc;
  int32_t tf;
  std::vector<int32_t> positions;
};

struct TermEntry {
  std::vector<Posting> postings;
};

struct Builder {
  std::unordered_map<std::string, TermEntry> terms;
  std::vector<int32_t> fieldnorms;   // token count per doc
  std::vector<int32_t> pos_base;     // next position base per doc (with gaps)
  int64_t total_tokens = 0;
  bool with_positions = false;
};

void add_value(Builder& b, int32_t doc, const uint8_t* buf, size_t len) {
  if (static_cast<size_t>(doc) >= b.fieldnorms.size()) {
    b.fieldnorms.resize(doc + 1, 0);
    b.pos_base.resize(doc + 1, 0);
  }
  int32_t base = b.pos_base[doc];
  // position indexes every token (even dropped overlong ones occupy a
  // position slot — tokenizer parity with query/tokenizers.py enumerate());
  // kept counts only indexed tokens (fieldnorm / BM25 doc length).
  int32_t position = 0;
  int32_t kept = 0;
  std::string token;
  size_t token_cps = 0;
  size_t i = 0;
  auto flush = [&](void) {
    if (!token.empty()) {
      if (token_cps <= kMaxTokenLen) {
        TermEntry& entry = b.terms[token];
        if (!entry.postings.empty() && entry.postings.back().doc == doc) {
          entry.postings.back().tf += 1;
          if (b.with_positions)
            entry.postings.back().positions.push_back(base + position);
        } else {
          Posting p;
          p.doc = doc;
          p.tf = 1;
          if (b.with_positions) p.positions.push_back(base + position);
          entry.postings.push_back(std::move(p));
        }
        kept += 1;
      }
      position += 1;
      token.clear();
      token_cps = 0;
    }
  };
  while (i < len) {
    uint32_t cp = next_cp(buf, len, i);
    if (is_word_cp(cp)) {
      append_utf8(token, lower_cp(cp));
      token_cps += 1;
    } else {
      flush();
    }
  }
  flush();
  b.fieldnorms[doc] += kept;
  // +1 gap between values so phrases never match across value boundaries
  b.pos_base[doc] = base + kept + 1;
  b.total_tokens += kept;
}

inline int64_t pad_to(int64_t n, int64_t m) { return ((n + m - 1) / m) * m; }

// ---------------------------------------------------------------------------
// Python bindings

struct BuilderCapsule {
  Builder builder;
};

void capsule_destructor(PyObject* capsule) {
  delete static_cast<BuilderCapsule*>(
      PyCapsule_GetPointer(capsule, "fastindex.Builder"));
}

PyObject* py_new_builder(PyObject*, PyObject* args) {
  int with_positions = 0;
  if (!PyArg_ParseTuple(args, "p", &with_positions)) return nullptr;
  auto* cap = new BuilderCapsule();
  cap->builder.with_positions = with_positions != 0;
  return PyCapsule_New(cap, "fastindex.Builder", capsule_destructor);
}

Builder* get_builder(PyObject* capsule) {
  auto* cap = static_cast<BuilderCapsule*>(
      PyCapsule_GetPointer(capsule, "fastindex.Builder"));
  return cap ? &cap->builder : nullptr;
}

// add_values(builder, doc_ids_bytes(int32 LE), text_blob, offsets_bytes(int64 LE))
PyObject* py_add_values(PyObject*, PyObject* args) {
  PyObject* capsule;
  Py_buffer doc_ids_buf, text_buf, offsets_buf;
  if (!PyArg_ParseTuple(args, "Oy*y*y*", &capsule, &doc_ids_buf, &text_buf,
                        &offsets_buf))
    return nullptr;
  Builder* b = get_builder(capsule);
  if (b == nullptr) {
    PyBuffer_Release(&doc_ids_buf);
    PyBuffer_Release(&text_buf);
    PyBuffer_Release(&offsets_buf);
    PyErr_SetString(PyExc_ValueError, "invalid builder capsule");
    return nullptr;
  }
  const auto* doc_ids = static_cast<const int32_t*>(doc_ids_buf.buf);
  const auto* text = static_cast<const uint8_t*>(text_buf.buf);
  const auto* offsets = static_cast<const int64_t*>(offsets_buf.buf);
  Py_ssize_t n_values = doc_ids_buf.len / static_cast<Py_ssize_t>(sizeof(int32_t));
  Py_BEGIN_ALLOW_THREADS
  for (Py_ssize_t v = 0; v < n_values; ++v) {
    add_value(*b, doc_ids[v], text + offsets[v],
              static_cast<size_t>(offsets[v + 1] - offsets[v]));
  }
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&doc_ids_buf);
  PyBuffer_Release(&text_buf);
  PyBuffer_Release(&offsets_buf);
  Py_RETURN_NONE;
}

// finish(builder, num_docs_padded) ->
//   (terms_blob, term_offsets, dfs, post_offs, post_lens,
//    ids_arena, tfs_arena, fieldnorms, total_tokens,
//    pos_offsets|None, pos_data|None)      -- all bytes objects (LE arrays)
PyObject* py_finish(PyObject*, PyObject* args) {
  PyObject* capsule;
  long long num_docs_padded;
  if (!PyArg_ParseTuple(args, "OL", &capsule, &num_docs_padded)) return nullptr;
  Builder* b = get_builder(capsule);
  if (b == nullptr) {
    PyErr_SetString(PyExc_ValueError, "invalid builder capsule");
    return nullptr;
  }

  std::vector<const std::string*> sorted_terms;
  sorted_terms.reserve(b->terms.size());
  for (const auto& kv : b->terms) sorted_terms.push_back(&kv.first);
  std::string blob;
  std::vector<int64_t> term_offsets;
  std::vector<int32_t> dfs;
  std::vector<int64_t> post_offs;
  std::vector<int32_t> post_lens;
  std::vector<int32_t> ids_arena;
  std::vector<int32_t> tfs_arena;
  std::vector<int64_t> pos_offsets;
  std::vector<int32_t> pos_data;

  Py_BEGIN_ALLOW_THREADS
  std::sort(sorted_terms.begin(), sorted_terms.end(),
            [](const std::string* a, const std::string* s) { return *a < *s; });
  size_t n_terms = sorted_terms.size();
  term_offsets.reserve(n_terms + 1);
  term_offsets.push_back(0);
  dfs.reserve(n_terms);
  post_offs.reserve(n_terms);
  post_lens.reserve(n_terms);
  int64_t total_padded = 0;
  for (const std::string* term : sorted_terms) {
    int64_t df = static_cast<int64_t>(b->terms[*term].postings.size());
    total_padded += pad_to(df, kPostingPad);
  }
  ids_arena.assign(total_padded, static_cast<int32_t>(num_docs_padded));
  tfs_arena.assign(total_padded, 0);
  if (b->with_positions) pos_offsets.assign(total_padded + 1, 0);
  int64_t cursor = 0;
  int64_t pos_cursor = 0;
  for (const std::string* term : sorted_terms) {
    blob += *term;
    term_offsets.push_back(static_cast<int64_t>(blob.size()));
    auto& postings = b->terms[*term].postings;
    int64_t df = static_cast<int64_t>(postings.size());
    int64_t padded = pad_to(df, kPostingPad);
    dfs.push_back(static_cast<int32_t>(df));
    post_offs.push_back(cursor);
    post_lens.push_back(static_cast<int32_t>(padded));
    for (int64_t i = 0; i < df; ++i) {
      ids_arena[cursor + i] = postings[i].doc;
      tfs_arena[cursor + i] = postings[i].tf;
      if (b->with_positions) {
        pos_offsets[cursor + i] = pos_cursor;
        for (int32_t p : postings[i].positions) pos_data.push_back(p);
        pos_cursor += static_cast<int64_t>(postings[i].positions.size());
      }
    }
    if (b->with_positions) {
      for (int64_t i = df; i <= padded && cursor + i <= total_padded; ++i)
        pos_offsets[cursor + i] = pos_cursor;
    }
    cursor += padded;
  }
  Py_END_ALLOW_THREADS

  std::vector<int32_t> norms(num_docs_padded, 0);
  size_t copy_n = std::min(b->fieldnorms.size(),
                           static_cast<size_t>(num_docs_padded));
  std::memcpy(norms.data(), b->fieldnorms.data(), copy_n * sizeof(int32_t));

  auto bytes_of = [](const void* data, size_t nbytes) {
    return PyBytes_FromStringAndSize(static_cast<const char*>(data),
                                     static_cast<Py_ssize_t>(nbytes));
  };
  PyObject* result = PyTuple_New(11);
  PyTuple_SET_ITEM(result, 0, bytes_of(blob.data(), blob.size()));
  PyTuple_SET_ITEM(result, 1, bytes_of(term_offsets.data(),
                                       term_offsets.size() * 8));
  PyTuple_SET_ITEM(result, 2, bytes_of(dfs.data(), dfs.size() * 4));
  PyTuple_SET_ITEM(result, 3, bytes_of(post_offs.data(), post_offs.size() * 8));
  PyTuple_SET_ITEM(result, 4, bytes_of(post_lens.data(), post_lens.size() * 4));
  PyTuple_SET_ITEM(result, 5, bytes_of(ids_arena.data(), ids_arena.size() * 4));
  PyTuple_SET_ITEM(result, 6, bytes_of(tfs_arena.data(), tfs_arena.size() * 4));
  PyTuple_SET_ITEM(result, 7, bytes_of(norms.data(), norms.size() * 4));
  PyTuple_SET_ITEM(result, 8, PyLong_FromLongLong(b->total_tokens));
  if (b->with_positions) {
    PyTuple_SET_ITEM(result, 9, bytes_of(pos_offsets.data(),
                                         pos_offsets.size() * 8));
    PyTuple_SET_ITEM(result, 10, bytes_of(pos_data.data(),
                                          pos_data.size() * 4));
  } else {
    Py_INCREF(Py_None);
    PyTuple_SET_ITEM(result, 9, Py_None);
    Py_INCREF(Py_None);
    PyTuple_SET_ITEM(result, 10, Py_None);
  }
  return result;
}

// ---------------------------------------------------------------------------
// k-way term-dictionary merge — the merge hot loop
// (role of tantivy's segment merge driven by the reference MergeExecutor,
// merge_split_directories; array-level: postings are re-based and
// re-padded, never re-tokenized). Semantics mirror
// index/merge_arrays.py::_merge_inverted exactly.

struct MergeReader {
  const uint8_t* blob;
  const int64_t* term_offsets;  // n_terms + 1
  const int32_t* dfs;
  const int64_t* post_offs;
  const int32_t* ids;
  const int32_t* tfs;
  const int64_t* pos_offs;  // arena_len + 1, or nullptr
  const int32_t* pos_data;  // or nullptr
  int64_t n_terms;
  int64_t doc_offset;
  int64_t cursor;  // current term ordinal

  bool done() const { return cursor >= n_terms; }
  std::pair<const uint8_t*, size_t> term() const {
    int64_t lo = term_offsets[cursor], hi = term_offsets[cursor + 1];
    return {blob + lo, static_cast<size_t>(hi - lo)};
  }
};

inline int term_cmp(std::pair<const uint8_t*, size_t> a,
                    std::pair<const uint8_t*, size_t> b) {
  size_t n = std::min(a.second, b.second);
  int c = std::memcmp(a.first, b.first, n);
  if (c != 0) return c;
  return a.second < b.second ? -1 : (a.second > b.second ? 1 : 0);
}

// merge_inverted([(blob, term_offsets, dfs, post_offs, ids, tfs,
//                  pos_offs|None, pos_data|None, doc_offset), ...],
//                num_docs_padded, with_positions)
//   -> (blob, term_offsets, dfs, post_offs, post_lens, ids, tfs,
//       pos_offsets|None, pos_data|None)        -- bytes (LE arrays)
PyObject* py_merge_inverted(PyObject*, PyObject* args) {
  PyObject* readers_list;
  long long num_docs_padded;
  int with_positions;
  if (!PyArg_ParseTuple(args, "OLp", &readers_list, &num_docs_padded,
                        &with_positions))
    return nullptr;
  if (!PyList_Check(readers_list)) {
    PyErr_SetString(PyExc_TypeError, "merge_inverted expects a list");
    return nullptr;
  }
  Py_ssize_t n_readers = PyList_Size(readers_list);
  std::vector<MergeReader> readers(n_readers);
  std::vector<std::vector<Py_buffer>> held(n_readers);
  auto release_all = [&]() {
    for (auto& bufs : held)
      for (auto& buf : bufs) PyBuffer_Release(&buf);
  };
  for (Py_ssize_t i = 0; i < n_readers; ++i) {
    PyObject* tup = PyList_GetItem(readers_list, i);
    Py_buffer blob_b, toffs_b, dfs_b, poffs_b, ids_b, tfs_b;
    PyObject *pos_offs_o, *pos_data_o;
    long long doc_offset;
    if (!PyArg_ParseTuple(tup, "y*y*y*y*y*y*OOL", &blob_b, &toffs_b, &dfs_b,
                          &poffs_b, &ids_b, &tfs_b, &pos_offs_o, &pos_data_o,
                          &doc_offset)) {
      release_all();
      return nullptr;
    }
    held[i] = {blob_b, toffs_b, dfs_b, poffs_b, ids_b, tfs_b};
    MergeReader& r = readers[i];
    r.blob = static_cast<const uint8_t*>(blob_b.buf);
    r.term_offsets = static_cast<const int64_t*>(toffs_b.buf);
    r.dfs = static_cast<const int32_t*>(dfs_b.buf);
    r.post_offs = static_cast<const int64_t*>(poffs_b.buf);
    r.ids = static_cast<const int32_t*>(ids_b.buf);
    r.tfs = static_cast<const int32_t*>(tfs_b.buf);
    r.n_terms = dfs_b.len / 4;
    r.doc_offset = doc_offset;
    r.cursor = 0;
    r.pos_offs = nullptr;
    r.pos_data = nullptr;
    if (pos_offs_o != Py_None && pos_data_o != Py_None) {
      Py_buffer po_b, pd_b;
      if (PyObject_GetBuffer(pos_offs_o, &po_b, PyBUF_SIMPLE) != 0 ||
          (PyObject_GetBuffer(pos_data_o, &pd_b, PyBUF_SIMPLE) != 0 &&
           (PyBuffer_Release(&po_b), true))) {
        release_all();
        return nullptr;
      }
      held[i].push_back(po_b);
      held[i].push_back(pd_b);
      r.pos_offs = static_cast<const int64_t*>(po_b.buf);
      r.pos_data = static_cast<const int32_t*>(pd_b.buf);
    }
  }

  std::string blob;
  std::vector<int64_t> term_offsets{0};
  std::vector<int32_t> dfs;
  std::vector<int64_t> post_offs;
  std::vector<int32_t> post_lens;
  std::vector<int32_t> ids_arena;
  std::vector<int32_t> tfs_arena;
  std::vector<int64_t> pos_offsets;
  std::vector<int32_t> pos_data;

  Py_BEGIN_ALLOW_THREADS
  {
    // upper-bound reservations: repeated geometric growth of the arenas
    // would memcpy hundreds of MB; the bound is cheap and tight enough
    // (sum of input dfs + worst-case padding per distinct term)
    int64_t max_terms = 0, sum_df = 0, blob_bytes = 0, pos_bytes = 0;
    for (auto& r : readers) {
      max_terms += r.n_terms;
      blob_bytes += r.term_offsets[r.n_terms];
      for (int64_t t = 0; t < r.n_terms; ++t) sum_df += r.dfs[t];
      if (r.pos_offs != nullptr && r.n_terms > 0) {
        int64_t last = r.post_offs[r.n_terms - 1] + r.dfs[r.n_terms - 1];
        pos_bytes += r.pos_offs[last];
      }
    }
    int64_t max_padded = sum_df + max_terms * (kPostingPad - 1) + kPostingPad;
    blob.reserve(blob_bytes);
    term_offsets.reserve(max_terms + 1);
    dfs.reserve(max_terms);
    post_offs.reserve(max_terms);
    post_lens.reserve(max_terms);
    ids_arena.reserve(max_padded);
    tfs_arena.reserve(max_padded);
    if (with_positions) {
      pos_offsets.reserve(max_padded + 1);
      pos_data.reserve(pos_bytes);
    }
  }
  int64_t cursor = 0;
  int64_t pos_cursor = 0;
  std::vector<Py_ssize_t> group;
  for (;;) {
    // min term among the heads (k is small: linear scan beats a heap)
    Py_ssize_t first = -1;
    for (Py_ssize_t i = 0; i < n_readers; ++i) {
      if (readers[i].done()) continue;
      if (first < 0 || term_cmp(readers[i].term(), readers[first].term()) < 0)
        first = i;
    }
    if (first < 0) break;
    auto term = readers[first].term();
    group.clear();
    for (Py_ssize_t i = first; i < n_readers; ++i) {
      if (!readers[i].done() && term_cmp(readers[i].term(), term) == 0)
        group.push_back(i);  // ascending reader order == ascending doc ids
    }

    int64_t df = 0;
    for (Py_ssize_t i : group) df += readers[i].dfs[readers[i].cursor];
    int64_t padded = pad_to(std::max<int64_t>(df, 1), kPostingPad);
    size_t base = ids_arena.size();
    ids_arena.resize(base + padded, static_cast<int32_t>(num_docs_padded));
    tfs_arena.resize(base + padded, 0);
    if (with_positions) pos_offsets.resize(base + padded, 0);
    int64_t w = 0;
    for (Py_ssize_t i : group) {
      MergeReader& r = readers[i];
      int64_t lo = r.post_offs[r.cursor];
      int64_t rdf = r.dfs[r.cursor];
      // bulk copies: tfs memcpy; ids re-based in a vectorizable loop
      std::memcpy(tfs_arena.data() + base + w, r.tfs + lo, rdf * 4);
      const int32_t off = static_cast<int32_t>(r.doc_offset);
      int32_t* dst = ids_arena.data() + base + w;
      const int32_t* src = r.ids + lo;
      for (int64_t j = 0; j < rdf; ++j) dst[j] = src[j] + off;
      if (with_positions && r.pos_offs != nullptr) {
        int64_t plo = r.pos_offs[lo], phi = r.pos_offs[lo + rdf];
        int64_t* podst = pos_offsets.data() + base + w;
        const int64_t* posrc = r.pos_offs + lo;
        const int64_t shift = pos_cursor - plo;
        for (int64_t j = 0; j < rdf; ++j) podst[j] = posrc[j] + shift;
        pos_data.insert(pos_data.end(), r.pos_data + plo, r.pos_data + phi);
        pos_cursor += phi - plo;
      } else if (with_positions) {
        for (int64_t j = 0; j < rdf; ++j) pos_offsets[base + w + j] = pos_cursor;
      }
      w += rdf;
      ++r.cursor;
    }
    if (with_positions) {
      for (int64_t j = df; j < padded; ++j) pos_offsets[base + j] = pos_cursor;
    }
    blob.append(reinterpret_cast<const char*>(term.first), term.second);
    term_offsets.push_back(static_cast<int64_t>(blob.size()));
    dfs.push_back(static_cast<int32_t>(df));
    post_offs.push_back(cursor);
    post_lens.push_back(static_cast<int32_t>(padded));
    cursor += padded;
  }
  if (with_positions) pos_offsets.push_back(pos_cursor);  // trailing guard
  Py_END_ALLOW_THREADS

  release_all();
  auto bytes_of = [](const void* data, size_t nbytes) {
    return PyBytes_FromStringAndSize(static_cast<const char*>(data),
                                     static_cast<Py_ssize_t>(nbytes));
  };
  PyObject* result = PyTuple_New(9);
  PyTuple_SET_ITEM(result, 0, bytes_of(blob.data(), blob.size()));
  PyTuple_SET_ITEM(result, 1, bytes_of(term_offsets.data(),
                                       term_offsets.size() * 8));
  PyTuple_SET_ITEM(result, 2, bytes_of(dfs.data(), dfs.size() * 4));
  PyTuple_SET_ITEM(result, 3, bytes_of(post_offs.data(), post_offs.size() * 8));
  PyTuple_SET_ITEM(result, 4, bytes_of(post_lens.data(), post_lens.size() * 4));
  PyTuple_SET_ITEM(result, 5, bytes_of(ids_arena.data(), ids_arena.size() * 4));
  PyTuple_SET_ITEM(result, 6, bytes_of(tfs_arena.data(), tfs_arena.size() * 4));
  if (with_positions) {
    PyTuple_SET_ITEM(result, 7, bytes_of(pos_offsets.data(),
                                         pos_offsets.size() * 8));
    PyTuple_SET_ITEM(result, 8, bytes_of(pos_data.data(), pos_data.size() * 4));
  } else {
    Py_INCREF(Py_None);
    PyTuple_SET_ITEM(result, 7, Py_None);
    Py_INCREF(Py_None);
    PyTuple_SET_ITEM(result, 8, Py_None);
  }
  return result;
}

PyMethodDef kMethods[] = {
    {"new_builder", py_new_builder, METH_VARARGS,
     "new_builder(with_positions) -> capsule"},
    {"add_values", py_add_values, METH_VARARGS,
     "add_values(builder, doc_ids_i32, text_blob, offsets_i64)"},
    {"finish", py_finish, METH_VARARGS,
     "finish(builder, num_docs_padded) -> arrays tuple"},
    {"merge_inverted", py_merge_inverted, METH_VARARGS,
     "merge_inverted(readers, num_docs_padded, with_positions) -> arrays"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef kModule = {PyModuleDef_HEAD_INIT, "fastindex",
                       "native inverted-index builder", -1, kMethods,
                       nullptr, nullptr, nullptr, nullptr};

}  // namespace

PyMODINIT_FUNC PyInit_fastindex(void) { return PyModule_Create(&kModule); }
