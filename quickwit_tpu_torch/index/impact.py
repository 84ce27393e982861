"""Impact-ordered postings: write-time BM25 quantization (format v3).

Role of the impact-sorted index family (BM25S, arxiv 2407.03618): each
posting's BM25 contribution is fully determined at write time (tf, the
doc's fieldnorm, the field's avg_len and the term's df are all frozen
when the split seals), so the score can be precomputed, quantized into
u8 buckets, and the postings stored sorted by descending impact. At
query time a pushed-down threshold then prunes whole 128-posting blocks
— and because the order is by impact, the live set is a *prefix*, so the
reader can skip staging the tail entirely.

Soundness contract (property-asserted in tests/test_impact_postings.py):

  quant[i] * scale  >=  exact query-time score of posting i   (always)

with `scale` persisted per term as f64. The quantized value is used ONLY
for skipping; survivors are rescored by the seed `ops.bm25` path, so
results stay bit-identical to doc-ordered execution.

Tie-break equivalence: the sort key is the *f32* score exactly as the
query kernel computes it (`_exact_scores_f32` mirrors
`ops.bm25.score_postings` operation by operation), secondary key doc id
ascending. Equal-f32-score groups therefore stay contiguous and
doc-ascending, so `lax.top_k`'s lowest-index-wins tie rule selects the
same docs in the same order as the seed doc-ordered layout for score
sorts. Field-primary sorts over impact-ordered postings are NOT
tie-equivalent and must not take the posting-space path (the executor
gates on `PPostings.impact_ordered`).

Everything here is plain numpy on host wire-state — no jax, no device
sync (this module is in qwlint QW001/QW002 scope).
"""

from __future__ import annotations

import numpy as np

from ..ops.bm25 import B, K1, idf as bm25_idf

# One impact block == POSTING_PAD, so per-term posting ranges (always
# 128-multiples, see writer.py arena layout) cover whole blocks and a
# block never straddles two terms.
IMPACT_BLOCK = 128
IMPACT_BUCKETS = 255
# Headroom on the persisted scale so `quant * scale` stays an upper bound
# even against scores recomputed through a differently-rounded path
# (e.g. the f64 "exact" score in the property suite, ~1e-7 relative off
# the f32 kernel value).
SCALE_MARGIN = 1e-4

_F32 = np.float32


def exact_scores_f32(tfs: np.ndarray, doc_ids: np.ndarray,
                     fieldnorms: np.ndarray, avg_len: float,
                     idf_value) -> np.ndarray:
    """The query kernel's score, replicated in numpy f32.

    Must stay operation-for-operation identical to
    `ops.bm25.score_postings` (same casts, same constant placement, same
    maximum clamps) so the write-time sort key equals the query-time f32
    score bit-for-bit — that equality is what makes impact-ordered
    tie-breaks reproduce the doc-ordered ones.
    """
    tf = tfs.astype(_F32)
    idx = np.clip(doc_ids, 0, fieldnorms.shape[0] - 1)
    norms = fieldnorms[idx].astype(_F32)
    avg = np.maximum(_F32(avg_len), _F32(1e-9))
    denom = tf + _F32(K1) * (_F32(1.0 - B) + _F32(B) * norms / avg)
    return (_F32(idf_value) * _F32(K1 + 1.0)) * tf / np.maximum(denom,
                                                                _F32(1e-9))


def quantize_term(scores_f32: np.ndarray):
    """(quant u8, scale f64) for one term's exact f32 scores.

    quant = ceil(score * 255 / max_score), scale = max_score * (1+margin)
    / 255, so quant*scale >= score*(1+margin) > score for every posting,
    and the first (highest-impact) posting lands exactly on bucket 255.
    """
    if scores_f32.size == 0:
        return (np.zeros(0, dtype=np.uint8), np.float64(0.0))
    s64 = scores_f32.astype(np.float64)
    m = s64.max()
    if not (m > 0.0):
        return (np.zeros(scores_f32.shape[0], dtype=np.uint8),
                np.float64(0.0))
    q = np.ceil(s64 * (np.float64(IMPACT_BUCKETS) / m))
    q = np.minimum(q, np.float64(IMPACT_BUCKETS)).astype(np.uint8)
    scale = m * (1.0 + SCALE_MARGIN) / np.float64(IMPACT_BUCKETS)
    return q, scale


def build_impact_arrays(ids_arena: np.ndarray, tfs_arena: np.ndarray,
                        post_offs: np.ndarray, dfs: np.ndarray,
                        fieldnorms: np.ndarray, avg_len: float,
                        num_docs: int):
    """Impact-order every term's postings and emit the v3 side arrays.

    Inputs are the writer's padded posting arenas (pad lanes: id ==
    sentinel >= num_docs, tf == 0) plus the per-term layout. Returns
    (ids, tfs, quant, bmax, scales):

      ids/tfs  — copies of the arenas with each term's real postings
                 stably reordered by (-f32_score, doc_id); pads untouched
      quant    — u8 per posting (pads 0), aligned with the arenas
      bmax     — u8 per IMPACT_BLOCK postings, max quant in the block;
                 non-increasing within a term by construction
      scales   — f64 per term
    """
    ids = np.array(ids_arena, dtype=np.int32, copy=True)
    tfs = np.array(tfs_arena, dtype=np.int32, copy=True)
    quant = np.zeros(ids.shape[0], dtype=np.uint8)
    num_terms = post_offs.shape[0]
    scales = np.zeros(num_terms, dtype=np.float64)
    # one bulk host decode for the whole loop instead of two per-term
    # casts (inputs are host numpy wire-state by module contract)
    post_offs_l = post_offs.tolist()
    dfs_l = dfs.tolist()
    for t in range(num_terms):
        lo = post_offs_l[t]
        df = dfs_l[t]
        if df <= 0:
            continue
        term_ids = ids[lo:lo + df]
        term_tfs = tfs[lo:lo + df]
        idf32 = _F32(bm25_idf(num_docs, df))
        s32 = exact_scores_f32(term_tfs, term_ids, fieldnorms, avg_len,
                               idf32)
        # lexsort: last key is primary — descending score, then doc asc
        order = np.lexsort((term_ids, -s32))
        ids[lo:lo + df] = term_ids[order]
        tfs[lo:lo + df] = term_tfs[order]
        q, scale = quantize_term(s32[order])
        quant[lo:lo + df] = q
        scales[t] = scale
    nblocks = ids.shape[0] // IMPACT_BLOCK
    bmax = quant[:nblocks * IMPACT_BLOCK].reshape(
        nblocks, IMPACT_BLOCK).max(axis=1)
    return ids, tfs, quant, bmax, scales
