"""Host-side phrase matching over positional postings.

Role of tantivy's `PhraseScorer` in the reference's leaf loop. Phrase
evaluation is a *pre-pass* in this engine: it runs on the (host-resident)
postings + positions of the phrase terms and produces a precomputed posting
list (doc ids + phrase frequencies) that enters the device plan like any
term's postings. This keeps the device graph static while supporting exact
phrases; a Pallas positional kernel is the planned upgrade path.

slop>0 uses the k-way minimal-window algorithm over RELATIVE positions
(p_i - i): an alignment of the phrase terms matches when the spread of
their relative positions is <= slop — tantivy's PhraseScorer semantics.
"""

from __future__ import annotations

import numpy as np


# qwlint: disable-next-line=QW001 - positions arrive as host numpy from
# the split's position index; matching never touches device arrays
def phrase_match(
    postings: list[tuple[np.ndarray, np.ndarray]],
    positions: list[tuple[np.ndarray, np.ndarray]],
    dfs: list[int],
    slop: int = 0,
    term_keys: list | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Docs containing the terms as an exact phrase.

    `postings[i] = (padded_ids, padded_tfs)` and
    `positions[i] = (offsets[post_len+1], data)` for phrase term i, with
    `dfs[i]` real (unpadded) postings. `term_keys[i]` identifies the term
    in slot i so REPEATED phrase terms ("a a") are required to occupy
    distinct document positions, as in Lucene/tantivy. Returns
    (doc_ids, phrase_freqs), unpadded, sorted by doc id.
    """
    if not postings:
        return np.array([], dtype=np.int32), np.array([], dtype=np.int32)

    # intersect doc ids across all terms, tracking each term's posting index
    ids0 = postings[0][0][: dfs[0]]
    common = ids0
    for (ids, _), df in zip(postings[1:], dfs[1:]):
        common = np.intersect1d(common, ids[:df], assume_unique=True)
        if common.size == 0:
            return np.array([], dtype=np.int32), np.array([], dtype=np.int32)

    out_ids: list[int] = []
    out_freqs: list[int] = []
    # per-term posting index of each common doc
    term_indices = []
    for (ids, _), df in zip(postings, dfs):
        term_indices.append(np.searchsorted(ids[:df], common))

    # slots holding the same term must align to distinct positions
    dup_groups: list[list[int]] = []
    if term_keys is not None:
        by_key: dict = {}
        for i, k in enumerate(term_keys):
            by_key.setdefault(k, []).append(i)
        dup_groups = [slots for slots in by_key.values() if len(slots) > 1]

    if slop == 0:
        return _exact_phrase_vectorized(positions, term_indices, common)

    for row, doc_id in enumerate(common):
        relatives = []
        for i in range(len(postings)):
            offs, data = positions[i]
            ji = term_indices[i][row]
            relatives.append(
                data[offs[ji]: offs[ji + 1]].astype(np.int64) - i)
        freq = _sloppy_matches(relatives, slop, dup_groups)
        if freq > 0:
            out_ids.append(int(doc_id))
            out_freqs.append(freq)
    return np.array(out_ids, dtype=np.int32), np.array(out_freqs, dtype=np.int32)


# qwlint: disable-next-line=QW001 - vectorized host numpy inner loop of
# phrase_match (see note there)
def _exact_phrase_vectorized(positions, term_indices, common):
    """slop=0 across ALL common docs at once — no per-doc Python loop.

    Positions of term i are shifted by -i (relative alignment) and encoded
    as doc_row * 2^32 + relative_position; the phrase's alignments are the
    k-way intersection of these encoded sets, and per-doc phrase freqs fall
    out of one bincount. Frequent phrases (10^4+ candidate docs) match in
    milliseconds instead of seconds."""
    base = None
    for i, (offs, data) in enumerate(positions):
        idx = term_indices[i]
        starts = offs[idx].astype(np.int64)
        lens = (offs[idx + 1] - offs[idx]).astype(np.int64)
        total = int(lens.sum())
        if total == 0:
            return (np.array([], dtype=np.int32),
                    np.array([], dtype=np.int32))
        # ragged gather: element j of run r sits at starts[r] + j
        run_of = np.repeat(np.arange(len(idx), dtype=np.int64), lens)
        within = np.arange(total, dtype=np.int64) - \
            np.repeat(np.cumsum(lens) - lens, lens)
        vals = data[starts[run_of] + within].astype(np.int64)
        # +len(positions) keeps the shifted relatives (vals - i) positive
        # for every slot, so the doc-row bits stay clean
        encoded = run_of << np.int64(32) | (vals - i + len(positions))
        base = encoded if base is None else \
            np.intersect1d(base, encoded, assume_unique=True)
        if base.size == 0:
            return (np.array([], dtype=np.int32),
                    np.array([], dtype=np.int32))
    rows = (base >> np.int64(32)).astype(np.int64)
    freqs_per_row = np.bincount(rows, minlength=len(common))
    hit_rows = np.nonzero(freqs_per_row)[0]
    return (common[hit_rows].astype(np.int32),
            freqs_per_row[hit_rows].astype(np.int32))


def _sloppy_matches(relatives: list[np.ndarray], slop: int,
                    dup_groups: list[list[int]] = ()) -> int:
    """Number of k-way alignments whose relative-position spread <= slop
    (minimal-window sweep with one pointer per term). A window only counts
    when slots of a repeated term (`dup_groups`) sit at distinct absolute
    positions (relative + slot index) — Lucene/tantivy semantics."""
    pointers = [0] * len(relatives)
    matches = 0
    while all(p < len(r) for p, r in zip(pointers, relatives)):
        values = [r[p] for p, r in zip(pointers, relatives)]
        lo, hi = min(values), max(values)
        if hi - lo <= slop and all(
                len({values[i] + i for i in group}) == len(group)
                for group in dup_groups):
            matches += 1
        # advance the minimum pointer to look for further windows
        advance = values.index(lo)
        pointers[advance] += 1
    return matches
