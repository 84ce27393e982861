"""The yardstick of the rooflines: the chip's published peaks and the bytes
that the requests themselves need, counted from the raw corpus and the
splits' stored widths, whatever kernels the program runs.

A roofline share is the least time those bytes take at the peak rate,
over the device's busy time in the traced window.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, at its 700 W power limit
H100_HBM_BYTES_PER_S = 3.35e12
# a posting as a search reads it: doc id, term frequency, field length
POSTING_BYTES = 4 + 4 + 4


def fields_read(request: dict, timestamp_field: str) -> set[str]:
    """The columns an aggregation-only request reads: the fields its
    aggregations name, and the timestamp when the request bounds time."""
    out = set()
    if (request.get("start_timestamp") is not None
            or request.get("end_timestamp") is not None):
        out.add(timestamp_field)

    def walk(aggs):
        for body in (aggs or {}).values():
            for kind, params in body.items():
                if kind == "aggs":
                    walk(params)
                elif isinstance(params, dict) and "field" in params:
                    out.add(params["field"])
    walk(request.get("aggs"))
    return out


def _in_range(ts: np.ndarray, request: dict) -> int:
    """How many of a split's sorted timestamps the time bounds select."""
    lo = request.get("start_timestamp")
    hi = request.get("end_timestamp")
    a = 0 if lo is None else int(np.searchsorted(ts, lo, "left"))
    b = len(ts) if hi is None else int(np.searchsorted(ts, hi, "left"))
    return max(0, b - a)


def aggregation_bytes(request: dict, timestamp_field: str,
                      splits: list[dict]) -> int:
    """Bytes an aggregation-only request needs: over each split, the
    docs its time bounds select times the stored width of each column it
    reads, each counted once. `splits`: per split, `ts_us` (its sorted
    timestamps) and `width` (bytes per doc of each column as stored)."""
    fields = fields_read(request, timestamp_field)
    return sum(_in_range(split["ts_us"], request)
               * sum(split["width"][f] for f in fields) for split in splits)


def search_bytes(request: dict, timestamp_field: str,
                 splits: list[dict]) -> int:
    """Bytes a request's query and hits need: over each split, for each
    distinct term its query reads, the term's docs times a posting's
    bytes; where it asks for hits, the docs its time bounds select times
    the timestamp column's stored width (unless it aggregates too: then
    `aggregation_bytes` counts that column) and, where it sorts on a
    field, the docs it matches times that column's stored width.
    `splits`: per split, `ts_us`, `width` (as for `aggregation_bytes`)
    and `split` (the plain reference's view of its raw documents, which
    counts the docs)."""
    query = request.get("query", {"match_all": {}})
    hits = bool(request.get("max_hits", 20))
    sort = (request.get("sort_by") or [{"field": "_score"}])[0]["field"]
    bounded = (hits and not request.get("aggs")
               and (request.get("start_timestamp") is not None
                    or request.get("end_timestamp") is not None))
    total = 0
    for split in splits:
        ref = split["split"]
        for field, term in ref.query_terms(query):
            total += ref.doc_freq(field, term) * POSTING_BYTES
        if bounded:
            total += (_in_range(split["ts_us"], request)
                      * split["width"][timestamp_field])
        if hits and sort not in ("_score", "_doc"):
            total += (int(ref.request_mask(request).sum())
                      * split["width"][sort])
    return total


def share(needed_bytes: float, busy_s: float) -> float | None:
    """The roofline share in %, or None when the window did no work."""
    if busy_s <= 0 or needed_bytes <= 0:
        return None
    return 100.0 * (needed_bytes / H100_HBM_BYTES_PER_S) / busy_s
