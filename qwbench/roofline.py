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


def aggregation_bytes(request: dict, timestamp_field: str,
                      splits: list[dict]) -> int:
    """Bytes an aggregation-only request needs: over each split, the
    docs its time bounds select times the stored width of each column it
    reads, each counted once. `splits`: per split, `ts_us` (its sorted
    timestamps) and `width` (bytes per doc of each column as stored)."""
    lo = request.get("start_timestamp")
    hi = request.get("end_timestamp")
    fields = fields_read(request, timestamp_field)
    total = 0
    for split in splits:
        ts = split["ts_us"]
        a = 0 if lo is None else int(np.searchsorted(ts, lo, "left"))
        b = len(ts) if hi is None else int(np.searchsorted(ts, hi, "left"))
        total += max(0, b - a) * sum(split["width"][f] for f in fields)
    return total


def share(needed_bytes: float, busy_s: float) -> float | None:
    """The roofline share in %, or None when the window did no work."""
    if busy_s <= 0 or needed_bytes <= 0:
        return None
    return 100.0 * (needed_bytes / H100_HBM_BYTES_PER_S) / busy_s
