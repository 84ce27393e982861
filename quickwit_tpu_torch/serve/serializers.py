"""JSON wire encoding for the internal search RPCs.

Role of the reference's protobuf messages on the root↔leaf boundary
(`search.proto` LeafSearchRequest/Response): here JSON over HTTP — numpy
aggregation states encode as typed lists; `PartialHit` as flat tuples.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ..search.models import LeafSearchResponse, PartialHit, SplitSearchError


def _encode_value(value: Any) -> Any:
    if isinstance(value, np.ndarray):
        return {"__nd__": value.dtype.str, "data": value.tolist()}
    if isinstance(value, np.generic):
        return value.item()
    if isinstance(value, dict):
        if any(not isinstance(k, str) for k in value):
            # histogram/terms bucket maps key by numbers; JSON would silently
            # stringify them and break cross-node merges
            return {"__kvlist__": [[_encode_value(k), _encode_value(v)]
                                   for k, v in value.items()]}
        return {k: _encode_value(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_encode_value(v) for v in value]
    if isinstance(value, float) and (value in (float("inf"), float("-inf"))):
        return {"__f__": "inf" if value > 0 else "-inf"}
    return value


def _decode_value(value: Any) -> Any:
    if isinstance(value, dict):
        if "__nd__" in value:
            return np.array(value["data"], dtype=np.dtype(value["__nd__"]))
        if "__f__" in value:
            return float(value["__f__"])
        if "__kvlist__" in value:
            return {_freeze(_decode_value(k)): _decode_value(v)
                    for k, v in value["__kvlist__"]}
        return {k: _decode_value(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_decode_value(v) for v in value]
    return value


def _freeze(value: Any) -> Any:
    return tuple(value) if isinstance(value, list) else value


def leaf_response_to_wire(response: LeafSearchResponse) -> dict[str, Any]:
    """Like `leaf_response_to_dict` but with intermediate agg states left
    as raw numpy — for the binary transport (`binwire.py`), which encodes
    arrays as dtype+shape+bytes instead of JSON lists."""
    d = leaf_response_to_dict(response)
    d["intermediate_aggs"] = response.intermediate_aggs
    return d


def leaf_response_from_wire(d: dict[str, Any]) -> LeafSearchResponse:
    response = leaf_response_from_dict({**d, "intermediate_aggs": {}})
    response.intermediate_aggs = d.get("intermediate_aggs", {})
    return response


def leaf_response_to_dict(response: LeafSearchResponse) -> dict[str, Any]:
    return {
        "num_hits": response.num_hits,
        "partial_hits": [
            [h.sort_value, h.split_id, h.doc_id, h.raw_sort_value,
             h.sort_value2, h.raw_sort_value2]
            for h in response.partial_hits
        ],
        "failed_splits": [
            {"split_id": e.split_id, "error": e.error, "retryable": e.retryable}
            for e in response.failed_splits
        ],
        "num_attempted_splits": response.num_attempted_splits,
        "num_successful_splits": response.num_successful_splits,
        "intermediate_aggs": _encode_value(response.intermediate_aggs),
        "resource_stats": response.resource_stats,
        # additive: absent unless the leaf profiled this request
        **({"profile": response.profile}
           if response.profile is not None else {}),
    }


def leaf_response_from_dict(d: dict[str, Any]) -> LeafSearchResponse:
    return LeafSearchResponse(
        num_hits=d["num_hits"],
        partial_hits=[
            PartialHit(sort_value=h[0], split_id=h[1], doc_id=h[2],
                       raw_sort_value=h[3],
                       sort_value2=h[4] if len(h) > 4 else 0.0,
                       raw_sort_value2=h[5] if len(h) > 5 else None)
            for h in d.get("partial_hits", [])
        ],
        failed_splits=[
            SplitSearchError(e["split_id"], e["error"], e.get("retryable", True))
            for e in d.get("failed_splits", [])
        ],
        num_attempted_splits=d.get("num_attempted_splits", 0),
        num_successful_splits=d.get("num_successful_splits", 0),
        intermediate_aggs=_decode_value(d.get("intermediate_aggs", {})),
        resource_stats=d.get("resource_stats", {}),
        profile=d.get("profile"),
    )
