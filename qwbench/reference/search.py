"""The plain reference: what a search request should answer, worked out
from the raw documents the benchmark drew, with plain torch on whatever
device it is given. It imports nothing of the program.

It covers the request language the traffic mixes use: the ES query DSL's
`match_all`, `term` on a raw-tokenized field and `range`, under `bool`
(must, filter, must_not); request time bounds (`start_timestamp`
inclusive, `end_timestamp` exclusive, microseconds) on the deployment's
timestamp field; the hit count; and the aggregations `date_histogram`
(`fixed_interval`), `terms` (by count, then key), `percentiles`
(DDSketch, relative accuracy 0.01), `avg`, `max`, `min` and `sum`,
nested. Requests that ask for hits are not in it (`max_hits` 0).

`dtype` is the precision of aggregated values: float64 for the
reference; a lower one gives the control (`qwbench/control.py`).
"""

from __future__ import annotations

import math

import torch

PCTL_ALPHA = 0.01
_INTERVAL_S = {"s": 1, "m": 60, "h": 3600, "d": 86400}


class Split:
    """One split's raw documents as columns, on a device."""

    def __init__(self, config: dict, raw: dict, split_id: str, device):
        self.config, self.split_id = config, split_id
        self.raw = {k: v.to(device) for k, v in raw.items()}
        self.n = next(iter(raw.values())).shape[0]
        self.device = device

    # --- field access ------------------------------------------------------
    def _field(self, name: str) -> dict:
        for fm in self.config["doc_mapping"]["field_mappings"]:
            if fm["name"] == name:
                return fm
        raise KeyError(f"unmapped field {name!r}")

    def _raw_key(self, name: str) -> str:
        return self.config["raw_columns"][name]

    def values(self, name: str) -> torch.Tensor:
        """A numeric or datetime field's values (datetime in micros, from
        raw values in the deployment's `raw_time_unit_us`)."""
        col = self.raw[self._raw_key(name)].to(torch.int64)
        if self._field(name)["type"] == "datetime":
            col = col * self.config["raw_time_unit_us"]
        return col

    def categories(self, name: str) -> tuple[torch.Tensor, list[str]]:
        vocab = self.config[self.config["raw_vocab"][name]]
        return self.raw[self._raw_key(name)].long(), vocab

    # --- queries -----------------------------------------------------------
    def evaluate(self, query: dict) -> torch.Tensor:
        """The match mask of every doc for one query node."""
        (kind, body), = query.items()
        every = torch.ones(self.n, dtype=torch.bool, device=self.device)
        if kind == "match_all":
            return every
        if kind == "term":
            (field, value), = body.items()
            if isinstance(value, dict):
                value = value["value"]
            codes, vocab = self.categories(field)
            if str(value) not in vocab:
                return ~every
            return codes == vocab.index(str(value))
        if kind == "range":
            (field, bounds), = body.items()
            vals = self.values(field)
            for op, bound in bounds.items():
                every &= {"gte": vals >= bound, "gt": vals > bound,
                          "lte": vals <= bound, "lt": vals < bound}[op]
            return every
        if kind == "bool" and not body.get("should"):
            for clause in body.get("must", []) + body.get("filter", []):
                every &= self.evaluate(clause)
            for clause in body.get("must_not", []):
                every &= ~self.evaluate(clause)
            return every
        raise ValueError(f"query {kind!r} is not in the reference")

    def request_mask(self, request: dict) -> torch.Tensor:
        mask = self.evaluate(request.get("query", {"match_all": {}}))
        ts_field = self.config["doc_mapping"]["timestamp_field"]
        if request.get("start_timestamp") is not None:
            mask = mask & (self.values(ts_field)
                           >= request["start_timestamp"])
        if request.get("end_timestamp") is not None:
            mask = mask & (self.values(ts_field) < request["end_timestamp"])
        return mask


# --- aggregations -----------------------------------------------------------

def _interval_ms(text: str) -> int:
    return int(text[:-1]) * _INTERVAL_S[text[-1]] * 1000


def _sketch_value(sorted_vals: torch.Tensor, q: float) -> float:
    """The DDSketch estimate of quantile q: the rank-th smallest value's
    log bucket (index ceil(log_gamma(v))), returned as the bucket's
    representative 2 gamma^i / (gamma + 1)."""
    n = sorted_vals.shape[0]
    if n == 0:
        return None
    gamma = (1.0 + PCTL_ALPHA) / (1.0 - PCTL_ALPHA)
    v = float(sorted_vals[int(math.floor(q * (n - 1)))])
    if v <= 0.0:
        return 0.0
    i = math.ceil(math.log(v) / math.log(gamma))
    return 2.0 * gamma ** i / (gamma + 1.0)


def _metric(kind: str, params: dict, parts: list, dtype):
    """A metric aggregation over the selected docs of every split: `parts`
    holds (split, mask) pairs."""
    vals = torch.cat([split.values(params["field"])[mask]
                      for split, mask in parts])
    if kind == "percentiles":
        # the values in `dtype` (exact in float64 for integer values)
        ordered = torch.sort(vals.to(dtype)).values.to(torch.float64)
        percents = params.get("percents", [1, 5, 25, 50, 75, 95, 99])
        return {"values": {str(p): _sketch_value(ordered, p / 100.0)
                           for p in percents}}
    if vals.numel() == 0:
        return {"value": None}
    x = vals.to(dtype)
    value = {"avg": lambda: x.sum() / x.numel(), "sum": lambda: x.sum(),
             "max": lambda: x.max(), "min": lambda: x.min()}[kind]()
    return {"value": float(value)}


def aggregate(aggs: dict, parts: list, dtype) -> dict:
    """The aggregations of one request over (split, mask) pairs."""
    out = {}
    for name, body in aggs.items():
        subs = body.get("aggs", {})
        (kind, params), = ((k, v) for k, v in body.items() if k != "aggs")
        if kind == "date_histogram":
            step = _interval_ms(params["fixed_interval"])
            keyed = [(split, mask,
                      torch.div(split.values(params["field"]) // 1000, step,
                                rounding_mode="floor") * step)
                     for split, mask in parts]
            present = torch.cat([key[mask] for _, mask, key in keyed])
            buckets = []
            if present.numel():
                lo, hi = int(present.min()), int(present.max())
                for key in range(lo, hi + step, step):
                    sel = [(s, m & (k == key)) for s, m, k in keyed]
                    count = sum(int(m.sum()) for _, m in sel)
                    bucket = {"key": float(key), "doc_count": count}
                    bucket.update(aggregate(subs, sel, dtype))
                    buckets.append(bucket)
            out[name] = {"buckets": buckets}
        elif kind == "terms":
            counts = {}
            for split, mask in parts:
                codes, vocab = split.categories(params["field"])
                hist = torch.bincount(codes[mask], minlength=len(vocab))
                for i, c in enumerate(hist.tolist()):
                    counts[vocab[i]] = counts.get(vocab[i], 0) + c
            ranked = sorted(((k, c) for k, c in counts.items() if c > 0),
                            key=lambda kc: (-kc[1], kc[0]))
            size = params.get("size", 10)
            buckets = []
            for key, count in ranked[:size]:
                sel = []
                for split, mask in parts:
                    codes, vocab = split.categories(params["field"])
                    sel.append((split, mask & (codes == vocab.index(key))))
                bucket = {"key": key, "doc_count": count}
                bucket.update(aggregate(subs, sel, dtype))
                buckets.append(bucket)
            out[name] = {"buckets": buckets, "sum_other_doc_count":
                         sum(c for _, c in ranked[size:]),
                         "doc_count_error_upper_bound": 0}
        else:
            out[name] = _metric(kind, params, parts, dtype)
    return out


def answer(splits: list[Split], request: dict, dtype=torch.float64) -> dict:
    """What an aggregation request (`max_hits` 0) should answer over
    `splits`: the hit count and the aggregations."""
    if request.get("max_hits", 20):
        raise ValueError("requests for hits are not in the reference")
    parts = [(split, split.request_mask(request)) for split in splits]
    return {"num_hits": sum(int(m.sum()) for _, m in parts),
            "aggs": aggregate(request.get("aggs") or {}, parts, dtype)}
