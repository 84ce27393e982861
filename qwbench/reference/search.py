"""The plain reference: what a search request should answer, worked out
from the raw documents the benchmark drew, with plain torch on whatever
device it is given. It imports nothing of the program.

It covers the request language the traffic mixes use: the ES query DSL's
`match_all`; `match` (`operator` `or`, the default, or `and`) on a
default-tokenized text field, or on a raw one as its whole text; `term`
on a text field (raw, or one token of a default-tokenized field) or on a
numeric fast field; `range` on a numeric or datetime field; `bool` with
must, should, filter and must_not (`minimum_should_match` an integer, by
default 1 where there is no must or filter, else 0, as in ES); request
time bounds (`start_timestamp` inclusive, `end_timestamp` exclusive,
microseconds) on the deployment's timestamp field; the hit count; the
top `max_hits` hits, by `_score` or by one fast field (`sort_by`), each
with its fetched document; and the aggregations `date_histogram`
(`fixed_interval`), `terms` (by count, then key; on a raw text field or a
numeric fast field, whose keys stay numbers), `percentiles` (DDSketch,
relative accuracy 0.01), `avg`, `max`, `min` and `sum`, nested.

A text field's raw form is each doc's token ids in CSR form (the raw
columns `<key>_offsets` and `<key>_ids`), over the vocabulary that the
deployment names (`raw_vocab`: a list of words, or `{"format", "size"}`
for the words `format.format(id)`). Query text is tokenized here:
lowercased, split on what is not a letter or digit, each word mapped to
its id; a word outside the vocabulary matches nothing.

Scores are BM25 per split, as the port's format v3 defines them: k1 1.2,
b 0.75, idf = ln(1 + (N - df + 0.5) / (df + 0.5)) with N and df the
split's own, avgdl the field's tokens in the split over N, and dl the
doc's exact token count. Tantivy, and so Quickwit, stores dl as a
one-byte fieldnorm, a code that keeps short lengths exact and rounds
longer ones; the port and this reference keep the exact count, so their
scores of long docs are not tantivy's. A field with one value a doc (raw
text, numbers) has dl = avgdl = 1. A doc's score is the sum over the
terms it matched in scoring clauses: `match`, `term`, and the must and
should clauses of a `bool`; filter and must_not clauses, `range`,
`match_all` and the time bounds add nothing. Hits by score are the top `max_hits` by (score
descending, split id, doc id); by a field, by its value in the stated
order, then by (split id, doc id). Where the deployment's corpus has no
documents (`document` None), hits carry none.

`dtype` is the precision of aggregated values and scores: float64 for
the reference; a lower one gives the control (`qwbench/control.py`).
"""

from __future__ import annotations

import math
import re

import torch

PCTL_ALPHA = 0.01
K1 = 1.2
B = 0.75
_INTERVAL_S = {"s": 1, "m": 60, "h": 3600, "d": 86400}
_WORD = re.compile(r"[^\W_]+")


def tokenize(text: str) -> list[str]:
    """Query text as the default tokenizer splits it."""
    return _WORD.findall(text.lower())


def vocabulary(config: dict, field: str) -> list[str]:
    """The words of a field's vocabulary, by id."""
    spec = config[config["raw_vocab"][field]]
    if isinstance(spec, dict):
        return [spec["format"].format(i) for i in range(spec["size"])]
    return spec


def _bm25(tf: torch.Tensor, dl: torch.Tensor, avgdl: float, n: int,
          df: int, dtype) -> torch.Tensor:
    """Each doc's BM25 for one term, in `dtype`; 0 where tf is 0."""
    tf = tf.to(dtype)
    scalar = lambda v: torch.tensor(v, dtype=dtype, device=tf.device)
    idf = torch.log1p(scalar((n - df + 0.5) / (df + 0.5)))
    norm = scalar(1.0 - B) + scalar(B) * dl.to(dtype) / scalar(avgdl)
    return idf * scalar(K1 + 1.0) * tf / (tf + scalar(K1) * norm)


class Split:
    """One split's raw documents as columns, on a device. `document(doc_id)`
    gives a doc as the corpus stored it, or is None."""

    def __init__(self, config: dict, raw: dict, split_id: str, device,
                 document=None):
        self.config, self.split_id = config, split_id
        self.raw = {k: v.to(device) for k, v in raw.items()}
        key = next(iter(config["raw_columns"].values()))
        self.n = (raw[key].shape[0] if key in raw
                  else raw[f"{key}_offsets"].shape[0] - 1)
        self.device = device
        self.document = document
        self._texts: dict = {}
        self._df: dict = {}

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

    def _is_tokenized(self, name: str) -> bool:
        fm = self._field(name)
        return fm["type"] == "text" and fm.get("tokenizer",
                                               "default") == "default"

    def _text(self, name: str):
        """(tokens per doc, id of each word, and the field's postings: the
        first posting of each word id, each posting's doc and term
        frequency) of a default-tokenized field, made once by one sort of
        its (word, doc) pairs."""
        if name not in self._texts:
            key = self._raw_key(name)
            offsets = self.raw[f"{key}_offsets"].long()
            lengths = offsets[1:] - offsets[:-1]
            doc = torch.repeat_interleave(
                torch.arange(self.n, device=self.device), lengths)
            words = vocabulary(self.config, name)
            pairs, tfs = torch.unique(
                self.raw[f"{key}_ids"].long() * self.n + doc,
                return_counts=True)
            word = torch.div(pairs, self.n, rounding_mode="floor")
            first = torch.zeros(len(words) + 1, dtype=torch.int64,
                                device=self.device)
            first[1:] = torch.cumsum(
                torch.bincount(word, minlength=len(words)), 0)
            self._texts[name] = (lengths, {w: i for i, w in enumerate(words)},
                                 first.tolist(), pairs - word * self.n, tfs)
        return self._texts[name]

    def _term_frequency(self, name: str, value) -> torch.Tensor:
        """How often each doc holds the term `value` of field `name`: a
        word of a tokenized field, a raw text value, or a number."""
        if self._is_tokenized(name):
            _, index, first, docs, tfs = self._text(name)
            tf = torch.zeros(self.n, dtype=torch.int64, device=self.device)
            if value in index:
                a, b = first[index[value]], first[index[value] + 1]
                tf[docs[a:b]] = tfs[a:b]
            return tf
        if self._field(name)["type"] == "text":
            codes, vocab = self.categories(name)
            if str(value) not in vocab:
                return torch.zeros(self.n, dtype=torch.int64,
                                   device=self.device)
            return (codes == vocab.index(str(value))).long()
        return (self.values(name) == int(value)).long()

    def doc_freq(self, name: str, value) -> int:
        """How many docs hold the term: from the field's postings where it
        is tokenized, else counted once and kept."""
        if self._is_tokenized(name):
            _, index, first, _, _ = self._text(name)
            return (first[index[value] + 1] - first[index[value]]
                    if value in index else 0)
        if (name, value) not in self._df:
            self._df[name, value] = int(
                (self._term_frequency(name, value) > 0).sum())
        return self._df[name, value]

    def _scored_term(self, name: str, value, dtype):
        tf = self._term_frequency(name, value)
        mask = tf > 0
        if dtype is None:
            return mask, None
        if self._is_tokenized(name):
            lengths = self._text(name)[0]
            avgdl = float(lengths.sum()) / self.n
        else:
            lengths, avgdl = torch.ones_like(tf), 1.0
        df = int(mask.sum())
        return mask, _bm25(tf, lengths, avgdl, self.n, df, dtype)

    # --- queries -----------------------------------------------------------
    def query_terms(self, query: dict) -> set[tuple[str, object]]:
        """The distinct (field, term) pairs whose postings a query reads."""
        (kind, body), = query.items()
        if kind in ("match", "term"):
            (field, spec), = body.items()
            if kind == "match":
                text = spec["query"] if isinstance(spec, dict) else spec
                return ({(field, w) for w in tokenize(str(text))}
                        if self._is_tokenized(field) else {(field, text)})
            return {(field, spec["value"] if isinstance(spec, dict)
                     else spec)}
        if kind == "bool":
            return set().union(*(self.query_terms(c) for occur in
                                 ("must", "should", "filter", "must_not")
                                 for c in body.get(occur, [])))
        return set()

    def evaluate(self, query: dict) -> torch.Tensor:
        """The match mask of every doc for one query node."""
        return self._match(query, None)[0]

    def _match(self, query: dict, dtype):
        """(mask, score) of one query node; no score where `dtype` is
        None, else each doc's score in `dtype`, 0 where it does not
        match."""
        (kind, body), = query.items()
        every = torch.ones(self.n, dtype=torch.bool, device=self.device)
        zero = (None if dtype is None else
                torch.zeros(self.n, dtype=dtype, device=self.device))
        if kind == "match_all":
            return every, zero
        if kind == "term":
            (field, value), = body.items()
            if isinstance(value, dict):
                value = value["value"]
            return self._scored_term(field, value, dtype)
        if kind == "match":
            (field, spec), = body.items()
            text = str(spec["query"] if isinstance(spec, dict) else spec)
            operator = (spec.get("operator", "or").lower()
                        if isinstance(spec, dict) else "or")
            if not self._is_tokenized(field):
                return self._scored_term(field, text, dtype)
            words = tokenize(text)
            if not words:
                return ~every, zero
            mask = every if operator == "and" else ~every
            score = zero
            for word in words:
                hit, part = self._scored_term(field, word, dtype)
                mask = mask & hit if operator == "and" else mask | hit
                if score is not None:
                    score = score + part
            return mask, (None if score is None else
                          torch.where(mask, score, zero))
        if kind == "range":
            (field, bounds), = body.items()
            vals = self.values(field)
            for op, bound in bounds.items():
                every &= {"gte": vals >= bound, "gt": vals > bound,
                          "lte": vals <= bound, "lt": vals < bound}[op]
            return every, zero
        if kind == "bool":
            score = zero
            for clause in body.get("must", []):
                hit, part = self._match(clause, dtype)
                every &= hit
                if score is not None:
                    score = score + part
            for clause in body.get("filter", []):
                every &= self.evaluate(clause)
            for clause in body.get("must_not", []):
                every &= ~self.evaluate(clause)
            should = body.get("should", [])
            if should:
                least = body.get("minimum_should_match",
                                 0 if body.get("must") or body.get("filter")
                                 else 1)
                if not isinstance(least, int):
                    raise ValueError("minimum_should_match other than an "
                                     "integer is not in the reference")
                count = torch.zeros(self.n, dtype=torch.int64,
                                    device=self.device)
                for clause in should:
                    hit, part = self._match(clause, dtype)
                    count += hit
                    if score is not None:
                        score = score + part
                every &= count >= least
            return every, (None if score is None else
                           torch.where(every, score, zero))
        raise ValueError(f"query {kind!r} is not in the reference")

    def request_match(self, request: dict, dtype=None):
        """(mask, score) of a request: its query under its time bounds."""
        mask, score = self._match(request.get("query", {"match_all": {}}),
                                  dtype)
        ts_field = self.config["doc_mapping"]["timestamp_field"]
        if request.get("start_timestamp") is not None:
            mask = mask & (self.values(ts_field)
                           >= request["start_timestamp"])
        if request.get("end_timestamp") is not None:
            mask = mask & (self.values(ts_field) < request["end_timestamp"])
        return mask, score

    def request_mask(self, request: dict) -> torch.Tensor:
        return self.request_match(request)[0]


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


def _term_keys(split: Split, field: str):
    """(each doc's key index, the keys) of a terms aggregation's field:
    a raw text field's values, or a numeric field's distinct values."""
    if split._field(field)["type"] == "text":
        return split.categories(field)
    keys, codes = torch.unique(split.values(field), return_inverse=True)
    return codes, keys.tolist()


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
            counts, keyed = {}, []
            for split, mask in parts:
                codes, vocab = _term_keys(split, params["field"])
                keyed.append((split, mask, codes, vocab))
                hist = torch.bincount(codes[mask], minlength=len(vocab))
                for i, c in enumerate(hist.tolist()):
                    counts[vocab[i]] = counts.get(vocab[i], 0) + c
            ranked = sorted(((k, c) for k, c in counts.items() if c > 0),
                            key=lambda kc: (-kc[1], kc[0]))
            size = params.get("size", 10)
            buckets = []
            for key, count in ranked[:size]:
                sel = [(split, mask & (codes == vocab.index(key))
                        if key in vocab else mask & False)
                       for split, mask, codes, vocab in keyed]
                bucket = {"key": key, "doc_count": count}
                bucket.update(aggregate(subs, sel, dtype))
                buckets.append(bucket)
            out[name] = {"buckets": buckets, "sum_other_doc_count":
                         sum(c for _, c in ranked[size:]),
                         "doc_count_error_upper_bound": 0}
        else:
            out[name] = _metric(kind, params, parts, dtype)
    return out


# --- hits -------------------------------------------------------------------

def sort_of(request: dict) -> tuple[str, str]:
    """(field, order) of a request's hits: `_score` descending unless
    `sort_by` names one key."""
    keys = request.get("sort_by") or [{"field": "_score", "order": "desc"}]
    if len(keys) != 1:
        raise ValueError("sorts on more than one key are not in the "
                         "reference")
    field, order = keys[0]["field"], keys[0].get("order", "desc")
    if field == "_score" and order != "desc":
        raise ValueError("an ascending score sort is not in the reference")
    return field, order


def _top(splits: list, matched: list, field: str, order: str, k: int):
    """The top k (key, split, doc) over every split: each split's own top
    k by key then doc, merged by key, split id and doc id."""
    candidates = []
    for split, (mask, score) in zip(splits, matched):
        docs = torch.nonzero(mask).flatten()
        keys = (score if field == "_score" else split.values(field))[docs]
        # a stable sort of the docs in ascending order keeps ties by doc
        order_k = torch.sort(keys, descending=order == "desc",
                             stable=True).indices[:k]
        for key, doc in zip(keys[order_k].tolist(), docs[order_k].tolist()):
            candidates.append((-key if order == "desc" else key,
                               split.split_id, doc, split))
    candidates.sort(key=lambda c: c[:3])
    return candidates[:k]


def answer(splits: list[Split], request: dict, dtype=torch.float64) -> dict:
    """What a request should answer over `splits`: the hit count and the
    aggregations; where it asks for hits, also the hits (`split_id`,
    `doc_id`, `score` by a score sort, else None, and `doc`), the sort
    (`sort`), and `lookup(split_id, doc_id)`, which gives a doc's
    (score, document) where it matches the request and None where not."""
    k = request.get("max_hits", 20)
    field, order = sort_of(request) if k else ("_doc", "asc")
    matched = [split.request_match(request,
                                   dtype if field == "_score" else None)
               for split in splits]
    parts = [(split, mask) for split, (mask, _) in zip(splits, matched)]
    out = {"num_hits": sum(int(m.sum()) for _, m in parts),
           "aggs": aggregate(request.get("aggs") or {}, parts, dtype)}
    if not k:
        return out
    by_id = {split.split_id: (split, mask, score)
             for split, (mask, score) in zip(splits, matched)}

    def lookup(split_id: str, doc_id: int):
        split, mask, score = by_id.get(split_id, (None, None, None))
        if split is None or not 0 <= doc_id < split.n or not mask[doc_id]:
            return None
        return (None if score is None else float(score[doc_id]),
                None if split.document is None else split.document(doc_id))

    out["hits"] = [
        {"split_id": split_id, "doc_id": doc,
         "score": -key if field == "_score" else None,
         "doc": None if split.document is None else split.document(doc)}
        for key, split_id, doc, split in _top(splits, matched, field,
                                              order, k)]
    out["sort"] = (field, order)
    out["lookup"] = lookup
    return out
