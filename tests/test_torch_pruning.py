"""The port's `search/pruning.py` and `search/predicate_cache.py` against the
JAX package's, function by function on the same inputs.

Each case builds its inputs with one package's own types (mappers, query
ASTs, requests, readers over the same split bytes) and the results must be
equal: floats exactly, requests by their `to_dict`, caches by every read
after the same sequence of writes. Follows `tests/test_threshold_pruning.py`
and `tests/test_predicate_cache.py`: the threshold box is monotone, contexts
classify sorts, term and split score bounds come from persisted `max_tf`
(or the impact cap), `split_best_internal_key` by timestamp, fast field and
score, downgrade to count, `threshold_from_response` and required terms.
"""

import types

import pytest

from quickwit_tpu.common.uri import Uri as JUri
from quickwit_tpu.index.reader import SplitReader as JSplitReader
from quickwit_tpu.index.synthetic import synthetic_hdfs_split
from quickwit_tpu.index.writer import SplitWriter as JSplitWriter
from quickwit_tpu.models import doc_mapper as j_dm
from quickwit_tpu.query import ast as JQ
from quickwit_tpu.search import leaf as j_leaf
from quickwit_tpu.search import models as j_models
from quickwit_tpu.search import predicate_cache as j_pc
from quickwit_tpu.search import pruning as j_pruning
from quickwit_tpu.storage.ram import RamStorage as JRamStorage

from quickwit_tpu_torch.common.uri import Uri as TUri
from quickwit_tpu_torch.index.reader import SplitReader as TSplitReader
from quickwit_tpu_torch.index.writer import SplitWriter as TSplitWriter
from quickwit_tpu_torch.models import doc_mapper as t_dm
from quickwit_tpu_torch.query import ast as TQ
from quickwit_tpu_torch.search import leaf as t_leaf
from quickwit_tpu_torch.search import models as t_models
from quickwit_tpu_torch.search import predicate_cache as t_pc
from quickwit_tpu_torch.search import pruning as t_pruning
from quickwit_tpu_torch.storage.ram import RamStorage as TRamStorage

BASE_TS = 1_650_000_000


def side(dm, Q, models, pruning, pc, Writer, Reader, Ram, Uri, leaf):
    F = dm.FieldType
    mapper = dm.DocMapper(
        field_mappings=[
            dm.FieldMapping("ts", F.DATETIME, fast=True,
                            input_formats=("unix_timestamp",)),
            dm.FieldMapping("val", F.I64, fast=True),
            dm.FieldMapping("ratio", F.F64, fast=True),
            dm.FieldMapping("flag", F.BOOL, fast=True),
            dm.FieldMapping("tenant", F.U64, fast=True),
            dm.FieldMapping("body", F.TEXT),
            dm.FieldMapping("sev", F.TEXT, tokenizer="raw", fast=True),
            dm.FieldMapping("host", F.TEXT, tokenizer="lowercase"),
            dm.FieldMapping("note", F.TEXT, indexed=False, fast=True,
                            tokenizer="raw"),
        ],
        timestamp_field="ts", default_search_fields=("body",))
    return types.SimpleNamespace(
        dm=dm, Q=Q, models=models, pruning=pruning, pc=pc, Writer=Writer,
        Reader=Reader, Ram=Ram, Uri=Uri, leaf=leaf, mapper=mapper)


JAX = side(j_dm, JQ, j_models, j_pruning, j_pc, JSplitWriter, JSplitReader,
           JRamStorage, JUri, j_leaf)
TORCH = side(t_dm, TQ, t_models, t_pruning, t_pc, TSplitWriter,
             TSplitReader, TRamStorage, TUri, t_leaf)


def both(fn):
    """`fn` on each side; asserts the results equal and returns one."""
    want, got = fn(JAX), fn(TORCH)
    assert got == want
    return got


def request(s, query=None, sort=(("ts", "desc"),), **kwargs):
    query = query or (lambda Q: Q.MatchAll())
    return s.models.SearchRequest(
        index_ids=["prune"], query_ast=query(s.Q),
        sort_fields=tuple(s.models.SortField(f, o) for f, o in sort),
        **kwargs)


# --- queries ------------------------------------------------------------------

QUERIES = {
    "match_all": lambda Q: Q.MatchAll(),
    "term_body": lambda Q: Q.Term("body", "common"),
    "term_tokenized": lambda Q: Q.Term("body", "Common Event1"),
    "term_verbatim": lambda Q: Q.Term("body", "Common", verbatim=True),
    "term_raw": lambda Q: Q.Term("sev", "ERROR"),
    "term_lowercase": lambda Q: Q.Term("host", "WEB-1"),
    "term_u64": lambda Q: Q.Term("tenant", "42"),
    "term_bad_u64": lambda Q: Q.Term("tenant", "not-a-number"),
    "term_datetime": lambda Q: Q.Term("ts", "1650000000"),
    "term_f64": lambda Q: Q.Term("ratio", "0.5"),
    "term_bool": lambda Q: Q.Term("flag", "True"),
    "term_fast_only": lambda Q: Q.Term("note", "x"),
    "term_unknown": lambda Q: Q.Term("nope", "x"),
    "full_and": lambda Q: Q.FullText("body", "disk failure", "and"),
    "full_or": lambda Q: Q.FullText("body", "disk failure", "or"),
    "full_or_single": lambda Q: Q.FullText("body", "disk", "or"),
    "full_phrase": lambda Q: Q.FullText("body", "disk failure", "phrase"),
    "full_numeric": lambda Q: Q.FullText("val", "7", "and"),
    "phrase_prefix": lambda Q: Q.PhrasePrefix("body", "disk fa"),
    "wildcard": lambda Q: Q.Wildcard("body", "dis*"),
    "regex": lambda Q: Q.Regex("body", "dis.*"),
    "range": lambda Q: Q.Range("val", lower=Q.RangeBound(1, True)),
    "presence": lambda Q: Q.FieldPresence("val"),
    "term_set": lambda Q: Q.TermSet({"sev": ("ERROR", "WARN")}),
    "boost": lambda Q: Q.Boost(Q.Term("body", "common"), 2.5),
    "bool": lambda Q: Q.Bool(
        must=(Q.Term("sev", "ERROR"), Q.Term("body", "common")),
        filter=(Q.Term("tenant", "42"),),
        should=(Q.Term("sev", "WARN"),),
        must_not=(Q.FullText("body", "exact phrase", "phrase"),)),
    "bool_scoring_phrase": lambda Q: Q.Bool(
        must=(Q.Term("body", "common"),),
        should=(Q.FullText("body", "disk failure", "phrase"),)),
    "nested_boost": lambda Q: Q.Boost(Q.Bool(
        must=(Q.Boost(Q.Term("body", "common"), 2.0),),
        should=(Q.FullText("body", "disk failure", "or"),)), 0.5),
}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_scoring_and_required_terms(name):
    query = QUERIES[name]
    both(lambda s: s.pruning.scoring_terms(query(s.Q), s.mapper))
    both(lambda s: s.pc.required_terms(query(s.Q), s.mapper))


# --- threshold box, caches ---------------------------------------------------

def test_threshold_box_is_monotone():
    updates = [None, 5.0, 3.0, None, 7.0, 7.0, -1.0, 9.5]

    def run(s):
        box = s.pruning.ThresholdBox()
        seen = [box.get()]
        for value in updates:
            box.update(value)
            seen.append(box.get())
        return seen, s.pruning.ThresholdBox(seed=2.0).get()

    seen, seeded = both(run)
    assert seen == [None, None, 5.0, 5.0, 5.0, 7.0, 7.0, 7.0, 9.5]
    assert seeded == 2.0


def test_score_bound_cache_lru():
    def run(s):
        cache = s.pruning.ScoreBoundCache(max_entries=3)
        cache.record("s1", "body", "a", 10, 2)
        cache.record("s1", "body", "b", 11, 3, 4.25)
        cache.record("s2", "body", "a", 12, 4)
        out = [cache.get("s1", "body", "a")]        # freshens s1/a
        cache.record("s3", "body", "c", 1, 1)       # evicts s1/b
        out += [cache.get(*k) for k in (("s1", "body", "a"),
                                        ("s1", "body", "b"),
                                        ("s2", "body", "a"),
                                        ("s3", "body", "c"))]
        cache.record("s2", "body", "a", 13, 5, None)  # overwrite
        return out + [cache.get("s2", "body", "a"), len(cache)]

    out = both(run)
    assert out[2] is None and out[-1] == 3


def test_predicate_cache_lru_and_lookup():
    def run(s):
        cache = s.pc.PredicateCache(max_bytes=340)
        cache.record_term_absent("s1", "body", "foo")
        cache.record_term_absent("s1", "body", "bar")
        out = [cache.is_term_absent("s1", "body", "foo")]
        cache.record_term_absent("s2", "body", "baz")   # evicts bar
        cache.record_term_absent("s2", "body", "baz")   # re-record
        out += [cache.is_term_absent("s1", "body", "bar"),
                cache.known_empty("s1", [("body", "foo"), ("body", "x")]),
                cache.known_empty("s3", [("body", "foo")]),
                cache.known_empty("s3", []), len(cache), cache.size_bytes]
        return out, cache.stats

    out, stats = both(run)
    assert out[1] is False and stats["hits"] == 1 and stats["misses"] == 2
    assert stats["evicted_bytes"] > 0 and stats["size_bytes"] <= 340


# --- score bounds ---------------------------------------------------------------

@pytest.mark.parametrize("num_docs", [1, 100, 30_720, 10_000_000])
def test_term_score_bound(num_docs):
    grid = [(df, tf, boost) for df in (0, 1, 50, num_docs)
            for tf in (0, 1, 3, 20, 1000) for boost in (1.0, 0.5, 2.0)]
    bounds = both(lambda s: [s.pruning.term_score_bound(num_docs, df, tf, b)
                             for df, tf, b in grid])
    assert bounds[0] == 0.0 and max(bounds) > 0.0


def test_split_score_upper_bound():
    stats = {("body", "a"): (10, 3), ("body", "b"): (4, 1, 2.75),
             ("body", "c"): (7, 2, None), ("body", "z"): (0, 0)}
    cases = [
        [("body", "a", 1.0)],
        [("body", "a", 1.0), ("body", "b", 2.0), ("body", "c", 0.5)],
        [("body", "z", 1.0), ("body", "b", 1.0)],
        [("body", "a", 1.0), ("body", "unknown", 1.0)],
        [],
    ]
    out = both(lambda s: [s.pruning.split_score_upper_bound(
        terms, 30_720, lambda f, t: stats.get((f, t))) for terms in cases])
    assert out[3] is None and out[4] == 0.0


@pytest.fixture(scope="module")
def hdfs_bytes():
    """Format v3 (impact-ordered): term stats come with an exact cap."""
    return synthetic_hdfs_split(20_000, seed=5)


def writer_bytes(s):
    """A writer split (persisted `terms.max_tf`, no impact cap on `sev`)."""
    writer = s.Writer(s.mapper)
    for i in range(300):
        tf = 1 + i % 7
        writer.add_json_doc({
            "ts": BASE_TS + i, "val": i - 150, "ratio": i / 7.0,
            "flag": i % 3 == 0, "tenant": i % 11,
            "body": f"event{i} " + "common " * tf,
            "sev": ["INFO", "WARN", "ERROR", "DEBUG"][i % 4],
            "host": f"Web-{i % 5}", "note": "x"})
    return writer.finish()


def reader_of(s, data):
    storage = s.Ram(s.Uri.parse("ram:///prune"))
    storage.put("s.split", data)
    return s.Reader(storage, "s.split")


def test_record_split_term_stats(hdfs_bytes):
    hdfs_terms = [("body", "term000003", 1.0), ("body", "term000077", 2.0),
                  ("severity_text", "ERROR", 1.0), ("body", "absent", 1.0)]
    writer_terms = [("body", "common", 1.0), ("sev", "ERROR", 1.0),
                    ("body", "event5", 1.0), ("body", "nope", 1.0)]

    def run(s):
        cache = s.pruning.ScoreBoundCache()
        out = []
        for split_id, data, terms in (
                ("hdfs", hdfs_bytes, hdfs_terms),
                ("writer", writer_bytes(s), writer_terms)):
            reader = reader_of(s, data)
            s.pruning.record_split_term_stats(cache, split_id, reader, terms)
            stats = [cache.get(split_id, f, t) for f, t, _ in terms]
            bound = s.pruning.split_score_upper_bound(
                terms[:3], reader.num_docs,
                lambda f, t: cache.get(split_id, f, t))
            out.append((stats, bound))
        return out, len(cache)

    (hdfs, writer), _ = both(run)
    assert hdfs[0][0][2] is not None      # the impact cap
    assert writer[0][0][:2] == (300, 7) and writer[0][3][:2] == (0, 0)


# --- contexts and per-split bounds ------------------------------------------

SORTS = {
    "ts_desc": dict(max_hits=5),
    "ts_asc": dict(max_hits=5, sort=(("ts", "asc"),)),
    "val_asc": dict(max_hits=5, sort=(("val", "asc"),)),
    "val_desc": dict(max_hits=5, sort=(("val", "desc"),)),
    "ratio": dict(max_hits=5, sort=(("ratio", "desc"),)),
    "flag": dict(max_hits=5, sort=(("flag", "asc"),)),
    "tenant": dict(max_hits=5, sort=(("tenant", "desc"),)),
    "two_keys": dict(max_hits=5, sort=(("ts", "desc"), ("val", "asc"))),
    "score": dict(max_hits=5, sort=(("_score", "desc"),),
                  query=QUERIES["nested_boost"]),
    "score_asc": dict(max_hits=5, sort=(("_score", "asc"),),
                      query=QUERIES["term_body"]),
    "score_phrase": dict(max_hits=5, sort=(("_score", "desc"),),
                         query=QUERIES["full_phrase"]),
    "count_only": dict(max_hits=0),
    "aggs": dict(max_hits=5, aggs={"a": {"terms": {"field": "sev"}}}),
    "doc": dict(max_hits=5, sort=(("_doc", "asc"),)),
    "string": dict(max_hits=5, sort=(("sev", "asc"),)),
    "not_fast": dict(max_hits=5, sort=(("body", "desc"),)),
    "unknown": dict(max_hits=5, sort=(("nope", "desc"),)),
}


def context_key(ctx):
    sort = None if ctx.sort is None else (ctx.sort.field, ctx.sort.order)
    return ctx.mode, sort, ctx.terms, ctx.timestamp_field


@pytest.mark.parametrize("name", sorted(SORTS))
def test_pruning_context_and_split_bound(name):
    kwargs = dict(SORTS[name])
    metas = [None, {}, {"min_value": -150, "max_value": 149},
             {"min_value": None, "max_value": 3.5}, {"min_value": 7}]
    stats = {("body", "common"): (300, 7), ("body", "disk"): (5, 2, 1.25),
             ("body", "failure"): (3, 1)}

    def run(s):
        ctx = s.pruning.pruning_context(request(s, **kwargs), s.mapper)
        bounds = []
        for time_range in ((BASE_TS * 10**6, (BASE_TS + 299) * 10**6),
                           None):
            split = s.models.SplitIdAndFooter(
                split_id="s", storage_uri="ram:///prune", num_docs=300,
                time_range=time_range)
            for meta in metas:
                bounds.append(s.pruning.split_best_internal_key(
                    ctx, split, field_meta_fn=lambda m=meta: m,
                    score_stats_fn=lambda f, t: stats.get((f, t))))
            bounds.append(s.pruning.split_best_internal_key(ctx, split))
        return context_key(ctx), bounds

    (mode, *_), bounds = both(run)
    inert = {"count_only", "aggs", "doc", "string", "not_fast", "unknown",
             "score_asc", "score_phrase"}
    assert (mode is None) == (name in inert)
    assert mode is None or any(b is not None for b in bounds)


# --- downgrade and seeded thresholds -------------------------------------------

@pytest.mark.parametrize("name", ["ts_desc", "score", "aggs", "two_keys"])
def test_downgrade_to_count(name):
    kwargs = dict(SORTS[name], start_timestamp=BASE_TS * 10**6,
                  end_timestamp=(BASE_TS + 100) * 10**6, start_offset=3)
    out = both(lambda s: s.pruning.downgrade_to_count(
        request(s, **kwargs)).to_dict())
    assert out["max_hits"] == 0 and out["count_hits_exact"] is True


@pytest.mark.parametrize("name,max_hits,offset", [
    ("ts_desc", 5, 0), ("ts_desc", 5, 2), ("val_asc", 7, 0),
    ("score", 10, 0), ("two_keys", 4, 0), ("string", 5, 0),
    ("doc", 5, 0), ("count_only", 0, 0), ("ts_desc", 400, 0)])
def test_threshold_from_response(name, max_hits, offset):
    kwargs = dict(SORTS[name], max_hits=max_hits, start_offset=offset)

    def run(s):
        reader = reader_of(s, writer_bytes(s))
        req = request(s, **kwargs)
        extra = {} if s is JAX else {"device": "cpu"}
        resp = s.leaf.leaf_search_single_split(req, s.mapper, reader, "s",
                                               **extra)
        return (s.pruning.threshold_from_response(req, s.mapper, resp),
                len(resp.partial_hits))

    thr, num_hits = both(run)
    full = name not in ("string", "doc", "count_only") and \
        num_hits >= offset + max_hits
    assert (thr is not None) == full
