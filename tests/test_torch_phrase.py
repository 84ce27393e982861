"""The port's phrase path (BASELINE config 4) against the JAX package's.

Both engines read the same stackoverflow split bytes: the port's generator
must write the JAX package's bytes. Each request runs through both leaves
on the CPU (the port with `device="cpu"`), the JAX side on a fresh reader
every time, and the responses must be equal: doc ids, counts, f64 sort
values and f32 hit scores, exactly.

Covered: `bench.py`'s c4 (a two-term phrase, top-20 by BM25), slop 1 and
2, a repeated-term phrase, a phrase with an absent term, a phrase prefix
(a Bool `should` root of phrases, doc space) and the phrase under a Bool
with a creation_date range filter; the slop of a phrase in the staging key
of its precomputed arrays; and the split read through `LocalFileStorage`
and through `S3CompatibleStorage` against the port's fake S3 server.
"""

import dataclasses

import numpy as np
import pytest

from quickwit_tpu.common.uri import Uri as JUri
from quickwit_tpu.index.reader import SplitReader as JSplitReader
from quickwit_tpu.index.synthetic import (
    SO_MAPPER as J_SO_MAPPER,
    synthetic_stackoverflow_split as j_so_split)
from quickwit_tpu.query import ast as JQ
from quickwit_tpu.search import leaf as j_leaf
from quickwit_tpu.search.models import SearchRequest as JSearchRequest
from quickwit_tpu.search.plan import lower_request as j_lower
from quickwit_tpu.storage.ram import RamStorage as JRamStorage

from quickwit_tpu_torch.common.uri import Uri as TUri
from quickwit_tpu_torch.index.reader import SplitReader as TSplitReader
from quickwit_tpu_torch.index.synthetic import (
    SO_MAPPER as T_SO_MAPPER, so_term,
    synthetic_stackoverflow_split as t_so_split)
from quickwit_tpu_torch.query import ast as TQ
from quickwit_tpu_torch.search import executor as t_executor
from quickwit_tpu_torch.search import leaf as t_leaf
from quickwit_tpu_torch.search.models import SearchRequest as TSearchRequest
from quickwit_tpu_torch.search.plan import PBool
from quickwit_tpu_torch.search.plan import lower_request as t_lower
from quickwit_tpu_torch.storage import (
    LocalFileStorage, S3CompatibleStorage, S3Config, StorageResolver)
from quickwit_tpu_torch.storage.fake_s3 import FakeS3Server
from quickwit_tpu_torch.storage.ram import RamStorage as TRamStorage

NUM_DOCS = 20_000
SEED = 11
SPLIT = "so-0"
C4_TEXT = f"{so_term(10)} {so_term(11)}"   # bench.py:209-214
DAY_US = 86400 * 1_000_000
START_US = 1_500_000_000 * 1_000_000   # the generator's start_ts


def phrase(Q, text=C4_TEXT, slop=0):
    return Q.FullText("body", text, mode="phrase", slop=slop)


def last_30_days(Q):
    """c4's phrase, filtered to the last 30 of the split's 90 days."""
    return Q.Bool(must=(phrase(Q),), filter=(Q.Range(
        "creation_date", lower=Q.RangeBound(START_US + 60 * DAY_US, True),
        upper=Q.RangeBound(START_US + 90 * DAY_US, False)),))


REQUESTS = {
    "c4": lambda Q: phrase(Q),
    "slop1": lambda Q: phrase(Q, slop=1),
    "slop2": lambda Q: phrase(Q, slop=2),
    "repeated_term": lambda Q: phrase(Q, f"{so_term(10)} {so_term(10)}"),
    "absent_term": lambda Q: phrase(Q, f"{so_term(10)} nosuchterm"),
    "phrase_prefix": lambda Q: Q.PhrasePrefix("body", "t000010 t00001"),
    "bool_range": last_30_days,
}


@pytest.fixture(scope="module")
def split_bytes():
    return t_so_split(NUM_DOCS, seed=SEED)


def torch_reader(data, storage=None):
    if storage is None:
        storage = TRamStorage(TUri.parse("ram:///phrase"))
    storage.put("so.split", data)
    return TSplitReader(storage, "so.split")


def hits(resp):
    return [(h.split_id, h.doc_id, h.sort_value, h.raw_sort_value,
             h.sort_value2, h.raw_sort_value2) for h in resp.partial_hits]


def jax_search(data, query, max_hits=20):
    """The JAX leaf on a fresh reader: its device array cache keys a
    phrase's arrays by its terms alone."""
    storage = JRamStorage(JUri.parse("ram:///phrase"))
    storage.put("so.split", data)
    request = JSearchRequest(index_ids=["so"], query_ast=query(JQ),
                             max_hits=max_hits)
    return j_leaf.leaf_search_single_split(
        request, J_SO_MAPPER, JSplitReader(storage, "so.split"), SPLIT)


def torch_search(reader, query, max_hits=20):
    request = TSearchRequest(index_ids=["so"], query_ast=query(TQ),
                             max_hits=max_hits)
    return t_leaf.leaf_search_single_split(request, T_SO_MAPPER, reader,
                                           SPLIT, device="cpu")


@pytest.mark.parametrize("seed", [11, 3])
def test_so_split_bytes_equal_jax(seed):
    assert t_so_split(NUM_DOCS, seed=seed) == j_so_split(NUM_DOCS, seed=seed)


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_phrase_requests_match_jax(split_bytes, name):
    query = REQUESTS[name]
    want = jax_search(split_bytes, query)
    got = torch_search(torch_reader(split_bytes), query)
    assert got.num_hits == want.num_hits
    assert hits(got) == hits(want)
    assert len(got.partial_hits) == min(20, got.num_hits)
    if name == "absent_term":
        assert got.num_hits == 0
    else:
        assert got.num_hits > 0
        scores = [h.sort_value for h in got.partial_hits]
        assert all(np.isfinite(scores)) and scores == sorted(scores,
                                                             reverse=True)


def canon(obj):
    """A comparable form: dataclasses by class name and fields, numpy data
    by dtype, shape and bytes."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,
                tuple((f.name, canon(getattr(obj, f.name)))
                      for f in dataclasses.fields(obj)))
    if isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        return ("np", arr.dtype.str, arr.shape, arr.tobytes())
    if isinstance(obj, dict):
        return ("dict", tuple((canon(k), canon(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return (type(obj).__name__, tuple(canon(v) for v in obj))
    return obj


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_lowered_plan_matches_jax(split_bytes, name):
    """Field for field, but for the slop the port adds to a sloppy
    phrase's array keys."""
    storage = JRamStorage(JUri.parse("ram:///phrase"))
    storage.put("so.split", split_bytes)
    j_plan = j_lower(REQUESTS[name](JQ), J_SO_MAPPER,
                     JSplitReader(storage, "so.split"), [])
    t_plan = t_lower(REQUESTS[name](TQ), T_SO_MAPPER,
                     torch_reader(split_bytes), [])
    slop = {"slop1": ".slop1", "slop2": ".slop2"}.get(name)
    keys = [k.replace(slop, "") for k in t_plan.array_keys] if slop \
        else t_plan.array_keys
    assert keys == j_plan.array_keys
    assert slop is None or any(slop in k for k in t_plan.array_keys)
    assert canon(dataclasses.replace(t_plan, array_keys=keys)) == \
        canon(j_plan)


def plan_of(reader, query):
    request = TSearchRequest(index_ids=["so"], query_ast=query(TQ),
                             max_hits=20)
    return t_leaf.prepare_plan_only(request, T_SO_MAPPER, reader, SPLIT)


def test_plan_shapes(split_bytes):
    """c4 lowers to one scoring precomputed posting list in posting space
    (the fused score_topk branch on the card); the phrase prefix to a Bool
    `should` of phrases in doc space, as in the JAX package."""
    reader = torch_reader(split_bytes)
    c4 = plan_of(reader, REQUESTS["c4"])
    assert t_executor._posting_space_eligible(c4) and c4.root.scoring
    assert c4.sort.by == "score" and c4.threshold_slot < 0
    prefix = plan_of(reader, REQUESTS["phrase_prefix"])
    assert isinstance(prefix.root, PBool) and len(prefix.root.should) == 10
    assert not t_executor._posting_space_eligible(prefix)
    assert not t_executor._posting_space_eligible(
        plan_of(reader, REQUESTS["bool_range"]))


def test_phrase_key_carries_the_slop(split_bytes):
    """On one reader, a slop-2 phrase after the exact phrase of the same
    terms gives what it gives on a fresh reader (the JAX leaf reuses the
    exact phrase's staged postings there: 27 hits in place of 96)."""
    reader = torch_reader(split_bytes)
    exact = torch_search(reader, REQUESTS["c4"])
    after = torch_search(reader, REQUESTS["slop2"])
    fresh = torch_search(torch_reader(split_bytes), REQUESTS["slop2"])
    assert (after.num_hits, hits(after)) == (fresh.num_hits, hits(fresh))
    assert (exact.num_hits, fresh.num_hits) == (27, 96)
    assert [h.doc_id for h in fresh.partial_hits[:5]] == [
        3660, 174, 360, 369, 429]
    assert hits(fresh) == hits(jax_search(split_bytes, REQUESTS["slop2"]))
    keys = {arr for arr in plan_of(reader, REQUESTS["slop2"]).array_keys
            if arr.startswith("pre.")}
    assert keys and all(key.endswith(".slop2.ids") or
                        key.endswith(".slop2.tfs") for key in keys)
    # slop 0 keeps the JAX package's key
    assert "pre.body.phrase.10.11.ids" in plan_of(
        reader, REQUESTS["c4"]).array_keys


def test_so_split_over_file_and_s3_storage(split_bytes, tmp_path):
    """The split read from a split file through the resolver's `file://`
    backend, and over the wire from the fake S3 server, gives RAM's c4."""
    want = torch_search(torch_reader(split_bytes), REQUESTS["c4"])
    local = StorageResolver.for_test().resolve(f"file://{tmp_path}")
    assert isinstance(local, LocalFileStorage)
    got = torch_search(torch_reader(split_bytes, local), REQUESTS["c4"])
    assert (got.num_hits, hits(got)) == (want.num_hits, hits(want))
    creds = dict(access_key="test-access-key", secret_key="test-secret")
    with FakeS3Server(**creds) as server:
        s3 = S3CompatibleStorage(
            TUri.parse("s3://bench/so"),
            S3Config(endpoint=server.endpoint, region="us-east-1", **creds))
        got = torch_search(torch_reader(split_bytes, s3), REQUESTS["c4"])
        assert server.auth_failures == 0
    assert (got.num_hits, hits(got)) == (want.num_hits, hits(want))
