"""The port's posting-space program against the JAX package's.

Each side lowers the same request on the same split bytes with its own
lowering, then runs its own `_build_posting_space(plan, k)` program: the
port on CPU torch (the fused score + top-k branch runs the kernel's plain
version), the JAX package under `jax.jit` on the CPU. Count, the valid
hits' sort values, doc ids and hit scores, and the aggregation counts must
be equal exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickwit_tpu.common.uri import Uri as JUri
from quickwit_tpu.index.reader import SplitReader as JSplitReader
from quickwit_tpu.index.synthetic import (
    HDFS_MAPPER as J_HDFS_MAPPER, body_term, synthetic_hdfs_split)
from quickwit_tpu.query import ast as JQ
from quickwit_tpu.query.aggregations import parse_aggs as j_parse_aggs
from quickwit_tpu.ops.aggs import bucket_counts as j_bucket_counts
from quickwit_tpu.search import executor as j_executor
from quickwit_tpu.search.plan import lower_request as j_lower
from quickwit_tpu.storage.ram import RamStorage as JRamStorage

from quickwit_tpu_torch.common.uri import Uri as TUri
from quickwit_tpu_torch.index.reader import SplitReader as TSplitReader
from quickwit_tpu_torch.index.synthetic import HDFS_MAPPER as T_HDFS_MAPPER
from quickwit_tpu_torch.query import ast as TQ
from quickwit_tpu_torch.query.aggregations import parse_aggs as t_parse_aggs
from quickwit_tpu_torch.ops.aggs import bucket_counts as t_bucket_counts
from quickwit_tpu_torch.search import executor as t_executor
from quickwit_tpu_torch.search.plan import lower_request as t_lower
from quickwit_tpu_torch.storage.ram import RamStorage as TRamStorage

AGGS = {"over_time": {"date_histogram": {"field": "timestamp",
                                         "fixed_interval": "1d"}},
        "severities": {"terms": {"field": "severity_text", "size": 10}}}

# name -> (query builder, aggs, sort field, sort order, k)
REQUESTS = {
    "flagship": (lambda Q: Q.Term("severity_text", "ERROR"), AGGS,
                 "_score", "desc", 10),
    "c1_term_top10": (lambda Q: Q.Term("severity_text", "ERROR"), {},
                      "_score", "desc", 10),
    "c3_agg_only": (lambda Q: Q.Term("severity_text", "ERROR"), AGGS,
                    "_score", "desc", 0),
    "body_top10": (lambda Q: Q.Term("body", body_term(3)), {},
                   "_score", "desc", 10),
    # the unfused path: k above the kernel's limit, field and doc sorts
    "body_top100": (lambda Q: Q.Term("body", body_term(3)), AGGS,
                    "_score", "desc", 100),
    "warn_by_timestamp": (lambda Q: Q.Term("severity_text", "WARN"), AGGS,
                          "timestamp", "asc", 10),
    "error_by_doc": (lambda Q: Q.Term("severity_text", "ERROR"), {},
                     "_doc", "desc", 10),
}


@pytest.fixture(scope="module")
def readers():
    data = synthetic_hdfs_split(50_000, seed=7)
    js = JRamStorage(JUri.parse("ram:///exec"))
    js.put("s.split", data)
    ts = TRamStorage(TUri.parse("ram:///exec"))
    ts.put("s.split", data)
    return JSplitReader(js, "s.split"), TSplitReader(ts, "s.split")


def _assert_tree_equal(a, b, path="aggs"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for key in a:
            _assert_tree_equal(a[key], b[key], f"{path}.{key}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{i}]")
    else:
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path


@pytest.mark.parametrize("name", list(REQUESTS))
def test_posting_space_program_matches_jax(readers, name):
    build, aggs, sort_field, sort_order, k = REQUESTS[name]
    j_reader, t_reader = readers
    j_plan = j_lower(build(JQ), J_HDFS_MAPPER, j_reader, j_parse_aggs(aggs),
                     sort_field=sort_field, sort_order=sort_order)
    t_plan = t_lower(build(TQ), T_HDFS_MAPPER, t_reader, t_parse_aggs(aggs),
                     sort_field=sort_field, sort_order=sort_order)
    assert j_executor._posting_space_eligible(j_plan)
    assert t_executor._posting_space_eligible(t_plan)

    j_fn = jax.jit(j_executor._build_posting_space(j_plan, k))
    j_out = j_fn(tuple(jnp.asarray(a) for a in j_plan.arrays),
                 tuple(jnp.asarray(s) for s in j_plan.scalars),
                 jnp.int32(j_plan.num_docs))
    t_fn = t_executor._build_posting_space(t_plan, k)
    t_out = t_fn([torch.from_numpy(np.array(a)) for a in t_plan.arrays],
                 tuple(t_plan.scalars), t_plan.num_docs)

    j_vals, j_vals2, j_docs, j_scores, j_count, _, j_aggs = j_out
    t_vals, t_vals2, t_docs, t_scores, t_count, _, t_aggs = t_out
    assert j_vals2 is None and t_vals2 is None
    count = int(j_count)
    assert int(t_count) == count > 0
    assert t_count.dtype == torch.int32
    live = min(k, count)
    assert t_vals.shape == (min(k, t_plan.arrays[t_plan.root.ids_slot]
                                .shape[0]),)
    assert (t_vals.dtype, t_docs.dtype, t_scores.dtype) == (
        torch.float64, torch.int32, torch.float32)
    np.testing.assert_array_equal(t_vals[:live].numpy(),
                                  np.asarray(j_vals)[:live])
    np.testing.assert_array_equal(t_docs[:live].numpy(),
                                  np.asarray(j_docs)[:live])
    np.testing.assert_array_equal(t_scores[:live].numpy(),
                                  np.asarray(j_scores)[:live])
    _assert_tree_equal(j_aggs, t_aggs)


def test_packed_readback_roundtrip(readers):
    """execute_plan's one-copy packed readback returns the program's tree."""
    _, t_reader = readers
    t_plan = t_lower(TQ.Term("severity_text", "ERROR"), T_HDFS_MAPPER,
                     t_reader, t_parse_aggs(AGGS))
    arrays = [torch.from_numpy(np.array(a)) for a in t_plan.arrays]
    direct = t_executor._build_posting_space(t_plan, 10)(
        arrays, tuple(t_plan.scalars), t_plan.num_docs)
    res = t_executor.execute_plan(t_plan, 10, arrays, device="cpu")
    assert res["count"] == int(direct[4])
    assert res["sort_values2"] is None
    for key, leaf in zip(("sort_values", "doc_ids", "scores"),
                         (direct[0], direct[2], direct[3])):
        assert res[key].dtype == leaf.numpy().dtype
        np.testing.assert_array_equal(res[key], leaf.numpy())
    _assert_tree_equal(res["aggs"], direct[6])


def test_unported_plans_raise(readers):
    """The plans that raised before the remaining-aggregations slice was
    ported (top-level metrics, range aggregations and bucket metrics) now
    run, on posting-space and doc-space plans alike, and their whole result
    tree equals the JAX program's exactly (tenant_id sums are integers far
    below 2^53). A Bool root with bucket counts still runs."""
    j_reader, t_reader = readers
    bool_query = (lambda Q: Q.Bool(must=(Q.Term("severity_text", "ERROR"),),
                                   should=(Q.Term("body", body_term(3)),)))
    formerly_unported = (
        {"t": {"stats": {"field": "tenant_id"}}},
        {"r": {"range": {"field": "tenant_id", "ranges": [{"to": 5}]}}},
        {"s": {"terms": {"field": "severity_text"},
               "aggs": {"m": {"max": {"field": "tenant_id"}}}}},
    )
    for query in (lambda Q: Q.Term("severity_text", "ERROR"), bool_query):
        for aggs in formerly_unported:
            j_plan = j_lower(query(JQ), J_HDFS_MAPPER, j_reader,
                             j_parse_aggs(aggs))
            t_plan = t_lower(query(TQ), T_HDFS_MAPPER, t_reader,
                             t_parse_aggs(aggs))
            assert (t_executor._posting_space_eligible(t_plan)
                    == j_executor._posting_space_eligible(j_plan))
            j_res = j_executor.execute_plan(
                j_plan, 10, [jnp.asarray(a) for a in j_plan.arrays])
            t_res = t_executor.execute_plan(
                t_plan, 10,
                [torch.from_numpy(np.array(a)) for a in t_plan.arrays],
                device="cpu")
            assert t_res["count"] == j_res["count"] > 0
            np.testing.assert_array_equal(t_res["doc_ids"],
                                          np.asarray(j_res["doc_ids"]))
            _assert_tree_equal(j_res["aggs"], [
                _as_tensors(tree) for tree in t_res["aggs"]])
    plan = t_lower(bool_query(TQ), T_HDFS_MAPPER, t_reader,
                   t_parse_aggs(AGGS))
    assert not t_executor._posting_space_eligible(plan)
    arrays = [torch.from_numpy(np.array(a)) for a in plan.arrays]
    res = t_executor.execute_plan(plan, 10, arrays, device="cpu")
    assert res["count"] > 0
    assert int(res["aggs"][1]["counts"].sum()) == res["count"]


def _as_tensors(tree):
    """A readback tree (numpy leaves) with torch leaves, for
    `_assert_tree_equal`."""
    if isinstance(tree, dict):
        return {key: _as_tensors(v) for key, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_tensors(v) for v in tree)
    return torch.from_numpy(np.asarray(tree))


@pytest.mark.parametrize("num_buckets", [1, 4, 64, 65, 700])
def test_bucket_counts_match_jax(num_buckets):
    """Both sides of the compare-and-reduce limit; indices at or past
    num_buckets (the executor's drop sentinel) drop. (The executor never
    passes negative indices: the JAX scatter form would wrap them.)"""
    rng = np.random.RandomState(num_buckets)
    idx = rng.randint(0, num_buckets + 2, 20_000).astype(np.int32)
    want = np.asarray(j_bucket_counts(jnp.asarray(idx), num_buckets))
    got = t_bucket_counts(torch.from_numpy(idx), num_buckets).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
