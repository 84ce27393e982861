"""The port's host lowering against the JAX package's.

For each request, both packages lower the same query against the same
split bytes; the resulting `LoweredPlan`s must agree field by field and
byte for byte (arrays, scalars, slot maps, aggregation executables, sort,
and the structure signature).
"""

import dataclasses

import numpy as np
import pytest

from quickwit_tpu.common.uri import Uri as JUri
from quickwit_tpu.index.reader import SplitReader as JSplitReader
from quickwit_tpu.index.synthetic import (
    HDFS_MAPPER as J_HDFS_MAPPER, body_term, synthetic_hdfs_split)
from quickwit_tpu.query import ast as JQ
from quickwit_tpu.query.aggregations import parse_aggs as j_parse_aggs
from quickwit_tpu.search.plan import lower_request as j_lower
from quickwit_tpu.storage.ram import RamStorage as JRamStorage

from quickwit_tpu_torch.common.uri import Uri as TUri
from quickwit_tpu_torch.index.reader import SplitReader as TSplitReader
from quickwit_tpu_torch.index.synthetic import HDFS_MAPPER as T_HDFS_MAPPER
from quickwit_tpu_torch.query import ast as TQ
from quickwit_tpu_torch.query.aggregations import parse_aggs as t_parse_aggs
from quickwit_tpu_torch.search.plan import lower_request as t_lower
from quickwit_tpu_torch.storage.ram import RamStorage as TRamStorage

AGGS = {"over_time": {"date_histogram": {"field": "timestamp",
                                         "fixed_interval": "1d"}},
        "severities": {"terms": {"field": "severity_text", "size": 10}}}

# name -> (query builder, aggs, sort field)
REQUESTS = {
    "flagship": (lambda Q: Q.Term("severity_text", "ERROR"), AGGS, "_score"),
    "c1_term_top10": (lambda Q: Q.Term("severity_text", "ERROR"), {},
                      "_score"),
    "c3_agg_only": (lambda Q: Q.Term("severity_text", "ERROR"), AGGS,
                    "_score"),
    "body_top10": (lambda Q: Q.Term("body", body_term(3)), {}, "_score"),
    "term_by_timestamp": (lambda Q: Q.Term("severity_text", "WARN"), AGGS,
                          "timestamp"),
}


@pytest.fixture(scope="module")
def readers():
    data = synthetic_hdfs_split(30_720, seed=7)
    js = JRamStorage(JUri.parse("ram:///plan"))
    js.put("s.split", data)
    ts = TRamStorage(TUri.parse("ram:///plan"))
    ts.put("s.split", data)
    return JSplitReader(js, "s.split"), TSplitReader(ts, "s.split")


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


@pytest.mark.parametrize("name", list(REQUESTS))
def test_lowered_plan_matches_jax(readers, name):
    build, aggs, sort_field = REQUESTS[name]
    j_reader, t_reader = readers
    j_plan = j_lower(build(JQ), J_HDFS_MAPPER, j_reader, j_parse_aggs(aggs),
                     sort_field=sort_field)
    t_plan = t_lower(build(TQ), T_HDFS_MAPPER, t_reader, t_parse_aggs(aggs),
                     sort_field=sort_field)
    assert t_plan.array_keys == j_plan.array_keys
    assert len(t_plan.arrays) == len(j_plan.arrays)
    for key, a, b in zip(j_plan.array_keys, j_plan.arrays, t_plan.arrays):
        assert canon(b) == canon(a), key
    assert canon(t_plan.scalars) == canon(j_plan.scalars)
    assert canon(t_plan.root) == canon(j_plan.root)
    assert canon(t_plan.sort) == canon(j_plan.sort)
    assert canon(t_plan.aggs) == canon(j_plan.aggs)
    for f in ("num_docs", "num_docs_padded", "search_after_relation",
              "sa_value_slot", "sa_value2_slot", "sa_doc_slot",
              "sort_text_field", "threshold_slot", "rebase",
              "count_override", "doc_base_slot"):
        assert getattr(t_plan, f) == getattr(j_plan, f), f
    for k in (0, 10, 100):
        assert t_plan.signature(k) == j_plan.signature(k)
    assert canon(t_plan) == canon(j_plan)
