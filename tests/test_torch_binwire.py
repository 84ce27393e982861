"""The port's binwire codec against the JAX package's.

`tests/test_binwire.py`'s eight cases run against the port's codec. Then
the wire itself: for each value both packages must write the same bytes,
and each package must decode the other's bytes to the same value, so a
mixed cluster's gRPC payloads stay readable in both directions. The
leaf responses come from each package's leaf over one JAX-written split
(the port on the CPU).
"""

import numpy as np
import pytest

from quickwit_tpu.serve import binwire as jwire
from quickwit_tpu_torch.serve import binwire as twire
from quickwit_tpu_torch.serve.binwire import BinwireError, decode, encode

SCALARS = [None, True, False, 0, -1, 2**62, -(2**62), 1.5, -0.25,
           "", "héllo", b"", b"\x00\xff", float("inf"), float("-inf")]
ARRAYS = [np.arange(10, dtype=np.int64),
          np.zeros((3, 4), dtype=np.float64),
          np.array([], dtype=np.int32),
          np.array([[1, 2], [3, 4]], dtype=np.uint8),
          (np.arange(6).reshape(2, 3) * 1.5).astype(np.float32)]


def agg_state():
    return {"over_time": {"kind": "date_histogram",
                          "counts": np.arange(100, dtype=np.int32),
                          "metrics": {"lat": {
                              "sum": np.ones(100),
                              "count": np.arange(100, dtype=np.int64)}},
                          "origin": 1_600_000_000_000_000,
                          "interval": 86_400_000_000}}


# --- tests/test_binwire.py, against the port ---------------------------------

def test_scalars_roundtrip():
    for value in SCALARS:
        assert decode(encode(value)) == value


def test_nan_roundtrip():
    out = decode(encode(float("nan")))
    assert out != out


def test_nested_structures():
    value = {"a": [1, "x", None, {"b": [True, 2.5]}],
             "empty": {}, "list": [], "bytes": b"raw"}
    assert decode(encode(value)) == value


def test_numpy_arrays_roundtrip():
    for arr in ARRAYS:
        out = decode(encode(arr))
        assert out.dtype == arr.dtype and out.shape == arr.shape
        assert np.array_equal(out, arr)


def test_non_string_dict_keys():
    value = {(1, 2): "pair", 3.5: "float", 7: "int"}
    out = decode(encode(value))
    assert out == {(1, 2): "pair", 3.5: "float", 7: "int"}


def test_agg_state_shaped_tree():
    state = agg_state()
    out = decode(encode(state))
    assert np.array_equal(out["over_time"]["counts"],
                          state["over_time"]["counts"])
    assert out["over_time"]["interval"] == 86_400_000_000


def test_truncated_and_trailing_bytes_error():
    good = encode({"a": 1})
    with pytest.raises(BinwireError):
        decode(good[:-1])
    with pytest.raises(BinwireError):
        decode(good + b"x")


def test_leaf_response_wire_roundtrip():
    from quickwit_tpu_torch.search.models import (
        LeafSearchResponse, PartialHit, SplitSearchError)
    from quickwit_tpu_torch.serve.serializers import (
        leaf_response_from_wire, leaf_response_to_wire)
    response = LeafSearchResponse(
        num_hits=42,
        partial_hits=[PartialHit(sort_value=3.5, split_id="s1", doc_id=7,
                                 raw_sort_value=1_600_000_000)],
        failed_splits=[SplitSearchError("s2", "boom", True)],
        num_attempted_splits=2, num_successful_splits=1,
        intermediate_aggs={"t": {"kind": "terms",
                                 "counts": np.array([5, 6], np.int64)}},
        resource_stats={"cpu_micros": 12.0})
    out = leaf_response_from_wire(decode(encode(
        leaf_response_to_wire(response))))
    assert out.num_hits == 42
    assert out.partial_hits[0].raw_sort_value == 1_600_000_000
    assert out.failed_splits[0].split_id == "s2"
    assert np.array_equal(out.intermediate_aggs["t"]["counts"], [5, 6])


# --- the two packages on one wire ---------------------------------------------

def same_value(a, b):
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and np.array_equal(a, b))
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(same_value(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same_value(x, y) for x, y in zip(a, b)))
    if isinstance(a, float) and a != a:
        return isinstance(b, float) and b != b
    return type(a) is type(b) and a == b


VALUES = {
    "scalars": SCALARS,
    "nan": float("nan"),
    "nested": {"a": [1, "x", None, {"b": [True, 2.5]}], "empty": {},
               "list": [], "bytes": b"raw", "tuple": (1, 2)},
    "arrays": ARRAYS,
    "numpy_scalars": [np.int32(-3), np.float64(2.5), np.uint64(2**63),
                      np.bool_(True)],
    "dict_keys": {(1, 2): "pair", 3.5: "float", 7: "int"},
    "agg_state": agg_state(),
}


@pytest.mark.parametrize("name", list(VALUES))
def test_both_packages_write_equal_bytes_and_read_each_other(name):
    value = VALUES[name]
    port_bytes, jax_bytes = twire.encode(value), jwire.encode(value)
    assert port_bytes == jax_bytes
    want = jwire.decode(jax_bytes)
    assert same_value(twire.decode(jax_bytes), want)
    assert same_value(jwire.decode(port_bytes), twire.decode(port_bytes))


@pytest.fixture(scope="module")
def leaf_responses():
    """Each package's leaf response for one split (the flagship: top-10
    hits and two bucket aggregations), the port on the CPU."""
    from quickwit_tpu.common.uri import Uri as JUri
    from quickwit_tpu.index.reader import SplitReader as JSplitReader
    from quickwit_tpu.index.synthetic import HDFS_MAPPER as J_MAPPER
    from quickwit_tpu.index.synthetic import synthetic_hdfs_split
    from quickwit_tpu.query import ast as JQ
    from quickwit_tpu.search.leaf import leaf_search_single_split as j_leaf
    from quickwit_tpu.search.models import SearchRequest as JRequest
    from quickwit_tpu.storage.ram import RamStorage as JRam
    from quickwit_tpu_torch.common.uri import Uri as TUri
    from quickwit_tpu_torch.index.reader import SplitReader as TSplitReader
    from quickwit_tpu_torch.index.synthetic import HDFS_MAPPER as T_MAPPER
    from quickwit_tpu_torch.query import ast as TQ
    from quickwit_tpu_torch.search.leaf import (
        leaf_search_single_split as t_leaf)
    from quickwit_tpu_torch.search.models import SearchRequest as TRequest
    from quickwit_tpu_torch.storage.ram import RamStorage as TRam

    aggs = {"over_time": {"date_histogram": {"field": "timestamp",
                                             "fixed_interval": "1d"}},
            "severities": {"terms": {"field": "severity_text", "size": 10}}}
    data = synthetic_hdfs_split(30_720, seed=7)
    js, ts = JRam(JUri.parse("ram:///bw")), TRam(TUri.parse("ram:///bw"))
    js.put("s.split", data)
    ts.put("s.split", data)
    j_resp = j_leaf(JRequest(index_ids=["hdfs-logs"],
                             query_ast=JQ.Term("severity_text", "ERROR"),
                             max_hits=10, aggs=dict(aggs)),
                    J_MAPPER, JSplitReader(js, "s.split"), "split-a")
    t_resp = t_leaf(TRequest(index_ids=["hdfs-logs"],
                             query_ast=TQ.Term("severity_text", "ERROR"),
                             max_hits=10, aggs=dict(aggs)),
                    T_MAPPER, TSplitReader(ts, "s.split"), "split-a",
                    device="cpu")
    return j_resp, t_resp


def test_leaf_responses_of_one_split_are_equal_bytes(leaf_responses):
    from quickwit_tpu.serve import serializers as jser
    from quickwit_tpu_torch.serve import serializers as tser
    j_resp, t_resp = leaf_responses
    assert t_resp.num_hits > 0 and len(t_resp.partial_hits) == 10
    # `cpu_micros` is each leaf's own wall time: the one field that may
    # differ, written as 0 on both sides
    assert set(j_resp.resource_stats) == set(t_resp.resource_stats)
    j_resp.resource_stats["cpu_micros"] = 0
    t_resp.resource_stats["cpu_micros"] = 0
    jax_bytes = jwire.encode(jser.leaf_response_to_wire(j_resp))
    port_bytes = twire.encode(tser.leaf_response_to_wire(t_resp))
    assert port_bytes == jax_bytes

    # each package decodes the other's bytes into an equal response
    from_jax = tser.leaf_response_from_wire(twire.decode(jax_bytes))
    from_port = jser.leaf_response_from_wire(jwire.decode(port_bytes))
    assert twire.encode(tser.leaf_response_to_wire(from_jax)) == jax_bytes
    assert jwire.encode(jser.leaf_response_to_wire(from_port)) == port_bytes
    assert same_value(from_jax.intermediate_aggs, j_resp.intermediate_aggs)
    assert [(h.split_id, h.doc_id, h.sort_value)
            for h in from_port.partial_hits] == [
        (h.split_id, h.doc_id, h.sort_value) for h in t_resp.partial_hits]


def test_a_tensor_is_refused_not_encoded():
    import torch
    with pytest.raises(BinwireError, match="Tensor"):
        encode({"counts": torch.arange(3)})
