"""The port's `exact_topk` against the JAX package's, on the orders that
separate them: `lax.top_k` ranks `+0.0` above `-0.0`, +NaN first and -NaN
last, with ties to the lowest index. A stable float sort ranks the two
zeros equal, so a top-k cut between them differs; the port sorts an
order-preserving integer view of the key instead.

Unit cases run both functions on numpy-seeded keys; the end-to-end case
sorts a split written by the JAX package's `SplitWriter` by an f64 fast
field that holds both zeros, with the top-k cut between them, in doc space
and in posting space.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickwit_tpu.ops import topk as j_topk
from quickwit_tpu_torch.ops import topk as t_topk


def _keys(rng, n, ties):
    """f64 keys with signed-zero pairs, NaN of both signs, -inf, the
    missing-value sentinel and (with `ties`) many equal values."""
    special = rng.choice([-0.0, 0.0, np.nan, -np.nan, -np.inf, np.inf,
                          t_topk.MISSING_VALUE_SENTINEL], n)
    values = (rng.randint(-4, 4, n) * 0.25 if ties
              else rng.standard_normal(n))
    return np.where(rng.rand(n) < 0.4, special, values)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n,k", [
    (n, k) for n in (1, 100, 1023, 1024, 1025, 3072, 5000)
    for k in (1, 10, 100) if k <= n])
def test_exact_topk_matches_jax(n, k, ties):
    keys = _keys(np.random.RandomState(n * 7 + k + ties), n, ties)
    want_vals, want_idx = jax.jit(j_topk.exact_topk, static_argnums=1)(
        jnp.asarray(keys), k)
    got_vals, got_idx = t_topk.exact_topk(torch.from_numpy(keys), k)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_vals.numpy().view(np.int64),
                                  np.asarray(want_vals).view(np.int64))


def test_positive_zero_ranks_above_negative_zero():
    """The input that showed the fault: `lax.top_k([-0., 0., -0., 0.], 4)`
    gives indices [1, 3, 0, 2]."""
    keys = torch.tensor([-0.0, 0.0, -0.0, 0.0], dtype=torch.float64)
    assert t_topk.exact_topk(keys, 4)[1].tolist() == [1, 3, 0, 2]


# --- end to end: an f64 field holding both zeros ---------------------------

def _mapper(FieldMapping, FieldType, DocMapper):
    return DocMapper(
        field_mappings=[
            FieldMapping("timestamp", FieldType.DATETIME, fast=True,
                         input_formats=("unix_timestamp",)),
            FieldMapping("severity_text", FieldType.TEXT, tokenizer="raw",
                         fast=True),
            FieldMapping("gain", FieldType.F64, fast=True),
            # positions keep the postings in doc order, so a field sort
            # over one term stays in posting space
            FieldMapping("body", FieldType.TEXT, record="position"),
        ],
        timestamp_field="timestamp")


@pytest.fixture(scope="module")
def zeros_split():
    from quickwit_tpu.common.uri import Uri as JUri
    from quickwit_tpu.index.reader import SplitReader as JSplitReader
    from quickwit_tpu.index.writer import SplitWriter
    from quickwit_tpu.models import doc_mapper as jdm
    from quickwit_tpu.storage.ram import RamStorage as JRamStorage
    from quickwit_tpu_torch.common.uri import Uri as TUri
    from quickwit_tpu_torch.index.reader import SplitReader as TSplitReader
    from quickwit_tpu_torch.models import doc_mapper as tdm
    from quickwit_tpu_torch.storage.ram import RamStorage as TRamStorage
    rng = np.random.RandomState(5)
    j_mapper = _mapper(jdm.FieldMapping, jdm.FieldType, jdm.DocMapper)
    writer = SplitWriter(j_mapper)
    for i in range(2500):
        writer.add_json_doc({
            "timestamp": 1_600_000_000 + i,
            "severity_text": ["INFO", "ERROR"][i % 2],
            "body": "alpha" if i % 3 else "beta",
            # 1.0 on 50 docs, then ~120 at +0.0 and ~1470 at -0.0
            "gain": float(rng.choice([0.0, -0.0, -1.0],
                                     p=[0.05, 0.6, 0.35]))
            if i % 50 else 1.0,
        })
    data = writer.finish()
    js = JRamStorage(JUri.parse("ram:///zeros"))
    js.put("z.split", data)
    ts = TRamStorage(TUri.parse("ram:///zeros"))
    ts.put("z.split", data)
    return (JSplitReader(js, "z.split"), j_mapper, TSplitReader(ts, "z.split"),
            _mapper(tdm.FieldMapping, tdm.FieldType, tdm.DocMapper))


@pytest.mark.parametrize("query", ["match_all", "term"])
def test_sort_by_field_with_both_zeros_matches_jax(zeros_split, query):
    """Held against the JAX program with its exact top-k. (The JAX leaf's
    default f32-screened `guided_topk` answers differently here: its
    screen maps both zeros to one f32 value and its exactness check
    compares them equal, so it certifies a cut that drops +0.0 lanes.)"""
    from quickwit_tpu.query import ast as JQ
    from quickwit_tpu.search import executor as j_executor
    from quickwit_tpu.search.plan import lower_request as j_lower
    from quickwit_tpu_torch.query import ast as TQ
    from quickwit_tpu_torch.search import executor as t_executor
    from quickwit_tpu_torch.search.plan import lower_request as t_lower
    j_reader, j_mapper, t_reader, t_mapper = zeros_split

    def ast(Q):
        return Q.MatchAll() if query == "match_all" else \
            Q.Term("body", "alpha")

    # 50 docs hold 1.0 and ~120 +0.0: a cut at 300 falls among the -0.0
    j_plan = j_lower(ast(JQ), j_mapper, j_reader, [], sort_field="gain")
    t_plan = t_lower(ast(TQ), t_mapper, t_reader, [], sort_field="gain")
    assert t_executor._posting_space_eligible(t_plan) == (query == "term")
    want = j_executor.readback_plan_result(j_executor.dispatch_plan(
        j_plan, 300, [jnp.asarray(a) for a in j_plan.arrays], exact=True))
    got = t_executor.execute_plan(
        t_plan, 300, [torch.from_numpy(np.array(a)) for a in t_plan.arrays],
        device="cpu")
    assert got["count"] == want["count"] > 300
    np.testing.assert_array_equal(got["doc_ids"], want["doc_ids"])
    np.testing.assert_array_equal(got["sort_values"].view(np.int64),
                                  want["sort_values"].view(np.int64))
    zeros = got["sort_values"][got["sort_values"] == 0.0]
    signs = list(np.signbit(zeros))
    # +0.0 hits come first, then -0.0 hits up to the cut
    assert signs == sorted(signs) and any(signs) and not all(signs)
