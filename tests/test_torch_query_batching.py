"""The port's stacked query groups and convoys (search/executor.py's
`dispatch_plan_stacked` / `dispatch_plan_multi`, search/batcher.py's
grouping rules, residency's shared-staging note and the lane kernel's plain
version) against solo runs of the port and of the JAX package.

Both packages read the same split bytes (written by the JAX package, the
corpus of `tests/test_query_batching.py`: 300 docs, formats v3, v2 and v1).
Every lane of a stacked dispatch on `device="cpu"` must equal the port's
solo `execute_plan` bit for bit and the JAX package's solo `execute_plan`
exactly (f64 sums to rtol 1e-12), across sorts, ties, thresholds,
search_after markers, aggregations and the three split formats. A lane
masked after the group formed reads back as None and launches nothing.

Two cases pin faults of the JAX stacked program that the port does not
share (ROADMAP §3): a same-named range agg with other bounds in two lanes,
and one phrase at slop 0 and slop 2. The JAX package shares those slots
between the lanes (its array keys name the agg and the terms alone); the
port's keys carry the bounds and the slop, so each lane reads its own, and
each lane equals its solo run. The JAX solo runs of those cases use a
fresh reader per request (its reader stages those slots by the same keys).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickwit_tpu.common.uri import Uri as JUri
from quickwit_tpu.index.reader import SplitReader as JSplitReader
from quickwit_tpu.index.writer import SplitWriter as JSplitWriter
from quickwit_tpu.models import doc_mapper as jdm
from quickwit_tpu.ops.pallas.score_topk import fused_score_topk
from quickwit_tpu.query import ast as JQ
from quickwit_tpu.search import executor as j_ex
from quickwit_tpu.search import models as j_models
from quickwit_tpu.search.batcher import QueryGroupPlanner as JPlanner
from quickwit_tpu.search.leaf import prepare_single_split as j_prepare
from quickwit_tpu.storage.ram import RamStorage as JRamStorage

from quickwit_tpu_torch.common.uri import Uri as TUri
from quickwit_tpu_torch.index.reader import SplitReader as TSplitReader
from quickwit_tpu_torch.models import doc_mapper as tdm
from quickwit_tpu_torch.observability.metrics import (
    QBATCH_INCOMPATIBLE_TOTAL, QBATCH_SHARED_BYTES_AVOIDED_TOTAL,
    RESIDENT_COLUMN_HITS, SEARCH_KERNEL_LAUNCHES_TOTAL, STAGING_BYTES_TOTAL,
)
from quickwit_tpu_torch.ops.kernels import score_topk as st
from quickwit_tpu_torch.query import ast as TQ
from quickwit_tpu_torch.search import executor as t_ex
from quickwit_tpu_torch.search import models as t_models
from quickwit_tpu_torch.search.batcher import QueryGroupPlanner
from quickwit_tpu_torch.search.leaf import prepare_single_split as t_prepare
from quickwit_tpu_torch.search.residency import note_group_shared_staging
from quickwit_tpu_torch.storage.ram import RamStorage as TRamStorage

from test_torch_chunked import _bits, assert_same_result

T0 = 1_600_000_000
SEVS = ("INFO", "WARN", "ERROR")


def _mapper(dm):
    return dm.DocMapper(
        field_mappings=[
            dm.FieldMapping("ts", dm.FieldType.DATETIME, fast=True,
                            input_formats=("unix_timestamp",)),
            dm.FieldMapping("sev", dm.FieldType.TEXT, tokenizer="raw",
                            fast=True),
            dm.FieldMapping("tenant", dm.FieldType.U64, fast=True),
            dm.FieldMapping("lat", dm.FieldType.F64, fast=True),
            dm.FieldMapping("body", dm.FieldType.TEXT),
        ],
        timestamp_field="ts", default_search_fields=("body",))


J_MAPPER, T_MAPPER = _mapper(jdm), _mapper(tdm)


def _docs(n, seed):
    rng = np.random.RandomState(seed)
    for i in range(n):
        yield {
            "ts": T0 + i * 60,
            "sev": SEVS[int(rng.randint(0, 3))],
            "tenant": int(rng.randint(0, 4)),
            "lat": float(rng.randint(1, 500)),
            "body": f"m{int(rng.randint(0, 4))}",
        }


class Split:
    """One split's bytes, with a reader of each package over them."""

    def __init__(self, data: bytes, name: str):
        self.data, self.name = data, name
        self.j_reader = self.fresh_jax_reader()
        storage = TRamStorage(TUri.parse(f"ram:///tqb-{name}"))
        storage.put("s.split", data)
        self.t_reader = TSplitReader(storage, "s.split")

    def fresh_jax_reader(self):
        storage = JRamStorage(JUri.parse(f"ram:///jqb-{self.name}"))
        storage.put("s.split", self.data)
        return JSplitReader(storage, "s.split")


def write_split(n_docs, seed, name, monkeypatch_env=None):
    with pytest.MonkeyPatch.context() as mp:
        for key, value in (monkeypatch_env or {}).items():
            mp.setenv(key, value)
        writer = JSplitWriter(J_MAPPER)
        for doc in _docs(n_docs, seed):
            writer.add_json_doc(doc)
        return Split(writer.finish(), name)


@pytest.fixture(scope="module")
def splits():
    return {"v3": write_split(300, 11, "v3"),
            "v2": write_split(300, 11, "v2", {"QW_DISABLE_IMPACT": "1"}),
            "v1": write_split(300, 11, "v1", {"QW_DISABLE_PACKED": "1"})}


class Query:
    """One request lowered and staged by both packages (the port on the
    CPU)."""

    def __init__(self, split: Split, build, fresh_jax_reader=False, **kw):
        j_reader = (split.fresh_jax_reader() if fresh_jax_reader
                    else split.j_reader)
        self.j_plan, self.j_arrays, _ = j_prepare(
            j_models.SearchRequest(index_ids=["t"], query_ast=build(JQ),
                                   **_sort_fields(j_models, kw)),
            J_MAPPER, j_reader, "s")
        self.plan, self.arrays, _ = t_prepare(
            t_models.SearchRequest(index_ids=["t"], query_ast=build(TQ),
                                   **_sort_fields(t_models, kw)),
            T_MAPPER, split.t_reader, "s", device="cpu")

    def solo(self, k):
        return t_ex.execute_plan(self.plan, k, self.arrays, device="cpu")

    def jax_solo(self, k):
        return j_ex.execute_plan(self.j_plan, k, self.j_arrays)


def _sort_fields(models, kw):
    kw = dict(kw)
    if "sort" in kw:
        kw["sort_fields"] = [models.SortField(*s) for s in kw.pop("sort")]
    return kw


def sev(s):
    return lambda Q: Q.Term("sev", s)


def window(lo_s, hi_s):
    return lambda Q: Q.Range("ts", lower=Q.RangeBound(lo_s * 1_000_000, True),
                             upper=Q.RangeBound(hi_s * 1_000_000, False))


def stack(queries, k, valid=None):
    return t_ex.readback_plan_stacked(t_ex.dispatch_plan_stacked(
        [q.plan for q in queries], k, [q.arrays for q in queries],
        valid=valid, device="cpu"))


def stack_and_compare(queries, k, valid=None):
    """Each live lane of the stacked dispatch against the port's solo run
    (bitwise) and the JAX package's (exactly, f64 sums to rtol 1e-12)."""
    stacked = stack(queries, k, valid)
    assert len(stacked) == len(queries)
    for lane, (got, query) in enumerate(zip(stacked, queries)):
        if valid is not None and not valid[lane]:
            assert got is None
            continue
        want = query.solo(k)
        assert_same_result(want, got, f"lane {lane} vs port solo")
        for key in ("sort_values", "sort_values2"):
            if want[key] is not None:
                np.testing.assert_array_equal(_bits(got[key]),
                                              _bits(want[key]))
        assert_same_result(query.jax_solo(k), got, f"lane {lane} vs jax solo")
    return stacked


AGGS = {"per_hour": {
    "date_histogram": {"field": "ts", "fixed_interval": "1h"},
    "aggs": {"lat_avg": {"avg": {"field": "lat"}}}}}

# name -> (format, [(query builder, request kwargs)], k)
CASES = {
    "score_sort": ("v3", [(sev(s), {"max_hits": 10}) for s in SEVS], 10),
    "column_sort_asc": ("v3", [
        (window(T0 + 600 * i, T0 + 600 * i + 7200),
         {"max_hits": 8, "sort": [("ts", "asc")]}) for i in range(3)], 8),
    "column_sort_desc": ("v3", [
        (window(T0 + 600 * i, T0 + 600 * i + 7200),
         {"max_hits": 8, "sort": [("ts", "desc")]}) for i in range(3)], 8),
    "two_key_sort": ("v3", [
        (sev(s), {"max_hits": 10, "sort": [("lat", "desc"), ("ts", "asc")]})
        for s in SEVS], 10),
    # tenant has 4 values over 300 docs: nearly all ties, so equal doc ids
    # show the tie-breaks are the solo program's
    "tie_breaks": ("v3", [
        (window(T0, T0 + 60 * 400),
         {"max_hits": 12, "sort": [("tenant", "desc")]}),
        (window(T0, T0 + 60 * 400),
         {"max_hits": 12, "sort": [("tenant", "desc")]}),
        (window(T0 + 6000, T0 + 60 * 400),
         {"max_hits": 12, "sort": [("tenant", "desc")]})], 12),
    # each lane keeps its own search_after marker
    "search_after": ("v3", [
        (window(T0, T0 + 60 * 300),
         {"max_hits": 6, "sort": [("ts", "desc")],
          "search_after": [(T0 + 60 * (100 + 50 * i)) * 1_000_000, "s",
                           5 * i]}) for i in range(3)], 6),
    "aggs": ("v3", [(sev(s), {"max_hits": 5, "aggs": AGGS}) for s in SEVS],
             5),
    "count_only_k0": ("v3", [
        (sev(s), {"max_hits": 0,
                  "aggs": {"lat_stats": {"stats": {"field": "lat"}}}})
        for s in SEVS], 0),
    "v2_split": ("v2", [(sev(s), {"max_hits": 10}) for s in SEVS], 10),
    "v1_split": ("v1", [(sev(s), {"max_hits": 10}) for s in SEVS], 10),
}


@pytest.mark.parametrize("case", list(CASES))
def test_stacked_matches_solo(splits, case):
    fmt, specs, k = CASES[case]
    queries = [Query(splits[fmt], build, **kw) for build, kw in specs]
    assert len({q.plan.structure_digest(k) for q in queries}) == 1
    stack_and_compare(queries, k)


def _spy_lanes(monkeypatch) -> list:
    """The lane counts of every `score_topk_lanes` call the executor makes
    (on the CPU the wrapper runs its plain version, which counts no
    launch)."""
    calls = []
    real = t_ex.score_topk_lanes
    monkeypatch.setattr(t_ex, "score_topk_lanes",
                        lambda lanes, k: calls.append(len(lanes))
                        or real(lanes, k))
    return calls


def test_stacked_valid_mask_drops_lane_keeps_survivors(splits, monkeypatch):
    queries = [Query(splits["v3"], sev(s), max_hits=10) for s in SEVS]
    calls = _spy_lanes(monkeypatch)
    stack_and_compare(queries, 10, valid=[True, False, True])
    # the two live lanes share one lane-kernel call; the masked one is not
    # in it
    assert calls == [2]


def test_fused_step_is_one_lane_launch_for_the_group(splits, monkeypatch):
    """A score-sorted term group runs its fused step as ONE
    `score_topk_lanes` call over the live lanes, and no solo `score_topk`
    call; the solo program still runs the step itself."""
    queries = [Query(splits["v3"], sev(s), max_hits=10) for s in SEVS]
    calls = _spy_lanes(monkeypatch)
    solo_calls = []
    monkeypatch.setattr(t_ex, "score_topk",
                        lambda *a: solo_calls.append(a) or st.score_topk(*a))
    stack(queries, 10)
    assert calls == [3] and not solo_calls
    queries[0].solo(10)
    assert calls == [3] and len(solo_calls) == 1


def test_stacked_lane_count_pads_to_bucket(splits):
    queries = [Query(splits["v3"], sev(s), max_hits=5) for s in SEVS]
    stacked = stack_and_compare(queries, 5)
    assert len(stacked) == 3          # surplus pad lanes never surface
    key = t_ex.stacked_program_cache_key([q.plan for q in queries], 5)
    assert key[1] == 4                # 3 lanes bucket to the next pow2
    assert key in t_ex._STACKED_CACHE
    assert [t_ex._batch_bucket(n) for n in (1, 2, 3, 5, 9, 16)] == \
        [1, 2, 4, 8, 16, 16]


def test_stacked_cache_key_mirror_in_lockstep(splits):
    """After a dispatch, `stacked_program_cache_key` is in the live cache,
    and it is the JAX package's key for the same group."""
    queries = [Query(splits["v3"], window(T0, T0 + 7200), max_hits=4),
               Query(splits["v3"], window(T0 + 900, T0 + 9000), max_hits=4)]
    plans = [q.plan for q in queries]
    stack(queries, 4)
    key = t_ex.stacked_program_cache_key(plans, 4)
    assert key in t_ex._STACKED_CACHE
    j_plans = [q.j_plan for q in queries]
    j_ex.readback_plan_stacked(j_ex.dispatch_plan_stacked(
        j_plans, 4, [q.j_arrays for q in queries]))
    assert key == j_ex.stacked_program_cache_key(j_plans, 4)
    assert t_ex.multi_program_cache_key(plans[0], 4, 2) == \
        j_ex.multi_program_cache_key(j_plans[0], 4, 2)


def test_stacked_slot_split_shares_columns_stacks_postings(splits):
    """sev-term lanes read the same fast columns (shared slots) but
    different posting lists (stacked slots), as in the JAX package."""
    queries = [Query(splits["v3"], sev(s), max_hits=5) for s in SEVS]
    plans = [q.plan for q in queries]
    shared, stacked = t_ex.stacked_slot_split(plans)
    assert shared and stacked
    assert sorted(shared + stacked) == list(range(len(plans[0].arrays)))
    keys0 = plans[0].array_keys
    for s in shared:
        assert all(p.array_keys[s] == keys0[s] for p in plans)
    for s in stacked:
        assert any(p.array_keys[s] != keys0[s] for p in plans)
    assert (shared, stacked) == j_ex.stacked_slot_split(
        [q.j_plan for q in queries])


def test_stacked_lanes_read_their_own_tensors_and_stage_nothing(
        splits, monkeypatch):
    """Shared slots are lane 0's tensor, the same object; stacked slots the
    lane's own; nothing is copied into a [Q, ...] stack, and neither a
    stacked nor a convoy call stages a byte."""
    queries = [Query(splits["v3"], sev(s), max_hits=5) for s in SEVS]
    shared, stacked = t_ex.stacked_slot_split([q.plan for q in queries])
    seen = []
    real = t_ex._packed_leaves
    monkeypatch.setattr(t_ex, "_packed_leaves",
                        lambda fn, arrays, *a: seen.append(arrays)
                        or real(fn, arrays, *a))
    staged = STAGING_BYTES_TOTAL.get()
    stack(queries, 5)
    assert len(seen) == 3
    for lane, arrays in enumerate(seen):
        for s in shared:
            assert arrays[s] is queries[0].arrays[s]
        for s in stacked:
            assert arrays[s] is queries[lane].arrays[s]
    windows = [Query(splits["v3"], window(T0 + 300 * i, T0 + 300 * i + 9000),
                     max_hits=5) for i in range(3)]
    t_ex.readback_plan_multi(t_ex.dispatch_plan_multi(
        windows[0].plan, 5, windows[0].arrays,
        [w.plan.scalars for w in windows], device="cpu"))
    assert STAGING_BYTES_TOTAL.get() == staged


def test_convoy_lanes_match_solo(splits):
    """`dispatch_plan_multi`: riders of one plan structure over the SAME
    arrays, differing in their scalars (window bounds), one dispatch; each
    lane equals its solo run and the JAX convoy's lane."""
    windows = [Query(splits["v3"], window(T0 + 300 * i, T0 + 300 * i + 9000),
                     max_hits=5, sort=[("ts", "desc")]) for i in range(3)]
    assert len({tuple(w.plan.array_keys) for w in windows}) == 1
    launches = SEARCH_KERNEL_LAUNCHES_TOTAL.get()
    got = t_ex.readback_plan_multi(t_ex.dispatch_plan_multi(
        windows[0].plan, 5, windows[0].arrays,
        [w.plan.scalars for w in windows], device="cpu"))
    assert SEARCH_KERNEL_LAUNCHES_TOTAL.get() == launches + 1
    j_got = j_ex.readback_plan_multi(j_ex.dispatch_plan_multi(
        windows[0].j_plan, 5, windows[0].j_arrays,
        [w.j_plan.scalars for w in windows]))
    assert len(got) == 3
    for lane, w in enumerate(windows):
        assert_same_result(w.solo(5), got[lane], f"convoy lane {lane}")
        assert_same_result(j_got[lane], got[lane], f"jax convoy lane {lane}")


def test_stacked_program_reused_across_groups(splits):
    """A second same-shape group is one dispatch and no new program: the
    program is keyed on structure and bucket, never on the queries."""
    first = [Query(splits["v3"], sev(s), max_hits=7) for s in SEVS]
    stack_and_compare(first, 7)
    cache_size = len(t_ex._STACKED_CACHE)
    again = [Query(splits["v3"], sev(s), max_hits=7)
             for s in ("ERROR", "INFO", "WARN")]
    launches = SEARCH_KERNEL_LAUNCHES_TOTAL.get()
    stacked = stack(again, 7)
    assert SEARCH_KERNEL_LAUNCHES_TOTAL.get() - launches == 1
    assert len(t_ex._STACKED_CACHE) == cache_size
    assert all(r is not None for r in stacked)


def test_all_lanes_masked_runs_nothing(splits, monkeypatch):
    queries = [Query(splits["v3"], sev(s), max_hits=5) for s in SEVS[:2]]
    calls = _spy_lanes(monkeypatch)
    assert stack(queries, 5, valid=[False, False]) == [None, None]
    assert calls == []


# --- the two JAX stacking faults, against solo runs --------------------------

def _range_aggs(ranges):
    return {"by_tenant": {"range": {"field": "tenant", "ranges": ranges}}}


def test_range_bounds_of_each_lane_are_its_own(splits):
    """Term(sev:ERROR) top-5 with a range agg named the same in both lanes
    and other bounds: the port stacks the bounds slots (its keys carry
    their bytes), the JAX package shares them (keyed by name), and each
    port lane equals its solo run ([86, 23] for lane 1; stacked in the JAX
    package it gets lane 0's [30, 51])."""
    lanes = [[{"to": 1}, {"from": 2}], [{"to": 3}, {"from": 3}]]
    queries = [Query(splits["v3"], sev("ERROR"), fresh_jax_reader=True,
                     max_hits=5, aggs=_range_aggs(r)) for r in lanes]
    plans = [q.plan for q in queries]
    agg = plans[0].aggs[0]
    bound_slots = {agg.froms_slot, agg.tos_slot}
    _, t_stacked = t_ex.stacked_slot_split(plans)
    j_shared, _ = j_ex.stacked_slot_split([q.j_plan for q in queries])
    assert bound_slots <= set(t_stacked)
    assert bound_slots <= set(j_shared)      # the reference's fault
    stacked = stack_and_compare(queries, 5)
    counts = [list(r["aggs"][0]["counts"]) for r in stacked]
    assert counts[1] == [86, 23] and counts[0] != counts[1]


@pytest.fixture(scope="module")
def so_split():
    from quickwit_tpu.index.synthetic import synthetic_stackoverflow_split
    return Split(synthetic_stackoverflow_split(20_000, seed=11), "so")


def test_phrase_slop_of_each_lane_is_its_own(so_split):
    """"t000010 t000011" top-20 at slop 0 and slop 2 in one group: the
    port's phrase keys carry the slop, so lane 1 reads its own postings
    and equals its solo run (96 hits, first docs [3660, 174, 360, 369,
    429]); the JAX group shares lane 0's (27 hits)."""
    from quickwit_tpu.index.synthetic import SO_MAPPER as J_SO
    from quickwit_tpu_torch.index.synthetic import SO_MAPPER as T_SO

    queries = []
    for slop in (0, 2):
        def build(Q, slop=slop):
            return Q.FullText("body", "t000010 t000011", mode="phrase",
                              slop=slop)
        q = Query.__new__(Query)
        q.j_plan, q.j_arrays, _ = j_prepare(
            j_models.SearchRequest(index_ids=["so"], query_ast=build(JQ),
                                   max_hits=20),
            J_SO, so_split.fresh_jax_reader(), "s")
        q.plan, q.arrays, _ = t_prepare(
            t_models.SearchRequest(index_ids=["so"], query_ast=build(TQ),
                                   max_hits=20),
            T_SO, so_split.t_reader, "s", device="cpu")
        queries.append(q)
    assert len({q.plan.structure_digest(20) for q in queries}) == 1
    _, t_stacked = t_ex.stacked_slot_split([q.plan for q in queries])
    j_shared, _ = j_ex.stacked_slot_split([q.j_plan for q in queries])
    ids_slot = queries[0].plan.root.ids_slot
    assert ids_slot in t_stacked and ids_slot in j_shared
    stacked = stack_and_compare(queries, 20)
    assert stacked[1]["count"] == 96 and stacked[0]["count"] == 27
    assert list(stacked[1]["doc_ids"][:5]) == [3660, 174, 360, 369, 429]


# --- grouping rules (QueryGroupPlanner) -------------------------------------

def test_group_key_stacks_distinct_terms_separates_structures(splits):
    plans = [Query(splits["v3"], sev(s), max_hits=5).plan for s in SEVS]
    keys = {QueryGroupPlanner.key_for(p, 5, "s", True) for p in plans}
    assert len(keys) == 1             # distinct terms, one group
    other = Query(splits["v3"], window(T0, T0 + 7200), max_hits=5).plan
    assert QueryGroupPlanner.key_for(other, 5, "s", True) not in keys
    assert QueryGroupPlanner.key_for(plans[0], 5, "s2", True) not in keys


def test_group_key_matches_the_jax_planner(splits):
    queries = [Query(splits["v3"], sev(s), max_hits=5) for s in SEVS]
    for q in queries:
        for stacking in (True, False):
            assert QueryGroupPlanner.key_for(q.plan, 5, "s", stacking) == \
                JPlanner.key_for(q.j_plan, 5, "s", stacking)


def test_group_key_kill_switch_restores_convoy_key(splits):
    """Under QW_DISABLE_QBATCH the key carries the array cache keys again:
    ERROR and INFO (different posting arrays) must NOT share."""
    plans = [Query(splits["v3"], sev(s), max_hits=5).plan
             for s in ("ERROR", "INFO")]
    k_on = {QueryGroupPlanner.key_for(p, 5, "s", True) for p in plans}
    k_off = {QueryGroupPlanner.key_for(p, 5, "s", False) for p in plans}
    assert len(k_on) == 1 and len(k_off) == 2
    assert k_off == {(p.signature(5), tuple(p.array_keys), "s")
                     for p in plans}


def test_group_key_falls_back_without_structure_digest():
    class BarePlan:
        array_keys = ("x",)
        scalars = ()

        def signature(self, k):
            return ("bare", k)

    key = QueryGroupPlanner.key_for(BarePlan(), 3, "s", True)
    assert key == (("bare", 3), ("x",), "s")


def test_incompatible_metric_reasons(splits):
    plan = Query(splits["v3"], sev("ERROR"), max_hits=5).plan
    key = QueryGroupPlanner.key_for(plan, 5, "s", True)
    other = Query(splits["v3"], window(T0, T0 + 7200), max_hits=5).plan
    other_key = QueryGroupPlanner.key_for(other, 5, "s", True)
    full0 = QBATCH_INCOMPATIBLE_TOTAL.get(reason="group_full")
    shape0 = QBATCH_INCOMPATIBLE_TOTAL.get(reason="plan_shape")
    QueryGroupPlanner.note_reject({key: [object()]}, key, True)
    assert QBATCH_INCOMPATIBLE_TOTAL.get(reason="group_full") == full0 + 1
    QueryGroupPlanner.note_reject({other_key: [object()]}, key, True)
    assert QBATCH_INCOMPATIBLE_TOTAL.get(reason="plan_shape") == shape0 + 1
    QueryGroupPlanner.note_reject({key: [object()]}, key, False)
    assert QBATCH_INCOMPATIBLE_TOTAL.get(reason="group_full") == full0 + 1


def test_shared_staging_accounting(splits):
    from quickwit_tpu.search.residency import (
        note_group_shared_staging as j_note)
    queries = [Query(splits["v3"], sev(s), max_hits=5) for s in SEVS]
    plans = [q.plan for q in queries]
    before = QBATCH_SHARED_BYTES_AVOIDED_TOTAL.get()
    hits = RESIDENT_COLUMN_HITS.get()
    saved = note_group_shared_staging(plans, 3)
    shared, _ = t_ex.stacked_slot_split(plans)
    expect = sum(plans[0].arrays[s].nbytes for s in shared) * 2
    assert saved == expect > 0
    assert saved == j_note([q.j_plan for q in queries], 3)
    assert QBATCH_SHARED_BYTES_AVOIDED_TOTAL.get() - before == expect
    assert RESIDENT_COLUMN_HITS.get() - hits == len(shared) * 2
    assert note_group_shared_staging(plans, 1) == 0


# --- the lane kernel's plain version ------------------------------------------

def _lane_inputs(num_lanes, num_postings, seed, num_docs=5_000):
    rng = np.random.RandomState(seed)
    lanes = []
    for q in range(num_lanes):
        ids = np.sort(rng.choice(num_docs, num_postings,
                                 replace=False)).astype(np.int32)
        tfs = rng.randint(0, 5, num_postings).astype(np.int32)
        ids[-7:], tfs[-7:] = num_docs + 3, 0      # a pad tail
        if q == 1:
            tfs[:] = 0                             # an all-invalid lane
        norms = rng.randint(1, 40, num_docs + 1).astype(np.int32)
        lanes.append((ids, tfs, norms, np.float32(1.0 + 0.37 * q),
                      np.float32(8.0 + q)))
    return lanes, num_docs


@pytest.mark.parametrize("k", [10, 64])
def test_lane_plain_version_matches_solo_and_pallas_vmap(k):
    """`score_topk_lanes` on CPU tensors is its plain version: row q equals
    `score_topk_reference` over lane q bit for bit, and the JAX package's
    `jax.vmap(fused_score_topk)` (the stacked program's lane axis, Pallas
    in interpret mode) on its valid winners."""
    lanes, num_docs = _lane_inputs(3, 384, seed=k)
    t_lanes = [(torch.from_numpy(i), torch.from_numpy(t), torch.from_numpy(n),
                idf, avg, num_docs) for i, t, n, idf, avg in lanes]
    vals, idx = st.score_topk_lanes(t_lanes, k)
    assert vals.shape == (3, k) and idx.dtype == torch.int64
    p_vals, p_idx = jax.vmap(functools.partial(
        fused_score_topk, k=k, interpret=True))(
        jnp.asarray(np.stack([i for i, *_ in lanes])),
        jnp.asarray(np.stack([t for _, t, *_ in lanes])),
        jnp.asarray(np.stack([n[np.clip(i, 0, n.shape[0] - 1)]
                              for i, _, n, *_ in lanes])),
        jnp.asarray([idf for *_, idf, _ in lanes], jnp.float32),
        jnp.asarray([avg for *_, avg in lanes], jnp.float32),
        jnp.full((3,), num_docs, jnp.int32))
    for q, lane in enumerate(t_lanes):
        s_vals, s_idx = st.score_topk_reference(*lane, k)
        assert torch.equal(vals[q], s_vals) and torch.equal(idx[q], s_idx)
        ids, tfs = lanes[q][0], lanes[q][1]
        live = min(k, int(((tfs > 0) & (ids < num_docs)).sum()))
        np.testing.assert_array_equal(vals[q].numpy()[:live],
                                      np.asarray(p_vals[q])[:live])
        np.testing.assert_array_equal(idx[q].numpy()[:live],
                                      np.asarray(p_idx[q])[:live])
        assert np.isneginf(vals[q].numpy()[live:]).all()
    assert live >= 0 and np.isneginf(vals[1].numpy()).all()


def test_lane_wrapper_checks_its_lanes():
    lanes, num_docs = _lane_inputs(2, 200, seed=3)
    t_lanes = [(torch.from_numpy(i), torch.from_numpy(t), torch.from_numpy(n),
                idf, avg, num_docs) for i, t, n, idf, avg in lanes]
    with pytest.raises(ValueError):
        st.score_topk_lanes([], 10)
    with pytest.raises(ValueError):
        st.score_topk_lanes(t_lanes * 9, 10)          # 18 > MAX_LANES
    with pytest.raises(ValueError):
        st.score_topk_lanes(t_lanes, st.MAX_K + 1)
    short = (t_lanes[0][0][:50], t_lanes[0][1][:50], *t_lanes[0][2:])
    vals, idx = st.score_topk_lanes([t_lanes[0], short], 10)   # unequal P
    assert torch.equal(vals[1], st.score_topk_reference(*short, 10)[0])
    assert int(idx[1].max()) < 50
