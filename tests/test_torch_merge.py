"""The port's split merge against the JAX package's.

`index/merge_arrays.py`: `tests/test_merge_arrays.py`'s heterogeneous
inputs (disjoint and shared terms, positions, missing column values,
ordinal dictionaries that differ per split) are written by each package's
`SplitWriter` (equal bytes) and merged by each package's `merge_splits`:
the merged files must be byte-identical to the JAX Python path's, in
append order and reordered by timestamp, and the port's merged split must
equal a doc-level re-index (term dictionaries, postings, positions,
columns, doc store, footer, search results). Dynamic fields typed
differently per split merge the same way in both.

`indexing/merge.py`: `MergeExecutor` (rows conserved, delete tasks
applied, the array fast path back once deletes are applied), the
`merge.execute`, `merge.reorder` and `merge.publish` faults, and the merge
policies' levels, with the metastore and split files byte-identical to the
JAX package's under the harness's clock and RNG.
"""

import random

import numpy as np
import pytest

from test_torch_indexing import (  # noqa: F401 - python_paths: a fixture
    PACKAGES, WriteEngine, force_python_paths, listed, make_docs,
    python_paths, run_both)


def positional_mapper(e):
    dm = e.dm
    return dm.DocMapper(
        field_mappings=[
            dm.FieldMapping("ts", dm.FieldType.DATETIME, fast=True,
                            input_formats=("unix_timestamp",)),
            dm.FieldMapping("level", dm.FieldType.TEXT, tokenizer="raw",
                            fast=True),
            dm.FieldMapping("score", dm.FieldType.F64, fast=True),
            dm.FieldMapping("body", dm.FieldType.TEXT, record="position"),
        ],
        timestamp_field="ts", default_search_fields=("body",))


def positional_corpora():
    """Three splits' docs (`tests/test_merge_arrays.py::build_inputs`)."""
    rng = np.random.RandomState(7)
    corpora, base = [], 0
    levels_per_split = [["INFO", "WARN"], ["ERROR"],
                        ["DEBUG", "INFO", "TRACE"]]
    for s in range(3):
        docs = []
        for i in range(60 + s * 30):
            levels = levels_per_split[s]
            doc = {"ts": 5000 + base + i,
                   "level": levels[int(rng.randint(len(levels)))],
                   "body": f"alpha beta{'' if i % 3 else ' gamma delta'} "
                           f"word{s}x{i % 5}"}
            if i % 4 != 0:
                doc["score"] = float(rng.rand() * 100)
            docs.append(doc)
        corpora.append(docs)
        base += len(docs)
    return corpora


def shuffled_corpora():
    """Three splits whose timestamps interleave, so the timestamp reorder
    applies (the mapper records no positions)."""
    rng = np.random.RandomState(3)
    corpora = []
    for s in range(3):
        docs = make_docs(70 + 10 * s, start=0)
        for doc in docs:
            doc["ts"] = int(1000 + rng.randint(0, 500))
            doc["body"] += f" split{s}" + (" rare" if doc["ts"] % 7 == 0
                                           else "")
        corpora.append(docs)
    return corpora


def write_readers(e, mapper, corpora, prefix):
    storage = e.storage_mod.StorageResolver.for_test().resolve(
        "ram:///amerge")
    blobs = []
    for s, docs in enumerate(corpora):
        writer = e.writer.SplitWriter(mapper)
        for doc in docs:
            writer.add_json_doc(doc)
        blobs.append(writer.finish())
        storage.put(f"{prefix}{s}.split", blobs[-1])
    readers = [e.reader.SplitReader(storage, f"{prefix}{s}.split")
               for s in range(len(corpora))]
    return storage, readers, blobs


@pytest.fixture(scope="module")
def merged():
    """Per package: (engine, storage, readers, merged bytes by layout)."""
    mp = pytest.MonkeyPatch()
    force_python_paths(mp)
    try:
        out = {}
        for root in PACKAGES:
            e = WriteEngine(root)
            mapper = positional_mapper(e)
            storage, readers, blobs = write_readers(
                e, mapper, positional_corpora(), "p")
            _, sreaders, sblobs = write_readers(
                e, e.mapper, shuffled_corpora(), "s")
            data = {
                "append": e.merge_arrays.merge_splits(readers),
                "reorder_positions": e.merge_arrays.merge_splits(
                    readers, reorder_field="ts"),
                "shuffled_append": e.merge_arrays.merge_splits(sreaders),
                "shuffled_reorder": e.merge_arrays.merge_splits(
                    sreaders, reorder_field="ts"),
            }
            out[root] = (e, mapper, storage, readers, blobs + sblobs, data)
        yield out
    finally:
        mp.undo()


def test_inputs_are_byte_identical(merged):
    assert merged["quickwit_tpu"][4] == merged["quickwit_tpu_torch"][4]


@pytest.mark.parametrize("layout", ["append", "reorder_positions",
                                    "shuffled_append", "shuffled_reorder"])
def test_merged_bytes_equal_jax_python_path(merged, layout):
    want = merged["quickwit_tpu"][5][layout]
    got = merged["quickwit_tpu_torch"][5][layout]
    assert got == want


def test_reorder_applies_only_without_positions(merged):
    data = merged["quickwit_tpu_torch"][5]
    # positions refuse the permute: the reorder falls back to append order
    assert data["reorder_positions"] == data["append"]
    assert data["shuffled_reorder"] != data["shuffled_append"]


def port_pair(merged):
    """The port's array-level merge beside its doc-level re-index."""
    e, mapper, storage, readers, _, data = merged["quickwit_tpu_torch"]
    storage.put("arraylevel.split", data["append"])
    writer = e.writer.SplitWriter(mapper)
    for reader in readers:
        for doc in reader.fetch_docs(list(range(reader.num_docs))):
            writer.add_json_doc(doc)
    storage.put("doclevel.split", writer.finish())
    return (e, mapper, e.reader.SplitReader(storage, "arraylevel.split"),
            e.reader.SplitReader(storage, "doclevel.split"))


def test_term_dicts_and_postings_equal_doc_level(merged):
    _, _, array_reader, doc_reader = port_pair(merged)
    for field in ("body", "level"):
        terms = list(array_reader.term_dict(field).iter_terms())
        assert terms == list(doc_reader.term_dict(field).iter_terms())
        for term, _df in terms:
            ia = array_reader.lookup_term(field, term)
            id_ = doc_reader.lookup_term(field, term)
            ids_a, tfs_a = array_reader.postings(field, ia)
            ids_d, tfs_d = doc_reader.postings(field, id_)
            assert np.array_equal(ids_a[:ia.df], ids_d[:id_.df]), term
            assert np.array_equal(tfs_a[:ia.df], tfs_d[:id_.df]), term


def test_positions_equal_doc_level(merged):
    _, _, array_reader, doc_reader = port_pair(merged)
    for term in ("alpha", "gamma", "delta"):
        ia = array_reader.lookup_term("body", term)
        id_ = doc_reader.lookup_term("body", term)
        offs_a, data_a = array_reader.positions("body", ia)
        offs_d, data_d = doc_reader.positions("body", id_)
        for j in range(ia.df):
            assert np.array_equal(data_a[offs_a[j]:offs_a[j + 1]],
                                  data_d[offs_d[j]:offs_d[j + 1]])


def test_columns_docstore_and_footer_equal_doc_level(merged):
    _, _, array_reader, doc_reader = port_pair(merged)
    n = array_reader.num_docs
    va, pa = array_reader.column_values("score")
    vd, pd = doc_reader.column_values("score")
    assert np.array_equal(pa[:n], pd[:n])
    assert np.array_equal(va[:n][pa[:n] > 0], vd[:n][pd[:n] > 0])
    assert array_reader.column_dict("level") == doc_reader.column_dict("level")
    assert np.array_equal(array_reader.column_ordinals("level")[:n],
                          doc_reader.column_ordinals("level")[:n])
    assert np.array_equal(array_reader.fieldnorm("body")[:n],
                          doc_reader.fieldnorm("body")[:n])
    all_docs = [d for docs in positional_corpora() for d in docs]
    assert array_reader.fetch_docs(list(range(n))) == all_docs
    assert array_reader.footer.time_range == doc_reader.footer.time_range
    assert array_reader.field_meta("body")["avg_len"] == pytest.approx(
        doc_reader.field_meta("body")["avg_len"], rel=1e-12)


def test_search_parity_with_doc_level(merged):
    e, mapper, array_reader, doc_reader = port_pair(merged)
    Q, models = e.Q, e.models
    requests = [
        models.SearchRequest(index_ids=["m"], query_ast=Q.Term("level",
                                                               "INFO"),
                             max_hits=1000),
        models.SearchRequest(index_ids=["m"], query_ast=Q.FullText(
            "body", "gamma delta", "phrase"), max_hits=1000),
        models.SearchRequest(index_ids=["m"], query_ast=Q.MatchAll(),
                             max_hits=7,
                             sort_fields=(models.SortField("ts", "desc"),)),
        models.SearchRequest(index_ids=["m"], query_ast=Q.MatchAll(),
                             max_hits=0,
                             aggs={"lv": {"terms": {"field": "level"}},
                                   "st": {"stats": {"field": "score"}}}),
    ]
    for request in requests:
        ra = e.leaf_search(request, mapper, array_reader, "x")
        rd = e.leaf_search(request, mapper, doc_reader, "x")
        assert ra.num_hits == rd.num_hits
        assert [(h.doc_id, h.raw_sort_value) for h in ra.partial_hits] == \
            [(h.doc_id, h.raw_sort_value) for h in rd.partial_hits]


def test_reordered_split_keeps_every_doc(merged):
    """The timestamp reorder renumbers doc ids: the stored docs are the
    inputs' in ascending timestamp order (stable), and a scored search
    finds the same docs as over the append-order merge."""
    e, _, storage, _, _, data = merged["quickwit_tpu_torch"]
    storage.put("sa.split", data["shuffled_append"])
    storage.put("sr.split", data["shuffled_reorder"])
    append = e.reader.SplitReader(storage, "sa.split")
    reorder = e.reader.SplitReader(storage, "sr.split")
    docs = [d for c in shuffled_corpora() for d in c]
    assert append.fetch_docs(list(range(append.num_docs))) == docs
    assert reorder.fetch_docs(list(range(reorder.num_docs))) == \
        sorted(docs, key=lambda d: d["ts"])
    request = e.request(lambda Q: Q.Term("body", "rare"), max_hits=1000)
    ra = e.leaf_search(request, e.mapper, append, "a")
    rr = e.leaf_search(request, e.mapper, reorder, "r")
    assert ra.num_hits == rr.num_hits > 0
    found_a = sorted(json_key(d) for d in append.fetch_docs(
        [h.doc_id for h in ra.partial_hits]))
    found_r = sorted(json_key(d) for d in reorder.fetch_docs(
        [h.doc_id for h in rr.partial_hits]))
    assert found_a == found_r


def json_key(doc):
    return tuple(sorted(doc.items()))


def test_dynamic_mixed_type_columns_match_jax(python_paths):
    out = {}
    for root in PACKAGES:
        e = WriteEngine(root)
        mapper = e.dm.DocMapper(field_mappings=[], mode="dynamic")
        batches = [[{"mixed": 5, "nums": 1}, {"mixed": 7, "nums": 2}],
                   [{"mixed": "abc", "nums": 2.5}]]
        storage, readers, _ = write_readers(e, mapper, batches, "d")
        data = e.merge_arrays.merge_splits(readers)
        storage.put("m.split", data)
        r = e.reader.SplitReader(storage, "m.split")
        meta = r.field_meta("mixed")
        assert meta["dynamic"] is True and meta["column_kind"] == "ordinal"
        assert sorted(meta["value_classes"]) == ["long", "str"]
        assert r.column_dict("mixed") == ["5", "7", "abc"]
        values, present = r.column_values("nums")
        assert r.field_meta("nums")["column_kind"] == "numeric"
        assert values.dtype == np.float64
        assert values[:3].tolist() == [1.0, 2.0, 2.5]
        assert present[:3].tolist() == [1, 1, 1]
        hits = e.leaf_search(e.request(lambda Q: Q.Term("mixed", "abc"),
                                       max_hits=5), mapper, r, "m")
        assert hits.num_hits == 1
        out[root] = data
    assert out["quickwit_tpu_torch"] == out["quickwit_tpu"]


# --- MergeExecutor ---------------------------------------------------------

def merge_op(e, splits):
    return e.merge.MergeOperation(tuple(splits))


def executor(e, env, **kw):
    return e.merge.MergeExecutor("logs:01", e.mapper, env.metastore,
                                 env.split_storage, **kw)


def scenario_conserves_rows(e, env):
    env.pipeline(e.sources.VecSource(make_docs(300)), target=100) \
        .run_to_completion()
    splits = env.published()
    assert len(splits) == 3
    merged_id = executor(e, env).execute(merge_op(e, splits))
    [split] = env.published()
    assert split.metadata.split_id == merged_id
    assert (split.metadata.num_docs, split.metadata.num_merge_ops) == (300, 1)
    count = env.count(merged_id, lambda Q: Q.Term("tenant", "0"))
    assert count == 100
    return (merged_id, listed(env.splits()), count,
            env.hits(merged_id, lambda Q: Q.Term("body", "common"),
                     max_hits=10))


def scenario_applies_delete_tasks(e, env):
    env.pipeline(e.sources.VecSource(make_docs(90)), target=30) \
        .run_to_completion()
    env.metastore.create_delete_task(
        "logs:01", {"type": "term", "field": "tenant", "value": "1"})
    merged_id = executor(e, env).execute(
        merge_op(e, env.published()),
        delete_tasks=env.metastore.list_delete_tasks("logs:01"))
    [split] = env.published()
    assert (split.metadata.num_docs, split.metadata.delete_opstamp) == (60, 1)
    assert env.count(merged_id, lambda Q: Q.Term("tenant", "1")) == 0
    return merged_id, listed(env.splits())


def scenario_all_docs_deleted(e, env):
    env.pipeline(e.sources.VecSource(make_docs(6)), target=3) \
        .run_to_completion()
    env.metastore.create_delete_task(
        "logs:01", {"type": "bool", "should": [
            {"type": "term", "field": "tenant", "value": str(t)}
            for t in range(3)]})
    result = executor(e, env).execute(
        merge_op(e, env.published()),
        delete_tasks=env.metastore.list_delete_tasks("logs:01"))
    assert result is None and env.published() == []
    return listed(env.splits())


def scenario_fast_path_resumes(e, env, calls):
    env.pipeline(e.sources.VecSource(make_docs(60)), target=20) \
        .run_to_completion()
    env.metastore.create_delete_task(
        "logs:01", {"type": "term", "field": "tenant", "value": "2"})
    tasks = env.metastore.list_delete_tasks("logs:01")
    ex = executor(e, env)
    ex.execute(merge_op(e, env.published()), delete_tasks=tasks)
    published = env.published()
    assert published[0].metadata.delete_opstamp == 1
    before = len(calls)
    ex.execute(merge_op(e, published), delete_tasks=tasks)
    assert len(calls) == before + 1, "array fast path not taken"
    return listed(env.splits())


def test_merge_executor_conserves_rows(python_paths):
    run_both(scenario_conserves_rows)


def test_merge_executor_applies_delete_tasks(python_paths):
    run_both(scenario_applies_delete_tasks)


def test_merge_executor_all_docs_deleted(python_paths):
    run_both(scenario_all_docs_deleted)


def test_merge_fast_path_resumes_after_deletes(python_paths, monkeypatch):
    calls = []
    for root in PACKAGES:
        ma = WriteEngine(root).merge_arrays
        orig = ma.merge_splits

        def spy(readers, _orig=orig, **kw):
            calls.append(len(readers))
            return _orig(readers, **kw)
        monkeypatch.setattr(ma, "merge_splits", spy)
    run_both(scenario_fast_path_resumes, calls)
    assert calls == [1, 1]  # one fast-path merge in each package


# --- merge faults ------------------------------------------------------------

def scenario_publish_fault(e, env):
    """A fault right before the atomic replace leaves every input
    published; the retry conserves rows."""
    env.pipeline(e.sources.VecSource(make_docs(300)), target=100) \
        .run_to_completion()
    inputs = env.published()
    injector = e.faults.FaultInjector(seed=11, rules=[e.faults.FaultRule(
        operation="merge.publish", kind="error", max_fires=1)])
    ex = executor(e, env, fault_injector=injector)
    with pytest.raises(e.faults.InjectedFault):
        ex.execute(merge_op(e, inputs))
    assert {s.metadata.split_id for s in env.published()} == \
        {s.metadata.split_id for s in inputs}
    staged = listed(env.splits("Staged"))
    assert len(staged) == 1
    merged_id = ex.execute(merge_op(e, inputs))
    [final] = env.published()
    assert (final.metadata.split_id, final.metadata.num_docs) == \
        (merged_id, 300)
    return staged, listed(env.splits()), injector.schedule()


def scenario_execute_fault(e, env):
    env.pipeline(e.sources.VecSource(make_docs(200)), target=100) \
        .run_to_completion()
    inputs = env.published()
    injector = e.faults.FaultInjector(seed=5, rules=[e.faults.FaultRule(
        operation="merge.execute", kind="error", max_fires=1)])
    with pytest.raises(e.faults.InjectedFault):
        executor(e, env, fault_injector=injector).execute(
            merge_op(e, inputs))
    assert env.splits("Staged") == []
    assert injector.schedule() == {"merge.execute": [(1, 0, "error")]}
    return listed(env.splits())


def scenario_reorder_fault(e, env):
    """A `merge.reorder` fault degrades the merge to append order: the
    merged split holds every doc, in the inputs' order."""
    docs = make_docs(90)
    for i, doc in enumerate(docs):
        doc["ts"] = 1000 + (i * 37) % 90
    env.pipeline(e.sources.VecSource(docs), target=30).run_to_completion()
    inputs = env.published()
    injector = e.faults.FaultInjector(seed=2, rules=[e.faults.FaultRule(
        operation="merge.reorder", kind="error", max_fires=1)])
    merged_id = executor(e, env, fault_injector=injector).execute(
        merge_op(e, inputs))
    reader = env.open(merged_id)
    stored = reader.fetch_docs(list(range(reader.num_docs)))
    by_split = [env.open(s.metadata.split_id) for s in inputs]
    assert stored == [d for r in by_split
                      for d in r.fetch_docs(list(range(r.num_docs)))]
    return merged_id, listed(env.splits()), injector.schedule()


@pytest.mark.parametrize("scenario", [scenario_publish_fault,
                                      scenario_execute_fault,
                                      scenario_reorder_fault],
                         ids=["publish", "execute", "reorder"])
def test_merge_fault_matches_jax(scenario, python_paths):
    run_both(scenario)


# --- policies ----------------------------------------------------------------

def policy_outcome(e):
    md = e.split_md
    state = md.SplitState.PUBLISHED
    policy = e.merge.StableLogMergePolicy(merge_factor=3, max_merge_factor=3,
                                          min_level_num_docs=100)
    small = [md.Split(md.SplitMetadata(f"s{i}", "x:01", num_docs=50), state)
             for i in range(7)]
    wide = e.merge.StableLogMergePolicy(merge_factor=3, max_merge_factor=12,
                                        min_level_num_docs=100)
    big = [md.Split(md.SplitMetadata(f"b{i}", "x:01", num_docs=20_000_000),
                    state) for i in range(5)]
    rng = random.Random(4)
    mixed = [md.Split(md.SplitMetadata(
        f"m{i:02d}", "x:01", num_docs=rng.choice([50, 500, 5_000, 50_000]),
        partition_id=i % 2), state) for i in range(40)]
    ops = {
        "small": policy.operations(small),
        "wide": wide.operations(small),
        "big": policy.operations(big),
        "mixed": policy.operations(mixed),
        "nop": e.merge.merge_policy_from_config({"type": "nop"})
        .operations(small),
        "config": e.merge.merge_policy_from_config(
            {"merge_factor": 4, "max_merge_factor": 4,
             "split_num_docs_target": 1_000_000}).operations(mixed),
    }
    with pytest.raises(ValueError):
        e.merge.merge_policy_from_config({"type": "weird"})
    return {k: [op.split_ids for op in v] for k, v in ops.items()}


def test_merge_policy_levels_match_jax():
    want = policy_outcome(WriteEngine("quickwit_tpu"))
    got = policy_outcome(WriteEngine("quickwit_tpu_torch"))
    assert got == want
    assert [len(ids) for ids in got["small"]] == [3, 3]
    assert [len(ids) for ids in got["wide"]] == [7]
    assert got["big"] == [] and got["nop"] == []
    assert got["mixed"]
