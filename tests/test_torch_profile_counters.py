"""Profile counters the port records as the JAX package does.

- The impact prefix cutoff (`search/plan.py::Lowering._impact_prefix`):
  `tests/test_impact_postings.py`'s three v3 splits (300 docs each, written
  by each package's `SplitWriter`, equal bytes), `body:common` top-10 by
  `_score` through a fresh `SearchService` at `batch_size=1` with the
  unthresholded call's 10th score as the threshold and `profile=True`. Both
  packages' profiles must hold the same `impact_*` counters (3 blocks
  scored, 6 skipped, 6,144 posting bytes never staged, 3 cutoffs), and the
  four `qw_impact_*` metrics must move by the same amounts.
- Hedged storage reads (`storage/wrappers.py::TimeoutAndRetryStorage`):
  a first `get_slice` that sleeps past the attempt's deadline is hedged,
  and a first `get_slice` that fails is retried; each adds one
  `storage_hedged_requests` to the ambient profile in both packages.
"""

import importlib
import threading
import time

import pytest

from test_impact_postings import DOCS_PER_SPLIT, NUM_SPLITS, make_docs
from test_torch_indexing import python_paths  # noqa: F401 - a fixture

PACKAGES = ("quickwit_tpu", "quickwit_tpu_torch")
IMPACT_METRICS = ("IMPACT_BLOCKS_SCORED_TOTAL", "IMPACT_BLOCKS_SKIPPED_TOTAL",
                  "IMPACT_POSTINGS_BYTES_AVOIDED_TOTAL",
                  "IMPACT_PREFIX_CUTOFFS_TOTAL")


def mod(root, path):
    return importlib.import_module(f"{root}.{path}")


def impact_run(root):
    dm = mod(root, "models.doc_mapper")
    models = mod(root, "search.models")
    service_mod = mod(root, "search.service")
    metrics = mod(root, "observability.metrics")
    mapper = dm.DocMapper(
        field_mappings=[
            dm.FieldMapping("ts", dm.FieldType.DATETIME, fast=True,
                            input_formats=("unix_timestamp",)),
            dm.FieldMapping("val", dm.FieldType.I64, fast=True),
            dm.FieldMapping("body", dm.FieldType.TEXT),
            dm.FieldMapping("sev", dm.FieldType.TEXT, tokenizer="raw",
                            fast=True)],
        timestamp_field="ts", default_search_fields=("body",))
    resolver = mod(root, "storage").StorageResolver.for_test()
    uri = "ram:///impact/v3"
    storage = resolver.resolve(uri)
    blobs = []
    for split in range(NUM_SPLITS):
        writer = mod(root, "index.writer").SplitWriter(mapper)
        for doc in make_docs(split):
            writer.add_json_doc(doc)
        blobs.append(writer.finish())
        storage.put(f"s{split}.split", blobs[-1])
    offsets = [models.SplitIdAndFooter(split_id=f"s{s}", storage_uri=uri,
                                       num_docs=DOCS_PER_SPLIT)
               for s in range(NUM_SPLITS)]
    ast = mod(root, "query").parse_query_string("body:common", ["body"])
    kw = {"device": "cpu"} if root == "quickwit_tpu_torch" else {}

    def leaf(threshold=None):
        # a fresh service per call: the leaf cache ignores the threshold
        service = service_mod.SearchService(service_mod.SearcherContext(
            storage_resolver=resolver, batch_size=1, **kw))
        request = models.SearchRequest(
            index_ids=["impact"], query_ast=ast, max_hits=10, profile=True,
            sort_fields=(models.SortField("_score", "desc"),))
        return service.leaf_search(models.LeafSearchRequest(
            search_request=request, index_uid="impact:01",
            doc_mapping=mapper.to_dict(), splits=offsets,
            sort_value_threshold=threshold))

    base = leaf()
    threshold = base.partial_hits[9].sort_value
    before = [getattr(metrics, name).get() for name in IMPACT_METRICS]
    response = leaf(threshold)
    deltas = [getattr(metrics, name).get() - b
              for name, b in zip(IMPACT_METRICS, before)]
    counters = {k: v for k, v in response.profile["counters"].items()
                if k.startswith("impact_")}
    hits = [(h.split_id, h.doc_id, h.sort_value)
            for h in response.partial_hits]
    return blobs, counters, deltas, response.num_hits, hits


def test_impact_prefix_counters_match_jax(python_paths):
    want = impact_run("quickwit_tpu")
    got = impact_run("quickwit_tpu_torch")
    assert got[0] == want[0]  # the same split bytes
    assert got[1] == want[1] == {
        "impact_blocks_scored": 3, "impact_blocks_skipped": 6,
        "impact_postings_bytes_avoided": 6144, "impact_prefix_cutoffs": 3}
    assert got[2] == want[2] == [3, 6, 6144, 3]
    assert got[3:] == want[3:]
    assert got[3] == 900


class FlakyStorage:
    """Wraps a RAM storage; its first `get_slice` sleeps or fails."""

    def __init__(self, underlying, first):
        self.underlying = underlying
        self.uri = underlying.uri
        self.first = first
        self.calls = 0
        self._lock = threading.Lock()

    def get_slice(self, path, start, end):
        with self._lock:
            self.calls += 1
            call = self.calls
        if call == 1 and self.first == "slow":
            time.sleep(0.5)
        elif call == 1:
            raise OSError("first attempt fails")
        return self.underlying.get_slice(path, start, end)


def hedged_read(root, first):
    storage_mod = mod(root, "storage")
    wrappers = mod(root, "storage.wrappers")
    profile_mod = mod(root, "observability.profile")
    ram = storage_mod.StorageResolver.for_test().resolve("ram:///hedge")
    ram.put("f.bin", bytes(range(256)))
    flaky = FlakyStorage(ram, first)
    policy = wrappers.StorageTimeoutPolicy(
        min_throughput_bytes_per_sec=0, timeout_millis=50, max_num_retries=1)
    hedged = wrappers.TimeoutAndRetryStorage(flaky, policy)
    profile = profile_mod.QueryProfile()
    with profile_mod.profile_scope(profile):
        data = hedged.get_slice("f.bin", 10, 20)
    counters = {k: v for k, v in profile.counters().items()
                if k == "storage_hedged_requests"}
    return data, flaky.calls, counters


@pytest.mark.parametrize("first", ["slow", "fails"])
def test_hedged_reads_are_counted_like_jax(first):
    want = hedged_read("quickwit_tpu", first)
    got = hedged_read("quickwit_tpu_torch", first)
    assert got == want
    assert got == (bytes(range(10, 20)), 2,
                   {"storage_hedged_requests": 1})
