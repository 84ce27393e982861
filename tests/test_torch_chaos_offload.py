"""Seeded chaos suite for the port's offload pool, against the JAX package.

`tests/test_chaos_offload.py`'s cases run against the port: a leaf
SearchService on the CPU whose cold-split tail fans out over four
in-process workers (each on the CPU), with faults injected at the
`offload.dispatch@<worker>` point (common/faults.py): a worker dying
mid-query loses no splits, an injected straggler is cut off by a hedge,
typed backpressure surfaces as a whole-query 429, and with every worker
dead the query completes through the local fallback. Then both packages
over the same split bytes: the unfaulted answers are equal, and the same
seed gives the same per-occurrence fault decisions in each package.

Deterministic and fast (marked `chaos`, runs in tier-1)."""

import random
import time

import pytest

from quickwit_tpu_torch.common import clock
from quickwit_tpu_torch.common.faults import FaultInjector, FaultRule
from quickwit_tpu_torch.indexing import IndexingPipeline, PipelineParams, VecSource
from quickwit_tpu_torch.metastore import FileBackedMetastore
from quickwit_tpu_torch.metastore.base import ListSplitsQuery
from quickwit_tpu_torch.models import DocMapper, FieldMapping, FieldType
from quickwit_tpu_torch.models import split_metadata
from quickwit_tpu_torch.models.index_metadata import (
    IndexConfig, IndexMetadata, SourceConfig,
)
from quickwit_tpu_torch.query import parse_query_string
from quickwit_tpu_torch.search.models import (
    LeafSearchRequest, SearchRequest, SplitIdAndFooter,
)
from quickwit_tpu_torch.search.service import (
    LocalSearchClient, SearcherContext, SearchService,
)
from quickwit_tpu_torch.serve.rest import classify_exception
from quickwit_tpu_torch.storage import StorageResolver
from quickwit_tpu_torch.tenancy.registry import TenantRateLimited

pytestmark = pytest.mark.chaos

MAPPER = DocMapper(
    field_mappings=[
        FieldMapping("ts", FieldType.DATETIME, fast=True,
                     input_formats=("unix_timestamp",)),
        FieldMapping("body", FieldType.TEXT),
    ],
    timestamp_field="ts",
    default_search_fields=("body",),
)

NUM_SPLITS = 6
DOCS_PER_SPLIT = 100
DEADLINE_SLACK_SECS = 1.6
WORKER_IDS = ("ow-0", "ow-1", "ow-2", "ow-3")
CORPUS_SEED = 17


@pytest.fixture(scope="module")
def corpus():
    resolver = StorageResolver.for_test()
    metastore = FileBackedMetastore(resolver.resolve("ram:///olchaos/ms"))
    split_uri = "ram:///olchaos/splits"
    config = IndexConfig(index_id="olchaos", index_uri=split_uri,
                         doc_mapper=MAPPER, split_num_docs_target=100)
    metastore.create_index(IndexMetadata(
        index_uid="olchaos:01", index_config=config,
        sources={"src": SourceConfig("src", "vec")}))
    docs = [{"ts": 1_700_000_000 + i, "body": f"event {i} common"}
            for i in range(NUM_SPLITS * DOCS_PER_SPLIT)]
    pipeline = IndexingPipeline(
        PipelineParams(index_uid="olchaos:01", source_id="src",
                       split_num_docs_target=100, batch_num_docs=50),
        MAPPER, VecSource(docs), metastore, resolver.resolve(split_uri))
    # split ids are (wall time, seeded draw): a fixed time prefix and a
    # seeded draw give the same ids, and so the same rendezvous placement
    # over the workers, in every run (both packages read these files)
    with pytest.MonkeyPatch.context() as mp, \
            clock.use_rng(random.Random(CORPUS_SEED)):
        mp.setattr(split_metadata, "wall_time", lambda: 1_700_000_000.0)
        pipeline.run_to_completion()
    splits = [SplitIdAndFooter(split_id=s.metadata.split_id,
                               storage_uri=split_uri,
                               num_docs=s.metadata.num_docs)
              for s in metastore.list_splits(ListSplitsQuery())]
    assert len(splits) == NUM_SPLITS
    return resolver, splits


class _SheddingClient:
    def leaf_search(self, request):
        raise TenantRateLimited("acme", "qps", 0.5)


def build_service(corpus, injector=None, worker_overrides=None,
                  **offload_extra):
    """A leaf service whose ENTIRE split set offloads (max_local_splits=0)
    to four in-process workers sharing the corpus storage; per-worker
    faults inject at the dispatcher's `offload.dispatch@<id>` point."""
    resolver, _ = corpus
    worker_overrides = worker_overrides or {}

    def factory(worker_id):
        override = worker_overrides.get(worker_id)
        if override is not None:
            return override
        return LocalSearchClient(SearchService(
            SearcherContext(resolver, prefetch=False, device="cpu"),
            node_id=worker_id))

    context = SearcherContext(
        resolver, prefetch=False, device="cpu",
        offload={"endpoints": list(WORKER_IDS), "max_local_splits": 0,
                 "task_splits": 1, "hedge_min_delay_secs": 0.05,
                 "fault_injector": injector, **offload_extra},
        offload_client_factory=factory)
    return SearchService(context, node_id="olchaos-main")


def leaf_request(splits, timeout_millis=20_000):
    return LeafSearchRequest(
        search_request=SearchRequest(
            index_ids=["olchaos"],
            query_ast=parse_query_string("body:common"),
            max_hits=5, timeout_millis=timeout_millis),
        index_uid="olchaos:01", doc_mapping=MAPPER.to_dict(),
        splits=splits, deadline_millis=timeout_millis)


def test_unfaulted_pool_serves_every_split(corpus):
    _, splits = corpus
    response = build_service(corpus).leaf_search(leaf_request(splits))
    assert response.num_successful_splits == NUM_SPLITS
    assert response.num_hits == NUM_SPLITS * DOCS_PER_SPLIT
    assert not response.failed_splits


def test_worker_death_mid_query_loses_no_splits(corpus):
    # one worker's every dispatch errors: its tasks must re-land on the
    # next-ranked workers, matching the unfaulted run split-for-split,
    # inside the deadline
    _, splits = corpus
    injector = FaultInjector(seed=7, rules=[
        FaultRule("offload.dispatch@ow-1", "error"),
    ])
    service = build_service(corpus, injector=injector)
    t0 = time.monotonic()
    response = service.leaf_search(leaf_request(splits))
    assert time.monotonic() - t0 < 20.0 + DEADLINE_SLACK_SECS
    assert response.num_successful_splits == NUM_SPLITS
    assert response.num_hits == NUM_SPLITS * DOCS_PER_SPLIT
    assert not response.failed_splits
    pool = service.context.offload_pool()
    assert pool.snapshot()["ow-1"]["failures"] >= 1


def test_injected_straggler_recovered_by_hedge(corpus):
    # every dispatch on one worker stalls 3s; the hedge (p95-driven, min
    # 50ms here) must duplicate the straggling task elsewhere and answer
    # far inside both the stall and the deadline
    _, splits = corpus
    injector = FaultInjector(seed=3, rules=[
        FaultRule("offload.dispatch@ow-2", "hang", hang_secs=3.0),
    ])
    service = build_service(corpus, injector=injector)
    t0 = time.monotonic()
    response = service.leaf_search(leaf_request(splits,
                                                timeout_millis=10_000))
    elapsed = time.monotonic() - t0
    assert elapsed < 3.0, "hedge never cut off the injected straggler"
    assert response.num_successful_splits == NUM_SPLITS
    assert response.num_hits == NUM_SPLITS * DOCS_PER_SPLIT


def test_worker_429_surfaces_as_whole_query_429(corpus):
    # a worker under tenant rate limiting answers typed backpressure: the
    # query must fail as a 429 — NOT fall back to local execution, which
    # would launder the remote admission decision
    _, splits = corpus
    service = build_service(
        corpus, worker_overrides={w: _SheddingClient() for w in WORKER_IDS})
    with pytest.raises(TenantRateLimited) as info:
        service.leaf_search(leaf_request(splits))
    assert classify_exception(info.value) == 429


def test_every_worker_dead_falls_back_to_local_execution(corpus):
    # generic (non-429) failure everywhere: the splits still belong to the
    # query — the service runs them locally and the response is complete
    _, splits = corpus
    injector = FaultInjector(seed=11, rules=[
        FaultRule("offload.dispatch@*", "error"),
    ])
    service = build_service(corpus, injector=injector)
    t0 = time.monotonic()
    response = service.leaf_search(leaf_request(splits))
    assert time.monotonic() - t0 < 20.0 + DEADLINE_SLACK_SECS
    assert response.num_successful_splits == NUM_SPLITS
    assert response.num_hits == NUM_SPLITS * DOCS_PER_SPLIT
    assert not response.failed_splits


def test_same_seed_same_per_occurrence_fault_decisions(corpus):
    # hedging/stealing make the NUMBER of dispatches timing-dependent, but
    # the injector's decision for the k-th dispatch to a given worker must
    # be identical across runs (the blake2b per-(seed, op, occurrence)
    # contract) — and every run must still serve all splits
    _, splits = corpus
    rules = [FaultRule("offload.dispatch@*", "error", probability=0.5)]

    def run():
        injector = FaultInjector(seed=1234, rules=rules)
        service = build_service(corpus, injector=injector)
        response = service.leaf_search(leaf_request(splits))
        return injector.schedule(), response.num_successful_splits

    schedule_a, served_a = run()
    schedule_b, served_b = run()
    assert served_a == served_b == NUM_SPLITS
    assert schedule_a, "seeded rules never fired — the run tested nothing"
    for op in set(schedule_a) & set(schedule_b):
        shared = min(len(schedule_a[op]), len(schedule_b[op]))
        assert schedule_a[op][:shared] == schedule_b[op][:shared], op


# --- both packages over the same split bytes ----------------------------------


def jax_service(corpus, injector=None):
    """The JAX package's `build_service` (with a JAX `FaultInjector`)
    over a copy of the port's split files (the JAX reader reads the port
    writer's bytes)."""
    from quickwit_tpu.search.service import (
        LocalSearchClient as JClient, SearcherContext as JContext,
        SearchService as JService)
    from quickwit_tpu.storage import StorageResolver as JResolver
    resolver, splits = corpus
    jresolver = JResolver.for_test()
    source = resolver.resolve(splits[0].storage_uri)
    target = jresolver.resolve(splits[0].storage_uri)
    for split in splits:
        name = f"{split.split_id}.split"
        target.put(name, source.get_all(name))

    def factory(worker_id):
        return JClient(JService(JContext(jresolver, prefetch=False),
                                node_id=worker_id))

    context = JContext(
        jresolver, prefetch=False,
        offload={"endpoints": list(WORKER_IDS), "max_local_splits": 0,
                 "task_splits": 1, "hedge_min_delay_secs": 0.05,
                 "fault_injector": injector},
        offload_client_factory=factory)
    return JService(context, node_id="olchaos-main"), injector


def jax_leaf_request(splits, timeout_millis=20_000):
    from quickwit_tpu.query import parse_query_string as j_parse
    from quickwit_tpu.search.models import (
        LeafSearchRequest as JLeafRequest, SearchRequest as JRequest,
        SplitIdAndFooter as JSplit)
    return JLeafRequest(
        search_request=JRequest(
            index_ids=["olchaos"], query_ast=j_parse("body:common"),
            max_hits=5, timeout_millis=timeout_millis),
        index_uid="olchaos:01", doc_mapping=MAPPER.to_dict(),
        splits=[JSplit(split_id=s.split_id, storage_uri=s.storage_uri,
                       num_docs=s.num_docs) for s in splits],
        deadline_millis=timeout_millis)


def answer(response):
    return (response.num_hits, response.num_successful_splits,
            [(h.split_id, h.doc_id, h.sort_value)
             for h in response.partial_hits],
            [e.split_id for e in response.failed_splits])


def test_unfaulted_answers_equal_the_jax_package(corpus):
    _, splits = corpus
    port = build_service(corpus).leaf_search(leaf_request(splits))
    jax_svc, _ = jax_service(corpus)
    want = jax_svc.leaf_search(jax_leaf_request(splits))
    assert answer(port) == answer(want)
    assert port.resource_stats["num_splits_offloaded"] == NUM_SPLITS
    assert want.resource_stats["num_splits_offloaded"] == NUM_SPLITS


def test_same_seed_same_fault_decisions_across_packages(corpus):
    # the k-th dispatch to a given worker gets the same decision in each
    # package (the blake2b per-(seed, op, occurrence) contract), and each
    # package still answers every split, equally
    _, splits = corpus
    rules = [FaultRule("offload.dispatch@*", "error", probability=0.5)]
    injector = FaultInjector(seed=1234, rules=rules)
    port = build_service(corpus, injector=injector).leaf_search(
        leaf_request(splits))
    from quickwit_tpu.common.faults import FaultInjector as JInjector
    from quickwit_tpu.common.faults import FaultRule as JRule
    jax_svc, jax_injector = jax_service(corpus, JInjector(seed=1234, rules=[
        JRule("offload.dispatch@*", "error", probability=0.5)]))
    want = jax_svc.leaf_search(jax_leaf_request(splits))
    assert answer(port) == answer(want)
    assert port.num_successful_splits == NUM_SPLITS
    port_schedule, jax_schedule = injector.schedule(), jax_injector.schedule()
    assert port_schedule and jax_schedule
    for op in set(port_schedule) & set(jax_schedule):
        shared = min(len(port_schedule[op]), len(jax_schedule[op]))
        assert port_schedule[op][:shared] == jax_schedule[op][:shared], op
