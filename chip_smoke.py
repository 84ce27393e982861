"""Drive the PyTorch/CUDA port's single-split leaf search on one NVIDIA GPU.

    python3 chip_smoke.py [--docs N] [--iters N]

Phases, each of which fails the run (non-zero exit) when it fails:

1. build  : compile every CUDA kernel of the path from `quickwit_tpu_torch/
            csrc/` with nvcc (all sources at once), and print the seconds
            and what ptxas reports per kernel (registers, shared memory,
            spills).
2. kernels: hold each kernel against its plain torch version on the card, at
            the slice's shape and at the edge cases (ties across the whole
            persistent grid, scores rising with the index, misaligned
            views, 200 calls back to back, two streams at once); valid
            winners must be exact, and each call must launch once.
3. split  : build a hdfs-logs split with the port's own generator (10M docs,
            seed 7 by default, the reference's split size).
4. slice  : run `leaf_search_single_split` on `cuda` for the flagship request
            (Term severity_text:ERROR, top-10 by BM25, date_histogram 1d,
            terms severity_text) and a body-term top-10. The kernel launch
            counters are zeroed just before and read just after; every
            kernel of the path must have launched (score_topk once per
            query). Then the doc-space requests, with the counters zeroed
            again, none of which may launch score_topk:
            - c2_bool_range_top100 (`bench.py`'s c2: Bool of a scoring MUST
              term, two SHOULD body terms and a timestamp range FILTER);
            - c2 sorted by timestamp desc then tenant_id asc, top-100, and
              its page 2 by `search_after` on the 100th hit, which must
              equal hits 101-200 of a top-200 run;
            - body_top10 with the top-k threshold pushed down at its own
              10th score (posting space, impact block-max), whose hits must
              equal the run without it;
            - c2's predicate through `compute_packed_mask`, then a
              filter-only request sorted by timestamp with that mask as
              `mask_override`, equal to the request without it.
            Each response must equal the port's own `device="cpu"` run on
            the same split, with num_hits > 0 and bucket counts summing to
            num_hits where there are aggregations.
5. aggs   : the aggregation requests, with the counters zeroed again: an
            otel-traces split from the port's generator (10M docs, the
            same seed) and a 20,000-doc split written by the port's
            SplitWriter (multivalued raw tags, a FOR-packed u64) beside the
            hdfs split. First the aggregation reductions over 10M rows
            (bucket sums past the compare limit, minima, maxima, sketches,
            HLL registers), twice on the card, against their CPU run. Then
            each request twice on `cuda` and once on the CPU:
            - c5_otel_percentiles_1split: MatchAll, percentiles of
              span_duration_micros (BASELINE config 5 on one split);
            - otel_latency_by_service: terms(service_name) with
              percentiles, extended_stats and cardinality of the duration,
              and date_histogram 1m with its avg and max;
            - flagship_bucket_metrics: the flagship's Term top-10 with
              stats and percentiles of tenant_id per day and max(timestamp)
              per severity; it must launch score_topk once per call;
            - c2_aggs: c2's Bool root, top-100, with cardinality(tenant_id),
              three overlapping timestamp ranges (sum and cardinality of
              tenant_id in each) and a composite (severity_text, day) of
              20 with avg(tenant_id) and a terms(tenant_id) child, then its
              page 2 through `after`;
            - mv_tags: a Range on the packed u64 with terms(tags), and the
              stats and cardinality of the packed u64.
            The two cuda calls must give the same bytes; the cuda response
            must equal the CPU's (f64 sums to rtol 1e-12, everything else
            exactly).
6. timing : for flagship, body_top10, c2 and the three timed aggregation
            requests: warm p50/p90 of the whole leaf call, its phases (plan,
            stage, execute), a profiler window (device busy share, ops per
            call, the top device ops by time; Chrome traces go to
            chip_traces/); and per kernel: its time by CUDA events (L2
            flushed before every launch), the same launches replayed from a
            CUDA graph, the plain version's time, the nearest library call,
            its bound, and the floor set by the 32-byte sectors that its
            norm gather touches.

Its last lines are the card's name and power limit, one JSON object with a
row per kernel, and `{"ok": true, "device": {...}}`. Without a GPU, or
without the rest of the repository beside it, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import statistics
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12      # f32 outside the tensor cores
L2_FLUSH_BYTES = 256 << 20      # > the 50 MB L2


def gpu_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def say(*parts) -> None:
    print(*parts, flush=True)


# --------------------------------------------------------------------------
# phase 1: build

def build_kernels(build_mod) -> dict[str, float]:
    """Compile every kernel source concurrently; returns seconds each."""
    from concurrent.futures import ThreadPoolExecutor
    names = sorted(p.stem for p in build_mod.CSRC.glob("*.cu"))
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(build_mod.load, names))
    return {name: build_mod.BUILD_SECONDS[name] for name in names}


def print_ptxas(build_mod, names) -> None:
    """Each kernel's ptxas lines: entry function, registers, shared memory,
    stack frame and spills."""
    for name in names:
        for line in build_mod.ptxas_report(name).splitlines():
            if line.strip() and ("ptxas" in line or "spill" in line):
                say(f"ptxas {name}: {line.strip()}")


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions

def score_topk_case(torch, num_postings, seed, num_docs, *, all_invalid=False,
                    equal_scores=False, ascending=False, invalid_head=0):
    """Random sorted posting ids with a pad tail (ids past num_docs, tf 0).
    `ascending`: posting i is doc i with tf 1 and a norm that falls as i
    rises, so every posting outscores the one before it. `invalid_head`:
    the first postings have tf 0, so the winners start mid-list."""
    import numpy as np
    rng = np.random.RandomState(seed)
    if ascending:
        ids = np.arange(num_postings, dtype=np.int32)
    else:
        ids = np.sort(rng.choice(num_docs, num_postings,
                                 replace=False)).astype(np.int32)
    tfs = rng.randint(1, 5, num_postings).astype(np.int32)
    norms = rng.randint(1, 50, num_docs + 1).astype(np.int32)
    pad = min(64, num_postings - 1)
    if pad > 0:
        tfs[-pad:] = 0
        ids[-pad:] = num_docs + 7
    if equal_scores:
        tfs[tfs > 0] = 1
        norms[:] = 7
    if ascending:
        tfs[tfs > 0] = 1
        norms[:num_postings] = np.arange(num_postings, 0, -1)
    tfs[:invalid_head] = 0
    if all_invalid:
        ids[:] = num_docs + 7
        tfs[:] = 0
    return (torch.from_numpy(ids), torch.from_numpy(tfs),
            torch.from_numpy(norms), np.float32(2.17), np.float32(9.3))


def compare_winners(torch, got, want, num_valid: int, k: int) -> float:
    """max |Δ| over valid winners; raises unless values and indices are
    exact there and both sides are -inf past them."""
    g_vals, g_idx = (t.cpu() for t in got)
    w_vals, w_idx = (t.cpu() for t in want)
    live = min(num_valid, k)
    if not torch.equal(g_idx[:live], w_idx[:live]):
        raise AssertionError(f"indices differ: {g_idx[:live].tolist()} vs "
                             f"{w_idx[:live].tolist()}")
    if not torch.equal(g_vals[:live], w_vals[:live]):
        raise AssertionError("values differ")
    if not (torch.isneginf(g_vals[live:]).all()
            and torch.isneginf(w_vals[live:]).all()):
        raise AssertionError("dead lanes are not -inf")
    if live == 0:
        return 0.0
    return float((g_vals[:live].double() - w_vals[:live].double())
                 .abs().max())


def misaligned(torch, t, shift: int):
    """A contiguous view of `t`'s values that starts `shift` int32 elements
    past a 16-byte boundary."""
    base = torch.empty(t.shape[0] + 4, dtype=t.dtype, device=t.device)
    view = base[shift:shift + t.shape[0]]
    view.copy_(t)
    return view


def check_score_topk(torch, kernels, dev) -> float:
    st = kernels
    num_docs = 10_000_000
    cases = {
        "slice_1M_k10": (dict(num_postings=1_000_000, seed=1), 10),
        "1024_k10": (dict(num_postings=1024, seed=1024), 10),
        "4096_k5": (dict(num_postings=4096, seed=4096), 5),
        "5000_k10": (dict(num_postings=5000, seed=5000), 10),
        "all_invalid": (dict(num_postings=1024, seed=3, all_invalid=True), 3),
        "equal_scores": (dict(num_postings=100_000, seed=9,
                              equal_scores=True), 10),
        "k64": (dict(num_postings=200_000, seed=64), 64),
        "p1": (dict(num_postings=1, seed=2), 1),
        "p3_k10": (dict(num_postings=3, seed=4), 10),
        "tile_plus_one": (dict(num_postings=4097, seed=5), 10),
        # ties across every block of the grid; winners start mid-tile
        "ties_1M_head_k10": (dict(num_postings=1_000_000, seed=11,
                                  equal_scores=True, invalid_head=300_001),
                             10),
        "ties_1M_k64": (dict(num_postings=1_000_000, seed=12,
                             equal_scores=True), 64),
        # every posting beats the threshold
        "ascending_1M_k10": (dict(num_postings=1_000_000, seed=13,
                                  ascending=True), 10),
        "ascending_1M_k64": (dict(num_postings=1_000_000, seed=14,
                                  ascending=True), 64),
        # ids and tfs views 4 and 12 bytes past a 16-byte boundary
        "misaligned_1M_k10": (dict(num_postings=1_000_001, seed=15), 10),
        "misaligned_5001_k33": (dict(num_postings=5001, seed=16), 33),
    }
    worst = 0.0
    for name, (spec, k) in cases.items():
        ids, tfs, norms, idf, avg = score_topk_case(torch, num_docs=num_docs,
                                                    **spec)
        num_valid = int(((tfs > 0) & (ids < num_docs)).sum())
        ids, tfs, norms = ids.to(dev), tfs.to(dev), norms.to(dev)
        if name.startswith("misaligned"):
            ids, tfs = misaligned(torch, ids, 1), misaligned(torch, tfs, 3)
            if (ids.data_ptr() % 16, tfs.data_ptr() % 16) != (4, 12):
                raise AssertionError(f"{name}: views are not misaligned")
        before = st.score_topk.launches
        got = st.score_topk(ids, tfs, norms, idf, avg, num_docs, k)
        if st.score_topk.launches != before + 1:
            raise AssertionError(f"{name}: {st.score_topk.launches - before} "
                                 "launches for one call")
        want = st.score_topk_reference(ids, tfs, norms, idf, avg, num_docs, k)
        torch.cuda.synchronize()
        if not ((got[1] >= 0) & (got[1] < ids.shape[0])).all():
            raise AssertionError(f"{name}: index out of range")
        err = compare_winners(torch, got, want, num_valid, k)
        worst = max(worst, err)
        say(f"kernel score_topk {name}: P={ids.shape[0]} k={k} "
            f"valid={num_valid} max_abs_err={err} indices_equal=True")

    # 200 calls back to back on one stream: the kernel's grid state (ticket,
    # candidate count, published k-th pair) must come back to 0 after every
    # launch, or a later call merges too early or filters too much
    ids, tfs, norms, idf, avg = score_topk_case(torch, 1_000_000, 21,
                                                num_docs)
    ids, tfs, norms = ids.to(dev), tfs.to(dev), norms.to(dev)
    num_valid = int(((tfs > 0) & (ids < num_docs)).sum())
    want = st.score_topk_reference(ids, tfs, norms, idf, avg, num_docs, 10)
    outs = [st.score_topk(ids, tfs, norms, idf, avg, num_docs, 10)
            for _ in range(200)]
    torch.cuda.synchronize()
    for got in outs:
        compare_winners(torch, got, want, num_valid, 10)
    say("kernel score_topk back_to_back: 200 calls on one stream, all equal "
        "to the plain version")

    # a second stream at once with the default one: each has its workspace
    o_ids, o_tfs, o_norms, o_idf, o_avg = score_topk_case(torch, 600_000, 22,
                                                          num_docs)
    other = (o_ids.to(dev), o_tfs.to(dev), o_norms.to(dev), o_idf, o_avg)
    other_valid = int(((o_tfs > 0) & (o_ids < num_docs)).sum())
    other_want = st.score_topk_reference(*other, num_docs, 64)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    pairs = []
    for _ in range(20):
        with torch.cuda.stream(side):
            b = st.score_topk(*other, num_docs, 64)
        a = st.score_topk(ids, tfs, norms, idf, avg, num_docs, 10)
        pairs.append((a, b))
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    for a, b in pairs:
        compare_winners(torch, a, want, num_valid, 10)
        compare_winners(torch, b, other_want, other_valid, 64)
    say("kernel score_topk two_streams: 20 pairs of calls on the default "
        "and a second stream, all equal to the plain version")
    return worst


# --------------------------------------------------------------------------
# phases 3-4: split and slice

def hdfs_requests(SearchRequest, Term, body_term):
    aggs = {"over_time": {"date_histogram": {"field": "timestamp",
                                             "fixed_interval": "1d"}},
            "severities": {"terms": {"field": "severity_text", "size": 10}}}
    return {
        "flagship": SearchRequest(index_ids=["hdfs-logs"],
                                  query_ast=Term("severity_text", "ERROR"),
                                  max_hits=10, aggs=aggs),
        "body_top10": SearchRequest(index_ids=["hdfs-logs"],
                                    query_ast=Term("body", body_term(3)),
                                    max_hits=10),
    }


def doc_space_requests(SearchRequest, SortField, Bool, Range, RangeBound,
                       Term, body_term):
    """`bench.py`'s c2_bool_range_top100, and c2's query under a two-key
    sort (timestamp desc, tenant_id asc) at top-100 and top-200."""
    day_us = 86400 * 1_000_000
    t0_us = 1_600_000_000 * 1_000_000
    c2 = Bool(
        must=(Term("severity_text", "ERROR"),),
        should=(Term("body", body_term(3)), Term("body", body_term(7))),
        filter=(Range("timestamp", lower=RangeBound(t0_us + day_us, True),
                      upper=RangeBound(t0_us + 4 * day_us, False)),))
    two_keys = (SortField("timestamp", "desc"), SortField("tenant_id", "asc"))
    return {
        "c2_bool_range_top100": SearchRequest(
            index_ids=["hdfs-logs"], query_ast=c2, max_hits=100),
        "c2_ts_tenant_top100": SearchRequest(
            index_ids=["hdfs-logs"], query_ast=c2, max_hits=100,
            sort_fields=two_keys),
        "c2_ts_tenant_top200": SearchRequest(
            index_ids=["hdfs-logs"], query_ast=c2, max_hits=200,
            sort_fields=two_keys),
        "c2_by_timestamp": SearchRequest(
            index_ids=["hdfs-logs"], query_ast=c2, max_hits=100,
            sort_fields=(SortField("timestamp", "desc"),)),
    }


def hit_key(resp):
    return [(h.split_id, h.doc_id, h.sort_value, h.raw_sort_value,
             h.sort_value2, h.raw_sort_value2) for h in resp.partial_hits]


def response_key(resp):
    import numpy as np
    hits = hit_key(resp)
    aggs = {name: {k: (v.dtype.str, v.tolist()) if isinstance(v, np.ndarray)
                   else v for k, v in state.items()}
            for name, state in resp.intermediate_aggs.items()}
    return resp.num_hits, hits, json.dumps(aggs, sort_keys=True, default=str)


def run_split(leaf, mapper, req, reader, dev, threshold=None, mask=None):
    """One split through the staged entry points, as a leaf service drives
    it: lower (with a pushed-down threshold or a cached predicate mask),
    stage, execute. Returns (plan, response)."""
    extra = {} if mask is None else {"mask_override": mask,
                                     "mask_key": "mask.c2"}
    plan = leaf.prepare_plan_only(req, mapper, reader, "split-0",
                                  sort_value_threshold=threshold, **extra)
    arrays, _ = leaf.warmup_device_arrays(reader, plan, dev)
    return plan, leaf.execute_prepared_split(
        req, mapper, reader, "split-0", plan, arrays, dev)


def check_doc_space(leaf, ex, mapper, reqs, body_req, body_resp, aggs,
                    reader, dev) -> dict:
    """Phase 4's doc-space requests on the card, each against its CPU run;
    score_topk must not launch. Returns {name: cuda response}."""
    import dataclasses

    import numpy as np
    import torch
    out = {}

    def both(name, req, **kw):
        plan, gpu = run_split(leaf, mapper, req, reader, dev, **kw)
        _, cpu = run_split(leaf, mapper, req, reader, "cpu", **kw)
        if response_key(gpu) != response_key(cpu):
            raise AssertionError(f"{name}: cuda response differs from cpu")
        if gpu.num_hits <= 0 or len(gpu.partial_hits) != min(
                req.max_hits, gpu.num_hits):
            raise AssertionError(f"{name}: unexpected hit count")
        if not all(h.sort_value > float("-inf") for h in gpu.partial_hits):
            raise AssertionError(f"{name}: a dead lane surfaced as a hit")
        for agg, state in gpu.intermediate_aggs.items():
            if int(state["counts"].sum()) != gpu.num_hits:
                raise AssertionError(f"{name}: {agg} buckets do not sum to "
                                     f"num_hits {gpu.num_hits}")
        say(f"doc-space {name}: num_hits={gpu.num_hits} "
            f"posting_space={ex._posting_space_eligible(plan)} "
            f"top_doc_ids={[h.doc_id for h in gpu.partial_hits[:10]]} "
            f"equal_to_cpu=True")
        out[name] = gpu
        return plan, gpu

    _, c2 = both("c2_bool_range_top100", reqs["c2_bool_range_top100"])
    _, page1 = both("c2_ts_tenant_top100", reqs["c2_ts_tenant_top100"])
    _, top200 = both("c2_ts_tenant_top200", reqs["c2_ts_tenant_top200"])
    last = page1.partial_hits[-1]
    _, page2 = both("c2_ts_tenant_page2", dataclasses.replace(
        reqs["c2_ts_tenant_top100"], search_after=[
            last.raw_sort_value, last.raw_sort_value2, "split-0",
            last.doc_id]))
    if hit_key(page2) != hit_key(top200)[100:200]:
        raise AssertionError("page 2 is not hits 101-200 of the top 200")
    say("doc-space c2_ts_tenant_page2: equal to hits 101-200 of the "
        "top-200 run")

    threshold = body_resp.partial_hits[9].sort_value
    plan, cut = both("body_top10_threshold", body_req, threshold=threshold)
    if plan.threshold_slot < 0 or plan.root.impact_bmax_slot < 0:
        raise AssertionError("body_top10_threshold: no pushdown in the plan")
    if hit_key(cut) != hit_key(body_resp) or cut.num_hits != \
            body_resp.num_hits:
        raise AssertionError("body_top10_threshold: hits differ from the "
                             "run without the threshold")

    c2_plan = leaf.prepare_plan_only(reqs["c2_bool_range_top100"], mapper,
                                     reader, "split-0")
    host_mask, dev_mask = ex.compute_packed_mask(
        c2_plan, leaf.warmup_device_arrays(reader, c2_plan, dev)[0], dev)
    cpu_mask, _ = ex.compute_packed_mask(
        c2_plan, leaf.warmup_device_arrays(reader, c2_plan, "cpu")[0], "cpu")
    set_bits = int(np.unpackbits(host_mask).sum())
    if dev_mask.device.type != torch.device(dev).type or not (
            host_mask == cpu_mask).all():
        raise AssertionError("compute_packed_mask: cuda bytes differ from cpu")
    if set_bits != c2.num_hits:
        raise AssertionError(f"compute_packed_mask: {set_bits} docs set, "
                             f"c2 matches {c2.num_hits}")
    by_ts = dataclasses.replace(reqs["c2_by_timestamp"], aggs=aggs)
    _, plain = both("c2_by_timestamp", by_ts)
    plan, masked = both("c2_by_timestamp_mask_override", by_ts,
                        mask=host_mask)
    if type(plan.root).__name__ != "PMaskRef" or \
            response_key(masked) != response_key(plain):
        raise AssertionError("mask_override: response differs from the "
                             "request without it")
    say(f"doc-space mask fill: bytes={host_mask.nbytes} set_bits={set_bits} "
        f"(= c2 num_hits) equal_to_cpu=True; mask_override response equal "
        f"to the request without it")
    return out


# --------------------------------------------------------------------------
# phase 5: aggregations

SUM_KEYS = ("sum", "sum_sq")


def assert_aggs_close(want, got, path="aggs") -> None:
    """Aggregation states of two runs: f64 sums to rtol 1e-12 (the CPU and
    the card reduce in other orders), everything else exactly (floats bit
    for bit)."""
    import numpy as np
    key = path.rsplit(".", 1)[-1]
    if isinstance(want, dict):
        if want.keys() != got.keys():
            raise AssertionError(f"{path}: keys differ")
        for k in want:
            assert_aggs_close(want[k], got[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        if len(want) != len(got):
            raise AssertionError(f"{path}: lengths differ")
        for i, (w, g) in enumerate(zip(want, got)):
            assert_aggs_close(w, g, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, float)):
        w, g = np.asarray(want), np.asarray(got)
        if w.dtype != g.dtype or w.shape != g.shape:
            raise AssertionError(f"{path}: dtype or shape differs")
        close = np.zeros(w.shape, dtype=bool)
        if key in SUM_KEYS:
            close[...] = True
        elif key == "state":          # [count, sum, sum_sq, min, max]
            close[1:3] = True
        if w.dtype.kind == "f":
            bits_equal = w.view(np.int64) == g.view(np.int64)
            near = np.isclose(g, w, rtol=1e-12, atol=0, equal_nan=True)
            ok = np.where(close, near, bits_equal)
        else:
            ok = w == g
        if not np.all(ok):
            raise AssertionError(f"{path}: {w} vs {g}")
    elif want != got:
        raise AssertionError(f"{path}: {want!r} vs {got!r}")


def agg_requests(SearchRequest, Term, MatchAll, Bool, Range, RangeBound,
                 body_term) -> dict:
    """name -> (split, request, timed)."""
    day_us = 86400 * 1_000_000
    t0_us = 1_600_000_000 * 1_000_000
    duration = "span_duration_micros"
    pctl = {"percentiles": {"field": duration, "percents": [50, 95, 99]}}
    c2 = Bool(
        must=(Term("severity_text", "ERROR"),),
        should=(Term("body", body_term(3)), Term("body", body_term(7))),
        filter=(Range("timestamp", lower=RangeBound(t0_us + day_us, True),
                      upper=RangeBound(t0_us + 4 * day_us, False)),))
    return {
        "c5_otel_percentiles_1split": ("otel", SearchRequest(
            index_ids=["otel-traces"], query_ast=MatchAll(), max_hits=0,
            aggs={"latency": pctl}), True),
        "otel_latency_by_service": ("otel", SearchRequest(
            index_ids=["otel-traces"], query_ast=MatchAll(), max_hits=0,
            aggs={"by_service": {
                "terms": {"field": "service_name", "size": 10},
                "aggs": {"latency": pctl,
                         "stats": {"extended_stats": {"field": duration}},
                         "distinct": {"cardinality": {"field": duration}}}},
                  "per_minute": {
                "date_histogram": {"field": "span_start_timestamp",
                                   "fixed_interval": "1m"},
                "aggs": {"avg": {"avg": {"field": duration}},
                         "max": {"max": {"field": duration}}}}}), True),
        "flagship_bucket_metrics": ("hdfs", SearchRequest(
            index_ids=["hdfs-logs"], query_ast=Term("severity_text", "ERROR"),
            max_hits=10, aggs={
                "over_time": {
                    "date_histogram": {"field": "timestamp",
                                       "fixed_interval": "1d"},
                    "aggs": {"tenant_stats": {"stats": {"field": "tenant_id"}},
                             "tenant_pct": {"percentiles": {
                                 "field": "tenant_id"}}}},
                "severities": {
                    "terms": {"field": "severity_text", "size": 10},
                    "aggs": {"last": {"max": {"field": "timestamp"}}}}}),
            True),
        "c2_aggs": ("hdfs", SearchRequest(
            index_ids=["hdfs-logs"], query_ast=c2, max_hits=100, aggs={
                "tenants": {"cardinality": {"field": "tenant_id"}},
                "windows": {
                    "range": {"field": "timestamp", "ranges": [
                        {"to": t0_us + 3 * day_us},
                        {"from": t0_us + 2 * day_us},
                        {"from": t0_us + day_us, "to": t0_us + 5 * day_us}]},
                    "aggs": {"tenant_sum": {"sum": {"field": "tenant_id"}},
                             "tenants": {"cardinality": {
                                 "field": "tenant_id"}}}},
                "pages": {
                    "composite": {"size": 20, "sources": [
                        {"sev": {"terms": {"field": "severity_text"}}},
                        {"day": {"date_histogram": {
                            "field": "timestamp",
                            "fixed_interval": "1d"}}}]},
                    "aggs": {"tenant_avg": {"avg": {"field": "tenant_id"}},
                             "by_tenant": {"terms": {
                                 "field": "tenant_id"}}}}}), False),
        "mv_tags": ("mv", SearchRequest(
            index_ids=["mv-tags"], query_ast=Range(
                "bytes", lower=RangeBound(2**40 + 200_000, True),
                upper=RangeBound(2**40 + 1_400_000, False)),
            max_hits=0, aggs={
                "tags": {"terms": {"field": "tags", "size": 50}},
                # the packed u64 rebased on the card: stats, its hash
                "bytes": {"stats": {"field": "bytes"}},
                "distinct_bytes": {"cardinality": {"field": "bytes"}}}),
            False),
    }


def mv_tags_split(SplitWriter, DocMapper, FieldMapping, FieldType, seed):
    """20,000 docs written by the port's SplitWriter: 1-4 tags per doc from
    a vocabulary of 50 (a multivalued raw field) and a u64 that packs into
    u32 lanes."""
    import numpy as np
    mapper = DocMapper(field_mappings=[
        FieldMapping("ts", FieldType.DATETIME, fast=True, indexed=False,
                     input_formats=("unix_timestamp",)),
        FieldMapping("tags", FieldType.TEXT, tokenizer="raw", fast=True),
        FieldMapping("bytes", FieldType.U64, fast=True, indexed=False)],
        timestamp_field="ts")
    rng = np.random.RandomState(seed)
    vocab = [f"tag{i:02d}" for i in range(50)]
    writer = SplitWriter(mapper)
    for i in range(20_000):
        writer.add_json_doc({
            "ts": 1_600_000_000 + i * 30,
            "tags": list(rng.choice(vocab, rng.randint(1, 5))),
            "bytes": int(2**40 + rng.randint(0, 400_000) * 4)})
    return mapper, writer.finish()


def check_agg_ops(torch, aggs, dev, seed, n) -> str:
    """The aggregation reductions over `n` rows (the split's doc count) on
    the card, twice, against their CPU run: bucket sums past the compare
    limit (the sort and segment path), minima and maxima over signed zeros
    and NaN, per-bucket sketches and HLL registers. Returns a summary
    line."""
    import numpy as np
    rng = np.random.RandomState(seed)
    idx = torch.from_numpy(rng.randint(0, 702, n).astype(np.int32))
    values = torch.from_numpy(np.exp(rng.normal(9.0, 1.5, n)))
    values[::1000] = -0.0
    values[1::1000] = 0.0
    values[7] = float("nan")
    hashes = torch.from_numpy(rng.randint(-2**63, 2**63 - 1, n,
                                          dtype=np.int64))
    valid = torch.from_numpy(rng.rand(n) < 0.9)
    cases = {
        "bucket_sum_700": lambda i, v, h, ok: aggs.bucket_sum(i, v, 700),
        "bucket_sum_64": lambda i, v, h, ok: aggs.bucket_sum(i, v, 64),
        "bucket_min_700": lambda i, v, h, ok: aggs.bucket_min(i, v, 700),
        "bucket_max_64": lambda i, v, h, ok: aggs.bucket_max(i, v, 64),
        "bucket_sketch_60": lambda i, v, h, ok:
            aggs.bucket_percentile_sketch(i, v, 60),
        "bucket_hll_700": lambda i, v, h, ok:
            aggs.bucket_hll_registers(i, h, ok, 700),
    }
    cpu = (idx, values, hashes, valid)
    gpu = tuple(t.to(dev) for t in cpu)
    worst = 0.0
    for name, fn in cases.items():
        want = fn(*cpu).numpy()
        first, second = fn(*gpu).cpu().numpy(), fn(*gpu).cpu().numpy()
        bits = (lambda a: a.view(np.int64) if a.dtype == np.float64 else a)
        if not np.array_equal(bits(first), bits(second)):
            raise AssertionError(f"{name}: two calls on the card differ")
        if name.startswith("bucket_sum"):
            if not np.allclose(first, want, rtol=1e-12, atol=0,
                               equal_nan=True):
                raise AssertionError(f"{name}: cuda differs from cpu")
            worst = max(worst, float(np.nanmax(np.abs(first - want)
                                               / np.abs(want))))
        elif not np.array_equal(bits(first), bits(want)):
            raise AssertionError(f"{name}: cuda differs from cpu")
    return (f"aggs ops at {n} rows: {sorted(cases)} equal to cpu (sums "
            f"max rel err {worst}), two cuda calls byte-equal")


def check_aggregations(leaf, st, collector_mod, reqs, splits, dev) -> None:
    """Phase 5's requests: twice on the card, once on the CPU."""
    import dataclasses

    import numpy as np
    out = {}

    def finalize(req, resp):
        collector = collector_mod.IncrementalCollector(req.max_hits)
        collector.add_leaf_response(resp)
        return collector_mod.finalize_aggregations(
            collector.aggregation_states())

    def three(name, split, req):
        mapper, reader = splits[split]
        before = st.score_topk.launches
        _, gpu = run_split(leaf, mapper, req, reader, dev)
        _, again = run_split(leaf, mapper, req, reader, dev)
        launched = st.score_topk.launches - before
        _, cpu = run_split(leaf, mapper, req, reader, "cpu")
        if response_key(gpu) != response_key(again):
            raise AssertionError(f"{name}: two cuda calls differ")
        if gpu.num_hits != cpu.num_hits or hit_key(gpu) != hit_key(cpu):
            raise AssertionError(f"{name}: cuda hits differ from cpu")
        assert_aggs_close(cpu.intermediate_aggs, gpu.intermediate_aggs,
                          name)
        if gpu.num_hits <= 0 or len(gpu.partial_hits) != min(
                req.max_hits, gpu.num_hits):
            raise AssertionError(f"{name}: unexpected hit count")
        final = finalize(req, gpu)
        say(f"aggs {name}: num_hits={gpu.num_hits} score_topk_launches="
            f"{launched} for 2 calls, two cuda calls byte-equal, "
            f"equal_to_cpu=True")
        out[name] = gpu
        return gpu, final, launched

    _, c5, _ = three("c5_otel_percentiles_1split",
                     *reqs["c5_otel_percentiles_1split"][:2])
    values = [v for v in c5["latency"]["values"].values()]
    if not (all(np.isfinite(values)) and values == sorted(values)):
        raise AssertionError(f"c5: percentiles {values}")
    say(f"aggs c5 percentiles (p50, p95, p99 micros): {values}")

    _, otel, _ = three("otel_latency_by_service",
                       *reqs["otel_latency_by_service"][:2])
    services = otel["by_service"]["buckets"]
    if sum(b["doc_count"] for b in services) != out[
            "otel_latency_by_service"].num_hits:
        raise AssertionError("otel: service buckets do not sum to num_hits")
    say("aggs otel by service: " + json.dumps(
        [[b["key"], b["doc_count"], b["distinct"]["value"]]
         for b in services]))

    _, flag, launched = three("flagship_bucket_metrics",
                              *reqs["flagship_bucket_metrics"][:2])
    if launched != 2:
        raise AssertionError(f"flagship_bucket_metrics launched score_topk "
                             f"{launched} times in 2 calls")
    days = flag["over_time"]["buckets"]
    if sum(b["doc_count"] for b in days) != out[
            "flagship_bucket_metrics"].num_hits:
        raise AssertionError("flagship_bucket_metrics: days do not sum")

    split, c2_req, _ = reqs["c2_aggs"]
    _, c2, _ = three("c2_aggs", split, c2_req)
    pages = c2["pages"]
    keys1 = [tuple(b["key"].values()) for b in pages["buckets"]]

    def after(key):
        composite = dict(c2_req.aggs["pages"]["composite"],
                         after=dict(zip(pages["after_key"], key)))
        return dataclasses.replace(c2_req, aggs={
            "pages": dict(c2_req.aggs["pages"], composite=composite)})

    # page 2 after the last key, and a page resumed after the first key,
    # which must be page 1 less its first bucket
    _, page2, _ = three("c2_aggs_page2", split, after(keys1[-1]))
    _, resumed, _ = three("c2_aggs_after_first", split, after(keys1[0]))
    keys2 = [tuple(b["key"].values()) for b in page2["pages"]["buckets"]]
    if (keys2 and keys2[0] <= keys1[-1]) or (len(keys1) < 20 and keys2):
        raise AssertionError("c2_aggs: page 2 does not follow page 1")
    if [(tuple(b["key"].values()), b["doc_count"])
            for b in resumed["pages"]["buckets"]] != [
            (k, b["doc_count"]) for k, b in zip(keys1, pages["buckets"])][1:]:
        raise AssertionError("c2_aggs: the page after the first key is not "
                             "page 1 less its first bucket")
    say(f"aggs c2 composite: page 1 {len(keys1)} buckets {keys1}, page 2 "
        f"{len(keys2)} buckets; the page after the first key is page 1 "
        f"less its first bucket")

    split, mv_req, _ = reqs["mv_tags"]
    plan, _ = run_split(leaf, splits[split][0], mv_req, splits[split][1], dev)
    lanes = plan.arrays[plan.root.values_slot].dtype
    if not (lanes == np.uint32 and plan.rebase
            and any(a.kind == "terms_mv" for a in plan.aggs)):
        raise AssertionError("mv_tags: no packed lanes, no rebase or no "
                             "pair arrays")
    _, mv, _ = three("mv_tags", split, mv_req)
    if sum(b["doc_count"] for b in mv["tags"]["buckets"]) <= out[
            "mv_tags"].num_hits:
        raise AssertionError("mv_tags: a multivalued doc counted once")


# --------------------------------------------------------------------------
# phase 6: timing

def cuda_ms(torch, fn, iters: int, flush=None) -> float:
    """Median ms of `fn` by CUDA events, `flush()` run (untimed) before each
    launch so every launch starts with a cold L2."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def pct(samples, q):
    s = sorted(samples)
    return s[min(len(s) - 1, int(q * len(s)))]


def graph_ms(torch, fn, iters: int, flush) -> float:
    """Median ms of `fn` captured once in a CUDA graph and replayed, so the
    host-side launch cost (Python, ctypes, allocation) drops out: the
    device time of the launches alone."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):   # the warmed-up stream
        fn()
    return cuda_ms(torch, graph.replay, iters, flush)


def device_profile(torch, fn, calls: int, out_path: str) -> str:
    """Run `fn` `calls` times under torch.profiler, write the Chrome trace
    to `out_path`, and summarize it: device busy share of the window (union
    of kernel, memcpy and memset intervals over the window's wall time) and
    the device time per kernel name and per torch op, largest first."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    prof.export_chrome_trace(out_path)
    with open(out_path) as fh:
        summary = summarize_trace(json.load(fh), calls, wall_us)
    # the same device time by the torch op that launched it
    by_op = sorted(((ev.key, getattr(ev, "self_device_time_total", 0.0))
                    for ev in prof.key_averages()
                    if ev.key.startswith("aten::")), key=lambda kv: -kv[1])
    return summary + " top_ops=" + json.dumps(
        [[name, round(us / calls, 2)] for name, us in by_op[:10] if us > 0])


def summarize_trace(trace: dict, calls: int, wall_us: float) -> str:
    spans = [(ev["ts"], ev["ts"] + ev["dur"], ev["name"])
             for ev in trace.get("traceEvents", [])
             if ev.get("ph") == "X" and ev.get("cat") in (
                 "kernel", "gpu_memcpy", "gpu_memset")]
    if not spans:
        return "device_profile: the trace holds no device events"
    busy, end = 0.0, float("-inf")
    for start, stop, _ in sorted(spans):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    by_name: dict[str, float] = {}
    for start, stop, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (stop - start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return (f"device_busy_ms_per_call={busy / 1e3 / calls:.4f} "
            f"wall_ms_per_call={wall_us / 1e3 / calls:.4f} "
            f"busy_share={busy / wall_us:.4f} device_ops_per_call="
            f"{len(spans) / calls:.1f} top=" + json.dumps(
                [[name[:60], round(us / calls, 2)] for name, us in top]))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--docs", type=int, default=10_000_000)
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU; nothing to measure", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import numpy as np
    from quickwit_tpu_torch.common.uri import Uri
    from quickwit_tpu_torch.index.reader import SplitReader
    from quickwit_tpu_torch.index import SplitWriter
    from quickwit_tpu_torch.index.synthetic import (
        HDFS_MAPPER, OTEL_BENCH_MAPPER, body_term, synthetic_hdfs_split,
        synthetic_otel_split)
    from quickwit_tpu_torch.models.doc_mapper import (
        DocMapper, FieldMapping, FieldType)
    from quickwit_tpu_torch.ops import aggs as agg_ops
    from quickwit_tpu_torch.ops.bm25 import score_postings
    from quickwit_tpu_torch.ops.kernels import build as build_mod
    from quickwit_tpu_torch.ops.kernels import score_topk as st
    from quickwit_tpu_torch.query.ast import (
        Bool, MatchAll, Range, RangeBound, Term)
    from quickwit_tpu_torch.search import collector as collector_mod
    from quickwit_tpu_torch.search import executor as ex
    from quickwit_tpu_torch.search import leaf as leaf_mod
    from quickwit_tpu_torch.search.collector import (
        IncrementalCollector, finalize_aggregations)
    from quickwit_tpu_torch.search.leaf import (
        execute_prepared_split, leaf_search_single_split, prepare_plan_only,
        warmup_device_arrays)
    from quickwit_tpu_torch.search.models import SearchRequest, SortField
    from quickwit_tpu_torch.storage.ram import RamStorage

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    label = gpu_label()
    say(f"device: {torch.cuda.get_device_name(0)} count="
        f"{torch.cuda.device_count()} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")

    # 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    built = build_kernels(build_mod)
    say(f"[{label}] build: {json.dumps(built)} total_s="
        f"{time.perf_counter() - t0:.3f}")
    print_ptxas(build_mod, built)

    # 2. kernels vs plain -------------------------------------------------
    max_abs_err = check_score_topk(torch, st, dev)

    # 3. split ------------------------------------------------------------
    t0 = time.perf_counter()
    data = synthetic_hdfs_split(args.docs, seed=args.seed)
    split_s = time.perf_counter() - t0
    say(f"split: docs={args.docs} seed={args.seed} bytes={len(data)} "
        f"build_s={split_s:.3f} host_maxrss_mb="
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024:.0f}")
    storage = RamStorage(Uri.parse("ram:///chip_smoke"))
    storage.put("hdfs.split", data)
    del data
    reader = SplitReader(storage, "hdfs.split")
    requests = hdfs_requests(SearchRequest, Term, body_term)

    # 4. slice on the card, against the port's CPU run ----------------------
    st.score_topk.launches = 0
    responses = {name: leaf_search_single_split(req, HDFS_MAPPER, reader,
                                                "split-0", device=dev)
                 for name, req in requests.items()}
    launches = {"score_topk": st.score_topk.launches}
    say(f"slice launches: {json.dumps(launches)}")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"kernel {name} never launched on the path")
    if launches["score_topk"] != len(requests):   # one launch per query
        raise AssertionError(f"score_topk launched {launches['score_topk']} "
                             f"times for {len(requests)} queries")
    for name, req in requests.items():
        gpu = responses[name]
        cpu = leaf_search_single_split(req, HDFS_MAPPER, reader, "split-0",
                                       device="cpu")
        if response_key(gpu) != response_key(cpu):
            raise AssertionError(f"{name}: cuda response differs from cpu")
        if gpu.num_hits <= 0 or len(gpu.partial_hits) != min(
                req.max_hits, gpu.num_hits):
            raise AssertionError(f"{name}: unexpected hit count")
        if not all(np.isfinite(h.sort_value) for h in gpu.partial_hits):
            raise AssertionError(f"{name}: non-finite sort value")
        collector = IncrementalCollector(req.max_hits)
        collector.add_leaf_response(gpu)
        final = finalize_aggregations(collector.aggregation_states())
        bucket_sums = {agg: sum(b["doc_count"] for b in out["buckets"])
                       for agg, out in final.items()}
        for agg, total in bucket_sums.items():
            if total != gpu.num_hits:
                raise AssertionError(f"{name}: {agg} buckets sum to {total}, "
                                     f"not num_hits {gpu.num_hits}")
        say(f"slice {name}: num_hits={gpu.num_hits} "
            f"bucket_doc_count_sums={json.dumps(bucket_sums)} "
            f"top_doc_ids={[h.doc_id for h in gpu.partial_hits]} "
            f"equal_to_cpu=True")

    # 4b. the doc-space requests, with the counters zeroed again
    doc_reqs = doc_space_requests(SearchRequest, SortField, Bool, Range,
                                  RangeBound, Term, body_term)
    st.score_topk.launches = 0
    check_doc_space(leaf_mod, ex, HDFS_MAPPER, doc_reqs,
                    requests["body_top10"], responses["body_top10"],
                    requests["flagship"].aggs, reader, dev)
    doc_launches = {"score_topk": st.score_topk.launches}
    say(f"doc-space launches: {json.dumps(doc_launches)}")
    if doc_launches["score_topk"] != 0:
        raise AssertionError("score_topk launched on a doc-space or "
                             "threshold request")

    # 5. aggregations, with the counters zeroed again ----------------------
    t0 = time.perf_counter()
    otel_data = synthetic_otel_split(args.docs, seed=args.seed)
    otel_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mv_mapper, mv_data = mv_tags_split(SplitWriter, DocMapper, FieldMapping,
                                       FieldType, args.seed)
    say(f"aggs splits: otel docs={args.docs} seed={args.seed} "
        f"bytes={len(otel_data)} build_s={otel_s:.3f}; mv_tags docs=20000 "
        f"bytes={len(mv_data)} build_s={time.perf_counter() - t0:.3f}")
    storage.put("otel.split", otel_data)
    storage.put("mv.split", mv_data)
    del otel_data, mv_data
    splits = {"hdfs": (HDFS_MAPPER, reader),
              "otel": (OTEL_BENCH_MAPPER, SplitReader(storage, "otel.split")),
              "mv": (mv_mapper, SplitReader(storage, "mv.split"))}
    say(check_agg_ops(torch, agg_ops, dev, args.seed, args.docs))
    agg_reqs = agg_requests(SearchRequest, Term, MatchAll, Bool, Range,
                            RangeBound, body_term)
    torch.cuda.reset_peak_memory_stats(dev)
    st.score_topk.launches = 0
    check_aggregations(leaf_mod, st, collector_mod, agg_reqs, splits, dev)
    agg_launches = {"score_topk": st.score_topk.launches}
    say(f"aggs launches: {json.dumps(agg_launches)} peak_device_mb="
        f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f}")
    if agg_launches["score_topk"] != 2:   # flagship_bucket_metrics, twice
        raise AssertionError("score_topk did not launch once per "
                             "flagship_bucket_metrics call")

    # 6. timing -----------------------------------------------------------
    flush_buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    rows = []
    timed = {name: (HDFS_MAPPER, reader, req)
             for name, req in requests.items()}
    timed["c2_bool_range_top100"] = (HDFS_MAPPER, reader,
                                     doc_reqs["c2_bool_range_top100"])
    for name, (split, req, is_timed) in agg_reqs.items():
        if is_timed:
            timed[name] = (*splits[split], req)
    for name, (mapper, split_reader, req) in timed.items():
        plan = prepare_plan_only(req, mapper, split_reader, "split-0")
        arrays, _ = warmup_device_arrays(split_reader, plan, dev)
        # the whole leaf call, warm (arrays resident), host clock; the call
        # ends in the packed readback, which synchronizes
        walls, phases = [], {"plan": [], "stage": [], "execute": []}
        for _ in range(args.iters):
            t0 = time.perf_counter()
            leaf_search_single_split(req, mapper, split_reader, "split-0",
                                     device=dev)
            walls.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            p = prepare_plan_only(req, mapper, split_reader, "split-0")
            t1 = time.perf_counter()
            a, staged = warmup_device_arrays(split_reader, p, dev)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            execute_prepared_split(req, mapper, split_reader, "split-0", p,
                                   a, dev)
            t3 = time.perf_counter()
            phases["plan"].append((t1 - t0) * 1e3)
            phases["stage"].append((t2 - t1) * 1e3)
            phases["execute"].append((t3 - t2) * 1e3)
        os.makedirs(os.path.join(here, "chip_traces"), exist_ok=True)
        summary = device_profile(
            torch, lambda: leaf_search_single_split(
                req, mapper, split_reader, "split-0", device=dev), 5,
            os.path.join(here, "chip_traces", f"trace_{name}.json"))
        say(f"[{label}] profile {name}: {summary}")
        staged_cold = sum(arr.nbytes for arr in plan.arrays)
        say(f"[{label}] leaf {name}: warm_p50_ms={pct(walls, 0.5):.4f} "
            f"warm_p90_ms={pct(walls, 0.9):.4f} iters={args.iters} "
            + " ".join(f"{ph}_p50_ms={pct(v, 0.5):.4f}"
                       for ph, v in phases.items())
            + f" staged_bytes_cold={staged_cold} staged_bytes_warm={staged}")

        # the kernel at this request's shape
        if not (ex._posting_space_eligible(plan) and plan.sort.by == "score"
                and plan.root.scoring):
            continue
        root = plan.root
        ids, tfs = arrays[root.ids_slot], arrays[root.tfs_slot]
        norms = arrays[root.norm_slot]
        idf, avg = plan.scalars[root.idf_slot], plan.scalars[root.avg_len_slot]
        k = min(req.max_hits, ids.shape[0])
        P = ids.shape[0]
        before = st.score_topk.launches
        kernel_ms = cuda_ms(torch, lambda: st.score_topk(
            ids, tfs, norms, idf, avg, plan.num_docs, k), args.iters, flush)
        device_ms = graph_ms(torch, lambda: st.score_topk(
            ids, tfs, norms, idf, avg, plan.num_docs, k), args.iters, flush)
        st.score_topk.launches = before   # timing launches are not the path's
        plain_ms = cuda_ms(torch, lambda: st.score_topk_reference(
            ids, tfs, norms, idf, avg, plan.num_docs, k), args.iters, flush)
        scores = score_postings(tfs, ids, norms, avg, idf)
        scores = torch.where((tfs > 0) & (ids < plan.num_docs), scores,
                             float("-inf"))
        library_ms = cuda_ms(torch, lambda: torch.topk(scores, k),
                             args.iters, flush)
        got = st.score_topk(ids, tfs, norms, idf, avg, plan.num_docs, k)
        st.score_topk.launches = before
        want = st.score_topk_reference(ids, tfs, norms, idf, avg,
                                       plan.num_docs, k)
        num_valid = int(((tfs > 0) & (ids < plan.num_docs)).sum())
        err = compare_winners(torch, got, want, num_valid, k)
        max_abs_err = max(max_abs_err, err)
        # bytes: ids + tfs + one gathered norm per posting, read once; the
        # k (f32, i64) winners written once. ops: ~11 f32 ops per posting.
        nbytes = 12 * P + 12 * k
        bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
        ops_ms = 11 * P / H100_F32_OPS_PER_S * 1e3
        # the floor the bound does not show: each gathered norm moves its
        # whole 32-byte sector, so count the distinct sectors this run's
        # valid postings touch, beside the streamed ids and tfs
        live = (tfs > 0) & (ids < plan.num_docs)
        sectors = int(torch.unique(ids[live] // 8).numel())
        sector_bytes = 8 * P + 32 * sectors + 12 * k
        sector_ms = sector_bytes / H100_BYTES_PER_S * 1e3
        say(f"[{label}] kernel score_topk @{name}: P={P} k={k} "
            f"ms={kernel_ms:.5f} graph_replay_ms={device_ms:.5f} "
            f"plain_ms={plain_ms:.5f} "
            f"library_ms(torch.topk)={library_ms:.5f} "
            f"bound_ms={max(bytes_ms, ops_ms):.6f} "
            f"(bytes={nbytes}, ops_ms={ops_ms:.6f}) "
            f"sector_floor_ms={sector_ms:.6f} (bytes={sector_bytes}, "
            f"achieved_GB_per_s={sector_bytes / device_ms / 1e6:.1f} at "
            f"graph replay) max_abs_err={err}")
        rows.append({
            "at": name, "P": P, "k": k,
            "ms": kernel_ms, "graph_replay_ms": device_ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "sector_floor_ms": sector_ms, "library_ms": library_ms})
    del flush_buf

    main_row = next(r for r in rows if r["at"] == "flagship")
    kernels = [{
        "name": "score_topk", "route": "cuda",
        "source": "quickwit_tpu_torch/csrc/score_topk.cu",
        "replaces": "quickwit_tpu/ops/pallas/score_topk.py:59",
        # the slice's flagship and body_top10 calls, and the two
        # flagship_bucket_metrics calls of the aggregation phase
        "launches": launches["score_topk"] + agg_launches["score_topk"],
        "max_abs_err": max_abs_err,
        "ms": main_row["ms"], "graph_replay_ms": main_row["graph_replay_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "sector_floor_ms": main_row["sector_floor_ms"],
        "library_ms": main_row["library_ms"],
        "shapes": rows,   # each posting-space request, with all of these
    }]
    say(label)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
