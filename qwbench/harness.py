"""One run of one cell, in the order the benchmark promises: build the
program's kernels, draw the corpus, build and publish the splits, warm the
cell's request shapes, measure for the window, then judge a sample of the
answers against the plain reference. The command line is `run.py`; this
module takes the device as an argument so its tests can drive a run on
the CPU at small sizes.
"""

from __future__ import annotations

import gc
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from . import cells, check, roofline, traffic
from .corpus.common import sub_seed
from .reference import search as reference

FORBIDDEN = ("jax", "jaxlib", "flax", "quickwit_tpu")
_WIDTH_ARRAYS = ("packed", "values", "ordinals")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole: `quickwit_tpu_torch` is not `quickwit_tpu`."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def _counters() -> dict:
    from quickwit_tpu_torch.observability import metrics as m
    return {"batcher_queries": m.SEARCH_BATCHER_QUERIES_TOTAL.get(),
            "batcher_dispatches": m.SEARCH_BATCHER_DISPATCHES_TOTAL.get(),
            "leaf_cache_hits": m.LEAF_CACHE_HITS_TOTAL.get(),
            "leaf_cache_misses": m.LEAF_CACHE_MISSES_TOTAL.get()}


def _python_ms() -> float:
    """ms one core of this host takes for a fixed piece of pure Python
    (best of three): how fast the host ran this run's interpreter."""
    best = float("inf")
    for _ in range(3):
        t = time.perf_counter()
        acc = 0
        for i in range(300_000):
            acc += i & 7
        best = min(best, time.perf_counter() - t)
    return best * 1e3


def _note_window(outcomes, start, end, cpu_s, latencies) -> None:
    """What the window looked like from the host, for standard error:
    completions per fifth of the window, this process's CPU seconds and
    the median latency."""
    fifth = (end - start) / 5
    per = [0] * 5
    for o in outcomes:
        if o.done is not None and start <= o.done < end:
            per[min(4, int((o.done - start) / fifth))] += 1
    print(f"window: completions per fifth {per} process_cpu_s {cpu_s:.3f} "
          f"wall_s {end - start:.3f} "
          f"latency_p50_ms {_percentile(latencies, 50)}", file=sys.stderr)


def _percentile(values, q) -> float | None:
    return float(np.percentile(values, q)) if len(values) else None


def _stored_widths(footer) -> dict:
    """Bytes per doc of each fast column as the split stores it."""
    out = {}
    for field in footer.fields:
        for kind in _WIDTH_ARRAYS:
            meta = footer.arrays.get(f"col.{field}.{kind}")
            if meta is not None:
                out[field] = np.dtype(meta.dtype).itemsize
                break
    return out


class Cell:
    """A cell's deployment, traffic and corpus, built from the seed."""

    def __init__(self, work: dict, seed: int, device: str,
                 config: dict | None = None, mix: dict | None = None):
        self.work, self.seed, self.device = work, seed, device
        self.config = config or cells.load_config(work["config"])
        self.mix = mix or cells.load_traffic(work["traffic"])
        self._reference: dict = {}

    def build_corpus(self):
        """Draw and build every split; keep the raw docs on the host."""
        corpus = cells.corpus_module(self.config)
        self.raws, self.splits = [], []
        for i in range(self.config["splits"]):
            raw = corpus.draw(self.config, self.seed, self.device, split=i)
            data, facts = corpus.build(self.config, raw)
            self.raws.append({k: v.cpu() for k, v in raw.items()})
            self.splits.append((f"s{i:04d}", data, facts))
            del raw

    def schedule(self, seconds: float, tag: str):
        """(specs, offsets) of a window of `seconds`, from the seed."""
        return traffic.schedule(self.mix, self.config, seconds, self.seed,
                                tag)

    def ts_us(self, raw: dict) -> np.ndarray:
        """A split's raw timestamps in microseconds."""
        ts_field = self.config["doc_mapping"]["timestamp_field"]
        return (raw[self.config["raw_columns"][ts_field]].numpy()
                * self.config["raw_time_unit_us"])

    def reference_splits(self, device) -> list:
        """The plain reference's view of every split's raw documents, each
        with the corpus's `document(config, raw, doc_id)` where it has
        one; made once a device, so that its term dictionaries serve the
        bytes counted and the judge alike."""
        if device not in self._reference:
            document = getattr(cells.corpus_module(self.config), "document",
                               None)
            self._reference[device] = [reference.Split(
                self.config, raw, split_id, device,
                None if document is None else
                (lambda doc_id, raw=raw: document(self.config, raw, doc_id)))
                for raw, (split_id, _, _) in zip(self.raws, self.splits)]
        return self._reference[device]

    # --- what each request needs of the device ---------------------------
    def needed_bytes(self, footers: dict, widths: dict | None = None):
        """`request -> {"aggs"?: bytes, "search"?: bytes}`, with the
        columns' widths from the splits' footers (or `widths`, for all),
        counted on the cell's device: `aggs` where the request aggregates,
        `search` where it asks for hits or its query reads postings."""
        ts_field = self.config["doc_mapping"]["timestamp_field"]
        tables = [{"ts_us": self.ts_us(raw),
                   "width": widths or _stored_widths(footers[split_id]),
                   "split": split}
                  for raw, (split_id, _, _), split in zip(
                      self.raws, self.splits,
                      self.reference_splits(self.device))]

        def bytes_of(request: dict) -> dict:
            out = {}
            if request.get("aggs"):
                out["aggs"] = roofline.aggregation_bytes(request, ts_field,
                                                         tables)
            if (request.get("max_hits", 20)
                    or tables[0]["split"].query_terms(
                        request.get("query", {"match_all": {}}))):
                out["search"] = roofline.search_bytes(request, ts_field,
                                                      tables)
            return out
        return bytes_of


def _drive(node, schedule, seconds, profile):
    call = (lambda spec: node.search(spec, profile=True)) if profile \
        else node.search
    specs, offsets = schedule
    return traffic.open_loop(call, specs, offsets, seconds)


def run_cell(work: dict, seed: int, seconds: float, trace: bool,
             device: str, t0: float, config: dict | None = None,
             mix: dict | None = None, program=None) -> dict:
    """One run; returns the result line's object. `program` replaces the
    node's `search` for the window (the control and the fault tests)."""
    from .node import Node
    cell = Cell(work, seed, device, config, mix)
    steps = {"imports": time.perf_counter() - t0}
    if device != "cpu":
        from quickwit_tpu_torch.ops.kernels import build
        build.load("score_topk")
    steps["kernels"] = time.perf_counter() - t0 - sum(steps.values())
    cell.build_corpus()
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    steps["corpus"] = time.perf_counter() - t0 - sum(steps.values())
    node = Node(cell.config, cell.splits, device)
    steps["publish"] = time.perf_counter() - t0 - sum(steps.values())
    footers = node.footers
    cell.splits = [(sid, None, facts) for sid, _, facts in cell.splits]
    search = program(node) if program is not None else node.search

    # warm the cell's own shapes: each one in turn, then a short loop
    for spec in traffic.warm_specs(cell.mix, cell.config, seed):
        search(spec["request"])
    warm_s = cell.mix.get("warmup", {}).get("seconds", 0)
    if warm_s:
        _drive(SimpleNamespace(search=search),
               cell.schedule(warm_s, "warmloop"), warm_s, False)
    if device != "cpu":
        torch.cuda.synchronize()
    steps["warmup"] = time.perf_counter() - t0 - sum(steps.values())
    print("setup seconds: " + " ".join(f"{k}={v:.3f}" for k, v in
                                       steps.items()), file=sys.stderr)

    schedule = cell.schedule(seconds, "window")
    specs = schedule[0]
    if program is not None:
        window_node = SimpleNamespace(
            search=lambda s, profile=False: search(s))
    else:
        window_node = node
    print(f"python_ms before the window: {_python_ms():.3f}",
          file=sys.stderr)
    before = _counters()
    setup_s = time.perf_counter() - t0
    tracer = None
    if trace or device != "cpu":
        # untraced runs record the card alone, for device_ms_per_query
        from .trace import DeviceTrace
        tracer = DeviceTrace(host=trace).__enter__()
    if trace:
        tracer.mark()
    cpu0 = time.process_time()
    outcomes, start, end = _drive(window_node, schedule, seconds, trace)
    cpu_s = time.process_time() - cpu0
    if trace:
        tracer.mark()
    if tracer is not None:
        t = time.perf_counter()
        tracer.__exit__(None, None, None)
        print(f"trace: profiler stop_s {time.perf_counter() - t:.3f}",
              file=sys.stderr)
    after = _counters()
    print(f"python_ms after the window: {_python_ms():.3f}",
          file=sys.stderr)
    peak = (torch.cuda.max_memory_allocated() if device != "cpu" else 0)

    # --- end-to-end -------------------------------------------------------
    def ok(o):
        return (o.done is not None and o.error is None
                and not o.response.errors and not o.response.timed_out
                and not o.response.cancelled and not o.response.failed_splits)
    done = [o for o in outcomes if ok(o)]
    latencies = [(o.done - o.due) * 1e3 for o in done]
    _note_window(outcomes, start, end, cpu_s, latencies)
    e2e = {"setup_s": setup_s}
    if tracer is not None and not trace and done:
        # the card's busy time over the window and its stragglers, the
        # union of kernel, memcpy and memset intervals, per request
        t = time.perf_counter()
        e2e["device_ms_per_query"] = tracer.busy_s() * 1e3 / len(done)
        print(f"trace: read_s {time.perf_counter() - t:.3f}", file=sys.stderr)
    units = {m["name"]: m["unit"] for m in work["end_to_end"]
             + work["per_layer"]}

    # --- per-layer --------------------------------------------------------
    per_layer, breakdown, device_info = {}, None, {}
    if trace:
        per_request, intervals = [], {}
        for o in done:
            sums: dict[str, float] = {}
            for ph in (o.response.profile or {}).get("phases", []):
                sums[ph["name"]] = sums.get(ph["name"], 0.0) \
                    + ph["duration_ms"]
                begin = o.sent + ph["start_ms"] / 1e3
                intervals.setdefault(ph["name"], []).append(
                    (begin, begin + ph["duration_ms"] / 1e3))
            per_request.append(sums)
        phases = {name: [sums.get(name, 0.0) for sums in per_request]
                  for name in intervals}
        summary = tracer.summarize(intervals,
                                   [(o.sent, o.done) for o in outcomes
                                    if o.sent is not None])
        breakdown = summary["breakdown"]
        device_info = {"busy_s": summary["busy_s"],
                       "window_s": summary["window_s"]}

    # --- the reference's work: the program's state goes first -------------
    del node, search, window_node
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    bytes_of = cell.needed_bytes(footers)
    needed = [bytes_of(specs[o.index]["request"]) for o in done]
    if trace:
        run = SimpleNamespace(
            done=done, latencies_ms=latencies, window_s=summary["window_s"],
            busy_s=summary["busy_s"], phases=phases,
            counters={k: after[k] - before[k] for k in after},
            needed=needed)
        for metric in work["per_layer"]:
            value = cells.reader(metric["name"])(run)
            if value is not None:
                per_layer[metric["name"]] = value

    # --- correctness --------------------------------------------------------
    weights = [sum(n.values()) for n in needed]
    tally = judge(cell, [(specs[done[i].index]["request"],
                          check.program_answer(done[i].response))
                         for i in choose_sample(cell, weights)])
    correct, shown = check.verdict(tally, cell.config["check"]["limits"])
    failed = len(outcomes) - len(done)
    # a request that failed, timed out, came back partial or never came
    # is wrong whatever the sample says
    shown["failed"] = {"value": failed, "limit": 0}
    correct = correct and failed == 0

    metrics = per_layer if trace else {
        m["name"]: e2e[m["name"]] for m in work["end_to_end"]
        if e2e.get(m["name"]) is not None}
    result = {
        "correct": correct and not forbidden_modules(),
        "attempted": len(outcomes),
        "failed": failed,
        "metrics": {name: {"value": value, "unit": units[name]}
                    for name, value in metrics.items()},
        "device": {"platform": "gpu" if device != "cpu" else "cpu",
                   "kind": (torch.cuda.get_device_name()
                            if device != "cpu" else "cpu"),
                   "count": int(work["chips"]),
                   "memory_peak_bytes": int(peak), **device_info},
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = shown
    return result


def choose_sample(cell: Cell, weights: list) -> list[int]:
    """Indices of the answers to judge: drawn from the seed, with those
    that needed the most device bytes always among them."""
    size = min(cell.config["check"]["sample"], len(weights))
    if not size:
        return []
    heavy = [int(i) for i in np.argsort(weights, kind="stable")[::-1][
        :max(1, size // 8)]]
    rng = np.random.default_rng(sub_seed(cell.seed, "check"))
    rest = [int(i) for i in rng.permutation(len(weights))
            if int(i) not in set(heavy)]
    return sorted(set(heavy) | set(rest[:size - len(heavy)]))


def judge(cell: Cell, items: list) -> dict:
    """Judge `(request, answer)` pairs against the reference, on the
    cell's device, from the raw documents."""
    tally = check.empty_tally()
    splits = cell.reference_splits(cell.device)
    tolerance = cell.config["check"]["limits"].get("score_gap", 0.0)
    for request, got in items:
        check.judge(got, reference.answer(splits, request), tally, tolerance)
    return tally


def summary_lines(result: dict) -> list[str]:
    """The numbers compared beside their limits, for standard error."""
    return [f"check {name}: {v['value']!r} (limit {v['limit']!r})"
            for name, v in result["checks"].items()] + [
        f"correct: {result['correct']}"]

