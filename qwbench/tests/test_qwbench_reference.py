"""The plain reference against the port's CPU path, the result line's
shape, and the rule that nothing the benchmark runs loads JAX or the JAX
package. On the CPU at small sizes."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from qwbench import cells, check, harness, run, traffic
from qwbench.node import Node

ROOT = Path(__file__).resolve().parents[2]
CELLS = ["otel-dashboard-open"]


# a mix as a later data-only cell could add it: Poisson arrivals of
# aggregation requests over drawn time ranges
POISSON = {"loop": "poisson", "rate_qps": 1.0,
           "kinds": [{"name": "by_service", "weight": 0.5,
                      "draws": {"w": {"law": "time_range",
                                      "lengths_s": [300, 900],
                                      "align_s": 60}},
                      "request": {"max_hits": 0,
                                  "start_timestamp": "$w.from_us",
                                  "end_timestamp": "$w.to_us",
                                  "aggs": {"s": {"terms": {
                                      "field": "service_name", "size": 5}}}}},
                     {"name": "slowest", "weight": 0.5,
                      "request": {"max_hits": 0, "aggs": {"m": {"max": {
                          "field": "span_duration_millis"}}}}}]}


def small(name: str, mix: dict | None = None):
    """A cell's parts at a size the CPU runs in seconds."""
    work = cells.cell(name)
    config = cells.load_config(work["config"])
    mix = dict(mix or cells.load_traffic(work["traffic"]))
    config["docs_per_split"] = 6000
    config["splits"] = 3
    mix = traffic.at_rate(mix, 8.0)
    mix["warmup"] = {"per_kind": 1, "rounds": 1, "seconds": 0}
    return work, config, mix


def kinds_of(mix: dict) -> set[str]:
    return {k["name"] for k in mix.get("kinds", mix.get("panels", []))}


@pytest.mark.parametrize("mix", [None, POISSON], ids=["cell", "poisson"])
@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_cpu_path_for_every_kind(name, mix):
    work, config, mix = small(name, mix)
    cell = harness.Cell(work, 5_000_000_021, "cpu", config, mix)
    cell.build_corpus()
    node = Node(cell.config, cell.splits, "cpu")
    specs = cell.schedule(4.0, "kinds")[0]
    assert {s["kind"] for s in specs} == kinds_of(mix)
    items = [(s["request"], check.program_answer(node.search(s["request"])))
             for s in specs]
    tally = harness.judge(cell, items)
    ok, shown = check.verdict(tally, config["check"]["limits"])
    assert ok, shown
    assert tally["count_wrong"] == 0
    assert all(got["num_hits"] for _, got in items)


@pytest.mark.parametrize("mix", [None, POISSON], ids=["cell", "poisson"])
@pytest.mark.parametrize("name", CELLS)
def test_every_seed_offers_the_same_work_in_another_order(name, mix):
    work, config, mix = small(name, mix)
    one = harness.Cell(work, 2**40 + 1, "cpu", config, mix).schedule(
        20.0, "window")
    two = harness.Cell(work, 2**40 + 1, "cpu", config, mix).schedule(
        20.0, "window")
    other = harness.Cell(work, 7, "cpu", config, mix).schedule(
        20.0, "window")
    assert one[0] == two[0] and list(one[1]) == list(two[1])
    assert one[0] != other[0]
    assert len(one[0]) == len(other[0])
    assert sorted(s["kind"] for s in one[0]) == sorted(
        s["kind"] for s in other[0])
    if mix["loop"] == "poisson":
        gaps = [sorted(np.diff(np.append(x[1], 20.0))) for x in (one, other)]
        assert gaps[0] == pytest.approx(gaps[1], rel=1e-9)
    else:                               # the same arrivals, shifted
        assert list(np.diff(one[1])) == pytest.approx(
            list(np.diff(other[1])), abs=1e-9)


def test_a_refresh_sends_its_panels_together_over_one_range():
    work, config, mix = small("otel-dashboard-open")
    specs, offsets = harness.Cell(work, 3, "cpu", config, mix).schedule(
        10.0, "window")
    end_us = traffic.corpus_end_ms(config) * 1000
    per = {}
    for spec, at in zip(specs, offsets):
        request = spec["request"]
        per.setdefault((spec["dashboard"], float(at)), set()).add(
            (request["start_timestamp"], request["end_timestamp"]))
        # "now" runs along the corpus's last seconds to its end
        assert end_us - 10_000_000 <= request["end_timestamp"] <= end_us
        assert request["end_timestamp"] % 1000 == 0
    assert all(len(ranges) == 1 for ranges in per.values())
    panels = len(mix["panels"])
    assert len(specs) == panels * len(per)


def test_result_line_has_the_contracts_keys():
    work, config, mix = small("otel-dashboard-open")
    result = harness.run_cell(work, 2**32 + 3, 1.0, False, "cpu",
                              time.perf_counter(), config, mix)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    # device_ms_per_query comes from the card's trace, so not on the CPU
    assert set(result["metrics"]) == {"setup_s"}
    for metric in result["metrics"].values():
        assert set(metric) == {"value", "unit"}
    assert set(result["checks"]) == set(check.NUMBERS) | {"failed"}
    assert result["correct"] is True
    json.dumps(result)


def test_no_card_no_result(capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code = run.main(["--workload", "otel-dashboard-open", "--seed", "1",
                     "--seconds", "1", "--trace", "0"])
    assert code != 0
    assert capsys.readouterr().out == ""


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                package = ".".join(path.relative_to(ROOT).with_suffix("")
                                   .parts[:-node.level])
                out.add(f"{package}.{node.module}" if node.module
                        else package)
            elif node.module:
                out.add(node.module)
    return out


def test_nothing_the_benchmark_runs_imports_jax():
    """Every module reachable from `qwbench` through imports in this
    repository, by whole top-level name."""
    todo = [p for p in (ROOT / "qwbench").rglob("*.py")]
    seen, tops = set(), set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for name in _imports(path):
            tops.add(name.split(".")[0])
            parts = name.split(".")
            for cut in range(len(parts), 0, -1):
                base = ROOT.joinpath(*parts[:cut])
                for cand in (base.with_suffix(".py"), base / "__init__.py"):
                    if cand.exists():
                        todo.append(cand)
                        break
                else:
                    continue
                break
    assert not tops & set(harness.FORBIDDEN), sorted(tops)
    assert any(p.parts[-2] == "search" for p in seen)   # the port was walked


def test_loading_the_benchmark_loads_no_jax():
    code = ("import sys, importlib, pkgutil, qwbench\n"
            "for m in pkgutil.walk_packages(qwbench.__path__, 'qwbench.'):\n"
            "    if '.tests' not in m.name: importlib.import_module(m.name)\n"
            "import qwbench.node\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'quickwit_tpu'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
