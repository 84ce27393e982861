"""Finding a cell's parts by name: its entry in `BENCHMARK.json`, its
deployment (`configs/<config>.json`), its traffic (`traffic/<mix>.json`),
its corpus kind (`corpus/<kind>.py`) and its per-layer readers
(`metrics/<metric>.py`, else `metrics/<metric up to its first dot>.py`,
so that `dispatch_cpu_ms.<x>` reuses `dispatch_cpu_ms`'s reader)."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def load_traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def corpus_module(config: dict):
    return importlib.import_module(f"qwbench.corpus.{config['corpus']}")


def cell(name: str, bench: dict | None = None) -> dict:
    """The cell's workload entry, with the metrics it reports."""
    bench = bench or benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    work = dict(found[0])
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name])
             and m["moves"] in reported]
    work["end_to_end"], work["per_layer"] = e2e, layer
    return work


def reader(metric: str):
    """The `read(run)` function of a per-layer metric."""
    for stem in (metric, metric.split(".")[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"qwbench.metrics.{stem.replace('.', '_')}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            return module.read
    raise KeyError(f"no reader for per-layer metric {metric!r}")
