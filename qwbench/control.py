"""The control of the comparison that decides `correct`: the plain
reference put in the program's place, computed one precision below the
one the deployment states (`check.control_dtype`: float32 aggregates
where float64 is stated; scores in that dtype too), answering a run's
sample of requests, hits and their documents included, over the same raw
documents. Its answers have to come out not correct; the readings it
prints set the upper end of each limit. Not run by the benchmark's runs.

    python3 -m qwbench.control --workload <cell> --seeds 1,2,3 --seconds 30
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import cells, check, harness


def readings(work: dict, seed: int, seconds: float, device: str,
             config: dict | None = None, mix: dict | None = None) -> dict:
    """One seed's control: (correct, {number: value})."""
    from .reference import search as reference
    cell = harness.Cell(work, seed, device, config, mix)
    corpus = cells.corpus_module(cell.config)
    cell.raws, cell.splits = [], []
    for i in range(cell.config["splits"]):
        raw = corpus.draw(cell.config, seed, device, split=i)
        cell.raws.append({k: v.cpu() for k, v in raw.items()})
        cell.splits.append((f"s{i:04d}", None, {}))
    widths = {f["name"]: 1
              for f in cell.config["doc_mapping"]["field_mappings"]}
    footers = {sid: None for sid, _, _ in cell.splits}
    bytes_of = cell.needed_bytes(footers, widths=widths)
    specs = cell.schedule(seconds, "window")[0]
    weights = [sum(bytes_of(s["request"]).values()) for s in specs]
    low = getattr(torch, cell.config["check"]["control_dtype"])
    splits = cell.reference_splits(device)
    items = []
    for i in harness.choose_sample(cell, weights):
        request = specs[i]["request"]
        answer = reference.answer(splits, request, dtype=low)
        items.append((request, {"num_hits": answer["num_hits"],
                                "hits": answer.get("hits", []),
                                "aggs": answer["aggs"], "errors": []}))
    tally = harness.judge(cell, items)
    ok, shown = check.verdict(tally, cell.config["check"]["limits"])
    return {"seed": seed, "correct": ok,
            "numbers": {k: v["value"] for k, v in shown.items()}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="qwbench.control")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("qwbench.control: no CUDA device", file=sys.stderr)
        return 2
    work = cells.cell(args.workload)
    for seed in [int(s) for s in args.seeds.split(",")]:
        print(json.dumps(readings(work, seed, args.seconds, "cuda")),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
