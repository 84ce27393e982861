"""The knee of an open-loop cell: build the cell once, warm it, then offer
its traffic at each rate in turn and print what came back. The rate a cell
runs at is fixed in its mix file at about four fifths of the highest rate
whose backlog does not grow; this finds that rate, once, on the card.

    python3 -m qwbench.sweep --workload <cell> --seed <n> --seconds <s> \\
        --rates 20,40,80
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="qwbench.sweep")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--rates", required=True)
    args = parser.parse_args(argv)

    import torch
    from qwbench import cells, harness, traffic
    from qwbench.node import Node

    if not torch.cuda.is_available():
        print("qwbench.sweep: no CUDA device", file=sys.stderr)
        return 2
    work = cells.cell(args.workload)
    cell = harness.Cell(work, args.seed, "cuda")
    from quickwit_tpu_torch.ops.kernels import build
    build.load("score_topk")
    cell.build_corpus()
    node = Node(cell.config, cell.splits, "cuda")
    for spec in traffic.warm_specs(cell.mix, cell.config, args.seed):
        node.search(spec["request"])
    print(json.dumps({"setup_s": time.perf_counter() - _T0}), flush=True)
    for rate in [float(r) for r in args.rates.split(",")]:
        mix = traffic.at_rate(cell.mix, rate)
        specs, offsets = traffic.schedule(mix, cell.config, args.seconds,
                                          args.seed, f"sweep{rate}")
        outcomes, start, end = traffic.open_loop(
            node.search, specs, offsets, args.seconds, straggle_s=30.0)
        done = [o for o in outcomes if o.done is not None and o.error is None]
        lat = np.array([(o.done - o.due) * 1e3 for o in done])
        lag = np.array([(o.sent - o.due) * 1e3 for o in done])
        by_kind = {}
        for o in done:
            by_kind.setdefault(o.kind, []).append((o.done - o.due) * 1e3)
        last = max((o.done for o in done), default=end)
        print(json.dumps({
            "rate_qps": rate, "offered": len(outcomes),
            "offered_qps": len(outcomes) / args.seconds,
            "completed": len(done),
            "p50_ms": float(np.percentile(lat, 50)) if len(lat) else None,
            "p95_ms": float(np.percentile(lat, 95)) if len(lat) else None,
            "p99_ms": float(np.percentile(lat, 99)) if len(lat) else None,
            "lag_p95_ms": float(np.percentile(lag, 95)) if len(lag) else None,
            "drain_s": last - end,
            "p50_by_kind": {k: float(np.median(v))
                            for k, v in by_kind.items()}}), flush=True)
        if last - end > 10.0:     # the backlog grew: higher rates only grow it
            break
    return 0


if __name__ == "__main__":
    sys.exit(main())
