"""Run one cell of `BENCHMARK.json` on the card and print its result line:

    python3 -m qwbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Exits non-zero, printing no result, where
there is no card or fewer cards than the cell asks for, or where JAX or
the JAX package got loaded.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()   # set-up is timed from the process's start

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = Path(__file__).resolve().parent.parent


def _fixed_caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout, so only
    a cell's first run there builds (the port's nvcc builds go to
    `quickwit_tpu_torch/_build/`, a path of its own)."""
    cache = _ROOT / ".qwbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="qwbench.run")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _fixed_caches()

    import torch
    from qwbench import cells, harness

    work = cells.cell(args.workload)
    if not torch.cuda.is_available():
        print("qwbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(work["chips"]):
        print(f"qwbench: {args.workload} needs {work['chips']} devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = harness.run_cell(work, args.seed, args.seconds,
                              bool(args.trace), "cuda", _T0)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"qwbench: forbidden modules loaded: {loaded}",
              file=sys.stderr)
        return 3
    for line in harness.summary_lines(result):
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
