"""Per-phase timeline and timings of the score_topk CUDA kernel on one GPU.

    python3 tools/score_topk_timeline.py [--docs N] [--iters N]
        [--set kItems=8,kStages=2 ...]

Builds the hdfs-logs split that chip_smoke.py builds (10M docs, seed 7 by
default), stages the flagship and body_top10 posting lists on the card, and
then:

- builds copies of the port under `quickwit_tpu_torch/_build/timeline/`:
  `base` (the source as it is), one per `--set` (its `constexpr int`
  constants overridden) and `stamped`, the base with a `%globaltimer` stamp
  at each phase of each block;
- holds every copy against the plain version (valid winners exact), then
  times each per call (CUDA events, L2 flushed before every launch) and
  replayed from a CUDA graph, in the order base, sets, sets reversed, base;
- prints the stamped copy's timeline for 5 calls per shape: the spread of
  block starts, then per block (p50/p90/max) the wait for the first staged
  tile, the tile loop, the block merge, the candidate append and ticket;
  then when the last block took its ticket, its scan and merge, and how
  many candidates it merged.

Needs a GPU; the copies build with the flags of ops/kernels/build.py.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import importlib.util
import os
import re
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "quickwit_tpu_torch", "_build", "timeline")

# (anchor, text put after it); a stamp records the time for thread 0
_STAMPS = [
    ("  const int tfs_shift = misalign(tfs);\n", "STAMP(0)"),
    ("    mbar_wait(&full[stage], (n / kStages) & 1);\n",
     "if (n == 0) STAMP(1)"),
    ("    top.offer(score, p, ok[u] && better(score, p, top.thr_v, "
     "top.thr_i),\n                lane, k);\n    }\n", "STAMP(2)"),
    ("  top.block_merge(merge_v, merge_i, warp, lane, k);\n  if (warp == 0) "
     "{\n    // Publish", None),   # checked below: stamp 3 goes after merge
    ("    if (is_last) __threadfence();   // acquire every block's "
     "candidates\n", "STAMP(4)"),
    ("  const int num_cands = static_cast<int>(__ldcg(&state->count));\n",
     "if (t == 0) g_stamp[blockIdx.x][7] = num_cands;"),
]
_HEAD = """
__device__ unsigned long long g_stamp[8192][8];
#define STAMP(slot) { if (threadIdx.x == 0) { unsigned long long now; \\
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now)); \\
  g_stamp[blockIdx.x][slot] = now; } }
extern "C" int qw_stamps(void* dst, int read) {
  return (int)(read ? cudaMemcpyFromSymbol(dst, g_stamp, sizeof(g_stamp))
                    : cudaMemcpyToSymbol(g_stamp, dst, sizeof(g_stamp)));
}
"""


def stamped(src: str) -> str:
    for anchor, text in _STAMPS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once: {anchor[:50]!r}")
        if text is not None:
            src = src.replace(anchor, anchor + text + "\n")
    merge = "  top.block_merge(merge_v, merge_i, warp, lane, k);\n"
    first, rest = src.split(merge, 1)
    rest_a, rest_b = rest.split(merge, 1)
    src = (first + merge + "STAMP(3)\n" + rest_a + "STAMP(5)\n" + merge
           + "STAMP(6)\n" + rest_b)
    return src.replace("namespace {\n", _HEAD + "namespace {\n", 1)


def overridden(src: str, sets: dict[str, int]) -> str:
    for name, value in sets.items():
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {value};", src)
        if n != 1:
            raise RuntimeError(f"no constant {name} in score_topk.cu")
    return src


def make_copy(name: str, src: str):
    """A copy of the port whose score_topk.cu is `src`, imported under its
    own name; returns its (score_topk module, build module)."""
    root = os.path.join(OUT, name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "quickwit_tpu_torch"),
                    os.path.join(root, "quickwit_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    with open(os.path.join(root, "quickwit_tpu_torch", "csrc",
                           "score_topk.cu"), "w") as fh:
        fh.write(src)
    alias = f"qtt_{name}"
    pkg = os.path.join(root, "quickwit_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return (importlib.import_module(f"{alias}.ops.kernels.score_topk"),
            importlib.import_module(f"{alias}.ops.kernels.build"))


def parse_set(text: str) -> dict[str, int]:
    return {k: int(v) for k, v in (kv.split("=") for kv in text.split(","))}


def q(values) -> str:
    import numpy as np
    v = np.asarray(values, dtype=np.float64) / 1e3
    return (f"p50={np.percentile(v, 50):.2f} p90={np.percentile(v, 90):.2f} "
            f"max={v.max():.2f}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--docs", type=int, default=10_000_000)
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--iters", type=int, default=30)
    parser.add_argument("--set", action="append", default=[],
                        help="constants of a variant, e.g. kItems=8,kStages=2")
    args = parser.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("score_topk_timeline: no CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from concurrent.futures import ThreadPoolExecutor
    from quickwit_tpu_torch.common.uri import Uri
    from quickwit_tpu_torch.index.reader import SplitReader
    from quickwit_tpu_torch.index.synthetic import (
        HDFS_MAPPER, body_term, synthetic_hdfs_split)
    from quickwit_tpu_torch.query.ast import Term
    from quickwit_tpu_torch.search.leaf import (
        prepare_plan_only, warmup_device_arrays)
    from quickwit_tpu_torch.search.models import SearchRequest
    from quickwit_tpu_torch.storage.ram import RamStorage

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    label = cs.gpu_label()
    with open(os.path.join(REPO, "quickwit_tpu_torch", "csrc",
                           "score_topk.cu")) as fh:
        base_src = fh.read()
    sources = {"base": base_src, "stamped": stamped(base_src)}
    for text in args.set:
        sources[text.replace("=", "").replace(",", "_")] = overridden(
            base_src, parse_set(text))
    copies = {name: make_copy(name, src) for name, src in sources.items()}
    with ThreadPoolExecutor(len(copies)) as pool:
        list(pool.map(lambda c: c[1].load("score_topk"), copies.values()))
    for name, (_, build) in copies.items():
        regs = [line.split(":", 1)[1].strip() for line in
                build.ptxas_report("score_topk").splitlines()
                if "registers" in line]
        print(f"ptxas {name}: {regs}", flush=True)

    t0 = time.perf_counter()
    storage = RamStorage(Uri.parse("ram:///timeline"))
    storage.put("hdfs.split", synthetic_hdfs_split(args.docs,
                                                   seed=args.seed))
    print(f"split: docs={args.docs} build_s={time.perf_counter() - t0:.1f}",
          flush=True)
    reader = SplitReader(storage, "hdfs.split")
    flush_buf = torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    flush = flush_buf.zero_
    timed = [name for name in sources if name != "stamped"]
    order = timed + timed[::-1]
    lib = copies["stamped"][1].load("score_topk")
    stamps = np.zeros((8192, 8), dtype=np.uint64)
    for shape, req in cs.hdfs_requests(SearchRequest, Term,
                                       body_term).items():
        plan = prepare_plan_only(req, HDFS_MAPPER, reader, "split-0")
        arrays, _, _ = warmup_device_arrays(reader, plan, device=dev)
        r = plan.root
        call = (arrays[r.ids_slot], arrays[r.tfs_slot], arrays[r.norm_slot],
                plan.scalars[r.idf_slot], plan.scalars[r.avg_len_slot],
                plan.num_docs, min(req.max_hits, arrays[r.ids_slot].shape[0]))
        ids, tfs, _, _, _, num_docs, k = call
        want = copies["base"][0].score_topk_reference(*call)
        num_valid = int(((tfs > 0) & (ids < num_docs)).sum())
        for name, (st, _) in copies.items():
            cs.compare_winners(torch, st.score_topk(*call), want, num_valid,
                               k)
        times: dict[str, list] = {}
        for name in order:
            st = copies[name][0]
            times.setdefault(name, []).append((
                cs.cuda_ms(torch, lambda: st.score_topk(*call), args.iters,
                           flush),
                cs.graph_ms(torch, lambda: st.score_topk(*call), args.iters,
                            flush)))
        for name, runs in times.items():
            print(f"[{label}] {shape} P={ids.shape[0]} k={k} {name}: "
                  + " | ".join(f"ms={a:.5f} graph_replay_ms={b:.5f}"
                               for a, b in runs), flush=True)
        st = copies["stamped"][0]
        for rep in range(5):
            stamps[:] = 0
            if lib.qw_stamps(stamps.ctypes.data_as(ctypes.c_void_p), 0):
                raise RuntimeError("cannot clear the stamps")
            flush()
            torch.cuda.synchronize()
            st.score_topk(*call)
            torch.cuda.synchronize()
            if lib.qw_stamps(stamps.ctypes.data_as(ctypes.c_void_p), 1):
                raise RuntimeError("cannot read the stamps")
            b = stamps[stamps[:, 0] > 0].astype(np.int64)
            start = b[:, 0].min()
            last = b[b[:, 5] > 0][0]
            print(f"[{label}] timeline {shape} call{rep}: blocks={len(b)} "
                  f"start_spread_us={(b[:, 0].max() - start) / 1e3:.2f} "
                  f"first_tile_wait_us[{q(b[:, 1] - b[:, 0])}] "
                  f"tile_loop_us[{q(b[:, 2] - b[:, 1])}] "
                  f"block_merge_us[{q(b[:, 3] - b[:, 2])}] "
                  f"append_and_ticket_us[{q(b[:, 4] - b[:, 3])}] "
                  f"last_ticket_at_us={(b[:, 4].max() - start) / 1e3:.2f} "
                  f"last_block_scan_us={(last[5] - last[4]) / 1e3:.2f} "
                  f"last_block_merge_us={(last[6] - last[5]) / 1e3:.2f} "
                  f"candidates_merged={last[7]} "
                  f"end_at_us={(last[6] - start) / 1e3:.2f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
