"""What sets the device time of c5's percentile-sketch scatter on one GPU.

    python3 tools/sketch_scatter_probe.py [--docs N] [--seed N]
        [--so-docs N] [--iters N]

c5_otel_percentiles_1split spends most of its device time in one
`index_add_`: 10M int32 ones scattered into a sketch of a few hundred hot
counters (`ops/aggs.py::bucket_counts`). Its time differs between runs of
`chip_smoke.py` whose c5 code is the same. This script builds the otel-traces
split that chip_smoke.py builds (10M docs, seed 7 by default) and prints,
each on its own line:

- `fresh`: c5's `index_add_` device µs per call (torch.profiler, 5 calls)
  and the address of the sketch counters it wrote, modulo 2 MiB;
- `sweep`: the same scatter, on c5's own indices, into counters placed at
  one offset after another inside a buffer of its own that starts on a
  2 MiB boundary (CUDA events, median of `--iters` calls per offset; every
  128-byte line of the first 8 KiB, every 4 bytes across the line of the
  in-situ counters' offset, 32 KiB steps over the segment): whether the
  counters' address alone moves the time, and what it reads at the
  in-situ offset;
- `after_phrase`: c5 again after chip_smoke.py's phrase phase has run on the
  card (the stackoverflow split written to a temporary directory and read
  through the file:// backend, its four requests on cuda), its reader kept;
- `after_free`: c5 again once that reader is dropped and the caching
  allocator has returned its free blocks (`torch.cuda.empty_cache()`).

Needs a GPU.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEGMENT = 2 << 20      # the caching allocator's small-pool segment


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--docs", type=int, default=10_000_000)
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--so-docs", type=int, default=5_000_000)
    parser.add_argument("--iters", type=int, default=10)
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("sketch_scatter_probe: no CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from quickwit_tpu_torch.common.uri import Uri
    from quickwit_tpu_torch.index.reader import SplitReader
    from quickwit_tpu_torch.index.synthetic import (
        OTEL_BENCH_MAPPER, SO_MAPPER, body_term, synthetic_otel_split,
        synthetic_stackoverflow_split)
    from quickwit_tpu_torch.ops import aggs as agg_ops
    from quickwit_tpu_torch.query.ast import (
        Bool, FullText, MatchAll, PhrasePrefix, Range, RangeBound, Term)
    from quickwit_tpu_torch.search import leaf as leaf_mod
    from quickwit_tpu_torch.search.models import SearchRequest
    from quickwit_tpu_torch.storage import StorageResolver
    from quickwit_tpu_torch.storage.ram import RamStorage

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    label = cs.gpu_label()

    storage = RamStorage(Uri.parse("ram:///probe"))
    storage.put("otel.split", synthetic_otel_split(args.docs, seed=args.seed))
    otel = SplitReader(storage, "otel.split")
    _, c5, _ = cs.agg_requests(SearchRequest, Term, MatchAll, Bool, Range,
                               RangeBound, body_term)[
        "c5_otel_percentiles_1split"]

    # record the sketch scatter's inputs and where its counters landed
    seen = {}
    original = agg_ops.bucket_counts

    def recording(idx, num_buckets):
        out = original(idx, num_buckets)
        if num_buckets > agg_ops._COMPARE_MAX_BUCKETS:
            seen.update(idx=idx, num_buckets=num_buckets,
                        ptr=out.data_ptr())
        return out

    agg_ops.bucket_counts = recording

    def c5_call():
        return leaf_mod.leaf_search_single_split(
            c5, OTEL_BENCH_MAPPER, otel, "split-0", device=dev)

    def c5_reading(stage):
        for _ in range(3):
            c5_call()
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        calls = 5
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                c5_call()
            torch.cuda.synchronize()
        us = sum(getattr(ev, "self_device_time_total", 0.0)
                 for ev in prof.key_averages()
                 if ev.key == "aten::index_add_") / calls
        print(f"[{label}] {stage}: index_add_us_per_call={us:.2f} "
              f"counters_at_mod_2MiB={seen['ptr'] % SEGMENT} "
              f"allocated_mb={torch.cuda.memory_allocated(dev) / 2**20:.1f} "
              f"reserved_mb={torch.cuda.memory_reserved(dev) / 2**20:.1f}",
              flush=True)
        return us

    fresh_us = c5_reading("fresh")

    # the same scatter into counters at chosen offsets of one buffer
    nb = seen["num_buckets"]
    safe = agg_ops._safe_index(seen["idx"], nb)
    ones = torch.ones(1, dtype=torch.int32, device=dev).expand(
        safe.shape[0])
    want = original(seen["idx"], nb)
    buf = torch.zeros(3 * SEGMENT // 4, dtype=torch.int32, device=dev)
    buf = buf[(-buf.data_ptr()) % SEGMENT // 4:]     # from a 2 MiB boundary
    # every 128-byte line over the first 8 KiB, every 4 bytes across the
    # line that holds the in-situ counters' offset, 32 KiB steps over the
    # segment, and that offset itself
    at = seen["ptr"] % SEGMENT
    line = at - at % 128
    offsets = sorted(set(list(range(0, 8 << 10, 128))
                         + list(range(line, line + 128, 4))
                         + list(range(0, SEGMENT, 32 << 10)) + [at]))
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    sweep = []
    for off in offsets:
        view = buf[off // 4: off // 4 + nb + 1]
        times = []
        for _ in range(args.iters):
            view.zero_()
            start.record()
            view.index_add_(0, safe, ones)
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop) * 1e3)
        if not torch.equal(view[:nb], want):
            raise AssertionError(f"sweep offset {off}: counts differ")
        sweep.append((off, statistics.median(times)))
    us = [t for _, t in sweep]
    print(f"[{label}] sweep: offsets={len(sweep)} num_buckets={nb} "
          f"scatter_us min={min(us):.2f} median={statistics.median(us):.2f} "
          f"max={max(us):.2f} at_in_situ_offset({at})="
          f"{dict(sweep)[at]:.2f}", flush=True)
    print("sweep_us_by_address_mod_2MiB=" + json.dumps(
        [[a, round(t, 2)] for a, t in sweep]), flush=True)
    del buf, safe, ones, want

    # chip_smoke.py's phrase phase: the split file, its requests on cuda
    with tempfile.TemporaryDirectory(prefix="probe_so_") as so_dir:
        so_storage = StorageResolver.for_test().resolve(f"file://{so_dir}")
        so_storage.put("so.split", synthetic_stackoverflow_split(
            args.so_docs, seed=cs.SO_SEED))
        so_reader = SplitReader(so_storage, "so.split")
        reqs = cs.phrase_requests(SearchRequest, FullText, PhrasePrefix, Bool,
                                  Range, RangeBound,
                                  so_reader.footer.time_range)
        for req in reqs.values():
            leaf_mod.leaf_search_single_split(req, SO_MAPPER, so_reader,
                                              "split-0", device=dev)
        phrase_us = c5_reading("after_phrase")
        del so_reader, so_storage
    gc.collect()
    torch.cuda.empty_cache()
    free_us = c5_reading("after_free")
    print(json.dumps({"fresh_us": fresh_us, "after_phrase_us": phrase_us,
                      "after_free_us": free_us,
                      "sweep_min_us": min(us), "sweep_max_us": max(us),
                      "sweep_at_in_situ_offset_us": dict(sweep)[at]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
