"""Drive the PyTorch/CUDA port's leaf search and its service on one NVIDIA GPU.

    python3 chip_smoke.py [--docs N] [--so-docs N] [--iters N]

Phases, each of which fails the run (non-zero exit) when it fails:

1. build  : compile every CUDA kernel of the path from `quickwit_tpu_torch/
            csrc/` with nvcc (all sources at once), and print the seconds
            and what ptxas reports per kernel (registers, shared memory,
            spills).
2. kernels: hold each kernel against its plain torch version on the card, at
            the slice's shape and at the edge cases (ties across the whole
            persistent grid, scores rising with the index, misaligned
            views, 200 calls back to back, two streams at once); valid
            winners must be exact, and each call must launch once. Then the
            lane kernel (`score_topk_lanes`) for Q in {1, 2, 5, 16} and k
            in {10, 64}, over lanes of unequal length, misaligned views and
            an all-invalid lane, bit for bit against its plain version and
            against one solo launch per lane, and 100 launches back to
            back with the lane count moving.
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
            requests: warm p50/p90 of the whole leaf call, its phases
            (plan, stage, execute), a profiler window (device busy share,
            ops per call, the top device ops by time; Chrome traces go to
            chip_traces/); and per kernel: its time by CUDA events (L2
            flushed before every launch), the same launches replayed from a
            CUDA graph, the plain version's time, the nearest library call,
            its bound, and the floor set by the 32-byte sectors that its
            norm gather touches. These run before phase 7 brings its split
            into the process: what a process allocates first moves where
            c5's sketch counters land, and with them the time of its
            scatter (tools/sketch_scatter_probe.py).
7. phrase : a stackoverflow split from the port's generator (5M docs, seed
            11: `bench.py`'s BASELINE config 4 corpus) written to a split
            file in a temporary directory outside the checkout, opened
            through the resolver's `file://` backend and read through
            `CountingStorage` (the reads and bytes of the cold open and of
            each cuda call are printed). With the counters zeroed again:
            - c4_phrase_bm25_top20 (phrase "t000010 t000011", top-20 by
              BM25; one score_topk launch);
            - c4 at slop 2 on the same reader right after c4 (one launch),
              which must differ from c4 and equal its run on a fresh reader
              (one launch);
            - the phrase prefix "t000010 t00001" (a Bool of phrases in doc
              space), the phrase filtered to the split's last 30 days, and
              c4 with its own 20th score pushed down as the threshold (same
              hits), none of which may launch score_topk.
            Each response must equal the port's `device="cpu"` run on the
            same reader, with num_hits > 0. Then c4 is timed as in phase 6.
8. service: the node's `SearchService.leaf_search` on `cuda`, with the
            counters zeroed again. Phase 3's split bytes go into its RAM
            storage under two split ids (hdfs_a, hdfs_b: one bytes object)
            behind a `StorageResolver`. The flagship, c2_bool_range_top100,
            c2 sorted by timestamp (top-100) and a dashboard request (c2's
            filter, max_hits=0, the flagship's terms and date_histogram)
            run over both splits, each equal to a `device="cpu"` context
            over the same resolver, with num_hits > 0; the flagship
            launches score_topk once per split. Then, each failing the run
            when it does not hold:
            - warm: the flagship and c2 at another page size (a leaf-cache
              miss) are full resident hits in both splits (staging cache
              hits +2, column misses +0, 0 bytes staged); the same on a
              context whose one-slot reader LRU reopens every reader;
            - Tier A: c2 by timestamp at a new page size is a mask hit in
              both splits with 0 predicate bytes staged, equal to its run
              on a context with every tier off;
            - Tier B: the dashboard's aggregations renamed are served by
              the partial-agg cache: no score_topk launch and no device
              event in a profiler window (a warm flagship call in the same
              kind of window shows the card's events);
            - Tier C: a byte-identical flagship repeat is a leaf-cache hit
              with no launch and no device event;
            - eviction: under a budget of 1.5 times one split's resident
              bytes (read from a probe context), the flagship alternates
              between the splits for two passes, equal to the unpressured
              context; at every eviction `torch.cuda.memory_allocated()`
              falls by at least the evicted bytes.
            It prints the budget's resident bytes beside the growth of
            `memory_allocated()` over the cold pass, warm p50/p90 of the
            service call over one split (the leaf cache off) in turns with
            `leaf_search_single_split` on the same reader and beside phase
            6's times, and the mean time of the service call's parts.
9. chunked: the resumable chunked scan (`search/chunkexec.py`), with the
            counters zeroed again and the chunking knobs and sizer put back
            at the end. Through the leaf's staged entry points, with
            explicit spans, each response equal to the same call with
            chunking off (f64 sums to rtol 1e-12, all else exactly):
            - posting mode: the flagship at 131,072 postings per chunk (8
              chunks, 8 score_topk launches), body_top10 at 524,288 (12
              chunks, 12 launches), and body_top10 with a pushed-down
              threshold whose impact prefix spans 3+ chunks, which may stop
              early (no launch: a threshold turns the fused kernel off);
            - dense mode at 1,048,576 docs per chunk (10 chunks, posting
              ids rebased on the card): c2_bool_range_top100, c2 by
              (timestamp, tenant_id) and its search_after page 2,
              c5_otel_percentiles_1split and otel_latency_by_service;
            - c2_aggs (composite) does not chunk: one program, no launch;
            - the flagship cancelled at the first boundary: partial after 2
              chunks (2 launches), fewer hits, the cancel-to-return time;
            - `SearchService.leaf_search` over one split id: the flagship
              and c2 equal to chunking off, and a cancelled flagship call.
            No chunked run may restart. Then warm p50/p90 of each chunked
            request in turns with its fused call, chunks, launches and
            bytes staged per warm call, the boundary interval's p50/p90,
            the host chunk-plan time of c2, profiler windows, and
            score_topk at the chunk shape (P = 131,072).
10. stacking: query stacking (`search/batcher.py`, the executor's
            stacked and convoy dispatch, the chunked group scan), with the
            counters zeroed again; every comparison and timing launch is
            counted apart. Each lane must equal its solo `execute_plan` on
            the card, a stacked call must be one program with 0 bytes
            staged and no solo `score_topk` launch:
            - a rare-term group: the 8 body terms of the hdfs split's most
              common padded posting length, top-10 by BM25 (one
              `score_topk_lanes` launch against 8 solo launches), and the
              convoy under QW_DISABLE_QBATCH=1 (4 copies of one such term
              through `dispatch_plan_multi`);
            - c2_bool_range_top100 over 4 windows [day d, day d + 3),
              d = 0..3 (one dashboard panel over 4 time ranges), then with
              lane 1 masked;
            - c5's percentiles over 4 span_start_timestamp windows on the
              otel split;
            - the reference's two stacking faults: a same-named range agg
              over other bounds (hdfs) and c4 at slop 0 and slop 2 in one
              group (phase 7's split where the two pad to one length, else
              a 20,000-doc stackoverflow split);
            - the chunked group scan: 8 rare terms whose postings span 3+
              chunks of 128 (one lane launch per chunk), lane 0 cancelled
              at the first boundary, and c2's 4 windows as a dense group
              on a 30,720-doc hdfs split at 8,192 docs per chunk (at 10M
              docs the host chunk-plan rebase alone costs ~43 ms per chunk
              per lane);
            - `SearchService.leaf_search` from 8 threads over one split id,
              the rare terms, the first leader held at `batcher.dispatch`
              until all have entered; each response equal to
              `leaf_search_single_split` on the card, a group formed.
            Then per group, 20 warm iterations in turns: the stacked call
            against its Q solo calls back to back (wall p50/p90), profiler
            windows of both, and `score_topk_lanes` at the rare-term shape
            (per call, graph replay, Q solo launches by graph replay, the
            plain version, one `torch.topk` over [Q, P] scores, the bound).
11. fanout: the multi-split batch (`parallel/fanout.py`), with the
            counters zeroed again; every comparison and timing launch is
            counted apart. Splits in RAM storage: 64 otel splits of 524,288
            docs (seeds 0..63: `bench.py`'s config 5, 33.5M docs) and 8
            hdfs splits of 524,288 docs (seeds 100..107, with the
            generator's doc store, which phase 12 fetches). Each batch on the
            card is one program with no solo `score_topk` launch and must
            equal the per-split route merged by the collector on the card
            (f64 sums to rtol 1e-12, all else exactly):
            - c5: MatchAll, percentiles of span_duration_micros, max_hits=0
              over the 64 otel splits; over the first 8, the batch on the
              card equals the batch on the CPU;
            - the flagship over the 8 hdfs splits: one `score_topk_lanes`
              launch (against 8 `score_topk` launches per split); each
              lane's P is printed;
            - c2_bool_range_top100 and c2 by (timestamp, tenant_id) over
              the same splits;
            - `SearchService.leaf_search` over the 64 otel ids (Tiers A
              and B off, which would each route a max_hits=0 request per
              split: 8 pipelined batch groups) and over the 8 hdfs ids
              with the flagship (1 batch), each equal to a `batch_size=1`
              service: the `dispatch.launch` flight events with path
              "batch" and the programs must number 8 and 1, and a repeat
              stages 0 bytes;
            - a deadline that passes between dispatch and readback: the
              dispatch is abandoned, `qw_resident_readbacks_shed_total`
              rises by 1 and every split fails retryably.
            Then each batch timed in turns with its per-split calls (wall
            p50/p90, profiler windows, bytes staged per warm call, the
            batch's device bytes, splits per second of device time), and
            `score_topk_lanes` at the flagship's 8 unequal lanes.
12. root  : root search (`search/root.py`) over phase 11's splits, with the
            counters zeroed again; every comparison and timing launch is
            counted apart. A `FileBackedMetastore` over RAM storage holds
            hdfs-logs (the 8 hdfs splits, `HDFS_MAPPER`), otel-traces (the
            64 otel splits, `OTEL_BENCH_MAPPER`: BASELINE config 5 at
            `bench.py`'s size) and otel-traces-head (the first 8 otel
            splits), each split published with a `SplitMetadata` read from
            its own columns (num_docs, time range, column bounds). One node
            on the card (`SearcherContext(batch_size=8, device="cuda")`,
            its leaf cache and Tiers A and B off, so that every call runs
            its program and an agg-only request batches) behind a
            `LocalSearchClient`; a second root over the same metastore and
            bytes whose node is on the CPU. Each response must equal the
            CPU root's (`to_dict()` minus `elapsed_time_micros`, with each
            hit's split, doc, score and sort values; aggregation floats to
            rtol 1e-12, everything else exactly):
            - the flagship as the query string `severity_text:ERROR`,
              top-10 by score, its date_histogram and terms, and the 10
              documents fetched with severity_text snippets (one lane
              launch: one batch of 8 splits);
            - body_top10 as `body:<term>` with body snippets (the
              generator stores no body, so they come back empty);
            - c2 as an ES-DSL bool body, top-100 by timestamp desc, and its
              page 2 through `search_after`, equal to hits 101-200;
            - c5 over otel-traces (64 splits, max_hits=0: 8 batches in one
              leaf request), equal after finalize to phase 11's batch of
              64, and against the CPU root over otel-traces-head (the
              CPU over all 64 splits would take minutes);
            - a time range beyond every split: the metastore prunes them
              all, 0 leaf calls, 0 launches, the aggregation skeleton;
            - a two-node root (both nodes on the card) whose node-0 client
              fails its first leaf call: one retry, a response equal to the
              fault-free two-node root's;
            - a cold node with a 20 ms budget: a timed-out partial response
              and, once the abandoned dispatch ends, 0 bytes pinned.
            Then warm p50/p90 in turns: the flagship through the root
            beside the service's leaf call over the same 8 splits, and c5
            through the root beside phase 11's batch; the root's phases
            from a profiled call of each; a profiler window of 3 calls.
13. write : the node's write flow (`ingest/`, `indexing/`,
            `index/merge_arrays.py`, `compaction/`, `janitor/`), with the
            counters zeroed again; every comparison and timing launch is
            counted apart. One index over `HDFS_MAPPER` in a
            `FileBackedMetastore` and split files in a temporary directory
            outside the checkout, an `Ingester` with fsync on, an
            `IngestRouter` over one shard, a split target of 131,072 docs
            and a `stable_log` policy merging 4 splits:
            - ingest: 524,288 hdfs-logs docs made from
              `--seed` in requests of 4,096 (the last request alone
              carries tenant 10);
            - index: one `IngestSource` pipeline pass (`Node.
              run_ingest_pass`): 4 published splits of 131,072 docs, the
              WAL truncated behind the published checkpoint;
            - search A through a root over a node on the card, each
              response equal to a root over a CPU node on the same
              metastore: the flagship (term top-10 by BM25 with its
              aggregations), c2 as ES-DSL (bool + range top-100), c3 (the
              aggregations alone), tenant 10's count and every hit of a
              rare body term by timestamp; 10 warm flagship calls;
            - delete: a delete task on tenant 10 and `run_delete_planner`
              with its count probes on the card: exactly 1 split
              rewritten and 3 fast-forwarded (a fault on the card
              propagates from the probe; any other failed probe reads as
              a match and would show as a rewrite); then search A, with
              tenant 10's count 0;
            - merge: one compaction pass (`CompactionPlanner`,
              `CompactorSupervisor`): one merged split of 520,192 docs
              over the array fast path, no doc-level rewrite; search A
              equal to the CPU root, with the counts, the buckets and the
              rare term's stored docs of the step before (the timestamp
              reorder renumbers doc ids);
            - gc past the deletion grace: only the merged split's file
              stays; search A once more.
            It prints each step's seconds, docs per second of ingest and
            index, the flagship's p50 over the 4 indexed splits and over
            the merged one, and the launches of each step.
14. sources: external sources and the control plane (`indexing/{kafka,
            kinesis,sqs,cooperative}.py` and their fakes, `cluster/`,
            `control_plane/`, `common/actors.py`), with the counters
            zeroed again (`SourcesFlow`):
            - setup: a `FakeKafkaBroker` (topic `hdfs-logs`, 8
              partitions), a `FakeKinesisServer` (4 shards) and a
              `FakeSqsServer` whose queue gets one S3 event per ndjson
              file landed in a `FakeS3Server`, all on 127.0.0.1 port 0;
              one index per source over `HDFS_MAPPER` in a
              `FileBackedMetastore` (split target 131,072); a `Cluster`
              of three indexers on a `FakeClock`; the
              `IndexingScheduler`'s plan of the three (index, source)
              tasks; each planned pipeline a supervised actor on one
              `Universe`, its turns gated by a `CooperativeIndexingCycle`
              (2 permits per indexer) around one `IndexingPipeline.
              run_to_completion()` over the indexer's `make_source`
              client;
            - first half: 131,072 Kafka docs (16,384 per partition, one
              record batch each), 32,768 Kinesis records, 8 files of
              4,096 docs, all made from `--seed` by `write_docs`; one
              turn per pipeline;
            - move: the Kafka task's indexer stops heartbeating, the
              clock passes `dead_after_secs`, the re-plan moves the Kafka
              task and keeps the others (drift before the plan is
              applied, none after);
            - second half: the rest, drained with the new owner resuming
              Kafka from the metastore checkpoint, then one more turn (SQS
              acknowledges published files on the pass after);
            - exactly once: each index's published docs equal what its
              source produced, every checkpoint at its end (each
              partition at its high watermark, each shard at its last
              sequence number, each file at EOF), every SQS message
              deleted;
            - search, on the real clock: the flagship (which must launch
              `score_topk_lanes`), c2 as ES-DSL and c3 over each index
              through a root over a node on the card, each equal to a
              root over a CPU node, and the exactly-once searches (each
              severity's count, a rare term's hits with their stored
              docs, each doc once); 10 warm flagship calls per index;
            - gossip: two `GossipService`s on loopback UDP under a
              `ScaledClock` discover each other and one ages out of the
              other's `Cluster` (at most 10 s).
            It prints the plans, each step's seconds, docs per second per
            source, CRC32C's thread seconds and share of the phase, the
            flagship's p50 per index and the launches per request.
15. serve : the node and its REST front door (`serve/{node,rest}.py`,
            `cli.py`, `client.py`), with the counters zeroed again; every
            comparison and timing launch is counted apart:
            - part A, the node as users start it: `python -u -m
              quickwit_tpu_torch.cli run` in a subprocess configured by
              the environment alone (`QW_REST_PORT=0`, a `file://`
              metastore and index root in a temporary directory outside
              the checkout, no `QW_DEVICE`: the node runs on `cuda`),
              its port read from its "listening on" line; through the
              port's `QuickwitClient`, an index over `HDFS_MAPPER`'s
              fields (split target 131,072) and 262,144 docs from
              `write_docs(--seed)` in two ndjson requests (two published
              splits); then the flagship (query string, top-10 by score,
              its aggregations), c2 (ES-DSL bool + range, top-100 by
              timestamp desc), c3 (the aggregations alone) and an ES
              scroll over c2 in three pages of 100 (equal to a top-300
              request), each equal as JSON to an in-process CPU node's
              (`NodeConfig(device="cpu", roles=("searcher",))`) over the
              same files; the published splits unchanged; 20 warm
              flagship calls over REST; SIGINT, exit 0 within 10 s. Its
              launches are not counted: they happen in the subprocess;
            - part B, REST over phase 12's splits: a node on the card over
              phase 12's metastore files and phase 11's bytes behind a
              `RestServer` on port 0: the flagship (one `score_topk_lanes`
              launch: one batch of 8 splits) equal to phase 12's root
              response as `rest.py` serializes it, c5 over the 64 otel
              splits through `_elastic` equal to phase 12's, 8 concurrent
              searches of distinct rare body terms each equal to the same
              request alone through a CPU node, the developer routes
              (debug, `/metrics` as Prometheus text, the Chrome trace with
              this phase's dispatch events), and the flagship's REST
              p50/p90 in turns with the same node's root call, beside
              phase 12's root p50.
            It prints each step's seconds, the ingest docs/s and part
            B's launches.
16. grpc  : the gRPC plane (`serve/{grpc_server,http2,hpack_huffman,
            binwire}.py`), the SQL metastore (`metastore/sql.py`) and the
            offload pool (`offload/*`), over phase 11's bytes and a
            `sqlite://` metastore in a temporary directory filled through
            the metastore API with phase 12's records, with the counters
            zeroed again; every comparison and timing launch is counted
            apart. Part A: three nodes on the card in this process, each
            with `grpc_port=0` and each a member of the others' cluster;
            the root on node 0 reaches its peers through
            `GrpcSearchClient` (its LeafSearch RPCs counted); the flagship over the 8 hdfs splits and c5 over the
            64 otel splits each equal to phase 12's root response; then 20
            warm calls of one leaf request (the flagship over the 8 hdfs
            splits) to one peer, through gRPC and HTTP in turns, with
            their payload bytes in binwire and JSON; an OTLP trace export
            over gRPC read back through Jaeger `GetTrace`. Part B, after
            part A's nodes stop and their resident columns are evicted:
            worker nodes W1 and W2 (searcher role) and node M with
            `offload={"endpoints": [W1, W2], "max_local_splits": 16}`
            (restarted before each run, so it cuts the same 16 local
            splits): c5 equal to phase 12's with 48 splits on the workers
            and none back; a scored leaf request over the 64 otel splits
            through another offloading node, equal to a node without
            offload, launching `score_topk_lanes`; c5 through those two
            nodes in turns, 20 warm calls of distinct percentiles (no
            cache answers); W2's listener stopped (a retry, still 48 remote,
            none back); W1's too (all 48 run on M's card).
17. mesh  : the fan-out's device mesh (`parallel/mesh.py`, the mesh route
            of `parallel/fanout.py`) over phase 11's splits, with the
            counters zeroed again; every comparison and timing launch is
            counted apart. Meshes of the one card repeated at the split
            axes of the JAX suite's shapes, 2, 4 and 8 rows: the flagship,
            c2 and c2
            by (timestamp, tenant_id) over the 8 hdfs splits and c5 over
            the 64 otel splits, each equal to the single-device batch
            (hits, sort-value bits and counts exactly, f64 agg sums to rtol
            1e-12), a scored request launching `score_topk_lanes`
            ceil(row splits / 16) times on each row and no solo
            `score_topk`, and the `qw_mesh_*` deltas (one dispatch, the
            grid's rows, no threshold round; the collective bytes printed,
            held against the JAX package by the CPU tests). Two seeded
            splits with 12 NaN gains,
            by gain desc and asc: the mesh equals the single-device batch,
            which equals the CPU's (the NaN hits first, then last).
            Two query groups of 4 flagship variants (time windows; terms
            sizes, one lane launch per row) on a 2-row mesh, each equal to
            its solo batches. A `SearcherContext` with `mesh_devices` of
            the card repeated 4 times: one mesh dispatch (`dispatch.launch`
            with mesh 4), equal to a single-device service, and a warm
            repeat that stages 0 bytes. 20 warm flagship calls in turns on
            a 4-row mesh and as the single-device batch (wall p50/p90: the
            mesh's cost on one card). Then `POST /api/v1/_sql` on a node on
            the card over phase 12's metastore: a GROUP BY with COUNT, AVG
            and APPROX_PERCENTILE and a DATE_TRUNC group over the 8-split
            otel index, a WHERE ... ORDER BY ... LIMIT projection over the
            hdfs index (the otel splits hold no documents), each equal to
            `execute_sql` over a root on a CPU node.

Its last lines are the card's name and power limit, one JSON object with a
row per kernel, and `{"ok": true, "device": {...}}`. Without a GPU, or
without the rest of the repository beside it, it exits non-zero and prints
no result.

`tests/test_torch_write_path.py` imports `write_docs` and its constants from
this module, so the CPU tests and phase 13 make their docs the same way.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import queue
import random
import resource
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
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


def lane_cases(torch, q, seed, num_docs, dev):
    """`q` lanes for the lane kernel: unequal lengths (3 postings to 1M),
    lane 1 all invalid, lanes 2 and 5 views past a 16-byte boundary."""
    lengths = [1_000_000, 1024, 4097, 3, 131_072, 5001, 700, 64_000]
    lanes = []
    for i in range(q):
        ids, tfs, norms, idf, avg = score_topk_case(
            torch, lengths[i % len(lengths)] + i, seed + i, num_docs,
            all_invalid=(i == 1))
        ids, tfs, norms = ids.to(dev), tfs.to(dev), norms.to(dev)
        if i % 3 == 2:
            ids, tfs = misaligned(torch, ids, 1), misaligned(torch, tfs, 3)
        lanes.append((ids, tfs, norms, np_f32(idf * (1 + 0.1 * i)),
                      np_f32(avg + i), num_docs))
    return lanes


def np_f32(x):
    import numpy as np
    return np.float32(x)


def check_score_topk_lanes(torch, st, dev) -> float:
    """The lane kernel against its plain version and against one solo
    launch per lane, bit for bit (values and indices, dead lanes
    included), for Q in {1, 2, 5, 16} and k in {10, 64} (both NS
    instantiations), over unequal, misaligned and all-invalid lanes; then
    100 launches back to back with the lane count moving."""
    num_docs = 10_000_000
    worst = 0.0
    for q in (1, 2, 5, 16):
        for k in (10, 64):
            lanes = lane_cases(torch, q, 100 * q + k, num_docs, dev)
            before = st.score_topk_lanes.launches
            vals, idx = st.score_topk_lanes(lanes, k)
            if st.score_topk_lanes.launches != before + 1:
                raise AssertionError(f"lanes q={q} k={k}: not one launch")
            want = st.score_topk_lanes_reference(lanes, k)
            solo = [st.score_topk(*lane, k) for lane in lanes]
            torch.cuda.synchronize()
            for row, lane in enumerate(lanes):
                if not (torch.equal(vals[row], solo[row][0])
                        and torch.equal(idx[row], solo[row][1])):
                    raise AssertionError(f"lanes q={q} k={k} row {row}: "
                                         "differs from its solo launch")
                num_valid = int(((lane[1] > 0) & (lane[0] < num_docs)).sum())
                worst = max(worst, compare_winners(
                    torch, (vals[row], idx[row]),
                    (want[0][row], want[1][row]), num_valid, k))
            say(f"kernel score_topk_lanes q={q} k={k}: P="
                f"{[lane[0].shape[0] for lane in lanes]} equal_to_solo="
                "True equal_to_plain=True")
    lanes = lane_cases(torch, 16, 7, num_docs, dev)
    want = [st.score_topk(*lane, 10) for lane in lanes]
    outs = [st.score_topk_lanes(lanes if i % 2 else lanes[:3], 10)
            for i in range(100)]
    torch.cuda.synchronize()
    for vals, idx in outs:
        for row in range(vals.shape[0]):
            if not (torch.equal(vals[row], want[row][0])
                    and torch.equal(idx[row], want[row][1])):
                raise AssertionError("lanes back_to_back: a launch left "
                                     "its grid state dirty")
    say("kernel score_topk_lanes back_to_back: 100 launches of 16 and 3 "
        "lanes on one stream, all equal to solo launches")
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


def hit_tuples(hits):
    return [(h.split_id, h.doc_id, h.sort_value, h.raw_sort_value,
             h.sort_value2, h.raw_sort_value2) for h in hits]


def hit_key(resp):
    return hit_tuples(resp.partial_hits)


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
    arrays, _, _ = leaf.warmup_device_arrays(reader, plan, device=dev)
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
        c2_plan, leaf.warmup_device_arrays(reader, c2_plan, device=dev)[0],
        dev)
    cpu_mask, _ = ex.compute_packed_mask(
        c2_plan, leaf.warmup_device_arrays(reader, c2_plan, device="cpu")[0],
        "cpu")
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
# phase 7: phrase (BASELINE config 4) over a split file

SO_SEED = 11    # bench.py's stackoverflow seed
C4_TEXT = "t000010 t000011"
DAY_US = 86400 * 1_000_000


def phrase_requests(SearchRequest, FullText, PhrasePrefix, Bool, Range,
                    RangeBound, time_range) -> dict:
    """`bench.py`'s c4_phrase_bm25_top20 and its variants: slop 2, a phrase
    prefix, and the phrase filtered to the last 30 days of the split."""
    def req(query):
        return SearchRequest(index_ids=["stackoverflow"], query_ast=query,
                             max_hits=20)

    c4 = FullText("body", C4_TEXT, mode="phrase")
    last_30_days = Range("creation_date",
                         lower=RangeBound(time_range[1] - 30 * DAY_US, True),
                         upper=RangeBound(time_range[1], True))
    return {
        "c4_phrase_bm25_top20": req(c4),
        "c4_slop2": req(FullText("body", C4_TEXT, mode="phrase", slop=2)),
        "c4_phrase_prefix": req(PhrasePrefix("body", "t000010 t00001")),
        "c4_bool_last_30_days": req(Bool(must=(c4,),
                                         filter=(last_30_days,))),
    }


def io_mark(counters):
    return counters.get_slice, counters.get_slice_bytes, counters.get_all


def io_delta(counters, before) -> str:
    """The reads and bytes since `before` (an `io_mark`)."""
    now = io_mark(counters)
    return (f"reads={now[0] - before[0] + now[2] - before[2]} "
            f"bytes={now[1] - before[1]}")


def check_phrase(leaf, st, ex, pruning, mapper, reqs, open_reader, counters,
                 dev) -> dict:
    """Phase 7's requests on the card, each against its CPU run on the same
    reader. c4 and its slop-2 form launch score_topk once per call; the
    phrase prefix, the Bool and the threshold request launch none. Returns
    {name: (reader, request, cuda response)}."""
    out = {}
    mark = io_mark(counters)
    reader = open_reader()
    say(f"phrase split open (cold, through CountingStorage): "
        f"{io_delta(counters, mark)}")

    def both(name, req, on=None, threshold=None, launches=0):
        on = on or reader
        mark = io_mark(counters)
        before = st.score_topk.launches
        plan, gpu = run_split(leaf, mapper, req, on, dev, threshold=threshold)
        launched = st.score_topk.launches - before
        io = io_delta(counters, mark)
        _, cpu = run_split(leaf, mapper, req, on, "cpu", threshold=threshold)
        if response_key(gpu) != response_key(cpu):
            raise AssertionError(f"{name}: cuda response differs from cpu")
        if gpu.num_hits <= 0 or len(gpu.partial_hits) != min(
                req.max_hits, gpu.num_hits):
            raise AssertionError(f"{name}: unexpected hit count")
        if launched != launches:
            raise AssertionError(f"{name}: score_topk launched {launched} "
                                 f"times, not {launches}")
        say(f"phrase {name}: num_hits={gpu.num_hits} "
            f"posting_space={ex._posting_space_eligible(plan)} "
            f"score_topk_launches={launched} "
            f"top_doc_ids={[h.doc_id for h in gpu.partial_hits[:10]]} "
            f"equal_to_cpu=True; cuda call {io}")
        out[name] = (on, req, gpu)
        return plan, gpu

    _, c4 = both("c4_phrase_bm25_top20", reqs["c4_phrase_bm25_top20"],
                 launches=1)
    # the same reader, right after the exact phrase of the same terms
    _, slop2 = both("c4_slop2", reqs["c4_slop2"], launches=1)
    _, fresh = both("c4_slop2_fresh_reader", reqs["c4_slop2"],
                    on=open_reader(), launches=1)
    if hit_key(slop2) == hit_key(c4) or response_key(slop2) != \
            response_key(fresh):
        raise AssertionError("c4_slop2: the sloppy phrase reused the exact "
                             "phrase's postings")
    plan, _ = both("c4_phrase_prefix", reqs["c4_phrase_prefix"])
    if type(plan.root).__name__ != "PBool" or not plan.root.should:
        raise AssertionError("c4_phrase_prefix: not a Bool should root")
    both("c4_bool_last_30_days", reqs["c4_bool_last_30_days"])
    req = reqs["c4_phrase_bm25_top20"]
    threshold = pruning.threshold_from_response(req, mapper, c4)
    plan, cut = both("c4_threshold", req, threshold=threshold)
    if threshold is None or plan.threshold_slot < 0 or \
            hit_key(cut) != hit_key(c4):
        raise AssertionError("c4_threshold: no pushdown, or hits differ "
                             "from the run without it")
    return out


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


def time_request(torch, leaf, st, ex, score_postings, name, mapper,
                 split_reader, req, dev, iters, flush, label, here,
                 leaf_times=None):
    """Phase 6's timing of one request: warm p50/p90 of the leaf call and of its
    phases, a profiler window, and, for a scored posting-space plan, the
    kernel at the request's shape. Records the leaf call's (p50, p90) ms
    in `leaf_times[name]` when given. Returns (kernel row or None, the
    kernel's max abs error against its plain version)."""
    plan = leaf.prepare_plan_only(req, mapper, split_reader, "split-0")
    arrays, _, _ = leaf.warmup_device_arrays(split_reader, plan, device=dev)
    # the whole leaf call, warm (arrays resident), host clock; the call
    # ends in the packed readback, which synchronizes
    walls, phases = [], {"plan": [], "stage": [], "execute": []}
    for _ in range(iters):
        t0 = time.perf_counter()
        leaf.leaf_search_single_split(req, mapper, split_reader,
                                      "split-0", device=dev)
        walls.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        p = leaf.prepare_plan_only(req, mapper, split_reader, "split-0")
        t1 = time.perf_counter()
        a, staged, _ = leaf.warmup_device_arrays(split_reader, p,
                                                 device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        leaf.execute_prepared_split(req, mapper, split_reader, "split-0",
                                    p, a, dev)
        t3 = time.perf_counter()
        phases["plan"].append((t1 - t0) * 1e3)
        phases["stage"].append((t2 - t1) * 1e3)
        phases["execute"].append((t3 - t2) * 1e3)
    os.makedirs(os.path.join(here, "chip_traces"), exist_ok=True)
    summary = device_profile(
        torch, lambda: leaf.leaf_search_single_split(
            req, mapper, split_reader, "split-0", device=dev), 5,
        os.path.join(here, "chip_traces", f"trace_{name}.json"))
    say(f"[{label}] profile {name}: {summary}")
    staged_cold = sum(arr.nbytes for arr in plan.arrays)
    if leaf_times is not None:
        leaf_times[name] = (pct(walls, 0.5), pct(walls, 0.9))
    say(f"[{label}] leaf {name}: warm_p50_ms={pct(walls, 0.5):.4f} "
        f"warm_p90_ms={pct(walls, 0.9):.4f} iters={iters} "
        + " ".join(f"{ph}_p50_ms={pct(v, 0.5):.4f}"
                   for ph, v in phases.items())
        + f" staged_bytes_cold={staged_cold} staged_bytes_warm={staged}")

    # the kernel at this request's shape
    if not (ex._posting_space_eligible(plan) and plan.sort.by == "score"
            and plan.root.scoring):
        return None, 0.0
    root = plan.root
    return kernel_row(torch, st, score_postings, name,
                      arrays[root.ids_slot], arrays[root.tfs_slot],
                      arrays[root.norm_slot], plan.scalars[root.idf_slot],
                      plan.scalars[root.avg_len_slot], plan.num_docs,
                      min(req.max_hits, arrays[root.ids_slot].shape[0]),
                      iters, flush, label)


def kernel_row(torch, st, score_postings, name, ids, tfs, norms, idf, avg,
               num_docs, k, iters, flush, label):
    """score_topk at one shape: per-call and graph-replay ms, the plain
    version's and `torch.topk`'s ms, the bound and the sector floor, and
    the winners against the plain version. Its launches are put back: they
    are not a path's. Returns (row, max abs error)."""
    P = ids.shape[0]
    before = st.score_topk.launches
    kernel_ms = cuda_ms(torch, lambda: st.score_topk(
        ids, tfs, norms, idf, avg, num_docs, k), iters, flush)
    device_ms = graph_ms(torch, lambda: st.score_topk(
        ids, tfs, norms, idf, avg, num_docs, k), iters, flush)
    st.score_topk.launches = before   # timing launches are not the path's
    plain_ms = cuda_ms(torch, lambda: st.score_topk_reference(
        ids, tfs, norms, idf, avg, num_docs, k), iters, flush)
    scores = score_postings(tfs, ids, norms, avg, idf)
    scores = torch.where((tfs > 0) & (ids < num_docs), scores,
                         float("-inf"))
    library_ms = cuda_ms(torch, lambda: torch.topk(scores, k),
                         iters, flush)
    got = st.score_topk(ids, tfs, norms, idf, avg, num_docs, k)
    st.score_topk.launches = before
    want = st.score_topk_reference(ids, tfs, norms, idf, avg,
                                   num_docs, k)
    num_valid = int(((tfs > 0) & (ids < num_docs)).sum())
    err = compare_winners(torch, got, want, num_valid, k)
    # bytes: ids + tfs + one gathered norm per posting, read once; the
    # k (f32, i64) winners written once. ops: ~11 f32 ops per posting.
    nbytes = 12 * P + 12 * k
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = 11 * P / H100_F32_OPS_PER_S * 1e3
    # the floor the bound does not show: each gathered norm moves its
    # whole 32-byte sector, so count the distinct sectors this run's
    # valid postings touch, beside the streamed ids and tfs
    live = (tfs > 0) & (ids < num_docs)
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
    return {
        "at": name, "P": P, "k": k,
        "ms": kernel_ms, "graph_replay_ms": device_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "sector_floor_ms": sector_ms, "library_ms": library_ms}, err


# --------------------------------------------------------------------------
# phase 8: the node's search service

def count_device_events(torch, fn, out_path: str) -> int:
    """Kernels, copies and fills the card ran in a profiler window around
    `fn` (its Chrome trace goes to `out_path`)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(out_path)
    with open(out_path) as fh:
        events = json.load(fh).get("traceEvents", [])
    return sum(1 for ev in events if ev.get("ph") == "X" and ev.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset"))


def host_breakdown(svc_mod, call, iters: int) -> str:
    """Mean ms per call of a service call's parts over `iters` warm calls:
    what the leaf call does too (lowering, the staging lookup, the program
    and its readback) and what only the service does (named here, and the
    rest). The parts are timed by wrapping the functions the service calls
    for the length of this measurement only."""
    parts = {"prepare_plan_only": (svc_mod, "prepare_plan_only"),
             "warmup_device_arrays": (svc_mod, "warmup_device_arrays"),
             "execute_prepared_split": (svc_mod, "execute_prepared_split"),
             "leaf_cache_put": (svc_mod.LeafSearchCache, "put"),
             "canonical_request_key": (svc_mod, "canonical_request_key"),
             "doc_mapper_from_dict": (svc_mod.DocMapper, "from_dict"),
             "collector_add": (svc_mod.IncrementalCollector,
                               "add_leaf_response")}
    spent = dict.fromkeys(parts, 0.0)
    saved = {part: vars(owner)[attr] for part, (owner, attr) in parts.items()}

    def timed(part, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[part] += time.perf_counter() - t0
        return wrapper

    for part, (owner, attr) in parts.items():
        setattr(owner, attr, timed(part, getattr(owner, attr)))
    try:
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
        total = time.perf_counter() - t0
    finally:
        for part, (owner, attr) in parts.items():
            setattr(owner, attr, saved[part])
    out = {part: round(sec / iters * 1e3, 4) for part, sec in spent.items()}
    out["rest"] = round((total - sum(spent.values())) / iters * 1e3, 4)
    return f"total={total / iters * 1e3:.4f} " + json.dumps(out)


def check_service(torch, st, mods, storage, num_docs, reqs, dev, iters,
                  label, here, leaf_times) -> None:
    """Phase 8: `SearchService.leaf_search` on `cuda` over two split ids of
    phase 3's split, each response against a cpu context over the same
    resolver, with the warm, reopen, Tier A/B/C and eviction checks, then
    the service's warm timing."""
    import dataclasses
    svc_mod, leaf_mod, models, metrics, residency, admission, Protocol, \
        StorageResolver, HDFS_MAPPER = mods
    data = storage.get_all("hdfs.split")
    split_ids = ("hdfs_a", "hdfs_b")
    for split_id in split_ids:          # the same bytes object, no rebuild
        storage.put(f"{split_id}.split", data)
    resolver = StorageResolver()
    resolver.register(Protocol.RAM, lambda _uri: storage)
    splits = [models.SplitIdAndFooter(split_id, "ram:///chip_smoke",
                                      len(data), num_docs=num_docs)
              for split_id in split_ids]
    del data

    def context(device, **kw):
        # the per-split route (phase 11 drives the batch route)
        kw.setdefault("batch_size", 1)
        ctx = svc_mod.SearcherContext(storage_resolver=resolver,
                                      device=device, **kw)
        return svc_mod.SearchService(ctx), ctx

    def leaf(service, req, on=splits):
        resp = service.leaf_search(models.LeafSearchRequest(
            search_request=req, index_uid="hdfs-logs:0",
            doc_mapping=HDFS_MAPPER.to_dict(), splits=list(on)))
        if resp.failed_splits:
            raise AssertionError(f"service: failed splits "
                                 f"{resp.failed_splits}")
        return resp

    def counter(name):
        return getattr(metrics, name).get()

    gpu, gpu_ctx = context(dev)
    cpu, _ = context("cpu")
    cold_gpu, _ = context(dev, resident_columns=False, leaf_cache_bytes=0,
                          enable_mask_cache=False, enable_agg_cache=False)

    def against_cpu(name, req, got):
        want = leaf(cpu, req)
        if response_key(got) != response_key(want):
            raise AssertionError(f"service {name}: cuda response differs "
                                 f"from the cpu context's")
        if got.num_hits <= 0:
            raise AssertionError(f"service {name}: no hits")
        return want

    # cold: every request once on cuda, each against the cpu context
    gc.collect()
    torch.cuda.synchronize()
    allocated0 = torch.cuda.memory_allocated(dev)
    staged0 = counter("STAGING_BYTES_TOTAL")
    launches = {}
    cold = {}
    for name, req in reqs.items():
        before = st.score_topk.launches
        cold[name] = leaf(gpu, req)
        launches[name] = st.score_topk.launches - before
        against_cpu(name, req, cold[name])
    torch.cuda.synchronize()
    staged_cold = counter("STAGING_BYTES_TOTAL") - staged0
    delta = torch.cuda.memory_allocated(dev) - allocated0
    resident = gpu_ctx.hbm_budget.stats()["resident"]
    store_bytes = gpu_ctx.resident_store.stats()["bytes"]
    say(f"[{label}] service cold: num_hits="
        f"{json.dumps({n: r.num_hits for n, r in cold.items()})} "
        f"score_topk_launches={json.dumps(launches)} "
        f"staged_bytes_cold={staged_cold:.0f} budget_resident_bytes="
        f"{resident} store_bytes={store_bytes} (the seeded masks ride "
        f"outside admission) memory_allocated_delta={delta} "
        f"slack_bytes={delta - store_bytes} equal_to_cpu=True")
    if launches != {"flagship": len(splits), "c2_bool_range_top100": 0,
                    "c2_by_timestamp": 0, "c2_dashboard": 0}:
        raise AssertionError(f"service: score_topk launches {launches}")

    # warm repeat at another page size: leaf-cache miss, resident columns
    def warm_check(service, tag):
        for name, max_hits in (("flagship", 7), ("c2_bool_range_top100", 50)):
            req = dataclasses.replace(reqs[name], max_hits=max_hits)
            hits0 = counter("RESIDENT_STAGING_CACHE_HITS")
            miss0 = counter("RESIDENT_COLUMN_MISSES")
            staged = counter("STAGING_BYTES_TOTAL")
            got = leaf(service, req)
            d_hits = counter("RESIDENT_STAGING_CACHE_HITS") - hits0
            d_miss = counter("RESIDENT_COLUMN_MISSES") - miss0
            d_staged = counter("STAGING_BYTES_TOTAL") - staged
            against_cpu(f"{name} {tag}", req, got)
            if hit_key(got) != hit_key(cold[name])[:max_hits] or \
                    got.num_hits != cold[name].num_hits:
                raise AssertionError(f"service {name} {tag}: hits differ "
                                     f"from the cold run's")
            say(f"[{label}] service {tag} {name}: max_hits={max_hits} "
                f"staging_cache_hits=+{d_hits:.0f} column_misses=+"
                f"{d_miss:.0f} staged_bytes_warm={d_staged:.0f} "
                f"equal_to_cpu=True")
            if d_hits != len(splits) or d_miss != 0 or d_staged != 0:
                raise AssertionError(f"service {name} {tag}: the warm call "
                                     f"staged columns")

    warm_check(gpu, "warm")
    reopen, _ = context(dev, max_open_splits=1)
    leaf(reopen, reqs["flagship"])
    leaf(reopen, reqs["c2_bool_range_top100"])
    warm_check(reopen, "reopen")
    del reopen

    # Tier A: c2's filter by timestamp at a new page size is a mask hit
    req = dataclasses.replace(reqs["c2_by_timestamp"], max_hits=50)
    hits0 = counter("MASK_CACHE_HITS_TOTAL")
    pred0 = counter("PREDICATE_STAGED_BYTES_TOTAL")
    got = leaf(gpu, req)
    d_hits = counter("MASK_CACHE_HITS_TOTAL") - hits0
    d_pred = counter("PREDICATE_STAGED_BYTES_TOTAL") - pred0
    against_cpu("tier_a", req, got)
    if response_key(got) != response_key(leaf(cold_gpu, req)):
        raise AssertionError("service tier_a: differs from its cold run")
    say(f"[{label}] service tier_a c2_by_timestamp: max_hits=50 "
        f"mask_hits=+{d_hits:.0f} predicate_staged_bytes=+{d_pred:.0f} "
        f"equal_to_cold_and_cpu=True")
    if d_hits != len(splits) or d_pred != 0:
        raise AssertionError("service tier_a: not a zero-staging mask hit")

    # Tier B: the dashboard's aggregations renamed (a leaf-cache miss)
    # come from the partial-agg cache alone
    served = []
    serve = gpu._serve_from_agg_cache

    def counting_serve(request, split):
        out = serve(request, split)
        served.append(out is not None)
        return out

    gpu._serve_from_agg_cache = counting_serve
    dash = reqs["c2_dashboard"]
    req = dataclasses.replace(dash, aggs={f"panel_{k}": v
                                          for k, v in dash.aggs.items()})
    before = st.score_topk.launches
    out = {}
    events = count_device_events(
        torch, lambda: out.setdefault("r", leaf(gpu, req)),
        os.path.join(here, "chip_traces", "trace_service_tier_b.json"))
    tier_b_launches = st.score_topk.launches - before
    del gpu._serve_from_agg_cache
    against_cpu("tier_b", req, out["r"])
    # the window sees the card when it works: a warm call with a program
    control = count_device_events(
        torch, lambda: leaf(gpu, dataclasses.replace(reqs["flagship"],
                                                     max_hits=9)),
        os.path.join(here, "chip_traces", "trace_service_control.json"))
    say(f"[{label}] service tier_b c2_dashboard renamed: "
        f"served_from_agg_cache={served} score_topk_launches="
        f"{tier_b_launches} device_events={events} (a warm flagship call "
        f"in the same window: {control}) equal_to_cpu=True")
    if served != [True] * len(splits) or tier_b_launches or events or \
            control <= 0:
        raise AssertionError("service tier_b: not served by the partial-agg "
                             "cache without the card")

    # Tier C: a byte-identical repeat of the flagship
    hits0 = counter("LEAF_CACHE_HITS_TOTAL")
    before = st.score_topk.launches
    out = {}
    events = count_device_events(
        torch, lambda: out.setdefault("r", leaf(gpu, reqs["flagship"])),
        os.path.join(here, "chip_traces", "trace_service_tier_c.json"))
    d_hits = counter("LEAF_CACHE_HITS_TOTAL") - hits0
    tier_c_launches = st.score_topk.launches - before
    if response_key(out["r"]) != response_key(cold["flagship"]):
        raise AssertionError("service tier_c: differs from the cold run")
    say(f"[{label}] service tier_c flagship repeat: leaf_cache_hits=+"
        f"{d_hits:.0f} score_topk_launches={tier_c_launches} "
        f"device_events={events} equal_to_cold=True")
    if d_hits != len(splits) or tier_c_launches or events:
        raise AssertionError("service tier_c: not a leaf-cache hit")

    # eviction under a budget of 1.5 splits, alternating the splits
    no_tiers = dict(leaf_cache_bytes=0, enable_mask_cache=False,
                    enable_agg_cache=False)
    probe, probe_ctx = context(dev, **no_tiers)
    leaf(probe, reqs["flagship"], splits[:1])
    per_split = probe_ctx.hbm_budget.stats()["resident"]
    del probe, probe_ctx
    pressured, p_ctx = context(dev, **no_tiers)
    p_ctx.hbm_budget = admission.HbmBudget(budget_bytes=int(1.5 * per_split))
    drops = []
    clear = residency._NotifyingCache.clear

    def measured_clear(cache):
        held = p_ctx.resident_store.stats()["by_split"].get(
            cache._split_id, 0)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        clear(cache)
        drops.append((cache._split_id, held,
                      before - torch.cuda.memory_allocated(dev)))

    evictions0 = counter("RESIDENT_EVICTIONS")
    residency._NotifyingCache.clear = measured_clear
    try:
        for _ in range(2):
            for split in splits:
                got = leaf(pressured, reqs["flagship"], [split])
                want = leaf(gpu, reqs["flagship"], [split])
                if response_key(got) != response_key(want):
                    raise AssertionError("service eviction: differs from "
                                         "the unpressured context")
    finally:
        residency._NotifyingCache.clear = clear
    evictions = counter("RESIDENT_EVICTIONS") - evictions0
    say(f"[{label}] service eviction: per_split_bytes={per_split} budget="
        f"{int(1.5 * per_split)} evictions=+{evictions:.0f} "
        f"(split, evicted_bytes, memory_allocated_drop)={json.dumps(drops)} "
        f"equal_to_unpressured=True")
    if evictions <= 0 or not drops or any(
            held <= 0 or freed < held for _, held, freed in drops):
        raise AssertionError("service eviction: memory_allocated did not "
                             "fall by the evicted bytes")
    del pressured, p_ctx

    # timing: warm calls over one split, the leaf cache off, in turns with
    # leaf_search_single_split on the same reader (its own per-reader
    # arrays), beside phase 6's times of the leaf call. Its launches are
    # not the path's: they are counted apart, and the count is put back.
    path_launches = st.score_topk.launches
    single_launches = 0
    for tiers, kw in (("tiers_a_b_on", {"leaf_cache_bytes": 0}),
                      ("all_tiers_off", no_tiers)):
        timed, timed_ctx = context(dev, **kw)
        reader = timed_ctx.reader(splits[0])
        for name in ("flagship", "c2_bool_range_top100"):
            def single():
                nonlocal single_launches
                before = st.score_topk.launches
                out = leaf_mod.leaf_search_single_split(
                    reqs[name], HDFS_MAPPER, reader, splits[0].split_id,
                    device=dev)
                single_launches += st.score_topk.launches - before
                return out
            leaf(timed, reqs[name], splits[:1])
            single()
            walls, single_walls = [], []
            for _ in range(iters):
                t0 = time.perf_counter()
                leaf(timed, reqs[name], splits[:1])
                t1 = time.perf_counter()
                single()
                walls.append((t1 - t0) * 1e3)
                single_walls.append((time.perf_counter() - t1) * 1e3)
            p50, p90 = leaf_times.get(name, (float("nan"),) * 2)
            say(f"[{label}] service timing {name} ({tiers}, one split): "
                f"warm_p50_ms={pct(walls, 0.5):.4f} warm_p90_ms="
                f"{pct(walls, 0.9):.4f} iters={iters}; in turns, "
                f"leaf_search_single_split warm_p50_ms="
                f"{pct(single_walls, 0.5):.4f} warm_p90_ms="
                f"{pct(single_walls, 0.9):.4f}; phase 6 "
                f"leaf_search_single_split warm_p50_ms={p50:.4f} "
                f"warm_p90_ms={p90:.4f}")
            if tiers == "all_tiers_off":
                say(f"[{label}] service host breakdown {name} (one split, "
                    f"mean ms per call): " + host_breakdown(
                        svc_mod, lambda: leaf(timed, reqs[name], splits[:1]),
                        iters))
        del timed
    timing_launches = st.score_topk.launches - path_launches
    say(f"[{label}] service timing launches (not the path's): "
        f"service_calls={timing_launches - single_launches} "
        f"leaf_search_single_split_calls={single_launches}")
    st.score_topk.launches = path_launches
    for split_id in split_ids:
        storage.delete(f"{split_id}.split")


# --------------------------------------------------------------------------
# phase 9: resumable chunked scans

POSTING_SPANS = {"flagship": 131_072, "body_top10": 524_288,
                 "body_top10_early_term": 524_288}
DOC_SPAN = 1_048_576


class CancelAtBoundary:
    """A fault injector that cancels `token` at the scan's first chunk
    boundary (observed at the next one) and notes when."""

    def __init__(self, token):
        self.token = token
        self.cancelled_at = None

    def perturb(self, operation):
        if operation == "kernel.chunk_yield" and self.cancelled_at is None:
            self.cancelled_at = time.perf_counter()
            self.token.cancel("chip_smoke cancel")


def early_term_threshold(reader, field, term, span):
    """The largest impact block bound whose pushed-down prefix (rounded up
    to a power of two of 128-posting blocks, as the lowering rounds it)
    spans at least three chunks of `span` postings and stops short of the
    term's end, so the plan carries the exact count (`count_override`)
    and the scan may stop early. Returns (threshold, prefix postings)."""
    import numpy as np
    info = reader.lookup_term(field, term)
    bmax, scale = reader.impact_term_bounds(field, info)
    bounds = bmax.astype(np.float64) * float(scale)
    for threshold in np.unique(bounds)[::-1]:
        live_blocks = 1
        while live_blocks < int(np.count_nonzero(bounds >= threshold)):
            live_blocks *= 2
        if 3 * span <= live_blocks * 128 < info.post_len:
            return float(threshold), live_blocks * 128
    raise AssertionError(f"{term}: no threshold prunes to 3+ chunks")


def check_chunked(torch, st, mods, reader, otel_reader, reqs, storage,
                  num_docs, dev, iters, label, here, flush) -> dict:
    """Phase 9: the resumable chunked scan through `leaf_search_single_split`
    and `SearchService.leaf_search`, with explicit spans, each response
    against the same call with chunking off (the fused program); the
    cancelled scan; the timings. Returns the path's score_topk launches and
    the kernel row at the chunk shape."""
    import dataclasses

    import numpy as np
    leaf, ex, ce, metrics, svc_mod, models, deadline, Protocol, \
        StorageResolver, HDFS_MAPPER, OTEL_MAPPER, score_postings = mods
    saved = (ce.CHUNKING, ce.CHUNK_SIZER)
    ce.CHUNKING, ce.CHUNK_SIZER = ce.ChunkConfig(), ce._ChunkSizer()
    try:
        def counter(name):
            return getattr(metrics, name).get()

        def spans_for(name):
            return {"posting_span": POSTING_SPANS.get(name),
                    "doc_span": DOC_SPAN}

        # name -> (mapper, reader, request, threshold)
        cases = {name: (HDFS_MAPPER, reader, reqs[name], None)
                 for name in ("flagship", "body_top10", "c2_bool_range_top100",
                              "c2_ts_tenant_top100")}
        for name in ("c5_otel_percentiles_1split", "otel_latency_by_service"):
            cases[name] = (OTEL_MAPPER, otel_reader, reqs[name], None)
        cases["c2_aggs"] = (HDFS_MAPPER, reader, reqs["c2_aggs"], None)
        body_term = reqs["body_top10"].query_ast.value
        threshold, prefix = early_term_threshold(
            reader, "body", body_term, POSTING_SPANS["body_top10_early_term"])
        cases["body_top10_early_term"] = (HDFS_MAPPER, reader,
                                          reqs["body_top10"], threshold)
        say(f"chunked body_top10_early_term: threshold={threshold!r} "
            f"(an impact block bound) keeps a prefix of {prefix} postings")

        def run(name, chunked, **kw):
            mapper, split_reader, req, thr = cases[name]
            ce.CHUNKING.set(enabled=chunked, **spans_for(name))
            return run_split(leaf, mapper, req, split_reader, dev,
                             threshold=thr, **kw)

        # the fused references, chunking off; their launches are not the path's
        before = st.score_topk.launches
        fused = {name: run(name, False)[1] for name in cases}
        c2_page1 = fused["c2_ts_tenant_top100"].partial_hits[-1]
        page2 = dataclasses.replace(reqs["c2_ts_tenant_top100"], search_after=[
            c2_page1.raw_sort_value, c2_page1.raw_sort_value2, "split-0",
            c2_page1.doc_id])
        cases["c2_ts_tenant_page2"] = (HDFS_MAPPER, reader, page2, None)
        fused["c2_ts_tenant_page2"] = run("c2_ts_tenant_page2", False)[1]
        fused_launches = st.score_topk.launches - before
        st.score_topk.launches = before

        def same(name, got, want):
            if got.num_hits != want.num_hits or hit_key(got) != hit_key(want):
                raise AssertionError(f"chunked {name}: hits differ from fused")
            assert_aggs_close(want.intermediate_aggs, got.intermediate_aggs,
                              f"chunked {name}")
            if got.failed_splits or got.num_hits <= 0:
                raise AssertionError(f"chunked {name}: failed or no hits")

        # the path, with the counters zeroed just before
        restarts0 = counter("CHUNK_RESTARTS_TOTAL")
        st.score_topk.launches = 0
        per_case = {}
        for name in cases:
            d0 = counter("CHUNK_DISPATCHES_TOTAL")
            e0 = counter("CHUNK_EARLY_TERMINATIONS_TOTAL")
            p0 = counter("SEARCH_KERNEL_LAUNCHES_TOTAL")
            k0 = st.score_topk.launches
            plan, got = run(name, True)
            mode = ce.chunk_mode(plan)
            total = (len(ce.chunk_spans(mode[1], spans_for(name)[
                "posting_span" if mode[0] == "posting" else "doc_span"],
                mode[2])) if mode else 1)
            same(name, got, fused[name])
            per_case[name] = {
                "mode": mode[0] if mode else None, "chunks": total,
                "dispatched": int(counter("CHUNK_DISPATCHES_TOTAL") - d0),
                "early_terminations": int(
                    counter("CHUNK_EARLY_TERMINATIONS_TOTAL") - e0),
                "programs": int(counter("SEARCH_KERNEL_LAUNCHES_TOTAL") - p0),
                "score_topk": st.score_topk.launches - k0}
            say(f"chunked {name}: {json.dumps(per_case[name])} num_hits="
                f"{got.num_hits} equal_to_fused=True")
        expect = {"flagship": (8, 8), "body_top10": (12, 12),
                  "c2_bool_range_top100": (10, 0),
                  "c2_ts_tenant_top100": (10, 0),
                  "c2_ts_tenant_page2": (10, 0),
                  "c5_otel_percentiles_1split": (10, 0),
                  "otel_latency_by_service": (10, 0), "c2_aggs": (0, 0)}
        for name, (dispatched, launched) in expect.items():
            got = per_case[name]
            if (got["dispatched"], got["score_topk"]) != (dispatched,
                                                          launched):
                raise AssertionError(
                    f"chunked {name}: {got}, expected {dispatched} chunks, "
                    f"{launched} launches")
        if per_case["c2_aggs"]["mode"] is not None or \
                per_case["c2_aggs"]["programs"] != 1:
            raise AssertionError("chunked c2_aggs: a composite plan chunked")
        early = per_case["body_top10_early_term"]
        if early["score_topk"] != 0 or early["chunks"] < 3:
            raise AssertionError(f"chunked body_top10_early_term: {early}")

        # cancel: the flagship cancelled at boundary 1, observed at boundary 2
        mapper, _, req, _ = cases["flagship"]
        ce.CHUNKING.set(enabled=True, **spans_for("flagship"))
        plan = leaf.prepare_plan_only(req, mapper, reader, "split-0")
        arrays, _, _ = leaf.warmup_device_arrays(reader, plan, device=dev)
        token = deadline.CancellationToken()
        shim = CancelAtBoundary(token)
        d0 = counter("CHUNK_DISPATCHES_TOTAL")
        k0 = st.score_topk.launches
        with deadline.cancel_scope(token):
            cut = leaf.execute_prepared_split(req, mapper, reader, "split-0",
                                              plan, arrays, dev,
                                              fault_injector=shim)
        returned = time.perf_counter()
        dispatched = int(counter("CHUNK_DISPATCHES_TOTAL") - d0)
        if not (len(cut.failed_splits) == 1 and cut.failed_splits[0].error
                .startswith("query cancelled: progressive partial results")
                and dispatched == 2 and st.score_topk.launches - k0 == 2
                and 0 < cut.num_hits < fused["flagship"].num_hits):
            raise AssertionError(f"chunked cancel: dispatched={dispatched} "
                                 f"num_hits={cut.num_hits} "
                                 f"failed={cut.failed_splits}")
        say(f"[{label}] chunked cancel flagship: partial=True chunks=2 of 8 "
            f"score_topk=2 num_hits={cut.num_hits} of "
            f"{fused['flagship'].num_hits} cancel_to_return_ms="
            f"{(returned - shim.cancelled_at) * 1e3:.4f}")

        # through the service, over one split id
        data = storage.get_all("hdfs.split")
        storage.put("hdfs_a.split", data)
        resolver = StorageResolver()
        resolver.register(Protocol.RAM, lambda _uri: storage)
        split = models.SplitIdAndFooter("hdfs_a", "ram:///chip_smoke",
                                        len(data), num_docs=num_docs)
        del data

        def service(**kw):
            ctx = svc_mod.SearcherContext(
                storage_resolver=resolver, device=dev, leaf_cache_bytes=0,
                enable_mask_cache=False, enable_agg_cache=False, **kw)
            return svc_mod.SearchService(ctx)

        def leaf_search(svc, req):
            return svc.leaf_search(models.LeafSearchRequest(
                search_request=req, index_uid="hdfs-logs:0",
                doc_mapping=HDFS_MAPPER.to_dict(), splits=[split]))

        svc = service()
        service_launches = {}
        for name in ("flagship", "c2_bool_range_top100"):
            req = cases[name][2]
            ce.CHUNKING.set(enabled=False)
            k0 = st.score_topk.launches
            want = leaf_search(svc, req)
            fused_launches += st.score_topk.launches - k0
            st.score_topk.launches = k0
            ce.CHUNKING.set(enabled=True, **spans_for(name))
            d0 = counter("CHUNK_DISPATCHES_TOTAL")
            got = leaf_search(svc, req)
            same(f"service {name}", got, want)
            service_launches[name] = st.score_topk.launches - k0
            say(f"chunked service {name}: chunks="
                f"{counter('CHUNK_DISPATCHES_TOTAL') - d0:.0f} score_topk="
                f"{service_launches[name]} equal_to_chunking_off=True")
        token = deadline.CancellationToken()
        ce.CHUNKING.set(enabled=True, **spans_for("flagship"))
        with deadline.cancel_scope(token):
            got = leaf_search(service(fault_injector=CancelAtBoundary(token)),
                              cases["flagship"][2])
        if not (len(got.failed_splits) == 1
                and not got.failed_splits[0].retryable
                and got.failed_splits[0].error.startswith("query cancelled")
                and 0 < got.num_hits < fused["flagship"].num_hits):
            raise AssertionError(
                f"chunked service cancel: {got.failed_splits}")
        say(f"chunked service cancel flagship: num_hits={got.num_hits} "
            f"failed_splits="
            f"{[(f.split_id, f.retryable) for f in got.failed_splits]}")
        storage.delete("hdfs_a.split")
        path_launches = st.score_topk.launches
        restarts = counter("CHUNK_RESTARTS_TOTAL") - restarts0
        if restarts:
            raise AssertionError(
                f"chunked: {restarts} restarts without a fault")

        # timing: chunked and fused in turns on the same reader; boundary
        # intervals read from the histogram's observations
        samples = []
        hist = metrics.CHUNK_BOUNDARY_SECONDS
        observe = hist.observe

        def record(value, **labels):
            samples.append(value)
            observe(value, **labels)

        timed_iters = min(iters, 10)
        hist.observe = record
        try:
            for name in ("flagship", "body_top10", "body_top10_early_term",
                         "c2_bool_range_top100", "c2_ts_tenant_top100",
                         "c5_otel_percentiles_1split",
                         "otel_latency_by_service"):
                run(name, True)
                run(name, False)
                walls, fused_walls = [], []
                del samples[:]
                d0 = counter("CHUNK_DISPATCHES_TOTAL")
                chunk_launches = staged = 0
                for _ in range(timed_iters):
                    k0 = st.score_topk.launches
                    staged0 = counter("STAGING_BYTES_TOTAL")
                    t0 = time.perf_counter()
                    run(name, True)
                    t1 = time.perf_counter()
                    chunk_launches += st.score_topk.launches - k0
                    staged += counter("STAGING_BYTES_TOTAL") - staged0
                    run(name, False)
                    walls.append((t1 - t0) * 1e3)
                    fused_walls.append((time.perf_counter() - t1) * 1e3)
                ms, nan = sorted(v * 1e3 for v in samples), float("nan")
                chunks = (counter("CHUNK_DISPATCHES_TOTAL") - d0) / timed_iters
                say(f"[{label}] chunked timing {name}: warm_p50_ms="
                    f"{pct(walls, 0.5):.4f} warm_p90_ms={pct(walls, 0.9):.4f} "
                    f"fused_in_turns_p50_ms={pct(fused_walls, 0.5):.4f} "
                    f"iters={timed_iters} chunks_per_call={chunks:.2f} "
                    f"score_topk_per_call={chunk_launches / timed_iters:.2f} "
                    f"staged_bytes_per_warm_call={staged / timed_iters:.0f} "
                    f"boundary_p50_ms={pct(ms, 0.5) if ms else nan:.4f} "
                    f"boundary_p90_ms={pct(ms, 0.9) if ms else nan:.4f}")
        finally:
            del hist.observe
        st.score_topk.launches = path_launches

        # host and device parts of one chunked call
        mapper, split_reader, req, _ = cases["c2_bool_range_top100"]
        c2_plan = leaf.prepare_plan_only(req, mapper, split_reader, "split-0")
        t0 = time.perf_counter()
        for lo, hi in ce.chunk_spans(c2_plan.num_docs_padded, DOC_SPAN,
                                     ce.DOC_PAD):
            ce.dense_chunk_plan(c2_plan, lo, hi - lo)
        say(f"[{label}] chunked c2_bool_range_top100 host dense_chunk_plan "
            f"(host posting-id rebase) ms per call: "
            f"{(time.perf_counter() - t0) * 1e3:.4f}")
        for name in ("flagship", "c2_bool_range_top100"):
            summary = device_profile(
                torch, lambda: run(name, True), 3,
                os.path.join(here, "chip_traces",
                             f"trace_chunked_{name}.json"))
            say(f"[{label}] profile chunked {name}: {summary}")
        st.score_topk.launches = path_launches

        # the kernel at the chunk shape: the flagship's first chunk
        mapper, split_reader, req, _ = cases["flagship"]
        plan = leaf.prepare_plan_only(req, mapper, split_reader, "split-0")
        arrays, _, _ = leaf.warmup_device_arrays(split_reader, plan,
                                                 device=dev)
        root, span = plan.root, POSTING_SPANS["flagship"]
        row, err = kernel_row(
            torch, st, score_postings, "flagship_chunk",
            arrays[root.ids_slot][:span], arrays[root.tfs_slot][:span],
            arrays[root.norm_slot], plan.scalars[root.idf_slot],
            plan.scalars[root.avg_len_slot], plan.num_docs, req.max_hits,
            iters, flush, label)
        say(f"[{label}] chunked fused-reference launches (not the path's): "
            f"score_topk={fused_launches}; restarts=0")
        return {"launches": path_launches, "row": row, "err": err}
    finally:
        ce.CHUNKING, ce.CHUNK_SIZER = saved

# --------------------------------------------------------------------------
# phase 10: query stacking

DENSE_GROUP_DOCS = 30_720
DENSE_GROUP_SPAN = 8192


def rare_term_group(reader, n, min_len=0):
    """`n` body terms of the padded posting length (at least `min_len`)
    that the most terms share, so that their plans stack. Returns
    [(term, df, P)]."""
    import numpy as np
    td = reader.term_dict("body")
    lengths, counts = np.unique(td.post_lens, return_counts=True)
    counts[(lengths < min_len) | (counts < n)] = 0
    if counts.max() == 0:
        raise AssertionError(f"no {n} body terms share a padded length")
    length = lengths[np.argmax(counts)]
    picks = np.flatnonzero(td.post_lens == length)[:n]
    return [(td.blob[td.offsets[i]:td.offsets[i + 1]].decode(),
             int(td.dfs[i]), int(td.post_lens[i])) for i in picks]


def same_result(want, got, label) -> None:
    """Two leaf-program result dicts: count, sort values, doc ids and f32
    scores bit for bit, aggregation states as `assert_aggs_close` holds
    them (f64 sums to rtol 1e-12, everything else exactly)."""
    import numpy as np
    if got is None or want is None:
        raise AssertionError(f"{label}: a result is missing")
    if int(got["count"]) != int(want["count"]):
        raise AssertionError(f"{label}: count {got['count']} vs "
                             f"{want['count']}")
    for key in ("sort_values", "sort_values2", "doc_ids", "scores"):
        w, g = want[key], got[key]
        if (w is None) != (g is None) or (w is not None and (
                np.asarray(w).dtype != np.asarray(g).dtype
                or np.asarray(w).tobytes() != np.asarray(g).tobytes())):
            raise AssertionError(f"{label}: {key} differs")
    assert_aggs_close(list(want["aggs"]), list(got["aggs"]), f"{label} aggs")


class HoldFirstLeader:
    """A fault injector that holds the first batcher leader at
    `batcher.dispatch` until `riders` queries have entered the batcher
    (polled, 20 s at most)."""

    def __init__(self, batcher, riders):
        self.batcher, self.riders = batcher, riders
        self.held = False
        self.waited_s = 0.0

    def perturb(self, operation):
        if operation != "batcher.dispatch" or self.held:
            return
        self.held = True
        t0 = time.perf_counter()
        while (self.batcher.num_queries < self.riders
               and time.perf_counter() - t0 < 20.0):
            time.sleep(0.001)
        self.waited_s = time.perf_counter() - t0
        if self.batcher.num_queries < self.riders:
            raise AssertionError("stacking service: the riders never queued")


def check_stacking(torch, st, m, reader, otel_reader, open_so_reader,
                   storage, num_docs, dev, iters, label, here, flush) -> dict:
    """Phase 10: stacked groups, a convoy, the two reference stacking
    faults, the chunked group scan and the service's batcher on the card,
    each lane against its solo call; then the timings. The path's launch
    counts start at 0 and leave out every comparison and timing launch.
    Returns the path's launches of both kernels and the lane kernel's row."""
    import numpy as np
    ex, ce, leaf, metrics = m.ex, m.chunkexec, m.leaf, m.metrics

    def counts():
        return st.score_topk.launches, st.score_topk_lanes.launches

    def aside(fn, *args, **kw):
        """Run a comparison or a timing: its launches are not the path's."""
        saved = counts()
        try:
            return fn(*args, **kw)
        finally:
            st.score_topk.launches, st.score_topk_lanes.launches = saved

    def counter(name):
        return getattr(metrics, name).get()

    def stage(split_reader, mapper, req):
        plan = leaf.prepare_plan_only(req, mapper, split_reader, "split-0")
        arrays, _, _ = leaf.warmup_device_arrays(split_reader, plan,
                                                 device=dev)
        return plan, arrays

    def solo_all(staged, k):
        return [ex.execute_plan(p, k, a, dev) for p, a in staged]

    def stacked(staged, k, valid=None):
        return ex.readback_plan_stacked(ex.dispatch_plan_stacked(
            [p for p, _ in staged], k, [a for _, a in staged], valid=valid,
            device=dev))

    def check_group(name, staged, k, valid=None, lanes_launches=None):
        digests = {p.structure_digest(k) for p, _ in staged}
        if len(digests) != 1:
            raise AssertionError(f"stacking {name}: lanes differ in "
                                 "structure")
        k0 = st.score_topk.launches
        solos = solo_all(staged, k)
        solo_launches = st.score_topk.launches - k0
        st.score_topk.launches = k0
        k0, l0 = counts()
        p0 = counter("SEARCH_KERNEL_LAUNCHES_TOTAL")
        s0 = counter("STAGING_BYTES_TOTAL")
        got = stacked(staged, k, valid)
        torch.cuda.synchronize()
        seen = {"programs": int(counter("SEARCH_KERNEL_LAUNCHES_TOTAL") - p0),
                "score_topk": st.score_topk.launches - k0,
                "score_topk_lanes": st.score_topk_lanes.launches - l0,
                "staged_bytes": int(counter("STAGING_BYTES_TOTAL") - s0),
                "solo_score_topk": solo_launches}
        for lane, (g, w) in enumerate(zip(got, solos)):
            if valid is not None and not valid[lane]:
                if g is not None:
                    raise AssertionError(f"stacking {name}: masked lane "
                                         f"{lane} came back")
                continue
            same_result(w, g, f"stacking {name} lane {lane}")
        say(f"stacking {name}: lanes={len(staged)} valid="
            f"{valid if valid is not None else 'all'} {json.dumps(seen)} "
            f"equal_to_solo=True")
        if (seen["programs"] != 1 or seen["score_topk"] != 0
                or seen["staged_bytes"] != 0
                or (lanes_launches is not None
                    and seen["score_topk_lanes"] != lanes_launches)):
            raise AssertionError(f"stacking {name}: {seen}")
        return got, solos

    saved = (ce.CHUNKING, ce.CHUNK_SIZER)
    ce.CHUNKING, ce.CHUNK_SIZER = ce.ChunkConfig(), ce._ChunkSizer()
    ce.CHUNKING.set(enabled=False)
    try:
        st.score_topk.launches = st.score_topk_lanes.launches = 0
        groups = {}

        # a. rare terms: one lane-kernel launch for 8 posting-space lanes
        rare = rare_term_group(reader, 8)
        say("stacking rare_terms: " + json.dumps(
            [{"term": t, "df": df, "P": p} for t, df, p in rare]))
        rare_reqs = [m.SearchRequest(index_ids=["hdfs-logs"],
                                     query_ast=m.Term("body", t),
                                     max_hits=10) for t, _, _ in rare]
        groups["rare_terms"] = ([stage(reader, m.HDFS_MAPPER, r)
                                 for r in rare_reqs], 10)
        check_group("rare_terms", *groups["rare_terms"], lanes_launches=1)

        # the convoy under the kill switch: 4 copies of one such term
        os.environ["QW_DISABLE_QBATCH"] = "1"
        try:
            plan, arrays = groups["rare_terms"][0][0]
            want = aside(ex.execute_plan, plan, 10, arrays, dev)
            l0 = st.score_topk_lanes.launches
            got = ex.readback_plan_multi(ex.dispatch_plan_multi(
                plan, 10, arrays, [plan.scalars] * 4, device=dev))
            for lane, g in enumerate(got):
                same_result(want, g, f"stacking convoy lane {lane}")
            say(f"stacking convoy (QW_DISABLE_QBATCH=1): 4 copies of "
                f"body:{rare[0][0]} score_topk_lanes="
                f"{st.score_topk_lanes.launches - l0} equal_to_solo=True")
        finally:
            del os.environ["QW_DISABLE_QBATCH"]

        # b. c2 over 4 time windows (doc space), then a masked lane
        day_us, t0_us = 86400 * 10**6, 1_600_000_000 * 10**6

        def c2_window(d, **kw):
            return m.SearchRequest(index_ids=["hdfs-logs"], query_ast=m.Bool(
                must=(m.Term("severity_text", "ERROR"),),
                should=(m.Term("body", m.body_term(3)),
                        m.Term("body", m.body_term(7))),
                filter=(m.Range("timestamp",
                                lower=m.RangeBound(t0_us + d * day_us, True),
                                upper=m.RangeBound(t0_us + (d + 3) * day_us,
                                                   False)),)),
                max_hits=100, **kw)

        groups["c2_windows"] = ([stage(reader, m.HDFS_MAPPER, c2_window(d))
                                 for d in range(4)], 100)
        check_group("c2_windows", *groups["c2_windows"], lanes_launches=0)
        check_group("c2_windows_masked", *groups["c2_windows"],
                    valid=[True, False, True, True], lanes_launches=0)

        # c. c5's percentiles over 4 span_start_timestamp windows
        ot0_us = 1_700_000_000 * 10**6
        pctl = {"percentiles": {"field": "span_duration_micros",
                                "percents": [50, 95, 99]}}
        otel_reqs = [m.SearchRequest(
            index_ids=["otel-traces"], query_ast=m.Bool(
                must=(m.MatchAll(),),
                filter=(m.Range("span_start_timestamp",
                                lower=m.RangeBound(
                                    ot0_us + 600 * d * 10**6, True),
                                upper=m.RangeBound(
                                    ot0_us + (600 * d + 1800) * 10**6,
                                    False)),)),
            max_hits=0, aggs={"latency": pctl}) for d in range(4)]
        groups["c5_windows"] = ([stage(otel_reader, m.OTEL_BENCH_MAPPER, r)
                                 for r in otel_reqs], 0)
        check_group("c5_windows", *groups["c5_windows"], lanes_launches=0)

        # d. the two reference stacking faults: a same-named range agg
        # over other bounds, and c4 at slop 0 and 2, each lane its own
        range_staged = [stage(reader, m.HDFS_MAPPER, m.SearchRequest(
            index_ids=["hdfs-logs"], query_ast=m.Term("severity_text",
                                                      "ERROR"),
            max_hits=5, aggs={"by_tenant": {"range": {
                "field": "tenant_id", "ranges": ranges}}}))
            for ranges in ([{"to": 1}, {"from": 2}],
                           [{"to": 3}, {"from": 3}])]
        _, t_stacked = ex.stacked_slot_split([p for p, _ in range_staged])
        agg = range_staged[0][0].aggs[0]
        if not {agg.froms_slot, agg.tos_slot} <= set(t_stacked):
            raise AssertionError("stacking range_bounds: bounds shared")
        got, _ = check_group("range_bounds", range_staged, 5)
        say("stacking range_bounds: counts per lane "
            f"{[list(map(int, g['aggs'][0]['counts'])) for g in got]}")

        def c4(slop):
            return m.SearchRequest(index_ids=["stackoverflow"],
                                   query_ast=m.FullText(
                                       "body", "t000010 t000011",
                                       mode="phrase", slop=slop),
                                   max_hits=20)

        so_reader = open_so_reader()
        phrase_staged = [stage(so_reader, m.SO_MAPPER, c4(s)) for s in (0, 2)]
        phrase_where = "the phase 7 split"
        if len({p.structure_digest(20) for p, _ in phrase_staged}) != 1:
            # at this size the two phrases' matched postings pad to other
            # lengths, so they cannot share a group; the reference's fault
            # needs a group, so take the 20,000-doc split of the CPU tests
            small = m.RamStorage(m.Uri.parse("ram:///chip_smoke_so_small"))
            small.put("so.split", m.synthetic_stackoverflow_split(
                20_000, seed=11))
            so_reader = m.SplitReader(small, "so.split")
            phrase_staged = [stage(so_reader, m.SO_MAPPER, c4(s))
                             for s in (0, 2)]
            phrase_where = ("a 20,000-doc split (seed 11: at the phase 7 "
                            "size the two phrases pad to other lengths)")
        ids_slot = phrase_staged[0][0].root.ids_slot
        if ids_slot not in ex.stacked_slot_split(
                [p for p, _ in phrase_staged])[1]:
            raise AssertionError("stacking phrase_slop: postings shared")
        got, _ = check_group("phrase_slop", phrase_staged, 20,
                             lanes_launches=1)
        say(f"stacking phrase_slop on {phrase_where}: hits per lane "
            f"{[int(g['count']) for g in got]}")

        # e. the chunked group scan: posting mode (rare terms whose padded
        # length spans 3+ chunks of 128) and dense mode (c2's windows on a
        # 30,720-doc split: at 10M docs the host chunk-plan rebase alone is
        # ~43 ms per chunk per lane, PERF.md §5, ~1.7 s per call for 4
        # lanes)
        ce.CHUNKING.set(enabled=True)
        chunk_terms = rare_term_group(reader, 8, min_len=3 * 128)
        chunk_staged = [stage(reader, m.HDFS_MAPPER, m.SearchRequest(
            index_ids=["hdfs-logs"], query_ast=m.Term("body", t),
            max_hits=10)) for t, _, _ in chunk_terms]
        plans = [p for p, _ in chunk_staged]
        _, total, align = ce.chunk_mode(plans[0])
        n_chunks = len(ce.chunk_spans(total, align, align))
        solos = aside(solo_all, chunk_staged, 10)
        d0 = counter("CHUNK_DISPATCHES_TOTAL")
        l0 = st.score_topk_lanes.launches
        got = ce.execute_group_chunked(plans, 10,
                                       [a for _, a in chunk_staged],
                                       span=align, device=dev)
        seen = {"chunks": n_chunks,
                "dispatched": int(counter("CHUNK_DISPATCHES_TOTAL") - d0),
                "score_topk_lanes": st.score_topk_lanes.launches - l0}
        for lane, (g, w) in enumerate(zip(got, solos)):
            same_result(w, g, f"chunked group lane {lane}")
        say(f"stacking chunked posting group: terms="
            f"{[(t, df, p) for t, df, p in chunk_terms]} {json.dumps(seen)} "
            "equal_to_fused=True")
        if not (n_chunks >= 3 and seen["dispatched"] == n_chunks
                and seen["score_topk_lanes"] == n_chunks):
            raise AssertionError(f"stacking chunked group: {seen}")
        token = m.deadline.CancellationToken()
        got = ce.execute_group_chunked(
            plans, 10, [a for _, a in chunk_staged], span=align, device=dev,
            cancels=[token] + [None] * (len(plans) - 1),
            fault_injector=CancelAtBoundary(token))
        cut = got[0]
        if not (isinstance(cut, m.deadline.CancelledQuery)
                or cut.get("partial")):
            raise AssertionError("stacking chunked cancel: lane 0 ran on")
        for lane in range(1, len(plans)):
            same_result(solos[lane], got[lane], f"chunked cancel lane {lane}")
        say("stacking chunked cancel: lane 0 "
            + ("partial count=" + str(cut["count"]) if isinstance(cut, dict)
               else "cancelled") + f" of {solos[0]['count']}; lanes 1-"
            f"{len(plans) - 1} equal_to_fused=True")
        small = m.RamStorage(m.Uri.parse("ram:///chip_smoke_dense_group"))
        small.put("s.split", m.synthetic_hdfs_split(DENSE_GROUP_DOCS, seed=7))
        small_reader = m.SplitReader(small, "s.split")
        dense_staged = [stage(small_reader, m.HDFS_MAPPER, c2_window(d))
                        for d in range(4)]
        dplans = [p for p, _ in dense_staged]
        _, dtotal, dalign = ce.chunk_mode(dplans[0])
        d_chunks = len(ce.chunk_spans(dtotal, DENSE_GROUP_SPAN, dalign))
        solos = aside(solo_all, dense_staged, 100)
        d0 = counter("CHUNK_DISPATCHES_TOTAL")
        got = ce.execute_group_chunked(dplans, 100,
                                       [a for _, a in dense_staged],
                                       span=DENSE_GROUP_SPAN, device=dev)
        for lane, (g, w) in enumerate(zip(got, solos)):
            same_result(w, g, f"chunked dense group lane {lane}")
        dispatched = int(counter("CHUNK_DISPATCHES_TOTAL") - d0)
        say(f"stacking chunked dense group: c2 windows x4 on "
            f"{DENSE_GROUP_DOCS} docs, chunks={d_chunks} dispatched="
            f"{dispatched} equal_to_fused=True")
        if d_chunks < 3 or dispatched != d_chunks:
            raise AssertionError("stacking chunked dense group: "
                                 f"{dispatched} of {d_chunks}")
        ce.CHUNKING.set(enabled=False)

        # f. through the service: 8 concurrent calls over one split id
        resolver = m.StorageResolver()
        resolver.register(m.Protocol.RAM, lambda _uri: storage)
        data_len = storage.file_num_bytes("hdfs.split")
        split = m.models.SplitIdAndFooter("hdfs", "ram:///chip_smoke",
                                          data_len, num_docs=num_docs)
        ctx = m.svc_mod.SearcherContext(storage_resolver=resolver,
                                        device=dev)
        svc = m.svc_mod.SearchService(ctx)
        hold = HoldFirstLeader(ctx.query_batcher, len(rare_reqs))
        ctx.query_batcher.fault_injector = hold
        results = [None] * len(rare_reqs)

        def rider(i):
            try:
                results[i] = svc.leaf_search(m.models.LeafSearchRequest(
                    search_request=rare_reqs[i], index_uid="hdfs-logs:0",
                    doc_mapping=m.HDFS_MAPPER.to_dict(), splits=[split]))
            except Exception as exc:  # noqa: BLE001 - checked below
                results[i] = exc

        import threading
        g0 = counter("QBATCH_GROUPS_TOTAL")
        hist = metrics.QBATCH_QUERIES_PER_DISPATCH
        h0 = list(hist._counts.get((), [0] * len(hist.buckets)))
        threads = [threading.Thread(target=rider, args=(i,), daemon=True)
                   for i in range(len(rare_reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        if any(t.is_alive() for t in threads):
            raise AssertionError("stacking service: a rider never returned")
        for i, got in enumerate(results):
            if isinstance(got, Exception):
                raise got
            want = aside(m.leaf_search_single_split, rare_reqs[i],
                         m.HDFS_MAPPER, reader, "hdfs", device=dev)
            if response_key(got) != response_key(want) or got.failed_splits:
                raise AssertionError(f"stacking service rider {i}: differs "
                                     "from leaf_search_single_split")
        h1 = hist._counts.get((), [0] * len(hist.buckets))
        groups_formed = counter("QBATCH_GROUPS_TOTAL") - g0
        say(f"stacking service: riders={len(rare_reqs)} leader_held_s="
            f"{hold.waited_s:.4f} qw_qbatch_groups_total+="
            f"{groups_formed:.0f} qw_qbatch_queries_per_dispatch="
            + json.dumps({f"le_{b:g}": c1 - c0 for b, c0, c1
                          in zip(hist.buckets, h0, h1)})
            + f" dispatches={ctx.query_batcher.num_dispatches} "
            "equal_to_leaf_search_single_split=True")
        if groups_formed < 1:
            raise AssertionError("stacking service: no group formed")
        path = {"score_topk": st.score_topk.launches,
                "score_topk_lanes": st.score_topk_lanes.launches}
        say(f"stacking launches: {json.dumps(path)}")
        if path["score_topk_lanes"] < 1:
            raise AssertionError("score_topk_lanes never launched on the "
                                 "stacking path")

        # g. timing, 20 warm iterations in turns per group
        timed_iters = iters
        for name, (staged, k) in groups.items():
            q = len(staged)

            def one_stacked(staged=staged, k=k):
                stacked(staged, k)

            def q_solos(staged=staged, k=k):
                solo_all(staged, k)

            walls, solo_walls = [], []
            aside(one_stacked)
            aside(q_solos)
            for _ in range(timed_iters):
                t0 = time.perf_counter()
                aside(one_stacked)
                t1 = time.perf_counter()
                aside(q_solos)
                walls.append((t1 - t0) * 1e3)
                solo_walls.append((time.perf_counter() - t1) * 1e3)
            os.makedirs(os.path.join(here, "chip_traces"), exist_ok=True)
            prof = aside(device_profile, torch, one_stacked, 5, os.path.join(
                here, "chip_traces", f"trace_stacked_{name}.json"))
            solo_prof = aside(device_profile, torch, q_solos, 5, os.path.join(
                here, "chip_traces", f"trace_solos_{name}.json"))
            say(f"[{label}] stacking timing {name}: Q={q} stacked_p50_ms="
                f"{pct(walls, 0.5):.4f} stacked_p90_ms={pct(walls, 0.9):.4f} "
                f"solo_calls_p50_ms={pct(solo_walls, 0.5):.4f} "
                f"solo_calls_p90_ms={pct(solo_walls, 0.9):.4f} "
                f"iters={timed_iters}")
            say(f"[{label}] profile stacked {name}: {prof}")
            say(f"[{label}] profile {q} solo calls {name}: {solo_prof}")
        row, err = aside(lanes_kernel_row, torch, st, m.score_postings,
                         groups["rare_terms"][0], iters, flush, label)
        return {"launches": path, "row": row, "err": err}
    finally:
        ce.CHUNKING, ce.CHUNK_SIZER = saved


def lanes_kernel_row(torch, st, score_postings, staged, iters, flush, label,
                     at="rare_terms"):
    """score_topk_lanes at a lane group's shape (`staged`: (plan, arrays)
    per lane, the lanes' P may differ): per call and by graph replay,
    beside the Q solo launches by graph replay, the plain version, one
    `torch.topk` over the group's [Q, P_max] precomputed scores (shorter
    lanes padded with -inf), and the bound. Returns (row, max abs
    error)."""
    lanes = []
    for plan, arrays in staged:
        root = plan.root
        lanes.append((arrays[root.ids_slot], arrays[root.tfs_slot],
                      arrays[root.norm_slot], plan.scalars[root.idf_slot],
                      plan.scalars[root.avg_len_slot], plan.num_docs))
    q = len(lanes)
    sizes = [lane[0].shape[0] for lane in lanes]
    P = max(sizes)
    k = min(10, min(sizes))
    kernel_ms = cuda_ms(torch, lambda: st.score_topk_lanes(lanes, k), iters,
                        flush)
    replay_ms = graph_ms(torch, lambda: st.score_topk_lanes(lanes, k),
                         iters, flush)

    def solos():
        for lane in lanes:
            st.score_topk(*lane, k)

    solo_replay_ms = graph_ms(torch, solos, iters, flush)
    plain_ms = cuda_ms(torch, lambda: st.score_topk_lanes_reference(
        lanes, k), iters, flush)
    scores = torch.stack([torch.nn.functional.pad(torch.where(
        (tfs > 0) & (ids < nd), score_postings(tfs, ids, norms, avg, idf),
        float("-inf")), (0, P - ids.shape[0]), value=float("-inf"))
        for ids, tfs, norms, idf, avg, nd in lanes])
    library_ms = cuda_ms(torch, lambda: torch.topk(scores, k, dim=1),
                         iters, flush)
    got = st.score_topk_lanes(lanes, k)
    want = st.score_topk_lanes_reference(lanes, k)
    err = 0.0
    for row, (ids, tfs, _, _, _, nd) in enumerate(lanes):
        num_valid = int(((tfs > 0) & (ids < nd)).sum())
        err = max(err, compare_winners(torch, (got[0][row], got[1][row]),
                                       (want[0][row], want[1][row]),
                                       num_valid, k))
    # bytes: each lane's ids + tfs + one gathered norm per posting, read
    # once (PR 2's model), and the [Q, k] (f32, i64) winners written once
    nbytes = 12 * sum(sizes) + q * 12 * k
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = 11 * sum(sizes) / H100_F32_OPS_PER_S * 1e3
    shape = f"P={P}" if len(set(sizes)) == 1 else f"P={sizes}"
    say(f"[{label}] kernel score_topk_lanes @{at}: Q={q} {shape} k={k} "
        f"ms={kernel_ms:.5f} graph_replay_ms={replay_ms:.5f} "
        f"q_solo_graph_replay_ms={solo_replay_ms:.5f} plain_ms="
        f"{plain_ms:.5f} library_ms(torch.topk over [Q, P] scores)="
        f"{library_ms:.5f} bound_ms={max(bytes_ms, ops_ms):.7f} "
        f"(bytes={nbytes}, ops_ms={ops_ms:.7f}) max_abs_err={err}")
    return {"at": at, "Q": q, "P": P if len(set(sizes)) == 1 else sizes,
            "k": k, "ms": kernel_ms,
            "graph_replay_ms": replay_ms,
            "q_solo_graph_replay_ms": solo_replay_ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms}, err


# --------------------------------------------------------------------------
# phase 11: the multi-split fan-out

FANOUT_OTEL_SPLITS = 64        # bench.py's OTEL_SPLITS x OTEL_DOCS, seeds
FANOUT_OTEL_DOCS = 524_288     # 0..63: BASELINE config 5
FANOUT_HDFS_SPLITS = 8         # one service group (batch_size 8)
FANOUT_HDFS_DOCS = 524_288
FANOUT_HDFS_SEED = 100         # seeds 100..107: used by no other phase


def widened_ints(tree):
    """Integer arrays as int64: a batch merges int32 counts into int64 (as
    the JAX batch does), the collector keeps int32."""
    import numpy as np
    if isinstance(tree, dict):
        return {k: widened_ints(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(widened_ints(v) for v in tree)
    if isinstance(tree, np.ndarray) and tree.dtype.kind in "iu":
        return tree.astype(np.int64)
    return tree


def busy_ms(summary: str) -> float:
    """The device busy ms per call of a `device_profile` summary."""
    return float(summary.split("device_busy_ms_per_call=")[1].split()[0])


def _hdfs_split_with_docs(args) -> bytes:
    """One hdfs split with its doc store (a process-pool worker)."""
    from quickwit_tpu_torch.index.synthetic import synthetic_hdfs_split
    num_docs, seed = args
    return synthetic_hdfs_split(num_docs, seed=seed, store_docs=True)


def hdfs_splits_in_parallel(num_docs: int, seeds: list) -> list:
    """The generator's hdfs splits for `seeds`, one worker process per
    split up to the host's cores: the same bytes as one after the other,
    in a fraction of the time the whole smoke has."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    workers = max(1, min(len(seeds), os.cpu_count() or 1))
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        return list(pool.map(_hdfs_split_with_docs,
                             [(num_docs, seed) for seed in seeds]))


def check_fanout(torch, st, m, dev, iters, label, here, flush, reqs,
                 otel_splits=FANOUT_OTEL_SPLITS, otel_docs=FANOUT_OTEL_DOCS,
                 hdfs_splits=FANOUT_HDFS_SPLITS,
                 hdfs_docs=FANOUT_HDFS_DOCS) -> dict:
    """Phase 11: the multi-split batch (`parallel/fanout.py`) on the card,
    each response against the per-split route merged by the collector;
    then the service's batch route, the deadline shed, and the timings.
    The path's launch counts start at 0 and leave out every comparison and
    timing launch. Returns the path's launches, the lane kernel's row at
    the fan-out's shape and the largest kernel error."""
    fan, metrics = m.fanout, m.metrics

    def counts():
        return st.score_topk.launches, st.score_topk_lanes.launches

    def aside(fn, *args, **kw):
        """Run a comparison or a timing: its launches are not the path's."""
        saved = counts()
        try:
            return fn(*args, **kw)
        finally:
            st.score_topk.launches, st.score_topk_lanes.launches = saved

    def counter(name):
        return getattr(metrics, name).get()

    storage = m.RamStorage(m.Uri.parse("ram:///chip_fanout"))
    t0 = time.perf_counter()
    otel_ids = [f"otel{s:02d}" for s in range(otel_splits)]
    otel_bytes = 0
    for s, split_id in enumerate(otel_ids):
        data = m.synthetic_otel_split(otel_docs, seed=s)
        otel_bytes += len(data)
        storage.put(f"{split_id}.split", data)
    otel_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hdfs_ids = [f"hdfs{i}" for i in range(hdfs_splits)]
    hdfs_bytes = 0
    for split_id, data in zip(hdfs_ids, hdfs_splits_in_parallel(
            hdfs_docs, [FANOUT_HDFS_SEED + i for i in range(hdfs_splits)])):
        hdfs_bytes += len(data)
        storage.put(f"{split_id}.split", data)
    del data
    say(f"fanout splits: otel {otel_splits} x {otel_docs} docs (seeds 0.."
        f"{otel_splits - 1}) bytes={otel_bytes} build_s={otel_s:.3f}; hdfs "
        f"{hdfs_splits} x {hdfs_docs} docs (seeds {FANOUT_HDFS_SEED}.."
        f"{FANOUT_HDFS_SEED + hdfs_splits - 1}) bytes={hdfs_bytes} build_s="
        f"{time.perf_counter() - t0:.3f}")

    def readers(ids):
        return [m.SplitReader(storage, f"{split_id}.split")
                for split_id in ids]

    otel_readers, hdfs_readers = readers(otel_ids), readers(hdfs_ids)
    c5 = m.SearchRequest(
        index_ids=["otel-traces"], query_ast=m.MatchAll(), max_hits=0,
        aggs={"latency": {"percentiles": {"field": "span_duration_micros",
                                          "percents": [50, 95, 99]}}})

    def per_split(req, mapper, split_readers, ids, device=dev):
        collector = m.IncrementalCollector(req.max_hits, req.start_offset)
        for split_id, reader in zip(ids, split_readers):
            collector.add_leaf_response(m.leaf_search_single_split(
                req, mapper, reader, split_id, device=device))
        return collector

    def same_as_per_split(name, got, want):
        merged = m.IncrementalCollector(want.max_hits, want.start_offset)
        merged.add_leaf_response(got)
        if (merged.num_hits != want.num_hits
                or hit_tuples(merged.partial_hits())
                != hit_tuples(want.partial_hits())):
            raise AssertionError(f"fanout {name}: hits differ from the "
                                 "per-split merge")
        assert_aggs_close(widened_ints(want.aggregation_states()),
                          widened_ints(merged.aggregation_states()),
                          f"fanout {name} aggs")

    def run_batch(name, req, mapper, split_readers, ids, lanes=None):
        """The batch on the card, checked against the per-split route on
        the card: one program, no solo score_topk launch, `lanes` lane
        launches (when given)."""
        batch = fan.build_batch(req, mapper, split_readers, ids)
        k0, l0 = counts()
        p0 = counter("SEARCH_KERNEL_LAUNCHES_TOTAL")
        got = fan.execute_batch(batch, req, device=dev)
        seen = {"programs": int(counter("SEARCH_KERNEL_LAUNCHES_TOTAL") - p0),
                "score_topk": st.score_topk.launches - k0,
                "score_topk_lanes": st.score_topk_lanes.launches - l0}
        k1 = st.score_topk.launches
        want = per_split(req, mapper, split_readers, ids)
        seen["per_split_score_topk"] = st.score_topk.launches - k1
        st.score_topk.launches = k1
        same_as_per_split(name, got, want)
        say(f"fanout {name}: splits={len(ids)} num_hits={got.num_hits} "
            f"{json.dumps(seen)} equal_to_per_split=True")
        if (seen["programs"] != 1 or seen["score_topk"] != 0
                or (lanes is not None and seen["score_topk_lanes"] != lanes)):
            raise AssertionError(f"fanout {name}: {seen}")
        return batch, got

    st.score_topk.launches = st.score_topk_lanes.launches = 0

    # a. config 5 at the bench's size: one batch of 64 splits
    batch5, got5 = run_batch("c5_otel_percentiles_64splits", c5,
                             m.OTEL_BENCH_MAPPER, otel_readers, otel_ids,
                             lanes=0)
    if got5.num_hits != otel_splits * otel_docs:
        raise AssertionError("fanout c5: not every doc counted")
    head = fan.build_batch(c5, m.OTEL_BENCH_MAPPER, otel_readers[:8],
                           otel_ids[:8])
    gpu8 = fan.execute_batch(head, c5, device=dev)
    cpu8 = aside(fan.execute_batch, fan.build_batch(
        c5, m.OTEL_BENCH_MAPPER, otel_readers[:8], otel_ids[:8]), c5,
        device="cpu")
    if response_key(gpu8) != response_key(cpu8):
        raise AssertionError("fanout c5 over 8 splits: cuda differs from "
                             "cpu")
    say("fanout c5 over the first 8 splits: equal_to_cpu=True")

    # b. the flagship over the 8 hdfs splits: one lane launch
    batch_f, _ = run_batch("flagship_8splits", reqs["flagship"],
                           m.HDFS_MAPPER, hdfs_readers, hdfs_ids, lanes=1)
    root = batch_f.template.root
    sizes = [p.arrays[root.ids_slot].shape[0] for p in batch_f.plans]
    say(f"fanout flagship lanes: P={sizes}")

    # c. doc space and two keys over the same splits (checked, not timed)
    for name in ("c2_bool_range_top100", "c2_ts_tenant_top100"):
        run_batch(name + "_8splits", reqs[name], m.HDFS_MAPPER,
                  hdfs_readers, hdfs_ids, lanes=0)

    # d. through the service, each against the per-split route
    resolver = m.StorageResolver()
    resolver.register(m.Protocol.RAM, lambda _uri: storage)

    def offsets(ids, num_docs):
        return [m.models.SplitIdAndFooter(
            split_id, "ram:///chip_fanout",
            storage.file_num_bytes(f"{split_id}.split"), num_docs=num_docs)
            for split_id in ids]

    def service(**kw):
        ctx = m.svc_mod.SearcherContext(storage_resolver=resolver,
                                        device=dev, **kw)
        return m.svc_mod.SearchService(ctx), ctx

    def leaf(svc, req, splits, deadline_millis=None):
        return svc.leaf_search(m.models.LeafSearchRequest(
            search_request=req, index_uid="fanout:0",
            doc_mapping=(m.OTEL_BENCH_MAPPER if splits[0].split_id
                         .startswith("otel") else m.HDFS_MAPPER).to_dict(),
            splits=splits, deadline_millis=deadline_millis))

    otel_offsets = offsets(otel_ids, otel_docs)
    hdfs_offsets = offsets(hdfs_ids, hdfs_docs)
    services = {}
    for name, req, splits, kw, groups in (
            # max_hits=0 sorts by _doc, which Tier A serves per split, and
            # Tier B serves agg-only requests per split: both tiers off
            ("c5_otel_64splits", c5, otel_offsets,
             {"enable_agg_cache": False, "enable_mask_cache": False},
             -(-otel_splits // 8)),
            ("flagship_8splits", reqs["flagship"], hdfs_offsets, {}, 1)):
        svc, ctx = service(**kw)
        single, _ = service(batch_size=1, **kw)
        services[name] = (svc, ctx, req, splits)
        m.flight.FLIGHT.begin_run()
        p0 = counter("SEARCH_KERNEL_LAUNCHES_TOTAL")
        got = leaf(svc, req, splits)
        programs = int(counter("SEARCH_KERNEL_LAUNCHES_TOTAL") - p0)
        batch_events = [e for e in m.flight.FLIGHT.events()
                        if e["kind"] == "dispatch.launch"
                        and e["attrs"].get("path") == "batch"]
        want = aside(leaf, single, req, splits)
        if (got.failed_splits or got.num_hits != want.num_hits
                or hit_key(got) != hit_key(want)):
            raise AssertionError(f"fanout service {name}: differs from the "
                                 "per-split route")
        assert_aggs_close(widened_ints(want.intermediate_aggs),
                          widened_ints(got.intermediate_aggs),
                          f"fanout service {name} aggs")
        s0 = counter("STAGING_BYTES_TOTAL")
        again = leaf(svc, req, splits)
        repeat_staged = int(counter("STAGING_BYTES_TOTAL") - s0)
        say(f"fanout service {name}: batch_dispatch_events="
            f"{len(batch_events)} programs={programs} (per-split "
            f"dispatches={programs - len(batch_events)}) splits_per_batch="
            f"{[e['attrs']['splits'] for e in batch_events]} "
            f"repeat_staged_bytes={repeat_staged} budget="
            f"{json.dumps(ctx.hbm_budget.stats()['resident'])} store_bytes="
            f"{ctx.resident_store.stats()['bytes']} "
            "equal_to_per_split_route=True")
        if (len(batch_events) != groups or programs != groups
                or repeat_staged != 0
                or response_key(again) != response_key(got)
                or ctx.hbm_budget.stats()["resident"]
                != ctx.resident_store.stats()["bytes"]):
            raise AssertionError(f"fanout service {name}")

    # e. a deadline that passes between dispatch and readback
    svc, ctx, req, splits = services["flagship_8splits"]
    real_dispatch, real_abandon = m.svc_mod.dispatch_batch, \
        m.svc_mod.abandon_dispatch
    abandoned = []

    def dispatch_then_expire(batch, request, device=None, mesh=None):
        out = real_dispatch(batch, request, device, mesh)
        m.deadline.current_deadline()._expires_at = float("-inf")
        return out

    def abandon(dispatched):
        abandoned.append(dispatched)
        real_abandon(dispatched)

    m.svc_mod.dispatch_batch = dispatch_then_expire
    m.svc_mod.abandon_dispatch = abandon
    try:
        shed0 = counter("RESIDENT_READBACKS_SHED")
        shed = leaf(svc, dataclasses.replace(req, max_hits=9), splits,
                    deadline_millis=600_000)
    finally:
        m.svc_mod.dispatch_batch = real_dispatch
        m.svc_mod.abandon_dispatch = real_abandon
    failed = sorted(f.split_id for f in shed.failed_splits)
    retryable = all(f.retryable for f in shed.failed_splits)
    say(f"fanout deadline shed: abandoned={len(abandoned)} "
        f"qw_resident_readbacks_shed_total+="
        f"{counter('RESIDENT_READBACKS_SHED') - shed0:.0f} failed_splits="
        f"{len(failed)} retryable={retryable} "
        f"pinned={ctx.hbm_budget.stats()['pinned']}")
    if (len(abandoned) != 1 or counter("RESIDENT_READBACKS_SHED") - shed0 != 1
            or failed != sorted(hdfs_ids) or not retryable
            or ctx.hbm_budget.stats()["pinned"] != 0):
        raise AssertionError("fanout deadline shed")
    path = {"score_topk": st.score_topk.launches,
            "score_topk_lanes": st.score_topk_lanes.launches}
    say(f"fanout launches: {json.dumps(path)}")
    if path["score_topk"] != 0 or path["score_topk_lanes"] < 1:
        raise AssertionError(f"fanout launches: {path}")

    # f. timing, in turns with the per-split calls
    os.makedirs(os.path.join(here, "chip_traces"), exist_ok=True)
    for name, batch, req, mapper, split_readers, ids in (
            ("c5_otel_64splits", batch5, c5, m.OTEL_BENCH_MAPPER,
             otel_readers, otel_ids),
            ("flagship_8splits", batch_f, reqs["flagship"], m.HDFS_MAPPER,
             hdfs_readers, hdfs_ids)):

        def one_batch(batch=batch, req=req):
            fan.execute_batch(batch, req, device=dev)

        def split_calls(req=req, mapper=mapper, split_readers=split_readers,
                        ids=ids):
            for split_id, reader in zip(ids, split_readers):
                m.leaf_search_single_split(req, mapper, reader, split_id,
                                           device=dev)

        aside(one_batch)
        aside(split_calls)
        walls, split_walls = [], []
        s0 = counter("STAGING_BYTES_TOTAL")
        for _ in range(iters):
            t0 = time.perf_counter()
            aside(one_batch)
            t1 = time.perf_counter()
            aside(split_calls)
            walls.append((t1 - t0) * 1e3)
            split_walls.append((time.perf_counter() - t1) * 1e3)
        staged = (counter("STAGING_BYTES_TOTAL") - s0) / iters
        prof = aside(device_profile, torch, one_batch, 3, os.path.join(
            here, "chip_traces", f"trace_fanout_batch_{name}.json"))
        split_prof = aside(device_profile, torch, split_calls, 3,
                           os.path.join(here, "chip_traces",
                                        f"trace_fanout_splits_{name}.json"))
        device_ms = busy_ms(prof)
        say(f"[{label}] fanout timing {name}: splits={len(ids)} batch_p50_ms="
            f"{pct(walls, 0.5):.4f} batch_p90_ms={pct(walls, 0.9):.4f} "
            f"split_calls_p50_ms={pct(split_walls, 0.5):.4f} "
            f"split_calls_p90_ms={pct(split_walls, 0.9):.4f} iters={iters} "
            f"staged_bytes_per_warm_call={staged:.0f} batch_device_bytes="
            f"{fan.per_device_bytes(batch)} splits_per_s_of_device_time="
            f"{len(ids) / (device_ms / 1e3):.1f}")
        say(f"[{label}] profile fanout batch {name}: {prof}")
        say(f"[{label}] profile {len(ids)} split calls {name}: {split_prof}")
        if staged != 0:
            raise AssertionError(f"fanout timing {name}: a warm batch staged "
                                 f"{staged} bytes")
    lanes = fan.stage_device_inputs(batch_f, dev)
    row, err = aside(lanes_kernel_row, torch, st, m.score_postings,
                     list(zip(batch_f.plans, lanes)), iters, flush, label,
                     at="fanout_flagship_8splits")
    return {"launches": path, "row": row, "err": err, "storage": storage,
            "otel_ids": otel_ids, "hdfs_ids": hdfs_ids, "batch5": batch5,
            "got5": got5}


# --------------------------------------------------------------------------
# phase 12: root search

SPLITS_URI = "ram:///chip_fanout"      # phase 11's storage
METASTORE_URI = "ram:///chip_metastore"  # phase 12's metastore files


def split_metadata(m, reader, split_id, index_uid, mapper):
    """A split's metastore record, read from its own columns: num_docs,
    the time range of its footer and the [min, max] of every mapped
    i64/u64/f64 fast column (what `SplitWriter.column_bounds` records)."""
    FT = m.FieldType
    n = reader.num_docs
    bounds = {}
    for fm in mapper.field_mappings:
        if fm.fast and fm.type in (FT.I64, FT.U64, FT.F64):
            values, present = reader.column_values(fm.name)
            live = values[:n][present[:n] != 0]
            if live.size:
                cast = float if fm.type is FT.F64 else int
                bounds[fm.name] = (cast(live.min()), cast(live.max()))
    start, end = reader.footer.time_range or (None, None)
    return m.SplitMetadata(
        split_id=split_id, index_uid=index_uid, source_id="chip_smoke",
        num_docs=n, footprint_bytes=reader.file_len,
        time_range_start=start, time_range_end=end, column_bounds=bounds)


def same_search(got, want, label, path="response") -> None:
    """Two `SearchResponse.to_dict()` trees (minus elapsed time and
    profile, plus each hit's split, doc, score and sort values): floats
    under `aggregations` to rtol 1e-12, everything else exactly."""
    import numpy as np

    def tree(resp):
        out = resp.to_dict()
        out.pop("elapsed_time_micros")
        out.pop("profile", None)
        out["hit_keys"] = [[h.split_id, h.doc_id, h.score,
                            list(h.sort_values)] for h in resp.hits]
        return out

    def walk(w, g, at):
        if isinstance(w, dict):
            if not isinstance(g, dict) or w.keys() != g.keys():
                raise AssertionError(f"{label} {at}: keys differ")
            for k in w:
                walk(w[k], g[k], f"{at}.{k}")
        elif isinstance(w, (list, tuple)):
            if len(w) != len(g):
                raise AssertionError(f"{label} {at}: lengths differ")
            for i, (a, b) in enumerate(zip(w, g)):
                walk(a, b, f"{at}[{i}]")
        elif isinstance(w, float) and ".aggregations" in at:
            if not (isinstance(g, float) and (
                    (np.isnan(w) and np.isnan(g))
                    or np.isclose(g, w, rtol=1e-12, atol=0))):
                raise AssertionError(f"{label} {at}: {w} vs {g}")
        elif w != g or type(w) is not type(g):
            raise AssertionError(f"{label} {at}: {w!r} vs {g!r}")

    if isinstance(got, dict):
        walk(want, got, path)
    else:
        walk(tree(want), tree(got), path)


def phase_ms(profile: dict) -> dict:
    """Milliseconds per phase name of a root profile (the embedded leaves
    write into it), largest first."""
    out: dict[str, float] = {}
    for rec in profile["phases"]:
        out[rec["name"]] = out.get(rec["name"], 0.0) + rec["duration_ms"]
    return {k: round(v, 4) for k, v in sorted(out.items(),
                                               key=lambda kv: -kv[1])}


def check_root(torch, st, m, dev, iters, label, here, reqs, fanned) -> dict:
    """Phase 12: `RootSearcher.search` over a file-backed metastore of
    phase 11's splits, through a node on the card, each response against
    the same root over a CPU node; then the pruned, retried and timed-out
    requests, and the timings. Returns the path's launches."""
    import threading
    from types import SimpleNamespace
    storage = fanned["storage"]
    hdfs_ids, otel_ids = fanned["hdfs_ids"], fanned["otel_ids"]

    def counts():
        return st.score_topk.launches, st.score_topk_lanes.launches

    def aside(fn, *args, **kw):
        """Run a comparison or a timing: its launches are not the path's."""
        saved = counts()
        try:
            return fn(*args, **kw)
        finally:
            st.score_topk.launches, st.score_topk_lanes.launches = saved

    def counter(name):
        return getattr(m.metrics, name).get()

    # the metastore: three indexes over phase 11's bytes
    t0 = time.perf_counter()
    resolver = m.StorageResolver()
    resolver.register(m.Protocol.RAM, lambda _uri: storage)
    meta_storage = m.RamStorage(m.Uri.parse(METASTORE_URI))
    metastore = m.FileBackedMetastore(meta_storage)
    for index_id, mapper, ids in (
            ("hdfs-logs", m.HDFS_MAPPER, hdfs_ids),
            ("otel-traces", m.OTEL_BENCH_MAPPER, otel_ids),
            ("otel-traces-head", m.OTEL_BENCH_MAPPER, otel_ids[:8])):
        index_uid = f"{index_id}:01"
        metastore.create_index(m.IndexMetadata(
            index_uid=index_uid, index_config=m.IndexConfig(
                index_id=index_id, index_uri=SPLITS_URI,
                doc_mapper=mapper)))
        records = [split_metadata(m, m.SplitReader(storage,
                                                   f"{split_id}.split"),
                                  split_id, index_uid, mapper)
                   for split_id in ids]
        metastore.stage_splits(index_uid, records)
        metastore.publish_splits(index_uid, list(ids))
    hdfs_md = metastore.list_splits(m.ListSplitsQuery(
        index_uids=["hdfs-logs:01"]))
    say(f"root metastore: indexes="
        f"{[im.index_id for im in metastore.list_indexes()]} "
        f"hdfs_split_0={json.dumps(hdfs_md[0].metadata.to_dict())} "
        f"setup_s={time.perf_counter() - t0:.3f}")

    class CountingClient:
        """A node's client that counts leaf calls."""

        def __init__(self, inner):
            self.inner, self.leaf_calls = inner, 0

        def leaf_search(self, request):
            self.leaf_calls += 1
            return self.inner.leaf_search(request)

        def fetch_docs(self, request):
            return self.inner.fetch_docs(request)

    def node(device, node_id="node-0", **kw):
        ctx = m.svc_mod.SearcherContext(
            storage_resolver=resolver, device=device, batch_size=8,
            leaf_cache_bytes=0, enable_agg_cache=False,
            enable_mask_cache=False, **kw)
        return m.svc_mod.SearchService(ctx, node_id=node_id), ctx

    def root_over(services, wrap=None):
        clients = {}
        for node_id, svc in services.items():
            client = m.svc_mod.LocalSearchClient(svc)
            clients[node_id] = wrap(node_id, client) if wrap else client
        return m.RootSearcher(metastore, clients)

    gpu_svc, gpu_ctx = node(dev)
    gpu_client = CountingClient(m.svc_mod.LocalSearchClient(gpu_svc))
    gpu_root = m.RootSearcher(metastore, {"node-0": gpu_client})
    cpu_svc, _ = node("cpu")
    cpu_root = root_over({"node-0": cpu_svc})

    t0_us = 1_600_000_000 * 1_000_000
    day_us = 86400 * 1_000_000
    flagship_aggs = reqs["flagship"].aggs
    c2_body = {"bool": {
        "must": [{"term": {"severity_text": "ERROR"}}],
        "should": [{"term": {"body": m.body_term(3)}},
                   {"term": {"body": m.body_term(7)}}],
        "filter": [{"range": {"timestamp": {"gte": t0_us + day_us,
                                            "lt": t0_us + 4 * day_us}}}]}}
    c5_aggs = {"latency": {"percentiles": {"field": "span_duration_micros",
                                           "percents": [50, 95, 99]}}}

    def request(index, query, **kw):
        ast = (m.es_query_to_ast(query) if isinstance(query, dict)
               else m.parse_query_string(query, ["body"]))
        return m.SearchRequest(index_ids=[index], query_ast=ast, **kw)

    by_ts = (m.SortField("timestamp", "desc"),)
    requests = {
        "flagship": request("hdfs-logs", "severity_text:ERROR", max_hits=10,
                            aggs=flagship_aggs,
                            snippet_fields=("severity_text",)),
        "body_top10": request("hdfs-logs", f"body:{m.body_term(3)}",
                              max_hits=10, snippet_fields=("body",)),
        "c2_es_dsl_by_ts": request("hdfs-logs", c2_body, max_hits=100,
                                   sort_fields=by_ts),
        "c5_otel_64splits": request("otel-traces", "*", max_hits=0,
                                    aggs=c5_aggs),
        "c5_otel_head_8splits": request("otel-traces-head", "*",
                                        max_hits=0, aggs=c5_aggs),
        "pruned_time_range": request(
            "hdfs-logs", "severity_text:ERROR", max_hits=10,
            aggs=flagship_aggs, start_timestamp=t0_us + 365 * day_us),
    }

    # 1-5 on the card, the counters zeroed just before
    st.score_topk.launches = st.score_topk_lanes.launches = 0
    out, seen = {}, {}
    for name, req in requests.items():
        k0, l0 = counts()
        calls0 = gpu_client.leaf_calls
        m.flight.FLIGHT.begin_run()
        t0 = time.perf_counter()
        out[name] = gpu_root.search(req)
        wall = (time.perf_counter() - t0) * 1e3
        batches = sum(1 for e in m.flight.FLIGHT.events()
                      if e["kind"] == "dispatch.launch"
                      and e["attrs"].get("path") == "batch")
        seen[name] = {"score_topk": st.score_topk.launches - k0,
                      "score_topk_lanes": st.score_topk_lanes.launches - l0,
                      "leaf_calls": gpu_client.leaf_calls - calls0,
                      "batches": batches, "cold_wall_ms": round(wall, 3)}
    last = out["c2_es_dsl_by_ts"].hits[-1]
    page2 = dataclasses.replace(
        requests["c2_es_dsl_by_ts"],
        search_after=[last.sort_values[0], last.split_id, last.doc_id])
    k0, l0 = counts()
    out["c2_page2"] = gpu_root.search(page2)
    seen["c2_page2"] = {"score_topk": st.score_topk.launches - k0,
                        "score_topk_lanes": st.score_topk_lanes.launches
                        - l0}

    # each against the CPU root (not over all 64 otel splits)
    for name, resp in out.items():
        if name == "c5_otel_64splits":
            continue
        want = aside(cpu_root.search, page2 if name == "c2_page2"
                     else requests[name])
        same_search(resp, want, f"root {name}")
        if resp.errors:
            raise AssertionError(f"root {name}: {resp.errors}")
    top200 = aside(gpu_root.search, dataclasses.replace(
        requests["c2_es_dsl_by_ts"], max_hits=200))
    if ([(h.split_id, h.doc_id) for h in out["c2_page2"].hits]
            != [(h.split_id, h.doc_id) for h in top200.hits[100:]]):
        raise AssertionError("root c2 page 2 is not hits 101-200")
    collector = m.IncrementalCollector(0, 0)
    collector.add_leaf_response(fanned["got5"])
    same_search(out["c5_otel_64splits"].aggregations,
                m.finalize_aggregations(collector.aggregation_states()),
                "root c5 over 64 splits vs phase 11's batch",
                path="response.aggregations")
    flagship = out["flagship"]
    checks = {
        "flagship": (flagship.num_hits > 0 and len(flagship.hits) == 10
                     and all(h.doc and h.snippets for h in flagship.hits)
                     and seen["flagship"]["score_topk_lanes"] == 1
                     and seen["flagship"]["batches"] == 1),
        "body_top10": (len(out["body_top10"].hits) == 10
                       and seen["body_top10"]["score_topk_lanes"] == 1),
        "c2": (len(out["c2_es_dsl_by_ts"].hits) == 100
               and len(out["c2_page2"].hits) == 100),
        "c5": (out["c5_otel_64splits"].num_hits == len(otel_ids)
               * FANOUT_OTEL_DOCS and seen["c5_otel_64splits"]["batches"]
               == -(-len(otel_ids) // 8)
               and seen["c5_otel_64splits"]["leaf_calls"] == 1),
        "pruned": (seen["pruned_time_range"]["leaf_calls"] == 0
                   and out["pruned_time_range"].num_attempted_splits == 0
                   and set(out["pruned_time_range"].aggregations)
                   == set(flagship_aggs)),
    }
    for name, resp in out.items():
        equal = ("phase_11_batch" if name == "c5_otel_64splits"
                 else "cpu_root")
        say(f"root {name}: num_hits={resp.num_hits} hits={len(resp.hits)} "
            f"splits={resp.num_attempted_splits} "
            f"{json.dumps(seen[name])} equal_to_{equal}=True")
    say("root flagship hits: " + json.dumps(
        [[h.split_id, h.doc_id, h.score, h.doc, h.snippets]
         for h in flagship.hits[:3]]))
    say("root pruned aggregations: "
        + json.dumps(out["pruned_time_range"].aggregations))
    say("root c5 over 64 splits: equal_to_phase_11_batch=True "
        + json.dumps(out["c5_otel_64splits"].aggregations))
    if not all(checks.values()):
        raise AssertionError(f"root checks: {checks}")

    # 6. a retry: node-0's first leaf call fails
    retry_nodes = {f"node-{i}": node(dev, f"node-{i}")[0] for i in range(2)}
    injector = m.faults.FaultInjector(seed=5, rules=[m.faults.FaultRule(
        "client.leaf_search@node-0", "error", max_fires=1)])
    faulty = root_over(retry_nodes, wrap=lambda node_id, client:
                       m.faults.FaultyClient(client, injector, node_id))
    r0 = counter("SEARCH_LEAF_RETRIES_TOTAL")
    k0, l0 = counts()
    retried = faulty.search(requests["flagship"])
    seen["retry"] = {"score_topk": st.score_topk.launches - k0,
                     "score_topk_lanes": st.score_topk_lanes.launches - l0,
                     "retries": counter("SEARCH_LEAF_RETRIES_TOTAL") - r0}
    clean_nodes = {f"node-{i}": node(dev, f"node-{i}")[0] for i in range(2)}
    clean = aside(root_over(clean_nodes).search, requests["flagship"])
    same_search(retried, clean, "root retry vs fault-free")
    same_search(retried, flagship, "root retry vs one node")
    say(f"root retry: {json.dumps(seen['retry'])} fired="
        f"{json.dumps(injector.schedule())} failed_splits="
        f"{len(retried.failed_splits)} equal_to_fault_free=True")
    if seen["retry"]["retries"] != 1 or retried.failed_splits:
        raise AssertionError(f"root retry: {seen['retry']}")
    del retry_nodes, clean_nodes, faulty

    # 7. a budget too small for a cold node
    cold_svc, cold_ctx = node(dev)
    cold_root = root_over({"node-0": cold_svc})
    k0, l0 = counts()
    timed_out = cold_root.search(dataclasses.replace(
        requests["c2_es_dsl_by_ts"], timeout_millis=20))
    end = time.monotonic() + 60.0
    for thread in threading.enumerate():
        if thread.name.startswith("root-fanout-"):
            thread.join(max(end - time.monotonic(), 0.0))
    pinned = cold_ctx.hbm_budget.stats()["pinned"]
    seen["timeout"] = {"score_topk": st.score_topk.launches - k0,
                       "score_topk_lanes": st.score_topk_lanes.launches - l0}
    say(f"root timeout: timed_out={timed_out.timed_out} failed_splits="
        f"{len(timed_out.failed_splits)} errors="
        f"{sorted({e.error for e in timed_out.failed_splits})} "
        f"pinned_after={pinned} {json.dumps(seen['timeout'])}")
    if not timed_out.timed_out or pinned != 0:
        raise AssertionError("root timeout")
    del cold_root, cold_svc, cold_ctx

    path = {"score_topk": st.score_topk.launches,
            "score_topk_lanes": st.score_topk_lanes.launches}
    say(f"root launches: {json.dumps(path)}")
    if path["score_topk_lanes"] < 1 or any(
            seen[name]["score_topk"] + seen[name]["score_topk_lanes"]
            for name in ("c2_es_dsl_by_ts", "c2_page2", "c5_otel_64splits",
                         "pruned_time_range")):
        raise AssertionError(f"root launches: {path} {seen}")

    # timing, in turns
    os.makedirs(os.path.join(here, "chip_traces"), exist_ok=True)
    leaf_request = m.models.LeafSearchRequest(
        search_request=requests["flagship"], index_uid="hdfs-logs:01",
        doc_mapping=m.HDFS_MAPPER.to_dict(),
        splits=[m.models.SplitIdAndFooter(split_id, SPLITS_URI,
                                          num_docs=FANOUT_HDFS_DOCS)
                for split_id in hdfs_ids])
    batch5 = fanned["batch5"]
    pairs = (
        ("flagship", lambda: gpu_root.search(requests["flagship"]),
         "service_leaf_8splits", lambda: gpu_svc.leaf_search(leaf_request)),
        ("c5_otel_64splits",
         lambda: gpu_root.search(requests["c5_otel_64splits"]),
         "phase11_batch_64splits",
         lambda: m.fanout.execute_batch(batch5, requests["c5_otel_64splits"],
                                        device=dev)),
    )
    root_p50 = {}
    for name, root_call, other_name, other_call in pairs:
        aside(root_call)
        aside(other_call)
        walls, other_walls = [], []
        for _ in range(iters):
            t0 = time.perf_counter()
            aside(root_call)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            aside(other_call)
            torch.cuda.synchronize()
            walls.append((t1 - t0) * 1e3)
            other_walls.append((time.perf_counter() - t1) * 1e3)
        root_p50[name] = pct(walls, 0.5)
        profiled = aside(gpu_root.search, dataclasses.replace(
            requests[name], profile=True))
        prof = aside(device_profile, torch, root_call, 3, os.path.join(
            here, "chip_traces", f"trace_root_{name}.json"))
        say(f"[{label}] root timing {name}: root_p50_ms={pct(walls, 0.5):.4f}"
            f" root_p90_ms={pct(walls, 0.9):.4f} {other_name}_p50_ms="
            f"{pct(other_walls, 0.5):.4f} {other_name}_p90_ms="
            f"{pct(other_walls, 0.9):.4f} iters={iters}")
        say(f"[{label}] root phases {name} (one profiled call, ms): "
            + json.dumps(phase_ms(profiled.profile)) + " counters="
            + json.dumps(profiled.profile["counters"]))
        say(f"[{label}] profile root {name}: {prof}")
    say(f"root node budget: {json.dumps(gpu_ctx.hbm_budget.stats())}")
    # what phases 15 and 16 serve: the bytes, the metastore files, the
    # requests and the responses on the card they must equal
    return {"launches": path, "storage": storage,
            "meta_storage": meta_storage, "flagship": out["flagship"],
            "c5": out["c5_otel_64splits"], "root_p50_ms": root_p50,
            "requests": requests, "hdfs_ids": hdfs_ids,
            "otel_ids": otel_ids}


# --------------------------------------------------------------------------
# phase 13: the write path

WRITE_DOCS = 524_288            # phases 11-12's split size, as 4 splits
WRITE_SPLITS = 4
WRITE_REQUEST_DOCS = 4_096      # docs per ingest request
WRITE_DELETED_TENANT = 10       # carried by the last request alone
WRITE_RARE_TERM = 3_000         # ~24 of 524,288 docs: every hit on a page
WRITE_T0 = 1_600_000_000


def write_docs(synthetic, num_docs, request_docs, seed):
    """hdfs-logs docs with `HDFS_MAPPER`'s fields and the generator's value
    distributions: timestamps over seven days, in request order with the
    order inside each request shuffled; tenants 0-9, except the last
    request's docs, which all carry `WRITE_DELETED_TENANT`; the
    generator's severity mix; 20 zipf(1.5) body terms over its
    vocabulary. `tests/test_torch_write_path.py` makes its docs here too."""
    import numpy as np
    rng = np.random.RandomState(seed)
    ts = np.sort(rng.randint(0, 7 * 86_400, size=num_docs)) + WRITE_T0
    for lo in range(0, num_docs, request_docs):
        ts[lo:lo + request_docs] = rng.permutation(ts[lo:lo + request_docs])
    tenants = rng.randint(0, 10, size=num_docs)
    tenants[num_docs - request_docs:] = WRITE_DELETED_TENANT
    sev = rng.choice(len(synthetic.SEVERITIES), size=num_docs,
                     p=synthetic._SEVERITY_P)
    vocab_size = synthetic._BODY_VOCAB_SIZE
    words = np.minimum(rng.zipf(1.5, size=(num_docs,
                                           synthetic._BODY_TOKENS_PER_DOC))
                       - 1, vocab_size - 1)
    vocab = [synthetic.body_term(k) for k in range(vocab_size)]
    return [{"timestamp": int(ts[i]), "tenant_id": int(tenants[i]),
             "severity_text": synthetic.SEVERITIES[sev[i]],
             "body": " ".join([vocab[w] for w in words[i]])}
            for i in range(num_docs)]


def write_requests(m, flagship_aggs, index_id="hdfs-write"):
    """Search A over `index_id`: the flagship (term top-10 by BM25 with its
    aggregations), c2 as ES-DSL (bool + range, top-100), c3 (the
    aggregations alone), the deleted tenant's count and every hit of a rare
    body term by time."""
    t0_us = WRITE_T0 * 1_000_000
    c2 = {"bool": {
        "must": [{"term": {"severity_text": "ERROR"}}],
        "should": [{"term": {"body": m.body_term(3)}},
                   {"term": {"body": m.body_term(7)}}],
        "filter": [{"range": {"timestamp": {"gte": t0_us + DAY_US,
                                            "lt": t0_us + 4 * DAY_US}}}]}}

    def request(query, **kw):
        ast = (m.es_query_to_ast(query) if isinstance(query, dict)
               else m.parse_query_string(query, ["body"]))
        return m.SearchRequest(index_ids=[index_id], query_ast=ast, **kw)

    return {
        "flagship": request("severity_text:ERROR", max_hits=10,
                            aggs=flagship_aggs),
        "c2_bool_range_top100": request(c2, max_hits=100),
        "c3_aggs": request("severity_text:ERROR", max_hits=0,
                           aggs=flagship_aggs),
        "deleted_tenant": request(f"tenant_id:{WRITE_DELETED_TENANT}",
                                  max_hits=0),
        "rare_term_all_hits": request(
            f"body:{m.body_term(WRITE_RARE_TERM)}", max_hits=100,
            sort_fields=(m.SortField("timestamp", "desc"),)),
    }


def check_write(torch, st, m, dev, label, num_docs, seed,
                flagship_aggs) -> dict:
    """Phase 13: the node's write flow on the card (WAL ingest, one ingest
    pass, the delete planner's probes, a compaction pass, GC), searching
    after each step through a root over a node on the card, each response
    against a root over a CPU node. Returns the path's launches."""
    split_docs = num_docs // WRITE_SPLITS
    out_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_write_")
    base = out_dir.name
    resolver = m.StorageResolver.for_test()
    split_uri, meta_uri = f"file://{base}/splits", f"file://{base}/metastore"
    split_storage = resolver.resolve(split_uri)
    metastore = m.FileBackedMetastore(resolver.resolve(meta_uri))
    index_uid = "hdfs-write:01"
    metastore.create_index(m.IndexMetadata(
        index_uid=index_uid, index_config=m.IndexConfig(
            index_id="hdfs-write", index_uri=split_uri,
            doc_mapper=m.HDFS_MAPPER, split_num_docs_target=split_docs,
            # splits at or above the policy's own target never merge
            merge_policy={"type": "stable_log", "merge_factor": WRITE_SPLITS,
                          "max_merge_factor": WRITE_SPLITS,
                          "split_num_docs_target": 10_000_000})))
    wal_dir = os.path.join(base, "wal")
    ingester = m.ingest.Ingester(wal_dir, fsync=True)
    router = m.ingest.IngestRouter(ingester, shards_per_source=1)
    requests = write_requests(m, flagship_aggs)

    def counts():
        return st.score_topk.launches, st.score_topk_lanes.launches

    def aside(fn, *args, **kw):
        """Run a comparison or a timing: its launches are not the path's."""
        saved = counts()
        try:
            return fn(*args, **kw)
        finally:
            st.score_topk.launches, st.score_topk_lanes.launches = saved

    def root(device):
        ctx = m.svc_mod.SearcherContext(
            storage_resolver=resolver, device=device, batch_size=8,
            leaf_cache_bytes=0, enable_agg_cache=False,
            enable_mask_cache=False)
        client = m.svc_mod.LocalSearchClient(
            m.svc_mod.SearchService(ctx, node_id="node-0"))
        return m.RootSearcher(metastore, {"node-0": client})

    gpu_root, cpu_root = root(dev), root("cpu")
    seconds, launches = {}, {}

    def search_a(step):
        k0, l0 = counts()
        out = {name: gpu_root.search(req) for name, req in requests.items()}
        launches[step] = {"score_topk": st.score_topk.launches - k0,
                          "score_topk_lanes": st.score_topk_lanes.launches
                          - l0}
        for name, resp in out.items():
            same_search(resp, aside(cpu_root.search, requests[name]),
                        f"write {step} {name}")
            if resp.errors:
                raise AssertionError(f"write {step} {name}: {resp.errors}")
        say(f"write search {step}: " + json.dumps(
            {name: [r.num_hits, len(r.hits), r.num_attempted_splits]
             for name, r in out.items()}) + " launches="
            + json.dumps(launches[step]) + " equal_to_cpu_root=True")
        return out

    def flagship_p50():
        aside(gpu_root.search, requests["flagship"])
        walls = []
        for _ in range(10):
            t0 = time.perf_counter()
            aside(gpu_root.search, requests["flagship"])
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return pct(walls, 0.5)

    def stored(resp):
        return sorted(json.dumps(h.doc, sort_keys=True) for h in resp.hits)

    st.score_topk.launches = st.score_topk_lanes.launches = 0

    # 1. ingest: requests of 4,096 docs through the router into the WAL
    t0 = time.perf_counter()
    docs = write_docs(m.synthetic, num_docs, WRITE_REQUEST_DOCS, seed)
    docs_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for lo in range(0, num_docs, WRITE_REQUEST_DOCS):
        router.ingest(index_uid, docs[lo:lo + WRITE_REQUEST_DOCS])
    seconds["ingest"] = time.perf_counter() - t0
    del docs
    head = ingester.shard_throughput_state()
    say(f"write ingest: docs={num_docs} requests="
        f"{num_docs // WRITE_REQUEST_DOCS} fsync=True docs_made_s="
        f"{docs_s:.3f} s={seconds['ingest']:.3f} docs_per_s="
        f"{num_docs / seconds['ingest']:.0f} wal={json.dumps(head)}")

    # 2. index: one ingest pass (`Node.run_ingest_pass`), then truncate
    t0 = time.perf_counter()
    source_id = m.INGEST_V2_SOURCE_ID
    metastore.add_source(index_uid, m.SourceConfig(source_id, "ingest"))
    counters = m.pipeline.IndexingPipeline(
        m.pipeline.PipelineParams(
            index_uid=index_uid, source_id=source_id,
            split_num_docs_target=split_docs,
            batch_num_docs=WRITE_REQUEST_DOCS),
        m.HDFS_MAPPER, m.IngestSource(ingester, index_uid, source_id),
        metastore, split_storage).run_to_completion()
    checkpoint = metastore.source_checkpoint(index_uid, source_id)
    for shard in ingester.list_shards(index_uid):
        position = checkpoint.position_for(shard.shard_id)
        if position != m.BEGINNING:
            ingester.truncate(index_uid, source_id, shard.shard_id,
                              int(position))
    seconds["index"] = time.perf_counter() - t0
    published = metastore.list_splits(m.ListSplitsQuery(
        index_uids=[index_uid], states=[m.SplitState.PUBLISHED]))
    wal = ingester.shard_throughput_state()
    wal_bytes = sum(os.path.getsize(os.path.join(d, f))
                    for d, _, files in os.walk(wal_dir) for f in files)
    say(f"write index: s={seconds['index']:.3f} docs_per_s="
        f"{num_docs / seconds['index']:.0f} splits="
        f"{[s.metadata.num_docs for s in published]} counters="
        f"{json.dumps(vars(counters))} wal={json.dumps(wal)} "
        f"wal_bytes_after_truncate={wal_bytes}")
    if ([s.metadata.num_docs for s in published] != [split_docs]
            * WRITE_SPLITS or any(s["published"] != num_docs
                                  for s in wal.values())):
        raise AssertionError("write index: splits or truncation")

    # 3. search A over the 4 indexed splits
    t0 = time.perf_counter()
    indexed = search_a("indexed")
    p50_indexed = flagship_p50()
    seconds["search_indexed"] = time.perf_counter() - t0
    if (indexed["deleted_tenant"].num_hits != WRITE_REQUEST_DOCS
            or len(indexed["flagship"].hits) != 10):
        raise AssertionError("write search indexed")

    # 4. delete: a task on the last request's tenant, the planner's count
    # probes on the card (`run_delete_planner`, the janitor's last step)
    t0 = time.perf_counter()
    metastore.create_delete_task(index_uid, {
        "type": "term", "field": "tenant_id",
        "value": str(WRITE_DELETED_TENANT)})
    k0, l0 = counts()
    planned = m.run_delete_planner(metastore, resolver, node_id="node-0",
                                   device=dev)
    launches["delete_probes"] = {
        "score_topk": st.score_topk.launches - k0,
        "score_topk_lanes": st.score_topk_lanes.launches - l0}
    seconds["delete"] = time.perf_counter() - t0
    say(f"write delete: s={seconds['delete']:.3f} planner="
        f"{json.dumps(planned)} probe_launches="
        f"{json.dumps(launches['delete_probes'])}")
    if planned != {"delete_splits_rewritten": 1,
                   "delete_splits_fast_forwarded": WRITE_SPLITS - 1,
                   "delete_splits_pending": 0}:
        raise AssertionError(f"write delete planner: {planned}")
    deleted = search_a("deleted")
    if deleted["deleted_tenant"].num_hits != 0:
        raise AssertionError("write delete: the tenant's docs remain")

    # 5. merge: one compaction pass (planner and supervisor), which must
    # take the array fast path: no doc-level rewrite
    t0 = time.perf_counter()
    fast, rewrites = [], []
    merge_splits, iter_all_docs = (m.merge_arrays.merge_splits,
                                   m.merge_mod._iter_all_docs)

    def counted_merge(readers, **kw):
        fast.append(len(readers))
        return merge_splits(readers, **kw)

    def counted_rewrite(reader):
        rewrites.append(reader)
        return iter_all_docs(reader)

    m.merge_arrays.merge_splits = counted_merge
    m.merge_mod._iter_all_docs = counted_rewrite
    try:
        planner = m.compaction.CompactionPlanner(metastore)
        supervisor = m.compaction.CompactorSupervisor(
            metastore, resolver, node_id="node-0", max_concurrent_merges=1)
        done = []
        for task in planner.plan(max_tasks=supervisor.available_slots()):
            supervisor.submit(task, synchronous=True,
                              on_done=lambda task, ok: done.append(ok))
    finally:
        m.merge_arrays.merge_splits = merge_splits
        m.merge_mod._iter_all_docs = iter_all_docs
    seconds["merge"] = time.perf_counter() - t0
    [merged] = metastore.list_splits(m.ListSplitsQuery(
        index_uids=[index_uid], states=[m.SplitState.PUBLISHED]))
    say(f"write merge: s={seconds['merge']:.3f} tasks={done} "
        f"fast_path_inputs={fast} doc_level_rewrites={len(rewrites)} "
        f"merged={json.dumps(merged.metadata.to_dict())}")
    if (done != [True] or fast != [WRITE_SPLITS] or rewrites
            or merged.metadata.num_docs != num_docs - WRITE_REQUEST_DOCS):
        raise AssertionError("write merge")
    t0 = time.perf_counter()
    after = search_a("merged")
    p50_merged = flagship_p50()
    seconds["search_merged"] = time.perf_counter() - t0
    # the timestamp reorder renumbers doc ids: counts, buckets and stored
    # docs must hold
    for name, resp in after.items():
        if resp.num_hits != deleted[name].num_hits:
            raise AssertionError(f"write merge {name}: num_hits")
        if resp.aggregations is not None:
            same_search(resp.aggregations, deleted[name].aggregations,
                        f"write merge {name} vs deleted",
                        path="response.aggregations")
        elif deleted[name].aggregations is not None:
            raise AssertionError(f"write merge {name}: aggregations")
    rare = after["rare_term_all_hits"]
    if (stored(rare) != stored(deleted["rare_term_all_hits"])
            or not 0 < len(rare.hits) == rare.num_hits):
        raise AssertionError("write merge: the rare term's docs")

    # 6. gc past the deletion grace: only the merged split's file stays
    t0 = time.perf_counter()
    collected = m.gc.run_garbage_collection(
        metastore, resolver, now=time.time() + m.gc.DELETION_GRACE_SECS + 1)
    seconds["gc"] = time.perf_counter() - t0
    left = split_storage.list_files()
    say(f"write gc: s={seconds['gc']:.3f} {json.dumps(collected)} "
        f"files_left={left}")
    if left != [f"{merged.metadata.split_id}.split"]:
        raise AssertionError("write gc")
    search_a("collected")

    path = {"score_topk": st.score_topk.launches,
            "score_topk_lanes": st.score_topk_lanes.launches}
    say(f"[{label}] write seconds: " + json.dumps(
        {k: round(v, 3) for k, v in seconds.items()}))
    say(f"[{label}] write flagship p50 (10 warm root calls): "
        f"indexed_4_splits_ms={p50_indexed:.4f} "
        f"merged_1_split_ms={p50_merged:.4f}")
    say(f"write launches: {json.dumps(path)} per_step="
        f"{json.dumps(launches)}")
    if path["score_topk_lanes"] < 1:
        raise AssertionError(f"write launches: {path}")
    del gpu_root, cpu_root
    out_dir.cleanup()
    return {"launches": path}


# --------------------------------------------------------------------------
# phase 14: external sources and the control plane

SOURCES_KINDS = ("kafka", "kinesis", "sqs")
SOURCES_TOPIC = "hdfs-logs"             # the Kafka topic and Kinesis stream
SOURCES_BUCKET = "hdfs-logs-landing"    # where the SQS-notified files land
SOURCES_SIZES = {                       # phase 14 on the card
    "kafka_partitions": 8, "kafka_docs": 262_144,
    "kinesis_shards": 4, "kinesis_docs": 65_536,
    "sqs_files": 16, "sqs_docs": 65_536,
    "split_docs": 131_072,      # phase 13's split target
    "rare_term": 600,           # ~30 of 65,536 docs: every hit on a page
}
SOURCES_KEYS = {"region": "us-east-1", "access_key": "AKIDSOURCES",
                "secret_key": "sources-secret"}
SOURCES_INDEXERS = ("indexer-0", "indexer-1", "indexer-2")
SOURCES_PERMITS = 2                     # concurrent turns per indexer
SOURCES_HEARTBEAT_SECS = 1.0
SOURCES_TURN_TIMEOUT_SECS = 600.0


def sources_modules():
    """The port's modules under the names `SourcesFlow`, `check_sources`
    and the search helpers read."""
    from types import SimpleNamespace

    from quickwit_tpu_torch.cluster.gossip import GossipService
    from quickwit_tpu_torch.cluster.membership import Cluster, ClusterMember
    from quickwit_tpu_torch.common import clock
    from quickwit_tpu_torch.common.actors import Actor, Universe
    from quickwit_tpu_torch.common.uri import Protocol
    from quickwit_tpu_torch.control_plane import (
        IndexingScheduler, IndexingTask)
    from quickwit_tpu_torch.index import synthetic
    from quickwit_tpu_torch.indexing import kafka, pipeline, sqs
    from quickwit_tpu_torch.indexing.cooperative import (
        CooperativeIndexingCycle)
    from quickwit_tpu_torch.indexing.fake_kafka import FakeKafkaBroker
    from quickwit_tpu_torch.indexing.fake_kinesis import FakeKinesisServer
    from quickwit_tpu_torch.indexing.fake_sqs import FakeSqsServer
    from quickwit_tpu_torch.indexing.sources import make_source
    from quickwit_tpu_torch.metastore import (
        FileBackedMetastore, ListSplitsQuery, checkpoint)
    from quickwit_tpu_torch.models.index_metadata import (
        IndexConfig, IndexMetadata, SourceConfig)
    from quickwit_tpu_torch.models.split_metadata import SplitState
    from quickwit_tpu_torch.query import parse_query_string
    from quickwit_tpu_torch.query.es_dsl import es_query_to_ast
    from quickwit_tpu_torch.search import service as svc_mod
    from quickwit_tpu_torch.search.models import SearchRequest, SortField
    from quickwit_tpu_torch.search.root import RootSearcher
    from quickwit_tpu_torch.storage import StorageResolver
    from quickwit_tpu_torch.storage.fake_s3 import FakeS3Server
    from quickwit_tpu_torch.storage.s3 import S3CompatibleStorage, S3Config
    return SimpleNamespace(
        synthetic=synthetic, HDFS_MAPPER=synthetic.HDFS_MAPPER,
        body_term=synthetic.body_term, clock=clock,
        StorageResolver=StorageResolver, Protocol=Protocol,
        FakeS3Server=FakeS3Server, S3CompatibleStorage=S3CompatibleStorage,
        S3Config=S3Config, FakeKafkaBroker=FakeKafkaBroker,
        FakeKinesisServer=FakeKinesisServer, FakeSqsServer=FakeSqsServer,
        kafka=kafka, sqs=sqs, checkpoint=checkpoint,
        FileBackedMetastore=FileBackedMetastore,
        ListSplitsQuery=ListSplitsQuery, IndexMetadata=IndexMetadata,
        IndexConfig=IndexConfig, SourceConfig=SourceConfig,
        SplitState=SplitState, Cluster=Cluster, ClusterMember=ClusterMember,
        GossipService=GossipService, IndexingScheduler=IndexingScheduler,
        IndexingTask=IndexingTask, Universe=Universe, Actor=Actor,
        CooperativeIndexingCycle=CooperativeIndexingCycle,
        make_source=make_source, pipeline=pipeline, svc_mod=svc_mod,
        RootSearcher=RootSearcher, SearchRequest=SearchRequest,
        SortField=SortField, parse_query_string=parse_query_string,
        es_query_to_ast=es_query_to_ast)


def sources_docs(synthetic, sizes, seed):
    """Each source's hdfs-logs docs in production order (`write_docs`, one
    seed per source, none of them phase 13's)."""
    return {kind: write_docs(synthetic, sizes[f"{kind}_docs"],
                             min(WRITE_REQUEST_DOCS, sizes[f"{kind}_docs"]),
                             seed + 1 + i)
            for i, kind in enumerate(SOURCES_KINDS)}


def s3_event(bucket, key, size):
    """One S3 `ObjectCreated:Put` event notification, as S3 sends it to
    SQS."""
    return json.dumps({"Records": [{
        "eventVersion": "2.1", "eventSource": "aws:s3",
        "awsRegion": SOURCES_KEYS["region"], "eventName": "ObjectCreated:Put",
        "s3": {"s3SchemaVersion": "1.0", "bucket": {"name": bucket},
               "object": {"key": key, "size": size}}}]})


class SourcesFlow:
    """Phase 14's flow in one package (`m`, a namespace of its modules):

    - a `FakeKafkaBroker` (one topic), a `FakeKinesisServer` (one stream)
      and a `FakeSqsServer` whose queue carries one S3 event per ndjson
      file landed in a `FakeS3Server`, which the flow's `StorageResolver`
      serves `s3://` from;
    - one index over `HDFS_MAPPER` per source in a `FileBackedMetastore`;
    - a `Cluster` of three indexers heartbeating on a `FakeClock`, whose
      live indexers the `IndexingScheduler` plans the (index, source)
      tasks over, built as `Node.schedule_indexing` builds them;
    - each planned pipeline a supervised actor on one `Universe`; a turn
      is `Node._cooperative_drain` (a `CooperativeIndexingCycle` per
      pipeline, `SOURCES_PERMITS` permits per indexer) around
      `Node.run_source_pass` (one `IndexingPipeline.run_to_completion()`
      over the indexer's cached `make_source` client).

    Call the steps under `use_clock(flow.clock)`; `close()` stops every
    actor, client and server. `tests/test_torch_sources_path.py` runs the
    flow in both packages at a small size."""

    def __init__(self, m, sizes, seed, base_uri):
        self.m, self.sizes, self.base_uri = m, dict(sizes), base_uri
        self.docs = sources_docs(m.synthetic, sizes, seed)
        self.clock = m.clock.FakeClock()
        self.resolver = m.StorageResolver.for_test()
        self.servers, self.clients, self.actors = [], {}, {}
        self.cycles, self.wake, self.sent = {}, {}, []
        self.permits = {node: threading.Semaphore(SOURCES_PERMITS)
                        for node in SOURCES_INDEXERS}
        self.live = set(SOURCES_INDEXERS)
        self.universe = None
        self.produced = {kind: 0 for kind in SOURCES_KINDS}

    # --- set-up and tear-down ---------------------------------------------
    def setup(self):
        """Start the brokers, create the indexes, join the indexers and
        apply the first plan. Returns the plan."""
        m, sizes, keys = self.m, self.sizes, SOURCES_KEYS
        s3 = m.FakeS3Server(access_key=keys["access_key"],
                            secret_key=keys["secret_key"]).start()
        self.servers.append(s3)
        s3_config = m.S3Config(endpoint=s3.endpoint, **keys)
        self.resolver.register(m.Protocol.S3, lambda uri: m.S3CompatibleStorage(
            uri, s3_config))
        self.broker = m.FakeKafkaBroker()
        self.servers.append(self.broker)
        self.broker.create_topic(SOURCES_TOPIC,
                                 partitions=sizes["kafka_partitions"])
        self.kinesis = m.FakeKinesisServer(
            access_key=keys["access_key"], secret_key=keys["secret_key"])
        self.servers.append(self.kinesis.start())
        self.kinesis.create_stream(SOURCES_TOPIC,
                                   num_shards=sizes["kinesis_shards"])
        self.sqs = m.FakeSqsServer(access_key=keys["access_key"],
                                   secret_key=keys["secret_key"],
                                   visibility_timeout=30.0)
        self.servers.append(self.sqs.start())
        params = {
            "kafka": {"topic": SOURCES_TOPIC, "client_params": {
                "bootstrap.servers": f"{self.broker.host}:"
                                     f"{self.broker.port}"}},
            "kinesis": {"stream_name": SOURCES_TOPIC,
                        "endpoint": self.kinesis.endpoint, **keys},
            "sqs": {"queue_url": self.sqs.queue_url,
                    "endpoint": self.sqs.endpoint, **keys}}
        self.metastore = m.FileBackedMetastore(
            self.resolver.resolve(f"{self.base_uri}/metastore"))
        for kind in SOURCES_KINDS:
            self.metastore.create_index(m.IndexMetadata(
                index_uid=f"hdfs-{kind}:01", index_config=m.IndexConfig(
                    index_id=f"hdfs-{kind}",
                    index_uri=f"{self.base_uri}/{kind}",
                    doc_mapper=m.HDFS_MAPPER,
                    split_num_docs_target=sizes["split_docs"]),
                sources={f"{kind}-source": m.SourceConfig(
                    f"{kind}-source", kind, params=params[kind])}))
        self.cluster = m.Cluster("control-plane",
                                 ("control_plane", "metastore"))
        for i, node in enumerate(SOURCES_INDEXERS):
            self.cluster.join(m.ClusterMember(
                node, ("indexer",), rest_endpoint=f"127.0.0.1:{7280 + i}"))
        self.tick(4 * SOURCES_HEARTBEAT_SECS)
        self.scheduler = m.IndexingScheduler()
        self.tasks = self.indexing_tasks()
        self.plan = self.scheduler.schedule(
            self.tasks, self.cluster.nodes_with_role("indexer"))
        self.universe = m.Universe()
        self.apply(self.plan)
        return self.plan

    def close(self):
        """Stop every actor, source client and server (safe to repeat)."""
        if self.universe is not None:
            self.universe.quit(timeout=10.0)
            self.universe = None
        for client in self.clients.values():
            client.close()
        self.clients.clear()
        for server in self.servers:
            server.stop()
        self.servers.clear()

    # --- the control plane --------------------------------------------------
    def indexing_tasks(self):
        """`Node.schedule_indexing`'s logical tasks: one per enabled
        external source (no ingest shards here)."""
        return [self.m.IndexingTask(metadata.index_uid, source_id)
                for metadata in self.metastore.list_indexes()
                for source_id, source in metadata.sources.items()
                if source.enabled and source.source_type != "void"]

    def tick(self, secs):
        """Move the fake clock by `secs` in heartbeat steps; each live
        indexer heartbeats at every step."""
        for _ in range(max(1, -int(-secs // SOURCES_HEARTBEAT_SECS))):
            self.clock.advance(SOURCES_HEARTBEAT_SECS)
            for node in sorted(self.live):
                self.cluster.record_heartbeat(node)

    def running(self):
        """What the live indexers report running."""
        out = {}
        for (node, _key), (_mailbox, task) in sorted(self.actors.items()):
            if node in self.live:
                out.setdefault(node, []).append(task)
        return out

    def apply(self, plan):
        """Each live indexer's `apply_indexing_plan`: pipelines it no
        longer holds stop; the ones it gained start. A dead indexer's
        pipelines stop with it."""
        want = {(node, t.key): t for node, tasks in plan.assignments.items()
                for t in tasks}
        for key in list(self.actors):
            if key not in want or key[0] not in self.live:
                mailbox, _task = self.actors.pop(key)
                mailbox.close()
                client = self.clients.pop(key, None)
                if client is not None:
                    client.close()
        for key, task in sorted(want.items()):
            if key not in self.actors:
                self.actors[key] = (self.spawn(key[0], task), task)

    def spawn(self, node, task):
        flow = self

        class PipelineActor(self.m.Actor):
            name = f"{node}/{task.index_uid}/{task.source_id}"

            def on_message(self, reply):
                try:
                    reply.put(flow.turn(node, task))
                except BaseException as exc:
                    reply.put(exc)
                    raise

        mailbox, _handle = self.universe.spawn(
            PipelineActor(), capacity=1, supervised=True, max_restarts=3)
        return mailbox

    # --- one pipeline turn (in the actor's thread) --------------------------
    def turn(self, node, task):
        """`Node._cooperative_drain` around `Node.run_source_pass`."""
        m, key = self.m, (node, task.key)
        metadata = self.metastore.index_metadata_by_uid(task.index_uid)
        now = m.clock.monotonic()
        cycle = self.cycles.get(key)
        if cycle is None:
            cycle = self.cycles[key] = m.CooperativeIndexingCycle(
                task.index_uid, metadata.index_config.commit_timeout_secs,
                self.permits[node], clock=m.clock.monotonic)
            self.wake[key] = now + cycle.initial_sleep_duration()
        if now < self.wake[key]:
            return {"ran": False}
        period = cycle.begin_period(timeout=0.001)
        if period is None:
            return {"ran": False}
        published, t0 = 0, time.perf_counter()
        try:
            counters = self.source_pass(node, task, metadata)
            published = counters.num_published_bytes
        finally:
            sleep_s, metrics = period.end_of_work(published)
            self.wake[key] = m.clock.monotonic() + sleep_s
        return {"ran": True, "node": node, "source": task.source_id,
                "s": time.perf_counter() - t0, "sleep_s": sleep_s,
                "cpu_load_mcpu": metrics.cpu_load_mcpu,
                "counters": vars(counters)}

    def source_pass(self, node, task, metadata):
        m, key = self.m, (node, task.key)
        config = metadata.sources[task.source_id]
        client = self.clients.get(key)
        if client is None:
            client = self.clients[key] = m.make_source(
                config.source_type, config.params, resolver=self.resolver)
        # a Kafka partition's half is one record batch, fetched whole
        batch = (self.sizes["kafka_docs"]
                 // self.sizes["kafka_partitions"] // 2)
        pipeline = m.pipeline.IndexingPipeline(
            m.pipeline.PipelineParams(
                index_uid=task.index_uid, source_id=task.source_id,
                node_id=node,
                split_num_docs_target=metadata.index_config
                .split_num_docs_target, batch_num_docs=batch),
            metadata.index_config.doc_mapper, client, self.metastore,
            self.resolver.resolve(metadata.index_config.index_uri))
        try:
            return pipeline.run_to_completion()
        except Exception:
            self.clients.pop(key, None)
            client.close()
            raise

    def drain(self, label):
        """One turn of every planned pipeline, each on its actor. A turn
        the cycle defers (before its wake time, or no permit free) is sent
        again once the clock has moved to the earliest pending wake.
        Returns {(node, task key): turn}."""
        pending, ran = dict(self.actors), {}
        for _ in range(16):
            replies = {}
            for key, (mailbox, _task) in pending.items():
                replies[key] = queue.Queue()
                mailbox.send(replies[key], timeout=60.0)
            for key, reply in replies.items():
                try:
                    out = reply.get(timeout=SOURCES_TURN_TIMEOUT_SECS)
                except queue.Empty:
                    raise AssertionError(f"sources {label}: {key} hung")
                if isinstance(out, BaseException):
                    raise AssertionError(
                        f"sources {label}: {key} raised {out!r}") from out
                if out["ran"]:
                    ran[key] = out
                    del pending[key]
            if not pending:
                return ran
            self.tick(max(min(self.wake[k] for k in pending)
                          - self.clock.monotonic(), 0.0))
        raise AssertionError(f"sources {label}: turns never ran: "
                             f"{sorted(pending)}")

    # --- the brokers' producers ---------------------------------------------
    def produce(self, half):
        """Half `half` (0 or 1) of every source's docs: each Kafka
        partition's half as one record batch, Kinesis records round-robin
        over the shards, SQS files landed in S3 and notified one event
        each."""
        sizes = self.sizes
        docs = self.docs["kafka"]
        per = len(docs) // sizes["kafka_partitions"]
        for p in range(sizes["kafka_partitions"]):
            part = docs[p * per:(p + 1) * per]
            part = part[half * per // 2:(half + 1) * per // 2]
            self.broker.seed(SOURCES_TOPIC, p,
                             [json.dumps(d).encode() for d in part])
            self.produced["kafka"] += len(part)
        docs = self.docs["kinesis"]
        for d in docs[half * len(docs) // 2:(half + 1) * len(docs) // 2]:
            self.kinesis.put_record(SOURCES_TOPIC, json.dumps(d).encode())
            self.produced["kinesis"] += 1
        docs, files = self.docs["sqs"], sizes["sqs_files"]
        per = len(docs) // files
        landing = self.resolver.resolve(f"s3://{SOURCES_BUCKET}/landing")
        for f in range(half * files // 2, (half + 1) * files // 2):
            data = "\n".join(json.dumps(d)
                             for d in docs[f * per:(f + 1) * per]).encode()
            landing.put(f"part-{f:05d}.ndjson", data)
            self.sent.append(self.sqs.send_message(s3_event(
                SOURCES_BUCKET, f"landing/part-{f:05d}.ndjson", len(data))))
            self.produced["sqs"] += per

    # --- the steps ----------------------------------------------------------
    def move(self):
        """The Kafka task's indexer stops heartbeating; once the clock has
        passed `dead_after_secs` the scheduler re-plans over the live
        indexers and the plan is applied."""
        kafka = next(t for t in self.tasks if t.source_id == "kafka-source")
        before = self.plan
        dead = before.node_of(kafka)
        self.live.discard(dead)
        self.tick(self.cluster.dead_after_secs + SOURCES_HEARTBEAT_SECS)
        indexers = self.cluster.nodes_with_role("indexer")
        running = self.running()
        self.plan = self.scheduler.schedule(self.tasks, indexers)
        drift = self.scheduler.plan_drift(running)
        self.apply(self.plan)
        drift_after = self.scheduler.plan_drift(self.running())
        out = {"dead": dead, "indexers": indexers,
               "kafka": [dead, self.plan.node_of(kafka)],
               "stayed": {t.source_id: [before.node_of(t),
                                        self.plan.node_of(t)]
                          for t in self.tasks if t != kafka},
               "drift_before_apply": drift, "drift_after_apply": drift_after}
        if (dead in indexers or self.plan.node_of(kafka) in (None, dead)
                or any(a != b for a, b in out["stayed"].values())
                or not drift or drift_after):
            raise AssertionError(f"sources move: {out}")
        return out

    def published(self, kind):
        return self.metastore.list_splits(self.m.ListSplitsQuery(
            index_uids=[f"hdfs-{kind}:01"],
            states=[self.m.SplitState.PUBLISHED]))

    def expected_checkpoints(self):
        m, sizes = self.m, self.sizes
        per = sizes["kafka_docs"] // sizes["kafka_partitions"]
        return {
            "kafka": {f"{SOURCES_TOPIC}:{p}": m.checkpoint.offset_position(per)
                      for p in range(sizes["kafka_partitions"])},
            "kinesis": {f"{SOURCES_TOPIC}:{shard}": str(records[-1][0])
                        for shard, records
                        in self.kinesis.streams[SOURCES_TOPIC].items()},
            "sqs": {f"s3://{SOURCES_BUCKET}/landing/part-{f:05d}.ndjson":
                    m.sqs.EOF_POSITION for f in range(sizes["sqs_files"])}}

    def exactly_once(self):
        """Every index's published docs equal what its source produced,
        every checkpoint sits at its end, every SQS message is deleted."""
        want = self.expected_checkpoints()
        out = {"splits": {}, "published_docs": {}, "checkpoints_at_end": {}}
        for kind in SOURCES_KINDS:
            splits = self.published(kind)
            out["splits"][kind] = sorted(s.metadata.num_docs for s in splits)
            out["published_docs"][kind] = sum(out["splits"][kind])
            checkpoint = self.metastore.source_checkpoint(
                f"hdfs-{kind}:01", f"{kind}-source").to_dict()
            out["checkpoints_at_end"][kind] = checkpoint == want[kind]
        out["sqs_messages"] = {"sent": len(self.sent),
                               "deleted": len(set(self.sqs.deleted)),
                               "left": self.sqs.visible_count()}
        if (out["published_docs"] != self.produced
                or not all(out["checkpoints_at_end"].values())
                or sorted(set(self.sqs.deleted)) != sorted(self.sent)
                or self.sqs.visible_count()):
            raise AssertionError(f"sources exactly once: {out} produced="
                                 f"{self.produced}")
        return out


def sources_requests(m, index_id, rare_term):
    """The exactly-once searches: each severity's count (every doc carries
    one severity term once) and every hit of a rare body term with its
    stored doc."""
    def request(query, **kw):
        return m.SearchRequest(index_ids=[index_id],
                               query_ast=m.parse_query_string(query, ["body"]),
                               **kw)

    out = {f"severity_{s}": request(f"severity_text:{s}", max_hits=0)
           for s in m.synthetic.SEVERITIES}
    out["rare_term_all_hits"] = request(
        f"body:{m.body_term(rare_term)}", max_hits=1000,
        sort_fields=(m.SortField("timestamp", "desc"),))
    return out


def check_exactly_once_search(m, docs, rare_term, responses, label):
    """The searches of `sources_requests` against the docs produced: each
    severity counted once per doc, and the rare term's hits are its docs,
    each once."""
    counts = {s: 0 for s in m.synthetic.SEVERITIES}
    for d in docs:
        counts[d["severity_text"]] += 1
    got = {s: responses[f"severity_{s}"].num_hits for s in counts}
    term = m.body_term(rare_term)
    want_docs = sorted(json.dumps(d, sort_keys=True) for d in docs
                       if term in d["body"].split())
    rare = responses["rare_term_all_hits"]
    got_docs = sorted(json.dumps(h.doc, sort_keys=True) for h in rare.hits)
    keys = {(h.split_id, h.doc_id) for h in rare.hits}
    if (got != counts or got_docs != want_docs or not want_docs
            or len(keys) != len(rare.hits) or len(keys) != rare.num_hits):
        raise AssertionError(f"{label}: severities {got} vs {counts}, rare "
                             f"term {len(got_docs)} vs {len(want_docs)} docs")
    return {"severities": got, "rare_term_hits": len(got_docs)}


def check_gossip(m, timeout_s=10.0):
    """Two `GossipService`s on loopback UDP under a `ScaledClock`: they
    discover each other, one stops, and it ages out of the other's
    `Cluster`. Returns the seconds of each part."""
    seconds, t0 = {}, time.perf_counter()
    deadline = t0 + timeout_s

    def until(predicate):
        while not predicate():
            if time.perf_counter() > deadline:
                raise AssertionError("gossip: past its time cap")
            time.sleep(0.01)

    def alive(cluster):
        return {member.node_id for member in cluster.members()}

    with m.clock.use_clock(m.clock.ScaledClock(factor=0.25)):
        nodes = []
        try:
            for name in ("gossip-a", "gossip-b"):
                cluster = m.Cluster(name, ("indexer",),
                                    rest_endpoint="127.0.0.1:0",
                                    dead_after_secs=1.0)
                seeds = (f"127.0.0.1:{nodes[0][1].port}",) if nodes else ()
                service = m.GossipService(
                    cluster, name, ("indexer",), rest_endpoint="127.0.0.1:0",
                    bind_host="127.0.0.1", bind_port=0, seeds=seeds,
                    interval_secs=0.05)
                nodes.append((cluster, service))
                service.start()
            (ca, _a), (cb, b) = nodes
            until(lambda: alive(ca) == alive(cb) == {"gossip-a", "gossip-b"})
            seconds["discover"] = time.perf_counter() - t0
            b.stop()
            t1 = time.perf_counter()
            until(lambda: alive(ca) == {"gossip-a"})
            seconds["age_out"] = time.perf_counter() - t1
        finally:
            for _cluster, service in nodes:
                service.stop()
    return seconds


def check_sources(torch, st, m, dev, label, seed, sizes,
                  flagship_aggs) -> dict:
    """Phase 14: three external sources drained by pipelines the control
    plane places on three indexers, one indexer dying half way; then the
    root's searches over the three indexes on the card against a CPU root,
    and gossip on loopback. Returns the path's launches."""
    out_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_sources_")
    seconds, launches, turns = {}, {}, []
    crc = {"s": 0.0, "bytes": 0}
    crc32c = m.kafka.crc32c

    def timed_crc(data):
        t = time.thread_time()
        try:
            return crc32c(data)
        finally:
            crc["s"] += time.thread_time() - t
            crc["bytes"] += len(data)

    def counts():
        return st.score_topk.launches, st.score_topk_lanes.launches

    def aside(fn, *args, **kw):
        saved = counts()
        try:
            return fn(*args, **kw)
        finally:
            st.score_topk.launches, st.score_topk_lanes.launches = saved

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    flow = SourcesFlow(m, sizes, seed, f"file://{out_dir.name}")
    seconds["docs"] = time.perf_counter() - t0
    m.kafka.crc32c = timed_crc
    try:
        with m.clock.use_clock(flow.clock), m.clock.use_rng(
                random.Random(seed)):
            t0 = time.perf_counter()
            plan = flow.setup()
            seconds["setup"] = time.perf_counter() - t0
            say("sources plan: " + json.dumps(
                {n: [t.source_id for t in ts]
                 for n, ts in plan.assignments.items()}))
            for step, half in (("first_half", 0), ("second_half", 1)):
                if step == "second_half":
                    t0 = time.perf_counter()
                    moved = flow.move()
                    seconds["move"] = time.perf_counter() - t0
                    say("sources move: " + json.dumps(moved) + " plan: "
                        + json.dumps({n: [t.source_id for t in ts] for n, ts
                                      in flow.plan.assignments.items()}))
                t0 = time.perf_counter()
                flow.produce(half)
                seconds[f"produce_{step}"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                ran = flow.drain(step)
                if step == "second_half":
                    # SQS deletes a message once the checkpoint proves
                    # its file published: on the pass after
                    ran_ack = flow.drain("ack")
                    turns.extend(ran_ack.values())
                seconds[f"drain_{step}"] = time.perf_counter() - t0
                turns.extend(ran.values())
                say(f"sources {step}: " + json.dumps(
                    {f"{t['node']}/{t['source']}": {
                        "docs": t["counters"]["num_docs_processed"],
                        "splits": t["counters"]["num_splits_published"],
                        "s": round(t["s"], 3), "sleep_s": t["sleep_s"]}
                     for t in ran.values()}))
            t0 = time.perf_counter()
            once = flow.exactly_once()
            seconds["exactly_once"] = time.perf_counter() - t0
        say("sources exactly once: " + json.dumps(once))
        per_source = {kind: {"docs": 0, "s": 0.0} for kind in SOURCES_KINDS}
        for t in turns:
            kind = t["source"].split("-")[0]
            per_source[kind]["docs"] += t["counters"]["num_docs_processed"]
            per_source[kind]["s"] += t["s"]
        say(f"[{label}] sources docs per second (turn seconds, all turns "
            f"concurrent on one host): " + json.dumps(
                {k: {"docs": v["docs"], "s": round(v["s"], 3),
                     "docs_per_s": round(v["docs"] / v["s"])}
                 for k, v in per_source.items()}))

        # search A on the card, on the real clock, against a CPU root
        def root(device):
            ctx = m.svc_mod.SearcherContext(
                storage_resolver=flow.resolver, device=device, batch_size=8,
                leaf_cache_bytes=0, enable_agg_cache=False,
                enable_mask_cache=False)
            client = m.svc_mod.LocalSearchClient(
                m.svc_mod.SearchService(ctx, node_id="node-0"))
            return m.RootSearcher(flow.metastore, {"node-0": client})

        gpu_root, cpu_root = root(dev), root("cpu")
        st.score_topk.launches = st.score_topk_lanes.launches = 0
        t0 = time.perf_counter()
        p50 = {}
        for kind in SOURCES_KINDS:
            index_id = f"hdfs-{kind}"
            full = write_requests(m, flagship_aggs, index_id)
            requests = {name: full[name] for name in (
                "flagship", "c2_bool_range_top100", "c3_aggs")}
            for name, req in requests.items():
                k0, l0 = counts()
                got = gpu_root.search(req)
                launches[f"{kind}/{name}"] = {
                    "score_topk": st.score_topk.launches - k0,
                    "score_topk_lanes": st.score_topk_lanes.launches - l0}
                if got.errors:
                    raise AssertionError(f"sources {kind} {name}: "
                                         f"{got.errors}")
                same_search(got, aside(cpu_root.search, req),
                            f"sources {kind} {name}")
            if launches[f"{kind}/flagship"]["score_topk_lanes"] < 1:
                raise AssertionError(f"sources {kind} flagship: "
                                     f"{launches[f'{kind}/flagship']}")
            checks = sources_requests(m, index_id, sizes["rare_term"])
            found = {}
            for name, req in checks.items():
                found[name] = aside(gpu_root.search, req)
                same_search(found[name], aside(cpu_root.search, req),
                            f"sources {kind} {name}")
            say(f"sources search {kind}: " + json.dumps(
                check_exactly_once_search(m, flow.docs[kind],
                                          sizes["rare_term"], found,
                                          f"sources {kind}"))
                + " equal_to_cpu_root=True")
            aside(gpu_root.search, requests["flagship"])
            walls = []
            for _ in range(10):
                t1 = time.perf_counter()
                aside(gpu_root.search, requests["flagship"])
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t1) * 1e3)
            p50[kind] = pct(walls, 0.5)
        seconds["search"] = time.perf_counter() - t0
        path = {"score_topk": st.score_topk.launches,
                "score_topk_lanes": st.score_topk_lanes.launches}
        del gpu_root, cpu_root

        t0 = time.perf_counter()
        gossip = check_gossip(m)
        seconds["gossip"] = time.perf_counter() - t0
    finally:
        m.kafka.crc32c = crc32c
        flow.close()
        out_dir.cleanup()
    phase_s = time.perf_counter() - t_phase
    say(f"sources gossip: {json.dumps(gossip)}")
    say(f"[{label}] sources seconds: " + json.dumps(
        {k: round(v, 3) for k, v in seconds.items()})
        + f" phase_s={phase_s:.3f}")
    say(f"[{label}] sources crc32c: s={crc['s']:.3f} bytes={crc['bytes']} "
        f"mb_per_s={crc['bytes'] / max(crc['s'], 1e-9) / 1e6:.2f} "
        f"share_of_phase={crc['s'] / phase_s:.4f}")
    say(f"[{label}] sources flagship p50 (10 warm root calls, 2 splits "
        f"each): " + json.dumps({k: round(v, 4) for k, v in p50.items()}))
    say(f"sources launches: {json.dumps(path)} per_request="
        f"{json.dumps(launches)}")
    return {"launches": path}


# --------------------------------------------------------------------------
# phase 15: the node and its REST front door

SERVE_DOCS = 262_144            # part A: two ingest requests of one split
SERVE_REQUEST_DOCS = 131_072    # each (~40 MB of ndjson, under the burst)
SERVE_RARE_TERMS = 8            # part B: concurrent searches, one term each
SERVE_RARE_FIRST = 2_000        # the first of those body terms
SERVE_START_S = 120.0           # the CLI node's start: torch and the card
SERVE_STOP_S = 10.0             # SIGINT to exit (cli.py's cmd_run)
CLOCK_KEYS = ("elapsed_time_micros", "took")   # wall times in a response


def without_clock(value):
    """A parsed JSON response without its wall-time keys."""
    if isinstance(value, dict):
        return {k: without_clock(v) for k, v in value.items()
                if k not in CLOCK_KEYS}
    if isinstance(value, list):
        return [without_clock(v) for v in value]
    return value


def rest(port, method, path, body=None, timeout=900.0):
    """One REST call on 127.0.0.1; fails unless it answers 200. Returns
    the parsed JSON body, or the text of a non-JSON one."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        data = None if body is None else (
            body if isinstance(body, bytes) else json.dumps(body).encode())
        conn.request(method, path, body=data)
        response = conn.getresponse()
        payload = response.read()
    finally:
        conn.close()
    if response.status != 200:
        raise AssertionError(f"REST {method} {path}: {response.status} "
                             f"{payload[:300]!r}")
    if response.getheader("Content-Type", "").startswith(
            "application/json"):
        return json.loads(payload)
    return payload.decode()


def prometheus_samples(text: str) -> int:
    """The number of samples in a Prometheus text exposition; fails on a
    line that is neither a comment nor `name{labels} value`."""
    import re
    sample = re.compile(r'[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? '
                        r'(-?[0-9.]+(e[-+]?[0-9]+)?|[-+]?Inf|NaN)'
                        r'( -?[0-9]+)?')
    n = 0
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        if not sample.fullmatch(line):
            raise AssertionError(f"/metrics: not Prometheus text: {line!r}")
        n += 1
    return n


def read_listening_line(proc, timeout_s: float) -> str:
    """The CLI node's `... listening on http://host:port` line."""
    import selectors
    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    end = time.monotonic() + timeout_s
    seen = []
    while time.monotonic() < end:
        if not sel.select(timeout=max(end - time.monotonic(), 0.0)):
            break
        line = proc.stdout.readline()
        if not line:
            break
        seen.append(line.rstrip())
        if "listening on" in line:
            return line.strip()
    raise AssertionError(f"the CLI node printed no listening line in "
                         f"{timeout_s:.0f} s: {seen}")


def serve_requests(m, flagship_aggs, t0_s):
    """Part A's requests, as REST bodies: the flagship (query string,
    top-10 by score, its aggregations), c2 as ES-DSL (bool + range, top-100
    by timestamp desc) and c3 (the aggregations alone)."""
    t0_us = t0_s * 1_000_000
    c2 = {"bool": {
        "must": [{"term": {"severity_text": "ERROR"}}],
        "should": [{"term": {"body": m.body_term(3)}},
                   {"term": {"body": m.body_term(7)}}],
        "filter": [{"range": {"timestamp": {"gte": t0_us + DAY_US,
                                            "lt": t0_us + 4 * DAY_US}}}]}}
    by_ts = [{"timestamp": {"order": "desc"}}]
    return {
        "flagship": ("POST", "/api/v1/hdfs-logs/search",
                     {"query": "severity_text:ERROR", "max_hits": 10,
                      "aggs": flagship_aggs}),
        "c2": ("POST", "/api/v1/_elastic/hdfs-logs/_search",
               {"query": c2, "size": 100, "sort": by_ts}),
        "c3": ("POST", "/api/v1/hdfs-logs/search",
               {"query": "severity_text:ERROR", "max_hits": 0,
                "aggs": flagship_aggs}),
        "c2_top300": ("POST", "/api/v1/_elastic/hdfs-logs/_search",
                      {"query": c2, "size": 300, "sort": by_ts}),
    }


def es_scroll(port, body, pages: int) -> list:
    """`pages` pages of an ES scroll over `body` (its `size` per page)."""
    out = [rest(port, "POST",
                "/api/v1/_elastic/hdfs-logs/_search?scroll=1m", body)]
    for _ in range(pages - 1):
        out.append(rest(port, "POST", "/api/v1/_elastic/_search/scroll",
                        {"scroll_id": out[-1]["_scroll_id"],
                         "scroll": "1m"}))
    return out


def serve_cli_node(m, dev, label, here, seed, flagship_aggs, docs_total,
                   request_docs, iters) -> dict:
    """Part A: `python -u -m quickwit_tpu_torch.cli run` in a subprocess,
    configured from the environment alone (no `QW_DEVICE` on the card),
    fed and searched through the port's `QuickwitClient` and REST, each
    response held against an in-process CPU node over the same files."""
    import signal
    steps = {}
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_serve_")
    env = {k: v for k, v in os.environ.items() if k != "QW_DEVICE"}
    if dev.type != "cuda":   # a rehearsal on the CPU names it
        env["QW_DEVICE"] = "cpu"
    env.update(QW_REST_PORT="0", PYTHONPATH=here,
               QW_METASTORE_URI=f"file://{tmp.name}/metastore",
               QW_DEFAULT_INDEX_ROOT_URI=f"file://{tmp.name}/indexes")
    stderr = open(os.path.join(tmp.name, "node.stderr"), "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "quickwit_tpu_torch.cli", "run"],
        cwd=here, env=env, stdout=subprocess.PIPE, stderr=stderr, text=True)
    cpu_server = None
    try:
        line = read_listening_line(proc, SERVE_START_S)
        endpoint = line.rsplit("://", 1)[1]
        port = int(endpoint.rsplit(":", 1)[1])
        steps["start"] = time.perf_counter() - t0
        say(f"serve A: {line}")
        client = m.client.QuickwitClient(endpoint, timeout_secs=900.0)
        client.create_index({
            "index_id": "hdfs-logs", "doc_mapping": m.HDFS_MAPPER.to_dict(),
            "indexing_settings": {"split_num_docs_target": request_docs}})
        t0 = time.perf_counter()
        docs = write_docs(m.synthetic, docs_total, request_docs, seed)
        steps["docs"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for lo in range(0, docs_total, request_docs):
            out = client.ingest("hdfs-logs", docs[lo:lo + request_docs],
                                commit="force")
            if out["num_ingested_docs"] != request_docs:
                raise AssertionError(f"serve A ingest: {out}")
        steps["ingest"] = time.perf_counter() - t0
        del docs
        client.close()

        def published():
            return sorted((s["metadata"]["split_id"],
                           s["metadata"]["num_docs"])
                          for s in rest(port, "GET", "/api/v1/indexes/"
                                        "hdfs-logs/splits")["splits"]
                          if s["state"] == "Published")
        splits = published()
        say(f"serve A splits: {json.dumps(splits)}")
        if [n for _, n in splits] != [request_docs] * (
                docs_total // request_docs):
            raise AssertionError(f"serve A: published splits {splits}")

        # the same files behind a CPU node in this process
        cpu_node = m.serve.Node(m.serve.NodeConfig(
            node_id="cpu-ref", roles=("searcher",), rest_port=0,
            device="cpu", data_dir=os.path.join(tmp.name, "cpu-ref"),
            metastore_uri=env["QW_METASTORE_URI"],
            default_index_root_uri=env["QW_DEFAULT_INDEX_ROOT_URI"]),
            storage_resolver=m.StorageResolver.default())
        cpu_server = m.serve.RestServer(cpu_node)
        cpu_server.start()
        t0 = time.perf_counter()
        reqs = serve_requests(m, flagship_aggs, WRITE_T0)
        answers = {}
        for name, (method, path, body) in reqs.items():
            got = rest(port, method, path, body)
            want = rest(cpu_server.port, method, path, body)
            same_search(without_clock(got), without_clock(want),
                        f"serve A {name}")
            answers[name] = got
        scroll = {p: es_scroll(p, reqs["c2"][2], 3)
                  for p in (port, cpu_server.port)}
        for i, (got, want) in enumerate(zip(scroll[port],
                                            scroll[cpu_server.port])):
            same_search(without_clock(got)["hits"],
                        without_clock(want)["hits"], f"serve A scroll {i}")
        scrolled = [h["_source"] for page in scroll[port]
                    for h in page["hits"]["hits"]]
        top300 = [h["_source"] for h in answers["c2_top300"]["hits"]["hits"]]
        if scrolled != top300 or len(top300) != 300:
            raise AssertionError(
                f"serve A: the scroll's 3 pages ({len(scrolled)} docs) are "
                f"not the top-300 ({len(top300)} of "
                f"{answers['c2_top300']['hits']['total']['value']})")
        steps["compare"] = time.perf_counter() - t0
        if published() != splits:
            raise AssertionError("serve A: the published splits changed "
                                 "during the comparisons")
        flagship = answers["flagship"]
        say(f"serve A: flagship num_hits={flagship['num_hits']} hits="
            f"{len(flagship['hits'])} c2 hits="
            f"{len(answers['c2']['hits']['hits'])} of "
            f"{answers['c2']['hits']['total']['value']} c3 buckets="
            f"{len(answers['c3']['aggregations']['over_time']['buckets'])}"
            f" scroll=3x100 equal_to_top300=True equal_to_cpu_node=True "
            f"launches=not counted (subprocess)")
        if flagship["num_hits"] <= 0 or len(flagship["hits"]) != 10 or len(
                answers["c2"]["hits"]["hits"]) != 100:
            raise AssertionError("serve A: empty answers")

        method, path, body = reqs["flagship"]
        rest(port, method, path, body)
        walls = []
        for _ in range(iters):
            t0 = time.perf_counter()
            rest(port, method, path, body)
            walls.append((time.perf_counter() - t0) * 1e3)
        say(f"[{label}] serve A timing flagship over REST (2 splits, the "
            f"CLI node on {dev.type}): p50_ms={pct(walls, 0.5):.4f} "
            f"p90_ms={pct(walls, 0.9):.4f} iters={iters}")

        t0 = time.perf_counter()
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=SERVE_STOP_S)
        steps["stop"] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"serve A: the CLI node exited {rc} on "
                                 f"SIGINT")
        say(f"[{label}] serve A seconds: "
            + json.dumps({k: round(v, 3) for k, v in steps.items()})
            + f" ingest_docs_per_s={docs_total / steps['ingest']:.0f}")
        return {"flagship_p50_ms": pct(walls, 0.5), "steps": steps}
    except BaseException:
        stderr.flush()
        with open(stderr.name) as f:
            say("serve A node stderr (tail):\n" + f.read()[-4000:])
        raise
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        proc.stdout.close()
        stderr.close()
        if cpu_server is not None:
            cpu_server.stop()
        tmp.cleanup()


def serve_phase12_node(torch, st, m, dev, label, iters, rooted,
                       flagship_aggs) -> dict:
    """Part B: an in-process node on the card behind a `RestServer` over
    phase 12's metastore files and phase 11's bytes: the flagship and c5
    against phase 12's responses, 8 concurrent searches against a CPU
    node, the developer routes, and the flagship's REST p50 beside the
    same node's root p50. Returns the launches of its path."""
    from concurrent.futures import ThreadPoolExecutor
    storage, meta_storage = rooted["storage"], rooted["meta_storage"]
    resolver = m.StorageResolver()
    resolver.register(m.Protocol.RAM, lambda uri: (
        meta_storage if str(uri).startswith(METASTORE_URI) else storage))
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_serve_b_")

    def node(device, node_id, **kw):
        n = m.serve.Node(m.serve.NodeConfig(
            node_id=node_id, rest_port=0, device=device,
            metastore_uri=METASTORE_URI, default_index_root_uri=SPLITS_URI,
            data_dir=os.path.join(tmp.name, node_id), **kw),
            storage_resolver=resolver)
        server = m.serve.RestServer(n)
        server.start()
        return n, server

    def counts():
        return st.score_topk.launches, st.score_topk_lanes.launches

    def aside(fn, *args):
        saved = counts()
        try:
            return fn(*args)
        finally:
            st.score_topk.launches, st.score_topk_lanes.launches = saved

    on_card = dev.type == "cuda"
    servers = []
    try:
        t0 = time.perf_counter()
        gpu_node, gpu_server = node(dev.type, "serve-b")
        _, cpu_server = node("cpu", "serve-b-cpu", roles=("searcher",))
        servers += [gpu_server, cpu_server]
        gport, cport = gpu_server.port, cpu_server.port
        steps = {"start": time.perf_counter() - t0}
        m.flight.FLIGHT.begin_run()
        st.score_topk.launches = st.score_topk_lanes.launches = 0
        seen = {}

        # the flagship: one batch of 8 splits, equal to phase 12's root
        flagship_body = {"query": "severity_text:ERROR", "max_hits": 10,
                         "aggs": flagship_aggs,
                         "snippet_fields": "severity_text"}
        t0 = time.perf_counter()
        k0, l0 = counts()
        got = rest(gport, "POST", "/api/v1/hdfs-logs/search", flagship_body)
        seen["flagship"] = {"score_topk": st.score_topk.launches - k0,
                            "score_topk_lanes":
                                st.score_topk_lanes.launches - l0}
        want = json.loads(json.dumps(rooted["flagship"].to_dict()))
        same_search(without_clock(got), without_clock(want),
                    "serve B flagship vs phase 12's root")
        if on_card and seen["flagship"] != {"score_topk": 0,
                                            "score_topk_lanes": 1}:
            raise AssertionError(f"serve B flagship: {seen['flagship']}")

        # c5 over the 64 otel splits through _elastic
        c5_body = {"query": {"match_all": {}}, "size": 0, "aggs": {
            "latency": {"percentiles": {"field": "span_duration_micros",
                                        "percents": [50, 95, 99]}}}}
        k0, l0 = counts()
        got = rest(gport, "POST", "/api/v1/_elastic/otel-traces/_search",
                   c5_body)
        seen["c5"] = {"score_topk": st.score_topk.launches - k0,
                      "score_topk_lanes": st.score_topk_lanes.launches - l0}
        es_request = gpu_server._es_search_request("otel-traces", c5_body,
                                                   {})
        want = json.loads(json.dumps(gpu_server._es_search_response(
            rooted["c5"], es_request)))
        same_search(without_clock(got), without_clock(want),
                    "serve B c5 vs phase 12's root")
        steps["flagship_c5"] = time.perf_counter() - t0

        # 8 concurrent searches, one rare body term each, each against the
        # same request alone through the CPU node
        t0 = time.perf_counter()
        bodies = [{"query": f"body:{m.body_term(SERVE_RARE_FIRST + i)}",
                   "max_hits": 10} for i in range(SERVE_RARE_TERMS)]
        k0, l0 = counts()
        with ThreadPoolExecutor(len(bodies)) as pool:
            got_all = list(pool.map(lambda b: rest(
                gport, "POST", "/api/v1/hdfs-logs/search", b), bodies))
        seen["concurrent"] = {"score_topk": st.score_topk.launches - k0,
                              "score_topk_lanes":
                                  st.score_topk_lanes.launches - l0}
        for i, (body, got) in enumerate(zip(bodies, got_all)):
            want = aside(rest, cport, "POST", "/api/v1/hdfs-logs/search",
                         body)
            same_search(without_clock(got), without_clock(want),
                        f"serve B concurrent {body['query']}")
        say("serve B concurrent: num_hits=" + json.dumps(
            [g["num_hits"] for g in got_all]) + " equal_to_solo_cpu=True")
        steps["concurrent"] = time.perf_counter() - t0

        # the developer routes
        debug = rest(gport, "GET", "/api/v1/developer/debug")
        samples = prometheus_samples(rest(gport, "GET", "/metrics"))
        trace = rest(gport, "GET", "/api/v1/developer/trace")
        kinds = {e.get("name") for e in trace["traceEvents"]}
        say(f"serve B developer: jit_cache_entries="
            f"{debug['jit_cache_entries']} metrics_samples={samples} "
            f"trace_events={len(trace['traceEvents'])} "
            f"dispatch_launch={'dispatch.launch' in kinds}")
        if debug["jit_cache_entries"] <= 0 or not {
                "dispatch.launch", "query.start", "query.done"} <= kinds:
            raise AssertionError("serve B developer routes")
        path = {"score_topk": st.score_topk.launches,
                "score_topk_lanes": st.score_topk_lanes.launches}
        say(f"serve launches: {json.dumps(path)} per request "
            f"{json.dumps(seen)}")

        # the flagship over REST beside the same node's root, in turns:
        # the request the REST route builds, without HTTP and JSON
        sr = m.rest_mod._search_request_from_params(
            "hdfs-logs", flagship_body, gpu_server._default_fields(
                "hdfs-logs"))
        aside(rest, gport, "POST", "/api/v1/hdfs-logs/search", flagship_body)
        aside(gpu_node.root_searcher.search, sr)
        rest_walls, root_walls = [], []
        for _ in range(iters):
            t0 = time.perf_counter()
            aside(rest, gport, "POST", "/api/v1/hdfs-logs/search",
                  flagship_body)
            t1 = time.perf_counter()
            aside(gpu_node.root_searcher.search, sr)
            rest_walls.append((t1 - t0) * 1e3)
            root_walls.append((time.perf_counter() - t1) * 1e3)
        say(f"[{label}] serve B timing flagship (8 hdfs splits): "
            f"rest_p50_ms={pct(rest_walls, 0.5):.4f} rest_p90_ms="
            f"{pct(rest_walls, 0.9):.4f} node_root_p50_ms="
            f"{pct(root_walls, 0.5):.4f} node_root_p90_ms="
            f"{pct(root_walls, 0.9):.4f} phase12_root_p50_ms="
            f"{rooted['root_p50_ms']['flagship']:.4f} iters={iters}")
        say(f"[{label}] serve B seconds: "
            + json.dumps({k: round(v, 3) for k, v in steps.items()}))
        return {"launches": path}
    finally:
        for server in servers:
            server.stop()
        tmp.cleanup()


def check_serve(torch, st, m, dev, label, here, seed, iters, rooted,
                flagship_aggs, docs_total=SERVE_DOCS,
                request_docs=SERVE_REQUEST_DOCS) -> dict:
    """Phase 15: the node as users start it (part A) and REST over phase
    12's splits (part B). Returns part B's launches."""
    served = serve_cli_node(m, dev, label, here, seed, flagship_aggs,
                            docs_total, request_docs, iters)
    return {**serve_phase12_node(torch, st, m, dev, label, iters, rooted,
                                 flagship_aggs), "a": served}


# --------------------------------------------------------------------------
# phase 16: the gRPC plane, the SQL metastore and the offload pool

OFFLOAD_LOCAL_SPLITS = 16       # M's `offload.max_local_splits`
OFFLOAD_DELTAS = {              # what an offloading run moves
    "remote": ("OFFLOAD_SPLITS_TOTAL", {"outcome": "remote"}),
    "fallback_local": ("OFFLOAD_SPLITS_TOTAL", {"outcome": "fallback_local"}),
    "retries": ("OFFLOAD_RETRIES_TOTAL", {}),
    "hedges": ("OFFLOAD_HEDGES_TOTAL", {"outcome": "launched"}),
    "steals": ("OFFLOAD_STEALS_TOTAL", {}),
}


def otlp_trace_request(grpc_mod, trace_id: str, service: str,
                       names: list, start_s: int) -> bytes:
    """An OTLP ExportTraceServiceRequest with one span per name in one
    trace, as a collector sends it."""
    import struct

    def fixed64(field, value):
        return grpc_mod.pb_varint_raw(field << 3 | 1) + struct.pack(
            "<Q", value)

    spans = b"".join(grpc_mod.pb_msg(2, (
        grpc_mod.pb_bytes(1, bytes.fromhex(trace_id))
        + grpc_mod.pb_bytes(2, (i + 1).to_bytes(8, "big"))
        + grpc_mod.pb_str(5, name)
        + fixed64(7, (start_s + i) * 10**9)
        + fixed64(8, (start_s + i) * 10**9 + 1_000_000)))
        for i, name in enumerate(names))
    resource = grpc_mod.pb_msg(1, grpc_mod.pb_str(1, "service.name")
                               + grpc_mod.pb_msg(2, grpc_mod.pb_str(
                                   1, service)))
    return grpc_mod.pb_msg(1, grpc_mod.pb_msg(1, resource)
                           + grpc_mod.pb_msg(2, spans))


def release_nodes(torch, nodes, servers) -> None:
    """Stop `servers` and `nodes` and give back their device memory: each
    node's resident columns are evicted through its store, then the
    caching allocator's free blocks go back to the card."""
    for server in servers:
        server.stop()
    for node in nodes:
        node.stop_background_services()
        store = node.searcher_context.resident_store
        if store is not None:
            for split_id in list(store.stats()["by_split"]):
                columns = store.peek(split_id)
                if columns is not None:   # the budget's own eviction path
                    columns._device_array_cache.clear()
        for client in node.clients.values():
            node._close_client(client)
    nodes.clear()
    servers.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def grpc_offload_modules():
    """The port's modules under the names `phase12_like` and
    `check_grpc_offload` read."""
    from types import SimpleNamespace

    from quickwit_tpu_torch import serve
    from quickwit_tpu_torch.cluster.membership import ClusterMember
    from quickwit_tpu_torch.common.uri import Protocol, Uri
    from quickwit_tpu_torch.index import synthetic
    from quickwit_tpu_torch.index.reader import SplitReader
    from quickwit_tpu_torch.metastore import (
        FileBackedMetastore, ListSplitsQuery, SqlMetastore)
    from quickwit_tpu_torch.models.doc_mapper import FieldType
    from quickwit_tpu_torch.models.index_metadata import (
        IndexConfig, IndexMetadata)
    from quickwit_tpu_torch.models.split_metadata import (
        SplitMetadata, SplitState)
    from quickwit_tpu_torch.observability import metrics
    from quickwit_tpu_torch.query import parse_query_string
    from quickwit_tpu_torch.query.ast import Term
    from quickwit_tpu_torch.search import models, service as svc_mod
    from quickwit_tpu_torch.search.root import RootSearcher
    from quickwit_tpu_torch.serve import (
        binwire, grpc_server, http_client, otlp_proto, serializers)
    from quickwit_tpu_torch.storage import StorageResolver
    from quickwit_tpu_torch.storage.ram import RamStorage
    return SimpleNamespace(
        serve=serve, ClusterMember=ClusterMember, Protocol=Protocol,
        Uri=Uri, SplitReader=SplitReader,
        HDFS_MAPPER=synthetic.HDFS_MAPPER,
        OTEL_BENCH_MAPPER=synthetic.OTEL_BENCH_MAPPER,
        body_term=synthetic.body_term,
        synthetic_hdfs_split=synthetic.synthetic_hdfs_split,
        synthetic_otel_split=synthetic.synthetic_otel_split,
        FileBackedMetastore=FileBackedMetastore,
        ListSplitsQuery=ListSplitsQuery, SqlMetastore=SqlMetastore,
        FieldType=FieldType, IndexConfig=IndexConfig,
        IndexMetadata=IndexMetadata, SplitMetadata=SplitMetadata,
        SplitState=SplitState, metrics=metrics,
        parse_query_string=parse_query_string, Term=Term, models=models,
        SearchRequest=models.SearchRequest, svc_mod=svc_mod,
        RootSearcher=RootSearcher, StorageResolver=StorageResolver,
        RamStorage=RamStorage, binwire=binwire, grpc=grpc_server,
        http_client=http_client, otlp_proto=otlp_proto,
        serializers=serializers)


def phase12_like(m, hdfs_splits, hdfs_docs, otel_splits, otel_docs,
                 flagship_aggs) -> dict:
    """What phase 12 hands phases 15 and 16, at a size of the caller's
    choosing: generator splits (hdfs with their doc store, seeds from
    FANOUT_HDFS_SEED; otel from seed 0) in RAM, a file-backed metastore of
    them, and the flagship's and c5's answers from a root over a CPU
    node. For the CPU rehearsal and the `gpu` test of phase 16."""
    storage = m.RamStorage(m.Uri.parse(SPLITS_URI))
    hdfs_ids = [f"hdfs{i}" for i in range(hdfs_splits)]
    otel_ids = [f"otel{s:02d}" for s in range(otel_splits)]
    for i, split_id in enumerate(hdfs_ids):
        storage.put(f"{split_id}.split", m.synthetic_hdfs_split(
            hdfs_docs, seed=FANOUT_HDFS_SEED + i, store_docs=True))
    for s, split_id in enumerate(otel_ids):
        storage.put(f"{split_id}.split",
                    m.synthetic_otel_split(otel_docs, seed=s))
    meta_storage = m.RamStorage(m.Uri.parse(METASTORE_URI))
    metastore = m.FileBackedMetastore(meta_storage)
    for index_id, mapper, ids in (("hdfs-logs", m.HDFS_MAPPER, hdfs_ids),
                                  ("otel-traces", m.OTEL_BENCH_MAPPER,
                                   otel_ids)):
        index_uid = f"{index_id}:01"
        metastore.create_index(m.IndexMetadata(
            index_uid=index_uid, index_config=m.IndexConfig(
                index_id=index_id, index_uri=SPLITS_URI,
                doc_mapper=mapper)))
        metastore.stage_splits(index_uid, [split_metadata(
            m, m.SplitReader(storage, f"{split_id}.split"), split_id,
            index_uid, mapper) for split_id in ids])
        metastore.publish_splits(index_uid, list(ids))
    resolver = m.StorageResolver()
    resolver.register(m.Protocol.RAM, lambda _uri: storage)
    requests = {
        "flagship": m.SearchRequest(
            index_ids=["hdfs-logs"], max_hits=10, aggs=flagship_aggs,
            query_ast=m.parse_query_string("severity_text:ERROR", ["body"]),
            snippet_fields=("severity_text",)),
        "c5_otel_64splits": m.SearchRequest(
            index_ids=["otel-traces"], max_hits=0,
            query_ast=m.parse_query_string("*", ["body"]),
            aggs={"latency": {"percentiles": {
                "field": "span_duration_micros",
                "percents": [50, 95, 99]}}}),
    }
    cpu = m.svc_mod.SearchService(m.svc_mod.SearcherContext(
        storage_resolver=resolver, device="cpu", batch_size=8))
    root = m.RootSearcher(metastore,
                          {"node-0": m.svc_mod.LocalSearchClient(cpu)})
    return {"storage": storage, "meta_storage": meta_storage,
            "requests": requests, "hdfs_ids": hdfs_ids,
            "otel_ids": otel_ids,
            "flagship": root.search(requests["flagship"]),
            "c5": root.search(requests["c5_otel_64splits"])}


def check_grpc_offload(torch, st, m, dev, label, iters, rooted,
                       local_splits=OFFLOAD_LOCAL_SPLITS) -> dict:
    """Phase 16: port nodes on the card over a `sqlite://` metastore
    filled with phase 12's records and phase 11's bytes. Part A: three
    nodes with `grpc_port=0`, the root on node 0 reaching its peers
    through `GrpcSearchClient`; the flagship and c5 against phase 12's
    responses; gRPC against HTTP to one peer in turns; an OTLP export
    read back through Jaeger. Part B: node M offloads c5's cold tail to
    workers W1 and W2, then with W2 down, then with both down; offload
    against a node without it in turns. Returns the path's launches."""
    storage = rooted["storage"]
    requests = rooted["requests"]
    hdfs_ids, otel_ids = rooted["hdfs_ids"], rooted["otel_ids"]
    metrics = m.metrics
    resolver = m.StorageResolver()
    resolver.register(m.Protocol.RAM, lambda _uri: storage)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_grpc_")
    db = os.path.join(tmp.name, "metastore.db")
    nodes, servers = [], []
    steps = {}
    on_card = dev.type == "cuda"

    def counts():
        return st.score_topk.launches, st.score_topk_lanes.launches

    def aside(fn, *args, **kw):
        """Run a comparison or a timing: its launches are not the path's."""
        saved = counts()
        try:
            return fn(*args, **kw)
        finally:
            st.score_topk.launches, st.score_topk_lanes.launches = saved

    def launches_since(k0, l0):
        return {"score_topk": st.score_topk.launches - k0,
                "score_topk_lanes": st.score_topk_lanes.launches - l0}

    def series(name, **labels):
        return getattr(metrics, name).get(**labels)

    def offload_marks():
        return {key: series(name, **labels)
                for key, (name, labels) in OFFLOAD_DELTAS.items()}

    def start(node_id, **kw):
        node = m.serve.Node(m.serve.NodeConfig(
            node_id=node_id, rest_port=0, device=dev.type,
            metastore_uri=f"sqlite://{db}",
            default_index_root_uri=SPLITS_URI,
            data_dir=os.path.join(tmp.name, node_id), wal_fsync=False,
            **kw), storage_resolver=resolver)
        server = m.serve.RestServer(node)
        server.start()
        nodes.append(node)
        servers.append(server)
        return node, server

    try:
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        # the SQL metastore, filled through its API with phase 12's records
        t0 = time.perf_counter()
        source = m.FileBackedMetastore(rooted["meta_storage"])
        sql = m.SqlMetastore(db)
        for metadata in source.list_indexes():
            uid = metadata.index_uid
            records = source.list_splits(m.ListSplitsQuery(index_uids=[uid]))
            sql.create_index(metadata)
            sql.stage_splits(uid, [r.metadata for r in records])
            sql.publish_splits(uid, [r.metadata.split_id for r in records])
        def published(metastore):
            return {metadata.index_id: len(metastore.list_splits(
                m.ListSplitsQuery(index_uids=[metadata.index_uid],
                                  states=[m.SplitState.PUBLISHED])))
                for metadata in metastore.list_indexes()}
        listed = published(sql)
        hdfs_splits, otel_splits = ([m.models.SplitIdAndFooter(
            r.metadata.split_id, SPLITS_URI, num_docs=r.metadata.num_docs)
            for r in sql.list_splits(m.ListSplitsQuery(index_uids=[uid]))]
            for uid in ("hdfs-logs:01", "otel-traces:01"))
        del sql
        say(f"grpc sql metastore: {json.dumps(listed)} bytes="
            f"{os.path.getsize(db)}")
        if listed != published(source) or listed["hdfs-logs"] != len(
                hdfs_ids) or listed["otel-traces"] != len(otel_ids):
            raise AssertionError(f"grpc sql metastore: {listed}")

        # part A: three nodes, each a member of the others' cluster
        trio = [start(f"grpc-{i}", grpc_port=0) for i in range(3)]
        for node, _ in trio:
            for peer, peer_server in trio:
                if peer is not node:
                    node.cluster.upsert_heartbeat(m.ClusterMember(
                        peer.config.node_id, tuple(peer.config.roles),
                        rest_endpoint=peer_server.endpoint,
                        grpc_endpoint=peer._grpc_advertise()))
        root = trio[0][0]
        rpcs = {}
        for peer_id, client in root.clients.items():
            if peer_id == root.config.node_id:
                continue
            if type(client) is not m.grpc.GrpcSearchClient:
                raise AssertionError(f"grpc: {peer_id} reached through "
                                     f"{type(client).__name__}")
            seen_rpcs = rpcs[peer_id] = {"LeafSearch": 0, "FetchDocs": 0}

            def spy(path, payload, timeout_secs=None, inner=client._call,
                    seen=seen_rpcs):
                method = path.rsplit("/", 1)[1]
                seen[method] = seen.get(method, 0) + 1
                return inner(path, payload, timeout_secs=timeout_secs)
            client._call = spy
        steps["a_start"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        st.score_topk.launches = st.score_topk_lanes.launches = 0
        seen = {}
        for name, want in (("flagship", rooted["flagship"]),
                           ("c5_otel_64splits", rooted["c5"])):
            before = {p: dict(r) for p, r in rpcs.items()}
            k0, l0 = counts()
            got = root.root_searcher.search(requests[name])
            same_search(got, want, f"grpc {name} vs phase 12's root")
            seen[name] = {**launches_since(k0, l0), "rpcs": {
                p: {k: v - before[p].get(k, 0) for k, v in r.items()}
                for p, r in rpcs.items()}}
            say(f"grpc A {name}: num_hits={got.num_hits} hits="
                f"{len(got.hits)} {json.dumps(seen[name])} "
                f"equal_to_phase_12=True")
        steps["a_searches"] = time.perf_counter() - t0
        c5_leaf_rpcs = sum(r["LeafSearch"] for r in
                           seen["c5_otel_64splits"]["rpcs"].values())
        if (any(r["LeafSearch"] < 1 for r in
                seen["c5_otel_64splits"]["rpcs"].values())
                or c5_leaf_rpcs != len(rpcs)):
            raise AssertionError(f"grpc A rpcs: {seen}")

        # gRPC against HTTP to one peer, in turns: the same leaf request
        peer, peer_server = trio[1]
        leaf_request = m.models.LeafSearchRequest(
            search_request=requests["flagship"], index_uid="hdfs-logs:01",
            doc_mapping=m.HDFS_MAPPER.to_dict(),
            splits=hdfs_splits)
        grpc_client = m.grpc.GrpcSearchClient(peer._grpc_advertise(),
                                              peer_server.endpoint)
        http_client = m.http_client.HttpSearchClient(peer_server.endpoint)
        try:
            first = aside(grpc_client.leaf_search, leaf_request)
            again = aside(http_client.leaf_search, leaf_request)
            if (first.num_hits != again.num_hits
                    or hit_tuples(first.partial_hits)
                    != hit_tuples(again.partial_hits)):
                raise AssertionError("grpc A: gRPC and HTTP leaf answers "
                                     "differ")
            grpc_walls, http_walls = [], []
            for _ in range(iters):
                t0 = time.perf_counter()
                aside(grpc_client.leaf_search, leaf_request)
                t1 = time.perf_counter()
                aside(http_client.leaf_search, leaf_request)
                grpc_walls.append((t1 - t0) * 1e3)
                http_walls.append((time.perf_counter() - t1) * 1e3)
        finally:
            grpc_client.close()
        sizes = {
            "request_binwire": len(m.binwire.encode(leaf_request.to_dict())),
            "request_json": len(json.dumps(leaf_request.to_dict()).encode()),
            "response_binwire": len(m.binwire.encode(
                m.serializers.leaf_response_to_wire(first))),
            "response_json": len(json.dumps(
                m.serializers.leaf_response_to_dict(first)).encode())}
        say(f"[{label}] grpc A timing leaf flagship (8 hdfs splits, warm "
            f"on the peer; the batch route runs its program on every "
            f"call): grpc_p50_ms="
            f"{pct(grpc_walls, 0.5):.4f} grpc_p90_ms="
            f"{pct(grpc_walls, 0.9):.4f} http_p50_ms="
            f"{pct(http_walls, 0.5):.4f} http_p90_ms="
            f"{pct(http_walls, 0.9):.4f} iters={iters} payload_bytes="
            + json.dumps(sizes))

        # an OTLP export over gRPC, read back through Jaeger GetTrace
        t0 = time.perf_counter()
        trace_id = "0f1e2d3c4b5a69788796a5b4c3d2e1f0"
        names = ["GET /search", "root_search", "leaf_search"]
        channel = m.grpc.GrpcChannel("127.0.0.1", root.grpc_server.port)
        try:
            _, status, message = channel.call(
                "/opentelemetry.proto.collector.trace.v1.TraceService/"
                "Export", otlp_trace_request(m.grpc, trace_id, "chip-smoke",
                                             names, 1_700_000_000))
            if status != 0:
                raise AssertionError(f"grpc A OTLP export: {message}")
            chunks, status, message = channel.call(
                "/jaeger.storage.v1.SpanReaderPlugin/GetTrace",
                m.grpc.pb_bytes(1, bytes.fromhex(trace_id)))
        finally:
            channel.close()
        spans = [bytes(value) for chunk in chunks for field, wire, value
                 in m.otlp_proto.iter_fields(memoryview(chunk))
                 if field == 1 and wire == 2]
        read_names = sorted(
            bytes(value).decode() for span in spans for field, wire, value
            in m.otlp_proto.iter_fields(memoryview(span))
            if field == 3 and wire == 2)
        say(f"grpc A otlp: exported={len(names)} status={status} "
            f"read_back={len(spans)} names={json.dumps(read_names)} "
            f"seconds={time.perf_counter() - t0:.3f}")
        if status != 0 or read_names != sorted(names):
            raise AssertionError(f"grpc A jaeger GetTrace: {message} "
                                 f"{read_names}")
        path_a = {"score_topk": st.score_topk.launches,
                  "score_topk_lanes": st.score_topk_lanes.launches}

        # part B: M offloads to W1 and W2; part A's nodes are gone first
        t0 = time.perf_counter()
        release_nodes(torch, nodes, servers)
        del trio, root, peer, peer_server
        gc.collect()
        workers = [start(f"offload-w{i}", roles=("searcher",))
                   for i in (1, 2)]
        endpoints = [server.endpoint for _, server in workers]
        offload = {"endpoints": endpoints, "max_local_splits": local_splits}
        steps["b_start"] = time.perf_counter() - t0
        c5 = dataclasses.replace(requests["c5_otel_64splits"], profile=True)
        runs = {}

        def offload_run(name, node_id):
            """c5 through a fresh M (the same config): its leaf and agg
            caches are empty and it cuts the same 16 local splits."""
            node, server = start(node_id, offload=dict(offload))
            marks = offload_marks()
            k0, l0 = counts()
            t0 = time.perf_counter()
            got = node.root_searcher.search(c5)
            wall = time.perf_counter() - t0
            same_search(got, rooted["c5"], f"offload {name} vs phase 12's")
            deltas = {key: value - marks[key]
                      for key, value in offload_marks().items()}
            counters = {k: v for k, v in got.profile["counters"].items()
                        if k.startswith("offload_")
                        or k == "num_splits_offloaded"}
            runs[name] = {**launches_since(k0, l0), **deltas,
                          "profile": counters, "wall_s": round(wall, 3)}
            say(f"offload B {name}: num_hits={got.num_hits} "
                f"{json.dumps(runs[name])} equal_to_phase_12=True")
            release_nodes(torch, [node], [server])
            return runs[name]

        remote_all = len(otel_ids) - local_splits
        both = offload_run("two_workers", "offload-m")
        if (both["remote"] != remote_all
                or both["fallback_local"] != 0
                or both["profile"].get("num_splits_offloaded")
                != remote_all):
            raise AssertionError(f"offload B two workers: {both}")
        steps["b_two_workers"] = time.perf_counter() - t0

        # offload against a node without it, in turns: fresh nodes, each
        # call a distinct percentile so no node answers from a cache
        t0 = time.perf_counter()
        timed_m, _ = start("offload-t", offload=dict(offload))
        plain, _ = start("offload-off")

        # a scored leaf request over the 64 otel splits (no doc store, so
        # no fetch phase): M's batches and the workers' launch
        # `score_topk_lanes`
        scored = m.models.LeafSearchRequest(
            search_request=m.SearchRequest(
                index_ids=["otel-traces"],
                query_ast=m.Term("service_name", "cart"), max_hits=10),
            index_uid="otel-traces:01",
            doc_mapping=m.OTEL_BENCH_MAPPER.to_dict(), splits=otel_splits)
        marks = offload_marks()
        k0, l0 = counts()
        got = timed_m.search_service.leaf_search(scored)
        runs["scored"] = {**launches_since(k0, l0), **{
            key: value - marks[key]
            for key, value in offload_marks().items()}}
        want = aside(plain.search_service.leaf_search, scored)
        say(f"offload B scored leaf service_name:cart top-10: num_hits="
            f"{got.num_hits} offloaded="
            f"{got.resource_stats.get('num_splits_offloaded')} "
            f"{json.dumps(runs['scored'])} equal_to_no_offload="
            f"{hit_tuples(got.partial_hits) == hit_tuples(want.partial_hits)}")
        if (got.num_hits != want.num_hits or got.failed_splits
                or hit_tuples(got.partial_hits)
                != hit_tuples(want.partial_hits)
                or runs["scored"]["remote"] != remote_all
                or (on_card and runs["scored"]["score_topk_lanes"] < 1)):
            raise AssertionError(f"offload B scored: {runs['scored']}")

        def c5_variant(i):
            aggs = {"latency": {"percentiles": {
                "field": "span_duration_micros",
                "percents": [50, 95, 99 - i / 1000]}}}
            return dataclasses.replace(requests["c5_otel_64splits"],
                                       aggs=aggs)

        remote0 = series("OFFLOAD_SPLITS_TOTAL", outcome="remote")
        with_walls, without_walls = [], []
        for i in range(-1, iters):
            req = c5_variant(i)
            t1 = time.perf_counter()
            got = aside(timed_m.root_searcher.search, req)
            t2 = time.perf_counter()
            want = aside(plain.root_searcher.search, req)
            t3 = time.perf_counter()
            same_search(got, want, f"offload B timing call {i}")
            if i >= 0:
                with_walls.append((t2 - t1) * 1e3)
                without_walls.append((t3 - t2) * 1e3)
        remote = series("OFFLOAD_SPLITS_TOTAL", outcome="remote") - remote0
        say(f"[{label}] offload B timing c5 (64 otel splits, {local_splits}"
            f" local + {remote_all} on 2 workers): offload_p50_ms="
            f"{pct(with_walls, 0.5):.4f} offload_p90_ms="
            f"{pct(with_walls, 0.9):.4f} local_p50_ms="
            f"{pct(without_walls, 0.5):.4f} local_p90_ms="
            f"{pct(without_walls, 0.9):.4f} iters={iters} remote_splits="
            f"{remote}")
        if remote != remote_all * (iters + 1):
            raise AssertionError(f"offload B timing offloaded {remote}")
        release_nodes(torch, [timed_m, plain], [])
        del timed_m, plain
        steps["b_timing"] = time.perf_counter() - t0

        # W2's listener stops: its tasks retry on W1
        t0 = time.perf_counter()
        workers[1][1].stop()
        one = offload_run("w2_stopped", "offload-m2")
        if (one["retries"] < 1
                or one["fallback_local"] != 0
                or one["remote"] != remote_all):
            raise AssertionError(f"offload B without W2: {one}")
        # W1's too: every offloaded split runs on M's card
        workers[0][1].stop()
        none = offload_run("no_worker", "offload-m3")
        if (none["fallback_local"] != remote_all
                or none["remote"] != 0):
            raise AssertionError(f"offload B without workers: {none}")
        steps["b_faults"] = time.perf_counter() - t0
        path_b = {key: sum(run[key] for run in runs.values())
                  for key in ("score_topk", "score_topk_lanes")}
        path = {key: path_a[key] + path_b[key] for key in path_a}
        say(f"grpc launches: {json.dumps(path)} part A "
            f"{json.dumps(path_a)} part B {json.dumps(path_b)}")
        say(f"[{label}] grpc seconds: "
            + json.dumps({k: round(v, 3) for k, v in steps.items()}))
        return {"launches": path}
    finally:
        release_nodes(torch, nodes, servers)
        tmp.cleanup()


# --------------------------------------------------------------------------
# phase 17: the fan-out's device mesh and the SQL analytics route

# the split axes of tests/test_mesh_root_merge.py's (2, 1), (4, 2), (8, 1)
MESH_ROWS = (2, 4, 8)


def mesh_modules():
    """The port's modules under the names `check_mesh` reads (and
    `phase12_like` for a rehearsal)."""
    m = grpc_offload_modules()
    from quickwit_tpu_torch.analytics import execute_sql
    from quickwit_tpu_torch.index import SplitWriter
    from quickwit_tpu_torch.models.doc_mapper import DocMapper, FieldMapping
    from quickwit_tpu_torch.observability import flight
    from quickwit_tpu_torch.parallel import fanout, mesh
    from quickwit_tpu_torch.query.ast import (
        Bool, MatchAll, Range, RangeBound)
    from quickwit_tpu_torch.search import executor
    from quickwit_tpu_torch.search.models import SortField
    m.__dict__.update(
        execute_sql=execute_sql, SplitWriter=SplitWriter,
        DocMapper=DocMapper, FieldMapping=FieldMapping, flight=flight,
        fanout=fanout, mesh=mesh, Bool=Bool, MatchAll=MatchAll, Range=Range,
        RangeBound=RangeBound, ex=executor, SortField=SortField)
    return m


def _fbits(value):
    if isinstance(value, float):
        return ("f", struct.unpack("<q", struct.pack("<d", value))[0])
    return value


def bit_hits(resp):
    """A response's hits with the bits of their float sort values, so
    that NaN and the two zeros compare."""
    return [(h.split_id, h.doc_id, _fbits(h.sort_value),
             _fbits(h.raw_sort_value), _fbits(h.sort_value2),
             _fbits(h.raw_sort_value2)) for h in resp.partial_hits]


def same_merged(got, want, label) -> None:
    """Hits with their sort-value bits and the count exactly; the
    aggregation states as `assert_aggs_close` holds them (f64 sums to
    rtol 1e-12: the mesh sums its rows' sums)."""
    if got.num_hits != want.num_hits or bit_hits(got) != bit_hits(want):
        raise AssertionError(f"{label}: hits or count differ")
    assert_aggs_close(want.intermediate_aggs, got.intermediate_aggs,
                      f"{label} aggs")


def same_json(want, got, path="$") -> None:
    """Equal parsed JSON, floats to rtol 1e-12."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or sorted(got) != sorted(want):
            raise AssertionError(f"{path}: keys differ")
        for key in want:
            same_json(want[key], got[key], f"{path}.{key}")
    elif isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            raise AssertionError(f"{path}: lengths differ")
        for i, (w, g) in enumerate(zip(want, got)):
            same_json(w, g, f"{path}[{i}]")
    elif isinstance(want, float) and isinstance(got, float):
        if not (want == got or abs(got - want) <= 1e-12 * abs(want)):
            raise AssertionError(f"{path}: {want!r} vs {got!r}")
    elif want != got or type(want) is not type(got):
        raise AssertionError(f"{path}: {want!r} vs {got!r}")


def nan_splits(m) -> tuple:
    """Two small seeded splits, 12 NaN gains in the second: (mapper,
    storage, ids)."""
    mapper = m.DocMapper(field_mappings=[
        m.FieldMapping("timestamp", m.FieldType.DATETIME, fast=True,
                       input_formats=("unix_timestamp",)),
        m.FieldMapping("gain", m.FieldType.F64, fast=True),
        m.FieldMapping("body", m.FieldType.TEXT)],
        timestamp_field="timestamp")
    import numpy as np
    rng = np.random.RandomState(17)
    storage = m.RamStorage(m.Uri.parse("ram:///chip_mesh_nan"))
    ids = ["nan-a", "nan-b"]
    nan_at = set(rng.choice(500, size=12, replace=False).tolist())
    for split_id in ids:
        writer = m.SplitWriter(mapper)
        for i in range(500):
            gain = float(rng.randint(0, 50))
            if split_id == "nan-b" and i in nan_at:
                gain = float("nan")
            writer.add_json_doc({"timestamp": 1_600_000_000 + i,
                                 "gain": gain, "body": "alpha"})
        storage.put(f"{split_id}.split", writer.finish())
    return mapper, storage, ids


def mesh_sql_statements(otel_index: str) -> dict:
    return {
        "group_by_service": (
            "SELECT service_name, COUNT(*) AS n, AVG(span_duration_micros) "
            "AS mean, APPROX_PERCENTILE(span_duration_micros, 95) AS p95 "
            f"FROM {otel_index} GROUP BY service_name ORDER BY n DESC"),
        "where_order_limit": (
            "SELECT tenant_id, severity_text FROM hdfs-logs WHERE "
            "severity_text = 'ERROR' AND tenant_id >= 3 ORDER BY tenant_id "
            "DESC LIMIT 10"),
        "date_trunc": (
            "SELECT DATE_TRUNC('minute', span_start_timestamp) AS minute, "
            f"COUNT(*) AS n FROM {otel_index} GROUP BY DATE_TRUNC('minute', "
            "span_start_timestamp) ORDER BY minute ASC LIMIT 20"),
    }


def check_mesh(torch, st, m, dev, label, iters, rooted,
               otel_index="otel-traces-head", mesh_rows=MESH_ROWS) -> dict:
    """Phase 17: the batch over a device mesh (`parallel/mesh.py` and the
    mesh route of `parallel/fanout.py`) on grids of the one card
    repeated, over phase 11's splits: each response against the
    single-device batch, the lane kernel on every row of a scored
    request, the `qw_mesh_*` metric deltas; the NaN input; a query group
    on a mesh; the service with `mesh_devices`; the mesh's one-card cost;
    then `POST /api/v1/_sql` on a node on the card against `execute_sql`
    over a CPU root. Returns the path's launches (comparisons and timings
    set aside)."""
    import numpy as np
    fan, mesh_mod = m.fanout, m.mesh
    storage = rooted["storage"]
    hdfs_ids, otel_ids = rooted["hdfs_ids"], rooted["otel_ids"]
    seconds = {}

    def counts():
        return st.score_topk.launches, st.score_topk_lanes.launches

    def aside(fn, *args, **kw):
        """Run a comparison or a timing: its launches are not the path's."""
        saved = counts()
        try:
            return fn(*args, **kw)
        finally:
            st.score_topk.launches, st.score_topk_lanes.launches = saved

    def counter(name):
        return getattr(m.metrics, name).get()

    def grid(rows):
        return mesh_mod.make_mesh(rows, devices=[dev] * rows)

    def readers(ids, store=storage):
        return [m.SplitReader(store, f"{split_id}.split") for split_id in ids]

    def single(batch, req):
        """The single-device batch of the same request: (response, k)."""
        dispatched = fan.dispatch_batch(batch, req, dev)
        return fan.readback_batch(dispatched), dispatched.k

    reqs = {**hdfs_requests(m.SearchRequest, m.Term, m.body_term),
            **doc_space_requests(m.SearchRequest, m.SortField, m.Bool,
                                 m.Range, m.RangeBound, m.Term,
                                 m.body_term)}
    c5 = m.SearchRequest(
        index_ids=["otel-traces"], query_ast=m.MatchAll(), max_hits=0,
        aggs={"latency": {"percentiles": {"field": "span_duration_micros",
                                          "percents": [50, 95, 99]}}})
    hdfs_readers, otel_readers = readers(hdfs_ids), readers(otel_ids)
    cases = {
        "flagship": (reqs["flagship"], m.HDFS_MAPPER, hdfs_readers,
                     hdfs_ids),
        "c2_bool_range_top100": (reqs["c2_bool_range_top100"], m.HDFS_MAPPER,
                                 hdfs_readers, hdfs_ids),
        "c2_ts_tenant_top100": (reqs["c2_ts_tenant_top100"], m.HDFS_MAPPER,
                                hdfs_readers, hdfs_ids),
        "c5_otel": (c5, m.OTEL_BENCH_MAPPER, otel_readers, otel_ids),
    }
    metric_names = ("MESH_DISPATCHES_TOTAL", "MESH_COLLECTIVE_BYTES_TOTAL",
                    "MESH_THRESHOLD_EXCHANGE_ROUNDS_TOTAL")
    # the CPU runs the kernels' plain versions, which count no launch
    on_card = dev.type == "cuda"
    st.score_topk.launches = st.score_topk_lanes.launches = 0

    # a. batches on the mesh, each against the single-device batch
    t0 = time.perf_counter()
    for name, (req, mapper, split_readers, ids) in cases.items():
        batch = fan.build_batch(req, mapper, split_readers, ids)
        want, k = aside(single, batch, req)
        fused = m.ex._takes_fused_kernel(batch.template, k)
        for a in mesh_rows:
            mesh = grid(a)
            before = [counter(n) for n in metric_names]
            k0, l0 = counts()
            got = fan.execute_batch(batch, req, device=dev, mesh=mesh)
            seen = {"score_topk": st.score_topk.launches - k0,
                    "score_topk_lanes": st.score_topk_lanes.launches - l0}
            deltas = {n.lower(): counter(n) - b
                      for n, b in zip(metric_names, before)}
            deltas["mesh_devices"] = counter("MESH_DEVICES")
            # the collective bytes are printed; the CPU tests hold them
            # against the JAX package's
            expect = {"mesh_dispatches_total": 1,
                      "mesh_threshold_exchange_rounds_total": 0,
                      "mesh_devices": a}
            held = {n: deltas[n] for n in expect}
            rows = batch.n_splits // a
            lanes = a * -(-rows // st.MAX_LANES) if fused and on_card else 0
            same_merged(got, want, f"mesh {name} rows={a}")
            say(f"mesh {name} rows={a}: splits={batch.n_splits} num_hits="
                f"{got.num_hits} launches={json.dumps(seen)} metrics="
                f"{json.dumps(deltas)} equal_to_single_device_batch=True")
            if seen != {"score_topk": 0, "score_topk_lanes": lanes}:
                raise AssertionError(f"mesh {name} rows={a}: launches {seen}, "
                                     f"expected {lanes} lane launches")
            if held != expect:
                raise AssertionError(f"mesh {name} rows={a}: metrics {held}"
                                     f" vs {expect}")
        del batch
    seconds["batches"] = time.perf_counter() - t0

    # b. NaN sort values: the mesh answers as the single-device batch
    t0 = time.perf_counter()
    nan_mapper, nan_storage, nan_ids = nan_splits(m)
    for order in ("desc", "asc"):
        req = m.SearchRequest(index_ids=["nan"], query_ast=m.MatchAll(),
                              max_hits=5,
                              sort_fields=(m.SortField("gain", order),))
        batch = fan.build_batch(req, nan_mapper,
                                readers(nan_ids, nan_storage), nan_ids)
        want, _ = aside(single, batch, req)
        got = fan.execute_batch(batch, req, device=dev, mesh=grid(2))
        same_merged(got, want, f"mesh nan {order}")
        # the CPU's order (the JAX package's): NaN first descending, last
        # ascending
        same_merged(want, fan.execute_batch(fan.build_batch(
            req, nan_mapper, readers(nan_ids, nan_storage), nan_ids), req,
            device="cpu"), f"mesh nan {order} vs cpu")
        nans = sum(np.isnan(h.sort_value) for h in got.partial_hits)
        say(f"mesh nan gain {order} top5 rows=2: split_ids="
            f"{[h.split_id for h in got.partial_hits]} nan_hits={nans} "
            "equal_to_single_device_batch=True equal_to_cpu=True")
        if nans != (5 if order == "desc" else 0):
            raise AssertionError(f"mesh nan {order}: {nans} NaN hits")
    seconds["nan"] = time.perf_counter() - t0

    # c. query groups of 4 flagship variants on a 2-row mesh
    t0 = time.perf_counter()
    flagship = reqs["flagship"]
    t_lo = min(r.footer.time_range[0] for r in hdfs_readers) // 1_000_000
    variants = {
        "flagship_windows": [dataclasses.replace(
            flagship, start_timestamp=t_lo + i * 86400) for i in range(4)],
        "flagship_term_sizes": [dataclasses.replace(flagship, aggs={
            **flagship.aggs, "severities": {"terms": {
                "field": "severity_text", "size": size}}})
            for size in (10, 6, 3, 1)],
    }
    for name, group_reqs in variants.items():
        batches = [fan.build_batch(r, m.HDFS_MAPPER, hdfs_readers, hdfs_ids)
                   for r in group_reqs]
        k = min(flagship.max_hits, batches[0].num_docs_padded)
        fused = m.ex._takes_fused_kernel(batches[0].template, k)
        k0, l0 = counts()
        group = fan.execute_query_group(batches, group_reqs[0], device=dev,
                                        mesh=grid(2))
        seen = {"score_topk": st.score_topk.launches - k0,
                "score_topk_lanes": st.score_topk_lanes.launches - l0}
        for i, (got, b, r) in enumerate(zip(group, batches, group_reqs)):
            same_merged(got, aside(single, fan.build_batch(
                r, m.HDFS_MAPPER, hdfs_readers, hdfs_ids), r)[0],
                f"mesh group {name}[{i}]")
        say(f"mesh group {name} rows=2: queries={len(batches)} num_hits="
            f"{[g.num_hits for g in group]} launches={json.dumps(seen)} "
            "equal_to_solo_batches=True")
        # each row's one launch covers its 4 splits of all 4 queries
        want_lanes = 2 if fused and on_card else 0
        if seen != {"score_topk": 0, "score_topk_lanes": want_lanes}:
            raise AssertionError(f"mesh group {name}: launches {seen}")
    seconds["groups"] = time.perf_counter() - t0

    # d. the service with mesh_devices: one mesh dispatch per group
    t0 = time.perf_counter()
    resolver = m.StorageResolver()
    resolver.register(m.Protocol.RAM, lambda _uri: storage)
    splits = [m.models.SplitIdAndFooter(
        split_id, SPLITS_URI, storage.file_num_bytes(f"{split_id}.split"),
        num_docs=r.num_docs) for split_id, r in zip(hdfs_ids, hdfs_readers)]

    def leaf(svc, req):
        return svc.leaf_search(m.models.LeafSearchRequest(
            search_request=req, index_uid="hdfs-logs:01",
            doc_mapping=m.HDFS_MAPPER.to_dict(), splits=splits))

    def service(**kw):
        return m.svc_mod.SearchService(m.svc_mod.SearcherContext(
            storage_resolver=resolver, device=dev, batch_size=8, **kw))

    mesh_svc = service(mesh_devices=[dev] * 4)
    ref_svc = service()
    for attempt, max_hits in (("cold", 10), ("warm", 9)):
        req = dataclasses.replace(flagship, max_hits=max_hits)
        m.flight.FLIGHT.begin_run()
        d0 = counter("MESH_DISPATCHES_TOTAL")
        s0 = counter("STAGING_BYTES_TOTAL")
        c0 = counter("RESIDENT_COLUMN_MISSES")
        got = leaf(mesh_svc, req)
        launches = [e["attrs"] for e in m.flight.FLIGHT.events()
                    if e["kind"] == "dispatch.launch"]
        staged = counter("STAGING_BYTES_TOTAL") - s0
        uploads = counter("RESIDENT_COLUMN_MISSES") - c0
        same_merged(got, aside(leaf, ref_svc, req), f"mesh service {attempt}")
        say(f"mesh service {attempt} flagship max_hits={max_hits}: "
            f"launch_events={json.dumps(launches)} mesh_dispatches="
            f"{counter('MESH_DISPATCHES_TOTAL') - d0} staged_bytes={staged} "
            f"column_uploads={uploads} equal_to_single_device_service=True")
        if [(e.get("path"), e.get("mesh")) for e in launches] != \
                [("batch", 4)]:
            raise AssertionError(f"mesh service {attempt}: {launches}")
        if attempt == "warm" and (staged or uploads):
            raise AssertionError("mesh service: a warm repeat staged "
                                 f"{staged} bytes, {uploads} columns")
    seconds["service"] = time.perf_counter() - t0
    path = {"score_topk": st.score_topk.launches,
            "score_topk_lanes": st.score_topk_lanes.launches}

    # e. the mesh's cost on one card: the flagship in turns, warm
    t0 = time.perf_counter()
    batch_one = fan.build_batch(flagship, m.HDFS_MAPPER, hdfs_readers,
                                hdfs_ids)
    batch_mesh = fan.build_batch(flagship, m.HDFS_MAPPER, hdfs_readers,
                                 hdfs_ids)
    mesh4 = grid(4)
    aside(fan.execute_batch, batch_one, flagship, device=dev)
    aside(fan.execute_batch, batch_mesh, flagship, device=dev, mesh=mesh4)
    mesh_walls, one_walls = [], []
    for _ in range(iters):
        t1 = time.perf_counter()
        aside(fan.execute_batch, batch_mesh, flagship, device=dev,
              mesh=mesh4)
        t2 = time.perf_counter()
        aside(fan.execute_batch, batch_one, flagship, device=dev)
        mesh_walls.append((t2 - t1) * 1e3)
        one_walls.append((time.perf_counter() - t2) * 1e3)
    say(f"[{label}] mesh timing flagship (8 hdfs splits): mesh_4rows_p50_ms="
        f"{pct(mesh_walls, 0.5):.4f} mesh_4rows_p90_ms="
        f"{pct(mesh_walls, 0.9):.4f} single_device_p50_ms="
        f"{pct(one_walls, 0.5):.4f} single_device_p90_ms="
        f"{pct(one_walls, 0.9):.4f} iters={iters}")
    del batch_one, batch_mesh
    seconds["timing"] = time.perf_counter() - t0

    # f. POST /api/v1/_sql on a node on the card against execute_sql over
    # a CPU root on the same splits
    t0 = time.perf_counter()
    meta_storage = rooted["meta_storage"]
    sql_resolver = m.StorageResolver()
    sql_resolver.register(m.Protocol.RAM, lambda uri: (
        meta_storage if str(uri).startswith(METASTORE_URI) else storage))
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_sql_")
    node = m.serve.Node(m.serve.NodeConfig(
        node_id="mesh-sql", rest_port=0, device=dev.type,
        metastore_uri=METASTORE_URI, default_index_root_uri=SPLITS_URI,
        data_dir=os.path.join(tmp.name, "node")),
        storage_resolver=sql_resolver)
    server = m.serve.RestServer(node)
    nodes, servers = [node], [server]
    try:
        server.start()
        cpu_root = m.RootSearcher(
            m.FileBackedMetastore(meta_storage),
            {"cpu": m.svc_mod.LocalSearchClient(m.svc_mod.SearchService(
                m.svc_mod.SearcherContext(storage_resolver=sql_resolver,
                                          device="cpu", batch_size=8)))})

        def cpu_search(index_id, query_ast, max_hits, aggs):
            return cpu_root.search(m.SearchRequest(
                index_ids=[index_id], query_ast=query_ast,
                max_hits=max_hits, aggs=aggs))

        for name, statement in mesh_sql_statements(otel_index).items():
            t1 = time.perf_counter()
            got = rest(server.port, "POST", "/api/v1/_sql",
                       {"query": statement})
            t2 = time.perf_counter()
            want = aside(m.execute_sql, statement, cpu_search)
            same_json(json.loads(json.dumps(want)), got, f"sql {name}")
            if not got["rows"]:
                raise AssertionError(f"sql {name}: no rows")
            say(f"mesh sql {name}: columns={got['columns']} rows="
                f"{len(got['rows'])} first={json.dumps(got['rows'][0])} "
                f"card_s={t2 - t1:.3f} cpu_s={time.perf_counter() - t2:.3f} "
                "equal_to_cpu_execute_sql=True")
        path = {"score_topk": st.score_topk.launches,
                "score_topk_lanes": st.score_topk_lanes.launches}
    finally:
        release_nodes(torch, nodes, servers)
        tmp.cleanup()
    seconds["sql"] = time.perf_counter() - t0
    say(f"mesh launches: {json.dumps(path)}")
    say(f"[{label}] mesh seconds: "
        + json.dumps({k: round(v, 3) for k, v in seconds.items()}))
    if on_card and path["score_topk_lanes"] < 1:
        raise AssertionError("mesh: score_topk_lanes never launched")
    return {"launches": path}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--docs", type=int, default=10_000_000)
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--so-docs", type=int, default=5_000_000)
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
        HDFS_MAPPER, OTEL_BENCH_MAPPER, SO_MAPPER, body_term,
        synthetic_hdfs_split, synthetic_otel_split,
        synthetic_stackoverflow_split)
    from quickwit_tpu_torch.models.doc_mapper import (
        DocMapper, FieldMapping, FieldType)
    from quickwit_tpu_torch.ops import aggs as agg_ops
    from quickwit_tpu_torch.ops.bm25 import score_postings
    from quickwit_tpu_torch.ops.kernels import build as build_mod
    from quickwit_tpu_torch.ops.kernels import score_topk as st
    from quickwit_tpu_torch.query.ast import (
        Bool, FullText, MatchAll, PhrasePrefix, Range, RangeBound, Term)
    from quickwit_tpu_torch.common import deadline as deadline_mod
    from quickwit_tpu_torch.search import chunkexec
    from quickwit_tpu_torch.search import collector as collector_mod
    from quickwit_tpu_torch.search import executor as ex
    from quickwit_tpu_torch.search import leaf as leaf_mod
    from quickwit_tpu_torch.search.collector import (
        IncrementalCollector, finalize_aggregations)
    from quickwit_tpu_torch.search.leaf import leaf_search_single_split
    from quickwit_tpu_torch.search import pruning
    from quickwit_tpu_torch.search.models import SearchRequest, SortField
    from quickwit_tpu_torch.storage import CountingStorage, StorageResolver
    from quickwit_tpu_torch.common.uri import Protocol
    from quickwit_tpu_torch.observability import metrics
    from quickwit_tpu_torch.search import admission, residency
    from quickwit_tpu_torch.search import models as search_models
    from quickwit_tpu_torch.search import service as svc_mod
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
    lanes_err = check_score_topk_lanes(torch, st, dev)

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
    leaf_times = {}
    timed = {name: (HDFS_MAPPER, reader, req)
             for name, req in requests.items()}
    timed["c2_bool_range_top100"] = (HDFS_MAPPER, reader,
                                     doc_reqs["c2_bool_range_top100"])
    for name, (split, req, is_timed) in agg_reqs.items():
        if is_timed:
            timed[name] = (*splits[split], req)
    for name, (mapper, split_reader, req) in timed.items():
        row, err = time_request(torch, leaf_mod, st, ex, score_postings,
                                name, mapper, split_reader, req, dev,
                                args.iters, flush, label, here, leaf_times)
        if row is not None:
            rows.append(row)
            max_abs_err = max(max_abs_err, err)

    # 7. phrase over a split file, with the counters zeroed again ----------
    # the split goes to a temporary directory outside the checkout and is
    # read back through the resolver's file:// backend
    so_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_so_")
    t0 = time.perf_counter()
    so_data = synthetic_stackoverflow_split(args.so_docs, seed=SO_SEED)
    so_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    so_storage = StorageResolver.for_test().resolve(f"file://{so_dir.name}")
    so_storage.put("so.split", so_data)
    say(f"phrase split: stackoverflow docs={args.so_docs} seed={SO_SEED} "
        f"bytes={len(so_data)} build_s={so_build_s:.3f} write_s="
        f"{time.perf_counter() - t0:.3f} storage="
        f"{type(so_storage).__name__} host_maxrss_mb="
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024:.0f}")
    del so_data
    so_counting = CountingStorage(so_storage)

    def open_so_reader():
        return SplitReader(so_counting, "so.split")

    time_range = open_so_reader().footer.time_range
    phrase_reqs = phrase_requests(SearchRequest, FullText, PhrasePrefix, Bool,
                                  Range, RangeBound, time_range)
    st.score_topk.launches = 0
    phrase_out = check_phrase(leaf_mod, st, ex, pruning, SO_MAPPER,
                              phrase_reqs, open_so_reader,
                              so_counting.counters, dev)
    phrase_launches = {"score_topk": st.score_topk.launches}
    say(f"phrase launches: {json.dumps(phrase_launches)}")
    if phrase_launches["score_topk"] != 3:   # c4, slop 2 on two readers
        raise AssertionError("score_topk did not launch once per c4 call")

    so_reader, c4_req, _ = phrase_out["c4_phrase_bm25_top20"]
    row, err = time_request(torch, leaf_mod, st, ex, score_postings,
                            "c4_phrase_bm25_top20", SO_MAPPER, so_reader,
                            c4_req, dev, args.iters, flush, label, here)
    rows.append(row)
    max_abs_err = max(max_abs_err, err)
    del flush_buf

    # 8. the node's search service, with the counters zeroed again --------
    service_reqs = {
        "flagship": requests["flagship"],
        "c2_bool_range_top100": doc_reqs["c2_bool_range_top100"],
        "c2_by_timestamp": doc_reqs["c2_by_timestamp"],
        "c2_dashboard": dataclasses.replace(
            doc_reqs["c2_bool_range_top100"], max_hits=0,
            aggs=requests["flagship"].aggs),
    }
    t0 = time.perf_counter()
    st.score_topk.launches = 0
    check_service(torch, st, (svc_mod, leaf_mod, search_models, metrics,
                              residency, admission, Protocol,
                              StorageResolver, HDFS_MAPPER),
                  storage, args.docs, service_reqs, dev, args.iters, label,
                  here, leaf_times)
    service_launches = {"score_topk": st.score_topk.launches}
    say(f"service launches: {json.dumps(service_launches)} phase_s="
        f"{time.perf_counter() - t0:.3f}")
    if service_launches["score_topk"] < 1:
        raise AssertionError("score_topk never launched on the service path")

    # 9. chunked scans, with the counters zeroed again ---------------------
    t0 = time.perf_counter()
    flush_buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    chunked = check_chunked(
        torch, st, (leaf_mod, ex, chunkexec, metrics, svc_mod, search_models,
                    deadline_mod, Protocol, StorageResolver, HDFS_MAPPER,
                    OTEL_BENCH_MAPPER, score_postings),
        reader, splits["otel"][1], {
            **requests, **doc_reqs,
            **{name: req for name, (_, req, _) in agg_reqs.items()}},
        storage, args.docs, dev, args.iters, label, here, flush)
    del flush_buf
    rows.append(chunked["row"])
    max_abs_err = max(max_abs_err, chunked["err"])
    say(f"chunked launches: {json.dumps({'score_topk': chunked['launches']})}"
        f" phase_s={time.perf_counter() - t0:.3f}")

    # 10. query stacking, with the counters zeroed again -------------------
    t0 = time.perf_counter()
    flush_buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    from types import SimpleNamespace
    from quickwit_tpu_torch.search import batcher as batcher_mod
    stacking = check_stacking(
        torch, st, SimpleNamespace(
            ex=ex, chunkexec=chunkexec, leaf=leaf_mod, metrics=metrics,
            batcher=batcher_mod, svc_mod=svc_mod, models=search_models,
            deadline=deadline_mod, Protocol=Protocol,
            StorageResolver=StorageResolver, RamStorage=RamStorage, Uri=Uri,
            SplitReader=SplitReader, HDFS_MAPPER=HDFS_MAPPER,
            OTEL_BENCH_MAPPER=OTEL_BENCH_MAPPER, SO_MAPPER=SO_MAPPER,
            SearchRequest=SearchRequest, Term=Term, Bool=Bool, Range=Range,
            RangeBound=RangeBound, MatchAll=MatchAll, FullText=FullText,
            body_term=body_term, synthetic_hdfs_split=synthetic_hdfs_split,
            synthetic_stackoverflow_split=synthetic_stackoverflow_split,
            leaf_search_single_split=leaf_search_single_split,
            score_postings=score_postings),
        reader, splits["otel"][1], open_so_reader, storage, args.docs, dev,
        args.iters, label, here, flush)
    del flush_buf
    so_dir.cleanup()
    say(f"stacking phase_s={time.perf_counter() - t0:.3f}")

    # 11. the multi-split fan-out, with the counters zeroed again ----------
    t0 = time.perf_counter()
    flush_buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    from quickwit_tpu_torch.observability import flight
    from quickwit_tpu_torch.parallel import fanout
    fanned = check_fanout(
        torch, st, SimpleNamespace(
            fanout=fanout, metrics=metrics, flight=flight,
            deadline=deadline_mod, svc_mod=svc_mod, models=search_models,
            Protocol=Protocol, StorageResolver=StorageResolver,
            RamStorage=RamStorage, Uri=Uri, SplitReader=SplitReader,
            HDFS_MAPPER=HDFS_MAPPER, OTEL_BENCH_MAPPER=OTEL_BENCH_MAPPER,
            SearchRequest=SearchRequest, MatchAll=MatchAll,
            IncrementalCollector=IncrementalCollector,
            leaf_search_single_split=leaf_search_single_split,
            synthetic_otel_split=synthetic_otel_split,
            score_postings=score_postings),
        dev, args.iters, label, here, flush, {**requests, **doc_reqs})
    del flush_buf
    fanout_launches, fanout_row, fanout_err = (
        fanned["launches"], fanned["row"], fanned["err"])
    say(f"fanout phase_s={time.perf_counter() - t0:.3f}")

    # 12. root search over phase 11's splits, with the counters zeroed
    # again --------------------------------------------------------------
    t0 = time.perf_counter()
    from quickwit_tpu_torch.common import faults
    from quickwit_tpu_torch.metastore import (
        FileBackedMetastore, ListSplitsQuery)
    from quickwit_tpu_torch.models.index_metadata import (
        IndexConfig, IndexMetadata)
    from quickwit_tpu_torch.models.split_metadata import SplitMetadata
    from quickwit_tpu_torch.query import parse_query_string
    from quickwit_tpu_torch.query.es_dsl import es_query_to_ast
    from quickwit_tpu_torch.search.root import RootSearcher
    rooted = check_root(
        torch, st, SimpleNamespace(
            metrics=metrics, flight=flight, faults=faults, fanout=fanout,
            svc_mod=svc_mod, models=search_models, Protocol=Protocol,
            StorageResolver=StorageResolver, RamStorage=RamStorage, Uri=Uri,
            SplitReader=SplitReader, FieldType=FieldType,
            HDFS_MAPPER=HDFS_MAPPER, OTEL_BENCH_MAPPER=OTEL_BENCH_MAPPER,
            FileBackedMetastore=FileBackedMetastore,
            ListSplitsQuery=ListSplitsQuery, IndexConfig=IndexConfig,
            IndexMetadata=IndexMetadata, SplitMetadata=SplitMetadata,
            parse_query_string=parse_query_string,
            es_query_to_ast=es_query_to_ast, RootSearcher=RootSearcher,
            SearchRequest=SearchRequest, SortField=SortField,
            IncrementalCollector=IncrementalCollector,
            finalize_aggregations=finalize_aggregations,
            body_term=body_term),
        dev, args.iters, label, here, {**requests, **doc_reqs}, fanned)
    del fanned
    say(f"root phase_s={time.perf_counter() - t0:.3f}")

    # 13. the write path, with the counters zeroed again ------------------
    t0 = time.perf_counter()
    from quickwit_tpu_torch import compaction, ingest
    from quickwit_tpu_torch.index import merge_arrays, synthetic
    from quickwit_tpu_torch.indexing import merge as merge_mod, pipeline
    from quickwit_tpu_torch.indexing.sources import IngestSource
    from quickwit_tpu_torch.ingest.router import INGEST_V2_SOURCE_ID
    from quickwit_tpu_torch.janitor import gc as gc_mod, run_delete_planner
    from quickwit_tpu_torch.metastore.checkpoint import BEGINNING
    from quickwit_tpu_torch.models.index_metadata import SourceConfig
    from quickwit_tpu_torch.models.split_metadata import SplitState
    written = check_write(
        torch, st, SimpleNamespace(
            svc_mod=svc_mod, StorageResolver=StorageResolver,
            FileBackedMetastore=FileBackedMetastore,
            ListSplitsQuery=ListSplitsQuery, IndexConfig=IndexConfig,
            IndexMetadata=IndexMetadata, SourceConfig=SourceConfig,
            SplitState=SplitState, HDFS_MAPPER=HDFS_MAPPER,
            synthetic=synthetic, body_term=body_term, ingest=ingest,
            INGEST_V2_SOURCE_ID=INGEST_V2_SOURCE_ID, pipeline=pipeline,
            IngestSource=IngestSource, BEGINNING=BEGINNING,
            merge_arrays=merge_arrays, merge_mod=merge_mod,
            compaction=compaction, gc=gc_mod,
            run_delete_planner=run_delete_planner,
            RootSearcher=RootSearcher, SearchRequest=SearchRequest,
            SortField=SortField, parse_query_string=parse_query_string,
            es_query_to_ast=es_query_to_ast),
        dev, label, WRITE_DOCS, args.seed, requests["flagship"].aggs)
    say(f"write phase_s={time.perf_counter() - t0:.3f}")

    # 14. external sources and the control plane, with the counters zeroed
    # again ---------------------------------------------------------------
    t0 = time.perf_counter()
    sourced = check_sources(torch, st, sources_modules(), dev, label,
                            args.seed, SOURCES_SIZES,
                            requests["flagship"].aggs)
    say(f"sources phase_s={time.perf_counter() - t0:.3f}")

    # 15. the node and its REST front door, with the counters zeroed again
    t0 = time.perf_counter()
    from quickwit_tpu_torch import client as client_mod, serve
    from quickwit_tpu_torch.serve import rest as rest_mod
    served = check_serve(
        torch, st, SimpleNamespace(
            serve=serve, client=client_mod, rest_mod=rest_mod, flight=flight,
            StorageResolver=StorageResolver, Protocol=Protocol,
            synthetic=synthetic, HDFS_MAPPER=HDFS_MAPPER,
            body_term=body_term),
        dev, label, here, args.seed, args.iters, rooted,
        requests["flagship"].aggs)
    say(f"serve phase_s={time.perf_counter() - t0:.3f}")

    # 16. the gRPC plane, the SQL metastore and the offload pool, with the
    # counters zeroed again ------------------------------------------------
    t0 = time.perf_counter()
    gridded = check_grpc_offload(torch, st, grpc_offload_modules(), dev,
                                 label, args.iters, rooted)
    say(f"grpc phase_s={time.perf_counter() - t0:.3f}")

    # 17. the fan-out's device mesh and the SQL route, with the counters
    # zeroed again ---------------------------------------------------------
    t0 = time.perf_counter()
    meshed = check_mesh(torch, st, mesh_modules(), dev, label, args.iters,
                        rooted)
    say(f"mesh phase_s={time.perf_counter() - t0:.3f}")

    main_row = next(r for r in rows if r["at"] == "flagship")
    kernels = [{
        "name": "score_topk", "route": "cuda",
        "source": "quickwit_tpu_torch/csrc/score_topk.cu",
        "replaces": "quickwit_tpu/ops/pallas/score_topk.py:59",
        # the slice's flagship and body_top10 calls, the two
        # flagship_bucket_metrics calls of the aggregation phase, the
        # three c4 calls of the phrase phase, the service phase's
        # flagship calls before its timing (one per split of each call
        # that runs a program), the chunked phase's scans before its
        # timing (one per posting chunk of a score-sorted scan) and the
        # root phase's one-split nodes (none: its nodes batch), the write
        # phase's searches over one merged split and the sources, serve and
        # gRPC phases' (a node's one-split leaf request, where placement
        # gives a node one split), and the mesh phase's (none: its scored
        # requests run the lane kernel on each row)
        "launches": (launches["score_topk"] + agg_launches["score_topk"]
                     + phrase_launches["score_topk"]
                     + service_launches["score_topk"]
                     + chunked["launches"]
                     + stacking["launches"]["score_topk"]
                     + fanout_launches["score_topk"]
                     + rooted["launches"]["score_topk"]
                     + written["launches"]["score_topk"]
                     + sourced["launches"]["score_topk"]
                     + served["launches"]["score_topk"]
                     + gridded["launches"]["score_topk"]
                     + meshed["launches"]["score_topk"]),
        "max_abs_err": max_abs_err,
        "ms": main_row["ms"], "graph_replay_ms": main_row["graph_replay_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "sector_floor_ms": main_row["sector_floor_ms"],
        "library_ms": main_row["library_ms"],
        "shapes": rows,   # each posting-space request, with all of these
    }, {
        "name": "score_topk_lanes", "route": "cuda",
        "source": "quickwit_tpu_torch/csrc/score_topk.cu",
        "replaces": "quickwit_tpu/ops/pallas/score_topk.py:59",
        # the stacking phase's path (the fused groups, the convoy, one per
        # chunk of the chunked groups and the service's group), the
        # fan-out's (one per batch of at most 16 splits) and the root's
        # (one per scored batch of a node's leaf request), the write
        # phase's (the root's scored searches over the indexed splits), the
        # sources phase's (its flagship and c2 over each index) and the
        # serve phase's part B (its flagship and concurrent searches; part
        # A's node runs in a subprocess, whose counts this process cannot
        # read) and the gRPC phase's (the flagship's batches on the three
        # nodes, the scored otel request's on M and its offload workers)
        # and the mesh phase's (one per row of each scored mesh batch, per
        # row of the fused query group and of the service's mesh batches,
        # and the SQL projection's batch)
        "launches": (stacking["launches"]["score_topk_lanes"]
                     + fanout_launches["score_topk_lanes"]
                     + rooted["launches"]["score_topk_lanes"]
                     + written["launches"]["score_topk_lanes"]
                     + sourced["launches"]["score_topk_lanes"]
                     + served["launches"]["score_topk_lanes"]
                     + gridded["launches"]["score_topk_lanes"]
                     + meshed["launches"]["score_topk_lanes"]),
        "max_abs_err": max(lanes_err, stacking["err"], fanout_err),
        **{key: stacking["row"][key] for key in (
            "ms", "graph_replay_ms", "q_solo_graph_replay_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")},
        "shapes": [stacking["row"], fanout_row],
    }]
    say(label)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
