"""The port's WAL ingest against the JAX package's.

`tests/test_ingest_wal.py`'s scenarios that need no node or control plane
(the record log's append, batches, recovery, truncation, an empty last
segment after a crash, a read racing a truncate and a torn tail; the
ingester's persist, fetch, truncate and recovery; the router's round robin
and its closed shard) run in both packages, each in a directory of its
own. Every scenario must return the same observations in both, and the
two WAL directories must hold the same files with the same bytes.
"""

import importlib
import os

import pytest

PACKAGES = ("quickwit_tpu", "quickwit_tpu_torch")


class Pkg:
    def __init__(self, root: str):
        self.root = root
        self.wal = importlib.import_module(f"{root}.ingest.wal")
        self.ingest = importlib.import_module(f"{root}.ingest")
        self.router = importlib.import_module(f"{root}.ingest.router")
        self.faults = importlib.import_module(f"{root}.common.faults")


def tree_bytes(root) -> dict[str, bytes]:
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def run_both(scenario, tmp_path, monkeypatch):
    """Run `scenario(pkg, directory, monkeypatch)` in each package; the
    observations and the directories' bytes must be equal."""
    results = {}
    for root in PACKAGES:
        directory = tmp_path / root
        directory.mkdir()
        with monkeypatch.context() as mp:
            obs = scenario(Pkg(root), directory, mp)
        results[root] = (obs, tree_bytes(directory))
    want, got = results["quickwit_tpu"], results["quickwit_tpu_torch"]
    assert got[0] == want[0]
    assert sorted(got[1]) == sorted(want[1])
    assert got[1] == want[1]
    return got


def scenario_append_read(p, d, mp):
    log = p.wal.RecordLog(str(d / "q"), fsync=False)
    positions = [log.append(f"rec-{i}".encode()) for i in range(10)]
    assert positions == list(range(10))
    records = log.read_from(4)
    assert [pos for pos, _ in records] == list(range(4, 10))
    assert records[0][1] == b"rec-4"
    log.close()
    return positions, records


def scenario_batch_and_recovery(p, d, mp):
    path = str(d / "q")
    log = p.wal.RecordLog(path, fsync=False)
    first_last = log.append_batch([b"a", b"b", b"c"])
    assert first_last == (0, 2)
    log.close()
    log2 = p.wal.RecordLog(path, fsync=False)
    head = log2.next_position
    assert head == 3
    assert log2.append(b"d") == 3
    records = log2.read_from(0)
    log2.close()
    return first_last, head, records


def scenario_truncation_drops_segments(p, d, mp):
    mp.setattr(p.wal, "_SEGMENT_MAX_BYTES", 64)  # tiny segments
    path = str(d / "q")
    log = p.wal.RecordLog(path, fsync=False)
    for i in range(50):
        log.append(f"record-{i:04d}".encode())
    num_segments = len(os.listdir(path))
    assert num_segments > 2
    dropped = log.truncate(40)
    left = sorted(os.listdir(path))
    assert len(left) < num_segments
    records = log.read_from(40)
    assert [pos for pos, _ in records][:3] == [40, 41, 42]
    log.close()
    return num_segments, dropped, left, records


def scenario_empty_segment_crash(p, d, mp):
    """A crash between a roll and the first append leaves an empty last
    segment; the restart must not register it twice."""
    log = p.wal.RecordLog(str(d / "wal"))
    log.append(b"r0")
    log._roll()
    log.close()
    log2 = p.wal.RecordLog(str(d / "wal"))
    log2.append(b"r1")
    paths = [os.path.relpath(path, d) for _, path in log2._segments]
    assert len(paths) == len(set(paths)), paths
    records = log2.read_from(0)
    assert [payload for _, payload in records] == [b"r0", b"r1"]
    log2.close()
    return paths, records


def scenario_read_survives_concurrent_truncate(p, d, mp):
    mp.setattr(p.wal, "_SEGMENT_MAX_BYTES", 8)
    log = p.wal.RecordLog(str(d / "wal"), fsync=False)
    for i in range(6):
        log.append(f"rec-{i}".encode())
    assert len(log._segments) > 2
    # the reader snapshotted the segments, then a truncate unlinked one
    segments = list(log._segments)
    os.unlink(segments[0][1])
    log._segments.pop(0)
    records = log.read_from(0)
    assert [payload for _, payload in records] == \
        [f"rec-{i}".encode() for i in range(1, 6)]
    log.close()
    return records


def scenario_torn_tail(p, d, mp):
    """A torn tail write is cut at recovery, so appends to the reopened
    segment are framed right."""
    log = p.wal.RecordLog(str(d / "wal"), fsync=False)
    log.append(b"good")
    path = log._segments[-1][1]
    log.close()
    with open(path, "ab") as f:
        f.write(p.wal._LEN.pack(100) + b"par")
    log2 = p.wal.RecordLog(str(d / "wal"), fsync=False)
    head = log2.next_position
    assert head == 1
    assert log2.append(b"after-crash") == 1
    records = log2.read_from(0)
    assert [payload for _, payload in records] == [b"good", b"after-crash"]
    log2.close()
    return head, records


def scenario_fsync_fault(p, d, mp):
    """The `wal.fsync` hook fires before the write with fsync on: a failed
    fsync leaves the log as it was, and the next append lands at the same
    position."""
    injector = p.faults.FaultInjector(seed=5, rules=[
        p.faults.FaultRule(operation="wal.fsync", kind="error", every=2,
                           max_fires=1)])
    log = p.wal.RecordLog(str(d / "wal"), fsync=True,
                          fault_injector=injector)
    first = log.append_batch([b"a", b"b"])
    with pytest.raises(p.faults.InjectedFault):
        log.append(b"c")
    after = log.append(b"c")
    records = log.read_from(0)
    log.close()
    assert [payload for _, payload in records] == [b"a", b"b", b"c"]
    return first, after, records, injector.schedule()


def scenario_ingester_persist_fetch_truncate(p, d, mp):
    ingester = p.ingest.Ingester(str(d / "wal"), fsync=False)
    first_last = ingester.persist("idx:01", "src", "shard-00",
                                  [{"n": i} for i in range(5)])
    assert first_last == (0, 4)
    records = ingester.fetch("idx:01", "src", "shard-00", from_position=2)
    assert [doc["n"] for _, doc in records] == [2, 3, 4]
    ingester.truncate("idx:01", "src", "shard-00", 3)
    state = ingester.shard_throughput_state()
    assert state["idx@01/src/shard-00"]["published"] == 3
    return first_last, records, state


def scenario_ingester_recovery_underscore_index_id(p, d, mp):
    wal_dir = str(d / "wal")
    ingester = p.ingest.Ingester(wal_dir, fsync=False)
    ingester.persist("my_index:01", "src", "shard-00", [{"n": 1}])
    recovered = p.ingest.Ingester(wal_dir, fsync=False)
    shards = recovered.list_shards("my_index:01")
    assert len(shards) == 1 and shards[0].index_uid == "my_index:01"
    return [(s.index_uid, s.source_id, s.shard_id, s.role) for s in shards]


def scenario_ingester_recovery(p, d, mp):
    wal_dir = str(d / "wal")
    ingester = p.ingest.Ingester(wal_dir, fsync=True)
    ingester.persist("idx:01", "src", "shard-00", [{"n": 1}, {"n": 2}])
    ingester2 = p.ingest.Ingester(wal_dir, fsync=True)  # crash + restart
    assert len(ingester2.list_shards("idx:01")) == 1
    records = ingester2.fetch("idx:01", "src", "shard-00", 0)
    assert len(records) == 2
    first, _ = ingester2.persist("idx:01", "src", "shard-00", [{"n": 3}])
    assert first == 2
    return records, first, ingester2.shard_throughput_state()


def scenario_router_round_robin_and_closed_shard(p, d, mp):
    ingester = p.ingest.Ingester(str(d / "wal"), fsync=False)
    router = p.ingest.IngestRouter(ingester, shards_per_source=2)
    r1 = router.ingest("idx:01", [{"a": 1}])
    r2 = router.ingest("idx:01", [{"a": 2}])
    used = set(list(r1["positions"]) + list(r2["positions"]))
    assert used == {"shard-00", "shard-01"}
    ingester.close_shard("idx:01", p.router.INGEST_V2_SOURCE_ID, "shard-00")
    rerouted = []
    for _ in range(3):
        result = router.ingest("idx:01", [{"a": 3}])
        assert list(result["positions"]) == ["shard-01"]
        rerouted.append(result)
    empty = router.ingest("idx:01", [])
    return r1, r2, rerouted, empty, p.router.INGEST_V2_SOURCE_ID


SCENARIOS = [
    scenario_append_read,
    scenario_batch_and_recovery,
    scenario_truncation_drops_segments,
    scenario_empty_segment_crash,
    scenario_read_survives_concurrent_truncate,
    scenario_torn_tail,
    scenario_fsync_fault,
    scenario_ingester_persist_fetch_truncate,
    scenario_ingester_recovery_underscore_index_id,
    scenario_ingester_recovery,
    scenario_router_round_robin_and_closed_shard,
]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__[len("scenario_"):]
                              for s in SCENARIOS])
def test_wal_scenario_matches_jax(scenario, tmp_path, monkeypatch):
    run_both(scenario, tmp_path, monkeypatch)


def test_concurrent_ingest_keeps_every_record(tmp_path):
    """Eight threads route batches into two shards at once: every record
    lands once, positions are dense per shard, and a recovered ingester
    reads the same records."""
    import threading

    p = Pkg("quickwit_tpu_torch")
    ingester = p.ingest.Ingester(str(tmp_path / "wal"), fsync=False)
    router = p.ingest.IngestRouter(ingester, shards_per_source=2)
    errors = []

    def worker(w):
        try:
            for b in range(20):
                router.ingest("idx:01", [{"w": w, "b": b, "i": i}
                                         for i in range(3)])
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert errors == []
    source = p.router.INGEST_V2_SOURCE_ID
    seen = []
    for shard_id in ("shard-00", "shard-01"):
        records = ingester.fetch("idx:01", source, shard_id, 0)
        assert [pos for pos, _ in records] == list(range(len(records)))
        seen.extend((d["w"], d["b"], d["i"]) for _, d in records)
    assert sorted(seen) == sorted((w, b, i) for w in range(8)
                                  for b in range(20) for i in range(3))
    recovered = p.ingest.Ingester(str(tmp_path / "wal"), fsync=False)
    again = []
    for shard_id in ("shard-00", "shard-01"):
        again.extend((d["w"], d["b"], d["i"]) for _, d in
                     recovered.fetch("idx:01", source, shard_id, 0))
    assert sorted(again) == sorted(seen)
