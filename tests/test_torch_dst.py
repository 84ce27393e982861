"""The port's deterministic simulation harness against the JAX package's.

`quickwit_tpu_torch/dst/` runs the JAX harness's scenarios over the
port's own cluster components, with every search on the CPU here
(`device="cpu"`; the card in `chip_smoke.py`'s phase 19). Held, with
nothing stripped from any trace:

- `smoke`, `mixed` and `fanout` at fixed seeds: the same seed gives the
  same trace events twice in each package, and the port's trace events,
  digest, invariant verdicts and op-thread flight tail equal the JAX
  package's; `fanout` over a mesh (`mesh_devices`, the CPU repeated 8
  times, as the JAX side runs on 8 host devices) equals the JAX mesh run;
- the planted bugs (`QW_DST_BREAK_PUBLISH`, `QW_DST_BREAK_WAL`): found,
  shrunk, saved and replayed byte-identically, twice, each shrunk artifact
  equal to the JAX package's; the CLI's exit codes as
  `tests/test_dst_{smoke,harness}.py` hold them;
- `--pct` runs the port's PCT race controller
  (`quickwit_tpu_torch/tools/qwrace`, held against `tools/qwrace` in
  `tests/test_torch_qwrace.py`), and a race artifact replays through it;
- the qwmc conformance check (`--conformance`, stdlib only) gives the
  same verdicts in both packages.
"""

from __future__ import annotations

import json
import time

import pytest
import torch

from quickwit_tpu_torch.dst import (
    SCENARIOS, load_artifact, replay, run_scenario, save_artifact, sweep)
from quickwit_tpu_torch.dst.__main__ import main as dst_main
from quickwit_tpu_torch.dst.trace import canonical_json

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

CPU = "cpu"
CASES = [("smoke", 0), ("smoke", 3), ("smoke", 7), ("mixed", 0),
         ("mixed", 1), ("fanout", 0), ("fanout", 3)]
BREAK_FLAGS = {"publish": ("exactly_once_publish", {"break_publish": True}),
               "wal": ("zero_loss_wal_failover", {"break_wal": True})}


@pytest.fixture(autouse=True)
def fresh_chunking(monkeypatch):
    """Each test starts from the default chunking knobs and a sizer that
    has learnt nothing, in both packages: a rate learnt by an earlier test
    file in this worker would chunk one package's scans and add
    `chunk.boundary` events to its flight tail alone."""
    import quickwit_tpu.search.chunkexec as j_chunkexec
    import quickwit_tpu_torch.search.chunkexec as t_chunkexec
    for mod in (j_chunkexec, t_chunkexec):
        monkeypatch.setattr(mod, "CHUNKING", mod.ChunkConfig())
        monkeypatch.setattr(mod, "CHUNK_SIZER", mod._ChunkSizer())


def jax_dst():
    import quickwit_tpu.dst as j_dst
    return j_dst


def port_run(name, seed, **kw):
    return run_scenario(SCENARIOS[name], seed, break_publish=False,
                        break_wal=False, device=CPU, **kw)


def jax_run(name, seed):
    j_dst = jax_dst()
    return j_dst.run_scenario(j_dst.SCENARIOS[name], seed,
                              break_publish=False, break_wal=False)


def first_difference(want, got):
    """(index, JAX event, port event) of the first event that differs, or
    None."""
    for i in range(max(len(want), len(got))):
        w = want[i] if i < len(want) else None
        g = got[i] if i < len(got) else None
        if w != g:
            return i, w, g
    return None


def verdicts(result):
    return [v.to_dict() for v in result.violations]


# --- traces, verdicts and flight tails ----------------------------------------

@pytest.mark.parametrize("name,seed", CASES)
def test_trace_equals_jax_and_is_seed_deterministic(name, seed):
    port, again = port_run(name, seed), port_run(name, seed)
    assert port.trace.events == again.trace.events     # bytes, not digest
    want, want_again = jax_run(name, seed), jax_run(name, seed)
    assert want.trace.events == want_again.trace.events
    assert first_difference(want.trace.events, port.trace.events) is None
    assert port.digest == want.digest
    assert verdicts(port) == verdicts(want) == []
    assert port.flight_tail == want.flight_tail
    assert port.flight_tail == again.flight_tail


@pytest.mark.parametrize("seed", [0, 1])     # seeds whose batches shard
def test_fanout_over_a_mesh_equals_the_jax_mesh_run(seed):
    from quickwit_tpu_torch.observability.metrics import (
        MESH_DISPATCHES_TOTAL)
    dispatches = MESH_DISPATCHES_TOTAL.get()
    port = port_run("fanout", seed, mesh_devices=[torch.device(CPU)] * 8)
    assert MESH_DISPATCHES_TOTAL.get() > dispatches   # the mesh route ran
    want = jax_run("fanout", seed)   # the JAX service meshes 8 host devices
    assert first_difference(want.trace.events, port.trace.events) is None
    assert verdicts(port) == verdicts(want) == []
    assert port.digest == port_run("fanout", seed).digest


def test_seeds_steer_the_run():
    assert port_run("smoke", 8).digest != port_run("smoke", 7).digest


def test_mixed_scenario_exercises_full_invariant_set():
    result = port_run("mixed", 0)
    assert len(SCENARIOS["mixed"].invariants) == 9 and result.ok
    kinds = {ev["op"]["kind"] for ev in result.trace.events
             if ev["kind"] == "op"}
    assert {"ingest", "search"} <= kinds


def test_runs_in_simulated_time_not_wall_time():
    scenario = SCENARIOS["smoke"]
    start = time.monotonic()
    result = port_run("smoke", 3)
    wall_elapsed = time.monotonic() - start
    assert result.ok
    quiesce = [ev for ev in result.trace.events if ev["kind"] == "quiesce"]
    virtual_elapsed = quiesce[0]["now"] - 1000.0
    assert virtual_elapsed >= scenario.steps * scenario.step_secs
    assert wall_elapsed < min(virtual_elapsed / 4, 60.0)


def test_flight_tail_is_deterministic_and_virtual():
    a, b = port_run("smoke", 7), port_run("smoke", 7)
    assert a.flight_tail and a.flight_tail == b.flight_tail
    kinds = {e["kind"] for e in a.flight_tail}
    assert {"dst.op", "dispatch.launch", "dispatch.readback"} <= kinds
    for e in a.flight_tail:
        assert "tid" not in e and "span" not in e and e["t_ms"] >= 0.0


def test_leaf_dispatch_flight_events_match_jax():
    """A leaf search records `dispatch.launch` (path solo, one lane) and
    `dispatch.readback` in the flight recorder, as the JAX executor does;
    the DST artifact's flight tail, which its digest covers, holds them."""
    from test_torch_native import reader_of
    from quickwit_tpu_torch.index.synthetic import synthetic_hdfs_split
    data = synthetic_hdfs_split(2_000, seed=3)
    tails = []
    for root in ("quickwit_tpu", "quickwit_tpu_torch"):
        import importlib
        mod = lambda p: importlib.import_module(f"{root}.{p}")  # noqa: E731
        clock, flight = mod("common.clock"), mod("observability.flight")
        request = mod("search.models").SearchRequest(
            index_ids=["hdfs"], max_hits=10,
            query_ast=mod("query.ast").Term("severity_text", "ERROR"))
        kw = {"device": CPU} if root.endswith("torch") else {}
        with clock.use_clock(clock.FakeClock()):
            flight.FLIGHT.begin_run()
            mod("search.leaf").leaf_search_single_split(
                request, mod("index.synthetic").HDFS_MAPPER,
                reader_of(root, data), "s", **kw)
            tails.append(flight.FLIGHT.dst_tail())
    assert tails[1] == tails[0]
    assert [e["kind"] for e in tails[1]] == ["dispatch.launch",
                                              "dispatch.readback"]


def test_fanout_dashboard_op_forms_query_groups():
    from quickwit_tpu_torch.observability.metrics import QBATCH_GROUPS_TOTAL
    scenario = SCENARIOS["fanout"]
    groups0 = QBATCH_GROUPS_TOTAL.get()
    seen_shed = False
    for seed in range(4):
        dash = [op for op in scenario.materialize(seed)
                if op["kind"] == "dashboard"]
        seen_shed = seen_shed or any(op["cancel_panel"] for op in dash)
        result = port_run("fanout", seed)
        assert result.ok, verdicts(result)
        for ev in result.trace.events:
            if ev["kind"] == "op" and ev["op"].get("kind") == "dashboard":
                assert len(ev["result"]["panels"]) == ev["op"]["panels"]
                shed = ev["result"].get("cancelled_panel")
                if shed is not None and "error" not in shed:
                    assert shed["registry_drained"] and not shed["num_hits"]
    assert seen_shed
    assert QBATCH_GROUPS_TOTAL.get() - groups0 >= 1


def test_smoke_sweep_equals_jax_sweep():
    summary = sweep(SCENARIOS["smoke"], seeds=16, break_publish=False,
                    break_wal=False, device=CPU)
    assert summary["ok"] and summary["passed"] == list(range(16))
    j_dst = jax_dst()
    assert summary == j_dst.sweep(j_dst.SCENARIOS["smoke"], seeds=16,
                                  break_publish=False, break_wal=False)


@pytest.mark.parametrize("break_publish", [False, True])
def test_conformance_verdicts_equal_jax(break_publish):
    port = sweep(SCENARIOS["smoke"], seeds=4, break_publish=break_publish,
                 break_wal=False, conformance=True, shrink_violations=False,
                 device=CPU)
    j_dst = jax_dst()
    want = j_dst.sweep(j_dst.SCENARIOS["smoke"], seeds=4,
                       break_publish=break_publish, break_wal=False,
                       conformance=True, shrink_violations=False)
    assert port == want
    assert bool(port["nonconforming"]) is break_publish


# --- the planted bugs: found, shrunk, saved, replayed -------------------------

@pytest.mark.parametrize("flag", sorted(BREAK_FLAGS))
def test_break_flag_found_shrunk_and_replayed_as_jax(flag, tmp_path):
    invariant, flags = BREAK_FLAGS[flag]
    summary = sweep(SCENARIOS["smoke"], seeds=200,
                    artifacts_dir=str(tmp_path), device=CPU, **flags)
    assert not summary["ok"]
    entry = summary["violations"][0]
    assert entry["invariant"] == invariant
    assert entry["ops_after_shrink"] < entry["ops_before_shrink"]
    artifact = load_artifact(entry["artifact"])
    assert artifact["break_flags"] == {"publish": flag == "publish",
                                       "wal": flag == "wal"}
    first, first_match = replay(artifact, device=CPU)
    second, second_match = replay(artifact, device=CPU)
    assert first_match and second_match
    assert first.trace.events == second.trace.events
    assert any(v.invariant == invariant for v in first.violations)
    j_dst = jax_dst()
    want = j_dst.sweep(j_dst.SCENARIOS["smoke"], seeds=200, **flags)
    assert entry["seed"] == want["violations"][0]["seed"]
    assert artifact == want["violations"][0]["artifact_inline"]


@pytest.mark.parametrize("name", ["mixed", "fanout"])
def test_break_publish_artifact_embeds_flight_tail_as_jax(name, tmp_path):
    summary = sweep(SCENARIOS[name], seeds=3, break_publish=True,
                    artifacts_dir=str(tmp_path), device=CPU)
    [path] = sorted(tmp_path.glob("*.json"))
    artifact = load_artifact(str(path))
    tail = artifact["flight_tail"]
    assert tail and all("t_ms" in e and "kind" in e for e in tail)
    result, ok = replay(artifact, device=CPU)
    assert ok and result.flight_tail == tail
    j_dst = jax_dst()
    want = j_dst.sweep(j_dst.SCENARIOS[name], seeds=3, break_publish=True)
    assert summary["violations"][0]["seed"] == want["violations"][0]["seed"]
    assert artifact == want["violations"][0]["artifact_inline"]


def test_break_flags_default_from_env(monkeypatch):
    monkeypatch.setenv("QW_DST_BREAK_PUBLISH", "1")
    result = run_scenario(SCENARIOS["smoke"], seed=0, device=CPU)
    assert any(v.invariant == "exactly_once_publish"
               for v in result.violations)


def test_artifact_save_load_round_trip(tmp_path):
    summary = sweep(SCENARIOS["smoke"], seeds=200, break_wal=True,
                    artifacts_dir=str(tmp_path), device=CPU)
    artifact = load_artifact(summary["violations"][0]["artifact"])
    clone = tmp_path / "clone.json"
    save_artifact(artifact, str(clone))
    assert load_artifact(str(clone)) == artifact
    assert clone.read_text() == canonical_json(artifact) + "\n"


# --- the CLI ------------------------------------------------------------------

def test_cli_sweep_and_list_json(capsys):
    assert dst_main(["sweep", "--scenario", "smoke", "--seeds", "4",
                     "--device", CPU, "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["ok"] is True and out["passed"] == [0, 1, 2, 3]
    assert dst_main(["list", "--json"]) == 0
    listed = json.loads(capsys.readouterr().out)
    from quickwit_tpu.dst.__main__ import main as j_main
    assert j_main(["list", "--json"]) == 0
    assert listed == json.loads(capsys.readouterr().out)


def test_cli_break_sweep_and_replay_exit_codes(tmp_path, capsys,
                                               monkeypatch):
    monkeypatch.setenv("QW_DST_BREAK_WAL", "1")
    rc = dst_main(["sweep", "--scenario", "smoke", "--seeds", "200",
                   "--artifacts-dir", str(tmp_path), "--device", CPU,
                   "--json"])
    assert rc == 1
    path = json.loads(capsys.readouterr().out)["violations"][0]["artifact"]
    monkeypatch.delenv("QW_DST_BREAK_WAL")
    monkeypatch.setenv("QW_DEVICE", CPU)    # the flag's default
    rc = dst_main(["replay", path, "--json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0, out
    assert out["digest_match"] is True and out["violation_reproduced"]


def test_pct_sweeps_and_a_raced_artifact_replays(tmp_path, capsys,
                                                 monkeypatch):
    rc = dst_main(["sweep", "--scenario", "fanout", "--seeds", "1", "--pct",
                   "--device", CPU, "--json"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert out["ok"] is True and out["passed"] == [0]
    assert out["race"]["pct"]["depth"] == 3
    monkeypatch.setenv("QW_RACE_BREAK_POOL", "1")
    rc = dst_main(["sweep", "--scenario", "fanout", "--seeds", "3", "--pct",
                   "--artifacts-dir", str(tmp_path), "--device", CPU,
                   "--json"])
    assert rc == 1
    entry = json.loads(capsys.readouterr().out)["violations"][0]
    assert entry["invariant"] == "data_race"
    monkeypatch.delenv("QW_RACE_BREAK_POOL")
    artifact = load_artifact(entry["artifact"])
    assert artifact["race"]["pct"]["break_flags"] == \
        {"QW_RACE_BREAK_POOL": True}
    result, digest_match = replay(artifact, device=CPU)
    assert digest_match and result.digest == artifact["trace_digest"]
    assert any(v.invariant == "data_race" for v in result.violations)
    assert dst_main(["replay", entry["artifact"], "--device", CPU,
                     "--json"]) == 0
    replayed = json.loads(capsys.readouterr().out)
    assert replayed["digest_match"] and replayed["violation_reproduced"]
    assert replayed["digest"] == artifact["trace_digest"]


def test_entry_points_run_on_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_scenario(SCENARIOS["smoke"], 0, break_publish=False,
                     break_wal=False)
