"""The comparison that decides `correct` has to fail what is wrong: the
control (the reference one precision down, in the program's place) and
runs with the timed path broken underneath. On the CPU at small sizes;
the chip runs the control at the cells' own sizes with
`python3 -m qwbench.control`."""

from __future__ import annotations

import dataclasses
import time

import pytest

from qwbench import control, harness
from qwbench.tests import logs_corpus
from qwbench.tests.test_qwbench_reference import logs_work, small
from quickwit_tpu_torch.search import service as service_mod


def test_control_is_not_correct():
    work, config, mix = small("otel-dashboard-open")
    for seed in (11, 2**31 + 12, 13):
        out = control.readings(work, seed, 2.0, "cpu", config, mix)
        assert out["correct"] is False, out


def test_a_float16_control_reads_scores_far_wider_than_float32(monkeypatch):
    """The control answers searches too, its scores in `control_dtype`:
    in float16 its widest score gap is 100 times float32's or more, so a
    deployment can set its limit between the two."""
    logs_corpus.registered(monkeypatch)
    for seed in (21, 2**31 + 22, 23):
        gaps = {}
        for dtype in ("float16", "float32"):
            config = logs_corpus.config()
            config["check"]["control_dtype"] = dtype
            out = control.readings(logs_work(), seed, 3.0, "cpu", config,
                                   logs_corpus.MIX)
            gaps[dtype] = out["numbers"]["score_gap"]
            if dtype == "float16":
                assert out["correct"] is False, out
        assert gaps["float16"] >= 100 * gaps["float32"] > 0, gaps


def _run(name, monkeypatch=None, program=None, patch=None):
    work, config, mix = small(name)
    if patch is not None:
        monkeypatch.setattr(service_mod.LocalSearchClient, "leaf_search",
                            patch(service_mod.LocalSearchClient.leaf_search))
    return harness.run_cell(work, 77, 1.5, False, "cpu",
                            time.perf_counter(), config, mix,
                            program=program)


def _stale(node):
    """A root that answers each request with the previous answer."""
    last = {}

    def search(spec, profile=False):
        answer = last.get("answer") or node.search(spec)
        last["answer"] = node.search(spec)
        return answer
    return search


def _altered_count(leaf_search):
    """The leaf alters its count where it produces it."""
    def patched(self, request):
        response = leaf_search(self, request)
        response.num_hits += 1
        return response
    return patched


def _half_the_splits(leaf_search):
    """The leaf searches half of the splits it is sent and answers as if
    those were all."""
    def patched(self, request):
        half = dataclasses.replace(
            request, splits=request.splits[:max(1, len(request.splits) // 2)])
        return leaf_search(self, half)
    return patched


def test_a_stale_answer_is_not_correct():
    assert _run("otel-dashboard-open", program=_stale)["correct"] is False


def test_an_answer_altered_at_the_leaf_is_not_correct(monkeypatch):
    result = _run("otel-dashboard-open", monkeypatch, patch=_altered_count)
    assert result["correct"] is False


def test_half_of_the_splits_left_out_is_not_correct(monkeypatch):
    result = _run("otel-dashboard-open", monkeypatch, patch=_half_the_splits)
    assert result["correct"] is False
    assert result["checks"]["count_wrong"]["value"] > 0


def test_the_sound_program_is_correct():
    assert _run("otel-dashboard-open")["correct"] is True


def _failing_one(kind, warm_calls):
    """A root whose third answer in the window fails as `kind` says: it
    raises, or it comes back timed out, or it never comes at all."""
    def program(node):
        calls = {"n": 0}

        def search(spec, profile=False):
            calls["n"] += 1
            if calls["n"] != warm_calls + 3:
                return node.search(spec)
            if kind == "raises":
                raise RuntimeError("planted")
            if kind == "never":
                time.sleep(4.0)
                return None
            response = node.search(spec)
            response.timed_out = True
            return response
        return search
    return program


@pytest.mark.parametrize("kind", ["raises", "timed_out", "never"])
def test_a_failed_request_is_not_correct(kind, monkeypatch):
    monkeypatch.setattr(harness.traffic, "open_loop", _short_straggle(
        harness.traffic.open_loop))
    _, config, mix = small("otel-dashboard-open")
    warm_calls = len(harness.traffic.warm_specs(mix, config, 77))
    result = _run("otel-dashboard-open",
                  program=_failing_one(kind, warm_calls))
    assert result["failed"] == 1
    assert result["checks"]["failed"] == {"value": 1, "limit": 0}
    assert result["correct"] is False


def _short_straggle(open_loop):
    def patched(call, specs, offsets, seconds, straggle_s=60.0, **kw):
        return open_loop(call, specs, offsets, seconds, straggle_s=1.0, **kw)
    return patched
