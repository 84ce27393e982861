"""The device trace of a run's window, from `torch.profiler`: when the card
was busy (the union of its kernel, memcpy and memset intervals, as
`chip_smoke.py::summarize_trace` counts it), which device operations took
the time, and what the host was doing while the card sat idle, by the
query profile phases that covered the idle time.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import torch

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_MARK = "qwbench.window"


def merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1][1] = end
        else:
            out.append([start, end])
    return out


def overlap(a, b) -> float:
    """Length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def complement(intervals, lo, hi):
    out, at = [], lo
    for start, end in intervals:
        if start > at:
            out.append([at, min(start, hi)])
        at = max(at, end)
        if at >= hi:
            break
    if at < hi:
        out.append([at, hi])
    return out


class DeviceTrace:
    """A profiler around the window. `mark()` at the window's open and
    close ties the trace's clock to `time.perf_counter`. With `host=False`
    it records the card's activity alone, at less cost to the host, and
    takes no marks: what `busy_s()` needs."""

    def __init__(self, host: bool = True):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CUDA]
        if host:
            activities.insert(0, ProfilerActivity.CPU)
        self._prof = profile(activities=activities)
        self.marks: list[float] = []

    def __enter__(self):
        torch.cuda.synchronize()
        self._prof.__enter__()
        return self

    def mark(self) -> float:
        with torch.profiler.record_function(_MARK):
            now = time.perf_counter()
        self.marks.append(now)
        return now

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        return False

    def _events(self) -> list:
        fd, path = tempfile.mkstemp(suffix=".json", prefix="qwbench_trace_")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as fh:
                return json.load(fh).get("traceEvents", [])
        finally:
            os.unlink(path)

    def busy_s(self) -> float:
        """Seconds in which a kernel, memcpy or memset ran on the card, over
        all that the profiler recorded."""
        busy = merge([(ev["ts"], ev["ts"] + ev["dur"])
                      for ev in self._events() if ev.get("ph") == "X"
                      and ev.get("cat") in _DEVICE_CATS])
        return sum(e - s for s, e in busy) / 1e6

    def summarize(self, host_phases: dict, requests: list) -> dict:
        """busy_s, window_s and the breakdown. `host_phases`: phase name to
        (start, end) intervals on the perf_counter clock; `requests`: each
        request's (sent, done) on that clock."""
        events = self._events()
        marks = sorted(ev["ts"] for ev in events
                       if ev.get("name") == _MARK and ev.get("ph") == "X")
        if len(marks) < 2:
            raise RuntimeError("the trace lost the window's marks")
        lo_us, hi_us = marks[0], marks[-1]
        offset_us = lo_us - self.marks[0] * 1e6   # trace us - perf_counter us
        spans = [(ev["ts"], ev["ts"] + ev["dur"], ev["name"])
                 for ev in events if ev.get("ph") == "X"
                 and ev.get("cat") in _DEVICE_CATS
                 and ev["ts"] + ev["dur"] > lo_us and ev["ts"] < hi_us]
        busy = merge([(max(s, lo_us), min(e, hi_us)) for s, e, _ in spans])
        busy_us = sum(e - s for s, e in busy)
        by_name: dict[str, float] = {}
        for s, e, name in spans:
            by_name[name[:120]] = by_name.get(name[:120], 0.0) + (e - s)
        idle = complement(busy, lo_us, hi_us)

        def to_trace(pairs):
            return merge([(s * 1e6 + offset_us, e * 1e6 + offset_us)
                          for s, e in pairs if e is not None])
        gaps = {name: overlap(idle, to_trace(pairs))
                for name, pairs in host_phases.items()}
        in_flight = to_trace(requests)
        gaps["no_request_in_flight"] = overlap(idle, complement(
            in_flight, lo_us, hi_us))
        gaps["request_outside_profile_phases"] = overlap(
            idle, in_flight) - overlap(idle, merge(
                [iv for pairs in host_phases.values()
                 for iv in to_trace(pairs)]))
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        idle_top = sorted(((k, v) for k, v in gaps.items() if v > 0),
                          key=lambda kv: -kv[1])[:10]
        return {"busy_s": busy_us / 1e6, "window_s": (hi_us - lo_us) / 1e6,
                "device_events": len(spans),
                "breakdown": {
                    "device_ops": [[n, us / 1e6] for n, us in top],
                    "idle_gaps": [[n, us / 1e6] for n, us in idle_top]}}
