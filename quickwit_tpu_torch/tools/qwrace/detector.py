"""FastTrack-style vector-clock happens-before race detection.

The runtime (`runtime.py` beside this module) serializes every instrumented
thread and forwards each annotated shared access (`sync.note_read` /
`sync.note_write`) here with the thread's vector clock, lockset, and call
site. Two accesses to the same (owner, field) race when at least one is a
write and neither happens-before the other; happens-before is exactly the
edge set the runtime maintains: program order, lock release→acquire,
condition notify→wake, event set→wait, semaphore release→acquire, thread
start→first-op and last-op→join.

Locksets are NOT part of the race decision (pure happens-before — no
lockset-discipline false positives); they ride along in the report so a
fix can see which lock each side held.

The detector also accumulates the lock-order *witness graph*: every
nested acquisition observed at runtime, keyed by the seam lock names that
align with qwlint QW007's static node naming (`bridge.py` cross-checks
the two graphs).
"""

from __future__ import annotations

from typing import Any, Optional


def vc_join(a: dict[int, int], b: dict[int, int]) -> None:
    """a |= b, componentwise max, in place."""
    for tid, clk in b.items():
        if clk > a.get(tid, 0):
            a[tid] = clk


def _hb(clk: int, tid: int, vc: dict[int, int]) -> bool:
    """True when epoch (tid, clk) happens-before the observer clock
    `vc` — i.e. the observer has seen at least `clk` ticks of `tid`."""
    return clk <= vc.get(tid, 0)


class _VarState:
    __slots__ = ("write_tid", "write_clk", "write_site", "write_lockset",
                 "reads")

    def __init__(self) -> None:
        self.write_tid: Optional[int] = None
        self.write_clk = 0
        self.write_site = ""
        self.write_lockset: tuple = ()
        # tid -> (clk, site, lockset): reads since the last HB-ordered write
        self.reads: dict[int, tuple[int, str, tuple]] = {}


class RaceDetector:
    """One instance per run. All entry points are called with the gated
    scheduler token held (exactly one instrumented thread runs at a time),
    so no internal locking is needed and every structure iterates in
    deterministic insertion order."""

    def __init__(self) -> None:
        self._vars: dict[tuple[str, str], _VarState] = {}
        self.races: list[dict[str, Any]] = []
        self.errors: list[dict[str, Any]] = []
        # (held_name, acquired_name) -> first witnessed site
        self.witness_edges: dict[tuple[str, str], str] = {}
        self._race_keys: set = set()
        self._op_step = 0   # DST op index, stamped by the controller

    # --- context ------------------------------------------------------------
    def set_op_step(self, step: int) -> None:
        self._op_step = step

    # --- accesses -----------------------------------------------------------
    def access(self, tid: int, vc: dict[int, int], var: tuple[str, str],
               is_write: bool, site: str, lockset: tuple) -> None:
        state = self._vars.get(var)
        if state is None:
            state = self._vars[var] = _VarState()
        if is_write:
            if state.write_tid is not None and state.write_tid != tid \
                    and not _hb(state.write_clk, state.write_tid, vc):
                self._report("write-write", var, tid, site, lockset,
                             state.write_tid, state.write_site,
                             state.write_lockset)
            for rtid, (rclk, rsite, rlocks) in state.reads.items():
                if rtid != tid and not _hb(rclk, rtid, vc):
                    self._report("read-write", var, tid, site, lockset,
                                 rtid, rsite, rlocks)
            state.write_tid = tid
            state.write_clk = vc.get(tid, 0)
            state.write_site = site
            state.write_lockset = lockset
            state.reads.clear()
        else:
            if state.write_tid is not None and state.write_tid != tid \
                    and not _hb(state.write_clk, state.write_tid, vc):
                self._report("write-read", var, tid, site, lockset,
                             state.write_tid, state.write_site,
                             state.write_lockset)
            state.reads[tid] = (vc.get(tid, 0), site, lockset)

    def _report(self, kind: str, var: tuple[str, str], tid: int, site: str,
                lockset: tuple, other_tid: int, other_site: str,
                other_lockset: tuple) -> None:
        # dedup on the unordered site pair: the same textual race fires
        # once per report no matter how many thread pairs hit it
        key = (kind, var, frozenset((site, other_site)))
        if key in self._race_keys:
            return
        self._race_keys.add(key)
        self.races.append({
            "kind": kind,
            "object": var[0],
            "field": var[1],
            "op_step": self._op_step,
            "access": {"tid": tid, "site": site,
                       "lockset": sorted(lockset)},
            "previous": {"tid": other_tid, "site": other_site,
                         "lockset": sorted(other_lockset)},
            "common_locks": sorted(set(lockset) & set(other_lockset)),
        })

    # --- lock-order witnesses ----------------------------------------------
    def witness(self, held_name: str, acquired_name: str, site: str) -> None:
        if held_name == acquired_name:
            return
        self.witness_edges.setdefault((held_name, acquired_name), site)

    # --- scheduler errors ---------------------------------------------------
    def deadlock(self, blocked: list[dict[str, Any]]) -> None:
        self.errors.append({"kind": "deadlock", "op_step": self._op_step,
                            "blocked": blocked})

    def budget_exhausted(self, steps: int) -> None:
        self.errors.append({"kind": "scheduler_budget_exhausted",
                            "op_step": self._op_step, "steps": steps})

    # --- summary ------------------------------------------------------------
    def findings(self) -> list[dict[str, Any]]:
        return list(self.races) + list(self.errors)
