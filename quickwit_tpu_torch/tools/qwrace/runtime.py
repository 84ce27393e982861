"""Gated PCT scheduler + instrumented sync primitives.

Counterpart of the JAX package's `tools/qwrace/runtime.py`, over this
package's `common/sync.py` seam.

Loom-style cooperative serialization: every thread constructed through
`quickwit_tpu_torch.common.sync` runs as a real OS thread, but exactly one
holds the scheduler token at any moment and every instrumented operation (lock
acquire/release, condition wait/notify, event set/wait, semaphore ops,
thread start/join, `note_read`/`note_write`) is a preemption point. At
each point the scheduler consults seeded PCT state — random per-thread
priorities plus `depth-1` pre-drawn priority-change steps — and either
lets the current thread continue or parks it and grants another. The
resulting interleaving is a pure function of the seed, so a detected race
replays byte-identically, and the rolling blake2b over the decision log
(`schedule_digest`) certifies it.

Timeout policy (the no-hang determinism rule): timeout *values* are
ignored entirely — several call sites derive them from real wall time,
which would leak nondeterminism. A timed wait blocks like an untimed one;
when NO thread is runnable, the earliest-blocked timed waiter is woken as
timed-out (a stall means its wakeup genuinely cannot arrive first). All
threads blocked with no timed waiter = deadlock: reported as a finding,
then the run aborts via `SchedulerAbort` (a BaseException so the
product's `except Exception` ladders cannot swallow it).

Uninstrumented ("wild") threads that touch an instrumented primitive are
lazily registered and gated from that point on; threads still parked when
the run ends are woken with the abort flag set so nothing leaks into the
next seed.
"""

from __future__ import annotations

import hashlib
import itertools
import os
import random
import sys
import threading
from typing import Any, Callable, Optional

from ...common.sync import SyncRuntime

from .detector import RaceDetector, vc_join

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
_SELF_FILES = (os.path.abspath(__file__),)
# the seam's own frames are never a finding's site: a site names the
# product line that called the seam
_SEAM_FILE = os.path.join("quickwit_tpu_torch", "common", "sync.py")


class SchedulerAbort(BaseException):
    """Run teardown/deadlock abort. BaseException on purpose: product
    code catches broad `Exception` in fan-out ladders; an aborting run
    must unwind through them."""


class _TState:
    __slots__ = ("tid", "name", "gate", "status", "timed", "block_seq",
                 "timeout_fired", "priority", "vc", "held", "final_vc",
                 "joiners", "real_thread")

    RUNNABLE = "runnable"
    BLOCKED = "blocked"
    FINISHED = "finished"

    def __init__(self, tid: int, name: str, priority: float,
                 vc: dict[int, int]):
        self.tid = tid
        self.name = name
        self.gate = threading.Event()
        self.status = _TState.RUNNABLE
        self.timed = False
        self.block_seq = 0
        self.timeout_fired = False
        self.priority = priority
        self.vc = vc
        self.held: list[Any] = []      # innermost-last instrumented locks
        self.final_vc: Optional[dict[int, int]] = None
        self.joiners: list["_TState"] = []
        self.real_thread: Optional[threading.Thread] = None


class RaceRuntime(SyncRuntime):
    """One instance per DST run; installed via `sync.use_runtime`."""

    def __init__(self, seed: int, depth: int = 3, horizon: int = 4096,
                 max_steps: int = 500_000,
                 detector: Optional[RaceDetector] = None):
        self.detector = detector if detector is not None else RaceDetector()
        self._rng = random.Random(seed)
        self._depth = max(int(depth), 1)
        self._max_steps = int(max_steps)
        points = min(self._depth - 1, max(horizon - 1, 0))
        self._change_points = set(
            self._rng.sample(range(1, horizon), points)) if points else set()
        self._step = 0
        self._block_counter = itertools.count(1)
        self._uid_counter = itertools.count()
        self._tid_counter = itertools.count(1)
        self._owner_names: dict[int, str] = {}     # id(obj) -> report name
        self._owner_refs: list[Any] = []           # pin ids against reuse
        self._owner_counts: dict[str, int] = {}
        self._order: list[_TState] = []            # registration order
        self._ident_map: dict[int, _TState] = {}
        self._reg_lock = threading.Lock()          # wild-thread admission
        self._pending: list[tuple[int, _TState]] = []
        self._active: Optional[_TState] = None
        self._aborted = False
        self._finalized = False
        self._hash = hashlib.blake2b(digest_size=16)
        self._main: Optional[_TState] = None

    # --- lifecycle ----------------------------------------------------------
    def install_main(self) -> None:
        """Register the calling thread (the DST op loop) as T0."""
        st = _TState(tid=0, name="main", priority=self._rng.random(),
                     vc={0: 1})
        self._order.append(st)
        self._ident_map[threading.get_ident()] = st
        self._active = st
        self._main = st

    def shutdown(self) -> None:
        """End of run (main thread active): abort and wake every parked
        thread so nothing leaks into the next seed; real-join seam
        threads briefly."""
        self._aborted = True
        self._finalized = True
        for st in self._order:
            if st.status != _TState.FINISHED:
                st.status = _TState.RUNNABLE
                st.gate.set()
        for st in self._order:
            t = st.real_thread
            if t is not None and t is not threading.current_thread():
                t.join(timeout=5.0)

    def schedule_digest(self) -> str:
        return self._hash.hexdigest()

    @property
    def steps(self) -> int:
        return self._step

    @property
    def aborted(self) -> bool:
        return self._aborted

    # --- registration -------------------------------------------------------
    def _state(self) -> _TState:
        st = self._ident_map.get(threading.get_ident())
        if st is not None:
            return st
        # wild thread: admit it into the gated world from here on
        st = _TState(tid=next(self._tid_counter),
                     name=threading.current_thread().name,
                     priority=self._rng.random(), vc={})
        st.vc[st.tid] = 1
        with self._reg_lock:
            self._ident_map[threading.get_ident()] = st
            self._pending.append((st.tid, st))
        st.gate.wait()   # parked until a decision point admits + grants it
        if self._aborted:
            raise SchedulerAbort
        return st

    def _admit_pending(self) -> None:
        with self._reg_lock:
            pending, self._pending = self._pending, []
        for _, st in pending:
            self._order.append(st)

    # --- the scheduler ------------------------------------------------------
    def _enter_op(self, op: str, uid) -> _TState:
        st = self._state()
        if self._aborted:
            raise SchedulerAbort
        self._step += 1
        if self._step > self._max_steps:
            self.detector.budget_exhausted(self._step)
            self._abort_all()
            raise SchedulerAbort
        self._hash.update(
            f"{self._step}:{st.tid}:{op}:{uid}\n".encode())
        if self._step in self._change_points and self._active is not None:
            # PCT priority-change point: the running thread drops below
            # every base priority (base priorities are in (0, 1))
            self._active.priority = -float(self._step)
        self._maybe_switch(st)
        return st

    def _runnable(self) -> list[_TState]:
        self._admit_pending()
        return [s for s in self._order if s.status == _TState.RUNNABLE]

    def _pick(self, current: _TState) -> _TState:
        runnable = self._runnable()
        if runnable:
            return max(runnable, key=lambda s: (s.priority, -s.tid))
        timed = [s for s in self._order
                 if s.status == _TState.BLOCKED and s.timed]
        if timed:
            waiter = min(timed, key=lambda s: s.block_seq)
            waiter.timeout_fired = True
            waiter.status = _TState.RUNNABLE
            self._hash.update(f"timeout:{waiter.tid}\n".encode())
            return waiter
        self.detector.deadlock([
            {"tid": s.tid, "name": s.name}
            for s in self._order if s.status == _TState.BLOCKED])
        self._abort_all()
        raise SchedulerAbort

    def _maybe_switch(self, st: _TState) -> None:
        nxt = self._pick(st)
        if nxt is not st:
            self._grant(nxt, park=st)

    def _block(self, st: _TState, timed: bool) -> None:
        """Park the calling thread until a waker (or the stall-timeout
        policy) marks it runnable and a scheduling decision grants it."""
        st.status = _TState.BLOCKED
        st.timed = timed
        st.timeout_fired = False
        st.block_seq = next(self._block_counter)
        nxt = self._pick(st)
        self._grant(nxt, park=st)

    def _grant(self, nxt: _TState, park: _TState) -> None:
        park.gate.clear()
        self._active = nxt
        nxt.gate.set()
        park.gate.wait()
        if self._aborted:
            raise SchedulerAbort

    def _wake(self, st: _TState) -> None:
        if st.status == _TState.BLOCKED:
            st.status = _TState.RUNNABLE

    def _abort_all(self) -> None:
        self._aborted = True
        for st in self._order:
            if st.status != _TState.FINISHED:
                st.status = _TState.RUNNABLE
                st.gate.set()

    # --- naming -------------------------------------------------------------
    def _auto_name(self, kind: str, name: Optional[str]) -> str:
        if name:
            return name
        return f"<anon:{kind}#{next(self._uid_counter)}>"

    def owner_name(self, obj: Any) -> str:
        key = id(obj)
        name = self._owner_names.get(key)
        if name is None:
            base = type(obj).__name__
            n = self._owner_counts.get(base, 0)
            self._owner_counts[base] = n + 1
            name = f"{base}#{n}"
            self._owner_names[key] = name
            self._owner_refs.append(obj)
        return name

    def _site(self) -> str:
        frame = sys._getframe(1)
        while frame is not None:
            path = os.path.abspath(frame.f_code.co_filename)
            if path not in _SELF_FILES and not path.endswith(_SEAM_FILE):
                rel = os.path.relpath(path, _REPO_ROOT).replace(os.sep, "/")
                return f"{rel}:{frame.f_lineno}"
            frame = frame.f_back
        return "<unknown>"

    # --- HB bookkeeping shared by the primitives ----------------------------
    def _hb_release(self, st: _TState, obj_vc: dict[int, int]) -> None:
        vc_join(obj_vc, st.vc)
        st.vc[st.tid] = st.vc.get(st.tid, 0) + 1

    def _hb_acquire(self, st: _TState, obj_vc: dict[int, int]) -> None:
        vc_join(st.vc, obj_vc)

    def _record_acquisition(self, st: _TState, lock: "_LockBase") -> None:
        site = self._site()
        for outer in st.held:
            self.detector.witness(outer.qw_name, lock.qw_name, site)
        st.held.append(lock)

    def lockset(self, st: _TState) -> tuple:
        return tuple(lk.qw_name for lk in st.held)

    # --- SyncRuntime factory interface --------------------------------------
    def make_lock(self, name: Optional[str]):
        return _Lock(self, self._auto_name("lock", name))

    def make_rlock(self, name: Optional[str]):
        return _RLock(self, self._auto_name("rlock", name))

    def make_condition(self, lock: Any, name: Optional[str]):
        if lock is None:
            lock = _RLock(self, self._auto_name("rlock", name))
        return _Condition(self, lock, self._auto_name("cond", name))

    def make_event(self, name: Optional[str]):
        return _Event(self, self._auto_name("event", name))

    def make_semaphore(self, value: int, name: Optional[str]):
        return _Semaphore(self, value, self._auto_name("sem", name))

    def make_thread(self, target: Optional[Callable], args: tuple,
                    kwargs: dict, name: Optional[str],
                    daemon: Optional[bool]):
        return _Thread(self, target, args, kwargs, name, daemon)

    def note_access(self, owner: Any, field: str, is_write: bool) -> None:
        if self._finalized:
            return
        # name first: the schedule digest must hash a run-deterministic
        # token, never a raw id()
        name = self.owner_name(owner)
        st = self._enter_op("w" if is_write else "r",
                            f"{name}.{field}")
        self.detector.access(st.tid, st.vc, (name, field), is_write,
                             self._site(), self.lockset(st))

    def register_shared(self, obj: Any, name: str) -> None:
        key = id(obj)
        if key not in self._owner_names:
            n = self._owner_counts.get(name, 0)
            self._owner_counts[name] = n + 1
            self._owner_names[key] = f"{name}#{n}"
            self._owner_refs.append(obj)


# --- instrumented primitives -------------------------------------------------

class _LockBase:
    def __init__(self, rt: RaceRuntime, name: str):
        self._rt = rt
        self.qw_name = name
        self._uid = next(rt._uid_counter)
        self._vc: dict[int, int] = {}
        self._owner: Optional[_TState] = None
        self._count = 0
        self._waiters: list[_TState] = []

    def _plain(self) -> bool:
        # post-run fallback: after shutdown the process is back to a
        # single-threaded harness — keep the object usable, skip the
        # (dead) scheduler
        return self._rt._finalized

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self) -> bool:
        return self._owner is not None

    def _acquire_free(self, st: _TState) -> None:
        self._owner = st
        self._count = 1
        self._rt._hb_acquire(st, self._vc)
        self._rt._record_acquisition(st, self)

    def _do_acquire(self, st: _TState, blocking: bool,
                    timed: bool, reentrant: bool) -> bool:
        while True:
            if self._owner is None:
                self._acquire_free(st)
                return True
            if reentrant and self._owner is st:
                self._count += 1
                return True
            if not blocking:
                return False
            self._waiters.append(st)
            try:
                self._rt._block(st, timed)
            finally:
                if st in self._waiters:
                    self._waiters.remove(st)
            if st.timeout_fired:
                return False

    def _do_release(self, st: _TState) -> None:
        if self._owner is not st:
            raise RuntimeError(
                f"release of {self.qw_name} by non-owner thread")
        self._count -= 1
        if self._count:
            return
        self._owner = None
        self._rt._hb_release(st, self._vc)
        if self in st.held:
            st.held.remove(self)
        for waiter in self._waiters:
            self._rt._wake(waiter)


class _Lock(_LockBase):
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._plain():
            self._count = 1
            return True
        st = self._rt._enter_op("lk+", self._uid)
        return self._do_acquire(st, blocking,
                                timed=timeout is not None and timeout >= 0,
                                reentrant=False)

    def release(self) -> None:
        if self._plain():
            self._count = 0
            return
        st = self._rt._enter_op("lk-", self._uid)
        self._do_release(st)


class _RLock(_LockBase):
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._plain():
            self._count += 1
            return True
        st = self._rt._enter_op("rl+", self._uid)
        return self._do_acquire(st, blocking,
                                timed=timeout is not None and timeout >= 0,
                                reentrant=True)

    def release(self) -> None:
        if self._plain():
            self._count = max(self._count - 1, 0)
            return
        st = self._rt._enter_op("rl-", self._uid)
        self._do_release(st)

    # Condition support (mirrors threading.RLock's private protocol)
    def _release_save(self, st: _TState):
        count = self._count
        self._count = 1
        self._do_release(st)
        return count

    def _acquire_restore(self, st: _TState, count: int) -> None:
        self._do_acquire(st, blocking=True, timed=False, reentrant=True)
        self._count = count

    def _is_owned_by(self, st: _TState) -> bool:
        return self._owner is st


class _Condition:
    def __init__(self, rt: RaceRuntime, lock: Any, name: str):
        self._rt = rt
        self.qw_name = name
        self._uid = next(rt._uid_counter)
        self._lock = lock
        self._vc: dict[int, int] = {}
        # (state, record) FIFO; record: {"notified": bool}
        self._waiters: list[tuple[_TState, dict]] = []

    def __enter__(self):
        self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()
        return False

    def acquire(self, *a, **k):
        return self._lock.acquire(*a, **k)

    def release(self):
        return self._lock.release()

    def _owned(self, st: _TState) -> bool:
        return getattr(self._lock, "_owner", None) is st

    def wait(self, timeout: Optional[float] = None) -> bool:
        if self._rt._finalized:
            return False
        st = self._rt._enter_op("cw", self._uid)
        if not self._owned(st):
            raise RuntimeError("cannot wait on un-acquired condition")
        record = {"notified": False}
        self._waiters.append((st, record))
        if isinstance(self._lock, _RLock):
            saved = self._lock._release_save(st)
        else:
            saved = None
            self._lock._do_release(st)
        try:
            while not record["notified"]:
                self._rt._block(st, timed=timeout is not None)
                if st.timeout_fired:
                    break
        finally:
            if (st, record) in self._waiters:
                self._waiters.remove((st, record))
            if record["notified"]:
                self._rt._hb_acquire(st, self._vc)
            # re-acquire exactly like threading.Condition does
            if saved is not None:
                self._lock._acquire_restore(st, saved)
            else:
                self._lock._do_acquire(st, blocking=True, timed=False,
                                       reentrant=False)
        return bool(record["notified"])

    def wait_for(self, predicate: Callable[[], Any],
                 timeout: Optional[float] = None):
        result = predicate()
        while not result:
            if not self.wait(timeout) and timeout is not None:
                return predicate()
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        if self._rt._finalized:
            return
        st = self._rt._enter_op("cn", self._uid)
        if not self._owned(st):
            raise RuntimeError("cannot notify on un-acquired condition")
        vc_join(self._vc, st.vc)
        st.vc[st.tid] = st.vc.get(st.tid, 0) + 1
        woken = 0
        for waiter, record in self._waiters:
            if record["notified"]:
                continue
            record["notified"] = True
            self._rt._wake(waiter)
            woken += 1
            if woken >= n:
                break

    def notify_all(self) -> None:
        self.notify(n=len(self._waiters) or 1)


class _Event:
    def __init__(self, rt: RaceRuntime, name: str):
        self._rt = rt
        self.qw_name = name
        self._uid = next(rt._uid_counter)
        self._flag = False
        self._vc: dict[int, int] = {}
        self._waiters: list[_TState] = []

    def is_set(self) -> bool:
        if self._flag and not self._rt._finalized:
            # an observed set() is a synchronization edge even through
            # the non-blocking read (FakeClock.wait polls this way)
            st = self._rt._ident_map.get(threading.get_ident())
            if st is not None:
                vc_join(st.vc, self._vc)
        return self._flag

    def set(self) -> None:
        if self._rt._finalized:
            self._flag = True
            return
        st = self._rt._enter_op("ev+", self._uid)
        self._flag = True
        vc_join(self._vc, st.vc)
        st.vc[st.tid] = st.vc.get(st.tid, 0) + 1
        for waiter in self._waiters:
            self._rt._wake(waiter)

    def clear(self) -> None:
        self._flag = False

    def wait(self, timeout: Optional[float] = None) -> bool:
        if self._rt._finalized:
            return self._flag
        st = self._rt._enter_op("evw", self._uid)
        while not self._flag:
            self._waiters.append(st)
            try:
                self._rt._block(st, timed=timeout is not None)
            finally:
                if st in self._waiters:
                    self._waiters.remove(st)
            if st.timeout_fired:
                return self._flag
        self._rt._hb_acquire(st, self._vc)
        return True


class _Semaphore:
    def __init__(self, rt: RaceRuntime, value: int, name: str):
        self._rt = rt
        self.qw_name = name
        self._uid = next(rt._uid_counter)
        self._value = int(value)
        self._vc: dict[int, int] = {}
        self._waiters: list[_TState] = []

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def acquire(self, blocking: bool = True,
                timeout: Optional[float] = None) -> bool:
        if self._rt._finalized:
            self._value -= 1
            return True
        st = self._rt._enter_op("sm+", self._uid)
        while self._value <= 0:
            if not blocking:
                return False
            self._waiters.append(st)
            try:
                self._rt._block(st, timed=timeout is not None)
            finally:
                if st in self._waiters:
                    self._waiters.remove(st)
            if st.timeout_fired:
                return False
        self._value -= 1
        self._rt._hb_acquire(st, self._vc)
        return True

    def release(self, n: int = 1) -> None:
        if self._rt._finalized:
            self._value += n
            return
        st = self._rt._enter_op("sm-", self._uid)
        self._value += n
        vc_join(self._vc, st.vc)
        st.vc[st.tid] = st.vc.get(st.tid, 0) + 1
        for waiter in self._waiters:
            self._rt._wake(waiter)


class _Thread:
    def __init__(self, rt: RaceRuntime, target: Optional[Callable],
                 args: tuple, kwargs: dict, name: Optional[str],
                 daemon: Optional[bool]):
        self._rt = rt
        self._target = target
        self._args = args
        self._kwargs = kwargs
        self.name = name or f"qwrace-{next(rt._uid_counter)}"
        self.daemon = True if daemon is None else daemon
        self._st: Optional[_TState] = None
        self._real: Optional[threading.Thread] = None

    def start(self) -> None:
        rt = self._rt
        if rt._finalized:
            self._real = threading.Thread(
                target=self._target, args=self._args, kwargs=self._kwargs,
                name=self.name, daemon=self.daemon)
            self._real.start()
            return
        parent = rt._enter_op("th+", 0)
        child = _TState(tid=next(rt._tid_counter), name=self.name,
                        priority=rt._rng.random(), vc=dict(parent.vc))
        child.vc[child.tid] = 1
        parent.vc[parent.tid] = parent.vc.get(parent.tid, 0) + 1
        self._st = child
        rt._order.append(child)

        def _child_main() -> None:
            with rt._reg_lock:
                rt._ident_map[threading.get_ident()] = child
            child.gate.wait()
            try:
                if not rt._aborted and self._target is not None:
                    self._target(*self._args, **self._kwargs)
            except SchedulerAbort:
                return
            finally:
                if not rt._aborted:
                    self._finish(child)

        self._real = threading.Thread(target=_child_main, name=self.name,
                                      daemon=self.daemon)
        child.real_thread = self._real
        self._real.start()

    def _finish(self, child: _TState) -> None:
        rt = self._rt
        rt._hash.update(f"fin:{child.tid}\n".encode())
        child.final_vc = dict(child.vc)
        child.status = _TState.FINISHED
        for joiner in child.joiners:
            rt._wake(joiner)
        # dying grant: hand the token on without parking
        try:
            nxt = rt._pick(child)
        except SchedulerAbort:
            return
        rt._active = nxt
        nxt.gate.set()

    def join(self, timeout: Optional[float] = None) -> None:
        rt = self._rt
        if rt._finalized or self._st is None:
            if self._real is not None:
                self._real.join(timeout)
            return
        st = rt._enter_op("thj", self._st.tid)
        child = self._st
        while child.status != _TState.FINISHED:
            child.joiners.append(st)
            try:
                rt._block(st, timed=timeout is not None)
            finally:
                if st in child.joiners:
                    child.joiners.remove(st)
            if st.timeout_fired:
                return
        if child.final_vc is not None:
            vc_join(st.vc, child.final_vc)

    def is_alive(self) -> bool:
        if self._st is not None:
            return self._st.status != _TState.FINISHED
        return self._real is not None and self._real.is_alive()
