"""Process-injectable synchronization seam.

Role of rustc's Send/Sync discipline in the reference: the Rust codebase
gets data-race freedom checked at compile time; this reproduction has
dozens of lock/thread sites (cache tiers, offload pool, admission,
residency, batcher) that CPython happily lets race. This seam is the
dynamic-analysis counterpart: every `Lock`/`RLock`/`Condition`/`Event`/
`Semaphore`/`Thread` on a concurrency-relevant path is constructed through
the factories below, so the qwrace runtime (`tools/qwrace`) can substitute
instrumented primitives that

- serialize all instrumented threads under ONE seeded scheduler (every
  sync operation is a preemption point — loom/PCT style), making any
  interleaving reproducible from a seed;
- record acquire/release/start/join/wait/notify as happens-before edges
  for FastTrack-style vector-clock race detection;
- witness the runtime lock-order graph that `tools/qwrace bridge`
  cross-checks against qwlint QW007's static acquisition graph.

Contract:

- With no runtime installed (production), every factory returns the plain
  `threading.*` object — byte-for-byte the pre-seam behavior, one global
  `is None` check of overhead.
- `set_runtime` / `use_runtime` install a `SyncRuntime`; the qwrace
  harness is the only installer.
- `note_read(owner, field)` / `note_write(owner, field)` annotate accesses
  to registered shared structures (ThresholdBox, WorkerPool, cache tiers,
  ResidentColumnStore, tenant registry, actor mailboxes). They are no-ops
  in production and feed the vector-clock detector under qwrace.
- `name=` strings follow qwlint QW007's lock-node naming
  (`ClassName._lock`, module-level `_SOME_LOCK`) so runtime witness edges
  and static edges meet in one namespace.

qwlint rule QW008 enforces adoption: raw `threading.{Lock,RLock,
Condition,Event,Semaphore,Thread}` construction outside this module is a
finding unless the site carries a justified suppression.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Callable, Iterator, Optional


class SyncRuntime:
    """Interface the qwrace runtime implements. Every method must return
    an object duck-compatible with the `threading` original (context
    manager protocol for locks, `wait`/`notify` for conditions, `start`/
    `join`/`is_alive` for threads)."""

    def make_lock(self, name: Optional[str]) -> Any:
        raise NotImplementedError

    def make_rlock(self, name: Optional[str]) -> Any:
        raise NotImplementedError

    def make_condition(self, lock: Any, name: Optional[str]) -> Any:
        raise NotImplementedError

    def make_event(self, name: Optional[str]) -> Any:
        raise NotImplementedError

    def make_semaphore(self, value: int, name: Optional[str]) -> Any:
        raise NotImplementedError

    def make_thread(self, target: Optional[Callable], args: tuple,
                    kwargs: dict, name: Optional[str],
                    daemon: Optional[bool]) -> Any:
        raise NotImplementedError

    def note_access(self, owner: Any, field: str, is_write: bool) -> None:
        raise NotImplementedError

    def register_shared(self, obj: Any, name: str) -> None:
        raise NotImplementedError


_runtime: Optional[SyncRuntime] = None
_runtime_lock = threading.Lock()


def get_runtime() -> Optional[SyncRuntime]:
    return _runtime


def set_runtime(runtime: Optional[SyncRuntime]) -> Optional[SyncRuntime]:
    """Install `runtime` process-wide (None restores plain threading);
    returns the previously installed runtime."""
    global _runtime
    with _runtime_lock:
        previous = _runtime
        _runtime = runtime
        return previous


@contextmanager
def use_runtime(runtime: SyncRuntime) -> Iterator[SyncRuntime]:
    previous = set_runtime(runtime)
    try:
        yield runtime
    finally:
        set_runtime(previous)


# --- factories ---------------------------------------------------------------

def lock(name: Optional[str] = None):
    """A mutex; `name` should match the QW007 static node for this lock
    (e.g. "WorkerPool._lock") so the lock-graph bridge can align the
    runtime witness edge with the static acquisition edge."""
    if _runtime is None:
        return threading.Lock()
    return _runtime.make_lock(name)


def rlock(name: Optional[str] = None):
    if _runtime is None:
        return threading.RLock()
    return _runtime.make_rlock(name)


def condition(lock: Any = None, name: Optional[str] = None):
    """A condition variable over `lock` (a fresh seam lock when None)."""
    if _runtime is None:
        return threading.Condition(lock)
    return _runtime.make_condition(lock, name)


def event(name: Optional[str] = None):
    if _runtime is None:
        return threading.Event()
    return _runtime.make_event(name)


def semaphore(value: int = 1, name: Optional[str] = None):
    if _runtime is None:
        return threading.Semaphore(value)
    return _runtime.make_semaphore(value, name)


def thread(target: Optional[Callable] = None, *, args: tuple = (),
           kwargs: Optional[dict] = None, name: Optional[str] = None,
           daemon: Optional[bool] = None):
    """A thread the qwrace scheduler can gate. `start()` on the returned
    object registers the child with the scheduler and establishes the
    start→first-op happens-before edge."""
    if _runtime is None:
        # qwlint: disable-next-line=QW003 - pass-through factory: context
        # propagation is the CALLER's contract (callers wrap their target
        # with run_with_context exactly as they did pre-seam), and QW003
        # keeps enforcing that at every call site of this factory
        t = threading.Thread(target=target, args=args,
                             kwargs=kwargs or {}, name=name)
        if daemon is not None:
            t.daemon = daemon
        return t
    return _runtime.make_thread(target, args, kwargs or {}, name, daemon)


# --- shared-access annotations ----------------------------------------------

def note_read(owner: Any, field: str) -> None:
    """Record a read of `owner.field` for race detection. No-op in
    production (one global check); under qwrace the access is stamped
    with the current thread's vector clock, lockset, and call site."""
    if _runtime is not None:
        _runtime.note_access(owner, field, False)


def note_write(owner: Any, field: str) -> None:
    """Record a write of `owner.field` for race detection (see
    `note_read`)."""
    if _runtime is not None:
        _runtime.note_access(owner, field, True)


def register_shared(obj: Any, name: str) -> None:
    """Give `obj` a stable human-readable identity in race reports
    ("WorkerPool#0" instead of an id()). Optional: unregistered owners
    auto-name by type on first noted access."""
    if _runtime is not None:
        _runtime.register_shared(obj, name)
