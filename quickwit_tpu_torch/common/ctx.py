"""Ambient-context propagation across thread hops.

Queries carry three contextvar bindings — deadline (common/deadline.py),
tenant (tenancy/context.py) and profile (observability/profile.py) — and
Python contextvars do NOT flow into `threading.Thread` targets or
`ThreadPoolExecutor` workers: a bare callable handed across a thread hop
silently drops all of them, so the downstream code sees no deadline (no
shedding), the default tenant (no isolation) and no profile (invisible
phases). Before this module each binding hand-rolled its own wrapper
(`bind_deadline`/`bind_tenant`/`bind_profile`, composed by hand at every
spawn site); `run_with_context` replaces the triple-wrap with ONE
snapshot of *all* contextvars, so a binding added later (e.g. a future
trace-baggage var) propagates without touching any spawn site.

qwlint rule QW003 flags spawn sites that pass bare callables and points
fixes here.
"""

from __future__ import annotations

import contextvars
import functools
from typing import Callable, TypeVar

T = TypeVar("T")


def run_with_context(fn: Callable[..., T],
                     context: "contextvars.Context | None" = None
                     ) -> Callable[..., T]:
    """Wrap `fn` so each invocation runs under a snapshot of the caller's
    contextvars (or an explicit `context`).

    Unlike `Context.run` on a shared snapshot — which raises RuntimeError
    when two threads enter the same Context concurrently — the wrapper
    replays the captured (var, value) pairs into a FRESH Context per
    call, so one wrapped callable can be handed to many threads (hedged
    storage attempts, pool workers) safely. Values are snapshotted at
    wrap time, matching the semantics of the bind_* helpers it replaces.
    """
    snapshot = context if context is not None \
        else contextvars.copy_context()
    items = list(snapshot.items())

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        fresh = contextvars.Context()

        def _replay_and_call():
            for var, value in items:
                var.set(value)
            return fn(*args, **kwargs)

        return fresh.run(_replay_and_call)

    return wrapper
