"""Tenant identity and ambient propagation.

Multi-tenant scheduling needs a tenant attached to every query without
threading a parameter through every call signature in the serving stack.
`TenantContext` mirrors `common/deadline.py`: an immutable context object
carried by a `contextvars.ContextVar`, bound per-request with
`tenant_scope` and re-bound across thread-pool hops with `bind_tenant`
(contextvars do not propagate into pool worker threads).

A query with NO bound tenant is scheduled as `DEFAULT_TENANT` — a single
implicit tenant, under which weighted deficit-round-robin admission
degenerates to the exact FIFO the scheduler had before tenancy existed.
Tenancy being "off" is therefore not a separate code path, just the
one-tenant case of the same scheduler.

Priority classes are deliberately coarse — three bands, like an
inference-serving scheduler's interactive/batch split, not a continuous
priority space: classes are what operators reason about, and the shed
ladder of the overload controller needs discrete rungs.
"""

from __future__ import annotations

import contextvars
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Optional

# class name -> (priority rank, DRR weight). Rank orders the overload shed
# ladder (lowest shed first); weight sets the fair-share ratio of admission
# bytes under contention.
PRIORITY_CLASSES: dict[str, tuple[int, float]] = {
    "interactive": (2, 4.0),
    "standard": (1, 2.0),
    "background": (0, 1.0),
}
DEFAULT_CLASS = "standard"
MAX_PRIORITY = max(rank for rank, _ in PRIORITY_CLASSES.values())

# REST header carrying the tenant id. `x-opaque-id` (the ES attribution
# header) is accepted as a fallback so unmodified ES clients land in the
# right bucket.
TENANT_HEADER = "x-qw-tenant"
ES_FALLBACK_HEADER = "x-opaque-id"


@dataclass(frozen=True)
class TenantContext:
    """Resolved identity of the tenant a query runs on behalf of."""

    tenant_id: str
    priority_class: str = DEFAULT_CLASS
    priority: int = PRIORITY_CLASSES[DEFAULT_CLASS][0]
    weight: float = PRIORITY_CLASSES[DEFAULT_CLASS][1]

    @classmethod
    def for_class(cls, tenant_id: str, priority_class: str = DEFAULT_CLASS,
                  weight: Optional[float] = None) -> "TenantContext":
        """Build a context from a class name; unknown classes map to the
        default class instead of failing — a typo'd header must degrade to
        standard service, not a 500."""
        if priority_class not in PRIORITY_CLASSES:
            priority_class = DEFAULT_CLASS
        rank, class_weight = PRIORITY_CLASSES[priority_class]
        return cls(tenant_id=tenant_id, priority_class=priority_class,
                   priority=rank,
                   weight=float(weight) if weight else class_weight)

    # --- wire format (additive optional request field) -------------------
    def to_wire(self) -> dict:
        """Compact dict for the leaf request wire field. The CLASS travels
        with the id so a remote leaf enforces the same scheduling band
        without sharing the root's tenant config."""
        return {"id": self.tenant_id, "class": self.priority_class}

    @classmethod
    def from_wire(cls, payload) -> Optional["TenantContext"]:
        if not isinstance(payload, dict) or not payload.get("id"):
            return None
        return cls.for_class(str(payload["id"]),
                             str(payload.get("class", DEFAULT_CLASS)))


# The implicit tenant of unlabeled traffic: one queue, standard class.
DEFAULT_TENANT = TenantContext.for_class("default", DEFAULT_CLASS)


# --- ambient propagation --------------------------------------------------

_CURRENT_TENANT: contextvars.ContextVar[Optional[TenantContext]] = (
    contextvars.ContextVar("quickwit_tpu_tenant", default=None))


def current_tenant() -> Optional[TenantContext]:
    """The tenant bound to this thread of execution, if any."""
    return _CURRENT_TENANT.get()


def effective_tenant() -> TenantContext:
    """The bound tenant, or the implicit default for unlabeled traffic."""
    return _CURRENT_TENANT.get() or DEFAULT_TENANT


@contextmanager
def tenant_scope(tenant: Optional[TenantContext]):
    token = _CURRENT_TENANT.set(tenant)
    try:
        yield tenant
    finally:
        _CURRENT_TENANT.reset(token)


def bind_tenant(fn: Callable, tenant: Optional[TenantContext] = None) -> Callable:
    """Wrap `fn` so it runs under `tenant` (default: the caller's current
    tenant). Needed for ThreadPoolExecutor hops, exactly like
    `bind_deadline` / `bind_profile`."""
    captured = tenant if tenant is not None else current_tenant()

    def wrapper(*args, **kwargs):
        with tenant_scope(captured):
            return fn(*args, **kwargs)

    return wrapper
