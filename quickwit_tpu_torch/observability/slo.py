"""Per-tenant SLO burn accounting over the flight-recorder event stream.

Role of the reference's Datadog-side SLO monitors: each priority class
(`tenancy/context.py PRIORITY_CLASSES`) carries a latency objective and a
success-ratio target; every root query completion (the `query.done`
flight event's site in `search/root.py`) is judged against its class —
a breach is a shed/timed-out/errored query or a successful one over the
latency objective. Burn rate is the classic multiwindow quantity reduced
to one window: `breach_fraction / error_budget` over a sliding bucketed
window, so burn == 1.0 means the class is spending its budget exactly as
fast as the objective allows, and an alerting rule on
`qw_slo_burn_rate > N` needs no PromQL gymnastics.

Time comes from the clock seam (QW006-scoped): under DST the window
arithmetic runs on virtual time and is deterministic; in production the
seam is the real clock. Per-tenant attribution reuses the laundered
metric labels from `TenancyRegistry.metric_label` — the caller passes the
label so this module stays import-light (no tenancy dependency).
"""

from __future__ import annotations

from typing import Any, Optional

from ..common import sync
from ..common.clock import monotonic
from .metrics import SLO_BURN_RATE, SLO_OBJECTIVE_LATENCY_MS, SLO_QUERIES_TOTAL

# class -> (latency objective ms, success-ratio target). The error budget
# is 1 - target: interactive tenants get a tight objective and a thin
# budget, background a loose objective and a thick one.
DEFAULT_OBJECTIVES: dict[str, tuple[float, float]] = {
    "interactive": (500.0, 0.999),
    "standard": (2000.0, 0.99),
    "background": (10000.0, 0.95),
}

_BUCKET_SECS = 10.0
_WINDOW_BUCKETS = 30          # 5-minute sliding window


class SloTracker:
    """Windowed per-class breach accounting + cumulative per-tenant
    counters, mirrored into the `qw_slo_*` metric families."""

    def __init__(self,
                 objectives: Optional[dict[str, tuple[float, float]]] = None):
        self._lock = sync.lock("SloTracker._lock")
        self.configure(objectives)

    def configure(self,
                  objectives: Optional[dict[str, tuple[float, float]]] = None
                  ) -> None:
        with self._lock:
            self._objectives = dict(objectives or DEFAULT_OBJECTIVES)
            # class -> {bucket_index: [total, breached]} sliding window
            self._window: dict[str, dict[int, list[float]]] = {}
            # (tenant_label, class) -> [total, breached] cumulative
            self._tenants: dict[tuple[str, str], list[float]] = {}
        for cls, (latency_ms, _target) in self._objectives.items():
            SLO_OBJECTIVE_LATENCY_MS.set(latency_ms, priority_class=cls)

    def objective(self, priority_class: str) -> tuple[float, float]:
        with self._lock:
            return self._objectives.get(
                priority_class,
                self._objectives.get("standard", (2000.0, 0.99)))

    # ------------------------------------------------------------------
    def note(self, priority_class: str, tenant_label: str,
             latency_ms: float, ok: bool) -> float:
        """Judge one completed query; returns the class's current burn
        rate. `ok=False` (shed / timed out / errored) is always a breach;
        an ok query breaches when it blew the latency objective."""
        latency_objective_ms, target = self.objective(priority_class)
        breach = (not ok) or latency_ms > latency_objective_ms
        budget = max(1.0 - target, 1e-6)
        bucket = int(monotonic() // _BUCKET_SECS)
        with self._lock:
            window = self._window.setdefault(priority_class, {})
            cell = window.setdefault(bucket, [0.0, 0.0])
            cell[0] += 1.0
            if breach:
                cell[1] += 1.0
            # expire buckets that slid out of the window
            floor = bucket - _WINDOW_BUCKETS
            for b in [b for b in window if b <= floor]:
                del window[b]
            total = sum(c[0] for c in window.values())
            breached = sum(c[1] for c in window.values())
            tcell = self._tenants.setdefault(
                (tenant_label, priority_class), [0.0, 0.0])
            tcell[0] += 1.0
            if breach:
                tcell[1] += 1.0
        burn = (breached / total) / budget if total else 0.0
        SLO_QUERIES_TOTAL.inc(priority_class=priority_class,
                              verdict="breach" if breach else "ok",
                              tenant=tenant_label)
        SLO_BURN_RATE.set(round(burn, 6), priority_class=priority_class)
        return burn

    # ------------------------------------------------------------------
    def report(self) -> dict[str, Any]:
        """JSON snapshot for the developer endpoint: objectives, live
        windowed burn per class, cumulative per-tenant breach counts."""
        with self._lock:
            objectives = dict(self._objectives)
            window = {cls: {b: list(c) for b, c in w.items()}
                      for cls, w in self._window.items()}
            tenants = {k: list(v) for k, v in self._tenants.items()}
        classes: dict[str, Any] = {}
        for cls, (latency_ms, target) in sorted(objectives.items()):
            w = window.get(cls, {})
            total = sum(c[0] for c in w.values())
            breached = sum(c[1] for c in w.values())
            budget = max(1.0 - target, 1e-6)
            classes[cls] = {
                "latency_objective_ms": latency_ms,
                "success_target": target,
                "window_secs": _BUCKET_SECS * _WINDOW_BUCKETS,
                "window_total": total,
                "window_breached": breached,
                "burn_rate": round((breached / total) / budget, 6)
                if total else 0.0,
            }
        per_tenant: dict[str, Any] = {}
        for (label, cls), (total, breached) in sorted(tenants.items()):
            per_tenant.setdefault(label, {})[cls] = {
                "total": total, "breached": breached}
        return {"classes": classes, "tenants": per_tenant}

    def reset(self) -> None:
        """Drop observations, keep objectives — test isolation."""
        with self._lock:
            self._window.clear()
            self._tenants.clear()


# Process-global tracker, matching METRICS / FLIGHT / OVERLOAD: the root
# searcher feeds it, the developer endpoint reports it.
SLO_TRACKER = SloTracker()
