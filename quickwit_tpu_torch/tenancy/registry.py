"""Tenant registry: configuration, token-bucket quotas, accounting.

One process-global registry (matching METRICS / SLOW_QUERY_LOG /
OVERLOAD) holds everything the serving stack needs to know about tenants:

- **config**: per-tenant priority class / weight overrides and rate
  limits, parsed from the node config's ``tenancy`` section;
- **resolution**: header value (or wire field at a leaf) -> a
  `TenantContext`. With tenancy disabled and no header, resolution
  returns None and the stack stays tenant-blind — the behavior-neutral
  off state;
- **quotas**: lazily-created `TokenBucket`s per tenant for QPS and
  staged-HBM-bytes/s, rejecting with `TenantRateLimited` (→ HTTP 429 +
  Retry-After);
- **accounting**: per-tenant counters mirrored into bounded-cardinality
  labeled metrics, and a JSON report for
  ``GET /api/v1/developer/tenants``.

Label cardinality: tenant ids are client-controlled strings, so they are
laundered through `metric_label` before becoming Prometheus label values —
long ids are hashed, and once `MAX_TENANT_LABELS` distinct ids have been
seen every further id collapses into the ``_other`` bucket. Configured
tenants always keep their own label (config size bounds them).
"""

from __future__ import annotations

import hashlib
from typing import Optional

from ..common.tower import TokenBucket
from ..observability.metrics import (
    TENANT_ADMISSION_WAIT, TENANT_EXECUTE_SECONDS_TOTAL,
    TENANT_QUERIES_TOTAL, TENANT_REJECTED_TOTAL, TENANT_SHED_TOTAL,
    TENANT_STAGED_BYTES_TOTAL,
)
from .context import DEFAULT_CLASS, DEFAULT_TENANT, TenantContext
from .overload import OVERLOAD
from ..common import sync

MAX_TENANT_LABELS = 64
_LABEL_ID_MAX_LEN = 32
OVERFLOW_LABEL = "_other"


class TenantRateLimited(Exception):
    """A tenant exceeded one of its token buckets. Carries the seconds
    until the bucket refills for the 429 Retry-After header."""

    def __init__(self, tenant_id: str, limit: str, retry_after_secs: float):
        self.tenant_id = tenant_id
        self.limit = limit  # "qps" | "staged_bytes"
        self.retry_after_secs = max(float(retry_after_secs), 0.0)
        super().__init__(
            f"tenant {tenant_id!r} over its {limit} limit; "
            f"retry after {self.retry_after_secs:.2f}s")


class TenancyRegistry:
    def __init__(self, config: Optional[dict] = None):
        self._lock = sync.lock("TenancyRegistry._lock")
        sync.register_shared(self, "TenancyRegistry")
        self.configure(config)

    # --- configuration ----------------------------------------------------
    def configure(self, config: Optional[dict]) -> None:
        """(Re)load from a ``tenancy`` config dict::

            {"enabled": true,
             "default_class": "standard",
             "default_tenant": "default",
             "default_limits": {"qps_limit": 50,
                                "staged_bytes_per_sec_limit": 1e9},
             "tenants": {"acme": {"class": "interactive",
                                  "weight": 8.0,
                                  "qps_limit": 100,
                                  "staged_bytes_per_sec_limit": 2e9}},
             "overload": {"enabled": true, "target_wait_secs": 0.5}}

        Unset limits mean unlimited. The overload section arms the global
        controller as a side effect so one config block governs the whole
        isolation stack."""
        config = dict(config or {})
        with self._lock:
            self.enabled = bool(config.get("enabled", False))
            self.default_class = str(
                config.get("default_class", DEFAULT_CLASS))
            self.default_tenant_id = str(
                config.get("default_tenant", DEFAULT_TENANT.tenant_id))
            self.default_limits = dict(config.get("default_limits") or {})
            self._specs: dict[str, dict] = {
                str(tid): dict(spec or {})
                for tid, spec in (config.get("tenants") or {}).items()}
            self._buckets: dict[tuple[str, str], Optional[TokenBucket]] = {}
            self._counters: dict[str, dict[str, float]] = {}
            self._labels: dict[str, str] = {}
        overload = config.get("overload")
        if overload:
            OVERLOAD.configure(
                target_wait_secs=overload.get("target_wait_secs"),
                enabled=overload.get("enabled"))

    def reset_usage(self) -> None:
        """Drop buckets/counters/labels, keep config — test isolation."""
        with self._lock:
            self._buckets.clear()
            self._counters.clear()
            self._labels.clear()

    # --- resolution -------------------------------------------------------
    def resolve(self, tenant_id: Optional[str]) -> Optional[TenantContext]:
        """Header/wire value -> TenantContext. No id + tenancy disabled
        -> None (the tenant-blind path existing tests exercise); no id +
        enabled -> the configured default tenant. An id is always honored,
        even with tenancy disabled, so a single labeled request can be
        attributed without flipping the global switch."""
        if not tenant_id:
            if not self.enabled:
                return None
            tenant_id = self.default_tenant_id
        tenant_id = str(tenant_id).strip()[:128]
        if not tenant_id:
            return None
        with self._lock:
            spec = self._specs.get(tenant_id, {})
            default_class = self.default_class
        return TenantContext.for_class(
            tenant_id, str(spec.get("class", default_class)),
            weight=spec.get("weight"))

    # --- quotas -----------------------------------------------------------
    def _limit_for(self, tenant_id: str, key: str):
        spec = self._specs.get(tenant_id, {})
        return spec.get(key, self.default_limits.get(key))

    def _bucket(self, tenant_id: str, kind: str) -> Optional[TokenBucket]:
        with self._lock:
            cache_key = (tenant_id, kind)
            if cache_key in self._buckets:
                return self._buckets[cache_key]
            limit_key = ("qps_limit" if kind == "qps"
                         else "staged_bytes_per_sec_limit")
            limit = self._limit_for(tenant_id, limit_key)
            bucket = None
            if limit is not None and float(limit) > 0:
                rate = float(limit)
                # one second of burst: a tenant can spend its whole
                # per-second allowance at once, then refills smoothly
                bucket = TokenBucket(rate_per_sec=rate, burst=rate)
            self._buckets[cache_key] = bucket
            return bucket

    def check_query_rate(self, tenant: TenantContext) -> None:
        """QPS bucket at root admission; cost 1 per root search."""
        bucket = self._bucket(tenant.tenant_id, "qps")
        if bucket is None:
            return
        if not bucket.try_acquire(1.0):
            self.note_rejected(tenant.tenant_id, "qps")
            raise TenantRateLimited(tenant.tenant_id, "qps",
                                    bucket.time_to_available(1.0))

    def charge_staged_bytes(self, tenant: TenantContext, nbytes: int) -> None:
        """Staged-bytes/s bucket at the HBM admission checkpoint. A query
        larger than one second's allowance drains the bucket fully instead
        of being permanently unadmittable — the hard byte ceiling is the
        HBM budget's job, this bucket only paces the *rate*."""
        if nbytes <= 0:
            return
        bucket = self._bucket(tenant.tenant_id, "staged_bytes")
        if bucket is None:
            return
        cost = min(float(nbytes), bucket.burst)
        if not bucket.try_acquire(cost):
            self.note_rejected(tenant.tenant_id, "staged_bytes")
            raise TenantRateLimited(tenant.tenant_id, "staged_bytes",
                                    bucket.time_to_available(cost))

    # --- bounded-cardinality labels ----------------------------------------
    def metric_label(self, tenant_id: str) -> str:
        with self._lock:
            label = self._labels.get(tenant_id)
            if label is not None:
                return label
            configured = tenant_id in self._specs \
                or tenant_id == self.default_tenant_id
            if not configured and len(self._labels) >= MAX_TENANT_LABELS:
                return OVERFLOW_LABEL
            if len(tenant_id) > _LABEL_ID_MAX_LEN:
                digest = hashlib.blake2b(tenant_id.encode("utf-8", "replace"),
                                         digest_size=6).hexdigest()
                label = f"t-{digest}"
            else:
                label = tenant_id
            self._labels[tenant_id] = label
            return label

    # --- accounting ---------------------------------------------------------
    def _count(self, tenant_id: str, field: str, amount: float = 1.0) -> None:
        with self._lock:
            counters = self._counters.setdefault(tenant_id, {})
            counters[field] = counters.get(field, 0.0) + amount

    def note_query(self, tenant_id: str, status: str = "ok") -> None:
        self._count(tenant_id, f"queries_{status}")
        TENANT_QUERIES_TOTAL.inc(tenant=self.metric_label(tenant_id),
                                 status=status)

    def note_shed(self, tenant_id: str, stage: str) -> None:
        self._count(tenant_id, "shed")
        TENANT_SHED_TOTAL.inc(tenant=self.metric_label(tenant_id),
                              stage=stage)

    def note_rejected(self, tenant_id: str, limit: str) -> None:
        self._count(tenant_id, "rejected")
        TENANT_REJECTED_TOTAL.inc(tenant=self.metric_label(tenant_id),
                                  limit=limit)

    def note_staged_bytes(self, tenant_id: str, nbytes: int) -> None:
        if nbytes <= 0:
            return
        self._count(tenant_id, "staged_bytes", float(nbytes))
        TENANT_STAGED_BYTES_TOTAL.inc(float(nbytes),
                                      tenant=self.metric_label(tenant_id))

    def note_admission_wait(self, tenant_id: str, wait_secs: float) -> None:
        self._count(tenant_id, "admission_wait_seconds", wait_secs)
        TENANT_ADMISSION_WAIT.observe(wait_secs,
                                      tenant=self.metric_label(tenant_id))

    def note_execute_seconds(self, tenant_id: str, seconds: float) -> None:
        if seconds <= 0:
            return
        self._count(tenant_id, "execute_seconds", seconds)
        TENANT_EXECUTE_SECONDS_TOTAL.inc(
            seconds, tenant=self.metric_label(tenant_id))

    # --- introspection ------------------------------------------------------
    def report(self) -> dict:
        """JSON body of ``GET /api/v1/developer/tenants``: configured and
        observed tenants with their class, limits and counters, plus the
        overload controller's live state."""
        with self._lock:
            tenant_ids = sorted(set(self._specs) | set(self._counters))
            specs = {tid: dict(self._specs.get(tid, {}))
                     for tid in tenant_ids}
            counters = {tid: dict(self._counters.get(tid, {}))
                        for tid in tenant_ids}
            enabled = self.enabled
            default_class = self.default_class
            default_limits = dict(self.default_limits)
        tenants = {}
        for tid in tenant_ids:
            spec = specs[tid]
            context = TenantContext.for_class(
                tid, str(spec.get("class", default_class)),
                weight=spec.get("weight"))
            tenants[tid] = {
                "class": context.priority_class,
                "priority": context.priority,
                "weight": context.weight,
                "limits": {
                    "qps": spec.get("qps_limit",
                                    default_limits.get("qps_limit")),
                    "staged_bytes_per_sec": spec.get(
                        "staged_bytes_per_sec_limit",
                        default_limits.get("staged_bytes_per_sec_limit")),
                },
                "counters": counters[tid],
                "metric_label": self.metric_label(tid),
            }
        return {"enabled": enabled, "default_class": default_class,
                "tenants": tenants, "overload": OVERLOAD.state()}


# Process-global registry: REST resolution, admission accounting and the
# developer endpoint share it; `serve/node.py` configures it from the node
# config's `tenancy` section.
GLOBAL_TENANCY = TenancyRegistry()


def configure_tenancy(config: Optional[dict]) -> TenancyRegistry:
    GLOBAL_TENANCY.configure(config)
    return GLOBAL_TENANCY
