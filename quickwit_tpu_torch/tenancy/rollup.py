"""Cluster-wide tenant usage rollup.

A tenant's footprint is not one node's counters: its queries land on
whichever searcher the root fans to, its cold splits run on offload
workers, and under the DST harness its traffic spreads over sim nodes.
`merge_tenant_reports` folds any number of per-node
`TenancyRegistry.report()` payloads into one cluster view — counters sum,
identity fields (class, priority, weight, limits, metric_label) come from
the first node that knows the tenant — and
`collect_cluster_tenant_report` drives it over the live membership: the
local registry, every alive cluster member's
`/api/v1/developer/tenants` endpoint, and any configured offload worker
endpoints. Per-endpoint failures degrade to an `errors` entry instead of
failing the rollup (a dead peer must not hide the live ones).

Served behind `GET /api/v1/developer/tenants?scope=cluster`
(serve/rest.py); with `scope=local` (the default) the endpoint keeps its
single-node shape.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Any, Optional

TENANTS_PATH = "/api/v1/developer/tenants"


def merge_tenant_reports(reports: list[dict]) -> dict[str, Any]:
    """Fold per-node tenancy reports into one cluster-scope report.

    Pure function (no I/O): the DST harness merges sim-node reports
    through the same code the REST endpoint uses against live peers."""
    tenants: dict[str, dict[str, Any]] = {}
    node_ids: list[str] = []
    enabled = False
    default_class: Optional[str] = None
    for rep in reports:
        if not isinstance(rep, dict):
            continue
        node_ids.append(str(rep.get("node_id", f"node-{len(node_ids)}")))
        enabled = enabled or bool(rep.get("enabled"))
        if default_class is None:
            default_class = rep.get("default_class")
        for tenant_id, entry in (rep.get("tenants") or {}).items():
            if not isinstance(entry, dict):
                continue
            slot = tenants.get(tenant_id)
            if slot is None:
                slot = tenants[tenant_id] = {
                    key: value for key, value in entry.items()
                    if key != "counters"}
                slot["counters"] = dict(entry.get("counters") or {})
                slot["nodes"] = 1
                continue
            slot["nodes"] += 1
            counters = slot["counters"]
            for key, value in (entry.get("counters") or {}).items():
                if isinstance(value, bool) or not isinstance(
                        value, (int, float)):
                    continue
                counters[key] = counters.get(key, 0) + value
    return {
        "scope": "cluster",
        "nodes": node_ids,
        "enabled": enabled,
        "default_class": default_class,
        "tenants": tenants,
    }


def _fetch_report(endpoint: str, timeout_secs: float) -> dict:
    """One peer's local-scope tenants report over REST."""
    base = endpoint if "://" in endpoint else f"http://{endpoint}"
    url = base.rstrip("/") + TENANTS_PATH
    with urllib.request.urlopen(url, timeout=timeout_secs) as resp:
        return json.loads(resp.read().decode("utf-8"))


def collect_cluster_tenant_report(node, timeout_secs: float = 2.0) -> dict:
    """The full rollup for `node`: local registry + alive cluster peers +
    configured offload worker endpoints. `node` is a serve.node.Node (or
    anything exposing `.config` and `.cluster` the same way)."""
    from ..observability.slo import SLO_TRACKER
    from .registry import GLOBAL_TENANCY

    local = GLOBAL_TENANCY.report()
    local["node_id"] = node.config.node_id
    reports: list[dict] = [local]
    errors: dict[str, str] = {}

    targets: list[tuple[str, str]] = []
    for member in node.cluster.members(alive_only=True):
        if member.node_id == node.config.node_id:
            continue
        if member.rest_endpoint:
            targets.append((member.node_id, member.rest_endpoint))
    offload_cfg = getattr(node.config, "offload", None) or {}
    for endpoint in offload_cfg.get("endpoints", ()):
        targets.append((f"offload:{endpoint}", endpoint))

    seen: set[str] = set()
    for name, endpoint in targets:
        if endpoint in seen:
            continue
        seen.add(endpoint)
        try:
            rep = _fetch_report(endpoint, timeout_secs)
        except (urllib.error.URLError, OSError, ValueError) as exc:
            errors[name] = str(exc)
            continue
        rep.setdefault("node_id", name)
        reports.append(rep)

    merged = merge_tenant_reports(reports)
    merged["errors"] = errors
    merged["slo"] = SLO_TRACKER.report()
    merged["overload"] = local.get("overload")
    return merged
