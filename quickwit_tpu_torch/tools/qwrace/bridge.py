"""Static↔dynamic lock-graph bridge (the qwmc trace-conformance pattern,
applied to locks instead of protocol traces), over this package's tree.

qwlint QW007 builds a *static* lock-acquisition graph by AST analysis;
the qwrace runtime witnesses the *dynamic* graph — every nested
acquisition that actually executed, named through the seam's QW007-style
lock names. The two must agree in one direction:

- a RUNTIME edge between two statically-identifiable locks that the
  static graph lacks is a **QW007 scope gap** — the analyzer missed an
  acquisition path that demonstrably happens (usually cross-procedural:
  a method called under lock A takes lock B internally). Gate-failing.
  Known cross-procedural edges are declared in `DECLARED_EDGES` with the
  call path that produces them; the declaration IS the audit trail.
- a runtime edge involving an anonymous lock (name outside QW007's
  `lock|mutex` naming convention) is reported as info: static analysis
  never claimed to see it.
- a STATIC edge never witnessed at runtime is coverage info, not a
  failure: the sweep simply never drove that path.

The static graph is qwlint's own QW007 rule (`tools/qwlint`, standard
library only, read here and never changed) run over `quickwit_tpu_torch/`.
QW007 has no package scope of its own (its `check` visits every file it is
given), so the port's paths need no copy of the rule.
"""

from __future__ import annotations

import os
from typing import Any, Optional

from tools.qwlint.core import FileContext, LintError, _iter_py_files
from tools.qwlint.rules import _LOCK_NAME_RE, _QW007_ALL_SHARED, LockOrder

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

# Cross-procedural acquisition edges QW007's intra-procedural traversal
# cannot see, each justified by the concrete call path. An entry here is
# reviewed like a suppression: the edge is REAL and must stay
# deadlock-consistent with the rest of the graph by manual argument.
DECLARED_EDGES: dict[tuple[str, str], str] = {
    ("TenantPartitionedCache._lock", "MemorySizedCache._lock"):
        "_partition()/_requota_locked() call part.resize()/evict hooks on "
        "the per-tenant MemorySizedCache while holding the partition-map "
        "lock; the inner cache never calls back out, so the order is "
        "acyclic by construction",
    ("Autoscaler._lock", "WorkerPool._lock"):
        "Autoscaler.tick() holds its reconcile lock across "
        "pool.size()/add_worker()/remove_worker()/snapshot(); WorkerPool "
        "methods never call back into the autoscaler, so the order is "
        "acyclic by construction",
    ("Autoscaler._lock", "OverloadController._lock"):
        "Autoscaler.tick()'s scale-down calm check reads "
        "overload.severity() under the reconcile lock; the controller is "
        "a leaf (pure EWMA state), so the order is acyclic",
    ("SearchService._lock", "WorkerPool._lock"):
        "SearcherContext.offload_dispatcher() lazily builds the pool and "
        "registers endpoint workers (pool.add_worker) under the context "
        "lock; the pool never re-enters the service, so the order is "
        "acyclic",
    # this package only: the JAX package has no per-split staging lock
    ("SplitColumns.staging_lock", "ResidentColumnStore._lock"):
        "leaf.warmup_device_arrays() stages a split's missing arrays under "
        "its owner's staging lock, and _stage_missing() records the upload "
        "with store.note_upload(), which takes the store lock; the store "
        "never takes a staging lock, so the order is acyclic",
}


def static_lock_graph(root: Optional[str] = None
                      ) -> dict[tuple[str, str], list[dict]]:
    """QW007's full static acquisition graph (suppressed edges included)
    over quickwit_tpu_torch/."""
    root = root or _REPO_ROOT
    package = os.path.join(root, "quickwit_tpu_torch")
    rule = LockOrder()
    shared: dict = {}
    for path in _iter_py_files(package):
        relpath = os.path.relpath(os.path.abspath(path), root)
        try:
            with open(path, "r", encoding="utf-8") as fh:
                ctx = FileContext(path, relpath, fh.read(), shared=shared)
        except LintError:
            continue
        rule.check(ctx)
    return shared.get(_QW007_ALL_SHARED, {})


def statically_identifiable(name: str) -> bool:
    """True when QW007's lock-identity regex would name this lock — the
    precondition for holding the static graph accountable for it."""
    if not name or name.startswith("<anon:"):
        return False
    return bool(_LOCK_NAME_RE.search(name.rsplit(".", 1)[-1]))


def compare(witness_edges: dict[tuple[str, str], str],
            static_edges: Optional[dict[tuple[str, str], list]] = None,
            declared: Optional[dict[tuple[str, str], str]] = None
            ) -> dict[str, Any]:
    """Cross-check the runtime witness graph against the static graph.

    Returns {"conforms", "gaps", "anonymous", "declared_used",
    "unwitnessed"}; `conforms` is False iff a statically-identifiable
    runtime edge is in neither the static graph nor DECLARED_EDGES."""
    if static_edges is None:
        static_edges = static_lock_graph()
    if declared is None:
        declared = DECLARED_EDGES
    gaps: list[dict] = []
    anonymous: list[dict] = []
    declared_used: list[dict] = []
    for (held, acquired), site in sorted(witness_edges.items()):
        entry = {"held": held, "acquired": acquired, "site": site}
        if not (statically_identifiable(held)
                and statically_identifiable(acquired)):
            anonymous.append(entry)
            continue
        if (held, acquired) in static_edges:
            continue
        if (held, acquired) in declared:
            declared_used.append(
                dict(entry, why=declared[(held, acquired)]))
            continue
        gaps.append(entry)
    witnessed = set(witness_edges)
    unwitnessed = [{"held": h, "acquired": a,
                    "sites": len(static_edges[(h, a)])}
                   for (h, a) in sorted(static_edges)
                   if (h, a) not in witnessed]
    return {
        "conforms": not gaps,
        "gaps": gaps,
        "anonymous": anonymous,
        "declared_used": declared_used,
        "unwitnessed": unwitnessed,
        "witnessed": len(witness_edges),
        "static_edges": len(static_edges),
    }
