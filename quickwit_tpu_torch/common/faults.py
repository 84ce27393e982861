"""Seeded, deterministic fault injection for the search path.

Role of chaos harnesses around the reference engine (S3 tail latency, node
loss, slow peers): every robustness claim in `search/root.py` /
`search/service.py` is only as good as the failures it has actually been
driven through. `FaultInjector` perturbs named operations — storage reads,
the root's metastore reads and leaf-search RPCs, the cache tiers'
corruption and eviction points, resident-column eviction — with latency
spikes, typed errors, and bounded hangs, from a plan keyed by `(seed,
operation, occurrence)`.

Determinism contract: the decision for the Nth occurrence of operation `op`
is a pure function of `(seed, op, N)` (derived via blake2b, NOT the salted
builtin `hash()`), so two runs that issue the same per-operation call
sequences see the same failure schedule regardless of thread interleaving
across *different* operations. `schedule()` exposes the fired decisions for
cross-run equality asserts in the chaos suite.
"""

from __future__ import annotations

import hashlib
import random
import threading
from dataclasses import asdict, dataclass, field
from typing import Optional

from ..storage.base import Storage, StorageError
from .clock import get_clock

FAULT_ERROR_MARK = "injected fault"


class InjectedFault(RuntimeError):
    """Typed error raised by an `error`-kind fault rule."""


@dataclass(frozen=True)
class FaultRule:
    """One perturbation: which operations, what kind, how often.

    `operation` matches exactly, or by prefix when it ends with `*`
    (e.g. ``"storage.*"``). `every=N` fires on every Nth occurrence
    (1-based); `probability` fires pseudo-randomly per occurrence; when both
    are set, `every` gates first and `probability` refines. `max_fires`
    bounds total activations (0 = unlimited).
    """

    operation: str
    kind: str  # "latency" | "error" | "hang"
    every: int = 1
    probability: float = 1.0
    latency_secs: float = 0.05
    hang_secs: float = 2.0
    error_message: str = FAULT_ERROR_MARK
    max_fires: int = 0

    def __post_init__(self):
        if self.kind not in ("latency", "error", "hang"):
            raise ValueError(f"unknown fault kind: {self.kind!r}")

    def matches(self, operation: str) -> bool:
        if self.operation.endswith("*"):
            return operation.startswith(self.operation[:-1])
        return operation == self.operation


@dataclass
class FaultDecision:
    operation: str
    occurrence: int  # 1-based, per operation
    rule_index: int
    kind: str


class FaultInjector:
    """Deterministic perturbation engine shared by the wrappers below.

    Thread-safe: per-operation occurrence counters are taken under a lock;
    the decision itself is derived from `(seed, rule, op, occurrence)` only,
    never from global RNG state, so concurrency cannot reorder decisions
    within one operation stream.
    """

    def __init__(self, seed: int, rules: list[FaultRule]):
        self.seed = seed
        self.rules = list(rules)
        # qwlint: disable-next-line=QW008 - fault-injector leaf lock; pure
        # dict/counter ops inside, never a seam primitive
        self._lock = threading.Lock()
        self._occurrences: dict[str, int] = {}
        self._fires_per_rule: list[int] = [0] * len(self.rules)
        self._fired: list[FaultDecision] = []

    def _roll(self, rule_index: int, operation: str, occurrence: int) -> float:
        digest = hashlib.blake2b(
            f"{self.seed}:{rule_index}:{operation}:{occurrence}".encode(),
            digest_size=8).digest()
        return random.Random(int.from_bytes(digest, "big")).random()

    def perturb(self, operation: str) -> None:
        """Apply every matching, firing rule to this occurrence of
        `operation`: sleep for latency/hang kinds, raise for error kinds
        (latency rules are applied before an error rule raises)."""
        with self._lock:
            occurrence = self._occurrences.get(operation, 0) + 1
            self._occurrences[operation] = occurrence
            firing: list[tuple[int, FaultRule]] = []
            for rule_index, rule in enumerate(self.rules):
                if not rule.matches(operation):
                    continue
                if rule.max_fires and self._fires_per_rule[rule_index] >= rule.max_fires:
                    continue
                if rule.every > 1 and occurrence % rule.every != 0:
                    continue
                if rule.probability < 1.0 and (
                        self._roll(rule_index, operation, occurrence)
                        >= rule.probability):
                    continue
                self._fires_per_rule[rule_index] += 1
                self._fired.append(FaultDecision(
                    operation=operation, occurrence=occurrence,
                    rule_index=rule_index, kind=rule.kind))
                firing.append((rule_index, rule))
        for _, rule in firing:
            # fleet-visible audit of what the chaos plan actually did: a
            # soak run's failure counts can be cross-checked against the
            # faults that were really injected
            from ..observability.metrics import FAULTS_INJECTED_TOTAL
            FAULTS_INJECTED_TOTAL.inc(op=operation, kind=rule.kind)
        error: Optional[InjectedFault] = None
        for rule_index, rule in firing:
            # sleeps route through the process clock so the DST harness's
            # virtual clock absorbs them instantly (simulated latency, no
            # wall time) while production/chaos runs really stall
            if rule.kind == "latency":
                get_clock().sleep(rule.latency_secs)
            elif rule.kind == "hang":
                # A bounded stall: long enough that only deadline-aware
                # callers survive it, short enough that test runs terminate.
                get_clock().sleep(rule.hang_secs)
            elif error is None:
                error = InjectedFault(
                    f"{rule.error_message} (op={operation}, n={occurrence})")
        if error is not None:
            raise error

    def occurrences(self, operation: str) -> int:
        with self._lock:
            return self._occurrences.get(operation, 0)

    def to_plan(self) -> dict:
        """Serialize the full injector state — seed, rule set, per-operation
        occurrence cursors, per-rule fire counts — as a JSON-safe dict (the
        `faults` section of a DST replay artifact). `from_plan` restores an
        injector that continues the decision stream exactly where this one
        stands: decisions are pure functions of `(seed, rule, op, occurrence)`,
        so state is nothing but the cursors."""
        with self._lock:
            return {
                "seed": self.seed,
                "rules": [asdict(rule) for rule in self.rules],
                "occurrences": dict(sorted(self._occurrences.items())),
                "fires_per_rule": list(self._fires_per_rule),
            }

    @classmethod
    def from_plan(cls, plan: dict) -> "FaultInjector":
        """Rebuild an injector from `to_plan()` output. A fresh plan (cursors
        all zero) reproduces the original run's schedule from the start; a
        mid-run plan resumes it."""
        injector = cls(
            seed=int(plan["seed"]),
            rules=[FaultRule(**rule) for rule in plan.get("rules", [])])
        with injector._lock:
            injector._occurrences = {
                str(op): int(count)
                for op, count in plan.get("occurrences", {}).items()}
            fires = plan.get("fires_per_rule")
            if fires is not None:
                if len(fires) != len(injector.rules):
                    raise ValueError(
                        "fires_per_rule length does not match rule count")
                injector._fires_per_rule = [int(n) for n in fires]
        return injector

    def schedule(self) -> dict[str, list[tuple[int, int, str]]]:
        """Fired decisions keyed by operation, ordered by occurrence:
        `{op: [(occurrence, rule_index, kind), ...]}`. Two runs with the same
        seed and the same per-operation call sequences produce equal
        schedules — the chaos suite asserts exactly this."""
        with self._lock:
            out: dict[str, list[tuple[int, int, str]]] = {}
            for decision in self._fired:
                out.setdefault(decision.operation, []).append(
                    (decision.occurrence, decision.rule_index, decision.kind))
        for decisions in out.values():
            decisions.sort()
        return out


# --- wrappers -------------------------------------------------------------


class FaultyStorage(Storage):
    """Delegating storage wrapper that perturbs the read path.

    Error-kind faults surface as retryable `StorageError`s so the hedging /
    retry machinery in `storage/wrappers.py` is what gets exercised, exactly
    as with a flaky object store.
    """

    def __init__(self, inner: Storage, injector: FaultInjector,
                 op_prefix: str = "storage"):
        super().__init__(inner.uri)
        self._inner = inner
        self._injector = injector
        self._op_prefix = op_prefix

    def _perturb(self, method: str) -> None:
        try:
            self._injector.perturb(f"{self._op_prefix}.{method}")
        except InjectedFault as exc:
            raise StorageError(str(exc), kind="internal") from exc

    def get_slice(self, path: str, start: int, end: int) -> bytes:
        self._perturb("get_slice")
        return self._inner.get_slice(path, start, end)

    def get_all(self, path: str) -> bytes:
        self._perturb("get_all")
        return self._inner.get_all(path)

    def file_num_bytes(self, path: str) -> int:
        self._perturb("file_num_bytes")
        return self._inner.file_num_bytes(path)

    # mutations and listing pass through unperturbed: the chaos suite targets
    # the search read path, and a faulty put would corrupt fixture setup
    def put(self, path: str, payload: bytes) -> None:
        self._inner.put(path, payload)

    def delete(self, path: str) -> None:
        self._inner.delete(path)

    def bulk_delete(self, paths) -> None:
        self._inner.bulk_delete(paths)

    def list_files(self) -> list[str]:
        return self._inner.list_files()


class FaultyStorageResolver:
    """Resolver shim: wraps every resolved storage in `FaultyStorage` so a
    `SearcherContext` built on it sees injected faults on all split reads."""

    def __init__(self, inner, injector: FaultInjector,
                 op_prefix: str = "storage"):
        self._inner = inner
        self._injector = injector
        self._op_prefix = op_prefix

    def resolve(self, uri) -> Storage:
        return FaultyStorage(self._inner.resolve(uri), self._injector,
                             op_prefix=self._op_prefix)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class FaultyMetastore:
    """Metastore wrapper perturbing the root's plan-time reads
    (``metastore.list_splits``, ``metastore.index_metadata``).

    Error-kind faults surface as `MetastoreError` (kind="internal") — the
    typed failure the root's planning path owns; latency/hang faults model a
    slow metastore backend, which the root must absorb into its deadline and
    still answer with a typed partial response. Mutations pass through
    unperturbed (a faulty publish would corrupt fixture setup)."""

    def __init__(self, inner, injector: FaultInjector,
                 op_prefix: str = "metastore"):
        self._inner = inner
        self._injector = injector
        self._op_prefix = op_prefix

    def _perturb(self, method: str) -> None:
        from ..metastore.base import MetastoreError
        try:
            self._injector.perturb(f"{self._op_prefix}.{method}")
        except InjectedFault as exc:
            raise MetastoreError(str(exc), kind="internal") from exc

    def list_splits(self, query):
        self._perturb("list_splits")
        return self._inner.list_splits(query)

    def index_metadata(self, index_id: str):
        self._perturb("index_metadata")
        return self._inner.index_metadata(index_id)

    def list_indexes(self):
        self._perturb("list_indexes")
        return self._inner.list_indexes()

    def __getattr__(self, name):
        return getattr(self._inner, name)


class FaultyClient:
    """Leaf-search client wrapper perturbing RPCs to one node.

    Operations are namespaced per node (``client.leaf_search@node-1``) so a
    rule can fail one replica while its peers stay healthy — the shape of
    real node loss."""

    def __init__(self, inner, injector: FaultInjector, node_id: str):
        self._inner = inner
        self._injector = injector
        self.node_id = node_id

    def leaf_search(self, request):
        self._injector.perturb(f"client.leaf_search@{self.node_id}")
        return self._inner.leaf_search(request)

    def fetch_docs(self, request):
        self._injector.perturb(f"client.fetch_docs@{self.node_id}")
        return self._inner.fetch_docs(request)

    def __getattr__(self, name):
        return getattr(self._inner, name)
