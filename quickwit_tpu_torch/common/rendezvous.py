"""Rendezvous (highest-random-weight) hashing.

Role of the reference's `quickwit-common/src/rendezvous_hasher.rs`: stable
assignment of a key (split id) to a preference-ordered list of nodes, so that
the same split is searched by the same node across queries (cache affinity)
and reassignment on membership change is minimal.
"""

from __future__ import annotations

import hashlib
from typing import Iterable, TypeVar

T = TypeVar("T")


def _weight(key: str, node: str) -> int:
    h = hashlib.blake2b(f"{key}\x00{node}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little")


def sort_by_rendezvous_hash(key: str, nodes: Iterable[str]) -> list[str]:
    """Nodes sorted by descending affinity for `key` (ties by node id)."""
    return sorted(nodes, key=lambda node: (-_weight(key, node), node))
