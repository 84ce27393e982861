"""The audited host-side decode seam for post-readback data.

qwlint's QW001 (hidden-host-readback) bans bare ``int()`` / ``float()`` /
``np.asarray()`` in hot-path modules because each call is a *potential*
device→host sync. But data that has already crossed the packed readback
seam (``executor.readback_plan_result`` performs ONE batched
``device_get``) or arrived deserialized off the wire at the root merge is
host numpy by contract — converting it costs nothing and syncs nothing.

These helpers make that contract explicit: hot-path modules convert
post-readback / wire-state scalars and arrays through here instead of the
bare builtins, so every bare conversion remaining in a hot-path file is a
real finding (a hidden sync to fix or justify), not noise drowning the
signal.

Callers MUST NOT pass live ``jax.Array`` values — that would hide the very
sync QW001 exists to catch. Only post-readback results, intermediate agg
states, and wire-deserialized payloads belong here.
"""

from __future__ import annotations

import numpy as np


def host_int(value) -> int:
    """``int()`` of a post-readback / wire host scalar."""
    # qwlint: disable-next-line=QW001 - host numpy by the module contract
    return int(value)


def host_float(value) -> float:
    """``float()`` of a post-readback / wire host scalar."""
    # qwlint: disable-next-line=QW001 - host numpy by the module contract
    return float(value)


def host_array(value) -> np.ndarray:
    """``np.asarray()`` of post-readback / wire host data."""
    # qwlint: disable-next-line=QW001 - host numpy by the module contract
    return np.asarray(value)


def host_list(value) -> list:
    """Bulk-decode a post-readback host array to Python scalars in one
    call — per-element ``int()``/``float()`` loops over readback arrays
    become plain list indexing (the ``.tolist()`` pre-decode pattern)."""
    return value.tolist() if hasattr(value, "tolist") else list(value)
