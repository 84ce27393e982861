"""Elastic leaf-search offload pool.

The reference fork runs leaf search on an elastic fleet of serverless
workers (`quickwit-lambda-*`); this package is that shape for a pod-scale
deployment: a dynamic `WorkerPool` with passive health tracking, an
`OffloadDispatcher` doing rendezvous-affine placement with deadline-
budgeted retry, hedging and work stealing, and an `Autoscaler` deriving
pool size from the tenancy overload signal plus queue depth.

`search/service.py` routes the cold-split tail of oversized leaf requests
through here; with no pool configured the subsystem is never imported.
Counterpart of the JAX package's `offload/`: each worker runs its share of
the splits on its own device, and what no worker serves runs on the
offloading node's device.
"""

from .autoscaler import Autoscaler, InProcessWorkerLauncher, WorkerLauncher
from .dispatcher import (
    OffloadDispatcher, OffloadOutcome, typed_backpressure_of,
)
from .pool import EJECTED, HEALTHY, SUSPECT, WorkerPool

__all__ = [
    "Autoscaler", "EJECTED", "HEALTHY", "InProcessWorkerLauncher",
    "OffloadDispatcher", "OffloadOutcome", "SUSPECT", "WorkerLauncher",
    "WorkerPool", "typed_backpressure_of",
]
