"""quickwit_tpu_torch: the PyTorch/CUDA port of `quickwit_tpu`.

The JAX package beside it is the reference. This package imports neither
JAX nor anything of `quickwit_tpu`: host-only modules are carried over as
copies, device code is rewritten in torch, and the TPU's Pallas kernel is
a hand-written CUDA kernel for Hopper (`csrc/`, built at first use).

Layout mirrors the reference package, so `quickwit_tpu_torch/search/leaf.py`
is the counterpart of `quickwit_tpu/search/leaf.py`. What is ported so far
is the full single-split leaf search: the posting-space program (the CUDA
`score_topk` kernel for scored top-k), the doc-space program (Bool and
range roots, search_after, two-key sorts, threshold pushdown, predicate
masks), every aggregation, phrase and phrase-prefix queries, the split
writer and generators, split pruning, and every storage backend (RAM,
local files, S3, GCS, Azure, with their wrappers and the disk split cache);
above the leaf, the node's search service and the root; and the write
path: the WAL ingest (`ingest/`), the indexing pipeline and its sources
(`indexing/`), the array-level merge (`index/merge_arrays.py`), the
compactor (`compaction/`) and the janitor (`janitor/`, whose delete
planner probes splits on the device).

Device entry points take `device=None`, which means `cuda`: a call that
does not name the CPU raises when no GPU is present, it never falls back.
Every f64/i64 tensor is created with an explicit dtype; torch's default
dtype is never changed.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names
    another. Raises when the GPU it would run on is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "quickwit_tpu_torch runs on the GPU by default and none is "
                "available; pass device='cpu' to run the plain torch path")
        if dev.index is None:   # one name per card for the staging cache
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
