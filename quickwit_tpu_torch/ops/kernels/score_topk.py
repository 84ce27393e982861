"""Fused BM25 score + top-k over one term's postings: the CUDA kernel and its
plain torch version.

Counterpart of the JAX package's Pallas kernel
`quickwit_tpu/ops/pallas/score_topk.py` (`_kernel` / `fused_score_topk`).
The kernel (`csrc/score_topk.cu`) computes the same function, not the same
layout: the gather of each posting's field norm is fused into the kernel
(the JAX wrapper materializes a [P] gathered-norms array first), pass 1
takes the top-k of each 4096-posting tile, and pass 2 merges the tile
winners, both by "higher value first, then lower posting index".

`score_topk` launches the kernel for CUDA tensors and calls
`score_topk_reference` for CPU tensors; for a CUDA tensor there is no
fallback. `score_topk.launches` counts kernel launches (two per call).

Contract: winners with a finite value and their posting indices are exact.
Lanes past the number of valid postings hold -inf and an unspecified
in-range posting index.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..bm25 import B, K1, score_postings
from ..topk import exact_topk

MAX_K = 64
_INT32_MAX = 2**31 - 1


def _host_scalars(idf, avg_len) -> tuple[float, float, float, float, float,
                                         float]:
    """The kernel's f32 constants, rounded on the host exactly as the JAX
    program rounds them: weight = f32(idf) * f32(K1 + 1), max(avg_len,
    1e-9), K1, B, 1 - B and the 1e-9 floor."""
    f32 = np.float32
    weight = (f32(1.0) * f32(idf)) * f32(K1 + 1.0)
    avg = np.maximum(f32(avg_len), f32(1e-9))
    return (float(weight), float(avg), float(f32(K1)), float(f32(B)),
            float(f32(1.0 - B)), float(f32(1e-9)))


def score_topk_reference(ids: torch.Tensor, tfs: torch.Tensor,
                         fieldnorms: torch.Tensor, idf, avg_len,
                         num_docs: int, k: int):
    """Plain torch version: `score_postings` → keys (f64 scores of valid
    postings, -inf elsewhere) → `exact_topk`. Returns (f32 values [k],
    int64 posting indices [k])."""
    scores = score_postings(tfs, ids, fieldnorms, avg_len, idf)
    valid = (tfs > 0) & (ids < num_docs)
    keyed = torch.where(valid, scores.to(torch.float64), float("-inf"))
    num_postings = keyed.shape[0]
    if num_postings < k:   # the kernel returns k lanes for any P >= 1
        keyed = torch.cat([keyed, keyed.new_full((k - num_postings,),
                                                 float("-inf"))])
    vals, pos = exact_topk(keyed, k)
    return vals.to(torch.float32), pos.clamp_max(num_postings - 1)


def _check(ids, tfs, fieldnorms, k) -> None:
    for name, t in (("ids", ids), ("tfs", tfs), ("fieldnorms", fieldnorms)):
        if t.dtype != torch.int32:
            raise TypeError(f"score_topk: {name} must be int32, got {t.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"score_topk: {name} must be a contiguous 1-D "
                             "tensor")
        if t.device != ids.device:
            raise ValueError("score_topk: ids, tfs and fieldnorms must be on "
                             "one device")
    if tfs.shape != ids.shape:
        raise ValueError("score_topk: ids and tfs differ in length")
    if not 1 <= ids.shape[0] < _INT32_MAX:
        raise ValueError(f"score_topk: needs 1 <= P < 2^31 - 1 postings, got "
                         f"{ids.shape[0]}")
    if fieldnorms.shape[0] < 1:
        raise ValueError("score_topk: fieldnorms is empty")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"score_topk: needs 1 <= k <= {MAX_K}, got {k}")


def _library():
    from . import build
    lib = build.load("score_topk")
    if not getattr(lib, "_qw_typed", False):
        vp, i64, f32, i32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_float,
                             ctypes.c_int)
        lib.qw_score_topk_tile_size.argtypes = []
        lib.qw_score_topk_tile_size.restype = i32
        lib.qw_score_topk_tiles.argtypes = [vp, vp, vp, i64, i64, i32,
                                            f32, f32, f32, f32, f32, f32,
                                            i32, vp, vp, vp]
        lib.qw_score_topk_tiles.restype = i32
        lib.qw_score_topk_merge.argtypes = [vp, vp, i64, i64, i32, vp, vp, vp]
        lib.qw_score_topk_merge.restype = i32
        lib._qw_typed = True
    return lib


def score_topk(ids: torch.Tensor, tfs: torch.Tensor, fieldnorms: torch.Tensor,
               idf, avg_len, num_docs: int, k: int):
    """Top-k BM25 (f32 values [k], int64 posting indices [k]) over a
    padded posting list. `fieldnorms` is the dense per-doc norm column;
    `idf`, `avg_len` (f32) and `num_docs` (exact int) are host scalars.
    CUDA tensors launch the kernel; CPU tensors run the plain version."""
    _check(ids, tfs, fieldnorms, k)
    num_docs = int(num_docs)
    if ids.device.type == "cpu":
        return score_topk_reference(ids, tfs, fieldnorms, idf, avg_len,
                                    num_docs, k)
    if ids.device.type != "cuda":
        raise ValueError(f"score_topk: no kernel for device {ids.device}")
    lib = _library()
    num_postings = ids.shape[0]
    tile = lib.qw_score_topk_tile_size()
    grid = (num_postings + tile - 1) // tile
    dev = ids.device
    cand_vals = torch.empty(grid * k, dtype=torch.float32, device=dev)
    cand_idx = torch.empty(grid * k, dtype=torch.int32, device=dev)
    out_vals = torch.empty(k, dtype=torch.float32, device=dev)
    out_idx = torch.empty(k, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.qw_score_topk_tiles(
            ids.data_ptr(), tfs.data_ptr(), fieldnorms.data_ptr(),
            num_postings, fieldnorms.shape[0], min(num_docs, _INT32_MAX),
            *_host_scalars(idf, avg_len), k,
            cand_vals.data_ptr(), cand_idx.data_ptr(), stream)
        if err:
            raise RuntimeError(f"score_topk_tiles launch failed: CUDA error "
                               f"{err}")
        score_topk.launches += 1
        err = lib.qw_score_topk_merge(
            cand_vals.data_ptr(), cand_idx.data_ptr(), grid * k,
            num_postings, k, out_vals.data_ptr(), out_idx.data_ptr(), stream)
        if err:
            raise RuntimeError(f"score_topk_merge launch failed: CUDA error "
                               f"{err}")
        score_topk.launches += 1
    return out_vals, out_idx


score_topk.launches = 0
