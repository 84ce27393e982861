"""Fused BM25 score + top-k over one term's postings: the CUDA kernel and its
plain torch version.

Counterpart of the JAX package's Pallas kernel
`quickwit_tpu/ops/pallas/score_topk.py` (`_kernel` / `fused_score_topk`).
The kernel (`csrc/score_topk.cu`) computes the same function, not the same
layout: the gather of each posting's field norm is fused into the kernel
(the JAX wrapper materializes a [P] gathered-norms array first), and one
launch of a persistent grid scores, selects each block's top-k and merges
the blocks' winners, all by "higher value first, then lower posting index".

`score_topk` launches the kernel for CUDA tensors and calls
`score_topk_reference` for CPU tensors; for a CUDA tensor there is no
fallback. `score_topk.launches` counts kernel launches (one per call).

The kernel's workspace (its arrival ticket, candidate count and shared
threshold, then the candidates) is made once per (device, stream) and
reused: the kernel leaves its state at 0, so calls and CUDA-graph replays
need no reset, and two streams never share one. A stream must have made
one call before a CUDA graph captures on it.

Contract: winners with a finite value and their posting indices are exact.
Lanes past the number of valid postings hold -inf and an unspecified
in-range posting index.
"""

from __future__ import annotations

import ctypes

import torch

from ..bm25 import B, K1, score_postings
from ..topk import exact_topk

MAX_K = 64
_INT32_MAX = 2**31 - 1
# posting indices (and a tile's end past the last one) stay below INT32_MAX
_MAX_POSTINGS = _INT32_MAX - 4096
_STATE_WORDS = 4   # the kernel's 16-byte grid state, before the candidates


def _f32(x) -> float:
    """`x` rounded to the nearest f32 (ties to even), as a Python float."""
    return ctypes.c_float(float(x)).value


_K1, _B, _ONE_MINUS_B = _f32(K1), _f32(B), _f32(1.0 - B)
_EPS = _f32(1e-9)
_K1_PLUS_1 = _f32(K1 + 1.0)


def _host_scalars(idf, avg_len) -> tuple[float, float, float, float, float,
                                         float]:
    """The kernel's f32 constants, rounded on the host exactly as the JAX
    program rounds them: weight = f32(idf) * f32(K1 + 1), max(avg_len,
    1e-9), K1, B, 1 - B and the 1e-9 floor. A product of two f32 values is
    exact in f64, so rounding it once to f32 is the f32 product."""
    weight = _f32(_f32(idf) * _K1_PLUS_1)
    avg = _f32(avg_len)
    if avg < _EPS:   # NaN stays NaN, as np.maximum keeps it
        avg = _EPS
    return weight, avg, _K1, _B, _ONE_MINUS_B, _EPS


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
        # the kernel stages 16-byte-aligned runs itself and reads a view's
        # misaligned head element by element; it needs whole elements
        if t.data_ptr() % 4:
            raise ValueError(f"score_topk: {name} is not 4-byte aligned")
    if tfs.shape != ids.shape:
        raise ValueError("score_topk: ids and tfs differ in length")
    if not 1 <= ids.shape[0] <= _MAX_POSTINGS:
        raise ValueError(f"score_topk: needs 1 <= P <= {_MAX_POSTINGS} "
                         f"postings, got {ids.shape[0]}")
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
        lib.qw_score_topk_grid_limit.argtypes = [i32, ctypes.POINTER(i32)]
        lib.qw_score_topk_grid_limit.restype = i32
        lib.qw_score_topk.argtypes = [vp, vp, vp, i32, i64, i32,
                                      f32, f32, f32, f32, f32, f32,
                                      i32, i32, vp, vp, vp, vp]
        lib.qw_score_topk.restype = i32
        lib._qw_typed = True
    return lib


# device index -> persistent grid size for (k <= 32, k <= 64)
_GRID_LIMITS: dict[int, tuple[int, int]] = {}
# (device index, stream handle) -> the kernel's grid state and candidates
_WORKSPACES: dict[tuple[int, int], torch.Tensor] = {}


def _grid_limits(lib, dev: torch.device) -> tuple[int, int]:
    limits = _GRID_LIMITS.get(dev.index)
    if limits is None:
        out = ctypes.c_int()
        found = []
        for k in (1, MAX_K):   # one kernel variant each
            err = lib.qw_score_topk_grid_limit(k, ctypes.byref(out))
            if err:
                raise RuntimeError(f"score_topk: occupancy query failed: "
                                   f"CUDA error {err}")
            found.append(out.value)
        limits = _GRID_LIMITS[dev.index] = (found[0], found[1])
    return limits


def _launch(ids, tfs, fieldnorms, idf, avg_len, num_docs: int, k: int):
    lib = _library()
    dev = ids.device
    limits = _grid_limits(lib, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    workspace = _WORKSPACES.get((dev.index, stream))
    if workspace is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "score_topk: its workspace is made on a stream's first call; "
                "call it once on this stream before capturing a CUDA graph")
        # zeroed once: the kernel leaves its grid state at 0 after a launch
        workspace = torch.zeros(_STATE_WORDS + 2 * max(limits) * MAX_K,
                                dtype=torch.int32, device=dev)
        _WORKSPACES[(dev.index, stream)] = workspace
    out_vals = torch.empty(k, dtype=torch.float32, device=dev)
    out_idx = torch.empty(k, dtype=torch.int64, device=dev)
    err = lib.qw_score_topk(
        ids.data_ptr(), tfs.data_ptr(), fieldnorms.data_ptr(), ids.shape[0],
        fieldnorms.shape[0], min(num_docs, _INT32_MAX),
        *_host_scalars(idf, avg_len), k, limits[k > 32],
        workspace.data_ptr(), out_vals.data_ptr(), out_idx.data_ptr(), stream)
    if err:
        raise RuntimeError(f"score_topk launch failed: CUDA error {err}")
    score_topk.launches += 1
    return out_vals, out_idx


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
    if torch.cuda.current_device() != ids.device.index:
        with torch.cuda.device(ids.device):
            return _launch(ids, tfs, fieldnorms, idf, avg_len, num_docs, k)
    return _launch(ids, tfs, fieldnorms, idf, avg_len, num_docs, k)


score_topk.launches = 0
