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

`score_topk_lanes` is the lane axis: Q posting lists (a stacked query
group's lanes, each with its own ids, tfs, norms and scalars) in ONE launch
of the lane kernel, returning [Q, k] values and indices; row q equals
`score_topk` over lane q bit for bit (the two kernels share one block
body). Its plain version, `score_topk_lanes_reference`, loops
`score_topk_reference` over the lanes. `score_topk_lanes.launches` counts
its launches (one per call of at most MAX_LANES lanes).

Each kernel's workspace (per list: its arrival ticket, candidate count and
shared threshold; then the candidates) is made once per (device, stream)
and reused: the kernels leave their state at 0, so calls and CUDA-graph
replays need no reset, and two streams never share one. A stream must have
made one call of a kernel before a CUDA graph captures that kernel on it.
The workspace dicts are guarded by a lock: the query batcher launches from
several threads.

Contract: winners with a finite value and their posting indices are exact.
Lanes past the number of valid postings hold -inf and an unspecified
in-range posting index.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import build
from ..bm25 import B, K1, score_postings
from ..topk import exact_topk

MAX_K = 64
MAX_LANES = 16     # the lane kernel's table: QueryBatcher(max_batch=16)
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
        lib.qw_score_topk_lanes_grid_limit.argtypes = [i32,
                                                       ctypes.POINTER(i32)]
        lib.qw_score_topk_lanes_grid_limit.restype = i32
        lib.qw_score_topk_lanes.argtypes = [vp, i32, i32, i32, vp, vp, vp,
                                            vp]
        lib.qw_score_topk_lanes.restype = i32
        lib._qw_typed = True
    return lib


# (kernel, device index) -> persistent grid size for (k <= 32, k <= 64)
_GRID_LIMITS: dict[tuple[str, int], tuple[int, int]] = {}
# (kernel, device index, stream handle) -> the kernel's grid states and
# candidates
_WORKSPACES: dict[tuple[str, int, int], torch.Tensor] = {}
_LOCK = threading.Lock()   # guards the two dicts above


def _grid_limits(query, kernel: str, dev: torch.device) -> tuple[int, int]:
    with _LOCK:
        limits = _GRID_LIMITS.get((kernel, dev.index))
        if limits is None:
            out = ctypes.c_int()
            found = []
            for k in (1, MAX_K):   # one kernel variant each
                err = query(k, ctypes.byref(out))
                if err:
                    raise build.KernelError(
                        f"{kernel}: occupancy query failed: CUDA error {err}")
                found.append(out.value)
            limits = _GRID_LIMITS[(kernel, dev.index)] = (found[0], found[1])
        return limits


def _workspace(kernel: str, dev: torch.device, stream: int,
               words: int) -> torch.Tensor:
    """The kernel's workspace on (device, stream), zeroed at its creation:
    the kernel leaves every grid state at 0 after a launch."""
    with _LOCK:
        workspace = _WORKSPACES.get((kernel, dev.index, stream))
        if workspace is None:
            if torch.cuda.is_current_stream_capturing():
                raise build.KernelError(
                    f"{kernel}: its workspace is made on a stream's first "
                    "call; call it once on this stream before capturing a "
                    "CUDA graph")
            workspace = torch.zeros(words, dtype=torch.int32, device=dev)
            _WORKSPACES[(kernel, dev.index, stream)] = workspace
        return workspace


def _launch(ids, tfs, fieldnorms, idf, avg_len, num_docs: int, k: int):
    lib = _library()
    dev = ids.device
    limits = _grid_limits(lib.qw_score_topk_grid_limit, "score_topk", dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    workspace = _workspace("score_topk", dev, stream,
                           _STATE_WORDS + 2 * max(limits) * MAX_K)
    out_vals = torch.empty(k, dtype=torch.float32, device=dev)
    out_idx = torch.empty(k, dtype=torch.int64, device=dev)
    err = lib.qw_score_topk(
        ids.data_ptr(), tfs.data_ptr(), fieldnorms.data_ptr(), ids.shape[0],
        fieldnorms.shape[0], min(num_docs, _INT32_MAX),
        *_host_scalars(idf, avg_len), k, limits[k > 32],
        workspace.data_ptr(), out_vals.data_ptr(), out_idx.data_ptr(), stream)
    if err:
        raise build.KernelError(
            f"score_topk launch failed: CUDA error {err}")
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


# --- the lane axis ------------------------------------------------------------

class _Lane(ctypes.Structure):
    """One lane of the lane kernel's table (`Lane` in csrc/score_topk.cu,
    64 bytes)."""
    _fields_ = [("ids", ctypes.c_void_p), ("tfs", ctypes.c_void_p),
                ("norms", ctypes.c_void_p), ("num_norms", ctypes.c_int64),
                ("num_postings", ctypes.c_int), ("num_docs", ctypes.c_int),
                ("weight", ctypes.c_float), ("avg_clamped", ctypes.c_float),
                ("k1", ctypes.c_float), ("b", ctypes.c_float),
                ("one_minus_b", ctypes.c_float), ("eps", ctypes.c_float)]


assert ctypes.sizeof(_Lane) == 64


def score_topk_lanes_reference(lanes, k: int):
    """Plain torch version of `score_topk_lanes`: `score_topk_reference`
    over each lane, stacked. Returns (f32 values [Q, k], int64 posting
    indices [Q, k])."""
    outs = [score_topk_reference(ids, tfs, norms, idf, avg_len, int(nd), k)
            for ids, tfs, norms, idf, avg_len, nd in lanes]
    return (torch.stack([v for v, _ in outs]),
            torch.stack([i for _, i in outs]))


def _launch_lanes(lanes, k: int):
    lib = _library()
    dev = lanes[0][0].device
    limits = _grid_limits(lib.qw_score_topk_lanes_grid_limit,
                          "score_topk_lanes", dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    workspace = _workspace("score_topk_lanes", dev, stream,
                           _STATE_WORDS * MAX_LANES + 2 * max(limits) * MAX_K)
    table = (_Lane * len(lanes))()
    for entry, (ids, tfs, norms, idf, avg_len, num_docs) in zip(table, lanes):
        entry.ids, entry.tfs, entry.norms = (ids.data_ptr(), tfs.data_ptr(),
                                             norms.data_ptr())
        entry.num_norms = norms.shape[0]
        entry.num_postings = ids.shape[0]
        entry.num_docs = min(int(num_docs), _INT32_MAX)
        (entry.weight, entry.avg_clamped, entry.k1, entry.b,
         entry.one_minus_b, entry.eps) = _host_scalars(idf, avg_len)
    out_vals = torch.empty((len(lanes), k), dtype=torch.float32, device=dev)
    out_idx = torch.empty((len(lanes), k), dtype=torch.int64, device=dev)
    err = lib.qw_score_topk_lanes(
        ctypes.addressof(table), len(lanes), k, limits[k > 32],
        workspace.data_ptr(), out_vals.data_ptr(), out_idx.data_ptr(), stream)
    if err:
        raise build.KernelError(
            f"score_topk_lanes launch failed: CUDA error {err}")
    score_topk_lanes.launches += 1
    return out_vals, out_idx


def score_topk_lanes(lanes, k: int):
    """Top-k BM25 of each lane in ONE launch: (f32 values [Q, k], int64
    posting indices [Q, k]), row q equal to `score_topk(*lanes[q], k)`.
    `lanes` is a sequence of 1..MAX_LANES tuples (ids, tfs, fieldnorms,
    idf, avg_len, num_docs) as `score_topk` takes them; lanes may differ in
    length and lie on one device. CUDA tensors launch the lane kernel; CPU
    tensors run the plain version."""
    if not 1 <= len(lanes) <= MAX_LANES:
        raise ValueError(f"score_topk_lanes: needs 1..{MAX_LANES} lanes, "
                         f"got {len(lanes)}")
    dev = lanes[0][0].device
    for ids, tfs, norms, *_ in lanes:
        _check(ids, tfs, norms, k)
        if ids.device != dev:
            raise ValueError("score_topk_lanes: lanes on different devices")
    if dev.type == "cpu":
        return score_topk_lanes_reference(lanes, k)
    if dev.type != "cuda":
        raise ValueError(f"score_topk_lanes: no kernel for device {dev}")
    if torch.cuda.current_device() != dev.index:
        with torch.cuda.device(dev):
            return _launch_lanes(lanes, k)
    return _launch_lanes(lanes, k)


score_topk_lanes.launches = 0
