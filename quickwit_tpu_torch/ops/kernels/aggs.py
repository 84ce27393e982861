"""One split's bucket aggregation in one pass over its packed columns, by a
CUDA kernel.

Replaces no TPU kernel: the JAX package leaves these reductions to XLA,
which fuses them; PyTorch does not, so `search/executor.py` routes the
aggregation nodes whose state this computes exactly here (see
`csrc/aggs.cu` for what it computes and what bounds it).

`bucket_aggregate` takes CUDA tensors only: the executor's torch path
(`executor._eval_agg_torch`) is its plain version, and the CPU runs that.
There is no fallback, and a launch that fails raises `KernelError`.
`bucket_aggregate.launches` counts kernel launches (one per call).

Contract: integer columns only, with max|value| * docs < 2^53, and
max|value|^2 * docs < 2^53 where `SUM_SQ` is asked for (the caller checks
it from the host-side FOR scalars, `value_bound`). Under it every integer
sum equals the f64 sum of the torch path in any order, so the state is
the torch path's bit for bit and repeats run to run.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import build
from .. import aggs as agg_ops

# what a call keeps: bucket doc counts, then per bucket over the metric
# column's present values their count, sum, sum of squares, minimum,
# maximum and DDSketch
COUNTS, COUNT, SUM, SUM_SQ, MIN, MAX, SKETCH = (1 << i for i in range(7))
STATS = COUNT | SUM | SUM_SQ | MIN | MAX

KINDS = ("none", "terms", "date_histogram")
# lane dtypes the kernel reads, by its enum (csrc/aggs.cu `Dtype`)
LANE_DTYPES = {torch.uint8: 0, torch.uint16: 1, torch.uint32: 2,
               torch.uint64: 3, torch.int8: 4, torch.int16: 5,
               torch.int32: 6, torch.int64: 7}
PRESENT_DTYPES = (torch.uint8, torch.int8, torch.bool)
EXACT_LIMIT = 2 ** 53
_PCTL = agg_ops.PCTL_NUM_BUCKETS
# a sketch bin's flat index, bucket * PCTL_NUM_BUCKETS + bin, is an i32
MAX_BUCKETS = 2**31 // _PCTL
_I64_MAX = (1 << 63) - 1


@dataclass(frozen=True)
class Column:
    """One column as stored: its raw integer lanes, its presence (one byte
    a doc, non-zero where present; None: present everywhere) and its FOR
    frame (scale, min) as i64 bit patterns, the value being `lane * scale
    + min` in wrapping 64-bit arithmetic (None: the lane is the value)."""
    lanes: torch.Tensor
    present: Optional[torch.Tensor] = None
    rebase: Optional[tuple[int, int]] = None


def lane_range(dtype: torch.dtype) -> tuple[int, int]:
    info = torch.iinfo(dtype)
    return int(info.min), int(info.max)


def value_bound(dtype: torch.dtype, frame=None) -> int:
    """max|value| over every lane of `dtype`, `frame` the column's (scale,
    min) as the values they stand for (a u64 frame's true values, not its
    bit patterns), or None for unpacked lanes."""
    lo, hi = lane_range(dtype)
    if frame is None:
        return max(abs(lo), abs(hi))
    scale, fmin = frame
    return max(abs(fmin + scale * lo), abs(fmin + scale * hi))


def _bits(x: int) -> int:
    """`x` as an i64 bit pattern."""
    x &= (1 << 64) - 1
    return x - (1 << 64) if x > _I64_MAX else x


def frame_of(frame) -> Optional[tuple[tuple[int, int], tuple[int, int]]]:
    """(the i64 bit patterns, the values) of a FOR frame's numpy (scale,
    min) scalars; None unless both are i64 or both u64."""
    scale, fmin = (np.asarray(x) for x in frame)
    if scale.dtype != fmin.dtype or scale.dtype not in (np.int64, np.uint64):
        return None
    values = (int(scale), int(fmin))
    return (_bits(values[0]), _bits(values[1])), values


def exact_column(lanes: torch.Tensor, present: Optional[torch.Tensor],
                 frame=None, squares: bool = False) -> Optional[Column]:
    """The `Column` of a metric over `lanes` (with `frame` its FOR (scale,
    min) numpy scalars, or None) where the kernel's state is exact: integer
    lanes, one-byte presence, max|value| * docs < 2^53 and, with
    `squares`, max|value|^2 * docs < 2^53, the bound read from the lanes'
    width and the frame alone. None where one of these fails."""
    if lanes.dtype not in LANE_DTYPES or (
            present is not None and present.dtype not in PRESENT_DTYPES):
        return None
    rebase = values = None
    if frame is not None:
        found = frame_of(frame)
        if found is None:
            return None
        rebase, values = found
    bound = value_bound(lanes.dtype, values)
    docs = max(lanes.shape[0], 1)
    if bound * docs >= EXACT_LIMIT or (
            squares and bound * bound * docs >= EXACT_LIMIT):
        return None
    return Column(lanes, present, rebase)


# --- the kernel ---------------------------------------------------------------

class _ColumnArg(ctypes.Structure):
    """`Column` in csrc/aggs.cu (40 bytes)."""
    _fields_ = [("lanes", ctypes.c_void_p), ("present", ctypes.c_void_p),
                ("scale", ctypes.c_int64), ("min", ctypes.c_int64),
                ("dtype", ctypes.c_int32), ("rebase", ctypes.c_int32)]


_SLOTS = ("sum", "sum_sq", "min", "max", "counts", "count", "sketch")
_SLOT_NEEDS = (SUM, SUM_SQ, MIN, MAX, COUNTS, COUNT, SKETCH)


class _Args(ctypes.Structure):
    """`Args` in csrc/aggs.cu."""
    _fields_ = [("mask", ctypes.c_void_p), ("n", ctypes.c_int64),
                ("bucket", _ColumnArg), ("metric", _ColumnArg),
                ("origin", ctypes.c_int64), ("interval", ctypes.c_int64),
                ("ln_gamma", ctypes.c_double), ("kind", ctypes.c_int32),
                ("narrow", ctypes.c_int32), ("nb", ctypes.c_int32),
                ("needs", ctypes.c_int32), ("has_metric", ctypes.c_int32),
                ("count_f64", ctypes.c_int32), ("acc", ctypes.c_void_p),
                ("offset", ctypes.c_int64 * len(_SLOTS)),
                ("out_counts", ctypes.c_void_p),
                ("out_count", ctypes.c_void_p), ("out_sum", ctypes.c_void_p),
                ("out_sum_sq", ctypes.c_void_p),
                ("out_min", ctypes.c_void_p), ("out_max", ctypes.c_void_p)]


def _library():
    lib = build.load("aggs")
    if not getattr(lib, "_qw_typed", False):
        lib.qw_bucket_aggs_setup.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.qw_bucket_aggs_setup.restype = ctypes.c_int
        lib.qw_bucket_aggs.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_void_p]
        lib.qw_bucket_aggs.restype = ctypes.c_int
        lib._qw_typed = True
    return lib


_NUM_SMS: dict[int, int] = {}    # device index -> SM count, once set up
_LOCK = threading.Lock()


def _num_sms(lib, dev: torch.device) -> int:
    with _LOCK:
        sms = _NUM_SMS.get(dev.index)
        if sms is None:
            out = ctypes.c_int()
            err = lib.qw_bucket_aggs_setup(ctypes.byref(out))
            if err:
                raise build.KernelError(
                    f"bucket_aggregate: setup failed: CUDA error {err}")
            sms = _NUM_SMS[dev.index] = out.value
        return sms


def _column_arg(col: Optional[Column]) -> _ColumnArg:
    arg = _ColumnArg()
    if col is None:
        return arg
    arg.lanes = col.lanes.data_ptr()
    arg.present = col.present.data_ptr() if col.present is not None else None
    arg.dtype = LANE_DTYPES[col.lanes.dtype]
    if col.rebase is not None:
        arg.rebase = 1
        arg.scale, arg.min = col.rebase
    return arg


def _launch(mask, nb, needs, kind, bucket, origin, interval, metric, stats):
    lib = _library()
    dev = mask.device
    sms = _num_sms(lib, dev)
    # the zeroed workspace: the arrival ticket (two words, so that 64-bit
    # slots stay 8-byte aligned), then each kept slot
    offsets, words = [], 2
    for name, need in zip(_SLOTS, _SLOT_NEEDS):
        if not needs & need:
            offsets.append(-1)
            continue
        entries = nb * _PCTL if name == "sketch" else nb
        size = entries * (2 if need in (SUM, SUM_SQ, MIN, MAX) else 1)
        offsets.append(words)
        words += size + (size & 1)
    acc = torch.zeros(words, dtype=torch.int32, device=dev)
    args = _Args(mask=mask.data_ptr(), n=mask.shape[0],
                 bucket=_column_arg(bucket), metric=_column_arg(metric),
                 origin=origin, interval=interval,
                 ln_gamma=agg_ops._PCTL_LN_GAMMA, kind=KINDS.index(kind),
                 nb=nb, needs=needs, has_metric=metric is not None,
                 count_f64=stats, acc=acc.data_ptr())
    args.narrow = (kind == "date_histogram"
                   and bucket.lanes.dtype == torch.int32
                   and bucket.rebase is None)
    for i, off in enumerate(offsets):
        args.offset[i] = off
    out: dict = {}

    def output(name, dtype, field):
        tensor = torch.empty(nb, dtype=dtype, device=dev)
        out[name] = tensor
        setattr(args, field, tensor.data_ptr())

    if stats:
        # [count, sum, sum_sq, min, max] in one f64 tensor
        state = torch.empty(5, dtype=torch.float64, device=dev)
        out["stats"] = state
        base, step = state.data_ptr(), state.element_size()
        (args.out_count, args.out_sum, args.out_sum_sq, args.out_min,
         args.out_max) = (base + i * step for i in range(5))
    else:
        if needs & COUNTS:
            output("counts", torch.int32, "out_counts")
        if needs & COUNT:
            output("count", torch.int64, "out_count")
        if needs & SUM:
            output("sum", torch.float64, "out_sum")
        if needs & SUM_SQ:
            output("sum_sq", torch.float64, "out_sum_sq")
        if needs & MIN:
            output("min", torch.float64, "out_min")
        if needs & MAX:
            output("max", torch.float64, "out_max")
    if needs & SKETCH:
        # the kernel counts the sketch in place, in the workspace
        at = offsets[_SLOTS.index("sketch")]
        out["sketch"] = acc[at: at + nb * _PCTL].view(nb, _PCTL)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.qw_bucket_aggs(ctypes.addressof(args), sms, stream)
    if err:
        raise build.KernelError(
            f"bucket_aggregate launch failed: CUDA error {err}")
    with _LOCK:     # the fan-out's pool threads launch at once
        bucket_aggregate.launches += 1
    return out


def _check(mask, nb, needs, kind, bucket, metric, stats) -> None:
    if mask.dtype != torch.bool or mask.dim() != 1 \
            or not mask.is_contiguous():
        raise ValueError("bucket_aggregate: mask must be a contiguous 1-D "
                         "bool tensor")
    if kind not in KINDS:
        raise ValueError(f"bucket_aggregate: unknown bucket kind {kind!r}")
    if (bucket is None) != (kind == "none"):
        raise ValueError("bucket_aggregate: a bucket column goes with a "
                         "terms or date_histogram bucket, and only there")
    if not 1 <= nb <= MAX_BUCKETS:
        raise ValueError(f"bucket_aggregate: needs 1 <= nb <= {MAX_BUCKETS}"
                         f", got {nb}")
    if kind == "none" and (nb != 1 or needs & COUNTS):
        raise ValueError("bucket_aggregate: a top-level metric has one "
                         "bucket and no bucket counts")
    if (metric is None) != ((needs & ~COUNTS) == 0):
        raise ValueError("bucket_aggregate: metric needs go with a metric "
                         "column, and only there")
    if stats and needs != STATS:
        raise ValueError("bucket_aggregate: the stats state keeps count, "
                         "sum, sum_sq, min and max")
    if kind == "terms" and (bucket.lanes.dtype != torch.int32
                            or bucket.rebase is not None):
        raise TypeError("bucket_aggregate: terms read i32 ordinals")
    for name, col in (("bucket", bucket), ("metric", metric)):
        if col is None:
            continue
        for part, t in (("lanes", col.lanes), ("present", col.present)):
            if t is None:
                continue
            if t.dim() != 1 or not t.is_contiguous() \
                    or t.shape != mask.shape or t.device != mask.device:
                raise ValueError(f"bucket_aggregate: {name} {part} must be "
                                 "contiguous, 1-D, of the mask's length "
                                 "and on its device")
        if col.lanes.dtype not in LANE_DTYPES:
            raise TypeError(f"bucket_aggregate: {name} lanes of dtype "
                            f"{col.lanes.dtype} are not integers")
        if col.present is not None and col.present.dtype not in \
                PRESENT_DTYPES:
            raise TypeError(f"bucket_aggregate: {name} presence must be one "
                            "byte a doc")


def bucket_aggregate(mask: torch.Tensor, nb: int, needs: int,
                     kind: str = "none", bucket: Optional[Column] = None,
                     origin: int = 0, interval: int = 1,
                     metric: Optional[Column] = None,
                     stats: bool = False) -> dict:
    """The aggregation state of the docs in `mask` over `nb` buckets:
    `kind` "terms" (i32 ordinals), "date_histogram" (floor((v - origin) /
    interval)) or "none" (a top-level metric, nb = 1). Returns the kept
    parts of `needs`: "counts" i32[nb]; over the metric column's present
    values "count" i64[nb], "sum", "sum_sq", "min" (+inf where empty) and
    "max" (-inf) f64[nb], "sketch" i32[nb, PCTL_NUM_BUCKETS]; with `stats`
    (needs == STATS, nb == 1) "stats" f64[5], `ops/aggs.py`'s
    `stats_state`. The tensors must be on a CUDA device."""
    _check(mask, nb, needs, kind, bucket, metric, stats)
    if mask.device.type != "cuda":
        raise ValueError(f"bucket_aggregate: no kernel for device "
                         f"{mask.device}")
    if torch.cuda.current_device() != mask.device.index:
        with torch.cuda.device(mask.device):
            return _launch(mask, nb, needs, kind, bucket, origin, interval,
                           metric, stats)
    return _launch(mask, nb, needs, kind, bucket, origin, interval, metric,
                   stats)


bucket_aggregate.launches = 0
