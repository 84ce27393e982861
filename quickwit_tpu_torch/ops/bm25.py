"""BM25 scoring over padded posting arrays.

Role of tantivy's `Bm25Weight`/`Bm25Scorer` (used by the reference's leaf hot
loop): identical formula and defaults (k1=1.2, b=0.75,
idf = ln(1 + (N - df + 0.5)/(df + 0.5))), evaluated vectorized over a whole
posting array at once: a gather of field norms plus an elementwise f32
expression.

Counterpart of the JAX package's `ops/bm25.py`. `idf`, `K1` and `B` stay
host-side Python; `score_postings` keeps the JAX op order and f32 casts so
the scores are bit-identical to the JAX program. One step is fused there:
XLA's CPU backend always allows LLVM to contract a multiply feeding an add,
so `tf + K1 * inner` is computed as one correctly rounded fma. The port
does that fma explicitly (`fma_f32` here, `__fmaf_rn` in the CUDA kernel)
and rounds every other step separately.

Pad slots (tf == 0) score exactly 0, so padded postings need no masking.
"""

from __future__ import annotations

import math

import numpy as np
import torch

K1 = 1.2
B = 0.75


def idf(num_docs: int, df: int) -> float:
    """Static per-term idf, computed host-side at plan time."""
    return math.log(1.0 + (num_docs - df + 0.5) / (df + 0.5))


def f32_scalar(value, device) -> torch.Tensor:
    """A 0-dim f32 tensor on `device`. Divisors must be device tensors: CUDA
    divides by a host scalar as a multiply by its reciprocal, which is not
    the correctly rounded quotient the JAX path computes."""
    return torch.tensor(np.float32(value), dtype=torch.float32, device=device)


def fma_f32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """`a * b + c` for f32 `a`, `c` and an f32 scalar `b`, rounded ONCE to
    f32, as a fused multiply-add does. The product is exact in f64; the f64
    sum is made round-to-odd from its TwoSum error, so the final rounding to
    f32 cannot double-round."""
    p = a.to(torch.float64) * float(np.float32(b))
    c64 = c.to(torch.float64)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.nextafter(s, torch.where(err > 0, math.inf, -math.inf)
                             .to(torch.float64))
    return torch.where((err != 0) & even, toward, s).to(torch.float32)


def score_postings(tfs: torch.Tensor, doc_ids: torch.Tensor,
                   fieldnorms: torch.Tensor, avg_len, idf_value,
                   boost: float = 1.0) -> torch.Tensor:
    """Per-posting BM25 partial scores (float32, same shape as `tfs`).

    `fieldnorms` is the dense per-doc token count; pad posting ids gather a
    clipped norm, but tf==0 zeroes the numerator so pads contribute nothing.
    `avg_len` and `idf_value` are f32 scalars (host or 0-dim tensors): the
    scalar products are rounded to f32 exactly as the JAX weak-typed
    expression `(boost * idf * (K1 + 1.0))` is.
    """
    device = tfs.device
    tf = tfs.to(torch.float32)
    safe = torch.clamp(doc_ids, 0, fieldnorms.shape[0] - 1).long()
    norms = fieldnorms[safe].to(torch.float32)
    avg = torch.clamp_min(f32_scalar(avg_len, device), np.float32(1e-9))
    inner = (norms * np.float32(B)) / avg + np.float32(1.0 - B)
    denom = fma_f32(inner, K1, tf)
    weight = (np.float32(boost) * np.float32(idf_value)) * np.float32(K1 + 1.0)
    return (tf * weight) / torch.clamp_min(denom, np.float32(1e-9))


def dequantize_block_bounds(bmax: torch.Tensor, scale) -> torch.Tensor:
    """Per-block f64 score upper bounds from the u8 block maxima of an
    impact-ordered term (format v3, index/impact.py). `scale` is the
    persisted per-term dequantization scale with the query boost already
    folded in at lowering (an f64 host scalar). Soundness
    (`bmax * scale >= score` for every posting of the block) is the
    writer's quantization contract."""
    return bmax.to(torch.float64) * float(scale)
