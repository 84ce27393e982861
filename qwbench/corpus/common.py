"""Split building shared by the corpus kinds: the port's split layout (the
one `quickwit_tpu_torch.index.writer.SplitWriter` writes) built from whole
columns at once, on the device where the work is large: numeric and
ordinal fast columns, the postings of raw text, numeric and
default-tokenized text fields (from token ids in CSR form), and the doc
store.

The layout is the program's, so the arrays go through its
`SplitFileBuilder` and its numeric column packing. The impact ordering of
the postings (format v3) is done here over all postings at once: the
port's `apply_impact_ordering` loops over terms in Python, which costs
minutes at 10M documents. `tests/test_qwbench_corpus.py` holds the two
equal, array by array, against `SplitWriter` itself.
"""

from __future__ import annotations

import hashlib
import json
import math
import re
from types import SimpleNamespace

import numpy as np
import torch

from quickwit_tpu_torch.index.format import (
    DOC_PAD, POSTING_PAD, ZONEMAP_BLOCK, SplitFileBuilder, SplitFooter, pad_to,
)
from quickwit_tpu_torch.index.writer import (
    ANALYZER_VERSION, SplitWriter, _column_zonemaps, _pack_numeric,
)
from quickwit_tpu_torch.models.doc_mapper import DocMapper, FieldType

# BM25 and the impact quantization, as format v3 fixes them
# (`index/impact.py`): k1, b, 255 buckets, blocks of 128 postings, and the
# scale's safety margin
K1 = 1.2
B = 0.75
IMPACT_BUCKETS = 255
IMPACT_BLOCK = 128
SCALE_MARGIN = 1e-4


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream of draws (`tag`) of a run's seed."""
    digest = hashlib.sha256(f"{int(seed)}/{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, tag))
    return gen


def doc_mapper(config: dict) -> DocMapper:
    return DocMapper.from_dict(config["doc_mapping"])


def padded(values: torch.Tensor, n_padded: int, fill=0) -> torch.Tensor:
    out = torch.full((n_padded,), fill, dtype=values.dtype,
                     device=values.device)
    out[:values.shape[0]] = values
    return out


# --- fast columns -----------------------------------------------------------

def numeric_column(builder: SplitFileBuilder, fm, values: np.ndarray,
                   num_docs_padded: int) -> dict:
    """A numeric fast column of a field every doc has, as
    `SplitWriter._write_column` writes it: frame-of-reference packed where
    the span allows, raw full width otherwise, with block zonemaps."""
    dtype = (np.float64 if fm.type is FieldType.F64
             else np.uint64 if fm.type is FieldType.U64 else np.int64)
    vals = np.ascontiguousarray(values, dtype=dtype)
    n = vals.shape[0]
    present = np.zeros(num_docs_padded, dtype=np.uint8)
    present[:n] = 1
    meta = {"type": fm.type.value, "fast": True, "column_kind": "numeric",
            "min_value": vals.min().item(), "max_value": vals.max().item()}
    packed = _pack_numeric(fm.type, vals)
    if packed is not None:
        deltas, for_min, for_scale, bit_width = packed
        lanes = np.zeros(num_docs_padded, dtype=deltas.dtype)
        lanes[:n] = deltas
        builder.add_array(f"col.{fm.name}.packed", lanes)
        meta["packed"] = {"for_min": for_min, "for_scale": for_scale,
                          "bit_width": bit_width}
        zdomain = lanes.astype(np.int32)
    else:
        full = np.zeros(num_docs_padded, dtype=dtype)
        full[:n] = vals
        builder.add_array(f"col.{fm.name}.values", full)
        zdomain = full
    builder.add_array(f"col.{fm.name}.present", present)
    zmin, zmax = _column_zonemaps(zdomain, present)
    builder.add_array(f"col.{fm.name}.zmin", zmin)
    builder.add_array(f"col.{fm.name}.zmax", zmax)
    meta["zonemap_block"] = ZONEMAP_BLOCK
    return meta


def ordinal_column(builder: SplitFileBuilder, name: str, vocab: list[str],
                   ordinals: np.ndarray, num_docs_padded: int) -> dict:
    """The dictionary-encoded column of a single-valued raw text field.
    `vocab` is sorted and holds only values some doc has."""
    out = np.full(num_docs_padded, -1, dtype=np.int32)
    out[:ordinals.shape[0]] = ordinals
    encoded = [v.encode() for v in vocab]
    offsets = np.zeros(len(vocab) + 1, dtype=np.int64)
    np.cumsum([len(v) for v in encoded], out=offsets[1:])
    builder.add_array(f"col.{name}.ordinals", out)
    builder.add_array(f"col.{name}.dict_blob",
                      np.frombuffer(b"".join(encoded), dtype=np.uint8))
    builder.add_array(f"col.{name}.dict_offsets", offsets)
    return {"fast": True, "column_kind": "ordinal",
            "cardinality": len(vocab)}


# --- inverted fields --------------------------------------------------------

def _idf_f32(dfs: np.ndarray, num_docs: int) -> np.ndarray:
    """f32(idf) per term, by the same host formula as `ops.bm25.idf`, once
    per distinct document frequency."""
    distinct, inverse = np.unique(dfs, return_inverse=True)
    table = np.array([math.log(1.0 + (num_docs - int(d) + 0.5)
                               / (int(d) + 0.5)) for d in distinct],
                     dtype=np.float64).astype(np.float32)
    return table[inverse]


def inverted_field(builder: SplitFileBuilder, name: str, term_blob: bytes,
                   term_offsets: np.ndarray, term: torch.Tensor,
                   doc: torch.Tensor, tf: torch.Tensor,
                   fieldnorms: torch.Tensor, total_tokens: int,
                   num_docs: int, num_docs_padded: int, fm) -> dict:
    """One text field's inverted arrays, impact-ordered (format v3).

    `term`, `doc`, `tf`: one entry per (term, doc) pair, sorted by term
    then doc, term ordinals dense over the terms in `term_blob` (every one
    of which has a posting). `fieldnorms`: tokens per doc, padded.
    """
    dev = term.device
    term = term.long()
    num_terms = term_offsets.shape[0] - 1
    dfs = torch.bincount(term, minlength=num_terms)
    post_lens = (dfs + POSTING_PAD - 1) // POSTING_PAD * POSTING_PAD
    post_offs = torch.cumsum(post_lens, 0) - post_lens
    first = torch.cumsum(dfs, 0) - dfs
    dfs_np = dfs.cpu().numpy()

    # the query kernel's f32 score of each posting (`impact.exact_scores_f32`)
    idf = torch.from_numpy(_idf_f32(dfs_np, num_docs)).to(dev)
    f32 = torch.float32
    tf32 = tf.to(f32)
    norms = fieldnorms[doc.long()].to(f32)
    avg = torch.clamp_min(torch.tensor(np.float32(total_tokens / num_docs),
                                       device=dev), np.float32(1e-9))
    inner = (norms * np.float32(B)) / avg
    # tensors stay on the left: products and sums commute exactly
    denom = tf32 + (inner + np.float32(1.0 - B)) * np.float32(K1)
    weight = idf * np.float32(K1 + 1.0)
    scores = (weight[term] * tf32) / torch.clamp_min(denom, np.float32(1e-9))

    # within a term: score descending, then doc ascending (the input order,
    # which a stable sort keeps among equal scores)
    key = (term << 32) | (0x7FFFFFFF - scores.view(torch.int32).long())
    order = torch.sort(key, stable=True).indices
    doc, tf, scores, term = doc[order], tf[order], scores[order], term[order]

    # u8 quantization against each term's best score
    best = scores[first].to(torch.float64)
    factor = torch.full_like(best, float(IMPACT_BUCKETS)) / best
    quant = torch.clamp_max(torch.ceil(scores.to(torch.float64)
                                       * factor[term]),
                            float(IMPACT_BUCKETS)).to(torch.uint8)
    scale = (best * (1.0 + SCALE_MARGIN)) / torch.full_like(
        best, float(IMPACT_BUCKETS))

    slots = post_offs[term] + (torch.arange(term.shape[0], device=dev)
                               - first[term])
    total = int(post_lens.sum())
    ids_arena = torch.full((total,), num_docs_padded, dtype=torch.int32,
                           device=dev)
    tfs_arena = torch.zeros(total, dtype=torch.int32, device=dev)
    quant_arena = torch.zeros(total, dtype=torch.uint8, device=dev)
    ids_arena[slots] = doc.to(torch.int32)
    tfs_arena[slots] = tf.to(torch.int32)
    quant_arena[slots] = quant
    max_tf = torch.zeros(num_terms, dtype=torch.int32, device=dev)
    max_tf.scatter_reduce_(0, term, tf.to(torch.int32), "amax")
    bmax = quant_arena.view(-1, IMPACT_BLOCK).amax(dim=1)

    arrays = {
        "terms.blob": np.frombuffer(term_blob, dtype=np.uint8),
        "terms.offsets": term_offsets.astype(np.int64),
        "terms.df": dfs_np.astype(np.int32),
        "terms.post_off": post_offs.cpu().numpy().astype(np.int64),
        "terms.post_len": post_lens.cpu().numpy().astype(np.int32),
        "terms.max_tf": max_tf.cpu().numpy(),
        "postings.ids": ids_arena.cpu().numpy(),
        "postings.tfs": tfs_arena.cpu().numpy(),
        "fieldnorm": fieldnorms.to(torch.int32).cpu().numpy(),
        "impact.quant": quant_arena.cpu().numpy(),
        "impact.bmax": bmax.cpu().numpy(),
        "impact.scale": scale.cpu().numpy(),
    }
    for suffix, arr in arrays.items():
        builder.add_array(f"inv.{name}.{suffix}", arr)
    return {"type": fm.type.value, "tokenizer": fm.tokenizer,
            "record": fm.record, "indexed": True, "num_terms": num_terms,
            "total_tokens": int(total_tokens),
            "avg_len": total_tokens / num_docs,
            "impact": {"buckets": IMPACT_BUCKETS, "block": IMPACT_BLOCK,
                       "ordered": True}}


def _one_term_postings(builder: SplitFileBuilder, fm, vocab: list[str],
                       codes: torch.Tensor, num_docs_padded: int):
    """Postings of a field with one term per doc: `vocab` sorted, codes
    index it. Returns (field meta, the terms some doc has, each doc's
    ordinal among them)."""
    dev = codes.device
    n = codes.shape[0]
    codes = codes.long()
    present = torch.bincount(codes, minlength=len(vocab)) > 0
    remap = torch.cumsum(present.long(), 0) - 1
    used = [v for v, p in zip(vocab, present.tolist()) if p]
    ords = remap[codes]
    order = torch.sort(ords, stable=True).indices
    encoded = [v.encode() for v in used]
    offsets = np.zeros(len(used) + 1, dtype=np.int64)
    np.cumsum([len(v) for v in encoded], out=offsets[1:])
    norms = padded(torch.ones(n, dtype=torch.int32, device=dev),
                   num_docs_padded)
    meta = inverted_field(builder, fm.name, b"".join(encoded), offsets,
                          ords[order], order, torch.ones_like(order),
                          norms, n, n, num_docs_padded, fm)
    return meta, used, ords


def categorical_field(builder: SplitFileBuilder, fm, vocab: list[str],
                      codes: torch.Tensor, num_docs_padded: int) -> dict:
    """A raw-tokenized fast text field with one value per doc: its
    postings (one token per doc) and its ordinal column. `vocab` sorted;
    codes index it."""
    meta, used, ords = _one_term_postings(builder, fm, vocab, codes,
                                          num_docs_padded)
    meta.update(ordinal_column(builder, fm.name, used,
                               ords.to(torch.int32).cpu().numpy(),
                               num_docs_padded))
    return meta


def numeric_terms(builder: SplitFileBuilder, fm, values: torch.Tensor,
                  num_docs_padded: int) -> dict:
    """The postings of an indexed integer field with one value per doc:
    each value indexed under its decimal string, the terms in byte order,
    as `SplitWriter` indexes a numeric field. The field's fast column is
    `numeric_column`'s; update this meta with its meta."""
    distinct, codes = torch.unique(values, return_inverse=True)
    words = [str(v) for v in distinct.tolist()]
    ordered, position = _byte_order(words)
    meta, _, _ = _one_term_postings(builder, fm, ordered,
                                    position.to(codes.device)[codes],
                                    num_docs_padded)
    return meta


_WORD = re.compile(r"[0-9a-z]+")


def _byte_order(words: list[str]) -> tuple[list[str], torch.Tensor]:
    """The words in byte order, the order of a split's term dictionary,
    and each word's position in it."""
    rank = sorted(range(len(words)), key=lambda i: words[i])
    position = torch.empty(len(words), dtype=torch.long)
    position[rank] = torch.arange(len(words))
    return [words[i] for i in rank], position


def text_field(builder: SplitFileBuilder, fm, words: list[str],
               offsets: torch.Tensor, ids: torch.Tensor,
               num_docs_padded: int) -> dict:
    """A default-tokenized text field from each doc's token ids in CSR
    form (doc i's tokens are `ids[offsets[i]:offsets[i + 1]]`, indices
    into `words`), with exact field lengths (tokens per doc), as
    `SplitWriter` indexes the text `" ".join(words[t] for t in tokens)`.
    Every word has to be its own one token: lowercase ASCII letters and
    digits."""
    bad = [w for w in words if not _WORD.fullmatch(w)]
    if bad:
        raise ValueError(f"words that do not tokenize to themselves: "
                         f"{bad[:5]}")
    dev = ids.device
    n = offsets.shape[0] - 1
    lengths = offsets[1:] - offsets[:-1]
    doc = torch.repeat_interleave(torch.arange(n, device=dev), lengths)
    ordered, position = _byte_order(words)
    pairs, tf = torch.unique(position.to(dev)[ids.long()] * n + doc,
                             return_counts=True)
    term_sorted = torch.div(pairs, n, rounding_mode="floor")
    used = torch.unique(term_sorted)
    term = torch.searchsorted(used, term_sorted)
    encoded = [ordered[i].encode() for i in used.tolist()]
    term_offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
    np.cumsum([len(w) for w in encoded], out=term_offsets[1:])
    norms = padded(lengths.to(torch.int32), num_docs_padded)
    return inverted_field(builder, fm.name, b"".join(encoded), term_offsets,
                          term, pairs - term_sorted * n, tf, norms,
                          int(offsets[-1]), n, num_docs_padded, fm)


# --- doc store --------------------------------------------------------------

def empty_doc_store(builder: SplitFileBuilder) -> None:
    builder.add_array("store.data", np.zeros(0, dtype=np.uint8))
    builder.add_array("store.block_offsets", np.array([0], dtype=np.int64))
    builder.add_array("store.block_first_doc", np.array([0], dtype=np.int32))


def doc_store(builder: SplitFileBuilder, docs) -> int:
    """The doc store of `docs` (JSON objects in doc order): each
    serialised as `SplitWriter.add_document` does, then written by the
    writer's own `_write_docstore`. Returns the documents' uncompressed
    bytes."""
    sources = [json.dumps(doc, separators=(",", ":")).encode()
               for doc in docs]
    SplitWriter._write_docstore(
        SimpleNamespace(_sources=sources, num_docs=len(sources)), builder)
    return sum(len(source) for source in sources)


def finish(builder: SplitFileBuilder, mapper: DocMapper, fields: dict,
           num_docs: int, time_range, uncompressed: int) -> bytes:
    footer = SplitFooter(
        num_docs=num_docs, num_docs_padded=pad_to(num_docs, DOC_PAD),
        arrays={}, fields=fields, time_range=time_range,
        doc_mapping_uid=mapper.doc_mapping_uid,
        extra={"uncompressed_docs_size_bytes": uncompressed,
               "analyzer_version": ANALYZER_VERSION})
    return builder.finish(footer)
