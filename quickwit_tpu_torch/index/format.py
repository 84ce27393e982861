"""The split container format — TPU-first.

Role of the reference's split format (`docs/internals/split-format.md`,
`quickwit-directories/src/hot_directory.rs` + the tantivy file formats): one
immutable `.split` object holding the inverted index, columnar fast fields,
doc store and a "hotcache" so a searcher can open it with a single ranged GET.

TPU-first divergence from tantivy: tantivy's postings are block-compressed
variable-byte streams decoded by scalar CPU code. Here **every index structure
is a named little-endian ndarray** — postings are padded dense int32 arrays,
columns are contiguous padded buffers — so warmup is `storage.get_slice →
np.frombuffer → jax.device_put` with zero decode work, and kernel shapes are
static. The price is bytes on disk (quantified tradeoff the reference's
parquet experiment also makes, `docs/internals/tantivy-parquet-architecture.md`);
the win is that the hot loop never touches a branchy decoder.

Layout of a split file:

    [array arena ... 128-byte aligned arrays ...]
    [metadata JSON (the "hotcache": schema, stats, array registry)]
    [u64 metadata_len][8-byte MAGIC]

Array naming convention (see writer.py):
    inv.{field}.terms.blob / .offsets / .df / .post_off / .post_len
    inv.{field}.terms.max_tf
    inv.{field}.postings.ids / .tfs
    inv.{field}.positions.offsets / .data      (record="position" fields)
    inv.{field}.impact.quant / .bmax / .scale  (format v3, see index/impact.py)
    inv.{field}.fieldnorm
    col.{field}.values / .present / .ordinals / .dict_blob / .dict_offsets
    col.{field}.packed / .zmin / .zmax      (format v2, see docs/device-layout.md)
    store.data / store.block_offsets / store.block_first_doc

Format v2 stores eligible numeric fast-field columns frame-of-reference
bit-packed (`col.{field}.packed`, u8/u16/u32 deltas from the column min,
optionally GCD-scaled) instead of the full-width `col.{field}.values`,
plus per-512-doc-block min/max zonemaps (`.zmin`/`.zmax`). v1 splits (raw
full-width columns, no zonemaps) remain readable and searchable.

Format v3 stores each text field's postings **impact-ordered**: within a
term, postings are sorted by descending quantized BM25 contribution
(`inv.{field}.impact.quant`, u8 buckets), with per-128-posting block
maxima (`.bmax`, u8) and a per-term dequantization scale (`.scale`, f64)
whose product is a sound upper bound on the query-time score. Readers
treat the absence of the impact arrays as the v2/v1 fallback — every v3
structure is optional per field, so older splits stay searchable and
positions-recording fields simply keep doc order.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

MAGIC = b"QWTPU001"
FORMAT_VERSION = 3
# Versions this reader still opens: v1 splits carry raw full-width columns
# only; every v2 structure is optional per column and every v3 structure is
# optional per field, so the fallback is simply "the packed/zonemap/impact
# arrays are absent".
SUPPORTED_FORMAT_VERSIONS = (1, 2, 3)
ALIGN = 128

# Zonemap granularity: per-block min/max over present docs, one block =
# ZONEMAP_BLOCK doc lanes. Divides DOC_PAD so padded tails are whole blocks.
ZONEMAP_BLOCK = 512

# Docs are padded to a multiple of DOC_PAD (8 sublanes x 128 lanes) so dense
# per-doc arrays tile cleanly onto the VPU; postings to POSTING_PAD lanes.
DOC_PAD = 1024
POSTING_PAD = 128

# Default number of tail bytes fetched on open; one GET covers the metadata
# footer for typical splits (role of the reference's footer_size_hint).
DEFAULT_FOOTER_HINT = 1 << 20


def pad_to(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


@dataclass(frozen=True)
class ArrayMeta:
    name: str
    dtype: str       # numpy dtype string, little-endian ("<i4", "<i8", "<f8", "|u1")
    shape: tuple[int, ...]
    offset: int      # byte offset in the split file
    nbytes: int

    def to_dict(self) -> dict[str, Any]:
        return {"name": self.name, "dtype": self.dtype, "shape": list(self.shape),
                "offset": self.offset, "nbytes": self.nbytes}

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "ArrayMeta":
        return ArrayMeta(d["name"], d["dtype"], tuple(d["shape"]), d["offset"], d["nbytes"])


@dataclass
class SplitFooter:
    """Parsed split metadata — everything needed to plan a search and issue
    exact byte-range reads (the hotcache role)."""
    num_docs: int
    num_docs_padded: int
    arrays: dict[str, ArrayMeta]
    # field name -> {"type","tokenizer","record","fast","indexed",
    #               "num_terms","total_tokens","avg_len" (text),
    #               "min_value","max_value" (numeric cols), "cardinality"}
    fields: dict[str, dict[str, Any]]
    time_range: Optional[tuple[int, int]] = None  # micros, inclusive
    doc_mapping_uid: str = "default"
    extra: dict[str, Any] = None  # type: ignore[assignment]

    def to_json_bytes(self) -> bytes:
        doc = {
            "format_version": FORMAT_VERSION,
            "num_docs": self.num_docs,
            "num_docs_padded": self.num_docs_padded,
            "arrays": [a.to_dict() for a in self.arrays.values()],
            "fields": self.fields,
            "time_range": list(self.time_range) if self.time_range else None,
            "doc_mapping_uid": self.doc_mapping_uid,
            "extra": self.extra or {},
        }
        return json.dumps(doc, separators=(",", ":")).encode()

    @staticmethod
    def from_json_bytes(data: bytes) -> "SplitFooter":
        doc = json.loads(data)
        if doc.get("format_version") not in SUPPORTED_FORMAT_VERSIONS:
            raise ValueError(f"unsupported split format version {doc.get('format_version')}")
        arrays = {a["name"]: ArrayMeta.from_dict(a) for a in doc["arrays"]}
        tr = doc.get("time_range")
        return SplitFooter(
            num_docs=doc["num_docs"],
            num_docs_padded=doc["num_docs_padded"],
            arrays=arrays,
            fields=doc["fields"],
            time_range=(tr[0], tr[1]) if tr else None,
            doc_mapping_uid=doc.get("doc_mapping_uid", "default"),
            extra=doc.get("extra", {}),
        )


class SplitFileBuilder:
    """Accumulates named arrays + metadata, emits the final file bytes."""

    def __init__(self) -> None:
        self._chunks: list[bytes] = []
        self._arrays: dict[str, ArrayMeta] = {}
        self._pos = 0

    def add_array(self, name: str, array: np.ndarray) -> None:
        if name in self._arrays:
            raise ValueError(f"duplicate array {name!r}")
        arr = np.ascontiguousarray(array)
        # normalize to little-endian
        if arr.dtype.byteorder == ">":
            arr = arr.astype(arr.dtype.newbyteorder("<"))
        pad = pad_to(self._pos, ALIGN) - self._pos
        if pad:
            self._chunks.append(b"\x00" * pad)
            self._pos += pad
        data = arr.tobytes()
        dtype_str = arr.dtype.str if arr.dtype.kind != "u" or arr.dtype.itemsize != 1 else "|u1"
        self._arrays[name] = ArrayMeta(name, arr.dtype.str, arr.shape, self._pos, len(data))
        self._chunks.append(data)
        self._pos += len(data)

    def finish(self, footer: SplitFooter) -> bytes:
        footer.arrays = dict(self._arrays)
        meta = footer.to_json_bytes()
        parts = self._chunks + [meta, len(meta).to_bytes(8, "little"), MAGIC]
        return b"".join(parts)


def read_footer(get_slice, file_len: int, footer_hint: int = DEFAULT_FOOTER_HINT) -> SplitFooter:
    """Parse the footer with at most two ranged reads.

    `get_slice(start, end) -> bytes`. First read grabs the last
    min(file_len, footer_hint) bytes (the single-GET open the hotcache design
    targets); a second read happens only if the metadata is larger.
    """
    tail_len = min(file_len, footer_hint)
    tail = get_slice(file_len - tail_len, file_len)
    if tail[-8:] != MAGIC:
        raise ValueError("not a quickwit_tpu split file (bad magic)")
    meta_len = int.from_bytes(tail[-16:-8], "little")
    if meta_len + 16 > file_len:
        raise ValueError("corrupt split footer: metadata length exceeds file")
    if meta_len + 16 <= tail_len:
        meta = tail[tail_len - 16 - meta_len: tail_len - 16]
    else:
        meta = get_slice(file_len - 16 - meta_len, file_len - 16)
    return SplitFooter.from_json_bytes(meta)
