"""hdfs-logs: the log lines of Quickwit's hdfs-logs tutorial index, the
fields its index config maps, at their own types: a timestamp in seconds
(`fast_precision: seconds`), a u64 `tenant_id`, a raw `severity_text`, a
default-tokenized `body` and a json `resource`; each line also carries
the unmapped `attributes`, stored and fetched with it. Each split holds
one consecutive slice of the corpus's span, as one ingest pipeline's
successive splits do, and its docs in time order. Body words follow a
Zipf law over a vocabulary named by frequency rank (`body_words`). Drawn
on the device from the seed.

The doc store holds each line as `SplitWriter` stores it (compact JSON,
keys in the dataset's order) in 64 KB zlib blocks. At 10M docs a split
building each doc and its `json.dumps` in Python takes minutes, so
`build` assembles the same bytes on the device, a chunk of docs at a
time, from the words' bytes and each number's digits, and compresses the
blocks on every core; `tests/test_torch_hdfs_search.py` holds them equal
to `common.doc_store` and to `SplitWriter`'s.
"""

from __future__ import annotations

import os
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from quickwit_tpu_torch.index.format import DOC_PAD, SplitFileBuilder, pad_to
from quickwit_tpu_torch.index.writer import _STORE_BLOCK_BYTES

from . import common

# the doc's JSON around its values, in the dataset's key order: the parts
# before the body's words, and those after them
_HEAD = (b'{"timestamp":', b',"severity_text":"', b'","body":"')
_TAIL = (b'","resource":{"service":"', b'"},"attributes":{"class":"',
         b'"},"tenant_id":', b'}\n')
# docs assembled on the device at a time
_CHUNK_DOCS = 1 << 20


def words(config: dict) -> list[str]:
    """The body's vocabulary; a word's id is its frequency rank."""
    spec = config["body_words"]
    return [spec["format"].format(i) for i in range(spec["size"])]


def term_name(config: dict, field: str, rank: int) -> str:
    """The body's word of frequency rank `rank`."""
    if field != "body":
        raise KeyError(field)
    return config["body_words"]["format"].format(rank)


def _categorical(weights: torch.Tensor, count: int, gen, device):
    """`count` draws of the indices of `weights` (any scale), by the
    inverse of their cumulative law."""
    cdf = torch.cumsum(weights.to(device=device, dtype=torch.float64), 0)
    u = torch.rand(count, generator=gen, device=device,
                   dtype=torch.float64) * cdf[-1]
    return torch.clamp_max(torch.searchsorted(cdf, u, right=True),
                           weights.shape[0] - 1)


def draw(config: dict, seed: int, device, split: int = 0) -> dict:
    """One split's raw logs on `device`: `ts` (s, sorted, inside the
    split's slice of the span), `tenant`, `severity` codes into
    `severities`, `body_offsets` and `body_ids` (each doc's word ids, CSR),
    `service` codes into `services` and `class` codes into `classes`."""
    n = config["docs_per_split"]
    gen = common.generator(seed, f"hdfs_logs/{split}", device)
    slice_s = config["span_seconds"] // config["splits"]
    ts = torch.sort(torch.randint(0, slice_s, (n,), generator=gen,
                                  device=device)).values
    ts = ts + (config["start_ts"] + split * slice_s)
    tenant = torch.randint(0, config["tenants"], (n,), generator=gen,
                           device=device)
    severity = _categorical(torch.tensor(config["severity_p"]), n, gen,
                            device).to(torch.int8)
    least, most = config["body_tokens"]
    lengths = torch.randint(least, most + 1, (n,), generator=gen,
                            device=device)
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=device)
    offsets[1:] = torch.cumsum(lengths, 0)
    size = config["body_words"]["size"]
    zipf = (torch.arange(size, dtype=torch.float64) + 1.0) \
        ** -config["body_zipf_s"]
    ids = _categorical(zipf, int(offsets[-1]), gen, device).to(torch.int32)
    service = torch.randint(0, len(config["services"]), (n,), generator=gen,
                            device=device).to(torch.int8)
    klass = _categorical(torch.tensor(config["class_p"]), n, gen,
                         device).to(torch.int8)
    return {"ts": ts, "tenant": tenant, "severity": severity,
            "body_offsets": offsets, "body_ids": ids, "service": service,
            "class": klass}


def document(config: dict, raw: dict, doc_id: int) -> dict:
    """One doc as it was ingested (and as the doc store holds it)."""
    a, b = raw["body_offsets"][doc_id:doc_id + 2].tolist()
    fmt = config["body_words"]["format"]
    return {"timestamp": int(raw["ts"][doc_id]),
            "severity_text": config["severities"][int(raw["severity"][
                doc_id])],
            "body": " ".join(fmt.format(t) for t in raw["body_ids"][a:b]
                             .tolist()),
            "resource": {"service": config["services"][int(raw["service"][
                doc_id])]},
            "attributes": {"class": config["classes"][int(raw["class"][
                doc_id])]},
            "tenant_id": int(raw["tenant"][doc_id])}


# --- the doc store ----------------------------------------------------------

def _blob(pieces: list[bytes], device) -> tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor]:
    """(the pieces' bytes end to end, each piece's start, its length)."""
    lengths = np.array([len(p) for p in pieces], dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    data = np.frombuffer(b"".join(pieces), dtype=np.uint8)
    return (torch.from_numpy(data.copy()).to(device),
            torch.from_numpy(starts).to(device),
            torch.from_numpy(lengths).to(device))


def _digits(values: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                            int]:
    """(the values' decimal digits, right-aligned in rows of `width`
    bytes, flattened; each value's digit count; `width`) of values >= 0."""
    v = values.to(torch.int64)
    if int(v.min()) < 0:
        raise ValueError("negative values have no digits here")
    width = len(str(int(v.max())))
    powers = torch.tensor([10 ** j for j in range(width - 1, -1, -1)],
                          dtype=torch.int64, device=v.device)
    digits = (torch.div(v[:, None], powers[None, :], rounding_mode="floor")
              % 10 + ord("0")).to(torch.uint8)
    count = torch.ones_like(v)
    for j in range(1, width):
        count += (v >= 10 ** j).long()
    return digits.reshape(-1), count, width


def _chunk_bytes(raw: dict, lo: int, hi: int, blobs: dict) -> torch.Tensor:
    """The docs `lo:hi`, each serialised and followed by a newline, end
    to end: a gather over pieces (the JSON's fixed parts, each number's
    digits, each coded value, each body word followed by a space but the
    last), on the raw's device. `blobs`: `store_stream`'s."""
    dev = raw["ts"].device
    offsets = raw["body_offsets"][lo:hi + 1]
    ntok = offsets[1:] - offsets[:-1]
    ids = raw["body_ids"][int(offsets[0]):int(offsets[-1])].long()
    m, t = hi - lo, ids.shape[0]
    pool = dict(blobs)
    width = {}
    for name, key in (("timestamp", "ts"), ("tenant", "tenant")):
        digits, count, width[name] = _digits(raw[key][lo:hi])
        pool[name] = (digits, None, count)
    base, at = {}, 0
    for name, blob in pool.items():
        base[name] = at
        at += blob[0].shape[0]
    data = torch.cat([blob[0] for blob in pool.values()])
    rows = torch.arange(m, device=dev)

    def part(j):
        return base["parts"] + pool["parts"][1][j], pool["parts"][2][j]

    def coded(name, key):
        codes = raw[key][lo:hi].long()
        return base[name] + pool[name][1][codes], pool[name][2][codes]

    def number(name):
        count = pool[name][2]
        return (base[name] + rows * width[name] + (width[name] - count),
                count)
    head = [part(0), number("timestamp"), part(1),
            coded("severities", "severity"), part(2)]
    tail = [part(3), coded("services", "service"), part(4),
            coded("classes", "class"), part(5), number("tenant"), part(6)]
    # piece slots: the head's, the body's words, the tail's
    fixed = len(head) + len(tail)
    first = rows * fixed + (offsets[:-1] - offsets[0])
    starts = torch.empty(m * fixed + t, dtype=torch.int64, device=dev)
    lengths = torch.empty_like(starts)
    for j, (start, length) in enumerate(head):
        starts[first + j] = start
        lengths[first + j] = length
    doc_of = torch.repeat_interleave(rows, ntok)
    slots = torch.arange(t, device=dev) + doc_of * fixed + len(head)
    starts[slots] = base["words"] + pool["words"][1][ids]
    lengths[slots] = pool["words"][2][ids] + 1
    after = first + len(head) + ntok
    lengths[after - 1] -= 1             # no space after the last word
    for j, (start, length) in enumerate(tail):
        starts[after + j] = start
        lengths[after + j] = length
    ends = torch.cumsum(lengths, 0)
    piece = torch.repeat_interleave(torch.arange(starts.shape[0],
                                                 device=dev), lengths)
    within = torch.arange(int(ends[-1]), device=dev) - (ends - lengths)[piece]
    return data[starts[piece] + within]


def store_stream(config: dict, raw: dict) -> tuple[np.ndarray, np.ndarray]:
    """(every doc serialised and followed by a newline, end to end; each
    doc's bytes with its newline), built on the raw's device."""
    dev = raw["ts"].device
    words_blob = _blob([w.encode() + b" " for w in words(config)], dev)
    blobs = {"parts": _blob(list(_HEAD + _TAIL), dev),
             "words": (words_blob[0], words_blob[1], words_blob[2] - 1)}
    for name in ("severities", "services", "classes"):
        blobs[name] = _blob([v.encode() for v in config[name]], dev)
    n = raw["ts"].shape[0]
    chunks, sizes = [], []
    for lo in range(0, n, _CHUNK_DOCS):
        hi = min(n, lo + _CHUNK_DOCS)
        out = _chunk_bytes(raw, lo, hi, blobs)
        chunks.append(out.cpu().numpy())
        newlines = torch.nonzero(out == ord("\n")).flatten()
        sizes.append(torch.diff(newlines, prepend=newlines.new_full(
            (1,), -1)).cpu().numpy())
    return np.concatenate(chunks), np.concatenate(sizes).astype(np.int64)


def doc_store(builder: SplitFileBuilder, stream: np.ndarray,
              sizes: np.ndarray) -> int:
    """The doc store `SplitWriter._write_docstore` writes for these docs
    (`store_stream`'s): a block closes after the doc that takes its bytes,
    newlines counted, to 64 KB; each block is its docs joined by newlines,
    zlib level 1. Returns the docs' uncompressed bytes."""
    ends = np.cumsum(sizes)
    n = sizes.shape[0]
    spans, first, base = [], 0, 0
    while first < n:
        last = min(int(np.searchsorted(ends, base + _STORE_BLOCK_BYTES,
                                       side="left")), n - 1)
        spans.append((first, last + 1, base, int(ends[last]) - 1))
        first, base = last + 1, int(ends[last])
    view = memoryview(stream)
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        blocks = list(pool.map(lambda s: zlib.compress(view[s[2]:s[3]], 1),
                               spans))
    offsets = np.zeros(len(blocks) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in blocks], out=offsets[1:])
    builder.add_array("store.data", np.frombuffer(b"".join(blocks),
                                                  dtype=np.uint8))
    builder.add_array("store.block_offsets", offsets)
    builder.add_array("store.block_first_doc", np.array(
        [0] + [s[1] for s in spans], dtype=np.int32))
    return int(ends[-1]) - n if n else 0


# --- the split ----------------------------------------------------------------

def resource_field(builder: SplitFileBuilder, fm, config: dict,
                   codes: torch.Tensor, num_docs_padded: int) -> dict:
    """The postings of the json `resource`, one term a doc: the port
    indexes a json value whole, as the raw term of its `str`
    (`DocMapper.tokens_for_field`)."""
    terms = [str({"service": s}) for s in config["services"]]
    order = sorted(range(len(terms)), key=terms.__getitem__)
    position = torch.empty(len(terms), dtype=torch.long)
    position[order] = torch.arange(len(terms))
    meta, _, _ = common._one_term_postings(
        builder, fm, [terms[i] for i in order],
        position.to(codes.device)[codes.long()], num_docs_padded)
    return meta


def build(config: dict, raw: dict) -> tuple[bytes, dict]:
    """One split's bytes, and its metastore facts."""
    mapper = common.doc_mapper(config)
    fm = {f.name: f for f in mapper.field_mappings}
    n = raw["ts"].shape[0]
    n_pad = pad_to(n, DOC_PAD)
    builder = SplitFileBuilder()
    ts_us = raw["ts"].cpu().numpy() * config["raw_time_unit_us"]
    tenant = raw["tenant"].cpu().numpy()
    fields = {
        "timestamp": common.numeric_column(builder, fm["timestamp"], ts_us,
                                           n_pad),
        "tenant_id": common.numeric_terms(builder, fm["tenant_id"],
                                          raw["tenant"], n_pad),
        "severity_text": common.categorical_field(
            builder, fm["severity_text"], config["severities"],
            raw["severity"], n_pad),
        "body": common.text_field(builder, fm["body"], words(config),
                                  raw["body_offsets"], raw["body_ids"],
                                  n_pad),
        "resource": resource_field(builder, fm["resource"], config,
                                   raw["service"], n_pad)}
    fields["tenant_id"].update(common.numeric_column(
        builder, fm["tenant_id"], tenant, n_pad))
    stored = doc_store(builder, *store_stream(config, raw))
    time_range = (int(ts_us[0]), int(ts_us[-1]))
    split = common.finish(builder, mapper, fields, n, time_range, stored)
    facts = {"num_docs": n, "time_range": time_range,
             "column_bounds": {"tenant_id": (int(tenant.min()),
                                             int(tenant.max()))}}
    return split, facts
