"""Split reader: ranged reads of the array layout, term lookups, doc fetch.

Role of the reference's directory stack (`open_index_with_caches`,
`quickwit-search/src/leaf.rs:219`: StorageDirectory → CachingDirectory →
HotDirectory over the hotcache): opens a split with one footer GET, then
serves exact byte-range reads for postings/columns through a ByteRangeCache.
Device transfer (warmup) lives in `search/leaf.py`; this class is pure host.
"""

from __future__ import annotations

import bisect
import json
import zlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Iterator, Optional

import numpy as np

from ..observability.profile import (
    STORE_BLOCKS_READ, current_profile, profile_add,
)
from ..storage.base import Storage
from ..storage.cache import ByteRangeCache
from .format import DEFAULT_FOOTER_HINT, ArrayMeta, SplitFooter, read_footer
from .impact import IMPACT_BLOCK
from ..common import sync


class _TermStatsCache:
    """Process-wide (path, field, term) → stats LRU shared across reader
    reopens. Splits are immutable, so stats computed by one reader instance
    stay valid for every later open of the same path — without this, a v2
    split lacking the `terms.max_tf` footer re-scans the term's postings on
    EVERY reader reopen (the leaf reader cache evicts under pressure)."""

    _MAX = 1 << 17

    def __init__(self) -> None:
        self._lock = sync.lock("_TermStatsCache._lock")
        self._entries: OrderedDict[tuple, Any] = OrderedDict()

    def get(self, key: tuple) -> Any:
        with self._lock:
            value = self._entries.get(key)
            if value is not None:
                self._entries.move_to_end(key)
            return value

    def put(self, key: tuple, value: Any) -> None:
        with self._lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self._MAX:
                self._entries.popitem(last=False)


_GLOBAL_TERM_STATS = _TermStatsCache()   # ((uri, path), field, term) -> (df, max_tf)
_GLOBAL_TERM_CAPS = _TermStatsCache()    # ((uri, path), field, term) -> float | 0.0


@dataclass(frozen=True)
class TermInfo:
    ordinal: int
    df: int
    post_off: int   # element offset into the postings arenas
    post_len: int   # padded element count


class _TermDict:
    """Sorted term dictionary of one field: binary-searchable blob+offsets."""

    def __init__(self, blob: bytes, offsets: np.ndarray, dfs: np.ndarray,
                 post_offs: np.ndarray, post_lens: np.ndarray):
        self.blob = blob
        self.offsets = offsets
        self.dfs = dfs
        self.post_offs = post_offs
        self.post_lens = post_lens

    def __len__(self) -> int:
        return len(self.dfs)

    def term_at(self, ordinal: int) -> str:
        return self.blob[self.offsets[ordinal]: self.offsets[ordinal + 1]].decode()

    def lookup(self, term: str) -> Optional[TermInfo]:
        target = term.encode()
        lo, hi = 0, len(self.dfs)
        while lo < hi:
            mid = (lo + hi) // 2
            cand = self.blob[self.offsets[mid]: self.offsets[mid + 1]]
            if cand < target:
                lo = mid + 1
            elif cand > target:
                hi = mid
            else:
                return TermInfo(mid, int(self.dfs[mid]), int(self.post_offs[mid]),
                                int(self.post_lens[mid]))
        return None

    def iter_terms(self, start: Optional[str] = None) -> Iterator[tuple[str, int]]:
        """(term, df) pairs in sorted order, optionally from `start`."""
        begin = 0
        if start is not None:
            target = start.encode()
            lo, hi = 0, len(self.dfs)
            while lo < hi:
                mid = (lo + hi) // 2
                if self.blob[self.offsets[mid]: self.offsets[mid + 1]] < target:
                    lo = mid + 1
                else:
                    hi = mid
            begin = lo
        for i in range(begin, len(self.dfs)):
            yield self.term_at(i), int(self.dfs[i])


class SplitReader:
    def __init__(self, storage: Storage, path: str,
                 footer_hint: int = DEFAULT_FOOTER_HINT,
                 cache: Optional[ByteRangeCache] = None,
                 file_len: Optional[int] = None):
        self.storage = storage
        self.path = path
        # key for the process-wide stats/caps caches: the bare path is not
        # unique across storages (two indexes both have an "s0.split")
        self._stats_scope = (str(storage.uri), path)
        self.cache = cache or ByteRangeCache()
        self.file_len = file_len if file_len is not None else storage.file_num_bytes(path)
        self.footer: SplitFooter = read_footer(self._get_slice, self.file_len, footer_hint)
        self._term_dicts: dict[str, _TermDict] = {}
        self._arrays: dict[str, np.ndarray] = {}
        self._term_stats: dict[tuple[str, str], tuple[int, int]] = {}

    # --- IO ----------------------------------------------------------------
    def _get_slice(self, start: int, end: int) -> bytes:
        cached = self.cache.get(self.path, start, end)
        if cached is not None:
            return cached
        data = self.storage.get_slice(self.path, start, end)
        self.cache.put(self.path, start, data)
        # per-query storage attribution: every split read (footer,
        # postings, columns) funnels through here on a byte-range-cache
        # miss; no-op (one ContextVar get) when no profile is bound
        profile = current_profile()
        if profile is not None:
            profile.add("storage_read_bytes", len(data))
            profile.add("storage_reads", 1)
        return data

    def _array_meta(self, name: str) -> ArrayMeta:
        meta = self.footer.arrays.get(name)
        if meta is None:
            raise KeyError(f"split has no array {name!r}")
        return meta

    def has_array(self, name: str) -> bool:
        return name in self.footer.arrays

    def array(self, name: str) -> np.ndarray:
        """Fetch a whole named array (cached)."""
        arr = self._arrays.get(name)
        if arr is None:
            meta = self._array_meta(name)
            raw = self._get_slice(meta.offset, meta.offset + meta.nbytes)
            arr = np.frombuffer(raw, dtype=np.dtype(meta.dtype)).reshape(meta.shape)
            self._arrays[name] = arr
        return arr

    def array_slice(self, name: str, start_elem: int, num_elems: int) -> np.ndarray:
        """Fetch `num_elems` elements of a named array without reading it all —
        the exact-byte-range read postings warmup relies on."""
        meta = self._array_meta(name)
        dtype = np.dtype(meta.dtype)
        byte_start = meta.offset + start_elem * dtype.itemsize
        raw = self._get_slice(byte_start, byte_start + num_elems * dtype.itemsize)
        return np.frombuffer(raw, dtype=dtype)

    # --- inverted index ----------------------------------------------------
    def term_dict(self, field: str) -> Optional[_TermDict]:
        td = self._term_dicts.get(field)
        if td is None:
            if f"inv.{field}.terms.offsets" not in self.footer.arrays:
                return None
            td = _TermDict(
                blob=self.array(f"inv.{field}.terms.blob").tobytes(),
                offsets=self.array(f"inv.{field}.terms.offsets"),
                dfs=self.array(f"inv.{field}.terms.df"),
                post_offs=self.array(f"inv.{field}.terms.post_off"),
                post_lens=self.array(f"inv.{field}.terms.post_len"),
            )
            self._term_dicts[field] = td
        return td

    def lookup_term(self, field: str, term: str) -> Optional[TermInfo]:
        td = self.term_dict(field)
        return td.lookup(term) if td else None

    def postings(self, field: str, info: TermInfo) -> tuple[np.ndarray, np.ndarray]:
        """Padded (doc_ids, tfs) for one term; reads only that term's range."""
        ids = self.array_slice(f"inv.{field}.postings.ids", info.post_off, info.post_len)
        tfs = self.array_slice(f"inv.{field}.postings.tfs", info.post_off, info.post_len)
        return ids, tfs

    def positions(self, field: str, info: TermInfo) -> tuple[np.ndarray, np.ndarray]:
        """(offsets[post_len+1], data) position lists for a term's postings."""
        offsets = self.array_slice(f"inv.{field}.positions.offsets",
                                   info.post_off, info.post_len + 1)
        data_start, data_end = int(offsets[0]), int(offsets[-1])
        data = self.array_slice(f"inv.{field}.positions.data",
                                data_start, data_end - data_start)
        return offsets - data_start, data

    def fieldnorm(self, field: str) -> np.ndarray:
        return self.array(f"inv.{field}.fieldnorm")

    # --- fast-field columns ------------------------------------------------
    def column_packing(self, field: str) -> Optional[dict[str, Any]]:
        """FOR packing info (`for_min`/`for_scale`/`bit_width`) when the
        column is stored as packed deltas (format v2), else None."""
        info = self.field_meta(field).get("packed")
        if info and self.has_array(f"col.{field}.packed"):
            return info
        return None

    def column_packed(self, field: str) -> tuple[np.ndarray, np.ndarray]:
        """(deltas, present) — the compact on-device representation of a
        packed column; `value = for_min + delta * for_scale`."""
        return (self.array(f"col.{field}.packed"),
                self.array(f"col.{field}.present"))

    def column_zonemaps(self, field: str) -> Optional[tuple[np.ndarray, np.ndarray]]:
        """Per-block (zmin, zmax) bounds in the column's on-disk domain
        (scaled deltas when packed, raw values otherwise); None for v1
        splits, which predate zonemaps."""
        if not self.has_array(f"col.{field}.zmin"):
            return None
        return self.array(f"col.{field}.zmin"), self.array(f"col.{field}.zmax")

    def column_values(self, field: str) -> tuple[np.ndarray, np.ndarray]:
        """(values, present) for a numeric column, padded to num_docs_padded.

        Packed columns (format v2) are reconstructed full-width host-side
        and cached, so every host consumer (exact sort-value re-reads,
        ordinalization, derived seconds columns, the doc-store-free bench
        comparator) sees the exact array a raw split would store. Device
        staging should prefer `column_packed` — that is where the byte
        savings live."""
        key = f"col.{field}.values"
        if key not in self._arrays and not self.has_array(key):
            info = self.column_packing(field)
            if info is not None:
                packed = self.array(f"col.{field}.packed")
                fm = self.field_meta(field)
                kind = fm.get("col_type") or fm.get("type")
                if kind == "u64":
                    values = (packed.astype(np.uint64)
                              * np.uint64(info["for_scale"])
                              + np.uint64(info["for_min"]))
                else:
                    values = (packed.astype(np.int64)
                              * np.int64(info["for_scale"])
                              + np.int64(info["for_min"]))
                # raw splits scatter into zeros: absent lanes hold 0, not
                # for_min — reconstruct bit-identically
                present = self.array(f"col.{field}.present")
                values = np.where(present != 0, values, values.dtype.type(0))
                self._arrays[key] = values
        return self.array(key), self.array(f"col.{field}.present")

    def column_ordinals(self, field: str) -> np.ndarray:
        return self.array(f"col.{field}.ordinals")

    def column_dict(self, field: str) -> list[str]:
        blob = self.array(f"col.{field}.dict_blob").tobytes()
        offsets = self.array(f"col.{field}.dict_offsets")
        return [blob[offsets[i]: offsets[i + 1]].decode() for i in range(len(offsets) - 1)]

    # --- doc store ---------------------------------------------------------
    def fetch_docs(self, doc_ids: list[int]) -> list[dict[str, Any]]:
        """Random-access doc fetch (reference: `fetch_docs.rs` over the doc
        store); decompresses each needed block once, and counts the blocks
        as `store_blocks_read` on the ambient query profile."""
        block_first = self.array("store.block_first_doc")
        block_offsets = self.array("store.block_offsets")
        by_block: dict[int, list[int]] = {}
        for doc_id in doc_ids:
            if not (0 <= doc_id < self.footer.num_docs):
                raise IndexError(f"doc id {doc_id} out of range")
            block = bisect.bisect_right(block_first, doc_id) - 1
            by_block.setdefault(block, []).append(doc_id)
        profile_add(STORE_BLOCKS_READ, len(by_block))
        docs_by_id: dict[int, dict[str, Any]] = {}
        for block, ids in by_block.items():
            raw = self.array_slice("store.data", int(block_offsets[block]),
                                   int(block_offsets[block + 1] - block_offsets[block]))
            lines = zlib.decompress(raw.tobytes()).split(b"\n")
            first = int(block_first[block])
            for doc_id in ids:
                docs_by_id[doc_id] = json.loads(lines[doc_id - first])
        return [docs_by_id[d] for d in doc_ids]

    # --- stats -------------------------------------------------------------
    @property
    def num_docs(self) -> int:
        return self.footer.num_docs

    @property
    def num_docs_padded(self) -> int:
        return self.footer.num_docs_padded

    def field_meta(self, field: str) -> dict[str, Any]:
        return self.footer.fields.get(field, {})

    def term_stats(self, field: str, term: str) -> tuple[int, int]:
        """(df, max_tf) of one term — the inputs of the BM25 per-split score
        upper bound (search/pruning.py). Absent term → (0, 0). Served from
        the persisted `terms.max_tf` footer array when present (one 4-byte
        ranged read); older splits without it fall back to scanning the
        term's padded tf slice (pads are 0, so the max is unaffected).
        Scan results backfill a process-wide per-path cache so a reader
        reopened on the same (immutable) split never rescans."""
        cached = self._term_stats.get((field, term))
        if cached is not None:
            return cached
        info = self.lookup_term(field, term)
        if info is None:
            stats = (0, 0)
        elif self.has_array(f"inv.{field}.terms.max_tf"):
            max_tf = self.array_slice(f"inv.{field}.terms.max_tf",
                                      info.ordinal, 1)
            stats = (info.df, int(max_tf[0]))
        else:
            global_key = (self._stats_scope, field, term)
            stats = _GLOBAL_TERM_STATS.get(global_key)
            if stats is None:
                _ids, tfs = self.postings(field, info)
                stats = (info.df, int(tfs.max()) if tfs.size else 0)
                _GLOBAL_TERM_STATS.put(global_key, stats)
        self._term_stats[(field, term)] = stats
        return stats

    # --- impact-ordered postings (format v3) --------------------------------
    def impact_info(self, field: str) -> Optional[dict[str, Any]]:
        """The field's impact descriptor ({"buckets","block","ordered"}) when
        its postings are impact-ordered with the v3 side arrays present,
        else None (v1/v2 splits, positions-recording fields, kill switch)."""
        info = self.field_meta(field).get("impact")
        if info and info.get("ordered") and self.has_array(
                f"inv.{field}.impact.bmax"):
            return info
        return None

    def impact_term_bounds(self, field: str,
                           info: TermInfo) -> tuple[np.ndarray, np.float64]:
        """(block_maxima u8, scale f64) for one term — per-IMPACT_BLOCK
        quantized upper bounds; `bmax * scale` bounds the query-time score
        of every posting in the block. Non-increasing across a term's
        blocks by construction (postings sorted by descending impact)."""
        bmax = self.array_slice(f"inv.{field}.impact.bmax",
                                info.post_off // IMPACT_BLOCK,
                                info.post_len // IMPACT_BLOCK)
        scale = self.array_slice(f"inv.{field}.impact.scale",
                                 info.ordinal, 1)[0]
        return bmax, scale

    def term_score_cap(self, field: str, term: str) -> Optional[float]:
        """Exact dequantized upper bound on the term's best query-time BM25
        score (boost 1), or None when the split has no impact arrays for
        the field. Strictly sharper than the `max_tf` formula bound — it
        reflects the actual best (tf, fieldnorm) pair in the split, not the
        norms-free worst case. Cached process-wide per path (immutable
        splits) alongside the term stats."""
        global_key = (self._stats_scope, field, term)
        cached = _GLOBAL_TERM_CAPS.get(global_key)
        if cached is not None:
            return cached[0]
        if self.impact_info(field) is None:
            cap = None
        else:
            info = self.lookup_term(field, term)
            if info is None:
                cap = 0.0
            else:
                # impact order puts the best posting first, so the first
                # block's max IS the term's max quant
                bmax, scale = self.impact_term_bounds(field, info)
                cap = float(bmax[0]) * float(scale) if bmax.size else 0.0
        _GLOBAL_TERM_CAPS.put(global_key, (cap,))
        return cap
