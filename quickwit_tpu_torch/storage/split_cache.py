"""Disk-resident split cache for searchers.

Role of the reference's `SearchSplitCache` + `SplitTable`
(`quickwit-storage/src/split_cache/mod.rs:43`, `split_table.rs:1`,
`download_task.rs`): leaf requests REPORT the splits they touch; a
download worker copies the hottest candidates from object storage into a
local directory as whole `.split` files; the reader open path serves
cached splits from local disk, making cold-split economics against S3
viable. An in-memory eviction table tracks candidate / downloading /
on-disk statuses under byte + count budgets with LRU-by-touch eviction
(most-recently-reported candidates download first, least-recently-touched
on-disk splits evict first).

Crash safety mirrors the reference: downloads write `<id>.split.temp`
then rename; leftover `.temp` files are deleted on startup; `.split`
files found on startup are adopted into the table.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Any, Optional

from ..observability.metrics import METRICS

logger = logging.getLogger(__name__)

_HITS = METRICS.counter("qw_split_cache_hits_total",
                        "reader opens served from the disk split cache")
_MISSES = METRICS.counter("qw_split_cache_misses_total",
                          "reader opens that had to go to object storage")
_EVICTIONS = METRICS.counter("qw_split_cache_evictions_total",
                             "splits evicted from the disk cache")
_DOWNLOADS = METRICS.counter("qw_split_cache_downloads_total",
                             "splits downloaded into the disk cache")

CANDIDATE = "candidate"
DOWNLOADING = "downloading"
ON_DISK = "on_disk"


class SplitTable:
    """Eviction table (split_table.rs role): every known split is
    candidate, downloading, or on-disk; a monotonic touch counter orders
    both download priority (newest candidate first) and eviction (oldest
    on-disk first). NOT thread-safe — the cache holds the lock."""

    def __init__(self, max_bytes: int, max_splits: int = 10_000):
        self.max_bytes = max_bytes
        self.max_splits = max_splits
        self._splits: dict[str, dict[str, Any]] = {}
        self._touch_counter = 0
        self.on_disk_bytes = 0

    def _touch_stamp(self) -> int:
        self._touch_counter += 1
        return self._touch_counter

    def info(self, split_id: str) -> Optional[dict[str, Any]]:
        return self._splits.get(split_id)

    def touch(self, split_id: str, storage_uri: str = "",
              num_bytes_hint: int = 0) -> None:
        """Report one split as interesting (a leaf request touched it).
        Unknown splits enter as candidates."""
        info = self._splits.get(split_id)
        if info is None:
            self._splits[split_id] = {
                "status": CANDIDATE, "storage_uri": storage_uri,
                "num_bytes": num_bytes_hint, "touch": self._touch_stamp()}
        else:
            info["touch"] = self._touch_stamp()

    def register_on_disk(self, split_id: str, num_bytes: int,
                         storage_uri: str = "") -> None:
        info = self._splits.get(split_id)
        if info is not None and info["status"] == ON_DISK:
            return
        if info is not None and info.get("reserved"):
            # converting a make_room reservation into the real entry:
            # release the reserved bytes before adding the actual size
            self.on_disk_bytes -= info["num_bytes"]
        self._splits[split_id] = {
            "status": ON_DISK, "storage_uri": storage_uri,
            "num_bytes": num_bytes, "touch": self._touch_stamp()}
        self.on_disk_bytes += num_bytes

    def forget(self, split_id: str) -> None:
        info = self._splits.pop(split_id, None)
        if info is not None and (info["status"] == ON_DISK
                                 or info.get("reserved")):
            self.on_disk_bytes -= info["num_bytes"]

    def num_on_disk(self) -> int:
        return sum(1 for i in self._splits.values()
                   if i["status"] == ON_DISK)

    def best_candidate(self) -> Optional[tuple[str, str]]:
        """(split_id, storage_uri) of the most-recently-touched candidate,
        or None. The freshest report downloads first — cold candidates age
        out of priority naturally."""
        best = None
        for split_id, info in self._splits.items():
            if info["status"] != CANDIDATE:
                continue
            if best is None or info["touch"] > best[2]:
                best = (split_id, info["storage_uri"], info["touch"])
        return (best[0], best[1]) if best else None

    def start_download(self, split_id: str) -> None:
        info = self._splits.get(split_id)
        if info is not None:
            info["status"] = DOWNLOADING

    def abort_download(self, split_id: str) -> None:
        info = self._splits.get(split_id)
        if info is not None and info["status"] == DOWNLOADING:
            if info.pop("reserved", None):
                self.on_disk_bytes -= info["num_bytes"]
            info["status"] = CANDIDATE

    def make_room(self, incoming_bytes: int,
                  incoming_count: int = 1,
                  reserve_for: Optional[str] = None) -> "Optional[list[str]]":
        """Evict least-recently-touched ON-DISK splits until
        `incoming_bytes` fits under the byte + count budgets. Returns the
        evicted ids, or None when the incoming split can NEVER fit (or
        only by evicting something fresher than it — the reference's
        NoRoomAvailable).

        With `reserve_for`, the incoming bytes are accounted against
        `on_disk_bytes` IMMEDIATELY (tagged reserved on that split's
        entry), so a concurrent download admitted between this call and
        `register_on_disk` cannot overshoot the budget; the reservation
        is released by register_on_disk / forget / abort_download."""
        if incoming_bytes > self.max_bytes:
            return None
        evicted: list[str] = []
        on_disk = sorted(
            ((i["touch"], sid) for sid, i in self._splits.items()
             if i["status"] == ON_DISK))
        bytes_after = self.on_disk_bytes
        # reserved in-flight downloads hold a count slot too — otherwise
        # concurrent admissions protect the byte budget but overshoot
        # max_splits
        count_after = len(on_disk) + sum(
            1 for i in self._splits.values() if i.get("reserved"))
        idx = 0
        while (bytes_after + incoming_bytes > self.max_bytes
               or count_after + incoming_count > self.max_splits):
            if idx >= len(on_disk):
                return None
            _, victim = on_disk[idx]
            idx += 1
            bytes_after -= self._splits[victim]["num_bytes"]
            count_after -= 1
            evicted.append(victim)
        for victim in evicted:
            self.forget(victim)
        if reserve_for is not None:
            info = self._splits.get(reserve_for)
            if info is not None and info["status"] == DOWNLOADING:
                info["num_bytes"] = incoming_bytes
                info["reserved"] = True
                self.on_disk_bytes += incoming_bytes
        return evicted


class DiskSplitCache:
    """The on-disk cache + its download worker."""

    def __init__(self, root_path: str, storage_resolver,
                 max_bytes: int = 10 << 30, max_splits: int = 10_000):
        self.root_path = root_path
        self.storage_resolver = storage_resolver
        os.makedirs(root_path, exist_ok=True)
        # qwlint: disable-next-line=QW008 - on-disk cache downloader does real
        # file IO and timed event waits on real time; outside the DST-raced in-
        # memory path
        self._lock = threading.Lock()
        self.table = SplitTable(max_bytes, max_splits)
        # qwlint: disable-next-line=QW008 - on-disk cache downloader does real
        # file IO and timed event waits on real time; outside the DST-raced in-
        # memory path
        self._wakeup = threading.Event()
        # qwlint: disable-next-line=QW008 - on-disk cache downloader does real
        # file IO and timed event waits on real time; outside the DST-raced in-
        # memory path
        self._stop = threading.Event()
        self._worker: Optional[threading.Thread] = None
        # startup scan: drop interrupted downloads, adopt finished splits
        adopted: list[tuple[int, str]] = []
        for name in os.listdir(root_path):
            path = os.path.join(root_path, name)
            if not os.path.isfile(path):
                continue
            if name.endswith(".temp"):
                try:
                    os.remove(path)
                except OSError:
                    logger.warning("failed to remove temp file %s", path)
            elif name.endswith(".split"):
                adopted.append((os.path.getsize(path),
                                name[: -len(".split")]))
            else:
                logger.warning("unknown file in split cache dir: %s", path)
        # no recency survives a restart: adopt largest-first so a budget
        # shrink below evicts the biggest splits and keeps the most splits
        for num_bytes, split_id in sorted(adopted, reverse=True):
            self.table.register_on_disk(split_id, num_bytes)
        # a budget shrink across restarts evicts down to the new limit
        with self._lock:
            evicted = self.table.make_room(0, incoming_count=0) or []
        self._delete_files(evicted)

    # -- read path ----------------------------------------------------------
    def local_path(self, split_id: str) -> Optional[str]:
        """Local file path when the split is cached (counts a hit and
        freshens its eviction rank); None otherwise (counts a miss —
        candidate registration happens in the caller via report_split)."""
        with self._lock:
            info = self.table.info(split_id)
            if info is not None and info["status"] == ON_DISK:
                self.table.touch(split_id)
                _HITS.inc()
                return os.path.join(self.root_path, f"{split_id}.split")
        _MISSES.inc()
        return None

    def report_split(self, split_id: str, storage_uri: str,
                     num_bytes_hint: int = 0) -> None:
        """Reference `ReportSplit`: a leaf request touched this split —
        candidate it for download."""
        with self._lock:
            self.table.touch(split_id, storage_uri, num_bytes_hint)
        self._wakeup.set()

    # -- download side ------------------------------------------------------
    def download_one(self) -> Optional[str]:
        """Download the hottest candidate; returns its id or None when
        there is nothing to do / no room. Called by the worker loop and
        directly by tests."""
        with self._lock:
            candidate = self.table.best_candidate()
            if candidate is None:
                return None
            split_id, storage_uri = candidate
            self.table.start_download(split_id)
        try:
            storage = self.storage_resolver.resolve(storage_uri)
            payload = storage.get_all(f"{split_id}.split")
        # qwlint: disable-next-line=QW004 - background prefetch worker off
        # the query path: a failed download only drops the candidate, and
        # the worker loop must survive storage faults (incl. injected ones)
        except Exception as exc:  # noqa: BLE001 - worker must survive
            logger.warning("split cache download %s failed: %s",
                           split_id, exc)
            with self._lock:
                # a failing candidate is dropped, not retried forever
                self.table.forget(split_id)
            return None
        with self._lock:
            evicted = self.table.make_room(len(payload),
                                           reserve_for=split_id)
            if evicted is None:
                # cannot fit without evicting fresher data: drop candidacy
                self.table.forget(split_id)
                return None
        self._delete_files(evicted)
        if evicted:
            _EVICTIONS.inc(len(evicted))
        # Temp-write + rename must COMPLETE before the table claims the
        # split is on disk: a concurrent local_path() must never hand out
        # a path to a file that does not exist yet, and a failed write
        # (disk full) must not leave a permanent phantom entry.
        temp = os.path.join(self.root_path, f"{split_id}.split.temp")
        final = os.path.join(self.root_path, f"{split_id}.split")
        try:
            with open(temp, "wb") as fh:
                fh.write(payload)
            os.replace(temp, final)
        except OSError as exc:
            logger.warning("split cache write %s failed: %s", split_id, exc)
            with self._lock:
                self.table.forget(split_id)
            try:
                os.remove(temp)
            except OSError:
                pass
            return None
        with self._lock:
            self.table.register_on_disk(split_id, len(payload), storage_uri)
        _DOWNLOADS.inc()
        return split_id

    def _delete_files(self, split_ids: list[str]) -> None:
        for split_id in split_ids:
            try:
                os.remove(os.path.join(self.root_path, f"{split_id}.split"))
            except OSError:
                pass

    # -- worker -------------------------------------------------------------
    def start(self) -> None:
        if self._worker is None:
            # qwlint: disable-next-line=QW003 - long-lived background
            # downloader; deliberately NOT bound to the starting request's
            # deadline/tenant context
            # qwlint: disable-next-line=QW008 - on-disk cache downloader does
            # real file IO and timed event waits on real time; outside the DST-
            # raced in-memory path
            self._worker = threading.Thread(
                target=self._worker_loop, name="split-cache-dl", daemon=True)
            self._worker.start()

    def stop(self) -> None:
        self._stop.set()
        self._wakeup.set()

    def _worker_loop(self) -> None:
        while not self._stop.is_set():
            self._wakeup.wait(timeout=5.0)
            self._wakeup.clear()
            if self._stop.is_set():
                return
            while self.download_one() is not None:
                if self._stop.is_set():
                    return
