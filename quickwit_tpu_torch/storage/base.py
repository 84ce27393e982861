"""Storage abstraction.

Role of the reference's `quickwit-storage/src/storage.rs:50-143` `Storage`
trait: byte-addressed object storage under a base URI with put / get_slice /
get_all / delete / bulk_delete / file_num_bytes / exists, resolved from a URI
by a `StorageResolver`. Splits, metastore files and WAL snapshots all live
behind this seam, which is what keeps searchers stateless.

Subset of the JAX package's `storage/base.py`: the resolver registers the
in-memory `ram://` backend only; the file and object-store backends are not
carried over yet.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterable, Optional

from ..common.uri import Protocol, Uri


class StorageError(IOError):
    def __init__(self, message: str, kind: str = "internal"):
        super().__init__(message)
        self.kind = kind  # "not_found" | "unauthorized" | "internal" | "timeout" | "deadline"


class Storage:
    """Abstract object storage rooted at `self.uri`."""

    def __init__(self, uri: Uri):
        self.uri = uri

    # --- writes ---------------------------------------------------------
    def put(self, path: str, payload: bytes) -> None:
        raise NotImplementedError

    def delete(self, path: str) -> None:
        raise NotImplementedError

    def bulk_delete(self, paths: Iterable[str]) -> None:
        errors = []
        for path in paths:
            try:
                self.delete(path)
            except StorageError as exc:  # pragma: no cover - defensive
                if exc.kind != "not_found":
                    errors.append((path, exc))
        if errors:
            raise StorageError(f"bulk delete failed for {[p for p, _ in errors]}")

    # --- reads ----------------------------------------------------------
    def get_slice(self, path: str, start: int, end: int) -> bytes:
        """Bytes [start, end) of the object."""
        raise NotImplementedError

    def get_all(self, path: str) -> bytes:
        raise NotImplementedError

    def file_num_bytes(self, path: str) -> int:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        try:
            self.file_num_bytes(path)
            return True
        except StorageError:
            return False

    def list_files(self) -> list[str]:
        """Non-recursive object listing (used by file-backed metastore + GC)."""
        raise NotImplementedError

    def copy_to_file(self, path: str, dest_path: str) -> int:
        data = self.get_all(path)
        with open(dest_path, "wb") as f:
            f.write(data)
        return len(data)


class StorageResolver:
    """URI → Storage factory with per-backend constructors and an instance
    cache (reference: `storage_resolver.rs`)."""

    def __init__(self) -> None:
        self._factories: dict[Protocol, Callable[[Uri], Storage]] = {}
        self._cache: dict[str, Storage] = {}
        # qwlint: disable-next-line=QW008 - storage base/fakes leaf locks; pure
        # in-memory ops inside, never a seam primitive
        self._lock = threading.Lock()

    def register(self, protocol: Protocol, factory: Callable[[Uri], Storage]) -> None:
        self._factories[protocol] = factory

    def resolve(self, uri: "Uri | str") -> Storage:
        if isinstance(uri, str):
            uri = Uri.parse(uri)
        key = str(uri)
        with self._lock:
            if key in self._cache:
                return self._cache[key]
            factory = self._factories.get(uri.protocol)
            if factory is None:
                raise StorageError(f"no storage backend for protocol {uri.protocol}")
            storage = factory(uri)
            self._cache[key] = storage
            return storage

    @staticmethod
    def for_test() -> "StorageResolver":
        from .ram import RamStorage
        resolver = StorageResolver()
        _ram_root = RamStorage(Uri.parse("ram:///"))
        resolver.register(Protocol.RAM, lambda uri: _ram_root.subdir(uri))
        return resolver

    @staticmethod
    def default() -> "StorageResolver":
        return StorageResolver.for_test()
