"""In-memory storage for tests (reference: `ram_storage.rs`)."""

from __future__ import annotations

import threading

from ..common.uri import Uri
from .base import Storage, StorageError


class RamStorage(Storage):
    def __init__(self, uri: Uri):
        super().__init__(uri)
        self._files: dict[str, bytes] = {}
        # qwlint: disable-next-line=QW008 - storage base/fakes leaf locks; pure
        # in-memory ops inside, never a seam primitive
        self._lock = threading.Lock()

    def subdir(self, uri: Uri) -> "RamStorage":
        """Share the same backing map, prefixing paths — mirrors the reference
        where all ram:// URIs resolve into one shared RamStorage tree."""
        child = RamStorage.__new__(RamStorage)
        Storage.__init__(child, uri)
        child._files = self._files
        child._lock = self._lock
        child._prefix = uri.path.lstrip("/")
        return child

    _prefix = ""

    def _key(self, path: str) -> str:
        return f"{self._prefix}/{path}" if self._prefix else path

    def put(self, path: str, payload: bytes) -> None:
        with self._lock:
            self._files[self._key(path)] = bytes(payload)

    def delete(self, path: str) -> None:
        with self._lock:
            if self._files.pop(self._key(path), None) is None:
                raise StorageError(f"not found: {path}", kind="not_found")

    def get_slice(self, path: str, start: int, end: int) -> bytes:
        return self._get(path)[start:end]

    def get_all(self, path: str) -> bytes:
        return self._get(path)

    def _get(self, path: str) -> bytes:
        with self._lock:
            data = self._files.get(self._key(path))
        if data is None:
            raise StorageError(f"not found: {path}", kind="not_found")
        return data

    def file_num_bytes(self, path: str) -> int:
        return len(self._get(path))

    def list_files(self) -> list[str]:
        with self._lock:
            if not self._prefix:
                return sorted(self._files)
            prefix = self._prefix + "/"
            return sorted(k[len(prefix):] for k in self._files if k.startswith(prefix))
