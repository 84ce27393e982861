"""Local filesystem storage (reference: `local_file_storage.rs`).

Writes are atomic: tmp file + rename, matching the reference's behavior so a
crashed upload never leaves a half-written split visible.
"""

from __future__ import annotations

import os
import tempfile
from typing import Iterable

from ..common.uri import Uri
from .base import Storage, StorageError


class LocalFileStorage(Storage):
    def __init__(self, uri: Uri):
        super().__init__(uri)
        self.root = uri.file_path
        os.makedirs(self.root, exist_ok=True)

    def _full(self, path: str) -> str:
        root = os.path.normpath(self.root)
        full = os.path.normpath(os.path.join(root, path))
        if full != root and os.path.commonpath([root, full]) != root:
            raise StorageError(f"path escapes storage root: {path}")
        return full

    def put(self, path: str, payload: bytes) -> None:
        full = self._full(path)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(full), prefix=".tmp-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(payload)
            os.replace(tmp, full)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def delete(self, path: str) -> None:
        try:
            os.unlink(self._full(path))
        except FileNotFoundError:
            raise StorageError(f"not found: {path}", kind="not_found")

    def get_slice(self, path: str, start: int, end: int) -> bytes:
        try:
            with open(self._full(path), "rb") as f:
                f.seek(start)
                return f.read(end - start)
        except FileNotFoundError:
            raise StorageError(f"not found: {path}", kind="not_found")

    def get_all(self, path: str) -> bytes:
        try:
            with open(self._full(path), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise StorageError(f"not found: {path}", kind="not_found")

    def file_num_bytes(self, path: str) -> int:
        try:
            return os.stat(self._full(path)).st_size
        except FileNotFoundError:
            raise StorageError(f"not found: {path}", kind="not_found")

    def list_files(self) -> list[str]:
        out = []
        for dirpath, _dirnames, filenames in os.walk(self.root):
            for name in filenames:
                if name.startswith(".tmp-"):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, name), self.root)
                out.append(rel.replace(os.sep, "/"))
        return sorted(out)
