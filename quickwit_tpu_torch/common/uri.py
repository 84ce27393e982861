"""URI abstraction for storage locations.

Role of the reference's `quickwit-common/src/uri.rs`: a normalized URI with an
explicit protocol, used everywhere a storage location is named (index uri,
split files, metastore uri). Supported protocols: ``file``, ``ram``, ``s3``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from enum import Enum


class Protocol(str, Enum):
    FILE = "file"
    RAM = "ram"
    S3 = "s3"
    AZURE = "azure"
    GCS = "gs"

    @property
    def is_object_storage(self) -> bool:
        return self in (Protocol.S3, Protocol.AZURE, Protocol.GCS)


@dataclass(frozen=True)
class Uri:
    protocol: Protocol
    path: str  # path after `<protocol>://`, normalized, no trailing slash

    @staticmethod
    def parse(uri: str) -> "Uri":
        if "://" in uri:
            proto_str, path = uri.split("://", 1)
            try:
                protocol = Protocol(proto_str)
            except ValueError:
                raise ValueError(f"unsupported URI protocol: {proto_str!r} in {uri!r}")
        else:
            # Bare paths are file paths (reference behavior: default protocol file).
            protocol, path = Protocol.FILE, os.path.abspath(uri)
        path = path.rstrip("/")
        if protocol is Protocol.FILE:
            path = os.path.normpath(path)
        return Uri(protocol, path)

    def join(self, *segments: str) -> "Uri":
        for segment in segments:
            if segment.startswith("/"):
                raise ValueError(f"cannot join absolute path segment {segment!r}")
        path = "/".join([self.path, *segments]) if segments else self.path
        return Uri(self.protocol, path)

    def parent(self) -> "Uri | None":
        if "/" not in self.path:
            return None
        return Uri(self.protocol, self.path.rsplit("/", 1)[0])

    @property
    def file_path(self) -> str:
        if self.protocol is not Protocol.FILE:
            raise ValueError(f"not a file uri: {self}")
        return self.path

    def __str__(self) -> str:
        return f"{self.protocol.value}://{self.path}"
