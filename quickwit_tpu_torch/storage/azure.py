"""Azure Blob Storage backend on the stdlib HTTP client.

Role of the reference's `quickwit-storage/src/object_storage/
azure_blob_storage.rs:1` (azure_storage_blobs SDK there); this build has
no Azure SDK, so the Blob service REST API is implemented directly —
Put/Get(Range)/Delete/Head Blob + List Blobs — with real **SharedKey**
request signing (HMAC-SHA256 over the canonicalized headers/resource,
the same scheme the SDK computes).

URI shape: `azure://container/prefix`; the storage account + access key
resolve from config or the standard environment variables
(AZURE_STORAGE_ACCOUNT / AZURE_STORAGE_ACCESS_KEY), with an endpoint
override (QW_AZURE_ENDPOINT) for non-public clouds and the wire fake.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import os
import time
import urllib.parse
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Optional

from ..common.uri import Uri
from .base import StorageError
from .http_object import HttpObjectStorage

_API_VERSION = "2021-08-06"


@dataclass
class AzureConfig:
    account: str = ""
    access_key: str = ""          # base64, as the portal hands it out
    endpoint: str = ""            # "" = https://{account}.blob.core.windows.net
    request_timeout_secs: float = 30.0

    @staticmethod
    def from_env(env: Optional[dict] = None) -> "AzureConfig":
        env = env if env is not None else os.environ
        return AzureConfig(
            account=env.get("AZURE_STORAGE_ACCOUNT", ""),
            access_key=env.get("AZURE_STORAGE_ACCESS_KEY", ""),
            endpoint=env.get("QW_AZURE_ENDPOINT", ""),
        )


def _rfc1123_now() -> str:
    return time.strftime("%a, %d %b %Y %H:%M:%S GMT", time.gmtime())


def shared_key_signature(access_key_b64: str, string_to_sign: str) -> str:
    key = base64.b64decode(access_key_b64)
    mac = hmac.new(key, string_to_sign.encode("utf-8"), hashlib.sha256)
    return base64.b64encode(mac.digest()).decode()


def shared_key_string_to_sign(method: str, headers: dict[str, str],
                              account: str, resource_path: str,
                              query: list[tuple[str, str]]) -> str:
    """The Blob-service SharedKey canonicalization (2015+ rules:
    Content-Length canonicalizes to "" when zero). Exposed so the wire
    fake verifies signatures with the identical computation."""
    def h(name: str) -> str:
        return headers.get(name, "")

    content_length = h("content-length")
    if content_length == "0":
        content_length = ""
    canonical_headers = "".join(
        f"{name}:{headers[name].strip()}\n"
        for name in sorted(headers) if name.startswith("x-ms-"))
    canonical_resource = f"/{account}{resource_path}"
    for name, value in sorted(query):
        canonical_resource += f"\n{name}:{value}"
    return "\n".join([
        method,
        h("content-encoding"), h("content-language"), content_length,
        h("content-md5"), h("content-type"), h("date"),
        h("if-modified-since"), h("if-match"), h("if-none-match"),
        h("if-unmodified-since"), h("range"),
    ]) + "\n" + canonical_headers + canonical_resource


class AzureBlobStorage(HttpObjectStorage):
    """`Storage` over the Azure Blob REST API. URI:
    `azure://container/prefix`. Connection pool, retry loop, and read
    paths live in HttpObjectStorage; this class adds SharedKey signing
    and Blob-specific operations."""

    service_name = "azure"

    def __init__(self, uri: Uri, config: Optional[AzureConfig] = None):
        self.config = config or AzureConfig.from_env()
        super().__init__(uri, self.config.request_timeout_secs)
        if not self.config.account or not self.config.access_key:
            raise StorageError(
                "azure storage requires AZURE_STORAGE_ACCOUNT and "
                "AZURE_STORAGE_ACCESS_KEY", kind="unauthorized")
        parts = uri.path.lstrip("/").split("/", 1)
        self.container = parts[0]
        self.prefix = parts[1].strip("/") if len(parts) > 1 else ""
        if not self.container:
            raise StorageError(f"azure uri has no container: {uri}")
        self._init_endpoint(
            self.config.endpoint or
            f"https://{self.config.account}.blob.core.windows.net")

    @property
    def _root_segment(self) -> str:
        return self.container

    def _sign_headers(self, method, resource_path, query, body,
                      extra_headers):
        headers = {
            "host": self._host_header,
            "x-ms-date": _rfc1123_now(),
            "x-ms-version": _API_VERSION,
        }
        if body:
            headers["content-length"] = str(len(body))
        if extra_headers:
            headers.update({k.lower(): v for k, v in extra_headers.items()})
        signature = shared_key_signature(
            self.config.access_key,
            shared_key_string_to_sign(method, headers, self.config.account,
                                      resource_path, query))
        headers["Authorization"] = \
            f"SharedKey {self.config.account}:{signature}"
        return headers

    # --- Storage impl ----------------------------------------------------
    def put(self, path: str, payload: bytes) -> None:
        status, _, data = self._request(
            "PUT", self._key(path), body=payload,
            extra_headers={"x-ms-blob-type": "BlockBlob"})
        self._check(status, data, "PUT", path)

    def list_files(self) -> list[str]:
        """List Blobs (`?restype=container&comp=list`) with pagination;
        names are relative to the prefix."""
        out: list[str] = []
        marker = ""
        while True:
            query = [("comp", "list"), ("restype", "container")]
            if self.prefix:
                query.append(("prefix", self.prefix + "/"))
            if marker:
                query.append(("marker", marker))
            status, _, data = self._request("GET", "", query=query)
            self._check(status, data, "LIST", self.container)
            root = ET.fromstring(data)
            for blob in root.iter("Blob"):
                name = blob.findtext("Name") or ""
                if self.prefix:
                    name = name[len(self.prefix) + 1:]
                if name and not name.endswith("/"):
                    # '/'-suffixed zero-byte blobs are directory
                    # placeholders (Storage Explorer / ADLS), not objects
                    out.append(name)
            marker = root.findtext("NextMarker") or ""
            if not marker:
                return sorted(out)
