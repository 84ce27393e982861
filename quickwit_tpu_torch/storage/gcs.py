"""Google Cloud Storage backend.

Role of the reference's `quickwit-storage/src/opendal_storage/` GCS
support. GCS's XML API implements the S3 wire protocol in its
"simple migration" interoperability mode — HMAC keys + AWS-SigV4-signed
requests against storage.googleapis.com — so the backend IS the proven
SigV4-on-stdlib S3 client pointed at the GCS endpoint, with GCS-specific
credential resolution (GCS_HMAC_KEY_ID / GCS_HMAC_SECRET, falling back
to the AWS variables some deployments reuse) and an endpoint override
(QW_GCS_ENDPOINT) for testing.

URI shape: `gs://bucket/prefix`.
"""

from __future__ import annotations

import os
from typing import Optional

from ..common.uri import Uri
from .s3 import S3CompatibleStorage, S3Config


def gcs_config_from_env(env: Optional[dict] = None) -> S3Config:
    env = env if env is not None else os.environ
    return S3Config(
        endpoint=env.get("QW_GCS_ENDPOINT",
                         "https://storage.googleapis.com"),
        # the scope region is not meaningful to GCS's interop mode, but
        # it participates in the SigV4 key derivation on both sides
        region=env.get("GCS_REGION", "auto"),
        access_key=env.get("GCS_HMAC_KEY_ID",
                           env.get("AWS_ACCESS_KEY_ID", "")),
        secret_key=env.get("GCS_HMAC_SECRET",
                           env.get("AWS_SECRET_ACCESS_KEY", "")),
    )


class GcsStorage(S3CompatibleStorage):
    """`Storage` over the GCS XML (S3-interop) API. URI:
    `gs://bucket/prefix`."""

    service_name = "gcs"

    def __init__(self, uri: Uri, config: Optional[S3Config] = None):
        super().__init__(uri, config or gcs_config_from_env())

    def bulk_delete(self, paths) -> None:
        # GCS's XML interop API has no S3 multi-object `POST /?delete`
        # (batching exists only in the JSON API) — per-object deletes
        from .base import Storage
        Storage.bulk_delete(self, paths)
