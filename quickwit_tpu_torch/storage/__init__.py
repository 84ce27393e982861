"""Object storage: every backend, the byte-range cache and the wrappers."""
from .base import Storage, StorageError, StorageResolver
from .local import LocalFileStorage
from .ram import RamStorage
from .cache import ByteRangeCache, MemorySizedCache, CachingStorage
from .s3 import S3CompatibleStorage, S3Config
from .azure import AzureBlobStorage, AzureConfig
from .gcs import GcsStorage
from .wrappers import (CountingStorage, DebouncedStorage,
                       StorageTimeoutPolicy, TimeoutAndRetryStorage)

__all__ = [
    "Storage", "StorageError", "StorageResolver", "LocalFileStorage",
    "RamStorage", "ByteRangeCache", "MemorySizedCache", "CachingStorage",
    "S3CompatibleStorage", "S3Config", "AzureBlobStorage", "AzureConfig",
    "GcsStorage", "CountingStorage",
    "DebouncedStorage", "StorageTimeoutPolicy", "TimeoutAndRetryStorage",
]
