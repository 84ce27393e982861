"""Object storage (in-memory backend and byte-range cache)."""
