"""Date/time parsing helpers."""
