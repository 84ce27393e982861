"""Analyzers that run over this package's own code (host code: no torch)."""
