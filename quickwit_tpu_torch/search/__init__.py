"""Leaf search: lowering, the posting-space program, collection."""
