"""Seeded corpus generators: `corpus/<kind>.py` per corpus kind, each with
`draw(config, seed, device)` (the raw documents, on the device) and
`build(config, raw, device)` (the split files' bytes and metastore facts)."""
