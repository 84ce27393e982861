"""Device ops in torch: BM25, top-k, masks, aggregation states."""
