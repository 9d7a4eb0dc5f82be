"""Fleet serving: admission, slab ingest and the engine."""
