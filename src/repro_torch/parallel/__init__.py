"""A fleet across processes: the AggTree-aligned partition, its transports
and the collective query plane (``topology.py``)."""
