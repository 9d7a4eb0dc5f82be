"""The model zoo's dense family (``repro/models`` in the reference)."""
