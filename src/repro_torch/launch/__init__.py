"""Command-line launchers, and the analytic FLOP count (``flops.py``)."""
