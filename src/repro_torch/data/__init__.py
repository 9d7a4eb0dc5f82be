"""Vector-stream sources."""
