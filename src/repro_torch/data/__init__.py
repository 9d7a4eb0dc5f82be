"""Vector-stream and token sources."""
