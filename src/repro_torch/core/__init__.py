"""DS-FD and FrequentDirections, batched over streams."""
