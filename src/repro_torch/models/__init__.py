"""The model zoo (``repro/models`` in the reference): the dense, MoE, VLM,
encoder-decoder, SSM and hybrid families."""
