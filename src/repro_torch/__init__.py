"""PyTorch port of the DS-FD sliding-window sketching system.

The JAX package ``repro`` is the reference; this package runs the same
algorithms on an NVIDIA card, with the TPU kernels rewritten by hand for
Hopper (``csrc/``).  It imports nothing of ``repro`` and nothing of JAX.
Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``, which runs the plain PyTorch versions of the kernels.
"""
