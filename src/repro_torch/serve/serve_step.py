"""Serving steps: prefill (prompt → caches + first token) and decode (one
token per call, greedy or sampled).

Counterpart of ``repro/serve/serve_step.py``.  PyTorch runs eagerly, so
each ``build_*_step`` returns a plain function (the reference jits it and
donates the cache).  Sampling at ``temperature > 0`` draws from a
``torch.Generator`` in place of a ``jax.random`` key; the two draw
different numbers, so only greedy decoding is held against the reference.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.parallel.sharding import constrain


def _whole_vocab(last: torch.Tensor) -> torch.Tensor:
    """The last position's logits with the whole vocabulary on each
    device: under a mesh whose rules split the vocabulary, the argmax (or
    the draw) reads every logit; a no-op without one."""
    return constrain(last, "batch", None)


def build_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        logits, caches = api.forward_prefill(cfg, params, batch)
        next_tok = torch.argmax(_whole_vocab(logits[:, -1]),
                                dim=-1).to(torch.int32)
        return next_tok[:, None], caches
    return prefill_step


def build_decode_step(cfg: ModelConfig, *, temperature: float = 0.0):
    def decode_step(params, tokens, caches,
                    generator: Optional[torch.Generator] = None):
        logits, caches = api.forward_decode(cfg, params, tokens, caches)
        last = _whole_vocab(logits[:, -1].float())
        if temperature > 0.0 and generator is not None:
            probs = torch.softmax(last / temperature, dim=-1)
            next_tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            next_tok = torch.argmax(last, dim=-1)
        return next_tok.to(torch.int32)[:, None], caches
    return decode_step
