"""Baseline sliding-window sketches the paper compares against (Table 1 /
Figures 4-9): LM-FD (Exponential Histogram FD), DI-FD (Dyadic Interval FD),
SWR / SWOR row sampling.  These are benchmark comparators and run on the host
(numpy), exactly like the paper's own Python implementations.

The port's own copy of ``repro/core/baselines/``: the same numpy
arithmetic and the same ``np.random.default_rng(seed)`` draws, so every
query gives the reference's rows bit for bit.  ``sketch/api.py`` registers
them as ``"lmfd"``, ``"difd"``, ``"swr"`` and ``"swor"``."""

from repro_torch.core.baselines.npfd import NpFD
from repro_torch.core.baselines.lmfd import LMFD
from repro_torch.core.baselines.difd import DIFD
from repro_torch.core.baselines.sampling import SWR, SWOR

__all__ = ["NpFD", "LMFD", "DIFD", "SWR", "SWOR"]
