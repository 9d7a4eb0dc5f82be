"""Stream a row sequence through any registered sketch variant.

Counterpart of ``benchmarks/common.py::run_sketch``, the runner that the
paper's error-against-space figures are drawn from
(``benchmarks/error_space.py``).  It is a library function of the port:
it returns what it measured and writes no file.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.sketch.api import make_sketch


def run_sketch(name: str, rows: np.ndarray, *, eps: float, window: int,
               query_every: int, timestamps: Optional[np.ndarray] = None,
               device="cuda", **hyper
               ) -> Tuple[Dict[int, np.ndarray], int, float]:
    """Stream ``rows`` ((n, d)) through the variant ``name``, one row at a
    time.

    Returns ``(queries, peak, wall_s)``: ``queries`` maps the 1-based row
    index of every ``query_every``-th row to the ``query_rows`` answer at
    that row's time as numpy ((k, d); a torch variant's one stream),
    ``peak`` is the most live rows ``space`` reported after any row, and
    ``wall_s`` the host-clock seconds of the stream (on the card, up to a
    ``torch.cuda.synchronize()`` after the last row).  Expiry follows
    ``timestamps`` when given (time-based streams), else rows 1..n.

    Host baselines run the reference's Python loop on the host; the port's
    torch variants run a loop of ``update`` on the sketch's device
    (``device``: the card unless it names the CPU), keeping each query and
    each row's live count on the device until the stream ends."""
    rows = np.asarray(rows)
    sk = make_sketch(name, d=rows.shape[1], eps=eps, window=window,
                     device=device, **hyper)
    n = rows.shape[0]
    ts_np = (np.asarray(timestamps, np.int64) if timestamps is not None
             else np.arange(1, n + 1, dtype=np.int64))

    if sk.meta["backend"] == "host":
        state = sk.init()
        queries, peak = {}, 0
        t0 = time.perf_counter()
        for i in range(n):
            state = sk.update(state, rows[i], int(ts_np[i]))
            peak = max(peak, int(sk.space(state)))
            if (i + 1) % query_every == 0:
                queries[i + 1] = np.asarray(sk.query_rows(state, ts_np[i]))
        return queries, peak, time.perf_counter() - t0

    dev = torch.device(sk.meta["device"])
    state = sk.init()
    t0 = time.perf_counter()
    data = torch.as_tensor(rows, dtype=torch.float32).to(dev)
    ts = torch.as_tensor(ts_np, dtype=torch.int32).to(dev)
    live, outs = [], {}
    for i in range(n):
        t = ts[i:i + 1]
        state = sk.update(state, data[i:i + 1], t)
        # the state may be updated in place: keep copies
        live.append(torch.as_tensor(sk.space(state)).reshape(1).clone())
        if (i + 1) % query_every == 0:
            outs[i + 1] = sk.query_rows(state, t)[0].clone()
    peak = int(torch.cat(live).max()) if live else 0
    queries = {i: q.cpu().numpy() for i, q in outs.items()}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return queries, peak, time.perf_counter() - t0
