"""Two real processes on the CPU: the port of
``tests/parallel/test_topology_distributed.py``.

Each test starts a pair of ``python -c`` children that import only
``torch`` and ``repro_torch``, meet through
``launch.mesh.init_distributed`` (gloo, a ``TCPStore`` on a free
localhost port) and run on ``device="cpu"``; the parent computes the
oracles from the reference and from the port's one-process fleet.

* The query pair at S = 8: each child ingests its half of the rows and
  answers ``query_cohort(ALL)`` and a cohort across the boundary
  collectively, bitwise the port's one-process fleet on the same rows,
  within the spine budget ``2⌈log₂S⌉``, and within 1e-4 absolute of the
  reference's answers by Gram (the parity contract).
* The engine checkpoint 1 → 2 → 1: one engine's checkpoint restores on
  two processes (pending rows split by owner, every user bitwise), the
  two shard checkpoints they write restore on one, which drains to the
  answers of the engine that never stopped.

Every child has a 120 s limit and every transport a 30 s one.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp

from repro.sketch import api as RA
from repro.sketch import query as RQ
from repro_torch.launch.mesh import pin_host_threads
from repro_torch.serve.engine import SketchFleetEngine
from repro_torch.sketch import api as PA
from repro_torch.sketch import query as PQ
from repro_torch.tree import leaves

# torch's intra-op pool at this pytest worker's share of the cores
pin_host_threads(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

S, D, N_ROWS, WINDOW, BLOCK = 8, 5, 20, 12, 4
TOL = 1e-4
SRC = Path(__file__).resolve().parents[1] / "src"


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn_pair(script: str, root: str):
    """Run ``script`` as processes 0 and 1 (argv: pid, port, root)."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(pid), str(port), root],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (rc, out, err) in enumerate(outs):
        assert rc == 0, (f"child {pid} failed (rc={rc})\n--- stdout ---\n"
                         f"{out}\n--- stderr ---\n{err[-4000:]}")
    return outs


_PREAMBLE = """
import os, sys
pid, port, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
import numpy as np
import torch
from repro_torch.launch import mesh
from repro_torch.parallel.topology import FleetTopology
mesh.init_distributed(pid, 2, "127.0.0.1", port, timeout_s=30)
import torch.distributed as dist
assert dist.get_world_size() == 2 and dist.get_rank() == pid
"""


_QUERY_SCRIPT = _PREAMBLE + """
from repro_torch.sketch.api import agg_tree, make_sketch, shard_streams
from repro_torch.sketch.query import ALL, Cohort
from repro_torch.tree import leaves

data = np.load(os.path.join(root, "rows.npz"))
X = data["X"]
S, n, d = X.shape
t = int(data["t"])
sk = make_sketch("dsfd", d=d, eps=0.25, window=int(data["window"]),
                 device="cpu")
topo = FleetTopology(S, timeout_s=30)        # defaults from the runtime
assert (topo.P, topo.pid, topo.local_size) == (2, pid, S // 2)
assert type(topo.transport).__name__ == "StoreTransport"
fleet = shard_streams(sk, S, topology=topo)
st = fleet.update_block(fleet.init(), torch.from_numpy(X[topo.lo:topo.hi]),
                        torch.arange(1, n + 1, dtype=torch.int32))
answers = {"all": fleet.query_cohort(st, ALL, t),
           "mid": fleet.query_cohort(st, Cohort.range(2, 6), t)}
tree = agg_tree(fleet)
budget = 2 * int(np.ceil(np.log2(S)))
assert tree.remote_fetches <= budget, (tree.remote_fetches, budget)
assert tree.spine_merges <= budget, (tree.spine_merges, budget)
out = {}
for name, g in answers.items():
    for i, leaf in enumerate(leaves(g)):
        out[f"{name}_leaf_{i:03d}"] = leaf.numpy()
    out[f"{name}_query"] = sk.query(g, t)[0].numpy()
np.savez(os.path.join(root, f"answers_{pid}.npz"), **out)
topo.barrier("answers")
mesh.shutdown()
print("TOPO-QUERY-OK fetches=%d spine=%d" % (tree.remote_fetches,
                                             tree.spine_merges))
"""


_ENGINE_SCRIPT = _PREAMBLE + """
from repro_torch.parallel.topology import OwnershipError
from repro_torch.serve.engine import SketchFleetEngine

data = np.load(os.path.join(root, "engine_oracle.npz"))
S, d = int(data["S"]), int(data["d"])
topo = FleetTopology(S, timeout_s=30)
eng = SketchFleetEngine.from_checkpoint(os.path.join(root, "ck1"),
                                        topology=topo, device="cpu")
assert eng.t == int(data["t"]), (eng.t, int(data["t"]))
assert (eng.S, eng.S_local) == (S, S // 2)
assert eng.backlog == 1                      # pending rows split by owner
for u in range(topo.lo, topo.hi):
    np.testing.assert_array_equal(eng.query_user(u), data["user_%03d" % u],
                                  err_msg=f"pid {pid} user {u}")
other = 0 if pid == 1 else topo.hi           # a stream the peer owns
try:
    eng.submit(other, np.zeros(d, np.float32))
    raise SystemExit("submit to a stream of the peer did not raise")
except OwnershipError as e:
    assert f"process {1 - pid}" in str(e), str(e)
eng.checkpoint(os.path.join(root, "ck2"))    # each writes its own shard
topo.barrier("ck2-done")
mesh.shutdown()
print("TOPO-ENGINE-OK")
"""


def _rows(seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(S, N_ROWS, D)).astype(np.float32)
    return X / np.linalg.norm(X, axis=2, keepdims=True)


def test_two_process_query_bitwise_within_spine_budget(tmp_path):
    root = str(tmp_path)
    X = _rows(11)
    np.savez(os.path.join(root, "rows.npz"), X=X, t=N_ROWS, window=WINDOW)
    outs = _spawn_pair(_QUERY_SCRIPT, root)
    for _, out, _ in outs:
        assert "TOPO-QUERY-OK" in out
    # the port's one-process fleet on the same rows, bitwise
    sk = PA.make_sketch("dsfd", d=D, eps=0.25, window=WINDOW, device="cpu")
    fleet = PA.fleet_streams(sk, S)
    import torch

    st = fleet.update_block(fleet.init(), torch.from_numpy(X),
                            torch.arange(1, N_ROWS + 1, dtype=torch.int32))
    # and the reference's, by Gram
    rsk = RA.make_sketch("dsfd", d=D, eps=0.25, window=WINDOW)
    rfleet = RA.vmap_streams(rsk, S)
    rst = rfleet.update_block(rfleet.init(), jnp.asarray(X),
                              jnp.arange(1, N_ROWS + 1, dtype=jnp.int32))
    for name, (pc, rc) in {"all": (PQ.ALL, RQ.ALL),
                           "mid": (PQ.Cohort.range(2, 6),
                                   RQ.Cohort.range(2, 6))}.items():
        want = list(leaves(PA.query_cohort(fleet, st, pc, N_ROWS)))
        rq = np.asarray(rsk.query(RA.query_cohort(rfleet, rst, rc, N_ROWS),
                                  N_ROWS), np.float64)
        for pid in range(2):
            got = np.load(os.path.join(root, f"answers_{pid}.npz"))
            for i, w in enumerate(want):
                np.testing.assert_array_equal(
                    got[f"{name}_leaf_{i:03d}"], w.numpy(),
                    err_msg=f"pid {pid} {name} leaf {i}")
            q = got[f"{name}_query"].astype(np.float64)
            np.testing.assert_allclose(q.T @ q, rq.T @ rq, rtol=0, atol=TOL)


def test_engine_checkpoint_one_to_two_to_one(tmp_path):
    root = str(tmp_path)
    X = _rows(13)
    eng = SketchFleetEngine("dsfd", d=D, streams=S, eps=0.25,
                            window=WINDOW, block=BLOCK, device="cpu")
    eng.submit_many(np.repeat(np.arange(S), 8), X[:, :8].reshape(-1, D))
    eng.run()
    eng.submit(1, X[1, 8])                   # pending across the saves
    eng.submit(6, X[6, 8])
    eng.checkpoint(os.path.join(root, "ck1"))
    payload = {"S": S, "d": D, "t": eng.t}
    for u in range(S):
        payload[f"user_{u:03d}"] = eng.query_user(u)
    np.savez(os.path.join(root, "engine_oracle.npz"), **payload)

    outs = _spawn_pair(_ENGINE_SCRIPT, root)             # 1 -> 2
    for _, out, _ in outs:
        assert "TOPO-ENGINE-OK" in out

    back = SketchFleetEngine.from_checkpoint(os.path.join(root, "ck2"),
                                             device="cpu")  # 2 -> 1
    assert (back.t, back.S, back.backlog) == (eng.t, S, 2)
    for u in range(S):
        np.testing.assert_array_equal(back.query_user(u),
                                      payload[f"user_{u:03d}"])
    back.run()
    eng.run()
    assert back.backlog == 0
    for u in range(S):
        np.testing.assert_array_equal(back.query_user(u), eng.query_user(u))
    np.testing.assert_array_equal(back.query_global(), eng.query_global())
