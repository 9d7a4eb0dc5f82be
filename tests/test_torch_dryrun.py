"""The program analyzer (``repro_torch.launch.hlo``) and the dry-run
(``repro_torch.launch.dryrun``).

The analyzer's ground truth, the counterpart of
``tests/launch/test_hlo_analysis.py`` (whose HLO text has a 12-trip loop;
an eager program dispatches each trip):

* 12 products (8, 64) @ (64, 64) count 12 · 2 · 8 · 64 · 64 FLOPs and 12
  dot calls;
* on a fake group of 8 (a subprocess: the fake default group must not
  meet the gloo groups of other files in a pytest worker), 12 all-gathers
  to (8, 64) f32 over a group of 4 count 2048 · 3/4 · 12 link bytes and an
  all-reduce of it over 8 counts 2 · 2048 · 7/8;
* views move no bytes;
* a flash call on the CPU counts its kernel's work formula (the bound's),
  once, and none of its plain version's ops;
* ``roofline_terms`` has the reference's keys and its ``dominant``, and
  prices 16-bit products at the bf16 peak and 32-bit ones (an f32
  product, an f32 kernel) at the f32 rate.

The dry-run, in one subprocess a family (all at once, a 120 s limit each)
on a fake world of 4: reduced configs of every family (dense, MoE, VLM,
SSM, hybrid, encoder-decoder) at (1, 2) and (2, 2) meshes, for train,
prefill and decode cells, plus a llama with 3 query heads and 1 KV head
on the chunked path (the sequence-parallel attention and the
sequence-sharded decode cache).  Every cell passes and its record carries
the reference's keys (but those of XLA's compile: its cost analysis, loop
trips and lower/compile times; the port records its trace time).  The
sharding is coherent: on a reduced llama whose heads, KV heads, FFN and
vocabulary divide 2 (and whose widths differ, so a product's shapes name
it), a device's matmul FLOPs at (1, 2) are half those at (1, 1) for
prefill and decode.  In the train cell DTensor runs four products of the
backward whole on each device (``REPLICATED``: both gradients of each
row-parallel projection, wo and w_down); the device's FLOPs at (1, 2),
doubled, are the (1, 1) count plus exactly those four.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.launch import hlo
from repro_torch.launch.mesh import pin_host_threads

# torch's intra-op pool at this pytest worker's share of the cores
pin_host_threads(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

SRC = Path(__file__).resolve().parents[1] / "src"


def _env():
    return dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")


def test_trip_count_and_loop_adjusted_flops():
    x = torch.randn(8, 64)
    w = torch.randn(64, 64)
    with hlo.analyze() as a:
        for _ in range(12):
            x = x @ w
    assert a.stats.matmul_flops == 12 * 2 * 8 * 64 * 64
    assert a.stats.dot_calls == 12
    assert a.stats.hbm_bytes == 12 * 4 * (8 * 64 + 64 * 64 + 8 * 64)


def test_views_move_no_bytes():
    x = torch.randn(8, 64)
    with hlo.analyze() as a:
        x.view(4, 128)
        x.t()
        x[2:]
        x.reshape(64, 8)
        x.unsqueeze(0).expand(3, 8, 64)
    assert a.stats.hbm_bytes == 0 and a.stats.matmul_flops == 0
    with hlo.analyze() as a:
        x.t().contiguous()
        x.to(torch.bfloat16)
    assert a.stats.hbm_bytes == 2 * 4 * 8 * 64 + (4 + 2) * 8 * 64


def test_flash_counts_its_formula_not_its_plain_ops():
    q = torch.randn(2, 256, 64)
    k = torch.randn(1, 256, 64)
    with hlo.analyze() as a:
        flash_ops.flash_attention(q, k, k)
    flops, nbytes = flash_ops.forward_work(2, 1, 256, 64, 4, True)
    assert flops == 4 * 64 * 2 * (256 * 257 // 2)
    assert nbytes == 4 * (2 * 2 * 256 * 64 + 2 * 256 * 64) + 4 * 2 * 256
    assert a.stats.matmul_flops == flops and a.stats.hbm_bytes == nbytes
    assert a.stats.dot_calls == 1
    assert a.stats.kernel_calls == {"flash_fwd": 1}


def test_roofline_terms_structure():
    s = hlo.HLOStats(matmul_flops=1e12, hbm_bytes=1e9,
                     collective_bytes=1e12)
    terms = hlo.roofline_terms(s, chips=8)
    assert {"compute_s", "memory_s", "collective_s", "dominant",
            "per_device_flops", "per_device_hbm_bytes",
            "per_device_collective_bytes", "total_flops",
            "chips"} <= set(terms)
    assert terms["dominant"] == "collective"
    assert terms["compute_s"] == 1e12 / hlo.PEAK_FLOPS
    assert terms["total_flops"] == 8e12


def test_roofline_prices_each_type_at_its_rate():
    a16, a32 = torch.randn(8, 64).bfloat16(), torch.randn(8, 64)
    with hlo.analyze() as a:
        a16 @ a16.T
        a32 @ a32.T
        flash_ops.flash_attention(torch.randn(2, 64, 64),
                                  torch.randn(1, 64, 64),
                                  torch.randn(1, 64, 64))
    f16, f32 = 2 * 8 * 8 * 64, 2 * 8 * 8 * 64 + 4 * 64 * 2 * (64 * 65 // 2)
    assert a.stats.matmul_flops == f16 + f32
    assert a.stats.matmul_flops_f32 == f32
    assert a.stats.matmul_by_shape == {"mm (8, 64)·(64, 8)": 2 * f16,
                                       "flash_fwd": f32 - f16}
    terms = hlo.roofline_terms(a.stats, 1)
    assert terms["compute_s"] == f16 / hlo.PEAK_FLOPS + f32 / hlo.PEAK_F32_FLOPS
    assert hlo.least_time(1e12, 1.0, torch.bfloat16) == (
        1e12 / hlo.PEAK_FLOPS, "operations")
    assert hlo.least_time(1e12, 1.0, torch.float32) == (
        1e12 / hlo.PEAK_F32_FLOPS, "operations")


_COLLECTIVES = r"""
import json
import torch
import torch.distributed._functional_collectives as funcol
from repro_torch.launch import hlo
from repro_torch.launch.mesh import make_debug_mesh, init_fake_world

init_fake_world(8)
mesh = make_debug_mesh(2, 4)
g4, g8 = mesh.get_group("model"), torch.distributed.group.WORLD
x = torch.randn(2, 64)
with hlo.analyze() as a:
    for _ in range(12):
        y = funcol.all_gather_tensor(x, 0, g4)
    z = funcol.all_reduce(torch.randn(8, 64), "sum", g8)
    assert tuple(y.shape) == (8, 64)
print(json.dumps(a.stats.as_dict()))
"""


def test_collective_bytes_ring_model():
    res = subprocess.run([sys.executable, "-c", _COLLECTIVES],
                         capture_output=True, text=True, timeout=120,
                         env=_env())
    assert res.returncode == 0, res.stderr[-3000:]
    s = json.loads(res.stdout.strip().splitlines()[-1])
    assert abs(s["collective_by_op"]["all-gather"] - 2048 * 3 / 4 * 12) < 1e-6
    assert abs(s["collective_by_op"]["all-reduce"] - 2 * 2048 * 7 / 8) < 1e-6
    assert s["collective_counts"] == {"all-gather": 12, "all-reduce": 1}


_CELLS = r"""
import dataclasses, json, sys
from repro_torch.configs.base import ShapeSpec, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import init_fake_world, make_debug_mesh

init_fake_world(4)
arch, meshes = sys.argv[1], sys.argv[2].split(",")
cfg = get_config(arch).reduced()
if sys.argv[3] == "seq":      # 3 query heads, 1 KV head, chunked at 64
    cfg = dataclasses.replace(cfg, n_heads=3, n_kv=1,
                              attn_full_threshold=16, attn_chunk_q=16,
                              attn_chunk_kv=16)
if sys.argv[3] == "distinct":  # every width even, no two alike
    cfg = dataclasses.replace(cfg, d_model=48, n_heads=6, n_kv=2,
                              head_dim=20, d_ff=88, vocab=112)
for m in meshes:
    mesh = make_debug_mesh(*map(int, m.split("x")))
    for kind in ("train", "prefill", "decode"):
        rec = dryrun.run_cell(arch, kind + "_s", False, save=False, cfg=cfg,
                              shape=ShapeSpec(kind + "_s", 64, 4, kind),
                              mesh=mesh)
        print(json.dumps(rec))
"""

FAMILIES = {"dense": "llama3-8b", "moe": "grok-1-314b", "vlm": "qwen2-vl-2b",
            "ssm": "mamba2-2.7b", "hybrid": "recurrentgemma-9b",
            "encdec": "whisper-large-v3"}
RUNS = {**{f: (a, "1x2,2x2", "") for f, a in FAMILIES.items()},
        "dense-1x1": ("llama3-8b", "1x1", "distinct"),
        "dense-1x2": ("llama3-8b", "1x2", "distinct"),
        "seq-attn": ("llama3-8b", "1x2,2x2", "seq")}


@pytest.fixture(scope="module")
def records():
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", _CELLS, *args], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=_env())
        for name, args in RUNS.items()}
    out = {}
    try:
        for name, p in procs.items():
            text, err = p.communicate(timeout=120)
            assert p.returncode == 0, f"{name}:\n{err[-4000:]}"
            out[name] = [json.loads(line) for line in text.splitlines()
                         if line.startswith("{")]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


# the reference's record keys; XLA's compile has no eager counterpart
REF_KEYS = {"arch", "shape", "mesh", "chips", "kind", "rules", "nparams",
            "fsdp", "optimizer", "memory", "hlo", "roofline"}
REF_MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
              "peak_per_device"}
REF_HLO = {"matmul_flops_per_device", "hbm_bytes_per_device",
           "collective_bytes_per_device", "collective_counts",
           "collective_by_op"}
REF_ROOFLINE = {"compute_s", "memory_s", "collective_s", "dominant",
                "model_flops_total", "hlo_flops_total", "useful_ratio",
                "step_time_bound_s", "ideal_s", "min_bytes_per_device",
                "compute_fraction", "roofline_fraction"}


@pytest.mark.parametrize("run", list(RUNS))
def test_every_cell_passes_with_the_reference_keys(records, run):
    recs = records[run]
    want = 3 * len(RUNS[run][1].split(","))
    assert len(recs) == want
    for rec in recs:
        assert REF_KEYS <= set(rec), rec.keys()
        assert REF_MEMORY <= set(rec["memory"])
        assert REF_HLO <= set(rec["hlo"])
        assert REF_ROOFLINE <= set(rec["roofline"])
        assert rec["hlo"]["matmul_flops_per_device"] > 0
        assert rec["memory"]["peak_per_device"] > 0
        if rec["kind"] == "train":
            assert {"n_micro", "accum"} <= set(rec)
        if rec["mesh"] == "2x2":
            assert rec["hlo"]["collective_bytes_per_device"] > 0


# the products the train cell's backward runs whole at (1, 2) on the
# "distinct" llama (T = 4 · 64 tokens, d 48, q 6 · 20 = 120, ff 88, 2
# layers), by the analyzer's key: both gradients of each row-parallel
# projection, whose input dimension the model axis splits
T, D, Q, F, LAYERS = 256, 48, 120, 88, 2
REPLICATED = {
    f"mm ({T}, {D})·({D}, {Q})": "wo's input gradient dY·Woᵀ",
    f"mm ({Q}, {T})·({T}, {D})": "wo's weight gradient Aᵀ·dY",
    f"mm ({T}, {D})·({D}, {F})": "w_down's input gradient dY·Wdᵀ",
    f"mm ({F}, {T})·({T}, {D})": "w_down's weight gradient Hᵀ·dY",
}


def test_the_sharding_is_coherent(records):
    one = {r["kind"]: r["hlo"] for r in records["dense-1x1"]}
    two = {r["kind"]: r["hlo"] for r in records["dense-1x2"]}
    key = "matmul_flops_per_device"
    assert two["prefill"][key] * 2 == one["prefill"][key]
    assert two["decode"][key] * 2 == one["decode"][key]
    by = two["train"]["matmul_by_shape"]
    whole = {k: by.get(k, 0.0) for k in REPLICATED}
    for k, what in REPLICATED.items():
        m, n, p = _mm_dims(k)
        assert whole[k] == LAYERS * 2 * m * n * p, (what, whole[k])
    assert two["train"][key] * 2 == one["train"][key] + sum(whole.values())
    # at (1, 1) the same keys are the whole products, each once
    assert all(one["train"]["matmul_by_shape"][k] >= whole[k]
               for k in REPLICATED)


def _mm_dims(key: str):
    """(m, k, n) of an ``mm (m, k)·(k, n)`` key."""
    a, b = key[3:].split("·")
    m, k = (int(x) for x in a.strip("()").split(", "))
    _, n = (int(x) for x in b.strip("()").split(", "))
    return m, k, n


def test_sequence_parallel_cells_reduce_over_the_model_axis(records):
    for rec in records["seq-attn"]:
        assert rec["rules"]["seq_attn"] == "model"
        assert rec["rules"]["kv_seq"] == "model"
        if rec["kind"] == "decode":
            # the sequence-sharded cache's softmax: max, sum, output
            assert rec["hlo"]["collective_counts"].get("all-reduce", 0) >= 3
