"""The port's MoE family held against the reference, on the CPU at small
width: the configs, virtual experts and the block
(``repro_torch.models.layers.moe``) here, the models through
``models/transformer.py`` in ``test_torch_moe_model.py``.

The reference's block runs without a mesh: its ``moe_block`` then takes
``_local_moe`` at model-axis size 1, the port's one-device form.  The
models' weights come from the reference's ``init_params`` and cross
through ``convert.model_params_from_reference``; the norm gains get small
random values so the ``1 + scale`` norm is exercised.

Tolerances (both packages compute in f32; only the summation order
differs, ~1e-7 relative a product): the block's output 1e-5 and its
balance loss 1e-6 at unit-scale inputs; the logits of a 2-layer model
1e-4; the loss and its gradients atol 5e-5, rtol 5e-4 (the reference's
VJP test's); train steps ``test_torch_train.py``'s 2e-4.  Which (token,
choice) pairs the capacity drops is integer bookkeeping and must be the
same set; greedy tokens must be identical.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoECfg as RefMoECfg
from repro.configs.base import get_config as ref_get_config
from repro.models import api as ref_api
from repro.models.layers import moe as ref_moe
from repro.models.params import count_params as ref_count_params
from repro_torch.configs.base import MoECfg, get_config
from repro_torch.launch.mesh import pin_host_threads
from repro_torch.models import api
from repro_torch.models.layers import moe
from repro_torch.models.params import count_params
from test_torch_train import _np

# torch's intra-op pool at this pytest worker's share of the cores
pin_host_threads(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

ARCHS = ["grok-1-314b", "kimi-k2-1t-a32b"]
BLOCK_TOL, AUX_TOL, LOGIT_TOL = 1e-5, 1e-6, 1e-4
GRAD_ATOL, GRAD_RTOL = 5e-5, 5e-4


# -- configs and virtual experts ----------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_reference(arch):
    ref, port = ref_get_config(arch), get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert count_params(api.param_defs(port)) == \
        ref_count_params(ref_api.param_defs(ref))


@pytest.mark.parametrize("msize", [1, 2, 3, 4, 8, 16, 32, 768])
@pytest.mark.parametrize("arch", ARCHS)
def test_virtual_experts_match_the_reference(arch, msize):
    m = get_config(arch).moe
    rm = ref_get_config(arch).moe
    try:
        want = (ref_moe.virtual_split(rm, msize),
                ref_moe.virtual_expert_shapes(rm, 64, msize))
    except AssertionError:
        with pytest.raises(AssertionError):
            moe.virtual_split(m, msize)
        with pytest.raises(AssertionError):
            moe.virtual_expert_shapes(m, 64, msize)
        return
    assert (moe.virtual_split(m, msize),
            moe.virtual_expert_shapes(m, 64, msize)) == want


# -- the block ----------------------------------------------------------------

# (experts, top-k, d_model, d_expert, B, S, capacity_factor): the reduced
# grok and kimi blocks, a capacity that drops assignments, and kimi's
# 384-expert top-8 dispatch at small width
BLOCK_CASES = {
    "grok-reduced": (4, 2, 32, 32, 2, 32, 1.25),
    "kimi-reduced": (4, 2, 32, 32, 2, 24, 1.25),
    "drops": (4, 2, 32, 32, 2, 32, 0.5),
    "kimi-dispatch": (384, 8, 16, 8, 2, 64, 1.25),
}


def _block_inputs(E, D, F, B, S, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    wr = (0.5 * rng.standard_normal((D, E))).astype(np.float32)
    ws = [(0.2 * rng.standard_normal(shape)).astype(np.float32)
          for shape in ((E, D, F), (E, D, F), (E, F, D))]
    return [x, wr] + ws


def _ref_dropped(cfg: RefMoECfg, x, wr):
    """The (token, choice) pairs the reference's capacity drops, from its
    own router (``moe.py:61-93`` at model-axis size 1)."""
    T = x.shape[0] * x.shape[1]
    xf = jnp.asarray(x).reshape(T, -1)
    probs = jax.nn.softmax(xf @ jnp.asarray(wr), axis=-1)
    _, topi = jax.lax.top_k(probs, cfg.top_k)
    ks, E = cfg.top_k, cfg.n_experts
    C = min(max(8, int(T * ks / E * cfg.capacity_factor) + 1), T)
    oh = jax.nn.one_hot(topi.reshape(-1), E, dtype=jnp.int32)
    pos_of = jnp.sum((jnp.cumsum(oh, axis=0) - oh) * oh, axis=-1)
    return np.asarray(pos_of >= C).reshape(T, ks), C


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_moe_block_matches_the_reference(case):
    E, k, D, F, B, S, cf = BLOCK_CASES[case]
    args = _block_inputs(E, D, F, B, S, seed=sorted(BLOCK_CASES).index(case))
    want_y, want_aux = ref_moe.moe_block(*map(jnp.asarray, args),
                                         moe=RefMoECfg(E, k, F, cf))
    cfg = MoECfg(E, k, F, cf)
    y, aux = moe.moe_block(*map(torch.from_numpy, args), moe=cfg)
    assert y.shape == (B, S, D) and y.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(want_y), atol=BLOCK_TOL,
                               rtol=BLOCK_TOL)
    assert abs(float(aux) - float(want_aux)) <= AUX_TOL

    slot, _, _, C = moe.route(cfg, torch.from_numpy(args[0]).reshape(
        B * S, D), torch.from_numpy(args[1]))
    dropped, want_C = _ref_dropped(RefMoECfg(E, k, F, cf), *args[:2])
    assert C == want_C == moe.capacity(cfg, B * S)
    np.testing.assert_array_equal((slot == E * C).numpy(), dropped)
    if case == "drops":
        assert 0.2 < dropped.mean() < 0.8       # the capacity really binds
    kept = slot[slot < E * C]
    assert kept.unique().numel() == kept.numel()   # a slot of its own


def test_combine_sums_in_slot_order_and_repeats():
    """Each token's kept slots summed in ascending slot order: the same
    bits as an explicit loop in that order, call after call."""
    E, k, D, F, B, S, cf = BLOCK_CASES["kimi-dispatch"]
    args = [torch.from_numpy(a) for a in _block_inputs(E, D, F, B, S, 7)]
    cfg = MoECfg(E, k, F, cf)
    y1, _ = moe.moe_block(*args, moe=cfg)
    y2, _ = moe.moe_block(*args, moe=cfg)
    assert torch.equal(y1, y2)

    x, wr, wg, wu, wd = args
    xf = x.reshape(-1, D)
    slot, w, _, C = moe.route(cfg, xf, wr)
    want = torch.zeros_like(xf)
    for t in range(xf.shape[0]):
        acc = torch.zeros(D)
        for j in sorted(range(k), key=lambda j: int(slot[t, j])):
            s = int(slot[t, j])
            if s == E * C:
                continue
            e = s // C
            h = torch.nn.functional.silu(xf[t] @ wg[e]) * (xf[t] @ wu[e])
            acc = acc + (h @ wd[e]) * w[t, j]
        want[t] = acc
    np.testing.assert_allclose(_np(y1).reshape(-1, D), _np(want),
                               atol=BLOCK_TOL, rtol=BLOCK_TOL)
