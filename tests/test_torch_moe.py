"""The port's mixture-of-experts FFN and ``moe`` family against the
reference, fp32 (CPU_RC) on the CPU: ``ffn.moe_apply`` with its three
metrics on both MoE smoke configs and with the full configs' capacity
factor 1.25, where tokens drop; ``lm.prefill`` and four decode steps of
llama4-maverick-400b-a17b-smoke.  Parameters are the reference's,
converted by ``params_from_jax``; inputs are made with numpy and handed
to both."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import common as j_common
from repro.models import ffn as j_ffn
from repro.models import lm as j_lm
from repro_torch.configs import get_config
from repro_torch.models import common, ffn, lm

# fp32 on both sides; the two sum the expert products in other orders,
# and the outputs are of size ~0.1-1: agreement to a few fp32 ulps
ATOL = 1e-5
MAVERICK = "llama4-maverick-400b-a17b-smoke"
DEEPSEEK = "deepseek-v2-lite-16b-smoke"


def _normal(shape, salt, scale=1.0):
    return (scale * np.random.default_rng([23, salt]).standard_normal(
        shape)).astype(np.float32)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol, rtol=0)


_PARAMS = {}


def _params(arch, **moe):
    """(jax cfg, torch cfg, jax params, torch params); ``moe`` replaces
    fields of the MoE config on both sides."""
    key = (arch, tuple(sorted(moe.items())))
    if key not in _PARAMS:
        jc, tc = j_get_config(arch), get_config(arch)
        if moe:
            jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe,
                                                                 **moe))
            tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe,
                                                                 **moe))
        jp = j_lm.init_params(jc, jax.random.PRNGKey(0), j_common.CPU_RC)
        tp = lm.params_from_jax(tc, jax.tree_util.tree_map(np.asarray, jp),
                                common.CPU_RC, device="cpu")
        _PARAMS[key] = (jc, tc, jp, tp)
    return _PARAMS[key]


def _moe_layer(arch, router_scale=1.0, **moe):
    """One layer's MoE parameters on both sides; ``router_scale`` sharpens
    the router so that routing is skewed (and, at capacity factor 1.25,
    drops tokens)."""
    jc, tc, jp, tp = _params(arch, **moe)
    jm = jax.tree_util.tree_map(lambda a: np.asarray(a[0]),
                                jp["blocks"]["moe"])
    jm["router"] = jm["router"] * router_scale
    tm = lm.params_from_jax(tc, {"moe": jm}, common.CPU_RC,
                            device="cpu")["moe"]
    return jc, tc, jax.tree_util.tree_map(jnp.asarray, jm), tm


@pytest.mark.parametrize("capacity_factor", [None, 1.25])
@pytest.mark.parametrize("arch", [MAVERICK, DEEPSEEK])
def test_moe_apply_and_its_metrics(arch, capacity_factor):
    """Outputs, ``moe_aux``, ``moe_z`` and ``moe_dropped``, two routing
    rows of 48 tokens.  The smoke configs' capacity factor 8 routes
    without drops; at the full configs' 1.25, with a sharp router and
    tokens that share a direction (so that most choose the same
    experts), tokens drop, and the same ones on both sides."""
    moe = {} if capacity_factor is None else {
        "capacity_factor": capacity_factor}
    # a router 20x the init scale spreads the logits over ~10: sharp, yet
    # no probability underflows to a denormal (XLA:CPU flushes those to
    # zero, torch keeps them, and a tie at zero would break otherwise)
    jc, tc, jm, tm = _moe_layer(arch, router_scale=20.0, **moe)
    x = _normal((2, 48, jc.d_model), 1) + _normal((jc.d_model,), 3, 2.0)
    ty, tmet = ffn.moe_apply(torch.from_numpy(x), tm, tc)
    jy, jmet = j_ffn.moe_apply(jnp.asarray(x), jm, jc)
    assert ty.shape == (2, 48, jc.d_model)
    _close(ty, jy)
    assert set(tmet) == set(jmet) == {"moe_aux", "moe_z", "moe_dropped"}
    for k in tmet:
        _close(tmet[k], jmet[k], atol=1e-6)
    dropped = float(jmet["moe_dropped"])
    if capacity_factor is None:
        assert dropped == 0.0
    else:
        assert dropped > 0.0
        assert float(tmet["moe_dropped"]) == dropped


@pytest.mark.parametrize("n,k,e,cf", [(8, 2, 4, 8.0), (512, 6, 64, 1.25),
                                      (1, 1, 128, 1.25), (64, 1, 8, 1.25),
                                      (48, 2, 4, 1.25)])
def test_moe_capacity_is_the_reference_rule(n, k, e, cf):
    assert ffn.moe_capacity(n, k, e, cf) == j_ffn.moe_capacity(n, k, e, cf)


def test_top_k_breaks_ties_to_the_lower_index_as_jax_does():
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                      [0.4, 0.1, 0.4, 0.1]], np.float32)
    tv, ti = ffn._top_k(torch.from_numpy(probs), 2)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 2)
    assert ti.tolist() == np.asarray(ji).tolist()
    _close(tv, jv, atol=0)


def test_record_routes_sees_every_call():
    jc, tc, jm, tm = _moe_layer(DEEPSEEK)
    x = torch.from_numpy(_normal((1, 6, jc.d_model), 2))
    with ffn.record_routes() as routes:
        ffn.moe_apply(x, tm, tc)
        ffn.moe_apply(x, tm, tc)
    assert len(routes) == 2 and ffn._ROUTES is None
    assert routes[0]["experts"].shape == (1, 6, tc.moe.top_k)
    assert torch.equal(routes[0]["experts"], routes[1]["experts"])
    assert bool((routes[0]["margin"] >= 0).all())


@pytest.mark.parametrize("capacity_factor", [None, 1.25])
def test_maverick_prefill_then_four_decode_steps(capacity_factor):
    """One (attn + dense, attn + MoE) group; the decode steps route the
    batch of two as one row.  Logits and all four caches."""
    moe = {} if capacity_factor is None else {
        "capacity_factor": capacity_factor}
    jc, tc, jp, tp = _params(MAVERICK, **moe)
    prompt = np.random.default_rng(5).integers(0, tc.vocab, (2, 12),
                                               dtype=np.int32)
    jlog, jcache = j_lm.prefill(jc, jp, {"tokens": jnp.asarray(prompt)},
                                j_common.CPU_RC, max_len=20)
    tlog, tcache = lm.prefill(tc, tp, {"tokens": torch.from_numpy(prompt)},
                              common.CPU_RC, max_len=20)
    _close(tlog, jlog)
    jdec = jax.jit(lambda p, t, c: j_lm.decode_step(jc, p, t, c,
                                                    j_common.CPU_RC))
    tok = prompt[:, -1].copy()
    for _ in range(4):
        jlog, jcache = jdec(jp, jnp.asarray(tok), jcache)
        tlog, tcache = lm.decode_step(tc, tp, torch.from_numpy(tok), tcache,
                                      common.CPU_RC)
        _close(tlog, jlog)
        tok = np.array(jnp.argmax(jlog, axis=-1), np.int32)
        assert torch.argmax(tlog, dim=-1).tolist() == tok.tolist()
    assert tcache["pos"] == int(jcache["pos"]) == 16
    for k in ("cka", "cva", "ckb", "cvb"):
        assert tuple(tcache[k].shape) == jcache[k].shape
        _close(tcache[k], jcache[k])


def test_init_params_has_the_reference_layout():
    for arch in (MAVERICK, DEEPSEEK):
        jc, tc, jp, _ = _params(arch)
        tp = lm.init_params(tc, torch.Generator().manual_seed(0),
                            common.CPU_RC, device="cpu")
        shapes = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                                  t)
        assert shapes(tp) == shapes(jp)
        assert float(tp["blocks"]["moe"]["w2"].abs().max()) \
            <= 2 * 0.02 / 2.0 + 1e-6              # truncated, scaled


def test_init_params_makes_bf16_leaves_without_an_fp32_tree():
    """Under the bf16 runtime every weight comes out bf16 and the norm
    scales fp32, as ``_place`` leaves them; stacked leaves are drawn a
    slice at a time, and every slice holds its own draw."""
    tc = get_config(DEEPSEEK)
    tp = lm.init_params(tc, torch.Generator().manual_seed(0),
                        common.DEFAULT_RC, device="cpu")
    w1 = tp["blocks"]["moe"]["w1"]
    assert w1.dtype == torch.bfloat16 and w1.shape[:2] == (2, 4)
    assert not torch.equal(w1[0], w1[1])
    assert tp["blocks"]["attn"]["c_norm"].dtype == torch.float32
    assert tp["blocks"]["moe"]["ln"]["scale"].dtype == torch.float32
