"""The port's hybrid family (RG-LRU + local attention) against the
reference on the CPU in fp32: recurrentgemma-2b-smoke (3 layers, one
(rglru, rglru, attn) group, tied head) and a 5-layer untied variant with
a 2-layer RG-LRU tail and an ``lm_head``, with the reference's
parameters converted by ``params_from_jax``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import common as j_common
from repro.models import lm as j_lm
from repro_torch.configs import get_config
from repro_torch.configs.base import _pattern_for
from repro_torch.models import common, lm

ATOL = 1e-5
ARCH = "recurrentgemma-2b-smoke"
VARIANTS = {"smoke": {}, "tail5": {"n_layers": 5, "tie_embeddings": False}}


def _configs(variant):
    kw = VARIANTS[variant]
    return (dataclasses.replace(j_get_config(ARCH), **kw),
            dataclasses.replace(get_config(ARCH), **kw))


_PARAMS = {}


def _params(variant):
    if variant not in _PARAMS:
        jc, tc = _configs(variant)
        jp = j_lm.init_params(jc, jax.random.PRNGKey(0), j_common.CPU_RC)
        tp = lm.params_from_jax(tc, jax.tree_util.tree_map(np.asarray, jp),
                                common.CPU_RC, device="cpu")
        _PARAMS[variant] = (jc, tc, jp, tp)
    return _PARAMS[variant]


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol, rtol=0)


def _close_caches(tcache, jcache):
    assert set(tcache) == set(jcache)
    for k, j in jcache.items():
        if k == "pos":
            assert tcache[k] == int(j)
        elif isinstance(j, dict):
            _close_caches(tcache[k], j)
        else:
            assert tuple(tcache[k].shape) == j.shape, k
            _close(tcache[k], j)


def test_tail_variant_has_a_tail_and_a_head():
    jc, tc, jp, tp = _params("tail5")
    assert _pattern_for(tc) == ["rglru", "rglru", "attn", "rglru", "rglru"]
    assert lm._hybrid_group_counts(tc) == (1, 2)
    assert set(tp["tail"]) == {"rec", "mlp"} and "lm_head" in tp
    assert _params("smoke")[3]["tail"] == {}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_init_params_has_the_reference_layout(variant):
    jc, tc, jp, _ = _params(variant)
    tp = lm.init_params(tc, torch.Generator().manual_seed(0),
                        common.DEFAULT_RC, device="cpu")
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    tshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), tp)
    assert tshapes == jshapes
    rec = tp["blocks"]["rec0"]
    # lam stays fp32 under a bf16 compute dtype; the norms in param dtype
    assert rec["lam"].dtype == torch.float32
    assert rec["ln"]["scale"].dtype == torch.float32
    assert rec["w_y"].dtype == torch.bfloat16
    lam = rec["lam"]
    assert float(lam.min()) > 0.6 and float(lam.max()) < 1.0


@pytest.mark.parametrize("S", [28, 40])       # below / above window 32
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_then_six_greedy_decode_steps(variant, S):
    """Prefill below and above the window, then 6 greedy decode steps,
    which cross the ring's wrap (slot pos % 32) in both cases."""
    jc, tc, jp, tp = _params(variant)
    prompt = np.random.default_rng(3).integers(0, tc.vocab, (1, S),
                                               dtype=np.int32)
    jlog, jcache = j_lm.prefill(jc, jp, {"tokens": jnp.asarray(prompt)},
                                j_common.CPU_RC, max_len=64)
    tlog, tcache = lm.prefill(tc, tp, {"tokens": torch.from_numpy(prompt)},
                              common.CPU_RC, max_len=64)
    _close(tlog, jlog)
    _close_caches(tcache, jcache)

    jdec = jax.jit(lambda p, t, c: j_lm.decode_step(jc, p, t, c,
                                                    j_common.CPU_RC))
    tok = int(prompt[0, -1])
    for _ in range(6):
        jlog, jcache = jdec(jp, jnp.asarray([tok], jnp.int32), jcache)
        tlog, tcache = lm.decode_step(tc, tp, torch.tensor([tok]), tcache,
                                      common.CPU_RC)
        _close(tlog, jlog)
        jtok = int(jnp.argmax(jlog[0]))
        assert int(torch.argmax(tlog[0])) == jtok
        tok = jtok
    _close_caches(tcache, jcache)


@pytest.mark.parametrize("max_len", [16, 64])  # ring min(window 32, max_len)
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_init_cache_matches_reference(variant, max_len):
    jc, tc, _, _ = _params(variant)
    jcache = j_lm.init_cache(jc, 2, max_len, j_common.DEFAULT_RC)
    tcache = lm.init_cache(tc, 2, max_len, common.DEFAULT_RC, device="cpu")

    def layout(c, dtype_name):
        return {k: (layout(v, dtype_name) if isinstance(v, dict)
                    else int(v) if k == "pos"
                    else (tuple(v.shape), dtype_name(v.dtype)))
                for k, v in c.items()}
    assert layout(tcache, lambda d: str(d).replace("torch.", "")) == \
        layout(jcache, lambda d: np.dtype(d).name)


def test_embedding_scale_is_rounded_to_the_compute_dtype():
    """The reference multiplies by jnp.asarray(sqrt(d), h.dtype): 50.5 in
    bf16 at d_model 2560, not 50.596."""
    jc, tc, jp, _ = _params("smoke")
    jc = dataclasses.replace(jc, d_model=2560)
    tc = dataclasses.replace(tc, d_model=2560)
    emb = np.random.default_rng(5).standard_normal((8, 2560)).astype(
        np.float32)
    toks = np.arange(8, dtype=np.int32)[None]
    want = j_lm.embed_inputs(jc, {"embed": jnp.asarray(emb)},
                             {"tokens": jnp.asarray(toks)},
                             j_common.DEFAULT_RC)
    got = lm.embed_inputs(tc, {"embed": torch.from_numpy(emb)},
                          {"tokens": torch.from_numpy(toks)},
                          common.DEFAULT_RC)
    assert got.dtype == torch.bfloat16
    _close(got, want, atol=0)
