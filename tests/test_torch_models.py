"""The port's dense decoder against the reference on tinyllama-1.1b-smoke,
fp32 (CPU_RC) on the CPU, with the reference's parameters converted by
``params_from_jax``; inputs are made with numpy and handed to both."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as j_attn
from repro.models import common as j_common
from repro.models import ffn as j_ffn
from repro.models import lm as j_lm
from repro_torch.configs import get_config
from repro_torch.models import attention, common, ffn, lm

ATOL = 1e-5
ARCH = "tinyllama-1.1b-smoke"


def _configs(tied: bool):
    jc, tc = j_get_config(ARCH), get_config(ARCH)
    if not tied:
        jc = dataclasses.replace(jc, tie_embeddings=False)
        tc = dataclasses.replace(tc, tie_embeddings=False)
    return jc, tc


_PARAMS = {}


def _params(tied: bool = True):
    """(jax cfg, torch cfg, jax params, torch params) for the smoke model."""
    if tied not in _PARAMS:
        jc, tc = _configs(tied)
        jp = j_lm.init_params(jc, jax.random.PRNGKey(0), j_common.CPU_RC)
        tp = lm.params_from_jax(tc, jax.tree_util.tree_map(np.asarray, jp),
                                common.CPU_RC, device="cpu")
        _PARAMS[tied] = (jc, tc, jp, tp)
    return _PARAMS[tied]


def _normal(shape, salt):
    return np.random.default_rng([11, salt]).standard_normal(
        shape).astype(np.float32)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol,
                               rtol=0)


def test_configs_match_the_reference():
    for name in ("tinyllama-1.1b", ARCH, "recurrentgemma-2b",
                 "recurrentgemma-2b-smoke"):
        jc, tc = j_get_config(name), get_config(name)
        for f in dataclasses.fields(tc):
            got, want = getattr(tc, f.name), getattr(jc, f.name)
            if dataclasses.is_dataclass(got):   # the sub-configs (rglru)
                got, want = dataclasses.asdict(got), dataclasses.asdict(want)
            assert got == want, (name, f.name)
        assert tc.dh == jc.dh


@pytest.mark.parametrize("tied", [True, False])
def test_init_params_has_the_reference_layout(tied):
    jc, tc, jp, _ = _params(tied)
    tp = lm.init_params(tc, torch.Generator().manual_seed(0),
                        common.CPU_RC, device="cpu")
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    tshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), tp)
    assert tshapes == jshapes
    wo = tp["blocks"]["attn"]["wo"]
    assert float(wo.abs().max()) <= 2 * 0.02 / 2.0 + 1e-6   # truncated, scaled
    assert float(tp["blocks"]["attn"]["ln"]["scale"].abs().max()) == 0.0


def test_params_cast_once_to_the_compute_dtype():
    jc, tc, jp, _ = _params()
    tp = lm.params_from_jax(tc, jax.tree_util.tree_map(np.asarray, jp),
                            common.DEFAULT_RC, device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    assert tp["blocks"]["mlp"]["w1"].dtype == torch.bfloat16
    assert tp["blocks"]["attn"]["ln"]["scale"].dtype == torch.float32
    assert tp["out_norm"]["scale"].dtype == torch.float32


def test_rmsnorm_and_rope():
    x = _normal((2, 5, 64), 0)
    scale = 0.1 * _normal((64,), 1)
    _close(common.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale)),
           j_common.rmsnorm(jnp.asarray(x), jnp.asarray(scale)))
    _close(common.layernorm(torch.from_numpy(x), torch.from_numpy(scale),
                            torch.from_numpy(scale)),
           j_common.layernorm(jnp.asarray(x), jnp.asarray(scale),
                              jnp.asarray(scale)))
    pos = np.arange(10, dtype=np.int32).reshape(2, 5) * 7
    tc, ts = common.rope_cos_sin(torch.from_numpy(pos), 16, 10000.0)
    jcos, jsin = j_common.rope_cos_sin(jnp.asarray(pos), 16, 10000.0)
    _close(tc, jcos)
    _close(ts, jsin)
    q = _normal((2, 5, 4, 16), 2)
    _close(common.apply_rope(torch.from_numpy(q), tc[:, :, None],
                             ts[:, :, None]),
           j_common.apply_rope(jnp.asarray(q), jcos[:, :, None],
                               jsin[:, :, None]))


def test_gqa_project_qkv_and_swiglu():
    jc, tc, jp, tp = _params()
    x = _normal((2, 6, 64), 3)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6)) + 3
    jpa = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["attn"])
    tpa = lm._layer(tp["blocks"]["attn"], 0)
    for t, j in zip(attention.gqa_project_qkv(torch.from_numpy(x), tpa, tc,
                                              torch.from_numpy(pos)),
                    j_attn.gqa_project_qkv(jnp.asarray(x), jpa, jc,
                                           jnp.asarray(pos))):
        _close(t, j)
    jpm = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["mlp"])
    tpm = lm._layer(tp["blocks"]["mlp"], 0)
    _close(ffn.swiglu(torch.from_numpy(x), tpm), j_ffn.swiglu(jnp.asarray(x),
                                                              jpm))
    _close(ffn.geglu(torch.from_numpy(x), tpm), j_ffn.geglu(jnp.asarray(x),
                                                            jpm))


@pytest.mark.parametrize("S,Hq,Hkv", [(8, 4, 2), (16, 4, 4), (12, 4, 1)])
def test_flash_attention_matches_jnp(S, Hq, Hkv):
    q, k, v = (_normal((2, S, H, 16), i)
               for i, H in enumerate((Hq, Hkv, Hkv)))
    out = attention.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v))
    want = j_attn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True)
    assert out.shape == (2, S, Hq, 16)
    _close(out, want)


def test_flash_attention_refuses_unported_options():
    q = torch.zeros((1, 4, 2, 16))
    with pytest.raises(NotImplementedError):
        attention.flash_attention(q, q, q, q_offset=2)
    with pytest.raises(NotImplementedError):
        attention.flash_attention(q, q, q, softcap=30.0)


@pytest.mark.parametrize("pos", [0, 5, 31])
def test_decode_attention_and_cache_update_match_jnp(pos):
    q = _normal((2, 4, 16), 4)
    kc, vc = _normal((2, 32, 2, 16), 5), _normal((2, 32, 2, 16), 6)
    new = _normal((2, 2, 16), 7)
    tk = attention.cache_update(torch.from_numpy(kc.copy()),
                                torch.from_numpy(new), pos)
    jk = j_attn.cache_update(jnp.asarray(kc), jnp.asarray(new), pos)
    _close(tk, jk, atol=0)
    out = attention.decode_attention(torch.from_numpy(q), tk,
                                     torch.from_numpy(vc), pos)
    _close(out, j_attn.decode_attention(jnp.asarray(q), jk, jnp.asarray(vc),
                                        pos))


@pytest.mark.parametrize("tied", [True, False])
def test_prefill_then_six_greedy_decode_steps(tied):
    jc, tc, jp, tp = _params(tied)
    prompt = np.random.default_rng(3).integers(0, tc.vocab, (1, 8),
                                               dtype=np.int32)
    jlog, jcache = j_lm.prefill(jc, jp, {"tokens": jnp.asarray(prompt)},
                                j_common.CPU_RC, max_len=32)
    tlog, tcache = lm.prefill(tc, tp, {"tokens": torch.from_numpy(prompt)},
                              common.CPU_RC, max_len=32)
    _close(tlog, jlog)
    _close(tcache["ck"], jcache["ck"])
    _close(tcache["cv"], jcache["cv"])
    assert tcache["pos"] == int(jcache["pos"]) == 8

    jdec = jax.jit(lambda p, t, c: j_lm.decode_step(jc, p, t, c,
                                                    j_common.CPU_RC))
    tok = int(prompt[0, -1])
    for _ in range(6):
        jlog, jcache = jdec(jp, jnp.asarray([tok], jnp.int32), jcache)
        tlog, tcache = lm.decode_step(tc, tp, torch.tensor([tok]), tcache,
                                      common.CPU_RC)
        _close(tlog, jlog)
        assert tcache["pos"] == int(jcache["pos"])
        jtok = int(jnp.argmax(jlog[0]))
        assert int(torch.argmax(tlog[0])) == jtok
        tok = jtok
    _close(tcache["ck"], jcache["ck"])
    _close(tcache["cv"], jcache["cv"])


def test_init_cache_matches_reference():
    jc, tc, _, _ = _params()
    jcache = j_lm.init_cache(jc, 2, 16, j_common.CPU_RC)
    tcache = lm.init_cache(tc, 2, 16, common.CPU_RC, device="cpu")
    assert tuple(tcache["ck"].shape) == jcache["ck"].shape
    assert tcache["ck"].dtype == torch.float32 and tcache["pos"] == 0


@pytest.mark.parametrize("family", ["xlstm", "vlm", "audio"])
def test_other_families_are_not_ported(family):
    """The last three of the reference's families are ported now; a family
    the reference lacks is still refused by name."""
    assert family in lm.FAMILIES
    tc = dataclasses.replace(get_config(ARCH), family=family + "2")
    with pytest.raises(NotImplementedError, match=family + "2"):
        lm.init_params(tc, torch.Generator(), device="cpu")


@pytest.mark.parametrize("name", ["olmo-1b", "phi4-mini-3.8b",
                                  "qwen1.5-110b", "deepseek-v2-lite-16b",
                                  "llama4-maverick-400b-a17b"])
def test_ported_configs_match_the_reference(name):
    for n in (name, name + "-smoke"):
        jc, tc = j_get_config(n), get_config(n)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc), n
        assert tc.dh == jc.dh


@pytest.mark.parametrize("arch", ["olmo-1b-smoke", "phi4-mini-3.8b-smoke",
                                  "qwen1.5-110b-smoke"])
def test_dense_variants_prefill_then_four_decode_steps(arch):
    """The dense variants through the dense code: olmo's non-parametric
    layernorm and MHA, phi4-mini's untied head, qwen's QKV biases (made
    non-zero here; the reference initialises them to zero) and rope
    theta 1e6.  Batch 2, logits and caches at every step."""
    jc, tc = j_get_config(arch), get_config(arch)
    jp = j_lm.init_params(jc, jax.random.PRNGKey(1), j_common.CPU_RC)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    if tc.qkv_bias:
        attn = tree["blocks"]["attn"]
        for i, b in enumerate(("bq", "bk", "bv")):
            attn[b] = 0.5 * _normal(attn[b].shape, 20 + i)
        jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = lm.params_from_jax(tc, tree, common.CPU_RC, device="cpu")
    prompt = np.random.default_rng(4).integers(0, tc.vocab, (2, 9),
                                               dtype=np.int32)
    jlog, jcache = j_lm.prefill(jc, jp, {"tokens": jnp.asarray(prompt)},
                                j_common.CPU_RC, max_len=16)
    tlog, tcache = lm.prefill(tc, tp, {"tokens": torch.from_numpy(prompt)},
                              common.CPU_RC, max_len=16)
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
    _close(tcache["ck"], jcache["ck"])
    _close(tcache["cv"], jcache["cv"])


@pytest.mark.parametrize("arch,dus", [("tinyllama-1.1b-smoke", True),
                                      ("tinyllama-1.1b-smoke", False),
                                      ("recurrentgemma-2b-smoke", True)])
def test_sharding_knobs_change_no_logit(arch, dus):
    """``pad_attn_heads`` (4 query heads padded per KV group to a multiple
    of 3), the decode cache write (in place or the one-hot select) and
    ``logical_axes`` outside ``axis_rules``: prefill and four decode steps
    equal the port without them and the JAX package with them."""
    jc, tc = j_get_config(arch), get_config(arch)
    jp = j_lm.init_params(jc, jax.random.PRNGKey(2), j_common.CPU_RC)
    tp = lm.params_from_jax(tc, jax.tree_util.tree_map(np.asarray, jp),
                            common.CPU_RC, device="cpu")
    knobs = dict(pad_attn_heads=3, dus_cache_update=dus, logical_axes=True)
    jrc = dataclasses.replace(j_common.CPU_RC, **knobs)
    trc = dataclasses.replace(common.CPU_RC, **knobs)
    prompt = np.random.default_rng(5).integers(0, tc.vocab, (2, 8),
                                               dtype=np.int32)
    jlog, jcache = j_lm.prefill(jc, jp, {"tokens": jnp.asarray(prompt)}, jrc,
                                max_len=16)
    tlog, tcache = lm.prefill(tc, tp, {"tokens": torch.from_numpy(prompt)},
                              trc, max_len=16)
    plog, pcache = lm.prefill(tc, tp, {"tokens": torch.from_numpy(prompt)},
                              common.CPU_RC, max_len=16)
    _close(tlog, jlog)
    _close(tlog, plog.numpy())
    jdec = jax.jit(lambda p, t, c: j_lm.decode_step(jc, p, t, c, jrc))
    tok = prompt[:, -1].copy()
    for _ in range(4):
        jlog, jcache = jdec(jp, jnp.asarray(tok), jcache)
        tlog, tcache = lm.decode_step(tc, tp, torch.from_numpy(tok), tcache,
                                      trc)
        plog, pcache = lm.decode_step(tc, tp, torch.from_numpy(tok), pcache,
                                      common.CPU_RC)
        _close(tlog, jlog)
        _close(tlog, plog.numpy())
        tok = np.array(jnp.argmax(jlog, axis=-1), np.int32)
