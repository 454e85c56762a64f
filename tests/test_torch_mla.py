"""The port's multi-head latent attention and ``mla_moe`` family against
the reference on deepseek-v2-lite-16b-smoke, fp32 (CPU_RC) on the CPU:
flash attention with a value head dim below the key's, ``mla_prefill_qkv``,
the weight-absorbed ``mla_decode`` over four steps, and ``lm.prefill``
with four decode steps, with the reference's parameters converted by
``params_from_jax``, its zero ``c_norm`` and a non-zero one.  Inputs are
made with numpy and handed to both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as j_attn
from repro.models import common as j_common
from repro.models import lm as j_lm
from repro_torch.configs import get_config
from repro_torch.models import attention, common, lm

# fp32 on both sides, values of size ~1: a few fp32 ulps of room for
# the other summation orders
ATOL = 1e-5
ARCH = "deepseek-v2-lite-16b-smoke"


def _normal(shape, salt, scale=1.0):
    return (scale * np.random.default_rng([31, salt]).standard_normal(
        shape)).astype(np.float32)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol, rtol=0)


_PARAMS = {}


def _params(c_norm: bool = False):
    """(jax cfg, torch cfg, jax params, torch params); with ``c_norm`` the
    compressed KV norm's scale is non-zero on both sides."""
    if c_norm not in _PARAMS:
        jc, tc = j_get_config(ARCH), get_config(ARCH)
        jp = j_lm.init_params(jc, jax.random.PRNGKey(0), j_common.CPU_RC)
        tree = jax.tree_util.tree_map(np.asarray, jp)
        if c_norm:
            cn = tree["blocks"]["attn"]["c_norm"]
            tree["blocks"]["attn"]["c_norm"] = _normal(cn.shape, 9, 0.5)
            jp = jax.tree_util.tree_map(jnp.asarray, tree)
        tp = lm.params_from_jax(tc, tree, common.CPU_RC, device="cpu")
        _PARAMS[c_norm] = (jc, tc, jp, tp)
    return _PARAMS[c_norm]


def _layer0(jp, tp):
    return (jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["attn"]),
            lm._layer(tp["blocks"]["attn"], 0))


@pytest.mark.parametrize("S,H", [(8, 4), (16, 2), (24, 4)])
def test_flash_attention_with_a_narrower_value_head(S, H):
    """The smoke config's MLA prefill shape: dqk 24, dv 16, scale
    24 ** -0.5, against the reference's jnp flash."""
    q, k = _normal((2, S, H, 24), 1), _normal((2, S, H, 24), 2)
    v = _normal((2, S, H, 16), 3)
    out = attention.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v))
    want = j_attn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True)
    assert out.shape == (2, S, H, 16)
    _close(out, want)


@pytest.mark.parametrize("c_norm", [False, True])
def test_mla_prefill_qkv(c_norm):
    jc, tc, jp, tp = _params(c_norm)
    jpa, tpa = _layer0(jp, tp)
    x = _normal((2, 7, tc.d_model), 4)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7)) + 5
    got = attention.mla_prefill_qkv(torch.from_numpy(x), tpa, tc,
                                    torch.from_numpy(pos))
    want = j_attn.mla_prefill_qkv(jnp.asarray(x), jpa, jc, jnp.asarray(pos))
    m = tc.mla
    shapes = [(2, 7, 4, m.qk_nope_dim + m.qk_rope_dim)] * 2 + [
        (2, 7, 4, m.v_head_dim), (2, 7, m.kv_lora_rank), (2, 7, m.qk_rope_dim)]
    for t, j, shape in zip(got, want, shapes):
        assert tuple(t.shape) == shape
        _close(t, j)


@pytest.mark.parametrize("c_norm", [False, True])
def test_mla_decode_four_steps(c_norm):
    """Four weight-absorbed decode steps from position 5 of a 12-slot
    compressed cache; the port writes the cache in place."""
    jc, tc, jp, tp = _params(c_norm)
    jpa, tpa = _layer0(jp, tp)
    m = tc.mla
    c0 = _normal((2, 12, m.kv_lora_rank), 5)
    kr0 = _normal((2, 12, m.qk_rope_dim), 6)
    tcc, tkr = torch.from_numpy(c0.copy()), torch.from_numpy(kr0.copy())
    jcc, jkr = jnp.asarray(c0), jnp.asarray(kr0)
    for step, pos in enumerate(range(5, 9)):
        x = _normal((2, tc.d_model), 10 + step)
        out = attention.mla_decode(torch.from_numpy(x), tpa, tc, tcc, tkr,
                                   pos)
        jout, jcc, jkr = j_attn.mla_decode(jnp.asarray(x), jpa, jc, jcc, jkr,
                                           pos)
        assert out.shape == (2, tc.d_model)
        _close(out, jout)
        _close(tcc, jcc)
        _close(tkr, jkr)


@pytest.mark.parametrize("c_norm", [False, True])
def test_prefill_then_four_greedy_decode_steps(c_norm):
    """Batch 2, a 10-token prompt, a 16-slot cache; the decode steps route
    the batch as one MoE row."""
    jc, tc, jp, tp = _params(c_norm)
    prompt = np.random.default_rng(7).integers(0, tc.vocab, (2, 10),
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
    assert tcache["pos"] == int(jcache["pos"]) == 14
    for k in ("cc", "ckr"):
        assert tuple(tcache[k].shape) == jcache[k].shape
        _close(tcache[k], jcache[k])


def test_init_cache_matches_reference():
    jc, tc, _, _ = _params()
    jcache = j_lm.init_cache(jc, 2, 16, j_common.CPU_RC)
    tcache = lm.init_cache(tc, 2, 16, common.CPU_RC, device="cpu")
    assert set(tcache) == set(jcache) == {"cc", "ckr", "pos"}
    for k in ("cc", "ckr"):
        assert tuple(tcache[k].shape) == jcache[k].shape
    assert tcache["pos"] == 0


def test_c_norm_stays_in_the_parameter_dtype():
    """``c_norm`` is a norm scale read as fp32: under the bf16 runtime it
    keeps its fp32 values, where a bf16 cast would round them."""
    jc, tc, jp, _ = _params(c_norm=True)
    tp = lm.params_from_jax(tc, jax.tree_util.tree_map(np.asarray, jp),
                            common.DEFAULT_RC, device="cpu")
    cn = tp["blocks"]["attn"]["c_norm"]
    assert cn.dtype == torch.float32
    _close(cn, jp["blocks"]["attn"]["c_norm"], atol=0)
    assert tp["blocks"]["attn"]["w_uk"].dtype == torch.bfloat16
