"""The port's xLSTM cells and ``xlstm`` family against the reference on
xlstm-125m-smoke, fp32 (CPU_RC) on the CPU: the mLSTM's parallel,
chunkwise and step forms, its final state, the per-head group norm and
the sLSTM, each with and without an initial state, then ``lm.prefill``
with four decode steps through both prefill branches (the parallel form
below the chunk, the chunkwise form at a multiple of it), with the
reference's parameters converted by ``params_from_jax``.  Inputs are made
with numpy and handed to both."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import common as j_common
from repro.models import lm as j_lm
from repro.models import recurrent as j_rec
from repro_torch.configs import get_config
from repro_torch.models import common, lm
from repro_torch.models import recurrent as rec

# fp32 on both sides; the stabilised exponentials and the per-head norms
# keep values of size ~1, so a few fp32 ulps of room for the summation
# orders
ATOL = RTOL = 1e-4
ARCH = "xlstm-125m-smoke"
B, H, DH = 2, 3, 8


def _normal(shape, salt, scale=1.0):
    return (scale * np.random.default_rng([23, salt]).standard_normal(
        shape)).astype(np.float32)


def _close(t, j, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol,
                               rtol=rtol)


def _cells(S, salt=0):
    """q, k, v (B,H,S,DH); log_i and log_f (B,H,S) as the model makes
    them: a raw input gate and a log-sigmoid forget gate near 3."""
    q, k, v = (_normal((B, H, S, DH), salt + i) for i in range(3))
    log_i = _normal((B, H, S), salt + 3)
    f_pre = _normal((B, H, S), salt + 4) + 3.0
    log_f = -np.logaddexp(0.0, -f_pre).astype(np.float32)
    return q, k, v, log_i, log_f


def _state(salt):
    """An mLSTM state (C, n, m) as a prefill leaves it: m of either sign."""
    return (_normal((B, H, DH, DH), salt), _normal((B, H, DH), salt + 1),
            _normal((B, H), salt + 2, 2.0))


def _t(arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def test_mlstm_parallel():
    args = _cells(12)
    out = rec.mlstm_parallel(*_t(args))
    assert out.shape == (B, H, 12, DH) and out.dtype == torch.float32
    _close(out, j_rec.mlstm_parallel(*_j(args)))


def test_mlstm_parallel_keeps_the_input_dtype():
    """bf16 in, bf16 out; the scores and the value product in fp32 as the
    reference's ``preferred_element_type``."""
    args = _cells(12)
    q, k, v = (torch.from_numpy(a).bfloat16() for a in args[:3])
    out = rec.mlstm_parallel(q, k, v, *_t(args[3:]))
    want = j_rec.mlstm_parallel(*(jnp.asarray(t.float().numpy(),
                                              jnp.bfloat16)
                                  for t in (q, k, v)), *_j(args[3:]))
    assert out.dtype == torch.bfloat16
    _close(out, want.astype(jnp.float32), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S,chunk", [(12, 4), (16, 8), (24, 8)])
def test_mlstm_chunkwise(S, chunk, with_state):
    """At least two chunks, from the empty state or a given one."""
    args = _cells(S, salt=10)
    st = _state(20) if with_state else None
    out, (C, n, m) = rec.mlstm_chunkwise(*_t(args), chunk=chunk,
                                         state=_t(st) if st else None)
    jout, (jC, jn, jm) = j_rec.mlstm_chunkwise(*_j(args), chunk=chunk,
                                               state=_j(st) if st else None)
    assert out.shape == (B, H, S, DH)
    _close(out, jout)
    for t, j in ((C, jC), (n, jn), (m, jm)):
        _close(t, j)


@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_final_state(with_state):
    args = _cells(10, salt=30)
    st = _state(40) if with_state else None
    got = rec.mlstm_final_state(*_t(args), state=_t(st) if st else None)
    want = j_rec.mlstm_final_state(*_j(args), state=_j(st) if st else None)
    for t, j in zip(got, want):
        _close(t, j)


@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_step_over_a_sequence(with_state):
    """Eight steps, each output and the state after each step."""
    q, k, v, log_i, log_f = _cells(8, salt=50)
    if with_state:
        st = _state(60)
        tst, jst = _t(st), _j(st)
    else:
        tst = rec._empty_mlstm_state(B, H, DH, DH)
        jst = j_rec._empty_mlstm_state(B, H, DH, DH)
    for s in range(8):
        a = (q[:, :, s], k[:, :, s], v[:, :, s], log_i[..., s],
             log_f[..., s])
        out, tst = rec.mlstm_step(*_t(a), tst)
        jout, jst = j_rec.mlstm_step(*_j(a), jst)
        _close(out, jout)
        for t, j in zip(tst, jst):
            _close(t, j)


def test_empty_mlstm_state():
    for t, j in zip(rec._empty_mlstm_state(B, H, DH, 5),
                    j_rec._empty_mlstm_state(B, H, DH, 5)):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
        _close(t, j, atol=0, rtol=0)


def test_groupnorm_heads():
    """The population variance (jnp.var), per head, scaled."""
    x = _normal((2, 5, 4 * 16), 70, 3.0) + 1.0
    scale = _normal((4 * 16,), 71)
    _close(rec.groupnorm_heads(torch.from_numpy(x), torch.from_numpy(scale),
                               4),
           j_rec.groupnorm_heads(jnp.asarray(x), jnp.asarray(scale), 4))


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_seq(with_state):
    """The head-major recurrent product split into z, i, f, o as the
    reference lays it out; recurrent weights large enough to matter."""
    D, nh = 16, 4
    p = {"w_in": _normal((D, 4 * D), 80, 0.3),
         "r": _normal((nh, D // nh, 4 * D // nh), 81, 0.5),
         "b": _normal((4 * D,), 82)}
    x = _normal((B, 9, D), 83)
    st = (_normal((B, D), 84), np.abs(_normal((B, D), 85)) + 0.5,
          _normal((B, D), 86), _normal((B, D), 87)) if with_state else None
    y, new = rec.slstm_seq(torch.from_numpy(x),
                           {k: torch.from_numpy(a) for k, a in p.items()},
                           nh, state=_t(st) if st else None)
    jy, jnew = j_rec.slstm_seq(jnp.asarray(x),
                               {k: jnp.asarray(a) for k, a in p.items()},
                               nh, state=_j(st) if st else None)
    _close(y, jy)
    for t, j in zip(new, jnew):
        _close(t, j)


# ---------------------------------------------------------------------------
# the family
# ---------------------------------------------------------------------------

# the smoke config (one group of mLSTM + sLSTM) and a deeper cut of it,
# two groups of two mLSTM layers and one sLSTM, so that both stacked
# dims of the mLSTM leaves are > 1
DEPTHS = {"smoke": {}, "2x3": {"n_layers": 6}}
_PARAMS = {}


def _params(depth="smoke"):
    if depth not in _PARAMS:
        jc, tc = j_get_config(ARCH), get_config(ARCH)
        if DEPTHS[depth]:
            jc = dataclasses.replace(
                jc, xlstm=dataclasses.replace(jc.xlstm, slstm_every=3),
                **DEPTHS[depth])
            tc = dataclasses.replace(
                tc, xlstm=dataclasses.replace(tc.xlstm, slstm_every=3),
                **DEPTHS[depth])
        jp = j_lm.init_params(jc, jax.random.PRNGKey(0), j_common.CPU_RC)
        tp = lm.params_from_jax(tc, jax.tree_util.tree_map(np.asarray, jp),
                                common.CPU_RC, device="cpu")
        _PARAMS[depth] = (jc, tc, jp, tp)
    return _PARAMS[depth]


@pytest.mark.parametrize("depth", list(DEPTHS))
def test_params_have_the_reference_layout(depth):
    """init_params and params_from_jax give the reference's tree: the
    mLSTM leaves stacked (G, n_m, ...), the sLSTM's (G, ...); the sLSTM's
    fp32 leaves stay fp32 under the bf16 runtime."""
    jc, tc, jp, tp = _params(depth)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), tp) == shapes
    made = lm.init_params(tc, torch.Generator().manual_seed(0),
                          common.CPU_RC, device="cpu")
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), made) == shapes
    G = tc.n_layers // tc.xlstm.slstm_every
    assert made["blocks"]["m"]["w_up"].shape[:2] == \
        (G, tc.xlstm.slstm_every - 1)
    _close(made["blocks"]["m"]["b_if"], jp["blocks"]["m"]["b_if"], 0, 0)
    _close(made["blocks"]["s"]["b"], jp["blocks"]["s"]["b"], 0, 0)
    bf = lm.params_from_jax(tc, jax.tree_util.tree_map(np.asarray, jp),
                            common.DEFAULT_RC, device="cpu")
    s = bf["blocks"]["s"]
    assert {k: s[k].dtype for k in ("w_in", "r", "b", "gn")} == \
        dict.fromkeys(("w_in", "r", "b", "gn"), torch.float32)
    assert s["ln_mlp"]["scale"].dtype == torch.float32
    assert s["mlp"]["w1"].dtype == bf["blocks"]["m"]["w_q"].dtype \
        == torch.bfloat16
    _close(s["r"], jp["blocks"]["s"]["r"], 0, 0)


def test_init_cache_matches_reference():
    jc, tc, _, _ = _params("2x3")
    jcache = j_lm.init_cache(jc, 2, 16, j_common.CPU_RC)
    tcache = lm.init_cache(tc, 2, 16, common.CPU_RC, device="cpu")
    assert set(tcache) == set(jcache)
    for k, j in jcache.items():
        if k == "pos":
            assert tcache[k] == 0
            continue
        assert tuple(tcache[k].shape) == j.shape, k
        assert str(tcache[k].dtype).replace("torch.", "") == str(j.dtype)
        _close(tcache[k], j, atol=0, rtol=0)


@pytest.mark.parametrize("depth", list(DEPTHS))
@pytest.mark.parametrize("S", [8, 32])
def test_prefill_then_four_greedy_decode_steps(S, depth):
    """Batch 2; S 8 takes the parallel form and its final state, S 32 the
    chunkwise form (two chunks of 16); every cache leaf after the prefill
    and after the decode steps."""
    jc, tc, jp, tp = _params(depth)
    prompt = np.random.default_rng(5).integers(0, tc.vocab, (2, S),
                                               dtype=np.int32)
    jlog, jcache = j_lm.prefill(jc, jp, {"tokens": jnp.asarray(prompt)},
                                j_common.CPU_RC, max_len=S + 8)
    tlog, tcache = lm.prefill(tc, tp, {"tokens": torch.from_numpy(prompt)},
                              common.CPU_RC, max_len=S + 8)
    _close(tlog, jlog)
    for k in jcache:
        if k != "pos":
            _close(tcache[k], jcache[k])
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
    assert tcache["pos"] == int(jcache["pos"]) == S + 4
    for k in jcache:
        if k != "pos":
            _close(tcache[k], jcache[k])


def test_decode_writes_the_state_in_place():
    """The serving loop keeps the cache dict it is handed: a decode step
    updates its tensors and returns them with pos + 1."""
    _, tc, _, tp = _params()
    _, cache = lm.prefill(tc, tp, {"tokens": torch.ones((1, 4),
                                                        dtype=torch.long)},
                          common.CPU_RC)
    before = {k: v.clone() for k, v in cache.items() if k != "pos"}
    _, out = lm.decode_step(tc, tp, torch.tensor([3]), cache, common.CPU_RC)
    assert out["pos"] == 5
    for k, t in before.items():
        assert out[k] is cache[k]
        assert not torch.equal(cache[k], t), k
