"""The port's RG-LRU pieces and local attention against the reference on
the CPU (fp32), on recurrentgemma-2b-smoke's widths: the reference's
parameters (``lm._rglru_block_params``) converted to torch, inputs made
with numpy from a seed and handed to both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels.rglru_scan import rglru_scan_tpu as j_rglru
from repro.models import attention as j_attn
from repro.models import lm as j_lm
from repro.models import recurrent as j_rec
from repro_torch.configs import get_config
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention_tpu
from repro_torch.kernels.rglru_scan import rglru_scan_tpu
from repro_torch.models import attention, recurrent

ATOL = 1e-5
ARCH = "recurrentgemma-2b-smoke"


def _normal(shape, salt):
    return np.random.default_rng([13, salt]).standard_normal(
        shape).astype(np.float32)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol, rtol=0)


_BLOCK = {}


def _block():
    """(cfg, jax block params, torch block params) of one RG-LRU layer."""
    if not _BLOCK:
        cfg = j_get_config(ARCH)
        jp = j_lm._rglru_block_params(cfg, jax.random.PRNGKey(0),
                                      jnp.float32)
        tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()
              if k != "ln"}
        _BLOCK["v"] = (get_config(ARCH), jp, tp)
    return _BLOCK["v"]


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("S", [1, 16, 37])
def test_rglru_scan_matches_reference(S, with_h0):
    cfg, jp, tp = _block()
    x = _normal((2, S, cfg.rglru.d_rnn), 0)
    h0 = _normal((2, cfg.rglru.d_rnn), 1) if with_h0 else None
    y, h_last = recurrent.rglru_scan(
        torch.from_numpy(x), tp, cfg.n_heads,
        h0=None if h0 is None else torch.from_numpy(h0))
    jy, jh = j_rec.rglru_scan(jnp.asarray(x), jp, cfg.n_heads,
                              h0=None if h0 is None else jnp.asarray(h0))
    assert y.dtype == torch.float32 and h_last.dtype == torch.float32
    _close(y, jy)
    _close(h_last, jh)


@pytest.mark.parametrize("B,S,D,bs,bd", [(2, 128, 256, 32, 128),
                                         (1, 64, 512, 64, 256)])
def test_rglru_wrapper_matches_the_pallas_kernel(B, S, D, bs, bd):
    """The wrapper on the CPU (its plain version) against the reference's
    Pallas kernel in interpret mode, on the test_rglru_kernel_sweep
    shapes."""
    a = np.random.default_rng([13, 2]).uniform(
        0.4, 0.999, (B, S, D)).astype(np.float32)
    b, h0 = _normal((B, S, D), 3), _normal((B, D), 4)
    out = rglru_scan_tpu(torch.from_numpy(a), torch.from_numpy(b),
                         torch.from_numpy(h0), block_s=bs, block_d=bd)
    want = j_rglru(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0),
                   block_s=bs, block_d=bd, interpret=True)
    assert out.shape == (B, S, D) and out.dtype == torch.float32
    _close(out, want)


def test_rglru_wrapper_keeps_reference_asserts():
    a = torch.zeros((1, 48, 64))
    h0 = torch.zeros((1, 64))
    with pytest.raises(AssertionError):
        rglru_scan_tpu(a, a, h0, block_s=32)          # 48 % 32 != 0
    with pytest.raises(AssertionError):
        rglru_scan_tpu(a, a, h0, block_d=48)          # 64 % 48 != 0
    assert rglru_scan_tpu(a, a, h0, block_s=16).shape == (1, 48, 64)


def test_rglru_step_continues_the_scan():
    cfg, jp, tp = _block()
    x = _normal((2, cfg.rglru.d_rnn), 5)
    h = _normal((2, cfg.rglru.d_rnn), 6)
    y, h_new = recurrent.rglru_step(torch.from_numpy(x), tp, cfg.n_heads,
                                    torch.from_numpy(h))
    jy, jh = j_rec.rglru_step(jnp.asarray(x), jp, cfg.n_heads,
                              jnp.asarray(h))
    _close(y, jy)
    _close(h_new, jh)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [1, 9])
def test_causal_conv1d(S, with_state):
    cfg, jp, tp = _block()
    d = cfg.rglru.d_rnn
    x = _normal((2, S, d), 7)
    b = _normal((d,), 8)
    state = _normal((2, cfg.rglru.conv_width - 1, d), 9) \
        if with_state else None
    y, st = recurrent.causal_conv1d(
        torch.from_numpy(x), tp["conv_w"], torch.from_numpy(b),
        state=None if state is None else torch.from_numpy(state))
    jy, jst = j_rec.causal_conv1d(
        jnp.asarray(x), jp["conv_w"], jnp.asarray(b),
        state=None if state is None else jnp.asarray(state))
    _close(y, jy)
    _close(st, jst, atol=0)


def test_block_diag_linear():
    cfg, jp, tp = _block()
    H = cfg.n_heads
    x = _normal((2, 3, H, cfg.rglru.d_rnn // H), 10)
    _close(recurrent.block_diag_linear(torch.from_numpy(x), tp["w_a"],
                                       tp["b_a"]),
           j_rec.block_diag_linear(jnp.asarray(x), jp["w_a"], jp["b_a"]))
    _close(recurrent.block_diag_linear(torch.from_numpy(x), tp["w_x"]),
           j_rec.block_diag_linear(jnp.asarray(x), jp["w_x"]))


@pytest.mark.parametrize("S,Hq,Hkv", [(64, 4, 1), (64, 4, 2), (16, 4, 1),
                                      (96, 2, 2)])
def test_local_attention_matches_reference(S, Hq, Hkv):
    """Smoke window 32; at S 64 and 96 the band really cuts."""
    window = get_config(ARCH).rglru.window
    q, k, v = (_normal((2, S, H, 16), 11 + i)
               for i, H in enumerate((Hq, Hkv, Hkv)))
    out = attention.local_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), window=window)
    want = j_attn.local_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), window=window)
    assert out.shape == (2, S, Hq, 16)
    _close(out, want)


def test_flash_window_plain_version_matches_local_attention():
    """The kernel's wrapper on the CPU (kernel layout, block sizes that
    split S) against the reference's banded attention."""
    q, k, v = (_normal((1, 48, H, 32), 20 + i)
               for i, H in enumerate((4, 1, 1)))
    out = flash_attention_tpu(*(torch.from_numpy(t).transpose(1, 2)
                                for t in (q, k, v)),
                              block_q=16, block_kv=16, window=8)
    want = j_attn.local_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), window=8, block_q=16)
    _close(out.transpose(1, 2), want)
    # window >= S is plain causal attention
    _close(tref.flash_attention_ref(*(torch.from_numpy(t).transpose(1, 2)
                                      for t in (q, k, v)), window=48),
           tref.flash_attention_ref(*(torch.from_numpy(t).transpose(1, 2)
                                      for t in (q, k, v))), atol=0)


def test_local_attention_refuses_unported_options():
    q = torch.zeros((1, 4, 2, 16))
    with pytest.raises(NotImplementedError):
        attention.local_attention(q, q, q, window=2, q_offset=4)
    with pytest.raises(ValueError):
        flash_attention_tpu(q, q, q, causal=False, window=2)
