"""The port's ``vlm`` (llava-next-34b) and ``audio`` (musicgen-large)
families against the reference on their smoke configs, fp32 (CPU_RC) on
the CPU, with the reference's parameters converted by
``params_from_jax``: prefill and four greedy decode steps, the vlm with and
without a prefix of patch embeddings, the audio family on (B, S, K)
codebook tokens with (B, K, V) logits; and the refusal of a (1, S) prompt
on the audio family, by the port's server as by the reference's.  Inputs
are made with numpy and handed to both."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import serving as j_serving
from repro.core import task as j_task
from repro.models import common as j_common
from repro.models import lm as j_lm
from repro_torch.configs import get_config
from repro_torch.core import serving, task
from repro_torch.models import common, lm

ATOL = 1e-5
VLM = "llava-next-34b-smoke"
AUDIO = "musicgen-large-smoke"


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol, rtol=0)


_PARAMS = {}


def _params(arch, tied=True):
    """(jax cfg, torch cfg, jax params, torch params); the smoke configs
    tie the embeddings, ``tied=False`` gives the published untied head."""
    key = (arch, tied)
    if key not in _PARAMS:
        jc, tc = j_get_config(arch), get_config(arch)
        if not tied:
            jc = dataclasses.replace(jc, tie_embeddings=False)
            tc = dataclasses.replace(tc, tie_embeddings=False)
        jp = j_lm.init_params(jc, jax.random.PRNGKey(0), j_common.CPU_RC)
        tp = lm.params_from_jax(tc, jax.tree_util.tree_map(np.asarray, jp),
                                common.CPU_RC, device="cpu")
        _PARAMS[key] = (jc, tc, jp, tp)
    return _PARAMS[key]


def test_every_reference_family_is_ported():
    from repro_torch.configs import ARCHS
    assert set(lm.FAMILIES) == {c.family for c in ARCHS.values()}
    assert len(lm.FAMILIES) == 7


@pytest.mark.parametrize("arch", [VLM, AUDIO])
@pytest.mark.parametrize("tied", [True, False])
def test_params_have_the_reference_layout(arch, tied):
    """The audio table holds K x V rows and its untied head K x V
    columns."""
    jc, tc, jp, tp = _params(arch, tied)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), tp) == shapes
    made = lm.init_params(tc, torch.Generator().manual_seed(0),
                          common.CPU_RC, device="cpu")
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), made) == shapes
    rows = tc.vocab * (tc.n_codebooks if tc.family == "audio" else 1)
    assert tuple(made["embed"].shape) == (rows, tc.d_model)
    if not tied:
        assert tuple(made["lm_head"].shape) == (tc.d_model, rows)


def _vlm_batch(tc, B, n_text, with_vis, salt=0):
    rng = np.random.default_rng(salt)
    b = {"tokens": rng.integers(0, tc.vocab, (B, n_text), dtype=np.int32)}
    if with_vis:
        b["vis_embeds"] = rng.standard_normal(
            (B, tc.n_frontend_tokens, tc.d_model)).astype(np.float32)
    return b


def _audio_batch(tc, B, S, salt=0):
    rng = np.random.default_rng(salt)
    return {"tokens": rng.integers(0, tc.vocab, (B, S, tc.n_codebooks),
                                   dtype=np.int32)}


def _run_both(arch, tied, batch, max_len, steps=4):
    """Prefill and ``steps`` greedy decode steps on both sides; every
    logit and the KV cache compared.  Returns the prompt's length."""
    jc, tc, jp, tp = _params(arch, tied)
    jlog, jcache = j_lm.prefill(jc, jp, {k: jnp.asarray(v)
                                         for k, v in batch.items()},
                                j_common.CPU_RC, max_len=max_len)
    tlog, tcache = lm.prefill(tc, tp, {k: torch.from_numpy(v)
                                       for k, v in batch.items()},
                              common.CPU_RC, max_len=max_len)
    assert tuple(tlog.shape) == jlog.shape
    _close(tlog, jlog)
    S = int(jcache["pos"])
    assert tcache["pos"] == S
    jdec = jax.jit(lambda p, t, c: j_lm.decode_step(jc, p, t, c,
                                                    j_common.CPU_RC))
    tok = np.array(jnp.argmax(jlog, axis=-1), np.int32)
    for _ in range(steps):
        jlog, jcache = jdec(jp, jnp.asarray(tok), jcache)
        tlog, tcache = lm.decode_step(tc, tp, torch.from_numpy(tok), tcache,
                                      common.CPU_RC)
        assert tuple(tlog.shape) == jlog.shape
        _close(tlog, jlog)
        tok = np.array(jnp.argmax(jlog, axis=-1), np.int32)
        assert torch.argmax(tlog, dim=-1).tolist() == tok.tolist()
    for k in ("ck", "cv"):
        assert tuple(tcache[k].shape) == jcache[k].shape
        _close(tcache[k], jcache[k])
    assert tcache["pos"] == int(jcache["pos"]) == S + steps
    return S


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("with_vis", [True, False])
def test_vlm_prefill_then_four_greedy_decode_steps(with_vis, tied):
    """Eight patch embeddings before eight text tokens (16 positions,
    RoPE over all of them), or the text alone; batch 2."""
    _, tc, _, _ = _params(VLM)
    S = _run_both(VLM, tied, _vlm_batch(tc, 2, 8, with_vis), max_len=24)
    assert S == 8 + (tc.n_frontend_tokens if with_vis else 0)


def test_vlm_prefix_is_cast_to_the_text_embeddings_dtype():
    _, tc, _, tp = _params(VLM)
    batch = _vlm_batch(tc, 1, 4, True)
    batch["vis_embeds"] = batch["vis_embeds"].astype(np.float64)
    h = lm.embed_inputs(tc, tp, {k: torch.from_numpy(v)
                                 for k, v in batch.items()}, common.CPU_RC)
    assert h.dtype == torch.float32 and h.shape == (1, 12, tc.d_model)
    _close(h[:, :8], batch["vis_embeds"])


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("B,S", [(1, 8), (2, 12)])
def test_audio_prefill_then_four_greedy_decode_steps(B, S, tied):
    """(B, S, K) prompts, (B, K) decode tokens, (B, K, V) logits, greedy
    per codebook."""
    _, tc, _, _ = _params(AUDIO)
    _run_both(AUDIO, tied, _audio_batch(tc, B, S), max_len=S + 8)


def test_audio_embeds_sum_the_codebooks():
    jc, tc, jp, tp = _params(AUDIO)
    batch = _audio_batch(tc, 2, 5, salt=3)
    h = lm.embed_inputs(tc, tp, {"tokens": torch.from_numpy(batch["tokens"])},
                        common.CPU_RC)
    _close(h, j_lm.embed_inputs(jc, jp, {"tokens": jnp.asarray(
        batch["tokens"])}, j_common.CPU_RC))
    emb, toks = tp["embed"], torch.from_numpy(batch["tokens"]).long()
    want = sum(emb[toks[..., c] + c * tc.vocab] for c in range(4))
    _close(h, want.numpy())


@pytest.mark.parametrize("shape", [(1, 8), (1, 8, 3)])
def test_audio_refuses_tokens_without_k_codebooks(shape):
    _, tc, _, tp = _params(AUDIO)
    with pytest.raises(ValueError, match=r"\(B, S, K=4\)"):
        lm.embed_inputs(tc, tp, {"tokens": torch.zeros(shape,
                                                       dtype=torch.long)},
                        common.CPU_RC)


def test_audio_is_refused_by_both_servers():
    """The servers feed a (1, S) prompt: the reference fails to broadcast
    it against the codebook offsets, the port refuses it, naming the
    (B, S, K) layout; both raise ValueError before any token."""
    jc, tc, jp, tp = _params(AUDIO)
    prompt = np.arange(8, dtype=np.int32)
    for srv_mod, crit, cfg, params, match in (
            (j_serving, j_task.Crit, jc, jp, "broadcast"),
            (serving, task.Crit, tc, tp, r"\(B, S, K=4\)")):
        srv = srv_mod.MESCServer(cfg, params, max_len=32)
        r = srv_mod.Request(rid=0, priority=0, prompt=prompt,
                            max_new_tokens=4, crit=crit.LO)
        srv.submit(r)
        with pytest.raises(ValueError, match=match):
            srv.step()
        assert r.generated == []
