"""The port's training side against the reference on the smoke configs,
on the CPU: ``lm.forward``, ``lm.loss_fn`` and every parameter gradient
against ``jax.value_and_grad(lm.loss_fn)`` for the seven families, the
remat policies, ``chunked_xent``, prefill/decode against ``forward`` for
the ten archs, bf16 compute on fp32 master weights, ``make_train_step``
against the reference's, and the kernel wrappers' refusal to be
differentiated.  Parameters come from the reference's ``init_params``
through ``params_from_jax(..., master=True)``; inputs are made with numpy
and handed to both.

Tolerances (fp32, CPU_RC; the two packages sum in other orders):
- logits: atol 2e-5; loss and metrics: atol 1e-5 + rtol 1e-5;
- gradients: max |port - reference| <= 1e-4 x max |reference| of that
  leaf, + 1e-7;
- three AdamW steps, fp32 moments: parameters atol 2e-6, except where
  either package's first clipped gradient is below 100 x eps (eps 1e-8):
  AdamW's first update lr * g / (|g| + eps) has the slope
  lr * eps / (|g| + eps)^2 there (~4e7 at |g| ~ eps), so a gradient gap
  of 1e-7 of the leaf's scale moves such a weight by ~3e-6.  Those
  elements' gradients are held to the gradient tolerance, and their
  parameters to atol plus the gap that the updates imply: both packages'
  gradients of each step, clipped, run through AdamW's arithmetic in
  float64 from the same start (the first update's lr * eps * |dg| /
  (min |g| + eps)^2 to first order); bf16 moments
  (the default): atol 5e-4, because an fp32 difference of one ulp in
  ``b * m + (1 - b) * g`` (XLA:CPU may contract it into an FMA) can flip
  the bf16 rounding of a moment, and an lr of 3e-3 moves a weight by
  ~lr x (a moment's relative error, up to 2^-8);
- bf16 compute (compute_dtype bf16, fp32 master weights): loss atol 3e-2
  against the reference under the same RuntimeConfig (bf16 activations
  round at ~4e-3 relative, in other places on each side);
- prefill/decode against forward: the reference's own test's atol 2e-3,
  rtol 1e-3;
- remat policies and the microbatch split: equal to ``"none"`` / one
  batch, bit for bit for remat (recomputation repeats the same
  operations), atol 2e-6 for the microbatches' parameters.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import common as j_common
from repro.models import lm as j_lm
from repro.optim import OptConfig as JOptConfig
from repro.optim import init_opt_state as j_init_opt_state
from repro.runtime import trainer as j_trainer
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import common, lm
from repro_torch.optim import OptConfig, init_opt_state, lr_schedule, \
    opt_state_from_jax
from repro_torch.pytree import tree_items, tree_leaves, tree_unflatten
from repro_torch.runtime import trainer

ARCHS = ["tinyllama-1.1b", "llama4-maverick-400b-a17b",
         "deepseek-v2-lite-16b", "olmo-1b", "phi4-mini-3.8b",
         "qwen1.5-110b", "recurrentgemma-2b", "llava-next-34b",
         "xlstm-125m", "musicgen-large"]
# one arch of each family, with the sequence length that exercises it:
# the hybrid's window (32) inside S, xlstm's chunkwise mLSTM (S 32 > chunk
# 16) and its parallel form (S 16)
FAMILY_CASES = [("tinyllama-1.1b", 16), ("llama4-maverick-400b-a17b", 16),
                ("deepseek-v2-lite-16b", 16), ("recurrentgemma-2b", 64),
                ("xlstm-125m", 16), ("xlstm-125m", 32),
                ("llava-next-34b", 16), ("musicgen-large", 16)]
LOGIT_ATOL = 2e-5
GRAD_RTOL = 1e-4

_PARAMS = {}


def _params(arch):
    """(jax cfg, torch cfg, jax params, torch master params), CPU_RC."""
    if arch not in _PARAMS:
        jc, tc = j_get_config(arch + "-smoke"), get_config(arch + "-smoke")
        jp = j_lm.init_params(jc, jax.random.PRNGKey(0), j_common.CPU_RC)
        tp = lm.params_from_jax(tc, jax.tree_util.tree_map(np.asarray, jp),
                                common.CPU_RC, device="cpu", master=True)
        _PARAMS[arch] = (jc, tc, jp, tp)
    return _PARAMS[arch]


def _batch(tc, B, S, salt=1):
    """tokens and next-token labels (vlm: S counts its patch embeddings,
    whose positions get no label)."""
    rng = np.random.default_rng(salt)
    nf = tc.n_frontend_tokens if tc.family == "vlm" else 0
    shape = (B, S - nf) + ((tc.n_codebooks,) if tc.family == "audio"
                           else ())
    toks = rng.integers(0, tc.vocab, shape, dtype=np.int32)
    b = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if nf:
        b["vis_embeds"] = (rng.standard_normal((B, nf, tc.d_model))
                           * 0.02).astype(np.float32)
    return b


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _grads(tc, tp, batch, rc=common.CPU_RC):
    """(loss, metrics, {path: grad}) of the port's loss_fn."""
    (loss, metrics), grads = trainer.loss_and_grads(tc, tp, _t(batch), rc)
    return loss, metrics, dict(tree_items(grads))


def _jax_loss_and_grads(jc, jp, batch, rc=j_common.CPU_RC):
    (loss, metrics), g = jax.value_and_grad(
        lambda p: j_lm.loss_fn(jc, p, _j(batch), rc), has_aux=True)(jp)
    return loss, metrics, dict(tree_items(
        jax.tree_util.tree_map(np.asarray, g)))


def _close_scalar(t, j, what):
    assert abs(float(t) - float(j)) <= 1e-5 + 1e-5 * abs(float(j)), \
        (what, float(t), float(j))


@pytest.mark.parametrize("arch,S", FAMILY_CASES)
def test_forward_logits_match_the_reference(arch, S):
    jc, tc, jp, tp = _params(arch)
    batch = _batch(tc, 2, S)
    jl, jm = j_lm.forward(jc, jp, _j(batch), j_common.CPU_RC)
    with torch.no_grad():
        tl, tm = lm.forward(tc, tp, _t(batch), common.CPU_RC)
    assert tuple(tl.shape) == jl.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        _close_scalar(tm[k], jm[k], k)
    h, _ = lm.forward(tc, tp, _t(batch), common.CPU_RC, return_hidden=True)
    assert tuple(h.shape) == tuple(tl.shape[:2]) + (tc.d_model,)


@pytest.mark.parametrize("arch,S", FAMILY_CASES)
def test_loss_metrics_and_every_gradient_match_the_reference(arch, S):
    jc, tc, jp, tp = _params(arch)
    batch = _batch(tc, 2, S)
    jloss, jm, jg = _jax_loss_and_grads(jc, jp, batch)
    tloss, tm, tg = _grads(tc, tp, batch)
    _close_scalar(tloss, jloss, "loss")
    assert sorted(tm) == sorted(jm)
    for k in jm:
        _close_scalar(tm[k], jm[k], k)
    if tc.family in ("moe", "mla_moe"):
        assert float(tm["moe_aux"]) > 0 and float(tm["moe_z"]) > 0
    if tc.family == "vlm":          # the patch positions carry no label
        assert float(tm["ntokens"]) == batch["labels"].size
    assert sorted(tg) == sorted(jg)
    for path, g in tg.items():
        want = jg[path]
        assert tuple(g.shape) == want.shape and g.dtype == torch.float32
        bound = GRAD_RTOL * float(np.abs(want).max()) + 1e-7
        err = float(np.abs(g.numpy() - want).max())
        assert err <= bound, (path, err, bound)


def test_a_hybrid_shorter_than_its_pattern_matches_the_reference():
    """recurrentgemma cut to 2 layers (rglru, rglru) has an empty
    attention stack that the loss never reaches: jax.grad gives its
    leaves zeros, and so does the port (torch.autograd.grad would raise
    on a leaf outside the graph)."""
    jc = dataclasses.replace(j_get_config("recurrentgemma-2b-smoke"),
                             n_layers=2)
    tc = dataclasses.replace(get_config("recurrentgemma-2b-smoke"),
                             n_layers=2)
    jp = j_lm.init_params(jc, jax.random.PRNGKey(0), j_common.CPU_RC)
    tp = lm.params_from_jax(tc, jax.tree_util.tree_map(np.asarray, jp),
                            common.CPU_RC, device="cpu", master=True)
    batch = _batch(tc, 2, 16)
    jloss, _, jg = _jax_loss_and_grads(jc, jp, batch)
    tloss, _, tg = _grads(tc, tp, batch)
    _close_scalar(tloss, jloss, "loss")
    assert sorted(tg) == sorted(jg)
    assert any(g.numel() == 0 for g in tg.values())
    for path, g in tg.items():
        assert tuple(g.shape) == jg[path].shape
        if g.numel():
            bound = GRAD_RTOL * float(np.abs(jg[path]).max()) + 1e-7
            assert float(np.abs(g.numpy() - jg[path]).max()) <= bound, path


def test_moe_metrics_are_summed_over_layers():
    """DeepSeek's smoke config has two MoE layers: forward's metrics are
    the sum of each layer's ``moe_apply`` metrics."""
    jc, tc, jp, tp = _params("deepseek-v2-lite-16b")
    assert tc.n_layers == 2
    batch = _batch(tc, 2, 16)
    seen = []
    real = lm.ffn_lib.moe_apply

    def spy(x, p, cfg):
        y, m = real(x, p, cfg)
        seen.append({k: float(v) for k, v in m.items()})
        return y, m
    lm.ffn_lib.moe_apply = spy
    try:
        with torch.no_grad():
            _, tm = lm.forward(tc, tp, _t(batch), common.CPU_RC)
    finally:
        lm.ffn_lib.moe_apply = real
    assert len(seen) == 2
    for k in lm.MOE_METRIC_KEYS:
        assert abs(float(tm[k]) - sum(s[k] for s in seen)) <= 1e-6


def test_blocked_attention_over_several_blocks_matches_the_reference():
    """Query and key blocks of 8 over 32 tokens: the online softmax
    across blocks, masked blocks included, as the reference's."""
    jc, tc, jp, tp = _params("tinyllama-1.1b")
    jrc = dataclasses.replace(j_common.CPU_RC, flash_block_q=8,
                              flash_block_kv=8)
    trc = dataclasses.replace(common.CPU_RC, flash_block_q=8,
                              flash_block_kv=8)
    batch = _batch(tc, 2, 32)
    jloss, _, jg = _jax_loss_and_grads(jc, jp, batch, jrc)
    tloss, _, tg = _grads(tc, tp, batch, trc)
    _close_scalar(tloss, jloss, "loss")
    for path, g in tg.items():
        bound = GRAD_RTOL * float(np.abs(jg[path]).max()) + 1e-7
        assert float(np.abs(g.numpy() - jg[path]).max()) <= bound, path


def test_blocked_attention_twins_match_the_reference_directly():
    from repro.models import attention as j_attn
    from repro_torch.models import attention as attn
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 64, 8, 16)).astype(np.float32)
    k = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
    T = [torch.from_numpy(a) for a in (q, k, v)]
    J = [jnp.asarray(a) for a in (q, k, v)]
    for causal in (True, False):
        got = attn.blocked_attention(*T, causal=causal, block_q=16,
                                     block_kv=16)
        want = j_attn.flash_attention(*J, causal=causal, block_q=16,
                                      block_kv=16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    got = attn.blocked_attention(*T, softcap=5.0, block_q=16, block_kv=32)
    want = j_attn.flash_attention(*J, softcap=5.0, block_q=16, block_kv=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    got = attn.blocked_attention(T[0][:, 48:], *T[1:], q_offset=48,
                                 block_q=8, block_kv=16)
    want = j_attn.flash_attention(J[0][:, 48:], *J[1:], q_offset=48,
                                  block_q=8, block_kv=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for window, bq in ((8, 16), (24, 64), (1, 8)):
        got = attn.blocked_local_attention(*T, window=window, block_q=bq)
        want = j_attn.local_attention(*J, window=window, block_q=bq)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("S", [1, 7, 16, 33])
def test_rglru_assoc_scan_matches_the_reference_and_its_grad(S):
    from repro.models import recurrent as j_rec
    from repro_torch.models import recurrent as rec
    jc, tc, jp, tp = _params("recurrentgemma-2b")
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["rec0"])
    tl = lm._layer(tp["blocks"]["rec0"], 0)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, tc.rglru.d_rnn)).astype(np.float32)
    h0 = rng.standard_normal((2, tc.rglru.d_rnn)).astype(np.float32)
    jy, jh = j_rec.rglru_scan(jnp.asarray(x), jl, tc.n_heads,
                              h0=jnp.asarray(h0))
    xt = torch.from_numpy(x).requires_grad_(True)
    ty, th = rec.rglru_assoc_scan(xt, tl, tc.n_heads,
                                  h0=torch.from_numpy(h0))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=1e-6)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh),
                               atol=1e-6)
    jgx = jax.grad(lambda a: jnp.sum(j_rec.rglru_scan(
        a, jl, tc.n_heads, h0=jnp.asarray(h0))[0] ** 2))(jnp.asarray(x))
    (tgx,) = torch.autograd.grad(torch.sum(ty ** 2), xt)
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), atol=1e-5)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-v2-lite-16b",
                                  "recurrentgemma-2b"])
@pytest.mark.parametrize("policy,groups", [("full", 0), ("dots", 0),
                                           ("none", 2), ("full", 2),
                                           ("dots", 2)])
def test_remat_policies_give_the_same_loss_and_gradients(arch, policy,
                                                         groups):
    _, tc, _, tp = _params(arch)
    if arch == "recurrentgemma-2b":       # one group of 3 + no tail
        assert tc.n_layers == 3
    batch = _batch(tc, 2, 16)
    base_loss, base_m, base = _grads(tc, tp, batch)
    rc = dataclasses.replace(common.CPU_RC, remat_policy=policy,
                             remat_groups=groups)
    loss, m, grads = _grads(tc, tp, batch, rc)
    assert torch.equal(loss, base_loss)
    for k in base_m:
        assert torch.equal(m[k].detach(), base_m[k].detach()), k
    for path, g in grads.items():
        assert torch.equal(g, base[path]), path


def test_remat_wrap_keeps_the_products_under_dots():
    """``"dots"`` saves the matrix products' outputs: the backward of a
    checkpointed chain recomputes only the elementwise operations."""
    calls = []

    def fn(x, w):
        calls.append(1)
        return torch.tanh(torch.matmul(x, w)).sum()
    x = torch.randn(4, 8, requires_grad=True)
    w = torch.randn(8, 8, requires_grad=True)
    for policy in ("none", "full", "dots"):
        calls.clear()
        rc = dataclasses.replace(common.CPU_RC, remat_policy=policy)
        out = common.remat_wrap(fn, rc)(x, w)
        gx, gw = torch.autograd.grad(out, (x, w))
        assert len(calls) == (1 if policy == "none" else 2), policy
        rx, rw = torch.autograd.grad(fn(x, w), (x, w))
        assert torch.equal(gx, rx) and torch.equal(gw, rw)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "musicgen-large"])
@pytest.mark.parametrize("chunk", [lm.LOSS_CHUNK, 8])
def test_chunked_xent_matches_full(arch, chunk, monkeypatch):
    """The reference's test_chunked_xent_matches_full, also over two
    chunks (LOSS_CHUNK 8 at S 16) and on audio's (B, S, K) labels."""
    _, tc, _, tp = _params(arch)
    monkeypatch.setattr(lm, "LOSS_CHUNK", chunk)
    b = _t(_batch(tc, 2, 16))
    with torch.no_grad():
        h, _ = lm.forward(tc, tp, b, common.CPU_RC, return_hidden=True)
        hn = common.apply_norm(tc.norm, h, tp["out_norm"])
        l1, m1 = lm.chunked_xent(tc, tp, hn, b["tokens"].long(),
                                 common.CPU_RC)
        logits, _ = lm.forward(tc, tp, b, common.CPU_RC)
        l2, m2 = common.softmax_xent(logits, b["tokens"].long(),
                                     z_loss_coef=common.CPU_RC.z_loss)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-5)
    np.testing.assert_allclose(float(m1["nll"]), float(m2["nll"]), rtol=1e-5)
    assert float(m1["ntokens"]) == float(m2["ntokens"])


def test_softmax_xent_matches_the_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32) * 4
    labels = rng.integers(-1, 11, (3, 5)).astype(np.int32)
    mask = rng.random((3, 5)) < 0.7
    for m in (None, mask):
        jl, jm = j_common.softmax_xent(
            jnp.asarray(logits), jnp.asarray(labels), 1e-3,
            mask=None if m is None else jnp.asarray(m))
        tl, tm = common.softmax_xent(
            torch.from_numpy(logits), torch.from_numpy(labels), 1e-3,
            mask=None if m is None else torch.from_numpy(m))
        assert abs(float(tl) - float(jl)) <= 1e-6
        assert abs(float(tm["nll"]) - float(jm["nll"])) <= 1e-6
        assert int(tm["ntokens"]) == int(jm["ntokens"])
    js = j_common.softmax_xent_sums(jnp.asarray(logits), jnp.asarray(labels))
    ts = common.softmax_xent_sums(torch.from_numpy(logits),
                                  torch.from_numpy(labels))
    for t, j in zip(ts, js):
        assert abs(float(t) - float(j)) <= 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    """The reference's tests/test_models.py:21-46 on the port: its own
    prefill and decode (the kernels' plain versions on the CPU) against
    its own forward."""
    _, cfg, _, tp = _params(arch)
    params = lm.place_params(tp, common.CPU_RC, "cpu")
    B, S, S1 = 2, 12, 8
    rng = np.random.default_rng(1)
    shape = (B, S, cfg.n_codebooks) if cfg.family == "audio" else (B, S)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, shape))
    batch, pre = {"tokens": toks}, {"tokens": toks[:, :S1]}
    nf = cfg.n_frontend_tokens if cfg.family == "vlm" else 0
    if nf:
        vis = torch.from_numpy(rng.standard_normal(
            (B, nf, cfg.d_model)).astype(np.float32))
        batch = {"tokens": toks[:, :S - nf], "vis_embeds": vis}
        pre = {"tokens": toks[:, :S1 - nf], "vis_embeds": vis}
    with torch.no_grad():
        full, _ = lm.forward(cfg, params, batch, common.CPU_RC)
    last, cache = lm.prefill(cfg, params, pre, common.CPU_RC, max_len=S)
    np.testing.assert_allclose(last.numpy(), full[:, S1 - 1].numpy(),
                               atol=2e-3, rtol=1e-3)
    for t in range(S1, S):
        tok = batch["tokens"][:, t - nf]
        logits, cache = lm.decode_step(cfg, params, tok, cache,
                                       common.CPU_RC)
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "recurrentgemma-2b",
                                  "llama4-maverick-400b-a17b",
                                  "deepseek-v2-lite-16b", "xlstm-125m",
                                  "llava-next-34b", "musicgen-large"])
def test_bf16_compute_on_fp32_master_weights(arch):
    jc, tc, jp, tp = _params(arch)
    rc = dataclasses.replace(common.CPU_RC, compute_dtype=torch.bfloat16)
    jrc = dataclasses.replace(j_common.CPU_RC, compute_dtype=jnp.bfloat16)
    assert {v.dtype for v in tree_leaves(tp)} == {torch.float32}
    batch = _batch(tc, 2, 16)
    loss, metrics, grads = _grads(tc, tp, batch, rc)
    assert {g.dtype for g in grads.values()} == {torch.float32}
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    jloss, _, _ = _jax_loss_and_grads(jc, jp, batch, jrc)
    assert abs(float(loss) - float(jloss)) <= 3e-2, (float(loss),
                                                      float(jloss))
    floss, _, _ = _grads(tc, tp, batch)
    assert float(loss) != float(floss)     # the bf16 path really ran


TRAIN_OPT = dict(lr=3e-3, warmup_steps=2, decay_steps=10)


def _train_both(arch, moment_dtype, steps=3, microbatches=1, B=4, S=16,
                grads=None):
    """``steps`` steps of both packages' make_train_step from the same
    parameters and optimizer state; returns (port params, reference
    params as {path: array}, port losses, reference losses).  A list
    ``grads`` receives each step's (port, reference) gradients, each
    taken at its own package's parameters."""
    jc, tc, jp, tp = _params(arch)
    jopt = JOptConfig(moment_dtype=moment_dtype[0], **TRAIN_OPT)
    topt = OptConfig(moment_dtype=moment_dtype[1], **TRAIN_OPT)
    jstate = j_init_opt_state(jp, jopt)
    tstate = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate),
                                device="cpu")
    jstep = jax.jit(j_trainer.make_train_step(jc, j_common.CPU_RC, jopt,
                                              microbatches=microbatches))
    tstep = trainer.make_train_step(tc, common.CPU_RC, topt,
                                    microbatches=microbatches)
    from repro.data import batch_for_arch
    jl, tl = [], []
    for s in range(steps):
        b = batch_for_arch(jc, S, B, s)
        if grads is not None:
            grads.append((_grads(tc, tp, b)[2],
                          _jax_loss_and_grads(jc, jp, b)[2]))
        jp, jstate, jm = jstep(jp, jstate, _j(b))
        tp, tstate, tm = tstep(tp, tstate, b)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    assert int(tstate["step"]) == steps
    return tp, dict(tree_items(jax.tree_util.tree_map(np.asarray, jp))), \
        tl, jl


def _clipped(grads, clip_norm):
    """{path: float64 gradient} scaled by AdamW's global-norm clip."""
    g = {k: np.asarray(v, np.float64) for k, v in grads.items()}
    norm = np.sqrt(sum(float(np.sum(x * x)) for x in g.values()))
    return {k: x * min(clip_norm / max(norm, 1e-9), 1.0)
            for k, x in g.items()}


def _adamw64(w0, grads, cfg):
    """{path: float64 parameters} after AdamW steps on the clipped
    gradients ``grads`` (one dict a step), in float64."""
    w = {k: np.asarray(v, np.float64) for k, v in w0.items()}
    m = {k: 0.0 for k in w}
    v = {k: 0.0 for k in w}
    for t, g in enumerate(grads):
        lr = float(lr_schedule(cfg, t))
        c1, c2 = 1 - cfg.b1 ** (t + 1), 1 - cfg.b2 ** (t + 1)
        for k in w:
            m[k] = cfg.b1 * m[k] + (1 - cfg.b1) * g[k]
            v[k] = cfg.b2 * v[k] + (1 - cfg.b2) * g[k] * g[k]
            d = (m[k] / c1) / (np.sqrt(v[k] / c2) + cfg.eps)
            if w[k].ndim >= 2:
                d = d + cfg.weight_decay * w[k]
            w[k] = w[k] - lr * d
    return w


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-v2-lite-16b"])
@pytest.mark.parametrize("moments,atol", [("float32", 2e-6),
                                          ("bfloat16", 5e-4)])
def test_three_train_steps_match_the_reference(arch, moments, atol):
    dt = (getattr(jnp, moments), getattr(torch, moments))
    grads = [] if moments == "float32" else None
    tp, jp, tl, jl = _train_both(arch, dt, grads=grads)
    np.testing.assert_allclose(tl, jl, atol=1e-5)
    if grads is None:
        for path, p in tree_items(tp):
            assert p.dtype == torch.float32
            np.testing.assert_allclose(p.numpy(), np.asarray(jp[path],
                                                             np.float32),
                                       atol=atol, rtol=0, err_msg=path)
        return
    # fp32 moments: the module docstring's eps-sized gradients
    cfg = OptConfig(**TRAIN_OPT)
    w0 = dict(tree_items(_params(arch)[3]))
    tgs = [_clipped(t, cfg.clip_norm) for t, _ in grads]
    jgs = [_clipped(j, cfg.clip_norm) for _, j in grads]
    implied = {k: np.abs(a - _adamw64(w0, jgs, cfg)[k])
               for k, a in _adamw64(w0, tgs, cfg).items()}
    n_eps = 0
    for path, p in tree_items(tp):
        assert p.dtype == torch.float32
        err = np.abs(p.numpy() - np.asarray(jp[path], np.float32))
        tg, jg = grads[0][0][path].numpy(), grads[0][1][path]
        tiny = np.minimum(np.abs(tgs[0][path]), np.abs(jgs[0][path])) \
            < 100 * cfg.eps
        n_eps += int(tiny.sum())
        assert float(err[~tiny].max(initial=0.0)) <= atol, path
        gbound = GRAD_RTOL * float(np.abs(jg).max()) + 1e-7
        assert float(np.abs(tg - jg)[tiny].max(initial=0.0)) <= gbound, path
        over = err[tiny] - (atol + implied[path][tiny])
        assert float(over.max(initial=-1.0)) <= 0.0, (path, over.max())
    assert n_eps > 0       # the looser bound had elements to hold


def test_two_microbatches_match_the_reference_and_one_batch():
    """tests/test_system.py:96-110 on the port, and the port's two
    microbatches against the reference's."""
    dt = (jnp.float32, torch.float32)
    tp2, jp2, tl2, jl2 = _train_both("olmo-1b", dt, steps=1, microbatches=2)
    tp1, _, _, _ = _train_both("olmo-1b", dt, steps=1, microbatches=1)
    np.testing.assert_allclose(tl2, jl2, atol=1e-5)
    for path, p in tree_items(tp2):
        np.testing.assert_allclose(p.numpy(), jp2[path], atol=2e-6,
                                   err_msg=path)
    d = max(float((a - b).abs().max())
            for a, b in zip(tree_leaves(tp1), tree_leaves(tp2)))
    assert d < 5e-2


def test_train_step_keeps_master_weights_and_changes_every_leaf():
    _, tc, _, tp = _params("recurrentgemma-2b")
    rc = dataclasses.replace(common.CPU_RC, compute_dtype=torch.bfloat16)
    opt_cfg = OptConfig(lr=3e-3, warmup_steps=1)
    step = trainer.make_train_step(tc, rc, opt_cfg)
    from repro_torch.data import batch_for_arch
    params, state = tp, init_opt_state(tp, opt_cfg)
    params, state, m = step(params, state, batch_for_arch(tc, 16, 2, 0))
    assert bool(torch.isfinite(m["loss"])) and float(m["grad_norm"]) > 0
    for (path, new), old in zip(tree_items(params), tree_leaves(tp)):
        assert new.dtype == torch.float32 and not new.requires_grad, path
        assert not torch.equal(new, old), path
    assert {v.dtype for v in tree_leaves(state["m"])} == {torch.bfloat16}


def test_init_train_state_master_and_meta():
    tc = get_config("tinyllama-1.1b-smoke")
    rc = dataclasses.replace(common.CPU_RC, compute_dtype=torch.bfloat16)
    p, opt = trainer.init_train_state(tc, torch.Generator().manual_seed(0),
                                      rc, OptConfig(), device="cpu")
    assert {v.dtype for v in tree_leaves(p)} == {torch.float32}
    serving = lm.init_params(tc, torch.Generator().manual_seed(0), rc,
                             device="cpu")
    placed = lm.place_params(p, rc, "cpu")
    for (path, a), b in zip(tree_items(placed), tree_leaves(serving)):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    meta, mopt = trainer.init_train_state(
        get_config("tinyllama-1.1b"), torch.Generator(), rc, OptConfig(),
        device="meta")
    assert all(v.device.type == "meta" for v in tree_leaves(meta))
    n = sum(v.numel() for v in tree_leaves(meta))
    assert 1.0e9 < n < 1.2e9
    assert mopt["step"].dtype == torch.int32


WRAPPERS = ["flash_attention_tpu", "decode_attention_tpu", "rglru_scan_tpu",
            "systolic_gemm", "gemm_partial"]


def _wrapper_args(name):
    r = torch.randn
    return {"flash_attention_tpu": ((r(1, 2, 8, 16), r(1, 2, 8, 16),
                                     r(1, 2, 8, 16)), {}),
            "decode_attention_tpu": ((r(1, 2, 16), r(1, 2, 8, 16),
                                      r(1, 2, 8, 16), 3), {}),
            "rglru_scan_tpu": ((r(1, 8, 4), r(1, 8, 4), r(1, 4)), {}),
            "systolic_gemm": ((r(8, 8), r(8, 8)), {}),
            "gemm_partial": ((r(8, 8), r(8, 8), torch.zeros(8, 8), 0, 1),
                             {"bk": 8})}[name]


@pytest.mark.parametrize("name", WRAPPERS)
def test_each_kernel_wrapper_refuses_to_be_differentiated(name):
    fn = getattr(ops, name)
    args, kw = _wrapper_args(name)
    fn(*args, **kw)                               # plain tensors: runs
    grad_args = [a.requires_grad_(True) if i == 0 else a
                 for i, a in enumerate(args)]
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*grad_args, **kw)
    with torch.no_grad():
        fn(*grad_args, **kw)                      # grad mode off: runs


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "recurrentgemma-2b",
                                  "deepseek-v2-lite-16b", "xlstm-125m",
                                  "llava-next-34b", "musicgen-large",
                                  "llama4-maverick-400b-a17b"])
def test_loss_backward_touches_no_kernel_wrapper(arch, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the training path reached a kernel wrapper")
    for name in WRAPPERS:
        monkeypatch.setattr(ops, name, refuse)
    _, tc, _, tp = _params(arch)
    leaves = {k: v.detach().requires_grad_(True) for k, v in tree_items(tp)}
    loss, _ = lm.loss_fn(tc, tree_unflatten(tp, leaves),
                         _t(_batch(tc, 2, 16)), common.CPU_RC)
    loss.backward()
    assert all(v.grad is not None for v in leaves.values())
    if tc.family == "xlstm":              # its serving path has no kernel
        return
    with pytest.raises(AssertionError, match="kernel wrapper"):
        lm.prefill(tc, lm.place_params(tp, common.CPU_RC, "cpu"),
                   _t(_batch(tc, 2, 16)), common.CPU_RC)
