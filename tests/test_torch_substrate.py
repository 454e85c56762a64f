"""The port's training substrate against the reference, on the CPU: the
synthetic data pipeline (byte-equal batches for the ten archs), AdamW
(schedule, update with fp32, bf16 and int8 moments, global norm), int8
compression and its all-reduce on two gloo ranks against the reference's
under ``shard_map`` on two host devices, checkpoints that each package
loads from the other, and ``launch/train.py --device cpu`` resumed from
a checkpoint against an uninterrupted run.

Tolerances: batches, checkpoint arrays (bf16 bits included) and the
resumed run: equal; ``lr_schedule`` and ``global_norm``: rtol 1e-6 (fp32
pow / cos and summation order); two AdamW updates, fp32 moments: atol
1e-6 on parameters and moments; bf16 moments: parameters atol 1e-6,
moments within one bf16 ulp (a one-ulp fp32 difference in
``b * m + (1 - b) * g``, which XLA:CPU may contract into an FMA, can flip
the rounding); int8 moments: parameters atol 1e-6, quantized moments
within 1; the compressed all-reduce: equal (integer sums of the same
quantized values, one fp32 product).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpointing import load_checkpoint as j_load_checkpoint
from repro.checkpointing import save_checkpoint as j_save_checkpoint
from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.data import SyntheticLM as JSyntheticLM
from repro.data import batch_for_arch as j_batch_for_arch
from repro import optim as j_optim
from repro.optim import compression as j_compression
from repro_torch.checkpointing import (CheckpointManager, latest_step,
                                       load_checkpoint, save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM, batch_for_arch
from repro_torch import optim
from repro_torch.optim import compression
from repro_torch.pytree import (from_numpy, to_numpy, tree_items,
                                tree_leaves)

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(J_ARCHS))
@pytest.mark.parametrize("seq,batch,step,seed", [(16, 2, 0, 0),
                                                 (32, 4, 7, 3)])
def test_batch_for_arch_is_byte_equal(arch, seq, batch, step, seed):
    jc, tc = j_get_config(arch), get_config(arch)
    want = j_batch_for_arch(jc, seq, batch, step, seed=seed)
    got = batch_for_arch(tc, seq, batch, step, seed=seed)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape and got[k].tobytes() == want[k].tobytes(), k
    if tc.family == "audio":
        assert got["tokens"].shape == (batch, seq, tc.n_codebooks)
    if tc.family == "vlm":
        assert "vis_embeds" in got


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_synthetic_lm_shards_are_byte_equal(n_shards):
    kw = dict(vocab=101, seq_len=24, global_batch=8, seed=3, noise_frac=0.2)
    t, j = SyntheticLM(**kw), JSyntheticLM(**kw)
    for shard in range(n_shards):
        got = t.batch(5, shard=shard, n_shards=n_shards)
        want = j.batch(5, shard=shard, n_shards=n_shards)
        for k in want:
            assert got[k].tobytes() == want[k].tobytes()
        assert got["tokens"].shape == (8 // n_shards, 24)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(lr=1.0, warmup_steps=10,
                                         decay_steps=100),
                                dict(lr=3e-3, warmup_steps=2, decay_steps=8,
                                     min_lr_frac=0.0)])
def test_lr_schedule_matches_the_reference(kw):
    tc, jc = optim.OptConfig(**kw), j_optim.OptConfig(**kw)
    for step in (0, 1, 2, 5, 9, 10, 11, 50, 99, 100, 101, 5000, 20000):
        want = float(j_optim.lr_schedule(jc, jnp.asarray(step)))
        got = optim.lr_schedule(tc, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-6 * abs(want), (step, got, want)
        assert abs(float(optim.lr_schedule(tc, step)) - want) <= \
            1e-6 * abs(want)


def _tree(rng):
    """A small parameter tree: matrices (decayed) and vectors (not)."""
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "blocks": {"a": rng.standard_normal((2, 3, 4)).astype(np.float32),
                       "ln": {"scale": rng.standard_normal(7).astype(
                           np.float32)}},
            "b": rng.standard_normal(9).astype(np.float32)}


def _jtree(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def _ttree(t):
    return jax.tree_util.tree_map(torch.from_numpy, t)


def _flat(tree):
    return dict(tree_items(jax.tree_util.tree_map(np.asarray, tree)))


def test_global_norm_matches_the_reference():
    g = _tree(np.random.default_rng(0))
    want = float(j_optim.global_norm(_jtree(g)))
    got = float(optim.global_norm(_ttree(g)))
    assert abs(got - want) <= 1e-6 * want


@pytest.mark.parametrize("moments", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_update_matches_the_reference(moments, clip):
    rng = np.random.default_rng(1)
    params = _tree(rng)
    kw = dict(lr=3e-2, warmup_steps=1, decay_steps=10, clip_norm=clip,
              moments_int8=moments == "int8")
    if moments != "int8":
        jc = j_optim.OptConfig(moment_dtype=getattr(jnp, moments), **kw)
        tc = optim.OptConfig(moment_dtype=getattr(torch, moments), **kw)
    else:
        jc, tc = j_optim.OptConfig(**kw), optim.OptConfig(**kw)
    jp, js = _jtree(params), j_optim.init_opt_state(_jtree(params), jc)
    tp = _ttree(params)
    ts = optim.opt_state_from_jax(jax.tree_util.tree_map(np.asarray, js),
                                  device="cpu")
    for _ in range(2):
        grads = _tree(rng)
        jp, js, jm = j_optim.adamw_update(jp, _jtree(grads), js, jc)
        tp, ts, tm = optim.adamw_update(tp, _ttree(grads), ts, tc)
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-6 * float(jm["grad_norm"])
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= 1e-9
    assert int(ts["step"]) == int(js["step"]) == 2
    assert ts["step"].dtype == torch.int32
    for path, want in _flat(jp).items():
        got = dict(tree_items(tp))[path]
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, err_msg=path)
    jflat = _flat(js)
    for path, got in tree_items(ts):
        want = jflat[path]
        got_np = got.float().numpy() if got.dtype == torch.bfloat16 \
            else got.numpy()
        assert str(got.dtype).split(".")[-1] == want.dtype.name, path
        if moments == "bfloat16" and path[0] in "mv":
            ulp = np.abs(want.astype(np.float32)) * 2.0 ** -7 + 1e-30
            assert (np.abs(got_np - want.astype(np.float32)) <= ulp).all()
        elif moments == "int8" and got.dtype == torch.int8:
            assert np.abs(got_np.astype(int) - want.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(got_np, want, atol=1e-6, rtol=1e-6,
                                       err_msg=path)


def test_adamw_converges_quadratic():
    cfg = optim.OptConfig(lr=0.1, warmup_steps=5, decay_steps=200,
                          weight_decay=0.0, clip_norm=0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = optim.init_opt_state(params, cfg)
    for _ in range(150):
        params, state, _ = optim.adamw_update(params, {"w": 2 * params["w"]},
                                              state, cfg)
    assert float(params["w"].abs().max()) < 0.1


def test_int8_moments_converge():
    """tests/test_serving.py's TestInt8Adam on the port."""
    cfg = optim.OptConfig(lr=0.1, warmup_steps=5, decay_steps=200,
                          weight_decay=0.0, clip_norm=0, moments_int8=True)
    params = {"w": torch.tensor([3.0, -2.0, 1.5])}
    state = optim.init_opt_state(params, cfg)
    assert state["m"]["w"].dtype == torch.int8
    for _ in range(150):
        params, state, _ = optim.adamw_update(params, {"w": 2 * params["w"]},
                                              state, cfg)
    assert float(params["w"].abs().max()) < 0.2


def test_int8_state_is_quarter_size():
    params = {"w": torch.zeros((128, 128))}
    s8 = optim.init_opt_state(params, optim.OptConfig(moments_int8=True))
    s16 = optim.init_opt_state(params, optim.OptConfig())

    def nbytes(s):
        return sum(a.numel() * a.element_size() for a in tree_leaves(s))
    assert nbytes(s8) < nbytes(s16) * 0.6
    js = j_optim.init_opt_state({"w": jnp.zeros((128, 128))},
                                j_optim.OptConfig(moments_int8=True))
    assert sorted(k for k, _ in tree_items(s8)) == sorted(_flat(js))


@pytest.mark.parametrize("seed", range(6))
def test_int8_compression_bounded_error_and_equal_to_the_reference(seed):
    rng = np.random.default_rng(seed)
    x = (rng.uniform(-1e3, 1e3, rng.integers(1, 65))
         * rng.choice([1e-3, 1.0])).astype(np.float32)
    q, s = compression.compress_int8(torch.from_numpy(x))
    back = compression.decompress_int8(q, s)
    amax = float(np.abs(x).max())
    assert float((back - torch.from_numpy(x)).abs().max()) <= \
        max(amax / 127.0, 1e-6) * 1.01
    jq, js = j_optim.compress_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    res = rng.standard_normal(x.shape).astype(np.float32)
    (tq, ts), tr = compression.ef_compress(torch.from_numpy(x),
                                           torch.from_numpy(res))
    (jq, js), jr = j_compression.ef_compress(jnp.asarray(x),
                                             jnp.asarray(res))
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-6)


_RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.optim.compression import psum_compressed
    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method="file://" + store,
                            world_size=2, rank=rank)
    g = dict(np.load(out + "/in.npz"))
    mine = {k: torch.from_numpy(v[rank]) for k, v in g.items()}
    got = psum_compressed({"a": mine["a"], "b": {"c": mine["c"]}})
    np.savez(out + f"/out{rank}.npz", a=got["a"].numpy(),
             c=got["b"]["c"].numpy())
    dist.destroy_process_group()
""")


def test_psum_compressed_on_two_gloo_ranks_matches_shard_map(tmp_path):
    from jax.sharding import Mesh, PartitionSpec as P
    rng = np.random.default_rng(4)
    g = {"a": rng.standard_normal((2, 5, 3)).astype(np.float32),
         "c": (rng.standard_normal((2, 11)) * 1e-3).astype(np.float32)}
    np.savez(tmp_path / "in.npz", **g)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r),
                               str(tmp_path / "store"), str(tmp_path)],
                              env=env, cwd=ROOT, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
    mesh = Mesh(np.array(jax.devices()[:2]), ("d",))
    fn = jax.shard_map(lambda t: j_compression.psum_compressed(t, "d"),
                       mesh=mesh, in_specs=P("d"), out_specs=P("d"))
    want = fn({"a": jnp.asarray(g["a"]), "b": {"c": jnp.asarray(g["c"])}})
    for r in range(2):
        got = np.load(tmp_path / f"out{r}.npz")
        assert np.array_equal(got["a"], np.asarray(want["a"][r]))
        assert np.array_equal(got["c"], np.asarray(want["b"]["c"][r]))
    exact = g["a"][0] + g["a"][1]
    assert np.abs(got["a"] - exact).max() <= 2 * np.abs(g["a"]).max() / 127


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _state(rng):
    """numpy state with every dtype a train state holds: fp32 weights,
    bf16 moments (as ml_dtypes), int8 moments, fp32 scales, int32 step."""
    bf = ml_dtypes.bfloat16
    return {"params": {"embed": rng.standard_normal((5, 4)).astype(
                           np.float32),
                       "blocks": {"attn": {"wq": rng.standard_normal(
                           (2, 4, 4)).astype(np.float32)}}},
            "opt": {"m": {"embed": rng.standard_normal((5, 4)).astype(bf)},
                    "v": {"embed": rng.integers(-127, 128, (5, 4)).astype(
                        np.int8)},
                    "v_scale": {"embed": np.float32(0.25)},
                    "step": np.int32(7)}}


def _torch_state(state):
    return jax.tree_util.tree_map(lambda a: from_numpy(np.asarray(a)), state)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype.name == b.dtype.name and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    st = _state(np.random.default_rng(0))
    save_checkpoint(tmp_path, 7, _torch_state(st), extra={"data_step": 7})
    templates = jax.tree_util.tree_map(jnp.asarray, st)
    got, manifest = j_load_checkpoint(tmp_path, templates)
    assert manifest["step"] == 7 and manifest["extra"] == {"data_step": 7}
    for (path, a), (_, b) in zip(tree_items(got), tree_items(st)):
        assert _same(a, b), path


def test_reference_checkpoint_loads_in_the_port(tmp_path):
    st = _state(np.random.default_rng(1))
    j_save_checkpoint(tmp_path, 3, jax.tree_util.tree_map(jnp.asarray, st))
    meta = jax.tree_util.tree_map(
        lambda a: torch.empty(np.shape(a), device="meta"), st)
    got, manifest = load_checkpoint(tmp_path, meta, device="cpu")
    assert manifest["step"] == 3
    assert got["opt"]["m"]["embed"].dtype == torch.bfloat16
    assert got["opt"]["step"].dtype == torch.int32
    for (path, a), (_, b) in zip(tree_items(got), tree_items(st)):
        assert _same(to_numpy(a)[0].view(np.asarray(b).dtype), b), path


def test_both_packages_write_the_same_format(tmp_path):
    st = _state(np.random.default_rng(2))
    j_save_checkpoint(tmp_path / "j", 5,
                      jax.tree_util.tree_map(jnp.asarray, st))
    save_checkpoint(tmp_path / "t", 5, _torch_state(st))
    dj, dt = tmp_path / "j" / "step_00000005", tmp_path / "t" / \
        "step_00000005"
    assert sorted(p.name for p in dj.iterdir()) == \
        sorted(p.name for p in dt.iterdir())
    mj = json.loads((dj / "manifest.json").read_text())
    mt = json.loads((dt / "manifest.json").read_text())
    assert mj["groups"] == mt["groups"] and mj["step"] == mt["step"]
    assert list(mj["groups"]["opt"]) == list(mt["groups"]["opt"])
    for group in ("params", "opt"):
        with np.load(dj / f"{group}.npz") as zj, \
                np.load(dt / f"{group}.npz") as zt:
            assert zj.files == zt.files
            for k in zj.files:
                assert _same(zj[k], zt[k]), k


def test_retention_and_the_tmp_rename(tmp_path):
    st = _torch_state(_state(np.random.default_rng(3)))
    (tmp_path / "step_00000009.tmp").mkdir(parents=True)   # a crashed write
    assert latest_step(tmp_path) is None
    for s in (1, 2, 3, 4):
        save_checkpoint(tmp_path, s, st, keep=2)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["step_00000003", "step_00000004", "step_00000009.tmp"]
    assert latest_step(tmp_path) == 4
    save_checkpoint(tmp_path, 9, st, keep=2)               # replaces the .tmp
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["step_00000004", "step_00000009"]
    got, _ = load_checkpoint(tmp_path, st, step=4, device="cpu")
    for (path, a), b in zip(tree_items(got), tree_leaves(st)):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    with pytest.raises(KeyError, match="checkpoint missing"):
        load_checkpoint(tmp_path, {"params": {"nope": st["params"]["embed"]}},
                        device="cpu")
    with pytest.raises(FileNotFoundError):
        load_checkpoint(tmp_path / "empty", st, device="cpu")


def test_manager_saves_on_its_interval_and_resumes(tmp_path):
    mgr = CheckpointManager(tmp_path, interval=2, keep=3)
    st = _torch_state(_state(np.random.default_rng(4)))
    state, step, extra = mgr.restore_or_init(st, lambda: "fresh",
                                             device="cpu")
    assert (state, step, extra) == ("fresh", 0, {})
    assert mgr.maybe_save(0, st) is None and mgr.maybe_save(3, st) is None
    assert mgr.maybe_save(4, st, extra={"data_step": 4}) is not None
    state, step, extra = mgr.restore_or_init(st, lambda: "fresh",
                                             device="cpu")
    assert step == 4 and extra == {"data_step": 4}
    assert torch.equal(state["params"]["embed"], st["params"]["embed"])


def _train(argv, capsys):
    from repro_torch.launch import train
    assert train.main(argv) == 0
    out = capsys.readouterr().out
    return [ln.rsplit(" ", 2)[0] if ln.endswith("ms/step") else ln
            for ln in out.splitlines()]


def test_train_launcher_resumes_bit_equal_to_an_uninterrupted_run(
        tmp_path, capsys):
    common = ["--device", "cpu", "--arch", "tinyllama-1.1b-smoke",
              "--steps", "6", "--batch", "4", "--seq", "16",
              "--log-every", "1", "--ckpt-every", "2"]
    full = _train(common + ["--ckpt-dir", str(tmp_path / "a")], capsys)
    assert full[-1] == "done" and sum(ln.startswith("step") for ln in full) \
        == 6
    _train(common + ["--ckpt-dir", str(tmp_path / "b")], capsys)
    for s in ("step_00000004", "step_00000006"):
        for p in (tmp_path / "b" / s).iterdir():
            p.unlink()
        (tmp_path / "b" / s).rmdir()
    resumed = _train(common + ["--ckpt-dir", str(tmp_path / "b")], capsys)
    assert resumed[0] == "resumed from step 2"
    assert [ln for ln in resumed if ln.startswith("step")] == \
        [ln for ln in full if ln.startswith("step")][2:]
    for group in ("params", "opt"):
        with np.load(tmp_path / "a" / "step_00000006" / f"{group}.npz") as a, \
                np.load(tmp_path / "b" / "step_00000006" / f"{group}.npz") \
                as b:
            assert a.files == b.files
            for k in a.files:
                assert _same(a[k], b[k]), (group, k)
