"""One sharded AdamW train step on real collectives against the plain
port step: four CPU processes on the ``gloo`` backend, a (2, 2)
``make_debug_mesh``, ``runtime.trainer.make_train_step`` (fp32, AdamW,
remat "full", sequence-parallel residual) on DTensors under
``axis_rules`` against the same step on plain tensors, from the same
parameters, optimizer state and batch.

Cases: the smoke configs of four families, and three cuts (each a
``dataclasses.replace`` of a smoke config) that bring the full-width
train cells' DTensor gaps down to a model axis of 2:

* ``xlstm-125m-smoke`` as is: ``F.logsigmoid``'s backward,
  ``aten.log_sigmoid_backward``, has no sharding strategy (the 16x16
  train_4k cell's error);
* xlstm with 3 heads (d_model 48): the backward of the mLSTM's head
  split and merge unflattens a dim sharded 2 ways into 3 heads (the
  2x16x16 cell's error, 4 heads of a 1536 sharded 16 ways); its chunk
  of 8 puts the 16-token step on the chunkwise mLSTM, which training
  runs on local shards (on the 2x16x16 mesh DTensor's backward of its
  einsums gave a local shape its own view refused);
* recurrentgemma with 3 heads (d_rnn 48): the backward of the RG-LRU's
  head merge unflattens 48 sharded 2 ways into 3 heads (the train_4k
  cells' error, 10 heads of a 2560 sharded 16 ways);
* llama4-maverick with an expert hidden width of 256, four times its
  d_model as the full config's 8192 is wider than its 5120: DTensor's
  backward of the expert products gives a gradient whose global stride
  its shards do not have, and a view of it fails (the train_4k cells'
  ``aten.view`` of (8, 16, 4, 1, 8192) into (8, 64, 8192)).

Each of the four error cases raises on the tree before
``sharding.reshape``'s ``_Reshape``, ``common.log_sigmoid`` and
``sharding.contiguous_grad``.

Beside it, on one process: ``sharding.reshape`` on plain tensors has
``torch.reshape``'s gradient bit for bit, and on a fake mesh its
gradient comes back in the input's placements through the same rule;
``common.log_sigmoid``'s gradient equals ``F.logsigmoid``'s bit for bit
over |x| up to 60 (both are ATen's formula on its forward's buffer).

Tolerance: the two steps sum the same terms in other orders (the
sharded one over ranks, then locally), so the loss, the gradient norm
and each gradient (read back from the first moment, m = (1 - b1) g) are
held to 1e-5 of their scale, as the gloo serving test holds logits.  An
updated weight is held to 1e-5 plus the gap that AdamW's first update
implies: lr * g / (|g| + eps) has the slope lr * eps / (|g| + eps)^2,
so an element whose gradient is eps-sized (eps 1e-8) moves by
lr * eps * |dg| / (min |g| + eps)^2 for a gradient gap dg.
"""
import json
import os
import socket
import subprocess
import sys

import pytest
import torch
import torch.nn.functional as F

from repro_torch.launch import dryrun
from repro_torch.models.common import log_sigmoid
from repro_torch.runtime import sharding

TOL = 1e-5

# (arch, cut): the cut as keyword arguments of dataclasses.replace, a
# dict value replacing fields of that sub-config
CASES = [
    ("tinyllama-1.1b-smoke", {}),
    ("recurrentgemma-2b-smoke", {}),
    ("xlstm-125m-smoke", {}),
    ("llama4-maverick-400b-a17b-smoke", {}),
    ("xlstm-125m-smoke", {"n_heads": 3, "n_kv_heads": 3, "d_model": 48,
                          "xlstm": {"chunk": 8}}),
    ("recurrentgemma-2b-smoke", {"n_heads": 3, "rglru": {"d_rnn": 48}}),
    ("llama4-maverick-400b-a17b-smoke", {"moe": {"d_expert": 256}}),
]

# one rank's program: the plain step, then the same step on DTensors
# under axis_rules; prints the comparison as JSON
_RANK = """
import dataclasses, json, sys
import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch import configs
from repro_torch.data import batch_for_arch
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.common import RuntimeConfig
from repro_torch.optim import OptConfig
from repro_torch.pytree import tree_items
from repro_torch.runtime import sharding
from repro_torch.runtime.trainer import init_train_state, make_train_step

arch, port, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
cut = json.loads(sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=4)
cfg = configs.get_config(arch)
cfg = dataclasses.replace(cfg, **{
    k: dataclasses.replace(getattr(cfg, k), **v) if isinstance(v, dict)
    else v for k, v in cut.items()})
rc = RuntimeConfig(compute_dtype=torch.float32, param_dtype=torch.float32,
                   remat_policy="full", sequence_parallel=True)
opt_cfg = OptConfig(lr=3e-3, warmup_steps=2, decay_steps=10,
                    moment_dtype=torch.float32)
params, opt = init_train_state(cfg, torch.Generator().manual_seed(0), rc,
                               opt_cfg, device="cpu")
batch = {k: torch.from_numpy(v)
         for k, v in batch_for_arch(cfg, 16, 4, 0).items()}
step = make_train_step(cfg, rc, opt_cfg)
want_p, want_o, want_m = step(params, opt, batch)

mesh = make_debug_mesh(2, 2)
rules = sharding.AxisRules(mesh, sequence_parallel=True)
p_spec = sharding.param_specs(params, rules)
o_spec = {k: p_spec if k in ("m", "v") else sharding.replicated(v, rules)
          for k, v in opt.items()}
args = (sharding.distribute(params, p_spec, mesh),
        sharding.distribute(opt, o_spec, mesh),
        sharding.distribute(batch, sharding.batch_specs(batch, rules), mesh))
with sharding.axis_rules(rules), implicit_replication():
    got_p, got_o, got_m = step(*args)


def full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


lr, eps, b1 = float(want_m["lr"]), opt_cfg.eps, opt_cfg.b1
got_p, got_g = dict(tree_items(got_p)), dict(tree_items(got_o["m"]))
want_g = dict(tree_items(want_o["m"]))
leaves = {}
for path, w in tree_items(want_p):
    gw, gg = want_g[path] / (1 - b1), full(got_g[path]) / (1 - b1)
    dg = (gg - gw).abs()
    implied = lr * eps * dg / (torch.minimum(gg.abs(), gw.abs()) + eps) ** 2
    dw = (full(got_p[path]) - w).abs()
    leaves["/".join(path)] = {
        "dg": float(dg.max()), "g_scale": float(gw.abs().max()),
        "dw": float(dw.max()), "over": float((dw - implied).max())}
print(json.dumps({
    "loss": [float(full(got_m["loss"])), float(want_m["loss"])],
    "grad_norm": [float(full(got_m["grad_norm"])),
                  float(want_m["grad_norm"])],
    "leaves": leaves}))
dist.destroy_process_group()
"""


def _run_ranks(arch, cut):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(root, "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, arch, str(port), str(r),
         json.dumps(cut)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    res = []
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (r, err[-3000:])
        res.append(json.loads(out.strip().splitlines()[-1]))
    return res


@pytest.mark.parametrize("arch,cut", CASES,
                         ids=[a + ("-cut" if c else "") for a, c in CASES])
def test_a_sharded_train_step_on_four_gloo_ranks_matches_the_plain_one(
        arch, cut):
    for r, res in enumerate(_run_ranks(arch, cut)):
        (got, want) = res["loss"]
        assert abs(got - want) <= TOL * max(1.0, abs(want)), (r, got, want)
        got, want = res["grad_norm"]
        assert abs(got - want) <= TOL * want, (r, got, want)
        assert len(res["leaves"]) > 0
        for path, lf in res["leaves"].items():
            assert lf["dg"] <= TOL * lf["g_scale"], (r, path, lf)
            assert lf["over"] <= TOL, (r, path, lf)


def test_reshape_on_plain_tensors_has_torch_reshapes_gradient():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 12, generator=g)
    w = torch.randn(2, 8, 3, 4, generator=g)
    a = x.clone().requires_grad_(True)
    b = x.clone().requires_grad_(True)
    ya, yb = sharding.reshape(a, (2, 8, 3, -1)), b.reshape(2, 8, 3, 4)
    assert torch.equal(ya, yb)
    (ya * w).sum().backward()
    (yb * w).sum().backward()
    assert torch.equal(a.grad, b.grad)


def test_reshape_gradient_returns_in_the_inputs_placements():
    """On a fake (1, 4) mesh: 40 sharded 4 ways splits into 10 heads of
    4 only after a gather (10 does not divide by 4); the merge back
    keeps the shard.  Each backward gives the input's placements, as the
    forward's rule places them, where DTensor's own would unflatten the
    sharded 40 into 10 uneven heads and raise."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with dryrun.fake_mesh((1, 4), ("data", "model")) as mesh:
        place = (Replicate(), Shard(2))
        x = DTensor.from_local(torch.empty(2, 8, 10, device="meta"), mesh,
                               place, run_check=False,
                               shape=torch.Size((2, 8, 40)),
                               stride=(320, 40, 1)).requires_grad_(True)
        heads = sharding.reshape(x, (2, 8, 10, 4))
        assert heads.placements == (Replicate(), Replicate())
        merged = sharding.reshape(heads * 2.0, (2, 8, 40))
        g = DTensor.from_local(torch.empty(2, 8, 10, device="meta"), mesh,
                               place, run_check=False,
                               shape=torch.Size((2, 8, 40)),
                               stride=(320, 40, 1))
        (gx,) = torch.autograd.grad(merged, x, g)
        assert gx.placements == place and tuple(gx.shape) == (2, 8, 40)
        assert tuple(gx.to_local().shape) == (2, 8, 10)


def test_log_sigmoid_gradient_equals_logsigmoids():
    x = torch.cat([torch.linspace(-60.0, 60.0, 24001),
                   torch.randn(4000, generator=torch.Generator()
                               .manual_seed(0)) * 4])
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(1))
    a = x.clone().requires_grad_(True)
    b = x.clone().requires_grad_(True)
    ya, yb = log_sigmoid(a), F.logsigmoid(b)
    assert torch.equal(ya, yb)
    ya.backward(g)
    yb.backward(g)
    assert torch.equal(a.grad, b.grad)
    assert bool((x.abs() > 30).any())
