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

import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from repro_torch.launch import dryrun
from repro_torch.models.common import log_sigmoid
from repro_torch.runtime import sharding

TOL = 1e-5

# (arch, cut) cases, their ids and the rank program (the plain step,
# then the same step on DTensors under axis_rules, printing the
# comparison as JSON) are chip_smoke's: the card machine's smoke run
# (phase 11 (e)) runs the same program under its own torch
CASES = chip_smoke.GLOO_TRAIN_CASES


def _run_ranks(arch, cut):
    return chip_smoke.run_gloo(chip_smoke.GLOO_TRAIN_RANK,
                               (arch, json.dumps(cut)))


@pytest.mark.parametrize("arch,cut", CASES, ids=chip_smoke.GLOO_TRAIN_IDS)
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


def test_pad_pads_each_ranks_shards_and_keeps_their_placements():
    """``sharding.pad`` (the causal conv's, the prefill cache's and the
    padded heads' pad) on a fake (2, 4) mesh: a pad along a whole dim runs
    on each rank's shards and keeps the placements; a pad along a sharded
    dim gathers that dim first.  A plain tensor gets ``F.pad``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    x = torch.randn(2, 3, 4)
    assert torch.equal(sharding.pad(x, (0, 0, 2, 1)),
                       F.pad(x, (0, 0, 2, 1)))
    with dryrun.fake_mesh((2, 4), ("data", "model")) as mesh:
        place = (Shard(0), Shard(2))
        x = DTensor.from_local(torch.empty(2, 16, 8, device="meta"), mesh,
                               place, run_check=False,
                               shape=torch.Size((4, 16, 32)),
                               stride=(512, 32, 1))
        y = sharding.pad(x, (0, 0, 3, 0))
        assert y.placements == place and tuple(y.shape) == (4, 19, 32)
        assert tuple(y.to_local().shape) == (2, 19, 8)
        z = sharding.pad(x, (1, 1))
        assert z.placements == (Shard(0), Replicate())
        assert tuple(z.shape) == (4, 16, 34)
        assert tuple(z.to_local().shape) == (2, 16, 34)


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
