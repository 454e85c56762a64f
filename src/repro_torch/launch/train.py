"""Training entry point: data pipeline -> train_step -> checkpoints (twin of
the reference's ``launch/train.py``), on the card unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --steps 200 --batch 8 --seq 512 --ckpt-dir ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch tinyllama-1.1b-smoke --steps 200 --batch 8 --seq 64

With ``--ckpt-dir`` it saves every ``--ckpt-every`` steps and resumes
from the latest checkpoint there; a batch is a function of (seed, step),
so a resumed run continues the uninterrupted one.  It prints the
reference's ``step ... loss= gnorm= lr= ms/step`` lines.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.checkpointing import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import batch_for_arch
from repro_torch.models.common import CPU_RC, RuntimeConfig
from repro_torch.optim import OptConfig
from repro_torch.pytree import tree_leaves
from repro_torch.runtime.device import resolve_device
from repro_torch.runtime.trainer import init_train_state, make_train_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b-smoke")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    rc = CPU_RC if device.type == "cpu" else RuntimeConfig()
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                        decay_steps=args.steps)
    step_fn = make_train_step(cfg, rc, opt_cfg,
                              microbatches=args.microbatches)

    def init(gen=torch.Generator(device=device), dev=device):
        params, opt = init_train_state(cfg, gen.manual_seed(args.seed), rc,
                                       opt_cfg, dev)
        return {"params": params, "opt": opt}

    start = 0
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, interval=args.ckpt_every)
        # the shapes alone, as the templates of a restore
        templates = init(torch.Generator(), "meta")
        state, start, _ = mgr.restore_or_init(templates, init, device)
        if start:
            print(f"resumed from step {start}")
    else:
        mgr = None
        state = init()

    params, opt = state["params"], state["opt"]
    n = sum(x.numel() for x in tree_leaves(params))
    print(f"arch={cfg.name} params={n/1e6:.2f}M backend={device.type}")
    t0 = time.time()
    for step in range(start, args.steps):
        batch = batch_for_arch(cfg, args.seq, args.batch, step,
                               seed=args.seed)
        params, opt, m = step_fn(params, opt, batch)
        if mgr:
            mgr.maybe_save(step + 1, {"params": params, "opt": opt},
                           extra={"data_step": step + 1})
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = (time.time() - t0) / max(step - start + 1, 1)
            print(f"step {step:5d} loss={float(m['loss']):.4f} "
                  f"gnorm={float(m['grad_norm']):.3f} "
                  f"lr={float(m['lr']):.2e} {dt*1e3:.0f} ms/step",
                  flush=True)
    print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
