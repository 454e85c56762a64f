"""Instruction-level preemption INSIDE a single GEMM on the card (twin of
the reference's ``examples/preemptible_gemm.py``).

A high-criticality request arrives while a large GEMM streams through the
checkpointable GEMM kernel.  Instead of waiting for the full product
(non-preemptive) or restarting it later (kill-based), MESC saves the
partial fp32 accumulator at a K-block boundary, runs the HI work, and
resumes exactly where it stopped.  The reference prints GemminiRT's
modeled save/restore cycles; here the save (device -> host copy of the
accumulator) and the restore (host -> device) are measured.

    PYTHONPATH=src python -m repro_torch.launch.preemptible_gemm
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.systolic_gemm import gemm_partial, systolic_gemm
from repro_torch.runtime.device import resolve_device


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(device=None, M: int = 1024, K: int = 1024, N: int = 1024,
        bk: int = 128, split: int = 3, seed: int = 0) -> dict:
    """LO GEMM for ``split`` of K/bk blocks, accumulator saved to host, a
    HI product, accumulator restored, LO resumed; checked against the
    uninterrupted product.  Returns the measured times and the error."""
    dev = resolve_device(device)
    nk = K // bk
    gen = torch.Generator(device=dev).manual_seed(seed)
    A = torch.randn((M, K), generator=gen, device=dev)
    B = torch.randn((K, N), generator=gen, device=dev)
    Ah = torch.randn((128, 128), generator=gen, device=dev)
    Bh = torch.randn((128, 128), generator=gen, device=dev)

    # LO task starts the big GEMM; after `split` of nk K-blocks HI arrives
    acc = torch.zeros((M, N), dtype=torch.float32, device=dev)
    acc = gemm_partial(A, B, acc, 0, split, bk=bk)
    _sync(dev)

    # --- preemption: save the accumulator ("step_wise_mvout") ---
    t0 = time.perf_counter()
    saved = acc.to("cpu")
    _sync(dev)
    save_s = time.perf_counter() - t0
    del acc

    # --- HI work runs immediately (a small urgent GEMM) ---
    t0 = time.perf_counter()
    hi_out = systolic_gemm(Ah, Bh, bm=128, bn=128, bk=128)
    _sync(dev)
    hi_s = time.perf_counter() - t0

    # --- resume LO from the saved accumulator ---
    t0 = time.perf_counter()
    acc = saved.to(dev)
    _sync(dev)
    restore_s = time.perf_counter() - t0
    acc = gemm_partial(A, B, acc, split, nk, bk=bk)
    _sync(dev)

    want = ref.gemm_ref(A, B)
    err = float((acc - want).abs().max())
    hi_err = float((hi_out - ref.gemm_ref(Ah, Bh)).abs().max())
    return {"device": str(dev), "M": M, "K": K, "N": N, "bk": bk,
            "split": split, "nk": nk, "save_s": save_s,
            "restore_s": restore_s, "hi_s": hi_s,
            "acc_bytes": M * N * 4, "max_abs_err": err,
            "hi_max_abs_err": hi_err}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    out = run(ap.parse_args().device)
    print(f"context save: {out['save_s']*1e3:.3f} ms for "
          f"{out['acc_bytes']/2**20:.1f} MiB fp32 accumulator -> host")
    print(f"HI task served while LO GEMM is suspended "
          f"({out['hi_s']*1e3:.3f} ms, max|err| {out['hi_max_abs_err']:.2e})")
    print(f"context restore: {out['restore_s']*1e3:.3f} ms;  resumed GEMM "
          f"max|err| vs uninterrupted = {out['max_abs_err']:.2e}")
    assert out["max_abs_err"] < 1e-2
    print("preempt/resume exact — the GEMM never restarted from scratch")


if __name__ == "__main__":
    main()
