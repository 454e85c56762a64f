#!/usr/bin/env python3
"""Tile sweep of the port's two GEMM kernels on one NVIDIA card.

    python3 gemm_sweep.py

The choices the GEMM's plan and kernels make, measured against their
neighbours at the shapes that set them:
- fp32 (``csrc/gemm.cu``): the K step BK and the ring depth STAGES (the
  source is compiled again with each pair into ``build/gemm_sweep/``), and
  the block tile, at the preemptible GEMM's resume call (1024^2, K blocks
  [3, 8) of 128) and its 128^3 HI product, beside ``torch.addmm`` /
  ``torch.matmul``;
- bf16 (``csrc/gemm_wgmma.cu``): the block width BN at TinyLlama's FFN
  width (512 x 2048 x 5632, and the resume call over K blocks [3, 8) of
  256), beside ``torch.matmul`` / ``torch.addmm(out_dtype=float32)``.
Device times are the median of 20 CUDA-graph replays of 10 calls.  It
prints the card's name and power limit and writes
``results/gemm_sweep.json``; it exits non-zero without CUDA.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

FP32_STEPS = ((16, 3), (32, 3), (32, 4))      # (BK, STAGES)
FP32_TILES = ((128, 64), (32, 32))
BF16_BNS = (128, 192)


def graph_ms(fn, reps: int = 20, per_graph: int = 10) -> float:
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / per_graph)
    return statistics.median(times)


def build_fp32_variants(nvcc: str, csrc: Path, out: Path) -> dict:
    """gemm.cu compiled at each (BK, STAGES), all at once."""
    out.mkdir(parents=True, exist_ok=True)
    src = (csrc / "gemm.cu").read_text()
    assert "constexpr int BK = 32;" in src and "constexpr int STAGES = 3;" \
        in src, "gemm.cu's BK / STAGES lines moved"
    procs = {}
    for bk, st in FP32_STEPS:
        name = f"bk{bk}_s{st}"
        cu = out / f"{name}.cu"
        cu.write_text(src.replace("constexpr int BK = 32;",
                                  f"constexpr int BK = {bk};")
                      .replace("constexpr int STAGES = 3;",
                               f"constexpr int STAGES = {st};"))
        procs[name] = subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-shared", f"-I{csrc}", str(cu),
             "-o", str(out / f"lib{name}.so")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc {name}:\n{log}")
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        from repro_torch.kernels import _build
        lib.repro_gemm_f32.argtypes = _build._SIGNATURES["repro_gemm_f32"]
        lib.repro_gemm_f32.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("gemm_sweep: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    main_lib = _build.lib()
    libs = build_fp32_variants(_build._nvcc(), _build.CSRC,
                               _build.BUILD_DIR.parent / "gemm_sweep")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape, dt=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    res = {"card": card, "fp32": {}, "bf16": {}}
    A, B, acc = rn(1024, 1024), rn(1024, 1024), rn(1024, 1024)
    a_sl, b_sl = A[:, 384:], B[384:]
    Ah, Bh = rn(128, 128), rn(128, 128)
    out, outh = torch.empty(1024, 1024, device="cuda"), \
        torch.empty(128, 128, device="cuda")
    want, wanth = torch.addmm(acc, a_sl, b_sl), Ah @ Bh
    res["fp32"]["addmm_resume"] = graph_ms(lambda: torch.addmm(acc, a_sl,
                                                               b_sl))
    res["fp32"]["matmul_128"] = graph_ms(lambda: torch.matmul(Ah, Bh))
    print(f"fp32 library: addmm resume {res['fp32']['addmm_resume']:.5f} ms,"
          f" matmul 128^3 {res['fp32']['matmul_128']:.5f} ms")
    for name, lib in libs.items():
        for bm, bn in FP32_TILES:
            for what, args, o, w in [
                    ("resume", (acc.data_ptr(), 1024, 1024, 640, 1024, 1024,
                                1024), out, want),
                    ("hi128", (None, 128, 128, 128, 128, 128, 0), outh,
                     wanth)]:
                src_a, src_b = (a_sl, b_sl) if what == "resume" else (Ah, Bh)
                seed, M, N, K, lda, ldb, ldacc = args

                def call():
                    err = lib.repro_gemm_f32(
                        0, bm, bn, 1, src_a.data_ptr(), src_b.data_ptr(),
                        seed, o.data_ptr(), M, N, K, lda, ldb, ldacc, N,
                        stream())
                    assert err == 0, err
                call()
                torch.cuda.synchronize()
                err = float((o - w).abs().max())
                assert err < 1e-2, (name, bm, bn, what, err)
                ms = graph_ms(call)
                res["fp32"][f"{name} {bm}x{bn} {what}"] = ms
                print(f"fp32 {name} tile {bm}x{bn} {what}: {ms:.5f} ms",
                      flush=True)
    bf = torch.bfloat16
    a, w = rn(512, 2048, dt=bf), rn(2048, 5632, dt=bf)
    acc2 = rn(512, 5632)
    o16 = torch.empty(512, 5632, device="cuda", dtype=bf)
    o32 = torch.empty(512, 5632, device="cuda")
    res["bf16"]["matmul_w1"] = graph_ms(lambda: torch.matmul(a, w))
    res["bf16"]["addmm_resume"] = graph_ms(lambda: torch.addmm(
        acc2, a[:, 768:], w[768:], out_dtype=torch.float32))
    print(f"bf16 library: matmul W1 {res['bf16']['matmul_w1']:.5f} ms, "
          f"addmm(out_dtype=float32) resume {res['bf16']['addmm_resume']:.5f}"
          " ms")
    for bn in BF16_BNS:
        def full():
            err = main_lib.repro_gemm_bf16(
                1, 1, bn, a.data_ptr(), w.data_ptr(), None, o16.data_ptr(),
                512, 5632, 2048, 2048, 5632, 0, 5632, stream())
            assert err == 0, err

        def resume():
            err = main_lib.repro_gemm_bf16(
                0, 1, bn, a[:, 768:].data_ptr(), w[768:].data_ptr(),
                acc2.data_ptr(), o32.data_ptr(), 512, 5632, 1280, 2048, 5632,
                5632, 5632, stream())
            assert err == 0, err
        full()
        resume()
        torch.cuda.synchronize()
        assert float((o16.float() - (a.float() @ w.float())).abs().max()) < 1
        res["bf16"][f"bn{bn} w1"] = graph_ms(full)
        res["bf16"][f"bn{bn} resume"] = graph_ms(resume)
        print(f"bf16 BN {bn} ({-(-5632 // bn) * 4} blocks): W1 "
              f"{res['bf16'][f'bn{bn} w1']:.5f} ms, resume "
              f"{res['bf16'][f'bn{bn} resume']:.5f} ms", flush=True)
    (ROOT / "results").mkdir(exist_ok=True)
    (ROOT / "results" / "gemm_sweep.json").write_text(json.dumps(res,
                                                                 indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
