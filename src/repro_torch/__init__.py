"""PyTorch/CUDA port of the MESC reproduction.

The JAX package ``repro`` is the reference; this package has its layout
and names and runs on one NVIDIA Hopper card:

  runtime.device  — device resolution (CUDA unless the CPU is asked for)
  runtime.device_config — validated integer environment knobs
  configs         — own copies of ArchConfig and the reference's ten configs
  core            — Crit / Mode / Policy, the MESC serving lane, the task
                    model, programs and task sets, and the lockstep
                    simulation engine in CUDA graphs (simulator_jit)
  scenarios       — CRN splitmix64 draws and the fault scenarios
  serving         — open-loop traffic, the admission front door, the
                    virtual clock and service model, SLO rows, fig12
  kernels         — hand-written sm_90a CUDA kernels, each beside its
                    plain PyTorch version (kernels/ref.py)
  models          — the dense GQA decoder (prefill / decode_step)
  launch          — the serving drive (batch and open-loop) and the
                    preemptible GEMM

Nothing here imports ``jax`` or ``repro``.
"""
