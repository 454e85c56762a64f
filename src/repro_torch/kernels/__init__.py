"""Hand-written Hopper (sm_90a) CUDA kernels for the compute hot spots.

systolic_gemm     — checkpointable GEMM: fp32 accumulator seeded from a
                    saved one (preemption inside a GEMM) or from zero
flash_attention   — causal flash attention with true tile skipping and an
                    optional local window (prefill): bf16 on the tensor
                    cores (wgmma fed by TMA, warp-specialised; route
                    "wgmma"), fp32 on FFMA (the parity path)
decode_attention  — flash-decoding for the KV cache (decode) in one
                    launch: split blocks sized to fill the card, the
                    combine done by the last block of each KV head
rglru_scan        — RG-LRU linear recurrence along S (hybrid prefill):
                    blocks of a few channels, one chain lane each, fed by
                    a cp.async ring; bit-equal to the plain version

csrc/ holds the CUDA sources, built at first CUDA use by _build.py;
ops.py = the public wrappers; ref.py = the plain PyTorch versions, which
a wrapper runs only for a tensor on the CPU.
"""
from repro_torch.kernels import ops, ref  # noqa: F401
