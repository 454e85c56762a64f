"""Hand-written Hopper (sm_90a) CUDA kernels for the compute hot spots.

systolic_gemm     — checkpointable GEMM: fp32 accumulator seeded from a
                    saved one (preemption inside a GEMM) or from zero
flash_attention   — causal flash attention with true tile skipping and an
                    optional local window (prefill)
decode_attention  — split-S flash-decoding for the KV cache (decode)
rglru_scan        — RG-LRU linear recurrence along S (hybrid prefill)

csrc/ holds the CUDA sources, built at first CUDA use by _build.py;
ops.py = the public wrappers; ref.py = the plain PyTorch versions, which
a wrapper runs only for a tensor on the CPU.
"""
from repro_torch.kernels import ops, ref  # noqa: F401
