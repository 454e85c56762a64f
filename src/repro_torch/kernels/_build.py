"""Build and load the port's CUDA kernels (plain C interface + ctypes).

The sources under ``kernels/csrc/`` are compiled for ``sm_90a`` at first
CUDA use into ``build/repro_torch_kernels/`` at the repository root,
keyed by a hash of the sources and the flags, so a fresh checkout builds
them with nothing but ``nvcc``.  One ``nvcc`` per object runs in
parallel (a source in ``VARIANTS`` makes a second object with its extra
flags), then one link makes the shared library.  Importing this
module needs no ``nvcc``: the CPU tests import every module.

Each C entry point returns ``cudaGetLastError()`` after its launches;
:func:`check` raises when that is not 0, because a refused launch
never runs and a later synchronize does not report it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
# sources compiled a second time with these flags, into an object of their
# own: the flash kernels' capped instantiations (softcap > 0)
VARIANTS = {"flash_attention.cu": ("-DREPRO_FLASH_CAP=1",),
            "flash_attention_mma.cu": ("-DREPRO_FLASH_CAP=1",)}

# launches of each kernel wrapper; a wrapper adds one where it launches
# its kernel and nowhere else (chip_smoke.py reads these)
LAUNCHES: Dict[str, int] = {"gemm_partial": 0, "systolic_gemm": 0,
                            "decode_attention": 0, "flash_attention": 0,
                            "rglru_scan": 0}
# the GEMM's launches by route (systolic_gemm.gemm_plan): "tma" and
# "async" are the bf16 wgmma kernel's two producers, "ffma" the fp32 kernel
GEMM_ROUTES: Dict[str, int] = {"tma": 0, "async": 0, "ffma": 0}

# C entry points: name -> argtypes (c_void_p for every pointer and the
# stream, c_int / c_longlong for sizes and strides)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # the GEMM's two kernels, routed by systolic_gemm.gemm_plan.  fp32
    # (gemm.cu, FFMA): out_dtype, bm, bn, vec, A, B, acc_in, C, M, N, K,
    # lda, ldb, ldacc, ldc, stream.  bf16 (gemm_wgmma.cu, wgmma): out_dtype,
    # tma, bn, A, B, acc_in, C, M, N, K, lda, ldb, ldacc, ldc, stream
    "repro_gemm_f32": [_I, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _L, _L,
                       _L, _L, _P],
    "repro_gemm_bf16": [_I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _L, _L, _L,
                        _L, _P],
    # dtype, q, k, v, out, part, counters, B, Hkv, G, dh, pos, chunk,
    # n_split, n_grp, q strides (b, h), k strides (b, h, s), v strides
    # (b, h, s), scale, stream
    "repro_decode_attention": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _I, _I, _I, _L, _L, _L, _L, _L, _L, _L,
                               _L, ctypes.c_float, _P],
    # q, k, v, out, B, Hq, Hkv, S, Skv, dqk, dv, causal, window, q_offset,
    # q/k/v/o strides (b, h, s) each, scale, softcap, stream; _f32 is the
    # FFMA kernel (flash_attention.cu), _bf16 the tensor-core one
    # (flash_attention_mma.cu)
    "repro_flash_attention_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                  _I, _I, _I, _L, _L, _L, _L, _L, _L, _L, _L,
                                  _L, _L, _L, _L, ctypes.c_float,
                                  ctypes.c_float, _P],
    "repro_flash_attention_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   _I, _I, _I, _I, _L, _L, _L, _L, _L, _L,
                                   _L, _L, _L, _L, _L, _L, ctypes.c_float,
                                   ctypes.c_float, _P],
    # a, b, h0, out, B, S, D, channels, steps, stages, vec, stream (the
    # plan of rglru_scan.scan_plan)
    "repro_rglru_scan": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _objects():
    """(source, object stem, extra flags) of every object to compile."""
    for src in sorted(CSRC.glob("*.cu")):
        yield src, src.stem, ()
        if src.name in VARIANTS:
            yield src, src.stem + "_cap", VARIANTS[src.name]


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(VARIANTS.items())).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _env_cuda_home() -> Optional[Path]:
    """``CUDA_HOME``, validated: ``None`` when unset or empty, else a
    directory that holds ``bin/nvcc``.  A set value without a compiler
    raises a ``ValueError`` naming the variable."""
    raw = os.environ.get("CUDA_HOME")
    if raw is None or not raw.strip():
        return None
    if not (Path(raw) / "bin" / "nvcc").exists():
        raise ValueError(f"CUDA_HOME={raw!r} holds no bin/nvcc; point "
                         "CUDA_HOME at a CUDA toolkit or unset it")
    return Path(raw)


def _nvcc() -> str:
    home = _env_cuda_home()
    if home is not None:
        return str(home / "bin" / "nvcc")
    if (Path("/usr/local/cuda") / "bin" / "nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's "
                           "kernels are built from source at first use")
    return found


def _build(lib_path: Path) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src, stem, extra in _objects():
            obj = Path(tmp) / (stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *extra, "-Xptxas", "-v", "-c",
                   str(src), "-o", str(obj)]
            procs.append((stem, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for stem, _, p in procs:
            out, _ = p.communicate()
            (Path(tmp) / (stem + ".log")).write_text(out)
            if p.returncode != 0:
                failed.append(f"{stem}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / lib_path.name
        out = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *[str(o) for _, o, _ in procs],
             "-o", str(tmp_lib)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        if out.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + out.stdout)
        for stem, _, _ in procs:
            shutil.copy(Path(tmp) / (stem + ".log"),
                        lib_path.with_name(f"{lib_path.stem}.{stem}.log"))
        os.replace(tmp_lib, lib_path)          # atomic for other builders


def library_path() -> Path:
    """Where the shared library of the current sources is (or will be)."""
    return BUILD_DIR / f"librepro_torch_kernels_{_key()}.so"


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _lib
    with _lock:
        if _lib is None:
            lib_path = library_path()
            if not lib_path.exists():
                _build(lib_path)
            handle = ctypes.CDLL(str(lib_path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def ptxas_report() -> str:
    """What ``-Xptxas -v`` said for each object of the current build."""
    lib()
    stem = library_path().stem
    return "\n".join(p.read_text() for p in
                     sorted(BUILD_DIR.glob(f"{stem}.*.log")))


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(t: torch.Tensor) -> int:
    try:
        return DTYPE_CODE[t.dtype]
    except KeyError:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}") \
            from None


def check_aligned(*tensors: torch.Tensor) -> None:
    """Raise unless every row of each tensor starts 16-byte aligned: the
    kernels that copy rows 16 bytes at a time need it."""
    for t in tensors:
        per = 16 // t.element_size()
        if t.data_ptr() % 16 or any(s % per for s in t.stride()[:-1]):
            raise ValueError("kernel needs rows that start 16-byte aligned "
                             f"(strides {t.stride()}, {t.dtype})")


def check_no_grad(what: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd would record this call: the kernels write into
    fresh buffers through ctypes, so their outputs carry no ``grad_fn``
    and a loss built on them would leave its inputs without gradients.
    It raises on every device, the CPU's plain versions included, so that
    no device trains through a kernel wrapper; training runs the model's
    differentiable twins (``lm.forward``)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{what} has no backward: call it under "
                           "torch.no_grad() or on tensors that do not "
                           "require grad")


def reset_launches() -> None:
    for counts in (LAUNCHES, GEMM_ROUTES):
        for k in counts:
            counts[k] = 0
