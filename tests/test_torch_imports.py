"""The PyTorch port stands alone: it imports neither jax nor the reference
package, and it runs on the card unless the CPU is asked for by name."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    import repro_torch
    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return sorted(names)


def _forbidden(name: str) -> bool:
    return name == "jax" or name.startswith("jax.") or name == "repro" \
        or name.startswith("repro.")


def test_every_port_module_is_found():
    mods = _port_modules()
    for want in ("repro_torch.core.serving", "repro_torch.models.lm",
                 "repro_torch.kernels.ops", "repro_torch.kernels._build",
                 "repro_torch.kernels.rglru_scan",
                 "repro_torch.models.recurrent",
                 "repro_torch.launch.serve",
                 "repro_torch.launch.preemptible_gemm",
                 "repro_torch.runtime.device",
                 "repro_torch.core.taskgen",
                 "repro_torch.scenarios", "repro_torch.scenarios.crn",
                 "repro_torch.scenarios.scenario",
                 "repro_torch.serving", "repro_torch.serving.clock",
                 "repro_torch.serving.traffic", "repro_torch.serving.slo",
                 "repro_torch.serving.frontend",
                 "repro_torch.serving.fig12",
                 "repro_torch.core.isa", "repro_torch.core.task",
                 "repro_torch.core.program", "repro_torch.core.simulator",
                 "repro_torch.core.simulator_vec",
                 "repro_torch.core.simulator_jit",
                 "repro_torch.runtime.device_config",
                 "repro_torch.configs.deepseek_v2_lite_16b",
                 "repro_torch.configs.llama4_maverick_400b_a17b",
                 "repro_torch.configs.llava_next_34b",
                 "repro_torch.configs.musicgen_large",
                 "repro_torch.configs.olmo_1b",
                 "repro_torch.configs.phi4_mini_3_8b",
                 "repro_torch.configs.qwen1_5_110b",
                 "repro_torch.configs.xlstm_125m",
                 "repro_torch.core", "repro_torch.core.scheduler",
                 "repro_torch.core.remapper", "repro_torch.core.executor",
                 "repro_torch.core.monitor", "repro_torch.core.wcrt",
                 "repro_torch.core.platform",
                 "repro_torch.experiments",
                 "repro_torch.experiments.spec",
                 "repro_torch.experiments.cache",
                 "repro_torch.experiments.metrics",
                 "repro_torch.experiments.runner",
                 "repro_torch.experiments.multiacc",
                 "repro_torch.pytree",
                 "repro_torch.data", "repro_torch.data.pipeline",
                 "repro_torch.optim", "repro_torch.optim.adamw",
                 "repro_torch.optim.compression",
                 "repro_torch.checkpointing",
                 "repro_torch.checkpointing.checkpoint",
                 "repro_torch.runtime.trainer", "repro_torch.launch.train",
                 "repro_torch._compat",
                 "repro_torch._compat.hypothesis_fallback",
                 "repro_torch.launch.dryrun", "repro_torch.launch.mesh",
                 "repro_torch.launch.perf", "repro_torch.launch.specs",
                 "repro_torch.runtime.hlo_analysis",
                 "repro_torch.runtime.sharding",
                 "repro_torch.kernels.meta"):
        assert want in mods


def test_every_reference_module_has_a_twin():
    """Every module of the JAX package has a counterpart in the port."""
    ref = ROOT / "src" / "repro"
    want = sorted(str(p.relative_to(ref)) for p in ref.rglob("*.py"))
    missing = [m for m in want if not (PORT / m).exists()]
    assert missing == []


def test_importing_the_port_builds_no_mesh_and_no_process_group():
    code = (
        "import importlib, torch.distributed as dist\n"
        "import repro_torch.launch.mesh, repro_torch.launch.dryrun\n"
        "import repro_torch.runtime.sharding as sh\n"
        "print(dist.is_initialized(), sh.current_rules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ,
                                  PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "False None"


def test_importing_the_port_loads_no_jax_and_no_reference():
    # a subprocess: tests/conftest.py has already imported jax here
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(repr(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ,
                                  PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import_in_source(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        assert not any(_forbidden(n) for n in names), \
            f"{path}:{node.lineno} imports {names}"


def test_resolve_device_raises_without_cuda(monkeypatch):
    from repro_torch.runtime.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_entry_points_default_to_the_card(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("tinyllama-1.1b-smoke")
    with pytest.raises(RuntimeError):
        lm.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError):
        lm.init_cache(cfg, 1, 8)


@pytest.mark.parametrize("arch", ["xlstm-125m-smoke", "llava-next-34b-smoke",
                                  "musicgen-large-smoke"])
def test_the_last_families_default_to_the_card(monkeypatch, arch):
    """The xlstm, vlm and audio entry points, like the others, raise
    without CUDA unless the CPU is named."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = get_config(arch)
    assert cfg.family in lm.FAMILIES
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm.init_cache(cfg, 1, 8)
    assert lm.init_cache(cfg, 1, 8, device="cpu")["pos"] == 0


def test_kernel_build_key_covers_every_source():
    from repro_torch.kernels import _build
    srcs = {p.name for p in _build._sources()}
    assert {"gemm.cu", "decode_attention.cu", "flash_attention.cu",
            "rglru_scan.cu", "common.cuh"} <= srcs
    assert _build._key() == _build._key()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.BUILD_DIR == ROOT / "build" / "repro_torch_kernels"


def test_cuda_home_without_nvcc_raises_naming_the_variable(monkeypatch,
                                                         tmp_path):
    from repro_torch.kernels import _build
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(ValueError, match="CUDA_HOME"):
        _build._nvcc()
    (tmp_path / "bin").mkdir()
    (tmp_path / "bin" / "nvcc").write_text("")
    assert _build._nvcc() == str(tmp_path / "bin" / "nvcc")
    monkeypatch.setenv("CUDA_HOME", "  ")
    assert _build._env_cuda_home() is None
    monkeypatch.delenv("CUDA_HOME")
    assert _build._env_cuda_home() is None
