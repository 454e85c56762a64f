"""The port's kernel wrappers on the CPU (where they run the plain
versions) against the reference on every sweep of tests/test_kernels.py
at its tolerances: the attention and RG-LRU Pallas kernels in interpret
mode, the GEMM through the reference's plain ``kernels/ref.py`` (its
Pallas GEMM asks for ``pltpu.TPUCompilerParams``, which newer JAX
releases no longer have).

Inputs are made with numpy from a seed and handed to both sides.  The
CUDA kernels themselves are held against the same plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention_tpu as j_decode
from repro.kernels.flash_attention import flash_attention_tpu as j_flash
from repro.kernels.rglru_scan import rglru_scan_tpu as j_rglru
from repro_torch.kernels import _build, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decode_attention import decode_attention_tpu
from repro_torch.kernels.flash_attention import flash_attention_tpu
from repro_torch.kernels.systolic_gemm import gemm_partial, systolic_gemm

SEED = 7


def _normal(shape, salt):
    return np.random.default_rng([SEED, salt]).standard_normal(
        shape).astype(np.float32)


def _pair(x, dtype):
    """The same values as a jax array and a torch CPU tensor."""
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.mark.parametrize("M,K,N,bm,bn,bk", [
    (128, 128, 128, 128, 128, 128),
    (256, 512, 128, 128, 128, 128),
    (512, 256, 384, 128, 128, 128),
    (128, 1024, 256, 64, 128, 256),
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_systolic_gemm_sweep(M, K, N, bm, bn, bk, dtype):
    ja, ta = _pair(_normal((M, K), 0), dtype)
    jb, tb = _pair(_normal((K, N), 1), dtype)
    want = jref.gemm_ref(ja, jb)
    out = systolic_gemm(ta, tb, bm=bm, bn=bn, bk=bk)
    assert out.dtype == ta.dtype and out.shape == (M, N)
    tol = 2e-2 if dtype == "bf16" else 1e-3
    np.testing.assert_allclose(_np(out), _np(want), atol=tol * K ** 0.5,
                               rtol=tol)


@pytest.mark.parametrize("split", [1, 2, 3])
def test_gemm_preempt_resume(split):
    """Preempt mid-K, save the accumulator, resume: equal to the full
    product and to the reference's own chain."""
    M = K = N = 512
    bk = 128
    nk = K // bk
    ja, ta = _pair(_normal((M, K), 0), "f32")
    jb, tb = _pair(_normal((K, N), 2), "f32")
    acc = torch.zeros((M, N), dtype=torch.float32)
    acc = gemm_partial(ta, tb, acc, 0, split, bk=bk)
    saved = acc.clone()                       # accumulator -> "DRAM"
    acc = gemm_partial(ta, tb, saved, split, nk, bk=bk)
    jacc = jnp.zeros((M, N), jnp.float32)
    jacc = jref.gemm_partial_ref(ja, jb, jacc, 0, split, bk)
    jacc = jref.gemm_partial_ref(ja, jb, jacc, split, nk, bk)
    np.testing.assert_allclose(_np(acc), _np(ta @ tb), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(_np(acc), _np(jacc), rtol=1e-4, atol=1e-2)


def test_gemm_partial_keeps_reference_asserts():
    a, b = torch.zeros((64, 96)), torch.zeros((96, 32))
    acc = torch.zeros((64, 32))
    with pytest.raises(AssertionError):
        gemm_partial(a, b, acc, 0, 1, bk=64)          # 96 % 64 != 0
    with pytest.raises(AssertionError):
        gemm_partial(a, b, acc, 2, 2, bk=32)          # empty K range
    out = gemm_partial(a, b, acc, 0, 3, bk=32)
    assert out.dtype == torch.float32 and out.shape == (64, 32)


@pytest.mark.parametrize("B,Hq,Hkv,S,dh,bq,bkv", [
    (1, 4, 4, 128, 64, 64, 64),      # MHA
    (2, 8, 2, 256, 64, 64, 128),     # GQA
    (1, 8, 1, 128, 128, 32, 32),     # MQA
])
def test_flash_attention_sweep(B, Hq, Hkv, S, dh, bq, bkv):
    jq, tq = _pair(_normal((B, Hq, S, dh), 0), "f32")
    jk, tk = _pair(_normal((B, Hkv, S, dh), 1), "f32")
    jv, tv = _pair(_normal((B, Hkv, S, dh), 2), "f32")
    want = j_flash(jq, jk, jv, block_q=bq, block_kv=bkv, interpret=True)
    out = flash_attention_tpu(tq, tk, tv, block_q=bq, block_kv=bkv)
    np.testing.assert_allclose(_np(out), _np(want), atol=5e-5)


@pytest.mark.parametrize("B,H,S,dqk,dv", [(2, 4, 16, 24, 16),
                                           (1, 2, 64, 192, 128)])
def test_flash_attention_with_a_narrower_value_head(B, H, S, dqk, dv):
    """MLA's prefill pairs, whose v head dim is below the key's: the
    wrapper's CPU path against the reference's plain version (its Pallas
    kernel reshapes v to the key's head dim, so it takes no such pair);
    the scale is dqk ** -0.5 on both sides."""
    jq, tq = _pair(_normal((B, H, S, dqk), 0), "f32")
    jk, tk = _pair(_normal((B, H, S, dqk), 1), "f32")
    jv, tv = _pair(_normal((B, H, S, dv), 2), "f32")
    out = flash_attention_tpu(tq, tk, tv)
    assert out.shape == (B, H, S, dv)
    np.testing.assert_allclose(_np(out), _np(jref.flash_attention_ref(
        jq, jk, jv)), atol=5e-5)


@pytest.mark.parametrize("q_offset,softcap,window", [
    (0, 5.0, 0), (24, None, 0), (24, 5.0, 0), (24, None, 8), (40, None, 64)])
def test_flash_plain_version_options_match_the_blocked_twins(
        q_offset, softcap, window):
    """``flash_attention_ref``'s ``q_offset``, ``softcap`` and window +
    ``q_offset`` (a 16-query chunk against Skv = q_offset + 16 keys, GQA
    4/2, q scaled by 4 so the cap of 5 bites) against the port's
    differentiable twins of the reference's jnp functions,
    ``blocked_attention`` and ``blocked_local_attention`` (held against
    the reference in tests/test_torch_train.py).  fp32 on both sides,
    tolerance 1e-5 as there."""
    from repro_torch.models import attention
    Sq, Skv = 16, q_offset + 16
    q = torch.from_numpy(4 * _normal((2, Sq, 4, 16), 0))
    k = torch.from_numpy(_normal((2, Skv, 2, 16), 1))
    v = torch.from_numpy(_normal((2, Skv, 2, 16), 2))
    got = tref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), window=window,
                                   q_offset=q_offset, softcap=softcap)
    if window:
        want = attention.blocked_local_attention(
            q, k, v, window=window, q_offset=q_offset, block_q=8)
    else:
        want = attention.blocked_attention(q, k, v, q_offset=q_offset,
                                           softcap=softcap, block_q=8,
                                           block_kv=8)
    np.testing.assert_allclose(_np(got.transpose(1, 2)), _np(want),
                               atol=1e-5)


@pytest.mark.parametrize("pos", [0, 17, 255])
@pytest.mark.parametrize("B,Hq,Hkv,S,dh", [(2, 8, 2, 256, 64),
                                           (1, 4, 4, 512, 32)])
def test_decode_attention_sweep(B, Hq, Hkv, S, dh, pos):
    jq, tq = _pair(_normal((B, Hq, dh), 0), "f32")
    jk, tk = _pair(_normal((B, Hkv, S, dh), 1), "f32")
    jv, tv = _pair(_normal((B, Hkv, S, dh), 2), "f32")
    want = j_decode(jq, jk, jv, pos, block_s=64, interpret=True)
    out = decode_attention_tpu(tq, tk, tv, pos, block_s=64)
    np.testing.assert_allclose(_np(out), _np(want), atol=5e-5)


@pytest.mark.parametrize("B,S,D,bs,bd", [(2, 128, 256, 32, 128),
                                         (1, 64, 512, 64, 256)])
def test_rglru_plain_version_sweep(B, S, D, bs, bd):
    rng = np.random.default_rng([SEED, 3])
    a = rng.uniform(0.4, 0.999, (B, S, D)).astype(np.float32)
    b = _normal((B, S, D), 4)
    h0 = _normal((B, D), 5)
    want = j_rglru(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0),
                   block_s=bs, block_d=bd, interpret=True)
    out = tref.rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(b),
                              torch.from_numpy(h0))
    np.testing.assert_allclose(_np(out), _np(want), atol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_versions_match_reference_oracles(dtype):
    """ref.py twin by twin, bf16 included (p cast to v's dtype)."""
    jq, tq = _pair(_normal((1, 4, 16, 32), 0), dtype)
    jk, tk = _pair(_normal((1, 2, 16, 32), 1), dtype)
    jv, tv = _pair(_normal((1, 2, 16, 32), 2), dtype)
    tol = 2e-2 if dtype == "bf16" else 1e-5
    np.testing.assert_allclose(
        _np(tref.flash_attention_ref(tq, tk, tv)),
        _np(jref.flash_attention_ref(jq, jk, jv)), atol=tol)
    np.testing.assert_allclose(
        _np(tref.flash_attention_ref(tq, tk, tv, causal=False)),
        _np(jref.flash_attention_ref(jq, jk, jv, causal=False)), atol=tol)
    np.testing.assert_allclose(
        _np(tref.decode_attention_ref(tq[:, :, 0], tk, tv, 9)),
        _np(jref.decode_attention_ref(jq[:, :, 0], jk, jv, 9)), atol=tol)
    ja, ta = _pair(_normal((32, 64), 3), dtype)
    jb, tb = _pair(_normal((64, 16), 4), dtype)
    np.testing.assert_allclose(_np(tref.gemm_ref(ta, tb)),
                               _np(jref.gemm_ref(ja, jb)), atol=tol * 8)
    acc = _normal((32, 16), 5)
    np.testing.assert_allclose(
        _np(tref.gemm_partial_ref(ta, tb, torch.from_numpy(acc), 1, 3, 16)),
        _np(jref.gemm_partial_ref(ja, jb, jnp.asarray(acc), 1, 3, 16)),
        atol=1e-4)


def test_cpu_tensors_never_launch_a_kernel():
    _build.reset_launches()
    q = torch.from_numpy(_normal((1, 4, 8, 16), 0))
    k = torch.from_numpy(_normal((1, 2, 8, 16), 1))
    a = torch.from_numpy(_normal((64, 64), 2))
    ops.flash_attention(q, k, k)
    ops.decode_attention(q[:, :, 0], k, k, 5, block_s=8)
    ops.gemm(a, a, bm=64, bn=64, bk=64)
    ops.gemm_resume(a, a, torch.zeros(64, 64), 0, 1, bk=64)
    ops.flash_attention(q, k, k, window=4)
    ops.rglru(a[None], a[None], a[:1])
    assert _build.LAUNCHES == {"gemm_partial": 0, "systolic_gemm": 0,
                               "decode_attention": 0, "flash_attention": 0,
                               "rglru_scan": 0}
    assert _build._lib is None            # nothing was built or loaded


def _c_entry_points():
    """name -> ctypes kinds of each ``extern "C" int name(...)`` in csrc."""
    import re
    kinds = {"void*": "P", "int": "I", "i64": "L", "float": "F"}
    found = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        text = src.read_text()
        for name, params in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)', text):
            types = []
            for p in params.split(","):
                words = p.replace("const ", "").replace("*", "* ").split()
                types.append(kinds["".join(words[:-1])])
            assert name not in found, f"{name} defined twice"
            found[name] = types
    return found


def test_ctypes_signatures_match_the_c_entry_points():
    """Every C entry point's parameters, in order, as ``_build`` declares
    them to ctypes: a pointer passed as a 32-bit int would be cut."""
    import ctypes
    kind = {ctypes.c_void_p: "P", ctypes.c_int: "I", ctypes.c_longlong: "L",
            ctypes.c_float: "F"}
    declared = {name: [kind[t] for t in argtypes]
                for name, argtypes in _build._SIGNATURES.items()}
    assert declared == _c_entry_points()


@pytest.mark.parametrize("src,macro", [
    ("flash_attention.cu", "REPRO_FLASH_CASE"),
    ("flash_attention_mma.cu", "REPRO_FLASH_MMA_CASE")])
def test_flash_pair_table_matches_the_kernel_dispatch(src, macro):
    """``HEAD_DIMS`` lists exactly the (dqk, dv) pairs each flash kernel's
    dispatch instantiates, read from its source."""
    import re
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    text = (_build.CSRC / src).read_text()
    cases = re.findall(r"^\s*%s\((\d+), (\d+)\)\s*$" % macro, text,
                       re.MULTILINE)
    pairs = [(int(a), int(b)) for a, b in cases]
    assert len(pairs) == len(set(pairs))
    assert set(pairs) == set(HEAD_DIMS)
    assert (192, 128) in pairs and (24, 16) in pairs


@pytest.mark.parametrize("dtype,offset,ok", [
    (torch.bfloat16, 0, True), (torch.bfloat16, 8, True),
    (torch.bfloat16, 4, False), (torch.float32, 4, True),
    (torch.float32, 2, False)])
def test_row_alignment_check(dtype, offset, ok):
    """The 16-byte row copies of the bf16 flash and the decode kernel need
    every row to start 16-byte aligned."""
    base = torch.zeros(4096, dtype=dtype)
    t = base[offset:offset + 4 * 64].view(4, 64)
    if ok:
        _build.check_aligned(t, t[:, None].transpose(0, 1))
    else:
        with pytest.raises(ValueError):
            _build.check_aligned(t)
    with pytest.raises(ValueError):            # a row stride of 12 bytes
        _build.check_aligned(torch.zeros(4, 6, dtype=torch.bfloat16)[:, :4])
