"""The port's CUDA kernels against their plain versions on the card, the
lockstep simulation engine's CUDA graphs against their pins and the CPU,
and training on the card: gradients against the CPU, the kernel
wrappers' refusal to be differentiated, and trained weights served
through the kernels against ``lm.forward``.

Marked ``cuda``: they need an NVIDIA card and ``nvcc`` and skip anywhere
else.  On the card they run without the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.decode_attention import (decode_attention_tpu,
                                                  edge_positions, plan_for)
from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_attention_tpu
from repro_torch.kernels.rglru_scan import rglru_scan_tpu
from repro_torch.kernels.systolic_gemm import gemm_partial, systolic_gemm

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels run only there)")
    return torch.Generator(device="cuda").manual_seed(5)


def _randn(gen, *shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("split", [1, 2, 3])
def test_gemm_preempt_resume(gen, split):
    a, b = _randn(gen, 512, 512), _randn(gen, 512, 512)
    acc = gemm_partial(a, b, torch.zeros(512, 512, device="cuda"), 0, split,
                       bk=128)
    acc = gemm_partial(a, b, acc.cpu().cuda(), split, 4, bk=128)
    want = ref.gemm_ref(a, b)
    assert _err(acc, want) <= 1e-2 + 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("M,K,N", [(128, 1024, 256), (200, 100, 72)])
def test_systolic_gemm(gen, M, K, N, dtype, tol):
    a, b = _randn(gen, M, K, dtype=dtype), _randn(gen, K, N, dtype=dtype)
    out = systolic_gemm(a, b, bm=M, bn=N, bk=K)
    assert out.dtype == dtype
    want = ref.gemm_ref(a, b)
    assert _err(out, want) <= tol * K ** 0.5 + tol * float(want.abs().max())


def _poisoned(a, b, k0, k1, bk):
    """A and B with NaN outside the K slice [k0*bk, k1*bk)."""
    a, b = a.clone(), b.clone()
    a[:, :k0 * bk] = float("nan")
    a[:, k1 * bk:] = float("nan")
    b[:k0 * bk] = float("nan")
    b[k1 * bk:] = float("nan")
    return a, b


def _one_route(fn):
    """fn()'s result and the one GEMM route it launched."""
    before = dict(_build.GEMM_ROUTES)
    out = fn()
    moved = [k for k, v in _build.GEMM_ROUTES.items() if v != before[k]]
    assert len(moved) == 1 and _build.GEMM_ROUTES[moved[0]] == \
        before[moved[0]] + 1, moved
    return out, moved[0]


@pytest.mark.parametrize("dtype,M,N,bk,nk,route", [
    (torch.float32, 512, 512, 128, 4, "ffma"),
    (torch.float32, 192, 136, 50, 4, "ffma"),      # 4-byte copies
    (torch.bfloat16, 192, 136, 128, 4, "tma"),
    (torch.bfloat16, 200, 72, 100, 4, "async"),    # slice 200 B into a row
    (torch.bfloat16, 512, 5632, 256, 8, "tma"),    # TinyLlama width
])
def test_gemm_partial_reads_only_its_slice_from_a_random_seed(
        gen, dtype, M, N, bk, nk, route):
    """NaN outside the K slice, a random fp32 seed: the result is finite,
    equals the plain version on the clean operands, and repeats bit for
    bit."""
    a, b = _randn(gen, M, nk * bk, dtype=dtype), _randn(gen, nk * bk, N,
                                                       dtype=dtype)
    seed = _randn(gen, M, N)
    k0, k1 = 1, nk - 1
    ap, bp = _poisoned(a, b, k0, k1, bk)
    out, took = _one_route(lambda: gemm_partial(ap, bp, seed, k0, k1, bk=bk))
    assert took == route
    assert torch.equal(out, gemm_partial(ap, bp, seed, k0, k1, bk=bk))
    want = ref.gemm_partial_ref(a, b, seed, k0, k1, bk)
    assert bool(torch.isfinite(out).all())
    assert _err(out, want) <= 1e-2 + 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("M,K,N", [(200, 100, 72), (192, 320, 136),
                                   (130, 33, 70), (512, 2048, 5632)])
def test_systolic_gemm_ragged_routes_and_repeats(gen, M, K, N, dtype, tol):
    """Ragged M, N and K on both kernels and both bf16 routes; a second
    call gives the same bits."""
    a, b = _randn(gen, M, K, dtype=dtype), _randn(gen, K, N, dtype=dtype)
    out, took = _one_route(lambda: systolic_gemm(a, b, bm=M, bn=N, bk=K))
    tma_ok = K % 8 == 0 and N % 8 == 0      # 16-byte rows of A and B
    assert took == ("ffma" if dtype == torch.float32
                    else "tma" if tma_ok else "async")
    assert torch.equal(out, systolic_gemm(a, b, bm=M, bn=N, bk=K))
    want = ref.gemm_ref(a, b)
    assert _err(out, want) <= tol * K ** 0.5 + tol * float(want.abs().max())


def test_bf16_gemm_in_a_cuda_graph_equals_the_eager_call(gen):
    """The TMA descriptors travel as kernel parameters, so a captured
    resume call replays."""
    bf = torch.bfloat16
    a, w = _randn(gen, 512, 2048, dtype=bf), _randn(gen, 2048, 5632, dtype=bf)
    acc = _randn(gen, 512, 5632)
    want = gemm_partial(a, w, acc, 3, 8, bk=256)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gemm_partial(a, w, acc, 3, 8, bk=256)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = gemm_partial(a, w, acc, 3, 8, bk=256)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


@pytest.mark.parametrize("pos", [0, 63, 64, 200])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5),
                                       (torch.bfloat16, 2e-2)])
def test_decode_attention_on_a_cache_view(gen, pos, dtype, tol):
    q = _randn(gen, 2, 8, 64, dtype=dtype)
    kc = _randn(gen, 2, 256, 2, 64, dtype=dtype).transpose(1, 2)
    vc = _randn(gen, 2, 256, 2, 64, dtype=dtype).transpose(1, 2)
    assert _err(decode_attention_tpu(q, kc, vc, pos),
                ref.decode_attention_ref(q, kc, vc, pos)) <= tol


@pytest.mark.parametrize("S,dh", [(8, 64), (100, 16), (128, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_ragged_and_views(gen, S, dh, causal):
    q = _randn(gen, 1, S, 8, dh).transpose(1, 2)
    k = _randn(gen, 1, S, 2, dh).transpose(1, 2)
    v = _randn(gen, 1, S, 2, dh).transpose(1, 2)
    out = flash_attention_tpu(q, k, v, causal=causal)
    assert out.shape == (1, 8, S, dh)
    assert _err(out, ref.flash_attention_ref(q, k, v, causal=causal)) <= 5e-5


def _scan_inputs(gen, B, S, D):
    a = torch.rand((B, S, D), generator=gen, device="cuda") * 0.599 + 0.4
    return a, _randn(gen, B, S, D), _randn(gen, B, D)


@pytest.mark.parametrize("B,S,D", [(2, 128, 256), (1, 64, 512),
                                   (1, 512, 2560), (1, 37, 100),
                                   (1, 8, 2560), (2, 1, 2560),
                                   (1, 2560, 2560), (1, 33, 37)])
def test_rglru_scan(gen, B, S, D):
    """No FMA contraction and S in order in the kernel: equal to the plain
    version bit for bit ((1, 33, 37) on the 4-byte copies)."""
    a, b, h0 = _scan_inputs(gen, B, S, D)
    out = rglru_scan_tpu(a, b, h0, block_s=S, block_d=D)
    assert out.shape == (B, S, D) and out.dtype == torch.float32
    assert torch.equal(out, ref.rglru_scan_ref(a, b, h0))


@pytest.mark.parametrize("B,S,D", [(1, 512, 2560), (1, 37, 100),
                                   (1, 33, 37)])
def test_rglru_scan_every_instantiation_is_bit_equal(gen, B, S, D):
    """Every block width, tile and ring depth the kernel instantiates, on
    both copy routes where D allows 16-byte copies."""
    import dataclasses
    import itertools

    from repro_torch.kernels import rglru_scan
    a, b, h0 = _scan_inputs(gen, B, S, D)
    want = ref.rglru_scan_ref(a, b, h0)
    plan = rglru_scan.scan_plan(B, S, D, a_ptr=a.data_ptr(),
                                b_ptr=b.data_ptr())
    routes = ("cp16", "cp4") if plan.route == "cp16" else ("cp4",)
    for c, t, st, route in itertools.product(
            rglru_scan.CHANNELS, rglru_scan.STEPS, rglru_scan.STAGES, routes):
        alt = dataclasses.replace(plan, channels=c, steps=t, stages=st,
                                  route=route)
        assert torch.equal(rglru_scan.launch_plan(a, b, h0, alt), want), alt


def test_rglru_scan_repeats_bit_for_bit(gen):
    a, b, h0 = _scan_inputs(gen, 1, 512, 2560)
    first = rglru_scan_tpu(a, b, h0)
    for _ in range(3):
        assert torch.equal(rglru_scan_tpu(a, b, h0), first)


def test_rglru_scan_in_a_cuda_graph_equals_the_eager_call(gen):
    a, b, h0 = _scan_inputs(gen, 1, 512, 2560)
    want = rglru_scan_tpu(a, b, h0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rglru_scan_tpu(a, b, h0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = rglru_scan_tpu(a, b, h0)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


@pytest.mark.parametrize("S,window", [(2560, 2048), (300, 64), (100, 1)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5),
                                       (torch.bfloat16, 2e-2)])
def test_flash_attention_window_dh256(gen, S, window, dtype, tol):
    q = _randn(gen, 1, S, 10, 256, dtype=dtype).transpose(1, 2)
    k = _randn(gen, 1, S, 1, 256, dtype=dtype).transpose(1, 2)
    v = _randn(gen, 1, S, 1, 256, dtype=dtype).transpose(1, 2)
    out = flash_attention_tpu(q, k, v, window=window, block_q=S, block_kv=S)
    assert _err(out, ref.flash_attention_ref(q, k, v, window=window)) <= tol


BF16_TOL = 2e-2
# the square (dqk == dv) pairs, by their head dim
SQUARE_DIMS = [d for d, e in HEAD_DIMS if d == e]


@pytest.mark.parametrize("dh", SQUARE_DIMS)
@pytest.mark.parametrize("S", [8, 100])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_tensor_core_kernel_every_head_dim(gen, dh, S, causal):
    """The bf16 (tensor-core) kernel at every head dim it instantiates:
    GQA 8/2, a ragged S, model-layout views."""
    bf = torch.bfloat16
    q = _randn(gen, 1, S, 8, dh, dtype=bf).transpose(1, 2)
    k = _randn(gen, 1, S, 2, dh, dtype=bf).transpose(1, 2)
    v = _randn(gen, 1, S, 2, dh, dtype=bf).transpose(1, 2)
    out = flash_attention_tpu(q, k, v, causal=causal)
    assert out.dtype == bf and out.shape == (1, 8, S, dh)
    assert _err(out, ref.flash_attention_ref(q, k, v, causal=causal)) \
        <= BF16_TOL


@pytest.mark.parametrize("dh", SQUARE_DIMS)
@pytest.mark.parametrize("B,Hq,Hkv", [(1, 4, 1), (2, 4, 4)])
def test_flash_bf16_window_every_head_dim(gen, dh, B, Hq, Hkv):
    """A window that cuts the band, MQA and MHA, batch 2."""
    bf = torch.bfloat16
    q = _randn(gen, B, Hq, 300, dh, dtype=bf)
    k = _randn(gen, B, Hkv, 300, dh, dtype=bf)
    v = _randn(gen, B, Hkv, 300, dh, dtype=bf)
    out = flash_attention_tpu(q, k, v, window=64, block_q=300,
                              block_kv=300)
    assert _err(out, ref.flash_attention_ref(q, k, v, window=64)) <= BF16_TOL


def _nan_framed(gen, B, S, H, D, dtype):
    """A (B,H,S,D) view of random values inside a NaN frame: one more
    sequence row, one more head and 8 more columns than the view holds
    (8 keeps bf16 rows 16-byte aligned), so a kernel that reads past the
    view returns NaN."""
    buf = torch.full((B, S + 1, H + 1, D + 8), float("nan"), device="cuda",
                     dtype=dtype)
    view = buf[:, :S, :H, :D]
    view.copy_(_randn(gen, B, S, H, D, dtype=dtype))
    return view.transpose(1, 2)


@pytest.mark.parametrize("dqk,dv", [p for p in HEAD_DIMS if p[0] != p[1]])
@pytest.mark.parametrize("S", [8, 100, 512])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5),
                                       (torch.bfloat16, BF16_TOL)])
def test_flash_mla_head_dims_inside_a_nan_frame(gen, dqk, dv, S, dtype, tol):
    """MLA's prefill shapes: the value head dim below the key's (DeepSeek-
    V2-Lite's 192/128, its smoke config's 24/16; 16 heads, MHA), causal,
    a ragged S, every view framed in NaN.  At 24 the tensor-core kernel
    pads the key dim to 32 with zero columns it must not read from the
    frame."""
    H = 16 if dqk == 192 else 4
    q = _nan_framed(gen, 1, S, H, dqk, dtype)
    k = _nan_framed(gen, 1, S, H, dqk, dtype)
    v = _nan_framed(gen, 1, S, H, dv, dtype)
    out = flash_attention_tpu(q, k, v)
    assert out.dtype == dtype and out.shape == (1, H, S, dv)
    assert bool(torch.isfinite(out).all())
    assert _err(out, ref.flash_attention_ref(q, k, v)) <= tol


@pytest.mark.parametrize("q_offset,softcap,window",
                         [(156, None, 0), (0, 5.0, 0), (156, 5.0, 0),
                          (156, None, 64)])
@pytest.mark.parametrize("dqk,dv", HEAD_DIMS)
@pytest.mark.parametrize("dtype,tol,rtol", [(torch.float32, 5e-5, 0.0),
                                            (torch.bfloat16, BF16_TOL,
                                             2 ** -7)])
def test_flash_q_offset_and_softcap_every_head_dim(gen, dqk, dv, q_offset,
                                                   softcap, window, dtype,
                                                   tol, rtol):
    """A ragged 100-query chunk at ``q_offset`` against Skv = q_offset +
    100 keys (GQA 8/2), with a cap that bites (q scaled by 4: scaled
    scores of std ~4 against a cap of 5) and a window across the chunk's
    start; the key and value buffers hold NaN rows past Skv, which the
    kernels must not read.  The sharp softmax gives outputs up to the
    values' extremes, so bf16 is held to BF16_TOL plus 2^-7 (the most one
    bf16 ulp is of the value it rounds) of the largest output."""
    S, Skv = 100, q_offset + 100
    q = (4 * _randn(gen, 1, S, 8, dqk)).to(dtype).transpose(1, 2)
    kv = []
    for d in (dqk, dv):
        buf = torch.full((1, Skv + 16, 2, d), float("nan"), device="cuda",
                         dtype=dtype)
        buf[:, :Skv] = _randn(gen, 1, Skv, 2, d, dtype=dtype)
        kv.append(buf[:, :Skv].transpose(1, 2))
    out = flash_attention_tpu(q, *kv, q_offset=q_offset, softcap=softcap,
                              window=window, block_q=S, block_kv=Skv)
    assert out.dtype == dtype and out.shape == (1, 8, S, dv)
    assert bool(torch.isfinite(out).all())
    want = ref.flash_attention_ref(q, *kv, q_offset=q_offset,
                                   softcap=softcap, window=window)
    assert _err(out, want) <= tol + rtol * float(want.float().abs().max())


@pytest.mark.parametrize("dqk,dv", HEAD_DIMS)
def test_flash_launches_take_the_wgmma_route(gen, dqk, dv):
    """Every bf16 flash call at every pair launches the wgmma kernel
    (route "wgmma"), every fp32 call the FFMA one: one launch each."""
    for dtype, route in ((torch.bfloat16, "wgmma"), (torch.float32, "ffma")):
        q = _randn(gen, 1, 100, 8, dqk, dtype=dtype).transpose(1, 2)
        k = _randn(gen, 1, 100, 2, dqk, dtype=dtype).transpose(1, 2)
        v = _randn(gen, 1, 100, 2, dv, dtype=dtype).transpose(1, 2)
        before = dict(_build.FLASH_ROUTES)
        flash_attention_tpu(q, k, v)
        moved = {r: n - before[r] for r, n in _build.FLASH_ROUTES.items()
                 if n != before[r]}
        assert moved == {route: 1}, (dtype, moved)


def test_flash_in_a_cuda_graph_equals_the_eager_call(gen):
    """LLaVA-NeXT-34B's prefill layer (GQA 56/8, dh 128, 1024 tokens,
    model-layout views): the TMA maps travel as kernel parameters, so a
    captured call replays bit for bit what the eager call computed."""
    bf = torch.bfloat16
    q = _randn(gen, 1, 1024, 56, 128, dtype=bf).transpose(1, 2)
    k = _randn(gen, 1, 1024, 8, 128, dtype=bf).transpose(1, 2)
    v = _randn(gen, 1, 1024, 8, 128, dtype=bf).transpose(1, 2)
    want = flash_attention_tpu(q, k, v)
    assert _err(want, ref.flash_attention_ref(q, k, v)) <= BF16_TOL
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flash_attention_tpu(q, k, v)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_attention_tpu(q, k, v)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


def test_flash_refuses_a_pair_it_does_not_instantiate(gen):
    q = _randn(gen, 1, 2, 8, 64).transpose(1, 2)
    with pytest.raises(ValueError):
        flash_attention_tpu(q, q, q[..., :32])


# (B, Hkv, G, dh, S): TinyLlama, recurrentgemma-2b's ring, B*Hkv > 1, MHA,
# G 10 over two head groups at batch 2, G 48 in two passes over the chunk
DECODE_SHAPES = [(1, 4, 8, 64, 1024), (1, 1, 10, 256, 2048),
                 (2, 2, 4, 64, 256), (1, 4, 1, 32, 256),
                 (2, 2, 10, 256, 512), (1, 2, 48, 64, 256)]


def _edge_positions(q, kc):
    """0, 535, the last slot and the positions at the edges of the plan
    the wrapper launches (a last chunk of one key, a full last chunk, a
    tile edge, a chunk that walks the ring)."""
    return edge_positions(lambda pos: plan_for(q, kc, pos), kc.shape[2])


@pytest.mark.parametrize("B,Hkv,G,dh,S", DECODE_SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5),
                                       (torch.bfloat16, BF16_TOL)])
def test_decode_at_chunk_edges_repeats_bit_for_bit(gen, B, Hkv, G, dh, S,
                                                   dtype, tol):
    """Against the plain version at the cluster plan's chunk and tile
    edges; a second call gives the same bits (the cluster folds its
    partials in rank order)."""
    q = _randn(gen, B, Hkv * G, dh, dtype=dtype)
    kc = _randn(gen, B, S, Hkv, dh, dtype=dtype).transpose(1, 2)
    vc = _randn(gen, B, S, Hkv, dh, dtype=dtype).transpose(1, 2)
    for pos in _edge_positions(q, kc):
        out = decode_attention_tpu(q, kc, vc, pos)
        again = decode_attention_tpu(q, kc, vc, pos)
        assert torch.equal(out, again), pos
        assert _err(out, ref.decode_attention_ref(q, kc, vc, pos)) <= tol, \
            pos


# the vlm and audio families' head layouts: LLaVA-NeXT-34B's GQA 56/8 at
# dh 128 (G 7, decode head groups of 4 + 3), MusicGen-large's MHA 32/32
# at dh 64 (G 1)
FAMILY_HEADS = [pytest.param(56, 8, 128, id="llava-G7"),
                pytest.param(32, 32, 64, id="musicgen-G1")]
PREFILL_LEN = {128: 1024, 64: 512}    # the chip_smoke prefills, by dh


@pytest.mark.parametrize("Hq,Hkv,dh", FAMILY_HEADS)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5),
                                       (torch.bfloat16, BF16_TOL)])
def test_flash_at_the_vlm_and_audio_head_layouts(gen, Hq, Hkv, dh, dtype,
                                                 tol):
    """Causal flash at each family's prefill length, inside NaN frames."""
    S = PREFILL_LEN[dh]
    q = _nan_framed(gen, 1, S, Hq, dh, dtype)
    k = _nan_framed(gen, 1, S, Hkv, dh, dtype)
    v = _nan_framed(gen, 1, S, Hkv, dh, dtype)
    out = flash_attention_tpu(q, k, v)
    assert out.dtype == dtype and out.shape == (1, Hq, S, dh)
    assert bool(torch.isfinite(out).all())
    assert _err(out, ref.flash_attention_ref(q, k, v)) <= tol


@pytest.mark.parametrize("Hq,Hkv,dh", FAMILY_HEADS)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5),
                                       (torch.bfloat16, BF16_TOL)])
def test_decode_at_the_vlm_and_audio_head_layouts(gen, Hq, Hkv, dh, dtype,
                                                  tol):
    """Decode on a 1024-slot cache at the cluster plan's edges, q and the
    cache inside NaN frames, each call twice and bit-identical."""
    q = _nan_framed(gen, 1, 1, Hq, dh, dtype)[:, :, 0]
    kc = _nan_framed(gen, 1, 1024, Hkv, dh, dtype)
    vc = _nan_framed(gen, 1, 1024, Hkv, dh, dtype)
    for pos in _edge_positions(q, kc):
        out = decode_attention_tpu(q, kc, vc, pos)
        assert torch.equal(out, decode_attention_tpu(q, kc, vc, pos)), pos
        assert bool(torch.isfinite(out).all()), pos
        assert _err(out, ref.decode_attention_ref(q, kc, vc, pos)) <= tol, \
            pos


@pytest.mark.parametrize("arch", ["xlstm-125m-smoke", "llava-next-34b-smoke",
                                  "musicgen-large-smoke"])
def test_last_families_on_the_card_equal_the_cpu(gen, arch):
    """One prefill (xLSTM: the chunkwise form, 32 tokens in chunks of 16;
    the vlm: 8 patch embeddings + 8 tokens; audio: (1, 16, 4) codebook
    ids) and four teacher-forced decode steps of the smoke config in fp32,
    the card (kernels) against the CPU (plain versions); one flash launch
    a prefill and one decode launch a step per attention layer, none for
    xLSTM."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.common import CPU_RC
    cfg = get_config(arch)
    p_dev = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           CPU_RC, device="cuda")
    p_cpu = _to_cpu(p_dev)
    rng = np.random.default_rng(4)
    S = 32 if cfg.family == "xlstm" else 16 if cfg.family == "audio" else 8
    shape = (1, S, cfg.n_codebooks) if cfg.family == "audio" else (1, S)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, shape))}
    if cfg.family == "vlm":
        batch["vis_embeds"] = torch.from_numpy(rng.standard_normal(
            (1, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32))
    n_attn = 0 if cfg.family == "xlstm" else cfg.n_layers
    lc, cc = lm.prefill(cfg, p_cpu, batch, CPU_RC, max_len=64)
    _build.reset_launches()
    ld, cd = lm.prefill(cfg, p_dev, batch, CPU_RC, max_len=64)
    assert _build.LAUNCHES["flash_attention"] == n_attn, _build.LAUNCHES
    assert _err(ld.cpu(), lc) <= 1e-4
    for _ in range(4):
        tok = torch.argmax(lc, dim=-1)
        lc, cc = lm.decode_step(cfg, p_cpu, tok, cc, CPU_RC)
        ld, cd = lm.decode_step(cfg, p_dev, tok, cd, CPU_RC)
        assert ld.shape == lc.shape and _err(ld.cpu(), lc) <= 1e-4
    assert _build.LAUNCHES["decode_attention"] == 4 * n_attn
    for k, t in cc.items():
        if k != "pos":
            assert _err(cd[k].cpu(), t) <= 1e-4, k


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


def test_decode_in_a_cuda_graph_equals_the_eager_call(gen):
    """Nothing but the output is allocated and nothing is left for the
    next call, so a decode call is captured with no eager call before it
    and its replays equal the eager call."""
    bf = torch.bfloat16
    q = _randn(gen, 1, 10, 256, dtype=bf)
    kc = _randn(gen, 1, 2048, 1, 256, dtype=bf).transpose(1, 2)
    vc = _randn(gen, 1, 2048, 1, 256, dtype=bf).transpose(1, 2)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attention_tpu(q, kc, vc, 1535)
    want = decode_attention_tpu(q, kc, vc, 1535)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


@pytest.mark.parametrize("B,Hkv,G,dh,S", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_ignores_nan_past_pos(gen, B, Hkv, G, dh, S, dtype):
    """Cache rows past ``pos`` poisoned with NaN (in the last chunk's
    tile and in later chunks' rows) leave the output finite and equal, bit
    for bit, to the call on the clean cache."""
    q = _randn(gen, B, Hkv * G, dh, dtype=dtype)
    kc = _randn(gen, B, S, Hkv, dh, dtype=dtype).transpose(1, 2)
    vc = _randn(gen, B, S, Hkv, dh, dtype=dtype).transpose(1, 2)
    for pos in _edge_positions(q, kc):
        kp, vp = kc.clone(), vc.clone()
        kp[:, :, pos + 1:] = float("nan")
        vp[:, :, pos + 1:] = float("nan")
        clean = decode_attention_tpu(q, kc, vc, pos)
        got = decode_attention_tpu(q, kp, vp, pos)
        assert bool(torch.isfinite(got).all()), pos
        assert torch.equal(got, clean), pos


# the device-position launches: DECODE_SHAPES and LLaVA-NeXT-34B's layer
# at its 4096-slot context (G 7, dh 128)
BUCKET_SHAPES = DECODE_SHAPES + [(1, 8, 7, 128, 4096)]


@pytest.mark.parametrize("B,Hkv,G,dh,S", BUCKET_SHAPES)
def test_decode_at_a_device_position_under_one_bucket_plan(gen, B, Hkv, G,
                                                           dh, S):
    """The plan for the last slot, the position read from the device:
    against the plain version at the per-position plan's edges and the
    bucket plan's chunk edges (chunks past pos empty), each call twice
    and bit-identical, and the same bits with the rows past pos NaN;
    one captured call replayed at every such position equals the eager
    device-position call; at the plan's own position the launch is the
    per-position one, bit for bit."""
    bf = torch.bfloat16
    q = _randn(gen, B, Hkv * G, dh, dtype=bf)
    kc = _randn(gen, B, S, Hkv, dh, dtype=bf).transpose(1, 2)
    vc = _randn(gen, B, S, Hkv, dh, dtype=bf).transpose(1, 2)
    top = S - 1
    plan = plan_for(q, kc, top)
    chunk_edges = {c * plan.chunk + d for c in range(plan.n_split)
                   for d in (-1, 0, 1)}
    positions = sorted(p for p in set(_edge_positions(q, kc)) | chunk_edges
                       if 0 <= p <= top)
    at = torch.zeros((), dtype=torch.long, device="cuda")
    eager = {}
    for pos in positions:
        at.fill_(pos)
        out = decode_attention_tpu(q, kc, vc, at, pos_top=top)
        assert torch.equal(out, decode_attention_tpu(q, kc, vc, at,
                                                     pos_top=top)), pos
        assert _err(out, ref.decode_attention_ref(q, kc, vc, pos)) \
            <= BF16_TOL, pos
        kp, vp = kc.clone(), vc.clone()
        kp[:, :, pos + 1:] = float("nan")
        vp[:, :, pos + 1:] = float("nan")
        assert torch.equal(out, decode_attention_tpu(q, kp, vp, at,
                                                     pos_top=top)), pos
        eager[pos] = out
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = decode_attention_tpu(q, kc, vc, at, pos_top=top)
    for pos in positions:
        at.fill_(pos)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(replayed, eager[pos]), pos
    assert torch.equal(eager[top], decode_attention_tpu(q, kc, vc, top))
    with pytest.raises(ValueError):                # a device pos, no top
        decode_attention_tpu(q, kc, vc, at)


def test_decode_on_two_streams_gives_the_solo_results(gen):
    """Two decode calls in flight on two streams (TinyLlama's and the
    hybrid's shapes) share nothing: each gives its solo result."""
    bf = torch.bfloat16
    calls = []
    for Hq, Hkv, dh, S, pos in [(32, 4, 64, 1024, 535),
                                (10, 1, 256, 2048, 2047)]:
        q = _randn(gen, 1, Hq, dh, dtype=bf)
        kc = _randn(gen, 1, S, Hkv, dh, dtype=bf).transpose(1, 2)
        vc = _randn(gen, 1, S, Hkv, dh, dtype=bf).transpose(1, 2)
        calls.append((q, kc, vc, pos))
    solo = [decode_attention_tpu(*c) for c in calls]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in calls]
    outs = [[] for _ in calls]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(20):
        for s, c, o in zip(streams, calls, outs):
            with torch.cuda.stream(s):
                o.append(decode_attention_tpu(*c))
    torch.cuda.synchronize()
    for want, got in zip(solo, outs):
        assert all(torch.equal(g, want) for g in got)


def test_decode_is_one_kernel_launch(gen):
    """The combine runs in the same launch as the split blocks."""
    from torch.profiler import ProfilerActivity, profile
    q = _randn(gen, 1, 32, 64, dtype=torch.bfloat16)
    kc = _randn(gen, 1, 4, 1024, 64, dtype=torch.bfloat16)
    decode_attention_tpu(q, kc, kc, 535)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        decode_attention_tpu(q, kc, kc, 535)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "decode_kernel" in kernels[0].name, \
        [e.name for e in kernels]


def test_each_call_counts_one_launch(gen):
    _build.reset_launches()
    a = _randn(gen, 64, 64)
    systolic_gemm(a, a)
    gemm_partial(a, a, torch.zeros(64, 64, device="cuda"), 0, 1, bk=64)
    q = _randn(gen, 1, 4, 16, 32)
    flash_attention_tpu(q, q, q)
    decode_attention_tpu(q[:, :, 0], q, q, 9)
    rglru_scan_tpu(a[None], a[None], a[:1])
    assert _build.LAUNCHES == {"gemm_partial": 1, "systolic_gemm": 1,
                               "decode_attention": 1, "flash_attention": 1,
                               "rglru_scan": 1}


def test_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    h = _randn(gen, 64, 64, dtype=torch.float16)
    with pytest.raises(TypeError):
        systolic_gemm(h, h)
    q = _randn(gen, 1, 4, 16, 48)
    with pytest.raises(ValueError):
        flash_attention_tpu(q, q, q)               # head dim 48
    with pytest.raises(ValueError):
        decode_attention_tpu(q[:, :, 0], q, q, 16)  # pos outside the cache
    a, h0 = _randn(gen, 2, 8, 4), _randn(gen, 2, 8)
    with pytest.raises(TypeError):                 # the scan is fp32 only
        rglru_scan_tpu(a.transpose(1, 2).contiguous().bfloat16(),
                       a.transpose(1, 2).contiguous().bfloat16(),
                       h0.bfloat16())
    with pytest.raises(ValueError):                # not contiguous
        rglru_scan_tpu(a.transpose(1, 2), a.transpose(1, 2), h0)
    z = torch.zeros((65536, 1, 1), device="cuda")
    with pytest.raises(ValueError):                # more rows than grid y
        rglru_scan_tpu(z, z, z[:, 0])


def test_open_loop_drive_matches_solo_replays_on_the_card(gen):
    """A short open-loop run on the card (tinyllama-1.1b-smoke, bf16, one
    resident slot): every request finishes, and the tokens of every HI
    request and every saved request equal a solo replay of its prompt."""
    from repro_torch.core.scheduler import Policy
    from repro_torch.core.serving import MESCServer, Request
    from repro_torch.core.task import Crit
    from repro_torch.launch import serve
    from repro_torch.serving import Poisson, build_workload
    cfg, params, rc = serve.load_model("tinyllama-1.1b-smoke", "cuda")
    wl = build_workload(seed=0, lo_process=Poisson(40.0),
                        hi_process=Poisson(20.0), n_lo=6, n_hi=3,
                        lo_tokens=12, hi_tokens=3)
    _build.reset_launches()
    got = serve.run_traffic_real(cfg, params, Policy.mesc(), wl, rc=rc,
                                 resident_slots=1)
    steps = sum(len(r.generated) for r in got.values()) + serve.WARMUP_TOKENS
    assert _build.LAUNCHES["decode_attention"] == cfg.n_layers * steps
    assert _build.LAUNCHES["flash_attention"] == cfg.n_layers * (len(wl) + 1)
    for r in got.values():
        assert r.done and len(r.generated) == r.max_new_tokens
        if r.crit == Crit.HI or r.saves:
            solo = MESCServer(cfg, params, policy=Policy.non_preemptive(),
                              rc=rc)
            solo.submit(Request(rid=0, priority=0, prompt=r.prompt,
                                max_new_tokens=r.max_new_tokens,
                                crit=Crit.LO))
            assert solo.run()[0].generated == r.generated, r.rid


# ----------------------------------------------------------------------
# the decode step replayed as a CUDA graph (models/decode_graph.py)
# ----------------------------------------------------------------------

# few-layer cuts at full width: LLaVA-NeXT-34B (dense GQA 56/8, dh 128,
# the decode kernel) and DeepSeek-V2-Lite (MLA, top-6 of 64 experts)
GRAPH_ARCHS = {"llava": "llava-next-34b", "deepseek": "deepseek-v2-lite-16b"}
GRAPH_PROMPT, GRAPH_STEPS, GRAPH_LEN = 504, 16, 1024   # crosses 511 | 512


@pytest.fixture(scope="module", params=sorted(GRAPH_ARCHS))
def few_layers(request):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels run only there)")
    cfg = dataclasses.replace(get_config(GRAPH_ARCHS[request.param]),
                              n_layers=2)
    yield serve.init_model(cfg, "cuda")
    torch.cuda.empty_cache()


def _prompt(cfg, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return {"tokens": torch.randint(0, cfg.vocab, (1, GRAPH_PROMPT),
                                    generator=g, device="cuda")}


def test_graphed_decode_equals_the_eager_body(few_layers):
    """Steps across a bucket edge (positions 504-519), replayed against
    the eager body on its own copy of the cache, both fed the eager
    tokens: the same argmax token and logits within the bf16 tolerance of
    the largest logit at every step, caches within it at the end; one
    eager step a bucket (its first, before its capture), replays
    otherwise; one decode launch a layer a step counted for each
    path."""
    from repro_torch.models import decode_graph, lm
    from repro_torch.runtime import trace
    cfg, params, rc = few_layers
    logits, cache = lm.prefill(cfg, params, _prompt(cfg, 1), rc,
                               max_len=GRAPH_LEN)
    mirror = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
              for k, v in cache.items()}
    reach = lm._plan_reach(cfg, cache)
    _build.reset_launches()
    trace.enable()
    try:
        for _ in range(GRAPH_STEPS):
            pos = mirror["pos"]
            tok = torch.argmax(logits, dim=-1)
            want = lm._decode_step(
                cfg, params, tok, mirror, rc,
                torch.full((), pos, dtype=torch.long, device="cuda"),
                decode_graph.bucket_top(pos, reach))
            mirror["pos"] = pos + 1
            got, cache = lm.decode_step(cfg, params, tok, cache, rc)
            assert cache["pos"] == pos + 1
            assert torch.equal(got.argmax(-1), want.argmax(-1)), pos
            assert _err(got, want) <= BF16_TOL * max(
                1.0, float(want.float().abs().max())), pos
            logits = want
        _, counters = trace.drain()
    finally:
        trace.disable()
    buckets = 1 if reach is None else 2
    assert counters["model.decode_eager"] == buckets
    assert counters["model.decode_graph_replays"] == GRAPH_STEPS - buckets
    assert counters["model.decode_graph_captures"] == buckets
    attn = 0 if reach is None else cfg.n_layers
    assert _build.LAUNCHES["decode_attention"] == 2 * attn * GRAPH_STEPS
    for k, t in mirror.items():
        if k != "pos":
            assert _err(cache[k], t) <= BF16_TOL, k


def test_after_a_warm_up_the_steps_capture_nothing(few_layers):
    """A warm-up of two live requests that each cross the bucket edge;
    then a new request in a freed entry and a cache restored from the
    host (copied into an entry once) step across the same buckets with
    no capture and no eager step, every step a replay."""
    from repro_torch.models import lm
    from repro_torch.runtime import trace
    cfg, params, rc = few_layers

    def run(logits, cache):
        for _ in range(GRAPH_STEPS):
            logits, cache = lm.decode_step(cfg, params,
                                           torch.argmax(logits, -1), cache,
                                           rc)
        return logits, cache

    trace.enable()
    try:
        la, a = lm.prefill(cfg, params, _prompt(cfg, 2), rc,
                           max_len=GRAPH_LEN)
        lb, b = lm.prefill(cfg, params, _prompt(cfg, 3), rc,
                           max_len=GRAPH_LEN)
        run(la, a)
        run(lb, {**b})
        a = None                               # finished: its entry frees
        _, warm = trace.drain()
        lc, c = lm.prefill(cfg, params, _prompt(cfg, 4), rc,
                           max_len=GRAPH_LEN)
        run(lc, c)
        saved = {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                 for k, v in b.items()}
        b = None                               # saved: its entry frees
        restored = {k: (v.cuda() if isinstance(v, torch.Tensor) else v)
                    for k, v in saved.items()}
        run(lb, restored)
        _, after = trace.drain()
    finally:
        trace.disable()
    assert warm["model.decode_graph_captures"] > 0
    assert after["model.decode_graph_captures"] == 0
    assert after["model.decode_eager"] == 0
    assert after["model.decode_graph_replays"] == 2 * GRAPH_STEPS
    assert after["model.decode_cache_adoptions"] == 1


# ----------------------------------------------------------------------
# the lockstep simulation engine in CUDA graphs (no kernel of its own:
# PyTorch operations on the card, captured)
# ----------------------------------------------------------------------

@pytest.fixture
def sim():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the engine's graphs run there)")
    import chip_smoke
    from repro_torch.core import simulator_jit
    lib = chip_smoke.sim_library()
    cases = {name: (ts, seeds, policy, kw)
             for name, ts, seeds, policy, kw in chip_smoke.sim_cases(lib)}
    return chip_smoke, simulator_jit, lib, cases


@pytest.mark.parametrize("name", ["smoke/sampled", "smoke/nominal",
                                  "mixed/lp", "smoke/faults@0.7"])
def test_lockstep_engine_on_the_card_equals_its_pin(sim, name):
    cs, sj, lib, cases = sim
    ts, seeds, policy, kw = cases[name]
    sj.reset_counts()
    got = sj.simulate_jbatch(ts, lib, policy, seeds=seeds,
                             duration=cs.SIM_DURATION, **kw)
    assert sj.metrics_digest(got) == cs.SIM_PINS[name]
    assert sj.COUNTS["replays"] * sj.GRAPH_STEPS >= sj.COUNTS["steps"] > 0
    # the same batch again replays the captured graph
    captures = sj.COUNTS["captures"]
    again = sj.simulate_jbatch(ts, lib, policy, seeds=seeds,
                               duration=cs.SIM_DURATION, **kw)
    assert sj.COUNTS["captures"] == captures
    assert sj.metrics_digest(again) == cs.SIM_PINS[name]


def test_lockstep_engine_on_the_card_equals_the_cpu(sim):
    cs, sj, lib, cases = sim
    ts, seeds, policy, kw = cases["mixed/mesc"]
    for scenario in ("heavy_tail", "burst", "thermal_throttle"):
        card = sj.simulate_jbatch(ts, lib, policy, seeds=seeds,
                                  duration=4e6, scenario=scenario)
        cpu = sj.simulate_jbatch(ts, lib, policy, seeds=seeds,
                                 duration=4e6, scenario=scenario,
                                 device="cpu")
        assert card == cpu, scenario


def test_lockstep_retry_ladder_and_one_step_graphs_on_the_card(sim,
                                                                monkeypatch):
    cs, sj, lib, cases = sim
    ts, seeds, policy, kw = cases["smoke/sampled"]
    want = sj.simulate_jbatch(ts, lib, policy, seeds=seeds, duration=4e6)
    monkeypatch.setenv("REPRO_JIT_TABLE_WIDTH", "2")
    sj.reset_counts()
    got = sj.simulate_jbatch(ts, lib, policy, seeds=seeds, duration=4e6)
    assert sj.COUNTS["retried_points"] > 0 and got == want
    monkeypatch.delenv("REPRO_JIT_TABLE_WIDTH")
    monkeypatch.setattr(sj, "GRAPH_STEPS", 1)
    got = sj.simulate_jbatch(ts, lib, policy, seeds=seeds, duration=4e6)
    assert got == want


def test_lockstep_spans_on_the_card_equal_the_cpu(sim):
    cs, sj, lib, cases = sim
    ts, seeds, policy, kw = cases["smoke/sampled"]
    cpu = sj.simulate_jbatch(ts, lib, policy, seeds=seeds, duration=4e6,
                             device="cpu")
    for batch_size in (5, 64):
        card = sj.simulate_jbatch(ts, lib, policy, seeds=seeds,
                                  duration=4e6, batch_size=batch_size)
        assert card == cpu, batch_size


def test_jit_campaign_on_the_card_equals_the_cpu_and_its_pin(sim, tmp_path):
    """A jit campaign runs its chunks in this process on the card (device
    None); its rows equal the CPU campaign's and fig8's pin."""
    cs, sj, lib, cases = sim
    from repro_torch.experiments import Campaign
    sweep = cs.fig8_sweep("jit")
    sj.reset_counts()
    card = Campaign(sweep, cache_dir=tmp_path / "card", workers=2)
    rows = card.collect()
    assert card.stats == {"hits": 0, "misses": 192}
    assert sj.COUNTS["replays"] > 0
    assert cs.rows_digest(rows) == cs.SIM_PINS["fig8/jit"]
    small = cs.fig8_sweep("jit", n_sets=1)
    cpu = Campaign(small, cache_dir=tmp_path / "cpu", workers=1,
                   device="cpu").collect()
    assert Campaign(small, cache_dir=tmp_path / "card2",
                    workers=1).collect() == cpu


# ---------------------------------------------------------------------------
# training: chip_smoke.py phase 10 (a), (b) and (d) at smoke size
# ---------------------------------------------------------------------------

# one smoke config of each family, at a length that exercises it (the
# hybrid's 32-token window inside 64 tokens, xLSTM's chunkwise mLSTM)
TRAIN_SMOKE = [("tinyllama-1.1b-smoke", 16), ("recurrentgemma-2b-smoke", 64),
               ("llama4-maverick-400b-a17b-smoke", 16),
               ("deepseek-v2-lite-16b-smoke", 16), ("xlstm-125m-smoke", 32),
               ("llava-next-34b-smoke", 16), ("musicgen-large-smoke", 16)]


def _loss_and_grads(cfg, params, batch, rc):
    from repro_torch.pytree import tree_items
    from repro_torch.runtime.trainer import loss_and_grads
    (loss, _), grads = loss_and_grads(cfg, params, batch, rc)
    return loss, dict(tree_items(grads))


@pytest.mark.parametrize("arch,S", TRAIN_SMOKE)
def test_loss_and_every_gradient_on_the_card_equal_the_cpu(gen, arch, S):
    """fp32, TF32 off: the loss within 1e-5 relative, each leaf's gradient
    within 1e-4 of that leaf's largest CPU gradient (the CPU tests' bound
    against the JAX package); no kernel launched."""
    from repro_torch.configs import get_config
    from repro_torch.data import batch_for_arch
    from repro_torch.models import lm
    from repro_torch.models.common import CPU_RC
    cfg = get_config(arch)
    p_cpu = lm.init_params(cfg, torch.Generator().manual_seed(0), CPU_RC,
                           "cpu", master=True)
    batch = {k: torch.from_numpy(v)
             for k, v in batch_for_arch(cfg, S, 2, 0).items()}
    lc, gc = _loss_and_grads(cfg, p_cpu, batch, CPU_RC)
    _build.reset_launches()
    ld, gd = _loss_and_grads(cfg, _to_device(p_cpu),
                             {k: v.cuda() for k, v in batch.items()}, CPU_RC)
    assert sum(_build.LAUNCHES.values()) == 0, _build.LAUNCHES
    assert abs(float(ld) - float(lc)) <= 1e-5 * abs(float(lc))
    for path, g in gc.items():
        assert _err(gd[path].cpu(), g) <= 1e-4 * float(g.abs().max()) + \
            1e-7, path


def _to_device(tree):
    if isinstance(tree, dict):
        return {k: _to_device(v) for k, v in tree.items()}
    return tree.cuda()


def test_log_sigmoid_gradient_on_the_card_equals_logsigmoids(gen):
    """On a CUDA tensor ATen keeps no forward buffer and its backward
    computes z = exp(-|x|) in the kernel; ``common.log_sigmoid``'s
    backward computes the same formula in elementwise operations (which
    DTensor shards): within one ulp of ``F.logsigmoid``'s gradient over
    |x| up to 60."""
    import torch.nn.functional as F

    from repro_torch.models.common import log_sigmoid
    x = torch.cat([torch.linspace(-60.0, 60.0, 24001, device="cuda"),
                   _randn(gen, 4000) * 4])
    g = _randn(gen, x.numel())
    a = x.clone().requires_grad_(True)
    b = x.clone().requires_grad_(True)
    ya, yb = log_sigmoid(a), F.logsigmoid(b)
    assert torch.equal(ya, yb)
    ya.backward(g)
    yb.backward(g)
    ulp = torch.nextafter(b.grad.abs(), torch.tensor(float("inf"),
                                                     device="cuda")) \
        - b.grad.abs()
    assert bool(((a.grad - b.grad).abs() <= ulp).all())


def test_kernel_wrappers_refuse_inputs_that_require_grad(gen):
    def r(*shape):
        return _randn(gen, *shape).requires_grad_(True)
    calls = [lambda: flash_attention_tpu(r(1, 2, 64, 64), r(1, 2, 64, 64),
                                         r(1, 2, 64, 64)),
             lambda: decode_attention_tpu(r(1, 2, 64), r(1, 2, 64, 64),
                                          r(1, 2, 64, 64), 3),
             lambda: rglru_scan_tpu(r(1, 8, 64), r(1, 8, 64), r(1, 64)),
             lambda: systolic_gemm(r(128, 128), r(128, 128)),
             lambda: gemm_partial(r(128, 128), r(128, 128),
                                  torch.zeros(128, 128, device="cuda"), 0, 1,
                                  bk=128)]
    _build.reset_launches()
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward"):
            call()
    assert sum(_build.LAUNCHES.values()) == 0
    with torch.no_grad():
        for call in calls:
            call()
    assert sum(_build.LAUNCHES.values()) == 5


@pytest.mark.parametrize("arch", ["tinyllama-1.1b-smoke",
                                  "recurrentgemma-2b-smoke",
                                  "deepseek-v2-lite-16b-smoke"])
def test_trained_weights_through_the_kernels_match_forward(gen, arch):
    """Two bf16 train steps on fp32 master weights (no kernel launched),
    then the weights in their serving placement: a 16-token prefill and
    4 teacher-forced decode steps through the kernels against forward's
    logits at the same positions, within 5e-2 x the position's largest
    logit (bf16 activations rounded in other places on each side); one
    flash launch a prefill and one decode launch a step per attention
    layer, one scan launch per RG-LRU layer."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import _pattern_for
    from repro_torch.data import batch_for_arch
    from repro_torch.models import lm
    from repro_torch.models.common import RuntimeConfig
    from repro_torch.optim import OptConfig
    from repro_torch.runtime import trainer
    cfg, rc = get_config(arch), RuntimeConfig()
    opt_cfg = OptConfig(lr=3e-3, warmup_steps=1)
    params, opt = trainer.init_train_state(
        cfg, torch.Generator(device="cuda").manual_seed(0), rc, opt_cfg)
    step = trainer.make_train_step(cfg, rc, opt_cfg)
    _build.reset_launches()
    for s in range(2):
        params, opt, m = step(params, opt, batch_for_arch(cfg, 32, 2, s))
        assert bool(torch.isfinite(m["loss"]))
    assert sum(_build.LAUNCHES.values()) == 0
    serve = lm.place_params(params, rc)
    toks = torch.from_numpy(batch_for_arch(cfg, 32, 1, 9)["tokens"]).cuda()
    pattern = _pattern_for(cfg)
    n_attn = 0 if cfg.family == "xlstm" else pattern.count("attn")
    logits, cache = trainer.make_prefill_step(cfg, rc, max_len=32)(
        serve, {"tokens": toks[:, :16]})
    assert _build.LAUNCHES["flash_attention"] == n_attn
    assert _build.LAUNCHES["rglru_scan"] == pattern.count("rglru")
    outs = [logits]
    decode = trainer.make_decode_step(cfg, rc)
    for t in range(4):
        logits, cache = decode(serve, toks[:, 16 + t], cache)
        outs.append(logits)
    assert _build.LAUNCHES["decode_attention"] == 4 * (
        0 if cfg.family == "mla_moe" else n_attn)
    with torch.no_grad():
        full, _ = lm.forward(cfg, serve, {"tokens": toks}, rc)
    for i, got in enumerate(outs):
        want = full[:, 15 + i].float()
        assert _err(got, want) <= 5e-2 * float(want.abs().max()), i
