"""The decode step's body at a device position, and the cache pool that
CUDA graphs of it run on (``models/decode_graph.py``), on the CPU.

The body takes the position as a 0-d int64 tensor so that a graph of it
replays at any position; on the CPU it runs eagerly, and it must give the
bits that the host-int position gives.  The pool's bookkeeping is device
agnostic, so it is checked here on CPU tensors; the graphs themselves
are checked on the card (``tests/test_torch_cuda.py``).
"""
import dataclasses
import weakref

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import decode_graph, lm
from repro_torch.models.common import CPU_RC
from repro_torch.runtime import trace

# one smoke config a family with its own decode body; the hybrid's ring
# has 32 slots, so the steps below wrap it
ARCHS = ["tinyllama-1.1b-smoke", "llama4-maverick-400b-a17b-smoke",
         "deepseek-v2-lite-16b-smoke", "recurrentgemma-2b-smoke",
         "xlstm-125m-smoke"]
PROMPT, STEPS = 24, 12


def _params(cfg):
    return lm.init_params(cfg, torch.Generator().manual_seed(0), CPU_RC,
                          device="cpu")


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _leaves(cache):
    return [(p, t) for p, t in decode_graph._flat(cache)]


@pytest.mark.parametrize("dus", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_the_body_at_a_device_position_gives_the_host_int_bits(arch, dus):
    """Steps of the body with the position a host int (the body as it was)
    and a 0-d int64 tensor, each on its own copy of the prefill's cache:
    equal logits and caches at every step, across the hybrid ring's wrap
    (position 32), and ``decode_step`` gives the same."""
    cfg = get_config(arch)
    rc = dataclasses.replace(CPU_RC, dus_cache_update=dus)
    params = _params(cfg)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, PROMPT)))
    logits, cache = lm.prefill(cfg, params, {"tokens": toks}, rc,
                               max_len=64)
    by_int, by_dev, public = cache, _clone(cache), _clone(cache)
    for _ in range(STEPS):
        pos = by_int["pos"]
        tok = torch.argmax(logits, dim=-1)
        li = lm._decode_step(cfg, params, tok, by_int, rc, pos, pos)
        ld = lm._decode_step(cfg, params, tok, by_dev, rc,
                             torch.tensor(pos), pos)
        lp, public = lm.decode_step(cfg, params, tok, public, rc)
        assert torch.equal(li, ld) and torch.equal(li, lp), pos
        for (path, a), (_, b), (_, c) in zip(_leaves(by_int),
                                             _leaves(by_dev),
                                             _leaves(public)):
            assert torch.equal(a, b) and torch.equal(a, c), (pos, path)
        by_int["pos"] = by_dev["pos"] = pos + 1
        assert public["pos"] == pos + 1
        logits = li
    if cfg.family == "hybrid":
        assert PROMPT + STEPS > cfg.rglru.window > PROMPT


def test_bucket_edges():
    top = decode_graph.bucket_top
    assert [top(p, 4096) for p in (0, 128, 511, 512, 1023, 1024, 3584,
                                    4095)] \
        == [511, 511, 511, 1023, 1023, 2047, 4095, 4095]
    assert top(7680, 8192) == 8191 and top(5, 64) == 63
    assert top(5000, 2048) == 2047          # a ring past its window
    assert top(100, None) is None           # no decode kernel: one bucket


def _layout(cfg, max_len=64):
    spec = []
    lm.init_cache(cfg, 1, max_len, CPU_RC, "meta",
                  make=lambda path, shape, dtype, fill: spec.append(
                      (tuple(path), tuple(shape), dtype)))
    return tuple(spec)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b-smoke",
                                  "recurrentgemma-2b-smoke"])
def test_live_caches_never_share_an_entry(arch):
    """Two live caches take two entries; finishing one (its dict dropped)
    or saving one (its dict replaced by host copies) frees its entry for
    the next cache; a nested cache (the hybrid's tail) is held the same
    way."""
    cfg = get_config(arch)
    params = _params(cfg)
    model = decode_graph.model_of(params, "cpu")
    layout = _layout(cfg)

    def new_cache():
        e = decode_graph.take(model, layout, "cpu")
        return e, lm.init_cache(cfg, 1, 64, CPU_RC, "cpu", make=e.make)

    e1, c1 = new_cache()
    e2, c2 = new_cache()
    assert e1 is not e2 and e1.busy() and e2.busy()
    assert decode_graph.adopt(model, c1) == (e1, False)
    c1 = None                                   # finished
    assert not e1.busy()
    e3, c3 = new_cache()
    assert e3 is e1 and e3.busy()
    c2 = {k: _clone(v) for k, v in c2.items()}  # saved: host copies
    assert not e2.busy()
    e4, c4 = new_cache()
    assert e4 is e2
    assert len(model.pools[layout]) == 2
    assert c2 is not None and c3 is not None and c4 is not None


@pytest.mark.parametrize("view", ["index", "narrow", "split", "detach"])
def test_a_view_alone_keeps_an_entry_busy(view):
    """A tensor on a leaf's memory (no cache dict holds the leaf itself)
    keeps its entry from the next cache until it dies."""
    cfg = get_config("tinyllama-1.1b-smoke")
    params = _params(cfg)
    model = decode_graph.model_of(params, "cpu")
    layout = _layout(cfg)
    e = decode_graph.take(model, layout, "cpu")
    cache = lm.init_cache(cfg, 1, 64, CPU_RC, "cpu", make=e.make)
    ck = cache["ck"]
    kept = {"index": lambda: ck[0], "narrow": lambda: ck.narrow(0, 0, 1),
            "split": lambda: ck.split(1)[0],
            "detach": lambda: ck.detach()}[view]()
    cache = ck = None
    assert e.busy()
    other = decode_graph.take(model, layout, "cpu")
    assert other is not e
    kept = None
    assert not e.busy()
    assert decode_graph.take(model, layout, "cpu") is e


def test_a_growing_pool_gives_back_other_layouts_free_entries():
    """A new entry of one cache length first gives back the free entries
    of the model's other lengths, with their graphs; the held ones stay,
    and so do the free ones of its own length."""
    cfg = get_config("tinyllama-1.1b-smoke")
    params = _params(cfg)
    model = decode_graph.model_of(params, "cpu")
    long, short = _layout(cfg, 64), _layout(cfg, 32)
    held = decode_graph.take(model, long, "cpu")
    c_held = held.cache(0)
    free = decode_graph.take(model, long, "cpu")
    free.graphs["g"] = torch.zeros(1)
    gone = [weakref.ref(free.leaves[0]), weakref.ref(free.graphs["g"])]
    leaf_ids = [id(t) for t in free.leaves]
    free = None
    s1 = decode_graph.take(model, short, "cpu")
    assert model.pools[long] == [held] and model.pools[short] == [s1]
    assert all(r() is None for r in gone)
    assert not any(i in decode_graph._OWNER for i in leaf_ids)
    s2 = decode_graph.take(model, short, "cpu")   # s1 is free: reused
    assert s2 is s1 and len(model.pools[short]) == 1
    assert c_held is not None


def test_a_cache_of_views_is_copied_into_an_entry():
    """A cache whose leaves share memory (views of one buffer) is not
    made an entry as it is, since its views would hold it busy for
    good: it is copied into a new entry, which frees once the step's
    dict is dropped."""
    cfg = get_config("tinyllama-1.1b-smoke")
    params = _params(cfg)
    model = decode_graph.model_of(params, "cpu")
    own = lm.init_cache(cfg, 1, 64, CPU_RC, "cpu")
    flat = torch.cat([own["ck"].reshape(-1), own["cv"].reshape(-1)])
    flat.normal_(generator=torch.Generator().manual_seed(5))
    ck, cv = flat.split(own["ck"].numel())
    views = {"ck": ck.view(own["ck"].shape), "cv": cv.view(own["cv"].shape),
             "pos": 9}
    entry, copied = decode_graph.adopt(model, views)
    assert copied and not entry.busy()
    assert torch.equal(entry.leaves[0], views["ck"])
    assert entry.leaves[0].data_ptr() != views["ck"].data_ptr()


def test_a_restored_cache_is_adopted_with_its_bytes():
    """A cache that is no entry (a restored copy) is copied into a free
    entry once: the entry holds its bytes, and a cache of the entry's
    leaves is adopted as it is; where no entry is free, the cache's own
    tensors become an entry, with no copy."""
    cfg = get_config("recurrentgemma-2b-smoke")
    params = _params(cfg)
    model = decode_graph.model_of(params, "cpu")
    gen = torch.Generator().manual_seed(3)
    restored = lm.init_cache(cfg, 1, 64, CPU_RC, "cpu")
    for _, t in _leaves(restored):
        t.copy_(torch.randn(t.shape, generator=gen).to(t.dtype))
    restored["pos"] = 40
    free = decode_graph.take(model, decode_graph._layout(restored), "cpu")
    entry, copied = decode_graph.adopt(model, restored)
    assert copied and entry is free and not entry.busy()
    held = entry.cache(41)
    assert entry.busy() and held["pos"] == 41
    for (path, a), (_, b) in zip(_leaves(restored), _leaves(held)):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr(), path
    assert decode_graph.adopt(model, held) == (entry, False)
    again = _clone(restored)
    other, copied = decode_graph.adopt(model, again)
    assert other is not entry and not copied     # `entry` is held
    for (_, a), (_, b) in zip(_leaves(again), _leaves(other.cache(0))):
        assert a is b
    assert len(model.pools[entry.layout]) == 2


def test_a_pool_dies_with_its_parameters():
    cfg = get_config("tinyllama-1.1b-smoke")
    params = _params(cfg)
    model = decode_graph.model_of(params, "cpu")
    decode_graph.take(model, _layout(cfg), "cpu")
    assert decode_graph.model_of(params, "cpu") is model
    key = model.key
    del params
    assert key not in decode_graph._MODELS and not model.pools


def test_steps_off_the_card_are_eager_and_counted():
    cfg = get_config("tinyllama-1.1b-smoke")
    params = _params(cfg)
    toks = torch.zeros((1, 8), dtype=torch.long)
    logits, cache = lm.prefill(cfg, params, {"tokens": toks}, CPU_RC,
                               max_len=32)
    assert not decode_graph.graphable(params, cache)
    trace.enable(device_events=False)
    try:
        for _ in range(3):
            logits, cache = lm.decode_step(cfg, params,
                                           torch.argmax(logits, -1), cache,
                                           CPU_RC)
        _, counters = trace.drain()
    finally:
        trace.disable()
    assert counters["model.decode_eager"] == 3
    assert counters["model.decode_graph_replays"] == 0
    assert counters["model.decode_graph_captures"] == 0
    assert counters["model.decode_cache_adoptions"] == 0
