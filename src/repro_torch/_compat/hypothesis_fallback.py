"""Minimal stand-in for `hypothesis` when the real package is absent.

The test suite uses a small slice of the hypothesis API:

    from hypothesis import given, settings, strategies as st
    @settings(max_examples=N, deadline=None)
    @given(seed=st.integers(a, b), u=st.floats(a, b))
    def test_...(...)

This module reimplements exactly that slice as a deterministic
pseudo-random sampler (seeded per test from the test's qualified name),
so property tests still exercise a spread of inputs on images where
hypothesis cannot be installed.  It is NOT a shrinker and finds no
minimal counterexamples — install the real `hypothesis` (declared in
pyproject.toml's dev extra) for full power.  `install()` registers the
shim under ``sys.modules["hypothesis"]`` only when the real package is
missing; see tests/conftest.py.
"""
from __future__ import annotations

import functools
import hashlib
import inspect
import sys
import types

import numpy as np

FALLBACK = True
_DEFAULT_MAX_EXAMPLES = 20


class Strategy:
    def __init__(self, draw):
        self._draw = draw

    def example(self, rng: np.random.Generator):
        return self._draw(rng)

    def map(self, f) -> "Strategy":
        return Strategy(lambda rng: f(self._draw(rng)))

    def filter(self, pred, _tries: int = 1000) -> "Strategy":
        def draw(rng):
            for _ in range(_tries):
                x = self._draw(rng)
                if pred(x):
                    return x
            raise ValueError("filter predicate never satisfied")
        return Strategy(draw)


def integers(min_value: int, max_value: int) -> Strategy:
    return Strategy(
        lambda rng: int(rng.integers(min_value, max_value + 1)))


def floats(min_value: float, max_value: float, **_kw) -> Strategy:
    return Strategy(lambda rng: float(rng.uniform(min_value, max_value)))


def booleans() -> Strategy:
    return Strategy(lambda rng: bool(rng.integers(0, 2)))


def sampled_from(seq) -> Strategy:
    seq = list(seq)
    return Strategy(lambda rng: seq[int(rng.integers(0, len(seq)))])


def lists(elements: Strategy, min_size: int = 0,
          max_size: int = 10, **_kw) -> Strategy:
    return Strategy(
        lambda rng: [elements.example(rng)
                     for _ in range(int(rng.integers(min_size,
                                                     max_size + 1)))])


def just(value) -> Strategy:
    return Strategy(lambda rng: value)


def tuples(*strategies: Strategy) -> Strategy:
    return Strategy(lambda rng: tuple(s.example(rng) for s in strategies))


def settings(max_examples: int = _DEFAULT_MAX_EXAMPLES, **_kw):
    def deco(fn):
        fn._fallback_max_examples = max_examples
        return fn
    return deco


def given(*arg_strategies: Strategy, **kw_strategies: Strategy):
    def deco(fn):
        # like real hypothesis: positional strategies bind to the
        # RIGHTMOST parameters (by keyword), so preceding pytest
        # fixture params keep working
        sig = inspect.signature(fn)
        free = [n for n in sig.parameters if n not in kw_strategies]
        pos_names = free[len(free) - len(arg_strategies):] \
            if arg_strategies else []
        strategies = {**dict(zip(pos_names, arg_strategies)),
                      **kw_strategies}

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            n = getattr(wrapper, "_fallback_max_examples",
                        _DEFAULT_MAX_EXAMPLES)
            # stable per-test stream, independent of run order
            h = hashlib.sha256(fn.__qualname__.encode()).digest()
            rng = np.random.default_rng(int.from_bytes(h[:8], "little"))
            done = 0
            attempts = 0
            while done < n and attempts < n * 50:
                attempts += 1
                drawn = {k: s.example(rng) for k, s in strategies.items()}
                try:
                    fn(*args, **kwargs, **drawn)
                except _Unsatisfied:
                    continue             # assume() discarded the example
                done += 1
            if n > 0 and done == 0:
                raise RuntimeError(
                    f"{fn.__qualname__}: assume() discarded all "
                    f"{attempts} drawn examples — unsatisfiable predicate?")
        # hide strategy-filled parameters from pytest's fixture resolution
        wrapper.__signature__ = sig.replace(
            parameters=[sig.parameters[n] for n in sig.parameters
                        if n not in strategies])
        wrapper.hypothesis_fallback = True
        return wrapper
    return deco


def assume(condition: bool) -> bool:
    if not condition:
        raise _Unsatisfied()
    return True


class _Unsatisfied(Exception):
    pass


def install() -> types.ModuleType:
    """Register this shim as ``hypothesis`` if the real one is missing."""
    if "hypothesis" in sys.modules:
        return sys.modules["hypothesis"]
    mod = types.ModuleType("hypothesis")
    mod.given = given
    mod.settings = settings
    mod.assume = assume
    mod.FALLBACK = True
    st = types.ModuleType("hypothesis.strategies")
    for name in ("integers", "floats", "booleans", "sampled_from",
                 "lists", "just", "tuples"):
        setattr(st, name, globals()[name])
    mod.strategies = st
    sys.modules["hypothesis"] = mod
    sys.modules["hypothesis.strategies"] = st
    return mod
