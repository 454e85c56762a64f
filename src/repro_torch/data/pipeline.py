"""Deterministic, resumable, shardable synthetic token pipeline (a copy
of the reference's ``data/pipeline.py``: NumPy only, so its batches are
byte-equal to the reference's).

Batches are a pure function of (seed, step, shard) — there is no iterator
state, so checkpoint/restart and elastic re-sharding are trivial: restore
``step`` and the pipeline continues bit-identically on any mesh layout.

The token distribution is a learnable mixture (so training-loss curves are
meaningful, not flat):
  * a dataset-global affine map  t_{i+1} = (a * t_i + c) mod V  (the model
    can memorize it as a next-token lookup -> loss drops toward the noise
    floor)
  * copy spans (induction heads)
  * uniform noise tokens
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise_frac: float = 0.1

    def _rng(self, step: int, shard: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))

    def batch(self, step: int, *, shard: int = 0, n_shards: int = 1
              ) -> Dict[str, np.ndarray]:
        """Tokens+labels for this step; ``shard`` of ``n_shards`` slices the
        global batch (data parallelism)."""
        assert self.global_batch % n_shards == 0
        b = self.global_batch // n_shards
        rng = self._rng(step, shard)
        V, S = self.vocab, self.seq_len
        g = np.random.default_rng(self.seed)          # dataset-global map
        a = np.full((b, 1), int(g.integers(2, min(V - 1, 97))))
        c = np.full((b, 1), int(g.integers(0, V)))
        t0 = rng.integers(0, V, size=(b, 1))
        toks = np.empty((b, S + 1), np.int64)
        toks[:, :1] = t0
        for i in range(S):
            toks[:, i + 1] = (a[:, 0] * toks[:, i] + c[:, 0]) % V
        # splice copy spans
        span = max(4, S // 8)
        starts = rng.integers(0, max(S - 2 * span, 1), size=b)
        for j in range(b):
            s0 = starts[j]
            toks[j, s0 + span: s0 + 2 * span] = toks[j, s0: s0 + span]
        noise = rng.random((b, S + 1)) < self.noise_frac
        toks = np.where(noise, rng.integers(0, V, size=(b, S + 1)), toks)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


def batch_for_arch(cfg: ArchConfig, seq_len: int, global_batch: int,
                   step: int, *, seed: int = 0, shard: int = 0,
                   n_shards: int = 1) -> Dict[str, Any]:
    """Family-aware batch (audio codebooks / VLM patch-embedding stubs)."""
    if cfg.family == "audio":
        ds = SyntheticLM(cfg.vocab, seq_len * cfg.n_codebooks, global_batch,
                         seed=seed)
        b = ds.batch(step, shard=shard, n_shards=n_shards)
        K = cfg.n_codebooks
        return {k: v.reshape(v.shape[0], seq_len, K) for k, v in b.items()}
    ds = SyntheticLM(cfg.vocab, seq_len, global_batch, seed=seed)
    b = ds.batch(step, shard=shard, n_shards=n_shards)
    if cfg.family == "vlm" and cfg.n_frontend_tokens > 0:
        nf = min(cfg.n_frontend_tokens, seq_len // 2)
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, step, shard, 7]))
        bsz = b["tokens"].shape[0]
        b = {k: v[:, :seq_len - nf] for k, v in b.items()}
        b["vis_embeds"] = rng.standard_normal(
            (bsz, nf, cfg.d_model)).astype(np.float32) * 0.02
    return b
