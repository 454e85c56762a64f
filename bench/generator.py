"""The one traffic generator: a mix file of parameters and a seed give the
requests of a run.

Every mix has one HI stream and one closed-loop LO stream.

* HI: a sporadic task.  Release k falls at phi + k * period + J_k, with
  phi ~ U[0, period - jitter) and J_k ~ U[0, jitter), so release k lies in
  [k * period, (k + 1) * period) and a window of ``seconds`` holds exactly
  floor(seconds / period) releases whatever the seed.  Each has a fixed
  prompt length and output length.
* LO: ``clients`` closed-loop clients, each sending its next document
  when its last one finishes; every document has the same prompt and
  output length.

The seed chooses only the phase, the jitter and the token ids: the work
offered in a window is the same for every seed.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np

# stream ids of the counter-based draws
_PHASE, _HI_IDS, _LO_IDS, _WARM_IDS, _JITTER = 0, 1, 2, 3, 4


def _rng(seed: int, *key: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 63), *key])


@dataclass(frozen=True)
class Release:
    k: int                 # release index
    t: float               # due time, seconds after the window opens
    prompt: np.ndarray     # (hi prompt_tokens,) int32


class Workload:
    """The requests of one run of a mix."""

    def __init__(self, traffic: dict, seed: int, seconds: float, vocab: int):
        self.seed, self.seconds, self.vocab = seed, float(seconds), vocab
        hi, lo = traffic["hi"], traffic["lo"]
        self.hi_spec, self.lo_spec = hi, lo
        period, jitter = float(hi["period_s"]), float(hi["jitter_s"])
        if not 0.0 <= jitter < period:
            raise ValueError(f"HI jitter {jitter} must lie in [0, period "
                             f"{period})")
        self.period, self.jitter = period, jitter
        self.phase = _rng(seed, _PHASE).random() * (period - jitter)
        n = int(math.floor(self.seconds / period + 1e-9))
        self.hi: List[Release] = [self.release(k) for k in range(n)]

    def release(self, k: int) -> Release:
        """HI release k; those from floor(seconds / period) on fall after
        the close, where the window's last LO documents finish under the
        same HI stream."""
        jit = _rng(self.seed, _JITTER, k).random() * self.jitter
        return Release(k, self.phase + k * self.period + jit,
                       self._ids(_HI_IDS, k, self.hi_spec["prompt_tokens"]))

    def _ids(self, stream: int, idx: int, length: int) -> np.ndarray:
        return _rng(self.seed, stream, idx).integers(
            0, self.vocab, length, dtype=np.int32)

    def lo_prompt(self, j: int) -> np.ndarray:
        """The j-th LO document sent in the run (over all clients)."""
        return self._ids(_LO_IDS, j, self.lo_spec["prompt_tokens"])

    def warm_prompts(self):
        """(LO, HI) prompts of the warm-up requests, drawn apart from the
        window's."""
        return (self._ids(_WARM_IDS, 0, self.lo_spec["prompt_tokens"]),
                self._ids(_WARM_IDS, 1, self.hi_spec["prompt_tokens"]))
