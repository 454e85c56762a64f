"""Whether what the timed path served is correct: a sample of the
finished requests, drawn from the seed, run through the plain reference
after the window, and the widest gap by which a served token's logit
lies below the reference's best (greedy serving).

The sample takes the configuration's ``check.lo_docs`` LO documents (the
longest requests; those whose context was saved and restored first) and
``check.hi_requests`` HI requests; the reference runs rows of one shape
together, up to ``check.batch_tokens`` tokens a batch.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np
import torch

from bench import reference

def sample(finished: List[dict], conf: dict, seed: int) -> List[dict]:
    """finished: {"crit", "prompt", "generated", "saves"} of every request
    finished; the ones to compare."""
    rng = np.random.default_rng([seed % (1 << 63), 99])
    lo = [r for r in finished if r["crit"] == "LO"]
    hi = [r for r in finished if r["crit"] == "HI"]
    saved = [r for r in lo if r["saves"] > 0]
    unsaved = [r for r in lo if r["saves"] == 0]
    lo_pick: List[dict] = []
    for group in (saved, unsaved):
        need = conf["lo_docs"] - len(lo_pick)
        if need > 0 and group:
            idx = rng.permutation(len(group))[:need]
            lo_pick += [group[i] for i in sorted(idx)]
    idx = rng.permutation(len(hi))[:conf["hi_requests"]]
    return lo_pick + [hi[i] for i in sorted(idx)]


def _batches(reqs: List[dict], batch_tokens: int):
    """Rows of one (prompt length, served length), at most
    ``batch_tokens`` tokens a batch."""
    groups: Dict[Tuple[int, int], List[dict]] = defaultdict(list)
    for r in reqs:
        groups[(len(r["prompt"]), len(r["generated"]))].append(r)
    for (s, n), rows in sorted(groups.items()):
        per = max(1, batch_tokens // (s + n))
        for i in range(0, len(rows), per):
            yield s, rows[i:i + per]


def compare(conf: dict, params: dict, reqs: List[dict],
            control: bool = False) -> dict:
    """{"gap": widest served-token gap, "tokens": tokens compared}, and
    with ``control`` also "control_gap": the widest gap of the token the
    fp8 control puts first at each of the same positions."""
    dev = params["embed"].device
    gap = cgap = 0.0
    n_tok = 0
    by_crit = {}
    for s, rows in _batches(reqs, conf["check"]["batch_tokens"]):
        toks = torch.tensor([reference.fed_tokens(r["prompt"], r["generated"])
                             for r in rows], device=dev)
        served = torch.tensor([r["generated"] for r in rows], device=dev)
        logits = reference.logits_at(conf, params, toks, s)
        flat = logits.reshape(-1, logits.shape[-1])
        g = reference.widest_gap(flat, served.reshape(-1))
        gap = max(gap, g)
        crit = rows[0]["crit"]
        by_crit[crit] = max(by_crit.get(crit, 0.0), g)
        n_tok += served.numel()
        if control:
            low = reference.logits_at(conf, params, toks, s, quant=True)
            pick = low.reshape(-1, low.shape[-1]).argmax(-1)
            cgap = max(cgap, reference.widest_gap(flat, served.reshape(-1),
                                                  picked=pick))
            del low
        del logits, flat
    out = {"gap": gap, "tokens": n_tok,
           **{f"gap_{k}": v for k, v in sorted(by_crit.items())}}
    if control:
        out["control_gap"] = cgap
    return out


def judge(conf: dict, numbers: dict, failed: int):
    """(correct, the numbers compared, each beside its limit)."""
    limit = conf["check"]["max_logit_gap"]
    checks = {"logit_gap": {"value": numbers["gap"], "limit": limit},
              "hi_unfinished": {"value": failed, "limit": 0}}
    correct = (limit is not None and numbers["gap"] <= limit
               and failed == 0 and numbers["lo_docs"] > 0
               and numbers["hi_requests"] > 0)
    return correct, checks


def judge_control(conf: dict, numbers: dict) -> bool:
    """Whether the fp8 control, put in the program's place on the same
    sample, comes out correct: it has to come out not correct."""
    return judge(conf, dict(numbers, gap=numbers["control_gap"]), 0)[0]
