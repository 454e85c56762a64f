"""Tiny configurations and mixes of the two families, for the
benchmark's CPU tests: the same keys as the cells' files at a size a
test run holds, with the parameter layout read off the program's own
tree (``lm.init_params`` on the meta device)."""
from __future__ import annotations

import copy
import json

from bench.spec import BENCH_DIR, Cell

_DIMS = {
    "llava34b": {"hidden_size": 64, "intermediate_size": 96,
                 "num_attention_heads": 4, "num_key_value_heads": 2,
                 "num_hidden_layers": 2, "vocab_size": 256},
    "dsv2lite": {"hidden_size": 64, "num_attention_heads": 4,
                 "num_key_value_heads": 4, "num_hidden_layers": 2,
                 "vocab_size": 256, "kv_lora_rank": 32,
                 "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
                 "v_head_dim": 16, "n_routed_experts": 8,
                 "num_experts_per_tok": 2, "n_shared_experts": 1,
                 "moe_intermediate_size": 32},
}


def _program(c: dict) -> dict:
    prog = dict(c["program"], name=c["program"]["name"] + "-tiny",
                n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
                n_heads=c["num_attention_heads"],
                n_kv_heads=c["num_key_value_heads"], vocab=c["vocab_size"])
    if c["reference"] == "dense":
        prog["d_ff"] = c["intermediate_size"]
    else:
        prog["head_dim"] = c["v_head_dim"]
        prog["d_ff"] = c["moe_intermediate_size"]
        prog["mla"] = {"kv_lora_rank": c["kv_lora_rank"],
                       "qk_nope_dim": c["qk_nope_head_dim"],
                       "qk_rope_dim": c["qk_rope_head_dim"],
                       "v_head_dim": c["v_head_dim"]}
        prog["moe"] = dict(prog["moe"], num_experts=c["n_routed_experts"],
                           top_k=c["num_experts_per_tok"],
                           num_shared=c["n_shared_experts"],
                           d_expert=c["moe_intermediate_size"])
    return prog


def program_layout(prog: dict, std: float = 0.02) -> list:
    """The parameter layout of the program's serving tree for ``prog``."""
    import torch

    from bench.harness import arch_config, runtime_config
    from repro_torch.models import lm
    cfg = arch_config(prog)
    rc = runtime_config({"compute_dtype": "bfloat16",
                         "dus_cache_update": True})
    tree = lm.init_params(cfg, torch.Generator(), rc, device="meta")
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [k])
            return
        dtype = str(node.dtype).replace("torch.", "")
        entry = {"path": ".".join(path), "shape": list(node.shape),
                 "dtype": dtype}
        entry.update({"init": "zeros"} if dtype == "float32"
                     else {"init": "normal", "std": std})
        out.append(entry)
    walk(tree, [])
    return out


def tiny_config(name: str, compute_dtype: str = "float32") -> dict:
    with open(BENCH_DIR / "configs" / f"{name}.json") as f:
        c = json.load(f)
    c.update(_DIMS[name])
    c["program"] = _program(c)
    c["serve"] = dict(c["serve"], compute_dtype=compute_dtype)
    c["params"] = program_layout(c["program"], std=0.2)
    c["check"] = dict(c["check"], lo_docs=2, hi_requests=4,
                      max_logit_gap=1e-3)
    return c


def tiny_traffic(evict: bool = False) -> dict:
    with open(BENCH_DIR / "traffic" / "longdoc4k.json") as f:
        t = json.load(f)
    t = copy.deepcopy(t)
    t["hi"].update(period_s=0.2, jitter_s=0.05, prompt_tokens=16)
    t["lo"].update(prompt_tokens=48, max_new_tokens=3)
    t["max_len"] = 64
    t["resident_slots"] = 1 if evict else 2
    return t


def tiny_cell(name: str, evict: bool = False, **kw) -> Cell:
    return Cell(name=f"{name}.tiny", config=tiny_config(name, **kw),
                traffic=tiny_traffic(evict), chips=1, end_to_end=[],
                per_layer=[])
