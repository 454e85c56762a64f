"""Operations and bytes of a served model's calls, from shapes alone (the
yardstick of the roofline and MFU metrics), and the device's peaks.

Operations count multiply-adds as two and only what the model needs:
each token's projections, its routed top-k experts and shared experts
(not the empty capacity slots the program also multiplies), attention
over the live positions, and the output head on the rows whose logits
are computed (one a prefill, one a decode step).
"""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json")
                   .read_text())


def peak(kind: str, what: str) -> float:
    """``what`` ("bf16_flops" or "hbm_bytes_per_s") of the card named
    ``kind``: the table's entry whose key the name contains."""
    for key, row in PEAKS["devices"].items():
        if key in kind:
            return float(row[what])
    raise KeyError(f"no peak for device {kind!r}")


def _token_matmul_flops(c: dict) -> float:
    """Projection and FFN operations of one token through every layer."""
    d, L = c["hidden_size"], c["num_hidden_layers"]
    if c["reference"] == "dense":
        hq, hkv = c["num_attention_heads"], c["num_key_value_heads"]
        dh = d // hq
        f = c["intermediate_size"]
        per = d * hq * dh + 2 * d * hkv * dh + hq * dh * d + 3 * d * f
        return 2.0 * L * per
    H, lora = c["num_attention_heads"], c["kv_lora_rank"]
    dn, dr, dv = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                  c["v_head_dim"])
    E, K, f = (c["n_routed_experts"], c["num_experts_per_tok"],
               c["moe_intermediate_size"])
    attn = d * (lora + dr) + d * H * (dn + dr) + H * dv * d
    moe = d * E + (K + c["n_shared_experts"]) * 3 * d * f
    return 2.0 * L * (attn + moe)


def _head_flops(c: dict) -> float:
    return 2.0 * c["hidden_size"] * c["vocab_size"]


def attention_flops(c: dict, q_len: int, kv_end: int) -> float:
    """Score and value operations of ``q_len`` queries at positions
    kv_end - q_len .. kv_end - 1, each over the keys at or before it,
    in every layer (MLA: the prefill's decompressed heads)."""
    H, L = c["num_attention_heads"], c["num_hidden_layers"]
    if c["reference"] == "dense":
        dqk = dv = c["hidden_size"] // H
    else:
        dqk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
        dv = c["v_head_dim"]
    first = kv_end - q_len + 1
    pairs = q_len * (first + kv_end) / 2.0
    return 2.0 * L * H * pairs * (dqk + dv)


def attention_bytes(c: dict, q_len: int, itemsize: int = 2) -> float:
    """Bytes a causal prefill's attention needs to read and write at
    least, in every layer: q, k and v read once, the output written once
    (GQA's shared keys and values counted once a KV head)."""
    H, L = c["num_attention_heads"], c["num_hidden_layers"]
    if c["reference"] == "dense":
        dh = c["hidden_size"] // H
        hkv = c["num_key_value_heads"]
        per = q_len * (H * dh * 2 + hkv * dh * 2)
    else:
        dqk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
        dv = c["v_head_dim"]
        per = q_len * H * (2 * dqk + 2 * dv)
    return float(L * per * itemsize)


def _decode_attention_flops(c: dict, pos: int) -> float:
    """One decode step at ``pos`` over pos + 1 live positions (MLA: the
    weight-absorbed form over the compressed cache, and its two
    absorption products)."""
    H, L = c["num_attention_heads"], c["num_hidden_layers"]
    live = pos + 1
    if c["reference"] == "dense":
        dh = c["hidden_size"] // H
        return 2.0 * L * H * live * 2 * dh
    lora, dn, dr, dv = (c["kv_lora_rank"], c["qk_nope_head_dim"],
                        c["qk_rope_head_dim"], c["v_head_dim"])
    absorb = H * dn * lora + H * lora * dv
    return 2.0 * L * (absorb + H * live * (lora + dr + lora))


def prefill_flops(c: dict, prompt_len: int) -> float:
    if c["reference"] == "dense":
        attn = attention_flops(c, prompt_len, prompt_len)
    else:
        # MLA's prefill also decompresses every position's keys and values
        H, lora = c["num_attention_heads"], c["kv_lora_rank"]
        up = 2.0 * c["num_hidden_layers"] * prompt_len * lora * H * (
            c["qk_nope_head_dim"] + c["v_head_dim"])
        attn = attention_flops(c, prompt_len, prompt_len) + up
    return prompt_len * _token_matmul_flops(c) + attn + _head_flops(c)


def decode_flops(c: dict, pos: int) -> float:
    return (_token_matmul_flops(c) + _decode_attention_flops(c, pos)
            + _head_flops(c))
