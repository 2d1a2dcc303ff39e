"""Operations and bytes of DeepSeek-V2's blocks (multi-head latent
attention, the mixture of experts with shared experts, a leading dense
layer), from a configuration's ``model`` block in the source's key names.

The same bound arithmetic as ``counts.py``: every input byte read once and
every output byte written once, and only the work the inputs need, so a
share computed from these counts cannot pass 100% unless the time leaves
out part of the work.
"""
from __future__ import annotations

from typing import Tuple

from bench.roofline.counts import BF16


def _dims(m: dict):
    return (m["hidden_size"], m["num_attention_heads"],
            m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"],
            m["kv_lora_rank"])


def k2(m: dict, B: int, pos: int) -> Tuple[float, float]:
    """K2 in MLA's naive decode, one layer: B rows of H query heads, each
    over its own expanded key and value head (Hkv = H), keys nope + rope
    wide and values v wide, at ``pos + 1`` positions: (FLOPs, bytes)."""
    _, H, nope, rope, dv, _ = _dims(m)
    dk, valid = nope + rope, pos + 1
    flops = B * H * valid * 2 * (dk + dv)
    nbytes = BF16 * (B * H * valid * (dk + dv) + B * H * (dk + dv)) + 4 * B
    return flops, nbytes


def attention_weights(m: dict) -> int:
    """Parameters of one layer's latent attention (direct query)."""
    d, H, nope, rope, dv, lora = _dims(m)
    return (d * H * (nope + rope) + d * (lora + rope)
            + lora * H * (nope + dv) + H * dv * d)


def decode_step(m: dict, B: int, pos: int) -> Tuple[float, float]:
    """The least one decode step of B rows at position ``pos`` needs:
    (FLOPs, bytes).  FLOPs: the active parameters' products for B tokens,
    attention in MLA's absorbed form (the query folded through the key
    half of ``wkv_b``, scores and the weighted sum over the latent cache,
    then its value half), the router, and the output head.  Bytes: every
    weight outside the routed experts once (the router in float32, the
    shared experts, the dense layers, the head; norms and the B embedding
    rows left out), ``num_experts_per_tok`` routed experts of each expert
    layer (all B tokens may choose the same), the latent cache (latent and
    rope key) up to ``pos``, and the bfloat16 logits out."""
    d, H, nope, rope, dv, lora = _dims(m)
    L, k_dense = m["num_hidden_layers"], m["first_k_dense_replace"]
    n_moe = L - k_dense
    E, k = m["n_routed_experts"], m["num_experts_per_tok"]
    dense = 3 * d * m["intermediate_size"]
    expert = 3 * d * m["moe_intermediate_size"]
    shared = expert * m["n_shared_experts"]
    head = d * m["vocab_size"]
    valid = pos + 1
    attn_tok = (2 * (d * H * (nope + rope) + d * (lora + rope)
                     + H * nope * lora + H * lora * dv + H * dv * d)
                + 2 * H * valid * ((lora + rope) + lora))
    flops = B * (L * attn_tok + k_dense * 2 * dense
                 + n_moe * (2 * (shared + k * expert) + 2 * d * E)
                 + 2 * head)
    nbytes = (BF16 * (L * attention_weights(m) + k_dense * dense
                      + n_moe * (shared + k * expert) + head)
              + 4 * n_moe * d * E
              + BF16 * L * B * valid * (lora + rope)
              + BF16 * B * m["vocab_size"])
    return flops, nbytes
