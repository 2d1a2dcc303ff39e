"""Plain float32 PyTorch reference of DeepSeek-V2 (arXiv:2405.04434), as
the benchmark serves DeepSeek-V2-Lite.

It reads a configuration file's ``model`` block (the source's
``config.json`` key names) and a flat ``{key path: tensor}`` weight dict in
the checkpoint layout the program loads (``seg0`` the leading dense layers,
``seg1`` the expert layers, each leaf with a leading layer axis), and runs
the published equations with no kernel, cache or batching:

* token embedding; per layer RMSNorm, multi-head latent attention, the
  residual, RMSNorm, then a dense SwiGLU MLP (the first
  ``first_k_dense_replace`` layers) or the mixture of experts, the
  residual; a final RMSNorm and the untied output head;
* attention: the query projected directly (``q_lora_rank`` null), split
  into its ``qk_nope_head_dim`` part and its ``qk_rope_head_dim`` part;
  the latent ``c_kv`` (``kv_lora_rank`` wide, RMS-normed) and one rope key
  head shared by all heads from one projection; keys and values expanded
  from the latent; the rope parts rotated with YaRN's frequencies
  (``rope_scaling``: Hugging Face's ``DeepseekV2YarnRotaryEmbedding``,
  cos and sin times mscale / mscale_all_dim); the softmax scale
  1/sqrt(nope + rope) times yarn_mscale(factor, mscale_all_dim) squared;
* experts: a softmax over the ``n_routed_experts`` router outputs, each
  token through exactly its ``num_experts_per_tok`` best experts, each
  output weighted by its gate as the softmax gave it (``norm_topk_prob``
  false: not renormalised), plus the ``n_shared_experts`` shared experts,
  held as one SwiGLU of their summed width, for every token.  A served
  capacity per expert and dispatch group that could drop a choice is
  refused (``transformer.check_dropless``).

The rope columns rotate as half-split pairs, as the program does, where
the source rotates interleaved pairs: a fixed permutation of those
columns, which random weights cannot show (the configuration lists it).

Everything runs in float32 with TF32 off; ``precision="fp8"`` rounds both
operands of every weight product to float8 e4m3, the control.  The
contract is ``bench/reference/transformer.py``'s, whose helpers this
module uses; it imports neither the program nor JAX.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from bench.reference.transformer import (_mm, _rms, check_dropless,  # noqa: F401
                                         no_tf32)


def _check(m: dict) -> None:
    """Refuse what this reference does not compute."""
    want = {"hidden_act": "silu", "q_lora_rank": None, "attention_bias": False,
            "tie_word_embeddings": False, "scoring_func": "softmax",
            "topk_method": "greedy", "n_group": 1, "topk_group": 1,
            "routed_scaling_factor": 1, "moe_layer_freq": 1}
    for key, v in want.items():
        if m.get(key, v) != v:
            raise ValueError(f"the reference computes {key} {v!r} only, "
                             f"not {m[key]!r}")
    if (m["rope_scaling"] or {}).get("type") != "yarn":
        raise ValueError(f"the reference computes YaRN rope scaling only, "
                         f"not {m['rope_scaling']}")


def _dense(m: dict) -> int:
    return int(m["first_k_dense_replace"])


# ----------------------------------------------------------------------
# weight layout
def layout(m: dict, dtype: torch.dtype) -> List[Tuple[str, tuple, torch.dtype, str, float]]:
    """Every weight leaf as (key path, shape, type, kind, scale), in draw
    order: ``kind`` "normal" draws N(0, scale^2), "norm" 1 + N(0, scale^2).
    Norm scales and the router are float32."""
    _check(m)
    d, V, H = m["hidden_size"], m["vocab_size"], m["num_attention_heads"]
    nope, rope = m["qk_nope_head_dim"], m["qk_rope_head_dim"]
    dv, lora = m["v_head_dim"], m["kv_lora_rank"]
    f, fe = m["intermediate_size"], m["moe_intermediate_size"]
    E, fs = m["n_routed_experts"], m["moe_intermediate_size"] * m["n_shared_experts"]
    f32 = torch.float32
    out = [("embed", (V, d), dtype, "normal", d ** -0.5),
           ("final_norm/scale", (d,), f32, "norm", 0.1),
           ("unembed", (d, V), dtype, "normal", d ** -0.5)]
    k = _dense(m)
    for seg, n in (("seg0", k), ("seg1", m["num_hidden_layers"] - k)):
        blk = f"{seg}/[0]"
        out += [(f"{blk}/norm1/scale", (n, d), f32, "norm", 0.1),
                (f"{blk}/norm2/scale", (n, d), f32, "norm", 0.1),
                (f"{blk}/mixer/wq", (n, d, H * (nope + rope)), dtype, "normal",
                 d ** -0.5),
                (f"{blk}/mixer/wkv_a", (n, d, lora + rope), dtype, "normal",
                 d ** -0.5),
                (f"{blk}/mixer/ckv_norm/scale", (n, lora), f32, "norm", 0.1),
                (f"{blk}/mixer/wkv_b", (n, lora, H * (nope + dv)), dtype,
                 "normal", lora ** -0.5),
                (f"{blk}/mixer/wo", (n, H * dv, d), dtype, "normal",
                 (H * dv) ** -0.5)]
        if seg == "seg0":
            out += [(f"{blk}/ffn/wi", (n, d, f), dtype, "normal", d ** -0.5),
                    (f"{blk}/ffn/wg", (n, d, f), dtype, "normal", d ** -0.5),
                    (f"{blk}/ffn/wo", (n, f, d), dtype, "normal", f ** -0.5)]
            continue
        out += [(f"{blk}/ffn/router", (n, d, E), f32, "normal", d ** -0.5),
                (f"{blk}/ffn/wi_e", (n, E, d, fe), dtype, "normal", d ** -0.5),
                (f"{blk}/ffn/wg_e", (n, E, d, fe), dtype, "normal", d ** -0.5),
                (f"{blk}/ffn/wo_e", (n, E, fe, d), dtype, "normal", fe ** -0.5),
                (f"{blk}/ffn/shared/wi", (n, d, fs), dtype, "normal", d ** -0.5),
                (f"{blk}/ffn/shared/wg", (n, d, fs), dtype, "normal", d ** -0.5),
                (f"{blk}/ffn/shared/wo", (n, fs, d), dtype, "normal",
                 fs ** -0.5)]
    return out


# ----------------------------------------------------------------------
# YaRN rotary embedding
def yarn_get_mscale(scale: float, mscale: float) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def _correction_dim(turns, dim, base, max_pos):
    return (dim * math.log(max_pos / (turns * 2 * math.pi))) \
        / (2 * math.log(base))


def yarn_inv_freq(dim: int, base: float, rs: dict) -> torch.Tensor:
    """(dim/2,) frequencies: the original ones up to ``low``, those
    divided by ``factor`` from ``high``, a linear blend between."""
    idx = torch.arange(0, dim, 2, dtype=torch.float32)
    freq_extra = 1.0 / (base ** (idx / dim))
    freq_inter = 1.0 / (rs["factor"] * base ** (idx / dim))
    max_pos = rs["original_max_position_embeddings"]
    low = max(math.floor(_correction_dim(rs["beta_fast"], dim, base,
                                         max_pos)), 0)
    high = min(math.ceil(_correction_dim(rs["beta_slow"], dim, base,
                                         max_pos)), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low)
                       / (high - low), 0, 1)
    mask = 1.0 - ramp
    return freq_inter * (1 - mask) + freq_extra * mask


def _rope(x, positions, m):
    """x: (B, S, H, dim) rotated as half-split pairs at YaRN's
    frequencies."""
    dim = x.shape[-1]
    rs = m["rope_scaling"]
    inv = yarn_inv_freq(dim, float(m["rope_theta"]), rs)
    scale = (yarn_get_mscale(rs["factor"], rs["mscale"])
             / yarn_get_mscale(rs["factor"], rs["mscale_all_dim"]))
    ang = positions[:, None].float() * inv.to(x.device)           # (S, dim/2)
    cos = (torch.cos(ang) * scale)[:, None, :]
    sin = (torch.sin(ang) * scale)[:, None, :]
    x1, x2 = x[..., :dim // 2], x[..., dim // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def softmax_scale(m: dict) -> float:
    scale = (m["qk_nope_head_dim"] + m["qk_rope_head_dim"]) ** -0.5
    rs = m["rope_scaling"]
    if rs["mscale_all_dim"]:
        ms = yarn_get_mscale(rs["factor"], rs["mscale_all_dim"])
        scale = scale * ms * ms
    return scale


# ----------------------------------------------------------------------
# blocks
def _mla(h, W, blk, l, m, pos, precision):
    """Multi-head latent attention of one layer: h (B, S, d) -> (B, S, d)."""
    B, S, _ = h.shape
    H = m["num_attention_heads"]
    nope, rope = m["qk_nope_head_dim"], m["qk_rope_head_dim"]
    dv, lora = m["v_head_dim"], m["kv_lora_rank"]
    eps = float(m["rms_norm_eps"])
    q = _mm(h, W[f"{blk}/mixer/wq"][l].float(), precision)
    q = q.reshape(B, S, H, nope + rope)
    q = torch.cat([q[..., :nope], _rope(q[..., nope:], pos, m)], dim=-1)
    kv = _mm(h, W[f"{blk}/mixer/wkv_a"][l].float(), precision)
    ckv = _rms(kv[..., :lora], W[f"{blk}/mixer/ckv_norm/scale"][l].float(), eps)
    kr = _rope(kv[..., None, lora:], pos, m)                    # (B, S, 1, rope)
    kvb = _mm(ckv, W[f"{blk}/mixer/wkv_b"][l].float(), precision)
    kvb = kvb.reshape(B, S, H, nope + dv)
    k = torch.cat([kvb[..., :nope], kr.expand(B, S, H, rope)], dim=-1)
    v = kvb[..., nope:]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * softmax_scale(m)
    mask = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, S, H * dv)
    return _mm(o, W[f"{blk}/mixer/wo"][l].float(), precision)


def _swiglu(x, wi, wg, wo, precision):
    return _mm(F.silu(_mm(x, wg.float(), precision)) * _mm(x, wi.float(),
                                                          precision),
               wo.float(), precision)


def _moe(h, W, l, m, precision, margins=None):
    """h: (T, d).  Every token through exactly its top-k routed experts,
    each weighted by its softmax gate, plus the shared experts."""
    E, k = m["n_routed_experts"], m["num_experts_per_tok"]
    blk = "seg1/[0]/ffn"
    gates = torch.softmax(h @ W[f"{blk}/router"][l].float(), dim=-1)
    if margins is not None and k < E:
        top = torch.topk(gates, k + 1, dim=-1).values
        margins.append(top[:, k - 1] - top[:, k])
    probs, idx = torch.topk(gates, k, dim=-1)
    if m.get("norm_topk_prob", False):
        probs = probs / probs.sum(-1, keepdim=True).clamp(min=1e-9)
    out = _swiglu(h, W[f"{blk}/shared/wi"][l], W[f"{blk}/shared/wg"][l],
                  W[f"{blk}/shared/wo"][l], precision)
    for e in range(E):
        chosen = idx == e                                       # (T, k)
        sel = torch.nonzero(chosen.any(-1))[:, 0]
        if sel.numel() == 0:
            continue
        y = _swiglu(h[sel], W[f"{blk}/wi_e"][l, e], W[f"{blk}/wg_e"][l, e],
                    W[f"{blk}/wo_e"][l, e], precision)
        out[sel] += (probs * chosen).sum(-1)[sel, None] * y
    return out


@torch.no_grad()
def forward(m: dict, W: Dict[str, torch.Tensor], tokens: torch.Tensor, *,
            last_only: bool = False, precision: str = "float32",
            margins=None) -> torch.Tensor:
    """Logits (B, S, V) float32, or (B, 1, V) with ``last_only``, for int
    ``tokens`` (B, S) on the weights' device.  Layer by layer, each
    layer's weights cast up to float32 when they are used.  ``margins``: a
    list that collects each expert layer's (B*S,) top-k margins."""
    _check(m)
    B, S = tokens.shape
    eps = float(m["rms_norm_eps"])
    check_dropless(dict(m, num_local_experts=m["n_routed_experts"]), B * S)
    x = W["embed"][tokens.long()].float()                       # (B, S, d)
    pos = torch.arange(S, device=x.device)
    k = _dense(m)
    for layer in range(m["num_hidden_layers"]):
        blk, l = ("seg0/[0]", layer) if layer < k else ("seg1/[0]", layer - k)
        h = _rms(x, W[f"{blk}/norm1/scale"][l].float(), eps)
        x = x + _mla(h, W, blk, l, m, pos, precision)
        h = _rms(x, W[f"{blk}/norm2/scale"][l].float(), eps)
        if layer < k:
            ff = _swiglu(h, W[f"{blk}/ffn/wi"][l], W[f"{blk}/ffn/wg"][l],
                         W[f"{blk}/ffn/wo"][l], precision)
        else:
            ff = _moe(h.reshape(B * S, -1), W, l, m, precision,
                      margins).reshape(B, S, -1)
        x = x + ff
    if last_only:
        x = x[:, -1:]
    x = _rms(x, W["final_norm/scale"].float(), eps)
    return _mm(x, W["unembed"].float(), precision)
