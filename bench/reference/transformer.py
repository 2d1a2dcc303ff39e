"""Plain float32 PyTorch reference of the decoder the benchmark serves.

It reads a configuration file's ``model`` block (Hugging Face key names)
and a flat ``{key path: tensor}`` weight dict in the checkpoint layout the
program loads (``seg0/[0]/mixer/wq`` with a leading layer axis), and runs
the published equations with no kernel, cache or batching:

* token embedding; per layer RMSNorm, grouped-query causal attention with
  half-split RoPE, the residual, RMSNorm, then a dense MLP (GELU, tanh
  form) or a routed mixture of experts (SwiGLU experts, softmax router,
  top-k renormalised), the residual; a final RMSNorm and the output head
  (the embedding, when tied);
* the experts route without drops, as the source does: every token
  goes through each of its top-k experts.  A configuration whose served
  capacity per expert and dispatch group could drop a choice is refused.

Everything runs in float32 with TF32 off.  ``precision="fp8"`` rounds both
operands of every weight product to float8 e4m3 (one scale per tensor):
the control, the step below the served bfloat16 that a faster path would
tempt.  This module imports neither the program nor JAX.

It is one reference module; a configuration file names its own by its
``reference`` key, a path from the repository root.  Every reference
module provides, as this one does:

* ``layout(m, dtype)``: every weight leaf, in the order the weights are
  drawn, as (key path, shape, type, kind, scale);
* ``forward(m, W, tokens, *, last_only=False, precision="float32",
  margins=None)``: float32 logits, with ``precision="fp8"`` the control;
  ``margins``, where given, a list that collects each expert layer's
  (B*S,) top-k margins (a model without experts adds none);
* ``no_tf32()``: full float32 products on the card;

and imports only ``torch``, the standard library and other reference
modules under ``bench/reference/``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0                     # largest finite float8 e4m3fn


def no_tf32() -> None:
    """Full float32 products on the card (TF32 keeps 10 mantissa bits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# ----------------------------------------------------------------------
# weight layout
def is_moe(m: dict) -> bool:
    return int(m.get("num_local_experts", 0)) > 0


def head_dim(m: dict) -> int:
    return int(m.get("head_dim") or m["hidden_size"] // m["num_attention_heads"])


def layout(m: dict, dtype: torch.dtype) -> List[Tuple[str, tuple, torch.dtype, str, float]]:
    """Every weight leaf as (key path, shape, type, kind, scale): ``kind``
    "normal" draws N(0, scale^2), "norm" draws 1 + N(0, scale^2).  Norm
    scales and the router are float32, as the checkpoint keeps them."""
    L, d = m["num_hidden_layers"], m["hidden_size"]
    H, Hkv, hd = m["num_attention_heads"], m["num_key_value_heads"], head_dim(m)
    V, f = m["vocab_size"], m["intermediate_size"]
    f32 = torch.float32
    out = [("embed", (V, d), dtype, "normal", d ** -0.5),
           ("final_norm/scale", (d,), f32, "norm", 0.1)]
    if not m.get("tie_word_embeddings", False):
        out.append(("unembed", (d, V), dtype, "normal", d ** -0.5))
    blk = "seg0/[0]"
    out += [(f"{blk}/norm1/scale", (L, d), f32, "norm", 0.1),
            (f"{blk}/norm2/scale", (L, d), f32, "norm", 0.1),
            (f"{blk}/mixer/wq", (L, d, H * hd), dtype, "normal", d ** -0.5),
            (f"{blk}/mixer/wk", (L, d, Hkv * hd), dtype, "normal", d ** -0.5),
            (f"{blk}/mixer/wv", (L, d, Hkv * hd), dtype, "normal", d ** -0.5),
            (f"{blk}/mixer/wo", (L, H * hd, d), dtype, "normal",
             (H * hd) ** -0.5)]
    if is_moe(m):
        E = m["num_local_experts"]
        out += [(f"{blk}/ffn/router", (L, d, E), f32, "normal", d ** -0.5),
                (f"{blk}/ffn/wi_e", (L, E, d, f), dtype, "normal", d ** -0.5),
                (f"{blk}/ffn/wg_e", (L, E, d, f), dtype, "normal", d ** -0.5),
                (f"{blk}/ffn/wo_e", (L, E, f, d), dtype, "normal", f ** -0.5)]
    elif m["hidden_act"] == "silu":
        out += [(f"{blk}/ffn/wi", (L, d, f), dtype, "normal", d ** -0.5),
                (f"{blk}/ffn/wg", (L, d, f), dtype, "normal", d ** -0.5),
                (f"{blk}/ffn/wo", (L, f, d), dtype, "normal", f ** -0.5)]
    else:
        out += [(f"{blk}/ffn/wi", (L, d, f), dtype, "normal", d ** -0.5),
                (f"{blk}/ffn/wo", (L, f, d), dtype, "normal", f ** -0.5)]
    return out


# ----------------------------------------------------------------------
# arithmetic
def _q8(t: torch.Tensor) -> torch.Tensor:
    s = t.abs().amax().clamp(min=1e-12) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def _mm(a: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        return _q8(a) @ _q8(w)
    return a @ w


def _rms(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def _rope(x, positions, theta):
    """x: (B, S, H, hd); the first and second halves rotate together."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    ang = positions[:, None].float() * freqs                  # (S, hd/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, scale):
    """Causal attention: q (B, S, H, hd), k/v (B, S, Hkv, hd)."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, S, H * hd)


def capacity(tokens_per_group: int, m: dict) -> int:
    """The served capacity per expert and dispatch group."""
    k, E = m["num_experts_per_tok"], m["num_local_experts"]
    c = int(tokens_per_group * k * m["moe_capacity_factor"] / E)
    return max(4, -(-c // 4) * 4)


def check_dropless(m: dict, tokens: int) -> None:
    """Refuse a configuration whose capacity could drop a choice: an
    expert can be chosen by every token of a group."""
    gs = min(int(m["moe_group_size"]), tokens)
    if capacity(gs, m) < gs:
        raise ValueError(f"a capacity of {capacity(gs, m)} per expert in "
                         f"groups of {gs} can drop choices; the reference "
                         "routes without drops")


def _moe(h, W, l, m, precision, margins=None):
    """h: (T, d).  Routed SwiGLU experts, every token through each of its
    top-k experts.  With ``margins`` (a list), appends each token's k-th
    gate less its next: how near its choice is to a tie."""
    E, k = m["num_local_experts"], m["num_experts_per_tok"]
    blk = "seg0/[0]/ffn"
    gates = torch.softmax(h @ W[f"{blk}/router"][l].float(), dim=-1)
    if margins is not None and k < E:
        top = torch.topk(gates, k + 1, dim=-1).values
        margins.append(top[:, k - 1] - top[:, k])
    probs, idx = torch.topk(gates, k, dim=-1)
    probs = probs / probs.sum(-1, keepdim=True).clamp(min=1e-9)
    out = torch.zeros_like(h)
    for e in range(E):
        w_tok = (probs * (idx == e)).sum(-1)                   # (T,)
        sel = torch.nonzero((idx == e).any(-1))[:, 0]
        if sel.numel() == 0:
            continue
        x = h[sel]
        wi = W[f"{blk}/wi_e"][l, e].float()
        wg = W[f"{blk}/wg_e"][l, e].float()
        wo = W[f"{blk}/wo_e"][l, e].float()
        y = _mm(F.silu(_mm(x, wg, precision)) * _mm(x, wi, precision), wo,
                precision)
        out[sel] += w_tok[sel, None] * y
    return out


def _mlp(h, W, l, m, precision):
    blk = "seg0/[0]/ffn"
    wi = W[f"{blk}/wi"][l].float()
    wo = W[f"{blk}/wo"][l].float()
    if m["hidden_act"] == "silu":
        a = F.silu(_mm(h, W[f"{blk}/wg"][l].float(), precision)) \
            * _mm(h, wi, precision)
    else:
        a = F.gelu(_mm(h, wi, precision), approximate="tanh")
    return _mm(a, wo, precision)


@torch.no_grad()
def forward(m: dict, W: Dict[str, torch.Tensor], tokens: torch.Tensor, *,
            last_only: bool = False, precision: str = "float32",
            margins=None) -> torch.Tensor:
    """Logits (B, S, V) float32, or (B, 1, V) with ``last_only``, for int
    ``tokens`` (B, S) on the weights' device.  Layer by layer, each
    layer's weights cast up to float32 when it runs.  ``margins``: a list
    that collects each expert layer's (B*S,) top-k margins."""
    B, S = tokens.shape
    L, eps = m["num_hidden_layers"], float(m["rms_norm_eps"])
    H, Hkv, hd = m["num_attention_heads"], m["num_key_value_heads"], head_dim(m)
    theta = float(m["rope_theta"])
    blk = "seg0/[0]"
    if is_moe(m):
        check_dropless(m, B * S)
    # Granite's scalar multipliers; without them, the plain decoder's
    att = float(m.get("attention_multiplier", 1.0 / math.sqrt(hd)))
    res = float(m.get("residual_multiplier", 1.0))
    x = W["embed"][tokens.long()].float() \
        * float(m.get("embedding_multiplier", 1.0))          # (B, S, d)
    pos = torch.arange(S, device=x.device)
    for l in range(L):
        h = _rms(x, W[f"{blk}/norm1/scale"][l].float(), eps)
        q = _mm(h, W[f"{blk}/mixer/wq"][l].float(), precision)
        kk = _mm(h, W[f"{blk}/mixer/wk"][l].float(), precision)
        vv = _mm(h, W[f"{blk}/mixer/wv"][l].float(), precision)
        q = _rope(q.reshape(B, S, H, hd), pos, theta)
        kk = _rope(kk.reshape(B, S, Hkv, hd), pos, theta)
        vv = vv.reshape(B, S, Hkv, hd)
        x = x + res * _mm(_attention(q, kk, vv, att),
                          W[f"{blk}/mixer/wo"][l].float(), precision)
        h = _rms(x, W[f"{blk}/norm2/scale"][l].float(), eps)
        if is_moe(m):
            ff = _moe(h.reshape(B * S, -1), W, l, m, precision,
                      margins).reshape(B, S, -1)
        else:
            ff = _mlp(h, W, l, m, precision)
        x = x + res * ff
    if last_only:
        x = x[:, -1:]
    x = _rms(x, W["final_norm/scale"].float(), eps)
    table = (W["embed"].float().t() if m.get("tie_word_embeddings", False)
             else W["unembed"].float())
    return _mm(x, table, precision) / float(m.get("logits_scaling", 1.0))
