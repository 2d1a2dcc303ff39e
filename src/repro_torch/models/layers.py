"""Dense building blocks of the port: RMSNorm, RoPE, the GQA attention
layer (prefill and decode) and the MLPs, as plain functions on param
dicts that mirror the reference's pytrees (``repro/models/layers.py``).

Types follow the reference exactly: RMSNorm and RoPE compute in float32
and cast back to the activation type; matmuls run in the weights' type.
Attention goes through ``kernels.ops``: on CUDA tensors the hand-written
kernels, on CPU tensors their plain versions.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.specs import TensorSpec


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ----------------------------------------------------------------------
# init helpers: same shapes and types as the reference's init_*
class ParamFactory:
    """Makes the leaves of an ``init_*`` tree: tensors drawn from ``gen``
    on its device, or, with no generator, ``TensorSpec`` records of the
    same shapes and types (specs without allocating anything)."""

    def __init__(self, gen: Optional[torch.Generator] = None):
        self.gen = gen

    def normal(self, shape, dtype: torch.dtype, scale: float):
        if self.gen is None:
            return TensorSpec(tuple(shape), dtype)
        w = torch.randn(shape, generator=self.gen, device=self.gen.device,
                        dtype=torch.float32)
        return (w * scale).to(dtype)

    def uniform(self, shape, dtype: torch.dtype, lo: float, hi: float):
        if self.gen is None:
            return TensorSpec(tuple(shape), dtype)
        u = torch.rand(shape, generator=self.gen, device=self.gen.device,
                       dtype=torch.float32)
        return (lo + (hi - lo) * u).to(dtype)

    def full(self, shape, dtype: torch.dtype, value: float):
        if self.gen is None:
            return TensorSpec(tuple(shape), dtype)
        return torch.full(shape, value, dtype=dtype, device=self.gen.device)


def dense_init(make: ParamFactory, in_dim: int, out_dim: int,
               dtype: torch.dtype, scale: Optional[float] = None):
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return make.normal((in_dim, out_dim), dtype, scale)


def init_rmsnorm(make: ParamFactory, d: int) -> dict:
    return {"scale": make.full((d,), torch.float32, 1.0)}


def rmsnorm_apply(params, x, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps) * params["scale"]
    return x.to(dtype)


# ----------------------------------------------------------------------
# RoPE (half-split rotation, float32), optionally YaRN-scaled
def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's magnitude correction, 0.1 * mscale * ln(factor) + 1 (1 for
    no extension)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_range(head_dim: int, theta: float, yarn) -> tuple:
    """(low, high): the frequency indices below which YaRN keeps RoPE's
    own frequency and from which it takes it divided by the factor, the
    dimensions that turn ``beta_fast`` and ``beta_slow`` times over the
    original context, clamped to [0, head_dim - 1]."""
    def dim(turns):
        return (head_dim * math.log(yarn.original_max_position_embeddings
                                    / (2 * math.pi * turns))
                / (2 * math.log(theta)))
    return (max(math.floor(dim(yarn.beta_fast)), 0),
            min(math.ceil(dim(yarn.beta_slow)), head_dim - 1))


def rope_frequencies(head_dim: int, theta: float, device=None, yarn=None):
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    freqs = 1.0 / (theta ** exponent)                    # (head_dim/2,)
    if yarn is None:
        return freqs
    # a linear ramp from the original frequencies (below ``low``) to the
    # interpolated ones, freqs / factor (from ``high``)
    low, high = yarn_range(head_dim, theta, yarn)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(head_dim // 2, dtype=torch.float32,
                                     device=device) - low) / (high - low),
                       0.0, 1.0)
    return freqs / yarn.factor * ramp + freqs * (1.0 - ramp)


def apply_rope(x, positions, theta: float, yarn=None):
    """x: (..., S, H, hd); positions: broadcastable to (..., S); ``yarn``:
    a ``configs.port.YaRN``, or None for plain RoPE."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device, yarn)
    angles = positions[..., None].float() * freqs        # (..., S, hd/2)
    angles = angles[..., None, :]                        # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    if yarn is not None:
        m = (yarn_mscale(yarn.factor, yarn.mscale)
             / yarn_mscale(yarn.factor, yarn.mscale_all_dim))
        if m != 1.0:
            cos, sin = cos * m, sin * m
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# GQA attention layer
def init_attention(make: ParamFactory, cfg) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    dtype = _dtype(cfg.dtype)
    p = {
        "wq": dense_init(make, d, cfg.n_heads * hd, dtype),
        "wk": dense_init(make, d, cfg.n_kv_heads * hd, dtype),
        "wv": dense_init(make, d, cfg.n_kv_heads * hd, dtype),
        "wo": dense_init(make, cfg.n_heads * hd, d, dtype),
    }
    if cfg.qkv_bias:
        nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
        p["bq"] = make.full((nq,), dtype, 0.0)
        p["bk"] = make.full((nkv,), dtype, 0.0)
        p["bv"] = make.full((nkv,), dtype, 0.0)
    return p


def attention_qkv(p, x, cfg, positions):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_prefill(p, x, cfg, *, local: bool, positions=None):
    """Returns (out, (k, v)) — k/v post-RoPE for cache seeding."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = attention_qkv(p, x, cfg, positions)
    window = cfg.window_size if local else None
    out = ops.flash_attention(q, k, v, causal=True, window=window,
                              softcap=cfg.attn_softcap, scale=cfg.query_scale)
    out = out.reshape(B, S, -1) @ p["wo"]
    return out, (k, v)


def decode_slot(pos, window, S_cache: int):
    """The cache slot of the token at ``pos``: a cache as long as the
    window is a ring buffer."""
    if window is not None and S_cache == window:
        return torch.remainder(pos, window)
    return pos


def attention_decode(p, x, cfg, cache, pos, *, local: bool):
    """x: (B,1,d); cache: {"k","v"} of (B, S_cache, Hkv, hd); pos: (B,)
    int32.  Returns (out, cache) — the SAME cache dict, updated in place."""
    B = x.shape[0]
    q, k, v = attention_qkv(p, x, cfg, pos[:, None])
    window = cfg.window_size if local else None
    slot = decode_slot(pos, window, cache["k"].shape[1])
    bidx = torch.arange(B, device=x.device)
    # in place: write this token's K/V into its cache slot (the reference
    # returns a new cache via .at[].set; the port keeps one buffer)
    cache["k"][bidx, slot.long()] = k[:, 0]
    cache["v"][bidx, slot.long()] = v[:, 0]
    out = ops.decode_attention(q, cache["k"], cache["v"], pos, window=window,
                               softcap=cfg.attn_softcap,
                               scale=cfg.query_scale)
    out = out.reshape(B, 1, -1) @ p["wo"]
    return out, cache


# ----------------------------------------------------------------------
# MLPs
def init_mlp(make: ParamFactory, cfg, d_ff: Optional[int] = None) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dtype = _dtype(cfg.dtype)
    if cfg.activation == "swiglu":
        return {"wi": dense_init(make, d, f, dtype),
                "wg": dense_init(make, d, f, dtype),
                "wo": dense_init(make, f, d, dtype)}
    return {"wi": dense_init(make, d, f, dtype),
            "wo": dense_init(make, f, d, dtype)}


def mlp_apply(p, x, activation: str):
    if activation == "swiglu":
        h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    elif activation == "squared_relu":
        h = torch.square(F.relu(x @ p["wi"]))
    elif activation == "gelu":
        h = F.gelu(x @ p["wi"], approximate="tanh")   # jax.nn.gelu default
    else:
        raise ValueError(activation)
    return h @ p["wo"]
