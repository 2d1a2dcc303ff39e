"""Griffin / RecurrentGemma recurrent block of the port
(``repro/models/rglru.py``): gated branch ⊙ (linear → causal conv1d →
RG-LRU), then the output projection.

RG-LRU recurrence (Griffin eq. 1-4), computed in float32:
    r_t = sigmoid(W_a x_t + b_a)          (recurrence gate, block-diagonal)
    i_t = sigmoid(W_x x_t + b_x)          (input gate, block-diagonal)
    log a_t = -c * softplus(Lambda) * r_t
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill runs the recurrence through ``kernels.ops.rglru_scan`` (kernel
K3 on CUDA tensors, its plain version on CPU tensors); the reference
runs ``jax.lax.associative_scan`` there, which agrees up to float32
reordering.  Decoding is a single-step update.  The convolutions are
width-many shifted multiply-adds in float32, as in the reference, and
never go through cuDNN (which would run them in TF32 on the card).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import ParamFactory, dense_init
from repro_torch.specs import TensorSpec, tensors_like_specs


def _lambda_from_uniform(u, c: float):
    """softplus^-1 of -log(u) / (2c), so that a^c spans [0.9, 0.999]."""
    if isinstance(u, TensorSpec):
        return u
    return torch.log(torch.exp(-torch.log(u) / (2 * c)) - 1.0)


def init_rglru_block(make: ParamFactory, cfg) -> dict:
    g = cfg.rglru
    d = cfg.d_model
    r = g.d_rnn or d
    nh = cfg.n_heads
    assert r % nh == 0
    rh = r // nh
    dtype = getattr(torch, cfg.dtype)
    f32 = torch.float32
    u = make.uniform((r,), f32, 0.9 ** 2, 0.999 ** 2)
    return {
        "w_gate": dense_init(make, d, r, dtype),
        "w_rec": dense_init(make, d, r, dtype),
        "conv_w": make.normal((g.conv_width, r), dtype, 0.1),
        "conv_b": make.full((r,), dtype, 0.0),
        "lru": {
            "lambda": _lambda_from_uniform(u, g.c),           # (r,) f32
            "w_a": make.normal((nh, rh, rh), f32, rh ** -0.5),
            "b_a": make.full((r,), f32, 0.0),
            "w_x": make.normal((nh, rh, rh), f32, rh ** -0.5),
            "b_x": make.full((r,), f32, 0.0),
        },
        "w_out": dense_init(make, r, d, dtype),
    }


def _block_linear(w, x, nh: int):
    """x: (..., r) with block-diagonal weight w: (nh, rh, rh)."""
    shp = x.shape
    xh = x.reshape(*shp[:-1], nh, shp[-1] // nh)
    yh = torch.einsum("...hr,hrq->...hq", xh, w)
    return yh.reshape(shp)


def _gates(lru, x, nh: int, c: float):
    """Returns the float32 decay ``a`` and input ``b`` of the scan."""
    xf = x.float()
    r_gate = torch.sigmoid(_block_linear(lru["w_a"], xf, nh) + lru["b_a"])
    i_gate = torch.sigmoid(_block_linear(lru["w_x"], xf, nh) + lru["b_x"])
    log_a = -c * F.softplus(lru["lambda"]) * r_gate
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * (i_gate * xf)


def rglru_scan(lru, x, nh: int, c: float, h0=None):
    """x: (B, S, r) -> (y (B, S, r) in x's type, h_final (B, r) float32).
    The recurrence runs in kernel K3 on the card."""
    a, b = _gates(lru, x, nh, c)                             # (B, S, r) f32
    h, h_last = ops.rglru_scan(a, b, None if h0 is None else h0.float())
    return h.to(x.dtype), h_last


def rglru_step(lru, x_t, h, nh: int, c: float):
    """x_t: (B, r); h: (B, r) float32 -> (y_t, h_new)."""
    a, b = _gates(lru, x_t, nh, c)
    h_new = a * h.float() + b
    return h_new.to(x_t.dtype), h_new


def conv1d_causal(w, bias, x):
    """Depthwise causal conv. x: (B, S, r); w: (width, r)."""
    width = w.shape[0]
    pad = F.pad(x, (0, 0, width - 1, 0))
    S = x.shape[1]
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):
        y = y + pad[:, i:i + S].float() * w[i].float()
    return (y + bias.float()).to(x.dtype)


def conv1d_step(w, bias, x_t, conv_cache):
    """x_t: (B, r); conv_cache: (B, width-1, r) past inputs (oldest
    first).  Returns (y_t, the new conv cache)."""
    width = w.shape[0]
    hist = torch.cat([conv_cache, x_t[:, None]], dim=1)     # (B, width, r)
    y = torch.zeros(x_t.shape, dtype=torch.float32, device=x_t.device)
    for i in range(width):
        y = y + hist[:, i].float() * w[i].float()
    return (y + bias.float()).to(x_t.dtype), hist[:, 1:]


def rglru_block_apply(p, x, cfg, cache=None, pos=None):
    """Full Griffin recurrent block.

    Prefill: x (B, S, d), cache None -> (y, {"h", "conv"} final states).
    Decode: x (B, 1, d), cache {"h": (B, r) f32, "conv": (B, w-1, r)}
    -> (y, a NEW {"h", "conv"}); the caller writes it into its buffers.
    """
    g = cfg.rglru
    nh = cfg.n_heads
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")   # jax.nn.gelu default
    rec_in = x @ p["w_rec"]
    if cache is None:
        rec = conv1d_causal(p["conv_w"], p["conv_b"], rec_in)
        y, h_last = rglru_scan(p["lru"], rec, nh, g.c)
        width = p["conv_w"].shape[0]
        S = rec_in.shape[1]
        if S >= width - 1:
            conv_state = rec_in[:, S - (width - 1):]
        else:                     # a short prompt: left-pad with zeros
            conv_state = F.pad(rec_in, (0, 0, width - 1 - S, 0))
        new_cache = {"h": h_last, "conv": conv_state}
    else:
        rec_t, conv_state = conv1d_step(p["conv_w"], p["conv_b"],
                                        rec_in[:, 0], cache["conv"])
        y_t, h_new = rglru_step(p["lru"], rec_t, cache["h"], nh, g.c)
        y = y_t[:, None]
        new_cache = {"h": h_new, "conv": conv_state}
    out = (gate * y) @ p["w_out"]
    return out, new_cache


def rglru_cache_specs(cfg, batch: int) -> dict:
    """Shapes and types of :func:`init_rglru_cache`'s leaves."""
    g = cfg.rglru
    r = g.d_rnn or cfg.d_model
    return {"h": TensorSpec((batch, r), torch.float32),
            "conv": TensorSpec((batch, g.conv_width - 1, r),
                               getattr(torch, cfg.dtype))}


def init_rglru_cache(cfg, batch: int, device) -> dict:
    return tensors_like_specs(rglru_cache_specs(cfg, batch), device)
