"""xLSTM blocks of the port (``repro/models/xlstm.py``): mLSTM (matrix
memory, chunkwise-parallel prefill, O(1) decode state) and sLSTM (scalar
memory, a sequential recurrence with block-diagonal recurrent weights).
[arXiv:2405.04517]

Both use exponential input gating with the log-space max stabiliser
``m``.  The functions mirror the reference's one for one and keep its
types: the gate projections, the mLSTM's Q·K and P·V products and the
whole sLSTM recurrence are float32, whatever the model's type.  A float32
product here is a float32 matmul, so on the card it relies on PyTorch's
default of no TF32 for matmuls.  The masks and the initial stabiliser
are the reference's finite ``NEG_INF`` (-1e30): with ``-inf``,
``exp(m - m_new)`` would be ``nan`` where both are masked.

No kernel is involved: the reference is plain jnp, with the prefill's
``lax.scan`` over key chunks and over the sequence, which here become
Python loops (the sLSTM prefill launches a few dozen small kernels per
token and layer).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.layers import (ParamFactory, dense_init,
                                      init_rmsnorm, rmsnorm_apply)
from repro_torch.models.rglru import conv1d_causal, conv1d_step
from repro_torch.specs import TensorSpec, tensors_like_specs

F32 = torch.float32


# ======================================================================
# mLSTM
def init_mlstm_block(make: ParamFactory, cfg) -> dict:
    x = cfg.xlstm
    d = cfg.d_model
    di = int(d * x.proj_factor_mlstm)
    nh = cfg.n_heads
    assert di % nh == 0
    dtype = getattr(torch, cfg.dtype)
    return {
        "w_up": dense_init(make, d, 2 * di, dtype),
        "conv_w": make.normal((x.conv_width, di), dtype, 0.1),
        "conv_b": make.full((di,), dtype, 0.0),
        "wq": dense_init(make, di, di, dtype),
        "wk": dense_init(make, di, di, dtype),
        "wv": dense_init(make, di, di, dtype),
        "w_i": dense_init(make, di, nh, F32),
        "b_i": make.full((nh,), F32, 0.0),
        "w_f": dense_init(make, di, nh, F32),
        "b_f": make.full((nh,), F32, 3.0),        # forget-gate bias init
        "out_norm": init_rmsnorm(make, di),
        "w_down": dense_init(make, di, d, dtype),
    }


def mlstm_parallel(q, k, v, i_raw, f_raw, chunk: int = 64):
    """Stabilised chunkwise-parallel mLSTM.

    q, k, v: (B, S, nh, hd); i_raw, f_raw: (B, S, nh) float32.
    Returns h: (B, S, nh, hd) in q's type, and the final recurrent state
    (C (B, nh, hd, hd), n (B, nh, hd), m (B, nh)), float32.  S must be a
    multiple of ``min(chunk, S)``, as in the reference.
    """
    B, S, nh, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    logf = F.logsigmoid(f_raw)                              # (B, S, nh)
    b = torch.cumsum(logf, dim=1)                           # inclusive

    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"mLSTM prefill length {S} is not a multiple of "
                         f"its chunk {chunk}")
    nc = S // chunk
    # layout (B, nh, nc, chunk, ...)
    qh = (q.transpose(1, 2) * scale).reshape(B, nh, nc, chunk, hd)
    kh = k.transpose(1, 2).reshape(B, nh, nc, chunk, hd)
    vh = v.transpose(1, 2).reshape(B, nh, nc, chunk, hd)
    bh = b.transpose(1, 2).reshape(B, nh, nc, chunk)
    ih = i_raw.transpose(1, 2).reshape(B, nh, nc, chunk)
    pos = torch.arange(chunk, device=q.device)

    outs = []
    for qi in range(nc):
        q_blk, b_q = qh[:, :, qi].to(F32), bh[:, :, qi]
        m = torch.full((B, nh, chunk), NEG_INF, dtype=F32, device=q.device)
        l = torch.zeros((B, nh, chunk), dtype=F32, device=q.device)
        acc = torch.zeros((B, nh, chunk, hd), dtype=F32, device=q.device)
        for ki in range(qi + 1):
            k_blk, v_blk = kh[:, :, ki], vh[:, :, ki]
            b_k, i_k = bh[:, :, ki], ih[:, :, ki]
            # logD_tj = b_t - b_j + i_j   (valid for j <= t)
            logD = b_q[..., :, None] - b_k[..., None, :] + i_k[..., None, :]
            mask = (qi * chunk + pos)[:, None] >= (ki * chunk + pos)[None, :]
            logD = torch.where(mask, logD, torch.full_like(logD, NEG_INF))
            m_new = torch.maximum(m, logD.amax(dim=-1))
            dmat = torch.exp(logD - m_new[..., None])
            qk = q_blk @ k_blk.to(F32).transpose(-1, -2)
            s = qk * dmat
            alpha = torch.exp(m - m_new)
            l = l * alpha + s.sum(dim=-1)
            # s is rounded to v's type before P·V, as in the reference
            acc = acc * alpha[..., None] + s.to(v_blk.dtype).to(F32) @ \
                v_blk.to(F32)
            m = m_new
        denom = torch.maximum(l.abs(), torch.exp(-m))
        outs.append((acc / denom[..., None]).to(q.dtype))
    h = torch.stack(outs, dim=2)                    # (B, nh, nc, chunk, hd)
    h = h.reshape(B, nh, S, hd).transpose(1, 2)

    # final recurrent state (for the prefill -> decode hand-over)
    b_T = bh[:, :, -1, -1]                                  # (B, nh)
    logw = (b_T[..., None, None] - bh + ih).reshape(B, nh, S)
    m_T = logw.amax(dim=-1)                                 # (B, nh)
    w = torch.exp(logw - m_T[..., None])                    # (B, nh, S)
    kf = kh.reshape(B, nh, S, hd).to(F32)
    vf = vh.reshape(B, nh, S, hd).to(F32)
    C = (vf * w[..., None]).transpose(-1, -2) @ kf          # (B, nh, hd, hd)
    n = (w[..., None] * kf).sum(dim=-2)                     # (B, nh, hd)
    return h, (C, n, m_T)


def mlstm_step(q, k, v, i_raw, f_raw, state):
    """One decode step.  q, k, v: (B, nh, hd); gates: (B, nh); state:
    (C, n, m) float32.  Returns (h in q's type, the new state)."""
    C, n, m = state
    hd = q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    logf = F.logsigmoid(f_raw)
    m_new = torch.maximum(logf + m, i_raw)
    i_p = torch.exp(i_raw - m_new)
    f_p = torch.exp(logf + m - m_new)
    kf = k.to(F32)
    vf = v.to(F32)
    C_new = f_p[..., None, None] * C + i_p[..., None, None] * \
        (vf[..., :, None] * kf[..., None, :])
    n_new = f_p[..., None] * n + i_p[..., None] * kf
    qf = q.to(F32) * scale
    num = (C_new @ qf[..., None])[..., 0]
    den = torch.maximum((n_new * qf).sum(dim=-1).abs(), torch.exp(-m_new))
    h = num / den[..., None]
    return h.to(q.dtype), (C_new, n_new, m_new)


def _mlstm_qkv(p, x, cfg, conv_cache=None):
    """Shared projection path.  Returns (q, k, v, i_raw, f_raw, z,
    new_conv)."""
    nh = cfg.n_heads
    up = x @ p["w_up"]
    di = up.shape[-1] // 2
    x_m, z = up[..., :di], up[..., di:]
    if conv_cache is None:
        x_c = F.silu(conv1d_causal(p["conv_w"], p["conv_b"], x_m))
        width = p["conv_w"].shape[0]
        S = x_m.shape[1]
        if S >= width - 1:
            new_conv = x_m[:, S - (width - 1):]
        else:                     # a short prompt: left-pad with zeros
            new_conv = F.pad(x_m, (0, 0, width - 1 - S, 0))
    else:
        y, new_conv = conv1d_step(p["conv_w"], p["conv_b"], x_m[:, 0],
                                  conv_cache)
        x_c = F.silu(y)[:, None]
    q = x_c @ p["wq"]
    k = x_c @ p["wk"]
    v = x_m @ p["wv"]
    i_raw = x_c.to(F32) @ p["w_i"] + p["b_i"]
    f_raw = x_c.to(F32) @ p["w_f"] + p["b_f"]
    B, S = x.shape[0], x.shape[1]
    shp = (B, S, nh, di // nh)
    return (q.reshape(shp), k.reshape(shp), v.reshape(shp),
            i_raw, f_raw, z, new_conv)


def mlstm_block_apply(p, x, cfg, cache=None):
    """Prefill: cache None -> (out, the final {"C","n","m","conv"}).
    Decode: x (B, 1, d), cache {"C","n","m","conv"} -> (out, a NEW state
    dict); the caller writes it into its buffers."""
    if cache is None:
        q, k, v, i_raw, f_raw, z, conv = _mlstm_qkv(p, x, cfg)
        h, (C, n, m) = mlstm_parallel(q, k, v, i_raw, f_raw,
                                      chunk=cfg.xlstm.chunk_size)
    else:
        q, k, v, i_raw, f_raw, z, conv = _mlstm_qkv(
            p, x, cfg, conv_cache=cache["conv"])
        h1, (C, n, m) = mlstm_step(q[:, 0], k[:, 0], v[:, 0], i_raw[:, 0],
                                   f_raw[:, 0],
                                   (cache["C"], cache["n"], cache["m"]))
        h = h1[:, None]
    new_cache = {"C": C, "n": n, "m": m, "conv": conv}
    B, S = x.shape[0], x.shape[1]
    h = rmsnorm_apply(p["out_norm"], h.reshape(B, S, -1), cfg.norm_eps)
    out = (h * F.silu(z)) @ p["w_down"]
    return out, new_cache


def mlstm_cache_specs(cfg, batch: int) -> dict:
    """Shapes, types and initial values of :func:`init_mlstm_cache`."""
    x = cfg.xlstm
    di = int(cfg.d_model * x.proj_factor_mlstm)
    nh = cfg.n_heads
    hd = di // nh
    return {"C": TensorSpec((batch, nh, hd, hd), F32),
            "n": TensorSpec((batch, nh, hd), F32),
            "m": TensorSpec((batch, nh), F32, NEG_INF),
            "conv": TensorSpec((batch, x.conv_width - 1, di),
                               getattr(torch, cfg.dtype))}


def init_mlstm_cache(cfg, batch: int, device) -> dict:
    return tensors_like_specs(mlstm_cache_specs(cfg, batch), device)


# ======================================================================
# sLSTM
def init_slstm_block(make: ParamFactory, cfg) -> dict:
    x = cfg.xlstm
    d = cfg.d_model
    nh = cfg.n_heads
    assert d % nh == 0
    dh = d // nh
    dtype = getattr(torch, cfg.dtype)

    def rec():      # block-diagonal recurrent weights, float32 for the scan
        return make.normal((nh, dh, dh), F32, 1.0 / math.sqrt(dh))

    f = int(d * x.proj_factor_slstm)
    return {
        "w_z": dense_init(make, d, d, dtype), "r_z": rec(),
        "w_i": dense_init(make, d, d, dtype), "r_i": rec(),
        "w_f": dense_init(make, d, d, dtype), "r_f": rec(),
        "w_o": dense_init(make, d, d, dtype), "r_o": rec(),
        "b_z": make.full((d,), F32, 0.0),
        "b_i": make.full((d,), F32, 0.0),
        "b_f": make.full((d,), F32, 3.0),
        "b_o": make.full((d,), F32, 0.0),
        "out_norm": init_rmsnorm(make, d),
        "w_up1": dense_init(make, d, f, dtype),
        "w_up2": dense_init(make, d, f, dtype),
        "w_down": dense_init(make, f, d, dtype),
    }


def _block_rec(w, h, nh: int):
    """h: (B, d) float32, w: (nh, dh, dh)."""
    B, d = h.shape
    hh = h.reshape(B, nh, d // nh)
    return torch.einsum("bhr,hrq->bhq", hh, w).reshape(B, d)


def slstm_step(p, xz, xi, xf, xo, state, nh: int):
    """Precomputed input contributions (B, d) float32 + state dict ->
    the new state dict."""
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    z_t = torch.tanh(xz + _block_rec(p["r_z"], h, nh))
    i_t = xi + _block_rec(p["r_i"], h, nh)
    f_t = xf + _block_rec(p["r_f"], h, nh)
    o_t = torch.sigmoid(xo + _block_rec(p["r_o"], h, nh))
    logf = F.logsigmoid(f_t)
    m_new = torch.maximum(logf + m, i_t)
    i_p = torch.exp(i_t - m_new)
    f_p = torch.exp(logf + m - m_new)
    c_new = f_p * c + i_p * z_t
    n_new = torch.clamp(f_p * n + i_p, min=1e-12)
    h_new = o_t * c_new / n_new
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def slstm_block_apply(p, x, cfg, cache=None):
    """Prefill: a loop over S from the initial state -> (out, the final
    {"c","n","h","m"}).  Decode: one step from the cache's states -> (out,
    a NEW state dict); the caller writes it into its buffers."""
    nh = cfg.n_heads
    B = x.shape[0]
    xz, xi, xf_, xo = slstm_inputs(p, x)
    if cache is None:
        h, state = slstm_scan(p, xz, xi, xf_, xo,
                              init_slstm_cache(cfg, B, x.device), nh)
        h = h.to(x.dtype)                                   # (B, S, d)
    else:
        state = slstm_step(p, xz[:, 0], xi[:, 0], xf_[:, 0], xo[:, 0],
                           cache, nh)
        h = state["h"][:, None].to(x.dtype)
    return slstm_output(p, h, cfg), state


def slstm_scan(p, xz, xi, xf, xo, state, nh: int):
    """The recurrence over all S steps from ``state`` -> (h (B, S, d)
    float32, the final state)."""
    hs = []
    for t in range(xz.shape[1]):
        state = slstm_step(p, xz[:, t], xi[:, t], xf[:, t], xo[:, t],
                           state, nh)
        hs.append(state["h"])
    return torch.stack(hs, dim=1), state


def slstm_inputs(p, x):
    """The gates' input contributions (B, S, d) float32: z, i, f, o."""
    xf32 = x.to(F32)
    return tuple(xf32 @ p[f"w_{g}"].to(F32) + p[f"b_{g}"] for g in "zifo")


def slstm_output(p, h, cfg):
    """The block's output from its hidden states ``h`` (B, S, d): the
    output norm, then the gated up and down projections."""
    h = rmsnorm_apply(p["out_norm"], h, cfg.norm_eps)
    up = F.gelu(h @ p["w_up1"], approximate="tanh")         # jax.nn.gelu
    return (up * (h @ p["w_up2"])) @ p["w_down"]


def slstm_cache_specs(cfg, batch: int) -> dict:
    """Shapes, types and initial values of :func:`init_slstm_cache`."""
    d = cfg.d_model
    return {"c": TensorSpec((batch, d), F32),
            "n": TensorSpec((batch, d), F32, 1e-12),
            "h": TensorSpec((batch, d), F32),
            "m": TensorSpec((batch, d), F32)}


def init_slstm_cache(cfg, batch: int, device) -> dict:
    return tensors_like_specs(slstm_cache_specs(cfg, batch), device)
