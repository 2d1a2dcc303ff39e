"""DeepSeek-V2 multi-head latent attention (MLA) of the port
(``repro/models/mla.py``).

The decode cache holds only the compressed latent ``ckv``
(``kv_lora_rank`` wide) and one RoPE key head ``kr`` shared by all heads.
Prefill expands the latents to full keys and values and runs K1; each
decode step writes its token's ``ckv``/``kr`` into their slots in place,
then either

* ``naive``: re-expands the whole latent cache and runs K2 (Hkv = Hq, one
  query head per KV head, dh = nope + rope, dv = ``v_head_dim``), or
* ``absorbed``: folds W_UK into the query and W_UV into the output and
  attends over the latents with plain PyTorch products, as the reference
  does with ``jnp.einsum``; its head dim (``kv_lora_rank`` +
  ``rope_head_dim``, 576 in deepseek-v2-lite) is beyond K2's, so no
  kernel runs on this path.

Where the config sets YaRN (``configs/port.py``), the query's rope part
and ``kr`` rotate at YaRN's frequencies in prefill and in both decode
modes, and the softmax scale takes YaRN's mscale squared (``_scale``).

The kernels read (B, S, H, D) tensors with a contiguous, 16-byte aligned
head dimension, so the keys, whose rope part is one head broadcast over
all heads, are materialised by a concat; the values are a strided view
of the expansion.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.port import rope_scaling
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.layers import (ParamFactory, apply_rope, dense_init,
                                      init_rmsnorm, rmsnorm_apply,
                                      yarn_mscale)


def init_mla(make: ParamFactory, cfg) -> dict:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    dtype = getattr(torch, cfg.dtype)
    qd = m.nope_head_dim + m.rope_head_dim
    p = {
        "wkv_a": dense_init(make, d, m.kv_lora_rank + m.rope_head_dim, dtype),
        "ckv_norm": init_rmsnorm(make, m.kv_lora_rank),
        "wkv_b": dense_init(make, m.kv_lora_rank,
                            H * (m.nope_head_dim + m.v_head_dim), dtype),
        "wo": dense_init(make, H * m.v_head_dim, d, dtype),
    }
    if m.q_lora_rank:
        p["wq_a"] = dense_init(make, d, m.q_lora_rank, dtype)
        p["q_norm"] = init_rmsnorm(make, m.q_lora_rank)
        p["wq_b"] = dense_init(make, m.q_lora_rank, H * qd, dtype)
    else:
        p["wq"] = dense_init(make, d, H * qd, dtype)
    return p


def _mla_q(p, x, cfg, positions):
    """x: (B, S, d) -> (q_nope (B, S, H, nope), q_rope (B, S, H, rope))."""
    m = cfg.mla
    B, S, _ = x.shape
    if m.q_lora_rank:
        q = rmsnorm_apply(p["q_norm"], x @ p["wq_a"], cfg.norm_eps) @ p["wq_b"]
    else:
        q = x @ p["wq"]
    q = q.reshape(B, S, cfg.n_heads, m.nope_head_dim + m.rope_head_dim)
    qn, qr = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    return qn, apply_rope(qr, positions, cfg.rope_theta, rope_scaling(cfg))


def _mla_latents(p, x, cfg, positions):
    """x: (B, S, d) -> (ckv (B, S, lora) normed, kr (B, S, rope) rotated)."""
    m = cfg.mla
    kv = x @ p["wkv_a"]
    ckv, kr = kv[..., :m.kv_lora_rank], kv[..., m.kv_lora_rank:]
    ckv = rmsnorm_apply(p["ckv_norm"], ckv, cfg.norm_eps)
    kr = apply_rope(kr[:, :, None, :], positions, cfg.rope_theta,
                    rope_scaling(cfg))[:, :, 0, :]
    return ckv, kr


def _expand(p, ckv, cfg):
    """latents (B, S, lora) -> k_nope (B, S, H, nope), v (B, S, H, v)."""
    m = cfg.mla
    B, S, _ = ckv.shape
    kvb = (ckv @ p["wkv_b"]).reshape(B, S, cfg.n_heads,
                                     m.nope_head_dim + m.v_head_dim)
    return kvb[..., :m.nope_head_dim], kvb[..., m.nope_head_dim:]


def _keys(kn, kr):
    """k_nope (B, S, H, nope) and the shared rope head (B, S, rope) ->
    contiguous keys (B, S, H, nope + rope)."""
    return torch.cat([kn, kr[:, :, None, :].expand(*kn.shape[:3],
                                                   kr.shape[-1])], dim=-1)


def _scale(cfg) -> float:
    """The softmax scale: 1/sqrt(dk), times YaRN's mscale(mscale_all_dim)
    squared where the config sets YaRN (as DeepSeek-V2 does)."""
    m = cfg.mla
    scale = 1.0 / math.sqrt(m.nope_head_dim + m.rope_head_dim)
    yarn = rope_scaling(cfg)
    if yarn is not None and yarn.mscale_all_dim:
        scale *= yarn_mscale(yarn.factor, yarn.mscale_all_dim) ** 2
    return scale


def mla_prefill(p, x, cfg, *, positions=None):
    """x: (B, S, d) -> (out, (ckv, kr)); attention through K1."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    qn, qr = _mla_q(p, x, cfg, positions)
    ckv, kr = _mla_latents(p, x, cfg, positions)
    kn, v = _expand(p, ckv, cfg)
    q = torch.cat([qn, qr], dim=-1)
    out = ops.flash_attention(q, _keys(kn, kr), v, causal=True,
                              scale=_scale(cfg))
    out = out.reshape(B, S, -1) @ p["wo"]
    return out, (ckv, kr)


def absorbed_attend(qn, qr, ckv, kr, pos, wkv_b, cfg):
    """The absorbed decode's attention: ``wkv_b``'s key half folded into
    the query, the scores taken against the latents ``ckv`` (B, L, lora)
    and ``kr`` up to ``pos``, its value half applied after.  qn, qr:
    (B, 1, H, nope/rope) for ``cfg.n_heads`` heads -> (B, 1, H, v)."""
    m = cfg.mla
    S = ckv.shape[1]
    valid = torch.arange(S, device=ckv.device)[None, :] <= pos.long()[:, None]
    wkv_b = wkv_b.reshape(m.kv_lora_rank, cfg.n_heads, -1)
    w_uk = wkv_b[..., :m.nope_head_dim]                      # (lora, H, nope)
    w_uv = wkv_b[..., m.nope_head_dim:]                      # (lora, H, v)
    q_lat = torch.einsum("bqhn,lhn->bqhl", qn, w_uk)
    s = (torch.einsum("bqhl,bsl->bhqs", q_lat.float(), ckv.float())
         + torch.einsum("bqhr,bsr->bhqs", qr.float(), kr.float())) \
        * _scale(cfg)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    probs = torch.softmax(s, dim=-1).to(qn.dtype)
    o_lat = torch.einsum("bhqs,bsl->bqhl", probs, ckv)
    return torch.einsum("bqhl,lhv->bqhv", o_lat, w_uv)


def mla_decode(p, x, cfg, cache, pos):
    """x: (B, 1, d); cache {"ckv": (B, L, lora), "kr": (B, L, rope)};
    pos: (B,) int32.  Returns (out, cache) — the SAME cache dict, with
    this token's latents written into their slots in place."""
    m = cfg.mla
    B = x.shape[0]
    H = cfg.n_heads
    qn, qr = _mla_q(p, x, cfg, pos[:, None])
    ckv_t, kr_t = _mla_latents(p, x, cfg, pos[:, None])
    bidx = torch.arange(B, device=x.device)
    slot = pos.long()
    cache["ckv"][bidx, slot] = ckv_t[:, 0]
    cache["kr"][bidx, slot] = kr_t[:, 0]
    ckv, kr = cache["ckv"], cache["kr"]
    scale = _scale(cfg)

    if m.decode_mode == "absorbed":
        out = absorbed_attend(qn, qr, ckv, kr, pos, p["wkv_b"], cfg)
    elif m.decode_mode == "naive":
        kn, v = _expand(p, ckv, cfg)
        q = torch.cat([qn, qr], dim=-1)                      # (B, 1, H, qd)
        out = ops.decode_attention(q, _keys(kn, kr), v, pos, scale=scale)
    else:
        raise ValueError(m.decode_mode)
    out = out.reshape(B, 1, -1) @ p["wo"]
    return out, cache
