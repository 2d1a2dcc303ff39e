"""Plain PyTorch versions of the port's three kernels.

The two attention versions compute the functions of the reference's jnp
oracles — ``repro.models.layers.flash_attention`` and
``decode_attention`` — on any device, in float32, with the oracles'
masking arithmetic: scores of masked pairs become ``NEG_INF`` (a large
finite number) before the softmax.  ``rglru_scan_ref`` is the literal
recurrence of ``repro.kernels.ref.ref_rglru_scan``.  ``kernels/ops.py``
sends CPU tensors here; ``chip_smoke.py`` holds each CUDA kernel against
these on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _softcap(s: torch.Tensor, softcap: Optional[float]) -> torch.Tensor:
    if softcap is None:
        return s
    return softcap * torch.tanh(s / softcap)


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None,
                        q_offset: int = 0) -> torch.Tensor:
    """Causal/windowed/softcapped GQA attention.

    q: (B, Sq, Hq, dh); k: (B, Sk, Hkv, dh); v: (B, Sk, Hkv, dv), with Hq a
    multiple of Hkv (query head ``h`` reads KV head ``h // G``).  Query
    row ``i`` sits at position ``q_offset + i``; key ``j`` at ``j``.
    Returns (B, Sq, Hq, dv) in q's type."""
    B, Sq, Hq, dh = q.shape
    _, Sk, Hkv, _ = k.shape
    dv = v.shape[-1]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qh = q.reshape(B, Sq, Hkv, G, dh).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qh, k.float()) * scale
    s = _softcap(s, softcap)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    kv_pos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= kv_pos[None, :]
    if window is not None:
        mask &= (q_pos[:, None] - kv_pos[None, :]) < window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, Hq, dv).to(q.dtype)


def decode_slot_valid(pos: torch.Tensor, S: int,
                      window: Optional[int]) -> torch.Tensor:
    """(B, S) validity of each cache slot for the current positions.

    A ring buffer (``window == S``) holds in slot ``j`` the position
    ``pos - ((pos - j) mod W)`` (true modulo), valid when it is >= 0;
    otherwise slot ``j`` is position ``j``, valid up to ``pos`` and
    within the window."""
    slots = torch.arange(S, device=pos.device)
    pos = pos.long()[:, None]
    if window is not None and S == window:
        return pos - torch.remainder(pos - slots[None, :], window) >= 0
    valid = slots[None, :] <= pos
    if window is not None:
        valid &= (pos - slots[None, :]) < window
    return valid


def decode_attention_ref(q, k_cache, v_cache, pos, *,
                         window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """One query token per row against a (possibly ring-buffered) cache.

    q: (B, 1, Hq, dh); k_cache: (B, S, Hkv, dh); v_cache: (B, S, Hkv, dv);
    pos: (B,) integer positions of the current token.  Returns
    (B, 1, Hq, dv) in q's type."""
    B, _, Hq, dh = q.shape
    _, S, Hkv, _ = k_cache.shape
    dv = v_cache.shape[-1]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qh = q.reshape(B, Hkv, G, dh).float()
    s = torch.einsum("bhgd,bshd->bhgs", qh, k_cache.float()) * scale
    s = _softcap(s, softcap)
    valid = decode_slot_valid(pos, S, window)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    return out.reshape(B, 1, Hq, dv).to(q.dtype)


def rglru_scan_ref(a, b, h0=None):
    """The literal recurrence ``h_t = a_t * h_{t-1} + b_t`` in float32.

    a, b: (B, S, r); h0: (B, r) or None (zeros).  Returns
    (y (B, S, r) float32, h_T (B, r) float32); h_T is h0 when S == 0."""
    a, b = a.float(), b.float()
    B, S, r = a.shape
    h = (torch.zeros((B, r), dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    y = torch.empty((B, S, r), dtype=torch.float32, device=a.device)
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        y[:, t] = h
    return y, h
