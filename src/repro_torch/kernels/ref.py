"""Plain PyTorch versions of the port's kernels.

The two attention versions compute the functions of the reference's jnp
oracles — ``repro.models.layers.flash_attention`` and
``decode_attention`` — on any device, in float32, with the oracles'
masking arithmetic: scores of masked pairs become ``NEG_INF`` (a large
finite number) before the softmax.  ``flash_attention_bwd_ref`` is the
reference's custom VJP backward (``layers._flash_bwd_rule``) without its
chunking.  ``rglru_scan_ref`` is the literal recurrence of
``repro.kernels.ref.ref_rglru_scan`` and ``rglru_scan_bwd_ref`` its
gradient, the reverse walk that the VJP of the reference's scan
computes.  ``moe_grouped_ref`` is K4's arithmetic, the routed experts
over the rows of kept assignments, with its routing metadata
(``moe_plan_ref``).  ``kernels/ops.py`` sends CPU tensors here; ``chip_smoke.py``
holds each CUDA kernel against these on the card.
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


def _attention_mask(Sq: int, Sk: int, causal: bool, window: Optional[int],
                    q_offset: int, device) -> torch.Tensor:
    """(Sq, Sk): True where query row ``i`` (at ``q_offset + i``) may see
    key ``j``."""
    q_pos = q_offset + torch.arange(Sq, device=device)
    kv_pos = torch.arange(Sk, device=device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos[:, None] >= kv_pos[None, :]
    if window is not None:
        mask &= (q_pos[:, None] - kv_pos[None, :]) < window
    return mask


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None,
                        q_offset: int = 0, return_lse: bool = False):
    """Causal/windowed/softcapped GQA attention.

    q: (B, Sq, Hq, dh); k: (B, Sk, Hkv, dh); v: (B, Sk, Hkv, dv), with Hq a
    multiple of Hkv (query head ``h`` reads KV head ``h // G``).  Query
    row ``i`` sits at position ``q_offset + i``; key ``j`` at ``j``.
    Returns (B, Sq, Hq, dv) in q's type; with ``return_lse`` also the
    float32 row log-sum-exp of the scaled, softcapped, masked scores,
    ``m + log(max(l, 1e-30))`` laid out (B, Hq, Sq), as the reference's
    ``_flash_fwd_impl`` returns it."""
    B, Sq, Hq, dh = q.shape
    _, Sk, Hkv, _ = k.shape
    dv = v.shape[-1]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qh = q.reshape(B, Sq, Hkv, G, dh).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qh, k.float()) * scale
    s = _softcap(s, softcap)
    mask = _attention_mask(Sq, Sk, causal, window, q_offset, q.device)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    out = out.reshape(B, Sq, Hq, dv).to(q.dtype)
    if not return_lse:
        return out
    m = s.amax(dim=-1)
    l = torch.exp(s - m[..., None]).sum(dim=-1)
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    return out, lse.reshape(B, Hq, Sq)


def flash_attention_bwd_ref(q, k, v, out, lse, do, *, causal: bool = True,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None,
                            scale: Optional[float] = None,
                            q_offset: int = 0):
    """Gradients (dq, dk, dv) of :func:`flash_attention_ref` given the
    forward's ``out`` (in q's type) and float32 ``lse`` (B, Hq, Sq), line
    for line the reference's ``_flash_bwd_rule``: every product in
    float32 on float32 copies of q, k, v and do; ``D = rowsum(do * o)``;
    ``p = exp(s - lse)`` set to exactly 0 where masked; ``ds = p (dp -
    D)``, times ``1 - t^2`` under the softcap ``s = cap * t``; dk and dv
    summed over the G query heads of each KV head.  Each gradient comes
    back in its input's type."""
    B, Sq, Hq, dh = q.shape
    _, Sk, Hkv, _ = k.shape
    dv = v.shape[-1]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qf = q.float().reshape(B, Sq, Hkv, G, dh)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(B, Sq, Hkv, G, dv)
    of = out.float().reshape(B, Sq, Hkv, G, dv)
    D = torch.sum(dof * of, dim=-1).permute(0, 2, 3, 1)      # (B,Hkv,G,Sq)
    L = lse.float().reshape(B, Hkv, G, Sq)
    s_raw = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    if softcap is not None:
        t = torch.tanh(s_raw / softcap)
        s = softcap * t
    else:
        s = s_raw
    mask = _attention_mask(Sq, Sk, causal, window, q_offset, q.device)
    p = torch.where(mask, torch.exp(s - L[..., None]),
                    torch.zeros((), dtype=s.dtype, device=s.device))
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    ds = p * (dp - D[..., None])
    if softcap is not None:
        ds = ds * (1.0 - torch.square(t))
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf) * scale
    dvv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    return (dq.reshape(B, Sq, Hq, dh).to(q.dtype), dk.to(k.dtype),
            dvv.to(v.dtype))


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


def rglru_scan_bwd_ref(a, y, h0, dy, dhT):
    """Gradients of :func:`rglru_scan_ref` from its output ``y`` (every
    step's state) and the cotangents ``dy`` (B, S, r) and ``dhT`` (B, r)
    or None (zeros), as the literal reverse walk in float32, one
    separately rounded operation at a time: carry ``c`` from dhT (or 0)
    over t = S-1 ... 0 with ``g = dy_t + c``, ``db_t = g``, ``da_t = g *
    h_{t-1}`` (``y_{t-1}``; ``h0`` or 0 before step 0) and ``c = a_t *
    g``.  Returns (da, db (B, S, r), dh0 (B, r) or None when h0 is None),
    float32; with S == 0, dh0 is dhT (or zeros)."""
    a, y, dy = a.float(), y.float(), dy.float()
    B, S, r = a.shape
    c = (torch.zeros((B, r), dtype=torch.float32, device=a.device)
         if dhT is None else dhT.float().clone())
    h_start = (torch.zeros((B, r), dtype=torch.float32, device=a.device)
               if h0 is None else h0.float())
    da = torch.empty((B, S, r), dtype=torch.float32, device=a.device)
    db = torch.empty((B, S, r), dtype=torch.float32, device=a.device)
    for t in range(S - 1, -1, -1):
        g = dy[:, t] + c
        db[:, t] = g
        da[:, t] = g * (y[:, t - 1] if t > 0 else h_start)
        c = a[:, t] * g
    return da, db, (None if h0 is None else c)


def moe_plan_ref(idx, pos, *, capacity: int, group_size: int, e0: int,
                 n_local: int, tile_rows: int, n_slots: int):
    """The routing metadata of ``moe_grouped`` (K4's first kernel).

    idx, pos: (T, k) experts and each assignment's rank within its group
    and expert.  An assignment is kept when its rank is under
    ``capacity`` and its expert lies in ``[e0, e0 + n_local)``.  Kept
    assignments take rows in expert-major order: the expert's offset,
    then its groups' in order, plus the rank.  Returns ``row_slot``
    (T*k,) int32, the assignment (t * k + j) of each row, -1 past the
    kept ones; and ``tiles`` (n_slots, 3) int32, (expert, first row,
    rows) for each run of up to ``tile_rows`` rows of one expert, in
    expert order, then (-1, 0, 0).  Both shapes are fixed by the call's
    shapes whatever the routing."""
    T, k = idx.shape
    n, G = T * k, T // group_size
    dev = idx.device
    e = idx.reshape(n).long() - e0
    rank = pos.reshape(n).long()
    live = (e >= 0) & (e < n_local) & (rank < capacity)
    group = torch.arange(n, device=dev) // k // group_size
    cell = torch.where(live, e * G + group, n_local * G)       # dead: last
    kept = torch.zeros(n_local * G + 1, dtype=torch.long, device=dev)
    kept.index_add_(0, cell, torch.ones_like(cell))
    base = torch.cumsum(kept, 0) - kept                         # exclusive
    row_slot = torch.full((n,), -1, dtype=torch.int32, device=dev)
    row_slot[(base[cell] + rank)[live]] = \
        torch.arange(n, dtype=torch.int32, device=dev)[live]
    tiles = torch.tensor([[-1, 0, 0]], dtype=torch.int32).repeat(n_slots, 1)
    first = base[:-1:G].tolist()
    counts = kept[:-1].view(n_local, G).sum(1).tolist()
    s = 0
    for ex, (r0, cnt) in enumerate(zip(first, counts)):
        for j in range(0, cnt, tile_rows):
            tiles[s] = torch.tensor([ex, r0 + j, min(tile_rows, cnt - j)])
            s += 1
    return row_slot, tiles.to(dev)


def moe_grouped_ref(x2d, idx, pos, probs, wg, wi, wo, *, capacity: int,
                    group_size: int, e0: int = 0, return_plan: bool = False):
    """The routed experts' output (T, d) as K4 computes it: each kept
    assignment's row (``moe_plan_ref``) through its expert's SwiGLU,
    silu(x W_g) * x W_i from float32 products stored in x's type, then
    h W_o in float32 times the gate, stored in x's type to the
    assignment's (T, k) slot; the k slots summed (those not kept are
    zero).  wg, wi: (E_loc, d, d_ff), wo: (E_loc, d_ff, d), the experts
    from ``e0`` on.  With ``return_plan`` also the metadata."""
    from repro_torch.kernels.moe_grouped import tiling
    T, d = x2d.shape
    k = idx.shape[1]
    n_local = wg.shape[0]
    tl = tiling(T, k, n_local)
    row_slot, tiles = moe_plan_ref(
        idx, pos, capacity=capacity, group_size=group_size, e0=e0,
        n_local=n_local, tile_rows=tl.rows, n_slots=tl.slots)
    slots = torch.zeros((T * k, d), dtype=x2d.dtype, device=x2d.device)
    gates = probs.reshape(-1).float()
    for ex, r0, rows in tiles.tolist():
        if ex < 0:
            break
        slot = row_slot[r0:r0 + rows].long()
        xs = x2d[slot // k].float()
        h = (torch.nn.functional.silu(xs @ wg[ex].float())
             * (xs @ wi[ex].float())).to(x2d.dtype)
        y = (h.float() @ wo[ex].float()) * gates[slot, None]
        slots[slot] = y.to(x2d.dtype)
    out = slots.view(T, k, d).sum(dim=1)
    return (out, row_slot, tiles) if return_plan else out
