"""Block assembly for the port: per-kind init/apply, cache construction
and seeding, and the segment loop (``repro/models/transformer.py``).

Segment params stay stacked as ``(repeats, ...)`` leaves, matching the
checkpoint keys; the reference's ``lax.scan`` over repeats becomes a
Python loop over views of those stacks.  This slice ports the dense
``attn`` block; the other kinds raise ``NotImplementedError`` naming the
ROADMAP item that ports them.
"""
from __future__ import annotations

import torch

from repro_torch.checkpoint.io import tree_map
from repro_torch.models import layers
from repro_torch.models.layers import (ParamFactory, init_rmsnorm,
                                      rmsnorm_apply)
from repro_torch.specs import TensorSpec

# block kind -> the ROADMAP.md module item that ports it
_PENDING = {
    "attn_local": "ROADMAP.md module item 1 (gemma2 attn_local and softcaps)",
    "attn_moe": "ROADMAP.md module item 2 (MoE)",
    "mla": "ROADMAP.md module item 3 (MLA)",
    "mla_moe": "ROADMAP.md module item 3 (MLA)",
    "rglru": "ROADMAP.md module item 4 (RG-LRU with kernel K3)",
    "mlstm": "ROADMAP.md module item 5 (xLSTM)",
    "slstm": "ROADMAP.md module item 5 (xLSTM)",
}


def require_ported(kind: str) -> None:
    if kind in _PENDING:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet: {_PENDING[kind]}")
    if kind != "attn":
        raise ValueError(kind)


def _has_ffn(kind, cfg) -> bool:
    if kind in ("mlstm", "slstm"):
        return False
    if kind in ("attn_moe", "mla_moe"):
        return True
    return cfg.d_ff > 0


# ----------------------------------------------------------------------
# per-block init / apply
def init_block(make: ParamFactory, kind: str, cfg) -> dict:
    require_ported(kind)
    p = {"norm1": init_rmsnorm(make, cfg.d_model)}
    if cfg.use_post_norm:
        p["post_norm1"] = init_rmsnorm(make, cfg.d_model)
    p["mixer"] = layers.init_attention(make, cfg)
    if _has_ffn(kind, cfg):
        p["norm2"] = init_rmsnorm(make, cfg.d_model)
        if cfg.use_post_norm:
            p["post_norm2"] = init_rmsnorm(make, cfg.d_model)
        p["ffn"] = layers.init_mlp(make, cfg)
    return p


def block_apply(kind, cfg, p, x, *, cache=None, pos=None, decode=False):
    """Returns (x, new_cache_or_None, aux).  In decode, ``cache`` is
    updated in place and returned.  ``aux`` (the MoE load-balance loss in
    the reference) is 0.0 for every ported kind."""
    require_ported(kind)
    aux = 0.0
    h = rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
    if decode:
        out, new_cache = layers.attention_decode(
            p["mixer"], h, cfg, cache, pos, local=False)
    else:
        out, new_cache = layers.attention_prefill(
            p["mixer"], h, cfg, local=False)     # (k, v) for cache seeding
    if cfg.use_post_norm:
        out = rmsnorm_apply(p["post_norm1"], out, cfg.norm_eps)
    x = x + out
    if _has_ffn(kind, cfg):
        h2 = rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
        out2 = layers.mlp_apply(p["ffn"], h2, cfg.activation)
        if cfg.use_post_norm:
            out2 = rmsnorm_apply(p["post_norm2"], out2, cfg.norm_eps)
        x = x + out2
    return x, new_cache, aux


# ----------------------------------------------------------------------
# caches
def block_cache_shapes(kind, cfg, batch: int, max_len: int) -> dict:
    hd = cfg.resolved_head_dim
    if kind in ("attn", "attn_moe"):
        L = max_len
    elif kind == "attn_local":
        L = min(max_len, cfg.window_size)
    else:
        require_ported(kind)
    shape = (batch, L, cfg.n_kv_heads, hd)
    return {"k": shape, "v": shape}


def init_block_cache(kind, cfg, batch: int, max_len: int, device) -> dict:
    dtype = getattr(torch, cfg.dtype)
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, shape in block_cache_shapes(kind, cfg, batch,
                                                  max_len).items()}


def seed_block_cache(kind, cfg, cache, prefill_out, seq_len: int) -> dict:
    """Place prefill K/V into a decode cache, in place; returns it."""
    if kind not in ("attn", "attn_moe", "attn_local"):
        require_ported(kind)
    for name, val in zip(("k", "v"), prefill_out):
        buf = cache[name]
        L = buf.shape[1]
        val = val.to(buf.dtype)
        if seq_len >= L:                  # exact fit, or ring-buffer wrap
            tail = val[:, seq_len - L:]
            slots = torch.remainder(
                torch.arange(seq_len - L, seq_len, device=buf.device), L)
            buf[:, slots] = tail
        else:
            buf[:, :seq_len] = val
    return cache


# ----------------------------------------------------------------------
# segments
def init_segment(make: ParamFactory, pattern, repeats: int, cfg) -> tuple:
    """Stacked params: tuple over pattern positions, leaves (repeats, ...)."""
    per = [tuple(init_block(make, kind, cfg) for kind in pattern)
           for _ in range(repeats)]
    return tuple(_stack([blocks[j] for blocks in per])
                 for j in range(len(pattern)))


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, TensorSpec):
        return TensorSpec((len(trees),) + first.shape, first.dtype)
    return torch.stack(trees)


def layer_params(seg_params, r: int) -> tuple:
    """Views of repeat ``r`` of a stacked segment."""
    return tuple(tree_map(lambda t: t[r], blk) for blk in seg_params)


def segment_apply(pattern, repeats: int, cfg, seg_params, x, *,
                  seg_caches=None, pos=None, decode=False):
    """Run ``repeats`` stacked super-blocks.  Returns (x, seg_caches, aux).

    With ``seg_caches`` (stacked ``(repeats, ...)`` buffers) the caches
    are written in place: in decode each layer writes its token's K/V;
    in prefill each layer's K/V seed its slice as soon as it is made."""
    aux = 0.0
    for r in range(repeats):
        params_r = layer_params(seg_params, r)
        for j, kind in enumerate(pattern):
            cache_rj = None
            if seg_caches is not None:
                cache_rj = {n: buf[r] for n, buf in seg_caches[j].items()}
            if decode:
                x, _, a = block_apply(kind, cfg, params_r[j], x,
                                      cache=cache_rj, pos=pos, decode=True)
            else:
                x, kv, a = block_apply(kind, cfg, params_r[j], x)
                if cache_rj is not None:
                    seed_block_cache(kind, cfg, cache_rj, kv, x.shape[1])
            aux = aux + a
    return x, seg_caches, aux
