"""Block assembly for the port: per-kind init/apply, cache construction
and seeding, and the segment loop (``repro/models/transformer.py``).

Segment params stay stacked as ``(repeats, ...)`` leaves, matching the
checkpoint keys; the reference's ``lax.scan`` over repeats becomes a
Python loop over views of those stacks.  The port has the attention
blocks (``attn``; ``attn_local`` with its sliding window and ring cache;
``attn_moe``, attention then the MoE FFN), the MLA blocks (``mla`` with a
dense MLP, ``mla_moe`` with the MoE FFN), the RG-LRU block (``rglru``)
and the xLSTM blocks (``mlstm``, ``slstm``, which carry their own up and
down projections and have no FFN): every kind the reference has.

Training (``segment_apply(..., remat=True)`` under autograd) mirrors the
reference's two-level sqrt(R) rematerialisation with
``torch.utils.checkpoint``.

Decode caches are preallocated buffers written in place: attention
writes its token's K/V into its slot, MLA its token's latents, and the
recurrent blocks' new states (RG-LRU ``h``/``conv``, mLSTM
``C``/``n``/``m``/``conv``, sLSTM ``c``/``n``/``h``/``m``) are copied
into their buffers.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.checkpoint.io import tree_map
from repro_torch.models import layers, mla, moe, rglru, xlstm
from repro_torch.models.layers import (ParamFactory, init_rmsnorm,
                                      rmsnorm_apply)
from repro_torch.sharding import boundary
from repro_torch.specs import TensorSpec, tensors_like_specs

_ATTN = ("attn", "attn_local", "attn_moe")
_MLA = ("mla", "mla_moe")
_MOE = ("attn_moe", "mla_moe")
_FULL_LENGTH_KV = ("attn", "attn_moe")     # the other attention is windowed
# recurrent kinds: block -> (init, apply, cache specs)
_RECURRENT = {
    "rglru": (rglru.init_rglru_block, rglru.rglru_block_apply,
              rglru.rglru_cache_specs),
    "mlstm": (xlstm.init_mlstm_block, xlstm.mlstm_block_apply,
              xlstm.mlstm_cache_specs),
    "slstm": (xlstm.init_slstm_block, xlstm.slstm_block_apply,
              xlstm.slstm_cache_specs),
}
PORTED = _ATTN + _MLA + tuple(_RECURRENT)


def require_ported(kind: str) -> None:
    if kind not in PORTED:
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
    if kind in _ATTN:
        p["mixer"] = layers.init_attention(make, cfg)
    elif kind in _MLA:
        p["mixer"] = mla.init_mla(make, cfg)
    else:
        p["mixer"] = _RECURRENT[kind][0](make, cfg)
    if _has_ffn(kind, cfg):
        p["norm2"] = init_rmsnorm(make, cfg.d_model)
        if cfg.use_post_norm:
            p["post_norm2"] = init_rmsnorm(make, cfg.d_model)
        if kind in _MOE:
            p["ffn"] = moe.init_moe(make, cfg)
        else:
            p["ffn"] = layers.init_mlp(make, cfg)
    return p


def block_apply(kind, cfg, p, x, *, cache=None, pos=None, decode=False):
    """Returns (x, new_cache_or_None, aux).  In decode, ``cache`` is
    updated in place and returned.  In prefill the second item is what
    seeds a decode cache: (k, v) for attention, (ckv, kr) for MLA, the
    final state dict for the recurrent kinds.  ``aux`` is the MoE
    load-balance loss, a float32 scalar tensor, or 0.0 for the kinds
    without MoE (no device work for them).  On DTensors (a sharded
    step) the mixer and the FFN run tensor parallel (``sharding.tp``)."""
    require_ported(kind)
    tp = None
    if boundary.sharded(x):
        from repro_torch.sharding import tp
    aux = 0.0
    h = rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
    if tp is not None:
        out, new_cache = tp.mixer_apply(kind, cfg, p["mixer"], h,
                                        cache=cache, pos=pos, decode=decode)
    elif kind in _MLA:
        if decode:
            out, new_cache = mla.mla_decode(p["mixer"], h, cfg, cache, pos)
        else:
            out, new_cache = mla.mla_prefill(p["mixer"], h, cfg)
    elif kind in _RECURRENT:
        out, new_cache = _RECURRENT[kind][1](
            p["mixer"], h, cfg, cache=cache if decode else None)
        if decode:                 # in place: the state lives in the buffers
            for name, val in new_cache.items():
                cache[name].copy_(val)
            new_cache = cache
    elif decode:
        out, new_cache = layers.attention_decode(
            p["mixer"], h, cfg, cache, pos, local=kind == "attn_local")
    else:
        out, new_cache = layers.attention_prefill(
            p["mixer"], h, cfg, local=kind == "attn_local")
    if cfg.use_post_norm:
        out = rmsnorm_apply(p["post_norm1"], out, cfg.norm_eps)
    x = x + out
    if _has_ffn(kind, cfg):
        h2 = rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
        if tp is not None:
            out2, aux = tp.ffn_apply(kind, cfg, p["ffn"], h2)
        elif kind in _MOE:
            out2, aux = moe.moe_apply(p["ffn"], h2, cfg)
        else:
            out2 = layers.mlp_apply(p["ffn"], h2, cfg.activation)
        if cfg.use_post_norm:
            out2 = rmsnorm_apply(p["post_norm2"], out2, cfg.norm_eps)
        x = x + out2
    return x, new_cache, aux


# ----------------------------------------------------------------------
# caches
def block_cache_specs(kind, cfg, batch: int, max_len: int) -> dict:
    """Shape and type of each leaf of one block's decode cache, as the
    reference's ``init_block_cache`` makes it: K/V (full length, or the
    window for ``attn_local``) and MLA's ``ckv``/``kr`` in the model's
    type, the recurrent states in float32 and the ``conv`` windows in
    the model's type, each with its initial value."""
    require_ported(kind)
    dtype = getattr(torch, cfg.dtype)
    if kind in _RECURRENT:
        return _RECURRENT[kind][2](cfg, batch)
    if kind in _MLA:
        m = cfg.mla
        return {"ckv": TensorSpec((batch, max_len, m.kv_lora_rank), dtype),
                "kr": TensorSpec((batch, max_len, m.rope_head_dim), dtype)}
    L = max_len if kind in _FULL_LENGTH_KV else min(max_len, cfg.window_size)
    spec = TensorSpec((batch, L, cfg.n_kv_heads, cfg.resolved_head_dim),
                      dtype)
    return {"k": spec, "v": spec}


def init_block_cache(kind, cfg, batch: int, max_len: int, device) -> dict:
    return tensors_like_specs(block_cache_specs(kind, cfg, batch, max_len),
                              device)


def seed_block_cache(kind, cfg, cache, prefill_out, seq_len: int) -> dict:
    """Place prefill products into a decode cache, in place; returns it.
    Attention K/V and MLA latents fill slots (a ring buffer wraps);
    recurrent states are copied as they are."""
    require_ported(kind)
    if kind in _RECURRENT:
        for name, val in prefill_out.items():
            if boundary.sharded(cache[name]):
                boundary.assign(cache[name], val)
            else:
                cache[name].copy_(val)
        return cache
    names = ("ckv", "kr") if kind in _MLA else ("k", "v")
    for name, val in zip(names, prefill_out):
        buf = cache[name]
        L = buf.shape[1]
        if boundary.sharded(buf):        # each rank seeds the slots it holds
            t0 = max(0, seq_len - L)
            boundary.write_slots(buf, val[:, t0:seq_len],
                                 [t % L for t in range(t0, seq_len)])
            continue
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


def unbind_repeats(seg_params, repeats: int) -> list:
    """Every repeat's views of a stacked segment, from one ``unbind`` per
    leaf.  Under autograd an index ``t[r]`` per repeat would make its
    backward allocate a zero gradient of the whole ``(repeats, ...)``
    stack, once per repeat; ``unbind``'s backward stacks the repeats'
    gradients once."""
    per_leaf = [tree_map(lambda t: torch.unbind(t), blk) for blk in seg_params]

    def pick(tree, r):
        if isinstance(tree, dict):
            return {k: pick(v, r) for k, v in tree.items()}
        return tree[r]
    return [tuple(pick(blk, r) for blk in per_leaf) for r in range(repeats)]


def _sqrt_divisor(n: int) -> int:
    """Largest divisor of n not exceeding sqrt(n)+1 (for 2-level remat)."""
    best = 1
    d = 1
    while d * d <= n + 1:
        if n % d == 0:
            best = d
        d += 1
    return best


def _remat(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are dropped and recomputed in the backward.  Every run
    after the first is a recomputation, during which ``moe.record_routing``
    records nothing, so each forward's routing is recorded once."""
    state = {"runs": 0}

    def run(*a):
        state["runs"] += 1
        if state["runs"] == 1:
            return fn(*a)
        with moe.recording_paused():
            return fn(*a)
    return checkpoint(run, *args, use_reentrant=False)


def segment_apply(pattern, repeats: int, cfg, seg_params, x, *,
                  seg_caches=None, pos=None, decode=False,
                  remat: bool = False, constrain=None):
    """Run ``repeats`` stacked super-blocks.  Returns (x, seg_caches, aux).

    With ``seg_caches`` (stacked ``(repeats, ...)`` buffers) the caches
    are written in place: in decode each layer writes its token's K/V or
    its new recurrent state; in prefill each layer's K/V, latents or
    final state seed its slice as soon as they are made.  ``aux`` sums
    the MoE layers' load-balance losses (0.0 when there are none).

    ``remat`` (no caches, grad mode on) is the reference's two-level
    sqrt(R) checkpointing (``segment_scan``): with ``repeats >= 4`` and
    ``k = _sqrt_divisor(repeats) > 1``, a checkpoint around each group of
    k super-blocks and one around each super-block inside it, so the
    backward keeps R/k group boundaries and recomputes within a group;
    otherwise a checkpoint around each super-block.  The repeats' params
    are taken with :func:`unbind_repeats`.

    ``constrain`` (the launch layer's ``logits_constrainer`` hook) is
    applied to ``x`` after every block, ``constrain(x, "activation")``,
    as the reference's ``superblock_apply`` applies it."""
    per_repeat = unbind_repeats(seg_params, repeats)
    if seg_caches is None and not decode:
        if remat and torch.is_grad_enabled():
            return _segment_remat(pattern, repeats, cfg, per_repeat, x,
                                  constrain)
        x, aux = _superblocks(pattern, cfg, per_repeat, x, constrain)
        return x, None, aux
    aux = 0.0
    for r, params_r in enumerate(per_repeat):
        for j, kind in enumerate(pattern):
            cache_rj = None
            if seg_caches is not None:
                cache_rj = {n: buf[r] for n, buf in seg_caches[j].items()}
            if decode:
                x, _, a = block_apply(kind, cfg, params_r[j], x,
                                      cache=cache_rj, pos=pos, decode=True)
            else:
                x, seed, a = block_apply(kind, cfg, params_r[j], x)
                seed_block_cache(kind, cfg, cache_rj, seed, x.shape[1])
            if constrain is not None:
                x = constrain(x, "activation")
            aux = aux + a
    return x, seg_caches, aux


def _superblock(pattern, cfg, params_r, x, constrain=None):
    """One super-block (each kind of ``pattern`` once) with no caches;
    returns (x, aux)."""
    aux = 0.0
    for j, kind in enumerate(pattern):
        x, _, a = block_apply(kind, cfg, params_r[j], x)
        if constrain is not None:
            x = constrain(x, "activation")
        aux = aux + a
    return x, aux


def _superblocks(pattern, cfg, params_rs, x, constrain=None):
    aux = 0.0
    for params_r in params_rs:
        x, a = _superblock(pattern, cfg, params_r, x, constrain)
        aux = aux + a
    return x, aux


def _remat_each(pattern, cfg, params_rs, x, constrain=None):
    """The super-blocks of ``params_rs`` in order from ``x``, each under
    its own checkpoint; returns (x, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for params_r in params_rs:
        x, a = _remat(_superblock, pattern, cfg, params_r, x, constrain)
        aux = aux + a
    return x, aux


def _segment_remat(pattern, repeats: int, cfg, per_repeat, x,
                   constrain=None):
    k = _sqrt_divisor(repeats) if repeats >= 4 else 1
    if k == 1:
        x, aux = _remat_each(pattern, cfg, per_repeat, x, constrain)
        return x, None, aux
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g0 in range(0, repeats, k):
        x, a = _remat(_remat_each, pattern, cfg, per_repeat[g0:g0 + k], x,
                      constrain)
        aux = aux + a
    return x, None, aux
