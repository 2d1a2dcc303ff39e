"""Tensor parallelism of the port's blocks on DTensors: the sharded
forward that the launch layer's steps run.

The placements come from the rules (``partitioning``): a block's
column-parallel weights (``wq``, ``wi``, ``w_gate`` ...) split their
output dim over ``model`` and its row-parallel ones (``wo``, ``w_out``
...) their input dim, the Megatron layout.  Each piece of a block runs
through ``local_map`` with placements fixed here, never left to
DTensor's propagation: its inputs are redistributed to them (weights
gathered over the batch axes, FSDP's all-gather), each rank computes on
its local tensors with the plain code of ``models/``, and a row-parallel
output comes back ``Partial`` over ``model`` (summed where the residual
stream needs it).  Gradients: a weight's are ``Partial`` over the axes
that split the tokens, each rank's activations' ``Partial`` over
``model`` where the weights are split.

A piece splits over ``model`` only where whole heads (experts, channel
groups) divide the axis; otherwise it runs replicated on every model
rank, as GSPMD would reshard it.  The kernels run at ``boundary``'s
``local_map``: K1/K1b and K2 on each rank's heads, K3/K3b on its
channels.  Norms and residual adds stay DTensor arithmetic.

The xLSTM blocks (``mlstm``, ``slstm``) run replicated over ``model``
with the batch split: their recurrent states stay model-replicated in the
rules (``cache_spec``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.checkpoint.io import flatten_with_paths, unflatten_paths
from repro_torch.models import layers, mla, moe, rglru, xlstm
from repro_torch.sharding import boundary

_ATTN = ("attn", "attn_local", "attn_moe")
_MLA = ("mla", "mla_moe")
_MOE = ("attn_moe", "mla_moe")


# ----------------------------------------------------------------------
# placements
def _dt():
    import torch.distributed.tensor as dt
    return dt


_names = boundary._names
_model_size = boundary.model_size


def _model_rank(mesh) -> int:
    return mesh.get_local_rank("model") if "model" in _names(mesh) else 0


def tokens_pl(x, keep_seq: bool = True) -> tuple:
    """Placements of activations ``x`` as a token-wise piece takes them:
    its batch split (dim 0) and, with ``keep_seq``, its sequence split
    (dim 1); every other mesh axis replicated."""
    dt = _dt()
    keep = (0, 1) if keep_seq else (0,)
    return tuple(p if isinstance(p, dt.Shard) and p.dim in keep
                 else dt.Replicate() for p in x.placements)


def splits(mesh, x_pl, *counts) -> bool:
    """True where the ``model`` axis is free in ``x_pl`` and divides every
    count (heads, KV heads, experts, channels)."""
    names = _names(mesh)
    if "model" not in names:
        return False
    if not isinstance(x_pl[names.index("model")], _dt().Replicate):
        return False
    m = _model_size(mesh)
    return all(c % m == 0 for c in counts)


def _with_model(mesh, pl, p) -> tuple:
    names = _names(mesh)
    out = list(pl)
    if "model" in names:
        out[names.index("model")] = p
    return tuple(out)


def _w_pl(mesh, x_pl, split: bool, dim: Optional[int]):
    """(placements, gradient placements) of a weight: split on ``dim``
    over ``model`` when ``split``, else replicated; its gradient is
    partial over the axes that split ``x_pl``'s tokens."""
    dt = _dt()
    names = _names(mesh)
    pl, grad = [], []
    for i, name in enumerate(names):
        if name == "model" and split and dim is not None:
            pl.append(dt.Shard(dim))
            grad.append(dt.Shard(dim))
        elif isinstance(x_pl[i], dt.Shard):
            pl.append(dt.Replicate())
            grad.append(dt.Partial())
        else:
            pl.append(dt.Replicate())
            grad.append(dt.Replicate())
    return tuple(pl), tuple(grad)


def _partial_if(mesh, pl, split: bool) -> tuple:
    return _with_model(mesh, pl, _dt().Partial()) if split else tuple(pl)


def _shard_if(mesh, pl, split: bool, dim: int) -> tuple:
    return _with_model(mesh, pl, _dt().Shard(dim)) if split else tuple(pl)


def _call(fn, mesh, args, in_pl, grad_pl, out_pl):
    from torch.distributed.tensor.experimental import local_map
    args = [boundary.as_dtensor(a, mesh) for a in args]
    grad_pl = [p if g is None else g for p, g in zip(in_pl, grad_pl)]
    single = isinstance(out_pl[0], _dt().Placement)

    def run(*a):
        out = fn(*a)
        return (out,) if single else tuple(out)

    out = local_map(run, out_placements=(out_pl,) if single else out_pl,
                    in_placements=tuple(in_pl),
                    in_grad_placements=tuple(grad_pl), device_mesh=mesh,
                    redistribute_inputs=True)(*args)
    return out[0] if single else out


def _params(mesh, p, x_pl, split: bool, split_dims: dict):
    """Flattened params with their placements: ``split_dims`` maps a leaf
    path to the dim it splits over ``model`` (others replicate)."""
    flat = flatten_with_paths(p)
    keys = list(flat)
    pls, grads = [], []
    for k in keys:
        pl, grad = _w_pl(mesh, x_pl, split, split_dims.get(k))
        pls.append(pl)
        grads.append(grad)
    return keys, [flat[k] for k in keys], pls, grads


def _local_cfg(cfg, m: int, kind: str):
    """The config a rank's piece computes with: its own heads (and, for
    the RG-LRU, its channels); the head dim is kept."""
    kw = dict(n_heads=cfg.n_heads // m, head_dim=cfg.resolved_head_dim)
    if kind in _ATTN:
        kw["n_kv_heads"] = cfg.n_kv_heads // m
    if kind == "rglru":
        r = cfg.rglru.d_rnn or cfg.d_model
        kw["rglru"] = dataclasses.replace(cfg.rglru, d_rnn=r // m)
    return dataclasses.replace(cfg, **kw)


# ----------------------------------------------------------------------
# embedding and logits
def embed(tokens, table):
    """``F.embedding(tokens, table)`` with the table's vocab split over
    ``model`` where it divides: each rank looks up its own rows and the
    ranks' outputs sum."""
    mesh = table.device_mesh
    t_pl = tokens_pl(tokens)
    V = table.shape[0]
    split = splits(mesh, t_pl, V)
    w_pl, w_grad = _w_pl(mesh, t_pl, split, 0)
    v0 = _model_rank(mesh) * (V // _model_size(mesh)) if split else 0

    def fn(tok, w):
        if not split:
            return F.embedding(tok, w)
        ids = tok - v0
        valid = (ids >= 0) & (ids < w.shape[0])
        out = F.embedding(torch.where(valid, ids, 0), w)
        return out.masked_fill(~valid[..., None], 0)

    return _call(fn, mesh, (tokens, table), (t_pl, w_pl), (None, w_grad),
                 _partial_if(mesh, t_pl, split))


def logits(x, table, transposed: bool):
    """``x @ table.T`` (a tied embedding, (V, d)) or ``x @ table`` ((d,
    V)) with the vocab split over ``model`` where it divides."""
    mesh = table.device_mesh
    x_pl = tokens_pl(x, keep_seq=False)
    V = table.shape[0] if transposed else table.shape[1]
    split = splits(mesh, x_pl, V)
    w_pl, w_grad = _w_pl(mesh, x_pl, split, 0 if transposed else 1)

    def fn(x, w):
        return x @ (w.T if transposed else w).to(x.dtype)

    return _call(fn, mesh, (x, table), (x_pl, w_pl),
                 (_partial_if(mesh, x_pl, split), w_grad),
                 _shard_if(mesh, x_pl, split, 2))


def xent(logits, targets):
    """``sum(logsumexp(logits) - logits[target])`` of float32 logits whose
    vocab may be split over ``model``: each rank picks the targets in its
    own rows and the picks sum."""
    mesh = logits.device_mesh
    dt = _dt()
    names = _names(mesh)
    split = "model" in names and isinstance(
        logits.placements[names.index("model")], dt.Shard)
    V_l = logits.to_local().shape[-1]
    v0 = _model_rank(mesh) * V_l if split else 0
    t_pl = tuple(p if isinstance(p, dt.Shard) and p.dim < 2 else
                 dt.Replicate() for p in logits.placements)

    def gold(lg, t):
        ids = t.long() - v0
        valid = (ids >= 0) & (ids < lg.shape[-1])
        g = torch.gather(lg, -1, torch.where(valid, ids, 0)[..., None])[..., 0]
        return g.masked_fill(~valid, 0)

    picked = _call(gold, mesh, (logits, targets), (logits.placements, t_pl),
                   (None, None), _partial_if(mesh, t_pl, split))
    return torch.sum(torch.logsumexp(logits, dim=-1) - picked)


# ----------------------------------------------------------------------
# blocks
def mixer_apply(kind, cfg, p, h, *, cache=None, pos=None, decode=False):
    """A block's mixer on DTensors: (out, new_cache) as
    ``transformer.block_apply`` takes them; a recurrent decode writes its
    states into the cache's buffers, in place."""
    if kind in _MLA:
        if decode:
            return _mla_decode(p, h, cfg, cache, pos)
        return _mla_prefill(p, h, cfg)
    if kind in _ATTN:
        if decode:
            return _attention_decode(p, h, cfg, cache, pos,
                                     local=kind == "attn_local")
        return _attention_prefill(p, h, cfg, local=kind == "attn_local")
    if kind == "rglru":
        out, new_cache = _rglru(p, h, cfg, cache=cache if decode else None)
    else:
        out, new_cache = _replicated_mixer(kind, p, h, cfg,
                                           cache=cache if decode else None)
    if decode:
        for name, val in new_cache.items():
            boundary.assign(cache[name], val)
        new_cache = cache
    return out, new_cache


def ffn_apply(kind, cfg, p, h):
    """A block's FFN on DTensors: (out, aux)."""
    if kind in _MOE:
        return _moe(p, h, cfg)
    return mlp(p, h, cfg.activation), 0.0


def mlp(p, x, activation: str):
    """The dense MLP: ``wi``/``wg`` column-parallel, ``wo`` row-parallel."""
    mesh = x.device_mesh
    x_pl = tokens_pl(x)
    split = splits(mesh, x_pl, p["wo"].shape[0])
    keys, leaves, pls, grads = _params(mesh, p, x_pl, split,
                                       {"wi": 1, "wg": 1, "wo": 0})

    def fn(x, *w):
        return layers.mlp_apply(dict(zip(keys, w)), x, activation)

    return _call(fn, mesh, (x, *leaves), (x_pl, *pls),
                 (_partial_if(mesh, x_pl, split), *grads),
                 _partial_if(mesh, x_pl, split))


_ATTN_SPLIT = {"wq": 1, "wk": 1, "wv": 1, "bq": 0, "bk": 0, "bv": 0}


def _attn_split(cfg, mesh, x_pl) -> bool:
    return splits(mesh, x_pl, cfg.n_heads, cfg.n_kv_heads)


def _pos_pl(mesh, x_pl, decode: bool) -> tuple:
    """Placements of the positions: a decode step's (B, 1) rows follow the
    batch split, a prefill's (1, S) range is replicated."""
    return boundary.batch_only(x_pl) if decode else _dt_replicated(mesh)


def _qkv(p, x, cfg, positions, split: bool, x_pl, decode: bool = False):
    """q, k, v (B, S, H, hd) after RoPE, heads split over ``model`` when
    ``split``."""
    mesh = x.device_mesh
    proj = {k: v for k, v in p.items() if k != "wo"}
    keys, leaves, pls, grads = _params(mesh, proj, x_pl, split, _ATTN_SPLIT)
    lcfg = _local_cfg(cfg, _model_size(mesh), "attn") if split else cfg
    qkv_pl = _shard_if(mesh, x_pl, split, 2)

    def fn(x, positions, *w):
        return layers.attention_qkv(dict(zip(keys, w)), x, lcfg, positions)

    return _call(fn, mesh, (x, positions, *leaves),
                 (x_pl, _pos_pl(mesh, x_pl, decode), *pls),
                 (_partial_if(mesh, x_pl, split), None, *grads),
                 (qkv_pl, qkv_pl, qkv_pl))


def _dt_replicated(mesh) -> tuple:
    return (_dt().Replicate(),) * mesh.ndim


def _row_parallel(o, w, x_pl, split: bool):
    """``o @ w`` with ``w`` split on its input dim when ``split``: each
    rank's product is a part of the sum."""
    mesh = o.device_mesh
    o_pl = _shard_if(mesh, x_pl, split, 2)
    w_pl, w_grad = _w_pl(mesh, x_pl, split, 0)
    return _call(lambda o, w: o @ w, mesh, (o, w), (o_pl, w_pl),
                 (o_pl, w_grad), _partial_if(mesh, x_pl, split))


def _attention_prefill(p, x, cfg, *, local: bool):
    mesh = x.device_mesh
    B, S, _ = x.shape
    x_pl = tokens_pl(x, keep_seq=False)          # attention needs every key
    split = _attn_split(cfg, mesh, x_pl)
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv(p, x, cfg, positions, split, x_pl)
    window = cfg.window_size if local else None
    out = boundary.flash_attention(q, k, v, causal=True, window=window,
                                   softcap=cfg.attn_softcap,
                                   scale=cfg.query_scale, q_chunk=cfg.q_chunk)
    out = _row_parallel(out.reshape(B, S, -1), p["wo"], x_pl, split)
    return out, (k, v)


def _attention_decode(p, x, cfg, cache, pos, *, local: bool):
    mesh = x.device_mesh
    B = x.shape[0]
    x_pl = tokens_pl(x, keep_seq=False)
    split = _attn_split(cfg, mesh, x_pl)
    pos = boundary.as_dtensor(pos, mesh)
    q, k, v = _qkv(p, x, cfg, pos[:, None], split, x_pl, decode=True)
    window = cfg.window_size if local else None
    slot = layers.decode_slot(pos, window, cache["k"].shape[1])
    boundary.write_rows(cache["k"], slot, k[:, 0])
    boundary.write_rows(cache["v"], slot, v[:, 0])
    out = boundary.decode_attention(q, cache["k"], cache["v"], pos,
                                    window=window, softcap=cfg.attn_softcap,
                                    scale=cfg.query_scale)
    out = _row_parallel(out.reshape(B, 1, -1), p["wo"], x_pl, split)
    return out, cache


# ----------------------------------------------------------------------
# MLA
_MLA_SPLIT = {"wq": 1, "wq_b": 1}


def _mla_q(p, x, cfg, positions, split, x_pl, decode=False):
    mesh = x.device_mesh
    sub = {k: p[k] for k in ("wq", "wq_a", "q_norm", "wq_b") if k in p}
    keys, leaves, pls, grads = _params(mesh, sub, x_pl, split, _MLA_SPLIT)
    lcfg = _local_cfg(cfg, _model_size(mesh), "mla") if split else cfg
    q_pl = _shard_if(mesh, x_pl, split, 2)

    def fn(x, positions, *w):
        return mla._mla_q(unflatten_paths(dict(zip(keys, w))), x, lcfg,
                          positions)

    return _call(fn, mesh, (x, positions, *leaves),
                 (x_pl, _pos_pl(mesh, x_pl, decode), *pls),
                 (_partial_if(mesh, x_pl, split), None, *grads),
                 (q_pl, q_pl))


def _mla_latents(p, x, cfg, positions, x_pl, decode=False):
    """The latents, computed alike on every model rank."""
    mesh = x.device_mesh
    sub = {k: p[k] for k in ("wkv_a", "ckv_norm")}
    keys, leaves, pls, grads = _params(mesh, sub, x_pl, False, {})

    def fn(x, positions, *w):
        return mla._mla_latents(unflatten_paths(dict(zip(keys, w))), x, cfg,
                                positions)

    return _call(fn, mesh, (x, positions, *leaves),
                 (x_pl, _pos_pl(mesh, x_pl, decode), *pls),
                 (x_pl, None, *grads), (x_pl, x_pl))


def _mla_attend(p, qn, qr, ckv, kr, pos, cfg, split, x_pl, decode: bool):
    """Expand the latents into each rank's heads and attend (K1 in
    prefill, K2 in a naive decode; the absorbed decode is plain)."""
    mesh = qn.device_mesh
    m = cfg.mla
    lcfg = _local_cfg(cfg, _model_size(mesh), "mla") if split else cfg
    wkv_pl, wkv_grad = _w_pl(mesh, x_pl, split, 1)
    h_pl = _shard_if(mesh, x_pl, split, 2)
    lat_pl = x_pl

    def expand(ckv, w):
        return mla._expand({"wkv_b": w}, ckv, lcfg)

    if decode and m.decode_mode == "absorbed":
        def absorbed(qn, qr, ckv, kr, pos, w):
            return mla.absorbed_attend(qn, qr, ckv, kr, pos, w, lcfg)
        rows = boundary.batch_only(lat_pl)
        return _call(absorbed, mesh, (qn, qr, ckv, kr, pos, p["wkv_b"]),
                     (h_pl, h_pl, lat_pl, lat_pl, rows, wkv_pl),
                     (h_pl, h_pl, None, None, None, wkv_grad), h_pl)
    kn, v = _call(expand, mesh, (ckv, p["wkv_b"]), (lat_pl, wkv_pl),
                  (_partial_if(mesh, lat_pl, split), wkv_grad), (h_pl, h_pl))
    k = _call(mla._keys, mesh, (kn, kr), (h_pl, lat_pl),
              (h_pl, _partial_if(mesh, lat_pl, split)), h_pl)
    q = torch.cat([qn, qr], dim=-1)
    if decode:
        return boundary.decode_attention(q, k, v, pos, scale=mla._scale(cfg))
    return boundary.flash_attention(q, k, v, causal=True,
                                    scale=mla._scale(cfg),
                                    q_chunk=cfg.q_chunk)


def _mla_prefill(p, x, cfg):
    mesh = x.device_mesh
    B, S, _ = x.shape
    x_pl = tokens_pl(x, keep_seq=False)
    split = splits(mesh, x_pl, cfg.n_heads)
    positions = torch.arange(S, device=x.device)[None, :]
    qn, qr = _mla_q(p, x, cfg, positions, split, x_pl)
    ckv, kr = _mla_latents(p, x, cfg, positions, x_pl)
    out = _mla_attend(p, qn, qr, ckv, kr, None, cfg, split, x_pl, False)
    out = _row_parallel(out.reshape(B, S, -1), p["wo"], x_pl, split)
    return out, (ckv, kr)


def _mla_decode(p, x, cfg, cache, pos):
    mesh = x.device_mesh
    B = x.shape[0]
    x_pl = tokens_pl(x, keep_seq=False)
    split = splits(mesh, x_pl, cfg.n_heads)
    pos = boundary.as_dtensor(pos, mesh)
    qn, qr = _mla_q(p, x, cfg, pos[:, None], split, x_pl, decode=True)
    ckv_t, kr_t = _mla_latents(p, x, cfg, pos[:, None], x_pl, decode=True)
    boundary.write_rows(cache["ckv"], pos, ckv_t[:, 0])
    boundary.write_rows(cache["kr"], pos, kr_t[:, 0])
    out = _mla_attend(p, qn, qr, cache["ckv"], cache["kr"], pos, cfg, split,
                      x_pl, True)
    out = _row_parallel(out.reshape(B, 1, -1), p["wo"], x_pl, split)
    return out, cache


# ----------------------------------------------------------------------
# MoE
def _moe(p, x, cfg):
    """Routing on every model rank (its load-balance statistics summed
    over the batch split), then each rank's own experts: expert
    parallelism over ``model``, the experts' outputs summing to the
    whole.  The batch stays split only where each rank holds whole
    dispatch groups, so capacity and drops are the unsharded run's."""
    e = cfg.moe
    mesh = x.device_mesh
    B, S, d = x.shape
    T = B * S
    gs = min(e.group_size, T)
    x_pl = tokens_pl(x, keep_seq=False)
    dt = _dt()
    nb = 1
    for pl, size in zip(x_pl, mesh.shape):
        if isinstance(pl, dt.Shard):
            nb *= size
    if (T // nb) % gs:
        x_pl = _dt_replicated(mesh)
    router_pl, router_grad = _w_pl(mesh, x_pl, False, None)

    def route(x, router):
        gates, probs, idx, _ = moe._route({"router": router},
                                          x.reshape(-1, x.shape[-1]), e)
        counts = moe._one_hot(idx, e.n_experts, torch.float32).sum(1)
        return gates, counts, probs, idx

    t_pl = x_pl                   # (T, ...): the tokens' split on dim 0
    gates, counts, probs, idx = _call(
        route, mesh, (x, p["router"]), (x_pl, router_pl),
        (x_pl, router_grad), (t_pl,) * 4)
    aux = e.n_experts * torch.sum(
        gates.mean(dim=0) * counts.sum(dim=0) / (T * e.top_k)) \
        * e.load_balance_coef

    split = splits(mesh, x_pl, e.n_experts)
    experts = {k: p[k] for k in ("wi_e", "wg_e", "wo_e") if k in p}
    keys, leaves, pls, grads = _params(mesh, experts, x_pl, split,
                                       {"wi_e": 0, "wg_e": 0, "wo_e": 0})
    e0 = _model_rank(mesh) * (e.n_experts // _model_size(mesh)) \
        if split else 0

    def dispatch(x, probs, idx, *w):
        x2d = x.reshape(-1, x.shape[-1])
        out2d = moe.routed(dict(zip(keys, w)), x2d, probs, idx, cfg, gs,
                           e0)[0]
        return out2d.reshape(x.shape)

    out = _call(dispatch, mesh, (x, probs, idx, *leaves),
                (x_pl, t_pl, t_pl, *pls),
                (_partial_if(mesh, x_pl, split),
                 _partial_if(mesh, t_pl, split), None, *grads),
                _partial_if(mesh, x_pl, split))
    if e.n_shared:
        out = out + mlp(p["shared"], x, cfg.activation)
    return out, aux


# ----------------------------------------------------------------------
# RG-LRU
_RG_SPLIT = {"w_gate": 1, "w_rec": 1, "conv_w": 1, "conv_b": 0,
             "lru/lambda": 0, "lru/w_a": 0, "lru/w_x": 0, "lru/b_a": 0,
             "lru/b_x": 0}


def _rglru(p, x, cfg, cache=None):
    """Projections, the causal conv and the gates on each rank's channel
    groups (whole heads of the block-diagonal gates), the scan through
    K3 on its channels, then ``w_out`` row-parallel."""
    mesh = x.device_mesh
    r = cfg.rglru.d_rnn or cfg.d_model
    nh = cfg.n_heads
    x_pl = tokens_pl(x, keep_seq=False)
    split = splits(mesh, x_pl, nh, r)
    lcfg = _local_cfg(cfg, _model_size(mesh), "rglru") if split else cfg
    sub = {k: v for k, v in p.items() if k != "w_out"}
    keys, leaves, pls, grads = _params(mesh, sub, x_pl, split, _RG_SPLIT)
    ch_pl = _shard_if(mesh, x_pl, split, 2)
    st_pl = boundary.drop_dim(ch_pl, 1)
    x_grad = _partial_if(mesh, x_pl, split)

    def weights(w):
        return unflatten_paths(dict(zip(keys, w)))

    if cache is None:
        def pre(x, *w):
            q = weights(w)
            gate, rec, conv = rglru.block_pre(q, x)
            a, b = rglru._gates(q["lru"], rec, lcfg.n_heads, lcfg.rglru.c)
            return gate, a, b, conv

        gate, a, b, conv = _call(pre, mesh, (x, *leaves), (x_pl, *pls),
                                 (x_grad, *grads),
                                 (ch_pl, ch_pl, ch_pl, ch_pl))
        y, h_last = boundary.rglru_scan(a, b)
        new_cache = {"h": h_last, "conv": conv}
    else:
        def step(x, h, conv, *w):
            gate, y, new = rglru.block_step(weights(w), x, lcfg,
                                            {"h": h, "conv": conv})
            return gate, y, new["h"], new["conv"]

        gate, y, h_new, conv = _call(
            step, mesh, (x, cache["h"], cache["conv"], *leaves),
            (x_pl, st_pl, ch_pl, *pls), (x_grad, None, None, *grads),
            (ch_pl, ch_pl, st_pl, ch_pl))
        new_cache = {"h": h_new, "conv": conv}
    w_pl, w_grad = _w_pl(mesh, x_pl, split, 0)

    def post(gate, y, w):
        return rglru.block_post({"w_out": w}, gate, y)

    out = _call(post, mesh, (gate, y, p["w_out"]), (ch_pl, ch_pl, w_pl),
                (ch_pl, ch_pl, w_grad), _partial_if(mesh, x_pl, split))
    return out, new_cache


# ----------------------------------------------------------------------
# xLSTM
def _replicated_mixer(kind, p, x, cfg, cache=None):
    """An xLSTM mixer with its weights gathered on every rank and the
    batch split: (out, its final or new states)."""
    mesh = x.device_mesh
    x_pl = tokens_pl(x, keep_seq=False)
    keys, leaves, pls, grads = _params(mesh, p, x_pl, False, {})
    apply = xlstm.mlstm_block_apply if kind == "mlstm" else \
        xlstm.slstm_block_apply
    names = sorted(xlstm.mlstm_cache_specs(cfg, 1) if kind == "mlstm"
                   else xlstm.slstm_cache_specs(cfg, 1))
    rows = boundary.batch_only(x_pl)
    st_pl = tuple(rows)
    c_in = [] if cache is None else [cache[n] for n in names]

    def fn(x, *rest):
        c = None if cache is None else dict(zip(names, rest[:len(names)]))
        w = rest[len(c_in):]
        out, new = apply(unflatten_paths(dict(zip(keys, w))), x, cfg,
                         cache=c)
        return (out,) + tuple(new[n] for n in names)

    res = _call(fn, mesh, (x, *c_in, *leaves),
                (x_pl, *([st_pl] * len(c_in)), *pls),
                (x_pl, *([None] * len(c_in)), *grads),
                (x_pl,) + (st_pl,) * len(names))
    return res[0], dict(zip(names, res[1:]))



def replicated(fn, p, acts, n_out: int = 1):
    """``fn(p, *acts)`` with the params ``p`` gathered on every rank and
    each activation split on its batch dim 0 where the batch axes divide
    it; ``fn`` returns ``n_out`` tensors whose dim 0 is the batch (the
    dry run's sLSTM units)."""
    mesh = next(a for a in acts if boundary.sharded(a)).device_mesh
    rows = boundary.placements(mesh, acts[0].shape[0], None, ())
    keys, leaves, pls, grads = _params(mesh, p, rows, False, {})

    def run(*a):
        w = unflatten_paths(dict(zip(keys, a[len(acts):])))
        return fn(w, *a[:len(acts)])

    return _call(run, mesh, (*acts, *leaves), (*([rows] * len(acts)), *pls),
                 (*([rows] * len(acts)), *grads),
                 rows if n_out == 1 else (rows,) * n_out)
