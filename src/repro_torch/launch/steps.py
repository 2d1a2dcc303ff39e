"""Step builders of the port (``repro/launch/steps.py``): the sharded
train, prefill and decode steps, and the per-kind roofline "units".

Each ``build_*_step`` returns ``(step, specs, donate, M)``: a plain
function of DTensor inputs, a ``TensorSpec`` tree whose leaves carry
their ``NamedSharding`` (``sharding.distribute_specs`` makes the inputs
from it, each rank allocating only its shard), the donated argument
positions (the reference's ``donate_argnums``; eager PyTorch updates the
decode cache in place and the train step returns new params), and the
microbatch count.  The step runs under ``implicit_replication``: a plain
tensor the model makes along the way (a position range, a scalar) is
replicated.

The reference also needs units because XLA's cost analysis counts a
while body once; PyTorch runs every op eagerly, so the dry run's
full-program counts are exact and the units are a per-kind breakdown
that adds up to them.  The one exception is training: remat recomputes
each block's forward in the backward, which the units (one block's
forward and backward, no remat) do not count; the dry run's ledger
books the recomputation apart (``ledger.on_fake_model``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.configs.base import ATTENTION_KINDS, InputShape, ModelConfig
from repro_torch.models import transformer
from repro_torch.models.layers import ParamFactory
from repro_torch.models.model import Model
from repro_torch.sharding import (NamedSharding, cache_leaf_spec,
                                  logits_constrainer, shard_cache_for_model,
                                  shard_params, token_spec, with_sharding)
from repro_torch.sharding.partitioning import axis_sizes, distribute_specs
from repro_torch.specs import TensorSpec
from repro_torch.train import OptimizerConfig, make_train_step
from repro_torch.train.optimizer import OptState, adamw_update

# microbatch counts for train_4k, sized so remat boundaries fit HBM
TRAIN_MICROBATCHES = {
    "pixtral-12b": 8, "musicgen-medium": 4, "gemma2-27b": 8,
    "deepseek-v2-lite-16b": 4, "phi3-medium-14b": 8, "nemotron-4-15b": 8,
    "granite-moe-1b-a400m": 2, "qwen2-0.5b": 2, "recurrentgemma-2b": 4,
    "xlstm-350m": 2,
}


@dataclass
class Unit:
    name: str
    fn: Callable
    specs: tuple
    multiplier: float            # FLOP multiplier (trip count)
    coll_multiplier: Optional[float] = None   # collective multiplier
    # train-block pairing: "<name>__act" units count per-microbatch
    # collectives; the full-vjp unit minus the act unit gives the weight-grad
    # reduction, counted once per step.


def resolve_serve_strategy(cfg: ModelConfig) -> str:
    """"auto": dp_cp (replicated weights, batch x sequence parallelism) for
    pure-attention archs whose replicated weights fit comfortably per chip;
    tensor-parallel otherwise."""
    if cfg.serve_strategy != "auto":
        return cfg.serve_strategy
    pure_attn = all(k in ATTENTION_KINDS for k in cfg.layer_kinds)
    small = cfg.param_count() * 2 <= 2.5e9
    return "dp_cp" if (pure_attn and small and cfg.moe is None) else "tp"


def _unit_cfg(cfg: ModelConfig, S: int) -> ModelConfig:
    """A unit's config: no remat, attention unchunked.  The reference
    also unchunks the mLSTM to keep its units scan-free; eager units
    need no such thing, and the chunkwise mLSTM's products depend on its
    chunk, so a unit keeps the full program's chunk and adds up to it."""
    return dataclasses.replace(cfg, q_chunk=max(S, 1), kv_chunk=max(S, 1),
                               remat=False)


def _dryrun_cfg(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Full-program config tweaks for lowering feasibility at scale."""
    kw: dict = {}
    if cfg.xlstm and shape.seq_len >= 32768:
        # keep the unrolled chunk count bounded for HLO size
        kw["xlstm"] = dataclasses.replace(cfg.xlstm, chunk_size=2048)
    elif cfg.xlstm and shape.mode == "train":
        kw["xlstm"] = dataclasses.replace(cfg.xlstm, chunk_size=256)
    if shape.seq_len >= 32768:
        kw["q_chunk"], kw["kv_chunk"] = 1024, 2048
    return dataclasses.replace(cfg, **kw) if kw else cfg


def _sharded(fn: Callable) -> Callable:
    """``fn`` run under ``implicit_replication``."""
    def step(*args):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with implicit_replication():
            return fn(*args)
    return step


def _seq_tokens(mesh, B: int, S: int, strategy: str) -> tuple:
    tok = token_spec(mesh, B)
    if strategy == "dp_cp" and S > 1 and S % axis_sizes(mesh)["model"] == 0:
        tok = (tok[0] if len(tok) else None, "model")
    return tok


def _batch_specs(model: Model, shape, mesh, strategy: str = "tp"):
    """Token batch specs with shardings attached."""
    cfg = model.cfg
    B, S = shape.global_batch, shape.seq_len
    tok = _seq_tokens(mesh, B, S, strategy)
    out = {"tokens": TensorSpec((B, S), torch.int32,
                                sharding=NamedSharding(mesh, tok))}
    if shape.mode == "train":
        out["targets"] = TensorSpec((B, S), torch.int32,
                                    sharding=NamedSharding(mesh, tok))
    if cfg.frontend != "none":
        out["frontend_embeds"] = TensorSpec(
            (B, S, cfg.d_model), getattr(torch, cfg.dtype),
            sharding=NamedSharding(mesh, (tok[0], None, None)))
        out["frontend_mask"] = TensorSpec(
            (B, S), torch.bool, sharding=NamedSharding(mesh, tok))
    return out


def _params_specs(model: Model, mesh, mode: str):
    shapes = model.param_specs()
    return with_sharding(shapes, shard_params(shapes, mesh, mode))


def _f32(specs):
    return _map_specs(lambda s: dataclasses.replace(s, dtype=torch.float32),
                      specs)


def _map_specs(fn, specs):
    if isinstance(specs, TensorSpec):
        return fn(specs)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, OptState):
        return OptState(*(_map_specs(fn, v) for v in specs))
    return tuple(_map_specs(fn, v) for v in specs)


def _cache_specs(model: Model, B: int, S: int, mesh, strategy: str):
    specs = model.cache_specs(B, S)
    return with_sharding(specs, shard_cache_for_model(model.cfg, specs, mesh,
                                                      B, strategy))


# ======================================================================
# FULL PROGRAMS
def build_train_step(model: Model, shape: InputShape, mesh,
                     microbatches: Optional[int] = None):
    cfg = model.cfg
    model.constrain = logits_constrainer(mesh)
    M = microbatches or TRAIN_MICROBATCHES.get(cfg.name, 1)
    step = make_train_step(model, OptimizerConfig(), num_microbatches=M,
                           constrain=model.constrain,
                           seq_chunk=min(512, shape.seq_len))
    params = _params_specs(model, mesh, "train")
    mu = _f32(params)
    opt_state = OptState(
        step=TensorSpec((), torch.int32, sharding=NamedSharding(mesh, ())),
        mu=mu, nu=mu)
    batch = _batch_specs(model, shape, mesh)
    return _sharded(step), (params, opt_state, batch), (0, 1), M


def build_prefill_step(model: Model, shape: InputShape, mesh,
                       max_len: Optional[int] = None):
    """``max_len`` sizes the decode cache the prefill seeds (default: the
    prompt, as the reference's step does); a longer one is what
    ``build_decode_step`` at that length continues from."""
    cfg = model.cfg
    strategy = resolve_serve_strategy(cfg)
    model.constrain = logits_constrainer(mesh, strategy)
    B, S = shape.global_batch, shape.seq_len
    cache_specs = _cache_specs(model, B, max_len or S, mesh, strategy)

    def step(params, batch):
        cache = distribute_specs(cache_specs, batch["tokens"].device)
        return model.prefill(
            params, batch["tokens"], cache=cache,
            frontend_embeds=batch.get("frontend_embeds"),
            frontend_mask=batch.get("frontend_mask"))

    params = _params_specs(model, mesh,
                           "serve_dp" if strategy == "dp_cp" else "serve")
    batch = _batch_specs(model, shape, mesh, strategy=strategy)
    return _sharded(step), (params, batch), (), 1


def build_decode_step(model: Model, shape: InputShape, mesh):
    cfg = model.cfg
    strategy = resolve_serve_strategy(cfg)
    model.constrain = logits_constrainer(mesh, strategy)
    B, S = shape.global_batch, shape.seq_len

    def step(params, cache, token, pos):
        return model.decode_step(params, cache, token, pos)

    params = _params_specs(model, mesh,
                           "serve_dp" if strategy == "dp_cp" else "serve")
    cache = _cache_specs(model, B, S, mesh, strategy)
    tok = token_spec(mesh, B)
    token = TensorSpec((B, 1), torch.int32,
                       sharding=NamedSharding(mesh, tok))
    pos = TensorSpec((B,), torch.int32,
                     sharding=NamedSharding(mesh, (tok[0],)))
    return _sharded(step), (params, cache, token, pos), (1,), 1


# ======================================================================
# UNITS
def _block_param_specs(kind, cfg, mesh, mode):
    shapes = transformer.init_block(ParamFactory(), kind, cfg)
    return with_sharding(shapes, shard_params(shapes, mesh, mode))


def _x_specs(B, S, cfg, mesh, strategy: str = "tp"):
    tok = token_spec(mesh, B)
    seq_ax = None
    if strategy == "dp_cp" and S > 1 and S % axis_sizes(mesh)["model"] == 0:
        seq_ax = "model"
    return TensorSpec((B, S, cfg.d_model), getattr(torch, cfg.dtype),
                      sharding=NamedSharding(mesh, (tok[0], seq_ax, None)))


def _kind_counts(cfg) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for k in cfg.layer_kinds:
        counts[k] = counts.get(k, 0) + 1
    return counts


def _grads(block_out, inputs):
    """Gradients of a block's ``(x, cache, aux)`` with respect to
    ``inputs``: x with a ones cotangent in its type (as the reference's
    vjp takes), and a MoE block's load-balance loss with 1, as the train
    step's loss adds it."""
    out, _, aux = block_out
    outs, cots = [out], [torch.ones_like(out)]
    if torch.is_tensor(aux) and aux.requires_grad:
        outs.append(aux)
        cots.append(torch.ones_like(aux))
    return torch.autograd.grad(outs, inputs, cots, allow_unused=True)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [v for t in tree for v in _leaves(t)]
    return [tree]


def _needs_grad(tree):
    if isinstance(tree, dict):
        return {k: _needs_grad(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_needs_grad(v) for v in tree)
    return tree.detach().requires_grad_(
        tree.dtype.is_floating_point)


def _head_specs(model: Model, mesh, mode: str):
    shapes = {k: v for k, v in model.param_specs().items()
              if k in ("embed", "unembed", "final_norm")}
    return with_sharding(shapes, shard_params(shapes, mesh, mode))


def build_units(model: Model, shape: InputShape, mesh,
                microbatches: Optional[int] = None) -> List[Unit]:
    cfg = model.cfg
    B, S = shape.global_batch, shape.seq_len
    units: List[Unit] = []
    counts = _kind_counts(cfg)
    strategy = resolve_serve_strategy(cfg) if shape.mode != "train" else "tp"
    mode = "train" if shape.mode == "train" else (
        "serve_dp" if strategy == "dp_cp" else "serve")

    if shape.mode == "train":
        M = microbatches or TRAIN_MICROBATCHES.get(cfg.name, 1)
        B_mb = B // M
        ucfg = _unit_cfg(cfg, S)
        umodel = Model(ucfg, device="cpu", constrain=logits_constrainer(mesh))
        for kind, n in counts.items():
            if kind == "slstm":
                units.extend(_slstm_units(ucfg, mesh, B_mb, S, n * M,
                                          grads=True))
                continue

            def block_grads(p, x, kind=kind, ucfg=ucfg):
                p, x = _needs_grad(p), _needs_grad(x)
                with torch.enable_grad():
                    out = transformer.block_apply(kind, ucfg, p, x)
                    return _grads(out, _leaves(p) + [x])

            def block_dx_only(p, x, kind=kind, ucfg=ucfg):
                x = _needs_grad(x)
                with torch.enable_grad():
                    out = transformer.block_apply(kind, ucfg, p, x)
                    return _grads(out, [x])

            p_specs = _block_param_specs(kind, ucfg, mesh, mode)
            x_specs = _x_specs(B_mb, S, ucfg, mesh)
            units.append(Unit(f"block_{kind}", block_grads,
                              (p_specs, x_specs), n * M, coll_multiplier=0.0))
            units.append(Unit(f"block_{kind}__act", block_dx_only,
                              (p_specs, x_specs), 0.0, coll_multiplier=n * M))

        Sc = min(512, S)               # loss works on seq chunks of <=512

        def lm_loss(p, x, targets):
            return umodel.chunk_xent(p, x, targets,
                                     umodel.constrain) / (B * S)

        def lm_grads(p, x, targets):
            p, x = _needs_grad(p), _needs_grad(x)
            with torch.enable_grad():
                return torch.autograd.grad(lm_loss(p, x, targets),
                                           _leaves(p) + [x],
                                           allow_unused=True)

        def lm_dx(p, x, targets):
            x = _needs_grad(x)
            with torch.enable_grad():
                return torch.autograd.grad(lm_loss(p, x, targets), [x])

        def embed_grads(p, tokens):
            p = _needs_grad(p)
            with torch.enable_grad():
                out = torch.sum(umodel._embed(p, tokens).float())
                return torch.autograd.grad(out, _leaves(p),
                                           allow_unused=True)

        head = _head_specs(model, mesh, mode)
        tok = token_spec(mesh, B_mb)
        tok_c = TensorSpec((B_mb, Sc), torch.int32,
                           sharding=NamedSharding(mesh, tok))
        x_c = _x_specs(B_mb, Sc, cfg, mesh)
        units.append(Unit("lm_head_loss", lm_grads, (head, x_c, tok_c),
                          M * (S // Sc), coll_multiplier=0.0))
        units.append(Unit("lm_head_loss__act", lm_dx, (head, x_c, tok_c),
                          0.0, coll_multiplier=M * (S // Sc)))
        # the embed table's gradient, once per microbatch
        units.append(Unit(
            "embed", embed_grads,
            (head, TensorSpec((B_mb, S), torch.int32,
                              sharding=NamedSharding(mesh, tok))), M,
            coll_multiplier=1.0))

        # optimizer update (once per step)
        params = _params_specs(model, mesh, "train")
        mu = _f32(params)
        opt = OptState(step=TensorSpec((), torch.int32,
                                       sharding=NamedSharding(mesh, ())),
                       mu=mu, nu=mu)

        def opt_fn(params, grads, opt_state):
            return adamw_update(OptimizerConfig(), params, grads, opt_state)

        units.append(Unit("opt_update", opt_fn, (params, params, opt), 1))
        return units

    if shape.mode == "prefill":
        ucfg = _unit_cfg(cfg, S)
        for kind, n in counts.items():
            if kind == "slstm":
                units.extend(_slstm_units(ucfg, mesh, B, S, n, grads=False,
                                          strategy=strategy))
                continue

            def block_fwd(p, x, kind=kind, ucfg=ucfg):
                return transformer.block_apply(kind, ucfg, p, x)[0]

            p_specs = _block_param_specs(kind, ucfg, mesh, mode)
            units.append(Unit(f"block_{kind}", block_fwd,
                              (p_specs, _x_specs(B, S, ucfg, mesh, strategy)),
                              n))
        units.append(_embed_head_unit(model, mesh, B, S, head_len=1,
                                      mode=mode, strategy=strategy))
        return units

    # decode
    for kind, n in counts.items():
        def block_dec(p, cache, x, pos, kind=kind):
            out, nc, _ = transformer.block_apply(
                kind, cfg, p, x, cache=cache, pos=pos, decode=True)
            return out, nc

        p_specs = _block_param_specs(kind, cfg, mesh, mode)
        cache = transformer.block_cache_specs(kind, cfg, B, S)
        cache = {k: dataclasses.replace(v, sharding=NamedSharding(
            mesh, cache_leaf_spec(kind, k, v.shape, mesh, B, strategy)))
            for k, v in cache.items()}
        tok = token_spec(mesh, B)
        pos = TensorSpec((B,), torch.int32,
                         sharding=NamedSharding(mesh, (tok[0],)))
        units.append(Unit(f"block_{kind}", block_dec,
                          (p_specs, cache, _x_specs(B, 1, cfg, mesh), pos),
                          n))
    units.append(_embed_head_unit(model, mesh, B, 1, head_len=1, mode=mode))
    return units


def _embed_head_unit(model: Model, mesh, B, S, head_len=1,
                     mode: str = "serve", strategy: str = "tp") -> Unit:
    constrain = model.constrain

    def fn(p, tokens, x_last):
        x = model._embed(p, tokens)
        if constrain is not None:
            x = constrain(x, "activation")
        return torch.sum(x.float()), model._logits(p, x_last)

    tok = _seq_tokens(mesh, B, S, strategy)
    return Unit("embed_head", fn,
                (_head_specs(model, mesh, mode),
                 TensorSpec((B, S), torch.int32,
                            sharding=NamedSharding(mesh, tok)),
                 _x_specs(B, head_len, model.cfg, mesh)), 1)


# ----------------------------------------------------------------------
# sLSTM: the time recurrence is a sequential loop; account one step x S
# plus the input and output projections around it
def _slstm_units(cfg, mesh, B, S, mult, grads: bool,
                 strategy: str = "tp") -> List[Unit]:
    from repro_torch.models import xlstm as xl
    from repro_torch.sharding import tp
    p_specs = _block_param_specs("slstm", cfg, mesh, "serve")["mixer"]
    tok = token_spec(mesh, B)
    vec = TensorSpec((B, cfg.d_model), torch.float32,
                     sharding=NamedSharding(mesh, (tok[0], None)))
    state = {k: dataclasses.replace(v, sharding=vec.sharding)
             for k, v in xl.slstm_cache_specs(cfg, B).items()}
    names = sorted(state)

    def proj(p, x):
        xz, xi, xf, xo = xl.slstm_inputs(p, x)
        return xl.slstm_output(p, (xz + xi + xf + xo).to(x.dtype), cfg)

    def step(p, *a):
        st = xl.slstm_step(p, *a[4:], dict(zip(names, a[:4])), cfg.n_heads)
        return tuple(st[k] for k in names)

    def proj_unit(p, x):
        if not grads:
            return tp.replicated(proj, p, (x,))
        p, x = _needs_grad(p), _needs_grad(x)
        with torch.enable_grad():
            out = tp.replicated(proj, p, (x,))
            return torch.autograd.grad(out, _leaves(p) + [x],
                                       torch.ones_like(out),
                                       allow_unused=True)

    def step_unit(p, st, xz, xi, xf, xo):
        acts = tuple(st[k] for k in names) + (xz, xi, xf, xo)
        if not grads:
            return tp.replicated(step, p, acts, n_out=4)
        p, acts = _needs_grad(p), _needs_grad(acts)
        with torch.enable_grad():
            h = tp.replicated(step, p, acts, n_out=4)[names.index("h")]
            return torch.autograd.grad(h.sum(), _leaves(p) + list(acts),
                                       allow_unused=True)

    return [Unit("slstm_proj", proj_unit,
                 (p_specs, _x_specs(B, S, cfg, mesh)), mult),
            Unit("slstm_step", step_unit, (p_specs, state, vec, vec, vec,
                                           vec), mult * S)]
