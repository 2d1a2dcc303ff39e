"""Parameter and activation sharding rules of the port
(``repro/sharding/partitioning.py``), as DTensor placements.

The rules are the reference's, table for table and function for
function: path-based (matched on the leaf's key path), a spec for the
*unstacked* trailing dims, leading ``None`` for the stacked repeats, and
any axis whose dim the mesh axis does not divide is dropped.

A spec is what a ``jax.sharding.PartitionSpec`` is: a tuple with one
entry per tensor dim, each ``None`` (replicated), a mesh axis name, or a
tuple of axis names.  :func:`spec_placements` turns a spec on a
``DeviceMesh`` into DTensor placements, one per mesh dim; an axis pair
such as ``("pod", "data")`` becomes two ``Shard``\\ s of the same tensor
dim, in mesh order.  The rules read only a mesh's axis names and sizes,
so they take a ``DeviceMesh`` or anything with ``axis_names`` and
``devices.shape`` (the reference's ``Mesh``).  ``torch.distributed`` is
imported only when a placement or a DTensor is made.

Two modes:
* ``serve`` — 1D: weights sharded over "model" only (tensor parallelism);
* ``train`` — 2D: "model" + FSDP over "data" on the other matrix dim, so
  params AND optimizer moments scale with the full mesh.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.sharding import boundary
from repro_torch.specs import TensorSpec

# rule table: leaf-name regex -> (serve_dims, train_dims) for trailing dims.
# "M" = model axis, "D" = data axis (fsdp), None = replicated.
_RULES = [
    (r"embed$",            (("M", None),        ("M", "D"))),
    (r"unembed$",          ((None, "M"),        ("D", "M"))),
    (r"(wq|wk|wv|wi|wg|w_up|w_up1|w_up2|w_gate|w_rec|wq_a|wq_b|wkv_b|w_z|w_i|w_f|w_o)$",
                           ((None, "M"),        ("D", "M"))),
    (r"(wo|w_down|w_out)$", (("M", None),       ("M", "D"))),
    (r"wkv_a$",            ((None, None),       ("D", None))),
    (r"router$",           ((None, None),       ("D", None))),
    (r"(bq|bk|bv)$",       (("M",),             ("M",))),
    (r"conv_w$",           ((None, "M"),        (None, "M"))),
    (r"(r_z|r_i|r_f|r_o|w_a|w_x)$", ((None, None, "M"), (None, None, "M"))),
]

# MoE expert-stacked weights: leading E dim -> expert parallelism on "model".
_MOE_RULES = [
    (r"(wi_e|wg_e)$",      (("M", None, None),  ("M", "D", None))),
    (r"wo_e$",             (("M", None, None),  ("M", None, "D"))),
]

Spec = Tuple[Any, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a reference-style mesh."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _axis_names(mesh) -> Tuple[str, ...]:
    return tuple(axis_sizes(mesh))


def _path_str(path) -> str:
    """A key path as the reference spells it: dict keys as they are,
    tuple positions as ``[i]``, joined by ``/``."""
    return "/".join(f"[{p}]" if isinstance(p, int) else str(p)
                    for p in path)


def _tree_map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_tree_map_with_path(fn, v, path + (i,))
                     for i, v in enumerate(tree))
    return fn(path, tree)


def _axis(tag: Optional[str], mesh) -> Optional[object]:
    if tag is None:
        return None
    if tag == "M":
        return "model"
    if tag == "D":
        # FSDP over data (and pod when present) for maximum param spread
        return ("pod", "data") if "pod" in _axis_names(mesh) else "data"
    raise ValueError(tag)


def _fit(dims, shape, mesh):
    """Drop assignments that don't divide the dim."""
    sizes = axis_sizes(mesh)
    out = []
    for d, ax in zip(shape, dims):
        if ax is None:
            out.append(None)
            continue
        n = sizes[ax] if isinstance(ax, str) else int(
            math.prod(sizes[a] for a in ax))
        out.append(ax if d % n == 0 else None)
    return tuple(out)


def param_spec(path_str: str, shape, mesh, mode: str) -> Spec:
    assert mode in ("serve", "train", "serve_dp")
    if mode == "serve_dp":                    # replicated weights (DP serving)
        return (None,) * len(shape)
    rules = _MOE_RULES + _RULES      # moe rules are more specific: first
    for pat, (serve_dims, train_dims) in rules:
        if re.search(pat, path_str):
            dims = serve_dims if mode == "serve" else train_dims
            if len(dims) > len(shape):        # e.g. bias rule on scalar
                dims = dims[-len(shape):]
            pad = (None,) * (len(shape) - len(dims))
            tagged = pad + tuple(_axis(t, mesh) for t in dims)
            return _fit(tagged, shape, mesh)
    return (None,) * len(shape)               # norms, gates, scalars


# ----------------------------------------------------------------------
# specs -> placements
def spec_placements(spec: Spec, mesh) -> tuple:
    """DTensor placements (one per mesh dim) of ``spec`` on ``mesh``: a
    mesh axis named in the spec shards that tensor dim, any other mesh
    axis replicates."""
    from torch.distributed.tensor import Replicate, Shard
    where: Dict[str, int] = {}
    for dim, ax in enumerate(spec):
        for name in ((ax,) if isinstance(ax, str) else (ax or ())):
            where[name] = dim
    return tuple(Shard(where[n]) if n in where else Replicate()
                 for n in mesh.mesh_dim_names)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the port's ``jax.sharding.NamedSharding``."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return spec_placements(self.spec, self.mesh)


def shard_params(params_shape, mesh, mode: str):
    """Param tree (tensors or ``TensorSpec``\\ s) -> matching tree of
    :class:`NamedSharding`."""
    def one(path, leaf):
        return NamedSharding(mesh, param_spec(_path_str(path),
                                              tuple(leaf.shape), mesh, mode))
    return _tree_map_with_path(one, params_shape)


def with_sharding(specs_tree, shardings_tree):
    """Attach shardings to a ``TensorSpec`` tree."""
    if isinstance(specs_tree, TensorSpec):
        return TensorSpec(specs_tree.shape, specs_tree.dtype,
                          specs_tree.fill, sharding=shardings_tree)
    if isinstance(specs_tree, dict):
        return {k: with_sharding(v, shardings_tree[k])
                for k, v in specs_tree.items()}
    return tuple(with_sharding(s, sh)
                 for s, sh in zip(specs_tree, shardings_tree))


# ----------------------------------------------------------------------
# Activations / caches
def batch_axes(mesh):
    return ("pod", "data") if "pod" in _axis_names(mesh) else ("data",)


def _mesh_size(mesh, axes) -> int:
    sizes = axis_sizes(mesh)
    return int(math.prod(sizes[a] for a in axes))


def token_spec(mesh, global_batch: int) -> Spec:
    ba = batch_axes(mesh)
    if global_batch % _mesh_size(mesh, ba) == 0:
        return (ba,)
    return (None,)


def cache_spec(path_str: str, shape, mesh, global_batch: int) -> Spec:
    """KV caches and recurrent states.

    Preference order: shard batch over data(+pod); if batch unshardable
    (long_500k B=1) shard the sequence dim of attention caches instead;
    shard heads (or the feature dim) over model when divisible.
    """
    sizes = axis_sizes(mesh)
    ba = batch_axes(mesh)
    nb = _mesh_size(mesh, ba)
    name = path_str.rsplit("/", 1)[-1]
    model = sizes["model"]
    # stacked caches carry a leading (repeats,) dim: strip it, shard the
    # logical dims, then pad the spec back out.
    arity = {"k": 4, "v": 4, "ckv": 3, "kr": 3, "conv": 3, "C": 4}.get(name)
    if arity is None:
        arity = 3 if name == "n" and len(shape) >= 3 else 2
    lead = max(0, len(shape) - arity)
    if lead:
        inner = cache_spec(path_str, shape[lead:], mesh, global_batch)
        return (None,) * lead + tuple(inner)
    b_ax = ba if (shape and shape[0] % nb == 0 and global_batch > 1) else None

    def m_if(n):
        return "model" if n % model == 0 else None

    if name in ("k", "v"):                    # (B, L, H, hd)
        B, L, H, hd = shape
        spec = [b_ax, None, m_if(H), None]
        if b_ax is None and L % nb == 0:
            spec[1] = ba                      # sequence-shard the cache
        if spec[2] is None:
            spec[3] = m_if(hd)
        return tuple(spec)
    if name in ("ckv", "kr"):                 # (B, L, r)
        # MLA latent caches have no head dim: shard the latent (lora) dim
        # over model.
        B, L, r = shape
        spec = [b_ax, None, m_if(r)]
        if b_ax is None and L % nb == 0:
            spec[1] = ba
        return tuple(spec)
    if name in ("h", "c", "n", "m") and len(shape) == 2:   # (B, d)
        # recurrent states stay model-replicated: sharding the feature dim
        # misaligns with the block-diagonal recurrent matmuls and forces
        # per-timestep reshards
        return (b_ax, None)
    if name == "conv":                        # (B, w-1, r)
        return (b_ax, None, m_if(shape[2]))
    if name == "C" and len(shape) == 4:       # (B, nh, hd, hd)
        return (b_ax, None, m_if(shape[2]), None)
    if name in ("n",) and len(shape) == 3:    # (B, nh, hd)
        return (b_ax, None, m_if(shape[2]))
    if name == "m" and len(shape) == 2:
        return (b_ax, None)
    return tuple([b_ax] + [None] * (len(shape) - 1)) if shape else ()


def cache_leaf_spec(kind: str, name: str, shape, mesh,
                    global_batch: int, strategy: str = "tp") -> Spec:
    """Kind-aware cache sharding (disambiguates e.g. slstm 'n' (B,d) from
    mlstm 'n' (B,nh,hd)); handles one leading stack dim.

    strategy "dp_cp": weights are replicated, so attention caches shard the
    SEQUENCE dim over the idle model axis (context parallelism) and batch
    over data; recurrent states shard batch only."""
    arities = {
        "attn": {"k": 4, "v": 4},
        "attn_local": {"k": 4, "v": 4},
        "attn_moe": {"k": 4, "v": 4},
        "mla": {"ckv": 3, "kr": 3},
        "mla_moe": {"ckv": 3, "kr": 3},
        "rglru": {"h": 2, "conv": 3},
        "mlstm": {"C": 4, "n": 3, "m": 2, "conv": 3},
        "slstm": {"c": 2, "n": 2, "h": 2, "m": 2},
    }[kind]
    arity = arities[name]
    lead = len(shape) - arity
    assert lead >= 0, (kind, name, shape)
    inner = shape[lead:]
    if strategy == "dp_cp":
        ba = batch_axes(mesh)
        nb = _mesh_size(mesh, ba)
        b_ax = ba if (inner[0] % nb == 0 and global_batch > 1) else None
        model = axis_sizes(mesh)["model"]
        if name in ("k", "v", "ckv", "kr"):
            seq_ax = "model" if inner[1] % model == 0 else None
            spec = (b_ax, seq_ax) + (None,) * (arity - 2)
        else:
            spec = (b_ax,) + (None,) * (arity - 1)
        return (None,) * lead + spec
    spec = cache_spec(f"{kind}/{name}", shape[lead:], mesh, global_batch)
    return (None,) * lead + tuple(spec)


def shard_cache_for_model(cfg, cache_shape, mesh, global_batch: int,
                          strategy: str = "tp"):
    """Model-structure-aware shardings for the full decode cache tree
    (``Model.cache_specs``' layout: segments, pattern positions, leaves)."""
    out = []
    for si, (pattern, repeats) in enumerate(cfg.segments):
        seg = []
        for pi, kind in enumerate(pattern):
            d = cache_shape[si][pi]
            seg.append({
                k: NamedSharding(mesh, cache_leaf_spec(
                    kind, k, tuple(v.shape), mesh, global_batch, strategy))
                for k, v in d.items()})
        out.append(tuple(seg))
    return tuple(out)


def logits_constrainer(mesh, strategy: str = "tp"):
    """Sharding-constraint hook: activations batch-sharded at every block
    boundary (sequence additionally sharded over the model axis under
    "dp_cp"); loss logits vocab-sharded.  Where the reference hands GSPMD
    a ``with_sharding_constraint``, the port redistributes a DTensor to
    the spec's placements; a plain tensor comes back as it is."""
    ba = batch_axes(mesh)
    model_size = axis_sizes(mesh)["model"]

    def constrain(x, tag):
        if not boundary.sharded(x):
            return x
        if tag == "logits":
            B, S, V = x.shape
            spec = (ba if B % _mesh_size(mesh, ba) == 0 else None, None,
                    "model" if V % model_size == 0 else None)
            return x.redistribute(mesh, spec_placements(spec, mesh))
        if tag == "activation":
            B = x.shape[0]
            b_ax = ba if B % _mesh_size(mesh, ba) == 0 else None
            seq_ax = None
            if (strategy == "dp_cp" and x.ndim == 3 and x.shape[1] > 1
                    and x.shape[1] % model_size == 0):
                seq_ax = "model"
            spec = ((b_ax, seq_ax) + (None,) * (x.ndim - 2))[:x.ndim]
            return x.redistribute(mesh, spec_placements(spec, mesh))
        return x
    return constrain


def distribute_specs(specs, device):
    """A tree of new DTensors shaped like a ``TensorSpec`` tree whose
    leaves carry a :class:`NamedSharding`: each rank allocates only its
    own shard, filled with the spec's ``fill``; a leaf without a sharding
    becomes a plain tensor."""
    if isinstance(specs, TensorSpec):
        if specs.sharding is None:
            return torch.full(specs.shape, specs.fill, dtype=specs.dtype,
                              device=device)
        from torch.distributed.tensor import DTensor
        mesh, pl = specs.sharding.mesh, specs.sharding.placements
        local, _ = local_shape_and_offset(specs.shape, mesh, pl)
        t = torch.full(local, specs.fill, dtype=specs.dtype, device=device)
        return DTensor.from_local(t, mesh, pl, run_check=False,
                                  shape=torch.Size(specs.shape),
                                  stride=_contiguous_stride(specs.shape))
    if isinstance(specs, dict):
        return {k: distribute_specs(v, device) for k, v in specs.items()}
    out = [distribute_specs(s, device) for s in specs]
    return type(specs)(*out) if hasattr(specs, "_fields") else tuple(out)


def distribute_tree(tree, specs):
    """Full tensors (the same on every rank) -> DTensors placed as the
    matching ``TensorSpec`` tree's shardings say, each rank keeping its
    own shard (no communication); a leaf whose spec has no sharding
    stays as it is."""
    if isinstance(specs, TensorSpec):
        if specs.sharding is None:
            return tree
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(tree, specs.sharding.mesh,
                                 specs.sharding.placements,
                                 src_data_rank=None)
    if isinstance(specs, dict):
        return {k: distribute_tree(tree[k], v) for k, v in specs.items()}
    out = [distribute_tree(t, s) for t, s in zip(tree, specs)]
    return type(specs)(*out) if hasattr(specs, "_fields") else tuple(out)


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for d in reversed(shape):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))


def local_shape_and_offset(shape, mesh, placements):
    """(local shape, global offset) of this rank's shard."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    with unset_fake_temporarily():       # the dry run's tensors are fake
        local, offset = compute_local_shape_and_global_offset(
            tuple(shape), mesh, placements)
    return tuple(local), tuple(offset)
