"""The port's kernels and in-place cache writes under DTensor.

The kernels (K1 and K1b through ``FlashAttentionFunction``, K2, K3 and
K3b through ``RGLRUScanFunction``) take plain tensors.  On a sharded
step each call site goes through ``local_map`` here: its DTensor inputs
are redistributed to placements the kernel can take, and each rank's
kernel runs on its local shard:

* attention (K1, K2): the batch split over the mesh's batch axes
  (``pod``, ``data``) where it divides, whole heads over ``model`` where
  both the query and the KV heads divide, and ``Replicate`` otherwise; a
  sequence-sharded activation or cache (``dp_cp``) and a cache sharded
  on its head dim are gathered, as GSPMD gathers them;
* the RG-LRU scan (K3): the batch as above, the channels over ``model``.

Each rank's gradients are those of its own heads, channels and rows, so
the gradients keep the input placements.  A launch on this path is
counted by ``KernelOp`` like any other.  The functions here take
DTensors (``sharding/tp.py`` calls them); a plain path calls
``kernels.ops`` itself.

On the dry run's fake tensors the attention runs its plain version one
``q_chunk`` of query rows at a time (``q_offset`` places each chunk), so
the memory booked is a chunk's scores, as the reference's chunked full
program allocates, not the S x S that no kernel allocates; the scan is
one fake op (``_FakeScan``).

Cache writes are in place: a decode step writes one slot per row into
each rank's own shard (a sequence-sharded cache by a one-hot select
over its local slots, which needs no data-dependent shape), and a
prefill seeds the slots each shard holds.
"""
from __future__ import annotations

import sys
from typing import Optional, Sequence

import torch

from repro_torch.kernels import ops

BATCH_AXES = ("pod", "data")


def sharded(*tensors) -> bool:
    """True if any of ``tensors`` is a DTensor.  ``torch.distributed.tensor``
    is imported only by a sharded step: until then no DTensor exists, and
    the serving path does not pay for the import."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and any(isinstance(t, mod.DTensor)
                                   for t in tensors)


def _mesh(*tensors):
    return next(t.device_mesh for t in tensors if sharded(t))


def _names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ())


def _batch_split(mesh, B: int) -> bool:
    n = 1
    for name, size in zip(_names(mesh), mesh.shape):
        if name in BATCH_AXES:
            n *= size
    return B % n == 0


def model_size(mesh) -> int:
    names = _names(mesh)
    return mesh.shape[names.index("model")] if "model" in names else 1


def placements(mesh, B: int, split_dim: Optional[int], heads: Sequence[int],
               ndim: int = 4) -> tuple:
    """Placements of a (B, ..., H, ...) tensor at a kernel boundary: the
    batch dim 0 over the batch axes where B divides, ``split_dim`` over
    ``model`` where every count in ``heads`` divides, else replicated."""
    from torch.distributed.tensor import Replicate, Shard
    bsplit = _batch_split(mesh, B)
    m = model_size(mesh)
    msplit = split_dim is not None and all(h % m == 0 for h in heads)
    out = []
    for name in _names(mesh):
        if name in BATCH_AXES and bsplit:
            out.append(Shard(0))
        elif name == "model" and msplit:
            out.append(Shard(split_dim % ndim))
        else:
            out.append(Replicate())
    return tuple(out)


def drop_dim(pl, dim: int) -> tuple:
    """Placements of a tensor with ``dim`` removed (a shard of ``dim``
    replicates; later dims shift down)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for p in pl:
        if isinstance(p, Shard):
            if p.dim == dim:
                out.append(Replicate())
            elif p.dim > dim:
                out.append(Shard(p.dim - 1))
            else:
                out.append(p)
        else:
            out.append(Replicate() if not isinstance(p, Replicate) else p)
    return tuple(out)


def batch_only(pl) -> tuple:
    from torch.distributed.tensor import Replicate, Shard
    return tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in pl)


# ----------------------------------------------------------------------
# kernels
def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(t)


def _flash_local(q, k, v, *, q_chunk: Optional[int] = None, **kw):
    Sq = q.shape[1]
    if q_chunk is None or not _is_fake(q) or Sq <= q_chunk:
        return ops.flash_attention(q, k, v, **kw)
    base = kw.pop("q_offset", 0)
    return torch.cat([ops.flash_attention(q[:, c0:c0 + q_chunk], k, v,
                                          q_offset=base + c0, **kw)
                      for c0 in range(0, Sq, q_chunk)], dim=1)


def flash_attention(q, k, v, *, q_chunk: Optional[int] = None, **kw):
    """``ops.flash_attention`` (K1, K1b under grad) on each rank's heads."""
    from torch.distributed.tensor.experimental import local_map
    mesh = _mesh(q, k, v)
    pl = placements(mesh, q.shape[0], 2, (q.shape[2], k.shape[2]))
    fn = local_map(lambda q, k, v: _flash_local(q, k, v, q_chunk=q_chunk,
                                                **kw),
                   out_placements=(pl,), in_placements=(pl, pl, pl),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(q, k, v)


def decode_attention(q, k_cache, v_cache, pos, **kw):
    """``ops.decode_attention`` (K2) on each rank's heads and rows."""
    from torch.distributed.tensor.experimental import local_map
    mesh = _mesh(q, k_cache, v_cache)
    pl = placements(mesh, q.shape[0], 2, (q.shape[2], k_cache.shape[2]))
    pos = as_dtensor(pos, mesh)
    fn = local_map(lambda q, k, v, p: ops.decode_attention(q, k, v, p, **kw),
                   out_placements=(pl,),
                   in_placements=(pl, pl, pl, batch_only(pl)),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(q, k_cache, v_cache, pos)


class _FakeScan(torch.autograd.Function):
    """K3 and K3b on the dry run's fake tensors: their outputs' shapes and
    types, and what ``RGLRUScanFunction`` keeps for the backward (a and
    y), with no loop over S (the plain scan steps through S on the host;
    its work is elementwise, which the ledger books at 0 FLOPs)."""

    @staticmethod
    def forward(ctx, a, b):
        B, S, r = a.shape
        y = a.new_empty((B, S, r), dtype=torch.float32)
        ctx.save_for_backward(a, y)
        return y, a.new_empty((B, r), dtype=torch.float32)

    @staticmethod
    def backward(ctx, dy, dhT):
        a, _ = ctx.saved_tensors
        return a.new_empty(a.shape), a.new_empty(a.shape)


def _scan_local(a, b):
    if _is_fake(a):
        return _FakeScan.apply(a, b)
    return ops.rglru_scan(a, b, None)


def rglru_scan(a, b):
    """``ops.rglru_scan`` from a zero state (K3, K3b under grad) on each
    rank's channels and rows; returns (y, h_T)."""
    from torch.distributed.tensor.experimental import local_map
    mesh = _mesh(a, b)
    pl = placements(mesh, a.shape[0], 2, (a.shape[2],), ndim=3)
    fn = local_map(_scan_local,
                   out_placements=(pl, drop_dim(pl, 1)),
                   in_placements=(pl, pl), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(a, b)


def as_dtensor(t, mesh):
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


# ----------------------------------------------------------------------
# cache writes, in place
def assign(dst, src) -> None:
    """``dst.copy_(src)`` for a sharded ``dst``: ``src`` is first
    redistributed to ``dst``'s placements, so each rank writes its own
    shard."""
    src = as_dtensor(src, dst.device_mesh)
    if tuple(src.placements) != tuple(dst.placements):
        src = src.redistribute(dst.device_mesh, dst.placements)
    dst.to_local().copy_(src.to_local())


def _local_offset(t, dim: int) -> int:
    from repro_torch.sharding.partitioning import local_shape_and_offset
    _, off = local_shape_and_offset(t.shape, t.device_mesh, t.placements)
    return off[dim]


def write_rows(buf, slot, val) -> None:
    """``buf[b, slot[b]] = val[b]`` for every row ``b`` of a sharded (B,
    L, ...) cache, in place, each rank into its own shard; ``slot`` (B,)
    may be any integer tensor."""
    from torch.distributed.tensor import Shard
    mesh, pl = buf.device_mesh, buf.placements
    val = as_dtensor(val, mesh).redistribute(mesh, drop_dim(pl, 1))
    slot = as_dtensor(slot, mesh).redistribute(mesh, batch_only(pl))
    lbuf, lval, lslot = buf.to_local(), val.to_local(), slot.to_local()
    seq_split = any(isinstance(p, Shard) and p.dim == 1 for p in pl)
    if not seq_split:
        bidx = torch.arange(lbuf.shape[0], device=lbuf.device)
        lbuf[bidx, lslot.long()] = lval.to(lbuf.dtype)
        return
    off = _local_offset(buf, 1)
    here = torch.arange(lbuf.shape[1], device=lbuf.device) + off
    hit = here[None, :] == lslot.long()[:, None]            # (B, L_local)
    hit = hit.reshape(hit.shape + (1,) * (lbuf.ndim - 2))
    lbuf.copy_(torch.where(hit, lval[:, None].to(lbuf.dtype), lbuf))


def write_slots(buf, val, slots: Sequence[int]) -> None:
    """``buf[:, slots[i]] = val[:, i]`` for the distinct slots of a Python
    list, in place (a prefill seeding its sharded cache)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh, pl = buf.device_mesh, buf.placements
    val = as_dtensor(val, mesh).redistribute(
        mesh, tuple(Replicate() if isinstance(p, Shard) and p.dim == 1
                    else p for p in pl))
    lbuf, lval = buf.to_local(), val.to_local()
    off = _local_offset(buf, 1)
    pairs = [(s - off, i) for i, s in enumerate(slots)
             if off <= s < off + lbuf.shape[1]]
    if not pairs:
        return
    dst = torch.tensor([d for d, _ in pairs], device=lbuf.device)
    src = torch.tensor([s for _, s in pairs], device=lbuf.device)
    lbuf[:, dst] = lval[:, src].to(lbuf.dtype)
