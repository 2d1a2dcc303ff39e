"""Mixture-of-Experts layer of the port (``repro/models/moe.py``): top-k
routing, a capacity per expert and dispatch group, optional shared
experts, and three ways to compute the routed experts, which all drop
the same assignments (those ranked at or past the capacity):

* ``einsum``: GShard-style one-hot dispatch and combine tensors;
* ``gather``: tokens are placed into a dense (E*C + 1, d) buffer by slot
  index (the last row takes what overflows) and gathered back;
* K4 (``kernels/ops.py`` ``moe_grouped``): a grouped SwiGLU GEMM over the
  rows that carry a kept assignment alone, its routing metadata built on
  the device.

Which runs where: on the card, outside autograd, SwiGLU experts take K4
whatever ``dispatch`` says (both values name the same function; K4
computes it without the capacity rows no token fills).  On the CPU
``dispatch`` picks ``einsum`` or ``gather``, as mirrors of the
reference.  Under autograd (a tensor that requires grad) the card keeps
the ``dispatch`` path too: K4 has no backward, and training runs the
batched products.  Both batched paths rank each (token, k-slot) within
its expert by the same k-major cumulative count; expert weights are
stacked on a leading E axis and their products are batched matmuls, as
the reference computes them outside any Pallas kernel.

The router runs in float32 whatever the model's type: its weight is
float32 and its input is cast up, so on the card it must run at full
float32 precision (PyTorch's default; TF32 keeps 10 mantissa bits,
enough to flip choices near a tie).

While a ``torch.profiler`` runs, each stage of the layer is a named
range (``moe/routing``, ``moe/dispatch``, ``moe/experts``,
``moe/combine``; K4 is one ``moe/experts`` range), so a trace attributes
device time to them; with no profiler running the ranges cost one flag
test.  ``record_routing()`` collects each call's choices, each token's
top-k margin and the dropped assignments, for the card-side gates and
the tests.  ``counting_rows()`` sums what each dispatch computes against
what it routes, host integers fixed by the shapes: a captured step
counts them once, at capture.

The top-k gates are renormalised to sum to one unless the config keeps
them raw (``configs/port.py`` ``norm_topk_prob``, DeepSeek-V2).
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import List

import torch
import torch.autograd.profiler as _autograd_profiler
import torch.nn.functional as F

from repro_torch.configs.port import norm_topk_prob
from repro_torch.kernels import ops
from repro_torch.models.layers import (ParamFactory, dense_init, init_mlp,
                                      mlp_apply)


def init_moe(make: ParamFactory, cfg) -> dict:
    e = cfg.moe
    d = cfg.d_model
    dtype = getattr(torch, cfg.dtype)

    def expert_stack(in_dim, out_dim):
        return make.normal((e.n_experts, in_dim, out_dim), dtype,
                           in_dim ** -0.5)

    # the router stays float32 in a bf16 model, as in the reference
    p = {"router": dense_init(make, d, e.n_experts, torch.float32),
         "wi_e": expert_stack(d, e.d_ff)}
    if cfg.activation == "swiglu":
        p["wg_e"] = expert_stack(d, e.d_ff)
    p["wo_e"] = expert_stack(e.d_ff, d)
    if e.n_shared:
        p["shared"] = init_mlp(make, cfg, d_ff=e.d_ff * e.n_shared)
    return p


def _stage(name: str):
    """A profiler range around one stage, only while a profiler runs."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(f"moe/{name}")
    return contextlib.nullcontext()


# ----------------------------------------------------------------------
# routing records
@dataclass
class RoutingRecord:
    """What ``moe_apply`` calls chose while a ``record_routing()`` block
    was open on this thread, one entry per call, in call order: ``idx``
    the (T, k) experts, ``margins`` each token's gap between its k-th
    and (k+1)-th gate (float32), ``dropped`` the assignments past capacity (an int scalar tensor) of
    ``assignments``, with ``capacity`` slots per expert in each of
    ``groups`` dispatch groups."""
    calls: List[dict] = field(default_factory=list)


_recording = threading.local()


@contextlib.contextmanager
def record_routing():
    """Record every ``moe_apply`` call on this thread inside the block."""
    rec = RoutingRecord()
    prev = getattr(_recording, "rec", None)
    _recording.rec = rec
    try:
        yield rec
    finally:
        _recording.rec = prev


@contextlib.contextmanager
def recording_paused():
    """Record no ``moe_apply`` call on this thread inside the block: a
    checkpointed segment's recomputation (``transformer._remat``) runs
    each forward a second time."""
    prev = getattr(_recording, "rec", None)
    _recording.rec = None
    try:
        yield
    finally:
        _recording.rec = prev


def _recorder():
    return getattr(_recording, "rec", None)


@dataclass
class RowCount:
    """What the ``routed`` calls on this thread inside a
    ``counting_rows()`` block dispatched, summed: ``assignments`` the
    routed (token, expert) pairs, T * k, and ``rows`` the expert rows
    computed: E_loc * G * C on the batched paths (capacity rows, used or
    not), T * k on K4 (the rows it gathers)."""
    assignments: int = 0
    rows: int = 0


_counting = threading.local()


@contextlib.contextmanager
def counting_rows():
    """Count every ``routed`` call on this thread inside the block."""
    count = RowCount()
    prev = getattr(_counting, "count", None)
    _counting.count = count
    try:
        yield count
    finally:
        _counting.count = prev


# ----------------------------------------------------------------------
def _expert_ffn(p, x, activation: str):
    """x: (E, C*, d) -> (E, C*, d) through each expert's own weights."""
    if activation == "swiglu":
        h = F.silu(torch.bmm(x, p["wg_e"])) * torch.bmm(x, p["wi_e"])
    elif activation == "squared_relu":
        h = torch.square(F.relu(torch.bmm(x, p["wi_e"])))
    elif activation == "gelu":
        h = F.gelu(torch.bmm(x, p["wi_e"]), approximate="tanh")
    else:
        raise ValueError(activation)
    return torch.bmm(h, p["wo_e"])


def _route(p, x2d, e):
    """x2d: (T, d) -> (gates (T, E), probs (T, k), idx (T, k), aux)."""
    logits = x2d.float() @ p["router"]                        # (T, E) f32
    gates = torch.softmax(logits, dim=-1)
    probs, idx = torch.topk(gates, e.top_k, dim=-1)
    if norm_topk_prob(e):
        probs = probs / torch.clamp(probs.sum(-1, keepdim=True), min=1e-9)
    # Switch/GShard load-balance aux loss
    me = gates.mean(dim=0)                                    # (E,)
    ce = _one_hot(idx, e.n_experts, torch.float32).sum(dim=(0, 1)) \
        / (x2d.shape[0] * e.top_k)
    aux = e.n_experts * torch.sum(me * ce) * e.load_balance_coef
    return gates, probs, idx, aux


def _routing(p, x2d, e):
    """x2d: (T, d) -> (probs (T, k), idx (T, k), aux scalar)."""
    return _route(p, x2d, e)[1:]


def _capacity(tokens_per_group: int, e) -> int:
    c = int(tokens_per_group * e.top_k * e.capacity_factor / e.n_experts)
    return max(4, -(-c // 4) * 4)                             # round up to 4


def _one_hot(t, n: int, dtype):
    """jax.nn.one_hot: an index outside [0, n) gives a row of zeros."""
    return (t[..., None] == torch.arange(n, device=t.device)).to(dtype)


def _positions(idx_g, n_experts: int):
    """(G, gs, k) experts -> each assignment's rank within its expert and
    group, k-major: every token's first choice ranks before any second.

    The count runs along the last dim of an (G, E, k*gs) one-hot: a scan
    along an outer dim gets one thread per expert column on the card,
    which took 18 ms of a 32 ms granite prefill."""
    G, gs, k = idx_g.shape
    order = idx_g.transpose(1, 2).reshape(G, 1, k * gs)       # k-major
    flat = (order == torch.arange(n_experts, device=idx_g.device)[:, None]
            ).to(torch.int32)                                 # (G, E, k*gs)
    ranks = torch.cumsum(flat, dim=2, dtype=torch.int32) - 1
    pos = torch.gather(ranks, 1, order)                       # (G, 1, k*gs)
    return pos.reshape(G, k, gs).transpose(1, 2)              # (G, gs, k)


def moe_apply(p, x, cfg):
    """x: (B, S, d) -> (out, aux loss)."""
    e = cfg.moe
    B, S, d = x.shape
    T = B * S
    x2d = x.reshape(T, d)
    with _stage("routing"):
        gates, probs, idx, aux = _route(p, x2d, e)
    gs = min(e.group_size, T)
    out2d, keep, C, G = routed(p, x2d, probs, idx, cfg, gs)
    rec = _recorder()
    if rec is not None:
        k, E = e.top_k, e.n_experts
        # outside autograd: a recorded forward saves for the backward just
        # what an unrecorded one (a checkpoint's recomputation) saves
        with torch.no_grad():
            top = torch.topk(gates, min(k + 1, E), dim=-1).values
            margins = (top[:, k - 1] - top[:, k]) if k < E else \
                torch.full((T,), float("inf"), device=x.device)
            rec.calls.append(dict(idx=idx, margins=margins,
                                  dropped=(~keep).sum(), assignments=T * k,
                                  capacity=C, groups=G))
    out = out2d.reshape(B, S, d)
    if e.n_shared:
        out = out + mlp_apply(p["shared"], x, cfg.activation)
    return out, aux


def _grouped(p, x2d, probs, activation: str) -> bool:
    """Whether ``routed`` runs K4: SwiGLU experts on the card, outside
    autograd (K4 has no backward)."""
    if not x2d.is_cuda or activation != "swiglu":
        return False
    return not (torch.is_grad_enabled() and any(
        t.requires_grad for t in (x2d, probs, p["wg_e"], p["wi_e"],
                                  p["wo_e"])))


def routed(p, x2d, probs, idx, cfg, gs: int, e0: int = 0):
    """The routed experts' output (T, d) for tokens ``x2d`` (T, d) with
    their top-k ``probs`` and ``idx`` (T, k), in dispatch groups of
    ``gs`` tokens with the capacity of ``gs``.  ``p``'s expert stacks may
    hold a slice of the experts, from global expert ``e0`` on (a tensor
    parallel rank's): capacity and each assignment's rank are counted
    over all experts, and only the slice's experts are computed, so the
    slices' outputs sum to the whole.  On the card outside autograd K4
    computes it (``_grouped``); elsewhere ``cfg.moe.dispatch``'s batched
    path.  Returns (out2d, keep, C, G)."""
    e = cfg.moe
    T, d = x2d.shape
    x = x2d
    if T % gs:
        raise ValueError(f"{T} tokens are not a whole number of dispatch "
                         f"groups of {gs}")
    if e.dispatch not in ("einsum", "gather"):
        raise ValueError(e.dispatch)
    G = T // gs
    C = _capacity(gs, e)
    E, k = e.n_experts, e.top_k
    E_loc = p["wi_e"].shape[0]
    whole = E_loc == E
    grouped = _grouped(p, x2d, probs, cfg.activation)
    count = getattr(_counting, "count", None)
    if count is not None:
        count.assignments += T * k
        count.rows += T * k if grouped else E_loc * G * C

    with _stage("dispatch"):
        idx_g = idx.reshape(G, gs, k)
        pos = _positions(idx_g, E)
        keep = pos < C
    if grouped:
        with _stage("experts"):
            out2d = ops.moe_grouped(x2d, idx, pos.reshape(T, k), probs,
                                    p["wg_e"], p["wi_e"], p["wo_e"],
                                    capacity=C, group_size=gs, e0=e0)
        return out2d, keep, C, G
    with _stage("dispatch"):
        xg = x2d.reshape(G, gs, d)
        probs_g = probs.reshape(G, gs, k)
        if e.dispatch == "einsum":
            # (G, gs, k, E, C) one-hot dispatch tensor
            disp = (_one_hot(idx_g, E, x.dtype)[..., :, None]
                    * _one_hot(pos, C, x.dtype)[..., None, :])
            disp = disp * keep[..., None, None].to(x.dtype)
            disp_tok = disp.sum(dim=2)                        # (G, gs, E, C)
            if not whole:
                disp = disp[..., e0:e0 + E_loc, :]
                disp_tok = disp_tok[..., e0:e0 + E_loc, :]
            expert_in = torch.einsum("gsec,gsd->gecd", disp_tok, xg)
        else:
            slot = torch.where(keep, idx_g * C + pos, E * C)  # overflow row
            buf = torch.zeros((G, E * C + 1, d), dtype=x.dtype,
                              device=x.device)
            garange = torch.arange(G, device=x.device)[:, None, None]
            buf[garange, slot] = xg[:, :, None, :].expand(G, gs, k, d)
            expert_in = buf[:, :-1].reshape(G, E, C, d)
            if not whole:
                expert_in = expert_in[:, e0:e0 + E_loc]
        expert_in = expert_in.transpose(0, 1).reshape(E_loc, G * C, d)
    with _stage("experts"):
        expert_out = _expert_ffn(p, expert_in, cfg.activation)
    with _stage("combine"):
        expert_out = expert_out.reshape(E_loc, G, C, d).transpose(0, 1)
        if e.dispatch == "einsum":
            combine = (disp * probs_g[..., None, None].to(x.dtype)).sum(dim=2)
            out2d = torch.einsum("gsec,gecd->gsd", combine, expert_out)
        else:
            if whole:
                ybuf = torch.cat([expert_out.reshape(G, E * C, d),
                                  torch.zeros((G, 1, d), dtype=x.dtype,
                                              device=x.device)], dim=1)
            else:                 # the other slices' slots read zeros
                ybuf = torch.zeros((G, E * C + 1, d), dtype=x.dtype,
                                   device=x.device)
                ybuf[:, e0 * C:(e0 + E_loc) * C] = \
                    expert_out.reshape(G, E_loc * C, d)
            gathered = ybuf[garange, slot]                    # (G, gs, k, d)
            out2d = torch.sum(gathered * probs_g[..., None].to(x.dtype),
                              dim=2)
    return out2d, keep, C, G


def moe_ref(p, x, cfg):
    """Dense oracle: every token through its top-k experts exactly (no
    capacity drops).  For the tests."""
    e = cfg.moe
    B, S, d = x.shape
    x2d = x.reshape(-1, d)
    probs, idx, aux = _routing(p, x2d, e)
    experts = {n: p[n] for n in ("wi_e", "wg_e", "wo_e") if n in p}
    ys = torch.stack([
        _expert_ffn({n: w[j:j + 1] for n, w in experts.items()}, x2d[None],
                    cfg.activation)[0]
        for j in range(e.n_experts)])                         # (E, T, d)
    sel = torch.gather(ys.transpose(0, 1), 1,
                       idx[..., None].expand(-1, -1, d))      # (T, k, d)
    out2d = torch.sum(sel * probs[..., None].to(x.dtype), dim=1)
    out = out2d.reshape(B, S, d)
    if e.n_shared:
        out = out + mlp_apply(p["shared"], x, cfg.activation)
    return out, aux
