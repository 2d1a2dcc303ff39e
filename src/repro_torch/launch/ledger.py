"""Per-device counts of a sharded step, taken on the local shards.

A ``TorchDispatchMode`` that steps aside for DTensor ops
(``NotImplemented``), so DTensor desugars each one into the local ops
and collectives that a rank runs, and the mode sees exactly those:

* FLOPs, from ``torch.utils.flop_counter``'s formulas applied to the
  local shapes (an op without a formula is decomposed first, as
  ``FlopCounterMode`` does); ``FlopCounterMode`` itself, around a DTensor
  op, would count the global op;
* collectives, by op, with the bytes of each one's result on this rank;
* memory: the bytes of the storages that the step's ops allocate and
  that are alive at once, and the peak of that sum (an output that
  shares its input's storage, a view, adds nothing).

DTensor's sharding propagation, which runs an op on global-shape fake
tensors to learn its output's metadata, is not a rank's work and is
skipped.

On fake tensors (``FakeTensorMode``) nothing is allocated or computed,
so a production-size step is counted on the CPU.  ``on_fake_model``
adapts the model to that run from outside it: the sLSTM prefill loop
runs as one op, and the remat checkpoints mark their recomputation.
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry, register_flop_formula

from repro_torch.models import transformer, xlstm

COLLECTIVES = ("all_gather_into_tensor", "reduce_scatter_tensor",
               "all_reduce", "all_to_all_single", "broadcast",
               "all_gather", "reduce_scatter")


def _collective(func) -> str | None:
    name = func._overloadpacket.__name__
    ns = func.namespace
    if ns in ("_c10d_functional", "c10d_functional", "c10d") and \
            name.rstrip("_") in COLLECTIVES:
        return name.rstrip("_")
    return None


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


_propagating = threading.local()


def _mark_propagation():
    """Wrap DTensor's sharding propagation, which runs each op once on
    global-shape fake tensors to learn its output's metadata, so that
    the ledger can tell that work from a rank's."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    fn = ShardingPropagator._propagate_tensor_meta_non_cached
    if getattr(fn, "_ledger_marked", False):
        return

    def marked(self, op_schema):
        depth = getattr(_propagating, "depth", 0)
        _propagating.depth = depth + 1
        try:
            return fn(self, op_schema)
        finally:
            _propagating.depth = depth

    marked._ledger_marked = True
    ShardingPropagator._propagate_tensor_meta_non_cached = marked


def _storage(t):
    try:
        return t.untyped_storage()
    except (NotImplementedError, RuntimeError):
        return None


class Ledger(TorchDispatchMode):
    """Counts FLOPs, collectives and live bytes of the local ops run
    inside ``with Ledger() as led:``."""

    def __init__(self, fake_mode=None):
        super().__init__()
        # a fake tensor of another mode is not a rank's; ``fake_mode`` is
        # the dry run's, whose fake tensors are
        self.fake_mode = fake_mode
        _mark_propagation()
        self.flops = 0
        self.recompute_flops = 0        # of which a checkpoint's recompute
        self.recomputing = 0            # depth of recomputes under way
        self.coll_count: Counter = Counter()
        self.coll_bytes: Counter = Counter()
        self.live = 0
        self.peak = 0
        self._seen: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if isinstance(func, torch._ops.HigherOrderOperator) or \
                getattr(_propagating, "depth", 0):
            return func(*args, **kwargs)
        packet = func._overloadpacket
        coll = _collective(func)
        if coll is None and packet not in flop_registry and \
                func.namespace == "aten":
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if not all(self._ours(t) for t in _tensors((args, kwargs, out))):
            return out
        views = {id(_storage(t)) for t in _tensors((args, kwargs))}
        if coll is not None:
            self.coll_count[coll] += 1
            self.coll_bytes[coll] += sum(t.numel() * t.element_size()
                                         for t in _tensors(out))
        elif packet in flop_registry:
            n = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += n
            if self.recomputing:
                self.recompute_flops += n
        self._track(out, views)
        return out

    @contextlib.contextmanager
    def recomputation(self):
        """Books the ops run inside it as a checkpoint's recompute."""
        self.recomputing += 1
        try:
            yield
        finally:
            self.recomputing -= 1

    def _ours(self, t) -> bool:
        mode = getattr(t, "fake_mode", None)
        return mode is None or mode is self.fake_mode

    def _track(self, out, views=()) -> None:
        for t in _tensors(out):
            st = _storage(t)
            key = id(st)
            if st is None or key in self._seen or key in views:
                continue
            n = st.nbytes()
            self._seen[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._seen.pop(key, 0)

    def collectives(self) -> dict:
        return {"bytes": dict(self.coll_bytes), "count": dict(self.coll_count),
                "total_bytes": sum(self.coll_bytes.values())}


@contextlib.contextmanager
def on_fake_model(ledger: Ledger):
    """While the dry run counts a program on fake tensors: the sLSTM
    prefill loop (``xlstm.slstm_scan``) runs as one op
    (``fake_slstm_scan``), and every remat checkpoint of the model
    (``transformer.checkpoint``) runs its recompute inside
    ``ledger.recomputation()``."""
    saved = xlstm.slstm_scan, transformer.checkpoint

    def checkpoint(fn, *args, **kwargs):
        return saved[1](fn, *args, context_fn=lambda: (
            contextlib.nullcontext(), ledger.recomputation()), **kwargs)

    xlstm.slstm_scan, transformer.checkpoint = fake_slstm_scan, checkpoint
    try:
        yield
    finally:
        xlstm.slstm_scan, transformer.checkpoint = saved


# ----------------------------------------------------------------------
# the sLSTM loop on the dry run's fake tensors
_SCAN_STATE = ("c", "n", "h", "m")
# per step, the (B, d) float32 tensors the loop's autograd keeps for its
# backward: the four gates, the stabilised input and forget factors
_SCAN_SAVED = 6
_scan_ops: dict = {}


def fake_slstm_scan(p, xz, xi, xf, xo, state, nh: int):
    """``xlstm.slstm_scan`` as one op, for ``FakeTensorMode`` only (a
    production-size dry run would run S x 12 layers of host steps): its
    outputs have the loop's shapes and types, the ledger books S steps
    of the four block-diagonal recurrent products (and twice that in
    the backward), and under grad it keeps ``_SCAN_SAVED`` (B, d) float32
    tensors a step for the backward, as the loop's autograd does."""
    op = _scan_op()
    keep = torch.is_grad_enabled() and any(
        t.requires_grad for t in (xz, xi, xf, xo, p["r_z"]))
    out = op(xz, xi, xf, xo, p["r_z"], p["r_i"], p["r_f"], p["r_o"],
             *(state[k] for k in _SCAN_STATE), nh, keep)
    return out[0], dict(zip(_SCAN_STATE, out[1:5]))


def _scan_op():
    if "fwd" in _scan_ops:
        return _scan_ops["fwd"]

    @torch.library.custom_op("repro_torch::slstm_scan", mutates_args=())
    def scan(xz: torch.Tensor, xi: torch.Tensor, xf: torch.Tensor,
             xo: torch.Tensor, r_z: torch.Tensor, r_i: torch.Tensor,
             r_f: torch.Tensor, r_o: torch.Tensor, c: torch.Tensor,
             n: torch.Tensor, h: torch.Tensor, m: torch.Tensor, nh: int,
             keep: bool) -> list[torch.Tensor]:
        raise NotImplementedError("the sLSTM scan op runs on fake tensors "
                                  "only; the model loops over steps")

    @scan.register_fake
    def _(xz, xi, xf, xo, r_z, r_i, r_f, r_o, c, n, h, m, nh, keep):
        B, S, d = xz.shape
        saved = (S, _SCAN_SAVED, B, d) if keep else (0,)
        return [xz.new_empty((B, S, d)), *(c.new_empty((B, d))
                                           for _ in range(4)),
                xz.new_empty(saved)]

    @torch.library.custom_op("repro_torch::slstm_scan_bwd", mutates_args=())
    def scan_bwd(dh: torch.Tensor, r_z: torch.Tensor,
                 saved: torch.Tensor) -> list[torch.Tensor]:
        raise NotImplementedError("fake tensors only")

    @scan_bwd.register_fake
    def _(dh, r_z, saved):
        B, S, d = dh.shape
        return [*(dh.new_empty((B, S, d)) for _ in range(4)),
                *(r_z.new_empty(r_z.shape) for _ in range(4)),
                *(dh.new_empty((B, d)) for _ in range(4))]

    def _flops(xz_shape, r_shape):
        B, S, d = xz_shape
        nh, dh, _ = r_shape
        return 4 * 2 * B * S * nh * dh * dh

    @register_flop_formula(torch.ops.repro_torch.slstm_scan)
    def _(xz, xi, xf, xo, r_z, *args, out_shape=None, **kwargs):
        return _flops(xz, r_z)

    @register_flop_formula(torch.ops.repro_torch.slstm_scan_bwd)
    def _(dh, r_z, saved, out_shape=None, **kwargs):
        return 2 * _flops(dh, r_z)

    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[4], output[5])

    def backward(ctx, grads):
        r_z, saved = ctx.saved_tensors
        g = scan_bwd(grads[0], r_z, saved)
        return (*g[:4], *g[4:8], *g[8:12], None, None)

    scan.register_autograd(backward, setup_context=setup_context)
    _scan_ops["fwd"] = scan
    return scan
