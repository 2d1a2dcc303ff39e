"""The RG-LRU scan's backward in the port, held against the JAX package on
the CPU: the plain reverse walk, the ``torch.autograd.Function`` that
``ops.rglru_scan`` takes under grad, and the walk of the CUDA kernel K3b
(``kernels/csrc/rglru_scan_bwd.cu``) mirrored in plain PyTorch.

* ``ref.rglru_scan_bwd_ref`` against ``jax.vjp`` of
  ``repro.kernels.ref.ref_rglru_scan`` (a, b, h0) and of
  ``repro.models.rglru.rglru_scan`` (its ``lru`` params, x and h0, through
  the gates), within 1e-5, over B, S (0, 1, odd, 64), r, with and
  without h0 and dh_T; and equal (``torch.equal``) to torch autograd
  through ``ref.rglru_scan_ref``'s forward loop.
* ``ops.rglru_scan`` under grad on the CPU takes ``RGLRUScanFunction``,
  launches nothing and gives those same gradients; a full-depth
  recurrentgemma under remat runs the scan and its backward as often as
  the card's launch window in ``chip_smoke.py`` expects, with the same
  gradients as without remat.
* K3b's walk: ``plan_scan_bwd``'s boxes through its ring, last box
  first, the y box read one step early (zero before step 0, h0 written
  over that zero), each step a separately rounded add and two
  multiplies into staged da/db boxes clipped at S and r: bit for bit the
  plain version.  The plan covers every (row, channel, step) once and
  fits a block; ``check_inputs`` refuses what TMA cannot read; the
  source's constants are the host module's.
* The train launcher trains reduced recurrentgemma on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ref import ref_rglru_scan  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro_torch.checkpoint import flatten_with_paths  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rglru_scan_bwd as kmod  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import make_model, transformer  # noqa: E402
from repro_torch.models import rglru as prglru  # noqa: E402
from repro_torch.train import loss_and_grads  # noqa: E402

JAX_TOL = dict(atol=1e-5, rtol=1e-5)
H100_SMS = 132
NH, C_GATE = 2, 8.0              # the gates' heads and c at the model test


@pytest.fixture(scope="module")
def jax_vjps():
    """The reference's two scans and their VJPs, jitted once."""
    def scan_vjp(a, b, h0, dy, dhT):
        if h0 is None:
            (y, hT), back = jax.vjp(lambda a_, b_: ref_rglru_scan(a_, b_),
                                    a, b)
        else:
            (y, hT), back = jax.vjp(ref_rglru_scan, a, b, h0)
        return back((dy, dhT))

    def model_vjp(lru, x, h0, dy, dhT):
        def f(lru_, x_, h0_):
            return jrglru.rglru_scan(lru_, x_, NH, C_GATE, h0_)
        if h0 is None:
            (y, hT), back = jax.vjp(lambda l_, x_: f(l_, x_, None), lru, x)
        else:
            (y, hT), back = jax.vjp(f, lru, x, h0)
        return back((dy, dhT))
    return scan_vjp, model_vjp


def _np_inputs(seed, B, S, r, with_h0, with_dhT):
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, r))))).astype(
        np.float32)
    b = rng.standard_normal((B, S, r), dtype=np.float32)
    h0 = rng.standard_normal((B, r), dtype=np.float32) if with_h0 else None
    dy = rng.standard_normal((B, S, r), dtype=np.float32)
    dhT = rng.standard_normal((B, r), dtype=np.float32) if with_dhT else None
    return a, b, h0, dy, dhT


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


# ---------------------------------------------------------------------------
# the plain backward against JAX and against torch autograd
SHAPES = [(B, S, r) for B, r in ((1, 8), (3, 20)) for S in (0, 1, 37, 64)]
OPTIONAL = [(True, True), (True, False), (False, True), (False, False)]


@pytest.mark.parametrize("with_h0,with_dhT", OPTIONAL)
@pytest.mark.parametrize("B,S,r", SHAPES)
def test_plain_backward_matches_jax_vjp_of_the_reference_scan(
        jax_vjps, B, S, r, with_h0, with_dhT):
    a, b, h0, dy, dhT = _np_inputs(B * 31 + S * 7 + r, B, S, r, with_h0,
                                   with_dhT)
    y, _ = ref.rglru_scan_ref(_t(a), _t(b), _t(h0))
    da, db, dh0 = ref.rglru_scan_bwd_ref(_t(a), y, _t(h0), _t(dy), _t(dhT))
    want = jax_vjps[0](_j(a), _j(b), _j(h0), _j(dy),
                       _j(dhT if with_dhT else np.zeros((B, r), np.float32)))
    _close(da, want[0], **JAX_TOL)
    _close(db, want[1], **JAX_TOL)
    if with_h0:
        _close(dh0, want[2], **JAX_TOL)
    else:
        assert dh0 is None


def _lru(seed, r, nh):
    rng = np.random.default_rng(seed)
    rh = r // nh
    u = rng.uniform(0.9 ** 2, 0.999 ** 2, r)
    return {"lambda": np.log(np.exp(-np.log(u) / (2 * C_GATE)) - 1.0).astype(
                np.float32),
            "w_a": (rng.standard_normal((nh, rh, rh)) * rh ** -0.5).astype(
                np.float32),
            "b_a": rng.standard_normal(r).astype(np.float32) * 0.1,
            "w_x": (rng.standard_normal((nh, rh, rh)) * rh ** -0.5).astype(
                np.float32),
            "b_x": rng.standard_normal(r).astype(np.float32) * 0.1}


@pytest.mark.parametrize("with_h0,with_dhT", OPTIONAL)
@pytest.mark.parametrize("B,S,r", [s for s in SHAPES if s[1] > 0])
def test_model_scan_gradients_match_jax(jax_vjps, B, S, r, with_h0,
                                        with_dhT):
    """Through the gates: the reference's associative scan, differentiated
    by JAX, against the port's scan under autograd (the Function)."""
    lru = _lru(S + r, r, NH)
    rng = np.random.default_rng(B + S + r)
    x = rng.standard_normal((B, S, r), dtype=np.float32)
    _, _, h0, dy, dhT = _np_inputs(S * 3 + r, B, S, r, with_h0, with_dhT)
    want = jax_vjps[1]({k: _j(v) for k, v in lru.items()}, _j(x), _j(h0),
                       _j(dy),
                       _j(dhT if with_dhT else np.zeros((B, r), np.float32)))
    tl = {k: _t(v).requires_grad_(True) for k, v in lru.items()}
    tx = _t(x).requires_grad_(True)
    th0 = None if h0 is None else _t(h0).requires_grad_(True)
    y, hT = prglru.rglru_scan(tl, tx, NH, C_GATE, th0)
    assert type(y.grad_fn).__name__ == "RGLRUScanFunctionBackward"
    outs, cots = [y], [_t(dy)]
    if with_dhT:
        outs, cots = outs + [hT], cots + [_t(dhT)]
    leaves = [*tl.values(), tx] + ([th0] if with_h0 else [])
    got = torch.autograd.grad(outs, leaves, cots)
    for k, g in zip(tl, got):
        scale = max(1.0, float(np.abs(np.asarray(want[0][k])).max()))
        _close(g, want[0][k], rtol=0, atol=JAX_TOL["atol"] * scale)
    _close(got[len(tl)], want[1], **JAX_TOL)
    if with_h0:
        _close(got[-1], want[2], **JAX_TOL)


def _autograd_plain(a, b, h0, dy, dhT):
    """(da, db, dh0) by torch autograd through the plain forward loop."""
    leaves = [a.clone().requires_grad_(True), b.clone().requires_grad_(True)]
    if h0 is not None:
        leaves.append(h0.clone().requires_grad_(True))
    y, hT = ref.rglru_scan_ref(*leaves[:2], leaves[2] if h0 is not None
                               else None)
    outs, cots = [y], [dy]
    if dhT is not None:
        outs, cots = outs + [hT], cots + [dhT]
    return torch.autograd.grad(outs, leaves, cots, allow_unused=True)


@pytest.mark.parametrize("with_h0,with_dhT", OPTIONAL)
@pytest.mark.parametrize("B,S,r", [s for s in SHAPES if s[1] > 0])
def test_plain_backward_equals_autograd_of_the_plain_forward(B, S, r,
                                                             with_h0,
                                                             with_dhT):
    a, b, h0, dy, dhT = (_t(x) for x in _np_inputs(S + 5 * r, B, S, r,
                                                    with_h0, with_dhT))
    y, _ = ref.rglru_scan_ref(a, b, h0)
    got = ref.rglru_scan_bwd_ref(a, y, h0, dy, dhT)
    want = _autograd_plain(a, b, h0, dy, dhT)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if with_h0:
        assert torch.equal(got[2], want[2])


def test_plain_backward_of_an_empty_sequence_hands_dhT_to_h0():
    dhT = torch.randn(2, 8)
    a = torch.zeros(2, 0, 8)
    da, db, dh0 = ref.rglru_scan_bwd_ref(a, a, torch.zeros(2, 8), a, dhT)
    assert da.shape == db.shape == (2, 0, 8)
    assert torch.equal(dh0, dhT)
    _, _, dh0 = ref.rglru_scan_bwd_ref(a, a, torch.zeros(2, 8), a, None)
    assert torch.equal(dh0, torch.zeros(2, 8))


# ---------------------------------------------------------------------------
# the Function ops.rglru_scan takes under grad
@pytest.mark.parametrize("with_h0,with_dhT", OPTIONAL)
def test_ops_scan_under_grad_takes_the_function_and_launches_nothing(
        with_h0, with_dhT):
    a, b, h0, dy, dhT = (_t(x) for x in _np_inputs(3, 2, 40, 96, with_h0,
                                                    with_dhT))
    leaves = [a.clone().requires_grad_(True), b.clone().requires_grad_(True)]
    if with_h0:
        leaves.append(h0.clone().requires_grad_(True))
    before = tuple(op.launches for op in ops.KERNELS)
    for forced in (False, True):
        with ops.force_reference() if forced else torch.enable_grad():
            y, hT = ops.rglru_scan(*leaves[:2],
                                   leaves[2] if with_h0 else None)
            assert type(y.grad_fn).__name__ == "RGLRUScanFunctionBackward"
            outs, cots = [y], [dy]
            if with_dhT:
                outs, cots = outs + [hT], cots + [dhT]
            got = torch.autograd.grad(outs, leaves, cots)
        want = _autograd_plain(a, b, h0, dy, dhT)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert tuple(op.launches for op in ops.KERNELS) == before
    with torch.no_grad():                        # serving: no Function
        assert ops.rglru_scan(*leaves[:2])[0].grad_fn is None
    assert ops.rglru_scan_bwd in ops.KERNELS
    assert ops.MODULES["rglru_scan_bwd"] is kmod


def test_function_with_an_unused_state_passes_no_dhT(monkeypatch):
    """A dh_T nobody used stays None (a null pointer for K3b)."""
    seen = []
    bwd = ref.rglru_scan_bwd_ref
    monkeypatch.setattr(ref, "rglru_scan_bwd_ref",
                        lambda *a: seen.append(a[4]) or bwd(*a))
    a = torch.rand(2, 5, 8, requires_grad=True)
    y, _ = ops.rglru_scan(a, torch.randn(2, 5, 8))
    y.sum().backward()
    assert seen == [None] and a.grad.shape == a.shape


def test_function_with_only_the_final_state_used():
    """No dy reaches the backward (None): it walks zeros."""
    a, b, h0, _, dhT = (_t(x) for x in _np_inputs(9, 2, 7, 8, True, True))
    leaves = [t.clone().requires_grad_(True) for t in (a, b, h0)]
    _, hT = ops.rglru_scan(*leaves)
    got = torch.autograd.grad(hT, leaves, dhT)
    want = _autograd_plain(a, b, h0, torch.zeros_like(a), dhT)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("with_h0", [True, False])
def test_kernel_side_gets_cotangents_it_can_read(monkeypatch, with_h0):
    """On the kernel side, reductions of y and h_T hand the backward
    expanded cotangents (strides of 0): K3b gets a dy and a dh_T that
    ``check_inputs`` refuses only for not lying on the card.  The
    kernels are stood in for by their plain versions."""
    seen = []

    def k3b(a, y, h0, dy, dhT=None):
        with pytest.raises(ValueError, match="CUDA device"):
            kmod.check_inputs(a, y, dy, h0, dhT)
        seen.append((dy.stride(), dhT.stride()))
        return ref.rglru_scan_bwd_ref(a, y, h0, dy, dhT)
    monkeypatch.setattr(ops, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(ops.rglru_scan, "launch_kernel", ref.rglru_scan_ref)
    monkeypatch.setattr(ops, "rglru_scan_bwd", k3b)
    a, b, h0, _, _ = (_t(x) for x in _np_inputs(11, 2, 9, 8, with_h0, False))
    leaves = [t.clone().requires_grad_(True) for t in (a, b, h0)
              if t is not None]
    y, hT = ops.rglru_scan(*leaves[:2], leaves[2] if with_h0 else None)
    got = torch.autograd.grad(y.sum() + hT.sum(), leaves)
    assert len(seen) == 1
    want = _autograd_plain(a, b, h0, torch.ones_like(a),
                           torch.ones(2, 8))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _full_depth_rgemma():
    """recurrentgemma-2b's 26 layers and both segment shapes at a CPU
    width, float32."""
    full = get_config("recurrentgemma-2b")
    cfg = dataclasses.replace(full.reduced(d_model=64, vocab=128),
                              n_layers=full.n_layers, segments=full.segments,
                              dtype="float32")
    model = make_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 128, (1, 17)).astype(np.int64)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "targets": torch.from_numpy(toks[:, 1:])}
    return cfg, model, params, batch


def test_full_depth_remat_runs_the_scan_as_the_card_window_expects(
        monkeypatch):
    """Segment 0 (8 super-blocks of rglru, rglru, attn_local) remats in
    groups of k = 2: 3k - 1 super-block runs a group; segment 1 (one
    rglru, rglru) 2 runs.  Per microbatch: the scan 44 times and its
    backward 18, attention 20 and its backward 8 (``chip_smoke.py``'s
    window is twice that, 2 microbatches a step).  Remat on and off give
    the same gradients bit for bit."""
    cfg, model, params, batch = _full_depth_rgemma()
    assert transformer._sqrt_divisor(8) == 2
    calls = {"rglru_scan_ref": 0, "rglru_scan_bwd_ref": 0,
             "flash_attention_ref": 0, "flash_attention_bwd_ref": 0}
    for name in calls:
        fn = getattr(ref, name)
        monkeypatch.setattr(ref, name, lambda *a, _n=name, _f=fn, **k: (
            calls.__setitem__(_n, calls[_n] + 1) or _f(*a, **k)))
    on = loss_and_grads(model, params, batch, seq_chunk=16)
    assert calls == {"rglru_scan_ref": 44, "rglru_scan_bwd_ref": 18,
                     "flash_attention_ref": 20, "flash_attention_bwd_ref": 8}
    off = loss_and_grads(make_model(dataclasses.replace(cfg, remat=False),
                                    device="cpu"), params, batch,
                         seq_chunk=16)
    assert torch.equal(on[0], off[0])
    a, b = flatten_with_paths(on[2]), flatten_with_paths(off[2])
    assert all(torch.equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------------------
# the plan
PLAN_SHAPES = [(2, 1024, 2560), (1, 4096, 2560), (4, 2048, 2560),
               (2, 77, 2500), (1, 300, 8), (3, 1, 64), (1, 1000, 100),
               (2, 0, 64)]


def _blocks(B, r, plan):
    for row in range(B):
        for tile in range(plan.tiles):
            c0 = tile * plan.channels
            yield row, c0, min(r, c0 + plan.channels)


@pytest.mark.parametrize("B,S,r", PLAN_SHAPES)
@pytest.mark.parametrize("n_sm", [H100_SMS, 1, 16])
def test_plan_covers_every_row_channel_and_step_once(B, S, r, n_sm):
    plan = kmod.plan_scan_bwd(B, S, r, n_sm)
    assert plan.channels in kmod.TILE_CHANNELS
    assert plan.steps * plan.channels * 4 == kmod.BOX_BYTES
    assert plan.tiles == -(-r // plan.channels)
    assert plan.blocks == B * plan.tiles
    assert 1 <= plan.stages <= kmod.MAX_STAGES
    assert plan.stages <= max(1, -(-S // plan.steps))
    if S > plan.steps:
        assert plan.stages >= 2             # one walked, one in flight
    count = np.zeros((B, S, r), np.int32)
    boxes = -(-S // plan.steps)
    for row, c0, c1 in _blocks(B, r, plan):
        for j in range(boxes - 1, -1, -1):  # last box first
            t0, t1 = j * plan.steps, min(S, (j + 1) * plan.steps)
            count[row, t0:t1, c0:c1] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("B,S,r", PLAN_SHAPES)
def test_plan_fits_a_block_and_reads_only_its_arguments(B, S, r):
    plan = kmod.plan_scan_bwd(B, S, r, H100_SMS)
    assert plan.smem_bytes <= kmod.SMEM_LIMIT == 232448
    # the ring, the staged (da, db) pairs, the barriers
    assert plan.smem_bytes == (kmod.SMEM_ALIGN + plan.stages * kmod.STAGE_BYTES
                               + kmod.OUT_BUFFERS * 2 * kmod.BOX_BYTES
                               + 8 * plan.stages)
    assert plan == kmod.plan_scan_bwd(B, S, r, H100_SMS)


def test_plan_fills_the_card_at_the_training_microbatch():
    for B, S in ((2, 1024), (1, 4096)):
        plan = kmod.plan_scan_bwd(B, S, 2560, H100_SMS)
        assert plan.blocks >= H100_SMS
        per_sm = -(-plan.blocks // H100_SMS)
        assert per_sm * plan.smem_bytes <= 228 * 1024
        # tens of KB of loads in flight on every SM
        assert per_sm * (plan.stages - 1) * kmod.STAGE_BYTES >= 32 * 1024
    main = kmod.plan_scan_bwd(2, 1024, 2560, H100_SMS)
    assert (main.channels, main.steps, main.blocks) == (32, 32, 160)


# ---------------------------------------------------------------------------
# the kernel's walk, mirrored
def scan_bwd_mirror(a, y, h0, dy, dhT, plan):
    """(da, db, dh0) as K3b computes them: block by block, the boxes last
    first through a ring of ``plan.stages`` slots refilled as the walk
    leaves them; each slot holds a box of a and of dy at the box's steps
    and one of y a step earlier, zero-filled outside [0, S) and past r,
    with h0 written over y's zero before step 0; each step a separately
    rounded add and two multiplies into staged da and db boxes that are
    stored once walked, clipped at S and r."""
    B, S, r = a.shape
    C, T, K = plan.channels, plan.steps, plan.stages
    boxes = -(-S // T)
    da = torch.full((B, S, r), float("nan"))
    db = torch.full((B, S, r), float("nan"))
    dh0 = None if h0 is None else torch.full((B, r), float("nan"))
    for row, c0, c1 in _blocks(B, r, plan):
        n = c1 - c0
        ring = [None] * K

        def box(src, start):              # TMA: zero outside [0, S), past r
            out = torch.zeros((T, C))
            lo, hi = max(0, start), min(S, start + T)
            if hi > lo:
                out[lo - start:hi - start, :n] = src[row, lo:hi, c0:c1]
            return out

        def load(k):
            j = boxes - 1 - k
            assert ring[k % K] is None, "a stage refilled before it was walked"
            ring[k % K] = (j, box(a, j * T), box(y, j * T - 1), box(dy, j * T))

        for k in range(min(K, boxes)):
            load(k)
        c = torch.zeros(C)
        if dhT is not None:
            c[:n] = dhT[row, c0:c1]
        for k in range(boxes):
            j, a_box, h_box, dy_box = ring[k % K]
            assert j == boxes - 1 - k, "the walk read a stage of another box"
            if j == 0 and h0 is not None:
                h_box[0, :n] = h0[row, c0:c1]
            t0 = j * T
            steps = min(T, S - t0)
            da_box = torch.full((T, C), float("nan"))
            db_box = torch.full((T, C), float("nan"))
            for u in range(steps - 1, -1, -1):
                g = torch.add(dy_box[u], c)
                db_box[u] = g
                da_box[u] = torch.mul(g, h_box[u])
                c = torch.mul(a_box[u], g)
            da[row, t0:t0 + steps, c0:c1] = da_box[:steps, :n]
            db[row, t0:t0 + steps, c0:c1] = db_box[:steps, :n]
            ring[k % K] = None
            if k + K < boxes:
                load(k + K)
        if dh0 is not None:
            dh0[row, c0:c1] = c[:n]
    return da, db, dh0


# S at and around one box and the ring's depth (n_sm 1 puts every block
# on one SM: B 2, r 64 is 4 blocks of 32 channels, 32 steps a box, a ring
# of 2 stages; B 1, r 100 at 132 SMs is 7 blocks of 16 channels, the last
# ragged, 64 steps a box, 10 stages), r below a tile, S 0 and 1
MIRROR_EDGES = ([(2, S, 64, 1) for S in (1, 31, 32, 33, 63, 64, 65, 200)]
                + [(1, S, 100, H100_SMS) for S in (63, 64, 65, 639, 640, 641)]
                + [(1, 300, 8, H100_SMS), (3, 70, 36, H100_SMS),
                   (2, 0, 64, H100_SMS)])


@pytest.mark.parametrize("with_h0,with_dhT", [(True, True), (False, False)])
@pytest.mark.parametrize("B,S,r,n_sm", MIRROR_EDGES)
def test_mirror_equals_plain_backward_bit_for_bit(B, S, r, n_sm, with_h0,
                                                  with_dhT):
    plan = kmod.plan_scan_bwd(B, S, r, n_sm)
    if (B, r, n_sm) == (2, 64, 1):
        assert (plan.channels, plan.steps) == (32, 32)
        assert plan.stages == min(2, max(1, -(-S // 32)))
    elif (B, r) == (1, 100):
        assert (plan.channels, plan.steps) == (16, 64)
        assert plan.stages == min(10, -(-S // 64))
    a, b, h0, dy, dhT = (_t(x) for x in _np_inputs(B * 7 + S * 3 + r, B, S,
                                                    r, with_h0, with_dhT))
    y, _ = ref.rglru_scan_ref(a, b, h0)
    got = scan_bwd_mirror(a, y, h0, dy, dhT, plan)
    want = ref.rglru_scan_bwd_ref(a, y, h0, dy, dhT)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if with_h0:
        assert torch.equal(got[2], want[2])
    else:
        assert got[2] is None and want[2] is None


# ---------------------------------------------------------------------------
# what the kernel takes
def test_check_inputs_refuses_what_tma_cannot_read():
    base = torch.zeros((2, 16, 12))
    flat = torch.zeros(2 * 16 * 12 + 1)
    cases = [
        (base[..., :10], "r % 4"),
        (base.transpose(1, 2).contiguous().transpose(1, 2), "contiguous"),
        (flat[1:].view(2, 16, 12), "aligned"),
        (torch.zeros((2, 16, 10))[..., :8], "multiples of 16"),
        (torch.zeros((2, 1, 12)).expand(2, 16, 12), "multiples of 16"),
    ]
    for bad, match in cases:
        ok = torch.zeros(bad.shape)
        for args in ((bad, ok, ok), (ok, bad, ok), (ok, ok, bad)):
            with pytest.raises(ValueError, match=match):
                kmod.check_inputs(*args)
    with pytest.raises(ValueError, match="contiguous"):
        kmod.check_inputs(base, base, base, torch.zeros((12, 2)).t())
    with pytest.raises(ValueError, match="contiguous"):
        kmod.check_inputs(base, base, base, None, torch.zeros((12, 2)).t())
    with pytest.raises(ValueError, match="one"):
        kmod.check_inputs(base, base, torch.zeros((2, 15, 12)))
    with pytest.raises(ValueError, match="dhT"):
        kmod.check_inputs(base, base, base, None, torch.zeros((2, 8)))
    with pytest.raises(TypeError, match="float32"):
        kmod.check_inputs(base, base, base.double())
    # a strided view TMA can read is taken up to the device check
    view = torch.zeros((2, 16, 24))[..., :12]
    with pytest.raises(ValueError, match="CUDA device"):
        kmod.check_inputs(base, base, view, torch.zeros((2, 12)),
                          torch.zeros((2, 12)))


def test_cotangents_of_layouts_tma_cannot_read_are_copied():
    expanded = torch.zeros((2, 1, 8)).expand(2, 16, 8)
    assert not ops._tma_readable(expanded).data_ptr() == expanded.data_ptr()
    assert ops._tma_readable(expanded).is_contiguous()
    view = torch.zeros((2, 16, 24))[..., :12]
    assert ops._tma_readable(view) is view


def test_source_constants_are_the_host_modules():
    src = (ops.CSRC / kmod.SOURCE).read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", src))
    assert consts["BOX_BYTES"] == str(kmod.BOX_BYTES)
    assert consts["STAGE_BYTES"] == "3 * BOX_BYTES"
    assert consts["OUT_BUFFERS"] == str(kmod.OUT_BUFFERS)
    assert consts["MAX_STAGES"] == str(kmod.MAX_STAGES)
    assert consts["SMEM_ALIGN"] == str(kmod.SMEM_ALIGN)
    # separately rounded steps, in the plain version's order
    body = src[src.index("void step_back"):]
    body = body[:body.index("}")]
    assert re.findall(r"__f(add|mul)_rn", body) == ["add", "mul", "mul"]
    assert "fma" not in body.lower()
    # a runtime call binds the thread's context before the tensor maps
    # are encoded: autograd calls the backward on a thread of its own
    launch = src[src.index("cudaError_t launch("):]
    assert (launch.index("cudaFuncSetAttribute")
            < launch.index("encode_fn()") < launch.index("encode_map_3d"))
    n_args = src[src.index("int rglru_scan_bwd("):]
    n_args = n_args[:n_args.index(")")].count(",") + 1
    assert n_args == len(kmod.ARGTYPES)


# ---------------------------------------------------------------------------
# the launcher
def test_train_launcher_trains_recurrentgemma_on_cpu(capsys):
    hist = train_launcher.main(["--device", "cpu", "--arch",
                                "recurrentgemma-2b", "--steps", "3",
                                "--batch", "2", "--seq", "32"])
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    assert "recurrentgemma-2b" in capsys.readouterr().out
