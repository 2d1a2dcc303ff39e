"""K4, the grouped SwiGLU expert GEMM (``kernels/moe_grouped.py``), on the
CPU: its plain version (``kernels/ref.py`` ``moe_grouped_ref`` with its
routing metadata, ``moe_plan_ref``) held against ``models/moe.py``
``routed``'s ``einsum`` and ``gather`` paths in float32 at 1e-5 — output
and kept assignments — at capacity factor 1.25 (drops) and E/k
(dropless, where it also equals the dense oracle ``moe_ref``), in one
dispatch group and in several, with experts that get no row, over two
expert slices that sum to the whole, at DeepSeek-like (64 experts top-6,
raw gates) and granite-like (32 top-8) routing at small widths.  Also:
the metadata's shapes are fixed by the call's shapes whatever the
routing, the tile shape follows the rows per expert, ``routed`` counts
T*k rows where it takes K4, and the source binds a context before it
encodes its tensor maps.  The CUDA kernels themselves run on the card
(``chip_smoke.py``'s ``parity`` phase).
"""
import types

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.port import PortMoEConfig  # noqa: E402
from repro_torch.kernels import moe_grouped as k4  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.layers import ParamFactory  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)
D, D_FF, T = 32, 48, 128
# name -> (experts, top-k, renormalised gates)
ROUTINGS = {"deepseek": (64, 6, False), "granite": (32, 8, True)}


def _cfg(routing, *, dispatch="einsum", factor=1.25, gs=T):
    E, k, norm = ROUTINGS[routing]
    e = PortMoEConfig(n_experts=E, top_k=k, n_shared=0, d_ff=D_FF,
                      capacity_factor=E / k if factor == "dropless"
                      else factor, group_size=gs, dispatch=dispatch,
                      norm_topk_prob=norm)
    return types.SimpleNamespace(moe=e, d_model=D, dtype="float32",
                                 activation="swiglu")


def _params(cfg, seed=0):
    return moe.init_moe(ParamFactory(torch.Generator().manual_seed(seed)),
                        cfg)


def _tokens(n=T, seed=1):
    return torch.randn((n, D), generator=torch.Generator().manual_seed(seed))


def _route(p, x, cfg):
    probs, idx, _ = moe._routing(p, x, cfg.moe)
    return probs, idx


def _pos(idx, cfg):
    gs = min(cfg.moe.group_size, idx.shape[0])
    G = idx.shape[0] // gs
    return moe._positions(idx.reshape(G, gs, -1),
                          cfg.moe.n_experts).reshape(idx.shape)


def _routed(p, x, probs, idx, cfg, gs, e0=0):
    """``routed``'s batched path, its output as (T, d)."""
    out, keep, C, G = moe.routed(p, x, probs, idx, cfg, gs, e0)
    return out.reshape(x.shape), keep, C, G


def _k4(p, x, probs, idx, cfg, e0=0):
    """K4's plain version on ``routed``'s capacity and groups."""
    gs = min(cfg.moe.group_size, x.shape[0])
    return ref.moe_grouped_ref(
        x, idx, _pos(idx, cfg), probs, p["wg_e"], p["wi_e"], p["wo_e"],
        capacity=moe._capacity(gs, cfg.moe), group_size=gs, e0=e0,
        return_plan=True)


def _kept(row_slot, n):
    out = torch.zeros(n, dtype=torch.bool)
    out[row_slot[row_slot >= 0].long()] = True
    return out


@pytest.mark.parametrize("routing", sorted(ROUTINGS))
@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("factor", [1.25, "dropless"])
@pytest.mark.parametrize("gs", [T, 32])
def test_plain_version_matches_routed(routing, dispatch, factor, gs):
    cfg = _cfg(routing, dispatch=dispatch, factor=factor, gs=gs)
    p, x = _params(cfg), _tokens()
    probs, idx = _route(p, x, cfg)
    want, keep, C, G = _routed(p, x, probs, idx, cfg, gs)
    got, row_slot, _ = _k4(p, x, probs, idx, cfg)
    assert G == T // gs
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(_kept(row_slot, idx.numel()), keep.reshape(-1))
    if factor == "dropless":
        assert bool(keep.all())
        dense, _ = moe.moe_ref(p, x[None], cfg)
        torch.testing.assert_close(got, dense[0], **TOL)
    else:
        assert not bool(keep.all()), "the case is meant to drop"


def _subset_routing(E, k, n, seed):
    """Each token's k distinct experts among the even ones, and gates."""
    gen = torch.Generator().manual_seed(seed)
    idx = torch.stack([2 * torch.randperm(E // 2, generator=gen)[:k]
                       for _ in range(n)])
    probs = torch.rand((n, k), generator=gen) + 0.1
    return probs, idx


@pytest.mark.parametrize("routing", sorted(ROUTINGS))
@pytest.mark.parametrize("factor", [1.25, "dropless"])
def test_experts_with_no_row(routing, factor):
    cfg = _cfg(routing, factor=factor, gs=32)
    E, k, _ = ROUTINGS[routing]
    p, x = _params(cfg), _tokens()
    probs, idx = _subset_routing(E, k, T, seed=3)
    want, keep, _, _ = _routed(p, x, probs, idx, cfg, 32)
    got, row_slot, tiles = _k4(p, x, probs, idx, cfg)
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(_kept(row_slot, idx.numel()), keep.reshape(-1))
    used = {e for e, _, _ in tiles.tolist() if e >= 0}
    assert used == {e for e in range(0, E, 2)}


@pytest.mark.parametrize("routing", sorted(ROUTINGS))
@pytest.mark.parametrize("factor", [1.25, "dropless"])
def test_two_slices_sum_to_the_whole(routing, factor):
    cfg = _cfg(routing, factor=factor, gs=32)
    E = ROUTINGS[routing][0]
    p, x = _params(cfg), _tokens()
    probs, idx = _route(p, x, cfg)
    whole, _, _, _ = _routed(p, x, probs, idx, cfg, 32)
    parts = []
    for e0 in (0, E // 2):
        sl = {n: p[n][e0:e0 + E // 2] for n in ("wg_e", "wi_e", "wo_e")}
        got, row_slot, _ = _k4(sl, x, probs, idx, cfg, e0=e0)
        want, _, _, _ = _routed(sl, x, probs, idx, cfg, 32, e0)
        torch.testing.assert_close(got, want, **TOL)
        live = row_slot[row_slot >= 0].long()
        assert bool(((idx.reshape(-1)[live] - e0) // (E // 2) == 0).all())
        parts.append(got)
    torch.testing.assert_close(parts[0] + parts[1], whole, **TOL)


def _routings(E, k, n):
    """Routings of one shape: random, the first k experts for every
    token, the even experts only."""
    gen = torch.Generator().manual_seed(5)
    rand = torch.stack([torch.randperm(E, generator=gen)[:k]
                        for _ in range(n)])
    first = torch.arange(k).repeat(n, 1)
    return {"random": rand, "first": first,
            "even": _subset_routing(E, k, n, seed=6)[1]}


@pytest.mark.parametrize("routing", sorted(ROUTINGS))
@pytest.mark.parametrize("n,gs", [(4, 4), (T, 32), (512, 512)])
def test_metadata_shapes_are_static(routing, n, gs):
    E, k, _ = ROUTINGS[routing]
    cfg = _cfg(routing, gs=gs)
    C = moe._capacity(gs, cfg.moe)
    tl = k4.tiling(n, k, E)
    for name, idx in _routings(E, k, n).items():
        pos = _pos(idx, cfg)
        row_slot, tiles = ref.moe_plan_ref(
            idx, pos, capacity=C, group_size=gs, e0=0, n_local=E,
            tile_rows=tl.rows, n_slots=tl.slots)
        assert row_slot.shape == (n * k,) and row_slot.dtype == torch.int32
        assert tiles.shape == (tl.slots, 3) and tiles.dtype == torch.int32
        kept = int((pos < C).sum())
        assert bool((row_slot[:kept] >= 0).all())
        assert bool((row_slot[kept:] == -1).all())
        live = tiles[tiles[:, 0] >= 0]
        assert bool((tiles[len(live):] == torch.tensor([-1, 0, 0])).all())
        assert int(live[:, 2].sum()) == kept, name
        assert bool((live[:, 2] >= 1).all() and (live[:, 2] <= tl.rows).all())
        # each expert's rows are one run, in expert order, tile after tile
        assert torch.equal(live[1:, 1], live[:-1, 1] + live[:-1, 2])
        assert bool((live[1:, 0] >= live[:-1, 0]).all())
        # the row of each kept assignment holds its expert
        slots = row_slot[:kept].long()
        row_expert = torch.repeat_interleave(live[:, 0], live[:, 2])
        assert torch.equal(idx.reshape(-1)[slots], row_expert.long())


@pytest.mark.parametrize("T_,k,E,want", [
    (4, 6, 64, (8, 67)),        # deepseek's decode step
    (8192, 6, 64, (128, 448)),  # deepseek's prefill, 16 groups of 512
    (4, 8, 32, (8, 36)),        # granite's decode step
    (512, 8, 32, (128, 64)),    # granite's prefill
    (512, 6, 64, (8, 448)),     # deepseek's float32 gate: 48 rows an expert
])
def test_tile_shape_follows_rows_per_expert(T_, k, E, want):
    assert tuple(k4.tiling(T_, k, E)) == want


@pytest.mark.parametrize("grouped", [True, False])
def test_counting_rows_counts_what_each_path_computes(monkeypatch, grouped):
    cfg = _cfg("deepseek", factor="dropless", gs=32)
    p, x = _params(cfg), _tokens()
    probs, idx = _route(p, x, cfg)
    want, _, C, G = _routed(p, x, probs, idx, cfg, 32)
    # on the CPU K4's op runs its plain version: the rule is forced to
    # reach it from ``routed``
    monkeypatch.setattr(moe, "_grouped", lambda *a: grouped)
    before = tuple(op.launches for op in ops.KERNELS)
    with moe.counting_rows() as count:
        got, keep, _, _ = _routed(p, x, probs, idx, cfg, 32)
    assert tuple(op.launches for op in ops.KERNELS) == before
    assert count.assignments == T * 6
    assert count.rows == (T * 6 if grouped else 64 * G * C)
    assert bool(keep.all())
    torch.testing.assert_close(got, want, **TOL)


def test_routed_keeps_the_batched_path_off_the_card():
    cfg = _cfg("granite")
    p, x = _params(cfg), _tokens()
    probs, _ = _route(p, x, cfg)
    assert not moe._grouped(p, x, probs, "swiglu")


@pytest.mark.parametrize("routing", sorted(ROUTINGS))
def test_op_routes_cpu_tensors_to_the_plain_version(routing):
    cfg = _cfg(routing, gs=32)
    p, x = _params(cfg), _tokens()
    probs, idx = _route(p, x, cfg)
    C = moe._capacity(32, cfg.moe)
    got = ops.moe_grouped(x, idx, _pos(idx, cfg), probs, p["wg_e"],
                          p["wi_e"], p["wo_e"], capacity=C, group_size=32)
    torch.testing.assert_close(got, _k4(p, x, probs, idx, cfg)[0], **TOL)


@pytest.mark.parametrize("routing", sorted(ROUTINGS))
def test_bf16_plain_version_is_within_bf16_tolerance(routing):
    cfg = _cfg(routing, factor="dropless", gs=32)
    p, x = _params(cfg), _tokens()
    probs, idx = _route(p, x, cfg)
    p16 = {n: w.bfloat16() for n, w in p.items() if n != "router"}
    p32 = {n: w.float() for n, w in p16.items()}
    x16 = x.bfloat16()
    got = _k4(p16, x16, probs, idx, cfg)[0]
    want = _k4(p32, x16.float(), probs, idx, cfg)[0]
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want, **BF16_TOL)


def test_source_binds_the_threads_context_before_encoding():
    """A pool thread may reach K4 first thing, and
    ``cuTensorMapEncodeTiled`` fails in a thread with no current context:
    a runtime call comes first."""
    src = (ops.CSRC / ops.MODULES["moe_grouped"].SOURCE).read_text()
    setter = src[src.index("cudaError_t set_smem("):]
    assert setter.index("cudaFuncSetAttribute") < setter.index("}")
    body = src[src.index("cudaError_t launch_bf16("):]
    assert body.index("set_smem(") < body.index("encode_weights(")
    assert ops.moe_grouped in ops.KERNELS
    assert k4.DEVICE_KERNELS_PER_CALL == 3
