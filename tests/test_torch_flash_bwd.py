"""The attention backward of the port held against the reference's custom
VJP (``repro.models.layers.flash_attention``, whose backward is
``_flash_bwd_rule``), on the CPU.

* ``kernels.ref.flash_attention_ref(return_lse=True)``'s row log-sum-exp
  against the reference's ``_flash_fwd_impl``, and
  ``flash_attention_bwd_ref``'s (dq, dk, dv) against ``jax.vjp`` of the
  reference, over G in {1, 2, 4}, causal or not, windows, softcaps,
  dh != dv and bfloat16, at the kernel tolerances of
  ``tests/test_kernels.py`` (float32 2e-5, bfloat16 3e-2).
* The port's ``FlashAttentionFunction`` (what ``ops.flash_attention``
  takes under autograd) against autograd through the plain forward.
* K1b's tiling (``kernels/csrc/flash_attention_bwd.cu``), mirrored in
  plain PyTorch: D by rows, dk/dv per (key tile, query head) over only
  the query tiles that can see the key tile, summed over G in head order,
  dq per query tile over only the key tiles it can see.  The mirror uses
  the kernel's integer formulas for the skipped ranges, and every skipped
  tile pair is checked to hold no visible pair.
* K1b's bfloat16 body, mirrored: float32 values split into three bf16
  terms rebuild them exactly; S and dP from the bf16 inputs and P and dS
  split for the dv, dk and dq products, over the body's own tile walk,
  match the float32 backward within 2e-5, and their bf16 cast passes
  ``chip_smoke.py``'s rule for K1b's bf16 gradients; the tile table
  matches the source's.

Inputs are made with numpy from a seed and handed to both packages.
"""
import functools
import importlib.util
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# (B, Sq, Sk, Hq, Hkv, dh, dv, causal, window, softcap, q_offset)
CASES = {
    "mha": (2, 48, 48, 2, 2, 16, 16, True, None, None, 0),
    "gqa2": (2, 48, 48, 4, 2, 16, 16, True, None, None, 0),
    "gqa4_window": (1, 64, 64, 8, 2, 32, 32, True, 20, None, 0),
    "softcap": (2, 48, 48, 4, 2, 16, 16, True, None, 5.0, 0),
    "window_softcap": (1, 64, 64, 4, 1, 32, 32, True, 24, 10.0, 0),
    "dh_ne_dv": (1, 32, 32, 4, 2, 24, 8, True, None, None, 0),
    "non_causal": (2, 32, 32, 4, 4, 16, 16, False, None, None, 0),
    "q_offset": (1, 16, 48, 4, 2, 16, 16, True, 40, None, 32),
}


def _pair(rng, shape, dtype):
    """The same values as a jnp array and a torch tensor of ``dtype``."""
    x = jnp.asarray(rng.standard_normal(shape, dtype=np.float32)).astype(
        JNP[dtype])
    return x, torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        TORCH[dtype])


def _inputs(case, dtype, seed=0):
    B, Sq, Sk, Hq, Hkv, dh, dv, causal, window, softcap, q_offset = case
    rng = np.random.default_rng(seed)
    q = _pair(rng, (B, Sq, Hq, dh), dtype)
    k = _pair(rng, (B, Sk, Hkv, dh), dtype)
    v = _pair(rng, (B, Sk, Hkv, dv), dtype)
    do = _pair(rng, (B, Sq, Hq, dv), dtype)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=None,
              q_offset=q_offset)
    return q, k, v, do, kw


def _close(port, want, dtype):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_lse_and_backward_match_the_reference_vjp(name, dtype):
    (jq, q), (jk, k), (jv, v), (jdo, do), kw = _inputs(CASES[name], dtype)
    chunks = dict(q_chunk=16, kv_chunk=16)
    jout, jlse = jlayers._flash_fwd_impl(
        jq, jk, jv, kw["causal"], kw["window"], kw["softcap"], kw["scale"],
        chunks["q_chunk"], chunks["kv_chunk"], kw["q_offset"])
    out, lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    B, Sq, Hq, _ = q.shape
    assert lse.dtype == torch.float32 and lse.shape == (B, Hq, Sq)
    _close(lse, np.asarray(jlse).reshape(B, Hq, Sq), dtype)
    _close(out, jout, dtype)

    _, vjp = jax.vjp(lambda a, b, c: jlayers.flash_attention(
        a, b, c, **kw, **chunks), jq, jk, jv)
    want = vjp(jdo)
    got = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
        _close(g, w, dtype)


@pytest.mark.parametrize("name", ["gqa4_window", "window_softcap",
                                  "q_offset", "dh_ne_dv"])
def test_autograd_function_matches_autograd_through_the_plain_forward(name):
    """On CPU tensors that require grad ``ops.flash_attention`` runs the
    autograd Function (plain forward with lse, plain VJP); its gradients
    equal autograd's through ``flash_attention_ref``."""
    (_, q), (_, k), (_, v), (_, do), kw = _inputs(CASES[name], "float32", 1)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    out = ops.flash_attention(q, k, v, **kw)
    assert out.grad_fn is not None
    assert type(out.grad_fn).__name__.startswith("FlashAttentionFunction")
    got = torch.autograd.grad(out, (q, k, v), do)
    want = torch.autograd.grad(ref.flash_attention_ref(q, k, v, **kw),
                               (q, k, v), do)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL["float32"])
    with torch.no_grad():                      # serving: no Function
        assert ops.flash_attention(q, k, v, **kw).grad_fn is None


def test_force_reference_keeps_the_plain_backward():
    """Under ``force_reference()`` the Function takes the plain versions
    on both sides; on the CPU that is also the default."""
    (_, q), (_, k), (_, v), (_, do), kw = _inputs(CASES["gqa2"], "float32", 2)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    before = tuple(op.launches for op in ops.KERNELS)
    with ops.force_reference():
        a = torch.autograd.grad(ops.flash_attention(q, k, v, **kw),
                                (q, k, v), do)
    b = torch.autograd.grad(ops.flash_attention(q, k, v, **kw), (q, k, v), do)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert tuple(op.launches for op in ops.KERNELS) == before
    assert ops.flash_attention_bwd in ops.KERNELS
    assert ops.MODULES["flash_attention_bwd"].SOURCE == "flash_attention_bwd.cu"


# ---------------------------------------------------------------------------
# K1b's tiling, mirrored
def kernel_tiles(dh, dv):
    """(BM, BN) of the kernel's ``with_tile``: 64 x 64 up to dh 192 / dv
    128, 32 x 32 beyond."""
    return (64, 64) if dh <= 192 and dv <= 128 else (32, 32)


def dkdv_row_range(n0, BN, BM, Sq, causal, window, q_offset):
    """The query rows the dkdv kernel walks for key tile n0 (its ints)."""
    m_begin, m_end = 0, Sq
    if causal:
        m_begin = max(0, n0 - q_offset)
    if window:
        m_end = min(Sq, n0 + BN - 1 + window - q_offset)
    return (m_begin // BM) * BM, m_end


def dq_key_range(q0, BM, BN, Sq, Sk, causal, window, q_offset):
    """The keys the dq kernel walks for query tile q0 (its ints)."""
    rows = min(BM, Sq - q0)
    q_lo = q_offset + q0
    q_hi = q_lo + rows - 1
    n_begin, n_end = 0, Sk
    if causal:
        n_end = min(Sk, q_hi + 1)
    if window:
        n_begin = max(0, q_lo - window + 1)
    return (n_begin // BN) * BN, n_end


def _visible(rows, keys, causal, window, q_offset):
    qpos = q_offset + rows[:, None]
    ok = torch.ones((len(rows), len(keys)), dtype=torch.bool)
    if causal:
        ok &= keys[None, :] <= qpos
    if window:
        ok &= qpos - keys[None, :] < window
    return ok


def _tile_scores(qt, kt, dot, vt, L, Dr, rows, keys, kw, scale):
    """p and ds of one (query tile, key tile) pair, as probs_and_ds."""
    s = qt @ kt.T * scale
    t = None
    if kw["softcap"] is not None:
        t = torch.tanh(s / kw["softcap"])
        s = kw["softcap"] * t
    vis = _visible(rows, keys, kw["causal"], kw["window"], kw["q_offset"])
    pr = torch.where(vis, torch.exp(s - L[:, None]), torch.zeros(()))
    ds = pr * (dot @ vt.T - Dr[:, None])
    if t is not None:
        ds = ds * (1 - t * t)
    return pr, ds, vis


def k1b_mirror(q, k, v, out, lse, do, kw, skipped):
    """K1b's four kernels in float32 plain PyTorch; appends each tile pair
    a kernel skips to ``skipped`` as (rows, keys)."""
    B, Sq, Hq, dh = q.shape
    _, Sk, Hkv, dv = v.shape
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(dh) if kw["scale"] is None else kw["scale"]
    BM, BN = kernel_tiles(dh, dv)
    qf, kf, vf = q.float(), k.float(), v.float()
    dof, of = do.float(), out.float()
    D = (dof * of).sum(-1).permute(0, 2, 1)                 # (B, Hq, Sq)
    part = torch.zeros((B, Sk, Hq, dh + dv))
    dq = torch.zeros((B, Sq, Hq, dh))
    cw = dict(causal=kw["causal"], window=kw["window"],
              q_offset=kw["q_offset"])
    for b in range(B):
        for h in range(Hq):
            hk = h // G
            # dkdv: one block per key tile of this query head
            for n0 in range(0, Sk, BN):
                keys = torch.arange(n0, min(n0 + BN, Sk))
                m_begin, m_end = dkdv_row_range(n0, BN, BM, Sq, **cw)
                for m0 in range(0, Sq, BM):
                    rows = torch.arange(m0, min(m0 + BM, Sq))
                    if not m_begin <= m0 < m_end:
                        skipped.append((rows, keys))
                        continue
                    pr, ds, _ = _tile_scores(
                        qf[b, rows, h], kf[b, keys, hk], dof[b, rows, h],
                        vf[b, keys, hk], lse[b, h, rows], D[b, h, rows], rows,
                        keys, kw, scale)
                    part[b, keys, h, :dh] += ds.T @ qf[b, rows, h] * scale
                    part[b, keys, h, dh:] += pr.T @ dof[b, rows, h]
            # dq: one block per query tile
            for q0 in range(0, Sq, BM):
                rows = torch.arange(q0, min(q0 + BM, Sq))
                n_begin, n_end = dq_key_range(q0, BM, BN, Sq, Sk, **cw)
                for n0 in range(0, Sk, BN):
                    keys = torch.arange(n0, min(n0 + BN, Sk))
                    if not n_begin <= n0 < n_end:
                        skipped.append((rows, keys))
                        continue
                    _, ds, _ = _tile_scores(
                        qf[b, rows, h], kf[b, keys, hk], dof[b, rows, h],
                        vf[b, keys, hk], lse[b, h, rows], D[b, h, rows], rows,
                        keys, kw, scale)
                    dq[b, rows, h] += ds @ kf[b, keys, hk] * scale
    # the reduce kernel: the G heads of each KV head, in head order
    grouped = part.reshape(B, Sk, Hkv, G, dh + dv)
    acc = torch.zeros((B, Sk, Hkv, dh + dv))
    for g in range(G):
        acc = acc + grouped[:, :, :, g]
    return (dq.to(q.dtype), acc[..., :dh].to(k.dtype),
            acc[..., dh:].to(v.dtype))


# (B, Sq, Sk, Hq, Hkv, dh, dv, causal, window, softcap, q_offset): shapes
# that cross the kernel's tiles, in both tile sizes (64 and, at dh 256, 32)
MIRROR_CASES = {
    "causal_3_tiles": (1, 150, 150, 4, 2, 16, 16, True, None, None, 0),
    "window_across_tiles": (1, 200, 200, 2, 1, 32, 32, True, 70, 20.0, 0),
    "q_offset_window": (1, 70, 300, 2, 1, 16, 16, True, 100, None, 230),
    "dh256_tiles_of_32": (1, 100, 100, 2, 1, 256, 256, True, 40, None, 0),
    "non_causal_window": (1, 130, 130, 2, 2, 16, 8, False, 50, None, 0),
}


@pytest.mark.parametrize("name", sorted(MIRROR_CASES))
def test_k1b_tiling_mirror_matches_the_plain_backward(name):
    (_, q), (_, k), (_, v), (_, do), kw = _inputs(MIRROR_CASES[name],
                                                  "float32", 3)
    out, lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    skipped = []
    got = k1b_mirror(q, k, v, out, lse, do, kw, skipped)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL["float32"])
    # a skipped tile pair holds no visible (row, key) pair
    cw = dict(causal=kw["causal"], window=kw["window"],
              q_offset=kw["q_offset"])
    assert all(not _visible(rows, keys, **cw).any() for rows, keys in skipped)
    if kw["causal"] or kw["window"]:
        assert skipped, "the case exercises no tile skipping"


# ---------------------------------------------------------------------------
# K1b's bfloat16 body: float32 operands split into bf16 terms, mirrored
SPLIT_TERMS = 3      # bf16 terms per float32 operand (the source's TERMS)


def bf16_tiles(dh, dv):
    """(DHT, DVT, BM, SPLIT, KN) of the bf16 body at (dh, dv), as the
    source's ``with_wgmma_tile`` picks them: head-dim tiles, the query
    rows per dkdv tile, whether dk and dv take a block each, and the keys
    per dq tile (64 keys per dkdv block and 64 rows per dq block)."""
    if dh <= 64 and dv <= 64:
        return 64, 64, 64, 0, 64
    if dh <= 128 and dv <= 128:
        return 128, 128, 64, 1, 64
    if dh <= 192 and dv <= 128:
        return 192, 128, 32, 1, 32
    return 256, 256, 32, 1, 32


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    """``chip_smoke.py`` as a module (it imports only the standard library
    at its top), for its bf16 gradient rule ``_bf16_grad_errs``."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_rules", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def split_terms(x, terms=None):
    """The bf16 body's split of float32 values (``split_frags``): hi =
    bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), as float32."""
    out, rest = [], x
    for _ in range(terms or SPLIT_TERMS):
        t = rest.to(torch.bfloat16).float()
        out.append(t)
        rest = rest - t
    return out


def _split_samples(kind, rng):
    if kind == "p":          # softmax weights: exp of scores minus lse
        x = np.exp(-rng.exponential(4.0, 200_000)).astype(np.float32)
        x = np.concatenate([x, np.float32([0.0, 1.0, 2.0 ** -126])])
    else:                    # ds = p (dp - D): signed, over many scales
        x = (rng.standard_normal(200_000)
             * 10.0 ** rng.uniform(-30, 1, 200_000)).astype(np.float32)
    return torch.from_numpy(x)


@pytest.mark.parametrize("kind", ["p", "ds"])
def test_three_bf16_terms_rebuild_float32_exactly(kind):
    """hi + mid + lo is x exactly, for P's range [0, 1] and dS's signed
    range, so each term's product with a bf16 operand, summed, is the
    float32 product; two terms are not enough."""
    x = _split_samples(kind, np.random.default_rng(11))
    hi, mid, lo = split_terms(x, 3)
    for t in (hi, mid, lo):
        assert torch.equal(t, t.to(torch.bfloat16).float())   # bf16 values
    assert torch.equal((hi + mid) + lo, x)
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())
    b = torch.from_numpy(np.random.default_rng(12).standard_normal(
        x.shape, dtype=np.float32)).to(torch.bfloat16).double()
    assert torch.equal(hi.double() * b + mid.double() * b + lo.double() * b,
                       x.double() * b)
    two = sum(split_terms(x, 2))
    assert not torch.equal(two, x)
    assert float(((two - x).abs() / x.abs().clamp_min(1e-38)).max()) \
        <= 2.0 ** -16


def _split_products(a, b):
    """a @ b with float32 ``a`` split into bf16 terms, each product taken
    and summed in float32 (the register-A products)."""
    return sum(t @ b for t in split_terms(a))


def k1b_bf16_mirror(q, k, v, out, lse, do, kw, skipped):
    """K1b's bf16 body in plain PyTorch, in float32: S and dP from the
    bf16 inputs, P and dS split into bf16 terms for the dv, dk and dq
    products, over the body's tile walk (64-key dkdv blocks over query
    tiles of BM rows; 64-row dq blocks over key tiles of KN keys, from
    ``bf16_tiles``); appends each skipped tile pair to ``skipped``."""
    B, Sq, Hq, dh = q.shape
    _, Sk, Hkv, dv = v.shape
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(dh) if kw["scale"] is None else kw["scale"]
    _, _, BM, _, KN = bf16_tiles(dh, dv)
    qf, kf, vf = q.float(), k.float(), v.float()
    dof, of = do.float(), out.float()
    D = (dof * of).sum(-1).permute(0, 2, 1)                 # (B, Hq, Sq)
    part = torch.zeros((B, Sk, Hq, dh + dv))
    dq = torch.zeros((B, Sq, Hq, dh))
    cw = dict(causal=kw["causal"], window=kw["window"],
              q_offset=kw["q_offset"])
    for b in range(B):
        for h in range(Hq):
            hk = h // G
            for n0 in range(0, Sk, 64):
                keys = torch.arange(n0, min(n0 + 64, Sk))
                m_begin, m_end = dkdv_row_range(n0, 64, BM, Sq, **cw)
                for m0 in range(0, Sq, BM):
                    rows = torch.arange(m0, min(m0 + BM, Sq))
                    if not m_begin <= m0 < m_end:
                        skipped.append((rows, keys))
                        continue
                    pr, ds, _ = _tile_scores(
                        qf[b, rows, h], kf[b, keys, hk], dof[b, rows, h],
                        vf[b, keys, hk], lse[b, h, rows], D[b, h, rows], rows,
                        keys, kw, scale)
                    part[b, keys, h, :dh] += _split_products(
                        ds.T, qf[b, rows, h])
                    part[b, keys, h, dh:] += _split_products(
                        pr.T, dof[b, rows, h])
            for q0 in range(0, Sq, 64):
                rows = torch.arange(q0, min(q0 + 64, Sq))
                n_begin, n_end = dq_key_range(q0, 64, KN, Sq, Sk, **cw)
                for n0 in range(0, Sk, KN):
                    keys = torch.arange(n0, min(n0 + KN, Sk))
                    if not n_begin <= n0 < n_end:
                        skipped.append((rows, keys))
                        continue
                    _, ds, _ = _tile_scores(
                        qf[b, rows, h], kf[b, keys, hk], dof[b, rows, h],
                        vf[b, keys, hk], lse[b, h, rows], D[b, h, rows], rows,
                        keys, kw, scale)
                    dq[b, rows, h] += _split_products(ds, kf[b, keys, hk])
    part[..., :dh] *= scale
    grouped = part.reshape(B, Sk, Hkv, G, dh + dv)
    acc = torch.zeros((B, Sk, Hkv, dh + dv))
    for g in range(G):
        acc = acc + grouped[:, :, :, g]
    return dq * scale, acc[..., :dh], acc[..., dh:]


BF16_MIRROR_CASES = dict(
    {f"cases/{n}": c for n, c in CASES.items()},
    **{f"tiles/{n}": c for n, c in MIRROR_CASES.items()
       if c[5] % 8 == 0 and c[6] % 8 == 0},
    # dk and dv in blocks of their own (dh 128, 64-row tiles), and MLA's
    # dh 192 / dv 128 with 32-row tiles
    **{"tiles/split_dh128": (1, 100, 100, 4, 2, 128, 64, True, None, 30.0,
                             0),
       "tiles/mla_dh192": (1, 80, 80, 2, 2, 192, 128, True, None, None, 0)})


@pytest.mark.parametrize("name", sorted(BF16_MIRROR_CASES))
def test_k1b_bf16_mirror_matches_the_float32_backward(name):
    """The bf16 body's arithmetic on bf16 inputs equals the reference's
    float32 backward on float32 copies within the float32 tolerance, and
    its bf16 cast passes chip_smoke.py's rule for K1b's bf16 gradients
    (each its float32 gradient rounded once); skipped tile pairs hold no
    visible pair."""
    (_, q), (_, k), (_, v), (_, do), kw = _inputs(BF16_MIRROR_CASES[name],
                                                  "bfloat16", 5)
    out, lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    skipped = []
    got = k1b_bf16_mirror(q, k, v, out, lse, do, kw, skipped)
    want32 = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                         out.float(), lse, do.float(), **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
    cs = _chip_smoke()
    for g, w, w32 in zip(got, want, want32):
        np.testing.assert_allclose(g.numpy(), w32.numpy(), **TOL["float32"])
        scaled, excess, _ = cs._bf16_grad_errs(torch, g.to(torch.bfloat16),
                                               w, w32)
        assert excess <= 0.0 and scaled <= cs.BWD_BF16_SCALED_TOL
    cw = dict(causal=kw["causal"], window=kw["window"],
              q_offset=kw["q_offset"])
    assert all(not _visible(rows, keys, **cw).any() for rows, keys in skipped)


def test_bf16_tiles_match_the_source_table():
    """``bf16_tiles`` is the source's ``with_wgmma_tile``, row for row,
    and ``SPLIT_TERMS`` its ``TERMS``."""
    src = (ops.CSRC / "flash_attention_bwd.cu").read_text()
    body = src[src.index("auto with_wgmma_tile("):]
    body = body[:body.index("\n}\n")]
    rows = re.findall(r"(?:if \(dh <= (\d+) && dv <= (\d+)\) )?return "
                      r"f\(WgTile<(\d+), (\d+), (\d+), (\d+), (\d+)>", body)
    assert len(rows) == 4
    for dh_max, dv_max, *tile in rows:
        dh, dv = int(dh_max or 256), int(dv_max or 256)
        assert bf16_tiles(dh, dv) == tuple(int(x) for x in tile)
    assert f"constexpr int TERMS = {SPLIT_TERMS};" in src
