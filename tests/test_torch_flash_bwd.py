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

Inputs are made with numpy from a seed and handed to both packages.
"""
import math

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
