"""The arithmetic of the port's attention kernels, mirrored in plain
PyTorch on the CPU and held against the reference's jnp oracles
(``repro.models.layers.flash_attention`` / ``decode_attention``).

The CUDA kernels run only on the card, where ``chip_smoke.py`` holds them
against their plain versions.  These mirrors repeat what the kernels do
differently from those plain versions, so that the new arithmetic is
checked against the JAX package before any card run:

* K2 splits the cache into slot ranges (``plan_splits``), keeps a partial
  softmax (m, l, acc) per split and merges the splits in a fixed order;
* K1's bfloat16 body walks key tiles with an online softmax in the log2
  domain and rounds P to bfloat16 before the P V product, with float32
  accumulators.

Inputs are made with numpy from a seed and handed to both packages.
"""
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import layers as jlayers  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.kernels import decode_attention as dmod  # noqa: E402
from repro_torch.kernels import flash_attention as fmod  # noqa: E402

TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
NEG_INF = -1e30
H100_SMS = 132


def _pair(rng, shape, dtype):
    """The same values as a jnp array and a float32 torch tensor."""
    x = jnp.asarray(rng.standard_normal(shape, dtype=np.float32)).astype(
        JNP[dtype])
    return x, torch.from_numpy(np.array(x.astype(jnp.float32)))


def _close(port, want, dtype):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


# ---------------------------------------------------------------------------
# K2: split-KV partials and their fixed-order merge
def split_ranges(S, splits, split_len):
    """The slot range [start, end) of each split of the plan."""
    return [(s * split_len, min(S, (s + 1) * split_len)) for s in range(splits)]


def _slot_valid(pos, j, window, ring):
    if ring:
        return pos - ((pos - j) % window) >= 0
    return j <= pos and (window is None or pos - j < window)


def split_kv_mirror(q, k, v, pos, *, window=None, softcap=None, n_sm=H100_SMS):
    """What the two passes compute, split by split, in float32."""
    B, _, Hq, dh = q.shape
    _, S, Hkv, dv = v.shape
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(dh)
    ring = window is not None and S == window
    splits, split_len = dmod.plan_splits(B, Hkv, S, n_sm)
    tile = dmod.SPLIT_TILE
    out = torch.zeros((B, 1, Hq, dv))
    for b in range(B):
        p = int(pos[b])
        n_end, n_begin = min(S, p + 1), 0
        if not ring and window is not None:
            n_begin = max(0, p - window + 1)
        if n_begin >= n_end:                   # no valid slot: visit all
            n_begin, n_end = 0, S
        for hk in range(Hkv):
            qg = q[b, 0, hk * G:(hk + 1) * G]                  # (G, dh)
            parts = []
            for s0, s1 in split_ranges(S, splits, split_len):
                lo, hi = max(s0, n_begin), min(s1, n_end)
                if lo >= hi:                   # unseen: weighs 0
                    parts.append((torch.full((G,), -math.inf),
                                  torch.zeros(G), torch.zeros((G, dv))))
                    continue
                t0 = max(s0, (lo // tile) * tile)
                slots = torch.arange(t0, t0 + -(-(hi - t0) // tile) * tile)
                kv = slots[slots < S]
                x = (qg @ k[b, kv, hk].T) * scale                 # (G, n)
                if softcap is not None:
                    x = softcap * torch.tanh(x / softcap)
                ok = torch.tensor([_slot_valid(p, int(j), window, ring)
                                   for j in kv])
                x = torch.where(ok[None, :], x, torch.full_like(x, NEG_INF))
                m = x.max(dim=1).values
                e = torch.exp(x - m[:, None])
                parts.append((m, e.sum(dim=1), e @ v[b, kv, hk]))
            M = torch.stack([m for m, _, _ in parts]).max(dim=0).values
            num, den = torch.zeros((G, dv)), torch.zeros(G)
            for m, l, acc in parts:            # in split order
                w = torch.where(l > 0, torch.exp(m - M), torch.zeros_like(m))
                num += w[:, None] * acc
                den += w * l
            out[b, 0, hk * G:(hk + 1) * G] = num / den[:, None]
    return out


# (B, S, Hq, Hkv, dh, window, softcap, positions): chip_smoke.py's decode
# cases, ring before / at / after the wrap, a plain window, pos -1, and a
# single (row, head) pair whose later splits lie wholly past pos
DECODE_CASES = [
    (2, 64, 4, 2, 32, 64, None, [3, 63, 64, 5 * 64 + 7]),   # ring buffer
    (4, 256, 14, 2, 64, None, None, [128, 131, 140, 143]),  # qwen2 main
    (2, 256, 4, 2, 64, 64, 30.0, [200, 17]),                # window + cap
    (3, 100, 14, 2, 64, None, None, [99, 0, 50]),           # ragged S
    (2, 256, 4, 2, 64, 64, None, [400, 100]),               # past a window
    (2, 128, 4, 2, 64, None, None, [-1, 5]),                # before slot 0
    (2, 64, 4, 2, 32, 64, None, [-3]),                      # ring, pos < 0
    (4, 256, 10, 1, 32, 256, None, [128, 131, 140, 143]),   # rgemma, ring
    (1, 512, 7, 1, 32, None, None, [0, 63, 64, 511]),       # B * Hkv = 1
    (1, 512, 10, 1, 32, 256, None, [255, 256, 300, 307]),   # ring, split edges
    # the dense configs' groups: nemotron G 6 and phi3 G 4 at dh 128,
    # musicgen's MHA at dh 64, gemma2's 32/16 with softcap 50 on a ring
    # (its local layers, window cut to 320) and without a window (global)
    (4, 272, 48, 8, 128, None, None, [128, 131, 140, 271]),
    (4, 264, 40, 10, 128, None, None, [128, 131, 140, 263]),
    (4, 200, 24, 24, 64, None, None, [128, 131, 140, 199]),
    (1, 320, 32, 16, 128, 320, 50.0, [319, 320, 400, 407]),
    (2, 288, 32, 16, 128, None, 50.0, [287, 150]),
]


@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: f"S{c[1]}-w{c[5]}")
def test_split_kv_mirror_matches_oracle(case):
    B, S, Hq, Hkv, dh, window, softcap, positions = case
    rng = np.random.default_rng(20)
    jq, tq = _pair(rng, (B, 1, Hq, dh), "float32")
    jk, tk = _pair(rng, (B, S, Hkv, dh), "float32")
    jv, tv = _pair(rng, (B, S, Hkv, dh), "float32")
    pos_sets = ([np.full((B,), p, np.int32) for p in positions]
                if len(positions) != B else [np.array(positions, np.int32)])
    for pos in pos_sets:
        port = split_kv_mirror(tq, tk, tv, pos, window=window, softcap=softcap)
        want = jlayers.decode_attention(jq, jk, jv, jnp.asarray(pos),
                                        window=window, softcap=softcap)
        _close(port, want, "float32")


@pytest.mark.parametrize("B,Hkv,S", [
    (8, 2, 4096), (4, 1, 256), (4, 2, 256), (1, 1, 4096), (3, 2, 100),
    (1, 1, 1), (2, 8, 2048), (64, 2, 4096), (1, 1, 2200)])
def test_plan_splits_tiles_the_cache(B, Hkv, S):
    splits, split_len = dmod.plan_splits(B, Hkv, S, H100_SMS)
    assert split_len % dmod.SPLIT_TILE == 0
    ranges = split_ranges(S, splits, split_len)
    assert ranges[0][0] == 0 and ranges[-1][1] == S
    assert all(a < b for a, b in ranges)                      # none empty
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(splits - 1))


def test_plan_splits_fills_the_card():
    """The long decode shape fills the 132 SMs twice over; recurrentgemma's
    four (row, head) pairs get at least 32 blocks; the plan takes no
    position, so it cannot depend on one."""
    splits, _ = dmod.plan_splits(8, 2, 4096, H100_SMS)
    assert 8 * 2 * splits >= 2 * H100_SMS
    splits, _ = dmod.plan_splits(4, 1, 256, H100_SMS)
    assert 4 * 1 * splits >= 32
    assert list(inspect.signature(dmod.plan_splits).parameters) == [
        "B", "Hkv", "S", "n_sm"]


# ---------------------------------------------------------------------------
# K1: the bfloat16 body's blocked arithmetic
def _tiles(dh, dv):
    """Keys per tile of the bfloat16 instantiation that takes (dh, dv)
    (``with_bf16_tile`` in the source): 64 up to dh 192 / dv 128, else 32."""
    return 64 if dh <= 192 and dv <= 128 else 32


def flash_bf16_mirror(q, k, v, *, causal=True, window=None, softcap=None,
                      q_offset=0):
    """K1's bfloat16 body: 64-row query tiles, key tiles with the key-range
    skip, online softmax in the log2 domain (exp2, scale * log2 e folded
    in), P rounded to bfloat16 for the P V product, float32 accumulators.
    q, k, v hold bfloat16 values as float32; returns bfloat16 as float32."""
    B, Sq, Hq, dh = q.shape
    _, Sk, Hkv, dv = v.shape
    G = Hq // Hkv
    kn = _tiles(dh, dv)
    scale = 1.0 / math.sqrt(dh)
    log2e = 1.4426950408889634
    kk = k.repeat_interleave(G, dim=2)                     # (B, Sk, Hq, dh)
    vv = v.repeat_interleave(G, dim=2)
    out = torch.empty((B, Sq, Hq, dv))
    for q0 in range(0, Sq, 64):
        rows = min(64, Sq - q0)
        q_lo, q_hi = q_offset + q0, q_offset + q0 + rows - 1
        n_begin, n_end = 0, Sk
        if causal:
            n_end = min(Sk, q_hi + 1)
        if window is not None:
            n_begin = max(0, q_lo - window + 1)
        n_begin = (n_begin // kn) * kn
        qt = q[:, q0:q0 + rows]                            # (B, r, Hq, dh)
        qpos = q_offset + q0 + torch.arange(rows)
        m = torch.full((B, Hq, rows), -math.inf)
        l = torch.zeros((B, Hq, rows))
        o = torch.zeros((B, Hq, rows, dv))
        for n0 in range(n_begin, n_end, kn):
            keys = torch.arange(n0, min(n0 + kn, Sk))
            s = torch.einsum("brhd,bnhd->bhrn", qt, kk[:, keys])
            if softcap is not None:
                x = softcap * torch.tanh(s * scale / softcap) * log2e
            else:
                x = s * (scale * log2e)
            ok = torch.ones((rows, len(keys)), dtype=torch.bool)
            if causal:
                ok &= keys[None, :] <= qpos[:, None]
            if window is not None:
                ok &= qpos[:, None] - keys[None, :] < window
            x = torch.where(ok, x, torch.full_like(x, -math.inf))
            mn = torch.maximum(m, x.max(dim=-1).values)
            mu = torch.where(mn == -math.inf, torch.zeros_like(mn), mn)
            alpha = torch.exp2(m - mu)
            p = torch.exp2(x - mu[..., None])
            l = l * alpha + p.sum(dim=-1)
            m = mn
            pb = p.to(torch.bfloat16).float()              # the rounding point
            o = o * alpha[..., None] + torch.einsum("bhrn,bnhd->bhrd", pb,
                                                    vv[:, keys])
        mean_v = vv.mean(dim=1)                             # (B, Hq, dv)
        res = torch.where(l[..., None] > 0, o / l.clamp_min(1e-30)[..., None],
                          mean_v[:, :, None, :])
        out[:, q0:q0 + rows] = res.permute(0, 2, 1, 3)
    return out.to(torch.bfloat16).float()


# chip_smoke.py's flash cases at reduced S:
# (B, Sq, Sk, Hq, Hkv, dh, dv, causal, window, softcap, q_offset)
FLASH_CASES = [
    (1, 128, 128, 4, 4, 32, 32, True, None, None, 0),      # MHA
    (2, 256, 256, 8, 2, 64, 64, True, None, None, 0),      # GQA
    (1, 192, 192, 2, 1, 128, 128, True, None, None, 0),    # MQA
    (3, 192, 192, 6, 3, 48, 48, True, None, None, 0),      # not tile multiples
    (2, 256, 256, 4, 2, 64, 64, True, 64, None, 0),        # window
    (2, 128, 128, 4, 2, 64, 64, True, None, 25.0, 0),      # softcap
    (2, 256, 256, 4, 2, 64, 64, True, 96, 50.0, 0),        # both
    (1, 128, 128, 4, 4, 32, 32, False, None, None, 0),     # non-causal
    (4, 128, 128, 14, 2, 64, 64, True, None, None, 0),     # qwen2 main path
    (2, 100, 100, 14, 2, 64, 64, True, None, None, 0),     # Sq not a tile multiple
    (1, 64, 192, 4, 2, 64, 64, True, None, None, 128),     # q_offset, Sq < Sk
    (1, 130, 130, 4, 2, 80, 40, True, None, None, 0),      # dh 80, dv 40
    (1, 128, 128, 2, 1, 256, 256, True, None, None, 0),    # dh 256
    (1, 160, 160, 4, 1, 192, 128, True, None, None, 0),    # MLA prefill dims
    (1, 192, 192, 4, 2, 64, 64, False, 80, None, 0),       # window only
    (1, 128, 64, 4, 2, 64, 64, True, 16, None, 0),         # rows >= 79 see none
    (1, 64, 64, 4, 2, 32, 32, False, 16, None, 100),       # no row sees a key
    (4, 128, 128, 10, 1, 256, 256, True, 2048, None, 0),   # rgemma main path
    (1, 300, 300, 10, 1, 256, 256, True, 256, None, 0),    # rgemma, window masks
    # the dense configs' prefills: nemotron 48/8 and phi3 40/10 at dh 128,
    # musicgen 24/24 at dh 64, gemma2's local layers (32/16, softcap 50,
    # window cut to 64 so that it masks)
    (2, 128, 128, 48, 8, 128, 128, True, None, None, 0),
    (2, 128, 128, 40, 10, 128, 128, True, None, None, 0),
    (2, 128, 128, 24, 24, 64, 64, True, None, None, 0),
    (1, 200, 200, 32, 16, 128, 128, True, 64, 50.0, 0),
]


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "x".join(map(str, c[:7])))
def test_flash_bf16_mirror_matches_oracle(case):
    B, Sq, Sk, Hq, Hkv, dh, dv, causal, window, softcap, q_offset = case
    rng = np.random.default_rng(21)
    jq, tq = _pair(rng, (B, Sq, Hq, dh), "bfloat16")
    jk, tk = _pair(rng, (B, Sk, Hkv, dh), "bfloat16")
    jv, tv = _pair(rng, (B, Sk, Hkv, dv), "bfloat16")
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    port = flash_bf16_mirror(tq, tk, tv, **kw)
    want = jlayers.flash_attention(jq, jk, jv, q_chunk=Sq, kv_chunk=Sk, **kw)
    _close(port, want, "bfloat16")


# ---------------------------------------------------------------------------
# the head dims every configuration gives the kernels
def _attention_dims(cfg):
    """(dh, dv) of prefill attention and of decode attention, or None
    where the configuration runs no attention."""
    kinds = set(cfg.layer_kinds)
    if kinds & {"mla", "mla_moe"}:
        m = cfg.mla
        return (m.nope_head_dim + m.rope_head_dim, m.v_head_dim)
    if kinds & {"attn", "attn_local", "attn_moe"}:
        hd = cfg.resolved_head_dim
        return (hd, hd)
    return None


@pytest.mark.parametrize("arch", list_archs())
def test_every_config_head_dims_are_taken(arch):
    for cfg in (get_config(arch), get_config(arch).reduced()):
        dims = _attention_dims(cfg)
        if dims is None:
            continue
        fmod.check_head_dims(*dims, torch.bfloat16)
        fmod.check_head_dims(*dims, torch.float32)
        dmod.check_head_dims(*dims)


@pytest.mark.parametrize("dh,dv", [(36, 36), (64, 20), (264, 64), (0, 64)])
def test_refused_head_dims_raise_value_error(dh, dv):
    with pytest.raises(ValueError):
        fmod.check_head_dims(dh, dv, torch.bfloat16)
    with pytest.raises(ValueError):
        dmod.check_head_dims(dh, dv)
