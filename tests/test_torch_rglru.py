"""The port's RG-LRU path (``repro_torch.models.rglru``, kernel K3's plain
version, the ``attn_local``/``rglru`` blocks) held against the JAX
reference in float32 on the CPU.

* K3's plain version (``kernels/ref.py:rglru_scan_ref``) against the
  Pallas kernel in interpret mode and the literal oracle, at 1e-6: the
  same separately rounded multiply and add, so only XLA's fusion can
  differ.
* Each RG-LRU function against its JAX counterpart at 1e-5: the block
  products and the associative scan sum in other orders.
* A two-segment reduced recurrentgemma shaped like the real one
  (``(rglru, rglru, attn_local) x 2 + (rglru, rglru)``, window 16)
  against the JAX ``Model`` at 1e-4 with identical greedy tokens, across
  the 16-slot ring's wrap, and served through ``ServingEngine``.

One JAX init, written once with ``repro.checkpoint.save_pytree`` and
read by the port's loader, gives both sides the same weights; inputs
are made with numpy from a seed.
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import save_pytree  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.kernels.ops import rglru_scan as pallas_rglru_scan  # noqa: E402
from repro.kernels.ref import ref_rglru_scan  # noqa: E402
from repro.models import make_model as jax_make_model  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro_torch.checkpoint import (flatten_with_paths, load_pytree,  # noqa: E402
                                    tree_map)
from repro_torch.configs import get_config as port_get_config  # noqa: E402
from repro_torch.core import FunctionSpec, Runtime  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rglru_scan as kmod  # noqa: E402
from repro_torch.models import make_model  # noqa: E402
from repro_torch.models import rglru  # noqa: E402
from repro_torch.serving import (Executor, ModelEndpoint,  # noqa: E402
                                 ServingEngine, WeightStore)
from repro_torch.specs import TensorSpec  # noqa: E402

KERNEL_TOL = dict(atol=1e-6, rtol=1e-6)
FN_TOL = dict(atol=1e-5, rtol=1e-5)
ATOL = 1e-4
B, MAX_LEN, STEPS = 2, 32, 8
NAME = "rg"


def _cfg(get, dtype="float32"):
    return dataclasses.replace(
        get("recurrentgemma-2b").reduced(d_model=128), vocab_size=256,
        dtype=dtype, window_size=16,
        segments=((("rglru", "rglru", "attn_local"), 2), (("rglru", "rglru"), 1)),
        n_layers=8)


def _np(t):
    return t.detach().float().numpy()


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The JAX model and params, and the port's, from one .npz."""
    cfg = _cfg(get_config)
    jm = jax_make_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    root = tmp_path_factory.mktemp("rg")
    save_pytree(str(root / f"{NAME}.npz"), jp)
    tm = make_model(_cfg(port_get_config), device="cpu")
    tp = load_pytree(str(root / f"{NAME}.npz"), device="cpu")
    jfns = dict(prefill=jax.jit(jm.prefill, static_argnames=("max_len",)),
                decode=jax.jit(jm.decode_step))
    return jm, jp, tm, tp, jfns, WeightStore(str(root))


@pytest.fixture(scope="module")
def block(both):
    """Layer 0's RG-LRU mixer params on both sides, and the config."""
    jm, jp, tm, tp, _, _ = both
    jb = jax.tree.map(lambda x: x[0], jp["seg0"][0]["mixer"])
    tb = tree_map(lambda t: t[0], tp["seg0"][0]["mixer"])
    return jm.cfg, tm.cfg, jb, tb


def _pair(rng, shape, fn=None):
    x = rng.standard_normal(shape, dtype=np.float32)
    if fn is not None:
        x = fn(x)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _sigmoid(x):
    return (1.0 / (1.0 + np.exp(-x))).astype(np.float32)


# ---------------------------------------------------------------------------
# K3's plain version
@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("Bk,S,r,r_blk", [
    (1, 64, 256, 128), (2, 128, 512, 256), (3, 200, 384, 128)])
def test_rglru_scan_ref_matches_pallas_and_oracle(Bk, S, r, r_blk, with_h0):
    rng = np.random.default_rng(S + r)
    ja, ta = _pair(rng, (Bk, S, r), _sigmoid)
    jb, tb = _pair(rng, (Bk, S, r))
    jh, th = _pair(rng, (Bk, r))
    if not with_h0:
        jh = th = None
    y, hT = ref.rglru_scan_ref(ta, tb, th)
    assert y.dtype == hT.dtype == torch.float32
    assert tuple(y.shape) == (Bk, S, r) and tuple(hT.shape) == (Bk, r)
    yk, hk = pallas_rglru_scan(ja, jb, jh, r_blk=r_blk, interpret=True)
    yo, ho = ref_rglru_scan(ja, jb, jh)
    for want_y, want_h in ((yk, hk), (yo, ho)):
        np.testing.assert_allclose(_np(y), np.asarray(want_y), **KERNEL_TOL)
        np.testing.assert_allclose(_np(hT), np.asarray(want_h), **KERNEL_TOL)


def test_rglru_scan_ref_empty_sequence_returns_h0():
    h0 = torch.randn(2, 8)
    y, hT = ref.rglru_scan_ref(torch.zeros(2, 0, 8), torch.zeros(2, 0, 8), h0)
    assert tuple(y.shape) == (2, 0, 8)
    assert torch.equal(hT, h0)


def test_ops_rglru_scan_on_cpu_launches_nothing():
    rng = np.random.default_rng(5)
    _, a = _pair(rng, (2, 40, 96), _sigmoid)
    _, b = _pair(rng, (2, 40, 96))
    _, h0 = _pair(rng, (2, 96))
    before = tuple(op.launches for op in ops.KERNELS)
    for h in (None, h0):
        y, hT = ops.rglru_scan(a, b, h)
        wy, wh = ref.rglru_scan_ref(a, b, h)
        torch.testing.assert_close(y, wy, rtol=0, atol=0)
        torch.testing.assert_close(hT, wh, rtol=0, atol=0)
    assert tuple(op.launches for op in ops.KERNELS) == before
    assert ops.rglru_scan in ops.KERNELS
    assert ops.MODULES["rglru_scan"] is kmod


def test_rglru_wrapper_checks_inputs():
    """The host wrapper refuses what the kernel does not take."""
    a = torch.zeros((2, 8, 16))
    with pytest.raises(ValueError, match="one"):
        kmod.check_inputs(a, torch.zeros((2, 8, 15)), None)
    with pytest.raises(ValueError, match="h0"):
        kmod.check_inputs(a, a, torch.zeros((2, 15)))
    with pytest.raises(TypeError, match="float32"):
        kmod.check_inputs(a.double(), a.double(), None)
    with pytest.raises(ValueError, match="CUDA"):
        kmod.check_inputs(a, a, None)
    with pytest.raises(ValueError):
        ops.rglru_scan(a.to("meta"), a, None)


# ---------------------------------------------------------------------------
# each RG-LRU function against its JAX counterpart
def test_gates(block):
    jcfg, pcfg, jb, tb = block
    jx, tx = _pair(np.random.default_rng(1), (B, 24, 128))
    ja, jbb = jrglru._gates(jb["lru"], jx, jcfg.n_heads, jcfg.rglru.c)
    ta, tbb = rglru._gates(tb["lru"], tx, pcfg.n_heads, pcfg.rglru.c)
    np.testing.assert_allclose(_np(ta), np.asarray(ja), **FN_TOL)
    np.testing.assert_allclose(_np(tbb), np.asarray(jbb), **FN_TOL)


def test_conv1d_causal_and_step(block):
    _, _, jb, tb = block
    rng = np.random.default_rng(2)
    jx, tx = _pair(rng, (B, 24, 128))
    np.testing.assert_allclose(
        _np(rglru.conv1d_causal(tb["conv_w"], tb["conv_b"], tx)),
        np.asarray(jrglru.conv1d_causal(jb["conv_w"], jb["conv_b"], jx)),
        **FN_TOL)
    jc, tc = _pair(rng, (B, 3, 128))
    jy, jst = jrglru.conv1d_step(jb["conv_w"], jb["conv_b"], jx[:, 0], jc)
    ty, tst = rglru.conv1d_step(tb["conv_w"], tb["conv_b"], tx[:, 0], tc)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **FN_TOL)
    np.testing.assert_array_equal(_np(tst), np.asarray(jst))


def test_rglru_step(block):
    jcfg, pcfg, jb, tb = block
    rng = np.random.default_rng(3)
    jx, tx = _pair(rng, (B, 128))
    jh, th = _pair(rng, (B, 128))
    jy, jh2 = jrglru.rglru_step(jb["lru"], jx, jh, jcfg.n_heads, jcfg.rglru.c)
    ty, th2 = rglru.rglru_step(tb["lru"], tx, th, pcfg.n_heads, pcfg.rglru.c)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **FN_TOL)
    np.testing.assert_allclose(_np(th2), np.asarray(jh2), **FN_TOL)


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_associative_scan(block, with_h0):
    """The port's prefill runs the sequential recurrence (K3's function);
    the reference model runs an associative scan."""
    jcfg, pcfg, jb, tb = block
    rng = np.random.default_rng(4)
    jx, tx = _pair(rng, (B, 40, 128))
    jh, th = _pair(rng, (B, 128))
    if not with_h0:
        jh = th = None
    jy, jhT = jrglru.rglru_scan(jb["lru"], jx, jcfg.n_heads, jcfg.rglru.c, jh)
    ty, thT = rglru.rglru_scan(tb["lru"], tx, pcfg.n_heads, pcfg.rglru.c, th)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **FN_TOL)
    np.testing.assert_allclose(_np(thT), np.asarray(jhT), **FN_TOL)


@pytest.mark.parametrize("S", [2, 24])
def test_rglru_block_apply_prefill(block, S):
    """S = 2 is shorter than width - 1 = 3: the conv state is left-padded."""
    jcfg, pcfg, jb, tb = block
    jx, tx = _pair(np.random.default_rng(S), (B, S, 128))
    jout, jc = jrglru.rglru_block_apply(jb, jx, jcfg)
    with torch.no_grad():
        tout, tc = rglru.rglru_block_apply(tb, tx, pcfg)
    np.testing.assert_allclose(_np(tout), np.asarray(jout), **FN_TOL)
    assert set(tc) == set(jc) == {"h", "conv"}
    for name in tc:
        assert tuple(tc[name].shape) == jc[name].shape
        np.testing.assert_allclose(_np(tc[name]), np.asarray(jc[name]),
                                   **FN_TOL)


def test_rglru_block_apply_decode(block):
    jcfg, pcfg, jb, tb = block
    rng = np.random.default_rng(7)
    jx, tx = _pair(rng, (B, 1, 128))
    jh, th = _pair(rng, (B, 128))
    jc, tc = _pair(rng, (B, 3, 128))
    jout, jnew = jrglru.rglru_block_apply(jb, jx, jcfg,
                                          cache={"h": jh, "conv": jc})
    with torch.no_grad():
        tout, tnew = rglru.rglru_block_apply(tb, tx, pcfg,
                                             cache={"h": th, "conv": tc})
    np.testing.assert_allclose(_np(tout), np.asarray(jout), **FN_TOL)
    for name in ("h", "conv"):
        np.testing.assert_allclose(_np(tnew[name]), np.asarray(jnew[name]),
                                   **FN_TOL)


# ---------------------------------------------------------------------------
# the slice as a whole: the two-segment reduced model
def _tokens(S):
    return np.random.default_rng(S).integers(0, 256, (B, S)).astype(np.int32)


def test_forward_hidden_and_logits(both):
    jm, jp, tm, tp, _, _ = both
    toks = _tokens(24)
    jx, _ = jm.forward(jp, jnp.asarray(toks))
    with torch.no_grad():
        tx, aux = tm.forward(tp, torch.from_numpy(toks))
        tl = tm._logits(tp, tx)
    np.testing.assert_allclose(_np(tx), np.asarray(jx), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(tl), np.asarray(jm._logits(jp, jx)),
                               atol=ATOL, rtol=0)
    assert float(aux) == 0.0


def _caches_close(tc, jc, msg):
    flat_t = flatten_with_paths(tc)
    flat_j = {"/".join(str(getattr(p, "key", f"[{getattr(p, 'idx', '')}]"))
                       for p in path): leaf
              for path, leaf in jax.tree_util.tree_flatten_with_path(jc)[0]}
    assert flat_t.keys() == flat_j.keys()
    for k in flat_t:
        assert tuple(flat_t[k].shape) == flat_j[k].shape, k
        np.testing.assert_allclose(_np(flat_t[k]), np.asarray(flat_j[k]),
                                   atol=ATOL, rtol=0, err_msg=f"{msg} {k}")
    return flat_t


@pytest.mark.parametrize("S", [12, 24])
def test_prefill_logits_and_every_cache_leaf(both, S):
    """Prompt 24 is longer than the 16-slot window: the ring is seeded
    wrapped."""
    jm, jp, tm, tp, jfns, _ = both
    toks = _tokens(S)
    jl, jc = jfns["prefill"](jp, jnp.asarray(toks), max_len=MAX_LEN)
    with torch.no_grad():
        tl, tc = tm.prefill(tp, torch.from_numpy(toks), max_len=MAX_LEN)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL, rtol=0)
    flat = _caches_close(tc, jc, "prefill")
    assert {k.rsplit("/", 1)[1] for k in flat} == {"h", "conv", "k", "v"}
    assert tuple(tc[0][2]["k"].shape) == (2, B, 16, 1, 32)   # the ring


@pytest.mark.parametrize("S", [12, 24])
def test_decode_steps_and_greedy_tokens(both, S):
    """Each side decodes its own greedy tokens for STEPS steps: prompt
    12 crosses the ring's wrap at position 16, prompt 24 starts past
    it.  Logits agree at every step, the tokens are identical, and the
    in-place cache ends equal to the reference's."""
    jm, jp, tm, tp, jfns, _ = both
    toks = _tokens(S)
    jl, jc = jfns["prefill"](jp, jnp.asarray(toks), max_len=MAX_LEN)
    with torch.no_grad():
        tl, tc = tm.prefill(tp, torch.from_numpy(toks), max_len=MAX_LEN)
    jtok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
    ttok = torch.argmax(tl[:, -1:], dim=-1).to(torch.int32)
    jpos = jnp.full((B,), S, jnp.int32)
    tpos = torch.full((B,), S, dtype=torch.int32)
    for step in range(STEPS):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok),
                                      err_msg=f"step {step}")
        jl, jc = jfns["decode"](jp, jc, jtok, jpos)
        with torch.no_grad():
            tl, tc2 = tm.decode_step(tp, tc, ttok, tpos)
        assert tc2 is tc
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL,
                                   rtol=0, err_msg=f"step {step}")
        jtok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        ttok = torch.argmax(tl[:, -1:], dim=-1).to(torch.int32)
        jpos, tpos = jpos + 1, tpos + 1
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    _caches_close(tc, jc, "after decode")


def test_init_matches_reference_shapes_and_types():
    """The port's seeded init makes the reference's leaves in a bf16
    model: same key paths, shapes and types (``lru/*`` stays float32)."""
    jspec = jax.eval_shape(lambda: jax_make_model(
        _cfg(get_config, "bfloat16")).init(jax.random.PRNGKey(0)))
    want = {"/".join(str(getattr(p, "key", f"[{getattr(p, 'idx', '')}]"))
                     for p in path): (tuple(l.shape), str(l.dtype))
            for path, l in jax.tree_util.tree_flatten_with_path(jspec)[0]}
    pm = make_model(_cfg(port_get_config, "bfloat16"), device="cpu")
    params = pm.init(torch.Generator().manual_seed(0))
    got = {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for k, t in flatten_with_paths(params).items()}
    assert got == want
    assert want["seg0/[0]/mixer/lru/lambda"][1] == "float32"
    specs = {k: (s.shape, str(s.dtype).replace("torch.", ""))
             for k, s in flatten_with_paths(pm.param_specs()).items()}
    assert specs == want
    # Lambda so that a^c spans [0.9, 0.999], as the reference draws it
    lam = params["seg0"][0]["mixer"]["lru"]["lambda"]
    a_c = torch.exp(-pm.cfg.rglru.c * torch.nn.functional.softplus(lam))
    assert float(a_c.min()) >= 0.9 - 1e-6 and float(a_c.max()) <= 0.999 + 1e-6


def test_cache_types_match_reference(both):
    """In a bf16 model ``h`` is float32 and ``conv``/``k``/``v`` bf16,
    in ``Model.cache_specs``/``init_cache`` and the engine's spec."""
    cfg = _cfg(get_config, "bfloat16")
    jspec = jax.eval_shape(lambda: jax_make_model(cfg).init_cache(B, MAX_LEN))
    want = {"/".join(str(getattr(p, "key", f"[{getattr(p, 'idx', '')}]"))
                     for p in path): (tuple(l.shape), str(l.dtype))
            for path, l in jax.tree_util.tree_flatten_with_path(jspec)[0]}
    assert want["[0]/[0]/h"][1] == "float32"
    assert want["[0]/[0]/conv"][1] == "bfloat16"
    pcfg = _cfg(port_get_config, "bfloat16")
    pm = make_model(pcfg, device="cpu")

    def kinds(tree):
        return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in flatten_with_paths(tree).items()}

    assert kinds(pm.cache_specs(B, MAX_LEN)) == want
    assert kinds(pm.init_cache(B, MAX_LEN)) == want
    shapes = pm.cache_shapes(B, MAX_LEN)
    for k, (shape, _) in want.items():
        seg, pos, name = k.split("/")
        assert shapes[int(seg[1:-1])][int(pos[1:-1])][name] == shape, k
    # the engine compiles its session steps for these per-leaf types
    ep = ModelEndpoint(NAME, pcfg, both[5], Executor(), batch_size=B,
                       seq_len=12, device="cpu")
    ep._compile_decode(MAX_LEN)
    assert ep.executor.get(f"{NAME}/decode{MAX_LEN}", (
        ep._params_spec(), pm.cache_specs(B, MAX_LEN), ep._tokens_spec(1),
        TensorSpec((B,), torch.int32)), device="cpu") is not None
    jblk = jax.eval_shape(lambda: jrglru.init_rglru_cache(cfg, B))
    assert kinds(rglru.init_rglru_cache(pcfg, B, "cpu")) == {
        k: (tuple(l.shape), str(l.dtype)) for k, l in jblk.items()}


def test_recurrentgemma_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_model(port_get_config("recurrentgemma-2b"))


# ---------------------------------------------------------------------------
# served through the engine
def _gen_runtime(cfg, store, S, n_steps):
    ep = ModelEndpoint(NAME, cfg, store, Executor(), batch_size=B, seq_len=S,
                       device="cpu")

    def plan_factory(rt):
        base = ep.build_plan(rt)
        base.entries.extend(ep.session_plan_entries(MAX_LEN, rt))
        return base

    def code(ctx, args):
        t0 = time.monotonic()
        toks = ep.generate(ctx, args["tokens"], n_steps=n_steps,
                           max_len=MAX_LEN, plan_offset=3)
        return {"tokens": toks, "latency": time.monotonic() - t0}

    rt = Runtime(FunctionSpec("rg-gen", code, plan_factory=plan_factory,
                              app="serving"))
    rt.init()
    return rt


def test_generation_matches_jax_model(both):
    """A freshened generation session (prefill seeds the preallocated
    cache, decode writes it in place) gives the JAX model's greedy
    tokens for row 0, across the ring's wrap."""
    jm, jp, tm, _, jfns, store = both
    S = 12
    toks = _tokens(S)
    rt = _gen_runtime(tm.cfg, store, S, STEPS)
    rt.freshen(blocking=True)
    assert rt.fr_state.stats()["freshened"] >= 4
    port_tokens = rt.run({"tokens": toks})["tokens"]
    jl, jc = jfns["prefill"](jp, jnp.asarray(toks), max_len=MAX_LEN)
    tok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
    want = [int(tok[0, 0])]
    pos = jnp.full((B,), S, jnp.int32)
    for _ in range(STEPS - 1):
        jl, jc = jfns["decode"](jp, jc, tok, pos)
        tok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        pos = pos + 1
        want.append(int(tok[0, 0]))
    assert port_tokens == want
    # a second session on the same runtime reuses the cache it seeds anew
    assert rt.run({"tokens": toks})["tokens"] == want


def test_scored_cold_and_freshened_logits_equal(both):
    _, _, tm, _, _, store = both
    toks = _tokens(24)
    eng, eng2 = ServingEngine(), ServingEngine()
    try:
        rt_cold = eng.deploy(ModelEndpoint(NAME, tm.cfg, store, Executor(),
                                           batch_size=B, seq_len=24,
                                           device="cpu"))
        cold = eng.invoke(NAME, toks, freshen_successors=False)
        assert rt_cold.fr_state.stats()["inline"] >= 3
        rt = eng2.deploy(ModelEndpoint(NAME, tm.cfg, store, Executor(),
                                       batch_size=B, seq_len=24,
                                       device="cpu"))
        rt.freshen(blocking=True)
        fresh = eng2.invoke(NAME, toks, freshen_successors=False)
        st = rt.fr_state.stats()
        assert st["freshened"] >= 3 and st["inline"] == 0
        assert fresh["logits"].shape == (B, 1, tm.cfg.vocab_size)
        np.testing.assert_array_equal(cold["logits"], fresh["logits"])
    finally:
        eng.close()
        eng2.close()
