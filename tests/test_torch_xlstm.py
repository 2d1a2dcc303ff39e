"""The port's xLSTM path (``repro_torch.models.xlstm``, the ``mlstm`` and
``slstm`` blocks) held against the JAX reference in float32 on the CPU.

* Each xLSTM function against its JAX counterpart at 1e-5: the chunkwise
  mLSTM at chunk 16 and 64, its decode step, the projections with and
  without a conv cache (prompts shorter than the conv window too), the
  sLSTM recurrence and both block applies in prefill and decode.
* Both caches' initial values (the mLSTM's ``m`` is -1e30, the sLSTM's
  ``n`` 1e-12, not zeros) and the init's keys, shapes and types, with
  the float32 leaves inside a bf16 model; a bf16 xLSTM checkpoint
  through the bridge bit for bit.
* The reduced xlstm-350m, ``(mlstm, slstm)`` once and twice, against
  the JAX ``Model`` at 1e-4 with identical greedy tokens over 16 decode
  steps, and served through the engine with the JAX endpoint's tokens.

One JAX init of the two-repeat model, published once by the JAX
``WeightStore``, gives both sides the same weights; the one-repeat model
takes the first repeat of each stacked leaf.  Inputs are made with numpy
from a seed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import load_pytree as jax_load  # noqa: E402
from repro.checkpoint import save_pytree as jax_save  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core import FunctionSpec as JaxSpec  # noqa: E402
from repro.core import Runtime as JaxRuntime  # noqa: E402
from repro.models import make_model as jax_make_model  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro.serving import Executor as JaxExecutor  # noqa: E402
from repro.serving import ModelEndpoint as JaxEndpoint  # noqa: E402
from repro.serving import WeightStore as JaxWeightStore  # noqa: E402
from repro_torch.checkpoint import (flatten_with_paths, load_pytree,  # noqa: E402
                                    save_pytree, tree_map)
from repro_torch.configs import get_config as port_get_config  # noqa: E402
from repro_torch.core import FunctionSpec, Runtime  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import make_model  # noqa: E402
from repro_torch.models import transformer, xlstm  # noqa: E402
from repro_torch.serving import Executor, ModelEndpoint, WeightStore  # noqa: E402

FN_TOL = dict(atol=1e-5, rtol=1e-5)
ATOL = 1e-4
B, MAX_LEN, STEPS = 2, 64, 16
NAME = "xl"


def _cfg(get, reps=2, dtype="float32"):
    base = get("xlstm-350m").reduced(d_model=128)
    return dataclasses.replace(base, vocab_size=256, dtype=dtype,
                               segments=((("mlstm", "slstm"), reps),),
                               n_layers=2 * reps)


def _np(t):
    return t.detach().float().numpy()


def _paths(tree):
    return {"/".join(str(getattr(p, "key", f"[{getattr(p, 'idx', '')}]"))
                     for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The two-repeat JAX model and params, published once, and the
    port's model and params read from the same file."""
    root = tmp_path_factory.mktemp("xl")
    jm = jax_make_model(_cfg(get_config))
    jp = jm.init(jax.random.PRNGKey(0))
    jstore = JaxWeightStore(str(root))
    jstore.publish(NAME, jp)
    store = WeightStore(str(root))
    tp, _, _ = store.load(NAME, device="cpu")
    tm = make_model(_cfg(port_get_config), device="cpu")
    return jm, jp, tm, tp, store, jstore


@pytest.fixture(scope="module")
def models(both):
    """reps -> (JAX model, JAX params, jitted prefill/decode, port model,
    port params); the one-repeat params are the first repeat's."""
    jm, jp, tm, tp, _, _ = both
    out = {}
    for reps in (1, 2):
        if reps == 2:
            jm_r, jp_r, tm_r, tp_r = jm, jp, tm, tp
        else:
            jm_r = jax_make_model(_cfg(get_config, reps))
            jp_r = dict(jp, seg0=jax.tree.map(lambda a: a[:1], jp["seg0"]))
            tm_r = make_model(_cfg(port_get_config, reps), device="cpu")
            tp_r = dict(tp, seg0=tree_map(lambda t: t[:1], tp["seg0"]))
        fns = dict(prefill=jax.jit(jm_r.prefill, static_argnames=("max_len",)),
                   decode=jax.jit(jm_r.decode_step))
        out[reps] = (jm_r, jp_r, fns, tm_r, tp_r)
    return out


@pytest.fixture(scope="module")
def blocks(both):
    """Layer 0's mLSTM and sLSTM mixer params on both sides, and the
    config."""
    jm, jp, tm, tp, _, _ = both
    jb = [jax.tree.map(lambda a: a[0], jp["seg0"][j]["mixer"])
          for j in range(2)]
    tb = [tree_map(lambda t: t[0], tp["seg0"][j]["mixer"]) for j in range(2)]
    return jm.cfg, tm.cfg, jb, tb


def _pair(rng, shape, shift=0.0):
    x = rng.standard_normal(shape, dtype=np.float32) + np.float32(shift)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _close(got, want, tol=FN_TOL, msg=""):
    assert tuple(got.shape) == tuple(want.shape), msg
    np.testing.assert_allclose(_np(got), np.asarray(want), err_msg=msg, **tol)


# ---------------------------------------------------------------------------
# mLSTM functions
@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("S", [64, 128])
def test_mlstm_parallel(chunk, S):
    rng = np.random.default_rng(S + chunk)
    shp = (B, S, 4, 32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, shp) for _ in range(3))
    ji, ti = _pair(rng, shp[:3])
    jf, tf = _pair(rng, shp[:3], 2.0)
    jh, jstate = jx.mlstm_parallel(jq, jk, jv, ji, jf, chunk=chunk)
    th, tstate = xlstm.mlstm_parallel(tq, tk, tv, ti, tf, chunk=chunk)
    assert th.dtype == torch.float32
    _close(th, jh, msg="h")
    for name, got, want in zip("Cnm", tstate, jstate):
        _close(got, want, msg=name)


def test_mlstm_parallel_refuses_a_ragged_chunk():
    """The reference asserts S % chunk == 0 (no padding); so does the
    port, with a ValueError."""
    rng = np.random.default_rng(0)
    for S, chunk in ((100, 64), (48, 32)):
        shp = (1, S, 2, 8)
        (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, shp) for _ in range(3))
        ji, ti = _pair(rng, shp[:3])
        with pytest.raises(AssertionError):
            jx.mlstm_parallel(jq, jk, jv, ji, ji, chunk=chunk)
        with pytest.raises(ValueError, match="multiple"):
            xlstm.mlstm_parallel(tq, tk, tv, ti, ti, chunk=chunk)


def test_mlstm_parallel_bf16_rounds_p_before_pv():
    """In a bf16 model the reference rounds s to v's type before P·V and
    returns h in q's type: the port's h then agrees to well under one
    bf16 step (without the rounding, 0.0625 apart here)."""
    rng = np.random.default_rng(9)
    shp = (B, 32, 2, 16)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, shp) for _ in range(3))
    ji, ti = _pair(rng, shp[:3])
    jf, tf = _pair(rng, shp[:3], 2.0)
    bf = [a.astype(jnp.bfloat16) for a in (jq, jk, jv)]
    tbf = [t.to(torch.bfloat16) for t in (tq, tk, tv)]
    jh, _ = jx.mlstm_parallel(*bf, ji, jf, chunk=16)
    th, _ = xlstm.mlstm_parallel(*tbf, ti, tf, chunk=16)
    assert th.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(th), np.asarray(jh, np.float32),
                               atol=1e-3, rtol=0)


def test_mlstm_step():
    rng = np.random.default_rng(2)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, (B, 4, 32)) for _ in range(3))
    ji, ti = _pair(rng, (B, 4))
    jf, tf = _pair(rng, (B, 4), 2.0)
    jC, tC = _pair(rng, (B, 4, 32, 32))
    jn, tn = _pair(rng, (B, 4, 32))
    jm, tm = _pair(rng, (B, 4))
    jh, jstate = jx.mlstm_step(jq, jk, jv, ji, jf, (jC, jn, jm))
    th, tstate = xlstm.mlstm_step(tq, tk, tv, ti, tf, (tC, tn, tm))
    _close(th, jh, msg="h")
    for name, got, want in zip("Cnm", tstate, jstate):
        _close(got, want, msg=name)


@pytest.mark.parametrize("S,with_cache", [(1, False), (2, False), (3, False),
                                          (1, True)])
def test_mlstm_qkv(blocks, S, with_cache):
    """S 1 and 2 are shorter than width - 1 = 3: the conv state is
    left-padded with zeros."""
    jcfg, pcfg, jb, tb = blocks
    rng = np.random.default_rng(S)
    jxx, txx = _pair(rng, (B, S, 128))
    jc = tc = None
    if with_cache:
        jc, tc = _pair(rng, (B, 3, 256))
    want = jx._mlstm_qkv(jb[0], jxx, jcfg, conv_cache=jc)
    got = xlstm._mlstm_qkv(tb[0], txx, pcfg, conv_cache=tc)
    for name, g, w in zip(("q", "k", "v", "i", "f", "z", "conv"), got, want):
        _close(g, w, msg=name)


def test_mlstm_block_apply_prefill_and_decode(blocks):
    jcfg, pcfg, jb, tb = blocks
    rng = np.random.default_rng(11)
    jxx, txx = _pair(rng, (B, 32, 128))
    jout, jc = jx.mlstm_block_apply(jb[0], jxx, jcfg)
    with torch.no_grad():
        tout, tc = xlstm.mlstm_block_apply(tb[0], txx, pcfg)
    _close(tout, jout, msg="prefill out")
    assert set(tc) == set(jc) == {"C", "n", "m", "conv"}
    for name in tc:
        _close(tc[name], jc[name], msg=f"prefill {name}")
    jxx, txx = _pair(rng, (B, 1, 128))
    jout, jnew = jx.mlstm_block_apply(jb[0], jxx, jcfg, cache=jc)
    with torch.no_grad():
        tout, tnew = xlstm.mlstm_block_apply(tb[0], txx, pcfg, cache=tc)
    _close(tout, jout, msg="decode out")
    for name in tnew:
        _close(tnew[name], jnew[name], msg=f"decode {name}")


# ---------------------------------------------------------------------------
# sLSTM functions
def test_block_rec(blocks):
    _, _, jb, tb = blocks
    jh, th = _pair(np.random.default_rng(3), (B, 128))
    _close(xlstm._block_rec(tb[1]["r_z"], th, 4),
           jx._block_rec(jb[1]["r_z"], jh, 4))


def test_slstm_step(blocks):
    _, _, jb, tb = blocks
    rng = np.random.default_rng(4)
    ins = [_pair(rng, (B, 128)) for _ in range(4)]
    jst, tst = {}, {}
    for name in ("c", "n", "h", "m"):
        jst[name], tst[name] = _pair(rng, (B, 128))
    jst["n"], tst["n"] = jnp.abs(jst["n"]) + 0.5, tst["n"].abs() + 0.5
    want = jx.slstm_step(jb[1], *[a for a, _ in ins], jst, 4)
    got = xlstm.slstm_step(tb[1], *[t for _, t in ins], tst, 4)
    assert set(got) == set(want)
    for name in got:
        _close(got[name], want[name], msg=name)


@pytest.mark.parametrize("S", [1, 24])
def test_slstm_block_apply_prefill_and_decode(blocks, S):
    jcfg, pcfg, jb, tb = blocks
    rng = np.random.default_rng(S + 5)
    jxx, txx = _pair(rng, (B, S, 128))
    jout, jc = jx.slstm_block_apply(jb[1], jxx, jcfg)
    with torch.no_grad():
        tout, tc = xlstm.slstm_block_apply(tb[1], txx, pcfg)
    _close(tout, jout, msg="prefill out")
    for name in ("c", "n", "h", "m"):
        _close(tc[name], jc[name], msg=f"prefill {name}")
    jxx, txx = _pair(rng, (B, 1, 128))
    jout, jnew = jx.slstm_block_apply(jb[1], jxx, jcfg, cache=jc)
    with torch.no_grad():
        tout, tnew = xlstm.slstm_block_apply(tb[1], txx, pcfg, cache=tc)
    _close(tout, jout, msg="decode out")
    for name in tnew:
        _close(tnew[name], jnew[name], msg=f"decode {name}")


# ---------------------------------------------------------------------------
# caches, init and the bridge
def _kinds(tree):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tree.items()}


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_cache_initial_values_match_reference(kind):
    """Not zeros: the mLSTM's ``m`` starts at -1e30 and the sLSTM's ``n``
    at 1e-12, in the block cache, ``Model.init_cache`` and the specs."""
    cfg = _cfg(get_config, dtype="bfloat16")
    pcfg = _cfg(port_get_config, dtype="bfloat16")
    want = jtransformer.init_block_cache(kind, cfg, B, MAX_LEN)
    got = transformer.init_block_cache(kind, pcfg, B, MAX_LEN, "cpu")
    assert _kinds(got) == {k: (a.shape, str(a.dtype)) for k, a in want.items()}
    for name in want:
        np.testing.assert_array_equal(_np(got[name]),
                                      np.asarray(want[name], np.float32),
                                      err_msg=name)
    init = {"mlstm": xlstm.init_mlstm_cache,
            "slstm": xlstm.init_slstm_cache}[kind](pcfg, B, "cpu")
    assert all(torch.equal(init[k], got[k]) for k in got)
    pm = make_model(pcfg, device="cpu")
    jwant = _paths(jax_make_model(cfg).init_cache(B, MAX_LEN))
    cache = flatten_with_paths(pm.init_cache(B, MAX_LEN))
    assert cache.keys() == jwant.keys()
    for k, leaf in jwant.items():
        assert str(cache[k].dtype).replace("torch.", "") == str(leaf.dtype)
        np.testing.assert_array_equal(_np(cache[k]),
                                      np.asarray(leaf, np.float32), err_msg=k)
    specs = flatten_with_paths(pm.cache_specs(B, MAX_LEN))
    assert {k: s.shape for k, s in specs.items()} == {
        k: t.shape for k, t in cache.items()}


def test_init_matches_reference_shapes_and_types():
    """Same key paths, shapes and types as the reference in a bf16 model:
    the mLSTM gates and the sLSTM's ``r_*``/``b_*`` stay float32, the
    ``r_*`` as (nh, dh, dh) stacks."""
    jspec = jax.eval_shape(lambda: jax_make_model(
        _cfg(get_config, dtype="bfloat16")).init(jax.random.PRNGKey(0)))
    want = {k: (tuple(a.shape), str(a.dtype))
            for k, a in _paths(jspec).items()}
    pm = make_model(_cfg(port_get_config, dtype="bfloat16"), device="cpu")
    got = _kinds(flatten_with_paths(
        pm.init(torch.Generator().manual_seed(0))))
    assert got == want
    assert _kinds(flatten_with_paths(pm.param_specs())) == want
    for k in ("w_i", "b_i", "w_f", "b_f"):
        assert want[f"seg0/[0]/mixer/{k}"][1] == "float32"
    for k in ("r_z", "r_i", "r_f", "r_o", "b_z", "b_i", "b_f", "b_o"):
        assert want[f"seg0/[1]/mixer/{k}"][1] == "float32"
    assert want["seg0/[1]/mixer/r_z"][0] == (2, 4, 32, 32)
    assert want["seg0/[0]/mixer/wq"][1] == "bfloat16"


def test_bf16_checkpoint_round_trip_is_bit_equal(both, tmp_path):
    """A bf16 xLSTM checkpoint written by JAX, with its float32 leaves,
    loads into the port and written back loads into JAX bit for bit."""
    _, jp, _, _, _, _ = both
    spec = jax.eval_shape(lambda: jax_make_model(
        _cfg(get_config, dtype="bfloat16")).init(jax.random.PRNGKey(0)))
    jbf = jax.tree.map(lambda a, s: a.astype(s.dtype), jp, spec)
    jax_save(str(tmp_path / "jax.npz"), jbf)
    port = load_pytree(str(tmp_path / "jax.npz"), device="cpu")
    types = {k: t.dtype for k, t in flatten_with_paths(port).items()}
    assert types["seg0/[0]/mixer/w_up"] == torch.bfloat16
    assert types["seg0/[0]/mixer/w_f"] == torch.float32
    assert types["seg0/[1]/mixer/r_o"] == torch.float32
    save_pytree(str(tmp_path / "port.npz"), port)
    back = _paths(jax_load(str(tmp_path / "port.npz"), jbf))
    want = _paths(jbf)
    assert back.keys() == want.keys()
    for k, leaf in want.items():
        assert back[k].dtype == leaf.dtype, k
        a, b = np.asarray(back[k]), np.asarray(leaf)
        if a.dtype.itemsize == 2:
            a, b = a.view(np.uint16), b.view(np.uint16)
        np.testing.assert_array_equal(a, b, err_msg=k)


# ---------------------------------------------------------------------------
# the slice as a whole: the reduced model, once and twice
def _tokens(S, seed=0):
    return np.random.default_rng(S + seed).integers(0, 256, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("reps", [1, 2])
def test_forward_hidden_and_logits(models, reps):
    jm, jp, _, tm, tp = models[reps]
    toks = _tokens(32)
    jh, _ = jm.forward(jp, jnp.asarray(toks))
    with torch.no_grad():
        th, aux = tm.forward(tp, torch.from_numpy(toks))
        tl = tm._logits(tp, th)
    np.testing.assert_allclose(_np(th), np.asarray(jh), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(tl), np.asarray(jm._logits(jp, jh)),
                               atol=ATOL, rtol=0)
    assert float(aux) == 0.0


@pytest.mark.parametrize("reps,S", [(1, 2), (1, 32), (2, 32)])
def test_prefill_decode_and_greedy_tokens(models, reps, S):
    """Prefill, then STEPS decode steps, each side on its own greedy
    tokens: logits within 1e-4 at every step, identical tokens, and the
    in-place cache ends equal to the reference's (prompt 2 is shorter
    than the conv window).  No kernel is launched."""
    jm, jp, fns, tm, tp = models[reps]
    toks = _tokens(S)
    before = tuple(op.launches for op in ops.KERNELS)
    jl, jc = fns["prefill"](jp, jnp.asarray(toks), max_len=MAX_LEN)
    with torch.no_grad():
        tl, tc = tm.prefill(tp, torch.from_numpy(toks), max_len=MAX_LEN)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL, rtol=0)
    jtok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
    ttok = torch.argmax(tl[:, -1:], dim=-1).to(torch.int32)
    jpos = jnp.full((B,), S, jnp.int32)
    tpos = torch.full((B,), S, dtype=torch.int32)
    for step in range(STEPS):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok),
                                      err_msg=f"step {step}")
        jl, jc = fns["decode"](jp, jc, jtok, jpos)
        with torch.no_grad():
            tl, tc2 = tm.decode_step(tp, tc, ttok, tpos)
        assert tc2 is tc
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL,
                                   rtol=0, err_msg=f"step {step}")
        jtok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        ttok = torch.argmax(tl[:, -1:], dim=-1).to(torch.int32)
        jpos, tpos = jpos + 1, tpos + 1
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    got, want = flatten_with_paths(tc), _paths(jc)
    assert got.keys() == want.keys()
    assert {k.rsplit("/", 1)[1] for k in got} == {"C", "n", "m", "conv", "c",
                                                  "h"}
    for k in got:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   atol=ATOL, rtol=1e-5, err_msg=k)
    assert tuple(op.launches for op in ops.KERNELS) == before


# ---------------------------------------------------------------------------
# served through the engine
def test_torch_endpoint_returns_the_jax_endpoints_tokens(both):
    """The .npz the JAX store published, one prompt, greedy decoding of
    STEPS tokens from a freshened session on each side."""
    _, _, tm, _, store, jstore = both
    S = 32
    prompt = _tokens(S, seed=1)[:1]

    def gen_runtime(ep, spec_cls, rt_cls, name):
        def plan_factory(rt):
            base = ep.build_plan(rt)
            base.entries.extend(ep.session_plan_entries(MAX_LEN))
            return base

        def code(ctx, args):
            return ep.generate(ctx, args["tokens"], n_steps=STEPS,
                               max_len=MAX_LEN, plan_offset=3)

        rt = rt_cls(spec_cls(name, code, plan_factory=plan_factory,
                             app="serving"))
        rt.init()
        rt.freshen(blocking=True)
        return rt

    ep = ModelEndpoint(NAME, tm.cfg, store, Executor(), batch_size=1,
                       seq_len=S, device="cpu")
    port_tokens = gen_runtime(ep, FunctionSpec, Runtime, "gen").run(
        {"tokens": prompt})
    jep = JaxEndpoint(NAME, _cfg(get_config), jstore, JaxExecutor(),
                      batch_size=1, seq_len=S)
    jax_tokens = gen_runtime(jep, JaxSpec, JaxRuntime, "jgen").run(
        {"tokens": prompt})
    assert len(port_tokens) == STEPS
    assert port_tokens == jax_tokens
