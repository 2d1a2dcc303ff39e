"""The port's multi-head latent attention (``repro_torch.models.mla``) and
the ``mla``/``mla_moe`` model held against the JAX reference in float32
on the CPU, on ``deepseek-v2-lite-16b.reduced()`` (one ``mla`` layer with
a dense MLP, one ``mla_moe`` layer with 4 experts, top-2 and a shared
expert; latent 64, nope 32, rope 16, v 32; untied embeddings).

* ``_mla_q``, ``_mla_latents``, ``_expand``, ``mla_prefill`` and
  ``mla_decode`` in both modes against the JAX functions at 1e-5, also
  with a ``q_lora_rank``; the port's ``absorbed`` decode against its
  ``naive`` decode at 1e-4, as ``tests/test_models.py`` checks in JAX.
* The reduced model: forward hidden states, logits and aux at 1e-4, and
  prefill plus 8 greedy decode steps with identical tokens, for both
  decode modes and both MoE dispatches; latent cache shapes and types.
* The weight bridge keeps every leaf's shape and type: the untied
  ``unembed`` and the float32 router of a bf16 model.

One JAX init in bfloat16, written once with ``repro.checkpoint`` and read
by the port's loader; the float32 runs cast both sides' copies up
(exactly).  The ``q_lora_rank`` variant goes through
``params_from_numpy``.  Inputs come from numpy seeds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import save_pytree  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.models import make_model as jax_make_model  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch.checkpoint import (flatten_with_paths, load_pytree,  # noqa: E402
                                    params_from_numpy, tree_map)
from repro_torch.configs import get_config as port_get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import make_model  # noqa: E402
from repro_torch.models import mla, transformer  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
FN_TOL = dict(atol=1e-5, rtol=1e-5)
ATOL = 1e-4
B, S, MAX_LEN, STEPS = 2, 16, 32, 8
D = 256


def _cfgs(dtype="float32", decode_mode="naive", dispatch="einsum", **mla_kw):
    out = []
    for get in (get_config, port_get_config):
        cfg = get(ARCH).reduced()
        out.append(dataclasses.replace(
            cfg, dtype=dtype,
            mla=dataclasses.replace(cfg.mla, decode_mode=decode_mode,
                                    **mla_kw),
            moe=dataclasses.replace(cfg.moe, dispatch=dispatch)))
    return out


def _np(t):
    return t.detach().float().numpy()


def _jax_flat(tree):
    return {"/".join(str(getattr(p, "key", f"[{getattr(p, 'idx', '')}]"))
                     for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def deepseek(tmp_path_factory):
    """bf16 JAX params published once; float32 copies on both sides;
    layer 0's (``mla``) mixer params."""
    jcfg16, _ = _cfgs("bfloat16")
    jp16 = jax_make_model(jcfg16).init(jax.random.PRNGKey(0))
    path = str(tmp_path_factory.mktemp("mla") / "deepseek.npz")
    save_pytree(path, jp16)
    tp16 = load_pytree(path, device="cpu")
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp16)
    tp = tree_map(lambda t: t.float(), tp16)
    jmix = jax.tree.map(lambda a: a[0], jp["seg0"][0]["mixer"])
    tmix = tree_map(lambda t: t[0], tp["seg0"][0]["mixer"])
    return dict(jp16=jp16, tp16=tp16, jp=jp, tp=tp, jmix=jmix, tmix=tmix)


@pytest.fixture(scope="module")
def qlora():
    """A ``q_lora_rank`` 32 variant's mixer params, bridged by numpy."""
    jcfg, pcfg = _cfgs(q_lora_rank=32)
    jp = jmla.init_mla(jax.random.PRNGKey(3), jcfg)
    return jcfg, pcfg, jp, params_from_numpy(_jax_flat(jp), device="cpu")


def _pair(seed, shape):
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _positions(S_):
    return jnp.arange(S_)[None, :], torch.arange(S_)[None, :]


def _mixers(deepseek, variant, qlora):
    if variant == "q_lora":
        return qlora
    jcfg, pcfg = _cfgs()
    return jcfg, pcfg, deepseek["jmix"], deepseek["tmix"]


# ---------------------------------------------------------------------------
# the weight bridge and the shapes
def test_bridge_keeps_every_leaf_type(deepseek):
    want = _jax_flat(deepseek["jp16"])
    for got in (flatten_with_paths(deepseek["tp16"]),
                flatten_with_paths(params_from_numpy(want, device="cpu"))):
        assert got.keys() == want.keys()
        for k, t in got.items():
            assert tuple(t.shape) == want[k].shape, k
            assert str(t.dtype).replace("torch.", "") == str(want[k].dtype), k
    got = flatten_with_paths(deepseek["tp16"])
    assert tuple(got["unembed"].shape) == (D, 512)             # untied
    assert got["unembed"].dtype == torch.bfloat16
    assert got["seg0/[1]/ffn/router"].dtype == torch.float32
    assert got["seg0/[0]/mixer/ckv_norm/scale"].dtype == torch.float32
    assert "seg0/[1]/ffn/shared/wi" in got and "seg0/[0]/ffn/wi" in got


@pytest.mark.parametrize("q_lora_rank", [None, 32])
def test_init_matches_reference_shapes_and_types(q_lora_rank):
    jcfg, pcfg = _cfgs("bfloat16", q_lora_rank=q_lora_rank)
    jspec = jax.eval_shape(lambda: jax_make_model(jcfg).init(
        jax.random.PRNGKey(0)))
    want = {"/".join(str(getattr(p, "key", f"[{getattr(p, 'idx', '')}]"))
                     for p in path): (tuple(l.shape), str(l.dtype))
            for path, l in jax.tree_util.tree_flatten_with_path(jspec)[0]}
    pm = make_model(pcfg, device="cpu")
    got = {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for k, t in flatten_with_paths(
               pm.init(torch.Generator().manual_seed(0))).items()}
    specs = {k: (s.shape, str(s.dtype).replace("torch.", ""))
             for k, s in flatten_with_paths(pm.param_specs()).items()}
    assert got == specs == want
    assert ("seg0/[0]/mixer/wq_a" in want) == bool(q_lora_rank)


@pytest.mark.parametrize("kind", ["mla", "mla_moe"])
def test_latent_cache_specs_match_reference(kind):
    jcfg, pcfg = _cfgs("bfloat16")
    want = jtransformer.init_block_cache(kind, jcfg, B, MAX_LEN)
    got = transformer.block_cache_specs(kind, pcfg, B, MAX_LEN)
    assert set(got) == set(want) == {"ckv", "kr"}
    for name in got:
        assert got[name].shape == want[name].shape
        assert got[name].dtype == torch.bfloat16
    assert got["ckv"].shape == (B, MAX_LEN, 64)
    assert got["kr"].shape == (B, MAX_LEN, 16)
    jm, pm = jax_make_model(jcfg), make_model(pcfg, device="cpu")
    jshapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                           jax.eval_shape(lambda: jm.init_cache(B, MAX_LEN)))
    pshapes = tree_map(lambda s: (s.shape, str(s.dtype).replace("torch.", "")),
                       pm.cache_specs(B, MAX_LEN))
    assert pshapes == tuple(tuple(dict(blk) for blk in seg) for seg in jshapes)


def test_seed_block_cache_places_latents():
    _, pcfg = _cfgs()
    cache = transformer.init_block_cache("mla", pcfg, B, MAX_LEN, "cpu")
    ckv, kr = torch.randn(B, S, 64), torch.randn(B, S, 16)
    out = transformer.seed_block_cache("mla", pcfg, cache, (ckv, kr), S)
    assert out is cache
    assert torch.equal(cache["ckv"][:, :S], ckv)
    assert torch.equal(cache["kr"][:, :S], kr)
    assert not cache["ckv"][:, S:].any()


# ---------------------------------------------------------------------------
# the MLA functions
@pytest.mark.parametrize("variant", ["plain", "q_lora"])
def test_mla_q_and_latents_and_expand(deepseek, qlora, variant):
    jcfg, pcfg, jp, tp = _mixers(deepseek, variant, qlora)
    jx, tx = _pair(1, (B, S, D))
    jpos, tpos = _positions(S)
    for jout, out in zip(jmla._mla_q(jp, jx, jcfg, jpos),
                         mla._mla_q(tp, tx, pcfg, tpos)):
        assert tuple(out.shape) == jout.shape
        np.testing.assert_allclose(_np(out), np.asarray(jout), **FN_TOL)
    jlat = jmla._mla_latents(jp, jx, jcfg, jpos)
    lat = mla._mla_latents(tp, tx, pcfg, tpos)
    for jout, out in zip(jlat, lat):
        assert tuple(out.shape) == jout.shape
        np.testing.assert_allclose(_np(out), np.asarray(jout), **FN_TOL)
    for jout, out in zip(jmla._expand(jp, jlat[0], jcfg),
                         mla._expand(tp, lat[0], pcfg)):
        assert tuple(out.shape) == jout.shape == (B, S, 4, 32)
        np.testing.assert_allclose(_np(out), np.asarray(jout), **FN_TOL)


@pytest.mark.parametrize("variant", ["plain", "q_lora"])
def test_mla_prefill_matches_jax(deepseek, qlora, variant):
    jcfg, pcfg, jp, tp = _mixers(deepseek, variant, qlora)
    jx, tx = _pair(2, (B, S, D))
    jout, (jckv, jkr) = jmla.mla_prefill(jp, jx, jcfg)
    before = ops.flash_attention.launches
    out, (ckv, kr) = mla.mla_prefill(tp, tx, pcfg)
    assert ops.flash_attention.launches == before      # CPU: plain version
    for got, want in ((out, jout), (ckv, jckv), (kr, jkr)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(_np(got), np.asarray(want), **FN_TOL)


@pytest.mark.parametrize("variant", ["plain", "q_lora"])
@pytest.mark.parametrize("mode", ["naive", "absorbed"])
def test_mla_decode_matches_jax(deepseek, qlora, variant, mode):
    """A latent cache of random contents, rows at different positions:
    the output, and the token's latents written in place at ``pos``."""
    jcfg, pcfg, jp, tp = _mixers(deepseek, variant, qlora)
    jcfg = dataclasses.replace(
        jcfg, mla=dataclasses.replace(jcfg.mla, decode_mode=mode))
    pcfg = dataclasses.replace(
        pcfg, mla=dataclasses.replace(pcfg.mla, decode_mode=mode))
    jx, tx = _pair(3, (B, 1, D))
    jckv, tckv = _pair(4, (B, MAX_LEN, 64))
    jkr, tkr = _pair(5, (B, MAX_LEN, 16))
    pos = np.array([5, 20], np.int32)
    jout, jcache = jmla.mla_decode(jp, jx, jcfg, {"ckv": jckv, "kr": jkr},
                                   jnp.asarray(pos))
    cache = {"ckv": tckv, "kr": tkr}
    ckv_buf = cache["ckv"]
    out, new = mla.mla_decode(tp, tx, pcfg, cache, torch.from_numpy(pos))
    assert new is cache and new["ckv"] is ckv_buf           # in place
    np.testing.assert_allclose(_np(out), np.asarray(jout), **FN_TOL)
    for name in ("ckv", "kr"):
        np.testing.assert_allclose(_np(new[name]), np.asarray(jcache[name]),
                                   **FN_TOL)


@pytest.mark.parametrize("variant", ["plain", "q_lora"])
def test_absorbed_decode_matches_naive(deepseek, qlora, variant):
    """The port's two decode modes agree at 1e-4 over a prefilled cache."""
    _, pcfg, _, tp = _mixers(deepseek, variant, qlora)
    _, tx = _pair(6, (B, S, D))
    _, (ckv, kr) = mla.mla_prefill(tp, tx, pcfg)
    _, tstep = _pair(7, (B, 1, D))
    outs = {}
    for mode in ("naive", "absorbed"):
        cfg = dataclasses.replace(
            pcfg, mla=dataclasses.replace(pcfg.mla, decode_mode=mode))
        cache = {n: torch.zeros((B, MAX_LEN, t.shape[-1]))
                 for n, t in (("ckv", ckv), ("kr", kr))}
        cache["ckv"][:, :S], cache["kr"][:, :S] = ckv, kr
        outs[mode], _ = mla.mla_decode(tp, tstep, cfg, cache,
                                       torch.full((B,), S, dtype=torch.int32))
    np.testing.assert_allclose(_np(outs["absorbed"]), _np(outs["naive"]),
                               atol=1e-4, rtol=1e-4)


def test_decode_modes_on_cpu_launch_nothing(deepseek):
    _, pcfg = _cfgs()
    before = tuple(op.launches for op in ops.KERNELS)
    _, tx = _pair(8, (B, 1, D))
    for mode in ("naive", "absorbed"):
        cfg = dataclasses.replace(
            pcfg, mla=dataclasses.replace(pcfg.mla, decode_mode=mode))
        cache = {"ckv": torch.zeros(B, MAX_LEN, 64),
                 "kr": torch.zeros(B, MAX_LEN, 16)}
        mla.mla_decode(deepseek["tmix"], tx, cfg, cache,
                       torch.tensor([0, 3], dtype=torch.int32))
    assert tuple(op.launches for op in ops.KERNELS) == before
    with pytest.raises(ValueError, match="sideways"):
        mla.mla_decode(deepseek["tmix"], tx, dataclasses.replace(
            pcfg, mla=dataclasses.replace(pcfg.mla, decode_mode="sideways")),
            cache, torch.tensor([0, 3], dtype=torch.int32))


# ---------------------------------------------------------------------------
# the reduced model
@pytest.fixture(scope="module")
def models():
    out = {}
    for mode in ("naive", "absorbed"):
        for dispatch in ("einsum", "gather"):
            jcfg, pcfg = _cfgs(decode_mode=mode, dispatch=dispatch)
            jm = jax_make_model(jcfg)
            out[mode, dispatch] = (
                jm, make_model(pcfg, device="cpu"),
                dict(prefill=jax.jit(jm.prefill,
                                     static_argnames=("max_len",)),
                     decode=jax.jit(jm.decode_step)))
    return out


def _tokens(S_=S, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, S_)).astype(
        np.int32)


def test_forward_hidden_logits_and_aux(deepseek, models):
    jm, tm, _ = models["naive", "einsum"]
    toks = _tokens(32)
    jx, jaux = jm.forward(deepseek["jp"], jnp.asarray(toks))
    with torch.no_grad():
        tx, aux = tm.forward(deepseek["tp"], torch.from_numpy(toks))
        tl = tm._logits(deepseek["tp"], tx)
    np.testing.assert_allclose(_np(tx), np.asarray(jx), atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        _np(tl), np.asarray(jm._logits(deepseek["jp"], jx)), atol=ATOL,
        rtol=0)
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("mode", ["naive", "absorbed"])
def test_prefill_and_greedy_decode_match_jax(deepseek, models, mode,
                                             dispatch):
    """Prefill and 8 greedy decode steps: logits within 1e-4 at every
    step, identical tokens, latent caches equal."""
    jm, tm, jfns = models[mode, dispatch]
    jp, tp = deepseek["jp"], deepseek["tp"]
    toks = _tokens()
    jl, jc = jfns["prefill"](jp, jnp.asarray(toks), max_len=MAX_LEN)
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
        jl, jc = jfns["decode"](jp, jc, jtok, jpos)
        with torch.no_grad():
            tl, tc = tm.decode_step(tp, tc, ttok, tpos)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL,
                                   rtol=0, err_msg=f"step {step}")
        jtok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        ttok = torch.argmax(tl[:, -1:], dim=-1).to(torch.int32)
        jpos, tpos = jpos + 1, tpos + 1
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    for j in range(2):
        for name in ("ckv", "kr"):
            np.testing.assert_allclose(_np(tc[0][j][name]),
                                       np.asarray(jc[0][j][name]), atol=ATOL,
                                       rtol=0, err_msg=f"[{j}] {name}")
