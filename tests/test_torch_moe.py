"""The port's MoE layer (``repro_torch.models.moe``) and the ``attn_moe``
model held against the JAX reference in float32 on the CPU, on
``granite-moe-1b-a400m.reduced()`` (E 4, top-2, group 32, so C = 20 slots
for 16 assignments per expert on average: the default capacity drops).

* Routing, capacity, both dispatches (with drops and, at capacity factor
  8, without), the dense oracle, shared experts and each activation
  against the JAX functions at 1e-5 (routing at 1e-6).
* K4's route (``grouped``: ``routed`` as it runs on the card, here
  through the op's plain version, ``kernels/ref.py`` ``moe_grouped_ref``)
  on the same inputs against the JAX functions, with and without drops,
  and with top-k gates kept raw (DeepSeek-V2) at 4 experts top-2 and 64
  top-6: the raw gates are the renormalised ones times their sum, so the
  JAX output scaled by that sum is the want.
* The reduced model: forward hidden states, logits and aux at 1e-4, and
  prefill plus 8 greedy decode steps with identical tokens under both
  dispatches and K4's route; cache and param shapes and types.
* The weight bridge keeps every leaf's shape and type, the float32
  router of a bf16 model included.

One JAX init in bfloat16, written once with ``repro.checkpoint`` and read
by the port's loader; the float32 runs cast both sides' copies up
(exactly).  Variants that need other params (shared experts,
activations) go through ``params_from_numpy``.  Inputs come from numpy
seeds.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import save_pytree  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.models import make_model as jax_make_model  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch.checkpoint import (flatten_with_paths, load_pytree,  # noqa: E402
                                    params_from_numpy, tree_map)
from repro_torch.configs import get_config as port_get_config  # noqa: E402
from repro_torch.configs.port import PortMoEConfig, port_config  # noqa: E402
from repro_torch.models import make_model  # noqa: E402
from repro_torch.models import moe, transformer  # noqa: E402

ARCH = "granite-moe-1b-a400m"
ROUTE_TOL = dict(atol=1e-6, rtol=1e-6)
FN_TOL = dict(atol=1e-5, rtol=1e-5)
ATOL = 1e-4
B, S, MAX_LEN, STEPS = 2, 16, 32, 8


def _cfgs(dtype="float32", **moe_kw):
    """The reduced config on both sides, with MoE fields replaced."""
    out = []
    for get in (get_config, port_get_config):
        cfg = get(ARCH).reduced()
        out.append(dataclasses.replace(
            cfg, dtype=dtype, moe=dataclasses.replace(cfg.moe, **moe_kw)))
    return out


def _np(t):
    return t.detach().float().numpy()


def _dispatch(monkeypatch, dispatch):
    """The config's ``dispatch`` for a case.  ``grouped`` forces
    ``routed`` onto K4's route, whose op runs its plain version on CPU
    tensors; the config keeps ``einsum``, which that route does not read."""
    if dispatch != "grouped":
        return dispatch
    monkeypatch.setattr(moe, "_grouped", lambda *a: True)
    return "einsum"


def _jax_flat(tree):
    return {"/".join(str(getattr(p, "key", f"[{getattr(p, 'idx', '')}]"))
                     for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _bridge(jtree):
    """JAX params -> the port's, through ``params_from_numpy``."""
    return params_from_numpy(_jax_flat(jtree), device="cpu")


@pytest.fixture(scope="module")
def granite(tmp_path_factory):
    """bf16 JAX params published once; float32 copies on both sides."""
    jcfg16, _ = _cfgs("bfloat16")
    jp16 = jax_make_model(jcfg16).init(jax.random.PRNGKey(0))
    path = str(tmp_path_factory.mktemp("moe") / "granite.npz")
    save_pytree(path, jp16)
    tp16 = load_pytree(path, device="cpu")
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp16)
    tp = tree_map(lambda t: t.float(), tp16)
    jffn = jax.tree.map(lambda a: a[0], jp["seg0"][0]["ffn"])
    tffn = tree_map(lambda t: t[0], tp["seg0"][0]["ffn"])
    return dict(jp16=jp16, tp16=tp16, jp=jp, tp=tp, jffn=jffn, tffn=tffn)


def _x(seed, shape=(B, 32, 256)):
    """Token states at unit RMS, as the block's RMSNorm hands them to
    the MoE layer, with one direction they all share, as hidden states
    have: it skews the routing, so the default capacity drops."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape, dtype=np.float32)
         + 2.0 * rng.standard_normal(shape[-1], dtype=np.float32))
    x = x / np.sqrt(np.mean(x * x, axis=-1, keepdims=True))
    return jnp.asarray(x), torch.from_numpy(x.copy())


# ---------------------------------------------------------------------------
# the weight bridge and the shapes
def test_bridge_keeps_every_leaf_type(granite):
    """The bf16 checkpoint loads with each leaf's shape and type: the
    router stays float32 among bf16 expert stacks."""
    want = _jax_flat(granite["jp16"])
    for got in (flatten_with_paths(granite["tp16"]),
                flatten_with_paths(_bridge(granite["jp16"]))):
        assert got.keys() == want.keys()
        for k, t in got.items():
            assert tuple(t.shape) == want[k].shape, k
            assert str(t.dtype).replace("torch.", "") == str(want[k].dtype), k
    got = flatten_with_paths(granite["tp16"])
    assert got["seg0/[0]/ffn/router"].dtype == torch.float32
    assert got["seg0/[0]/ffn/wi_e"].dtype == torch.bfloat16
    assert tuple(got["seg0/[0]/ffn/wg_e"].shape) == (2, 4, 256, 256)


def test_init_matches_reference_shapes_and_types():
    jcfg, pcfg = _cfgs("bfloat16", n_shared=1)
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
    assert want["seg0/[0]/ffn/router"][1] == "float32"
    assert "seg0/[0]/ffn/shared/wg" in want


def test_attn_moe_cache_is_full_length():
    """granite has no window: its attn_moe cache spans max_len (a kind
    other than attn used to be sized by the window, and raised)."""
    jcfg, pcfg = _cfgs("bfloat16")
    assert pcfg.window_size is None
    want = jtransformer.init_block_cache("attn_moe", jcfg, B, MAX_LEN)
    got = transformer.block_cache_specs("attn_moe", pcfg, B, MAX_LEN)
    assert set(got) == set(want) == {"k", "v"}
    for name in got:
        assert got[name].shape == want[name].shape == (B, MAX_LEN, 4, 32)
        assert got[name].dtype == torch.bfloat16
    m = make_model(pcfg, device="cpu")
    jm = jax_make_model(jcfg)
    jshapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                           jax.eval_shape(lambda: jm.init_cache(B, MAX_LEN)))
    pshapes = tree_map(lambda s: (s.shape, str(s.dtype).replace("torch.", "")),
                       m.cache_specs(B, MAX_LEN))
    assert pshapes == tuple(tuple(dict(blk) for blk in seg) for seg in jshapes)
    cache = m.init_cache(B, MAX_LEN)
    assert tuple(cache[0][0]["k"].shape) == (2, B, MAX_LEN, 4, 32)


# ---------------------------------------------------------------------------
# routing and capacity
def test_routing_matches_jax(granite):
    jcfg, pcfg = _cfgs()
    jx, tx = _x(1, (64, 256))
    jprobs, jidx, jaux = jmoe._routing(granite["jffn"], jx, jcfg.moe)
    probs, idx, aux = moe._routing(granite["tffn"], tx, pcfg.moe)
    assert probs.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(_np(probs), np.asarray(jprobs), **ROUTE_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **ROUTE_TOL)
    # the probabilities gathered at the chosen experts agree too (ties
    # may order equal gates differently)
    gates = torch.softmax(tx @ granite["tffn"]["router"], -1)
    picked = torch.gather(gates, 1, idx)
    np.testing.assert_allclose(
        _np(picked / picked.sum(-1, keepdim=True)), np.asarray(jprobs),
        **ROUTE_TOL)


@pytest.mark.parametrize("tokens,n_experts,top_k,factor", [
    (32, 4, 2, 1.25), (512, 32, 8, 1.25), (512, 64, 6, 1.25), (4, 32, 8, 1.25),
    (2, 4, 2, 8.0), (100, 7, 3, 1.0), (33, 5, 2, 0.5), (1, 64, 6, 2.0)])
def test_capacity_matches_jax(tokens, n_experts, top_k, factor):
    jcfg, pcfg = _cfgs(n_experts=n_experts, top_k=top_k,
                       capacity_factor=factor)
    assert moe._capacity(tokens, pcfg.moe) == jmoe._capacity(tokens, jcfg.moe)


def test_capacity_at_the_served_shapes():
    """C at batch 4, prompt 128: granite 160 slots, deepseek 60."""
    for arch, want in (("granite-moe-1b-a400m", 160),
                       ("deepseek-v2-lite-16b", 60)):
        e = port_get_config(arch).moe
        assert moe._capacity(min(e.group_size, 4 * 128), e) == want


# ---------------------------------------------------------------------------
# the layer
@pytest.mark.parametrize("factor", [1.25, 8.0])
@pytest.mark.parametrize("dispatch", ["einsum", "gather", "grouped"])
def test_moe_apply_matches_jax(granite, monkeypatch, dispatch, factor):
    """Two dispatch groups; at the default capacity some assignments are
    dropped, at factor 8 none are."""
    jcfg, pcfg = _cfgs(dispatch=_dispatch(monkeypatch, dispatch),
                       capacity_factor=factor)
    jx, tx = _x(2)
    jout, jaux = jmoe.moe_apply(granite["jffn"], jx, jcfg)
    with moe.record_routing() as rec, moe.counting_rows() as count:
        out, aux = moe.moe_apply(granite["tffn"], tx, pcfg)
    if dispatch == "grouped":       # K4's route computed the kept rows
        assert count.rows == count.assignments == 128
    np.testing.assert_allclose(_np(out), np.asarray(jout), **FN_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **ROUTE_TOL)
    (call,) = rec.calls
    assert (call["groups"], call["assignments"]) == (2, 128)
    dropped = int(call["dropped"])
    if factor == 8.0:
        assert call["capacity"] == 128 and dropped == 0
        ref_out, _ = jmoe.moe_ref(granite["jffn"], jx, jcfg)
        np.testing.assert_allclose(_np(out), np.asarray(ref_out), **FN_TOL)
    else:
        assert call["capacity"] == 20 and dropped > 0


def _raw(pcfg):
    """``pcfg`` with its top-k gates kept as the softmax gave them."""
    fields = {f.name: getattr(pcfg.moe, f.name)
              for f in dataclasses.fields(pcfg.moe)}
    return port_config(pcfg, moe=PortMoEConfig(**fields,
                                               norm_topk_prob=False))


@pytest.mark.parametrize("factor", [1.25, "dropless"])
@pytest.mark.parametrize("experts", [(4, 2), (64, 6)])
def test_grouped_raw_gates_match_jax(monkeypatch, experts, factor):
    """K4's route with DeepSeek-V2's raw gates against the JAX layer,
    which renormalises: each token's output is the JAX one times the sum
    of its top-k softmax gates (the drops are the same, as they follow
    the choices alone)."""
    E, k = experts
    jcfg, pcfg = _cfgs(n_experts=E, top_k=k, capacity_factor=(
        E / k if factor == "dropless" else factor))
    jp = jmoe.init_moe(jax.random.PRNGKey(7), jcfg)
    tp, pcfg = _bridge(jp), _raw(pcfg)
    jx, tx = _x(8)
    jout, jaux = jmoe.moe_apply(jp, jx, jcfg)
    gates = jax.nn.softmax(jx.reshape(-1, jx.shape[-1]) @ jp["router"], -1)
    total = jax.lax.top_k(gates, k)[0].sum(-1)
    assert float(total.max()) < 1.0
    want = np.asarray(jout) * np.asarray(total).reshape(B, -1, 1)
    monkeypatch.setattr(moe, "_grouped", lambda *a: True)
    with moe.record_routing() as rec, moe.counting_rows() as count:
        out, aux = moe.moe_apply(tp, tx, pcfg)
    assert count.rows == count.assignments == B * 32 * k
    np.testing.assert_allclose(_np(out), want, **FN_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **ROUTE_TOL)
    (call,) = rec.calls
    assert (int(call["dropped"]) > 0) == (factor == 1.25)


def test_dispatches_drop_the_same_assignments(granite):
    _, ein = _cfgs(dispatch="einsum")
    _, gat = _cfgs(dispatch="gather")
    _, tx = _x(3)
    with moe.record_routing() as rec:
        a, _ = moe.moe_apply(granite["tffn"], tx, ein)
        b, _ = moe.moe_apply(granite["tffn"], tx, gat)
    assert int(rec.calls[0]["dropped"]) == int(rec.calls[1]["dropped"]) > 0
    np.testing.assert_allclose(_np(a), _np(b), **FN_TOL)


def test_moe_ref_matches_jax(granite):
    jcfg, pcfg = _cfgs()
    jx, tx = _x(4)
    jout, jaux = jmoe.moe_ref(granite["jffn"], jx, jcfg)
    out, aux = moe.moe_ref(granite["tffn"], tx, pcfg)
    np.testing.assert_allclose(_np(out), np.asarray(jout), **FN_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **ROUTE_TOL)


def _variant(activation, n_shared, seed):
    jcfg, pcfg = _cfgs(n_shared=n_shared)
    jcfg = dataclasses.replace(jcfg, activation=activation)
    pcfg = dataclasses.replace(pcfg, activation=activation)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    return jcfg, pcfg, jp, _bridge(jp)


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
def test_shared_experts_match_jax(dispatch):
    jcfg, pcfg, jp, tp = _variant("swiglu", 1, 5)
    assert set(tp["shared"]) == {"wi", "wg", "wo"}
    jcfg = dataclasses.replace(
        jcfg, moe=dataclasses.replace(jcfg.moe, dispatch=dispatch))
    pcfg = dataclasses.replace(
        pcfg, moe=dataclasses.replace(pcfg.moe, dispatch=dispatch))
    jx, tx = _x(5)
    for jfn, fn in ((jmoe.moe_apply, moe.moe_apply),
                    (jmoe.moe_ref, moe.moe_ref)):
        jout, _ = jfn(jp, jx, jcfg)
        out, _ = fn(tp, tx, pcfg)
        np.testing.assert_allclose(_np(out), np.asarray(jout), **FN_TOL)


@pytest.mark.parametrize("activation", ["swiglu", "squared_relu", "gelu"])
def test_each_activation_matches_jax(activation):
    jcfg, pcfg, jp, tp = _variant(activation, 0, 6)
    assert ("wg_e" in tp) == (activation == "swiglu")
    jx, tx = _x(6)
    for jfn, fn in ((jmoe.moe_apply, moe.moe_apply),
                    (jmoe.moe_ref, moe.moe_ref)):
        jout, _ = jfn(jp, jx, jcfg)
        out, _ = fn(tp, tx, pcfg)
        np.testing.assert_allclose(_np(out), np.asarray(jout), **FN_TOL)


def test_tokens_not_a_whole_number_of_groups_raise(granite):
    """40 tokens in groups of 32: JAX asserts, the port raises
    ValueError (no padding on either side)."""
    jcfg, pcfg = _cfgs()
    jx, tx = _x(7, (1, 40, 256))
    with pytest.raises(ValueError, match="dispatch groups of 32"):
        moe.moe_apply(granite["tffn"], tx, pcfg)
    with pytest.raises(AssertionError):
        jmoe.moe_apply(granite["jffn"], jx, jcfg)


def test_routing_record_is_per_thread_and_closes(granite):
    _, pcfg = _cfgs()
    _, tx = _x(8)
    with moe.record_routing() as outer:
        with moe.record_routing() as inner:
            moe.moe_apply(granite["tffn"], tx, pcfg)
        moe.moe_apply(granite["tffn"], tx, pcfg)
    moe.moe_apply(granite["tffn"], tx, pcfg)
    assert len(inner.calls) == len(outer.calls) == 1
    call = inner.calls[0]
    assert tuple(call["idx"].shape) == (64, 2)
    assert tuple(call["margins"].shape) == (64,)
    assert float(call["margins"].min()) > 0


# ---------------------------------------------------------------------------
# the reduced model
@pytest.fixture(scope="module")
def models(granite):
    out = {}
    for dispatch in ("einsum", "gather"):
        jcfg, pcfg = _cfgs(dispatch=dispatch)
        jm = jax_make_model(jcfg)
        out[dispatch] = (jm, make_model(pcfg, device="cpu"),
                         dict(prefill=jax.jit(jm.prefill,
                                              static_argnames=("max_len",)),
                              decode=jax.jit(jm.decode_step)))
    return out


def _tokens(S_=S, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, S_)).astype(
        np.int32)


def test_forward_hidden_logits_and_aux(granite, models):
    jm, tm, _ = models["einsum"]
    toks = _tokens(32)
    jx, jaux = jm.forward(granite["jp"], jnp.asarray(toks))
    with torch.no_grad():
        tx, aux = tm.forward(granite["tp"], torch.from_numpy(toks))
        tl = tm._logits(granite["tp"], tx)
    np.testing.assert_allclose(_np(tx), np.asarray(jx), atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        _np(tl), np.asarray(jm._logits(granite["jp"], jx)), atol=ATOL, rtol=0)
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=1e-6)
    assert float(aux) > 0


def test_forward_aux_stays_a_tensor_with_its_graph(granite, models):
    """The summed aux loss comes back as the float32 tensor the layers
    made: not copied through ``torch.tensor`` (which warns and detaches)."""
    _, tm, _ = models["einsum"]
    params = tree_map(lambda t: t.clone().requires_grad_(True), granite["tp"])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, aux = tm.forward(params, torch.from_numpy(_tokens(16)))
    assert aux.dtype == torch.float32 and aux.device.type == "cpu"
    assert aux.requires_grad and aux.grad_fn is not None
    aux.backward()
    assert params["seg0"][0]["ffn"]["router"].grad is not None
    # a model without MoE layers gives a zero float32 tensor
    dense = make_model(dataclasses.replace(
        port_get_config("qwen2-0.5b").reduced(d_model=128), vocab_size=256,
        dtype="float32"), device="cpu")
    with torch.no_grad():
        _, zero = dense.forward(dense.init(torch.Generator().manual_seed(0)),
                                torch.zeros((1, 4), dtype=torch.int64))
    assert zero.dtype == torch.float32 and float(zero) == 0.0


@pytest.mark.parametrize("dispatch", ["einsum", "gather", "grouped"])
def test_prefill_and_greedy_decode_match_jax(granite, models, monkeypatch,
                                             dispatch):
    """Prefill (B*S = 32: one dispatch group) and 8 greedy decode steps:
    logits within 1e-4 at every step, identical tokens, caches equal."""
    jm, tm, jfns = models[_dispatch(monkeypatch, dispatch)]
    jp, tp = granite["jp"], granite["tp"]
    toks = _tokens()
    jl, jc = jfns["prefill"](jp, jnp.asarray(toks), max_len=MAX_LEN)
    with torch.no_grad(), moe.counting_rows() as count:
        tl, tc = tm.prefill(tp, torch.from_numpy(toks), max_len=MAX_LEN)
    if dispatch == "grouped":       # K4's route computed the kept rows
        assert count.rows == count.assignments > 0
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
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[0][0][name]),
                                   np.asarray(jc[0][0][name]), atol=ATOL,
                                   rtol=0)
