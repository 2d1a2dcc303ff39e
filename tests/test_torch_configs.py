"""The dense configurations no other port test serves, held against the
JAX reference in float32 on the CPU: phi3-medium-14b (SwiGLU, GQA
group 4), nemotron-4-15b (squared-ReLU MLP, group 6), pixtral-12b
(``rope_theta`` 1e6, vision frontend embeddings) and musicgen-medium
(tanh-GELU MLP, MHA), each with an untied output head.

Each config is ``.reduced()`` (2 layers, d_model 256, vocab 512, head
dim 32) with its published query-to-KV group size kept (``.reduced()``
alone makes every one of them MHA at 4/4 heads), in float32.  One JAX
``init`` per config, published once by the JAX ``WeightStore`` (one
``.npz``, written by ``repro.checkpoint.save_pytree``), gives both sides
the same numbers: the port reads the file with its ``load_pytree``.
Checked: ``forward`` logits within 1e-4, prefill and 6 greedy decode
steps with identical tokens and every step's logits within 1e-4,
pixtral's prefill with ``frontend_embeds`` / ``frontend_mask``, and
nemotron's served endpoint against the JAX ``ModelEndpoint``'s greedy
tokens.  XLA:CPU and torch sum in different orders, hence a tolerance
rather than equality.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config  # noqa: E402
from repro.core import FunctionSpec as JaxSpec  # noqa: E402
from repro.core import Runtime as JaxRuntime  # noqa: E402
from repro.models import make_model as jax_make_model  # noqa: E402
from repro.serving import Executor as JaxExecutor  # noqa: E402
from repro.serving import ModelEndpoint as JaxEndpoint  # noqa: E402
from repro.serving import WeightStore as JaxWeightStore  # noqa: E402
from repro_torch.checkpoint import load_pytree  # noqa: E402
from repro_torch.configs import get_config as port_get_config  # noqa: E402
from repro_torch.core import FunctionSpec, Runtime  # noqa: E402
from repro_torch.models import make_model  # noqa: E402
from repro_torch.serving import Executor, ModelEndpoint, WeightStore  # noqa: E402

ATOL = 1e-4
B, S, MAX_LEN, STEPS = 2, 16, 24, 6
# arch -> (query heads, KV heads) of the reduced config: the published
# group size (phi3 40/10, nemotron 48/8, pixtral 32/8, musicgen 24/24)
HEADS = {"phi3-medium-14b": (8, 2), "nemotron-4-15b": (12, 2),
         "pixtral-12b": (8, 2), "musicgen-medium": (4, 4)}
ARCHS = tuple(HEADS)
# what each config brings that the other port tests do not serve
WANT = {"phi3-medium-14b": dict(activation="swiglu", tie_embeddings=False),
        "nemotron-4-15b": dict(activation="squared_relu",
                               tie_embeddings=False),
        "pixtral-12b": dict(activation="swiglu", tie_embeddings=False,
                            rope_theta=1e6, frontend="vision"),
        "musicgen-medium": dict(activation="gelu", tie_embeddings=False,
                                frontend="audio")}


def _cfg(get, arch):
    hq, hkv = HEADS[arch]
    return dataclasses.replace(get(arch).reduced(), n_heads=hq,
                               n_kv_heads=hkv, dtype="float32")


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """The JAX store's root; each arch is published there once, on
    first use."""
    root = str(tmp_path_factory.mktemp("configs"))
    return root, JaxWeightStore(root), {}


def _build(stores, arch):
    """(JAX model, JAX params, jitted prefill and decode, port model,
    port params) for one arch, made once per module."""
    root, jstore, made = stores
    if arch not in made:
        jm = jax_make_model(_cfg(get_config, arch))
        jp = jm.init(jax.random.PRNGKey(0))
        jstore.publish(arch, jp)
        tm = make_model(_cfg(port_get_config, arch), device="cpu")
        tp = load_pytree(f"{root}/{arch}.npz", device="cpu")
        jfns = dict(prefill=jax.jit(jm.prefill, static_argnames=("max_len",)),
                    decode=jax.jit(jm.decode_step))
        made[arch] = (jm, jp, jfns, tm, tp)
    return made[arch]


@pytest.fixture(params=ARCHS)
def both(request, stores):
    return _build(stores, request.param)


def _np(t):
    return t.detach().float().numpy()


def _tokens(vocab, seed, batch=B, seq=S):
    return np.random.default_rng(seed).integers(0, vocab, (batch, seq)).astype(
        np.int32)


def test_reduced_configs_keep_what_they_test(both):
    _, _, _, tm, tp = both
    cfg = tm.cfg
    arch = cfg.name.removesuffix("-smoke")
    for key, value in WANT[arch].items():
        assert getattr(cfg, key) == value, key
    assert (cfg.n_heads, cfg.n_kv_heads) == HEADS[arch]
    assert ("unembed" in tp) == (not cfg.tie_embeddings)


def test_forward_logits(both):
    jm, jp, _, tm, tp = both
    toks = _tokens(tm.cfg.vocab_size, 0)
    jx, _ = jm.forward(jp, jnp.asarray(toks))
    with torch.no_grad():
        tx, aux = tm.forward(tp, torch.from_numpy(toks))
        tl = tm._logits(tp, tx)
    np.testing.assert_allclose(_np(tx), np.asarray(jx), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(tl), np.asarray(jm._logits(jp, jx)),
                               atol=ATOL, rtol=0)
    assert float(aux) == 0.0


def test_prefill_and_decode_greedy_tokens(both):
    """Prefill, then STEPS decode steps on each side's own greedy
    tokens: every step's logits within 1e-4, the tokens identical, the
    KV caches within 1e-4 at the end."""
    jm, jp, jfns, tm, tp = both
    toks = _tokens(tm.cfg.vocab_size, 1)
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
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[0][0][name]),
                                   np.asarray(jc[0][0][name]), atol=ATOL,
                                   rtol=0, err_msg=name)


def test_pixtral_prefill_with_frontend_embeddings(stores):
    """The vision frontend's patch embeddings replace the token
    embeddings where the mask is set, in the prefill and in the decode
    steps that follow it."""
    jm, jp, jfns, tm, tp = _build(stores, "pixtral-12b")
    rng = np.random.default_rng(2)
    toks = _tokens(tm.cfg.vocab_size, 2)
    emb = rng.standard_normal((B, S, tm.cfg.d_model)).astype(np.float32)
    mask = rng.random((B, S)) < 0.5
    jl, jc = jm.prefill(jp, jnp.asarray(toks), max_len=MAX_LEN,
                        frontend_embeds=jnp.asarray(emb),
                        frontend_mask=jnp.asarray(mask))
    with torch.no_grad():
        tl, tc = tm.prefill(tp, torch.from_numpy(toks), max_len=MAX_LEN,
                            frontend_embeds=torch.from_numpy(emb),
                            frontend_mask=torch.from_numpy(mask))
        plain, _ = tm.prefill(tp, torch.from_numpy(toks), max_len=MAX_LEN)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL, rtol=0)
    assert not torch.allclose(tl, plain)        # the embeddings took effect
    jtok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
    ttok = torch.argmax(tl[:, -1:], dim=-1).to(torch.int32)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    jl, _ = jfns["decode"](jp, jc, jtok, jnp.full((B,), S, jnp.int32))
    with torch.no_grad():
        tl, _ = tm.decode_step(tp, tc, ttok, torch.full((B,), S,
                                                        dtype=torch.int32))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL, rtol=0)


def test_nemotron_endpoint_returns_the_jax_endpoints_tokens(stores):
    """The .npz the JAX store published, one prompt, STEPS greedy tokens
    from a freshened generation session on each side."""
    arch = "nemotron-4-15b"
    _, _, _, tm, _ = _build(stores, arch)
    root, jstore, _ = stores
    prompt = _tokens(tm.cfg.vocab_size, 3, batch=1)

    def gen_runtime(ep, spec_cls, rt_cls, name):
        def plan_factory(rt):
            base = ep.build_plan(rt)
            # the port's session entries end the instance's own plan
            mine = (rt,) if isinstance(ep, ModelEndpoint) else ()
            base.entries.extend(ep.session_plan_entries(MAX_LEN, *mine))
            return base

        def code(ctx, args):
            return ep.generate(ctx, args["tokens"], n_steps=STEPS,
                               max_len=MAX_LEN, plan_offset=3)

        rt = rt_cls(spec_cls(name, code, plan_factory=plan_factory,
                             app="serving"))
        rt.init()
        rt.freshen(blocking=True)
        return rt

    ep = ModelEndpoint(arch, tm.cfg, WeightStore(root), Executor(),
                       batch_size=1, seq_len=S, device="cpu")
    port_tokens = gen_runtime(ep, FunctionSpec, Runtime, "gen").run(
        {"tokens": prompt})
    jep = JaxEndpoint(arch, _cfg(get_config, arch), jstore, JaxExecutor(),
                      batch_size=1, seq_len=S)
    jax_tokens = gen_runtime(jep, JaxSpec, JaxRuntime, "jgen").run(
        {"tokens": prompt})
    assert len(port_tokens) == STEPS
    assert port_tokens == jax_tokens
