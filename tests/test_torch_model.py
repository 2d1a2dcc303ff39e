"""The port's attention models (``repro_torch.models``) held against the
JAX reference in float32 on the reduced qwen2-0.5b (``attn``) and the
reduced gemma2-27b (``attn_local`` with its 64-slot ring, softcaps,
post-norms, ``query_scale``, ``scale_embedding``): the weights are made by
the JAX ``init``, written with ``repro.checkpoint.save_pytree`` and read
by the port's loader, so both run the same numbers.  XLA:CPU and torch
sum in different orders, hence 1e-4 rather than exact equality; greedy
tokens must match exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import save_pytree  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.models import make_model as jax_make_model  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch.checkpoint import flatten_with_paths, load_pytree  # noqa: E402
from repro_torch.configs import get_config as port_get_config  # noqa: E402
from repro_torch.models import make_model  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

ATOL = 1e-4
B, S, MAX_LEN, STEPS = 2, 16, 24, 6


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(d_model=128),
                              vocab_size=256, dtype="float32")
    jm = jax_make_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    path = str(tmp_path_factory.mktemp("bridge") / "qwen2.npz")
    save_pytree(path, jp)
    pcfg = dataclasses.replace(
        port_get_config("qwen2-0.5b").reduced(d_model=128), vocab_size=256,
        dtype="float32")
    tm = make_model(pcfg, device="cpu")
    tp = load_pytree(path, device="cpu")
    toks = np.random.default_rng(0).integers(0, 256, (B, S)).astype(np.int32)
    return jm, jp, tm, tp, toks


def _np(t):
    return t.detach().float().numpy()


def test_forward_hidden_and_logits(both):
    jm, jp, tm, tp, toks = both
    jx, _ = jm.forward(jp, jnp.asarray(toks))
    with torch.no_grad():
        tx, aux = tm.forward(tp, torch.from_numpy(toks))
        tl = tm._logits(tp, tx)
    np.testing.assert_allclose(_np(tx), np.asarray(jx), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(tl), np.asarray(jm._logits(jp, jx)),
                               atol=ATOL, rtol=0)
    assert float(aux) == 0.0


def test_prefill_logits_and_cache(both):
    jm, jp, tm, tp, toks = both
    jl, jc = jm.prefill(jp, jnp.asarray(toks), max_len=MAX_LEN)
    with torch.no_grad():
        tl, tc = tm.prefill(tp, torch.from_numpy(toks), max_len=MAX_LEN)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL, rtol=0)
    for name in ("k", "v"):
        got, want = _np(tc[0][0][name]), np.asarray(jc[0][0][name])
        assert got.shape == want.shape == (2, B, MAX_LEN, 2, 32)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_decode_steps_and_greedy_tokens(both):
    """Each side decodes its own greedy tokens for STEPS steps; logits
    agree at every step and the tokens are identical."""
    jm, jp, tm, tp, toks = both
    jl, jc = jm.prefill(jp, jnp.asarray(toks), max_len=MAX_LEN)
    with torch.no_grad():
        tl, tc = tm.prefill(tp, torch.from_numpy(toks), max_len=MAX_LEN)
    jtok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
    ttok = torch.argmax(tl[:, -1:], dim=-1).to(torch.int32)
    jpos = jnp.full((B,), S, jnp.int32)
    tpos = torch.full((B,), S, dtype=torch.int32)
    for step in range(STEPS):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok),
                                      err_msg=f"step {step}")
        jl, jc = jm.decode_step(jp, jc, jtok, jpos)
        with torch.no_grad():
            tl, tc = tm.decode_step(tp, tc, ttok, tpos)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL,
                                   rtol=0, err_msg=f"step {step}")
        jtok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        ttok = torch.argmax(tl[:, -1:], dim=-1).to(torch.int32)
        jpos, tpos = jpos + 1, tpos + 1
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    # the decode cache is the same buffer, written in place
    np.testing.assert_allclose(_np(tc[0][0]["k"]), np.asarray(jc[0][0]["k"]),
                               atol=ATOL, rtol=0)


def test_init_matches_reference_shapes_and_types(both):
    """The port's seeded init makes the reference's leaves: same key
    paths, shapes and types (norm scales stay float32 in a bf16 model)."""
    jm, _, _, _, _ = both
    cfg = get_config("qwen2-0.5b").reduced(d_model=128)
    jspec = jax.eval_shape(lambda: jax_make_model(cfg).init(
        jax.random.PRNGKey(0)))
    want = {"/".join(str(getattr(p, "key", f"[{getattr(p, 'idx', '')}]"))
                     for p in path): (tuple(l.shape), str(l.dtype))
            for path, l in jax.tree_util.tree_flatten_with_path(jspec)[0]}
    pm = make_model(port_get_config("qwen2-0.5b").reduced(d_model=128),
                    device="cpu")
    got = {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for k, t in flatten_with_paths(
               pm.init(torch.Generator().manual_seed(0))).items()}
    assert got == want
    specs = {k: (s.shape, str(s.dtype).replace("torch.", ""))
             for k, s in flatten_with_paths(pm.param_specs()).items()}
    assert specs == want


def test_cache_shapes_match_reference(both):
    jm, _, tm, _, _ = both
    want = jax.tree.map(lambda x: tuple(x.shape),
                        jax.eval_shape(lambda: jm.init_cache(B, MAX_LEN)))
    got = tm.cache_shapes(B, MAX_LEN)
    assert got == tuple(tuple(dict(blk) for blk in seg) for seg in want)
    cache = tm.init_cache(B, MAX_LEN)
    assert tuple(cache[0][0]["k"].shape) == got[0][0]["k"]
    blk = transformer.init_block_cache("attn", tm.cfg, B, MAX_LEN, "cpu")
    assert tuple(blk["v"].shape) == got[0][0]["v"][1:]


@pytest.mark.parametrize("seq_len", [40, 64, 150])
def test_seed_block_cache_ring_matches_reference(seq_len):
    """Seeding a window-64 ring cache: prefix, exact fit and wrap."""
    cfg = get_config("gemma2-27b").reduced()
    pcfg = port_get_config("gemma2-27b").reduced()
    rng = np.random.default_rng(seq_len)
    kv = [rng.standard_normal((2, seq_len, cfg.n_kv_heads, 32)).astype(
        np.float32) for _ in range(2)]
    jempty = jax.tree.map(lambda x: x.astype(jnp.float32),
                          jtransformer.init_block_cache("attn_local", cfg, 2,
                                                        4096))
    want = jtransformer.seed_block_cache(
        "attn_local", cfg, jempty, tuple(jnp.asarray(a) for a in kv), seq_len)
    empty = {n: t.float() for n, t in transformer.init_block_cache(
        "attn_local", pcfg, 2, 4096, "cpu").items()}
    got = transformer.seed_block_cache(
        "attn_local", pcfg, empty, tuple(torch.from_numpy(a) for a in kv),
        seq_len)
    for name in ("k", "v"):
        assert tuple(got[name].shape) == (2, 64, cfg.n_kv_heads, 32)
        np.testing.assert_array_equal(_np(got[name]), np.asarray(want[name]))


def test_unported_block_kinds_name_their_roadmap_item():
    with pytest.raises(NotImplementedError, match="xLSTM"):
        make_model(port_get_config("xlstm-350m").reduced(), device="cpu")
    # the attn_local, rglru, attn_moe, mla and mla_moe kinds are ported:
    # these build on the CPU
    for arch in ("gemma2-27b", "recurrentgemma-2b", "granite-moe-1b-a400m",
                 "deepseek-v2-lite-16b"):
        m = make_model(port_get_config(arch).reduced(), device="cpu")
        assert m.init(torch.Generator().manual_seed(0))["seg0"]


def test_model_defaults_to_cuda_and_refuses_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_model(port_get_config("qwen2-0.5b").reduced())


# ---------------------------------------------------------------------------
# gemma2: attn_local with its 64-slot ring, softcaps, post-norms,
# query_scale and scale_embedding, on gemma2-27b.reduced() in float32
G_B, G_MAX_LEN, G_STEPS = 2, 136, 8


@pytest.fixture(scope="module")
def gemma2(tmp_path_factory):
    cfg = dataclasses.replace(get_config("gemma2-27b").reduced(),
                              dtype="float32")
    jm = jax_make_model(cfg)
    jp = jm.init(jax.random.PRNGKey(1))
    path = str(tmp_path_factory.mktemp("bridge") / "gemma2.npz")
    save_pytree(path, jp)
    pcfg = dataclasses.replace(port_get_config("gemma2-27b").reduced(),
                               dtype="float32")
    tm = make_model(pcfg, device="cpu")
    tp = load_pytree(path, device="cpu")
    jfns = dict(prefill=jax.jit(jm.prefill, static_argnames=("max_len",)),
                decode=jax.jit(jm.decode_step))
    return jm, jp, tm, tp, jfns


def _g_tokens(S):
    return np.random.default_rng(S).integers(0, 512, (G_B, S)).astype(
        np.int32)


def test_gemma2_forward_hidden_and_logits(gemma2):
    jm, jp, tm, tp, _ = gemma2
    cfg = tm.cfg
    assert (cfg.attn_softcap, cfg.final_softcap, cfg.use_post_norm,
            cfg.scale_embedding, cfg.window_size) == (50.0, 30.0, True,
                                                       True, 64)
    toks = _g_tokens(128)
    jx, _ = jm.forward(jp, jnp.asarray(toks))
    with torch.no_grad():
        tx, _ = tm.forward(tp, torch.from_numpy(toks))
        tl = tm._logits(tp, tx)
    np.testing.assert_allclose(_np(tx), np.asarray(jx), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(tl), np.asarray(jm._logits(jp, jx)),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("S", [60, 128])
def test_gemma2_prefill_decode_across_the_ring_wrap(gemma2, S):
    """Prompt 60 decodes positions 60..67: before, at and past the
    64-slot ring's wrap; prompt 128 seeds the ring wrapped.  Prefill
    logits and caches, then every decode step's logits, agree; greedy
    tokens are identical."""
    jm, jp, tm, tp, jfns = gemma2
    toks = _g_tokens(S)
    jl, jc = jfns["prefill"](jp, jnp.asarray(toks), max_len=G_MAX_LEN)
    with torch.no_grad():
        tl, tc = tm.prefill(tp, torch.from_numpy(toks), max_len=G_MAX_LEN)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL, rtol=0)
    assert tuple(tc[0][0]["k"].shape)[2] == 64           # the local ring
    assert tuple(tc[0][1]["k"].shape)[2] == G_MAX_LEN    # the global cache

    def caches_close(msg):
        for j in range(2):
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    _np(tc[0][j][name]), np.asarray(jc[0][j][name]),
                    atol=ATOL, rtol=0, err_msg=f"{msg} [{j}] {name}")

    caches_close("prefill")
    jtok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
    ttok = torch.argmax(tl[:, -1:], dim=-1).to(torch.int32)
    jpos = jnp.full((G_B,), S, jnp.int32)
    tpos = torch.full((G_B,), S, dtype=torch.int32)
    for step in range(G_STEPS):
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
    caches_close("after decode")
