"""Training in the port (``repro_torch.train``, ``Model.loss``, remat,
``input_specs``, the frontend embeddings, ``repro_torch.data``) held
against the JAX package on the CPU.

* ``schedule`` and ``adamw_update`` against the reference's on the same
  params, grads and state: float32 and bfloat16 leaves, stacked
  ``(R, d)`` leaves (decayed, as the reference decays every leaf whose
  stacked array has ndim >= 2) and an unstacked vector (not decayed).
* ``Model.loss``, its ``xent``/``aux`` and every gradient leaf against
  ``jax.value_and_grad(Model.loss)`` for reduced float32 qwen2, gemma2
  (softcaps, ``attn_local``), granite (MoE aux) and recurrentgemma, with
  two loss chunks: loss within 1e-5 and each gradient within 1e-4
  (absolute, and relative to its leaf's largest entry): XLA:CPU and
  torch sum in different orders.  Weights are made by the JAX ``init``,
  written with ``repro.checkpoint.save_pytree`` and read by the port.
* Remat on and off give the same gradients bit for bit, and its group
  size is the reference's ``_sqrt_divisor``.
* One or two microbatches: losses within 1e-5, gradients summed in
  float32; 40 steps on ``packed_batches`` lower the loss by more than 0.3
  (``tests/test_train.py``).
* pixtral's frontend embeddings in ``forward`` and ``prefill``;
  ``input_specs`` against the reference's for all three modes; a port
  ``Trainer`` checkpoint loads with the reference's ``load_pytree``.
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
from repro.configs.base import InputShape as JInputShape  # noqa: E402
from repro.models import make_model as jax_make_model  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.train import OptimizerConfig as JOptimizerConfig  # noqa: E402
from repro.train import OptState as JOptState  # noqa: E402
from repro.train import adamw_update as jadamw_update  # noqa: E402
from repro.train import schedule as jschedule  # noqa: E402
from repro_torch.checkpoint import (flatten_with_paths, load_pytree,  # noqa: E402
                                    tree_map, unflatten_paths)
from repro_torch.configs import get_config as port_get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.data import DataConfig, packed_batches  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import make_model  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.train import (OptimizerConfig, OptState, Trainer,  # noqa: E402
                               TrainerConfig, adamw_update, loss_and_grads,
                               make_train_step, schedule)
from repro_torch.train import trainer as trainer_mod  # noqa: E402

LOSS_ATOL = 1e-5
GRAD_TOL = 1e-4
B, S, CHUNK = 2, 32, 16                # two loss chunks


def _np(t):
    return t.detach().float().numpy()


def _flat_jax(tree) -> dict:
    return {"/".join(str(getattr(p, "key", f"[{getattr(p, 'idx', '')}]"))
                     for p in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


# ---------------------------------------------------------------------------
# the optimizer
def test_schedule_matches_jax():
    for cfg in (OptimizerConfig(peak_lr=1e-3, min_lr=1e-4, warmup_steps=10,
                                total_steps=100),
                OptimizerConfig(peak_lr=3e-3, warmup_steps=0,
                                total_steps=60)):
        jcfg = JOptimizerConfig(**dataclasses.asdict(cfg))
        for step in range(0, 101):
            got = float(schedule(cfg, torch.tensor(step, dtype=torch.int32)))
            want = float(jschedule(jcfg, jnp.asarray(step, jnp.int32)))
            assert abs(got - want) <= 1e-9, (step, got, want)


def _opt_tree(rng, dtype):
    """A params-shaped tree: a stacked segment (matrices (R, d, n), a norm
    scale (R, d) and a bias (R, n)) and an unstacked final norm (d,)."""
    R, d, n = 3, 8, 12

    def leaf(shape, dt):
        return rng.standard_normal(shape, dtype=np.float32).astype(dt)
    return {"final_norm": {"scale": leaf((d,), np.float32)},
            "seg0": ({"mixer": {"wq": leaf((R, d, n), dtype),
                                "bq": leaf((R, n), dtype)},
                      "norm1": {"scale": leaf((R, d), np.float32)}},)}


@pytest.mark.parametrize("case", ["float32", "bfloat16", "clipped"])
def test_adamw_update_matches_jax(case):
    """Identical params, grads and state into both updates.  ``clipped``
    scales the grads above ``clip_norm``, so the global norm enters every
    leaf's update; elsewhere the norm is below it (scale exactly 1)."""
    rng = np.random.default_rng(7)
    pdt = jnp.bfloat16 if case == "bfloat16" else jnp.float32
    params = jax.tree.map(lambda a: jnp.asarray(a).astype(
        pdt if a.ndim == 3 or a.shape == (3, 12) else jnp.float32),
        _opt_tree(rng, np.float32))
    gscale = 10.0 if case == "clipped" else 0.05
    grads = jax.tree.map(lambda p: (jnp.asarray(rng.standard_normal(
        p.shape, dtype=np.float32)) * gscale).astype(p.dtype), params)
    mu = jax.tree.map(lambda p: jnp.asarray(0.01 * rng.standard_normal(
        p.shape, dtype=np.float32)), params)
    nu = jax.tree.map(lambda p: jnp.asarray(1e-4 * rng.random(
        p.shape, dtype=np.float32)), params)
    cfg = OptimizerConfig(peak_lr=1e-2, warmup_steps=2, total_steps=20,
                          weight_decay=0.1, clip_norm=1.0)
    jcfg = JOptimizerConfig(**dataclasses.asdict(cfg))
    jp, jst, jm = jadamw_update(jcfg, params, grads,
                                JOptState(jnp.asarray(3, jnp.int32), mu, nu))

    def port(tree):
        flat = {k: np.asarray(v) for k, v in _flat_jax(tree).items()}
        return unflatten_paths({k: torch.from_numpy(
            np.array(v, np.float32)).to(
                torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32)
            for k, v in flat.items()})
    pp, pst, pm = adamw_update(
        cfg, port(params), port(grads),
        OptState(torch.tensor(3, dtype=torch.int32), port(mu), port(nu)))
    assert int(pst.step) == int(jst.step) == 4
    np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(pm["lr"]), float(jm["lr"]), rtol=1e-6)
    for got_tree, want_tree in ((pp, jp), (pst.mu, jst.mu), (pst.nu, jst.nu)):
        got, want = flatten_with_paths(got_tree), _flat_jax(want_tree)
        assert got.keys() == want.keys()
        for k in got:
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
            w = np.asarray(want[k], np.float32)
            # rel 1e-6 of the leaf's largest entry: a moment near zero
            # after b1 m + (1 - b1) g cancels carries the clip scale's
            # last-bit difference (the two global norms sum in their own
            # orders) at a larger relative size
            np.testing.assert_allclose(_np(got[k]), w, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(w).max()),
                                       err_msg=k)
    # the reference's decay quirk: stacked vectors (ndim 2) are decayed,
    # the unstacked final norm is not
    ones = {"final_norm": {"scale": torch.ones(8)},
            "seg0": ({"norm1": {"scale": torch.ones(3, 8)}},)}
    zeros = tree_map(torch.zeros_like, ones)
    new, _, _ = adamw_update(
        OptimizerConfig(peak_lr=1.0, warmup_steps=0), ones, zeros,
        OptState(torch.tensor(0, dtype=torch.int32), zeros, zeros))
    assert torch.equal(new["final_norm"]["scale"], torch.ones(8))
    assert bool((new["seg0"][0]["norm1"]["scale"] < 1).all())


# ---------------------------------------------------------------------------
# Model.loss and its gradients
ARCHS = {
    "qwen2-0.5b": dict(d_model=64, vocab=256),
    "gemma2-27b": dict(d_model=64, vocab=256),
    "granite-moe-1b-a400m": dict(d_model=64, vocab=256),
    "recurrentgemma-2b": dict(d_model=64, vocab=256),
}


@pytest.fixture(scope="module", params=sorted(ARCHS))
def model_pair(request, tmp_path_factory):
    arch = request.param
    kw = ARCHS[arch]
    jcfg = dataclasses.replace(get_config(arch).reduced(**kw), dtype="float32")
    pcfg = dataclasses.replace(port_get_config(arch).reduced(**kw),
                               dtype="float32")
    jm = jax_make_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    path = str(tmp_path_factory.mktemp("train") / f"{arch}.npz")
    jax_save(path, jp)
    pm = make_model(pcfg, device="cpu")
    pp = load_pytree(path, device="cpu")
    rng = np.random.default_rng(11)
    toks = rng.integers(0, kw["vocab"], (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    return arch, jm, jp, pm, pp, batch


def test_loss_and_grads_match_jax(model_pair):
    arch, jm, jp, pm, pp, batch = model_pair
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jm.loss(p, jbatch, seq_chunk=CHUNK), has_aux=True)(jp)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    pl, pmet, pg = loss_and_grads(pm, pp, tbatch, seq_chunk=CHUNK)
    np.testing.assert_allclose(float(pl), float(jl), atol=LOSS_ATOL, rtol=0)
    for name in ("xent", "aux"):
        np.testing.assert_allclose(float(pmet[name]), float(jmet[name]),
                                   atol=LOSS_ATOL, rtol=0)
    if arch.startswith("granite"):
        assert float(pmet["aux"]) > 0          # the MoE aux loss is in it
    got, want = flatten_with_paths(pg), _flat_jax(jg)
    assert got.keys() == want.keys()
    for k in got:
        w = np.asarray(want[k], np.float32)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(_np(got[k]), w, rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=k)


@pytest.mark.parametrize("n_layers", [2, 4])
def test_remat_records_each_moe_forward_once(n_layers):
    """Under remat the backward recomputes each MoE layer's forward;
    ``moe.record_routing`` keeps only the first run of each (on the CPU
    the recomputation runs on the recording thread), and the recorded
    forward saves what the recomputation saves, so the checkpoint's
    check of the saved tensors holds; the gradients equal an unrecorded
    run's."""
    from repro_torch.models import moe
    cfg = dataclasses.replace(
        port_get_config("granite-moe-1b-a400m").reduced(
            d_model=64, n_layers=n_layers), dtype="float32", vocab_size=128)
    model = make_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = _tokens(128, (2, 32), seed=4)
    with moe.record_routing() as rec:
        recorded = loss_and_grads(model, params, batch, 16)
    plain = loss_and_grads(model, params, batch, 16)
    assert len(rec.calls) == n_layers
    a, b = flatten_with_paths(recorded[2]), flatten_with_paths(plain[2])
    assert all(torch.equal(a[key], b[key]) for key in a)


def test_loss_needs_whole_chunks(model_pair):
    _, _, _, pm, pp, batch = model_pair
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with pytest.raises(ValueError, match="seq_chunk"):
        with torch.no_grad():
            pm.loss(pp, tbatch, seq_chunk=12)


def _small(n_layers=8, **kw):
    cfg = dataclasses.replace(
        port_get_config("qwen2-0.5b").reduced(d_model=64, n_layers=n_layers),
        dtype="float32", vocab_size=128, **kw)
    return cfg, make_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))


def _tokens(vocab, shape, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, vocab, (shape[0], shape[1] + 1)).astype(np.int32)
    return {"tokens": torch.from_numpy(toks[:, :-1]),
            "targets": torch.from_numpy(toks[:, 1:])}


@pytest.mark.parametrize("n_layers", [3, 8, 24])
def test_remat_on_and_off_give_the_same_gradients(n_layers, monkeypatch):
    """Bit for bit on the CPU.  The group size is the reference's; the
    forward runs per group of k layers: once, again in the group's
    recomputation up to its last layer (the last layer's input is all
    the group's backward needs), and once more per layer inside the
    backward: 3k - 1 per group, 2 per layer without groups (R < 4)."""
    for n in range(1, 65):
        assert transformer._sqrt_divisor(n) == jtransformer._sqrt_divisor(n)
    cfg, params = _small(n_layers)
    batch = _tokens(128, (2, 32))
    calls = []
    fwd = ref.flash_attention_ref
    monkeypatch.setattr(ref, "flash_attention_ref",
                        lambda *a, **k: calls.append(1) or fwd(*a, **k))
    on = loss_and_grads(make_model(cfg, device="cpu"), params, batch, 16)
    k = transformer._sqrt_divisor(n_layers) if n_layers >= 4 else 1
    per_group = 3 * k - 1 if k > 1 else 2
    assert len(calls) == n_layers // k * per_group
    off = loss_and_grads(make_model(dataclasses.replace(cfg, remat=False),
                                    device="cpu"), params, batch, 16)
    assert torch.equal(on[0], off[0])
    a, b = flatten_with_paths(on[2]), flatten_with_paths(off[2])
    assert all(torch.equal(a[key], b[key]) for key in a)


def test_microbatches_sum_in_float32_and_match_one_batch(monkeypatch):
    cfg, params = _small(2)
    model = make_model(cfg, device="cpu")
    batch = _tokens(128, (4, 32), seed=1)
    opt = OptimizerConfig(warmup_steps=0)
    from repro_torch.train import init_opt_state
    seen = []
    update = trainer_mod.adamw_update

    def spy(cfg_, p, g, st):
        seen.append({t.dtype for t in flatten_with_paths(g).values()})
        return update(cfg_, p, g, st)
    monkeypatch.setattr(trainer_mod, "adamw_update", spy)
    p1, _, m1 = make_train_step(model, opt, num_microbatches=1)(
        params, init_opt_state(params), batch)
    p2, _, m2 = make_train_step(model, opt, num_microbatches=2)(
        params, init_opt_state(params), batch)
    assert seen[1] == {torch.float32}
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=0, atol=1e-5)
    assert float(m2["aux"]) == 0.0 and float(m2["xent"]) == float(m2["loss"])
    a, b = flatten_with_paths(p1), flatten_with_paths(p2)
    for key in a:
        np.testing.assert_allclose(_np(a[key]), _np(b[key]), atol=5e-5,
                                   rtol=5e-4, err_msg=key)


def test_training_reduces_loss():
    cfg = dataclasses.replace(
        port_get_config("qwen2-0.5b").reduced(d_model=128), dtype="float32",
        vocab_size=128)
    model = make_model(cfg, device="cpu")
    data = packed_batches(DataConfig(vocab_size=128, seq_len=64,
                                     batch_size=8, seed=3))
    tr = Trainer(model, OptimizerConfig(peak_lr=3e-3, warmup_steps=5,
                                        total_steps=60),
                 TrainerConfig(steps=40), data)
    hist = tr.run()
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first - 0.3, (first, last)


# ---------------------------------------------------------------------------
# frontend embeddings, input_specs, checkpoints, the launcher
@pytest.fixture(scope="module")
def pixtral(tmp_path_factory):
    kw = dict(d_model=64, vocab=256)
    jcfg = dataclasses.replace(get_config("pixtral-12b").reduced(**kw),
                               dtype="float32")
    pcfg = dataclasses.replace(port_get_config("pixtral-12b").reduced(**kw),
                               dtype="float32")
    jm = jax_make_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    path = str(tmp_path_factory.mktemp("pixtral") / "p.npz")
    jax_save(path, jp)
    return jm, jp, make_model(pcfg, device="cpu"), load_pytree(path, "cpu")


def test_frontend_embeddings_match_jax(pixtral):
    jm, jp, pm, pp = pixtral
    assert pm.cfg.frontend == "vision"
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 256, (B, 16)).astype(np.int32)
    emb = rng.standard_normal((B, 16, 64)).astype(np.float32)
    mask = rng.random((B, 16)) < 0.5
    jx, _ = jm.forward(jp, jnp.asarray(toks), jnp.asarray(emb),
                       jnp.asarray(mask))
    jl, _ = jm.prefill(jp, jnp.asarray(toks), max_len=20,
                       frontend_embeds=jnp.asarray(emb),
                       frontend_mask=jnp.asarray(mask))
    args = (torch.from_numpy(toks), torch.from_numpy(emb),
            torch.from_numpy(mask))
    with torch.no_grad():
        px, _ = pm.forward(pp, *args)
        pl, _ = pm.prefill(pp, args[0], max_len=20, frontend_embeds=args[1],
                           frontend_mask=args[2])
        plain, _ = pm.forward(pp, args[0])
    np.testing.assert_allclose(_np(px), np.asarray(jx), atol=1e-4, rtol=0)
    np.testing.assert_allclose(_np(pl), np.asarray(jl), atol=1e-4, rtol=0)
    assert not torch.allclose(px, plain)       # the embeddings took effect


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "pixtral-12b",
                                  "recurrentgemma-2b", "xlstm-350m"])
def test_input_specs_match_jax(arch):
    jm = jax_make_model(get_config(arch))
    pm = make_model(port_get_config(arch), device="cpu")
    for mode in ("train", "prefill", "decode"):
        want = _flat_jax(jm.input_specs(JInputShape("t", 256, 4, mode)))
        got = flatten_with_paths(pm.input_specs(InputShape("t", 256, 4,
                                                           mode)))
        assert got.keys() == want.keys(), mode
        for k in got:
            assert tuple(got[k].shape) == tuple(want[k].shape), (mode, k)
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), \
                (mode, k)
    with pytest.raises(ValueError):
        pm.input_specs(InputShape("t", 8, 1, "serve"))


def test_trainer_checkpoint_loads_in_jax(tmp_path):
    cfg, _ = _small(2)
    jcfg = dataclasses.replace(
        get_config("qwen2-0.5b").reduced(d_model=64, n_layers=2),
        dtype="float32", vocab_size=128)
    path = str(tmp_path / "ck.npz")
    data = packed_batches(DataConfig(vocab_size=128, seq_len=32,
                                     batch_size=2, seed=1))
    tr = Trainer(make_model(cfg, device="cpu"),
                 OptimizerConfig(warmup_steps=1, total_steps=4),
                 TrainerConfig(steps=2, checkpoint_every=2,
                               checkpoint_path=path), data,
                 generator=torch.Generator().manual_seed(3))
    tr.run()
    jp = jax_make_model(jcfg).init(jax.random.PRNGKey(0))
    f32 = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, jnp.float32),
                       jp)
    like = {"params": jp, "mu": f32, "nu": f32}
    loaded = _flat_jax(jax_load(path, like))
    mine = flatten_with_paths({"params": tr.params, "mu": tr.opt_state.mu,
                               "nu": tr.opt_state.nu})
    assert loaded.keys() == mine.keys()
    for k in mine:
        np.testing.assert_array_equal(np.asarray(loaded[k]), _np(mine[k]),
                                      err_msg=k)


def test_train_launcher_on_cpu(capsys, monkeypatch):
    hist = train_launcher.main(["--device", "cpu", "--arch", "qwen2-0.5b",
                                "--steps", "4", "--batch", "2", "--seq", "32"])
    assert len(hist) == 4 and all(np.isfinite(h["loss"]) for h in hist)
    assert "done: loss" in capsys.readouterr().out
    # --dry-run hands the reference's arguments to the port's dry run
    # (``tests/test_torch_launch.py`` runs that dry run itself)
    from repro_torch.launch import dryrun
    seen = []
    monkeypatch.setattr(dryrun, "main", lambda argv: seen.append(argv))
    train_launcher.main(["--arch", "qwen2-0.5b", "--dry-run"])
    assert seen == [["--arch", "qwen2-0.5b", "--shape", "train_4k",
                     "--mesh", "both", "--force"]]
