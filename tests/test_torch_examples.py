"""The port's counterparts of the ``examples/`` drivers
(``repro_torch.examples``) held against the reference drivers on the CPU,
and a trained weight version rolled out to a served endpoint.

* ``quickstart``: the port's and the reference's driver, each run as a
  subprocess, print the same ``result`` and ``stats`` counts in every
  case.
* ``train_small``: its body, in float32 from JAX-initialized params
  through the bridge, gives each step's loss within 1e-4 (relative) of
  the JAX ``Trainer``'s, and the version it publishes loads into
  ``repro.checkpoint.load_pytree`` bit for bit; its ``main`` prints the
  reference's lines.
* The rollout: a version trained from v1 and published into the served
  endpoint's own store is refetched inline by the next invoke (one more
  inline on the weights entry and on the warm-up, which binds the step
  to each version's params, nothing else), whose logits are a fresh
  endpoint's on that version bit for bit; after a further version and a
  blocking freshen the invoke runs with nothing inline.
* ``WeightStore.publish`` bumps the version only after the file is in
  place: a load while the file is written serves the old version under
  the old number, and the next invoke refetches the new one.
* ``serve_chain``: the port's pipeline on the reference's own weights
  (float32, the example's widths) gives each stage's logits within 1e-4
  of the reference pipeline's with the same fed-forward tokens; freshen
  off and on give the same logits bit for bit, and with freshen on the
  downstream stages run nothing inline.
"""
import dataclasses
import importlib.util
import os
import re
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import load_pytree as jax_load  # noqa: E402
from repro.checkpoint import save_pytree as jax_save  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import packed_batches as jax_packed_batches  # noqa: E402
from repro.models import make_model as jax_make_model  # noqa: E402
from repro.train import OptimizerConfig as JOptimizerConfig  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro.train import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.checkpoint import flatten_with_paths, load_pytree  # noqa: E402
from repro_torch.configs import get_config as port_get_config  # noqa: E402
from repro_torch.examples import serve_chain, train_small  # noqa: E402
from repro_torch.serving import (Executor, ModelEndpoint,  # noqa: E402
                                 ServingEngine, WeightStore)
from repro_torch.serving import weights as weights_mod  # noqa: E402
from repro_torch.train import OptimizerConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
LOSS_RTOL = 1e-4
LOGIT_TOL = 1e-4
STEPS, B, S = 4, 2, 32
SERVE_B, SERVE_S = 2, 16
CHAIN_REQUESTS = 3


def _small(get):
    return dataclasses.replace(
        get("qwen2-0.5b").reduced(n_layers=2, d_model=64, vocab=256),
        dtype="float32")


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The file's one JAX init: reduced float32 qwen2 (d 64, 2 layers,
    vocab 256), saved by the JAX package and read by the port."""
    path = str(tmp_path_factory.mktemp("jax") / "init.npz")
    jcfg = _small(get_config)
    jparams = jax_make_model(jcfg).init(jax.random.PRNGKey(0))
    jax_save(path, jparams)
    return jcfg, jparams, _small(port_get_config), load_pytree(path, "cpu")


def _run(module_or_path, *args):
    cmd = ([sys.executable, "-m", module_or_path] if "/" not in module_or_path
           else [sys.executable, module_or_path])
    return subprocess.Popen(cmd + list(args), cwd=ROOT, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            env={**os.environ, "PYTHONPATH": str(SRC)})


def _cases(out: str):
    """Each case's header with its ``result`` and ``stats`` values."""
    cases, cur = [], None
    for line in out.splitlines():
        if line.startswith("==="):
            cur = {"case": line}
            cases.append(cur)
            continue
        for key, pat in (("result", r"result=(\d+)"), ("stats", r"stats=(.*)$")):
            m = re.search(pat, line)
            if m:
                cur[key] = m.group(1)
    return cases


def test_quickstart_matches_reference():
    procs = [_run("repro_torch.examples.quickstart", "--device", "cpu"),
             _run(str(ROOT / "examples" / "quickstart.py"))]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, out + err
        outs.append(out)
    port, ref = (_cases(o) for o in outs)
    assert len(port) == len(ref) == 5
    assert port == ref
    assert sum("stats" in c for c in port) == 3
    assert [c.get("result") for c in port] == [
        "499501", "499501", "499501", None, "1499503"]


def test_train_small_matches_jax_trainer(small, tmp_path):
    jcfg, jparams, cfg, params = small
    trainer = train_small.train(cfg, "cpu", params, steps=STEPS, batch=B,
                                seq=S)
    jtrainer = JTrainer(
        jax_make_model(jcfg),
        JOptimizerConfig(peak_lr=1e-3, warmup_steps=20, total_steps=STEPS),
        JTrainerConfig(steps=STEPS, num_microbatches=2),
        jax_packed_batches(JDataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                       batch_size=B, seed=0)),
        params=jparams)
    jtrainer.run()
    got = np.array([h["loss"] for h in trainer.history])
    want = np.array([h["loss"] for h in jtrainer.history])
    assert len(got) == STEPS
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)

    store = WeightStore(str(tmp_path / "store"))
    assert store.publish("trained-small", trainer.params) == 1
    loaded = jax_load(str(tmp_path / "store" / "trained-small.npz"), jparams)
    flat = flatten_with_paths(trainer.params)
    jflat = {"/".join(str(getattr(p, "key", f"[{getattr(p, 'idx', '')}]"))
                      for p in path): leaf
             for path, leaf in jax.tree_util.tree_leaves_with_path(loaded)}
    assert jflat.keys() == flat.keys()
    for k, t in flat.items():
        np.testing.assert_array_equal(np.asarray(jflat[k]), t.numpy(),
                                      err_msg=k)


def test_train_small_main_on_cpu(capsys):
    trainer, store = train_small.main(
        ["--device", "cpu", "--steps", "2", "--dim", "64", "--layers", "2",
         "--batch", "2", "--seq", "32", "--vocab", "128"])
    out = capsys.readouterr().out
    assert out.startswith("arch=qwen2-0.5b-smoke params=")
    assert len(trainer.history) == 2
    assert all(np.isfinite(h["loss"]) for h in trainer.history)
    assert "final loss:" in out
    assert "published to WeightStore as version 1" in out
    assert store.version("trained-small") == 1


def _endpoint(cfg, store, name="m"):
    return ModelEndpoint(name, cfg, store, Executor(), batch_size=SERVE_B,
                         seq_len=SERVE_S, device="cpu")


def _fresh_logits(cfg, params, tmp, toks, name="m"):
    """Logits of a fresh endpoint on a store that holds only ``params``."""
    store = WeightStore(str(tmp))
    store.publish(name, params)
    eng = ServingEngine()
    try:
        eng.deploy(_endpoint(cfg, store, name))
        return eng.invoke(name, toks, freshen_successors=False)["logits"]
    finally:
        eng.close()


def _inline(rt):
    return [e.inline_count for e in rt.fr_state.entries]


def test_rollout_on_cpu(small, tmp_path):
    """v1 served; v2 trained from v1 and published into the same store;
    the next invoke refetches the weights inline; v3 published and
    freshened before the invoke."""
    _, _, cfg, params = small
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (SERVE_B, SERVE_S)).astype(np.int32)
    opt = OptimizerConfig(peak_lr=1e-3, warmup_steps=1, total_steps=2)
    store = WeightStore(str(tmp_path / "served"))
    assert store.publish("m", params) == 1
    eng = ServingEngine()
    try:
        rt = eng.deploy(_endpoint(cfg, store))
        rt.freshen(blocking=True)
        v1 = eng.invoke("m", toks, freshen_successors=False)["logits"]
        assert _inline(rt) == [0, 0, 0]

        tr2 = train_small.train(cfg, "cpu", params, steps=2, batch=B, seq=S,
                                opt_cfg=opt)
        assert store.publish("m", tr2.params) == 2
        v2 = eng.invoke("m", toks, freshen_successors=False)["logits"]
        assert _inline(rt) == [1, 0, 1]          # the weights, refetched
        assert not np.array_equal(v1, v2)
        assert np.array_equal(v2, _fresh_logits(cfg, tr2.params,
                                                 tmp_path / "only-v2", toks))

        tr3 = train_small.train(cfg, "cpu", tr2.params, steps=1, batch=B,
                                seq=S, opt_cfg=opt)
        assert store.publish("m", tr3.params) == 3
        freshened = rt.fr_state.stats()["freshened"]
        rt.freshen(blocking=True)
        assert rt.fr_state.stats()["freshened"] == freshened + 2
        v3 = eng.invoke("m", toks, freshen_successors=False)["logits"]
        assert _inline(rt) == [1, 0, 1]          # nothing inline
        assert not np.array_equal(v2, v3)
        assert np.array_equal(v3, _fresh_logits(cfg, tr3.params,
                                                 tmp_path / "only-v3", toks))
        assert store.load_count == 3             # v1, v2 inline, v3
    finally:
        eng.close()


def test_publish_bumps_the_version_after_the_file(small, tmp_path,
                                                  monkeypatch):
    """A freshen that loads while v2's file is being written reads v1 and
    records version 1, so the next invoke finds the weights stale and
    serves v2."""
    _, _, cfg, params = small
    toks = np.zeros((SERVE_B, SERVE_S), np.int32)
    store = WeightStore(str(tmp_path / "served"))
    store.publish("m", params)
    params2 = {**params, "final_norm": {
        "scale": params["final_norm"]["scale"] * 1.5}}
    writing, release = threading.Event(), threading.Event()
    real_save = weights_mod.save_pytree

    def blocked_save(*args, **kw):
        writing.set()
        assert release.wait(60)
        return real_save(*args, **kw)

    monkeypatch.setattr(weights_mod, "save_pytree", blocked_save)
    eng = ServingEngine()
    publisher = threading.Thread(target=lambda: store.publish("m", params2))
    try:
        rt = eng.deploy(_endpoint(cfg, store))
        publisher.start()
        assert writing.wait(60)
        rt.freshen(blocking=True)                # loads while v2 is written
        assert store.version("m") == 1
        assert rt.fr_state.entries[0].version == 1
        release.set()
        publisher.join(60)
        assert not publisher.is_alive() and store.version("m") == 2
        got = eng.invoke("m", toks, freshen_successors=False)["logits"]
        assert _inline(rt) == [1, 0, 1]
        assert rt.fr_state.entries[0].version == 2
    finally:
        release.set()
        eng.close()
    assert np.array_equal(got, _fresh_logits(cfg, params2,
                                             tmp_path / "only-v2", toks))


def _reference_serve_chain():
    spec = importlib.util.spec_from_file_location(
        "reference_serve_chain", ROOT / "examples" / "serve_chain.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # the example's widths in float32: the module's own config lookup
    mod.get_config = lambda name: dataclasses.replace(get_config(name),
                                                      dtype="float32")
    return mod


def _recording(eng):
    """Wrap ``eng.invoke`` to keep each stage's row-0 tokens and logits."""
    seen, invoke = {}, eng.invoke

    def rec(stage, toks, **kw):
        out = invoke(stage, toks, **kw)
        seen.setdefault(stage, []).append((np.asarray(toks)[0],
                                           out["logits"][0]))
        return out
    eng.invoke = rec
    return seen


def test_serve_chain_matches_reference(tmp_path):
    ref = _reference_serve_chain()
    jeng, jstages = ref.build(freshen_on=False)
    try:
        seen = _recording(jeng)
        ref.run_pipeline(jeng, jstages, CHAIN_REQUESTS, False)
        roots = {s: jeng.endpoints[s].store.root for s in jstages}
    finally:
        jeng.close()
    assert tuple(jstages) == serve_chain.STAGES

    cfgs = {s: dataclasses.replace(c, dtype="float32")
            for s, c in serve_chain.stage_configs().items()}
    store = WeightStore(str(tmp_path / "port"))
    for s in jstages:                 # the reference's own weights
        store.publish(s, load_pytree(f"{roots[s]}/{s}.npz", "cpu"))
    runs = {}
    for mode in (False, True):
        eng, stages = serve_chain.build(mode, cfgs, store, device="cpu")
        try:
            _, _, outputs = serve_chain.run_pipeline(eng, stages,
                                                     CHAIN_REQUESTS, mode)
            runs[mode] = (outputs, eng.platform_stats())
        finally:
            eng.close()

    outputs, _ = runs[False]
    for s in jstages:
        assert len(outputs[s]) == len(seen[s]) == CHAIN_REQUESTS
        for (x, logits), (jx, jlogits) in zip(outputs[s], seen[s]):
            np.testing.assert_array_equal(x, jx)     # fed-forward tokens
            np.testing.assert_allclose(logits, jlogits, atol=LOGIT_TOL,
                                       rtol=LOGIT_TOL)
    on, stats = runs[True]
    for s in jstages:
        for (x, logits), (x_on, logits_on) in zip(outputs[s], on[s]):
            assert np.array_equal(x, x_on) and np.array_equal(logits,
                                                              logits_on)
    assert stats[jstages[0]]["inline"] == 3
    assert [stats[s]["inline"] for s in jstages[1:]] == [0, 0]
    assert runs[False][1][jstages[2]]["inline"] == 3


def test_serve_chain_main_on_cpu(capsys):
    serve_chain.main(["--device", "cpu", "--requests", "2"])
    out = capsys.readouterr().out
    assert out.count("=== freshen") == 2
    on = out.split("=== freshen ON")[1]
    assert "pool[rank-medium]: instances=1" in on
    assert re.search(r"pool\[generate-small\].*inline=0", on)
    assert re.search(r"pool\[embed-small\].*inline=3", on)
