"""The port's launch layer (``repro_torch.launch``: meshes, the sharded
steps, the dry run) against the reference.

* A 4-rank gloo rehearsal, one spawn for the file, on a ``FileStore``
  under ``tmp_path``: meshes (2, 2) and (1, 4) of ``("data", "model")``,
  reduced float32 qwen2 (heads 14/2 at dh 16, so an axis of 4 splits
  heads mid-head and the attention runs replicated), granite (experts
  over ``model``) and recurrentgemma (the scan channel-sharded).  The
  sharded prefill and greedy decode match the JAX unsharded forward on
  the same checkpoint within 1e-4 with identical tokens; the sharded
  train step's loss, and every gradient leaf of the sharded loss, match
  the unsharded port's within 1e-4.
* Fake-mesh dry runs of qwen2-0.5b ``train_4k`` and ``decode_32k`` on
  16x16, in subprocesses: status ok, FLOPs and collectives counted; in
  decode the units add up to the full program within 1%, in training
  the full program's excess over the units is the remat recomputation
  it booked, within 1%.
* The dry run's config arithmetic (``analytic_hbm_traffic``,
  ``_cache_bytes``, ``model_flops``, ``apply_overrides``) and its
  ``unsupported`` gating equal the reference's for every config and
  input shape; the reference's side runs in a subprocess because
  importing ``repro.launch.dryrun`` sets ``XLA_FLAGS``.

The rehearsal's workers import this file by name, so ``jax`` stays out
of its top level.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
B, S, N_DEC = 4, 16, 3
ARCHS = ("qwen2-0.5b", "granite-moe-1b-a400m", "recurrentgemma-2b")
MESHES = ((2, 2), (1, 4))
WORLD = 4
TOL = 1e-4


def _cfg(get_config, arch):
    """The reduced float32 config, from either package's ``get_config``."""
    cfg = get_config(arch).reduced()
    if arch == "qwen2-0.5b":
        cfg = dataclasses.replace(cfg, n_heads=14, n_kv_heads=2, head_dim=16)
    return dataclasses.replace(cfg, dtype="float32")


def _dryrun(shape, out):
    # fake tensors compute nothing: one thread, beside the other workers
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-0.5b", "--shape", shape, "--mesh", "pod", "--out", str(out),
         "--force"], env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


# ----------------------------------------------------------------------
# the rehearsal's ranks
def _rank(rank, tmp):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import flatten_with_paths, load_pytree
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import steps
    from repro_torch.models import make_model
    from repro_torch.sharding import distribute_tree
    from repro_torch.train import OptimizerConfig, make_train_step
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.trainer import loss_and_grads

    torch.set_num_threads(1)            # tiny tensors; 4 ranks share the host
    tmp = Path(tmp)
    dist.init_process_group("gloo", init_method=f"file://{tmp / 'store'}",
                            rank=rank, world_size=WORLD)
    results = {}
    try:
        for shape in MESHES:
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("data", "model"))
            for arch in ARCHS:
                cfg = _cfg(get_config, arch)
                ref = np.load(tmp / f"{arch}.ref.npz")
                params = load_pytree(str(tmp / f"{arch}.npz"), device="cpu")
                toks = torch.as_tensor(ref["tokens"])
                model = make_model(cfg, device="cpu")
                pre, pspecs, _, _ = steps.build_prefill_step(
                    model, InputShape("p", S, B, "prefill"), mesh,
                    max_len=S + N_DEC)
                dec, dspecs, _, _ = steps.build_decode_step(
                    model, InputShape("d", S + N_DEC, B, "decode"), mesh)
                p_sh = distribute_tree(params, pspecs[0])
                rec = {"errs": [], "tokens": True}
                with torch.no_grad():
                    logits, cache = pre(p_sh, distribute_tree(
                        {"tokens": toks}, pspecs[1]))
                    for t in range(N_DEC + 1):
                        got = logits.full_tensor().numpy()
                        rec["errs"].append(float(np.abs(
                            got - ref[f"logits{t}"]).max()))
                        tok = got.argmax(-1).astype(np.int32)
                        rec["tokens"] &= bool(np.array_equal(
                            tok, ref[f"tokens{t}"]))
                        if t == N_DEC:
                            break
                        pos = torch.full((B,), S + t, dtype=torch.int32)
                        logits, cache = dec(
                            p_sh, cache,
                            distribute_tree(torch.as_tensor(tok), dspecs[2]),
                            distribute_tree(pos, dspecs[3]))
                # training: the step, and the gradients of the loss
                batch = {"tokens": toks,
                         "targets": torch.as_tensor(ref["targets"])}
                tstep, tspecs, _, M = steps.build_train_step(
                    model, InputShape("t", S, B, "train"), mesh,
                    microbatches=2)
                plain = make_model(cfg, device="cpu")
                ustep = make_train_step(plain, OptimizerConfig(),
                                        num_microbatches=2, seq_chunk=S)
                opt = init_opt_state(params)
                _, _, want = ustep(params, opt, batch)
                _, _, got = tstep(distribute_tree(params, tspecs[0]),
                                  distribute_tree(opt, tspecs[1]),
                                  distribute_tree(batch, tspecs[2]))
                rec["step_loss_err"] = abs(float(got["loss"].full_tensor())
                                           - float(want["loss"]))
                l0, _, g0 = loss_and_grads(plain, params, batch, S)
                l1, _, g1 = loss_and_grads(
                    model, distribute_tree(params, tspecs[0]),
                    distribute_tree(batch, tspecs[2]), S, model.constrain)
                rec["loss_err"] = abs(float(l1.full_tensor()) - float(l0))
                flat0, flat1 = flatten_with_paths(g0), flatten_with_paths(g1)
                rec["grad_err"] = max(
                    float((flat1[k].full_tensor() - flat0[k]).abs().max())
                    for k in flat0)
                rec["grad_scale"] = max(float(v.abs().max())
                                        for v in flat0.values())
                results[f"{arch}@{shape[0]}x{shape[1]}"] = rec
    finally:
        if rank == 0:
            (tmp / "results.json").write_text(json.dumps(results))
        dist.destroy_process_group()


# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """JAX's unsharded forward on each checkpoint, the 4-rank rehearsal
    and the two dry runs (started first, running beside it)."""
    import jax
    from repro.checkpoint import save_pytree
    from repro.configs import get_config
    from repro.models import make_model

    tmp = tmp_path_factory.mktemp("launch")
    dry = {s: _dryrun(s, tmp / "dry") for s in ("train_4k", "decode_32k")}
    rng = np.random.default_rng(0)
    for i, arch in enumerate(ARCHS):
        cfg = _cfg(get_config, arch)
        model = make_model(cfg)
        params = model.init(jax.random.PRNGKey(i))
        save_pytree(str(tmp / f"{arch}.npz"), params)
        toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        ref = {"tokens": toks,
               "targets": rng.integers(0, cfg.vocab_size,
                                       (B, S)).astype(np.int32)}
        logits, cache = model.prefill(params, toks, max_len=S + N_DEC)
        for t in range(N_DEC + 1):
            ref[f"logits{t}"] = np.asarray(logits, np.float32)
            tok = np.asarray(logits).argmax(-1).astype(np.int32)
            ref[f"tokens{t}"] = tok
            if t < N_DEC:
                logits, cache = model.decode_step(
                    params, cache, tok, np.full((B,), S + t, np.int32))
        np.savez(tmp / f"{arch}.ref.npz", **ref)
    import torch.multiprocessing as mp
    mp.start_processes(_rank, args=(str(tmp),), nprocs=WORLD,
                       start_method="spawn")
    results = json.loads((tmp / "results.json").read_text())
    logs = {s: p.communicate(timeout=600)[0] for s, p in dry.items()}
    recs = {}
    for s, p in dry.items():
        assert p.returncode == 0, logs[s][-3000:]
        recs[s] = json.loads(
            (tmp / "dry" / f"qwen2-0.5b__{s}__sp.json").read_text())
    return results, recs


@pytest.mark.parametrize("mesh", [f"{a}x{b}" for a, b in MESHES])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_serving_matches_jax(launched, arch, mesh):
    rec = launched[0][f"{arch}@{mesh}"]
    assert len(rec["errs"]) == N_DEC + 1
    assert max(rec["errs"]) < TOL, rec["errs"]
    assert rec["tokens"]


@pytest.mark.parametrize("mesh", [f"{a}x{b}" for a, b in MESHES])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_unsharded(launched, arch, mesh):
    rec = launched[0][f"{arch}@{mesh}"]
    assert rec["step_loss_err"] < TOL
    assert rec["loss_err"] < TOL
    assert rec["grad_err"] < TOL, rec
    assert rec["grad_scale"] > 0


def test_dry_run_decode_units_add_up(launched):
    rec = launched[1]["decode_32k"]
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    full = rec["full_program"]
    assert full["flops_per_device"] > 0
    assert full["collectives"]["total_bytes"] > 0
    assert sum(full["collectives"]["count"].values()) > 0
    assert full["recompute_flops_per_device"] == 0
    assert abs(rec["ledger"]["full_over_units"] - 1.0) < 0.01
    assert rec["memory"]["argument_bytes_per_device"] > 0
    assert {u["unit"] for u in rec["units"]} == {"block_attn", "embed_head"}


def test_dry_run_train_excess_is_remat(launched):
    rec = launched[1]["train_4k"]
    assert rec["status"] == "ok" and rec["microbatches"] == 2
    full, led = rec["full_program"], rec["ledger"]
    assert full["flops_per_device"] > 0
    assert full["collectives"]["total_bytes"] > 0
    assert led["full_over_units"] > 1.0
    assert full["recompute_flops_per_device"] > 0
    assert abs(led["excess_over_recompute"] - 1.0) < 0.01
    names = {u["unit"] for u in rec["units"]}
    assert {"block_attn", "block_attn__act", "lm_head_loss",
            "lm_head_loss__act", "embed", "opt_update"} <= names
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")


# ----------------------------------------------------------------------
REF_ARITH = r"""
import json, sys
from repro.configs import INPUT_SHAPES, get_config, list_archs
from repro.launch import dryrun
out = {}
for arch in list_archs():
    cfg = get_config(arch)
    for name, shape in INPUT_SHAPES.items():
        out[f"{arch}/{name}"] = {
            "hbm": [dryrun.analytic_hbm_traffic(cfg, shape, n)
                    for n in (256, 512)],
            "cache": dryrun._cache_bytes(cfg, shape.global_batch,
                                         shape.seq_len),
            "flops": dryrun.model_flops(cfg, shape),
            "supported": cfg.supports_shape(name),
            "unsupported": dryrun.run_combo(arch, name, False)
            if not cfg.supports_shape(name) else None}
    for ov in ({"strategy": "dp_cp"}, {"mla_decode": "absorbed"},
               {"moe_dispatch": "gather"}):
        c = dryrun.apply_overrides(cfg, ov)
        out[f"{arch}/{json.dumps(ov)}"] = [
            c.serve_strategy, c.mla.decode_mode if c.mla else None,
            c.moe.dispatch if c.moe else None]
print(json.dumps(out))
"""


def test_dry_run_arithmetic_equals_the_reference():
    from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
    from repro_torch.launch import dryrun
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REF_ARITH], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    n_unsupported = 0
    for arch in list_archs():
        cfg = get_config(arch)
        for name, shape in INPUT_SHAPES.items():
            w = want[f"{arch}/{name}"]
            assert [dryrun.analytic_hbm_traffic(cfg, shape, n)
                    for n in (256, 512)] == w["hbm"]
            assert dryrun._cache_bytes(cfg, shape.global_batch,
                                       shape.seq_len) == w["cache"]
            assert dryrun.model_flops(cfg, shape) == w["flops"]
            assert cfg.supports_shape(name) == w["supported"]
            if not w["supported"]:
                n_unsupported += 1
                got = dryrun.run_combo(arch, name, False)
                assert {k: got[k] for k in ("status", "reason", "mesh")} == \
                    {k: w["unsupported"][k] for k in
                     ("status", "reason", "mesh")}
        for ov in ({"strategy": "dp_cp"}, {"mla_decode": "absorbed"},
                   {"moe_dispatch": "gather"}):
            c = dryrun.apply_overrides(cfg, ov)
            assert [c.serve_strategy, c.mla.decode_mode if c.mla else None,
                    c.moe.dispatch if c.moe else None] == \
                want[f"{arch}/{json.dumps(ov)}"]
    assert n_unsupported > 0


def test_fake_model_books_the_slstm_loop_as_the_loop_does():
    """``ledger.on_fake_model`` swaps the sLSTM prefill loop for one op
    while the dry run counts, and puts the loop (and the model's
    checkpoint) back after: the op books the FLOPs the loop books step by
    step, and the block's outputs keep the loop's shapes and types."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.launch.ledger import Ledger, on_fake_model
    from repro_torch.models import transformer, xlstm
    from repro_torch.models.layers import ParamFactory
    from repro_torch.specs import tensors_like_specs

    cfg = get_config("xlstm-350m").reduced()
    loop, ckpt = xlstm.slstm_scan, transformer.checkpoint
    fake = FakeTensorMode()
    counted = {}
    for swapped in (False, True):
        with fake:
            p = tensors_like_specs(xlstm.init_slstm_block(ParamFactory(),
                                                          cfg), "cpu")
            x = torch.empty((2, 24, cfg.d_model), dtype=torch.float32)
            led = Ledger(fake)
            with (on_fake_model(led) if swapped else
                  contextlib.nullcontext()), led:
                assert (xlstm.slstm_scan is not loop) == swapped
                out, state = xlstm.slstm_block_apply(p, x, cfg)
        assert out.shape == x.shape and out.dtype == x.dtype
        assert {k: (tuple(v.shape), v.dtype) for k, v in state.items()} == {
            k: ((2, cfg.d_model), torch.float32) for k in "cnhm"}
        counted[swapped] = led.flops
    assert counted[True] == counted[False] > 0
    assert (xlstm.slstm_scan, transformer.checkpoint) == (loop, ckpt)
