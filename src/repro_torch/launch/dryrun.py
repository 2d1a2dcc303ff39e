# fabriclint: allow-file[clock] -- launch-time measurement harness:
# wall-clock stamps feed the printed timings only.

"""Multi-pod dry run of the port (``repro/launch/dryrun.py``): every
(architecture x input shape x mesh) run once at production size on fake
tensors, and the roofline ledger.

Each mesh runs in a process of its own, on the ``fake`` process-group
backend (``launch/mesh.py``): one process is rank 0 of the 256 or 512
ranks, every tensor is a ``FakeTensor``, and nothing is allocated or
computed.  Per combo:

* the FULL program (``build_*_step``: layers looped, attention chunked
  by ``q_chunk``, microbatched) runs once under ``launch.ledger.Ledger``:
  per-device FLOPs on the local shards, collectives by op with their
  bytes, and memory (the local shards' argument bytes, and the peak of
  the bytes the step allocates on top, counted by the ledger itself:
  ``MemTracker`` also books the global-shape fake tensors of DTensor's
  sharding propagation, 26 GB of them in qwen2's ``decode_32k``);
* the UNITS (``build_units``: one block of each kind, the embedding and
  head, the optimizer update), each run once, times its multiplier.
  Eager PyTorch counts every op the full program runs, so the units are
  a per-kind breakdown that must add up to it; in training the full
  program also recomputes the remat checkpoints' forwards, booked apart
  as ``recompute_flops_per_device``.  The sLSTM prefill loop runs on fake
  tensors as one op (``launch/ledger.py:fake_slstm_scan``) that books its
  S steps' recurrent products, as the units' ``slstm_step`` x S does;
* the analytic HBM-traffic model (the reference's formula), and a
  roofline from the H100 SXM 80GB datasheet: 989 TFLOP/s dense bf16,
  3.35 TB/s HBM3, NVLink 450 GB/s each way.  Derived from peaks, not
  measured.

What the reference's record reads from XLA has a counterpart or goes:
``memory_analysis`` becomes ``memory`` (arguments from the shards,
``peak_step_bytes_per_device`` from the ledger; no output, temp or alias
split, and no ``cpu_bf16_upcast_artifact_bytes``: fake tensors allocate
in the program's own types); ``cost_analysis``' once-counted while
bodies and ``collectives_full_program_once_counted`` become the exact
``full_program`` counts; HLO text parsing (``_shape_bytes``,
``parse_collectives``, ``convert_artifact_bytes``) has no counterpart;
``lower_seconds``/``compile_seconds`` become ``run_seconds``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both --out build/dryrun
"""
import argparse
import json
import logging
import os
import subprocess
import sys
import time
import traceback
from collections import Counter
from contextlib import nullcontext

from repro_torch.configs import INPUT_SHAPES, get_config, list_archs

# H100 SXM 80GB datasheet peaks, for the derived roofline
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12                  # bytes/s, HBM3
NVLINK_BW = 450e9                 # bytes/s each way
MESHES = {"pod": [False], "multipod": [True], "both": [False, True]}


# ----------------------------------------------------------------------
def analytic_hbm_traffic(cfg, shape, n_chips: int) -> float:
    """Per-device HBM bytes per step (documented model, EXPERIMENTS.md):

    weights: read once per fwd pass (+remat fwd +bwd for training), sharded
    across all chips; optimizer: p read/write + f32 moments read/write;
    activations: ~12 d_model-sized streams per token per layer;
    attention KV: each query chunk re-streams the full K/V (flash on TPU);
    decode: whole KV cache read once + params read once.
    """
    P_total = cfg.param_count()
    P_active = cfg.active_param_count()
    d = cfg.d_model
    L = cfg.n_layers
    hd = cfg.resolved_head_dim
    B, S = shape.global_batch, shape.seq_len
    bytes_p = 2

    if shape.mode == "train":
        tokens = B * S
        w = 3 * P_total * bytes_p                      # fwd + remat + bwd
        w += P_total * (2 * bytes_p + 16) + P_total * 4    # adamw + grads
        act = 12 * tokens * d * bytes_p * L
        nq = max(1, S // cfg.q_chunk)
        kv = 2 * nq * B * S * cfg.n_kv_heads * hd * bytes_p * L * 3
        logits = 2 * tokens * cfg.vocab_size * bytes_p // max(1, S // 512)
        total = w + act + kv + logits
    elif shape.mode == "prefill":
        tokens = B * S
        w = P_active * bytes_p if cfg.moe else P_total * bytes_p
        act = 12 * tokens * d * bytes_p * L
        nq = max(1, S // cfg.q_chunk)
        kv = 2 * nq * B * S * cfg.n_kv_heads * hd * bytes_p * L
        cache_write = 2 * B * S * cfg.n_kv_heads * hd * bytes_p * L
        total = w + act + kv + cache_write
    else:                                              # decode (1 token)
        w = (P_active if cfg.moe else P_total) * bytes_p
        cache = _cache_bytes(cfg, B, S)
        act = 12 * B * d * bytes_p * L
        total = w + cache + act
    return total / n_chips


def _cache_bytes(cfg, B, S) -> float:
    total = 0.0
    for kind in cfg.layer_kinds:
        if kind in ("attn", "attn_moe"):
            total += 2 * B * S * cfg.n_kv_heads * cfg.resolved_head_dim * 2
        elif kind == "attn_local":
            L = min(S, cfg.window_size or S)
            total += 2 * B * L * cfg.n_kv_heads * cfg.resolved_head_dim * 2
        elif kind in ("mla", "mla_moe"):
            total += B * S * (cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim) * 2
        elif kind == "rglru":
            r = cfg.rglru.d_rnn or cfg.d_model
            total += B * r * 4
        elif kind == "mlstm":
            di = int(cfg.d_model * cfg.xlstm.proj_factor_mlstm)
            total += B * cfg.n_heads * (di // cfg.n_heads) ** 2 * 4
        elif kind == "slstm":
            total += 4 * B * cfg.d_model * 4
    return total


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N_active·D (train) / 2·N_active·D (inference)."""
    N = cfg.active_param_count()
    if shape.mode == "train":
        return 6.0 * N * shape.global_batch * shape.seq_len
    if shape.mode == "prefill":
        return 2.0 * N * shape.global_batch * shape.seq_len
    return 2.0 * N * shape.global_batch                 # one token per row


# ----------------------------------------------------------------------
def apply_overrides(cfg, overrides: dict):
    """Perf-iteration knobs (EXPERIMENTS.md §Perf):
    strategy=tp|dp_cp|auto, mla_decode=absorbed|naive,
    moe_dispatch=einsum|gather, use_tri=0|1, microbatches=N."""
    import dataclasses as dc
    if "strategy" in overrides:
        cfg = dc.replace(cfg, serve_strategy=overrides["strategy"])
    if "mla_decode" in overrides and cfg.mla:
        cfg = dc.replace(cfg, mla=dc.replace(
            cfg.mla, decode_mode=overrides["mla_decode"]))
    if "moe_dispatch" in overrides and cfg.moe:
        cfg = dc.replace(cfg, moe=dc.replace(
            cfg.moe, dispatch=overrides["moe_dispatch"]))
    return cfg


def _spec_bytes(specs) -> int:
    """This rank's bytes of a sharded ``TensorSpec`` tree."""
    import torch
    from repro_torch.sharding.partitioning import local_shape_and_offset
    from repro_torch.specs import spec_leaves
    total = 0
    for s in spec_leaves(specs):
        shape = s.shape
        if s.sharding is not None:
            shape, _ = local_shape_and_offset(s.shape, s.sharding.mesh,
                                              s.sharding.placements)
        n = 1
        for d in shape:
            n *= d
        total += n * torch.empty((), dtype=s.dtype).element_size()
    return total


def _count(fn, specs, fake_mode):
    """Run ``fn`` once on fresh fake inputs made from ``specs``; returns
    its ledger."""
    from repro_torch.launch.ledger import Ledger, on_fake_model
    from repro_torch.sharding.partitioning import distribute_specs
    with fake_mode:
        args = distribute_specs(specs, "cpu")
        led = Ledger(fake_mode)
        with on_fake_model(led), led:
            fn(*args)
    return led


def run_combo(arch: str, shape_name: str, multi_pod: bool,
              with_units: bool = True, overrides: dict | None = None) -> dict:
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import make_model

    overrides = overrides or {}
    shape = INPUT_SHAPES[shape_name]
    base_cfg = get_config(arch)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "status": "unsupported", "overrides": overrides}
    if not base_cfg.supports_shape(shape_name):
        rec["reason"] = ("full-attention KV at 524288 infeasible; "
                         "see DESIGN.md shape-skip table")
        return rec

    cfg = apply_overrides(steps_mod._dryrun_cfg(base_cfg, shape), overrides)
    microbatches = (int(overrides["microbatches"])
                    if "microbatches" in overrides else None)
    model = make_model(cfg, device="cpu")
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size()
    fake = FakeTensorMode()

    if shape.mode == "train":
        step, specs, donate, M = steps_mod.build_train_step(
            model, shape, mesh, microbatches=microbatches)
    elif shape.mode == "prefill":
        step, specs, donate, M = steps_mod.build_prefill_step(
            model, shape, mesh)
    else:
        step, specs, donate, M = steps_mod.build_decode_step(
            model, shape, mesh)

    t0 = time.monotonic()
    with torch.no_grad() if shape.mode != "train" else nullcontext():
        full = _count(step, specs, fake)
    t_run = time.monotonic() - t0
    args_bytes = _spec_bytes(specs)
    rec.update({
        "status": "ok",
        "run_seconds": round(t_run, 2),
        "microbatches": M,
        "memory": {
            "argument_bytes_per_device": args_bytes,
            "donated_arguments": list(donate),
            "peak_step_bytes_per_device": full.peak,
            "peak_estimate_per_device": args_bytes + full.peak,
        },
        "full_program": {
            "flops_per_device": full.flops,
            "recompute_flops_per_device": full.recompute_flops,
            "collectives": full.collectives(),
        },
    })

    if not with_units:
        return rec
    unit_rows = []
    flops_units = 0.0
    coll_bytes_per_dev = 0.0
    coll_by_op: Counter = Counter()
    raw = {}
    units = steps_mod.build_units(model, shape, mesh,
                                  microbatches=microbatches)
    for u in units:
        with torch.no_grad() if shape.mode != "train" else nullcontext():
            led = _count(steps_mod._sharded(u.fn), u.specs, fake)
        ucol = led.collectives()
        cmul = (u.coll_multiplier if u.coll_multiplier is not None
                else u.multiplier)
        raw[u.name] = (u, led.flops, ucol, cmul)
        flops_units += led.flops * u.multiplier
        coll_bytes_per_dev += ucol["total_bytes"] * cmul
        for k, v in ucol["bytes"].items():
            coll_by_op[k] += v * cmul
        unit_rows.append({
            "unit": u.name, "multiplier": u.multiplier,
            "coll_multiplier": cmul,
            "flops_per_device_once": led.flops,
            "collective_bytes_once": ucol["total_bytes"],
            "collective_ops": ucol["count"]})
    # weight-grad reductions: (full vjp - activation-only) collectives,
    # once per step, as the reference books them
    for name, (u, fl, ucol, cmul) in raw.items():
        act_name = name + "__act"
        if act_name in raw:
            act_bytes = raw[act_name][2]["total_bytes"]
            n_layers_mult = raw[act_name][3] / max(1.0, M)
            wgrad = max(0.0, ucol["total_bytes"] - act_bytes)
            coll_bytes_per_dev += wgrad * n_layers_mult
            coll_by_op["wgrad_once"] += wgrad * n_layers_mult
            unit_rows.append({
                "unit": name + "__wgrad", "multiplier": n_layers_mult,
                "coll_multiplier": n_layers_mult,
                "flops_per_device_once": 0.0,
                "collective_bytes_once": wgrad,
                "collective_ops": {}})
    rec["units"] = unit_rows
    excess = full.flops - flops_units
    rec["ledger"] = {
        "flops_per_device": flops_units,
        "hlo_flops_global": flops_units * n_chips,
        "full_over_units": full.flops / flops_units if flops_units else 0.0,
        "excess_flops_per_device": excess,
        "excess_over_recompute": (excess / full.recompute_flops
                                  if full.recompute_flops else None),
        "collective_bytes_per_device": coll_bytes_per_dev,
        "collective_bytes_by_op_per_device": dict(coll_by_op),
    }

    # ---------------- roofline (derived from datasheet peaks) ----------
    mf = model_flops(cfg, shape)
    hbm_per_dev = analytic_hbm_traffic(cfg, shape, n_chips)
    terms = {"compute": full.flops / PEAK_FLOPS_BF16,
             "memory": hbm_per_dev / HBM_BW,
             "collective": full.collectives()["total_bytes"] / NVLINK_BW}
    rec["roofline"] = {
        **{f"{k}_seconds": v for k, v in terms.items()},
        "dominant": max(terms, key=terms.get),
        "model_flops": mf,
        "useful_flop_ratio": mf / (full.flops * n_chips) if full.flops
        else 0.0,
        "hbm_bytes_per_device": hbm_per_dev,
        "peaks": "H100 SXM 80GB datasheet: 989e12 FLOP/s dense bf16, "
                 "3.35e12 B/s HBM3, 450e9 B/s NVLink each way; derived, "
                 "not measured",
    }
    return rec


# ----------------------------------------------------------------------
def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--mesh", default="pod", choices=list(MESHES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--no-units", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--override", default="",
                    help="comma list k=v (strategy, mla_decode, "
                         "moe_dispatch, microbatches)")
    ap.add_argument("--tag", default="", help="suffix for output filenames")
    args = ap.parse_args(argv)
    meshes = MESHES[args.mesh]
    if len(meshes) > 1:               # one process per mesh
        rc = 0
        for name in ("pod", "multipod"):
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   *_without_mesh(sys.argv[1:] if argv is None else argv),
                   "--mesh", name]
            rc = max(rc, subprocess.run(cmd).returncode)
        if rc:
            raise SystemExit(rc)
        return
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    overrides = dict(kv.split("=", 1) for kv in args.override.split(",")
                     if "=" in kv)

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]

    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch in archs:
        for shape_name in shapes:
            for multi_pod in meshes:
                tag = f"{arch}__{shape_name}__{'mp' if multi_pod else 'sp'}"
                if args.tag:
                    tag += "__" + args.tag
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path) and not args.force:
                    print(f"[skip] {tag} (cached)")
                    continue
                print(f"[run ] {tag}", flush=True)
                t0 = time.monotonic()
                try:
                    rec = run_combo(arch, shape_name, multi_pod,
                                    with_units=not args.no_units,
                                    overrides=overrides)
                except Exception as e:
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": "2x16x16" if multi_pod else "16x16",
                           "status": "FAILED", "error": str(e),
                           "traceback": traceback.format_exc()[-2000:]}
                    failures.append(tag)
                rec["wall_seconds"] = round(time.monotonic() - t0, 1)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1, default=float)
                print(f"       -> {rec['status']} "
                      f"({rec['wall_seconds']}s)", flush=True)
    if failures:
        print("FAILURES:", failures)
        raise SystemExit(1)
    print("all combos ok")


def _without_mesh(argv) -> list:
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        if a == "--mesh":
            skip = True
            continue
        if a.startswith("--mesh="):
            continue
        out.append(a)
    return out


if __name__ == "__main__":
    main()
