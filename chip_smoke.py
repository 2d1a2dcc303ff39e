#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py                      # every phase, one card
  python3 chip_smoke.py --phases env,build,parity   # compile and check

Phases, each of which raises on failure (exit code 1):

1. environment: torch/CUDA versions and the card's name and power limit;
2. build: compile the hand-written kernels from ``src/repro_torch/kernels/csrc``
   with nvcc into the ignored ``build/kernels/`` and time the build;
3. parity: each kernel against its plain PyTorch version on the card, on
   the cases of ``tests/test_kernels.py``, the main path's shapes and rows
   that see no key, in float32 (atol/rtol 2e-5, TF32 off) and bfloat16
   (3e-2);
4. main path: full-width qwen2-0.5b (24 layers, d_model 896, random
   weights from a seed) published to a ``WeightStore`` and served through
   ``ServingEngine``: a cold invoke, a freshened one, a warm one, and a
   generation endpoint decoding 16 tokens; launch counts checked per
   forward and per decode step; the bfloat16 kernel path compared with
   the reference path, teacher-forced; a torch.profiler trace of a
   prefill and 4 decode steps (device-busy time, idle share; trace in
   ``build/profile/``); the float32 model held against its
   ``force_reference`` run, teacher-forced (every step's logits within
   1e-3) and served (last-position logits within 1e-3, identical tokens);
5. times: each kernel, its plain version, the PyTorch library call and
   the bound, at the main path's shapes and a long one.

It prints the kernel records on a ``kernels `` line and as one JSON
object, then the card's name and power limit, and ends with
``{"ok": true, "device": {...}}``.  Without CUDA, or without the
repository's ``src`` beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("env", "build", "parity", "main", "times")
TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
PEAK_BF16_FLOPS = 989e12          # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12              # H100 SXM HBM3
KERNEL_META = {
    "flash_attention": dict(
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:72"),
    "decode_attention": dict(
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:69"),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1
def phase_env(torch):
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} devices {torch.cuda.device_count()} "
        f"name {torch.cuda.get_device_name(0)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    check(bool(smi), "nvidia-smi printed nothing")
    log(f"nvidia-smi: {smi[0]}")
    return smi[0]


# ---------------------------------------------------------------------------
# phase 2
def phase_build(ops):
    t0 = time.perf_counter()
    ops.LIBRARY.load()
    wall = time.perf_counter() - t0
    log(f"build: {wall:.2f} s wall, nvcc built {ops.LIBRARY.built or 'none'} "
        f"into {ops.LIBRARY.build_dir.relative_to(ROOT)}")
    for line in ops.LIBRARY.build_log.splitlines():
        if line.startswith("==") or "Used" in line or "spill" in line:
            log(f"  {line.strip()}")
    return wall


# ---------------------------------------------------------------------------
# phase 3
def _rand(torch, gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.float32).to(dtype)


def _err(torch, out, ref, dtype_name):
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    tol = TOL[dtype_name]
    ok = bool((err <= tol["atol"] + tol["rtol"] * ref.abs()).all())
    check(bool(torch.isfinite(out).all()), "kernel output is not finite")
    return float(err.max()), ok


def phase_parity(torch, ops, ref):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("parity: torch.backends.cuda.matmul.allow_tf32=False, "
        "torch.backends.cudnn.allow_tf32=False; tolerances f32 2e-5, "
        "bf16 3e-2 (atol and rtol)")
    gen = torch.Generator(device="cuda").manual_seed(1234)
    errs = {k: {"float32": 0.0, "bfloat16": 0.0} for k in KERNEL_META}
    # (B, Sq, Sk, Hq, Hkv, dh, dv, causal, window, softcap, q_offset)
    flash_cases = [
        (1, 128, 128, 4, 4, 32, 32, True, None, None, 0),      # MHA
        (2, 256, 256, 8, 2, 64, 64, True, None, None, 0),      # GQA
        (1, 512, 512, 2, 1, 128, 128, True, None, None, 0),    # MQA
        (3, 192, 192, 6, 3, 48, 48, True, None, None, 0),      # odd sizes
        (2, 256, 256, 4, 2, 64, 64, True, 64, None, 0),        # window
        (2, 256, 256, 4, 2, 64, 64, True, None, 25.0, 0),      # softcap
        (2, 256, 256, 4, 2, 64, 64, True, 96, 50.0, 0),        # both
        (1, 128, 128, 4, 4, 32, 32, False, None, None, 0),     # non-causal
        (4, 128, 128, 14, 2, 64, 64, True, None, None, 0),     # main path
        (2, 100, 100, 14, 2, 64, 64, True, None, None, 0),     # ragged S
        (1, 64, 192, 4, 2, 64, 64, True, None, None, 128),     # q_offset
        (1, 130, 130, 4, 2, 80, 40, True, None, None, 0),      # dh 80, dv 40
        (1, 128, 128, 2, 1, 256, 256, True, None, None, 0),    # dh 256
        (1, 192, 192, 4, 2, 64, 64, False, 80, None, 0),       # window only
        (1, 128, 64, 4, 2, 64, 64, True, 16, None, 0),         # rows >= 79
        (1, 64, 64, 4, 2, 32, 32, False, 16, None, 100),       # see no key
    ]
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for (B, Sq, Sk, Hq, Hkv, dh, dv, causal, window, softcap,
             q_offset) in flash_cases:
            # q is a strided view (head stride 2*dh): the kernel reads
            # the (B, S, H, D) layout through strides
            q = _rand(torch, gen, (B, Sq, Hq, 2 * dh), dtype)[..., :dh]
            k = _rand(torch, gen, (B, Sk, Hkv, dh), dtype)
            v = _rand(torch, gen, (B, Sk, Hkv, dv), dtype)
            kw = dict(causal=causal, window=window, softcap=softcap,
                      q_offset=q_offset)
            out = ops.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            want = ref.flash_attention_ref(q, k, v, **kw)
            e, ok = _err(torch, out, want, name)
            errs["flash_attention"][name] = max(errs["flash_attention"][name], e)
            check(ok, f"flash_attention {name} case {(B, Sq, Sk, Hq, Hkv, dh, dv)} "
                  f"{kw}: max abs err {e}")
    # (B, S, Hq, Hkv, dh, window, softcap, positions or None=random)
    decode_cases = [
        (2, 256, 4, 2, 64, None, None, None),
        (1, 512, 8, 8, 32, None, None, None),
        (4, 128, 2, 1, 128, None, None, None),
        (2, 64, 4, 2, 32, 64, None, [3, 63, 64, 5 * 64 + 7]),   # ring buffer
        (4, 256, 14, 2, 64, None, None, [128, 131, 140, 143]),  # main path
        (2, 256, 4, 2, 64, 64, 30.0, [200, 17]),                # window+cap
        (3, 100, 14, 2, 64, None, None, [99, 0, 50]),           # ragged S
        (2, 256, 32, 2, 64, None, None, [255, 77]),             # G 16
        (1, 128, 32, 1, 128, None, None, [127]),                # G 32, dv 128
        # rows that see no slot: past a plain window, pos -1, ring pos -3
        (2, 256, 4, 2, 64, 64, None, [400, 100]),
        (2, 128, 4, 2, 64, None, None, [-1, 5]),
        (2, 64, 4, 2, 32, 64, None, [-3]),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for B, S, Hq, Hkv, dh, window, softcap, positions in decode_cases:
            k = _rand(torch, gen, (B, S, Hkv, dh), dtype)
            v = _rand(torch, gen, (B, S, Hkv, dh), dtype)
            q = _rand(torch, gen, (B, 1, Hq, dh), dtype)
            if positions is None:
                pos_sets = [torch.randint(1, S, (B,), generator=gen,
                                          device="cuda", dtype=torch.int32)]
            elif window == S:                   # ring: each p for every row
                pos_sets = [torch.full((B,), p, dtype=torch.int32,
                                       device="cuda") for p in positions]
            else:
                pos_sets = [torch.tensor(positions, dtype=torch.int32,
                                         device="cuda")]
            for pos in pos_sets:
                kw = dict(window=window, softcap=softcap)
                out = ops.decode_attention(q, k, v, pos, **kw)
                torch.cuda.synchronize()
                want = ref.decode_attention_ref(q, k, v, pos, **kw)
                e, ok = _err(torch, out, want, name)
                errs["decode_attention"][name] = max(
                    errs["decode_attention"][name], e)
                check(ok, f"decode_attention {name} case {(B, S, Hq, Hkv, dh)} "
                      f"{kw} pos {pos.tolist()}: max abs err {e}")
    for kname, e in errs.items():
        log(f"parity {kname}: max abs err f32 {e['float32']:.3e} "
            f"bf16 {e['bfloat16']:.3e} over {len(flash_cases) if kname == 'flash_attention' else len(decode_cases)} "
            f"cases x 2 types: ok")
    return errs


# ---------------------------------------------------------------------------
# phase 4
def _counts(ops):
    return {op.name: op.launches for op in ops.KERNELS}


def _delta(before, after):
    return {k: after[k] - before[k] for k in after}


def phase_main(torch, np, ops, tmp_root, engines):
    """Full-width qwen2-0.5b on the card.  Every engine it starts goes
    into ``engines`` for the caller to close."""
    from repro_torch.configs import get_config
    from repro_torch.core import FunctionSpec
    from repro_torch.models import make_model
    from repro_torch.serving import (Executor, ModelEndpoint, ServingEngine,
                                     WeightStore)

    cfg = get_config("qwen2-0.5b")
    device = "cuda"
    n_layers = cfg.n_layers
    B, S, MAX_LEN, N_TOK = 4, 128, 256, 16
    log(f"main: {cfg.name} full width: {n_layers} layers, d_model "
        f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, head_dim "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}, {cfg.param_count() / 1e6:.1f} M params; batch {B}, "
        f"prompt {S}, cache {MAX_LEN}, {N_TOK} tokens")
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, size=(B, S), dtype=np.int32)
    out: dict = {}

    def gen_spec(ep, name):
        def plan_factory(rt):
            base = ep.build_plan(rt)
            base.entries.extend(ep.session_plan_entries(MAX_LEN))
            return base

        def code(ctx, args):
            return ep.generate(ctx, args["tokens"], n_steps=N_TOK,
                               max_len=MAX_LEN, plan_offset=3)
        return FunctionSpec(name, code, plan_factory=plan_factory,
                            app="serving")

    def serve(cfg_, store, name, tag):
        """cold invoke, freshened invoke, warm invoke, generation."""
        res = {}
        eng_cold = ServingEngine()
        engines.append(eng_cold)
        rt_cold = eng_cold.deploy(ModelEndpoint(
            name, cfg_, store, Executor(), batch_size=B, seq_len=S,
            device=device))
        c0 = _counts(ops)
        t0 = time.perf_counter()
        cold = eng_cold.invoke(name, prompt, freshen_successors=False)
        res["cold_ms"] = (time.perf_counter() - t0) * 1e3
        res["cold_launches"] = _delta(c0, _counts(ops))
        st = rt_cold.fr_state.stats()
        check(st["inline"] >= 3, f"{tag} cold invoke paid {st} inline")
        res["cold_timing"] = cold["timing"]

        eng = ServingEngine()
        engines.append(eng)
        ep = ModelEndpoint(name, cfg_, store, Executor(), batch_size=B,
                           seq_len=S, device=device)
        rt = eng.deploy(ep)
        rt.freshen(blocking=True)
        st = rt.fr_state.stats()
        check(st["freshened"] >= 3 and st["inline"] == 0,
              f"{tag} freshen left {st}")
        c0 = _counts(ops)
        t0 = time.perf_counter()
        fresh = eng.invoke(name, prompt, freshen_successors=False)
        res["freshened_ms"] = (time.perf_counter() - t0) * 1e3
        res["freshened_launches"] = _delta(c0, _counts(ops))
        t0 = time.perf_counter()
        warm = eng.invoke(name, prompt, freshen_successors=False)
        res["warm_ms"] = (time.perf_counter() - t0) * 1e3
        res["warm_timing"] = warm["timing"]
        for r in (cold, fresh, warm):
            check(r["logits"].shape == (B, 1, cfg_.vocab_size),
                  f"{tag} logits shape {r['logits'].shape}")
            check(bool(np.isfinite(r["logits"]).all()),
                  f"{tag} logits not finite")
        check(np.array_equal(cold["logits"], fresh["logits"]),
              f"{tag} cold and freshened logits differ")
        res["logits"] = warm["logits"]

        rt_gen = eng.scheduler.register(gen_spec(ep, f"{name}/generate"))
        rt_gen.init()
        rt_gen.freshen(blocking=True)
        c0 = _counts(ops)
        t0 = time.perf_counter()
        tokens = eng.invoke(f"{name}/generate", prompt,
                            freshen_successors=False)
        res["generate_ms"] = (time.perf_counter() - t0) * 1e3
        res["generate_launches"] = _delta(c0, _counts(ops))
        check(len(tokens) == N_TOK and all(0 <= t < cfg_.vocab_size
                                           for t in tokens),
              f"{tag} generated {tokens}")
        res["tokens"] = tokens
        return res

    # ---- bf16 main path: through the kernels -------------------------------
    gen = torch.Generator(device=device).manual_seed(0)
    model = make_model(cfg, device=device)
    params = model.init(gen)
    store = WeightStore(tempfile.mkdtemp(dir=tmp_root, prefix="weights-"))
    t0 = time.perf_counter()
    store.publish("qwen2", params)
    out["publish_s"] = time.perf_counter() - t0
    log(f"main: published {store.nbytes('qwen2') / 1e9:.3f} GB in "
        f"{out['publish_s']:.2f} s")

    ops.reset_launches()                      # the main path's run starts
    bf = serve(cfg, store, "qwen2", "bf16")
    out["launches"] = _counts(ops)            # ... and ends here
    per_fwd = {"flash_attention": n_layers, "decode_attention": 0}
    # cold invoke = warm-up forward on zeros + the request's forward
    check(bf["cold_launches"] == {k: 2 * v for k, v in per_fwd.items()},
          f"cold invoke launches {bf['cold_launches']}")
    check(bf["freshened_launches"] == per_fwd,
          f"freshened invoke launches {bf['freshened_launches']}")
    want_gen = {"flash_attention": n_layers,
                "decode_attention": n_layers * (N_TOK - 1)}
    check(bf["generate_launches"] == want_gen,
          f"generation launches {bf['generate_launches']} != {want_gen}")
    check(all(v > 0 for v in out["launches"].values()),
          f"a kernel was not launched on the main path: {out['launches']}")
    log(f"main bf16: cold invoke {bf['cold_ms']:.1f} ms "
        f"(timing {json.dumps({k: round(v * 1e3, 2) for k, v in bf['cold_timing'].items()})} ms), "
        f"freshened invoke {bf['freshened_ms']:.1f} ms, warm invoke "
        f"{bf['warm_ms']:.1f} ms, generate {N_TOK} tokens "
        f"{bf['generate_ms']:.1f} ms; launches {out['launches']}")
    log(f"main bf16: tokens {bf['tokens']}")
    out.update({k: bf[k] for k in ("cold_ms", "freshened_ms", "warm_ms",
                                   "generate_ms")})

    # ---- bf16: kernel path vs reference path, teacher-forced ---------------
    toks = torch.as_tensor(prompt, device=device)

    def run(model, params, reference: bool, feed=None):
        """Prefill, then N_TOK - 1 decode steps; with ``feed`` the tokens
        are those of an earlier run (teacher forcing)."""
        ctx = ops.force_reference() if reference else contextlib.nullcontext()
        logits_steps, step_ms = [], []
        with ctx, torch.no_grad():
            cache = model.init_cache(B, MAX_LEN)
            logits, cache = model.prefill(params, toks, max_len=MAX_LEN,
                                          cache=cache)
            logits_steps.append(logits.float())
            tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
            pos = torch.full((B,), S, dtype=torch.int32, device=device)
            fed = []
            for i in range(N_TOK - 1):
                if feed is not None:
                    tok = feed[i]
                fed.append(tok)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = model.decode_step(params, cache, tok, pos)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                logits_steps.append(logits.float())
                tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
                pos = pos + 1
        return logits_steps, fed, step_ms

    def compare(k_logits, r_logits, tag):
        check(all(bool(torch.isfinite(a).all()) for a in k_logits),
              f"{tag} teacher-forced logits not finite")
        diff = max(float((a - b).abs().max())
                   for a, b in zip(k_logits, r_logits))
        agree = sum(int((a.argmax(-1) == b.argmax(-1)).sum())
                    for a, b in zip(k_logits, r_logits))
        return diff, agree, sum(a.shape[0] for a in k_logits)

    k_logits, fed, k_ms = run(model, params, False)
    r_logits, _, r_ms = run(model, params, True, feed=fed)
    diff, agree, total = compare(k_logits, r_logits, "bf16")
    out["bf16_teacher_forced"] = {"max_logit_diff": diff,
                                  "greedy_agree": agree, "of": total}
    out["decode_step_ms"] = sorted(k_ms)[len(k_ms) // 2]
    out["decode_step_ms_reference"] = sorted(r_ms)[len(r_ms) // 2]
    log(f"main bf16 kernel vs reference path, teacher-forced over "
        f"{N_TOK} positions x {B} rows: max |logit diff| {diff:.4e}, "
        f"greedy agreement {agree}/{total}; decode step median "
        f"{out['decode_step_ms']:.2f} ms (reference path "
        f"{out['decode_step_ms_reference']:.2f} ms)")
    out["profile"] = profile_steps(torch, model, params, toks, MAX_LEN,
                                   ROOT / "build" / "profile")
    del params, model

    # ---- float32 parity: kernel path vs force_reference --------------------
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device=device).manual_seed(0)
    model32 = make_model(cfg32, device=device)
    params32 = model32.init(gen)
    store.publish("qwen2f32", params32)
    # every decode step's logits, teacher-forced: this is where K2 shows
    k_logits, fed, _ = run(model32, params32, False)
    r_logits, _, _ = run(model32, params32, True, feed=fed)
    diff32, agree32, total32 = compare(k_logits, r_logits, "f32")
    del k_logits, r_logits, params32, model32
    out["f32_teacher_forced"] = {"max_logit_diff": diff32,
                                 "greedy_agree": agree32, "of": total32}
    log(f"main f32 kernel vs reference path, teacher-forced over {N_TOK} "
        f"positions x {B} rows: max |logit diff| {diff32:.3e} (limit 1e-3), "
        f"greedy agreement {agree32}/{total32}")
    check(diff32 <= 1e-3, f"f32 teacher-forced logits differ by {diff32}")
    k32 = serve(cfg32, store, "qwen2f32", "f32 kernels")
    c0 = _counts(ops)
    with ops.force_reference():
        r32 = serve(cfg32, store, "qwen2f32", "f32 reference")
    check(_counts(ops) == c0, "force_reference run launched a kernel")
    d32 = float(np.abs(k32["logits"] - r32["logits"]).max())
    out["f32_logit_diff"] = d32
    out["f32_tokens_equal"] = k32["tokens"] == r32["tokens"]
    log(f"main f32 kernels vs force_reference: last-position max |logit "
        f"diff| {d32:.3e} (limit 1e-3), tokens equal "
        f"{out['f32_tokens_equal']}")
    check(d32 <= 1e-3, f"f32 logits differ by {d32}")
    check(out["f32_tokens_equal"],
          f"f32 tokens differ: {k32['tokens']} vs {r32['tokens']}")
    return out


def profile_steps(torch, model, params, toks, max_len, trace_dir, steps=4):
    """Trace one prefill and ``steps`` decode steps with torch.profiler:
    device-busy share of the wall time, kernels per step, and the
    kernels that take the device time.  The Chrome trace and the host-op
    table go to ``trace_dir``."""
    from torch.profiler import ProfilerActivity, profile, record_function
    B, S = toks.shape

    def work():
        with torch.no_grad():
            cache = model.init_cache(B, max_len)
            logits, cache = model.prefill(params, toks, max_len=max_len,
                                          cache=cache)
            torch.cuda.synchronize()
            t_pre = time.perf_counter()
            with record_function("decode_steps"):
                tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
                pos = torch.full((B,), S, dtype=torch.int32,
                                 device=toks.device)
                for _ in range(steps):
                    logits, cache = model.decode_step(params, cache, tok, pos)
                    tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
                    pos = pos + 1
                torch.cuda.synchronize()
            return t_pre

    work()                                    # allocator and handles warm
    res = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        t_pre = work()
        t1 = time.perf_counter()
    events = prof.events()
    # device events, without the marker's own span on the GPU timeline
    kern = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name != "decode_steps"]
    out_dir = Path(trace_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out_dir / "decode_trace.json"))
    marks = [e for e in events if e.name == "decode_steps"]
    if not kern or not marks:
        log("profile: the profiler recorded no device events: device time "
            "not measured")
        return res
    # the prefill ends in a synchronize before the decode region opens,
    # so device events that start inside the region are the decode's
    split_us = marks[0].time_range.start
    dec = [e for e in kern if e.time_range.start >= split_us]
    pre = [e for e in kern if e.time_range.start < split_us]
    by_name: dict = {}
    for e in dec:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_dec = sum(by_name.values())
    busy_pre = sum(e.time_range.elapsed_us() for e in pre)
    wall_pre, wall_dec = (t_pre - t0) * 1e6, (t1 - t_pre) * 1e6
    res = dict(prefill_wall_ms=wall_pre / 1e3, prefill_busy_ms=busy_pre / 1e3,
               prefill_kernels=len(pre),
               decode_wall_ms_per_step=wall_dec / steps / 1e3,
               decode_busy_ms_per_step=busy_dec / steps / 1e3,
               decode_kernels_per_step=len(dec) / steps,
               decode_idle_share=1 - busy_dec / wall_dec)
    log("profile (bf16, batch %d, prompt %d): prefill wall %.2f ms, device "
        "busy %.2f ms, %d device events; decode per step wall %.2f ms, "
        "device busy %.3f ms, %.0f device events, device idle share %.3f"
        % (B, S, res["prefill_wall_ms"], res["prefill_busy_ms"],
           res["prefill_kernels"], res["decode_wall_ms_per_step"],
           res["decode_busy_ms_per_step"], res["decode_kernels_per_step"],
           res["decode_idle_share"]))
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"profile decode top: {us / steps:9.1f} us/step  {name[:90]}")
    table = prof.key_averages().table(sort_by="self_cpu_time_total",
                                      row_limit=15)
    (out_dir / "profile_table.txt").write_text(table)
    log("profile host ops by self CPU time (prefill + decode, profiler on):")
    for line in table.splitlines()[:19]:
        log(f"  {line[:150]}")
    return res


# ---------------------------------------------------------------------------
# phase 5
def cuda_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_times(torch, ops, ref):
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(99)
    bf16 = torch.bfloat16
    rows = {}

    def sdpa(*a, **kw):
        return F.scaled_dot_product_attention(*a, **kw, enable_gqa=True)

    for label, (B, S) in (("main", (4, 128)), ("long", (1, 4096))):
        Hq, Hkv, dh = 14, 2, 64
        q = _rand(torch, gen, (B, S, Hq, dh), bf16)
        k = _rand(torch, gen, (B, S, Hkv, dh), bf16)
        v = _rand(torch, gen, (B, S, Hkv, dh), bf16)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        pairs = S * (S + 1) // 2
        flops = B * Hq * pairs * 2 * (dh + dh)
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
        bound, by = _bound(flops, nbytes)
        rows[("flash_attention", label)] = dict(
            shape=f"B={B} S={S} Hq={Hq} Hkv={Hkv} dh={dh} bf16 causal",
            ms=cuda_ms(torch, lambda: ops.flash_attention(q, k, v)),
            plain_ms=cuda_ms(torch, lambda: ref.flash_attention_ref(q, k, v),
                             iters=5),
            library_ms=cuda_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True)),
            bound_ms=bound, bound_by=by)
    for label, (B, S, p) in (("main", (4, 256, 143)),
                             ("long", (8, 4096, 4095))):
        Hq, Hkv, dh = 14, 2, 64
        q = _rand(torch, gen, (B, 1, Hq, dh), bf16)
        k = _rand(torch, gen, (B, S, Hkv, dh), bf16)
        v = _rand(torch, gen, (B, S, Hkv, dh), bf16)
        pos = torch.full((B,), p, dtype=torch.int32, device="cuda")
        mask = ref.decode_slot_valid(pos, S, None)[:, None, None, :]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        valid = min(p + 1, S)
        flops = B * Hq * valid * 2 * (dh + dh)
        nbytes = 2 * (B * Hkv * valid * 2 * dh + 2 * q.numel()) + 4 * B
        bound, by = _bound(flops, nbytes)
        rows[("decode_attention", label)] = dict(
            shape=f"B={B} cache={S} pos={p} Hq={Hq} Hkv={Hkv} dh={dh} bf16",
            ms=cuda_ms(torch, lambda: ops.decode_attention(q, k, v, pos)),
            plain_ms=cuda_ms(torch, lambda: ref.decode_attention_ref(
                q, k, v, pos)),
            library_ms=cuda_ms(torch, lambda: sdpa(qt, kt, vt,
                                                    attn_mask=mask)),
            bound_ms=bound, bound_by=by)
    for (name, label), r in rows.items():
        log(f"times {name} [{label}] {r['shape']}: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, library (sdpa) "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}), kernel at {r['bound_ms'] / r['ms']:.1%} "
            f"of bound")
    return rows


# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES}; a subset "
                         "(env,build,parity) is the quick compile-and-check "
                         "run and prints no result line")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    check(set(phases) <= set(PHASES), f"unknown phase in {phases}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.kernels import ops, ref

    smi = phase_env(torch)
    results: dict = {}
    if "build" in phases:
        results["build_s"] = phase_build(ops)
    if "parity" in phases:
        results["errs"] = phase_parity(torch, ops, ref)
    tmp_root = tempfile.mkdtemp(prefix="chip-smoke-")
    engines: list = []
    try:
        if "main" in phases:
            results["main"] = phase_main(torch, np, ops, tmp_root, engines)
    finally:
        for eng in engines:
            eng.close()
        shutil.rmtree(tmp_root, ignore_errors=True)
    if "times" in phases:
        results["times"] = phase_times(torch, ops, ref)
    if not set(PHASES) <= set(phases):
        log(f"chip_smoke: ran phases {phases} only")
        return 0

    main_res = results["main"]
    log(f"e2e: cold invoke {main_res['cold_ms']:.3f} ms, freshened invoke "
        f"{main_res['freshened_ms']:.3f} ms, warm invoke "
        f"{main_res['warm_ms']:.3f} ms, decode step (per token, batch 4) "
        f"{main_res['decode_step_ms']:.3f} ms, decode device idle share "
        f"under the profiler "
        f"{main_res['profile'].get('decode_idle_share', 'not measured')}")
    records, short = [], []
    for name, meta in KERNEL_META.items():
        t_main = results["times"][(name, "main")]
        t_long = results["times"][(name, "long")]
        errs = results["errs"][name]
        rec = dict(name=name, route="cuda", **meta,
                   launches=main_res["launches"][name],
                   max_abs_err=max(errs.values()),
                   max_err_f32=errs["float32"], max_err_bf16=errs["bfloat16"],
                   ms=t_main["ms"], plain_ms=t_main["plain_ms"],
                   bound_ms=t_main["bound_ms"], bound_by=t_main["bound_by"],
                   library_ms=t_main["library_ms"],
                   long={k: t_long[k] for k in ("shape", "ms", "plain_ms",
                                                 "library_ms", "bound_ms",
                                                 "bound_by")})
        records.append(rec)
        short.append({k: rec[k] for k in (
            "name", "launches", "max_err_f32", "max_err_bf16", "ms",
            "plain_ms", "library_ms", "bound_ms")})
    log("kernels " + json.dumps(short))
    log(json.dumps({"kernels": records}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
