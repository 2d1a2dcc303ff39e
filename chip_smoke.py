#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py                      # every phase, one card
  python3 chip_smoke.py --phases env,build,parity   # compile and check
  python3 chip_smoke.py --phases env,build,parity,rollout  # and the drivers

Phases, each of which raises on failure (exit code 1):

1. environment: torch/CUDA versions and the card's name and power limit;
2. build: compile the hand-written kernels from ``src/repro_torch/kernels/csrc``
   with nvcc into the ignored ``build/kernels/`` and time the build; echo
   each kernel's registers and spills (the bf16 tensor-core
   instantiations of K1 must not spill, nor K1b's at dh 64, nor K3b's),
   K1's and K1b's shared memory per block, and K3's and K3b's plans
   (tiles, ring stages, shared memory) at their timed shapes;
3. parity: each kernel against its plain PyTorch version on the card, on
   the cases of ``tests/test_kernels.py``, the served models' shapes
   (the dense phase's too, gemma2's K1 at a prompt of 4200 past its
   window of 4096 and its K2 on the 4096-slot ring),
   rows that see no key, and the edges of the new designs (K1's bf16
   head-dim tiles up to dh 192 / dv 128 and 256, ragged Sq, q_offset; K2's
   splits wholly past pos and the ring across split edges; MLA's dh 192
   / dv 128 at 16/16 heads with v a strided view of the latent
   expansion, as the model hands it over): the
   attention kernels K1/K2 in float32 (atol/rtol 2e-5, TF32 off) and
   bfloat16 (3e-2), also (with K1b) at the heads one rank of a 2-way
   model axis takes (qwen2 7/1, granite 8/4, recurrentgemma 5/1); the
   RG-LRU scan K3 in float32 bit for bit (max error
   0, and within 1e-6), also at the training microbatch, on a ragged
   width, strided views, r below one tile and S around the plan's box and
   ring edges, and K3 refusing
   layouts TMA cannot read; K3b, the scan's backward, against its plain
   version in float32 bit for bit on K3's y (held bit for bit too), each
   case launched twice with the same bits: the training microbatch (B 2, S 1024, r 2560) with and without
   h0 and dh_T, S 0 and 1, S around K3b's box and ring edges, a ragged r,
   strided views of dy, and K3b refusing layouts TMA cannot read; K1
   (bf16 and float32) and K3 launched first thing on a fresh thread, bit
   for bit the main thread's launch (the fabric runs bodies on pool and
   router threads); K4, the grouped expert GEMM, against its plain
   version at the MoE models' decode and prefill shapes, with drops, on
   an expert slice and in float32 (bf16 within two ulps of the largest
   output and a 2-norm within 2**-9; its plain version rounds where it
   does), its routing metadata equal, each call captured and replayed
   bit for bit;
4. main: full-width qwen2-0.5b (24 layers, d_model 896, random weights
   from a seed) published to a ``WeightStore`` and served through
   ``ServingEngine``: a cold invoke, a freshened one, a warm one, and a
   generation endpoint decoding 16 tokens; every served step runs as a
   CUDA graph the freshen (or a cold invoke's inline warm-up) captured,
   and a served run checks that the freshened invokes and the freshened
   generation capture nothing inline and that the warm invoke's logits
   and the generated tokens are the eager step's (the step function
   called directly on the instance's params) bit for bit; launch counts
   checked per forward and per decode step, a replay counting the
   launches its graph recorded (a cold invoke: the warm-up's run before
   the capture and the replay); the bfloat16 kernel path compared with
   the reference path, teacher-forced; the served graphs: each one's
   capture seconds and pool bytes, the replayed decode step per token
   (host-synced) and its device idle share from CUDA events
   (``replay_idle``), and a torch.profiler trace of a replayed prefill
   and 4 replayed decode steps (device-busy time, device kernels per
   step; trace in ``build/profile/``); the float32 model held against its
   ``force_reference`` run, teacher-forced (every step's logits within
   1e-3) and served (last-position logits within 1e-3, identical tokens);
5. rgemma: full-width recurrentgemma-2b (26 layers, 18 RG-LRU through K3
   and 8 local-attention through K1/K2 with window 2048; bfloat16)
   served the same way, with its own launch-count window and profiler
   pass, and one profiled prefill of a single prompt of 4096 tokens (18
   K3 launches; its device time and K3's share of it); then a float32
   copy cut to 5 layers (both segment shapes) held against
   ``force_reference``, teacher-forced within 1e-3 with identical tokens,
   at prompt 128 and past the 2048-slot ring's wrap;
6. moe: full-width, uncut granite-moe-1b-a400m (24 ``attn_moe`` layers:
   attention, 16/8 heads at dh 64, through K1/K2, then a 32-expert
   top-8 MoE FFN; bfloat16) served the same way, with its own launch-count
   window (24 K1 per forward, 24 K2 per decode step), the dropped MoE
   assignments of one forward, an ungated bf16 kernel-vs-reference
   comparison (logit diff, share of routing that agreed) and the
   profiler pass; then the float32 gate on a copy
   cut to 4 layers: both dispatches (``einsum``, ``gather``) at prompts
   128 and 256 (two dispatch groups), teacher-forced against
   ``force_reference``;
7. mla: deepseek-v2-lite-16b at full width, cut to 4 layers (the dense
   ``mla`` layer 0 and 3 ``mla_moe`` layers; 64 experts top-6 plus 2
   shared), served the same way (4 K1 per forward, 4 K2 per ``naive``
   decode step at Hkv 16, dh 192, dv 128); its ``absorbed`` decode run
   once to show it launches no K2; then the float32 gate on ``(mla) +
   (mla_moe)``: both dispatches and both decode modes at prompts 128 and
   256.  The float32 gates: logits within 1e-3 at every step whose
   routing agreed in every MoE layer on both paths, identical greedy
   tokens, and no expert choice that flips between the paths where the
   gap between the k-th and (k+1)-th gate was above 1e-5; every flip is
   printed;
8. xlstm: full-width, uncut xlstm-350m (12 ``mlstm`` and 12 ``slstm``
   blocks, d_model 1024; bfloat16) served the same way; its launch-count
   window shows that nothing on this path reaches K1, K2 or K3 (the
   reference is plain jnp here); a profiler pass, and one over a single
   sLSTM layer's prefill (the per-token host loop); then two float32
   gates with TF32 off: the full model on the card against the same
   model on the CPU, teacher-forced over 16 positions, and a copy cut to
   ``(mlstm, slstm)`` whose prefill of 64 tokens and 64 teacher-forced
   decode steps must give a 128-token forward's logits (the chunkwise
   prefill's states handed over to the step recurrence); each within
   1e-3 with identical greedy tokens;
9. dense: the five configurations no other phase serves, at their
   published widths (heads, head dims, d_ff, vocab, window, softcaps,
   activations), bf16, random weights from seed 0: musicgen-medium uncut
   (48 layers, 24/24 heads at dh 64, tanh-GELU), then pixtral-12b (32/8
   at dh 128, ``rope_theta`` 1e6), phi3-medium-14b (40/10) and
   nemotron-4-15b (48/8, squared ReLU, vocab 256000), each cut to 4
   layers, and gemma2-27b cut to 2 (local, global) pairs (32/16 at dh
   128, window 4096, softcaps 50 and 30): each published once and served
   as ``main`` is (its own launch-count window: K1 n per forward, K2 n
   per decode step), with the ungated bf16 kernel-vs-reference comparison
   and a profiler pass, its engines closed and its weights dropped
   before the next; each model's float32 gate at 2 layers (gemma2: one
   local, one global), TF32 off, batch 4 x 128 (every teacher-forced
   step within 1e-3, identical tokens), and for gemma2 also batch 1 x
   4200 with 8 decode steps, past the window on the local layers' 4096-
   slot ring; then the paper's chain: one engine with all five endpoints
   deployed from their published stores and chained, one request walked
   through them with ``freshen_successors=True``, each successor's
   freshen joined before its invoke (every entry freshened, none
   inline), each stage's logits bit for bit its own served run's, the
   freshen bill, the stages' invoke ms and the card's peak memory;
10. fabric: full-width qwen2-0.5b (bf16, batch 4, prompt 128), published
   once, through the fabric: on one scheduler (the thread backend; the
   reference logits of 16 prompts); on two shards of the card behind
   the warmth-aware router (``deploy(shards=2, elastic=True)``,
   ``max_instances=2``): a prediction fired on shard 0 placed by the
   router on warm shard 1, whose next request runs with nothing inline,
   16 concurrent requests, ``scale_shards(3)`` with the new shard
   serving, and ``scale_shards(1)`` draining with 8 requests in flight;
   every logit bit for bit one scheduler's, K1 24 times per forward
   (warm-up forwards counted), no request lost; then out of process, on
   the subprocess and the snapshot backends (``spec_ref`` naming
   ``fabric_endpoint_spec``): a cold invoke, the instance demoted to
   INITIALIZED, a freshen, the freshened invoke (nothing inline) and a
   warm invoke, K1 launched 24 times per forward in the child, logits
   within the bf16 tolerance of the thread backend's with the same
   argmax, and the cold start's parts (spawn or fork, ``import torch``,
   CUDA context, weights, kernel library), the child's memory and no
   process left after ``close``; the phase runs in a process of its own
   under the port's lock sanitizer (``repro_torch.analysis.sanitizer``,
   installed before that process imports the port, so no other phase
   runs with tracked locks): it prints the graph's size and fails on a
   cycle or a violation;
11. launch: the launch layer (``repro_torch.launch.steps``) on a (1, 1)
   mesh over the card (an NCCL group of world size 1): qwen2-0.5b uncut
   in bf16 through the sharded prefill (batch 4 x prompt 128) and 15
   greedy decode steps, against the unsharded ``Model.prefill`` and
   ``decode_step`` (bit for bit, or within 3e-2 with identical tokens,
   which the phase says), K1 24 per prefill and K2 24 per decode step in
   their own windows; the sharded train step, 2 steps of batch 4 x 1024
   in 2 microbatches (K1 132, K1b 48 per step); each sharded step's ms
   beside the unsharded one's; a float32 gate at 2 layers, 2 x 256: the
   loss and every gradient leaf within 1e-4 of the unsharded ones;
12. train: the second entry point, training.  K1's float32 row
   log-sum-exp (written only when asked for) and K1b, the flash-attention
   backward, against their plain versions in float32 and bfloat16 at
   qwen2's training shape (B 4, S 1024, 14/2, dh 64), gemma2's softcap 50
   at dh 128, MLA's dh 192 / dv 128 and recurrentgemma's dh 256 at G 10
   with window 2048 (S 2048, and its training microbatch B 2 x S 1024 in
   both types), and at the edges (ragged S, Sq < Sk with q_offset,
   non-causal, dv > dh, a do with a strided head dimension), each case
   launched twice (bit for bit the same) and profiled once to show that
   bfloat16 ran K1b's tensor-core body and float32 its scalar one; K2
   raising NotImplementedError on CUDA tensors that require grad (a
   decode step is never differentiated); a float32 gate on qwen2-0.5b at full width cut to 2 layers (loss and
   every gradient leaf within 1e-4 of ``force_reference``, then 5
   ``Trainer`` steps on each path, losses within 1e-4 relative); then
   qwen2-0.5b uncut in bfloat16 through ``Trainer``, 10 steps of batch 4
   x 1024 from ``packed_batches`` in 2 microbatches: finite losses that
   fall, its own launch-count window (per step 132 K1, 48 K1b), step ms,
   tokens/s, peak memory, and one profiled step (device idle share, K1b's
   and K1's shares of device time, K1b by device kernel, which must be
   the tensor-core body's; trace in ``build/profile/train``).  The
   RG-LRU scan under grad on the card: its output has a ``grad_fn``, and
   its backward launches K3b once, also with y and h_T reduced into the
   loss (expanded cotangents), its gradients then the plain version's bit
   for bit.  Then recurrentgemma-2b: a float32
   gate at full width cut to ``((rglru, rglru, attn_local), 1),
   ((rglru, rglru), 1)`` with the window cut to 128 at S 256 (loss and
   every gradient leaf within 1e-4 of ``force_reference``, then 5
   ``Trainer`` steps on each path), and the model uncut in bfloat16, 10
   ``Trainer`` steps of batch 4 x 1024 in 2 microbatches, with its own
   launch-count window (per step 88 K3, 36 K3b, 40 K1, 16 K1b), step ms,
   tokens/s, peak memory and one profiled step (idle share, the shares
   of device time of K3b, K3 and K1b; trace in
   ``build/profile/train_rgemma``);
13. rollout: the port's counterparts of the ``examples/`` drivers on the
   card, qwen2-0.5b uncut in bf16, batch 4 x prompt 128.  (a) The
   quickstart's cases at model scale on one endpoint served from a store
   holding v1 (seed 0): a cold invoke; ``freshen(blocking=True)`` then
   an invoke; ``freshen(blocking=False)`` then an invoke that waits for
   the weight load in flight (``FrWait``); a second invoke, a hit; v2,
   trained from v1 by ``examples/train_small``'s body (2 ``Trainer``
   steps of batch 4 x 1024 in 2 microbatches, its own launch window: K1
   132 and K1b 48 a step) and published into the same store, which the
   next invoke finds stale and refetches inline (one more inline on the
   weights entry, the card's peak memory printed); v3, one step further,
   freshened before the invoke, which runs nothing inline.  Each case
   prints its invoke ms, ``timing`` parts, freshen stats and K1 launches
   (24 a forward); the logits of cases 1-4 are the cold invoke's bit for
   bit, and v2's and v3's a fresh endpoint's on that version alone.  (b)
   ``examples/serve_chain``'s pipeline at full width: three uncut
   qwen2-0.5b endpoints (seeds 0-2; the example's stages differ only in
   d_model, which at full width is the published 896 for all three), 8
   requests through ``Batcher``s, each batch one row padded to 4, with
   freshen off, then on: per stage first, p50 and max ms, the wall
   time, the bill, ``latency_summary`` and each pool's counters; every
   request's logits bit for bit the same in both runs, nothing inline
   downstream with freshen on, K1 24 a forward;
14. graphs: the served steps as CUDA graphs beside the eager steps, for
   qwen2-0.5b, recurrentgemma-2b, granite-moe-1b-a400m and xlstm-350m
   uncut and phi3-medium-14b cut to 4 layers (bf16, batch 4, prompt 128,
   cache 256, 16 tokens): the score step (the invoke's execute part,
   logits to the host) and each decode step eager and replayed (host-
   synced medians), every logit of a greedy session bit for bit; each
   graph's warm run, capture-and-instantiate seconds, memory pool bytes
   and the launches it recorded (K1, K2, K3 inside); a replayed decode
   step's device idle share from CUDA events (``replay_idle``);
15. times: each kernel, its plain version, the PyTorch library call and
   the bound, at each served model's shapes (the dense phase's five
   too; gemma2's K1 and K2 with softcap 50, sdpa's without) and a long
   one (K3 also at
   four prompts of 2048 and at the gate's prompt of 2100, with its
   achieved GB/s; K1b at the four training-phase shapes against the
   backward of sdpa; K3b at the training microbatch and at one long
   prompt, with its achieved GB/s and no library call: no single PyTorch
   call computes a reversed linear recurrence); kernel and library each
   timed by CUDA events and on the device alone, and compared device
   time to device time.

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
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("env", "build", "parity", "main", "rgemma", "moe", "mla", "xlstm",
          "dense", "fabric", "launch", "train", "rollout", "graphs", "times")
TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
PEAK_BF16_FLOPS = 989e12          # H100 SXM dense bf16 tensor-core peak
PEAK_F32_FLOPS = 67e12            # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12              # H100 SXM HBM3
MOE_KINDS = ("attn_moe", "mla_moe")
ROUTING_FLIP_MARGIN = 1e-5        # a flip above this gate gap fails
F32_LOGIT_TOL = 1e-3
# phase -> the model its served path runs
PATHS = (("main", "qwen2-0.5b"), ("rgemma", "recurrentgemma-2b"),
         ("moe", "granite-moe-1b-a400m"), ("mla", "deepseek-v2-lite-16b"),
         ("xlstm", "xlstm-350m"))
KERNEL_META = {
    "flash_attention": dict(
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:72"),
    # a mirror of the reference's jnp custom VJP, not of a TPU kernel
    "flash_attention_bwd": dict(
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/models/layers.py:177"),
    "decode_attention": dict(
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:69"),
    "rglru_scan": dict(
        source="src/repro_torch/kernels/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan.py:40"),
    # the VJP of the reference's associative scan, not a TPU kernel
    "rglru_scan_bwd": dict(
        source="src/repro_torch/kernels/csrc/rglru_scan_bwd.cu",
        replaces="src/repro/models/rglru.py:75"),
    # the reference's experts are batched products outside Pallas: K4
    # replaces no TPU kernel
    "moe_grouped": dict(
        source="src/repro_torch/kernels/csrc/moe_grouped.cu",
        replaces="none (src/repro/models/moe.py _expert_ffn, outside Pallas)"),
}


# the kernels the served paths launch; the backward kernels, K1b and
# K3b, run only in training and launch on no served path, and K4 only on
# the MoE models' (the MoE phases count it)
SERVING_KERNELS = ("flash_attention", "decode_attention", "rglru_scan")
NOT_LAUNCHED = {"flash_attention_bwd": 0, "rglru_scan_bwd": 0,
                "moe_grouped": 0}
# K3b's timed shapes: the training microbatch and one long prompt
K3B_SHAPES = (("main", 2, 1024, 2560), ("long", 1, 4096, 2560))
# K1b's device kernels by body: bf16 runs the tensor-core ones, float32
# the scalar ones (with bwd_delta and bwd_reduce for both)
K1B_WGMMA = re.compile(r"flash_bwd_(dkdv|dq)_wgmma_kernel")
K1B_SCALAR = re.compile(r"flash_bwd_(dkdv|dq)_kernel")


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
def phase_build(torch, ops):
    t0 = time.perf_counter()
    ops.LIBRARY.load()
    wall = time.perf_counter() - t0
    log(f"build: {wall:.2f} s wall, nvcc built {ops.LIBRARY.built or 'none'} "
        f"into {ops.LIBRARY.build_dir.relative_to(ROOT)}")
    name, spills, regs = "?", {}, {}
    for line in ops.LIBRARY.build_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = _kernel_name(m.group(1))
        elif line.startswith("=="):
            log(f"  {line.strip()}")
        elif "Used" in line or "spill" in line:
            log(f"  {name}: {line.strip()}")
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                spills[name] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                regs[name] = int(m.group(1))
    bf16 = {k: v for k, v in spills.items() if k.startswith("flash_wgmma")}
    check(len(bf16) > 0 and not any(bf16.values()),
          f"the bf16 flash instantiations spill: {bf16}")
    # K1b's bf16 body: every instantiation logged; none may spill at dh 64
    # (qwen2's training shape), as K1's may not anywhere
    k1b = {k: v for k, v in spills.items() if K1B_WGMMA.match(k)}
    for k in sorted(k1b):
        log(f"  K1b bf16 {k}: {regs.get(k, '?')} registers, {k1b[k]} bytes "
            f"of spills")
    at64 = {k: v for k, v in k1b.items() if "<64," in k}
    check(len(at64) == 2 and not any(at64.values()),
          f"K1b's bf16 instantiations at dh 64 spill: {at64}")
    from repro_torch.kernels import flash_attention as fa
    smem = getattr(ops.LIBRARY.get("flash_attention"), fa.SMEM_BYTES)
    for dh, dv in ((64, 64), (128, 128), (192, 128), (256, 256)):
        log(f"  K1 bf16 up to dh {dh}, dv {dv}: {smem(dh, dv)} bytes of "
            f"dynamic shared memory per block")
    from repro_torch.kernels import flash_attention_bwd as fb
    bwd_smem = getattr(ops.LIBRARY.get("flash_attention_bwd"), fb.SMEM_BYTES)
    for dh, dv in ((64, 64), (128, 128), (192, 128), (256, 256)):
        # which: float32 body's dkdv 0, dq 1; bf16 body's dkdv 2, dq 3
        sizes = [bwd_smem(dh, dv, which) for which in range(4)]
        check(max(sizes) <= 232448, f"K1b at dh {dh}, dv {dv} asks for "
              f"{max(sizes)} bytes of shared memory")
        log(f"  K1b at dh {dh}, dv {dv}: float32 dkdv {sizes[0]}, dq "
            f"{sizes[1]}; bf16 dkdv {sizes[2]}, dq {sizes[3]} bytes of "
            f"dynamic shared memory per block")
    from repro_torch.kernels import rglru_scan as k3
    k3_smem = getattr(ops.LIBRARY.get("rglru_scan"), k3.SMEM_BYTES)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for B, S, r in ((4, 128, 2560), (1, 4096, 2560), (4, 2048, 2560),
                    (1, 2100, 2560)):
        plan = k3.plan_scan(B, S, r, n_sm)
        check(k3_smem(plan.stages) == plan.smem_bytes,
              f"K3 plan {plan}: the kernel asks for {k3_smem(plan.stages)} "
              f"bytes of shared memory")
        log(f"  K3 plan at B {B}, S {S}, r {r}, {n_sm} SMs: {plan.blocks} "
            f"blocks of {plan.channels} channels, {plan.stages} stages of "
            f"{plan.steps} steps, {plan.smem_bytes} bytes of dynamic shared "
            f"memory per block")
    # K3b: both tile widths logged, neither may spill
    k3b_spills = {k: v for k, v in spills.items()
                  if k.startswith("rglru_scan_bwd_kernel")}
    check(len(k3b_spills) == 2 and not any(k3b_spills.values()),
          f"K3b's instantiations spill or are missing: {k3b_spills}")
    for k in sorted(k3b_spills):
        log(f"  K3b {k}: {regs.get(k, '?')} registers, {k3b_spills[k]} "
            f"bytes of spills")
    from repro_torch.kernels import rglru_scan_bwd as k3b
    k3b_smem = getattr(ops.LIBRARY.get("rglru_scan_bwd"), k3b.SMEM_BYTES)
    for _, B, S, r in K3B_SHAPES:
        plan = k3b.plan_scan_bwd(B, S, r, n_sm)
        check(k3b_smem(plan.stages) == plan.smem_bytes,
              f"K3b plan {plan}: the kernel asks for "
              f"{k3b_smem(plan.stages)} bytes of shared memory")
        log(f"  K3b plan at B {B}, S {S}, r {r}, {n_sm} SMs: {plan.blocks} "
            f"blocks of {plan.channels} channels, {plan.stages} stages of "
            f"{plan.steps} steps, {plan.smem_bytes} bytes of dynamic shared "
            f"memory per block")
    from repro_torch.kernels import moe_grouped as k4
    k4_smem = getattr(ops.LIBRARY.get("moe_grouped"), k4.SMEM_BYTES)
    for label, which, K in (("swapped up, d 2048", 0, 2048),
                            ("swapped down, d_ff 1408", 1, 1408),
                            ("128-row up", 2, 2048), ("128-row down", 3, 1408),
                            ("metadata, 64 experts x 16 groups", 4, 64)):
        size = k4_smem(which, K, 16)
        check(size <= 232448, f"K4 {label} asks for {size} bytes of shared "
              f"memory")
        log(f"  K4 {label}: {size} bytes of dynamic shared memory per block")
    k4_spills = {k: v for k, v in spills.items() if "moe_" in k}
    check(len(k4_spills) >= 5, f"K4's device kernels are missing from the "
          f"build log: {sorted(k4_spills)}")
    for k in sorted(k4_spills):
        log(f"  K4 {k}: {regs.get(k, '?')} registers, {k4_spills[k]} bytes "
            f"of spills")
    return wall


def _kernel_name(mangled: str) -> str:
    """``flash_wgmma_kernel<64,64,64,3>`` from a mangled kernel name."""
    m = re.search(r"([a-z]+(?:_[a-z]+)*_kernel)(\w*)", mangled)
    if not m:
        return mangled[:60]
    args = m.group(2)[1:] if m.group(2).startswith("I") else ""
    kind = ["bf16"] if "bfloat16" in args else ["f32"] if args[:1] == "f" else []
    parts = kind + re.findall(r"Li(\d+)E", args)
    return m.group(1) + (f"<{','.join(parts)}>" if parts else "")


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


def _no_tf32(torch):
    """Float32 products at full precision: the parity tolerances and the
    MoE router's gates need it (TF32 keeps 10 mantissa bits, enough to
    flip an expert choice near a tie)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def phase_parity(torch, ops, ref):
    _no_tf32(torch)
    log("parity: torch.backends.cuda.matmul.allow_tf32=False, "
        "torch.backends.cudnn.allow_tf32=False; tolerances f32 2e-5, "
        "bf16 3e-2 (atol and rtol) for K1/K2, 1e-6 for K3 (float32)")
    gen = torch.Generator(device="cuda").manual_seed(1234)
    errs = {k: {"float32": 0.0, "bfloat16": 0.0} for k in SERVING_KERNELS}
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
        # recurrentgemma's attn_local: MQA, 10 query heads, dh 256
        (4, 128, 128, 10, 1, 256, 256, True, 2048, None, 0),   # its main path
        (1, 2100, 2100, 10, 1, 256, 256, True, 2048, None, 0), # window masks
        # the bf16 tensor-core body's other tiles and edges
        (1, 200, 200, 4, 1, 192, 128, True, None, None, 0),    # MLA prefill dims
        (2, 333, 333, 16, 16, 192, 128, True, None, None, 0),  # ragged, MHA
        (1, 100, 100, 10, 1, 256, 256, True, 2048, None, 0),   # Sq not a tile
        (2, 70, 300, 4, 2, 128, 128, True, 200, None, 230),    # q_offset, window
        (1, 128, 128, 2, 1, 64, 128, True, None, None, 0),     # dv > dh
        (1, 1000, 1000, 14, 2, 64, 64, True, None, None, 0),   # many tiles
        # granite's attn_moe prefill: 16/8 heads at dh 64
        (4, 128, 128, 16, 8, 64, 64, True, None, None, 0),
        (4, 256, 256, 16, 8, 64, 64, True, None, None, 0),
        # the dense phase's prefills: phi3 40/10, nemotron 48/8, pixtral
        # 32/8 at dh 128, musicgen 24/24 at dh 64, gemma2's 32/16 at dh
        # 128 with softcap 50 (local: window 4096; its gate's prompt of
        # 4200 runs past the window)
        (4, 128, 128, 40, 10, 128, 128, True, None, None, 0),
        (4, 128, 128, 48, 8, 128, 128, True, None, None, 0),
        (4, 128, 128, 32, 8, 128, 128, True, None, None, 0),
        (4, 128, 128, 24, 24, 64, 64, True, None, None, 0),
        (4, 128, 128, 32, 16, 128, 128, True, 4096, 50.0, 0),
        (4, 128, 128, 32, 16, 128, 128, True, None, 50.0, 0),
        (1, 4200, 4200, 32, 16, 128, 128, True, 4096, 50.0, 0),
    ]
    # MLA prefill: 16/16 heads, dh 192 (nope 128 + rope 64), dv 128; k
    # contiguous, v a view of the (nope + v)-wide latent expansion
    mla_cases = [(4, 128, 16), (4, 256, 16), (1, 333, 16), (2, 64, 16)]
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
        for B, S, H in mla_cases:
            q = _rand(torch, gen, (B, S, H, 192), dtype)
            k = _rand(torch, gen, (B, S, H, 192), dtype)
            v = _rand(torch, gen, (B, S, H, 256), dtype)[..., 128:]
            out = ops.flash_attention(q, k, v, scale=192 ** -0.5)
            torch.cuda.synchronize()
            want = ref.flash_attention_ref(q, k, v, scale=192 ** -0.5)
            e, ok = _err(torch, out, want, name)
            errs["flash_attention"][name] = max(errs["flash_attention"][name], e)
            check(ok, f"flash_attention {name} MLA case {(B, S, H)}: max abs "
                  f"err {e}")
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
        # recurrentgemma: G = 10 (a ragged last warp), dh 256, window 2048
        (4, 256, 10, 1, 256, 2048, None, [128, 131, 140, 143]),  # linear slots
        (1, 2048, 10, 1, 256, 2048, None, [2047, 2048, 2100, 2107]),  # ring
        # split-KV: one (row, head) pair, splits wholly past pos; the ring
        # across split edges at batch 2; the long shape at mixed positions
        (1, 4096, 7, 1, 64, None, None, [0, 63, 64, 4095]),
        (2, 2048, 10, 1, 256, 2048, None, [2047, 2048, 2107]),
        (8, 4096, 14, 2, 64, None, None, [4095, 17, 2048, 4000, 1, 0, 3000, 255]),
        # granite's attn_moe decode: 16/8 heads at dh 64
        (4, 256, 16, 8, 64, None, None, [128, 131, 140, 143]),
        # the dense phase's decode steps (G 4, 6, 4, 1, 2); gemma2's
        # local layers at cache 256 and on the 4096-slot ring past its
        # wrap, its global layers with the softcap alone
        (4, 256, 40, 10, 128, None, None, [128, 131, 140, 143]),
        (4, 256, 48, 8, 128, None, None, [128, 131, 140, 143]),
        (4, 256, 32, 8, 128, None, None, [128, 131, 140, 143]),
        (4, 256, 24, 24, 64, None, None, [128, 131, 140, 143]),
        (4, 256, 32, 16, 128, 4096, 50.0, [128, 131, 140, 143]),
        (1, 4096, 32, 16, 128, 4096, 50.0, [4095, 4096, 4200, 4207]),
        (1, 4224, 32, 16, 128, None, 50.0, [4200, 4207]),
    ]
    # MLA naive decode: 16/16 heads (G 1), dh 192, dv 128, v a view of the
    # latent expansion; (B, S, positions)
    mla_decode_cases = [(4, 256, [128, 131, 140, 143]), (3, 100, [99, 0, 50]),
                        (2, 2048, [2047, 17]), (4, 272, [256, 263, 270, 271])]
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for B, S, Hq, Hkv, dh, window, softcap, positions in decode_cases:
            k = _rand(torch, gen, (B, S, Hkv, dh), dtype)
            v = _rand(torch, gen, (B, S, Hkv, dh), dtype)
            q = _rand(torch, gen, (B, 1, Hq, dh), dtype)
            if positions is None:
                pos_sets = [torch.randint(1, S, (B,), generator=gen,
                                          device="cuda", dtype=torch.int32)]
            elif window == S or len(positions) != B:   # each p, every row
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
        for B, S, positions in mla_decode_cases:
            k = _rand(torch, gen, (B, S, 16, 192), dtype)
            v = _rand(torch, gen, (B, S, 16, 256), dtype)[..., 128:]
            q = _rand(torch, gen, (B, 1, 16, 192), dtype)
            pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
            out = ops.decode_attention(q, k, v, pos, scale=192 ** -0.5)
            torch.cuda.synchronize()
            want = ref.decode_attention_ref(q, k, v, pos, scale=192 ** -0.5)
            e, ok = _err(torch, out, want, name)
            errs["decode_attention"][name] = max(
                errs["decode_attention"][name], e)
            check(ok, f"decode_attention {name} MLA case {(B, S)} pos "
                  f"{positions}: max abs err {e}")
    n_cases = {"flash_attention": f"{len(flash_cases) + len(mla_cases)} "
                                  f"cases x 2 types",
               "decode_attention": f"{len(decode_cases) + len(mla_decode_cases)} "
                                   f"cases x 2 types"}
    n_cases["rglru_scan"] = parity_rglru(torch, ops, ref, gen, errs)
    n_cases["rglru_scan_bwd"] = parity_rglru_bwd(torch, ops, ref, gen, errs)
    n_cases["moe_grouped"] = parity_moe_grouped(torch, ops, ref, gen, errs)
    errs["per_rank"] = parity_per_rank(torch, ops, ref, gen)
    for kname, e in errs.items():
        if kname == "per_rank":
            continue
        log(f"parity {kname}: max abs err f32 {e['float32']:.3e} "
            f"bf16 {_fmt(e['bfloat16'], '.3e')} over {n_cases[kname]}: ok")
    parity_fresh_thread(torch, ops, gen)
    return errs


# K4's cases: (label, T, group, experts, top-k, d, d_ff, capacity factor,
# first expert of the slice, experts in the slice, dtype); deepseek's and
# granite's decode steps and prefills at their widths (their capacity
# drops nothing), a capacity that drops, half the experts as a tensor
# parallel rank holds them, and the float32 body
MOE_CASES = (
    ("deepseek_decode", 4, 512, 64, 6, 2048, 1408, 64 / 6, 0, 64, "bfloat16"),
    ("deepseek_prefill", 8192, 512, 64, 6, 2048, 1408, 64 / 6, 0, 64,
     "bfloat16"),
    ("granite_prefill", 512, 512, 32, 8, 1024, 512, 4.0, 0, 32, "bfloat16"),
    ("granite_decode", 4, 512, 32, 8, 1024, 512, 4.0, 0, 32, "bfloat16"),
    ("drops", 1024, 512, 64, 6, 2048, 1408, 1.25, 0, 64, "bfloat16"),
    ("slice_prefill", 512, 512, 64, 6, 2048, 1408, 64 / 6, 32, 32,
     "bfloat16"),
    ("slice_decode", 4, 512, 64, 6, 2048, 1408, 64 / 6, 32, 32, "bfloat16"),
    ("f32_small", 64, 64, 64, 6, 2048, 1408, 1.25, 0, 64, "float32"),
    ("f32_large", 1024, 512, 32, 8, 1024, 512, 4.0, 0, 32, "float32"),
)


# K4's plain version rounds where K4 rounds (h to bf16 once from float32,
# each k slot's product to x's type), so their bf16 outputs part only
# where the two float32 sums, in different orders, round to neighbours:
# the largest error stays within two bf16 ulps of the largest output
# (2**-6 of max |ref|), and the error's 2-norm within 2**-9 of the
# output's (a rounding's mean relative size); TOL's 3e-2 would pass a
# wrong gate on a few rows of outputs ~0.1 in size
K4_BF16_MAX_TOL = 2.0 ** -6
K4_BF16_L2_TOL = 2.0 ** -9


def _k4_err(torch, out, ref):
    """K4's bf16 output against its plain version: (max abs err, its
    share of max |ref|, relative 2-norm of the error, within both)."""
    out, ref = out.float(), ref.float()
    check(bool(torch.isfinite(out).all()), "kernel output is not finite")
    err = (out - ref).abs()
    e, top = float(err.max()), float(ref.abs().max())
    rel = float(torch.linalg.vector_norm(out - ref)
                / torch.linalg.vector_norm(ref))
    return e, e / top, rel, (e <= K4_BF16_MAX_TOL * top
                             and rel <= K4_BF16_L2_TOL)


def moe_inputs(torch, gen, T, E, k, d, d_ff, E_loc, dtype):
    """Tokens, a router's top-k (softmax gates, not renormalised) and an
    expert slice's stacks at a model's widths, from ``gen``."""
    x = _rand(torch, gen, (T, d), dtype)
    logits = torch.randn((T, E), generator=gen, device="cuda")
    probs, idx = torch.topk(torch.softmax(logits, -1), k, dim=-1)
    w = {n: (torch.randn(shape, generator=gen, device="cuda")
             * shape[1] ** -0.5).to(dtype)
         for n, shape in (("wg_e", (E_loc, d, d_ff)),
                          ("wi_e", (E_loc, d, d_ff)),
                          ("wo_e", (E_loc, d_ff, d)))}
    return x, probs, idx, w


def parity_moe_grouped(torch, ops, ref, gen, errs):
    """K4 against its plain version on the same routing: the metadata
    (each kept assignment's row, the tile list) equal, the output within
    TOL in its type, and one call captured as a CUDA graph (which fails
    on a host sync), its replays bit for bit each other and the eager
    call."""
    from repro_torch.models import moe
    from repro_torch.configs.base import MoEConfig
    from repro_torch.kernels import moe_grouped as k4
    errs["moe_grouped"] = {n: 0.0 for n in BOTH}
    for label, T, gsz, E, k, d, d_ff, factor, e0, E_loc, dname in MOE_CASES:
        dtype = getattr(torch, dname)
        gs = min(gsz, T)
        C = moe._capacity(gs, MoEConfig(n_experts=E, top_k=k, d_ff=d_ff,
                                        capacity_factor=factor))
        x, probs, idx, w = moe_inputs(torch, gen, T, E, k, d, d_ff, E_loc,
                                      dtype)
        pos = moe._positions(idx.reshape(T // gs, gs, k), E).reshape(T, k)
        args = (x, idx, pos, probs, w["wg_e"], w["wi_e"], w["wo_e"])
        kw = dict(capacity=C, group_size=gs, e0=e0)
        n0 = ops.moe_grouped.launches
        out, row_slot, tiles = ops.moe_grouped(*args, **kw, return_plan=True)
        torch.cuda.synchronize()
        check(ops.moe_grouped.launches == n0 + 1, f"K4 {label} not counted")
        want, want_rows, want_tiles = ref.moe_grouped_ref(*args, **kw,
                                                          return_plan=True)
        check(torch.equal(row_slot, want_rows)
              and torch.equal(tiles, want_tiles),
              f"K4 {label}: the routing metadata differs from the plain "
              f"version's")
        if dname == "bfloat16":
            e, scaled, rel, ok = _k4_err(torch, out, want)
            note = (f" ({scaled:.3e} of max |ref|, limit "
                    f"{K4_BF16_MAX_TOL:.3e}; relative 2-norm {rel:.3e}, "
                    f"limit {K4_BF16_L2_TOL:.3e})")
        else:
            (e, ok), note = _err(torch, out, want, dname), ""
        errs["moe_grouped"][dname] = max(errs["moe_grouped"][dname], e)
        check(ok, f"K4 {label}: max abs err {e}{note}")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            ops.moe_grouped(*args, **kw)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static = ops.moe_grouped(*args, **kw)
        graph.replay()
        first = static.clone()
        graph.replay()
        torch.cuda.synchronize()
        check(torch.equal(first, static) and torch.equal(first, out),
              f"K4 {label}: replays differ from each other or the eager "
              f"call")
        tl = k4.tiling(T, k, E_loc)
        live = int((tiles[:, 0] >= 0).sum())
        log(f"parity moe_grouped [{label}] T {T} group {gs} experts {E} "
            f"top-{k} slice {e0}+{E_loc} d {d} d_ff {d_ff} capacity {C} "
            f"{dname}: {tl.rows}-row tiles, {live} of {tl.slots} live, "
            f"{int((row_slot >= 0).sum())} of {T * k} assignments kept; max "
            f"abs err {e:.3e}{note}; metadata equal; replays bit for bit")
    return f"{len(MOE_CASES)} cases"


# the heads one rank of a 2-way model axis hands the kernels: (label, Hq,
# Hkv, dh, window, K1b too)
PER_RANK = (("qwen2", 7, 1, 64, None, True), ("granite", 8, 4, 64, None, True),
            ("rgemma", 5, 1, 256, 2048, False))


def parity_per_rank(torch, ops, ref, gen):
    """K1, K2 and K1b at the per-rank head counts of a 2-way ``model``
    axis (``sharding.boundary`` runs each rank's kernel on its own
    heads): qwen2 7/1 and granite 8/4 at dh 64, recurrentgemma 5/1 at dh
    256 with its window (K1, K2), in both types at TOL; K1b's bfloat16
    gradients also within ``BWD_BF16_SCALED_TOL`` of their largest
    element."""
    errs = {k: {n: 0.0 for n in BOTH} for k in
            ("flash_attention", "decode_attention", "flash_attention_bwd")}
    B, S, L = 4, 128, 256
    for label, Hq, Hkv, dh, window, bwd in PER_RANK:
        kw = dict(causal=True, window=window, softcap=None, scale=None,
                  q_offset=0)
        for name in BOTH:
            dtype = getattr(torch, name)
            q = _rand(torch, gen, (B, S, Hq, dh), dtype)
            k = _rand(torch, gen, (B, S, Hkv, dh), dtype)
            v = _rand(torch, gen, (B, S, Hkv, dh), dtype)
            out, lse = ops.flash_attention.launch_kernel(
                q, k, v, return_lse=True, **kw)
            torch.cuda.synchronize()
            want = ref.flash_attention_ref(q, k, v, **kw)
            e, ok = _err(torch, out, want, name)
            errs["flash_attention"][name] = max(
                errs["flash_attention"][name], e)
            check(ok, f"per-rank K1 {label} {name}: max abs err {e}")
            kc = _rand(torch, gen, (B, L, Hkv, dh), dtype)
            vc = _rand(torch, gen, (B, L, Hkv, dh), dtype)
            qd = _rand(torch, gen, (B, 1, Hq, dh), dtype)
            pos = torch.tensor([128, 131, 140, 255], dtype=torch.int32,
                               device="cuda")
            got = ops.decode_attention(qd, kc, vc, pos, window=window)
            torch.cuda.synchronize()
            e, ok = _err(torch, got, ref.decode_attention_ref(
                qd, kc, vc, pos, window=window), name)
            errs["decode_attention"][name] = max(
                errs["decode_attention"][name], e)
            check(ok, f"per-rank K2 {label} {name}: max abs err {e}")
            if not bwd:
                continue
            do = _rand(torch, gen, (B, S, Hq, dh), dtype)
            grads = ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
            torch.cuda.synchronize()
            wants = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
            for gname, a, b in zip(("dq", "dk", "dv"), grads, wants):
                e, ok = _err(torch, a, b, name)
                errs["flash_attention_bwd"][name] = max(
                    errs["flash_attention_bwd"][name], e)
                check(ok, f"per-rank K1b {label} {name} {gname}: max abs "
                      f"err {e}")
                scaled = e / max(float(b.float().abs().max()), 1e-30)
                check(name != "bfloat16" or scaled <= BWD_BF16_SCALED_TOL,
                      f"per-rank K1b {label} bf16 {gname}: {scaled:.3e}")
    log("parity per rank (a 2-way model axis: qwen2 7/1, granite 8/4 at dh "
        "64, recurrentgemma 5/1 at dh 256): " + ", ".join(
            f"{k} f32 {e['float32']:.3e} bf16 {e['bfloat16']:.3e}"
            for k, e in errs.items()) + ": ok")
    return errs


def parity_fresh_thread(torch, ops, gen):
    """K1 (bf16 and float32) and K3 launched from a fresh thread whose
    first CUDA work is that launch, as a pool or router thread of the
    fabric may make it, on inputs made on the main thread: bit for bit
    the main thread's result.  ``cuTensorMapEncodeTiled`` fails in a
    thread with no current context, so each launch makes a runtime call
    first."""
    import threading
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (_rand(torch, gen, (4, 128, h, 64), dtype)
                   for h in (14, 2, 2))
        cases.append((f"flash_attention {str(dtype).split('.')[-1]}",
                      lambda q=q, k=k, v=v: ops.flash_attention(q, k, v)))
    a = torch.sigmoid(_rand(torch, gen, (4, 128, 2560), torch.float32))
    b = _rand(torch, gen, (4, 128, 2560), torch.float32)
    cases.append(("rglru_scan float32", lambda: ops.rglru_scan(a, b)[0]))
    for name, launch in cases:
        want = launch()
        torch.cuda.synchronize()
        got: dict = {}

        def run():
            try:
                got["out"] = launch()
                torch.cuda.synchronize()
            except BaseException as e:               # noqa: BLE001
                got["error"] = e

        th = threading.Thread(target=run, name=f"fresh-{name}")
        th.start()
        th.join(timeout=120)
        check(not th.is_alive(), f"{name} on a fresh thread did not return")
        check("error" not in got,
              f"{name} on a fresh thread raised {got.get('error')!r}")
        check(torch.equal(got["out"], want),
              f"{name} on a fresh thread differs from the main thread's")
    log(f"parity fresh thread: {', '.join(n for n, _ in cases)} launched "
        f"first thing on a new thread, bit for bit the main thread's")


def _fmt(x, spec):
    return "n/a" if x is None else format(x, spec)


def parity_rglru(torch, ops, ref, gen, errs):
    """K3 against its plain version, float32 only (the scan's type): bit
    for bit (max error 0) and, as before, within atol/rtol 1e-6.  The
    sweep of tests/test_kernels.py with and without h0, a ragged r,
    strided views, the main, training and long shapes, and the edges of
    the plan
    (``rglru_scan.plan_scan``): S around one box and around the ring's
    depth, the float32 gate's prompt 2100, four long prompts, and r below
    one tile."""
    from repro_torch.kernels import rglru_scan as kmod
    tol = 1e-6
    errs["rglru_scan"] = {"float32": 0.0, "bfloat16": None}
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    # (B, S, r, h0, layout): "contig", "channels" (a channel-stride view
    # of a 2r-wide tensor) or "batch" (rows and steps swapped: an (S, B, r)
    # tensor read through its strides)
    cases = [(1, 64, 256, True, "contig"), (2, 128, 512, True, "contig"),
             (3, 200, 384, True, "contig"), (1, 64, 256, False, "contig"),
             (2, 128, 512, False, "contig"), (3, 200, 384, False, "contig"),
             (2, 77, 2500, True, "contig"),             # ragged r and S
             (2, 50, 320, True, "channels"),            # strided views
             (4, 128, 2560, False, "contig"),           # main path
             (2, 1024, 2560, False, "contig"),          # training microbatch
             (1, 4096, 2560, True, "contig"),           # long, with h0
             (1, 2100, 2560, False, "contig"),          # the float32 gate's
             (4, 2048, 2560, False, "contig"),          # four long prompts
             (1, 300, 8, True, "contig"),               # r below one tile
             (2, 1, 64, True, "contig"),                # one step
             (3, 90, 256, True, "batch")]               # rows through strides
    for B, r in ((1, 2560), (4, 2560), (2, 100)):       # box and ring edges
        plan = kmod.plan_scan(B, 1 << 20, r, n_sm)
        for S in (plan.steps - 1, plan.steps, plan.steps + 1,
                  plan.stages * plan.steps - 1, plan.stages * plan.steps,
                  plan.stages * plan.steps + 1):
            cases.append((B, S, r, S % 2 == 0, "contig"))
    for B, S, r, with_h0, layout in cases:
        width = 2 * r if layout == "channels" else r
        if layout == "batch":
            a = torch.sigmoid(_rand(torch, gen, (S, B, r),
                                    torch.float32)).transpose(0, 1)
            b = _rand(torch, gen, (S, B, r), torch.float32).transpose(0, 1)
        else:
            a = torch.sigmoid(_rand(torch, gen, (B, S, width),
                                    torch.float32))[..., :r]
            b = _rand(torch, gen, (B, S, width), torch.float32)[..., :r]
        h0 = (_rand(torch, gen, (B, width), torch.float32)[:, :r]
              if with_h0 else None)
        y, hT = ops.rglru_scan(a, b, h0)
        torch.cuda.synchronize()
        wy, wh = ref.rglru_scan_ref(a, b, h0)
        case = (B, S, r, with_h0, layout)
        for got, want in ((y, wy), (hT, wh)):
            check(bool(torch.isfinite(got).all()), "K3 output is not finite")
            err = (got - want).abs()
            e = float(err.max()) if err.numel() else 0.0
            errs["rglru_scan"]["float32"] = max(errs["rglru_scan"]["float32"], e)
            check(bool((err <= tol + tol * want.abs()).all()),
                  f"rglru_scan case {case}: max abs err {e}")
            check(torch.equal(got, want),
                  f"rglru_scan case {case}: not bit for bit (max abs err {e})")
    a = torch.zeros((2, 16, 12), device="cuda")
    flat = torch.zeros(2 * 16 * 12 + 1, device="cuda")
    for bad, why in ((a.transpose(1, 2), "a non-contiguous channel dimension"),
                     (a[..., :10], "r % 4 != 0"),
                     (flat[1:].view(2, 16, 12), "a misaligned base"),
                     (torch.zeros((2, 16, 10), device="cuda")[..., :8],
                      "a 40-byte step stride")):
        try:
            ops.rglru_scan(bad, bad)
        except ValueError:
            pass
        else:
            raise SmokeFailure(f"K3 took {why}")
    return f"{len(cases)} cases, float32, bit for bit"


def parity_rglru_bwd(torch, ops, ref, gen, errs):
    """K3b against its plain version on the same a, y (K3's output, itself
    held bit for bit against its plain version), h0, dy and dh_T, float32
    only: bit for bit (max error 0), and a second launch on the same
    inputs gives the same bits.  The training
    microbatch with and without h0 and dh_T, S 0 and 1, a ragged r, r
    below one tile, one long prompt, strided views of dy (a channel-stride
    view, and rows and steps swapped), every input a view, and S around
    the plan's box and ring edges (``rglru_scan_bwd.plan_scan_bwd``)."""
    from repro_torch.kernels import rglru_scan_bwd as kmod
    errs["rglru_scan_bwd"] = {"float32": 0.0, "bfloat16": None}
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    # (B, S, r, h0, dhT, layout): "contig"; "dy_view" (dy a channel-stride
    # view of a 2r-wide tensor); "dy_batch" (dy an (S, B, r) tensor read
    # through its strides); "views" (a, y and dy channel-stride views)
    cases = [(2, 1024, 2560, h0, dhT, "contig")          # the microbatch
             for h0 in (True, False) for dhT in (True, False)]
    cases += [(2, 0, 64, True, True, "contig"), (2, 0, 64, True, False,
                                                  "contig"),
              (2, 0, 64, False, False, "contig"),         # no step
              (2, 1, 64, True, True, "contig"), (3, 1, 256, False, False,
                                                  "contig"),
              (2, 77, 2500, True, True, "contig"),        # ragged r and S
              (3, 70, 36, False, True, "contig"),
              (1, 300, 8, True, False, "contig"),         # r below one tile
              (1, 4096, 2560, True, True, "contig"),      # long, with h0
              (2, 50, 320, True, True, "dy_view"),        # strided dy
              (3, 90, 256, False, True, "dy_batch"),
              (2, 130, 320, True, False, "views")]
    for B, r in ((2, 2560), (1, 2560), (2, 100)):        # box and ring edges
        plan = kmod.plan_scan_bwd(B, 1 << 20, r, n_sm)
        for S in (plan.steps - 1, plan.steps, plan.steps + 1,
                  plan.stages * plan.steps - 1, plan.stages * plan.steps,
                  plan.stages * plan.steps + 1):
            cases.append((B, S, r, S % 2 == 0, S % 3 == 0, "contig"))

    def make(B, S, r, wide, fn=lambda t: t):
        return fn(_rand(torch, gen, (B, S, 2 * r if wide else r),
                        torch.float32))[..., :r]
    for B, S, r, with_h0, with_dhT, layout in cases:
        views = layout == "views"
        a = make(B, S, r, views, torch.sigmoid)
        b = make(B, S, r, False)
        h0 = _rand(torch, gen, (B, r), torch.float32) if with_h0 else None
        dhT = _rand(torch, gen, (B, r), torch.float32) if with_dhT else None
        y_k, _ = ops.rglru_scan.launch_kernel(a, b, h0)
        check(torch.equal(y_k, ref.rglru_scan_ref(a, b, h0)[0]),
              f"K3 y under rglru_scan_bwd case {(B, S, r, with_h0)}: not "
              f"bit for bit")
        y = make(B, S, r, True) if views else y_k
        if views:
            y.copy_(y_k)
        if layout == "dy_batch":
            dy = _rand(torch, gen, (S, B, r), torch.float32).transpose(0, 1)
        else:
            dy = make(B, S, r, layout in ("dy_view", "views"))
        got = ops.rglru_scan_bwd(a, y, h0, dy, dhT)
        torch.cuda.synchronize()
        again = ops.rglru_scan_bwd(a, y, h0, dy, dhT)
        want = ref.rglru_scan_bwd_ref(a, y, h0, dy, dhT)
        case = (B, S, r, with_h0, with_dhT, layout)
        check((got[2] is None) == (h0 is None) == (want[2] is None),
              f"rglru_scan_bwd case {case}: dh0 {got[2] is None}")
        for name, g, g2, w in zip(("da", "db", "dh0"), got, again, want):
            if w is None:
                continue
            check(bool(torch.isfinite(g).all()), f"K3b {name} is not finite")
            err = (g - w).abs()
            e = float(err.max()) if err.numel() else 0.0
            errs["rglru_scan_bwd"]["float32"] = max(
                errs["rglru_scan_bwd"]["float32"], e)
            check(torch.equal(g, w), f"rglru_scan_bwd case {case} {name}: "
                  f"not bit for bit (max abs err {e})")
            check(torch.equal(g, g2), f"rglru_scan_bwd case {case} {name}: "
                  f"a second launch gave other bits")
    z = torch.zeros((2, 16, 12), device="cuda")
    flat = torch.zeros(2 * 16 * 12 + 1, device="cuda")
    for bad, why in ((z.transpose(1, 2).contiguous().transpose(1, 2),
                      "a non-contiguous channel dimension"),
                     (z[..., :10], "r % 4 != 0"),
                     (flat[1:].view(2, 16, 12), "a misaligned base"),
                     (torch.zeros((2, 16, 10), device="cuda")[..., :8],
                      "a 40-byte step stride")):
        ok = torch.zeros(bad.shape, device="cuda")
        for args in ((bad, ok, ok), (ok, bad, ok), (ok, ok, bad)):
            try:
                ops.rglru_scan_bwd(args[0], args[1], None, args[2])
            except ValueError:
                pass
            else:
                raise SmokeFailure(f"K3b took {why}")
    return f"{len(cases)} cases, float32, bit for bit, 2 launches each"


# ---------------------------------------------------------------------------
# phases 4 and 5: the served paths
def _counts(ops):
    return {op.name: op.launches for op in ops.KERNELS}


def _delta(before, after):
    return {k: after[k] - before[k] for k in after}


def _times(counts, n):
    return {k: n * v for k, v in counts.items()}


def gen_spec(ep, name, n_tok, max_len):
    """A generation function on ``ep``'s plan plus its session entries,
    the session's steps captured against its cache among them."""
    from repro_torch.core import FunctionSpec

    def plan_factory(rt):
        base = ep.build_plan(rt)
        base.entries.extend(ep.session_plan_entries(max_len, rt))
        return base

    def code(ctx, args):
        return ep.generate(ctx, args["tokens"], n_steps=n_tok,
                           max_len=max_len, plan_offset=3)
    return FunctionSpec(name, code, plan_factory=plan_factory, app="serving")


def serve(np, ops, cfg_, store, name, tag, prompt, engines, *, max_len,
          n_tok, trace_dir=None):
    """Through ``ServingEngine`` on the card: a cold invoke, a freshened
    one, a warm one, and a generation of ``n_tok`` tokens from a
    freshened session cache; then the served graphs themselves
    (``served_graphs``: capture seconds, pool bytes, the replayed decode
    step's ms and idle share, with ``trace_dir`` the profiler pass).
    Every engine goes into ``engines`` for the caller to close."""
    from repro_torch.serving import (Executor, ModelEndpoint, ServingEngine)
    B, S = prompt.shape
    res = {}
    eng_cold = ServingEngine()
    engines.append(eng_cold)
    rt_cold = eng_cold.deploy(ModelEndpoint(
        name, cfg_, store, Executor(), batch_size=B, seq_len=S,
        device="cuda"))
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
                       seq_len=S, device="cuda")
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
    for label, r in (("freshened", fresh), ("warm", warm)):
        check("capture" not in r["timing"],
              f"{tag} {label} invoke captured inline: {r['timing']}")
    res["logits"] = warm["logits"]

    rt_gen = eng.scheduler.register(
        gen_spec(ep, f"{name}/generate", n_tok, max_len))
    rt_gen.init()
    rt_gen.freshen(blocking=True)
    st = rt_gen.fr_state.stats()
    check(st["inline"] == 0 and st["freshened"] == 6,
          f"{tag} generation freshen left {st}")
    captures = _captures(ep)
    c0 = _counts(ops)
    t0 = time.perf_counter()
    tokens = eng.invoke(f"{name}/generate", prompt, freshen_successors=False)
    res["generate_ms"] = (time.perf_counter() - t0) * 1e3
    res["generate_launches"] = _delta(c0, _counts(ops))
    check(_captures(ep) == captures and rt_gen.fr_state.stats()["inline"] == 0,
          f"{tag} the freshened generation captured inline")
    check(len(tokens) == n_tok and all(0 <= t < cfg_.vocab_size
                                       for t in tokens),
          f"{tag} generated {tokens}")
    res["tokens"] = tokens
    with uncounted(ops):
        eager_check(np, ep, rt, prompt, res, tag, max_len=max_len,
                    n_tok=n_tok)
        res["graphs"] = served_graphs(rt, rt_gen, prompt, tag, n_tok=n_tok,
                                      trace_dir=trace_dir)
    res["profile"] = res["graphs"].pop("profile", {})
    return res


def served_graphs(rt, rt_gen, prompt, tag, *, n_tok, trace_dir):
    """The served path's own graphs, driven as the engine drives them:
    the score step its warm-up entry holds and the prefill and decode
    steps its generation's session entry holds.  Each one's warm run,
    capture seconds and pool bytes; a greedy session of ``n_tok`` tokens
    on them (each decode step host-synced and timed: the per-token
    figure); the replayed decode step's idle share from CUDA events
    (``replay_idle``); with ``trace_dir`` the profiler pass
    (``profile_steps``) over a replayed prefill and 4 replayed decode
    steps."""
    import threading
    import torch
    from repro_torch.serving.engine import _entry_index
    score = rt.fr_state.entries[_entry_index(rt, "warmup")].result.step
    pre, dec = rt_gen.fr_state.entries[
        _entry_index(rt_gen, "session_graphs")].result
    out = {}
    for name, g in (("score", score), ("prefill", pre), ("decode", dec)):
        check(g.graph is not None, f"{tag} {name} step is not a graph")
        out[name] = dict(warm_s=g.warm_seconds, capture_s=g.capture_seconds,
                         pool_bytes=pool_bytes(torch, g.graph),
                         launches=dict(g.launches), moe_rows=g.moe_rows)
    toks = torch.as_tensor(prompt, device=score.compiled.device)
    _, _, ms, (tok, pos) = greedy_session(torch, pre, dec, toks, n_tok)
    out["decode_ms"] = _median(ms)
    out["decode_idle"], out["decode_busy_ms"], out["decode_period_ms"] = \
        replay_idle(torch, dec, tok, pos)
    out["threads"] = threading.active_count()
    log(f"{tag} replayed decode step (per token) {out['decode_ms']:.3f} ms "
        f"host-synced; device idle share {out['decode_idle']:.4f} from CUDA "
        f"events (busy {out['decode_busy_ms']:.4f} ms of a "
        f"{out['decode_period_ms']:.4f} ms step, {out['threads']} threads "
        f"alive); "
        + ", ".join(f"{k} warm run {out[k]['warm_s']:.3f} s, capture "
                    f"{out[k]['capture_s']:.3f} s, pool {_mib(out[k])}"
                    for k in ("score", "prefill", "decode")))
    if trace_dir is not None:
        out["profile"] = profile_steps(torch, pre, dec, toks, trace_dir)
    return out


def _served_line(r):
    """A served path's figures: the invokes, the generation and its
    replayed decode step, the eager step's time in brackets."""
    g, prof = r["graphs"], r["profile"]
    return (
        f"cold invoke {r['cold_ms']:.3f} ms, freshened invoke "
        f"{r['freshened_ms']:.3f} ms, warm invoke {r['warm_ms']:.3f} ms, "
        f"generate 16 tokens {r['generate_ms']:.3f} ms, decode step (per "
        f"token, batch 4) replayed {g['decode_ms']:.3f} ms [eager "
        f"{r['decode_step_ms']:.3f} ms], replayed decode device idle share "
        f"{g['decode_idle']:.4f} from CUDA events "
        f"({prof.get('decode_idle_share', 'not measured')} on the host "
        f"clock under the profiler, "
        f"{prof.get('decode_kernels_per_step', 'not measured')} device "
        f"events per step), capture s score {g['score']['capture_s']:.3f} "
        f"prefill {g['prefill']['capture_s']:.3f} decode "
        f"{g['decode']['capture_s']:.3f}, pool score {_mib(g['score'])} "
        f"prefill {_mib(g['prefill'])} decode {_mib(g['decode'])}")


def _mib(g):
    pb = g["pool_bytes"]
    return "not measured" if pb is None else f"{pb / 2**20:.1f} MiB"


def _captures(ep):
    return sum(len(v) for v in ep.executor.capture_seconds.values())


@contextlib.contextmanager
def uncounted(ops):
    """Launches inside the block (the eager steps the replays are held
    against) are not the path's: the counts go back to what they were."""
    saved = _counts(ops)
    try:
        yield
    finally:
        for op in ops.KERNELS:
            with op._count_lock:
                op.launches = saved[op.name]


def eager_check(np, ep, rt, prompt, res, tag, *, max_len, n_tok):
    """The served path's replays against the eager step on the same
    params and inputs: the warm invoke's logits and the generated tokens,
    bit for bit."""
    import torch
    from repro_torch.serving.engine import _to_numpy
    params = rt.fr_state.entries[0].result      # the instance's own
    dev = ep.device
    toks = torch.as_tensor(prompt, device=dev)
    with torch.no_grad():
        logits = _to_numpy(ep._score_fn(dev)(params, toks))
        model = ep.model_for(dev)
        B, S = toks.shape
        cache = model.init_cache(B, max_len)
        step, cache = model.prefill(params, toks, max_len=max_len,
                                    cache=cache)
        tok = torch.argmax(step[:, -1:], -1).to(torch.int32)
        tokens = [int(tok[0, 0])]
        pos = torch.full((B,), S, dtype=torch.int32, device=dev)
        for _ in range(n_tok - 1):
            step, cache = model.decode_step(params, cache, tok, pos)
            tok = torch.argmax(step[:, -1:], -1).to(torch.int32)
            pos = pos + 1
            tokens.append(int(tok[0, 0]))
        del cache
    diff = float(np.abs(logits - res["logits"]).max())
    res["eager_logit_diff"] = diff
    res["eager_tokens_equal"] = tokens == res["tokens"]
    log(f"{tag} replay vs eager step: warm invoke logits max |diff| "
        f"{diff:.3e} (bit for bit {diff == 0.0}), generated tokens equal "
        f"{res['eager_tokens_equal']}")
    check(np.array_equal(logits, res["logits"]),
          f"{tag} replayed logits differ from the eager step's by {diff}")
    check(res["eager_tokens_equal"],
          f"{tag} replayed tokens {res['tokens']} != eager {tokens}")


def check_launches(res, per_fwd, per_step, n_tok, tag):
    """A cold invoke is the warm-up forward on zeros plus the request's;
    a generation is one prefill forward and n_tok - 1 decode steps."""
    check(res["cold_launches"] == _times(per_fwd, 2),
          f"{tag} cold invoke launches {res['cold_launches']}")
    check(res["freshened_launches"] == per_fwd,
          f"{tag} freshened invoke launches {res['freshened_launches']}")
    want = {k: per_fwd[k] + (n_tok - 1) * per_step[k] for k in per_fwd}
    check(res["generate_launches"] == want,
          f"{tag} generation launches {res['generate_launches']} != {want}")


def run_steps(torch, ops, model, params, toks, max_len, n_tok, *,
              reference, feed=None):
    """Prefill, then n_tok - 1 decode steps; with ``feed`` the tokens are
    those of an earlier run (teacher forcing).  Returns (each position's
    logits, the tokens fed, each decode step's ms)."""
    B, S = toks.shape
    ctx = ops.force_reference() if reference else contextlib.nullcontext()
    logits_steps, step_ms, fed = [], [], []
    with ctx, torch.no_grad():
        cache = model.init_cache(B, max_len)
        logits, cache = model.prefill(params, toks, max_len=max_len,
                                      cache=cache)
        logits_steps.append(logits.float())
        tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
        pos = torch.full((B,), S, dtype=torch.int32, device=toks.device)
        for i in range(n_tok - 1):
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


def compare(torch, k_logits, r_logits, tag):
    """(max |logit diff|, greedy agreement, positions x rows)."""
    check(all(bool(torch.isfinite(a).all()) for a in k_logits),
          f"{tag} teacher-forced logits not finite")
    diff = max(float((a - b).abs().max()) for a, b in zip(k_logits, r_logits))
    agree = sum(int((a.argmax(-1) == b.argmax(-1)).sum())
                for a, b in zip(k_logits, r_logits))
    return diff, agree, sum(a.shape[0] for a in k_logits)


def kernel_vs_reference(torch, ops, model, params, toks, max_len, n_tok):
    """The kernel path, then the reference path fed the kernel path's
    tokens: (max |logit diff|, agreement, total, kernel and reference
    decode-step medians in ms)."""
    k_logits, fed, k_ms = run_steps(torch, ops, model, params, toks, max_len,
                                    n_tok, reference=False)
    r_logits, _, r_ms = run_steps(torch, ops, model, params, toks, max_len,
                                  n_tok, reference=True, feed=fed)
    diff, agree, total = compare(torch, k_logits, r_logits, "teacher-forced")
    return diff, agree, total, _median(k_ms), _median(r_ms)


def _median(xs):
    return sorted(xs)[len(xs) // 2] if xs else float("nan")


def _publish(store, name, params):
    t0 = time.perf_counter()
    store.publish(name, params)
    wall = time.perf_counter() - t0
    log(f"published {name}: {store.nbytes(name) / 1e9:.3f} GB in "
        f"{wall:.2f} s")
    return wall


def _log_served(tag, res, n_tok, launches):
    log(f"{tag}: cold invoke {res['cold_ms']:.1f} ms (timing "
        f"{json.dumps({k: round(v * 1e3, 2) for k, v in res['cold_timing'].items()})} ms), "
        f"freshened invoke {res['freshened_ms']:.1f} ms, warm invoke "
        f"{res['warm_ms']:.1f} ms, generate {n_tok} tokens "
        f"{res['generate_ms']:.1f} ms; launches {launches}")
    log(f"{tag}: tokens {res['tokens']}")


def phase_main(torch, np, ops, tmp_root, engines):
    """Full-width qwen2-0.5b on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import make_model
    from repro_torch.serving import WeightStore

    cfg = get_config("qwen2-0.5b")
    n_layers = cfg.n_layers
    B, S, MAX_LEN, N_TOK = 4, 128, 256, 16
    log(f"main: {cfg.name} full width: {n_layers} layers, d_model "
        f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, head_dim "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}, {cfg.param_count() / 1e6:.1f} M params; batch {B}, "
        f"prompt {S}, cache {MAX_LEN}, {N_TOK} tokens")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(B, S),
                                               dtype=np.int32)
    out: dict = {}

    # ---- bf16 main path: through the kernels -------------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = make_model(cfg, device="cuda")
    params = model.init(gen)
    store = WeightStore(tempfile.mkdtemp(dir=tmp_root, prefix="weights-"))
    out["publish_s"] = _publish(store, "qwen2", params)

    ops.reset_launches()                      # the main path's run starts
    bf = serve(np, ops, cfg, store, "qwen2", "bf16", prompt, engines,
               max_len=MAX_LEN, n_tok=N_TOK,
               trace_dir=ROOT / "build" / "profile" / "qwen2")
    out["launches"] = _counts(ops)            # ... and ends here
    check_launches(bf, {"flash_attention": n_layers, "decode_attention": 0,
                        "rglru_scan": 0, **NOT_LAUNCHED},
                   {"flash_attention": 0, "decode_attention": n_layers,
                    "rglru_scan": 0, **NOT_LAUNCHED}, N_TOK, "qwen2 bf16")
    check(out["launches"]["flash_attention"] > 0
          and out["launches"]["decode_attention"] > 0,
          f"a kernel was not launched on the main path: {out['launches']}")
    _log_served("main bf16", bf, N_TOK, out["launches"])
    out.update({k: bf[k] for k in ("cold_ms", "freshened_ms", "warm_ms",
                                   "generate_ms", "graphs", "profile")})

    # ---- bf16: kernel path vs reference path, teacher-forced ---------------
    toks = torch.as_tensor(prompt, device="cuda")
    diff, agree, total, k_ms, r_ms = kernel_vs_reference(
        torch, ops, model, params, toks, MAX_LEN, N_TOK)
    out["bf16_teacher_forced"] = {"max_logit_diff": diff,
                                  "greedy_agree": agree, "of": total}
    out["decode_step_ms"], out["decode_step_ms_reference"] = k_ms, r_ms
    log(f"main bf16 kernel vs reference path, teacher-forced over "
        f"{N_TOK} positions x {B} rows: max |logit diff| {diff:.4e}, "
        f"greedy agreement {agree}/{total}; decode step median "
        f"{k_ms:.2f} ms (reference path {r_ms:.2f} ms)")
    del params, model

    # ---- float32 parity: kernel path vs force_reference --------------------
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(0)
    model32 = make_model(cfg32, device="cuda")
    params32 = model32.init(gen)
    store.publish("qwen2f32", params32)
    # every decode step's logits, teacher-forced: this is where K2 shows
    diff32, agree32, total32, _, _ = kernel_vs_reference(
        torch, ops, model32, params32, toks, MAX_LEN, N_TOK)
    del params32, model32
    out["f32_teacher_forced"] = {"max_logit_diff": diff32,
                                 "greedy_agree": agree32, "of": total32}
    log(f"main f32 kernel vs reference path, teacher-forced over {N_TOK} "
        f"positions x {B} rows: max |logit diff| {diff32:.3e} (limit 1e-3), "
        f"greedy agreement {agree32}/{total32}")
    check(diff32 <= 1e-3, f"f32 teacher-forced logits differ by {diff32}")
    k32 = serve(np, ops, cfg32, store, "qwen2f32", "f32 kernels", prompt,
                engines, max_len=MAX_LEN, n_tok=N_TOK)
    c0 = _counts(ops)
    with ops.force_reference():
        r32 = serve(np, ops, cfg32, store, "qwen2f32", "f32 reference",
                    prompt, engines, max_len=MAX_LEN, n_tok=N_TOK)
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


def phase_rgemma(torch, np, ops, tmp_root, engines):
    """Full-width recurrentgemma-2b on the card: RG-LRU prefill through K3,
    local attention through K1/K2 (window 2048)."""
    from repro_torch.configs import get_config
    from repro_torch.models import make_model
    from repro_torch.serving import WeightStore

    cfg = get_config("recurrentgemma-2b")
    kinds = cfg.layer_kinds
    n_attn, n_rec = kinds.count("attn_local"), kinds.count("rglru")
    B, S, MAX_LEN, N_TOK = 4, 128, 256, 16
    log(f"rgemma: {cfg.name} full width, not cut: {cfg.n_layers} layers "
        f"({n_rec} rglru, {n_attn} attn_local, window {cfg.window_size}), "
        f"d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, "
        f"head_dim {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, d_rnn {cfg.rglru.d_rnn}, {cfg.dtype}, "
        f"{cfg.param_count() / 1e9:.3f} B params; batch {B}, prompt {S}, "
        f"cache {MAX_LEN}, {N_TOK} tokens")
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(B, S),
                                               dtype=np.int32)
    toks = torch.as_tensor(prompt, device="cuda")
    out: dict = {}

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = make_model(cfg, device="cuda")
    params = model.init(gen)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    store = WeightStore(tempfile.mkdtemp(dir=tmp_root, prefix="weights-"))
    out["publish_s"] = _publish(store, "rgemma", params)

    ops.reset_launches()                      # this path's run starts
    bf = serve(np, ops, cfg, store, "rgemma", "rgemma bf16", prompt, engines,
               max_len=MAX_LEN, n_tok=N_TOK,
               trace_dir=ROOT / "build" / "profile" / "rgemma")
    out["launches"] = _counts(ops)            # ... and ends here
    check_launches(bf, {"flash_attention": n_attn, "decode_attention": 0,
                        "rglru_scan": n_rec, **NOT_LAUNCHED},
                   {"flash_attention": 0, "decode_attention": n_attn,
                    "rglru_scan": 0, **NOT_LAUNCHED}, N_TOK, "rgemma bf16")
    check(all(out["launches"][k] > 0 for k in SERVING_KERNELS),
          f"a kernel was not launched on the rgemma path: {out['launches']}")
    _log_served("rgemma bf16", bf, N_TOK, out["launches"])
    out.update({k: bf[k] for k in ("cold_ms", "freshened_ms", "warm_ms",
                                   "generate_ms", "cold_timing", "graphs",
                                   "profile")})

    diff, agree, total, k_ms, r_ms = kernel_vs_reference(
        torch, ops, model, params, toks, MAX_LEN, N_TOK)
    out["bf16_teacher_forced"] = {"max_logit_diff": diff,
                                  "greedy_agree": agree, "of": total}
    out["decode_step_ms"], out["decode_step_ms_reference"] = k_ms, r_ms
    log(f"rgemma bf16 kernel vs reference path, teacher-forced over {N_TOK} "
        f"positions x {B} rows: max |logit diff| {diff:.4e}, greedy "
        f"agreement {agree}/{total}; decode step median {k_ms:.2f} ms "
        f"(reference path {r_ms:.2f} ms)")
    out["long_prefill"] = profile_prefill(
        torch, np, ops, model, params, cfg, n_rec,
        ROOT / "build" / "profile" / "rgemma_long")
    del params, model
    torch.cuda.empty_cache()

    # ---- float32 gate: full width, depth cut to both segment shapes --------
    cfg32 = dataclasses.replace(
        cfg, dtype="float32", n_layers=5,
        segments=((("rglru", "rglru", "attn_local"), 1),
                  (("rglru", "rglru"), 1)))
    log(f"rgemma f32 gate: depth cut from {cfg.n_layers} to "
        f"{cfg32.n_layers} layers, segments {cfg32.segments} (both segment "
        f"shapes of the full model); widths as published")
    model32 = make_model(cfg32, device="cuda")
    params32 = model32.init(torch.Generator(device="cuda").manual_seed(0))
    gates = {}
    long_prompt = np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(1, 2100), dtype=np.int32)
    for label, p, max_len, n_tok in (
            ("prompt 128", toks, MAX_LEN, N_TOK),
            ("past the wrap", torch.as_tensor(long_prompt, device="cuda"),
             2200, 9)):
        ring = model32.cache_shapes(p.shape[0], max_len)[0][2]["k"][2]
        diff32, agree32, total32, _, _ = kernel_vs_reference(
            torch, ops, model32, params32, p, max_len, n_tok)
        gates[label] = {"max_logit_diff": diff32, "greedy_agree": agree32,
                        "of": total32}
        log(f"rgemma f32 kernel vs reference path [{label}: batch "
            f"{p.shape[0]}, prompt {p.shape[1]}, cache {max_len}, attn_local "
            f"cache {ring} slots, {n_tok - 1} decode steps at positions "
            f"{p.shape[1]}-{p.shape[1] + n_tok - 2}], teacher-forced: max "
            f"|logit diff| {diff32:.3e} (limit 1e-3), greedy agreement "
            f"{agree32}/{total32}")
        check(diff32 <= 1e-3,
              f"rgemma f32 [{label}] logits differ by {diff32}")
        check(agree32 == total32,
              f"rgemma f32 [{label}] greedy tokens differ: {agree32}/{total32}")
    check(model32.cache_shapes(1, 2200)[0][2]["k"][2] == cfg.window_size,
          "the past-the-wrap run does not use a ring cache")
    out["f32_gates"] = gates
    del params32, model32
    torch.cuda.empty_cache()
    return out


def profile_prefill(torch, np, ops, model, params, cfg, n_rec, trace_dir,
                    S=4096):
    """One prefill of a single long prompt under torch.profiler: its device
    time and K3's share of it.  A warm-up prefill runs first; the traced
    one must launch K3 once per RG-LRU layer."""
    from torch.profiler import ProfilerActivity, profile
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(1, S), dtype=np.int32), device="cuda")

    def prefill():
        with torch.no_grad():
            logits, _ = model.prefill(params, toks, max_len=S)
        torch.cuda.synchronize()
        return logits

    prefill()
    c0 = _counts(ops)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        logits = prefill()
        wall = time.perf_counter() - t0
    launches = _delta(c0, _counts(ops))
    check(launches["rglru_scan"] == n_rec,
          f"the long prefill launched K3 {launches['rglru_scan']} times, "
          f"not {n_rec}")
    check(bool(torch.isfinite(logits).all())
          and tuple(logits.shape) == (1, 1, cfg.vocab_size),
          f"long prefill logits {tuple(logits.shape)} not finite or shaped")
    out_dir = Path(trace_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out_dir / "prefill_trace.json"))
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        log("profile long prefill: the profiler recorded no device events: "
            "device time not measured")
        return {"launches": launches}
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    k3 = [e for e in kern if "rglru_scan" in e.name]
    check(len(k3) == n_rec, f"the trace holds {len(k3)} K3 kernels, not "
          f"{n_rec}")
    k3_ms = sum(e.time_range.elapsed_us() for e in k3) / 1e3
    res = dict(wall_ms=wall * 1e3, device_ms=busy, device_events=len(kern),
               k3_ms=k3_ms, k3_events=len(k3), k3_share=k3_ms / busy,
               launches=launches)
    log(f"profile long prefill (bf16, batch 1, prompt {S}): wall "
        f"{res['wall_ms']:.2f} ms, device busy {busy:.3f} ms in {len(kern)} "
        f"device events; K3 {k3_ms:.4f} ms in {len(k3)} device events "
        f"({res['k3_share']:.2%} of the prefill's device time); launches "
        f"{launches}")
    by_name: dict = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"profile long prefill top: {us / 1e3:8.3f} ms "
            f"({us / 1e3 / busy:.1%})  {name[:90]}")
    return res


def profile_steps(torch, prefill, decode, toks, trace_dir, steps=4):
    """Trace one prefill and ``steps`` decode steps of a served session
    (its bound steps: replays of their graphs) with torch.profiler:
    device-busy share of the host's wall time, device kernels per step,
    and the kernels that take the device time.  The Chrome trace and the
    host-op table go to ``trace_dir``.  The MoE stage ranges are host
    markers a graph does not hold, so no stage split is taken here."""
    from torch.profiler import ProfilerActivity, profile, record_function
    B, S = toks.shape

    def work():
        logits, _ = prefill(toks)
        torch.cuda.synchronize()
        t_pre = time.perf_counter()
        with record_function("decode_steps"):
            tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
            pos = torch.full((B,), S, dtype=torch.int32, device=toks.device)
            for _ in range(steps):
                logits, _ = decode(tok, pos)
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
    # device events, without the decode region's own span on the GPU
    # timeline
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
    log("profile, replayed (bf16, batch %d, prompt %d): prefill wall %.2f "
        "ms, device busy %.2f ms, %d device events; decode per step wall "
        "%.2f ms, device busy %.3f ms, %.0f device events, device idle "
        "share on the host clock under the profiler %.3f"
        % (B, S, res["prefill_wall_ms"], res["prefill_busy_ms"],
           res["prefill_kernels"], res["decode_wall_ms_per_step"],
           res["decode_busy_ms_per_step"], res["decode_kernels_per_step"],
           res["decode_idle_share"]))
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"profile decode top: {us / steps:9.1f} us/step  {name[:90]}")
    # the port's own kernels (K2's two passes), whatever their rank
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1]):
        if re.search(r"(decode_split|decode_merge|flash_\w+|rglru_scan)_kernel",
                     name):
            log(f"profile decode port kernel: {us / steps:9.1f} us/step "
                f"({us / busy_dec:.1%} of device busy)  {name[:70]}")
    table = prof.key_averages().table(sort_by="self_cpu_time_total",
                                      row_limit=15)
    (out_dir / "profile_table.txt").write_text(table)
    log("profile host ops by self CPU time (prefill + decode, profiler on):")
    for line in table.splitlines()[:19]:
        log(f"  {line[:150]}")
    return res


# ---------------------------------------------------------------------------
# phases 6 and 7: the MoE and MLA families
def routing_compare(torch, krec, rrec, n_moe, n_steps):
    """Every MoE layer's chosen experts on the two paths, step by step:
    (per step whether every layer chose alike for every token, the flips,
    the smallest top-k margin seen, the share of token choices that
    agreed).  A flip's margin is the smaller of the two paths' gaps
    between that token's k-th and (k+1)-th gate."""
    check(len(krec.calls) == len(rrec.calls) == n_moe * n_steps,
          f"routing records {len(krec.calls)}/{len(rrec.calls)}, expected "
          f"{n_moe} MoE layers x {n_steps} steps")
    agreed, flips = [], []
    same = total = 0
    min_margin = float("inf")
    for i in range(n_steps):
        ok = True
        for layer in range(n_moe):
            kc, rc = krec.calls[i * n_moe + layer], rrec.calls[i * n_moe + layer]
            ki, ri = kc["idx"].sort(-1).values, rc["idx"].sort(-1).values
            margins = torch.minimum(kc["margins"], rc["margins"])
            min_margin = min(min_margin, float(margins.min()))
            differs = (ki != ri).any(-1)
            n_diff = int(differs.sum())
            same += ki.shape[0] - n_diff
            total += ki.shape[0]
            for t in differs.nonzero().flatten().tolist():
                flips.append(dict(step=i, layer=layer, token=t,
                                  kernel=ki[t].tolist(),
                                  reference=ri[t].tolist(),
                                  margin=float(margins[t])))
            ok = ok and n_diff == 0
        agreed.append(ok)
    return agreed, flips, min_margin, same / total


def moe_vs_reference(torch, ops, moe, model, params, toks, max_len, n_tok,
                     tag, gate):
    """The kernel path, then the reference path fed its tokens, both with
    their routing recorded.  With ``gate``: logits within 1e-3 at every
    step whose routing agreed in every MoE layer, identical greedy tokens,
    and no flip whose margin is above ``ROUTING_FLIP_MARGIN``."""
    with moe.record_routing() as krec:
        k_logits, fed, k_ms = run_steps(torch, ops, model, params, toks,
                                        max_len, n_tok, reference=False)
    with moe.record_routing() as rrec:
        r_logits, _, r_ms = run_steps(torch, ops, model, params, toks,
                                      max_len, n_tok, reference=True,
                                      feed=fed)
    diff, agree, total = compare(torch, k_logits, r_logits, tag)
    n_moe = sum(kind in MOE_KINDS for kind in model.cfg.layer_kinds)
    agreed, flips, min_margin, share = routing_compare(torch, krec, rrec,
                                                       n_moe, n_tok)
    diffs = [float((a - b).abs().max()) for a, b in zip(k_logits, r_logits)]
    agreed_diff = max((d for d, ok in zip(diffs, agreed) if ok), default=0.0)
    pre = krec.calls[:n_moe]
    dropped = [int(c["dropped"]) for c in pre]
    B, S = toks.shape
    res = dict(max_logit_diff=diff, max_logit_diff_agreed_steps=agreed_diff,
               greedy_agree=agree, of=total, steps_agreed=sum(agreed),
               steps=len(agreed), flips=flips, min_margin=min_margin,
               routing_agree_share=share, prefill_dropped=dropped,
               prefill_assignments=pre[0]["assignments"],
               capacity=pre[0]["capacity"], groups=pre[0]["groups"],
               decode_step_ms=_median(k_ms),
               decode_step_ms_reference=_median(r_ms))
    log(f"{tag} [batch {B}, prompt {S}, cache {max_len}, {n_tok - 1} decode "
        f"steps], teacher-forced: max |logit diff| {diff:.3e} (over steps "
        f"whose routing agreed {agreed_diff:.3e}, limit "
        f"{F32_LOGIT_TOL if gate else 'none, not gated'}), greedy agreement "
        f"{agree}/{total}, routing agreed in every MoE layer at "
        f"{sum(agreed)}/{len(agreed)} steps, {share:.4%} of token choices "
        f"agree, {len(flips)} flips, smallest top-k margin {min_margin:.3e}; "
        f"prefill dropped {sum(dropped)} of {n_moe} x "
        f"{pre[0]['assignments']} assignments ({dropped} per MoE layer; "
        f"{pre[0]['groups']} groups, capacity {pre[0]['capacity']})")
    if gate:
        for f in flips:
            log(f"{tag} flip: step {f['step']} MoE layer {f['layer']} token "
                f"{f['token']}: kernel {f['kernel']} reference "
                f"{f['reference']} margin {f['margin']:.3e}")
        check(agreed_diff <= F32_LOGIT_TOL,
              f"{tag}: logits differ by {agreed_diff} at a step whose "
              f"routing agreed")
        check(agree == total, f"{tag}: greedy tokens differ {agree}/{total}")
        bad = [f for f in flips if f["margin"] > ROUTING_FLIP_MARGIN]
        check(not bad, f"{tag}: {len(bad)} flips above the margin "
              f"{ROUTING_FLIP_MARGIN}: {bad[:5]}")
    return res


def serve_family(torch, np, ops, moe, cfg, tag, tmp_root, engines,
                 prompt_seed):
    """A full-width MoE-family model on the card, bf16, seed 0: publish,
    serve (own launch-count window: one K1 per layer per forward, one K2
    per layer per decode step), the dropped assignments of one forward,
    the ungated bf16 comparison and the profiler pass.  Returns (out,
    model, params, toks)."""
    from repro_torch.models import make_model
    from repro_torch.serving import WeightStore
    B, S, MAX_LEN, N_TOK = 4, 128, 256, 16
    n = cfg.n_layers
    prompt = np.random.default_rng(prompt_seed).integers(
        0, cfg.vocab_size, size=(B, S), dtype=np.int32)
    toks = torch.as_tensor(prompt, device="cuda")
    out: dict = {}
    t0 = time.perf_counter()
    model = make_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    store = WeightStore(tempfile.mkdtemp(dir=tmp_root, prefix="weights-"))
    out["publish_s"] = _publish(store, tag, params)

    n_moe = sum(kind in MOE_KINDS for kind in cfg.layer_kinds)
    ops.reset_launches()                      # this path's run starts
    with batched_experts_counted(moe) as batched:
        bf = serve(np, ops, cfg, store, tag, f"{tag} bf16", prompt, engines,
                   max_len=MAX_LEN, n_tok=N_TOK,
                   trace_dir=ROOT / "build" / "profile" / tag)
    out["launches"] = _counts(ops)            # ... and ends here
    check_launches(bf, {"flash_attention": n, "decode_attention": 0,
                        "rglru_scan": 0, **NOT_LAUNCHED,
                        "moe_grouped": n_moe},
                   {"flash_attention": 0, "decode_attention": n,
                    "rglru_scan": 0, **NOT_LAUNCHED, "moe_grouped": n_moe},
                   N_TOK, f"{tag} bf16")
    check(out["launches"]["flash_attention"] > 0
          and out["launches"]["decode_attention"] > 0
          and out["launches"]["moe_grouped"] > 0,
          f"a kernel was not launched on the {tag} path: {out['launches']}")
    # the captured steps run K4 in every MoE layer and no batched expert
    # product, and count the rows K4 gathers (T * k a layer)
    check(batched["calls"] == 0, f"{tag}: the served path ran the batched "
          f"experts {batched['calls']} times")
    for step, tokens in (("prefill", B * S), ("decode", B)):
        g = bf["graphs"][step]
        check(g["launches"].get("moe_grouped") == n_moe
              and g["moe_rows"] == (n_moe * tokens * cfg.moe.top_k,) * 2,
              f"{tag} captured {step}: launches {g['launches']}, expert rows "
              f"{g['moe_rows']}")
    log(f"{tag} captured prefill and decode: K4 {n_moe} launches each, "
        f"routed rows = expert rows computed "
        f"({bf['graphs']['prefill']['moe_rows']}, "
        f"{bf['graphs']['decode']['moe_rows']}), no batched expert product")
    _log_served(f"{tag} bf16", bf, N_TOK, out["launches"])
    out.update({k: bf[k] for k in ("cold_ms", "freshened_ms", "warm_ms",
                                   "generate_ms", "cold_timing", "graphs",
                                   "profile")})

    with moe.record_routing() as rec, torch.no_grad():
        x, aux = model.forward(params, toks)
    check(bool(torch.isfinite(x).all()) and bool(torch.isfinite(aux)),
          f"{tag} forward not finite")
    drops = [int(c["dropped"]) for c in rec.calls]
    out["forward_dropped"] = drops
    log(f"{tag} bf16 forward (batch {B}, prompt {S}): {len(drops)} MoE layers "
        f"dropped {sum(drops)} of {len(drops)} x {rec.calls[0]['assignments']}"
        f" assignments (capacity {rec.calls[0]['capacity']} per expert, "
        f"{rec.calls[0]['groups']} group(s)); per layer {drops}; aux "
        f"{float(aux):.5f}")
    out["bf16_teacher_forced"] = moe_vs_reference(
        torch, ops, moe, model, params, toks, MAX_LEN, N_TOK,
        f"{tag} bf16 kernel vs reference path", gate=False)
    out["decode_step_ms"] = out["bf16_teacher_forced"]["decode_step_ms"]
    return out, model, params, toks


@contextlib.contextmanager
def batched_experts_counted(moe):
    """Count the calls of the batched expert products
    (``moe._expert_ffn``) inside the block."""
    calls = {"calls": 0}
    inner = moe._expert_ffn

    def counted(*a, **kw):
        calls["calls"] += 1
        return inner(*a, **kw)
    moe._expert_ffn = counted
    try:
        yield calls
    finally:
        moe._expert_ffn = inner


@contextlib.contextmanager
def batched_moe(moe):
    """``routed`` on its batched path on the card (the yardstick K4 is
    timed against): the K4 rule answers no inside the block."""
    rule = moe._grouped
    moe._grouped = lambda *a: False
    try:
        yield
    finally:
        moe._grouped = rule


def f32_gates(torch, ops, moe, cfg32, variants, prompts, tag):
    """The float32 gate for each (label, config) of ``variants`` at each
    prompt: one set of params (seed 0) shared by the variants."""
    from repro_torch.models import make_model
    _no_tf32(torch)
    params = make_model(cfg32, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    gates = {}
    for label, cfg_v in variants:
        model = make_model(cfg_v, device="cuda")
        for toks, max_len, n_tok in prompts:
            key = f"{label}, prompt {toks.shape[1]}"
            gates[key] = moe_vs_reference(
                torch, ops, moe, model, params, toks, max_len, n_tok,
                f"{tag} f32 [{key}] kernel vs reference path", gate=True)
    del params
    torch.cuda.empty_cache()
    return gates


def _prompts(torch, np, cfg, seed):
    """The gates' prompts: batch 4 at 128 (one dispatch group) and at 256
    (two groups)."""
    rng = np.random.default_rng(seed)
    return [(torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(4, S),
                                          dtype=np.int32), device="cuda"),
             max_len, 16) for S, max_len in ((128, 256), (256, 288))]


def _with_moe(cfg, **kw):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **kw))


def _with_mla(cfg, **kw):
    return dataclasses.replace(cfg, mla=dataclasses.replace(cfg.mla, **kw))


def phase_moe(torch, np, ops, tmp_root, engines):
    """Full-width, uncut granite-moe-1b-a400m on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config("granite-moe-1b-a400m")
    e = cfg.moe
    log(f"moe: {cfg.name} full width, not cut: {cfg.n_layers} attn_moe "
        f"layers, d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads},"
        f" head_dim {cfg.resolved_head_dim}, {e.n_experts} experts top-"
        f"{e.top_k} (d_ff {e.d_ff}, {e.n_shared} shared, dispatch "
        f"{e.dispatch}, group {e.group_size}, capacity factor "
        f"{e.capacity_factor}), vocab {cfg.vocab_size}, {cfg.dtype}, "
        f"{cfg.param_count() / 1e9:.3f} B params; batch 4, prompt 128, cache "
        f"256, 16 tokens")
    out, model, params, _ = serve_family(torch, np, ops, moe, cfg, "granite",
                                         tmp_root, engines, 4)
    del params, model
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32", n_layers=4,
                                segments=((("attn_moe",), 4),))
    log(f"granite f32 gate: depth cut from {cfg.n_layers} to "
        f"{cfg32.n_layers} layers; widths as published")
    out["f32_gates"] = f32_gates(
        torch, ops, moe, cfg32,
        [(d, _with_moe(cfg32, dispatch=d)) for d in ("einsum", "gather")],
        _prompts(torch, np, cfg, 5), "granite")
    return out


def phase_mla(torch, np, ops, tmp_root, engines):
    """deepseek-v2-lite-16b on the card: full width, cut to 4 layers."""
    from repro_torch.configs import get_config
    from repro_torch.models import make_model, moe
    full = get_config("deepseek-v2-lite-16b")
    cfg = dataclasses.replace(full, n_layers=4,
                              segments=((("mla",), 1), (("mla_moe",), 3)))
    m, e = cfg.mla, cfg.moe
    log(f"mla: {cfg.name} full width, depth cut from {full.n_layers} to "
        f"{cfg.n_layers} layers (segments {cfg.segments}; uncut "
        f"{full.param_count() / 1e9:.2f} B params): d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, latent {m.kv_lora_rank}, nope/rope/v "
        f"{m.nope_head_dim}/{m.rope_head_dim}/{m.v_head_dim}, decode "
        f"{m.decode_mode}, dense d_ff {cfg.d_ff}, {e.n_experts} experts top-"
        f"{e.top_k} (d_ff {e.d_ff}, {e.n_shared} shared, dispatch "
        f"{e.dispatch}), vocab {cfg.vocab_size}, untied, {cfg.dtype}, "
        f"{cfg.param_count() / 1e9:.3f} B params; batch 4, prompt 128, cache "
        f"256, 16 tokens")
    out, model, params, toks = serve_family(torch, np, ops, moe, cfg,
                                            "deepseek", tmp_root, engines, 6)
    # the absorbed decode attends over the latents in plain PyTorch: a
    # prefill and 3 decode steps launch K1 once per layer and K2 never
    absorbed = make_model(_with_mla(cfg, decode_mode="absorbed"),
                          device="cuda")
    c0 = _counts(ops)
    logits_steps, _, _ = run_steps(torch, ops, absorbed, params, toks, 256, 4,
                                   reference=False)
    got = _delta(c0, _counts(ops))
    out["absorbed_launches"] = got
    n_moe = sum(kind in MOE_KINDS for kind in cfg.layer_kinds)
    check(got == {"flash_attention": cfg.n_layers, "decode_attention": 0,
                  "rglru_scan": 0, **NOT_LAUNCHED, "moe_grouped": 4 * n_moe},
          f"absorbed prefill + 3 decode steps launched {got}")
    check(all(bool(torch.isfinite(a).all()) for a in logits_steps),
          "absorbed decode logits not finite")
    log(f"deepseek bf16 absorbed decode: a prefill and 3 decode steps "
        f"launched {got}")
    del params, model, absorbed
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32", n_layers=2,
                                segments=((("mla",), 1), (("mla_moe",), 1)))
    log(f"deepseek f32 gate: depth cut to {cfg32.n_layers} layers "
        f"{cfg32.segments}; widths as published")
    out["f32_gates"] = f32_gates(
        torch, ops, moe, cfg32,
        [(f"{mode}, {d}", _with_mla(_with_moe(cfg32, dispatch=d),
                                    decode_mode=mode))
         for mode in ("naive", "absorbed") for d in ("einsum", "gather")],
        _prompts(torch, np, cfg, 7), "deepseek")
    return out


# ---------------------------------------------------------------------------
# phase 8
def profile_slstm_prefill(torch, p, cfg, x):
    """One sLSTM layer's prefill (its per-token loop) under torch.profiler:
    device events, device-busy ms and wall ms, after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import xlstm

    def run():
        with torch.no_grad():
            out, _ = xlstm.slstm_block_apply(p, x, cfg)
        torch.cuda.synchronize()
        return out

    run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        wall = time.perf_counter() - t0
    check(bool(torch.isfinite(out).all()), "sLSTM prefill not finite")
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    res = dict(wall_ms=wall * 1e3, device_events=len(kern),
               device_ms=sum(e.time_range.elapsed_us() for e in kern) / 1e3)
    B, S, _ = x.shape
    log(f"profile sLSTM layer prefill (bf16, batch {B}, prompt {S}, profiler "
        f"on): wall {res['wall_ms']:.2f} ms, {len(kern)} device events "
        f"({len(kern) / S:.1f} per token), device busy {res['device_ms']:.3f}"
        f" ms")
    return res


def parallel_vs_recurrent(torch, np, cfg2, B=4, S=128, S0=64):
    """A float32 copy cut to ``(mlstm, slstm)``: a prefill of S0 tokens,
    then S - S0 decode steps fed the prompt's next tokens, each against
    one forward's logits over all S tokens (two chunks of 64)."""
    from repro_torch.models import make_model
    model = make_model(cfg2, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    toks = torch.as_tensor(np.random.default_rng(9).integers(
        0, cfg2.vocab_size, size=(B, S), dtype=np.int32), device="cuda")
    with torch.no_grad():
        x, _ = model.forward(params, toks)
        full = model._logits(params, x).float()             # (B, S, V)
        cache = model.init_cache(B, S)
        logits, cache = model.prefill(params, toks[:, :S0], max_len=S,
                                      cache=cache)
        steps = [logits.float()]
        for t in range(S0, S):
            pos = torch.full((B,), t, dtype=torch.int32, device="cuda")
            logits, cache = model.decode_step(params, cache,
                                              toks[:, t:t + 1], pos)
            steps.append(logits.float())
    # the prefill's logits are position S0 - 1's; the step at t is t's
    diff, agree, total = compare(torch, steps,
                                 [full[:, t:t + 1] for t in range(S0 - 1, S)],
                                 "parallel vs recurrent")
    return diff, agree, total


def phase_xlstm(torch, np, ops, tmp_root, engines):
    """Full-width, uncut xlstm-350m on the card: plain PyTorch, no port
    kernel on the path."""
    from repro_torch.checkpoint import flatten_with_paths, tree_map
    from repro_torch.configs import get_config
    from repro_torch.models import make_model
    from repro_torch.serving import WeightStore

    cfg = get_config("xlstm-350m")
    x = cfg.xlstm
    di = int(cfg.d_model * x.proj_factor_mlstm)
    B, S, MAX_LEN, N_TOK = 4, 128, 256, 16
    log(f"xlstm: {cfg.name} full width, not cut: {cfg.n_layers} layers "
        f"{cfg.segments}, d_model {cfg.d_model}, {cfg.n_heads} heads; mLSTM "
        f"inner {di} (head dim {di // cfg.n_heads}), chunk {x.chunk_size}, "
        f"conv {x.conv_width}; sLSTM FFN "
        f"{int(cfg.d_model * x.proj_factor_slstm)}; vocab {cfg.vocab_size}, tied, {cfg.dtype}; batch {B}, prompt {S}, "
        f"cache {MAX_LEN}, {N_TOK} tokens")
    prompt = np.random.default_rng(8).integers(0, cfg.vocab_size, size=(B, S),
                                               dtype=np.int32)
    toks = torch.as_tensor(prompt, device="cuda")
    out: dict = {"seconds": {}}
    t_lap = [time.perf_counter()]

    def lap(step):                    # where the phase's seconds go
        now = time.perf_counter()
        out["seconds"][step] = now - t_lap[0]
        t_lap[0] = now

    t0 = time.perf_counter()
    model = make_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    n_params = sum(t.numel() for t in flatten_with_paths(params).values())
    log(f"xlstm: {n_params / 1e6:.1f} M params")
    store = WeightStore(tempfile.mkdtemp(dir=tmp_root, prefix="weights-"))
    out["publish_s"] = _publish(store, "xlstm", params)
    lap("init and publish")

    ops.reset_launches()                      # this path's run starts
    bf = serve(np, ops, cfg, store, "xlstm", "xlstm bf16", prompt, engines,
               max_len=MAX_LEN, n_tok=N_TOK,
               trace_dir=ROOT / "build" / "profile" / "xlstm")
    out["launches"] = _counts(ops)            # ... and ends here
    lap("serve")
    none = {k: 0 for k in out["launches"]}
    check_launches(bf, none, none, N_TOK, "xlstm bf16")
    check(out["launches"] == none,
          f"the xlstm path launched a port kernel: {out['launches']}")
    _log_served("xlstm bf16", bf, N_TOK, out["launches"])
    out.update({k: bf[k] for k in ("cold_ms", "freshened_ms", "warm_ms",
                                   "generate_ms", "cold_timing", "graphs",
                                   "profile")})
    logits_steps, _, step_ms = run_steps(torch, ops, model, params, toks,
                                         MAX_LEN, N_TOK, reference=False)
    check(all(bool(torch.isfinite(a).all()) for a in logits_steps),
          "xlstm bf16 decode logits not finite")
    out["decode_step_ms"] = _median(step_ms)
    log(f"xlstm bf16 eager decode step median {out['decode_step_ms']:.2f} ms "
        f"(batch {B}, {N_TOK - 1} steps)")
    lap("decode steps")
    with torch.no_grad():
        h = model._embed(params, toks)
    out["slstm_prefill"] = profile_slstm_prefill(
        torch, tree_map(lambda t: t[0], params["seg0"][1]["mixer"]), cfg, h)
    lap("sLSTM profile")
    del params, model, h
    torch.cuda.empty_cache()

    # ---- float32 gates, TF32 off --------------------------------------------
    _no_tf32(torch)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = make_model(cfg32, device="cuda")
    params32 = model32.init(torch.Generator(device="cuda").manual_seed(0))
    card, fed, _ = run_steps(torch, ops, model32, params32, toks, MAX_LEN,
                             N_TOK, reference=False)
    lap("f32 on the card")
    t0 = time.perf_counter()
    cpu_params = tree_map(lambda t: t.cpu(), params32)
    del params32, model32
    torch.cuda.empty_cache()
    host, _, _ = run_steps(torch, ops, make_model(cfg32, device="cpu"),
                           cpu_params, toks.cpu(), MAX_LEN, N_TOK,
                           reference=False, feed=[t.cpu() for t in fed])
    del cpu_params
    diff, agree, total = compare(torch, [a.cpu() for a in card], host,
                                 "card vs CPU")
    out["f32_card_vs_cpu"] = {"max_logit_diff": diff, "greedy_agree": agree,
                              "of": total, "cpu_s": time.perf_counter() - t0}
    log(f"xlstm f32 card vs CPU, full depth, teacher-forced over {N_TOK} "
        f"positions x {B} rows: max |logit diff| {diff:.3e} (limit 1e-3), "
        f"greedy agreement {agree}/{total}; the CPU run took "
        f"{out['f32_card_vs_cpu']['cpu_s']:.1f} s")
    check(diff <= F32_LOGIT_TOL, f"xlstm f32 card vs CPU differ by {diff}")
    check(agree == total, f"xlstm f32 card vs CPU tokens differ: "
          f"{agree}/{total}")
    lap("f32 on the CPU")

    cfg2 = dataclasses.replace(cfg32, n_layers=2,
                               segments=((("mlstm", "slstm"), 1),))
    diff, agree, total = parallel_vs_recurrent(torch, np, cfg2)
    out["f32_parallel_vs_recurrent"] = {"max_logit_diff": diff,
                                        "greedy_agree": agree, "of": total}
    log(f"xlstm f32 parallel vs recurrent, depth cut to {cfg2.segments}: "
        f"prefill 64 tokens + 64 teacher-forced decode steps against one "
        f"128-token forward, x 4 rows: max |logit diff| {diff:.3e} (limit "
        f"1e-3), greedy agreement {agree}/{total}")
    check(diff <= F32_LOGIT_TOL,
          f"xlstm f32 parallel vs recurrent differ by {diff}")
    check(agree == total, f"xlstm f32 parallel vs recurrent tokens differ: "
          f"{agree}/{total}")
    lap("parallel vs recurrent")
    log("xlstm seconds by step " + json.dumps(
        {k: round(v, 1) for k, v in out["seconds"].items()}))
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase dense: the five dense configurations no other phase serves, then
# the paper's chain through all five
# (arch, tag, served segments or None for uncut, prompt seed, the float32
# gate's segments); widths, heads, head dims, vocab, window, softcaps and
# activations stay as published
DENSE = (
    ("musicgen-medium", "musicgen", None, 11, ((("attn",), 2),)),
    ("pixtral-12b", "pixtral", ((("attn",), 4),), 12, ((("attn",), 2),)),
    ("phi3-medium-14b", "phi3", ((("attn",), 4),), 13, ((("attn",), 2),)),
    ("nemotron-4-15b", "nemotron", ((("attn",), 4),), 14,
     ((("attn",), 2),)),
    ("gemma2-27b", "gemma2", ((("attn_local", "attn"), 2),), 15,
     ((("attn_local", "attn"), 1),)),
)
DENSE_SHAPE = (4, 128, 256, 16)         # batch, prompt, cache, tokens
# gemma2's float32 gate past its 4096 window: batch 1, prompt, cache and
# tokens (the prefill's and 8 decode steps')
GEMMA2_LONG = (1, 4200, 4224, 9)
CHAIN_JOIN_S = 600


def _cut(cfg, segments):
    """``cfg`` with its depth cut to ``segments`` (None: uncut)."""
    if segments is None:
        return cfg
    return dataclasses.replace(
        cfg, segments=segments,
        n_layers=sum(len(pat) * reps for pat, reps in segments))


@contextlib.contextmanager
def _closing_new(torch, engines):
    """Close the engines appended to ``engines`` inside the block when it
    ends, and free what they held on the card.  They stay in ``engines``
    until then, so the phase's own ``finally`` closes them on a
    failure."""
    import gc
    n0 = len(engines)
    try:
        yield
    finally:
        for eng in engines[n0:]:
            eng.close()
        del engines[n0:]
        gc.collect()
        torch.cuda.empty_cache()


def _describe(cfg):
    return (f"{cfg.n_layers} layers {cfg.segments}, d_model {cfg.d_model}, "
            f"heads {cfg.n_heads}/{cfg.n_kv_heads}, head_dim "
            f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff} {cfg.activation}, "
            f"vocab {cfg.vocab_size} "
            f"{'tied' if cfg.tie_embeddings else 'untied'}, rope_theta "
            f"{cfg.rope_theta:g}, window {cfg.window_size}, softcaps "
            f"{cfg.attn_softcap}/{cfg.final_softcap}, {cfg.dtype}, "
            f"{cfg.param_count() / 1e9:.3f} B params")


def serve_dense(torch, np, ops, full, cfg, tag, seed, store, engines):
    """One dense model on the card in bf16, weights from seed 0: publish
    to ``store`` (kept for the chain), serve (its own launch-count
    window: n K1 per forward, n K2 per decode step), the ungated bf16
    kernel-vs-reference comparison and the profiler pass.  Every engine
    it makes is closed and its weights dropped before it returns."""
    from repro_torch.models import make_model
    B, S, MAX_LEN, N_TOK = DENSE_SHAPE
    n = cfg.n_layers
    cut = ("not cut" if cfg is full else
           f"depth cut from {full.n_layers} to {n} layers (uncut "
           f"{full.param_count() / 1e9:.3f} B params, "
           f"{2 * full.param_count() / 1e9:.2f} GB in bf16)")
    log(f"dense: {cfg.name} published widths, {cut}: {_describe(cfg)}; "
        f"batch {B}, prompt {S}, cache {MAX_LEN}, {N_TOK} tokens")
    prompt = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S), dtype=np.int32)
    toks = torch.as_tensor(prompt, device="cuda")
    out: dict = {"layers": n, "prompt": prompt}
    t0 = time.perf_counter()
    model = make_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["publish_s"] = _publish(store, tag, params)
    out["bytes"] = store.nbytes(tag)

    with _closing_new(torch, engines):
        ops.reset_launches()                  # this path's run starts
        bf = serve(np, ops, cfg, store, tag, f"{tag} bf16", prompt, engines,
                   max_len=MAX_LEN, n_tok=N_TOK,
                   trace_dir=ROOT / "build" / "profile" / tag)
        out["launches"] = _counts(ops)        # ... and ends here
    check_launches(bf, {"flash_attention": n, "decode_attention": 0,
                        "rglru_scan": 0, **NOT_LAUNCHED},
                   {"flash_attention": 0, "decode_attention": n,
                    "rglru_scan": 0, **NOT_LAUNCHED}, N_TOK, f"{tag} bf16")
    check(out["launches"]["flash_attention"] > 0
          and out["launches"]["decode_attention"] > 0,
          f"a kernel was not launched on the {tag} path: {out['launches']}")
    _log_served(f"{tag} bf16", bf, N_TOK, out["launches"])
    out.update({k: bf[k] for k in ("cold_ms", "freshened_ms", "warm_ms",
                                   "generate_ms", "cold_timing", "logits",
                                   "tokens", "graphs", "profile")})
    log(f"{tag} bf16 cold invoke: {out['bytes'] / 1e9:.3f} GB of weights at "
        f"{out['bytes'] / 1e9 / out['cold_timing']['weights']:.3f} GB/s "
        f"(the load and the copy to the card)")

    diff, agree, total, k_ms, r_ms = kernel_vs_reference(
        torch, ops, model, params, toks, MAX_LEN, N_TOK)
    out["bf16_teacher_forced"] = {"max_logit_diff": diff,
                                  "greedy_agree": agree, "of": total}
    out["decode_step_ms"], out["decode_step_ms_reference"] = k_ms, r_ms
    log(f"{tag} bf16 kernel vs reference path, teacher-forced over {N_TOK} "
        f"positions x {B} rows: max |logit diff| {diff:.4e}, greedy "
        f"agreement {agree}/{total}; decode step median {k_ms:.2f} ms "
        f"(reference path {r_ms:.2f} ms)")
    del params, model
    torch.cuda.empty_cache()
    return out


def dense_gate(torch, np, ops, full, segments, tag, toks):
    """The float32 gate at published widths cut to ``segments`` (TF32
    off): the kernel path against the plain path, teacher-forced, every
    step's logits within F32_LOGIT_TOL and the same greedy tokens; for
    gemma2 also one prompt past its window, on the local layers' ring."""
    from repro_torch.models import make_model
    _no_tf32(torch)
    cfg32 = dataclasses.replace(_cut(full, segments), dtype="float32")
    log(f"{tag} f32 gate: depth cut from {full.n_layers} to "
        f"{cfg32.n_layers} layers {cfg32.segments}; widths as published")
    model32 = make_model(cfg32, device="cuda")
    params32 = model32.init(torch.Generator(device="cuda").manual_seed(0))
    _, _, max_len, n_tok = DENSE_SHAPE
    runs = [("prompt 128", toks, max_len, n_tok)]
    if cfg32.window_size:
        B, S, max_len_l, n_tok_l = GEMMA2_LONG
        ring = model32.cache_shapes(B, max_len_l)[0][0]["k"][2]
        check(S > cfg32.window_size == ring,
              f"{tag} long gate: prompt {S}, window {cfg32.window_size}, "
              f"local cache {ring} slots: the ring does not wrap")
        runs.append(("past the window", torch.as_tensor(
            np.random.default_rng(16).integers(
                0, cfg32.vocab_size, size=(B, S), dtype=np.int32),
            device="cuda"), max_len_l, n_tok_l))
    gates = {}
    for label, p, ml, nt in runs:
        diff, agree, total, _, _ = kernel_vs_reference(
            torch, ops, model32, params32, p, ml, nt)
        gates[label] = {"max_logit_diff": diff, "greedy_agree": agree,
                        "of": total}
        log(f"{tag} f32 kernel vs reference path [{label}: batch "
            f"{p.shape[0]}, prompt {p.shape[1]}, cache {ml}, {nt - 1} decode "
            f"steps at positions {p.shape[1]}-{p.shape[1] + nt - 2}], "
            f"teacher-forced: max |logit diff| {diff:.3e} (limit "
            f"{F32_LOGIT_TOL:g}), greedy agreement {agree}/{total}")
        check(diff <= F32_LOGIT_TOL,
              f"{tag} f32 [{label}] logits differ by {diff}")
        check(agree == total,
              f"{tag} f32 [{label}] greedy tokens differ: {agree}/{total}")
    del params32, model32
    torch.cuda.empty_cache()
    return gates


def dense_chain(torch, np, ops, served, cfgs, store, engines):
    """The paper's scenario: one engine with every dense endpoint deployed
    from its published store, chained in order; one request walks the
    stages with ``freshen_successors=True``, so invoking stage k freshens
    stage k + 1 while k runs.  Each successor's freshen is joined before
    its invoke and must have left every entry freshened, none inline;
    each stage's logits must equal, bit for bit, its own served run's."""
    from repro_torch.core.accounting import ServiceClass
    from repro_torch.serving import Executor, ModelEndpoint, ServingEngine
    B, S, _, _ = DENSE_SHAPE
    names = list(served)
    out: dict = {"stages": {}}
    with _closing_new(torch, engines):
        eng = ServingEngine()
        engines.append(eng)
        acct = eng.scheduler.accountant
        acct.service_class["serving"] = ServiceClass.LATENCY_SENSITIVE
        for tag in names:
            eng.deploy(ModelEndpoint(tag, cfgs[tag], store, Executor(),
                                     batch_size=B, seq_len=S,
                                     device="cuda"))
        eng.chain(names)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()                  # the chain's run starts
        t0 = time.perf_counter()
        for i, tag in enumerate(names):
            rt = eng.scheduler.runtimes[tag]
            st = {}
            if i:
                tj = time.perf_counter()
                rt.join_freshen(timeout=CHAIN_JOIN_S)
                st["join_ms"] = (time.perf_counter() - tj) * 1e3
                check(not rt.freshen_in_flight(),
                      f"chain: {tag}'s freshen still runs after "
                      f"{CHAIN_JOIN_S} s")
                # the scheduler books a freshen on a thread of its own
                # once the freshen ends: wait for it, so that this
                # invoke finds it pending and bills it useful
                check(_wait_until(lambda: acct.bill(
                    "serving").freshen_invocations >= i, 30.0),
                      f"chain: {tag}'s freshen was not booked")
                fr = rt.fr_state.stats()
                st["freshen_stats"] = fr
                check(fr["freshened"] >= 3 and fr["inline"] == 0,
                      f"chain: {tag} before its invoke: {fr}")
            ti = time.perf_counter()
            res = eng.invoke(tag, served[tag]["prompt"],
                             freshen_successors=True)
            st["invoke_ms"] = (time.perf_counter() - ti) * 1e3
            check(np.array_equal(res["logits"], served[tag]["logits"]),
                  f"chain: {tag}'s logits differ from its served run's "
                  f"(max |diff| "
                  f"{np.abs(res['logits'] - served[tag]['logits']).max()})")
            out["stages"][tag] = st
        torch.cuda.synchronize()
        out["wall_ms"] = (time.perf_counter() - t0) * 1e3
        out["launches"] = _counts(ops)        # ... and ends here
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        bill = acct.bill("serving")
        out["bill"] = dict(function_s=bill.function_seconds,
                           freshen_s=bill.freshen_seconds,
                           useful=bill.useful_freshens,
                           mispredicted=bill.mispredicted_freshens,
                           cold_starts=bill.cold_starts)
    # every stage runs its warm-up forward (inline at stage 0, in the
    # freshen elsewhere) and the request's: 2 K1 per layer, no decode
    want = {"flash_attention": 2 * sum(cfgs[t].n_layers for t in names),
            "decode_attention": 0, "rglru_scan": 0, **NOT_LAUNCHED}
    check(out["launches"] == want,
          f"chain launches {out['launches']} != {want}")
    for tag in names:
        st = out["stages"][tag]
        log(f"chain {tag}: invoke {st['invoke_ms']:.1f} ms (served cold "
            f"{served[tag]['cold_ms']:.1f}, warm {served[tag]['warm_ms']:.1f})"
            + (f", freshen joined after {st['join_ms']:.1f} ms, "
               f"{st['freshen_stats']}" if "join_ms" in st else ", cold")
            + "; logits bit for bit its served run's")
    b = out["bill"]
    log(f"chain: {len(names)} stages in {out['wall_ms']:.1f} ms; freshen "
        f"{b['freshen_s']:.3f} s, function {b['function_s']:.3f} s, useful "
        f"{b['useful']}, mispredicted {b['mispredicted']}, cold starts "
        f"{b['cold_starts']}; peak memory {out['peak_bytes'] / 1e9:.3f} GB; "
        f"launches {out['launches']}")
    check(b["mispredicted"] == 0 and b["useful"] == len(names) - 1,
          f"chain bill: {b}")
    return out


def _wait_until(cond, timeout):
    t_end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > t_end:
            return False
        time.sleep(0.005)
    return True


def phase_dense(torch, np, ops, tmp_root, engines):
    """musicgen-medium uncut and pixtral-12b, phi3-medium-14b,
    nemotron-4-15b and gemma2-27b at published widths cut to 4 layers,
    each served, gated in float32 and dropped before the next; then all
    five as one chain."""
    from repro_torch.configs import get_config
    from repro_torch.serving import WeightStore
    store = WeightStore(tempfile.mkdtemp(dir=tmp_root, prefix="weights-"))
    out: dict = {"models": {}, "seconds": {}}
    cfgs = {}
    for arch, tag, segs, seed, gate_segs in DENSE:
        t0 = time.perf_counter()
        full = get_config(arch)
        cfgs[tag] = _cut(full, segs)
        r = serve_dense(torch, np, ops, full, cfgs[tag], tag, seed, store,
                        engines)
        r["f32_gates"] = dense_gate(torch, np, ops, full, gate_segs, tag,
                                    torch.as_tensor(r["prompt"],
                                                    device="cuda"))
        out["models"][tag] = r
        out["seconds"][tag] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["chain"] = dense_chain(torch, np, ops, out["models"], cfgs, store,
                               engines)
    out["seconds"]["chain"] = time.perf_counter() - t0
    log("dense seconds by step " + json.dumps(
        {k: round(v, 1) for k, v in out["seconds"].items()}))
    return out


# ---------------------------------------------------------------------------
# phase fabric: placement across shards and out-of-process endpoints
FABRIC_ARCH = "qwen2-0.5b"
FABRIC_NAME = "qwen2"
FABRIC_SHAPE = (4, 128)                 # batch, prompt: the served shape
FABRIC_REQUESTS = 16
FABRIC_SPEC_REF = "chip_smoke:fabric_endpoint_spec"
# how the worker and template processes find the published weights: the
# backends hand them this process's environment
FABRIC_STORE_ENV = "CHIP_SMOKE_FABRIC_STORE"


def fabric_endpoint_spec():
    """The fabric phase's endpoint as an out-of-process worker rebuilds
    it (``spec_ref``): the same qwen2-0.5b endpoint on the store the
    parent published to, its body wrapped so that each result also
    carries the child's pid, its kernels' launch counts, the libraries
    nvcc built in it (none: it loads what the ``build`` phase built),
    its device memory and the parts of its cold start.  A snapshot
    template calls this before it forks, so it touches no CUDA: the
    context is made by ``init_fn``, in the instance."""
    import os
    t0 = time.perf_counter()
    import torch
    t_torch = time.perf_counter() - t0
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.serving import Executor, ModelEndpoint, WeightStore
    t_import = time.perf_counter() - t0
    B, S = FABRIC_SHAPE
    ep = ModelEndpoint(FABRIC_NAME, get_config(FABRIC_ARCH),
                       WeightStore(os.environ[FABRIC_STORE_ENV]), Executor(),
                       batch_size=B, seq_len=S, device="cuda",
                       spec_ref=FABRIC_SPEC_REF)
    parts = {"pid_at_spec": os.getpid(), "import_torch_s": t_torch,
             "import_s": t_import}

    def init_fn(rt):
        t = time.perf_counter()
        torch.cuda.init()
        torch.empty(1, device="cuda")
        torch.cuda.synchronize()
        parts["cuda_context_s"] = time.perf_counter() - t

    def code(ctx, args):
        out = ep.code(ctx, args)
        out.update(parts, pid=os.getpid(), launches=_counts(ops),
                   nvcc_built=list(ops.LIBRARY.built),
                   memory_reserved=torch.cuda.memory_reserved(),
                   max_memory_allocated=torch.cuda.max_memory_allocated())
        return out
    return dataclasses.replace(ep.spec(), code=code, init_fn=init_fn)


def _running(pid) -> bool:
    """Whether ``pid`` is a live process (a zombie is not)."""
    try:
        stat = Path(f"/proc/{pid}/stat").read_text()
    except OSError:
        return False
    return stat.rsplit(")", 1)[-1].split()[0] not in ("Z", "X")


def _ms_since(t0):
    return (time.perf_counter() - t0) * 1e3


def fabric_sequence(np, eng, rt, prompt, tag):
    """On one deployed endpoint: a cold invoke (weights, kernel library
    and warm-up inline), the instance demoted to INITIALIZED (its caches
    released, as keep-alive demotion does: process, CUDA context and plan
    stay), a freshen, the freshened invoke, which must pay nothing
    inline, and a warm invoke."""
    from repro_torch.core import WarmthLevel
    res = {}
    t0 = time.perf_counter()
    res["cold"] = eng.invoke(FABRIC_NAME, prompt, freshen_successors=False)
    res["cold_ms"] = _ms_since(t0)
    inline0 = rt.freshen_stats()["inline"]
    check(inline0 >= 3, f"{tag} cold invoke paid {inline0} inline")
    rt.demote_to(WarmthLevel.INITIALIZED)
    t0 = time.perf_counter()
    rt.freshen(blocking=True)
    res["freshen_ms"] = _ms_since(t0)
    t0 = time.perf_counter()
    res["fresh"] = eng.invoke(FABRIC_NAME, prompt, freshen_successors=False)
    res["freshened_ms"] = _ms_since(t0)
    st = rt.freshen_stats()
    res["fresh_inline"] = st["inline"] - inline0
    check(res["fresh_inline"] == 0 and st["freshened"] >= 3,
          f"{tag} freshened invoke: {st}, {res['fresh_inline']} inline")
    t0 = time.perf_counter()
    res["warm"] = eng.invoke(FABRIC_NAME, prompt, freshen_successors=False)
    res["warm_ms"] = _ms_since(t0)
    for k in ("cold", "fresh", "warm"):
        logits = res[k]["logits"]
        check(logits.shape[:2] == (FABRIC_SHAPE[0], 1)
              and bool(np.isfinite(logits).all()),
              f"{tag} {k} logits {logits.shape} not finite or misshapen")
    return res


def _bf16_close(np, got, want):
    tol = TOL["bfloat16"]
    err = np.abs(got - want)
    return (float(err.max()), bool((err <= tol["atol"]
                                    + tol["rtol"] * np.abs(want)).all()))


def _wait_gone(pids, timeout=15.0):
    deadline = time.monotonic() + timeout
    while any(_running(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.05)
    return [p for p in pids if _running(p)]


def phase_fabric(torch, np, ops, tmp_root, engines):
    """qwen2-0.5b uncut, bf16, batch 4 x prompt 128, published once:
    (a) on one scheduler, the thread backend: the reference logits and
    the thread row; (b) two shards on the card behind the warmth-aware
    router, with a cross-shard freshen, 16 concurrent requests, a third
    shard, and a drain back to one shard with requests in flight; (c) out
    of process, on the subprocess and the snapshot backends."""
    import os
    import threading
    from repro_torch.cluster import partition_devices
    from repro_torch.configs import get_config
    from repro_torch.core import PoolConfig, Prediction
    from repro_torch.models import make_model
    from repro_torch.serving import (Executor, ModelEndpoint, ServingEngine,
                                     WeightStore)

    cfg = get_config(FABRIC_ARCH)
    B, S = FABRIC_SHAPE
    per_fwd = {"flash_attention": cfg.n_layers, "decode_attention": 0,
               "rglru_scan": 0, **NOT_LAUNCHED}
    ops.LIBRARY.load()             # workers only load what this built
    store_root = tempfile.mkdtemp(dir=tmp_root, prefix="weights-")
    store = WeightStore(store_root)
    gen = torch.Generator(device="cuda").manual_seed(0)
    _publish(store, FABRIC_NAME, make_model(cfg, device="cuda").init(gen))
    torch.cuda.empty_cache()
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(FABRIC_REQUESTS, B, S), dtype=np.int32)
    pool_cfg = PoolConfig(max_instances=2, keep_alive=600.0)
    out: dict = {"backends": {}}

    def endpoint(**kw):
        return ModelEndpoint(FABRIC_NAME, cfg, store, Executor(),
                             batch_size=B, seq_len=S, device="cuda", **kw)

    # ---- (a) one scheduler, thread backend ---------------------------------
    eng1 = ServingEngine()
    engines.append(eng1)
    t0 = time.perf_counter()
    rt1 = eng1.deploy(endpoint(), pool_config=pool_cfg)
    deploy_ms = _ms_since(t0)
    c0 = _counts(ops)
    seq = fabric_sequence(np, eng1, rt1, prompts[0], "thread")
    check(_delta(c0, _counts(ops)) == _times(per_fwd, 5),
          f"thread sequence launches {_delta(c0, _counts(ops))}")
    want = [eng1.invoke(FABRIC_NAME, p, freshen_successors=False)["logits"]
            for p in prompts]
    check(np.array_equal(seq["warm"]["logits"], want[0]),
          "thread backend: the warm and later logits differ")
    out["backends"]["thread"] = {
        "deploy_ms": deploy_ms, "cold_ms": seq["cold_ms"],
        "freshen_ms": seq["freshen_ms"], "freshened_ms": seq["freshened_ms"],
        "warm_ms": seq["warm_ms"], "cold_timing": seq["cold"]["timing"],
        "memory_reserved": torch.cuda.memory_reserved()}
    eng1.close()
    del rt1, seq
    torch.cuda.empty_cache()

    # ---- (b) shards on one card --------------------------------------------
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    log(f"fabric: partition_devices({[str(c) for c in cards]}, 2) = "
        f"{partition_devices(cards, 2)}; the engine pins no shard, so every "
        f"shard runs on cuda:{torch.cuda.current_device()}")
    eng = ServingEngine(router_policy="warmth-aware")
    engines.append(eng)
    ep = endpoint()
    n_warm, warm_lock = [0], threading.Lock()
    warmup = ep.executor.warmup

    def counted_warmup(*args, **kw):          # each is one more forward
        with warm_lock:
            n_warm[0] += 1
        return warmup(*args, **kw)
    ep.executor.warmup = counted_warmup
    n_req = 0
    ops.reset_launches()                      # the sharded run starts
    eng.deploy(ep, pool_config=pool_cfg, shards=2, elastic=True)
    cluster = eng.cluster
    w0, w1 = cluster.worker(0), cluster.worker(1)
    # cross-shard freshen: shard 1 holds the warmth, so arrivals route
    # there; a prediction fired on shard 0 is placed on shard 1 as well
    for th in w1.prewarm(FABRIC_NAME, provision=True):
        th.join()
    check(cluster.route(FABRIC_NAME) == 1,
          f"warm shard 1 is not the route: {cluster.route(FABRIC_NAME)}")
    before = [w.pool(FABRIC_NAME).stats()["prewarm_dispatches"]
              for w in (w0, w1)]
    check(w0.scheduler._dispatch_freshen(Prediction(
        FABRIC_NAME, probability=1.0, expected_delay=0.05)),
        "the predicted freshen was not dispatched")
    after = [w.pool(FABRIC_NAME).stats()["prewarm_dispatches"]
             for w in (w0, w1)]
    check(cluster.stats()["cross_freshens"] == 1
          and after == [before[0], before[1] + 1],
          f"the freshen did not land on shard 1: {before} -> {after}")
    deadline = time.monotonic() + 60
    while w1.warm_idle(FABRIC_NAME) == 0 and time.monotonic() < deadline:
        time.sleep(0.01)                      # the freshen finishing
    s1 = eng.platform_stats()[f"shard1/{FABRIC_NAME}"]
    routed1 = cluster.stats()["routed"][1]
    res = eng.invoke(FABRIC_NAME, prompts[0], freshen_successors=False)
    n_req += 1
    s1b = eng.platform_stats()[f"shard1/{FABRIC_NAME}"]
    check(cluster.stats()["routed"][1] == routed1 + 1,
          "the request after the freshen was not routed to shard 1")
    check(s1b["inline"] == s1["inline"] == 0
          and s1b["warm_acquires"] == s1["warm_acquires"] + 1,
          f"shard 1 ran the request with inline work: {s1} -> {s1b}")
    check(np.array_equal(res["logits"], want[0]),
          "shard 1's logits differ from one scheduler's")
    out["cross_freshen"] = {"prewarm_dispatches": after,
                            "shard1_inline": s1b["inline"]}
    # 16 concurrent requests through the router
    t0 = time.perf_counter()
    futs = [eng.submit(FABRIC_NAME, p, freshen_successors=False)
            for p in prompts]
    results = [f.result(timeout=300) for f in futs]
    out["sharded_16_ms"] = _ms_since(t0)
    n_req += len(futs)
    for i, r in enumerate(results):
        check(np.array_equal(r["logits"], want[i]),
              f"sharded request {i}: logits differ from one scheduler's")
    out["routed"] = dict(cluster.stats()["routed"])
    # grow to three shards: the new one serves the endpoint
    check(eng.scale_shards(3) == 3, "scale_shards(3)")
    new = max(w.shard_id for w in cluster.workers)
    res = cluster.worker(new).invoke(FABRIC_NAME, {"tokens": prompts[1]},
                                     freshen_successors=False)
    n_req += 1
    check(np.array_equal(res["logits"], want[1]),
          f"new shard {new}'s logits differ from one scheduler's")
    out["per_shard"] = {k: v for k, v in eng.platform_stats().items()
                        if k.startswith("shard")}
    # drain back to one shard with requests in flight: none is lost
    futs = [eng.submit(FABRIC_NAME, p, freshen_successors=False)
            for p in prompts[:8]]
    n_req += len(futs)
    t0 = time.perf_counter()
    check(eng.scale_shards(1, drain=True) == 1, "scale_shards(1)")
    out["drain_ms"] = _ms_since(t0)
    for i, f in enumerate(futs):
        check(np.array_equal(f.result(timeout=300)["logits"], want[i]),
              f"request {i} in flight across the drain: logits differ")
    check([w.shard_id for w in cluster.workers] == [0],
          f"live shards after the drain: {cluster.workers}")
    count = eng.latency_summary("serving")["count"]
    check(count == n_req, f"latency_summary counts {count} of {n_req}")
    out["launches"] = _counts(ops)            # ... and ends here
    want_k = _times(per_fwd, n_req + n_warm[0])
    check(out["launches"] == want_k,
          f"sharded launches {out['launches']} != {want_k} ({n_req} "
          f"requests, {n_warm[0]} warm-up forwards)")
    out.update(requests=n_req, warmups=n_warm[0], latency_count=count,
               peak_memory=torch.cuda.max_memory_allocated())
    log(f"fabric sharded: {n_req} requests, {n_warm[0]} warm-up forwards, "
        f"K1 {out['launches']['flash_attention']} launches "
        f"({cfg.n_layers} per forward); routed {out['routed']}; 16 "
        f"concurrent requests {out['sharded_16_ms']:.1f} ms; drain 3 -> 1 "
        f"{out['drain_ms']:.1f} ms with 8 in flight; logits bit for bit "
        f"one scheduler's; latency_summary count {count}; cross-shard "
        f"freshen: prewarm dispatches {before} -> {after}, shard 1 served "
        f"the next request with inline 0")
    for key, st in sorted(out["per_shard"].items()):      # before the drain
        log(f"  {key}: cold_starts {st['cold_starts']}, warm_acquires "
            f"{st['warm_acquires']}, prewarm_dispatches "
            f"{st['prewarm_dispatches']}, inline {st['inline']}, freshened "
            f"{st['freshened']}")
    eng.close()
    del ep, eng, cluster, results, futs, res
    torch.cuda.empty_cache()

    # ---- (c) out of process ------------------------------------------------
    os.environ[FABRIC_STORE_ENV] = store_root
    for backend in ("subprocess", "snapshot"):
        engb = ServingEngine()
        engines.append(engb)
        t0 = time.perf_counter()
        rt = engb.deploy(endpoint(spec_ref=FABRIC_SPEC_REF),
                         pool_config=pool_cfg, backend=backend)
        deploy_ms = _ms_since(t0)
        c0 = _counts(ops)
        seq = fabric_sequence(np, engb, rt, prompts[0], backend)
        check(_counts(ops) == c0, f"{backend}: a kernel launched in this "
              f"process, not in the instance")
        cold, fresh, warm = seq["cold"], seq["fresh"], seq["warm"]
        pid = cold["pid"]
        check(pid != os.getpid() and fresh["pid"] == warm["pid"] == pid,
              f"{backend}: pids {pid}, {fresh['pid']}, {warm['pid']} "
              f"(this process {os.getpid()})")
        check(cold["nvcc_built"] == [], f"{backend}: the instance ran nvcc "
              f"for {cold['nvcc_built']}")
        check(cold["launches"] == _times(per_fwd, 2)
              and _delta(cold["launches"], fresh["launches"])
              == _times(per_fwd, 2)
              and _delta(fresh["launches"], warm["launches"]) == per_fwd,
              f"{backend} instance launches: cold {cold['launches']}, "
              f"freshened {fresh['launches']}, warm {warm['launches']}")
        err, ok = _bf16_close(np, warm["logits"], want[0])
        check(ok, f"{backend}: logits differ from the thread backend's by "
              f"{err}")
        check(np.array_equal(warm["logits"].argmax(-1), want[0].argmax(-1)),
              f"{backend}: argmax tokens differ from the thread backend's")
        bits = bool(np.array_equal(warm["logits"], want[0]))
        pool = engb.scheduler.pool(FABRIC_NAME)
        stats = engb.platform_stats()[FABRIC_NAME]
        check(stats["backend"] == backend,
              f"the pool's stats name {stats['backend']}")
        row = {"deploy_ms": deploy_ms, "cold_ms": seq["cold_ms"],
               "freshen_ms": seq["freshen_ms"],
               "freshened_ms": seq["freshened_ms"], "warm_ms": seq["warm_ms"],
               "measured_cold_start_s": pool.measured_cold_start(),
               "worker_init_s": rt.backend.worker_init_seconds,
               "cold_timing": cold["timing"], "pid": pid,
               "launches": warm["launches"], "bit_equal": bits,
               "max_abs_err": err,
               **{k: cold[k] for k in ("import_torch_s", "import_s",
                                       "cuda_context_s", "memory_reserved",
                                       "max_memory_allocated")}}
        pids = [pid]
        if backend == "subprocess":
            row["spawn_s"] = rt.backend.spawn_seconds
            start = f"spawn and load {row['spawn_s'] * 1e3:.1f} ms"
        else:
            tpl = pool.template
            row.update(fork_s=rt.backend.fork_seconds,
                       restore_s=rt.backend.restore_seconds,
                       template_boot_s=tpl.template_boot_seconds,
                       template_probe_s=tpl.first_boot_seconds,
                       working_set=len(tpl.working_set))
            check(cold["pid_at_spec"] == tpl.template_pid,
                  f"the spec was built in {cold['pid_at_spec']}, not in the "
                  f"template {tpl.template_pid}")
            pids.append(tpl.template_pid)
            start = (f"fork {row['fork_s'] * 1e3:.1f} ms (template boot "
                     f"{row['template_boot_s'] * 1e3:.1f} ms once, with its "
                     f"probe {row['template_probe_s'] * 1e3:.1f} ms; "
                     f"{row['working_set']} modules prefetched)")
        out["backends"][backend] = row
        engb.close()
        left = _wait_gone(pids)
        check(not left, f"{backend}: processes {left} still run after close")
        t = row["cold_timing"]
        log(f"fabric {backend}: pid {pid}; measured cold start "
            f"{row['measured_cold_start_s'] * 1e3:.1f} ms = {start} + init "
            f"{row['worker_init_s'] * 1e3:.1f} ms (CUDA context "
            f"{row['cuda_context_s'] * 1e3:.1f} ms); import torch "
            f"{row['import_torch_s'] * 1e3:.1f} ms, with repro_torch "
            f"{row['import_s'] * 1e3:.1f} ms"
            + (" (in the template)" if backend == "snapshot" else "")
            + f"; cold invoke {row['cold_ms']:.1f} ms: weights "
            f"{t['weights'] * 1e3:.1f}, kernel library "
            f"{t['compile'] * 1e3:.1f}, warm-up {t['warmup'] * 1e3:.1f}, "
            f"execute {t['execute'] * 1e3:.1f}")
        log(f"fabric {backend}: freshen {row['freshen_ms']:.1f} ms, "
            f"freshened invoke {row['freshened_ms']:.1f} ms (inline 0), warm "
            f"invoke {row['warm_ms']:.1f} ms; instance memory reserved "
            f"{row['memory_reserved'] / 1e9:.3f} GB, peak allocated "
            f"{row['max_memory_allocated'] / 1e9:.3f} GB; K1 "
            f"{row['launches']['flash_attention']} launches in the instance; "
            f"logits vs thread backend max |diff| {err:.3e}, bit for bit "
            f"{bits}")
    th = out["backends"]["thread"]
    log(f"fabric thread: deploy {th['deploy_ms']:.1f} ms, cold invoke "
        f"{th['cold_ms']:.1f} ms (timing "
        f"{json.dumps({k: round(v * 1e3, 2) for k, v in th['cold_timing'].items()})}"
        f" ms), freshen {th['freshen_ms']:.1f} ms, freshened invoke "
        f"{th['freshened_ms']:.1f} ms, warm invoke {th['warm_ms']:.1f} ms")
    return out


# ---------------------------------------------------------------------------
# phase launch: the launch layer's sharded steps on a one-card mesh
LAUNCH_ARCH = "qwen2-0.5b"
LAUNCH_SERVE = (4, 128, 15)             # batch, prompt, decode steps
LAUNCH_TRAIN = (4, 1024, 2)             # batch, seq, steps
LAUNCH_GRAD_TOL = 1e-4                  # float32 gate, absolute
LAUNCH_REPEATS = 3


def _timed_ms(torch, fn, n=LAUNCH_REPEATS):
    """(median ms of ``n`` calls of ``fn``, waiting for the card after
    each; the last call's result)."""
    times, out = [], None
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return _median(times), out


def phase_launch(torch, np, ops, tmp_root, engines):
    """qwen2-0.5b uncut, bf16, through the launch layer's sharded steps
    (``launch/steps.py``) on ``make_host_mesh("cuda")``, an NCCL group of
    world size 1 ended at the phase's end: ``build_prefill_step`` on
    batch 4 x prompt 128 and 15 greedy ``build_decode_step`` steps held
    against the unsharded ``Model.prefill`` / ``decode_step``, bit for bit
    or within the bf16 tolerance with identical tokens (the phase says
    which), K1 24 per prefill and K2 24 per decode step, each in its own
    window; ``build_train_step`` for 2 steps of batch 4 x 1024 in
    ``TRAIN_MICROBATCHES`` microbatches, K1 132 and K1b 48 per step; each
    sharded step's ms beside the unsharded one's (at world size 1 the
    ratio is DTensor's host cost); then a float32 gate at 2 layers, 2 x
    256: the sharded loss and every gradient leaf within 1e-4 of the
    unsharded ones."""
    import gc

    import torch.distributed as dist

    from repro_torch.checkpoint import flatten_with_paths
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import make_model
    from repro_torch.sharding import distribute_tree
    from repro_torch.train import OptimizerConfig, make_train_step
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.trainer import loss_and_grads

    cfg = get_config(LAUNCH_ARCH)
    B, S, N = LAUNCH_SERVE
    mesh = make_host_mesh("cuda")
    out = {"mesh": f"{tuple(mesh.shape)} {mesh.mesh_dim_names} "
                   f"{dist.get_backend()} world {dist.get_world_size()}"}
    zero = dict.fromkeys(KERNEL_META, 0)
    try:
        gen = torch.Generator(device="cuda").manual_seed(21)
        model = make_model(cfg, device="cuda")
        params = model.init(gen)
        plain = make_model(cfg, device="cuda")
        toks = torch.as_tensor(np.random.default_rng(21).integers(
            0, cfg.vocab_size, (B, S), dtype=np.int32), device="cuda")
        pre, pspecs, _, _ = steps.build_prefill_step(
            model, InputShape("launch", S, B, "prefill"), mesh,
            max_len=S + N)
        dec, dspecs, _, _ = steps.build_decode_step(
            model, InputShape("launch", S + N, B, "decode"), mesh)
        p_sh = distribute_tree(params, pspecs[0])
        batch = distribute_tree({"tokens": toks}, pspecs[1])

        # ---- prefill and decode, each launch window on its own ---------
        with torch.no_grad():
            ops.reset_launches()
            logits, cache = pre(p_sh, batch)
            torch.cuda.synchronize()
            per_pre = _counts(ops)
            check(per_pre == dict(zero, flash_attention=cfg.n_layers),
                  f"the sharded prefill launched {per_pre}")
            want, wcache = plain.prefill(params, toks, max_len=S + N)
            got = logits.full_tensor()
            bits = [bool(torch.equal(got, want))]
            errs = [float((got.float() - want.float()).abs().max())]
            same_tok = True
            tok_s = got.argmax(-1).to(torch.int32)
            tok_p = want.argmax(-1).to(torch.int32)
            per_dec = []
            for t in range(N):
                pos = torch.full((B,), S + t, dtype=torch.int32,
                                 device="cuda")
                ops.reset_launches()
                logits, cache = dec(p_sh, cache,
                                    distribute_tree(tok_s, dspecs[2]),
                                    distribute_tree(pos, dspecs[3]))
                torch.cuda.synchronize()
                per_dec.append(_counts(ops))
                want, wcache = plain.decode_step(params, wcache, tok_p, pos)
                got = logits.full_tensor()
                bits.append(bool(torch.equal(got, want)))
                errs.append(float((got.float() - want.float()).abs().max()))
                tok_s = got.argmax(-1).to(torch.int32)
                tok_p = want.argmax(-1).to(torch.int32)
                same_tok &= bool(torch.equal(tok_s, tok_p))
            check(all(c == dict(zero, decode_attention=cfg.n_layers)
                      for c in per_dec),
                  f"the sharded decode steps launched {per_dec}")
            bit_for_bit = all(bits)
            check(bit_for_bit or (max(errs) <= TOL["bfloat16"]["atol"]
                                  and same_tok),
                  f"sharded serving against unsharded: max |diff| "
                  f"{max(errs)}, tokens identical {same_tok}")
            out["serve"] = dict(bit_for_bit=bit_for_bit,
                                steps_bit_for_bit=sum(bits),
                                max_abs_err=max(errs),
                                tokens_identical=same_tok,
                                prefill_launches=per_pre,
                                decode_launches=per_dec[0])
            # ---- host cost: sharded against unsharded -------------------
            ms_pre, _ = _timed_ms(torch, lambda: pre(p_sh, batch))
            ms_pre0, _ = _timed_ms(torch, lambda: plain.prefill(
                params, toks, max_len=S + N))
            tok_d = distribute_tree(tok_s, dspecs[2])
            pos_d = distribute_tree(pos, dspecs[3])
            ms_dec, _ = _timed_ms(torch, lambda: dec(p_sh, cache, tok_d,
                                                     pos_d), n=N)
            ms_dec0, _ = _timed_ms(torch, lambda: plain.decode_step(
                params, wcache, tok_p, pos), n=N)
        out["serve"].update(prefill_ms=ms_pre, prefill_plain_ms=ms_pre0,
                            decode_step_ms=ms_dec, decode_plain_ms=ms_dec0)
        log(f"launch serve ({LAUNCH_ARCH} uncut, bf16, mesh {out['mesh']}, "
            f"batch {B}, prompt {S}, {N} decode steps): logits "
            + ("bit for bit the unsharded ones at every step"
               if bit_for_bit else
               f"within {max(errs):.3e} of the unsharded ones "
               f"({sum(bits)}/{N + 1} steps bit for bit), tokens identical "
               f"{same_tok}")
            + f"; K1 {per_pre['flash_attention']} per prefill, K2 "
            f"{per_dec[0]['decode_attention']} per decode step; prefill "
            f"{ms_pre:.3f} ms vs unsharded {ms_pre0:.3f} ms (ratio "
            f"{ms_pre / ms_pre0:.3f}), decode step {ms_dec:.3f} ms vs "
            f"{ms_dec0:.3f} ms (ratio {ms_dec / ms_dec0:.3f})")
        del cache, wcache, logits, batch
        gc.collect()
        torch.cuda.empty_cache()

        # ---- training ----------------------------------------------------
        TB, TS, TSTEPS = LAUNCH_TRAIN
        tstep, tspecs, _, M = steps.build_train_step(
            model, InputShape("launch", TS, TB, "train"), mesh)
        ustep = make_train_step(plain, OptimizerConfig(), num_microbatches=M,
                                seq_chunk=min(512, TS))
        rng = np.random.default_rng(22)
        tb = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (TB, TS),
                                              dtype=np.int32), device="cuda")
              for k in ("tokens", "targets")}
        opt = init_opt_state(params)
        state = (distribute_tree(params, tspecs[0]),
                 distribute_tree(opt, tspecs[1]))
        tb_sh = distribute_tree(tb, tspecs[2])
        ms_t, losses, per_step = [], [], []
        for i in range(TSTEPS):
            ops.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p_new, o_new, met = tstep(*state, tb_sh)
            losses.append(float(met["loss"].full_tensor()))
            ms_t.append((time.perf_counter() - t0) * 1e3)
            per_step.append(_counts(ops))
            state = (p_new, o_new)
        want_step = dict(zero, **{k: v for k, v in train_window(cfg, M).items()
                                  if k in ("flash_attention",
                                           "flash_attention_bwd")})
        check(all(c == want_step for c in per_step),
              f"the sharded train steps launched {per_step}, not {want_step}")
        del state
        gc.collect()
        ms_u, ulosses = [], []
        ustate = (params, opt)
        for i in range(TSTEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p_new, o_new, met = ustep(*ustate, tb)
            ulosses.append(float(met["loss"]))
            ms_u.append((time.perf_counter() - t0) * 1e3)
            ustate = (p_new, o_new)
        del ustate, p_new, o_new
        check(all(np.isfinite(losses)), f"sharded losses {losses}")
        out["train"] = dict(step_ms=ms_t, plain_step_ms=ms_u, losses=losses,
                            plain_losses=ulosses, microbatches=M,
                            launches=per_step[0])
        log(f"launch train ({LAUNCH_ARCH} uncut, bf16, batch {TB} x {TS}, "
            f"{M} microbatches): step ms {[round(x, 3) for x in ms_t]} vs "
            f"unsharded {[round(x, 3) for x in ms_u]} (ratio of the last "
            f"{ms_t[-1] / ms_u[-1]:.3f}); losses {losses} vs {ulosses}; per "
            f"step K1 {per_step[0]['flash_attention']}, K1b "
            f"{per_step[0]['flash_attention_bwd']}")
        del params, p_sh
        gc.collect()
        torch.cuda.empty_cache()

        # ---- float32 gate -------------------------------------------------
        _no_tf32(torch)
        cfg32 = dataclasses.replace(cfg, dtype="float32", n_layers=2,
                                    segments=((("attn",), 2),))
        m32 = make_model(cfg32, device="cuda")
        p32 = m32.init(torch.Generator(device="cuda").manual_seed(23))
        gb = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 256),
                                              dtype=np.int32), device="cuda")
              for k in ("tokens", "targets")}
        _, gspecs, _, _ = steps.build_train_step(
            m32, InputShape("gate", 256, 2, "train"), mesh, microbatches=1)
        l0, _, g0 = loss_and_grads(make_model(cfg32, device="cuda"), p32,
                                   gb, 256)
        l1, _, g1 = loss_and_grads(m32, distribute_tree(p32, gspecs[0]),
                                   distribute_tree(gb, gspecs[2]), 256,
                                   m32.constrain)
        f0, f1 = flatten_with_paths(g0), flatten_with_paths(g1)
        gerr = {k: float((f1[k].full_tensor() - f0[k]).abs().max())
                for k in f0}
        worst = max(gerr, key=gerr.get)
        lerr = abs(float(l1.full_tensor()) - float(l0))
        log(f"launch float32 gate ({LAUNCH_ARCH} full width, 2 layers, batch "
            f"2 x 256): loss {float(l1.full_tensor()):.6f} vs unsharded "
            f"{float(l0):.6f} (|diff| {lerr:.3e}); {len(gerr)} gradient "
            f"leaves, worst |diff| {gerr[worst]:.3e} at {worst} (limit "
            f"{LAUNCH_GRAD_TOL})")
        check(lerr <= LAUNCH_GRAD_TOL and gerr[worst] <= LAUNCH_GRAD_TOL,
              f"the float32 gate: loss {lerr}, {worst} {gerr[worst]}")
        out["gate"] = dict(loss_err=lerr, grad_err=gerr[worst],
                           worst_leaf=worst)
    finally:
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
    out["launches"] = {k: out["serve"]["prefill_launches"][k]
                       + N * out["serve"]["decode_launches"][k]
                       + TSTEPS * out["train"]["launches"][k]
                       for k in KERNEL_META}
    return out


# ---------------------------------------------------------------------------
# phase train: the port's training entry point on the card
# K1b's shapes: (label, B, Sq, Sk, Hq, Hkv, dh, dv, causal, window, softcap,
# scale, q_offset, types).  qwen2's training shape, gemma2's softcap at dh
# 128, MLA's dh 192 / dv 128 (v a strided view), recurrentgemma's dh 256
# at G 10 with its window (a long prompt, and the training microbatch that
# train_full hands K1 and K1b), then the edges: ragged S, a window across
# tiles, Sq < Sk with q_offset, non-causal, dv > dh, dh 256 in float32
BOTH = ("float32", "bfloat16")
# K1b's bfloat16 gradients, beyond the element check at TOL (whose atol is
# of the size of most gradient elements here): each must be its float32
# gradient rounded once, |got - g32| <= 2**-8 |g32| (half a bf16 ulp) plus
# the float32 TOL for the reassociated sums, and its largest error at most
# BWD_BF16_SCALED_TOL of its largest element (one ulp is at most 2**-7)
BF16_HALF_ULP = 2.0 ** -8
BWD_BF16_SCALED_TOL = 1e-2
BWD_CASES = [
    ("qwen2", 4, 1024, 1024, 14, 2, 64, 64, True, None, None, None, 0, BOTH),
    ("gemma2", 1, 1024, 1024, 32, 16, 128, 128, True, None, 50.0,
     (4608 / 32) ** -0.5, 0, BOTH),
    ("mla", 2, 512, 512, 16, 16, 192, 128, True, None, None, 192 ** -0.5, 0,
     BOTH),
    ("rgemma", 1, 2048, 2048, 10, 1, 256, 256, True, 2048, None, None, 0,
     ("bfloat16",)),
    ("rgemma_train", 2, 1024, 1024, 10, 1, 256, 256, True, 2048, None, None,
     0, BOTH),
    ("ragged", 2, 100, 100, 4, 2, 64, 64, True, None, None, None, 0, BOTH),
    ("window", 1, 300, 300, 4, 1, 128, 128, True, 64, 30.0, None, 0, BOTH),
    ("q_offset", 2, 70, 300, 4, 2, 64, 64, True, 200, None, None, 230, BOTH),
    ("non-causal", 1, 128, 128, 4, 2, 32, 32, False, None, None, None, 0, BOTH),
    ("dv>dh", 1, 128, 128, 2, 1, 64, 128, True, None, None, None, 0, BOTH),
    ("dh256-f32", 1, 256, 256, 10, 1, 256, 256, True, 64, None, None, 0,
     ("float32",)),
]
TRAIN_GRAD_TOL = 1e-4     # per leaf: max |g_kernels - g_plain| / max |g_plain|
TRAIN_LOSS_TOL = 1e-4     # each step's loss, relative, kernels vs plain


def _bwd_inputs(torch, gen, case, dtype):
    """q, k, v, do and the keywords of one K1b case; MLA's v is a view of
    the (nope + v)-wide latent expansion, as the model hands it over."""
    (_, B, Sq, Sk, Hq, Hkv, dh, dv, causal, window, softcap, scale,
     q_offset, _) = case
    q = _rand(torch, gen, (B, Sq, Hq, dh), dtype)
    k = _rand(torch, gen, (B, Sk, Hkv, dh), dtype)
    if dh == 192:
        v = _rand(torch, gen, (B, Sk, Hkv, 2 * dv), dtype)[..., dv:]
    else:
        v = _rand(torch, gen, (B, Sk, Hkv, dv), dtype)
    do = _rand(torch, gen, (B, Sq, Hq, dv), dtype)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
              q_offset=q_offset)
    return q, k, v, do, kw


def _bf16_grad_errs(torch, got, want, want32):
    """A bfloat16 gradient against the plain version's (``want``) and its
    float32 gradient before the cast (``want32``): (largest error over the
    largest element, largest excess over half an ulp plus the float32
    TOL, relative L2 error)."""
    got, want = got.float(), want.float()
    top = float(want.abs().max())
    scaled = float((got - want).abs().max()) / max(top, 1e-30)
    tol = TOL["float32"]
    bound = ((BF16_HALF_ULP + tol["rtol"]) * want32.abs() + tol["atol"])
    excess = float(((got - want32).abs() - bound).max())
    rel_l2 = float(torch.linalg.vector_norm(got - want)
                   / torch.linalg.vector_norm(want).clamp_min(1e-30))
    return scaled, excess, rel_l2


def _k1b_body_of(name):
    """(the body a K1b launch in type ``name`` must run, the other)."""
    return ("wgmma", "scalar") if name == "bfloat16" else ("scalar", "wgmma")


def k1b_bodies_child() -> int:
    """Run in a fresh process by ``k1b_bodies``: K1b on each
    ``BWD_CASES`` row and type under the profiler, until a session shows
    both of its body's kernels (dkdv and dq) and none of the other's, at
    most 3 sessions, each launch behind a spin of about 10 ms.  Prints
    {"case/type": {"bodies": {...}, "sessions": n}} as its last line.
    A fresh process, because short sessions that follow other profiler
    passes in the same process lose device events (all of them, after
    the served phases' passes)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(4321)
    out = {}
    for case in BWD_CASES:
        for name in case[-1]:
            q, k, v, do, kw = _bwd_inputs(torch, gen, case,
                                          getattr(torch, name))
            o, lse = ops.flash_attention.launch_kernel(q, k, v,
                                                       return_lse=True, **kw)
            body, other = _k1b_body_of(name)
            for n in range(1, 4):
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    torch.cuda._sleep(20_000_000)
                    ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
                    torch.cuda.synchronize()
                names = {e.name for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA}
                bodies = {b: sorted({m.group(0) for x in names
                                     for m in [pat.search(x)] if m})
                          for b, pat in (("wgmma", K1B_WGMMA),
                                         ("scalar", K1B_SCALAR))}
                if len(bodies[body]) == 2 and not bodies[other]:
                    break
            out[f"{case[0]}/{name}"] = dict(bodies=bodies, sessions=n)
    print(json.dumps(out), flush=True)
    return 0


def k1b_bodies(timeout=600):
    """``k1b_bodies_child`` in a fresh process: the device kernels each
    K1b case ran, by body."""
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            f"import chip_smoke; sys.exit(chip_smoke.k1b_bodies_child())")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=timeout)
    check(res.returncode == 0, f"the K1b body check failed: {res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def train_parity(torch, ops, ref):
    """K1's row log-sum-exp and K1b's (dq, dk, dv) against their plain
    versions on the same inputs (K1b and its plain version both get K1's
    output and lse), at the TOL of each type, TF32 off; K1b's bfloat16
    gradients also against their float32 gradients (``_bf16_grad_errs``).
    K1b runs twice on each case's inputs, and the two results must be bit
    for bit the same; under the profiler (``k1b_bodies``, a fresh
    process), its device kernels must be the tensor-core body's for
    bfloat16 and the scalar body's for float32."""
    _no_tf32(torch)
    ran = k1b_bodies()
    gen = torch.Generator(device="cuda").manual_seed(4321)
    errs = {"lse": {n: 0.0 for n in BOTH},
            "flash_attention_bwd": {n: 0.0 for n in BOTH}}
    bf16 = {"scaled": 0.0, "excess": -1.0, "rel_l2": 0.0}
    n = 0
    for case in BWD_CASES:
        for name in case[-1]:
            dtype = getattr(torch, name)
            q, k, v, do, kw = _bwd_inputs(torch, gen, case, dtype)
            if case[0] == "ragged":
                # a do whose head dimension is strided: K1b copies it
                do = do.transpose(2, 3).contiguous().transpose(2, 3)
            out, lse = ops.flash_attention.launch_kernel(q, k, v,
                                                         return_lse=True, **kw)
            torch.cuda.synchronize()
            r_out, r_lse = ref.flash_attention_ref(q, k, v, return_lse=True,
                                                   **kw)
            e, ok = _err(torch, lse, r_lse, name)
            errs["lse"][name] = max(errs["lse"][name], e)
            check(ok and lse.shape == r_lse.shape,
                  f"K1 lse {name} case {case[0]}: max abs err {e}")
            e, ok = _err(torch, out, r_out, name)
            check(ok, f"K1 (with lse) {name} case {case[0]}: max abs err {e}")
            got = ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
            torch.cuda.synchronize()
            again = ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"K1b {name} case {case[0]}: a second launch on the same "
                  f"inputs gave other gradients")
            body, other = _k1b_body_of(name)
            bodies = ran[f"{case[0]}/{name}"]["bodies"]
            check(len(bodies[body]) == 2 and not bodies[other],
                  f"K1b {name} case {case[0]} ran {bodies} under the "
                  f"profiler, not the {body} body's dkdv and dq")
            want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
            want32 = (ref.flash_attention_bwd_ref(
                q.float(), k.float(), v.float(), out.float(), lse,
                do.float(), **kw) if name == "bfloat16" else want)
            for gname, a, b, b32 in zip(("dq", "dk", "dv"), got, want,
                                        want32):
                check(a.shape == b.shape and a.dtype == b.dtype,
                      f"K1b {gname} {tuple(a.shape)} {a.dtype}")
                e, ok = _err(torch, a, b, name)
                errs["flash_attention_bwd"][name] = max(
                    errs["flash_attention_bwd"][name], e)
                check(ok, f"K1b {name} case {case[0]} {gname}: max abs err "
                      f"{e}")
                if name != "bfloat16":
                    continue
                scaled, excess, rel_l2 = _bf16_grad_errs(torch, a, b, b32)
                bf16 = {"scaled": max(bf16["scaled"], scaled),
                        "excess": max(bf16["excess"], excess),
                        "rel_l2": max(bf16["rel_l2"], rel_l2)}
                check(scaled <= BWD_BF16_SCALED_TOL,
                      f"K1b bfloat16 case {case[0]} {gname}: max abs err "
                      f"over max |grad| {scaled:.3e} > {BWD_BF16_SCALED_TOL}")
                check(excess <= 0.0,
                      f"K1b bfloat16 case {case[0]} {gname}: not its float32 "
                      f"gradient rounded once (excess {excess:.3e} over half "
                      f"an ulp plus the float32 tolerance)")
            n += 1
            log(f"train parity {case[0]} {name}: lse and dq/dk/dv within "
                f"tolerance; 2 launches bit for bit; K1b ran "
                f"{', '.join(bodies[body])} (profiled session "
                f"{ran[f'{case[0]}/{name}']['sessions']})")
    log(f"train parity: K1 lse max abs err f32 {errs['lse']['float32']:.3e} "
        f"bf16 {errs['lse']['bfloat16']:.3e}; K1b max abs err f32 "
        f"{errs['flash_attention_bwd']['float32']:.3e} bf16 "
        f"{errs['flash_attention_bwd']['bfloat16']:.3e} over {n} cases; "
        f"K1b bf16 max abs err over max |grad| {bf16['scaled']:.3e} (limit "
        f"{BWD_BF16_SCALED_TOL}), relative L2 error {bf16['rel_l2']:.3e}, "
        f"largest excess over half an ulp of the float32 gradient plus the "
        f"float32 tolerance {bf16['excess']:.3e} (limit 0): ok")
    errs["bwd_bf16"] = bf16
    return errs


def grad_raises(torch, ops):
    """K2 has no backward (the reference never differentiates a decode
    step): on CUDA tensors that require grad it must raise, never hand
    back a tensor cut from the graph.  The RG-LRU scan under grad takes
    ``RGLRUScanFunction``: its output has a ``grad_fn``, the forward
    launches K3 once and the backward K3b once, also when y and h_T reach
    the loss through reductions (expanded cotangents)."""
    c0 = _counts(ops)
    q = torch.randn((2, 1, 4, 64), device="cuda", requires_grad=True)
    kc = torch.randn((2, 32, 2, 64), device="cuda")
    pos = torch.tensor([5, 9], dtype=torch.int32, device="cuda")
    try:
        ops.decode_attention(q, kc, kc, pos)
    except NotImplementedError as e:
        log(f"train: decode_attention under grad raises "
            f"NotImplementedError: {e}")
    else:
        raise SmokeFailure("decode_attention on CUDA tensors that require "
                           "grad did not raise")
    check(_counts(ops) == c0, "a refused call launched a kernel")
    a = torch.rand((2, 16, 64), device="cuda", requires_grad=True)
    b = torch.randn((2, 16, 64), device="cuda", requires_grad=True)
    y, _ = ops.rglru_scan(a, b)
    check(type(y.grad_fn).__name__ == "RGLRUScanFunctionBackward",
          f"rglru_scan under grad gave a y with grad_fn {y.grad_fn}")
    fwd = _delta(c0, _counts(ops))
    torch.autograd.grad(y, (a, b), torch.randn_like(y))
    torch.cuda.synchronize()
    both = _delta(c0, _counts(ops))
    want = dict.fromkeys(both, 0)
    check(fwd == dict(want, rglru_scan=1)
          and both == dict(want, rglru_scan=1, rglru_scan_bwd=1),
          f"rglru_scan under grad launched {fwd}, then with its backward "
          f"{both}")
    # y and h_T reach the loss through reductions: autograd hands the
    # backward expanded cotangents (strides of 0), which K3b must get in
    # a layout it reads; the gradients equal the plain versions' bit for bit
    c1 = _counts(ops)
    h0 = torch.randn((2, 64), device="cuda", requires_grad=True)
    y2, hT = ops.rglru_scan(a, b, h0)
    got = torch.autograd.grad(y2.sum() + hT.sum(), (a, b, h0))
    torch.cuda.synchronize()
    reduced = _delta(c1, _counts(ops))
    with ops.force_reference():
        y2, hT = ops.rglru_scan(a, b, h0)
        plain = torch.autograd.grad(y2.sum() + hT.sum(), (a, b, h0))
    check(reduced == dict(want, rglru_scan=1, rglru_scan_bwd=1),
          f"rglru_scan under grad with reduced outputs launched {reduced}")
    check(all(torch.equal(g, p) for g, p in zip(got, plain)),
          "rglru_scan under grad with reduced outputs: K3b's gradients are "
          "not the plain version's bit for bit")
    log(f"train: rglru_scan under grad has grad_fn "
        f"{type(y.grad_fn).__name__}; forward and backward launched "
        f"{ {k: v for k, v in both.items() if v} }; with y and h_T reduced "
        f"(expanded cotangents) the same launches and the plain "
        f"version's gradients bit for bit")


def _rel_err(a, b) -> float:
    """max |a - b| over max |b| (0 when both are 0)."""
    scale = float(b.abs().max())
    diff = float((a.float() - b.float()).abs().max())
    return diff / scale if scale else diff


# the float32 training gates: (architecture, cuts, the loss and grads'
# launches).  qwen2-0.5b cut to 2 layers; recurrentgemma-2b cut to both of
# its segment shapes once (5 layers) with the window cut to 128 at S 256,
# so that K1b's window binds inside the model.  Remat runs each
# super-block twice (R < 4): a forward and its recomputation.
TRAIN_GATES = (
    ("qwen2-0.5b", dict(n_layers=2, segments=((("attn",), 2),)),
     dict(flash_attention=4, flash_attention_bwd=2)),
    ("recurrentgemma-2b",
     dict(n_layers=5, segments=((("rglru", "rglru", "attn_local"), 1),
                                (("rglru", "rglru"), 1)), window_size=128),
     dict(flash_attention=2, flash_attention_bwd=1, rglru_scan=8,
          rglru_scan_bwd=4)),
)


def train_gate(torch, np, ops, arch, cuts, want):
    """``arch`` at full width with ``cuts``, float32, TF32 off: the loss
    and every gradient leaf through the kernels (K1/K1b, K3/K3b) against
    the same under ``force_reference()``, then 5 ``Trainer`` steps on
    each path from the same params and batches, loss curves compared
    step by step."""
    from repro_torch.checkpoint import flatten_with_paths, tree_map
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, packed_batches
    from repro_torch.models import make_model
    from repro_torch.train import (OptimizerConfig, Trainer, TrainerConfig,
                                   loss_and_grads)
    _no_tf32(torch)
    cfg = dataclasses.replace(get_config(arch), dtype="float32", **cuts)
    B, S, STEPS = 2, 256, 5
    data = packed_batches(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                     batch_size=B, seed=7))
    batches = [next(data) for _ in range(STEPS)]
    model = make_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in batches[0].items()}
    c0 = _counts(ops)
    lk, _, gk = loss_and_grads(model, params, batch, seq_chunk=128)
    torch.cuda.synchronize()
    got = _delta(c0, _counts(ops))
    check(got == dict(dict.fromkeys(got, 0), **want),
          f"the {arch} gate's loss and grads launched {got}, not {want}")
    c0 = _counts(ops)
    with ops.force_reference():
        lr, _, gr = loss_and_grads(model, params, batch, seq_chunk=128)
    check(_counts(ops) == c0, "the force_reference gradients launched a "
          "kernel")
    gk, gr = flatten_with_paths(gk), flatten_with_paths(gr)
    errs = {k: _rel_err(gk[k], gr[k]) for k in gr}
    worst = max(errs, key=errs.get)
    loss_err = abs(float(lk) - float(lr)) / abs(float(lr))
    log(f"train gate ({arch} full width, {cfg.n_layers} layers, float32, "
        f"batch {B}, seq {S}, window {cfg.window_size}; launches {want}): "
        f"loss {float(lk):.6f} vs plain {float(lr):.6f} (rel "
        f"{loss_err:.3e}); grads of {len(errs)} leaves, worst max |diff| / "
        f"max |plain| {errs[worst]:.3e} at {worst} (limit {TRAIN_GRAD_TOL})")
    check(loss_err <= TRAIN_LOSS_TOL, f"gate loss differs by {loss_err}")
    check(errs[worst] <= TRAIN_GRAD_TOL,
          f"gate grad {worst} differs by {errs[worst]}")

    def curve(reference):
        p0 = tree_map(lambda t: t.clone(), params)
        tr = Trainer(model, OptimizerConfig(peak_lr=1e-3, warmup_steps=1,
                                            total_steps=STEPS),
                     TrainerConfig(steps=STEPS), iter(batches), params=p0)
        with ops.force_reference() if reference else contextlib.nullcontext():
            return [h["loss"] for h in tr.run()]
    ck, cr = curve(False), curve(True)
    curve_err = max(abs(a - b) / abs(b) for a, b in zip(ck, cr))
    log(f"train gate {arch}, {STEPS} Trainer steps: losses {[round(x, 6) for x in ck]}"
        f" vs plain {[round(x, 6) for x in cr]}; worst rel diff "
        f"{curve_err:.3e} (limit {TRAIN_LOSS_TOL})")
    check(all(np.isfinite(ck)) and curve_err <= TRAIN_LOSS_TOL,
          f"gate loss curves differ by {curve_err}")
    return dict(loss_rel_err=loss_err, grad_rel_err=errs[worst],
                grad_worst_leaf=worst, curve_rel_err=curve_err,
                curve=ck, curve_plain=cr, launches=got)


def train_window(cfg, MB):
    """Launches per training step of ``cfg`` in ``MB`` microbatches under
    remat (``models/transformer.py``): a segment of R super-blocks runs
    in groups of k = ``_sqrt_divisor(R)`` (k = 1 below R 4); each group
    runs its super-blocks once forward, again in its recomputation up to
    its last one (whose input is all the group's backward needs) and once
    more in each one's own backward: 3k - 1 super-block runs a group, 2 a
    super-block without groups.  Each run launches K1 per attention
    layer and K3 per RG-LRU layer; the backward K1b and K3b once per
    layer."""
    from repro_torch.models import transformer
    per = dict.fromkeys(KERNEL_META, 0)
    for pattern, R in cfg.segments:
        k = transformer._sqrt_divisor(R) if R >= 4 else 1
        runs = (R // k) * (3 * k - 1) if k > 1 else 2 * R
        n_attn = sum(kind in ("attn", "attn_local") for kind in pattern)
        n_rec = pattern.count("rglru")
        per["flash_attention"] += MB * runs * n_attn
        per["flash_attention_bwd"] += MB * R * n_attn
        per["rglru_scan"] += MB * runs * n_rec
        per["rglru_scan_bwd"] += MB * R * n_rec
    return per


def train_full(torch, np, ops, arch, trace_dir):
    """``arch`` uncut in bfloat16 through ``Trainer``: 10 steps of batch
    4 x 1024 tokens from ``packed_batches`` in 2 microbatches at the
    launcher's defaults, its launch window checked, then one profiled
    step."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, packed_batches
    from repro_torch.models import make_model
    from repro_torch.train import OptimizerConfig, Trainer, TrainerConfig
    cfg = get_config(arch)
    B, S, MB, STEPS = 4, 1024, 2, 10
    t0 = time.perf_counter()
    data = packed_batches(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                     batch_size=B, seed=0))
    batches = [next(data) for _ in range(STEPS + 1)]     # set-up, not steps
    data_s = time.perf_counter() - t0
    model = make_model(cfg, device="cuda")
    trainer = Trainer(model, OptimizerConfig(peak_lr=1e-3,
                                             warmup_steps=STEPS // 10,
                                             total_steps=STEPS),
                      TrainerConfig(steps=STEPS, num_microbatches=MB),
                      iter(batches[:STEPS]),
                      generator=torch.Generator(device="cuda").manual_seed(0))
    log(f"train: {cfg.name} uncut, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}, {cfg.param_count() / 1e6:.1f} M "
        f"params; batch {B} x {S} tokens in {MB} microbatches, {STEPS} "
        f"steps (data made in {data_s:.1f} s)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                      # the training path's run starts
    hist = trainer.run()
    launches = _counts(ops)                   # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist]
    log(f"train {arch} losses {[round(x, 4) for x in losses]}, grad norms "
        f"{[round(h['grad_norm'], 3) for h in hist]}")
    check(all(np.isfinite(losses)), f"a training loss is not finite: {losses}")
    check(np.mean(losses[-3:]) < losses[0],
          f"the loss did not fall: {losses[0]} -> {losses[-3:]}")
    per_step = train_window(cfg, MB)
    check(launches == _times(per_step, STEPS),
          f"{arch} training launches {launches} != {STEPS} x {per_step}")
    step_s = sorted(h["seconds"] for h in hist[1:])
    step_ms = step_s[len(step_s) // 2] * 1e3
    res = dict(launches=launches, steps=STEPS, losses=losses,
               step_ms=step_ms, first_step_ms=hist[0]["seconds"] * 1e3,
               tokens_per_s=B * S / (step_ms / 1e3), peak_bytes=peak)
    log(f"train {arch}: step median {step_ms:.1f} ms (first "
        f"{res['first_step_ms']:.1f} ms), {res['tokens_per_s']:.0f} tokens/s, "
        f"peak memory {peak / 1e9:.2f} GB; launches per step "
        f"{ {n: c // STEPS for n, c in launches.items()} }")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(batches[STEPS])
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    out_dir = Path(trace_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out_dir / "train_step_trace.json"))
    if not kern:
        log(f"train {arch} profile: the profiler recorded no device events: "
            f"device time not measured")
        return res
    by_name: dict = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    # K1b: both bodies' dkdv and dq kernels, and the delta and reduce
    # kernels they share; the bf16 step must have run the tensor-core body
    k1b_by = {}
    for n, us in by_name.items():
        m = K1B_WGMMA.search(n) or K1B_SCALAR.search(n) or re.search(
            r"bwd_(delta|reduce)_kernel", n)
        if m:
            k1b_by[m.group(0)] = k1b_by.get(m.group(0), 0.0) + us
    check(sum(1 for n in k1b_by if K1B_WGMMA.match(n)) == 2
          and not any(K1B_SCALAR.match(n) for n in k1b_by),
          f"the bf16 training step ran K1b's {sorted(k1b_by)}, not the "
          f"tensor-core body")
    k1b = sum(k1b_by.values())
    k1 = sum(us for n, us in by_name.items()
             if re.search(r"flash_(fwd|wgmma)_kernel", n))
    k3 = sum(us for n, us in by_name.items() if "rglru_scan_kernel" in n)
    k3b = sum(us for n, us in by_name.items()
              if "rglru_scan_bwd_kernel" in n)
    check((k3b > 0) == (per_step["rglru_scan_bwd"] > 0),
          f"the profiled {arch} step shows {k3b} us of K3b's device kernel "
          f"for {per_step['rglru_scan_bwd']} launches a step")
    res.update(profile_wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
               device_events=len(kern), idle_share=1 - busy / wall_us,
               k1b_ms=k1b / 1e3, k1b_share=k1b / busy, k1_ms=k1 / 1e3,
               k1_share=k1 / busy, k3_ms=k3 / 1e3, k3_share=k3 / busy,
               k3b_ms=k3b / 1e3, k3b_share=k3b / busy,
               k1b_kernels_ms={n: us / 1e3 for n, us in k1b_by.items()})
    log(f"train {arch} profile (one step): wall {wall_us / 1e3:.1f} ms, "
        f"device busy {busy / 1e3:.2f} ms in {len(kern)} device events, idle "
        f"share {res['idle_share']:.3f}; K1b {k1b / 1e3:.2f} ms "
        f"({res['k1b_share']:.1%} of device time), K1 {k1 / 1e3:.2f} ms "
        f"({res['k1_share']:.1%}), K3b {k3b / 1e3:.2f} ms "
        f"({res['k3b_share']:.1%}), K3 {k3 / 1e3:.2f} ms "
        f"({res['k3_share']:.1%}); K1b by kernel "
        + ", ".join(f"{n} {us / 1e3:.2f} ms" for n, us in
                    sorted(k1b_by.items(), key=lambda kv: -kv[1])))
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"train {arch} profile top: {us / 1e3:8.3f} ms ({us / busy:.1%})"
            f"  {name[:90]}")
    table = prof.key_averages().table(sort_by="self_cpu_time_total",
                                      row_limit=12)
    (out_dir / "profile_table.txt").write_text(table)
    log(f"train {arch} profile host ops by self CPU time (one step, "
        f"profiler on):")
    for line in table.splitlines()[:16]:
        log(f"  {line[:150]}")
    return res


def phase_train(torch, np, ops, ref):
    """Training on the card: K1's lse and K1b against their plain
    versions, K2 refusing grad and the scan taking its Function, the
    float32 gates, then full-width bf16 qwen2-0.5b and recurrentgemma-2b
    through ``Trainer``, each model freed before the next."""
    import gc
    out = {"errs": train_parity(torch, ops, ref)}
    grad_raises(torch, ops)
    out["gates"] = {arch: train_gate(torch, np, ops, arch, cuts, want)
                    for arch, cuts, want in TRAIN_GATES}
    out["full"] = {}
    for arch, trace in (("qwen2-0.5b", "train"),
                        ("recurrentgemma-2b", "train_rgemma")):
        gc.collect()
        torch.cuda.empty_cache()
        out["full"][arch] = train_full(torch, np, ops, arch,
                                       ROOT / "build" / "profile" / trace)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase rollout: a trained version reaching a served endpoint, and the
# example chain with freshen off and on
ROLLOUT_ARCH = "qwen2-0.5b"
ROLLOUT_NAME = "qwen2"
ROLLOUT_SHAPE = (4, 128)                # batch, prompt: the served shape
ROLLOUT_TRAIN = (4, 1024, 2)            # batch, sequence, microbatches
ROLLOUT_STEPS = {2: 2, 3: 1}            # Trainer steps to make v2, v3
ROLLOUT_REQUESTS = 8                    # through the chain, per mode


def rollout_invoke(np, ops, eng, rt, prompt, per_fwd, case, *, forwards):
    """One invoke of the rollout's endpoint on ``eng``: its ms, the
    ``timing`` parts, the runtime's freshen stats and its inline count by
    entry, and its K1 launches, which must be ``forwards`` forwards'."""
    c0 = _counts(ops)
    t0 = time.perf_counter()
    res = eng.invoke(ROLLOUT_NAME, prompt, freshen_successors=False)
    ms = _ms_since(t0)
    rt.join_freshen(timeout=CHAIN_JOIN_S)
    launches = _delta(c0, _counts(ops))
    check(launches == _times(per_fwd, forwards),
          f"rollout {case}: launches {launches} != {forwards} forwards of "
          f"{per_fwd}")
    logits = res["logits"]
    check(logits.shape == (prompt.shape[0], 1, logits.shape[-1])
          and bool(np.isfinite(logits).all()),
          f"rollout {case}: logits {logits.shape} not finite or misshapen")
    out = dict(ms=ms, timing=res["timing"], stats=rt.fr_state.stats(),
               inline=[e.inline_count for e in rt.fr_state.entries],
               launches=launches, logits=logits)
    timing_ms = {k: round(v * 1e3, 2) for k, v in res["timing"].items()}
    log(f"rollout {case}: invoke {ms:.1f} ms (timing "
        f"{json.dumps(timing_ms)} ms), stats {out['stats']}, "
        f"inline by entry {out['inline']}, K1 {launches['flash_attention']} "
        f"= {forwards} x {per_fwd['flash_attention']}")
    return out


def rollout_train(torch, np, ops, cfg, params, version):
    """``examples/train_small``'s body on the card from ``params``: batch
    4 x 1024 in 2 microbatches, its own launch window (K1 132 and K1b 48
    a step under remat)."""
    from repro_torch.examples import train_small
    from repro_torch.train import OptimizerConfig
    B, S, MB = ROLLOUT_TRAIN            # train_small's 2 microbatches
    steps = ROLLOUT_STEPS[version]
    c0 = _counts(ops)
    t0 = time.perf_counter()
    trainer = train_small.train(
        cfg, "cuda", params, steps=steps, batch=B, seq=S,
        opt_cfg=OptimizerConfig(peak_lr=1e-3, warmup_steps=1,
                                total_steps=steps))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _delta(c0, _counts(ops))
    per_step = train_window(cfg, MB)
    check(launches == _times(per_step, steps),
          f"rollout v{version} training launches {launches} != {steps} x "
          f"{per_step}")
    hist = trainer.history
    check(all(np.isfinite(h["loss"]) for h in hist),
          f"rollout v{version} training losses {hist}")
    log(f"rollout v{version}: {steps} Trainer steps (batch {B} x {S}, {MB} "
        f"microbatches) in {wall:.2f} s, losses "
        f"{[round(h['loss'], 4) for h in hist]}, step ms "
        f"{[round(h['seconds'] * 1e3, 1) for h in hist]}; K1 "
        f"{launches['flash_attention']}, K1b "
        f"{launches['flash_attention_bwd']} = {steps} x "
        f"{per_step['flash_attention']} / {per_step['flash_attention_bwd']}")
    return trainer.params, dict(steps=steps, wall_s=wall, launches=launches,
                                losses=[h["loss"] for h in hist],
                                step_ms=[h["seconds"] * 1e3 for h in hist])


def rollout_fresh(np, cfg, params, tmp_root, prompt, engines):
    """The logits of a fresh endpoint on a store holding only ``params``."""
    from repro_torch.serving import (Executor, ModelEndpoint, ServingEngine,
                                     WeightStore)
    store = WeightStore(tempfile.mkdtemp(dir=tmp_root, prefix="only-"))
    store.publish(ROLLOUT_NAME, params)
    eng = ServingEngine()
    engines.append(eng)
    B, S = ROLLOUT_SHAPE
    eng.deploy(ModelEndpoint(ROLLOUT_NAME, cfg, store, Executor(),
                             batch_size=B, seq_len=S, device="cuda"))
    return eng.invoke(ROLLOUT_NAME, prompt, freshen_successors=False)["logits"]


def rollout_versions(torch, np, ops, cfg, tmp_root, engines):
    """The quickstart's cases at model scale on one endpoint served from
    a store that holds v1 (seed 0): a cold invoke; freshen(blocking) then
    invoke; freshen(non-blocking) then an invoke that waits for it; a
    second invoke (a hit); v2, trained from v1 and published into the
    same store, refetched inline by the next invoke; v3, freshened before
    the invoke, which then runs nothing inline.  Each version's logits
    must be a fresh endpoint's on that version alone, bit for bit."""
    from repro_torch.core.freshen import FrState
    from repro_torch.models import make_model
    from repro_torch.serving import (Executor, ModelEndpoint, ServingEngine,
                                     WeightStore)
    B, S = ROLLOUT_SHAPE
    per_fwd = {"flash_attention": cfg.n_layers, "decode_attention": 0,
               "rglru_scan": 0, **NOT_LAUNCHED}
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               size=(B, S), dtype=np.int32)
    store = WeightStore(tempfile.mkdtemp(dir=tmp_root, prefix="weights-"))
    params = make_model(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    out: dict = {"publish_s": {1: _publish(store, ROLLOUT_NAME, params)},
                 "cases": {}, "train": {}}
    cases = out["cases"]

    def deploy():
        eng = ServingEngine()
        engines.append(eng)
        return eng, eng.deploy(ModelEndpoint(
            ROLLOUT_NAME, cfg, store, Executor(), batch_size=B, seq_len=S,
            device="cuda"))

    with _closing_new(torch, engines):
        eng, rt = deploy()
        cases["1 no freshen"] = c = rollout_invoke(
            np, ops, eng, rt, prompt, per_fwd, "1 no freshen (cold)",
            forwards=2)
        check(c["inline"] == [1, 1, 1], f"cold invoke inline {c['inline']}")
    with _closing_new(torch, engines):
        eng, rt = deploy()
        c0 = _counts(ops)
        t0 = time.perf_counter()
        rt.freshen(blocking=True)
        fr_ms = _ms_since(t0)
        check(_delta(c0, _counts(ops)) == per_fwd,
              f"blocking freshen launches {_delta(c0, _counts(ops))}")
        cases["2 freshen-before"] = c = rollout_invoke(
            np, ops, eng, rt, prompt, per_fwd,
            f"2 freshen-before (freshen {fr_ms:.1f} ms)", forwards=1)
        c["freshen_ms"] = fr_ms
        check(c["inline"] == [0, 0, 0] and c["stats"]["freshened"] == 3,
              f"freshened invoke: {c['stats']}")
    with _closing_new(torch, engines):      # one endpoint for cases 3-6
        eng, rt = deploy()
        rt.freshen(blocking=False)        # the prediction arrived late
        check(_wait_until(lambda: rt.fr_state.entries[0].state
                          is FrState.RUNNING, 30.0),
              "the non-blocking freshen never started its weight load")
        cases["3 freshen-concurrent"] = c = rollout_invoke(
            np, ops, eng, rt, prompt, per_fwd,
            "3 freshen-concurrent (waits via FrWait)", forwards=2)
        check(c["inline"][0] == 0 and c["stats"]["waits"] >= 1,
              f"concurrent invoke: {c['stats']}, inline {c['inline']}")
        cases["4 hit"] = c = rollout_invoke(
            np, ops, eng, rt, prompt, per_fwd, "4 second invoke (hit)",
            forwards=1)
        check(c["inline"] == cases["3 freshen-concurrent"]["inline"],
              f"the second invoke ran {c['inline']} inline")
        v1 = cases["1 no freshen"]["logits"]
        for k in ("2 freshen-before", "3 freshen-concurrent", "4 hit"):
            check(np.array_equal(cases[k]["logits"], v1),
                  f"rollout case {k}: logits differ from the cold invoke's")

        # ---- v2: trained from v1, published into the served store -------
        base_inline = list(cases["4 hit"]["inline"])
        params2, out["train"][2] = rollout_train(torch, np, ops, cfg,
                                                  params, 2)
        del params
        out["publish_s"][2] = _publish(store, ROLLOUT_NAME, params2)
        check(store.version(ROLLOUT_NAME) == 2, "v2 was not published")
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ep = eng.endpoints[ROLLOUT_NAME]
        captures = _captures(ep)
        cases["5 v2 stale"] = c = rollout_invoke(
            np, ops, eng, rt, prompt, per_fwd,
            "5 v2 published: the invoke refetches the weights and binds "
            "the step to them inline (a warm run and a capture)",
            forwards=2)
        c["held_bytes"] = held
        c["peak_bytes"] = torch.cuda.max_memory_allocated()
        torch.cuda.synchronize()
        c["after_bytes"] = torch.cuda.memory_allocated()
        check(c["inline"] == [base_inline[0] + 1, base_inline[1],
                              base_inline[2] + 1],
              f"v2 invoke inline {c['inline']} after {base_inline}")
        check(_captures(ep) == captures + 1,
              f"the v2 invoke made {_captures(ep) - captures} captures")
        v_bytes = store.nbytes(ROLLOUT_NAME)
        check(c["after_bytes"] - held < v_bytes / 2,
              f"after the refetch the card holds {c['after_bytes']} bytes, "
              f"{held} before: v1's params ({v_bytes} bytes) were not "
              f"dropped with their graph")
        check(not np.array_equal(c["logits"], v1), "v2's logits are v1's")
        with _closing_new(torch, engines):
            want = rollout_fresh(np, cfg, params2, tmp_root, prompt, engines)
        check(np.array_equal(c["logits"], want),
              f"v2's refetched logits differ from a fresh v2 endpoint's (max "
              f"|diff| {np.abs(c['logits'] - want).max()})")
        log(f"rollout v2: the refetch held {held / 1e9:.3f} GB before, "
            f"peaked at {c['peak_bytes'] / 1e9:.3f} GB (v1 and v2 both on the "
            f"card for a moment) and held {c['after_bytes'] / 1e9:.3f} GB "
            f"after (v1 and its graph dropped; a version is "
            f"{v_bytes / 1e9:.3f} GB); logits bit for bit a fresh v2 "
            f"endpoint's")

        # ---- v3: freshened before the invoke ----------------------------
        params3, out["train"][3] = rollout_train(torch, np, ops, cfg,
                                                  params2, 3)
        del params2
        out["publish_s"][3] = _publish(store, ROLLOUT_NAME, params3)
        base_inline = list(c["inline"])
        c0 = _counts(ops)
        captures = _captures(ep)
        t0 = time.perf_counter()
        rt.freshen(blocking=True)
        fr_ms = _ms_since(t0)
        # the freshen reloads the weights and binds the step to them: one
        # warm run, and the v3 capture
        check(_delta(c0, _counts(ops)) == per_fwd,
              f"v3 freshen launches {_delta(c0, _counts(ops))}")
        check(_captures(ep) == captures + 1,
              f"the v3 freshen made {_captures(ep) - captures} captures")
        cases["6 v3 freshened"] = c = rollout_invoke(
            np, ops, eng, rt, prompt, per_fwd,
            f"6 v3 published, freshen-before ({fr_ms:.1f} ms): nothing "
            "inline",
            forwards=1)
        c["freshen_ms"] = fr_ms
        check(c["inline"] == base_inline,
              f"v3 invoke inline {c['inline']} after {base_inline}")
        check(_captures(ep) == captures + 1 and "capture" not in c["timing"],
              "the freshened v3 invoke captured inline")
        check(not np.array_equal(c["logits"],
                                 cases["5 v2 stale"]["logits"]),
              "v3's logits are v2's")
        with _closing_new(torch, engines):
            want = rollout_fresh(np, cfg, params3, tmp_root, prompt, engines)
        check(np.array_equal(c["logits"], want),
              "v3's logits differ from a fresh v3 endpoint's")
        del params3
    for k in cases:
        cases[k].pop("logits")
    return out


def rollout_chain(torch, np, ops, cfg, tmp_root, engines):
    """``examples/serve_chain``'s pipeline at full width: three uncut
    endpoints (seeds 0, 1, 2), 8 requests through ``Batcher``s with
    freshen off, then on; each request's logits bit for bit the same in
    both runs, nothing inline downstream with freshen on."""
    from repro_torch.examples import serve_chain
    B, S = ROLLOUT_SHAPE
    R = ROLLOUT_REQUESTS
    cfgs = {s: cfg for s in serve_chain.STAGES}
    dims = ", ".join(str(d) for d in serve_chain.DIMS.values())
    log(f"rollout chain: {' -> '.join(cfgs)}; the example's stages differ "
        f"only in d_model ({dims}); at full width all three take the "
        f"published {cfg.d_model}: {cfg.name} uncut, {cfg.dtype}, seeds "
        f"0-2, batch {B} x {S}, {R} requests a mode")
    t0 = time.perf_counter()
    store = serve_chain.publish_stages(
        cfgs, "cuda", root=tempfile.mkdtemp(dir=tmp_root, prefix="chain-"))
    torch.cuda.empty_cache()
    out: dict = {"publish_s": time.perf_counter() - t0, "modes": {}}
    runs = {}
    for mode in (False, True):
        with _closing_new(torch, engines):
            eng, stages = serve_chain.build(mode, cfgs, store, seq=S,
                                            device="cuda")
            engines.append(eng)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            c0 = _counts(ops)
            lat, wall, outputs = serve_chain.run_pipeline(eng, stages, R,
                                                          mode)
            launches = _delta(c0, _counts(ops))
            serve_chain.report(eng, stages, lat, wall, R, mode)
            pools = eng.platform_stats()
            bill = eng.scheduler.accountant.bill("serving")
            summary = eng.scheduler.accountant.latency_summary("serving")
            m = dict(
                wall_s=wall, launches=launches,
                peak_bytes=torch.cuda.max_memory_allocated(),
                stages={s: dict(first_ms=lat[s][0] * 1e3,
                                p50_ms=float(np.percentile(lat[s], 50)) * 1e3,
                                max_ms=max(lat[s]) * 1e3, batches=len(lat[s]))
                        for s in stages},
                bill=dict(function_s=bill.function_seconds,
                          freshen_s=bill.freshen_seconds,
                          useful=bill.useful_freshens,
                          mispredicted=bill.mispredicted_freshens,
                          cold_starts=bill.cold_starts),
                latency={k: summary[k] for k in ("p50", "p95", "p99",
                                                 "mean_queue_delay")},
                pools={s: {k: pools[s][k] for k in (
                    "instances", "cold_starts", "hits", "inline", "waits",
                    "freshened")} for s in stages})
        runs[mode] = outputs
        label = "on" if mode else "off"
        out["modes"][label] = m
        forwards = 3 * R + sum(p["instances"] for p in m["pools"].values())
        want = _times({"flash_attention": cfg.n_layers, "decode_attention": 0,
                       "rglru_scan": 0, **NOT_LAUNCHED}, forwards)
        check(launches == want,
              f"chain freshen {label}: launches {launches} != {want} "
              f"({forwards} forwards)")
        check(all(len(lat[s]) == R for s in stages),
              f"chain freshen {label}: batches {[len(lat[s]) for s in stages]}"
              f" for {R} requests")
        log(f"rollout chain freshen {label}: wall {wall * 1e3:.1f} ms, "
            f"peak memory {m['peak_bytes'] / 1e9:.3f} GB, K1 "
            f"{launches['flash_attention']} = {forwards} forwards x "
            f"{cfg.n_layers}; stages " + json.dumps(
                {s: {k: round(v, 2) for k, v in st.items()}
                 for s, st in m["stages"].items()}))
    stages = list(cfgs)
    inline_on = [out["modes"]["on"]["pools"][s]["inline"] for s in stages]
    check(inline_on[1:] == [0, 0],
          f"freshen on: downstream stages ran {inline_on} inline")
    for s in stages:
        for i, ((x, lo), (x_on, lo_on)) in enumerate(zip(runs[False][s],
                                                         runs[True][s])):
            check(np.array_equal(x, x_on) and np.array_equal(lo, lo_on),
                  f"chain {s} request {i}: freshen off and on differ")
    log(f"rollout chain: {3 * R} logits rows bit for bit with freshen off "
        f"and on; inline by stage with freshen on {inline_on}")
    return out


def phase_rollout(torch, np, ops, tmp_root, engines):
    """qwen2-0.5b uncut, bf16, batch 4 x prompt 128: (a) a trained version
    rolled out to a served endpoint through freshen, (b) the example
    chain with freshen off and on."""
    from repro_torch.configs import get_config
    cfg = get_config(ROLLOUT_ARCH)
    log(f"rollout: {cfg.name} uncut, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.dtype}, batch {ROLLOUT_SHAPE[0]}, prompt "
        f"{ROLLOUT_SHAPE[1]}")
    ops.reset_launches()                  # the rollout's run starts
    t0 = time.perf_counter()
    out = {"versions": rollout_versions(torch, np, ops, cfg, tmp_root,
                                        engines)}
    t1 = time.perf_counter()
    out["chain"] = rollout_chain(torch, np, ops, cfg, tmp_root, engines)
    out["launches"] = _counts(ops)        # ... and ends here
    out["seconds"] = {"versions": t1 - t0,
                      "chain": time.perf_counter() - t1}
    log("rollout seconds by part " + json.dumps(
        {k: round(v, 1) for k, v in out["seconds"].items()}))
    return out


# ---------------------------------------------------------------------------
# phase graphs
# arch and depth cut: every served path's family, one dense config cut
GRAPH_PATHS = (("qwen2-0.5b", None), ("recurrentgemma-2b", None),
               ("granite-moe-1b-a400m", None), ("xlstm-350m", None),
               ("phi3-medium-14b", ((("attn",), 4),)))
GRAPH_SHAPE = (4, 128, 256, 16)          # batch, prompt, cache, tokens
GRAPH_REPEATS = 3                        # timed calls per figure (median)
IDLE_STEPS = 8                           # decode steps per idle share


def pool_bytes(torch, graph):
    """Bytes of the segments in ``graph``'s private memory pool, or None
    where the allocator's snapshot does not name pools."""
    segs = torch.cuda.memory_snapshot()
    if segs and "segment_pool_id" not in segs[0]:
        return None
    pid = tuple(graph.pool())
    return sum(sg["total_size"] for sg in segs
               if tuple(sg["segment_pool_id"]) == pid)


def _synced_ms(torch, fn):
    """(median ms of GRAPH_REPEATS host-synced calls after one, last out)."""
    out = fn()
    ms = []
    for _ in range(GRAPH_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append(_ms_since(t0))
    return _median(ms), out


def greedy_session(torch, prefill, decode, toks, n_tok):
    """Prefill, then n_tok - 1 greedy decode steps, each host-synced and
    timed: (each position's float32 logits, row 0's tokens, step ms)."""
    B, S = toks.shape
    logits = prefill(toks)[0]
    steps, ms = [logits.float()], []
    tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
    tokens = [int(tok[0, 0])]
    pos = torch.full((B,), S, dtype=torch.int32, device=toks.device)
    for _ in range(n_tok - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = decode(tok, pos)[0]
        torch.cuda.synchronize()
        ms.append(_ms_since(t0))
        steps.append(logits.float())
        tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
        pos = pos + 1
        tokens.append(int(tok[0, 0]))
    return steps, tokens, ms, (tok, pos)


def replay_idle(torch, decode, tok, pos, steps=IDLE_STEPS):
    """A replayed decode step's device idle share on the device's own
    clock (CUDA events), the step as generate runs it: copy-in, replay,
    the argmax and the next position.  Busy is a step's device time with
    the queue kept full (``steps`` steps issued back to back, no token
    read); the period is one step's start to the next's when the host
    reads each token before it issues the next step, as generate does.
    Returns (1 - busy / period, busy ms, period ms)."""
    def step(tok, pos):
        logits = decode(tok, pos)[0]
        return torch.argmax(logits[:, -1:], -1).to(torch.int32), pos + 1

    def event():
        return torch.cuda.Event(enable_timing=True)
    tok, pos = step(tok, pos)
    torch.cuda.synchronize()
    first, last = event(), event()
    first.record()
    t, p = tok, pos
    for _ in range(steps):
        t, p = step(t, p)
    last.record()
    last.synchronize()
    busy = first.elapsed_time(last) / steps
    marks = [event() for _ in range(steps + 1)]
    for i in range(steps):
        marks[i].record()
        tok, pos = step(tok, pos)
        int(tok[0, 0])
    marks[steps].record()
    marks[steps].synchronize()
    period = marks[0].elapsed_time(marks[steps]) / steps
    return 1 - busy / period, busy, period


def graph_path(torch, np, ops, arch, segments):
    """One config on the card, bf16, random weights from seed 0: the score
    step and a greedy session, each eager (the step function called
    directly) beside its replay, every logit bit for bit; capture seconds
    and pool bytes of each graph; the replayed decode step's idle share
    from CUDA events (``replay_idle``); the launches each graph
    recorded."""
    import threading
    from repro_torch.configs import get_config
    from repro_torch.serving import Executor, ModelEndpoint
    from repro_torch.serving.engine import _to_numpy
    full = get_config(arch)
    cfg = _cut(full, segments)
    B, S, MAX_LEN, N_TOK = GRAPH_SHAPE
    ep = ModelEndpoint(arch, cfg, None, Executor(), batch_size=B, seq_len=S,
                       device="cuda")
    dev = ep.device
    model = ep.model_for(dev)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(B, S), dtype=np.int32), device=dev)
    out: dict = {"layers": cfg.n_layers}
    cut = "uncut" if segments is None else \
        f"cut from {full.n_layers} to {cfg.n_layers} layers"
    log(f"graphs: {arch} ({cut}), bf16, batch {B}, prompt {S}, cache "
        f"{MAX_LEN}, {N_TOK} tokens")

    # ---- the score step: the invoke's execute part -------------------------
    score = ep._score_fn(dev)
    c0 = _counts(ops)
    eager_ms, eager = _synced_ms(torch, lambda: _to_numpy(
        torch.no_grad()(score)(params, toks)))
    step = ep.executor.warmup(ep._compile(), params)
    replay_ms, replayed = _synced_ms(torch, lambda: _to_numpy(step(toks)))
    out["score"] = dict(eager_ms=eager_ms, replay_ms=replay_ms,
                        warm_s=step.warm_seconds,
                        capture_s=step.capture_seconds,
                        pool_bytes=pool_bytes(torch, step.graph),
                        launches=step.launches)
    check(np.array_equal(eager, replayed),
          f"graphs {arch}: replayed score logits differ from the eager "
          f"step's by {np.abs(eager - replayed).max()}")

    # ---- a greedy session: prefill and decode ------------------------------
    c_pre, c_dec = ep._compile_decode(MAX_LEN)
    cache = ep._prealloc_session(MAX_LEN)
    pre = ep.executor.warmup(c_pre, params, cache)
    dec = ep.executor.warmup(c_dec, params, cache)
    r_logits, r_tokens, r_ms, (tok, pos) = greedy_session(
        torch, pre, dec, toks, N_TOK)
    r_idle = replay_idle(torch, dec, tok, pos)
    fresh = model.init_cache(B, MAX_LEN)
    prefill, decode = ep._decode_fns(MAX_LEN)
    with torch.no_grad():
        e_logits, e_tokens, e_ms, _ = greedy_session(
            torch, lambda t: prefill(params, fresh, t),
            lambda t, p: decode(params, fresh, t, p), toks, N_TOK)
    diff = max(float((a - b).abs().max()) for a, b in zip(r_logits, e_logits))
    check(diff == 0.0 and r_tokens == e_tokens,
          f"graphs {arch}: replayed session differs from the eager one: "
          f"max |logit diff| {diff}, tokens {r_tokens} vs {e_tokens}")
    for name, g in (("prefill", pre), ("decode", dec)):
        out[name] = dict(warm_s=g.warm_seconds, capture_s=g.capture_seconds,
                         pool_bytes=pool_bytes(torch, g.graph),
                         launches=g.launches)
    out["decode"].update(
        eager_ms=_median(e_ms), replay_ms=_median(r_ms),
        replay_idle=r_idle[0], replay_busy_ms=r_idle[1],
        replay_period_ms=r_idle[2], threads=threading.active_count())
    out["launches"] = _delta(c0, _counts(ops))
    d = out["decode"]
    log(f"graphs {arch}: score step eager {eager_ms:.3f} ms, replay "
        f"{replay_ms:.3f} ms (host-synced, logits to the host), bit for bit; "
        f"decode step eager {d['eager_ms']:.3f} ms, replay "
        f"{d['replay_ms']:.3f} ms; replayed decode device idle share "
        f"{r_idle[0]:.4f} from CUDA events (busy {r_idle[1]:.4f} ms of a "
        f"{r_idle[2]:.4f} ms step, {d['threads']} threads alive); session "
        f"logits and tokens bit for bit")
    for name in ("score", "prefill", "decode"):
        g = out[name]
        log(f"graphs {arch} {name}: warm run {g['warm_s']:.3f} s, capture "
            f"and instantiate {g['capture_s']:.3f} s, pool {_mib(g)}, "
            f"launches per replay {g['launches']}")
    kinds = {kind for pat, _ in cfg.segments for kind in pat}
    if kinds & {"attn", "attn_local", "attn_moe", "mla", "mla_moe"}:
        check(out["prefill"]["launches"].get("flash_attention", 0) > 0
              and out["decode"]["launches"].get("decode_attention", 0) > 0,
              f"graphs {arch}: K1/K2 not inside the graphs: {out}")
    if "rglru" in kinds:
        check(out["prefill"]["launches"].get("rglru_scan", 0) > 0,
              f"graphs {arch}: K3 not inside the prefill graph")
    del step, pre, dec, cache, fresh, params, model
    return out


def phase_graphs(torch, np, ops, tmp_root, engines):
    """The served steps as CUDA graphs beside the eager steps, per
    family."""
    import gc
    out = {}
    for arch, segments in GRAPH_PATHS:
        out[arch] = graph_path(torch, np, ops, arch, segments)
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase times
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


def device_ms(torch, fn, iters=20):
    """Device time per call of ``fn``: the launches are queued behind a
    kernel that spins 5e7 clock cycles (~25 ms), so the
    events time the card running them back to back, without the host's
    launch cost that ``cuda_ms`` sees at small shapes.  Fails if the
    host had not queued them all before the spin ended."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    check(not start.query(), "the host queued the launches slower than the "
          "card's spin: device time not measured")
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(flops, nbytes, peak_flops=PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_times(torch, ops, ref):
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    g2 = get_config("gemma2-27b")             # its window, softcap, scale
    gen = torch.Generator(device="cuda").manual_seed(99)
    bf16 = torch.bfloat16
    rows = {}

    def sdpa(*a, **kw):
        return F.scaled_dot_product_attention(*a, **kw, enable_gqa=True)

    def _v(B, S, H, dv):
        """v as the model hands it over: contiguous, or for MLA (dv 128
        beside dh 192) a view of the (nope + v)-wide latent expansion."""
        if dv == 128 and H == 16:
            return _rand(torch, gen, (B, S, H, 256), bf16)[..., 128:]
        return _rand(torch, gen, (B, S, H, dv), bf16)

    # (label, B, S, Hq, Hkv, dh, dv, window, softcap): qwen2's main and
    # long shapes, recurrentgemma's attn_local at its main path's shape and
    # at its longest prefill that the window still covers, granite's
    # attn_moe, deepseek's MLA prefill and the dense phase's five models
    # at their main path's shapes (gemma2's local layers, with their
    # softcap and query scale; sdpa has no softcap: its row times sdpa
    # without one)
    for label, B, S, Hq, Hkv, dh, dv, window, softcap in (
            ("main", 4, 128, 14, 2, 64, 64, None, None),
            ("long", 1, 4096, 14, 2, 64, 64, None, None),
            ("rgemma", 4, 128, 10, 1, 256, 256, 2048, None),
            ("rgemma_long", 1, 2048, 10, 1, 256, 256, 2048, None),
            ("granite", 4, 128, 16, 8, 64, 64, None, None),
            ("deepseek", 4, 128, 16, 16, 192, 128, None, None),
            ("phi3", 4, 128, 40, 10, 128, 128, None, None),
            ("nemotron", 4, 128, 48, 8, 128, 128, None, None),
            ("pixtral", 4, 128, 32, 8, 128, 128, None, None),
            ("gemma2", 4, 128, 32, 16, 128, 128, g2.window_size,
             g2.attn_softcap),
            ("musicgen", 4, 128, 24, 24, 64, 64, None, None)):
        q = _rand(torch, gen, (B, S, Hq, dh), bf16)
        k = _rand(torch, gen, (B, S, Hkv, dh), bf16)
        v = _v(B, S, Hkv, dv)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        w = min(S, window or S)
        pairs = sum(min(i + 1, w) for i in range(S))      # causal, windowed
        flops = B * Hq * pairs * 2 * (dh + dv)
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + B * S * Hq * dv)
        bound, by = _bound(flops, nbytes)
        check(window is None or window >= S,
              "the sdpa yardstick assumes the window covers the sequence")
        kw = dict(window=window, softcap=softcap,
                  scale=g2.query_scale if softcap else None)
        def kern():
            return ops.flash_attention(q, k, v, **kw)
        def lib():
            return sdpa(qt, kt, vt, is_causal=True, scale=kw["scale"])
        rows[("flash_attention", label)] = dict(
            shape=f"B={B} S={S} Hq={Hq} Hkv={Hkv} dh={dh}"
                  + (f" dv={dv}" if dv != dh else "") + " bf16 causal"
                  + (f" window={window}" if window else "")
                  + (f" softcap={softcap} (sdpa without)" if softcap
                     else ""),
            ms=cuda_ms(torch, kern), device_ms=device_ms(torch, kern),
            plain_ms=cuda_ms(torch, lambda: ref.flash_attention_ref(
                q, k, v, **kw), iters=5),
            library_ms=cuda_ms(torch, lib),
            library_device_ms=device_ms(torch, lib),
            bound_ms=bound, bound_by=by)
    for label, B, S, p, Hq, Hkv, dh, dv, window, softcap in (
            ("main", 4, 256, 143, 14, 2, 64, 64, None, None),
            ("long", 8, 4096, 4095, 14, 2, 64, 64, None, None),
            ("rgemma", 4, 256, 143, 10, 1, 256, 256, 2048, None),
            ("granite", 4, 256, 143, 16, 8, 64, 64, None, None),
            ("deepseek", 4, 256, 143, 16, 16, 192, 128, None, None),
            ("phi3", 4, 256, 143, 40, 10, 128, 128, None, None),
            ("nemotron", 4, 256, 143, 48, 8, 128, 128, None, None),
            ("pixtral", 4, 256, 143, 32, 8, 128, 128, None, None),
            ("gemma2", 4, 256, 143, 32, 16, 128, 128, g2.window_size,
             g2.attn_softcap),
            ("musicgen", 4, 256, 143, 24, 24, 64, 64, None, None)):
        q = _rand(torch, gen, (B, 1, Hq, dh), bf16)
        k = _rand(torch, gen, (B, S, Hkv, dh), bf16)
        v = _v(B, S, Hkv, dv)
        pos = torch.full((B,), p, dtype=torch.int32, device="cuda")
        mask = ref.decode_slot_valid(pos, S, window)[:, None, None, :]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        valid = int(ref.decode_slot_valid(pos, S, window)[0].sum())
        flops = B * Hq * valid * 2 * (dh + dv)
        nbytes = (2 * (B * Hkv * valid * (dh + dv) + B * Hq * (dh + dv))
                  + 4 * B)
        bound, by = _bound(flops, nbytes)
        kw = dict(window=window, softcap=softcap,
                  scale=g2.query_scale if softcap else None)
        def kern():
            return ops.decode_attention(q, k, v, pos, **kw)
        def lib():
            return sdpa(qt, kt, vt, attn_mask=mask, scale=kw["scale"])
        rows[("decode_attention", label)] = dict(
            shape=f"B={B} cache={S} pos={p} Hq={Hq} Hkv={Hkv} dh={dh}"
                  + (f" dv={dv}" if dv != dh else "") + " bf16"
                  + (f" window={window}" if window else "")
                  + (f" softcap={softcap} (sdpa without)" if softcap
                     else ""),
            ms=cuda_ms(torch, kern), device_ms=device_ms(torch, kern),
            plain_ms=cuda_ms(torch, lambda: ref.decode_attention_ref(
                q, k, v, pos, **kw)),
            library_ms=cuda_ms(torch, lib),
            library_device_ms=device_ms(torch, lib),
            bound_ms=bound, bound_by=by)
    # K3 as the main path calls it (no h0): a, b read, y and h_T written,
    # a multiply and an add per element in float32 on the CUDA cores; the
    # main shape, one long prompt, four long prompts and the float32
    # gate's prompt
    for label, B, S, r in (("main", 4, 128, 2560), ("long", 1, 4096, 2560),
                           ("long_b4", 4, 2048, 2560),
                           ("gate", 1, 2100, 2560)):
        a = torch.sigmoid(_rand(torch, gen, (B, S, r), torch.float32))
        b = _rand(torch, gen, (B, S, r), torch.float32)
        nbytes = 4 * (3 * B * S * r + B * r)
        bound, by = _bound(2 * B * S * r, nbytes, PEAK_F32_FLOPS)
        def kern():
            return ops.rglru_scan(a, b)
        row = dict(
            shape=f"B={B} S={S} r={r} float32",
            ms=cuda_ms(torch, kern), device_ms=device_ms(torch, kern),
            plain_ms=cuda_ms(torch, lambda: ref.rglru_scan_ref(a, b),
                             iters=3, warmup=1),
            library_ms=None, library_device_ms=None, bound_ms=bound,
            bound_by=by)
        row["device_gb_s"] = nbytes / row["device_ms"] / 1e6
        rows[("rglru_scan", label)] = row
    # K3b as training calls it (no h0, no dh_T): a, y and dy read, da and
    # db written, an add and two multiplies per element in float32 on the
    # CUDA cores; no library call (no single PyTorch call computes a
    # reversed linear recurrence: cumsum / cumprod forms are another
    # function in float32)
    for label, B, S, r in K3B_SHAPES:
        a = torch.sigmoid(_rand(torch, gen, (B, S, r), torch.float32))
        y, _ = ops.rglru_scan.launch_kernel(
            a, _rand(torch, gen, (B, S, r), torch.float32))
        dy = _rand(torch, gen, (B, S, r), torch.float32)
        nbytes = 4 * 5 * B * S * r
        bound, by = _bound(3 * B * S * r, nbytes, PEAK_F32_FLOPS)

        def kern():
            return ops.rglru_scan_bwd(a, y, None, dy)
        row = dict(
            shape=f"B={B} S={S} r={r} float32",
            ms=cuda_ms(torch, kern), device_ms=device_ms(torch, kern),
            plain_ms=cuda_ms(torch, lambda: ref.rglru_scan_bwd_ref(
                a, y, None, dy, None), iters=3, warmup=1),
            library_ms=None, library_device_ms=None, bound_ms=bound,
            bound_by=by)
        row["device_gb_s"] = nbytes / row["device_ms"] / 1e6
        rows[("rglru_scan_bwd", label)] = row
    # K4 at the MoE models' served shapes (deepseek's decode step is the
    # main one): its rows' products and, as bytes, the touched experts'
    # weights read once, the tokens read and the output written; the
    # yardstick is ``routed``'s batched einsum path on the same routing
    import types
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe
    for label, T, gsz, E, k, d, d_ff, factor in (
            ("main", 4, 512, 64, 6, 2048, 1408, 64 / 6),
            ("prefill", 8192, 512, 64, 6, 2048, 1408, 64 / 6),
            ("granite", 512, 512, 32, 8, 1024, 512, 4.0),
            ("granite_decode", 4, 512, 32, 8, 1024, 512, 4.0)):
        gs = min(gsz, T)
        e = MoEConfig(n_experts=E, top_k=k, d_ff=d_ff, capacity_factor=factor,
                      group_size=gsz)
        C = moe._capacity(gs, e)
        x, probs, idx, w = moe_inputs(torch, gen, T, E, k, d, d_ff, E, bf16)
        pos = moe._positions(idx.reshape(T // gs, gs, k), E).reshape(T, k)
        args = (x, idx, pos, probs, w["wg_e"], w["wi_e"], w["wo_e"])
        kw = dict(capacity=C, group_size=gs)
        used = int(torch.unique(idx).numel())
        bound, by = _bound(6 * T * k * d * d_ff,
                           2 * (3 * used * d * d_ff + 2 * T * d) + 4 * T * k)
        cfg = types.SimpleNamespace(moe=e, activation="swiglu")

        def kern():
            return ops.moe_grouped(*args, **kw)

        def lib():
            with batched_moe(moe):
                return moe.routed(w, x, probs, idx, cfg, gs)
        rows[("moe_grouped", label)] = dict(
            shape=f"T={T} group={gs} E={E} top-{k} d={d} d_ff={d_ff} C={C} "
                  f"bf16, {used} experts touched",
            library="einsum dispatch",
            ms=cuda_ms(torch, kern), device_ms=device_ms(torch, kern),
            plain_ms=cuda_ms(torch, lambda: ref.moe_grouped_ref(*args, **kw),
                             iters=3, warmup=1),
            library_ms=cuda_ms(torch, lib, iters=5, warmup=1),
            library_device_ms=device_ms(torch, lib, iters=5),
            bound_ms=bound, bound_by=by)
        del x, probs, idx, w, args
    # K1b at the training path's shape ("main": qwen2, B 4, S 1024) and at
    # gemma2's, MLA's and recurrentgemma's shapes; the yardstick is the
    # backward of sdpa (its forward + backward minus its forward), timed
    # only (sdpa has no softcap: gemma2's row times it without one)
    for case in BWD_CASES[:4]:
        label = "main" if case[0] == "qwen2" else case[0]
        q, k, v, do, kw = _bwd_inputs(torch, gen, case, bf16)
        out, lse = ops.flash_attention.launch_kernel(q, k, v, return_lse=True,
                                                     **kw)
        B, S, Hq, dh = q.shape
        dv = v.shape[-1]
        check(kw["window"] is None or kw["window"] >= S,
              "the sdpa yardstick assumes the window covers the sequence")
        w = min(S, kw["window"] or S)
        pairs = sum(min(i + 1, w) for i in range(S))
        flops = B * Hq * pairs * 2 * (3 * dh + 2 * dv)   # s, dp, dv, dk, dq
        # q, k, v, out, do and lse read; dq, dk, dv written
        nbytes = (2 * (2 * (q.numel() + k.numel() + v.numel()) + out.numel()
                       + do.numel()) + 4 * lse.numel())
        bound, by = _bound(flops, nbytes)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        dot = do.transpose(1, 2)

        def kern():
            return ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)

        def fwd():
            return sdpa(qt, kt, vt, is_causal=True, scale=kw["scale"])

        def fwd_bwd():
            return torch.autograd.grad(fwd(), (qt, kt, vt), dot)
        rows[("flash_attention_bwd", label)] = dict(
            shape=f"B={B} S={S} Hq={Hq} Hkv={k.shape[2]} dh={dh}"
                  + (f" dv={dv}" if dv != dh else "") + " bf16 causal"
                  + (f" window={kw['window']}" if kw["window"] else "")
                  + (f" softcap={kw['softcap']} (sdpa without)"
                     if kw["softcap"] else ""),
            ms=cuda_ms(torch, kern), device_ms=device_ms(torch, kern),
            plain_ms=cuda_ms(torch, lambda: ref.flash_attention_bwd_ref(
                q, k, v, out, lse, do, **kw), iters=3, warmup=1),
            library_ms=cuda_ms(torch, fwd_bwd) - cuda_ms(torch, fwd),
            library_device_ms=(device_ms(torch, fwd_bwd)
                               - device_ms(torch, fwd)),
            bound_ms=bound, bound_by=by)
    for (name, label), r in rows.items():
        # the factor compares device time with device time
        lib = ("none" if r["library_ms"] is None
               else f"({r.get('library', 'sdpa')}) {r['library_ms']:.4f} "
                    f"ms (device {r['library_device_ms']:.4f} ms; kernel/"
                    f"library on the device "
                    f"{r['device_ms'] / r['library_device_ms']:.2f}x)")
        log(f"times {name} [{label}] {r['shape']}: kernel {r['ms']:.4f} ms "
            f"(device {r['device_ms']:.4f} ms), plain {r['plain_ms']:.4f} "
            f"ms, library {lib}, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}), kernel at {r['bound_ms'] / r['ms']:.1%} of "
            f"bound ({r['bound_ms'] / r['device_ms']:.1%} on device time)"
            + (f", {r['device_gb_s']:.1f} GB/s on device time"
               if "device_gb_s" in r else ""))
    return rows


# ---------------------------------------------------------------------------
def sanitizer_report(graph) -> dict:
    """The lock sanitizer's graph after the fabric phase: its size, and
    a failure on any cycle or violation."""
    edges = graph.edges()
    nodes = set(edges) | {d for ds in edges.values() for d in ds}
    n_edges = sum(len(ds) for ds in edges.values())
    under_admin = {d for ds in edges.values() for d in ds}
    log(f"fabric sanitizer (repro_torch.analysis.sanitizer, installed before "
        f"the port's first lock): {len(nodes)} lock classes, {n_edges} "
        f"acquisition-order edges, {len(graph.violations)} violations, "
        f"cycle {graph.find_cycle()}; router.py:_admin outermost "
        f"{'router.py:_admin' not in under_admin}")
    graph.assert_clean()
    check("router.py:_admin" not in under_admin,
          "router.py:_admin was taken under another fabric lock")
    return dict(lock_classes=len(nodes), edges=n_edges,
                violations=len(graph.violations))


def fabric_child(out_path) -> int:
    """Run in a fresh process by ``fabric_in_child``: the port's lock
    sanitizer, installed before this process imports the port (so every
    lock the port makes is tracked), then ``phase_fabric``, its engines'
    close and the sanitizer's report, written to ``out_path`` as JSON."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.analysis import sanitizer
    graph = sanitizer.install()
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    tmp_root = tempfile.mkdtemp(prefix="chip-smoke-")
    engines: list = []
    try:
        out = phase_fabric(torch, np, ops, tmp_root, engines)
    finally:
        for eng in engines:
            eng.close()
        shutil.rmtree(tmp_root, ignore_errors=True)
    out["sanitizer"] = sanitizer_report(graph)
    Path(out_path).write_text(json.dumps(
        out, default=lambda o: o.item() if hasattr(o, "item") else str(o)))
    return 0


def fabric_in_child(torch, np, ops, tmp_root, engines, timeout=900):
    """``fabric_child`` in a process of its own (and its own session, so
    that every process it leaves is stopped): only the fabric phase runs
    with the sanitizer's tracked locks, and the other phases' host times
    are taken on the genuine ``threading`` locks.  The child loads the
    ``build`` phase's libraries.  Returns the phase's results."""
    import os
    import signal
    out_path = Path(tmp_root) / "fabric.json"
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); import "
            f"chip_smoke; sys.exit(chip_smoke.fabric_child({str(out_path)!r}))")
    sys.stdout.flush()
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=str(ROOT),
                            start_new_session=True)
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        rc = None
    finally:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    check(rc == 0, f"the fabric phase's process ended with {rc}")
    return json.loads(out_path.read_text())


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
    phase_s: dict = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        log(f"phase {name}: {phase_s[name]:.1f} s")
        return out

    if "build" in phases:
        results["build_s"] = timed("build", phase_build, torch, ops)
    if "parity" in phases:
        results["errs"] = timed("parity", phase_parity, torch, ops, ref)
    def served(name, fn):
        # a served path closes its engines and drops its weights on the way
        # out, so the next one starts with the card's memory free
        tmp_root = tempfile.mkdtemp(prefix="chip-smoke-")
        engines: list = []
        try:
            results[name] = timed(name, fn, torch, np, ops, tmp_root, engines)
        finally:
            for eng in engines:
                eng.close()
            engines.clear()
            shutil.rmtree(tmp_root, ignore_errors=True)
            torch.cuda.empty_cache()

    for name, fn in (("main", phase_main), ("rgemma", phase_rgemma),
                     ("moe", phase_moe), ("mla", phase_mla),
                     ("xlstm", phase_xlstm), ("dense", phase_dense),
                     ("fabric", fabric_in_child),
                     ("launch", phase_launch)):
        if name in phases:
            served(name, fn)
    if "train" in phases:
        results["train"] = timed("train", phase_train, torch, np, ops, ref)
    if "rollout" in phases:
        served("rollout", phase_rollout)
    if "graphs" in phases:
        served("graphs", phase_graphs)
    if "times" in phases:
        results["times"] = timed("times", phase_times, torch, ops, ref)
    if not set(PHASES) <= set(phases):
        log(f"chip_smoke: ran phases {phases} only")
        return 0

    for key, tag in PATHS:
        log(f"e2e {tag}: {_served_line(results[key])}")
    dense = results["dense"]
    for arch, tag, _, _, _ in DENSE:
        r = dense["models"][tag]
        log(f"e2e {arch} ({r['layers']} layers, {r['bytes'] / 1e9:.3f} GB): "
            f"{_served_line(r)} (weights of the cold invoke "
            f"{r['cold_timing']['weights'] * 1e3:.3f} ms)")
    ch = dense["chain"]
    log(f"e2e dense chain ({' -> '.join(ch['stages'])}): "
        + ", ".join(f"{t} {st['invoke_ms']:.3f} ms"
                    for t, st in ch["stages"].items())
        + f"; wall {ch['wall_ms']:.3f} ms, freshen "
        f"{ch['bill']['freshen_s']:.3f} s, useful {ch['bill']['useful']}, "
        f"mispredicted {ch['bill']['mispredicted']}, peak memory "
        f"{ch['peak_bytes'] / 1e9:.3f} GB")
    for backend, r in results["fabric"]["backends"].items():
        log(f"e2e qwen2-0.5b on the {backend} backend: cold invoke "
            f"{r['cold_ms']:.3f} ms, freshened invoke {r['freshened_ms']:.3f} "
            f"ms, warm invoke {r['warm_ms']:.3f} ms"
            + (f", measured cold start {r['measured_cold_start_s'] * 1e3:.3f}"
               f" ms" if "measured_cold_start_s" in r else ""))
    la = results["launch"]
    log(f"e2e qwen2-0.5b sharded steps (launch layer, one-card mesh): "
        f"prefill {la['serve']['prefill_ms']:.3f} ms vs unsharded "
        f"{la['serve']['prefill_plain_ms']:.3f} ms, decode step "
        f"{la['serve']['decode_step_ms']:.3f} ms vs "
        f"{la['serve']['decode_plain_ms']:.3f} ms, train step "
        f"{la['train']['step_ms'][-1]:.3f} ms vs "
        f"{la['train']['plain_step_ms'][-1]:.3f} ms; logits bit for bit "
        f"{la['serve']['bit_for_bit']}")
    ro = results["rollout"]
    ro_cases = ro["versions"]["cases"]
    log("e2e qwen2-0.5b rollout (bf16, batch 4 x 128): "
        + ", ".join(f"case {k} {c['ms']:.3f} ms (weights "
                    f"{c['timing']['weights'] * 1e3:.3f} ms, inline "
                    f"{c['inline']})" for k, c in ro_cases.items())
        + f"; refetch peak memory "
        f"{ro_cases['5 v2 stale']['peak_bytes'] / 1e9:.3f} GB")
    for label, m in ro["chain"]["modes"].items():
        log(f"e2e qwen2-0.5b chain of 3, freshen {label}, "
            f"{ROLLOUT_REQUESTS} requests: wall {m['wall_s'] * 1e3:.3f} ms, "
            + ", ".join(f"{s} first {st['first_ms']:.3f} p50 "
                        f"{st['p50_ms']:.3f} max {st['max_ms']:.3f} ms"
                        for s, st in m["stages"].items())
            + f", latency p50 {m['latency']['p50'] * 1e3:.3f} p95 "
            f"{m['latency']['p95'] * 1e3:.3f} p99 "
            f"{m['latency']['p99'] * 1e3:.3f} ms, inline by stage "
            f"{[p['inline'] for p in m['pools'].values()]}")
    for arch, g in results["graphs"].items():
        d = g["decode"]
        log(f"e2e {arch} ({g['layers']} layers) eager step vs CUDA graph: "
            f"score step {g['score']['eager_ms']:.3f} / "
            f"{g['score']['replay_ms']:.3f} ms, decode step "
            f"{d['eager_ms']:.3f} / {d['replay_ms']:.3f} ms, replayed decode "
            f"idle share {d['replay_idle']}; capture "
            f"s score {g['score']['capture_s']:.3f}, prefill "
            f"{g['prefill']['capture_s']:.3f}, decode {d['capture_s']:.3f}; "
            f"pool MiB " + ", ".join(
                f"{k} {g[k]['pool_bytes'] / 2**20:.1f}"
                if g[k]["pool_bytes"] is not None else f"{k} not measured"
                for k in ("score", "prefill", "decode")))
    tr = results["train"]
    qtr, rtr = (tr["full"][a] for a in ("qwen2-0.5b", "recurrentgemma-2b"))
    for arch, t, shares in (("qwen2-0.5b", qtr, ("k1b", "k1")),
                            ("recurrentgemma-2b", rtr,
                             ("k3b", "k3", "k1b", "k1"))):
        log(f"e2e {arch} training (bf16, batch 4 x 1024, 2 microbatches): "
            f"step {t['step_ms']:.3f} ms, {t['tokens_per_s']:.1f} tokens/s, "
            f"peak memory {t['peak_bytes'] / 1e9:.3f} GB, device idle share "
            f"{t.get('idle_share', 'not measured')}, "
            + ", ".join(f"{k.upper()} share of device time "
                        f"{t.get(k + '_share', 'not measured')}"
                        for k in shares))
    log("phase seconds " + json.dumps({k: round(v, 1)
                                       for k, v in phase_s.items()}))
    # `launches` is, for K1-K3, the recurrentgemma served run (it launches
    # all three serving kernels), for K1b the qwen2 training run and for
    # K3b the recurrentgemma training run; each path's own counts are
    # beside it
    paths = {tag: results[key]["launches"] for key, tag in PATHS}
    for arch, tag, _, _, _ in DENSE:
        paths[arch] = dense["models"][tag]["launches"]
    paths["dense chain"] = dense["chain"]["launches"]
    paths["qwen2-0.5b fabric"] = results["fabric"]["launches"]
    paths["qwen2-0.5b launch"] = results["launch"]["launches"]
    paths["qwen2-0.5b train"] = qtr["launches"]
    paths["qwen2-0.5b rollout"] = ro["launches"]
    paths["recurrentgemma-2b train"] = rtr["launches"]
    train_path = {"flash_attention_bwd": "qwen2-0.5b train",
                  "rglru_scan_bwd": "recurrentgemma-2b train",
                  "moe_grouped": "deepseek-v2-lite-16b"}
    errs_all = {k: v for k, v in results["errs"].items() if k != "per_rank"}
    errs_all["flash_attention_bwd"] = tr["errs"]["flash_attention_bwd"]
    for k, e in results["errs"]["per_rank"].items():     # K1, K2, K1b
        errs_all[k] = {n: max(errs_all[k][n], e[n]) for n in BOTH}
    keys = ("shape", "ms", "device_ms", "plain_ms", "library_ms",
            "library_device_ms", "bound_ms", "bound_by")
    records, short = [], []
    for name, meta in KERNEL_META.items():
        t_main = results["times"][(name, "main")]
        errs = errs_all[name]
        mod = ops.MODULES[name]
        path = train_path.get(name, "recurrentgemma-2b")
        rec = dict(name=name, route="cuda", **meta, design=mod.DESIGN,
                   device_kernels_per_call=mod.DEVICE_KERNELS_PER_CALL,
                   launches=paths[path][name],
                   launches_by_path={p: c[name] for p, c in paths.items()},
                   max_abs_err=max(e for e in errs.values() if e is not None),
                   max_err_f32=errs["float32"], max_err_bf16=errs["bfloat16"],
                   ms=t_main["ms"], device_ms=t_main["device_ms"],
                   plain_ms=t_main["plain_ms"],
                   bound_ms=t_main["bound_ms"], bound_by=t_main["bound_by"],
                   library_ms=t_main["library_ms"],
                   library_device_ms=t_main["library_device_ms"],
                   shape=t_main["shape"])
        if "device_gb_s" in t_main:
            rec["device_gb_s"] = t_main["device_gb_s"]
        rec["launches_per_train_step"] = qtr["launches"][name] // qtr["steps"]
        rec["launches_per_rgemma_train_step"] = (rtr["launches"][name]
                                                 // rtr["steps"])
        if name == "flash_attention_bwd":
            rec["bf16_scaled_err"] = tr["errs"]["bwd_bf16"]["scaled"]
            rec["bf16_rel_l2_err"] = tr["errs"]["bwd_bf16"]["rel_l2"]
        if name == "flash_attention":
            rec["lse_max_err_f32"] = tr["errs"]["lse"]["float32"]
            rec["lse_max_err_bf16"] = tr["errs"]["lse"]["bfloat16"]
        for label in ("long", "rgemma", "rgemma_long", "long_b4", "gate",
                      "granite", "deepseek", "gemma2", "mla", "phi3",
                      "nemotron", "pixtral", "musicgen", "prefill",
                      "granite_decode"):
            if (name, label) in results["times"]:
                t = results["times"][(name, label)]
                rec[label] = {k: t[k] for k in keys + ("device_gb_s",)
                              if k in t}
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
