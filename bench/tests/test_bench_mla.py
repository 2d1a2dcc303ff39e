"""DeepSeek-V2's plain reference (``bench/reference/deepseek_v2.py``), its
program mapping (``bench/programs/deepseek_v2_lite.py``) and their roofline
counts (``bench/roofline/mla_moe.py``), on the CPU at a tiny size.

``tiny-mla`` (``data/mla``) is DeepSeek-V2-Lite's configuration in the
source's key names at tiny widths, with a program mapping of its own: its
run comes out correct, and not correct once the program drops YaRN,
renormalises the gates or drops a shared expert, or once the control, the
reference in float8, takes the program's place.  A mapping whose layout
differs from the reference's stops the run."""
import dataclasses
import json
import math
import time
from pathlib import Path

import pytest
import torch

from bench.harness import cells, check, spec
from bench.harness.weights import check_layout, make_weights
from bench.reference import deepseek_v2 as ref
from bench.roofline import mla_moe
from bench.run import run_cell

DATA = Path(__file__).parent / "data" / "mla"
SEED = 2 ** 31 + 77


def _cell():
    return spec.load("tiny-mla", DATA, DATA)


def _run(seconds=2.0):
    return run_cell(_cell(), SEED, seconds, False, torch.device("cpu"),
                    time.monotonic())


def _mapping():
    return spec._bench_module(_cell().config["program"])


def test_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert {"tokens_per_s", "setup_s"} <= set(res["metrics"])


def _no_yarn(cfg):
    return dataclasses.replace(cfg, rope_scaling=None)


def _renormalised(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, norm_topk_prob=True))


@pytest.mark.parametrize("fault", [_no_yarn, _renormalised])
def test_program_fault_is_not_correct(monkeypatch, fault):
    mod = _mapping()
    mapping = mod.program_config
    monkeypatch.setattr(mod, "program_config", lambda c: fault(mapping(c)))
    res = _run()
    assert not res["correct"], res["check"]


def test_dropped_shared_expert_is_not_correct(monkeypatch):
    """The shared experts are one SwiGLU of their summed width: serving
    the first half of it drops the second shared expert."""
    from repro_torch.models import moe
    mlp = moe.mlp_apply

    def one_shared(p, x, activation):
        f = p["wi"].shape[-1] // 2
        return mlp({"wi": p["wi"][..., :f], "wg": p["wg"][..., :f],
                    "wo": p["wo"][..., :f, :]}, x, activation)
    monkeypatch.setattr(moe, "mlp_apply", one_shared)
    res = _run()
    assert not res["correct"], res["check"]


def test_control_is_not_correct():
    cell = _cell()
    dev = torch.device("cpu")
    w, prog = cells.DRIVERS[cell.mix["entry"]](cell, SEED, 1.5, False, dev)
    prog.close()
    ok, _ = check.verdict(check.judge(cell, SEED, w, dev), cell.limits)
    assert ok
    ctrl, table = check.verdict(check.judge(cell, SEED, w, dev,
                                            precision="fp8"), cell.limits)
    assert not ctrl, table


@pytest.mark.parametrize("change", [{"kv_lora_rank": 48},
                                    {"n_shared_experts": 1},
                                    {"first_k_dense_replace": 2}])
def test_layout_check_stops_a_wrong_mapping(monkeypatch, change):
    mod = _mapping()
    mapping = mod.program_config
    monkeypatch.setattr(mod, "program_config", lambda c: mapping(
        dict(c, model=dict(c["model"], **change))))
    with pytest.raises(RuntimeError, match="layout"):
        _run()


def test_expert_row_share_reads_the_dispatch():
    """At a capacity that holds a whole group every expert computes every
    token of it: k of E rows carry an assignment."""
    cell = _cell()
    w, prog = cells.run_generate(cell, SEED, 1.5, False, torch.device("cpu"))
    prog.close()
    run = dict(config=cell.config, mix=cell.mix, window=w, trace=None,
               counters=w.counters)
    m = cell.config["model"]
    share = spec.reader("summarize.expert_row_share")(run)
    assert share == pytest.approx(
        100.0 * m["num_experts_per_tok"] / m["n_routed_experts"])
    assert all(spec.reader(n)(run) is None for n in (
        "summarize.decode_mfu", "summarize.k2_roofline",
        "summarize.prefill_ms"))               # no device trace on the CPU
    late = dict(run, window=dataclasses.replace(w, t0=time.monotonic() + 1e6))
    assert spec.reader("summarize.expert_row_share")(late) is None


# ----------------------------------------------------------------------
# the reference against the program
def _setup(seed=7):
    from repro_torch.checkpoint.io import flatten_with_paths, unflatten_paths
    from repro_torch.models import make_model
    conf = _cell().config
    m = conf["model"]
    model = make_model(spec.model_config(conf), device="cpu")
    W = make_weights(ref, m, torch.float32, seed, torch.device("cpu"))
    check_layout(W, flatten_with_paths(model.param_specs()))
    return m, model, W, unflatten_paths(W)


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def test_forward_and_decode_match_the_program():
    m, model, W, params = _setup()
    B, S, n = 4, 16, 6
    toks = torch.randint(0, m["vocab_size"], (B, S),
                         generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        x, _ = model.forward(params, toks)
        assert _rel(model._logits(params, x), ref.forward(m, W, toks)) < 1e-5
        logits, cache = model.prefill(params, toks, max_len=S + n)
        seq, steps = [toks], [logits[:, -1]]
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
        pos = torch.full((B,), S, dtype=torch.int32)
        for _ in range(n - 1):
            seq.append(tok)
            logits, cache = model.decode_step(params, cache, tok, pos)
            steps.append(logits[:, -1])
            tok = logits[:, -1:].argmax(-1).to(torch.int32)
            pos = pos + 1
    full = ref.forward(m, W, torch.cat(seq, dim=1).long())
    assert _rel(torch.stack(steps, dim=1), full[:, S - 1:]) < 1e-5


def test_reference_yarn_at_deepseek_v2_lite():
    conf = json.loads((Path(ref.__file__).parents[1] / "configs" /
                       "deepseek-v2-lite-16b.json").read_text())
    m = conf["model"]
    assert ref.yarn_get_mscale(40, 0.707) == pytest.approx(1.2608, abs=1e-4)
    assert ref.softmax_scale(m) * math.sqrt(192) == pytest.approx(
        1.5897, abs=1e-4)
    inv = ref.yarn_inv_freq(64, 10000.0, m["rope_scaling"])
    base = 1.0 / (10000.0 ** (torch.arange(0, 64, 2) / 64))
    torch.testing.assert_close(inv[:11], base[:11])           # below low 10
    torch.testing.assert_close(inv[23:], base[23:] / 40)      # from high 23
    assert torch.all((inv[11:23] < base[11:23])
                     & (inv[11:23] > base[11:23] / 40))


def test_reference_refuses_what_it_does_not_compute():
    m, _, W, _ = _setup()
    toks = torch.zeros((4, 16), dtype=torch.long)
    with pytest.raises(ValueError, match="drop"):
        ref.forward(dict(m, moe_capacity_factor=1.0), W, toks)
    with pytest.raises(ValueError, match="q_lora_rank"):
        ref.forward(dict(m, q_lora_rank=8), W, toks)
    with pytest.raises(ValueError, match="routed_scaling_factor"):
        spec.model_config(dict(_cell().config, model=dict(
            m, routed_scaling_factor=2.0)))


# ----------------------------------------------------------------------
# roofline counts, worked by hand
TINY = {"hidden_size": 8, "num_attention_heads": 2, "qk_nope_head_dim": 4,
        "qk_rope_head_dim": 2, "v_head_dim": 4, "kv_lora_rank": 3,
        "num_hidden_layers": 3, "first_k_dense_replace": 1,
        "n_routed_experts": 5, "num_experts_per_tok": 2,
        "n_shared_experts": 2, "intermediate_size": 10,
        "moe_intermediate_size": 3, "vocab_size": 11}


def test_k2_at_mla_shape():
    # B 2 at position 4: 5 positions, 2 heads, dk 4 + 2, dv 4
    flops, nbytes = mla_moe.k2(TINY, 2, 4)
    assert flops == 2 * 2 * 5 * 2 * (6 + 4)
    assert nbytes == 2 * (2 * 2 * 5 * 10 + 2 * 2 * 10) + 4 * 2


def test_decode_step_needs():
    B, pos = 2, 4
    attn = 8 * 2 * 6 + 8 * (3 + 2) + 3 * 2 * (4 + 4) + 2 * 4 * 8   # 248
    assert mla_moe.attention_weights(TINY) == attn == 248
    # per token: the absorbed products (q, kv_a, q through W_UK, W_UV, wo)
    # and, per head, scores over 5 latents (3 + 2 wide) and their sum (3)
    absorbed = 2 * (8 * 2 * 6 + 8 * 5 + 2 * 4 * 3 + 2 * 3 * 4 + 2 * 4 * 8)
    attn_tok = absorbed + 2 * 2 * 5 * (5 + 3)
    dense, expert = 3 * 8 * 10, 3 * 8 * 3
    flops, nbytes = mla_moe.decode_step(TINY, B, pos)
    assert flops == B * (3 * attn_tok + 2 * dense
                         + 2 * (2 * (2 * expert + 2 * expert) + 2 * 8 * 5)
                         + 2 * 8 * 11)
    assert nbytes == (2 * (3 * attn + dense + 2 * (2 * expert + 2 * expert)
                           + 8 * 11)
                      + 4 * 2 * 8 * 5            # two float32 routers
                      + 2 * 3 * B * 5 * (3 + 2)  # latent cache, 3 layers
                      + 2 * B * 11)              # bf16 logits


def test_weight_bytes_of_the_configuration():
    """DeepSeek-V2-Lite's 15.7 B parameters, from the counts' pieces."""
    m = json.loads((Path(ref.__file__).parents[1] / "configs" /
                    "deepseek-v2-lite-16b.json").read_text())["model"]
    d, L = m["hidden_size"], m["num_hidden_layers"]
    expert = 3 * d * m["moe_intermediate_size"]
    n = (L * mla_moe.attention_weights(m) + 3 * d * m["intermediate_size"]
         + (L - 1) * (66 * expert + d * 64) + 2 * d * m["vocab_size"])
    assert 15.6e9 < n < 15.8e9
