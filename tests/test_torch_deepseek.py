"""DeepSeek-V2's settings in the port, on the CPU: YaRN RoPE, top-k gates
kept as the softmax gave them, and the expert-row records of a served
generation (``configs/port.py``, ``models/layers.py``, ``models/mla.py``,
``models/moe.py``, ``serving/executor.py``, ``telemetry/recorder.py``).

* YaRN's frequencies and scales against their closed form at
  DeepSeek-V2-Lite's rope width (low 10, high 23, mscale 1.2608, softmax
  factor 1.5897, cos/sin factor 1), at every position;
* with no scaling set, RoPE, the MLA blocks and a granite MoE model are
  bit for bit what a copied ``ModelConfig`` serves;
* ``norm_topk_prob=False`` against the dense oracle and against raw
  gates worked out here; the default renormalises, as before;
* a generation's prefill and each of its decode replays record the
  routed assignments (T * k) and the expert rows computed (E * G * C),
  counted at capture, and counting adds no operation to a step.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.port import (PortMoEConfig, YaRN,  # noqa: E402
                                      port_config)
from repro_torch.core import FunctionSpec, Runtime  # noqa: E402
from repro_torch.models import make_model  # noqa: E402
from repro_torch.models import layers, mla, moe  # noqa: E402
from repro_torch.serving import (Executor, ModelEndpoint,  # noqa: E402
                                 WeightStore)
from repro_torch.serving import executor as executor_mod  # noqa: E402
from repro_torch.telemetry.recorder import Recorder  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

LITE = YaRN(factor=40.0, original_max_position_embeddings=4096,
            beta_fast=32.0, beta_slow=1.0, mscale=0.707, mscale_all_dim=0.707)
B, SEQ, MAX_LEN, N_STEPS = 2, 16, 24, 5


def _deepseek(**moe_kw):
    """Reduced deepseek (an ``mla`` and an ``mla_moe`` layer) in float32,
    4 experts top-2 and a shared expert, routed without drops."""
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b").reduced(),
                              dtype="float32", vocab_size=128)
    kw = dict(capacity_factor=2.0)
    kw.update(moe_kw)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **kw))


def _lift(cfg, norm_topk_prob=True, **changes):
    fields = {f.name: getattr(cfg.moe, f.name)
              for f in dataclasses.fields(cfg.moe)}
    return port_config(cfg, moe=PortMoEConfig(**fields,
                                              norm_topk_prob=norm_topk_prob),
                       **changes)


def _randn(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


# ----------------------------------------------------------------------
# YaRN
def test_yarn_closed_form_at_deepseek_v2_lite():
    dim, theta = 64, 10000.0
    assert layers.yarn_range(dim, theta, LITE) == (10, 23)
    ms = layers.yarn_mscale(40.0, 0.707)
    assert ms == pytest.approx(1.2608, abs=1e-4)
    assert ms ** 2 == pytest.approx(1.5897, abs=1e-4)
    assert layers.yarn_mscale(40.0, 0.707) / layers.yarn_mscale(40.0, 0.707) \
        == 1.0
    # the closed form, in float64
    i = np.arange(dim // 2)
    extra = theta ** (-2.0 * i / dim)
    inter = extra / 40.0
    mask = 1.0 - np.clip((i - 10) / (23 - 10), 0.0, 1.0)
    want = inter * (1.0 - mask) + extra * mask
    got = layers.rope_frequencies(dim, theta, yarn=LITE).double().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.all(got[:11] == layers.rope_frequencies(dim, theta)[:11]
                  .numpy())                  # below low: RoPE's own
    np.testing.assert_allclose(got[23:], extra[23:] / 40.0, rtol=1e-6)


def test_yarn_scales_the_mla_softmax():
    plain = _deepseek()
    yarn = port_config(plain, rope_scaling=LITE)
    assert mla._scale(plain) == 1.0 / math.sqrt(
        plain.mla.nope_head_dim + plain.mla.rope_head_dim)
    assert mla._scale(yarn) / mla._scale(plain) == pytest.approx(
        1.2608037774 ** 2, rel=1e-9)
    nodim = port_config(plain, rope_scaling=dataclasses.replace(
        LITE, mscale_all_dim=0.0))
    assert mla._scale(nodim) == mla._scale(plain)


@pytest.mark.parametrize("mscale", [0.707, 1.0])
def test_yarn_rotation_at_every_position(mscale):
    """Past the original 4096 positions and before: the half-split
    rotation at YaRN's frequencies, cos and sin times mscale /
    mscale_all_dim."""
    yarn = dataclasses.replace(LITE, mscale=mscale)
    x = _randn(1, 6, 2, 64, seed=1)
    pos = torch.tensor([[0, 1, 17, 4095, 4096, 9000]])
    got = layers.apply_rope(x, pos, 10000.0, yarn)
    inv = layers.rope_frequencies(64, 10000.0, yarn=yarn)
    m = layers.yarn_mscale(40.0, mscale) / layers.yarn_mscale(40.0, 0.707)
    ang = pos[0].float()[:, None] * inv            # (6, 32), float32 angles
    cos, sin = (torch.cos(ang) * m)[:, None], (torch.sin(ang) * m)[:, None]
    x1, x2 = x[..., :32], x[..., 32:]
    want = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    plain = layers.apply_rope(x, pos, 10000.0)
    assert not torch.allclose(got, plain, atol=1e-3)


def test_yarn_is_served_for_mla_blocks_only():
    granite = get_config("granite-moe-1b-a400m").reduced()
    with pytest.raises(AssertionError, match="MLA"):
        port_config(granite, rope_scaling=LITE)


def test_no_scaling_leaves_rope_unchanged():
    x = _randn(2, 5, 3, 32, seed=2)
    pos = torch.arange(5)[None, :].expand(2, 5)
    freqs = 1.0 / (10000.0 ** (torch.arange(0, 32, 2, dtype=torch.float32)
                               / 32))
    ang = (pos[..., None].float() * freqs)[..., None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    want = torch.cat([x1 * torch.cos(ang) - x2 * torch.sin(ang),
                      x2 * torch.cos(ang) + x1 * torch.sin(ang)], dim=-1)
    assert torch.equal(layers.apply_rope(x, pos, 10000.0), want)
    assert torch.equal(layers.apply_rope(x, pos, 10000.0, None), want)


def _serve(cfg, params, toks, n=4):
    """Forward hidden states, then prefill and ``n`` greedy decode steps'
    logits."""
    model = make_model(cfg, device="cpu")
    with torch.no_grad():
        x, _ = model.forward(params, toks)
        outs = [x]
        logits, cache = model.prefill(params, toks, max_len=toks.shape[1] + n)
        pos = torch.full((toks.shape[0],), toks.shape[1], dtype=torch.int32)
        for _ in range(n):
            outs.append(logits)
            tok = logits[:, -1:].argmax(-1).to(torch.int32)
            logits, cache = model.decode_step(params, cache, tok, pos)
            pos = pos + 1
    return outs


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "granite-moe-1b-a400m"])
def test_defaults_serve_bit_for_bit_as_the_copied_config(arch):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              vocab_size=128)
    lifted = _lift(cfg)
    assert lifted.rope_scaling is None and lifted.moe.norm_topk_prob
    params = make_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(3))
    toks = torch.randint(0, 128, (B, SEQ),
                         generator=torch.Generator().manual_seed(4))
    for a, b in zip(_serve(cfg, params, toks), _serve(lifted, params, toks)):
        assert torch.equal(a, b)
    # and a setting that serves another function changes it
    yarn = _serve(port_config(lifted, rope_scaling=LITE), params, toks) \
        if arch.startswith("deepseek") else None
    if yarn is not None:
        assert not torch.allclose(yarn[0], _serve(cfg, params, toks)[0])


# ----------------------------------------------------------------------
# gates
@pytest.fixture(scope="module")
def ffn():
    cfg = _deepseek()
    params = make_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(5))
    seg = params["seg0"][cfg.segments[0][0].index("mla_moe")]["ffn"]
    p = {k: v[0] for k, v in seg.items() if k != "shared"}
    p["shared"] = {k: v[0] for k, v in seg["shared"].items()}
    x = _randn(B, SEQ, cfg.d_model, seed=6)
    return cfg, p, x


def _raw_gate_moe(p, x, cfg):
    """Worked out here: each token through its top-k experts weighted by
    its softmax gates as they are, plus the shared expert."""
    x2d = x.reshape(-1, x.shape[-1])
    gates = torch.softmax(x2d @ p["router"], dim=-1)
    out = torch.zeros_like(x2d)
    for t in range(x2d.shape[0]):
        g, idx = torch.topk(gates[t], cfg.moe.top_k)
        for w, e in zip(g, idx):
            h = x2d[t] @ p["wg_e"][e]
            out[t] += w * ((torch.nn.functional.silu(h)
                            * (x2d[t] @ p["wi_e"][e])) @ p["wo_e"][e])
    out = out.reshape(x.shape)
    return out + layers.mlp_apply(p["shared"], x, cfg.activation)


def test_raw_gates_match_the_oracle_and_the_worked_form(ffn):
    cfg, p, x = ffn
    raw = _lift(cfg, norm_topk_prob=False)
    with torch.no_grad():
        probs, _, _ = moe._routing(p, x.reshape(-1, cfg.d_model), raw.moe)
        assert torch.all(probs.sum(-1) < 1.0)
        out, _ = moe.moe_apply(p, x, raw)
        ref, _ = moe.moe_ref(p, x, raw)
        mine = _raw_gate_moe(p, x, cfg)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out, mine, rtol=1e-5, atol=1e-5)


def test_default_gates_are_renormalised_as_before(ffn):
    cfg, p, x = ffn
    lifted = _lift(cfg)
    with torch.no_grad():
        probs, _, _ = moe._routing(p, x.reshape(-1, cfg.d_model), lifted.moe)
        torch.testing.assert_close(probs.sum(-1), torch.ones(B * SEQ))
        assert torch.equal(moe.moe_apply(p, x, lifted)[0],
                           moe.moe_apply(p, x, cfg)[0])
        raw = moe.moe_apply(p, x, _lift(cfg, norm_topk_prob=False))[0]
    assert not torch.allclose(raw, moe.moe_apply(p, x, cfg)[0], atol=1e-3)


# ----------------------------------------------------------------------
# expert-row records
class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.append(func._schema.name)
        return func(*args, **(kwargs or {}))


def test_counting_rows_adds_no_operation(ffn):
    cfg, p, x = ffn
    with torch.no_grad():
        with _Ops() as plain:
            moe.moe_apply(p, x, cfg)
        with moe.counting_rows() as count, _Ops() as counted:
            moe.moe_apply(p, x, cfg)
    assert counted.seen == plain.seen
    C = moe._capacity(B * SEQ, cfg.moe)
    assert (count.assignments, count.rows) == (
        B * SEQ * cfg.moe.top_k, cfg.moe.n_experts * 1 * C)


class _Graphs:
    """Stands in for the card's graphs (``executor._graph_backend``): a
    replay runs the captured call again."""

    def __init__(self):
        self.captures = 0

    def warm(self, run):
        run()

    def capture(self, run):
        self.captures += 1
        out = run()
        return _Replay(run, out), out


class _Replay:
    def __init__(self, run, out):
        self.run, self.out = run, out

    def replay(self):
        new = self.run()
        for have, got in zip(executor_mod._leaves(self.out),
                             executor_mod._leaves(new)):
            if have is not got:
                have.copy_(got)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    cfg = _lift(_deepseek(), norm_topk_prob=False, rope_scaling=LITE)
    st = WeightStore(str(tmp_path_factory.mktemp("deepseek")))
    st.publish("ds", make_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(7)))
    return cfg, st


def _generate(cfg, st, rec, n_gen=2):
    ep = ModelEndpoint("ds", cfg, st, Executor(), batch_size=B,
                       seq_len=SEQ, device="cpu", tracer=rec)

    def plan_factory(rt):
        base = ep.build_plan(rt)
        base.entries.extend(ep.session_plan_entries(MAX_LEN, rt))
        return base

    def code(ctx, args):
        return ep.generate(ctx, args["tokens"], n_steps=N_STEPS,
                           max_len=MAX_LEN, plan_offset=3)
    rt = Runtime(FunctionSpec("ds/gen", code, plan_factory=plan_factory,
                              app="serving"))
    rt.init()
    rt.freshen(blocking=True)
    prompt = np.arange(B * SEQ, dtype=np.int32).reshape(B, SEQ) % 100
    for _ in range(n_gen):
        assert len(rt.run({"tokens": prompt})) == N_STEPS
    return rt


@pytest.mark.parametrize("captured", [False, True])
def test_each_replay_records_its_expert_rows(store, monkeypatch, captured):
    cfg, st = store
    graphs = _Graphs()
    if captured:
        monkeypatch.setattr(executor_mod, "_graph_backend",
                            lambda device: graphs)
    rec = Recorder()
    _generate(cfg, st, rec)
    assert graphs.captures == (3 if captured else 0)  # score, prefill, decode
    recs = rec.row_records()
    n_moe, E, k = 1, cfg.moe.n_experts, cfg.moe.top_k
    C_pre = moe._capacity(B * SEQ, cfg.moe)
    C_dec = moe._capacity(B, cfg.moe)
    assert (C_pre, C_dec) == (32, 4)
    per = {"prefill": (B * SEQ * k * n_moe, E * 1 * C_pre * n_moe),
           "decode": (B * k * n_moe, E * 1 * C_dec * n_moe)}
    assert [r.kind for r in recs] == (["prefill"] + ["decode"] * (N_STEPS - 1)) * 2
    assert all((r.assignments, r.rows) == per[r.kind] for r in recs)
    for gen in {r.gen for r in recs}:
        mine = [r for r in recs if r.gen == gen]
        starts = [r.start for r in mine]
        assert len(mine) == N_STEPS and starts == sorted(starts)
        decodes = [d.start for d in rec.decode_steps() if d.gen == gen]
        assert len(decodes) == N_STEPS - 1
        # each decode record begins with its step, after the timer's start
        assert all(d <= r for d, r in zip(decodes, starts[1:]))
    assert not any(r.profiled for r in recs)


def test_a_model_without_experts_records_no_rows(tmp_path):
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(d_model=64),
                              dtype="float32", vocab_size=128)
    st = WeightStore(str(tmp_path))
    st.publish("ds", make_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(8)))
    rec = Recorder()
    _generate(cfg, st, rec, n_gen=1)
    assert rec.row_records() == [] and len(rec.decode_steps()) == N_STEPS - 1
