"""The benchmark's plain reference against the program it judges, at a
tiny size on the CPU in float32: the same weights and tokens give the same
logits, through experts routed without drops and through the decode cache.
(The test may import both; the reference imports nothing of the program.)"""
import json
from pathlib import Path

import pytest
import torch

from bench.harness.spec import program_config
from bench.harness.weights import check_layout, make_weights
from bench.reference import transformer as ref

DATA = Path(__file__).parent / "data" / "configs"


def _setup(name, seed=7):
    from repro_torch.checkpoint.io import flatten_with_paths, unflatten_paths
    from repro_torch.models import make_model
    conf = json.loads((DATA / f"{name}.json").read_text())
    m = conf["model"]
    model = make_model(program_config(conf), device="cpu")
    W = make_weights(m, torch.float32, seed, torch.device("cpu"))
    check_layout(W, flatten_with_paths(model.param_specs()))
    return m, model, W, unflatten_paths(W)


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("name", ["tiny-moe", "tiny-dense"])
def test_forward_matches_program(name):
    m, model, W, params = _setup(name)
    toks = torch.randint(0, m["vocab_size"], (4, 16),
                         generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        x, _ = model.forward(params, toks)
        got = model._logits(params, x)
    want = ref.forward(m, W, toks)
    assert _rel(got, want) < 1e-5


def test_crowded_experts_match_without_drops():
    """Tokens that all choose alike crowd the same experts: at the
    configuration's capacity the program drops none, as the reference."""
    m, model, W, params = _setup("tiny-moe")
    toks = torch.full((4, 16), 5, dtype=torch.long)
    want = ref.forward(m, W, toks, last_only=True)
    with torch.no_grad():
        x, _ = model.forward(params, toks)
        got = model._logits(params, x[:, -1:])
    assert _rel(got, want) < 1e-5


def test_capacity_that_drops_is_refused():
    m, _, W, _ = _setup("tiny-moe")
    m = dict(m, moe_capacity_factor=1.25)
    with pytest.raises(ValueError, match="drop"):
        ref.forward(m, W, torch.zeros((4, 16), dtype=torch.long))


def test_multipliers_the_program_cannot_serve_are_refused():
    conf = json.loads((DATA / "tiny-moe.json").read_text())
    conf["model"]["residual_multiplier"] = 0.22
    with pytest.raises(ValueError, match="residual_multiplier"):
        program_config(conf)


def test_decode_through_cache_matches_full_forward():
    m, model, W, params = _setup("tiny-dense")
    B, S, n = 4, 16, 6
    toks = torch.randint(0, m["vocab_size"], (B, S),
                         generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        logits, cache = model.prefill(params, toks, max_len=S + n)
        seq = [toks]
        steps = [logits[:, -1]]
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
        pos = torch.full((B,), S, dtype=torch.int32)
        for _ in range(n - 1):
            seq.append(tok)
            logits, cache = model.decode_step(params, cache, tok, pos)
            steps.append(logits[:, -1])
            tok = logits[:, -1:].argmax(-1).to(torch.int32)
            pos = pos + 1
    full = ref.forward(m, W, torch.cat(seq, dim=1).long())
    got = torch.stack(steps, dim=1)
    assert _rel(got, full[:, S - 1:]) < 1e-5


def test_fp8_control_departs():
    m, _, W, _ = _setup("tiny-moe")
    toks = torch.randint(0, m["vocab_size"], (4, 16),
                         generator=torch.Generator().manual_seed(5))
    assert _rel(ref.forward(m, W, toks, precision="fp8"),
                ref.forward(m, W, toks)) > 1e-2


def test_layout_mismatch_is_refused():
    m, model, W, _ = _setup("tiny-moe")
    from repro_torch.checkpoint.io import flatten_with_paths
    W.pop("embed")
    with pytest.raises(RuntimeError, match="layout"):
        check_layout(W, flatten_with_paths(model.param_specs()))


def test_weights_repeat_from_the_seed():
    m = json.loads((DATA / "tiny-moe.json").read_text())["model"]
    a = make_weights(m, torch.float32, 2 ** 31 + 9, torch.device("cpu"))
    b = make_weights(m, torch.float32, 2 ** 31 + 9, torch.device("cpu"))
    c = make_weights(m, torch.float32, 2 ** 31 + 10, torch.device("cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])
