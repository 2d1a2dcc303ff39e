"""The benchmark's plain reference against the program it judges, at a
tiny size on the CPU in float32: the same weights and tokens give the same
logits, through experts routed without drops and through the decode cache.
(The test may import both; the reference imports nothing of the program.)
A configuration's reference and program mapping are the modules its file
names."""
import hashlib
import json
from pathlib import Path

import pytest
import torch

from bench.harness import spec
from bench.harness.spec import program_config
from bench.harness.weights import check_layout, make_weights
from bench.reference import transformer as ref

DATA = Path(__file__).parent / "data" / "configs"


def _conf(name):
    return json.loads((DATA / f"{name}.json").read_text())


def _setup(name, seed=7):
    from repro_torch.checkpoint.io import flatten_with_paths, unflatten_paths
    from repro_torch.models import make_model
    conf = _conf(name)
    m = conf["model"]
    model = make_model(spec.model_config(conf), device="cpu")
    W = make_weights(spec.reference(conf), m, torch.float32, seed,
                     torch.device("cpu"))
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
    m = _conf("tiny-moe")["model"]
    cpu = torch.device("cpu")
    a = make_weights(ref, m, torch.float32, 2 ** 31 + 9, cpu)
    b = make_weights(ref, m, torch.float32, 2 ** 31 + 9, cpu)
    c = make_weights(ref, m, torch.float32, 2 ** 31 + 10, cpu)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])


# sha256 over the leaves in key order (each key, then its bytes) of the
# weights drawn at seed 7 on the CPU by the parent of the change that let a
# configuration name its reference, commit 3de6fdb85b0c35b5b8e33ec3b47abe6e0f210360
PARENT_DIGESTS = {
    ("tiny-moe", torch.float32):
        "ae319096da4f3cecb3b211a73d209906a63497b0efe1b0cf226460c5913d3bf7",
    ("tiny-moe", torch.bfloat16):
        "1b0488c49b853a3bcc286c99b8a769f130cc894d8e6ed179aa3295ab84b0f2d2",
    ("tiny-dense", torch.float32):
        "d6e60a62ddc418fa992a61db44673a17c0cbbb79e6b3cdd1beb11388787c5969",
    ("tiny-dense", torch.bfloat16):
        "77affa215fc969afb88a1b927bca3868bd3d08d1a83b05a40b0be5709e8eeddb",
}


@pytest.mark.parametrize("name,dtype", sorted(PARENT_DIGESTS, key=str))
def test_weights_are_the_parents(name, dtype):
    """The weights drawn through the configuration's named reference are,
    bit for bit, those the harness drew when it imported the reference by
    name: each seed gives the existing cells the same weights."""
    conf = _conf(name)
    W = make_weights(spec.reference(conf), conf["model"], dtype, 7,
                     torch.device("cpu"))
    h = hashlib.sha256()
    for k in sorted(W):
        h.update(k.encode())
        h.update(W[k].contiguous().view(-1).view(torch.uint8).numpy()
                 .tobytes())
    assert h.hexdigest() == PARENT_DIGESTS[(name, dtype)]


def test_reference_is_the_named_module():
    plain = spec.reference(_conf("tiny-moe"))
    assert Path(plain.__file__) == Path(ref.__file__)
    named = spec.reference(_conf("tiny-named"))
    assert named is spec.reference(_conf("tiny-named"))      # loaded once
    assert Path(named.__file__) == DATA.parent / "reference" / "tiny_named.py"


@pytest.mark.parametrize("conf,match", [
    ({"name": "x"}, "'reference' key"),
    ({"name": "x", "reference": "src/repro_torch/__init__.py"}, "under bench"),
    ({"name": "x", "reference": "bench/../src/repro_torch/__init__.py"},
     "under bench"),
    ({"name": "x", "reference": "/etc/passwd"}, "under bench"),
    ({"name": "x", "reference": "bench/reference/absent.py"}, "under bench"),
    ({"name": "x", "reference": "bench/README.md"}, "under bench")])
def test_reference_not_named_is_refused(conf, match):
    with pytest.raises(ValueError, match=match):
        spec.reference(conf)


def test_program_key_absent_serves_the_default_mapping():
    conf = _conf("tiny-moe")
    assert "program" not in conf
    assert spec.model_config(conf) == program_config(conf)
