"""Whole runs of the harness at a tiny size on the CPU: the look for a card
is skipped, the rest of a run is driven.  Sound runs come out correct; a
run whose timed path is broken underneath comes out not correct, once for
each fault a serving cell can have (an answer altered where it is
produced, half of a batch left out, a served token altered, in row 0 or,
where every row is returned, in the later rows); and the control, the
reference in float8 in the program's place, fails the check."""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from bench.harness import cells, check, spec
from bench.run import run_cell

DATA = Path(__file__).parent / "data"
ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 77


def _run(name, seconds=2.0):
    cell = spec.load(name, DATA, DATA)
    return run_cell(cell, SEED, seconds, False, torch.device("cpu"),
                    time.monotonic())


@pytest.mark.parametrize("name,metric", [
    ("tiny-fresh", "device_gb_s_per_invoke"), ("tiny-gen", "tokens_per_s"),
    ("tiny-named", "device_gb_s_per_invoke")])
def test_sound_run_is_correct(name, metric):
    res = _run(name)
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert metric in res["metrics"] and "setup_s" in res["metrics"]
    assert list(res)[-1] == "check"


def _patch_scores(monkeypatch, alter):
    from repro_torch.serving import ModelEndpoint
    code = ModelEndpoint.code

    def broken(self, ctx, args):
        out = code(self, ctx, args)
        out["logits"] = alter(np.array(out["logits"]))
        return out
    monkeypatch.setattr(ModelEndpoint, "code", broken)


def _other_row(x):
    x[0] = x[1]
    return x


def _half_left_out(x):
    x[x.shape[0] // 2:] = 0.0
    return x


@pytest.mark.parametrize("name,alter", [
    ("tiny-fresh", _other_row), ("tiny-fresh", _half_left_out)])
def test_broken_scores_are_not_correct(monkeypatch, name, alter):
    _patch_scores(monkeypatch, alter)
    res = _run(name)
    assert not res["correct"], res["check"]


def test_altered_token_is_not_correct(monkeypatch):
    from repro_torch.serving import ModelEndpoint
    generate = ModelEndpoint.generate

    def broken(self, *a, **kw):
        out = list(generate(self, *a, **kw))
        out[len(out) // 2] = (out[len(out) // 2] + 1) % self.cfg.vocab_size
        return out
    monkeypatch.setattr(ModelEndpoint, "generate", broken)
    assert not _run("tiny-gen")["correct"]


@pytest.mark.parametrize("name", ["tiny-fresh", "tiny-gen"])
def test_control_is_not_correct(name):
    cell = spec.load(name, DATA, DATA)
    w, prog = cells.DRIVERS[cell.mix["entry"]](cell, SEED, 1.5, False,
                                               torch.device("cpu"))
    prog.close()
    dev = torch.device("cpu")
    ok, _ = check.verdict(check.judge(cell, SEED, w, dev), cell.limits)
    assert ok
    ctrl, table = check.verdict(check.judge(cell, SEED, w, dev,
                                            precision="fp8"), cell.limits)
    assert not ctrl, table


def test_tokens_counted_are_the_tokens_returned():
    """``generate`` returns row 0's tokens: the rate counts those, not the
    rows the step decodes and nobody receives."""
    cell = spec.load("tiny-gen", DATA, DATA)
    w, prog = cells.run_generate(cell, SEED, 1.5, False, torch.device("cpu"))
    prog.close()
    assert w.answers
    assert all(np.asarray(a).shape == (cell.mix["new_tokens"],)
               for a in w.answers.values())
    assert w.tokens == cell.mix["new_tokens"] * len(w.completions)


def _every_row(monkeypatch, alter=None):
    """``generate`` returning every row's tokens, as a later program may;
    with ``alter``, those rows changed before they are returned."""
    from repro_torch.serving import ModelEndpoint
    generate = ModelEndpoint.generate

    def rows(self, ctx, tokens, **kw):
        out = [generate(self, ctx, np.asarray(tokens)[[r] * len(tokens)],
                        **kw) for r in range(len(tokens))]
        out = np.asarray(out)
        return alter(out, self.cfg.vocab_size) if alter else out.tolist()
    monkeypatch.setattr(ModelEndpoint, "generate", rows)


def _later_rows_altered(out, vocab):
    out[1:, len(out[0]) // 2] = (out[1:, len(out[0]) // 2] + 1) % vocab
    return out.tolist()


@pytest.mark.parametrize("alter,correct", [(None, True),
                                           (_later_rows_altered, False)])
def test_every_returned_row_is_checked(monkeypatch, alter, correct):
    """An answer of every row is counted row by row and judged row by
    row: a token altered in rows 1-3 alone comes out not correct."""
    _every_row(monkeypatch, alter)
    res = _run("tiny-gen")
    assert res["correct"] is correct, res["check"]


def test_named_reference_judges(monkeypatch):
    """``tiny-named``'s file names a reference of its own: a change to that
    module alone makes the same run not correct, and the plain decoder's
    module is not what judged it."""
    from bench.reference import transformer
    plain = transformer.forward
    named = spec.load("tiny-named", DATA, DATA).reference
    assert named is not transformer

    def off(*a, **kw):
        return plain(*a, **kw) * 1.01
    monkeypatch.setattr(named, "forward", off)
    res = _run("tiny-named")
    assert not res["correct"], res["check"]
    assert transformer.forward is plain
    assert spec.reference(json.loads(
        (DATA / "configs" / "tiny-moe.json").read_text())).forward is not off


def test_named_program_is_served(monkeypatch):
    """``tiny-named``'s file names a program mapping of its own: the
    ``ModelConfig`` its ``program_config`` returns is the one served, and
    one that differs from the reference's layout stops the run."""
    conf = spec.load("tiny-named", DATA, DATA).config
    mod = spec._bench_module(conf["program"])
    mapping = mod.program_config
    served = []

    def recorded(c):
        served.append(mapping(c))
        return served[-1]
    monkeypatch.setattr(mod, "program_config", recorded)
    assert _run("tiny-named")["correct"]
    assert served

    def wider(c):
        return mapping(dict(c, model=dict(c["model"], vocab_size=98)))
    monkeypatch.setattr(mod, "program_config", wider)
    with pytest.raises(RuntimeError, match="layout"):
        _run("tiny-named")


def test_missing_answers_are_not_correct():
    ok, table = check.verdict({"logits_rel_err_mean": 0.0, "missing": 1.0},
                              {"logits_rel_err_mean": 0.1})
    assert not ok and table["missing"]["limit"] == 0.0


def test_no_card_no_result():
    """Without a CUDA card the command exits non-zero and prints nothing on
    its standard output."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "granite-fresh", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.card
@pytest.mark.parametrize("workload", ["musicgen-gen"])
def test_cell_on_the_card(card, workload):
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        workload, "--seed", str(SEED), "--seconds", "10",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
