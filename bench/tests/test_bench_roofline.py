"""The roofline counts against operations and bytes worked out by hand."""
import pytest

from bench.roofline import counts

TINY = {"num_hidden_layers": 2, "hidden_size": 8, "num_attention_heads": 2,
        "num_key_value_heads": 1, "head_dim": 4, "intermediate_size": 6,
        "vocab_size": 10, "hidden_act": "silu", "tie_word_embeddings": True,
        "num_local_experts": 4, "num_experts_per_tok": 2}
DENSE = dict(TINY, hidden_act="gelu_pytorch_tanh", tie_word_embeddings=False,
             num_local_experts=0, num_experts_per_tok=0)


def test_k1():
    # B 1, S 3, H 2, Hkv 1, hd 4: 6 causal pairs a head, 2 * (4 + 4) each
    flops, nbytes = counts.k1(TINY, 1, 3)
    assert flops == 1 * 2 * 6 * 2 * 8
    assert nbytes == 2 * (3 * 2 * 4 + 2 * 3 * 1 * 4 + 3 * 2 * 4)


def test_k2():
    # B 2 at position 4: 5 cached positions
    flops, nbytes = counts.k2(TINY, 2, 4)
    assert flops == 2 * 2 * 5 * 2 * 8
    assert nbytes == 2 * (2 * 1 * 5 * 8 + 2 * 2 * 8) + 4 * 2


def test_score_step_moe():
    B, S = 1, 3
    attn = 8 * 8 + 2 * 8 * 4 + 8 * 8               # wq, wk, wv, wo
    expert = 3 * 8 * 6
    flops, nbytes = counts.score_step(TINY, B, S)
    per_layer = 2 * 3 * (attn + 2 * expert) + counts.k1(TINY, B, S)[0] \
        + 2 * 3 * 8 * 4                             # router
    assert flops == 2 * per_layer + 2 * B * 8 * 10
    assert nbytes == 2 * (2 * (attn + 4 * expert) + 8 * 10) + 4 * 3 + 4 * 10


def test_decode_step_dense():
    B, pos = 2, 4
    attn = 8 * 8 + 2 * 8 * 4 + 8 * 8
    mlp = 2 * 8 * 6
    flops, nbytes = counts.decode_step(DENSE, B, pos)
    assert flops == 2 * (2 * B * (attn + mlp) + counts.k2(DENSE, B, pos)[0]) \
        + 2 * B * 8 * 10
    kv = 2 * 2 * B * 2 * 1 * 4 * 5
    assert nbytes == 2 * (2 * (attn + mlp) + 8 * 10) + kv + 4 * B * 10


@pytest.mark.parametrize("flops,nbytes,by", [(989e12, 1.0, "operations"),
                                             (1.0, 3.35e12, "bytes")])
def test_bound(flops, nbytes, by):
    t, what = counts.bound_s(flops, nbytes)
    assert t == pytest.approx(1.0) and what == by


def test_weight_bytes_granite():
    import json
    from pathlib import Path
    m = json.loads((Path(counts.__file__).parents[1] / "configs" /
                    "granite-moe-1b-a400m.json").read_text())["model"]
    # 1.33 B parameters in bfloat16, as the configuration states
    assert 2.6e9 < counts.weight_bytes(m) < 2.7e9
