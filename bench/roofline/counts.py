"""Operations and bytes of the served kernels and whole steps, from shapes.

A frozen copy of the bound arithmetic behind the port's kernel table
(``PERF.md``): a bound is the larger of operations over the peak rate and
bytes over the peak bandwidth, and a share is that bound over the time
measured.  Every input byte is counted as read once and every output byte
as written once, whatever a kernel reads again, and only the work these
inputs need: a share computed this way cannot pass 100% unless the time
leaves out part of the work.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 989 TFLOP/s bfloat16 on the tensor cores, 3.35 TB/s of HBM3.
"""
from __future__ import annotations

from typing import Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
BF16 = 2

# the port's device kernels by the names the profiler gives them: K1 the
# prefill attention (bf16 on the tensor cores, float32 scalar), K2 the
# split-KV decode attention (two kernels a call)
KERNELS = {"k1": ("flash_wgmma_kernel", "flash_fwd_kernel"),
           "k2": ("decode_split_kernel", "decode_merge_kernel")}


def bound_s(flops: float, nbytes: float) -> Tuple[float, str]:
    """(least seconds, what bounds it: "operations" or "bytes")."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _heads(m: dict):
    hd = int(m.get("head_dim") or m["hidden_size"] // m["num_attention_heads"])
    return m["num_attention_heads"], m["num_key_value_heads"], hd


# ----------------------------------------------------------------------
# kernels
def k1(m: dict, B: int, S: int) -> Tuple[float, float]:
    """K1, causal prefill attention of one layer: (FLOPs, bytes)."""
    H, Hkv, hd = _heads(m)
    pairs = S * (S + 1) // 2
    flops = B * H * pairs * 2 * (hd + hd)
    nbytes = BF16 * (B * S * H * hd + 2 * B * S * Hkv * hd + B * S * H * hd)
    return flops, nbytes


def k2(m: dict, B: int, pos: int) -> Tuple[float, float]:
    """K2, one decode step's attention of one layer over ``pos + 1``
    cached positions: (FLOPs, bytes)."""
    H, Hkv, hd = _heads(m)
    valid = pos + 1
    flops = B * H * valid * 2 * (hd + hd)
    nbytes = BF16 * (B * Hkv * valid * (hd + hd) + B * H * (hd + hd)) + 4 * B
    return flops, nbytes


# ----------------------------------------------------------------------
# whole steps
def _layer_weights(m: dict) -> Tuple[int, int]:
    """(parameters of one layer's attention, of its feed-forward as
    stored); norms excluded (float32, negligible)."""
    d = m["hidden_size"]
    H, Hkv, hd = _heads(m)
    attn = d * H * hd + 2 * d * Hkv * hd + H * hd * d
    f = m["intermediate_size"]
    per = (3 if m["hidden_act"] == "silu" else 2) * d * f
    E = int(m.get("num_local_experts", 0))
    ffn = E * per if E else per
    return attn, ffn


def _active_ffn(m: dict) -> int:
    d, f = m["hidden_size"], m["intermediate_size"]
    per = (3 if m["hidden_act"] == "silu" else 2) * d * f
    k = int(m.get("num_experts_per_tok", 0))
    return k * per if k else per


def _head(m: dict) -> int:
    return m["hidden_size"] * m["vocab_size"]


def score_step(m: dict, B: int, S: int) -> Tuple[float, float]:
    """A scoring forward of B x S tokens that returns the last position's
    logits: (FLOPs, bytes).  Bytes: every weight once (all experts:
    B x S x top-k choices reach every expert at the served sizes), the
    tokens in and the logits out."""
    L = m["num_hidden_layers"]
    attn, ffn = _layer_weights(m)
    T = B * S
    flops = L * (2 * T * (attn + _active_ffn(m)) + k1(m, B, S)[0]
                 + (2 * T * m["hidden_size"] * m["num_local_experts"]
                    if m.get("num_local_experts") else 0))
    flops += 2 * B * _head(m)
    nbytes = BF16 * (L * (attn + ffn) + _head(m)) + 4 * T + 4 * B * m["vocab_size"]
    return flops, nbytes


def decode_step(m: dict, B: int, pos: int) -> Tuple[float, float]:
    """One decode step of B rows at position ``pos``: (FLOPs, bytes).
    Bytes: every layer weight and the output head once (a dense model;
    the embedding lookup reads B rows), the cache up to ``pos`` read, the
    logits out."""
    L = m["num_hidden_layers"]
    attn, ffn = _layer_weights(m)
    H, Hkv, hd = _heads(m)
    flops = L * (2 * B * (attn + _active_ffn(m)) + k2(m, B, pos)[0])
    flops += 2 * B * _head(m)
    kv = L * BF16 * B * 2 * Hkv * hd * (pos + 1)
    nbytes = (BF16 * (L * (attn + ffn) + _head(m)) + kv
              + 4 * B * m["vocab_size"])
    return flops, nbytes


def weight_bytes(m: dict) -> int:
    """Stored bytes of every bfloat16 weight."""
    attn, ffn = _layer_weights(m)
    head = 0 if m.get("tie_word_embeddings") else _head(m)
    return BF16 * (m["num_hidden_layers"] * (attn + ffn) + _head(m) + head)
