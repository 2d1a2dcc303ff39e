"""Qwen2-0.5B: GQA with QKV bias, tied embeddings.  [arXiv:2407.10671]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151936,
    segments=((("attn",), 24),),
    activation="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="arXiv:2407.10671",
)
