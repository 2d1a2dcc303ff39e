"""MusicGen-medium decoder backbone over EnCodec tokens; the conv/codec
frontend is stubbed — inputs are precomputed frame embeddings + codebook
tokens.  [arXiv:2306.05284]

Adaptation note: the original uses learned absolute positions; we use RoPE
for substrate uniformity (recorded in DESIGN.md).  MHA: n_kv_heads == n_heads.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    segments=((("attn",), 48),),
    activation="gelu",
    frontend="audio",
    source="arXiv:2306.05284 (EnCodec frontend stubbed per spec)",
)
