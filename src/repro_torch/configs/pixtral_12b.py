"""Pixtral-12B language backbone (Mistral-Nemo style) consuming ViT patch
embeddings from a stubbed vision frontend.  [hf:mistralai/Pixtral-12B-2409]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    segments=((("attn",), 40),),
    activation="swiglu",
    rope_theta=1_000_000.0,
    frontend="vision",
    source="hf:mistralai/Pixtral-12B-2409 (ViT frontend stubbed per spec)",
)
