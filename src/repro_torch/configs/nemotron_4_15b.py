"""Nemotron-4 15B: GQA with squared-ReLU MLP.  [arXiv:2402.16819]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256000,
    segments=((("attn",), 32),),
    activation="squared_relu",
    source="arXiv:2402.16819",
)
