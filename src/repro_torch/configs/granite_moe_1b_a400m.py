"""IBM Granite-3.0 1B-A400M: 32-expert top-8 MoE, every layer.
[hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    segments=((("attn_moe",), 24),),
    activation="swiglu",
    moe=MoEConfig(n_experts=32, top_k=8, n_shared=0, d_ff=512),
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
