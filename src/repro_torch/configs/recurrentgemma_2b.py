"""RecurrentGemma-2B (Griffin): RG-LRU recurrent blocks and 2048-window local
attention in a 2:1 pattern; 26 layers = 8×(rec,rec,attn) + (rec,rec).
[arXiv:2402.19427]"""
from repro_torch.configs.base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,              # MQA on the local-attention layers
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    segments=((("rglru", "rglru", "attn_local"), 8), (("rglru", "rglru"), 1)),
    activation="gelu",
    window_size=2048,
    scale_embedding=True,
    tie_embeddings=True,
    rglru=RGLRUConfig(d_rnn=2560, conv_width=4, c=8.0),
    source="arXiv:2402.19427",
)
