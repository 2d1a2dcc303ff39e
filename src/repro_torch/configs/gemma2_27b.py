"""Gemma-2 27B: alternating local(4096-window)/global attention, logit
softcaps, sandwich norms, scaled embedding.  [arXiv:2408.00118]

long_context_ok: half the layers are 4k-window local; the global layers
decode in O(L) per token against a mesh-sharded KV cache, so long_500k
decode is feasible (see DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    segments=((("attn_local", "attn"), 23),),
    activation="swiglu",
    window_size=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    query_scale=(4608 / 32) ** -0.5,   # query_pre_attn_scalar = d_model/n_heads
    use_post_norm=True,
    scale_embedding=True,
    tie_embeddings=True,
    long_context_ok=True,
    source="arXiv:2408.00118",
)
