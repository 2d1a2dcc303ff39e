"""DeepSeek-V2-Lite 16B: MLA attention (kv_lora=512), first layer dense MLP,
remaining layers MoE with 64 routed experts top-6 + 2 shared.
[arXiv:2405.04434]

The assignment header mentions both "64e top-6" and "160 routed"; 160 is the
full DeepSeek-V2 — the V2-Lite line (64 routed, top-6, 2 shared) is
authoritative here and matches the cited model.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,            # MLA: KV heads == heads after latent expansion
    head_dim=128,
    d_ff=10944,               # dense-MLP hidden for layer 0 (per model card)
    vocab_size=102400,
    segments=((("mla",), 1), (("mla_moe",), 26)),
    activation="swiglu",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=None,
                  nope_head_dim=128, rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_ff=1408),
    source="arXiv:2405.04434",
)
