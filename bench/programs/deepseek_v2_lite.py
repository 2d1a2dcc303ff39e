"""The program mapping that the configuration ``deepseek-v2-lite-16b`` names:
its ``model`` block (the source's ``config.json`` key names) as the port's
``ModelConfig``.

The leading ``first_k_dense_replace`` layers are MLA with a dense MLP
(``mla``), the rest MLA with the mixture of experts (``mla_moe``); the
experts route top-k over a softmax without renormalising
(``norm_topk_prob``), with the shared experts, at the file's capacity;
the rope heads rotate with YaRN (``rope_scaling``); the decode re-expands
the latent cache each step and attends through K2 (``decode_mode``
"naive").  Settings the port cannot serve are refused.
"""
from __future__ import annotations


def program_config(conf: dict):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MLAConfig
    from repro_torch.configs.port import PortMoEConfig, YaRN, port_config
    m = conf["model"]
    served = {"hidden_act": "silu", "q_lora_rank": None,
              "attention_bias": False, "tie_word_embeddings": False,
              "scoring_func": "softmax", "topk_method": "greedy",
              "n_group": 1, "topk_group": 1, "routed_scaling_factor": 1,
              "moe_layer_freq": 1}
    for key, v in served.items():
        if m.get(key, v) != v:
            raise ValueError(f"the program serves {key} {v!r} only, not "
                             f"{m[key]!r}")
    rs = m["rope_scaling"] or {}
    if rs.get("type") != "yarn":
        raise ValueError(f"the program serves YaRN rope scaling only, not {rs}")
    L, k = m["num_hidden_layers"], m["first_k_dense_replace"]
    return port_config(
        get_config(conf["arch"]),
        moe=PortMoEConfig(
            n_experts=m["n_routed_experts"], top_k=m["num_experts_per_tok"],
            d_ff=m["moe_intermediate_size"], n_shared=m["n_shared_experts"],
            capacity_factor=m["moe_capacity_factor"],
            group_size=m["moe_group_size"],
            norm_topk_prob=m["norm_topk_prob"]),
        n_layers=L, d_model=m["hidden_size"],
        n_heads=m["num_attention_heads"],
        n_kv_heads=m["num_key_value_heads"], head_dim=m["v_head_dim"],
        d_ff=m["intermediate_size"], vocab_size=m["vocab_size"],
        segments=((("mla",), k), (("mla_moe",), L - k)),
        activation="swiglu", tie_embeddings=False,
        norm_eps=m["rms_norm_eps"], rope_theta=float(m["rope_theta"]),
        mla=MLAConfig(kv_lora_rank=m["kv_lora_rank"], q_lora_rank=None,
                      nope_head_dim=m["qk_nope_head_dim"],
                      rope_head_dim=m["qk_rope_head_dim"],
                      v_head_dim=m["v_head_dim"], decode_mode="naive"),
        rope_scaling=YaRN(
            factor=float(rs["factor"]),
            original_max_position_embeddings=int(
                rs["original_max_position_embeddings"]),
            beta_fast=float(rs["beta_fast"]), beta_slow=float(rs["beta_slow"]),
            mscale=float(rs["mscale"]),
            mscale_all_dim=float(rs["mscale_all_dim"])),
        dtype=conf["dtype"])
