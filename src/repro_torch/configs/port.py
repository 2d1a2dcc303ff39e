"""Published settings the port's model code serves that the copied
``base.py`` has no key for, as subclasses of its dataclasses (``base.py``
stays the reference's file, verbatim).

* ``YaRN``: DeepSeek-V2's YaRN rotary scaling (Hugging Face's
  ``DeepseekV2YarnRotaryEmbedding``), set as ``PortModelConfig.rope_scaling``.
  It changes the rotary frequencies at every position (``models/layers.py``
  ``rope_frequencies``) and MLA's softmax scale (``models/mla.py``
  ``_scale``), so only MLA blocks take it.
* ``PortMoEConfig.norm_topk_prob``: True renormalises each token's top-k
  gates to sum to one (the reference's only behaviour); False keeps them as
  the softmax over all experts gave them (DeepSeek-V2).

A copied ``ModelConfig`` or ``MoEConfig`` reads as the defaults (no
scaling, renormalised gates), so every existing configuration is served as
before.

``base.py``'s comment calls ``dispatch="gather"`` dropless; it is not.
Both dispatches give each expert the same capacity per dispatch group and
drop the same assignments past it (``models/moe.py``), so routing without
drops takes a capacity that holds a whole group: ``capacity_factor`` at
least ``n_experts / top_k``.  ``dispatch`` picks the path on the CPU and
under autograd (training) only: on the card, outside autograd, SwiGLU
experts take K4 (``kernels/ops.py`` ``moe_grouped``), which drops the same
assignments and computes the kept rows alone (``models/moe.py``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.base import ModelConfig, MoEConfig


@dataclass(frozen=True)
class YaRN:
    factor: float                               # context extension
    original_max_position_embeddings: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


@dataclass(frozen=True)
class PortMoEConfig(MoEConfig):
    norm_topk_prob: bool = True


@dataclass(frozen=True)
class PortModelConfig(ModelConfig):
    rope_scaling: Optional[YaRN] = None

    def __post_init__(self):
        super().__post_init__()
        if self.rope_scaling is not None:
            assert all(k in ("mla", "mla_moe") for k in self.layer_kinds), (
                f"{self.name}: YaRN is served for MLA blocks only")


def port_config(cfg: ModelConfig, moe: Optional[MoEConfig] = None,
                **changes) -> PortModelConfig:
    """``cfg`` as a ``PortModelConfig`` with ``changes``; with ``moe``, its
    MoE settings in its place."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if moe is not None:
        kw["moe"] = moe
    kw.update(changes)
    return PortModelConfig(**kw)


def rope_scaling(cfg) -> Optional[YaRN]:
    """The YaRN setting of ``cfg``, or None for plain RoPE (any copied
    ``ModelConfig``)."""
    return getattr(cfg, "rope_scaling", None)


def norm_topk_prob(moe) -> bool:
    """Whether ``moe``'s top-k gates are renormalised (a copied
    ``MoEConfig``: yes)."""
    return getattr(moe, "norm_topk_prob", True)
