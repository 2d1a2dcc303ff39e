"""Model configuration dataclasses.

Every assigned architecture is expressed as a ``ModelConfig``.  A config is a
pure description: the model code in ``repro_torch.models`` interprets it.  Layers are
described by *segments*: ``((pattern, repeats), ...)`` where ``pattern`` is a
tuple of block kinds.  Each segment is executed as a ``lax.scan`` over
``repeats`` stacked super-blocks, so compiled HLO size is depth-independent.

Block kinds
-----------
``attn``        global causal attention + dense MLP
``attn_local``  sliding-window causal attention + dense MLP
``attn_moe``    global causal attention + mixture-of-experts MLP
``mla``         DeepSeek multi-head latent attention + dense MLP
``mla_moe``     MLA + MoE (DeepSeek-V2 style: shared + routed experts)
``rglru``       Griffin/RecurrentGemma RG-LRU recurrent block + dense MLP
``mlstm``       xLSTM mLSTM block (matrix memory, parallelizable)
``slstm``       xLSTM sLSTM block (scalar memory, sequential scan)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

Segment = Tuple[Tuple[str, ...], int]

ATTENTION_KINDS = ("attn", "attn_local", "attn_moe", "mla", "mla_moe")
RECURRENT_KINDS = ("rglru", "mlstm", "slstm")
ALL_KINDS = ATTENTION_KINDS + RECURRENT_KINDS


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                       # per-expert hidden size
    n_shared: int = 0               # DeepSeek-style always-on shared experts
    router_jitter: float = 0.0
    load_balance_coef: float = 0.01
    # "einsum" = GShard one-hot dispatch (baseline); "gather" = sort-free
    # take/segment-sum dropless dispatch (beyond-paper perf variant).
    dispatch: str = "einsum"
    capacity_factor: float = 1.25
    group_size: int = 512           # tokens per dispatch group


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None   # None => direct q projection (V2-Lite)
    nope_head_dim: int = 128
    rope_head_dim: int = 64
    v_head_dim: int = 128
    # decode path: "naive" re-expands cached latents each step;
    # "absorbed" folds W_UK/W_UV into the query/output projections.
    decode_mode: str = "naive"


@dataclass(frozen=True)
class RGLRUConfig:
    d_rnn: int = 0                  # 0 => d_model
    conv_width: int = 4
    c: float = 8.0                  # RG-LRU constant from Griffin


@dataclass(frozen=True)
class XLSTMConfig:
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 4.0 / 3.0
    conv_width: int = 4
    chunk_size: int = 64            # mLSTM chunkwise-parallel chunk length


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    segments: Tuple[Segment, ...]
    head_dim: int = 0               # 0 => d_model // n_heads
    activation: str = "swiglu"      # swiglu | squared_relu | gelu
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    window_size: Optional[int] = None       # for attn_local
    attn_softcap: Optional[float] = None    # gemma2 attention logit softcap
    final_softcap: Optional[float] = None   # gemma2 final logit softcap
    query_scale: Optional[float] = None     # None => 1/sqrt(head_dim)
    use_post_norm: bool = False             # gemma2 sandwich norms
    scale_embedding: bool = False           # gemma multiplies by sqrt(d_model)
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    rglru: Optional[RGLRUConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    frontend: str = "none"          # none | vision | audio (stub embeddings)
    dtype: str = "bfloat16"
    # attention compute chunking (blockwise/flash attention)
    q_chunk: int = 512
    kv_chunk: int = 1024
    # training
    remat: bool = True
    source: str = ""                # citation for the config
    # serving sharding strategy: "tp" (tensor-parallel over the model axis;
    # the recorded baseline), "dp_cp" (weights replicated; batch over data,
    # sequence over model — right for small models where TP resharding
    # dominates), or "auto" (dp_cp for pure-attention archs whose replicated
    # weights fit ~2.5GB).  Baselines in EXPERIMENTS.md use "tp"; §Perf
    # documents the dp_cp wins.
    serve_strategy: str = "tp"
    # long_500k opt-in for non-subquadratic archs that remain feasible at
    # 500k decode (e.g. gemma2: half the layers are 4k-window local; global
    # layers decode in O(L) against a mesh-sharded KV cache).
    long_context_ok: bool = False

    def __post_init__(self):
        assert self.family in ("dense", "moe", "hybrid", "ssm", "vlm", "audio")
        total = sum(len(p) * r for p, r in self.segments)
        assert total == self.n_layers, (
            f"{self.name}: segments cover {total} layers != n_layers={self.n_layers}")
        for pattern, _ in self.segments:
            for kind in pattern:
                assert kind in ALL_KINDS, f"unknown block kind {kind}"
        if any(k in ("attn_moe", "mla_moe") for p, _ in self.segments for k in p):
            assert self.moe is not None
        if any(k.startswith("mla") for p, _ in self.segments for k in p):
            assert self.mla is not None
        if any(k == "rglru" for p, _ in self.segments for k in p):
            assert self.rglru is not None
        if any(k in ("mlstm", "slstm") for p, _ in self.segments for k in p):
            assert self.xlstm is not None

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        kinds: list[str] = []
        for pattern, repeats in self.segments:
            kinds.extend(pattern * repeats)
        return tuple(kinds)

    @property
    def is_subquadratic(self) -> bool:
        """True when no layer needs an unbounded full-attention KV cache."""
        for kind in self.layer_kinds:
            if kind in ("attn", "attn_moe", "mla", "mla_moe"):
                return False
        return True

    def supports_shape(self, shape_name: str) -> bool:
        if shape_name == "long_500k":
            if self.is_subquadratic or self.long_context_ok:
                return True
            return all(k in ("attn_local", "rglru", "mlstm", "slstm")
                       for k in self.layer_kinds)
        return True

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (matches init; used for rooflines)."""
        d, hd = self.d_model, self.resolved_head_dim
        nh, nkv = self.n_heads, self.n_kv_heads
        total = self.vocab_size * d                       # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * d                  # output head
        for kind in self.layer_kinds:
            total += self._block_params(kind, d, hd, nh, nkv)
        total += d                                        # final norm
        return total

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE counts top_k + shared only)."""
        d, hd = self.d_model, self.resolved_head_dim
        nh, nkv = self.n_heads, self.n_kv_heads
        total = self.vocab_size * d
        if not self.tie_embeddings:
            total += self.vocab_size * d
        for kind in self.layer_kinds:
            total += self._block_params(kind, d, hd, nh, nkv, active_only=True)
        total += d
        return total

    def _block_params(self, kind, d, hd, nh, nkv, active_only=False) -> int:
        n = 2 * d                                         # two pre-norms
        if self.use_post_norm:
            n += 2 * d
        if kind in ("attn", "attn_local", "attn_moe"):
            n += d * nh * hd + 2 * d * nkv * hd + nh * hd * d
            if self.qkv_bias:
                n += nh * hd + 2 * nkv * hd
        elif kind in ("mla", "mla_moe"):
            m = self.mla
            qd = m.nope_head_dim + m.rope_head_dim
            if m.q_lora_rank:
                n += d * m.q_lora_rank + m.q_lora_rank * nh * qd + m.q_lora_rank
            else:
                n += d * nh * qd
            n += d * (m.kv_lora_rank + m.rope_head_dim) + m.kv_lora_rank
            n += m.kv_lora_rank * nh * (m.nope_head_dim + m.v_head_dim)
            n += nh * m.v_head_dim * d
        elif kind == "rglru":
            r = self.rglru.d_rnn or d
            n += 2 * d * r + r * self.rglru.conv_width + 2 * r + 2 * r + r * d
        elif kind == "mlstm":
            x = self.xlstm
            di = int(d * x.proj_factor_mlstm)
            n += d * 2 * di + 3 * di * di // max(1, self.n_heads) * 0  # qkv below
            n += 3 * di * di + 2 * di + di * x.conv_width + di * d + di
        elif kind == "slstm":
            x = self.xlstm
            di = d
            n += 4 * d * di + 4 * (di // max(1, self.n_heads)) * di + 4 * di
            pf = x.proj_factor_slstm
            n += int(d * pf * d) * 2
        # feed-forward
        if kind in ("attn_moe", "mla_moe"):
            e = self.moe
            per_expert = 3 * d * e.d_ff if self.activation == "swiglu" else 2 * d * e.d_ff
            experts = (e.top_k + e.n_shared) if active_only else (e.n_experts + e.n_shared)
            n += experts * per_expert + d * e.n_experts   # router
        elif kind in ("attn", "attn_local", "mla", "rglru"):
            if self.d_ff:
                if self.activation == "swiglu":
                    n += 3 * d * self.d_ff
                else:
                    n += 2 * d * self.d_ff
        return n

    # ------------------------------------------------------------------
    def reduced(self, n_layers: int = 2, d_model: int = 256,
                vocab: int = 512) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        hd = 32
        nh = max(2, min(4, self.n_heads))
        nkv = max(1, min(nh, self.n_kv_heads if self.n_kv_heads < self.n_heads else nh))
        if nh % nkv:
            nkv = 1
        # keep one instance of each distinct block kind, in order
        seen, pattern = set(), []
        for k in self.layer_kinds:
            if k not in seen:
                seen.add(k)
                pattern.append(k)
        pattern = tuple(pattern[:n_layers]) if len(pattern) >= n_layers else tuple(pattern)
        reps = max(1, n_layers // len(pattern))
        segs = ((pattern, reps),)
        nl = len(pattern) * reps
        kw = dict(
            n_layers=nl, d_model=d_model, n_heads=nh, n_kv_heads=nkv,
            head_dim=hd, d_ff=(d_model * 2 if self.d_ff else 0),
            vocab_size=vocab, segments=segs,
            window_size=(64 if self.window_size else None),
            q_chunk=64, kv_chunk=64,
        )
        if self.moe:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=2,
                n_shared=min(1, self.moe.n_shared), d_ff=d_model, group_size=32)
        if self.mla:
            kw["mla"] = dataclasses.replace(
                self.mla, kv_lora_rank=64, nope_head_dim=32, rope_head_dim=16,
                v_head_dim=32)
        if self.rglru:
            kw["rglru"] = dataclasses.replace(self.rglru, d_rnn=d_model)
        if self.xlstm:
            kw["xlstm"] = dataclasses.replace(self.xlstm, chunk_size=16)
        return dataclasses.replace(self, name=self.name + "-smoke", **kw)


# ----------------------------------------------------------------------
# Input shape suite (assigned)
@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                       # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
