"""xLSTM-350M: alternating mLSTM (matrix memory, chunkwise-parallel) and
sLSTM (scalar memory, sequential) blocks.  d_ff=0: blocks carry their own
up/down projections, no external FFN.  [arXiv:2405.04517]"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50304,
    segments=((("mlstm", "slstm"), 12),),
    activation="gelu",
    tie_embeddings=True,
    xlstm=XLSTMConfig(proj_factor_mlstm=2.0, proj_factor_slstm=4.0 / 3.0,
                      conv_width=4, chunk_size=64),
    source="arXiv:2405.04517",
)
