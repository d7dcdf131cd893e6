"""xLSTM 1.3B [arXiv:2405.04517; unverified].

48 blocks d_model=2048 4H vocab=50304, d_ff=0 (mixer blocks carry their own
up/down projections). xLSTM[7:1]: one sLSTM per 8 blocks (slstm_every=8)."""

from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=0, d_conv=4, expand=2, chunk=256, slstm_every=8),
)
