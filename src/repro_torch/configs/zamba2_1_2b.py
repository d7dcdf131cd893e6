"""Zamba2 1.2B [arXiv:2411.15242; hf] — Mamba2 backbone + shared attention.

38 Mamba2 layers d_model=2048, ssm_state=64; one shared attention+MLP block
(32H, d_ff=8192) applied every 6 layers (7 sites: 0,6,...,36)."""
from repro_torch.models.config import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=256),
    hybrid=HybridConfig(attn_every=6, shared_d_ff=8192),
)
