"""Mistral-Nemo 12B [hf:mistralai/Mistral-Nemo-Base-2407; hf].

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, head_dim=128
(explicit — not d_model/n_heads=160), 128k context (rope theta 1M)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=131072,
    head_dim=128,
    rope_theta=1000000.0,
)
