"""HuBERT X-Large [arXiv:2106.07447; unverified] — encoder-only audio model.

48L d_model=1280 16H d_ff=5120 vocab=504 (cluster targets). The conv
waveform frontend is a STUB per the assignment: the inputs are
precomputed frame embeddings [B, T, 512] (w2v2 conv output width)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    encoder_only=True,
    frontend="frames",
    frontend_dim=512,
)
