"""Llama-3.2-Vision 11B [hf:meta-llama/Llama-3.2-11B-Vision; unverified].

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256, gated
cross-attention to vision every 5th layer. The vision tower is a STUB
per the assignment: the inputs are precomputed patch embeddings
[B, 1601, 7680] which w_vision projects to d_model."""
from repro_torch.models.config import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    arch_id="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    rope_theta=500000.0,
    vlm=VLMConfig(cross_attn_every=5, vision_dim=7680, vision_tokens=1601),
)
