"""Qwen1.5-32B [hf:Qwen/Qwen1.5-0.5B family; hf].

64L d_model=5120 40H (assignment sheet: kv=40) d_ff=27392 vocab=152064,
QKV bias. It follows the assignment's kv=40 (the published model uses
GQA kv=8), as the JAX package's config does."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab=152064,
    qkv_bias=True,
    # the kv=40 full-MHA cache in int8 takes half the bytes of bf16
    kv_quant=True,
)
