"""DeepSeek 7B [arXiv:2401.02954; hf] — llama-architecture dense LM.

30L d_model=4096 32H (kv=32) d_ff=11008 vocab=102400."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab=102400,
    # full-MHA (kv=32) cache: int8 KV halves it
    kv_quant=True,
)
