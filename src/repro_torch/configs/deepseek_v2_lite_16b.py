"""DeepSeek-V2-Lite 16B [arXiv:2405.04434; hf].

27L d_model=2048 16H d_ff_expert=1408 vocab=102400, MoE 64 routed top-6 +
2 shared, first layer dense FFN (10944). MLA: kv_lora=512, rope 64 / nope 128 /
v 128 head dims. The published config has 64 routed experts."""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    rope_theta=10000.0,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2,
                  first_dense_layers=1, d_ff_dense=10944, dispatch="adaptive"),
    mla=MLAConfig(kv_lora_rank=512, rope_head_dim=64, nope_head_dim=128,
                  v_head_dim=128),
)
