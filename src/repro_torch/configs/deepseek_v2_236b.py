"""deepseek-v2-236b [moe]: MLA + fine-grained MoE (arXiv:2405.04434).

60L d_model=5120 128H (MLA: kv_lora=512, rope 64, nope 128, v 128)
expert d_ff=1536, vocab=102400; 2 shared + 160 routed experts, top-6.
Layer 0 uses a dense FFN (d_ff 12288) per the published config.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,          # MLA: latent cache; kv head count == q heads
    d_ff=1536,
    vocab_size=102400,
    head_dim=128,              # v head dim; qk dims come from MLAConfig
    activation="silu_glu",
    norm="rmsnorm",
    rope_theta=10000.0,
    tie_embeddings=False,
    moe=MoEConfig(
        num_experts=160,
        top_k=6,
        expert_ff=1536,
        num_shared_experts=2,
        shared_ff=1536,
    ),
    dense_layer_prefix=1,
    dense_prefix_ff=12288,
)
