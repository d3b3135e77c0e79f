"""arctic-480b [moe]: Snowflake Arctic dense-MoE hybrid (hf:Snowflake/snowflake-arctic-base).

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128 experts top-2
computed IN PARALLEL with a dense residual FFN branch (Arctic's design).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,                # dense residual branch hidden dim
    vocab_size=32000,
    activation="silu_glu",
    norm="rmsnorm",
    rope_theta=10000.0,
    tie_embeddings=False,
    moe=MoEConfig(
        num_experts=128,
        top_k=2,
        expert_ff=4864,
        parallel_dense=True,
    ),
)
