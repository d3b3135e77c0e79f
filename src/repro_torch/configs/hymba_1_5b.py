"""hymba-1.5b [hybrid]: parallel attention + mamba heads (arXiv:2411.13676).

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Sliding-window attention (1024) everywhere except 3 global layers
{0, mid, last}; the SSM path runs in parallel with attention in every block
(outputs mean-combined after per-path normalization). Meta-tokens omitted
(orthogonal to the comm-stack study; noted in DESIGN.md).
Runs long_500k (window + constant SSM state).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    activation="silu_glu",
    norm="rmsnorm",
    rope_theta=10000.0,
    tie_embeddings=True,
    ssm=SSMConfig(state_dim=16, head_dim=64, expand=2, conv_width=4, chunk=128),
    attn_window=1024,
    global_attn_layers=(0, 15, 31),
)
