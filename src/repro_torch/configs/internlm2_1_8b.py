"""internlm2-1.8b [dense]: GQA decoder (arXiv:2403.17297).

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92544,
    head_dim=128,
    activation="silu_glu",
    norm="rmsnorm",
    rope_theta=1000000.0,
    tie_embeddings=False,
)
