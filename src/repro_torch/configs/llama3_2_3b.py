"""llama3.2-3b [dense]: small llama3 (hf:meta-llama/Llama-3.2-3B family).

28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    head_dim=128,
    activation="silu_glu",
    norm="rmsnorm",
    rope_theta=500000.0,
    tie_embeddings=True,
)
