"""granite-8b [dense]: IBM Granite code model, llama-arch (arXiv:2405.04324).

36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=49152,
    head_dim=128,
    activation="silu_glu",
    norm="rmsnorm",
    rope_theta=10000000.0,
    tie_embeddings=True,
)
