"""nemotron-4-340b [dense]: GQA + squared-ReLU FFN (arXiv:2402.16819).

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000.
The memory-pressure arch: requires ZeRO-3 + bf16 moments + remat at 256 chips.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    head_dim=192,
    activation="relu2",        # squared ReLU
    norm="layernorm",
    rope_theta=10000.0,
    tie_embeddings=False,
)
