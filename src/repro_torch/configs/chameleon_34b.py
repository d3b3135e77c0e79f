"""chameleon-34b [vlm]: early-fusion mixed-modal decoder (arXiv:2405.09818).

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536. The 65536-entry
vocabulary includes the VQ image tokens; the modality frontend is a stub
(token ids in, per the assignment). Chameleon uses qk-layernorm for stability.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    activation="silu_glu",
    norm="rmsnorm",
    rope_theta=10000.0,
    qk_norm=True,
    tie_embeddings=False,
    frontend="token",
)
