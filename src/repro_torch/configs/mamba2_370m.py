"""mamba2-370m [ssm]: state-space duality, attention-free (arXiv:2405.21060).

48L d_model=1024 d_ff=0 vocab=50280, ssm_state=128. d_inner = 2*1024 = 2048,
head_dim 64 => 32 SSD heads per layer. No attention, no MLP (Mamba-2 blocks
only). Runs long_500k (constant-size state decode).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    head_dim=64,
    norm="rmsnorm",
    tie_embeddings=True,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4, chunk=256),
)
