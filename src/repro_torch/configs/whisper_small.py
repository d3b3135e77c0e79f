"""whisper-small [audio]: encoder-decoder ASR backbone (arXiv:2212.04356).

12L (x2: encoder+decoder) d_model=768 12H (kv=12) d_ff=3072 vocab=51865.
The conv frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed frame embeddings (batch, 1500, 768).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    num_layers=12,            # decoder layers
    encoder_layers=12,
    encoder_seq=1500,         # mel frames after conv stem (stubbed)
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    activation="gelu",
    norm="layernorm",
    rope_theta=0.0,           # whisper uses learned/sinusoidal positions
    tie_embeddings=True,
    frontend="audio_stub",
)
