from repro_torch.models.model import (
    Model, Segment, build_schedule, cache_schema, forward_decode,
    forward_prefill, init_cache, model_schema,
)
from repro_torch.models.params import (
    cache_from_jax, init_params, params_from_jax,
)

__all__ = [
    "Model", "Segment", "build_schedule", "cache_schema", "forward_decode",
    "forward_prefill", "init_cache", "model_schema", "cache_from_jax",
    "init_params", "params_from_jax",
]
