from repro_torch.models.model import (
    Model, Segment, build_schedule, cache_schema, encode,
    forward_decode, forward_prefill, forward_train, gather_logits, greedy,
    init_cache, input_specs, model_schema,
)
from repro_torch.models.params import (
    Slot, cache_from_jax, init_params, opt_slots, params_from_jax,
    train_state_from_jax, train_state_to_numpy,
)

__all__ = [
    "Model", "Segment", "build_schedule", "cache_schema",
    "encode", "forward_decode", "forward_prefill", "forward_train",
    "gather_logits", "greedy", "init_cache", "input_specs", "model_schema",
    "Slot", "cache_from_jax", "init_params", "opt_slots", "params_from_jax",
    "train_state_from_jax", "train_state_to_numpy",
]
