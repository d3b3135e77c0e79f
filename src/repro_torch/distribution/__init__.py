"""repro_torch.distribution — logical sharding rules on a DeviceMesh
(``sharding``) and the GPipe pipeline over ``pod`` (``pipeline``).

``ParamDesc``, ``init_params`` and ``abstract_params`` live with the
models (``models/schema.py``, ``models/params.py``) and are re-exported
here under the reference's names, resolved on first use: the models import
this package's ``sharding``.
"""
from repro_torch.distribution.sharding import (
    LOGICAL_RULES, ShardingCtx, constrain, padded_heads, param_shardings,
    sharding_for, spec_for,
)

__all__ = [
    "LOGICAL_RULES", "ParamDesc", "ShardingCtx", "abstract_params",
    "constrain", "init_params", "padded_heads", "param_shardings",
    "sharding_for", "spec_for",
]


def __getattr__(name):
    if name in ("ParamDesc", "abstract_params"):
        from repro_torch.models import schema
        return getattr(schema, name)
    if name == "init_params":
        from repro_torch.models.params import init_params
        return init_params
    raise AttributeError(name)
