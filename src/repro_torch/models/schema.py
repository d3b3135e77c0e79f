"""Parameter schemas and the module that holds them.

Models declare each parameter as a ``ParamDesc`` (the counterpart of the
reference's ``distribution/sharding.py::ParamDesc``): its shape, its
logical dims (``dims``, one name per dim, which ``distribution/sharding.py``
resolves to mesh axes), dtype and init. ``ParamTree`` turns a nested schema
dict into an ``nn.Module`` that reads like the reference's pytree:
``block["attn"]["wq"]``; on a mesh it holds each leaf's local shard.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.device import dtype_of


# "small_normal" is the reference's kind for the SSM conv taps: drawn like
# "normal" (normal * init_scale / sqrt(fan_in)), with its own init_scale
INITS = ("normal", "small_normal", "zeros", "ones")


@dataclass(frozen=True)
class ParamDesc:
    shape: Tuple[int, ...]
    dtype: str = "bfloat16"
    init: str = "normal"       # one of INITS
    init_scale: float = 1.0
    # fan-in of the product this weight enters; 0 = shape[0], right for
    # every weight that contracts its leading dim (wo (HQ, hd, d) names
    # HQ * hd, an untied head (V, d) names d)
    fan_in: int = 0
    # one logical axis name (or None) per dim; () names none of them
    dims: Tuple[Optional[str], ...] = ()

    def __post_init__(self):
        if self.init not in INITS:
            raise ValueError(f"init {self.init!r} is not one of {INITS}")
        if not self.dims:
            object.__setattr__(self, "dims", (None,) * len(self.shape))
        if len(self.dims) != len(self.shape):
            raise ValueError(f"dims {self.dims} do not name the "
                             f"{len(self.shape)} dims of {self.shape}")

    @property
    def init_fan_in(self) -> int:
        return self.fan_in or (self.shape[0] if self.shape else 1)


class ParamTree(nn.Module):
    """A nested parameter dict as an ``nn.Module``. Parameters are created
    uninitialized (``torch.empty``) and frozen; ``models.params`` fills
    them from a generator or from the reference's weights. With a
    ``ShardingCtx`` each leaf holds this rank's block of the layout
    ``shd.weight_spec`` gives it (the serving or the training layout), and
    ``spec(key)`` returns that layout."""

    def __init__(self, schema: Dict, device: torch.device, shd=None):
        super().__init__()
        self._keys: List[str] = []
        self._specs: Dict[str, Tuple] = {}
        self._dims: Dict[str, Tuple] = {}
        for key, desc in schema.items():
            if isinstance(desc, ParamDesc):
                shape = desc.shape
                self._dims[key] = desc.dims
                if shd is not None and shd.mesh is not None:
                    from repro_torch.distribution.sharding import local_shape
                    spec = shd.weight_spec(desc.shape, desc.dims)
                    self._specs[key] = spec
                    shape = local_shape(desc.shape, spec, shd.mesh)
                self.register_parameter(key, nn.Parameter(
                    torch.empty(shape, dtype=dtype_of(desc.dtype),
                                device=device), requires_grad=False))
            else:
                self.add_module(key, ParamTree(desc, device, shd))
            self._keys.append(key)

    def spec(self, key: str) -> Tuple:
        """The leaf's layout on the mesh (``()``: whole on every rank)."""
        return self._specs.get(key, ())

    def dims(self, key: str) -> Tuple:
        """The leaf's logical dims."""
        return self._dims[key]

    def __getitem__(self, key: str):
        if key not in self._keys:
            raise KeyError(key)
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._keys

    def keys(self) -> List[str]:
        return list(self._keys)

    def get(self, key: str, default=None):
        return self[key] if key in self._keys else default


def walk(schema: Dict, prefix: Tuple[str, ...] = ()
         ) -> Iterator[Tuple[Tuple[str, ...], ParamDesc]]:
    """(path, desc) for every leaf, in sorted-key order (the order the
    reference flattens its parameter pytrees in)."""
    for key in sorted(schema):
        desc = schema[key]
        if isinstance(desc, ParamDesc):
            yield prefix + (key,), desc
        else:
            yield from walk(desc, prefix + (key,))


def leaf(tree: ParamTree, path: Tuple[str, ...]) -> torch.Tensor:
    node = tree
    for key in path:
        node = node[key]
    return node


def abstract_params(schema):
    """The schema's tree with every leaf a meta tensor of its shape and
    dtype (the reference's ``ShapeDtypeStruct`` stand-ins)."""
    if isinstance(schema, ParamDesc):
        return torch.empty(schema.shape, dtype=dtype_of(schema.dtype),
                           device="meta")
    if isinstance(schema, dict):
        return {k: abstract_params(v) for k, v in schema.items()}
    return type(schema)(abstract_params(v) for v in schema)
