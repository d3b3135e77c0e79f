"""Weights: seeded initialization and the bridge from the reference's pytrees.

``init_params`` fills a ``Model`` from a seeded ``torch.Generator`` with the
reference's per-leaf rule (``distribution/sharding.py::init_params``):
``normal * init_scale / sqrt(fan_in)`` (kinds "normal" and "small_normal",
the SSM conv taps at init_scale 0.5), zeros, or ones. One difference: the
reference reads fan-in as a leaf's first dim, which on its layer-stacked
block weights is the layer count (std 1/sqrt(L) at any width); the port
uses each weight's true fan-in (``ParamDesc.init_fan_in``), so full-width
activations stay O(1). ``torch.Generator`` cannot reproduce ``jax.random``
in any case, so parity tests always carry the reference's weights across.

``params_from_jax`` is that bridge: it takes the reference's parameter
pytree with every leaf already a numpy array (``jax.tree.map(np.asarray,
params)``, done by the caller), splits the per-segment layer stacking into
the port's per-layer modules, and carries bf16 bit for bit without
importing ``ml_dtypes``; the SSM leaves cross like any other (``A_log``,
``D`` and ``dt_bias`` f32 ``(H,)``, conv taps ``(W, C)``).
``cache_from_jax`` does the same for a cache tuple, each leaf in its own
dtype (an SSM ``state`` ``(L, B, H, P, N)`` is f32, its ``conv_*`` tails
``(L, B, W-1, C)`` in the cache dtype).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import Model, build_schedule, model_schema
from repro_torch.models.schema import leaf, walk


@torch.no_grad()
def init_params(cfg: ModelConfig, *, device=None,
                generator: Optional[torch.Generator] = None,
                seed: int = 0) -> Model:
    """A model with random weights, made on ``device`` from ``generator``
    (default: a new generator on that device seeded with ``seed``)."""
    dev = resolve_device(device)
    model = Model(cfg, device=dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    schema = model_schema(cfg)
    trees = [(schema["embed"], model.embed),
             (schema["final_norm"], model.final_norm)]
    trees += list(zip(schema["layers"], model.blocks))
    for sch, tree in trees:
        for path, desc in walk(sch):
            p = leaf(tree, path)
            if desc.init == "zeros":
                p.zero_()
            elif desc.init == "ones":
                p.fill_(1.0)
            else:
                scale = desc.init_scale / max(1.0, float(desc.init_fan_in)) \
                    ** 0.5
                w = torch.randn(desc.shape, generator=generator,
                                dtype=torch.float32, device=dev)
                p.copy_(w.mul_(scale))
    return model


# ---------------------------------------------------------------------------
# The bridge from the reference's numpy-converted pytrees
# ---------------------------------------------------------------------------


def to_torch(a: np.ndarray, device=None) -> torch.Tensor:
    """A numpy array (bf16 included, recognised by dtype name) as a torch
    tensor, bit for bit."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:       # torch tensors must own writable memory
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device) if device is not None else t


def _assign(param: torch.Tensor, value: np.ndarray, what: str) -> None:
    t = to_torch(value)
    if tuple(t.shape) != tuple(param.shape) or t.dtype != param.dtype:
        raise ValueError(f"{what}: reference leaf {tuple(t.shape)} {t.dtype} "
                         f"does not match the port's {tuple(param.shape)} "
                         f"{param.dtype}")
    param.copy_(t)


def _get(tree: Dict, path: Sequence[str]):
    node = tree
    for key in path:
        if key not in node:
            raise ValueError(f"reference tree has no leaf "
                             f"{'.'.join(path)}")
        node = node[key]
    return node


@torch.no_grad()
def params_from_jax(tree: Dict, cfg: ModelConfig, device=None) -> Model:
    """The port's model holding the reference's weights. ``tree`` is the
    reference's parameter pytree with numpy leaves."""
    dev = resolve_device(device)
    model = Model(cfg, device=dev)
    schema = model_schema(cfg)
    for name, sub in (("embed", model.embed),
                      ("final_norm", model.final_norm)):
        for path, _desc in walk(schema[name]):
            _assign(leaf(sub, path), _get(tree[name], path),
                    ".".join((name,) + path))
    layer = 0
    for si, seg in enumerate(build_schedule(cfg)):
        stacked = tree["segments"][si]
        for i in range(seg.count):
            for path, _desc in walk(schema["layers"][layer]):
                _assign(leaf(model.blocks[layer], path),
                        _get(stacked, path)[i],
                        f"segments[{si}][{i}]." + ".".join(path))
            layer += 1
    if layer != len(model.blocks):
        raise ValueError(f"reference tree covers {layer} layers, the model "
                         f"has {len(model.blocks)}")
    return model


def cache_from_jax(caches: Sequence[Dict], device=None) -> Tuple:
    """The reference's cache tuple (numpy leaves) in the port's layout,
    which is the same: one dict per segment, each leaf stacked over the
    segment's layers and kept in its dtype."""
    dev = resolve_device(device)
    return tuple({k: to_torch(v, dev) for k, v in seg.items()}
                 for seg in caches)
