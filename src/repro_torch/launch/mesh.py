"""Mesh construction for the production pods and for local worlds.

The counterpart of ``repro/launch/mesh.py``. The factories return a
``torch.distributed.device_mesh.DeviceMesh`` over the axes ``("pod",
"data", "model")`` or ``("data", "model")``, on the port's device (the
card unless the caller passes ``device="cpu"``). A mesh needs an
initialized ``torch.distributed`` world whose size is the mesh's product
(``init_process_group`` with an address, a world size and a rank: nothing
on a machine tells a program of its cluster); a factory raises by name
otherwise. Functions, not module-level constants: importing this module
touches no world.

``axis_sizes`` and ``data_axes`` also take a ``core/nsm.py::MeshAxes`` or
a plain ``{axis: size}`` dict, so the sharding rule math runs at the
production sizes (16x16, 2x16x16) with no world, as the reference's tests
do with their ``_FakeMesh``.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch.distributed as dist

from repro_torch.device import resolve_device

POD_AXES = ("pod", "data", "model")
AXES = ("data", "model")


def _make(shape: Tuple[int, ...], axes: Tuple[str, ...], device=None):
    from torch.distributed.device_mesh import init_device_mesh
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {dict(zip(axes, shape))} mesh needs an initialized "
            f"torch.distributed world of {n} ranks "
            f"(init_process_group(init_method='tcp://localhost:<port>', "
            f"world_size={n}, rank=...))")
    if dist.get_world_size() != n:
        raise ValueError(
            f"a {dict(zip(axes, shape))} mesh needs a world of {n} ranks, "
            f"this one has {dist.get_world_size()}")
    return init_device_mesh(resolve_device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16x16 chips per pod; ``multi_pod`` adds the cross-pod ("pod") axis."""
    if multi_pod:
        return _make((2, 16, 16), POD_AXES, device)
    return _make((16, 16), AXES, device)


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 0, *,
                   device=None):
    """A small mesh over the world's ranks, for tests and smoke runs."""
    if pod:
        return _make((pod, data, model), POD_AXES, device)
    return _make((data, model), AXES, device)


def make_single_device_mesh(*, device=None):
    return make_host_mesh(1, 1, device=device)


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh``, a ``MeshAxes`` or a dict."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if not names:
        raise TypeError(f"want a DeviceMesh with mesh_dim_names, a MeshAxes "
                        f"or an {{axis: size}} dict, got {type(mesh)}")
    return dict(zip(names, tuple(mesh.shape)))


def data_axes(mesh) -> Tuple[str, ...]:
    """Axes the global batch is sharded over."""
    sizes = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)
