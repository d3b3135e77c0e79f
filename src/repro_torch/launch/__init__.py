"""repro_torch.launch — mesh construction (``mesh``).

The reference's ``roofline`` and ``dryrun`` are not ported yet (ROADMAP).
"""
from repro_torch.launch.mesh import (
    axis_sizes, data_axes, make_host_mesh, make_production_mesh,
    make_single_device_mesh,
)

__all__ = ["axis_sizes", "data_axes", "make_host_mesh",
           "make_production_mesh", "make_single_device_mesh"]
