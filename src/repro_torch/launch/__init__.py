"""repro_torch.launch — mesh construction (``mesh``), the roofline terms
on the H100 (``roofline``) and the dry run on the meta device
(``dryrun``: one rank's shard of every production cell; run it as
``python -m repro_torch.launch.dryrun``). ``roofline`` and ``dryrun`` are
imported by name, not here: the dry run imports the models and the
trainer, which import this package.
"""
from repro_torch.launch.mesh import (
    axis_sizes, data_axes, make_host_mesh, make_production_mesh,
    make_single_device_mesh,
)

__all__ = ["axis_sizes", "data_axes", "make_host_mesh",
           "make_production_mesh", "make_single_device_mesh"]
