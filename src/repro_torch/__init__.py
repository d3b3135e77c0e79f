"""NetKernel on PyTorch and CUDA: the port of ``repro`` to one NVIDIA H100.

Same module paths as the reference package (``repro_torch.models.attention``
is the counterpart of ``repro.models.attention``, and so on), PyTorch idiom
inside: ``nn.Module``s for blocks and the model, plain functions on
tensors, an explicit ``device`` on every entry point and explicit
``torch.Generator``s. Every Pallas kernel of the reference has a
counterpart written by hand in CUDA C++ for Hopper (``repro_torch.kernels``:
prefill and decode attention, the SSD scan, the water-fill, the int8
codec); the dense projections stay ``torch.matmul``, and the collectives
of the bytes plane (``repro_torch.core``) are ``torch.distributed``'s.

Nothing here imports JAX or the reference package.
"""
from repro_torch.device import dtype_of, resolve_device

__all__ = ["dtype_of", "resolve_device"]
