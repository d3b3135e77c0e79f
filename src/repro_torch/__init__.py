"""NetKernel on PyTorch and CUDA: the port of ``repro`` to one NVIDIA H100.

Same module paths as the reference package (``repro_torch.models.attention``
is the counterpart of ``repro.models.attention``, and so on), PyTorch idiom
inside: ``nn.Module``s for blocks and the model, plain functions on
tensors, an explicit ``device`` on every entry point and explicit
``torch.Generator``s. Attention on the serving path runs through kernels
written by hand in CUDA C++ for Hopper (``repro_torch.kernels``); the
dense projections stay ``torch.matmul``.

Nothing here imports JAX or the reference package.
"""
from repro_torch.device import dtype_of, resolve_device

__all__ = ["dtype_of", "resolve_device"]
