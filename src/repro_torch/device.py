"""Device and dtype policy for every entry point of the port.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(the CPU tests do). Without a card and without an explicit CPU request
they raise: a serving path that silently fell back to the CPU would report
CPU numbers under a device's name. ``device="meta"``, asked for by name
only, builds shapes and dtypes with no storage (``launch/dryrun.py``).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype for a ``ModelConfig.dtype``/``param_dtype`` or
    ``RunConfig.kv_cache_dtype`` string."""
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; "
                         f"known: {sorted(DTYPES)}") from None


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card. Raises when a CUDA device is asked for
    (explicitly or by default) and none is present. A bare ``"cuda"``
    becomes the current card's index, so devices compare equal to the
    devices of the tensors made on them. ``"meta"`` is admitted when it is
    asked for (no storage: shapes and dtypes only)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
