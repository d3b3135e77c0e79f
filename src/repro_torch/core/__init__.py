"""The CoreEngine dataplane; this slice carries its ``TokenBucket``."""
from repro_torch.core.engine import TokenBucket

__all__ = ["TokenBucket"]
