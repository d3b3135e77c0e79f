"""repro_torch.core — the paper's contribution: network stack as
infrastructure.

CommOp (NQE), NSMs (pluggable collective stacks over torch.distributed),
CoreEngine (switch, accounting, isolation) and the nk_* socket-boundary API.
"""
from repro_torch.core.nqe import CommOp, NQE_SIZE, VERBS
from repro_torch.core.nsm import (
    Nsm, XlaNsm, RingNsm, HierarchicalNsm, CompressedNsm, ShmNsm, MeshAxes,
    available_nsms, get_nsm, register_nsm,
)
from repro_torch.core.engine import CoreEngine, TokenBucket, make_engine
from repro_torch.core.collectives import (
    current_engine, nk_all_gather, nk_all_to_all, nk_grad_sync, nk_ppermute,
    nk_psum, nk_reduce_scatter, use_engine,
)

__all__ = [
    "CommOp", "NQE_SIZE", "VERBS",
    "Nsm", "XlaNsm", "RingNsm", "HierarchicalNsm", "CompressedNsm", "ShmNsm",
    "MeshAxes", "available_nsms", "get_nsm", "register_nsm",
    "CoreEngine", "TokenBucket", "make_engine",
    "current_engine", "use_engine",
    "nk_psum", "nk_all_gather", "nk_reduce_scatter", "nk_all_to_all",
    "nk_ppermute", "nk_grad_sync",
]
