"""The ``nk_*`` API — the BSD-socket boundary of NetKernel.

Model and training code calls these functions (on every rank, in the same
order) and never names a collective implementation. A CoreEngine — owned by
the operator, configured per tenant — resolves each call to an NSM, exactly
as GuestLib redirects ``send()`` to whichever NSM the operator attached.
Swapping stacks (use case 3) is a config change; model code is untouched.

The mesh comes from the installed engine. The reference, with no engine
installed, falls back to the native stack over the axis names its
``shard_map`` body binds; torch has no such ambient axis context, so here
``nk_*`` with no engine installed raises (an engine built with the default
policy, ``make_engine(mesh, "xla")``, is the native stack).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

from repro_torch.core.engine import CoreEngine
from repro_torch.core.nqe import FLAG_GRADIENT, FLAG_SERVING

_state = threading.local()


def _current() -> Optional[CoreEngine]:
    return getattr(_state, "engine", None)


@contextlib.contextmanager
def use_engine(engine: CoreEngine):
    """Install a CoreEngine for nk_* calls made within this context."""
    prev = _current()
    _state.engine = engine
    try:
        yield engine
    finally:
        _state.engine = prev


def current_engine() -> Optional[CoreEngine]:
    return _current()


def _axes_tuple(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _dispatch(verb, x, axes, *, tenant_id=0, flags=0, op_data=0, **kw):
    eng = _current()
    if eng is None:
        raise RuntimeError(
            f"nk_{verb} needs an installed CoreEngine (use_engine): its "
            f"mesh names the axes; make_engine(mesh, 'xla') is the native "
            f"stack")
    return eng.dispatch(verb, x, _axes_tuple(axes), tenant_id=tenant_id,
                        flags=flags, op_data=op_data, **kw)


def nk_psum(x, axes, *, tenant_id=0, gradient=False, serving=False, op_data=0):
    flags = (FLAG_GRADIENT if gradient else 0) \
        | (FLAG_SERVING if serving else 0)
    return _dispatch("psum", x, axes, tenant_id=tenant_id, flags=flags,
                     op_data=op_data)


def nk_all_gather(x, axes, *, axis=0, tiled=True, tenant_id=0, op_data=0):
    return _dispatch("all_gather", x, axes, tenant_id=tenant_id,
                     op_data=op_data, axis=axis, tiled=tiled)


def nk_reduce_scatter(x, axes, *, axis=0, tenant_id=0, gradient=False):
    flags = FLAG_GRADIENT if gradient else 0
    return _dispatch("reduce_scatter", x, axes, tenant_id=tenant_id,
                     flags=flags, axis=axis)


def nk_all_to_all(x, axes, *, split_axis, concat_axis, tenant_id=0):
    return _dispatch("all_to_all", x, axes, tenant_id=tenant_id,
                     split_axis=split_axis, concat_axis=concat_axis)


def nk_ppermute(x, axes, *, perm, tenant_id=0):
    return _dispatch("ppermute", x, axes, tenant_id=tenant_id, perm=perm)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def nk_grad_sync(grads, axes, *, tenant_id=0):
    """Synchronize a gradient pytree (nested dicts, lists and tuples of
    tensors) over ``axes`` through the engine.

    This is the NetKernel-owned "last mile" of training traffic: every leaf
    is a gradient-flagged psum the routing table may send to the compressed /
    hierarchical / ring stack.
    """
    return _tree_map(
        lambda g: nk_psum(g, axes, tenant_id=tenant_id, gradient=True), grads)
