"""Network Stack Modules: pluggable collective implementations.

The paper's NSMs are whole TCP/IP stacks (Linux kernel, mTCP, shared-memory)
that serve unmodified applications behind the BSD socket API. Here an NSM is
a whole *collective stack* that serves unmodified model code behind the
``nk_*`` API (repro_torch.core.collectives), over ``torch.distributed``:

  XlaNsm           "the kernel stack": the backend's native collectives
                   (NCCL on the card, gloo on the CPU). Always correct,
                   operator-default. (The name is the reference's: the
                   routing table and the NQE stream name stacks by it.)
  RingNsm          "the mTCP stack": explicit (bidirectional) ring
                   reduce-scatter / all-gather built on point-to-point
                   hops — schedules the wire explicitly so per-step
                   chunking is under framework control.
  HierarchicalNsm  2-level multi-pod stack: reduce-scatter on the fast
                   intra-pod axis, exchange only 1/axis_size of the bytes on
                   the slow pod axis, all-gather back. Cross-pod bytes drop
                   by the intra-pod axis size.
  CompressedNsm    int8-on-the-wire transport for slow axes (gradient
                   compression), composing with either inner stack.
  ShmNsm           the colocated fast path: elides ops whose payload is
                   already reduced/replicated (sharding-compatible), the
                   analog of copying via shared memory instead of TCP.

Every rank of the mesh calls the same verbs in the same order (SPMD), as
inside the reference's ``shard_map`` bodies. The verbs are functional: they
never write into the caller's tensor. ``axis_sizes`` is a ``MeshAxes``,
which maps each axis to its size as the reference's dict does and also
holds the process groups that stand in for ``shard_map``'s named axes.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Iterator, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import compression
from repro_torch.core.nqe import CommOp


class MeshAxes(Mapping):
    """A ``DeviceMesh``'s named axes: ``axes[name]`` is the axis size, and
    ``group(axes)`` the process group over any combination of axes.

    Every group is created here, eagerly and in one order on every rank:
    ``new_group`` is collective over the whole world, so a group made
    lazily on one code path deadlocks the ranks that never take it. A
    group's ranks are in mesh order (row-major over the mesh's dims), so a
    gather over ``("pod", "data")`` concatenates pod-major, as the
    reference's does.
    """

    def __init__(self, mesh):
        names = tuple(mesh.mesh_dim_names or ())
        if not names:
            raise ValueError("MeshAxes needs a DeviceMesh with "
                             "mesh_dim_names")
        self.mesh = mesh
        self.names = names
        self._sizes = dict(zip(names, mesh.shape))
        self._coord = tuple(mesh.get_coordinate())
        self._groups: Dict[Tuple[str, ...], object] = {}
        ranks = mesh.mesh
        for k in range(1, len(names) + 1):
            for dims in itertools.combinations(range(len(names)), k):
                key = tuple(names[d] for d in dims)
                if k == 1:
                    self._groups[key] = mesh.get_group(key[0])
                    continue
                rest = [d for d in range(len(names)) if d not in dims]
                width = math.prod(self._sizes[a] for a in key)
                lists = ranks.permute(*rest, *dims).reshape(-1, width)
                self._groups[key], _ = dist.new_subgroups_by_enumeration(
                    lists.tolist())

    # -- Mapping: axis name -> size (the reference's ``axis_sizes``) -------
    def __getitem__(self, axis: str) -> int:
        return self._sizes[axis]

    def __iter__(self) -> Iterator[str]:
        return iter(self._sizes)

    def __len__(self) -> int:
        return len(self._sizes)

    def _key(self, axes: Sequence[str]) -> Tuple[str, ...]:
        for a in axes:
            if a not in self._sizes:
                raise ValueError(f"unknown mesh axis {a!r}; the mesh has "
                                 f"{self.names}")
        if len(set(axes)) != len(axes) or not axes:
            raise ValueError(f"axes must be distinct and non-empty: {axes}")
        return tuple(a for a in self.names if a in axes)

    def group(self, axes: Sequence[str]):
        """The process group over ``axes`` (any order, mesh order inside)."""
        return self._groups[self._key(tuple(axes))]

    def size(self, axes: Sequence[str]) -> int:
        return math.prod(self._sizes[a] for a in self._key(tuple(axes)))

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
        return self._coord[self.names.index(axis)]

    def peer(self, axis: str, idx: int) -> int:
        """The global rank at coordinate ``idx`` along ``axis``, with this
        rank's coordinates on every other axis."""
        coord = list(self._coord)
        coord[self.names.index(axis)] = idx
        return int(self.mesh.mesh[tuple(coord)])


def ppermute(x: torch.Tensor, axis: str, perm, axes: MeshAxes
             ) -> torch.Tensor:
    """``lax.ppermute`` over one axis: ``perm`` holds axis-local
    ``(src, dst)`` pairs; a rank that is no destination gets zeros. One
    batch of point-to-point sends and receives to global ranks."""
    me = axes.index(axis)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x, axes.peer(axis, dst)))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, axes.peer(axis, src)))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


def _all_gather(x: torch.Tensor, group, n: int, axis: int,
                tiled: bool) -> torch.Tensor:
    """Concatenate (``tiled``) or stack the group's ``x`` along ``axis``."""
    moved = x.movedim(axis, 0).contiguous()
    out = torch.empty((n * moved.shape[0],) + tuple(moved.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, moved, group=group)
    if not tiled:
        parts = out.reshape((n,) + tuple(moved.shape))
        return torch.stack([p.movedim(0, axis) for p in parts], dim=axis)
    return out.movedim(0, axis)


def _reduce_scatter(x: torch.Tensor, group, n: int, axis: int
                    ) -> torch.Tensor:
    moved = x.movedim(axis, 0).contiguous()
    if moved.shape[0] % n:
        raise ValueError(f"reduce_scatter dim {moved.shape[0]} must divide "
                         f"by the group size {n}")
    out = torch.empty((moved.shape[0] // n,) + tuple(moved.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, moved, group=group)
    return out.movedim(0, axis)


class Nsm:
    """Base collective stack. Subclasses implement the verbs they accelerate;
    anything not overridden falls back to the native collectives."""

    name = "base"

    # -- verbs ----------------------------------------------------------
    def psum(self, x, axes: Tuple[str, ...], *, axis_sizes: MeshAxes,
             op: Optional[CommOp] = None):
        return _all_reduce(x, axis_sizes.group(axes))

    def all_gather(self, x, axes, *, axis_sizes, axis: int = 0, tiled=True,
                   op: Optional[CommOp] = None):
        return _all_gather(x, axis_sizes.group(axes), axis_sizes.size(axes),
                           axis, tiled)

    def reduce_scatter(self, x, axes, *, axis_sizes, axis: int = 0,
                       op: Optional[CommOp] = None):
        return _reduce_scatter(x, axis_sizes.group(axes),
                               axis_sizes.size(axes), axis)

    def all_to_all(self, x, axes, *, axis_sizes, split_axis: int,
                   concat_axis: int, op: Optional[CommOp] = None):
        n = axis_sizes.size(axes)
        moved = x.movedim(split_axis, 0).contiguous()
        if moved.shape[0] % n:
            raise ValueError(f"all_to_all split dim {moved.shape[0]} must "
                             f"divide by the group size {n}")
        out = torch.empty_like(moved)
        dist.all_to_all_single(out, moved, group=axis_sizes.group(axes))
        parts = [c.movedim(0, split_axis) for c in out.chunk(n, 0)]
        return torch.cat(parts, dim=concat_axis)

    def ppermute(self, x, axes, *, axis_sizes, perm,
                 op: Optional[CommOp] = None):
        return ppermute(x, axes[0], perm, axis_sizes)

    def __repr__(self):
        return f"<Nsm:{self.name}>"


class XlaNsm(Nsm):
    """Native stack — the backend's own collectives ("kernel stack")."""

    name = "xla"


# ---------------------------------------------------------------------------
# Ring stack
# ---------------------------------------------------------------------------


def _flatten_pad(x, n: int):
    """Flatten to (n, chunk) with zero padding; returns (chunks,
    orig_size, shape)."""
    flat = x.reshape(-1)
    size = flat.shape[0]
    chunk = -(-size // n)
    pad = n * chunk - size
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(n, chunk), size, x.shape


def _unflatten(chunks, size: int, shape):
    return chunks.reshape(-1)[:size].reshape(shape)


class RingNsm(Nsm):
    """Explicit ring collectives over point-to-point hops ("the mTCP stack").

    Ring reduce-scatter + ring all-gather with an optional bidirectional
    split (two counter-rotating rings, halving the per-link bytes).
    """

    name = "ring"

    def __init__(self, bidirectional: bool = False):
        self.bidirectional = bidirectional
        if bidirectional:
            self.name = "ring2"

    # --- internals ------------------------------------------------------
    @staticmethod
    def _perm(n: int, reverse: bool):
        return [(i, (i + 1) % n) for i in range(n)] if not reverse else \
               [(i, (i - 1) % n) for i in range(n)]

    def _ring_reduce_scatter(self, chunks, axis: str, axes: MeshAxes,
                             reverse=False):
        """chunks: (n, chunk). Returns this rank's owned reduced chunk.
        Rank r accumulates the chunk it will own (index r) over n-1 hops."""
        n = chunks.shape[0]
        idx = axes.index(axis)
        step = -1 if not reverse else 1
        perm = self._perm(n, reverse)
        acc = torch.zeros_like(chunks[0])
        for t in range(n - 1):
            acc = ppermute(acc + chunks[(idx + step * (t + 1)) % n], axis,
                           perm, axes)
        return chunks[idx] + acc

    def _ring_all_gather(self, piece, axis: str, n: int, axes: MeshAxes,
                         reverse=False):
        """piece: (chunk,) owned by this rank. Returns (n, chunk)."""
        idx = axes.index(axis)
        perm = self._perm(n, reverse)
        step = -1 if not reverse else 1
        buf = piece.new_zeros((n,) + tuple(piece.shape))
        buf[idx] = piece
        cur = piece
        for t in range(n - 1):
            cur = ppermute(cur, axis, perm, axes)
            buf[(idx + step * (t + 1)) % n] = cur
        return buf

    # --- verbs ----------------------------------------------------------
    def psum(self, x, axes, *, axis_sizes, op=None):
        out = x
        for axis in axes:
            out = self._psum_one(out, axis, axis_sizes)
        return out

    def _psum_one(self, x, axis: str, axes: MeshAxes):
        n = axes[axis]
        if n == 1:
            return x
        if not self.bidirectional:
            chunks, size, shape = _flatten_pad(x, n)
            piece = self._ring_reduce_scatter(chunks, axis, axes)
            full = self._ring_all_gather(piece, axis, n, axes)
            return _unflatten(full, size, shape)
        # bidirectional: two half-payload counter-rotating rings
        flat = x.reshape(-1)
        half = flat.shape[0] // 2
        a, b = flat[:half], flat[half:]
        ca, sa, _ = _flatten_pad(a, n)
        cb, sb, _ = _flatten_pad(b, n)
        pa = self._ring_reduce_scatter(ca, axis, axes, reverse=False)
        pb = self._ring_reduce_scatter(cb, axis, axes, reverse=True)
        fa = self._ring_all_gather(pa, axis, n, axes, reverse=False)
        fb = self._ring_all_gather(pb, axis, n, axes, reverse=True)
        out = torch.cat([fa.reshape(-1)[:sa], fb.reshape(-1)[:sb]])
        return out.reshape(x.shape)

    def reduce_scatter(self, x, axes, *, axis_sizes, axis: int = 0, op=None):
        name = axes[0]
        n = axis_sizes[name]
        if n == 1:
            return x
        # move scatter dim to front, chunk it along the ring
        moved = x.movedim(axis, 0)
        if moved.shape[0] % n:
            raise ValueError("reduce_scatter dim must divide ring")
        flat = moved.reshape(n, -1)
        piece = self._ring_reduce_scatter(flat, name, axis_sizes)
        piece = piece.reshape((moved.shape[0] // n,)
                              + tuple(moved.shape[1:]))
        return piece.movedim(0, axis)

    def all_gather(self, x, axes, *, axis_sizes, axis: int = 0, tiled=True,
                   op=None):
        name = axes[0]
        n = axis_sizes[name]
        if n == 1:
            return x
        buf = self._ring_all_gather(x.reshape(-1), name, n, axis_sizes)
        parts = buf.reshape((n,) + tuple(x.shape))
        moved = parts.movedim(0, axis)
        return moved.reshape(tuple(x.shape[:axis]) + (n * x.shape[axis],)
                             + tuple(x.shape[axis + 1:]))


class HierarchicalNsm(Nsm):
    """2-level psum for multi-axis reductions (the multi-pod stack).

    psum over ("pod","data"): reduce_scatter over 'data' (fast), psum over
    'pod' carrying only 1/|data| of the payload (slow axis), all_gather over
    'data'. Cross-pod bytes drop by |data|.
    """

    name = "hierarchical"

    def __init__(self, inner: Optional[Nsm] = None):
        self.inner = inner or XlaNsm()

    def psum(self, x, axes, *, axis_sizes, op=None):
        if len(axes) < 2:
            return self.inner.psum(x, axes, axis_sizes=axis_sizes, op=op)
        # reduce-scatter over all fast axes, psum on the slowest, gather
        # back. Convention: axes[0] is the slow one ('pod').
        slow, fast = axes[0], tuple(axes[1:])
        n_fast = axis_sizes.size(fast)
        group = axis_sizes.group(fast)
        chunks, size, shape = _flatten_pad(x, n_fast)
        piece = _reduce_scatter(chunks, group, n_fast, 0)    # (1, chunk)
        piece = self.inner.psum(piece, (slow,), axis_sizes=axis_sizes, op=op)
        full = _all_gather(piece, group, n_fast, 0, True)
        return _unflatten(full, size, shape)


class CompressedNsm(Nsm):
    """int8-on-the-wire gradient transport for designated (slow) axes.

    psum quantizes to int8 with a globally agreed scale, sums in int32 and
    dequantizes — wire bytes halve vs bf16 (quarter vs f32). Intended for the
    'pod' axis; error feedback is the caller's. Non-psum verbs pass through
    the inner stack.
    """

    name = "compressed"

    def __init__(self, inner: Optional[Nsm] = None,
                 compress_axes: Tuple[str, ...] = ("pod",)):
        self.inner = inner or XlaNsm()
        self.compress_axes = tuple(compress_axes)

    def psum(self, x, axes, *, axis_sizes, op=None):
        comp = tuple(a for a in axes if a in self.compress_axes)
        rest = tuple(a for a in axes if a not in self.compress_axes)
        out = x
        if rest:
            out = self.inner.psum(out, rest, axis_sizes=axis_sizes, op=op)
        if comp:
            if not out.dtype.is_floating_point:
                out = _all_reduce(out, axis_sizes.group(comp))
            else:
                out = compression.compressed_psum(out, comp,
                                                  axis_sizes=axis_sizes)
        return out


class ShmNsm(Nsm):
    """Colocated fast path: elide ops whose payload already satisfies the
    destination sharding (op.op_data bit0 set by the CoreEngine when the
    routing table proves source/destination compatibility)."""

    name = "shm"

    def __init__(self, inner: Optional[Nsm] = None):
        self.inner = inner or XlaNsm()

    def psum(self, x, axes, *, axis_sizes, op=None):
        if op is not None and op.op_data & 1:
            return x                      # already reduced: zero-copy move
        return self.inner.psum(x, axes, axis_sizes=axis_sizes, op=op)

    def all_gather(self, x, axes, *, axis_sizes, axis=0, tiled=True, op=None):
        if op is not None and op.op_data & 1:
            return x                      # already replicated
        return self.inner.all_gather(x, axes, axis_sizes=axis_sizes,
                                     axis=axis, tiled=tiled, op=op)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Nsm] = {}


def register_nsm(nsm: Nsm) -> Nsm:
    _REGISTRY[nsm.name] = nsm
    return nsm


def get_nsm(name: str) -> Nsm:
    if name not in _REGISTRY:
        raise KeyError(f"unknown NSM {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available_nsms():
    return sorted(_REGISTRY)


register_nsm(XlaNsm())
register_nsm(RingNsm())
register_nsm(RingNsm(bidirectional=True))
register_nsm(HierarchicalNsm())
register_nsm(CompressedNsm())
register_nsm(ShmNsm())
