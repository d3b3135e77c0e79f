"""Logical-axis sharding rules with divisibility-aware fallback, on a DeviceMesh.

The counterpart of ``repro/distribution/sharding.py``. Every parameter,
cache and activation dimension is named with a *logical* axis ("batch",
"heads", "ffn", ...). ``spec_for`` maps logical axes to mesh axes by
priority, dropping any candidate whose mesh size does not divide the
actual dimension (the head counts 12/24/25/56 against a 16-way model
axis); models never name mesh axes. The rule tables and their resolution
are plain Python and need only the mesh's axis sizes: a ``DeviceMesh``, a
``core/nsm.py::MeshAxes`` or an ``{axis: size}`` dict.

A spec is the port's own: a tuple with one entry per leading dimension,
each ``None`` (replicated), a mesh axis, or a tuple of mesh axes used
together, trailing ``None``s trimmed. It compares equal to
``tuple(jax_spec)`` of the reference's ``PartitionSpec``.

The layout half maps a spec onto DTensor placements: ``placements_for``
gives one ``Shard(dim)`` or ``Replicate()`` per mesh dim. A tensor dim
sharded over two mesh axes (``("pod", "data")``) is split by DTensor in
mesh-dim order, which is XLA's order only when the tuple is in mesh
order: every tuple of the rule tables is (asserted below), and
``placements_for`` refuses any other by name. ``shard_slices`` gives the
same blocks as plain slices, which is how the port materializes a rank's
shard of a weight or a cache without building the whole tensor.

``ShardingCtx`` is threaded through the port's sharded forward. Besides
the reference's ``spec``/``constrain``/``constrain_act``/``axis_sizes``/
``tp``, it carries the ``MeshAxes`` whose process groups the forward's
collectives use, and sends them through the ``nk_*`` verbs and the
installed ``CoreEngine`` (its own native engine when none is installed),
so the operator's routing table sees the serving traffic; a thread with
no engine installed (autograd's device thread) uses the one last seen.
Weights on the serving path are laid out by the context's rules with
``pod`` and ``data`` stripped (``weight_spec``): model-sharded and
replicated over the batch axes, the layout of the reference's
``TP_RULES``; caches and activations keep the full rules, so the batch
splits over ``data``.

**Training** (``ShardingCtx(..., train=True)``) lays the weights out by
the run's rules whole (``make_rules(rcfg.rules_variant)``): under ``"2d"``
a weight's ``embed`` rows over ``data`` (FSDP) and its ``heads``/``ffn``/
``vocab`` over ``model`` (TP); under ``"fsdp"`` the ``embed`` rows over
``(data, model)`` and no TP; under ``"tp"`` TP only. The forward gathers a
layer's FSDP shards just before use (``gathered``, a view of a
``ParamTree``) and lets them go after. The collectives are autograd
functions with the Megatron transposes: ``psum`` of row-parallel partial
sums has the identity as its backward, ``psum_partial`` (a sum each rank
uses for its own part only) a gradient ``psum``, ``enter`` (a tensor
replicated over the TP axis entering column-parallel work, once however
many consumers share it) the identity forward and a ``psum`` of the
cotangent backward, ``all_gather`` a ``reduce_scatter``.
The backward's collectives are flagged ``gradient``, the forward's neither
``serving`` nor ``gradient``. Megatron-SP (``seq_parallel``, the rules'
``seq_sp``) splits a training forward's residual stream along the
sequence over the TP axis (``for_seq`` makes the forward's copy with
``sp`` set): a block gathers the rows it splits its work over
(``rows_in``, whose transpose is a reduce-scatter) and reduce-scatters
its row-parallel sums back to them (``rows_out``, ``_ReduceScatter``,
whose transpose is an all-gather). ``shared`` divides the gradient of a
value every rank computes alike where such a transpose sums it (the MoE
aux losses). ``NamedSharding`` pairs a spec with the
mesh: ``state_shardings``/``batch_shardings`` (``train/train_loop.py``)
return trees of them; ``block`` gives a rank's slices, ``whole`` the
global tensor from the ranks' blocks.
"""
from __future__ import annotations

import copy
import math
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.launch.mesh import POD_AXES, axis_sizes as _axis_sizes

# logical axis -> ordered candidates; each candidate is a mesh axis or a
# tuple of mesh axes (used together). First candidate that (a) exists in the
# mesh and (b) divides the dim size wins; otherwise the dim is replicated.
LOGICAL_RULES: Dict[str, Tuple] = {
    "batch": (("pod", "data"), "data"),
    "embed": ("data",),           # FSDP: parameter rows sharded over data
    "embed_tp": ("model",),       # output-proj rows: TP contraction dim
    "heads": ("model",),
    "kv_heads": (),               # replicated (kv < tp in most assigned archs)
    "head_dim": (),
    "ffn": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "expert_group": ("data",),    # MoE dispatch group dim (GShard 2D layout)
    "expert_cap": ("data",),      # MoE (E, C, D) capacity dim
    "expert_ff": (),
    "seq": (),
    "seq_sp": ("model",),         # Megatron-SP activation sharding
    "kv_seq": ("model",),         # context-parallel decode cache
    "ssm_heads": ("model",),
    "ssm_state": (),
    "conv": (),
    "layers": (),                 # stacked-layer leading dim
    "stage": ("pod",),            # pipeline stages
    "none": (),
}

# Pure-FSDP variant: the whole mesh acts as one data/param-sharding axis.
FSDP_RULES: Dict[str, Tuple] = dict(
    LOGICAL_RULES,
    batch=(("pod", "data", "model"), ("data", "model"), "data"),
    embed=(("data", "model"), "data"),
    heads=(), ffn=(), vocab=(), experts=(), ssm_heads=(),
    seq_sp=(),
)

# Serving/TP variant: weights live model-sharded and are never gathered;
# they replicate over 'data'.
TP_RULES: Dict[str, Tuple] = dict(
    LOGICAL_RULES,
    embed=(),
)

RULE_VARIANTS = {"2d": LOGICAL_RULES, "fsdp": FSDP_RULES, "tp": TP_RULES}


def _in_mesh_order(cand: Tuple[str, ...]) -> bool:
    at = [POD_AXES.index(a) for a in cand]
    return at == sorted(at)


# DTensor splits a dim sharded over several mesh dims in mesh-dim order;
# XLA splits it in the tuple's order. They agree because every tuple is in
# mesh order.
assert all(_in_mesh_order(c) for rules in RULE_VARIANTS.values()
           for cands in rules.values() for c in cands
           if isinstance(c, tuple))


def make_rules(variant: str) -> Dict[str, Tuple]:
    return RULE_VARIANTS[variant]


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    return _axis_sizes(mesh)


def strip_axes_from_rules(axes: Tuple[str, ...],
                          rules: Optional[Dict[str, Tuple]] = None
                          ) -> Dict[str, Tuple]:
    """Rules with the given mesh axes removed (e.g. the serving weights'
    layout, replicated over the batch axes)."""
    rules = dict(rules or LOGICAL_RULES)
    out: Dict[str, Tuple] = {}
    for k, cands in rules.items():
        new = []
        for c in cands:
            if isinstance(c, tuple):
                c = tuple(a for a in c if a not in axes)
                if len(c) == 1:
                    c = c[0]
                if not c:
                    continue
            elif c in axes:
                continue
            new.append(c)
        out[k] = tuple(new)
    return out


def _candidate_size(cand, sizes: Dict[str, int]) -> Optional[int]:
    if isinstance(cand, tuple):
        n = 1
        for a in cand:
            if a not in sizes:
                return None
            n *= sizes[a]
        return n
    return sizes.get(cand)


def resolve_dim(logical: Optional[str], dim_size: int, sizes: Dict[str, int],
                rules: Optional[Dict[str, Tuple]] = None):
    """Mesh axis (or axes tuple) for one dimension, or None (replicate)."""
    if logical is None or logical == "none":
        return None
    rules = rules or LOGICAL_RULES
    if logical not in rules:
        raise KeyError(f"unknown logical axis {logical!r}")
    for cand in rules[logical]:
        n = _candidate_size(cand, sizes)
        if n is None or n == 0:
            continue
        if dim_size % n == 0:
            return cand
    return None


def _flat(cand) -> Tuple[str, ...]:
    if cand is None:
        return ()
    return cand if isinstance(cand, tuple) else (cand,)


def spec_for(shape: Sequence[int], dims: Sequence[Optional[str]], mesh,
             rules: Optional[Dict[str, Tuple]] = None) -> Tuple:
    assert len(shape) == len(dims), (shape, dims)
    sizes = mesh_axis_sizes(mesh)
    used: set = set()
    entries = []
    for size, logical in zip(shape, dims):
        cand = resolve_dim(logical, size, sizes, rules)
        flat = _flat(cand)
        # a mesh axis may appear at most once per spec
        if any(a in used for a in flat):
            cand, flat = None, ()
        used.update(flat)
        entries.append(cand)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


# ---------------------------------------------------------------------------
# Layout: DTensor placements and plain slices of a spec
# ---------------------------------------------------------------------------


def placements_for(spec: Tuple, mesh) -> Tuple:
    """One DTensor placement per mesh dim: ``Shard(d)`` where tensor dim
    ``d``'s spec entry names that mesh axis, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh_axis_sizes(mesh))
    out = [Replicate() for _ in names]
    for d, cand in enumerate(spec):
        flat = _flat(cand)
        at = [names.index(a) if a in names else -1 for a in flat]
        if -1 in at:
            raise ValueError(f"spec {spec} names an axis outside the mesh "
                             f"{names}")
        if at != sorted(at):
            raise ValueError(f"spec entry {cand} is not in mesh order "
                             f"{names}: DTensor would split dim {d} in "
                             f"another order than XLA")
        for i in at:
            out[i] = Shard(d)
    return tuple(out)


def sharding_for(shape, dims, mesh, rules=None) -> Tuple:
    return placements_for(spec_for(shape, dims, mesh, rules), mesh)


def _tree_map(fn, tree):
    from repro_torch.models.schema import ParamDesc
    if isinstance(tree, ParamDesc):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return type(tree)(_tree_map(fn, v) for v in tree)


def param_shardings(schema, mesh, rules=None):
    """The schema's tree with every ``ParamDesc`` replaced by its DTensor
    placements on ``mesh``."""
    return _tree_map(lambda d: sharding_for(d.shape, d.dims, mesh, rules),
                     schema)


def _block(cand, sizes: Dict[str, int], coord: Dict[str, int]):
    """(index, count) of this rank's block of a dim sharded over ``cand``:
    row-major over the candidate's axes, as DTensor and XLA split it."""
    idx, n = 0, 1
    for a in _flat(cand):
        idx = idx * sizes[a] + coord[a]
        n *= sizes[a]
    return idx, n


def local_shape(shape: Sequence[int], spec: Tuple, mesh) -> Tuple[int, ...]:
    sizes = mesh_axis_sizes(mesh)
    out = list(shape)
    for d, cand in enumerate(spec):
        out[d] //= _candidate_size(cand, sizes) if cand else 1
    return tuple(out)


def shard_slices(shape: Sequence[int], spec: Tuple, mesh,
                 coord: Dict[str, int]) -> Tuple[slice, ...]:
    """This rank's block of a tensor of ``shape`` laid out by ``spec``, as
    one slice per dim; ``coord`` is the rank's index on each mesh axis."""
    sizes = mesh_axis_sizes(mesh)
    out = [slice(0, n) for n in shape]
    for d, cand in enumerate(spec):
        if cand:
            idx, n = _block(cand, sizes, coord)
            w = shape[d] // n
            out[d] = slice(idx * w, (idx + 1) * w)
    return tuple(out)


def constrain(x, dims, mesh, rules=None):
    """``with_sharding_constraint`` by logical dims: ``redistribute`` a
    DTensor to the placements the rules give; a plain tensor (the port's
    explicit per-rank shards) is returned as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, sharding_for(
        tuple(x.shape), dims, x.device_mesh, rules))


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``): ``spec`` is the
    port's tuple, which compares equal to ``tuple(jax_spec)``; ``mesh`` a
    ``MeshAxes``, a ``DeviceMesh`` or an ``{axis: size}`` dict."""

    mesh: object
    spec: Tuple = ()

    def block(self, shape) -> Tuple[slice, ...]:
        """This rank's block of a global tensor of ``shape`` (``mesh`` a
        ``MeshAxes``)."""
        coord = {a: self.mesh.index(a) for a in self.mesh}
        return shard_slices(shape, self.spec, self.mesh, coord)

    def whole(self, t: torch.Tensor) -> torch.Tensor:
        """The global tensor of which ``t`` is this rank's block: gathered
        dim by dim over each entry's axes, on every rank of the mesh (a
        ``MeshAxes``), outside the ``nk_*`` verbs (checkpoint I/O)."""
        from repro_torch.core.nsm import _all_gather
        for d, cand in enumerate(self.spec):
            if cand:
                axes = _flat(cand)
                t = _all_gather(t, self.mesh.group(axes),
                                self.mesh.size(axes), d, True)
        return t.contiguous()


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def padded_heads(num_heads: int, mesh) -> int:
    """Q-heads padded up to the model-axis multiple (the inert-head scheme:
    the head mask zeroes the padded heads in both directions, see
    ``models/attention.py``)."""
    tp = mesh_axis_sizes(mesh).get("model", 1)
    if num_heads % tp == 0:
        return num_heads
    return pad_to_multiple(num_heads, tp)


# ---------------------------------------------------------------------------
# The context threaded through the sharded forward
# ---------------------------------------------------------------------------


# logical dims a layer computes sharded (tensor parallelism); a weight's
# ``embed`` dim is FSDP instead: gathered before use
TP_DIMS = ("heads", "ffn", "vocab")


class _Psum(torch.autograd.Function):
    """``psum`` of partial sums whose result every rank of the group holds
    and feeds the same loss (the row-parallel products, the vocab-sharded
    lookup, the loss's sums): its transpose is the identity (Megatron's
    g)."""

    @staticmethod
    def forward(ctx, x, shd, axes):
        return shd._psum(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _PsumPartial(torch.autograd.Function):
    """``psum`` of partial sums whose result each rank of the group uses
    only for its own part (the gated norm's mean square, which scales only
    the rank's channels): each rank's cotangent is then a partial one, and
    the transpose is a gradient ``psum`` of it."""

    @staticmethod
    def forward(ctx, x, shd, axes):
        ctx.shd, ctx.axes = shd, axes
        return shd._psum(x, axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.shd._psum(g.contiguous(), ctx.axes, gradient=True), \
            None, None


class _Enter(torch.autograd.Function):
    """A tensor replicated over ``axes`` entering work split over them
    (column-parallel products, kv heads read by each rank's query heads):
    the identity forward, and a gradient ``psum`` of the cotangent, of
    which each rank holds only its part (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, shd, axes):
        ctx.shd, ctx.axes = shd, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.shd._psum(g.contiguous(), ctx.axes, gradient=True), \
            None, None


class _AllGather(torch.autograd.Function):
    """``all_gather`` (tiled along ``dim``); its transpose is the gradient
    ``reduce_scatter`` along the same dim."""

    @staticmethod
    def forward(ctx, x, shd, axes, dim):
        ctx.shd, ctx.axes, ctx.dim = shd, axes, dim
        return shd._all_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.shd.reduce_scatter(g.contiguous(), ctx.axes, ctx.dim), \
            None, None, None


class _ReduceScatter(torch.autograd.Function):
    """``reduce_scatter`` of partial sums along ``dim`` (Megatron-SP's
    row-parallel output, each rank keeping its rows); its transpose is
    the ``all_gather`` along the same dim."""

    @staticmethod
    def forward(ctx, x, shd, axes, dim):
        ctx.shd, ctx.axes, ctx.dim = shd, axes, dim
        return shd.reduce_scatter(x, axes, dim, gradient=False)

    @staticmethod
    def backward(ctx, g):
        return ctx.shd._all_gather(g.contiguous(), ctx.axes, ctx.dim), \
            None, None, None


class _Shared(torch.autograd.Function):
    """A value every rank of a group computes alike and feeds a consumer
    every rank computes alike (the MoE aux losses), upstream of a gather
    or an enter whose transpose sums the ranks' cotangents: the identity
    forward, the cotangent divided by the group's size backward, so the
    sum gives it back once."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def _records(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def split_axes(spec: Tuple) -> set:
    """Every mesh axis a layout splits some dim over."""
    return {a for cand in spec for a in _flat(cand)}


def fsdp_entry(spec: Tuple, dims: Tuple):
    """(dim, axes) of a weight's FSDP dim, its ``embed`` dim where the
    layout splits it, or None."""
    for d, cand in enumerate(spec):
        if cand and dims[d] == "embed":
            return d, cand
    return None


class GatheredTree:
    """A ``ParamTree`` as a layer's forward reads it in training: each leaf
    all-gathered over the axes of its FSDP (``embed``) dim on first use,
    and ``spec(key)`` the layout left, its TP axes. A view made inside a
    layer's (rematerialized) function holds the gathered weights only
    while the layer runs, and the recompute gathers them again."""

    def __init__(self, tree, shd: "ShardingCtx"):
        self._tree, self._shd = tree, shd
        self._cache: Dict[str, object] = {}

    def _fsdp(self, key: str):
        return fsdp_entry(self._tree.spec(key), self._tree.dims(key))

    def __getitem__(self, key: str):
        if key not in self._cache:
            node = self._tree[key]
            if isinstance(node, torch.Tensor):
                fsdp = self._fsdp(key)
                if fsdp is not None:
                    node = self._shd.all_gather(node, fsdp[1], fsdp[0])
            else:
                node = GatheredTree(node, self._shd)
            self._cache[key] = node
        return self._cache[key]

    def spec(self, key: str) -> Tuple:
        spec = list(self._tree.spec(key))
        fsdp = self._fsdp(key)
        if fsdp is not None:
            spec[fsdp[0]] = None
        while spec and spec[-1] is None:
            spec.pop()
        return tuple(spec)

    def __contains__(self, key: str) -> bool:
        return key in self._tree

    def get(self, key: str, default=None):
        return self[key] if key in self else default


@dataclass
class ShardingCtx:
    """Resolves logical dims on ``mesh`` and runs the forward's collectives.

    ``mesh``: a ``DeviceMesh`` (its groups are built here, on every rank,
    in one order: group creation is collective), a ``MeshAxes`` already
    built from one, an ``{axis: size}`` dict (rule math only, no
    collectives), or None (one device). ``train``: the training layout
    (weights by the rules whole, FSDP included) and flags."""

    mesh: object
    rules: Optional[Dict[str, Tuple]] = None
    seq_parallel: bool = False
    train: bool = False
    axes: object = field(default=None, init=False, repr=False)
    # the axis a training forward's residual stream splits its rows over
    # (Megatron-SP), set on the forward's own copy (``for_seq``)
    sp: object = field(default=None, init=False, repr=False)
    _native: object = field(default=None, init=False, repr=False)
    _installed: object = field(default=None, init=False, repr=False)

    def __post_init__(self):
        from repro_torch.core.nsm import MeshAxes
        if self.mesh is None or isinstance(self.mesh, dict):
            return
        self.axes = self.mesh if isinstance(self.mesh, MeshAxes) \
            else MeshAxes(self.mesh)
        from repro_torch.core.engine import make_engine
        self._native = make_engine(self.axes, "xla")

    # -- the reference's surface -------------------------------------------
    def spec(self, shape, dims) -> Tuple:
        return spec_for(shape, dims, self.mesh, self.rules)

    def constrain(self, x, dims):
        if self.mesh is None:
            return x
        return constrain(x, dims, self.mesh, self.rules)

    def constrain_act(self, x, with_seq_dim=1):
        """Standard activation constraint (batch[, seq-SP])."""
        dims: list = [None] * x.ndim
        dims[0] = "batch"
        if self.seq_parallel and x.ndim > with_seq_dim:
            dims[with_seq_dim] = "seq_sp"
        return self.constrain(x, dims)

    @property
    def loss_axes(self) -> Tuple[str, ...]:
        """The axes a training loss sums over: every mesh axis but the TP
        axes, whose ranks share one loss."""
        tp = self.tp_axes
        return tuple(a for a in self.axis_sizes if a not in tp)

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return {} if self.mesh is None else mesh_axis_sizes(self.mesh)

    @property
    def tp(self) -> int:
        return self.axis_sizes.get("model", 1)

    # -- layout of the port's per-rank shards ------------------------------
    @property
    def size(self) -> int:
        """Ranks in the mesh."""
        return math.prod(self.axis_sizes.values()) if self.axis_sizes else 1

    @property
    def weight_rules(self) -> Dict[str, Tuple]:
        if self.train:
            return self.rules or LOGICAL_RULES
        return strip_axes_from_rules(("pod", "data"), self.rules)

    def weight_spec(self, shape, dims) -> Tuple:
        """A weight's layout: on the serving path model-sharded and
        replicated over the batch axes; in training the rules' whole."""
        return spec_for(shape, dims, self.mesh, self.weight_rules)

    @property
    def tp_axes(self) -> Tuple[str, ...]:
        """The mesh axes the rules split a layer's work over (``heads``,
        ``ffn``, ``vocab``): ``("model",)`` under ``"2d"`` and ``"tp"``,
        none under ``"fsdp"``, in mesh order."""
        rules = self.rules or LOGICAL_RULES
        named = {a for d in TP_DIMS for c in rules[d] for a in _flat(c)}
        return tuple(a for a in self.axis_sizes if a in named)

    def gathered(self, tree) -> GatheredTree:
        return GatheredTree(tree, self)

    # -- Megatron-SP: the residual stream's rows split over the TP axis ----
    def for_seq(self, seq: int) -> "ShardingCtx":
        """The context a training forward over ``seq`` tokens runs in:
        with ``seq_parallel`` and the rules' ``seq_sp`` dividing ``seq``,
        a copy whose ``sp`` names the axis the residual stream's rows
        split over between blocks (the reference's ``constrain_act``);
        else this context (where ``seq_sp`` does not divide the sequence
        the reference's constraint leaves it whole too)."""
        axis = self.split("seq_sp", seq) \
            if self.seq_parallel and self.train else None
        if not axis:
            return self
        out = copy.copy(self)
        out.sp = axis
        return out

    def sp_of(self, seq: int):
        """The axis a training forward over ``seq`` tokens splits its
        rows over (``for_seq``), or None."""
        return self.for_seq(seq).sp

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Under SP, the rank's rows of the residual stream (dim 1)
        all-gathered over ``sp`` and marked entered over it, so a later
        ``enter`` or ``gather_rows`` of the result is the identity; its
        transpose reduce-scatters the cotangent. Else ``x``."""
        if not self.sp or getattr(x, "_entered", None) == _flat(self.sp):
            return x
        out = self.all_gather(x, self.sp, 1)
        out._entered = _flat(self.sp)
        return out

    def rows_in(self, x: torch.Tensor, axis) -> torch.Tensor:
        """``x`` entering work split over ``axis`` (heads, MLP columns,
        the vocabulary): under SP its rows gathered where the work is
        split (``gather_rows``), the rank's own rows where it is not;
        else ``enter``."""
        if self.sp:
            return self.gather_rows(x) if axis else x
        return self.enter(x, axis)

    def rows_out(self, y: torch.Tensor, axis, x_in: torch.Tensor
                 ) -> torch.Tensor:
        """The output ``y`` of work on ``x_in`` (``rows_in``'s result):
        partial sums over ``axis`` ``psum``med, or, under SP with
        ``x_in``'s rows gathered, reduce-scattered along the sequence so
        each rank keeps its rows (the transpose an all-gather); an output
        over gathered rows with nothing to sum keeps the rank's rows."""
        if self.sp and getattr(x_in, "_entered", None) == _flat(self.sp):
            return self.scatter_rows(y) if axis else self.own_rows(y)
        return self.psum(y, axis) if axis else y

    def scatter_rows(self, y: torch.Tensor) -> torch.Tensor:
        """Partial sums over ``sp`` of every row (dim 1), reduce-scattered
        so the rank keeps the sum of its rows; under autograd the
        transpose is an all-gather (``_ReduceScatter``)."""
        if _records(y):
            return _ReduceScatter.apply(y, self, self.sp, 1)
        return self.reduce_scatter(y, self.sp, 1, gradient=False)

    def own_rows(self, y: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``y``'s rows (dim 1) over ``sp``."""
        return y[:, self.block(self.sp, y.shape[1])]

    def enter_weight(self, w: torch.Tensor, axis) -> torch.Tensor:
        """A weight every rank of ``axis`` holds whole and reads for its
        part of work split over it (kv heads, q/k norms, MLA's
        down-projection): ``enter``ed, so its gradient is summed over
        ``axis``; under SP as it is, the step summing every leaf the SP
        axis does not split over that axis after the backward
        (``train_loop.sum_axes``)."""
        return w if self.sp else self.enter(w, axis)

    def shared(self, x: torch.Tensor, axes) -> torch.Tensor:
        """``x``, which every rank of ``axes`` computes alike for a
        consumer every rank computes alike, where a gather's or an
        enter's transpose then sums the ranks' cotangents: its cotangent
        divided by the ranks' count (``_Shared``), so the sum counts it
        once. The identity off autograd or with no axes."""
        if not axes or not _records(x):
            return x
        return _Shared.apply(
            x, math.prod(self.axis_sizes[a] for a in _flat(axes)))

    def coord(self) -> Dict[str, int]:
        if self.axes is None:
            raise ValueError("this ShardingCtx has axis sizes only; a rank's "
                             "coordinates need a DeviceMesh or MeshAxes")
        return {a: self.axes.index(a) for a in self.axes}

    def index(self, axis: str) -> int:
        return self.axes.index(axis) if axis in self.axis_sizes else 0

    def slices(self, shape, spec) -> Tuple[slice, ...]:
        return shard_slices(shape, spec, self.mesh, self.coord())

    def split(self, logical: str, size: int):
        """The mesh axis (or axes) a dim of ``size`` named ``logical`` is
        sharded over by the context's rules, or None."""
        if self.mesh is None:
            return None
        return resolve_dim(logical, size, self.axis_sizes, self.rules)

    def block(self, cand, size: int) -> slice:
        """This rank's range of a dim of ``size`` sharded over ``cand``."""
        if not cand:
            return slice(0, size)
        idx, n = _block(cand, self.axis_sizes, self.coord())
        return slice(idx * (size // n), (idx + 1) * (size // n))

    # -- the wire: nk_* verbs through the installed (or own) engine --------
    def _wire(self):
        from repro_torch.core.collectives import current_engine, use_engine
        # the engine installed around this context's collectives; a thread
        # with none (autograd's device thread runs a backward, and a
        # remat's recompute, on the card) keeps the last one seen, so the
        # backward's traffic reaches the same ledger as the forward's
        engine = current_engine()
        if engine is not None:
            self._installed = engine
        return use_engine(engine or self._installed or self._native)

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        """``lax.psum`` through ``nk_psum``; under autograd, with the
        identity as its backward (``_Psum``)."""
        if _records(x):
            return _Psum.apply(x, self, axes)
        return self._psum(x, axes)

    def psum_partial(self, x: torch.Tensor, axes) -> torch.Tensor:
        """``psum`` of partial sums of which each rank then uses the sum
        for its own part only; under autograd its backward is a gradient
        ``psum`` (``_PsumPartial``)."""
        if _records(x):
            return _PsumPartial.apply(x, self, axes)
        return self._psum(x, axes)

    def _psum(self, x: torch.Tensor, axes, gradient: bool = False
              ) -> torch.Tensor:
        """A bf16 tensor is summed in f32 and rounded once, as the
        reference's partitioned all-reduce does: a bf16 sum rounds after
        every rank's term."""
        from repro_torch.core.collectives import nk_psum
        flags = dict(gradient=gradient, serving=not (gradient or self.train))
        with self._wire():
            if x.dtype == torch.bfloat16:
                return nk_psum(x.float(), _flat(axes), **flags).to(x.dtype)
            return nk_psum(x, _flat(axes), **flags)

    def enter(self, x: torch.Tensor, axes) -> torch.Tensor:
        """``x``, replicated over ``axes``, entering work split over them:
        its gradient is summed over them (``_Enter``). The identity when
        autograd does not record or ``axes`` is empty, and for a tensor
        already entered over ``axes``: entering it again would sum its
        summed gradient once more, so a caller may enter a tensor that
        several consumers share once for all of them."""
        if not axes or not _records(x) \
                or getattr(x, "_entered", None) == _flat(axes):
            return x
        out = _Enter.apply(x, self, axes)
        out._entered = _flat(axes)
        return out

    def all_gather(self, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """Tiled ``nk_all_gather``; under autograd its backward is the
        gradient ``reduce_scatter`` (``_AllGather``)."""
        if _records(x):
            return _AllGather.apply(x, self, axes, dim)
        return self._all_gather(x, axes, dim)

    def _all_gather(self, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
        from repro_torch.core.collectives import nk_all_gather
        with self._wire():
            return nk_all_gather(x, _flat(axes), axis=dim, tiled=True)

    def reduce_scatter(self, x: torch.Tensor, axes, dim: int,
                       gradient: bool = True) -> torch.Tensor:
        """``nk_reduce_scatter`` along ``dim``: the sum over ``axes``, this
        rank's block of it. bf16 is summed in f32 and rounded once, as
        ``psum`` does."""
        from repro_torch.core.collectives import nk_reduce_scatter
        with self._wire():
            if x.dtype == torch.bfloat16:
                return nk_reduce_scatter(x.float(), _flat(axes), axis=dim,
                                         gradient=gradient).to(x.dtype)
            return nk_reduce_scatter(x, _flat(axes), axis=dim,
                                     gradient=gradient)

    def ppermute(self, x: torch.Tensor, axis: str, perm) -> torch.Tensor:
        from repro_torch.core.collectives import nk_ppermute
        with self._wire():
            return nk_ppermute(x, axis, perm=perm)

    def pmax(self, x: torch.Tensor, axis) -> torch.Tensor:
        """``lax.pmax`` over one axis or several: not an ``nk_*`` verb, a
        MAX all-reduce on the axes' group (no gradient)."""
        import torch.distributed as dist
        out = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.MAX,
                        group=self.axes.group(_flat(axis)))
        return out

    def agreed_now(self, now: Optional[float]) -> float:
        """One clock for every rank's host decisions: ``now``, or the
        first rank's monotonic time, broadcast over the mesh."""
        if now is not None or self.size == 1:
            return time.monotonic() if now is None else now
        import torch.distributed as dist
        t = torch.tensor([time.monotonic()], dtype=torch.float64,
                         device=_group_device(self))
        group = self.axes.group(tuple(self.axes))
        dist.broadcast(t, group=group,
                       src=dist.get_global_rank(group, 0))
        return float(t.item())


def _group_device(ctx: ShardingCtx) -> torch.device:
    mesh = ctx.axes.mesh
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")
