"""Weights: seeded initialization and the bridge from the reference's pytrees.

``init_params`` fills a ``Model`` from a seeded ``torch.Generator`` with the
reference's per-leaf rule (``distribution/sharding.py::init_params``):
``normal * init_scale / sqrt(fan_in)`` (kinds "normal" and "small_normal",
the SSM conv taps at init_scale 0.5), zeros, or ones. One difference: the
reference reads fan-in as a leaf's first dim, which on its layer-stacked
block weights is the layer count (std 1/sqrt(L) at any width); the port
uses each weight's true fan-in (``ParamDesc.init_fan_in``), so full-width
activations stay O(1). ``torch.Generator`` cannot reproduce ``jax.random``
in any case, so parity tests always carry the reference's weights across.

On a mesh (``shd``, a ``ShardingCtx``) the model holds each rank's shard
of the padded schema. ``init_params`` still draws every leaf whole from the
generator's stream, in the same slices as on one device, and keeps only the
rank's block of each slice, so every layout holds the same values; the
padded heads' weights are drawn like the real ones, as the reference's
are. ``params_from_jax`` copies the rank's block of each reference leaf.

``params_from_jax`` is that bridge: it takes the reference's parameter
pytree with every leaf already a numpy array (``jax.tree.map(np.asarray,
params)``, done by the caller), splits the per-segment layer stacking into
the port's per-layer modules, and carries bf16 bit for bit without
importing ``ml_dtypes``; the SSM leaves cross like any other (``A_log``,
``D`` and ``dt_bias`` f32 ``(H,)``, conv taps ``(W, C)``), and an encoder
model's ``encoder.segments[0]`` and ``encoder.final_norm`` cross into
``Model.encoder``.
``cache_from_jax`` does the same for a cache tuple, each leaf in its own
dtype (an SSM ``state`` ``(L, B, H, P, N)`` is f32, its ``conv_*`` tails
``(L, B, W-1, C)`` in the cache dtype).

A train state crosses too. The optimizer keeps its moments in ``Slot``s
(``opt_slots``): one per top-level parameter, one per layer for a
parameter of two or more dims, and one per segment for a 1-D per-layer
parameter (norm scales, biases), stacked over the segment's layers as the
reference stacks it, because its factored second moment averages over
those layers. ``train_state_from_jax`` carries the reference's state
(parameters, ``opt.mu``, ``opt.nu`` with factored ``vr``/``vc``,
``opt.count``, ``step``) into that layout, and ``train_state_to_numpy``
gives it back in the reference's stacked layout, bf16 widened to f32
(numpy has no bf16 without ``ml_dtypes``). On a mesh a slot is laid out
as its parameter (``slot_spec``; ``nu_specs`` for the Adafactor factors):
``train_state_from_jax(..., shd=)`` keeps each rank's block, and
``train_state_to_numpy`` gathers the blocks back.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import Model, build_schedule, model_schema
from repro_torch.models.schema import ParamTree, leaf, walk


# leaves up to INIT_WHOLE elements are drawn in one f32 temporary (every
# leaf of the dense, ssm, hybrid and encdec models); larger ones (a MoE
# layer's expert stacks at full width) in slices of their leading dim of
# at most INIT_SLICE elements, so no f32 copy of a whole stack exists
INIT_WHOLE = 1 << 30
INIT_SLICE = 1 << 28


def _schema(cfg: ModelConfig, shd) -> Dict:
    return model_schema(cfg, None if shd is None else shd.mesh)


def _block_of(model: Model, name: str, path, shape) -> Tuple[slice, ...]:
    """The rank's block of a leaf of ``shape`` (all of it off a mesh)."""
    node = model.get_submodule(name)
    for key in path[:-1]:
        node = node[key]
    spec = node.spec(path[-1])
    if not spec:
        return tuple(slice(0, n) for n in shape)
    return model.shd.slices(shape, spec)


@torch.no_grad()
def init_params(cfg: ModelConfig, *, device=None,
                generator: Optional[torch.Generator] = None,
                seed: int = 0, shd=None) -> Model:
    """A model with random weights, made on ``device`` from ``generator``
    (default: a new generator on that device seeded with ``seed``); with a
    ``ShardingCtx`` on a mesh, this rank's shards of them."""
    dev = resolve_device(device)
    model = Model(cfg, device=dev, shd=shd)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    schema = _schema(cfg, model.shd)
    for sch, name in _trees(cfg, schema):
        tree = model.get_submodule(name)
        for path, desc in walk(sch):
            p = leaf(tree, path)
            if desc.init == "zeros":
                p.zero_()
            elif desc.init == "ones":
                p.fill_(1.0)
            else:
                _draw(p, desc, _block_of(model, name, path, desc.shape),
                      generator, dev)
    return model


def _draw(p: torch.Tensor, desc, block: Tuple[slice, ...], generator,
          dev) -> None:
    """Draw the leaf ``desc`` whole, in slices of its leading dim, and
    copy the part of each slice inside ``block`` into ``p``."""
    scale = desc.init_scale / max(1.0, float(desc.init_fan_in)) ** 0.5
    n0, row = desc.shape[0], math.prod(desc.shape[1:])
    rows = max(1, INIT_SLICE // row) if n0 * row > INIT_WHOLE else n0
    b0 = block[0]
    for i in range(0, n0, rows):
        w = torch.randn((min(rows, n0 - i),) + tuple(desc.shape[1:]),
                        generator=generator, dtype=torch.float32, device=dev)
        lo, hi = max(i, b0.start), min(i + w.shape[0], b0.stop)
        if lo < hi:
            p[lo - b0.start:hi - b0.start].copy_(
                w[(slice(lo - i, hi - i),) + block[1:]].mul_(scale))


# ---------------------------------------------------------------------------
# The bridge from the reference's numpy-converted pytrees
# ---------------------------------------------------------------------------


def to_torch(a: np.ndarray, device=None) -> torch.Tensor:
    """A numpy array (bf16 included, recognised by dtype name) as a torch
    tensor, bit for bit; a torch tensor passes through (a tree carried to
    a process that has no bf16 numpy)."""
    if isinstance(a, torch.Tensor):
        t = a.contiguous()
        return t.to(device) if device is not None else t
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:       # torch tensors must own writable memory
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device) if device is not None else t


def _own(a, device) -> torch.Tensor:
    """``a`` as a tensor of its own on ``device``: an optimizer moment is
    updated in place, so it never shares memory with the caller's arrays
    (the reference's zero moments may be one buffer)."""
    return to_torch(a).to(device, copy=True)


def _assign(param: torch.Tensor, value: np.ndarray, what: str) -> None:
    t = to_torch(value)
    if tuple(t.shape) != tuple(param.shape) or t.dtype != param.dtype:
        raise ValueError(f"{what}: reference leaf {tuple(t.shape)} {t.dtype} "
                         f"does not match the port's {tuple(param.shape)} "
                         f"{param.dtype}")
    param.copy_(t)


def _get(tree: Dict, path: Sequence[str]):
    node = tree
    for key in path:
        if key not in node:
            raise ValueError(f"reference tree has no leaf "
                             f"{'.'.join(path)}")
        node = node[key]
    return node


def _tops(cfg: ModelConfig, schema: Dict):
    """(the reference's path, the schema, the port's module name) of every
    unstacked subtree, in the order the reference flattens them."""
    out = [(("embed",), schema["embed"], "embed")]
    if cfg.encoder_layers:
        out.append((("encoder", "final_norm"),
                    schema["encoder"]["final_norm"], "encoder.final_norm"))
    out.append((("final_norm",), schema["final_norm"], "final_norm"))
    return out


def _stacks(cfg: ModelConfig, schema: Dict):
    """(the reference's path of a stacked segment, its first layer's
    schema, the port's module names of its layers), for every segment:
    the decoder's, then an encoder's."""
    out, first = [], 0
    for si, seg in enumerate(build_schedule(cfg)):
        out.append((("segments", si), schema["layers"][first],
                    [f"blocks.{first + i}" for i in range(seg.count)]))
        first += seg.count
    if cfg.encoder_layers:
        out.append((("encoder", "segments", 0),
                    schema["encoder"]["layers"][0],
                    [f"encoder.blocks.{i}"
                     for i in range(cfg.encoder_layers)]))
    return out


@torch.no_grad()
def params_from_jax(tree: Dict, cfg: ModelConfig, device=None,
                    shd=None) -> Model:
    """The port's model holding the reference's weights. ``tree`` is the
    reference's parameter pytree with numpy leaves, made on the same mesh
    (its padded heads) when ``shd`` is a ``ShardingCtx`` on one; the model
    then holds this rank's block of each leaf."""
    dev = resolve_device(device)
    model = Model(cfg, device=dev, shd=shd)
    schema = _schema(cfg, model.shd)
    for top, sch, name in _tops(cfg, schema):
        for path, desc in walk(sch):
            _assign(leaf(model.get_submodule(name), path),
                    _get(_at(tree, top), path)[
                        _block_of(model, name, path, desc.shape)],
                    ".".join(top + path))
    for ref, sch, names in _stacks(cfg, schema):
        stacked = _at(tree, ref)
        for i, name in enumerate(names):
            for path, desc in walk(sch):
                _assign(leaf(model.get_submodule(name), path),
                        _get(stacked, path)[i][
                            _block_of(model, name, path, desc.shape)],
                        f"{ref}[{i}]." + ".".join(path))
    return model


# ---------------------------------------------------------------------------
# The train state: optimizer slots and the bridge from the reference's
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Slot:
    """One leaf of the optimizer state. ``params`` names the port's
    parameters it updates (``Model.named_parameters``): one, or a
    segment's layers when ``stacked``. ``ref_path`` is the reference leaf
    it belongs to, and ``layer`` its index in that leaf's stack for a
    per-layer slot (None otherwise)."""
    name: str
    params: Tuple[str, ...]
    ref_path: Tuple
    layer: Optional[int]
    stacked: bool


def _at(tree, path: Sequence):
    for key in path:
        tree = tree[key]
    return tree


@functools.lru_cache(maxsize=None)
def opt_slots(cfg: ModelConfig) -> Tuple[Slot, ...]:
    """The model's optimizer slots: the top-level leaves (embed, an
    encoder's final norm, final_norm), then each segment's leaves, each
    leaf's layers in turn, an encoder's segment last. Kept per config: an
    optimizer step reads them."""
    schema = model_schema(cfg)
    out: List[Slot] = []
    for top, sch, module in _tops(cfg, schema):
        for path, desc in walk(sch):
            name = ".".join((module,) + path)
            out.append(Slot(name, (name,), top + path, None, False))
    for ref, sch, modules in _stacks(cfg, schema):
        for path, desc in walk(sch):
            pnames = tuple(".".join((m,) + path) for m in modules)
            if len(desc.shape) <= 1:
                out.append(Slot(".".join(map(str, ref + path)), pnames,
                                ref + path, None, True))
            else:
                out.extend(Slot(n, (n,), ref + path, i, False)
                           for i, n in enumerate(pnames))
    return tuple(out)


def _trees(cfg: ModelConfig, schema: Dict):
    """(schema, the port's module name) of every subtree of leaves: the
    top-level ones, then each layer's."""
    return [(sch, name) for _ref, sch, name in _tops(cfg, schema)] + \
        [(sch, name) for _ref, sch, names in _stacks(cfg, schema)
         for name in names]


def schema_layouts(cfg: ModelConfig, shd) -> Dict[str, Tuple[Tuple, Tuple]]:
    """``param_layouts`` of the model ``Model(cfg, shd=shd)`` would make,
    from the schema and the rule math alone (no tensor; ``shd`` may hold
    an ``{axis: size}`` dict, as at production sizes)."""
    out = {}
    for sch, name in _trees(cfg, _schema(cfg, shd)):
        for path, desc in walk(sch):
            out[".".join((name,) + path)] = (
                shd.weight_spec(desc.shape, desc.dims), desc.dims)
    return out


def param_layouts(model: Model) -> Dict[str, Tuple[Tuple, Tuple]]:
    """(layout, logical dims) of every parameter, by its
    ``named_parameters`` name; the layout is ``()`` off a mesh."""
    out = {}
    for prefix, module in model.named_modules():
        if not isinstance(module, ParamTree):
            continue
        for key in module.keys():
            if isinstance(module[key], torch.Tensor):
                name = f"{prefix}.{key}" if prefix else key
                out[name] = (module.spec(key), module.dims(key))
    return out


def _drop(spec: Tuple, ndim: int, d: int) -> Tuple:
    full = list(spec) + [None] * (ndim - len(spec))
    del full[d]
    while full and full[-1] is None:
        full.pop()
    return tuple(full)


def nu_specs(spec: Tuple, ndim: int, factored: bool) -> Dict[str, Tuple]:
    """The layouts of a slot's second moment: its own, or the Adafactor
    factors' (``vr`` without the last dim, ``vc`` without the one before),
    each the slot's layout with that dim's entry taken out."""
    if not factored or ndim < 2:
        return {"full": spec}
    return {"vr": _drop(spec, ndim, ndim - 1),
            "vc": _drop(spec, ndim, ndim - 2)}


def slot_spec(slot: Slot, layouts: Dict) -> Tuple:
    """A slot's layout: its parameter's, behind a whole layer dim for a
    stacked slot (the 1-D per-layer leaves: the SSM heads' ``A_log``,
    ``D`` and ``dt_bias`` split over ``model``, the norm scales whole),
    as the reference's stacked leaf is laid out."""
    spec = layouts[slot.params[0]][0]
    return (None,) + spec if slot.stacked and spec else spec


def _block(model: Model, shape, spec) -> Tuple[slice, ...]:
    if model.shd is None or not spec:
        return tuple(slice(0, n) for n in shape)
    return model.shd.slices(shape, spec)


@torch.no_grad()
def train_state_from_jax(state: Dict, cfg: ModelConfig, device=None,
                         shd=None) -> Dict:
    """The reference's train state (numpy leaves) as the port's:
    ``{"params": Model, "opt": {"mu": {slot: tensor}, "nu": {slot: {"full"}
    or {"vr", "vc"}}, "count": int32}, "step": int32}``. With a training
    ``ShardingCtx`` on a mesh (``shd``), this rank's block of every
    parameter, ``mu`` and ``nu`` leaf, laid out as
    ``train.state_shardings`` gives it."""
    model = params_from_jax(state["params"], cfg, device, shd)
    dev = model.device
    layouts = param_layouts(model)
    ref_opt = state["opt"]
    mu, nu = {}, {}
    for slot in opt_slots(cfg):
        def pick(a, _layer=slot.layer):
            return a if _layer is None else a[_layer]
        spec = slot_spec(slot, layouts)
        m = pick(_at(ref_opt["mu"], slot.ref_path))
        mu[slot.name] = _own(m[_block(model, m.shape, spec)], dev)
        ref_nu = _at(ref_opt["nu"], slot.ref_path)
        specs = nu_specs(spec, m.ndim, "vr" in ref_nu)
        nu[slot.name] = {k: _own(pick(v)[_block(
            model, pick(v).shape, specs[k])], dev)
            for k, v in ref_nu.items()}

    def scalar(v):
        return torch.tensor(int(v), dtype=torch.int32, device=dev)

    return {"params": model,
            "opt": {"mu": mu, "nu": nu, "count": scalar(ref_opt["count"])},
            "step": scalar(state["step"])}


def _np(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t`` (never a view of a state a step updates in
    place), bf16 widened to f32."""
    t = t.detach().to("cpu", torch.float32 if t.dtype == torch.bfloat16
                      else t.dtype, copy=True)
    return t.numpy()


def _put(tree: Dict, path: Sequence, value) -> None:
    for key in path[:-1]:
        tree = tree[key] if isinstance(key, int) else tree.setdefault(key,
                                                                      {})
    tree[path[-1]] = value


@torch.no_grad()
def train_state_to_numpy(state: Dict, cfg: ModelConfig) -> Dict:
    """A port train state in the reference's layout: every segment leaf
    stacked over its layers, numpy leaves, bf16 widened to f32. On a mesh
    each leaf is first assembled from the ranks' blocks, a gather every
    rank takes part in."""
    model = state["params"]
    params = dict(model.named_parameters())
    opt = state["opt"]
    if model.shd is not None:
        from repro_torch.distribution.sharding import NamedSharding
        layouts = param_layouts(model)

        def whole(t, spec):
            return NamedSharding(model.shd.axes, spec).whole(t.detach())
        params = {n: whole(t, layouts[n][0]) for n, t in params.items()}
        mu, nu = {}, {}
        for slot in opt_slots(cfg):
            spec = slot_spec(slot, layouts)
            m = opt["mu"][slot.name]
            mu[slot.name] = whole(m, spec)
            specs = nu_specs(spec, m.ndim, "vr" in opt["nu"][slot.name])
            nu[slot.name] = {k: whole(t, specs[k])
                             for k, t in opt["nu"][slot.name].items()}
        opt = {"mu": mu, "nu": nu, "count": opt["count"]}
    n_seg = len(build_schedule(cfg))
    out = {k: {"segments": [{} for _ in range(n_seg)]}
           for k in ("params", "mu", "nu")}
    if cfg.encoder_layers:
        for tree in out.values():
            tree["encoder"] = {"segments": [{}]}
    by_ref: Dict[Tuple, List[Slot]] = {}
    for slot in opt_slots(cfg):
        by_ref.setdefault(slot.ref_path, []).append(slot)
    for ref, slots in by_ref.items():
        if slots[0].layer is None:          # one slot holds the whole leaf
            (s0,) = slots
            p = np.stack([_np(params[n]) for n in s0.params]) \
                if s0.stacked else _np(params[s0.params[0]])
            m = _np(opt["mu"][s0.name])
            v = {k: _np(t) for k, t in opt["nu"][s0.name].items()}
        else:                               # one slot per layer
            p = np.stack([_np(params[s.params[0]]) for s in slots])
            m = np.stack([_np(opt["mu"][s.name]) for s in slots])
            v = {k: np.stack([_np(opt["nu"][s.name][k]) for s in slots])
                 for k in opt["nu"][slots[0].name]}
        for key, val in (("params", p), ("mu", m), ("nu", v)):
            _put(out[key], ref, val)
    for tree in out.values():
        tree["segments"] = tuple(tree["segments"])
        if cfg.encoder_layers:
            tree["encoder"]["segments"] = tuple(
                tree["encoder"]["segments"])
    return {"params": out["params"],
            "opt": {"mu": out["mu"], "nu": out["nu"],
                    "count": np.int32(int(opt["count"]))},
            "step": np.int32(int(state["step"]))}


def cache_from_jax(caches: Sequence[Dict], device=None) -> Tuple:
    """The reference's cache tuple (numpy leaves) in the port's layout,
    which is the same: one dict per segment, each leaf stacked over the
    segment's layers and kept in its dtype."""
    dev = resolve_device(device)
    return tuple({k: to_torch(v, dev) for k, v in seg.items()}
                 for seg in caches)
