"""AdamW with a configurable moment dtype, a cosine schedule and global
clipping: the counterpart of ``repro/train/optimizer.py``.

The moments live in the optimizer slots of ``models.params.opt_slots``:
one per top-level parameter, one per layer for a parameter of two or more
dims, one per segment for a 1-D per-layer parameter, stacked over the
segment's layers as the reference stacks it. Two things follow from the
reference's stacked layout and are kept: every block parameter decays
(its stacked leaf has ``ndim >= 2``, the norm scales included), and a
factored second moment of a 1-D per-layer parameter averages over the
segment's layers (its ``vc``), so such a slot is updated stacked.

The update runs in place under ``torch.no_grad()``. ``lr``, ``c1`` and
``c2`` are f32, as in the reference; with ``moment_dtype="bfloat16"`` the
moment arithmetic runs in bf16, each constant rounded to bf16 first (a
Python scalar in a JAX bf16 product is weak-typed to bf16, where torch
would keep it in f32).
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Optional, Tuple

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.device import dtype_of
from repro_torch.distribution.sharding import split_axes
from repro_torch.models.params import Slot, opt_slots, param_layouts, \
    slot_spec


def cosine_schedule(rcfg: RunConfig):
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = rcfg.learning_rate * (step + 1) / max(rcfg.warmup_steps, 1)
        t = torch.clamp((step - rcfg.warmup_steps)
                        / max(rcfg.total_steps - rcfg.warmup_steps, 1),
                        0.0, 1.0)
        cos = 0.5 * rcfg.learning_rate * (1 + torch.cos(math.pi * t))
        return torch.where(step < rcfg.warmup_steps, warm, cos)
    return lr


def _decay_mask(slots: Iterable[Slot], params: Dict[str, torch.Tensor]
                ) -> Dict[str, bool]:
    """Weight decay per slot: the reference's ``ndim >= 2`` of the leaf as
    it stacks it. A segment's leaf (a stacked slot, or one layer of it)
    has one dim more than each layer's parameter, so every block
    parameter decays, the norms' scales included; 1-D top-level
    parameters, such as ``final_norm``, are spared."""
    def ndim(s: Slot) -> int:
        per_param = params[s.params[0]].dim()
        return per_param + (s.stacked or s.layer is not None)
    return {s.name: ndim(s) >= 2 for s in slots}


def _nu_shapes(p_shape, factored: bool):
    """Second-moment leaf layout: full, or Adafactor row/col factors over
    the last two dims (stacked layer dims are kept)."""
    if not factored or len(p_shape) < 2:
        return {"full": p_shape}
    return {"vr": p_shape[:-1], "vc": p_shape[:-2] + p_shape[-1:]}


def _slot_shape(slot: Slot, params: Dict[str, torch.Tensor]):
    shape = tuple(params[slot.params[0]].shape)
    return (len(slot.params),) + shape if slot.stacked else shape


@torch.no_grad()
def init_opt_state(model, rcfg: RunConfig) -> Dict:
    """Zero moments for every slot of ``model`` on its device."""
    mdt = dtype_of(rcfg.moment_dtype)
    params = dict(model.named_parameters())
    dev = model.device
    mu, nu = {}, {}
    for slot in opt_slots(model.cfg):
        shape = _slot_shape(slot, params)
        mu[slot.name] = torch.zeros(shape, dtype=mdt, device=dev)
        # row/col factors stay f32: they're tiny and precision matters
        nu[slot.name] = {
            k: torch.zeros(s, dtype=torch.float32 if rcfg.factored_nu
                           and k != "full" else mdt, device=dev)
            for k, s in _nu_shapes(shape, rcfg.factored_nu).items()}
    return {"mu": mu, "nu": nu,
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tensors: Iterable[torch.Tensor], shd=None,
                axes: Optional[Iterable[Tuple[str, ...]]] = None
                ) -> torch.Tensor:
    """The 2-norm of all the tensors' elements. On a mesh (``shd``) each
    tensor is a rank's block of a leaf split over ``axes`` (one tuple a
    tensor) and replicated over the rest: the local sums of squares of the
    leaves split alike are ``psum``med over their axes alone, so every
    element counts once."""
    if shd is None:
        sq = sum(torch.sum(torch.square(g.float())) for g in tensors)
        return torch.sqrt(sq)
    groups: Dict[Tuple[str, ...], torch.Tensor] = {}
    for g, ax in zip(tensors, axes):
        groups[ax] = groups.get(ax, 0.0) + torch.sum(torch.square(g.float()))
    sq = sum(shd._psum(v, ax, gradient=True) if ax else v
             for ax, v in groups.items())
    return torch.sqrt(sq)


def grad_norm(model, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The global norm of ``model``'s gradients by parameter name (on a
    mesh, of the rank's synced blocks: ``global_norm`` with each
    parameter's axes)."""
    if model.shd is None:
        return global_norm(grads.values())
    layouts = param_layouts(model)
    order = tuple(model.shd.axis_sizes)
    return global_norm(grads.values(), model.shd, [
        tuple(a for a in order if a in split_axes(layouts[n][0]))
        for n in grads])


def _f32(t: torch.Tensor) -> torch.Tensor:
    """An f32 copy of ``t`` that in-place arithmetic may write (``float``
    returns ``t`` itself when it is f32 already)."""
    return t.to(torch.float32, copy=True)


def _round(v: float, dtype: torch.dtype) -> float:
    """``v`` as the nearest value of ``dtype`` (exact in f32 and bf16)."""
    return torch.tensor(v, dtype=dtype).item()


@torch.no_grad()
def adamw_update(model, grads: Dict[str, torch.Tensor], opt_state: Dict,
                 rcfg: RunConfig) -> Tuple[object, Dict, Dict]:
    """One AdamW step over ``grads`` (parameter name -> gradient), in
    place on the model's parameters and on ``opt_state``. Returns (model,
    opt_state, metrics) like the reference's (new_params, new_opt_state,
    metrics)."""
    count = opt_state["count"]
    lr = cosine_schedule(rcfg)(count)
    b1, b2 = rcfg.beta1, rcfg.beta2
    eps = 1e-8
    shd = model.shd
    layouts = param_layouts(model) if shd is not None else {}
    gnorm = grad_norm(model, grads)
    scale = torch.clamp(rcfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if rcfg.grad_clip > 0 \
        else torch.ones((), device=gnorm.device)
    n = (count + 1).to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(b1, device=n.device), n)
    c2 = 1.0 - torch.pow(torch.tensor(b2, device=n.device), n)

    # moment math dtype: f32 normally; bf16 when moments are stored bf16
    # (>=100B models); bias correction and the factored-nu reconstruction
    # stay f32
    cdt = torch.bfloat16 if rcfg.moment_dtype == "bfloat16" \
        else torch.float32
    b1c, b1m = _round(b1, cdt), _round(1 - b1, cdt)
    b2c, b2m = _round(b2, cdt), _round(1 - b2, cdt)
    scale_c = scale.to(cdt)

    def mean(t, dim: int, spec: Tuple, at: int, keepdim: bool = False):
        """``t``'s mean over ``dim``, which is dim ``at`` of a slot laid
        out by ``spec``: over the whole dim where a mesh splits it."""
        cand = spec[at] if at < len(spec) else None
        if not cand:
            return torch.mean(t, dim=dim, keepdim=keepdim)
        cand = cand if isinstance(cand, tuple) else (cand,)
        total = shd._psum(torch.sum(t, dim=dim, keepdim=keepdim), cand,
                          gradient=True)
        return total / (t.shape[dim] * shd.axes.size(cand))

    def nu_update(nu, g2, spec):
        if "full" in nu:
            nu_f = nu["full"].to(cdt) * b2c + b2m * g2
            nu["full"].copy_(nu_f)
            return nu_f
        g2f = g2.float()
        del g2
        nd = g2f.dim()
        vr = nu["vr"] * b2 + (1 - b2) * mean(g2f, -1, spec, nd - 1)
        vc = nu["vc"] * b2 + (1 - b2) * mean(g2f, -2, spec, nd - 2)
        del g2f
        denom = torch.clamp(mean(vr, -1, spec, nd - 2, keepdim=True),
                            min=1e-30)
        nu["vr"].copy_(vr)
        nu["vc"].copy_(vc)
        # in place: one f32 temporary of the slot's size, not three
        full = vr[..., None] * vc[..., None, :]
        return full.div_(denom[..., None]).to(cdt)

    params = dict(model.named_parameters())
    slots = opt_slots(model.cfg)
    mask = _decay_mask(slots, params)
    for slot in slots:
        ps = [params[n] for n in slot.params]
        p = torch.stack(ps) if slot.stacked else ps[0]
        g = torch.stack([grads[n] for n in slot.params]) if slot.stacked \
            else grads[slot.params[0]]
        mu = opt_state["mu"][slot.name]
        g = g.to(cdt) * scale_c
        mu_f = mu.to(cdt) * b1c + b1m * g
        nu_f = nu_update(opt_state["nu"][slot.name], (g * g).to(cdt),
                         slot_spec(slot, layouts) if shd else ())
        del g
        mu.copy_(mu_f)
        # the step's arithmetic in place on f32 copies, in the reference's
        # order, so a slot of a billion elements (an expert stack) holds
        # two f32 temporaries at a time, not six: (mu / c1) / (sqrt(nu /
        # c2) + eps) [+ wd p], then p - lr * step
        step = _f32(mu_f).div_(c1)
        del mu_f
        step.div_(_f32(nu_f).div_(c2).sqrt_().add_(eps))
        del nu_f
        if mask[slot.name]:
            step.add_(_f32(p).mul_(rcfg.weight_decay))
        new_p = _f32(p).sub_(step.mul_(lr)).to(p.dtype)
        del step
        if slot.stacked:
            for i, q in enumerate(ps):
                q.copy_(new_p[i])
        else:
            p.copy_(new_p)
    count += 1
    return model, opt_state, {"grad_norm": gnorm, "lr": lr}
