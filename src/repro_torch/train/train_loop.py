"""Training step factory: loss, gradient accumulation, NSM-routed pod sync.

The counterpart of ``repro/train/train_loop.py``. Two stacks for the same
model code (the paper's use case 3, applied to training):

  * **plain** (one card): ``plain_step`` computes the gradients and runs
    AdamW; no collective.
  * **netkernel pod sync** (``RunConfig.explicit_pod_sync`` on a mesh
    with a ``pod`` axis): one rank per pod of a ``torch.distributed``
    world (``core/nsm.py::MeshAxes``) computes its pod's rows of the
    batch, and the per-pod gradients are synchronized through the
    CoreEngine (``nk_grad_sync``), so the operator's routing table picks
    the cross-pod transport (hierarchical / int8-compressed / ring)
    without touching model or loss code. The reference runs the pods as
    ``vmap`` lanes of one program; the arithmetic is the same.

A step updates the state in place (the reference donates it) and returns
it with its metrics, as 0-d tensors on the state's device. The state is
``{"params": Model, "opt": {"mu", "nu", "count"}, "step"}``
(``models/params.py::opt_slots`` lays out the moments). The reference's
``state_shardings``/``batch_shardings`` have no one-card counterpart and
are left out (ROADMAP: distribution).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.collectives import nk_grad_sync, use_engine
from repro_torch.core.compression import int8_roundtrip_residual
from repro_torch.core.engine import CoreEngine, make_engine
from repro_torch.device import dtype_of, resolve_device
from repro_torch.models.model import Model, check_family, forward_train
from repro_torch.models.params import init_params
from repro_torch.train.optimizer import adamw_update, init_opt_state


def loss_fn(model: Model, batch: Dict, cfg: ModelConfig, rcfg: RunConfig
            ) -> Tuple[torch.Tensor, Dict]:
    """Mean next-token cross entropy in f32, plus the z-loss. A gather picks
    the labels' logits (the reference's select-reduce exists only for its
    vocab-sharded logits)."""
    logits, aux = forward_train(model, batch, cfg, rcfg)
    logits = logits.float()
    labels = batch["labels"].long()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None])[..., 0]
    loss = torch.mean(lse - picked)
    metrics = {"ce_loss": loss}
    if rcfg.z_loss:
        zl = rcfg.z_loss * torch.mean(torch.square(lse))
        loss = loss + zl
        metrics["z_loss"] = zl
    if "moe_lb_loss" in aux:
        moe_l = 1e-2 * aux["moe_lb_loss"] + 1e-3 * aux["moe_z_loss"]
        loss = loss + moe_l
        metrics.update(aux)
    metrics["loss"] = loss
    return loss, {k: v.detach() for k, v in metrics.items()}


def _trainable(model: Model) -> List[Tuple[str, torch.Tensor]]:
    """The model's parameters by name, with ``requires_grad`` on (the
    port makes them frozen; a trainer turns it on for its own model)."""
    named = list(model.named_parameters())
    for _, p in named:
        p.requires_grad_(True)
    return named


def _grads(model: Model, batch: Dict, cfg: ModelConfig, rcfg: RunConfig
           ) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """(gradients by parameter name, metrics). With ``grad_accum > 1``:
    each micro-batch's gradient (in the parameter dtype) is added into
    ``grad_accum_dtype`` accumulators, and the mean is cast to bf16; the
    metrics are the last micro-batch's (the reference's scan carry keeps
    only those)."""
    named = _trainable(model)
    names = [n for n, _ in named]
    params = [p for _, p in named]
    if rcfg.grad_accum <= 1:
        loss, metrics = loss_fn(model, batch, cfg, rcfg)
        return dict(zip(names, torch.autograd.grad(loss, params))), metrics
    a = rcfg.grad_accum
    mb = {k: v.reshape((a, v.shape[0] // a) + v.shape[1:])
          for k, v in batch.items()}
    adt = dtype_of(rcfg.grad_accum_dtype)
    acc = [torch.zeros(p.shape, dtype=adt, device=p.device) for p in params]
    metrics = _zero_metrics(cfg, rcfg, params[0].device)
    for i in range(a):
        loss, metrics = loss_fn(model, {k: v[i] for k, v in mb.items()},
                                cfg, rcfg)
        g = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for acc_i, g_i in zip(acc, g):
                acc_i.add_(g_i.to(adt))
        del g
    grads = {}
    with torch.no_grad():
        for i, name in enumerate(names):
            grads[name] = (acc[i] / a).to(torch.bfloat16)
            acc[i] = None               # free each accumulator as it goes
    return grads, metrics


@torch.no_grad()
def ef_residual_metrics(grads: Dict[str, torch.Tensor]) -> Dict:
    """Measured int8 error-feedback residual of a gradient tree.

    ``ef_residual_max`` is the largest absolute one-step quantization
    error any gradient element would incur on the int8 wire: the residual
    EF-SGD carries, and the quantity an error-feedback-aware numerics
    bound is derived from (``RunConfig.track_ef_residual`` exposes it as a
    per-step training metric)."""
    leaves = [int8_roundtrip_residual(g).abs().amax() for g in grads.values()]
    return {"ef_residual_max": torch.stack(leaves).amax()}


def _zero_metrics(cfg: ModelConfig, rcfg: RunConfig, device=None) -> Dict:
    def zero():
        return torch.zeros((), dtype=torch.float32, device=device)
    m = {"ce_loss": zero(), "loss": zero()}
    if rcfg.z_loss:
        m["z_loss"] = zero()
    if cfg.moe is not None:
        m.update({k: zero() for k in ("moe_lb_loss", "moe_z_loss",
                                      "moe_max_frac", "moe_drop_frac")})
    return m


def _pod_mean(metrics: Dict, group, pods: int) -> Dict:
    """Each metric averaged over the pod group: one small all-reduce
    outside the engine (GSPMD's mean in the reference, which costs no
    NQE)."""
    keys = sorted(metrics)
    stacked = torch.stack([metrics[k].float() for k in keys])
    dist.all_reduce(stacked, group=group)
    return dict(zip(keys, stacked / pods))


def make_train_step(cfg: ModelConfig, rcfg: RunConfig, mesh=None,
                    engine: Optional[CoreEngine] = None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics). ``mesh``: the
    ``MeshAxes`` of a ``torch.distributed`` world (None on one card);
    ``engine`` routes the pod sync (default: the native stack,
    ``make_engine(mesh, "xla")``)."""
    check_family(cfg)

    def plain_step(state, batch):
        grads, metrics = _grads(state["params"], batch, cfg, rcfg)
        if rcfg.track_ef_residual:
            metrics.update(ef_residual_metrics(grads))
        _, _, om = adamw_update(state["params"], grads, state["opt"], rcfg)
        metrics.update(om)
        state["step"] += 1
        return state, metrics

    if not (rcfg.explicit_pod_sync and mesh is not None and "pod" in mesh):
        return plain_step

    # --- NetKernel-owned cross-pod gradient sync ---
    pods = mesh["pod"]
    me = mesh.index("pod")
    group = mesh.group(("pod",))
    engine = engine if engine is not None else make_engine(mesh, "xla")

    def pod_step(state, batch):
        rows = {k: v.reshape((pods, v.shape[0] // pods) + v.shape[1:])[me]
                for k, v in batch.items()}
        grads, metrics = _grads(state["params"], rows, cfg, rcfg)
        with torch.no_grad():
            with use_engine(engine):
                grads = nk_grad_sync(grads, ("pod",))
            grads = {k: g / pods for k, g in grads.items()}
        metrics = _pod_mean(metrics, group, pods)
        if rcfg.track_ef_residual:
            # the residual of the *synced* gradients: what the int8 wire
            # would have cost this step had the compressed stack carried it
            metrics.update(ef_residual_metrics(grads))
        _, _, om = adamw_update(state["params"], grads, state["opt"], rcfg)
        metrics.update(om)
        state["step"] += 1
        return state, metrics

    return pod_step


def make_train_state(cfg: ModelConfig, rcfg: RunConfig, *,
                     model: Optional[Model] = None, seed: int = 0,
                     device=None, abstract: bool = False) -> Dict:
    """A fresh train state on ``device`` (``cuda`` unless ``"cpu"``): the
    given ``model``, or the port's ``init_params`` from ``seed``, or, with
    ``abstract``, an uninitialized model (the template a checkpoint
    restore fills in place); zero moments, count and step."""
    check_family(cfg)
    if model is None:
        dev = resolve_device(device)
        model = Model(cfg, device=dev) if abstract \
            else init_params(cfg, device=dev, seed=seed)
    _trainable(model)
    return {"params": model, "opt": init_opt_state(model, rcfg),
            "step": torch.zeros((), dtype=torch.int32, device=model.device)}
