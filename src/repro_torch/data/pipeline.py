"""Deterministic synthetic LM data: the counterpart of ``repro/data/pipeline.py``.

Generation is a pure function of (seed, step), so a restart replays the
same batches bit for bit (the fault-tolerance tests rely on it). The
generator is the reference's numpy code, copied as it is: a mixture of
Zipfian unigrams and shifted-copy spans, which gives a learnable signal.
``batch_at`` hands the arrays to the pipeline's device as int32 tokens and
labels (and f32 ``frames`` for an encoder model).

On a mesh (``shardings``, the train step's input layout from
``train.batch_shardings``) ``batch_at`` returns this rank's block of the
global batch, the block the reference's ``make_array_from_callback``
gives the rank's device: still a pure function of (seed, step).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    copy_span: int = 8      # learnable structure: token[t] = token[t-span]
    copy_prob: float = 0.7
    with_frames: bool = False
    encoder_seq: int = 0
    d_model: int = 0


def _batch_np(dcfg: DataConfig, step: int, lo: int, hi: int) -> Dict[str, np.ndarray]:
    """Rows [lo, hi) of the global batch for ``step``. Pure in (seed, step)."""
    rng = np.random.default_rng(
        np.random.SeedSequence([dcfg.seed, step, 0x5EED]))
    b = dcfg.global_batch
    zipf = rng.zipf(1.3, size=(b, dcfg.seq_len)).astype(np.int64)
    tokens = (zipf % (dcfg.vocab_size - 1)) + 1
    span = dcfg.copy_span
    copy_mask = rng.random((b, dcfg.seq_len)) < dcfg.copy_prob
    for t in range(span, dcfg.seq_len):
        tokens[:, t] = np.where(copy_mask[:, t], tokens[:, t - span],
                                tokens[:, t])
    tokens = tokens.astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = 0
    out = {"tokens": tokens[lo:hi], "labels": labels[lo:hi]}
    if dcfg.with_frames:
        out["frames"] = rng.standard_normal(
            (hi - lo, dcfg.encoder_seq, dcfg.d_model)).astype(np.float32) * 0.05
    return out


class DataPipeline:
    """Restartable batch source on one device (``cuda`` unless ``"cpu"``
    is passed). ``shardings``: a ``NamedSharding`` for each input (the
    ``Runner`` sets it, and ``mesh``, from ``batch_shardings``)."""

    def __init__(self, dcfg: DataConfig, mesh=None,
                 shardings: Optional[Dict] = None, *, device=None):
        self.dcfg = dcfg
        self.mesh = mesh
        self.shardings = shardings
        self.device = resolve_device(device)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        d = self.dcfg
        arrs = _batch_np(d, step, 0, d.global_batch)
        if self.shardings is not None:
            arrs = {k: v[self.shardings[k].block(v.shape)]
                    for k, v in arrs.items()}
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in arrs.items()}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def for_model(cfg, shape, mesh=None, shardings=None, *, seed: int = 0,
              device=None) -> DataPipeline:
    return DataPipeline(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
                   global_batch=shape.global_batch, seed=seed,
                   with_frames=bool(cfg.encoder_layers),
                   encoder_seq=cfg.encoder_seq, d_model=cfg.d_model),
        mesh, shardings, device=device)
