"""Roofline terms for the port on an NVIDIA H100 80GB HBM3.

The counterpart of ``repro/launch/roofline.py``. Three terms per (arch x
shape x mesh) cell:

  compute term    = FLOPs_per_chip / PEAK_FLOPS
  memory term     = HBM_bytes_per_chip / HBM_BW
  collective term = collective_payload_bytes_per_chip / ICI_BW

and the floor ``t_ideal``: the better of the compute and memory walls for
the useful work (``model_flops``, ``ideal_bytes``). The formulas are the
reference's. What differs is where the counts come from: the reference
reads executed FLOPs and HBM bytes off compiled HLO, which the port does
not have. ``RooflineCell`` therefore takes ``None`` for a count nobody
measured, every property that needs it returns ``None``, and
``markdown_table`` prints it as ``-``. No count is derived from the ideal
and shown as if it were executed. The collective term's bytes come from a
``CoreEngine``'s ledger (``ledger_collective_bytes``), which counts every
collective of a sharded step as it is issued.

The constants are the H100 SXM5 80GB HBM3 datasheet's peaks, not
measurements: dense bf16 tensor-core FLOP/s (989e12), f32 and f64 (67e12,
34e12; non-tensor), dense TF32 tensor-core FLOP/s (495e12), HBM3
bandwidth (3.35e12 B/s) and capacity (80 GB). An f32-accurate product
that runs on the tensor cores as three TF32 products (the f32 flash
kernel) does three TF32 operations for each of its own:
``PEAK_FLOPS_F32_TENSOR``, a third of the TF32 rate, is its peak.
``ICI_BW`` is NVLink 4's 450e9 B/s per direction (900e9 both ways over 18
links): unmeasured, since one card has no link to measure.
``chip_smoke.py`` takes its bounds from here and prints
``torch.cuda.get_device_properties(0).total_memory`` beside ``HBM_BYTES``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

# --- hardware constants (NVIDIA H100 80GB HBM3, per card; datasheet) ---
PEAK_FLOPS_BY_DTYPE = {"bfloat16": 989e12, "float32": 67e12,
                       "float64": 34e12}
PEAK_FLOPS = PEAK_FLOPS_BY_DTYPE["bfloat16"]
PEAK_FLOPS_TF32 = 495e12     # dense TF32 on the tensor cores
# f32 products as a_hi b_hi + a_hi b_lo + a_lo b_hi in TF32: ~165e12
PEAK_FLOPS_F32_TENSOR = PEAK_FLOPS_TF32 / 3
HBM_BW = 3.35e12             # bytes/s
ICI_BW = 450e9               # bytes/s, NVLink 4 per direction (unmeasured)
HBM_BYTES = 80 * 10 ** 9     # 80 GB

# the ledger's verbs (core/collectives.py's nk_*) in the reference's kind
# names; nk_grad_sync is a psum per leaf
LEDGER_KINDS = {"psum": "all-reduce", "all_gather": "all-gather",
                "reduce_scatter": "reduce-scatter",
                "all_to_all": "all-to-all", "ppermute": "collective-permute"}
# verbs that move nothing over a link (shm_move hands a buffer over)
LEDGER_LOCAL = ("shm_move",)


def bound_ms(nbytes: float, flops: float, dtype: str,
             peak: Optional[float] = None) -> Tuple[float, str]:
    """(least milliseconds, what binds) for work that moves ``nbytes`` and
    does ``flops`` at ``dtype``: the larger of the bytes over ``HBM_BW``
    and the operations over the peak for ``dtype`` (``peak``, where the
    work runs at another rate than its dtype's, e.g.
    ``PEAK_FLOPS_F32_TENSOR``)."""
    t_bytes = nbytes / HBM_BW
    t_ops = flops / (peak or PEAK_FLOPS_BY_DTYPE[dtype])
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Collective and HBM counts
# ---------------------------------------------------------------------------

_NO_HLO = ("the port compiles no HLO: its steps run eagerly. Take a "
           "sharded step's collective bytes from its CoreEngine's ledger "
           "(ledger_collective_bytes)")


def parse_hlo_collectives(hlo_text: str):
    """The reference walks compiled HLO text for its collectives."""
    raise NotImplementedError(f"parse_hlo_collectives: {_NO_HLO}")


def collective_bytes(hlo_text: str):
    """The reference's per-chip collective payload from compiled HLO."""
    raise NotImplementedError(f"collective_bytes: {_NO_HLO}")


def hlo_traffic_bytes(hlo_text: str):
    """The reference's post-fusion HBM traffic from compiled HLO."""
    raise NotImplementedError(
        "hlo_traffic_bytes: the port compiles no HLO, and nothing counts "
        "the HBM bytes an eager step moves; a cell's hbm_bytes_per_chip "
        "stays None")


def ledger_collective_bytes(engine, since=None) -> Tuple[int, Dict[str, int]]:
    """``(total, by_kind)``: the collective payload bytes of one rank, from
    its ``CoreEngine``'s ledger (or the rows of its ``ledger_table()``),
    less an earlier ``ledger_table()`` ``since``; kinds in the
    reference's names (``LEDGER_KINDS``). A payload is the operand's
    bytes on the rank as the ledger counts it; the reference's HLO walk
    counts an all-gather's result, which is the axis size times more."""
    rows = engine.ledger_table() if hasattr(engine, "ledger_table") \
        else engine
    before = {(t, v, a): b for t, v, a, _, b in (since or ())}
    by_kind: Dict[str, int] = {}
    for t, verb, axes, _ops, nbytes in rows:
        if verb in LEDGER_LOCAL:
            continue
        if verb not in LEDGER_KINDS:
            raise ValueError(f"ledger verb {verb!r} has no collective kind")
        kind = LEDGER_KINDS[verb]
        moved = nbytes - before.get((t, verb, axes), 0)
        if moved:
            by_kind[kind] = by_kind.get(kind, 0) + moved
    return sum(by_kind.values()), by_kind


# ---------------------------------------------------------------------------
# Roofline assembly
# ---------------------------------------------------------------------------


def _div(a: Optional[float], b: float) -> Optional[float]:
    return None if a is None else a / b


@dataclass
class RooflineCell:
    """One cell's terms. ``flops_per_chip``, ``hbm_bytes_per_chip`` and
    ``coll_bytes_per_chip`` are ``None`` where nothing measured them; the
    properties that need one return ``None``."""

    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: Optional[float]
    hbm_bytes_per_chip: Optional[float]
    coll_bytes_per_chip: Optional[float]
    coll_by_kind: Dict[str, int]
    model_flops_global: float
    memory_per_chip_gb: Optional[float]
    compile_seconds: float
    ideal_bytes_global: float = 0.0
    skipped: bool = False
    skip_reason: str = ""
    notes: str = ""

    @property
    def t_compute(self) -> Optional[float]:
        return _div(self.flops_per_chip, PEAK_FLOPS)

    @property
    def t_memory(self) -> Optional[float]:
        return _div(self.hbm_bytes_per_chip, HBM_BW)

    @property
    def t_collective(self) -> Optional[float]:
        return _div(self.coll_bytes_per_chip, ICI_BW)

    def _terms(self) -> Optional[Dict[str, float]]:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return None if None in terms.values() else terms

    @property
    def dominant(self) -> Optional[str]:
        terms = self._terms()
        return None if terms is None else max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> Optional[float]:
        if self.flops_per_chip is None:
            return None
        executed = self.flops_per_chip * self.chips
        return self.model_flops_global / executed if executed else 0.0

    @property
    def t_ideal(self) -> float:
        """Roofline floor: the better of the compute and memory walls for
        the *useful* work (model FLOPs / minimal bytes)."""
        return max(self.model_flops_global / (self.chips * PEAK_FLOPS),
                   self.ideal_bytes_global / (self.chips * HBM_BW))

    @property
    def roofline_fraction(self) -> Optional[float]:
        """t_ideal / modeled step time (max of the three terms, perfect
        overlap assumed)."""
        terms = self._terms()
        if terms is None:
            return None
        t = max(terms.values())
        if t <= 0:
            return 0.0
        return min(self.t_ideal / t, 1.0)

    def to_json(self) -> Dict:
        d = dataclasses.asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, dominant=self.dominant,
                 useful_ratio=self.useful_ratio, t_ideal=self.t_ideal,
                 roofline_fraction=self.roofline_fraction)
        return d


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6*N_active*D (train), 2*N_active*D (prefill),
    2*N_active*B (decode, per step)."""
    n = cfg.num_active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


def cache_bytes_global(cfg, shape, dtype_bytes: int = 2) -> float:
    """Decode-cell KV/state cache size (the floor of decode HBM traffic)."""
    b, s = shape.global_batch, shape.seq_len
    total = 0.0
    mla = cfg.mla
    for i in range(cfg.num_layers):
        window = 0
        if cfg.attn_window and i not in cfg.global_attn_layers:
            window = cfg.attn_window
        n_slots = min(s, window) if window else s
        if cfg.family == "ssm":
            pass
        elif mla is not None:
            total += b * n_slots * (mla.kv_lora_rank + mla.qk_rope_head_dim) \
                * dtype_bytes
        elif cfg.family in ("dense", "moe", "vlm", "encdec", "hybrid"):
            total += 2 * b * n_slots * cfg.num_kv_heads * cfg.head_dim \
                * dtype_bytes
        if cfg.ssm is not None:
            ss = cfg.ssm
            total += b * ss.num_heads(cfg.d_model) * ss.head_dim \
                * ss.state_dim * 4
    return total


def ideal_bytes(cfg, shape) -> float:
    """Global minimal HBM traffic per step (documented floor, not a bound
    proof): weights read fwd(+remat+bwd for train), optimizer state r/w,
    a small per-layer activation budget, plus the full cache for decode."""
    n = cfg.num_active_params()
    n_tot = cfg.num_params()
    b, s = shape.global_batch, shape.seq_len
    act = 6.0 * b * s * cfg.d_model * 2 * cfg.num_layers
    if shape.kind == "train":
        return 3 * 2 * n + 10 * n_tot + act     # weights x3, opt state r/w
    if shape.kind == "prefill":
        return 2 * n + act + cache_bytes_global(cfg, shape)
    act = 6.0 * b * 1 * cfg.d_model * 2 * cfg.num_layers
    return 2 * n + act + cache_bytes_global(cfg, shape)


def fmt_seconds(s: Optional[float]) -> str:
    if s is None:
        return "-"
    if s >= 1:
        return f"{s:.2f}s"
    if s >= 1e-3:
        return f"{s * 1e3:.2f}ms"
    return f"{s * 1e6:.1f}us"


def _fmt(v, spec: str, bold: bool = False) -> str:
    if v is None:
        return "-"
    out = format(v, spec)
    return f"**{out}**" if bold else out


def markdown_table(cells: List[RooflineCell]) -> str:
    hdr = ("| arch | shape | mesh | dominant | t_compute | t_memory | "
           "t_collective | useful | roofline | mem/chip |\n"
           "|---|---|---|---|---|---|---|---|---|---|\n")
    rows = []
    for c in cells:
        if c.skipped:
            rows.append(f"| {c.arch} | {c.shape} | {c.mesh} | SKIP | - | - | "
                        f"- | - | - | - |")
            continue
        mem = "-" if c.memory_per_chip_gb is None \
            else f"{c.memory_per_chip_gb:.2f} GB"
        rows.append(
            f"| {c.arch} | {c.shape} | {c.mesh} | "
            f"{_fmt(c.dominant, 's', bold=True)} | "
            f"{fmt_seconds(c.t_compute)} | {fmt_seconds(c.t_memory)} | "
            f"{fmt_seconds(c.t_collective)} | {_fmt(c.useful_ratio, '.2f')} | "
            f"{_fmt(c.roofline_fraction, '.2%')} | {mem} |")
    return hdr + "\n".join(rows)
