"""Config system: architecture + shape + run configuration.

A copy of the reference package's configs, kept in the port so that it
imports nothing of the reference; ``tests/test_torch_isolation.py`` holds
the two equal.

Every assigned architecture is a frozen ``ModelConfig`` built in its own
module (``repro_torch/configs/<arch>.py``) with the exact published dimensions.
Shapes (seq_len x global_batch cells) live here; the registry in
``repro_torch/configs/__init__.py`` exposes ``get_config(name)`` / ``get_shape``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration."""

    num_experts: int
    top_k: int
    expert_ff: int
    num_shared_experts: int = 0      # deepseek-v2: 2 shared experts
    shared_ff: int = 0               # hidden dim of each shared expert
    capacity_factor: float = 1.25
    router_zloss: float = 1e-3
    # dense residual branch computed in parallel with the MoE branch (arctic)
    parallel_dense: bool = False


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block configuration."""

    state_dim: int            # N
    head_dim: int = 64        # P
    expand: int = 2           # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 256          # SSD chunk length
    dt_min: float = 0.001
    dt_max: float = 0.1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0          # 0 => full-rank q projection
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0                # 0 => d_model // num_heads
    activation: str = "silu_glu"     # silu_glu | relu2 | gelu
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    rope_theta: float = 500000.0
    qk_norm: bool = False            # chameleon uses qk layernorm
    tie_embeddings: bool = True
    logit_softcap: float = 0.0

    # --- MoE ---
    moe: Optional[MoEConfig] = None
    # layer indices that use a plain dense FFN instead of MoE (deepseek: (0,))
    dense_layer_prefix: int = 0
    dense_prefix_ff: int = 0         # d_ff of the dense prefix layers

    # --- SSM / hybrid ---
    ssm: Optional[SSMConfig] = None
    # hybrid (hymba): per-layer attention windows; layers listed here use
    # full/global attention, all others use sliding-window attention.
    attn_window: int = 0             # 0 => full causal attention
    global_attn_layers: Tuple[int, ...] = ()

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0             # fixed source length (1500 audio frames)
    frontend: str = "none"           # none | audio_stub | token

    # --- numerics ---
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))

    # --- derived quantities -------------------------------------------------
    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k cell (per assignment instructions)."""
        return self.family in ("ssm", "hybrid")

    @property
    def mla(self) -> Optional[MLAConfig]:
        return MLA_BY_NAME.get(self.name)

    def attn_params_per_layer(self) -> int:
        d, h, kv, hd = self.d_model, self.num_heads, self.num_kv_heads, self.head_dim
        mla = self.mla
        if mla is not None:
            qk_hd = mla.qk_nope_head_dim + mla.qk_rope_head_dim
            p = d * h * qk_hd                                   # q proj
            p += d * (mla.kv_lora_rank + mla.qk_rope_head_dim)  # down proj
            p += mla.kv_lora_rank * h * (mla.qk_nope_head_dim + mla.v_head_dim)
            p += h * mla.v_head_dim * d                         # out proj
            return p
        return d * h * hd + 2 * d * kv * hd + h * hd * d

    def ffn_params_per_layer(self) -> int:
        if self.moe is not None:
            m = self.moe
            e = m.num_experts * self._expert_ffn(m.expert_ff)
            e += m.num_shared_experts * self._expert_ffn(m.shared_ff or m.expert_ff)
            e += self.d_model * m.num_experts                    # router
            if m.parallel_dense:
                e += self._expert_ffn(self.d_ff)
            return e
        if self.d_ff == 0:
            return 0
        return self._expert_ffn(self.d_ff)

    def _expert_ffn(self, ff: int) -> int:
        mult = 3 if self.activation == "silu_glu" else 2
        return mult * self.d_model * ff

    def ssm_params_per_layer(self) -> int:
        if self.ssm is None:
            return 0
        s = self.ssm
        di = s.d_inner(self.d_model)
        nh = s.num_heads(self.d_model)
        # in_proj produces (x, z, B, C, dt); out_proj back to d_model
        p = self.d_model * (2 * di + 2 * s.state_dim + nh)
        p += di * self.d_model
        p += s.conv_width * (di + 2 * s.state_dim)   # depthwise conv
        p += 2 * nh                                   # A_log, D
        return p

    def ffn_active_params_per_layer(self) -> int:
        if self.moe is None:
            return self.ffn_params_per_layer()
        m = self.moe
        a = m.top_k * self._expert_ffn(m.expert_ff)
        a += m.num_shared_experts * self._expert_ffn(m.shared_ff or m.expert_ff)
        a += self.d_model * m.num_experts
        if m.parallel_dense:
            a += self._expert_ffn(self.d_ff)
        return a

    def _layer_params(self, active: bool) -> int:
        ffn = self.ffn_active_params_per_layer() if active else self.ffn_params_per_layer()
        if self.family == "ssm":
            return self.ssm_params_per_layer() + 2 * self.d_model
        per = ffn + 2 * self.d_model
        if self.family == "hybrid":
            per += self.attn_params_per_layer() + self.ssm_params_per_layer()
        else:
            per += self.attn_params_per_layer()
        return per

    def num_params(self) -> int:
        """Total parameter count (analytic)."""
        n = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        body = 0
        for i in range(self.num_layers):
            if self.moe is not None and i < self.dense_layer_prefix:
                dense = ModelConfig(
                    name="_tmp", family="dense", num_layers=1, d_model=self.d_model,
                    num_heads=self.num_heads, num_kv_heads=self.num_kv_heads,
                    d_ff=self.dense_prefix_ff or self.d_ff, vocab_size=1,
                    activation=self.activation)
                body += dense._layer_params(False) + self.attn_params_per_layer() - dense.attn_params_per_layer()
                continue
            body += self._layer_params(False)
        n += body + self.d_model
        if self.encoder_layers:
            enc_layer = self.attn_params_per_layer() + self._expert_ffn(self.d_ff) + 2 * self.d_model
            cross = self.attn_params_per_layer()
            n += self.encoder_layers * enc_layer + self.num_layers * cross
        return n

    def num_active_params(self) -> int:
        """Active parameters per token (= num_params for non-MoE)."""
        if self.moe is None:
            return self.num_params()
        n = self.num_params()
        n -= self.num_layers_moe() * (self.ffn_params_per_layer() - self.ffn_active_params_per_layer())
        return n

    def num_layers_moe(self) -> int:
        return 0 if self.moe is None else self.num_layers - self.dense_layer_prefix


# MLA is attached per-arch here (keeps ModelConfig generic/flat).
MLA_BY_NAME = {
    "deepseek-v2-236b": MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                                  v_head_dim=128),
    "deepseek-v2-smoke": MLAConfig(kv_lora_rank=32, q_lora_rank=0,
                                   qk_nope_head_dim=16, qk_rope_head_dim=8,
                                   v_head_dim=16),
}


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch x shape) cell is runnable, and why not if skipped."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k requires sub-quadratic attention (skip per assignment)"
    return True, ""


# ---------------------------------------------------------------------------
# Run config (training/serving knobs; the operator-owned side)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RunConfig:
    """Operator-owned knobs: parallelism, NSM policy, numerics, FT."""

    # parallelism
    multi_pod: bool = False
    fsdp: bool = True                       # shard params/opt over 'data'
    seq_parallel_activations: bool = False  # Megatron-SP between blocks
    pipeline_stages: int = 1                # >1: GPipe over 'pod'
    grad_accum: int = 1

    # NetKernel stack policy (the paper's contribution surface)
    nsm_policy: str = "xla"       # xla | ring | hierarchical | compressed | shm-first
    explicit_pod_sync: bool = False  # route cross-pod grad sync through CoreEngine
    # track the int8 error-feedback residual of the gradients each step
    # (metrics["ef_residual_max"]) — the measured signal an EF-aware
    # numerics tolerance derives from (see test_nsm_conformance.py)
    track_ef_residual: bool = False

    # numerics / memory
    remat: str = "full"           # full | dots | none
    rules_variant: str = "2d"     # 2d (FSDP+TP) | fsdp (pure FSDP over mesh)
    grad_accum_dtype: str = "float32"   # float32 | bfloat16 (>=300B models)
    factored_nu: bool = False     # Adafactor-style second moment (>=300B)
    # roofline probes: unroll scanned segments so XLA cost_analysis (which
    # counts a while body once) attributes per-layer cost exactly
    force_unroll_segments: bool = False
    moment_dtype: str = "float32"  # float32 | bfloat16 (>=100B models)
    kv_cache_dtype: str = "bfloat16"  # bfloat16 | int8
    attention_impl: str = "chunked"   # naive = plain torch; else the kernels
    attn_q_block: int = 512
    attn_kv_block: int = 512

    # optimizer
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    z_loss: float = 1e-4

    # fault tolerance
    checkpoint_every: int = 50
    keep_checkpoints: int = 3
    async_checkpoint: bool = True
    straggler_factor: float = 3.0


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Family-preserving reduction for CPU smoke tests (tiny dims)."""
    kw: dict = dict(
        name=cfg.name + "-smoke",
        num_layers=min(cfg.num_layers, 2 + (cfg.dense_layer_prefix or 0)),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=256,
        head_dim=16,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2), expert_ff=64,
            shared_ff=64 if cfg.moe.num_shared_experts else 0)
        kw["dense_prefix_ff"] = 128 if cfg.dense_layer_prefix else 0
        if cfg.dense_layer_prefix:
            kw["num_layers"] = max(kw["num_layers"], cfg.dense_layer_prefix + 2)
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, state_dim=16, head_dim=16, chunk=32)
    if cfg.global_attn_layers:
        kw["global_attn_layers"] = (0,)
        kw["attn_window"] = 32
    if cfg.encoder_layers:
        kw["encoder_layers"] = 2
        kw["encoder_seq"] = 24
    if cfg.name == "deepseek-v2-236b":
        kw["name"] = "deepseek-v2-smoke"   # picks up the smoke MLA config
    return dataclasses.replace(cfg, **kw)
