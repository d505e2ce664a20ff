"""Config dataclasses: model architecture, input shapes, runtime execution.

Every assigned architecture is a ``ModelConfig`` instance in its own module
(``src/repro_torch/configs/<id>.py``, a copy of the JAX package's); the registry in ``__init__`` maps
``--arch`` ids to configs.  ``reduced()`` derives the CPU-smoke variant of
any config (same family and wiring, tiny dims).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm", "cnn"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int | None = None          # default d_model // n_heads
    norm: str = "rms"                  # 'rms' | 'layer'
    act: str = "silu"                  # 'silu' | 'gelu' | 'squared_relu'
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1e4
    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_layer_period: int = 1          # MoE every k-th layer (1 = all)
    shared_expert_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- SSM (mamba2) --------------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    # --- hybrid --------------------------------------------------------------
    attn_layer_period: int = 0         # zamba2: shared attn every k layers
    # --- modality ------------------------------------------------------------
    is_encoder: bool = False
    frontend: str | None = None        # 'audio_frames' | 'vision_patches'
    n_prefix_tokens: int = 0           # vlm: image patches prepended
    frontend_dim: int = 0              # stub embedding dim fed by input_specs
    # --- numerics ------------------------------------------------------------
    dtype: str = "bfloat16"
    source: str = ""                   # provenance note ([arXiv/hf; tier])

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_decode(self) -> bool:
        return not self.is_encoder

    @property
    def subquadratic(self) -> bool:
        """Archs allowed to run the long_500k cell (assignment rule)."""
        return self.family in ("ssm", "hybrid")

    def n_params(self) -> int:
        """Analytic parameter count (used for 6·N·D roofline bookkeeping)."""
        return _count_params(self, active_only=False)

    def n_active_params(self) -> int:
        return _count_params(self, active_only=True)

    def reduced(self) -> "ModelConfig":
        """CPU-smoke variant: same family/wiring, tiny dims."""
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 4 if self.attn_layer_period == 0
                         else 2 * max(self.attn_layer_period, 2)),
            d_model=128,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_head=32,
            d_ff=max(64, min(self.d_ff, 256)),
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            shared_expert_ff=128 if self.shared_expert_ff else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            n_prefix_tokens=8 if self.n_prefix_tokens else 0,
            frontend_dim=64 if self.frontend_dim else 0,
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                          # 'train' | 'prefill' | 'decode'

    def reduced(self) -> "ShapeConfig":
        return dataclasses.replace(self, name=self.name + "-reduced",
                                   seq_len=min(self.seq_len, 64),
                                   global_batch=min(self.global_batch, 2))


LM_SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> dict[str, ShapeConfig]:
    """Shape cells this arch runs, applying the assignment's skip rules:
    encoder-only archs skip decode shapes; pure full-attention archs skip
    long_500k (sub-quadratic archs run it)."""
    out = {}
    for name, sh in LM_SHAPES.items():
        if sh.kind == "decode" and not cfg.supports_decode:
            continue
        if name == "long_500k" and not cfg.subquadratic:
            continue
        if cfg.is_encoder and sh.kind == "decode":
            continue
        out[name] = sh
    return out


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Execution knobs threaded through model apply functions: the fields
    of the JAX package's ``RuntimeConfig`` that the ported serving and
    training paths read, with the same defaults."""
    mode: str = "xla"                  # 'brainslug' | 'xla' | 'barrier'
    remat: str = "none"                # 'none' | 'full' ('dots' comes later)
    # --- serving KV-cache layout ------------------------------------------
    # 'dense'  — every batch slot reserves max_len contiguous KV columns
    # 'paged'  — a fixed pool of kv_block_size-token blocks addressed
    #            through per-slot block tables (prefix sharing + COW); the
    #            continuous-batching engine allocates blocks on demand
    kv_layout: str = "dense"           # 'dense' | 'paged'
    kv_block_size: int = 16            # tokens per KV block (paged layout)
    ssd_chunk: int = 64                # SSD (mamba2) chunk length
    decode_block_k: int = 512
    attn_block_q: int = 128
    attn_block_k: int = 128
    fused_loss_chunk: int = 0          # 0 = unchunked vocab loss
    attn_impl: str = "auto"            # 'auto' | 'skip_core' (cost probes:
                                       # bypass the quadratic core so the
                                       # attention share of a block's cost
                                       # can be measured by differencing)

    def __post_init__(self) -> None:
        if self.mode not in ("brainslug", "xla", "barrier"):
            raise ValueError(f"mode must be brainslug, xla or barrier, got "
                             f"{self.mode!r}")
        if self.remat not in ("none", "dots", "full"):
            raise ValueError(f"remat must be none, dots or full, got "
                             f"{self.remat!r}")
        if self.kv_layout not in ("dense", "paged"):
            raise ValueError(f"unknown kv_layout {self.kv_layout!r}; "
                             f"allowed: 'dense' | 'paged'")
        if self.kv_block_size < 1:
            raise ValueError(f"kv_block_size must be >= 1, got "
                             f"{self.kv_block_size}")
        if self.ssd_chunk < 1:
            raise ValueError(f"ssd_chunk must be >= 1, got {self.ssd_chunk}")


def _count_params(cfg: ModelConfig, active_only: bool) -> int:
    d = cfg.d_model
    total = cfg.vocab_size * d                              # embed
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * d                         # lm head
    hd = cfg.head_dim
    attn = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd \
        + cfg.n_heads * hd * d
    dense_mlp = 3 * d * cfg.d_ff
    moe_mlp = 0
    if cfg.n_experts:
        per_expert = 3 * d * cfg.d_ff
        n_used = cfg.top_k if active_only else cfg.n_experts
        moe_mlp = n_used * per_expert + d * cfg.n_experts   # + router
        if cfg.shared_expert_ff:
            moe_mlp += 3 * d * cfg.shared_expert_ff
    ssm = 0
    if cfg.ssm_state:
        di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        ssm = d * (2 * di + 2 * n + h) + di * d \
            + cfg.ssm_conv_width * (di + 2 * n) + 3 * h
    hybrid_shared_counted = False
    for i in range(cfg.n_layers):
        if cfg.family == "ssm":
            total += ssm + d                                # + norm
        elif cfg.family == "hybrid":
            is_attn = (cfg.attn_layer_period
                       and (i + 1) % cfg.attn_layer_period == 0)
            if is_attn:
                # zamba2 SHARES one attention block across applications:
                # params counted once, FLOPs counted per application.
                if not hybrid_shared_counted and not active_only:
                    total += attn + dense_mlp + 2 * d
                    hybrid_shared_counted = True
                elif active_only:
                    total += attn + dense_mlp + 2 * d
            else:
                total += ssm + 2 * d
        elif cfg.n_experts and (i % cfg.moe_layer_period
                                == cfg.moe_layer_period - 1):
            total += attn + moe_mlp + 2 * d
        else:
            total += attn + dense_mlp + 2 * d
    return total
