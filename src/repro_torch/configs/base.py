"""Configuration system (port of ``repro/configs/base.py``).

``FluxConfig`` and ``ModelConfig`` are the JAX package's frozen
dataclasses with torch dtypes; ``register``/``get_config`` and
``smoke_variant`` keep their meaning. This slice of the port registers
phi3-mini-3.8b only; the other architectures come with the slices that
port their layer kinds (ROADMAP Queue 1 item 14).
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

import torch

# ---------------------------------------------------------------------------
# Flux Attention (the paper's technique) configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FluxConfig:
    """Configuration of the paper's layer-level FA/SA routing.

    Defaults follow Table 3 of the paper (``block`` is the JAX package's
    TPU tile and is not read by this port's kernels)."""

    enabled: bool = True
    # Sparse-layer attention mode: "ssa" (StreamingLLM sink+local),
    # "xa" (XAttention antidiagonal block-sparse), "ta" (Triangle).
    sa_mode: str = "ssa"
    # StreamingLLM-style geometry (paper: sink 128 / local 2048).
    sink: int = 128
    local: int = 2048
    block: int = 128
    chunk: int = 16384
    stride: int = 16
    threshold: float = 0.9
    # Router (paper §3.1 / App. D.1): prefix-suffix pooling over the
    # boundary ``pool_size`` tokens, Context-Encoder MLP, Router Head.
    pool_size: int = 100
    router_hidden: int = 128
    # Gumbel-Softmax temperature annealing (paper §3.1).
    tau_start: float = 5.0
    tau_end: float = 0.1
    # Target sparse budgets t (paper §4.1: holistic 1.0, retrieval 0.45).
    target_retrieval: float = 0.45
    target_holistic: float = 1.0
    num_task_types: int = 2

    def replace(self, **kw) -> "FluxConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

# Block kinds appearing in ``layer_pattern``:
#   "attn"   — global self attention (flux-routable)
#   "local"  — sliding-window self attention (already sparse; not routed)
#   "mamba"  — Mamba2 SSD block (attention-free; not routed)
ATTN_KINDS = ("attn", "local")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | audio | vlm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    layer_pattern: Tuple[str, ...] = ("attn",)
    moe_layers: str = "none"

    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25

    # --- MLA (DeepSeek-V2) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- SSM (Mamba2 SSD) ---
    ssm_state_dim: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # --- Sliding window (gemma local layers) ---
    sliding_window: int = 1024

    # --- Encoder-decoder (whisper backbone) ---
    num_encoder_layers: int = 0
    encoder_ctx: int = 0

    # --- VLM (phi-3-vision) ---
    num_prefix_tokens: int = 0

    # --- Common ---
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    causal_split_depth: int = 0
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.bfloat16

    flux: FluxConfig = field(default_factory=FluxConfig)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Block kind for every layer (pattern repeated)."""
        p = self.layer_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def moe_layer_mask(self) -> Tuple[bool, ...]:
        if self.moe_layers == "all":
            return tuple(True for _ in range(self.num_layers))
        if self.moe_layers == "even":
            return tuple(i % 2 == 0 for i in range(self.num_layers))
        return tuple(False for _ in range(self.num_layers))

    def routable_layers(self) -> Tuple[int, ...]:
        """Indices of layers the Flux router controls (global attention)."""
        return tuple(i for i, k in enumerate(self.layer_kinds) if k == "attn")

    def param_count(self) -> int:
        """Parameters of a dense GQA model (the kinds this slice runs)."""
        d = self.d_model
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = (d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
                     + 3 * d * self.d_ff + 2 * d)
        return n + self.num_layers * per_layer + d


# ---------------------------------------------------------------------------
# Registry + smoke variants
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ModelConfig] = {}

# arch name -> module registering it (the archs this slice serves)
ARCH_MODULES = {"phi3-mini-3.8b": "repro_torch.configs.phi3_mini_3_8b"}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; this port serves "
                       f"{sorted(ARCH_MODULES)} (the others wait for "
                       f"ROADMAP Queue 1 items 11-14)")
    importlib.import_module(ARCH_MODULES[name])
    return _REGISTRY[name]


def list_configs() -> Tuple[str, ...]:
    return tuple(sorted(ARCH_MODULES))


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant: 2 layers, d_model<=512, <=4 experts.

    The same reduction as the JAX package's ``smoke_variant``, so a
    smoke config means the same shapes in both packages."""
    num_layers = min(cfg.num_layers, 2 * len(cfg.layer_pattern))
    num_layers = min(num_layers, max(2, len(cfg.layer_pattern)))
    d_model = min(cfg.d_model, 256)
    head_dim = 32
    num_heads = 4
    num_kv_heads = (min(cfg.num_kv_heads, 2)
                    if cfg.num_kv_heads < cfg.num_heads else 4)
    kw: Dict[str, Any] = dict(
        num_layers=num_layers,
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv_heads,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 512) or 0,
        vocab_size=min(cfg.vocab_size, 512),
        dtype=torch.float32,
        param_dtype=torch.float32,
        flux=cfg.flux.replace(
            sink=8, local=32, block=16, chunk=64, pool_size=8,
            router_hidden=16, stride=4),
        sliding_window=16,
    )
    if cfg.num_experts:
        kw.update(num_experts=min(cfg.num_experts, 4),
                  top_k=min(cfg.top_k, 2),
                  num_shared_experts=min(cfg.num_shared_experts, 1),
                  moe_d_ff=min(cfg.moe_d_ff, 128),
                  moe_capacity_factor=float(min(cfg.num_experts, 4)))
    if cfg.use_mla:
        kw.update(q_lora_rank=64, kv_lora_rank=32,
                  qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32)
    if cfg.ssm_state_dim:
        kw.update(ssm_state_dim=16, ssm_head_dim=32, ssm_chunk=16)
    if cfg.num_encoder_layers:
        kw.update(num_encoder_layers=2, encoder_ctx=16)
    if cfg.num_prefix_tokens:
        kw.update(num_prefix_tokens=8)
    return cfg.replace(**kw)
