"""Configuration system (port of ``repro/configs/base.py``).

``FluxConfig`` and ``ModelConfig`` are the JAX package's frozen
dataclasses with torch dtypes; ``register``/``get_config`` and
``smoke_variant`` keep their meaning. The port registers the archs
whose every layer is global attention, GQA or Multi-head Latent
Attention, with a dense or an MoE FFN (phi3-mini-3.8b, stablelm-12b,
command-r-plus-104b, granite-moe-3b-a800m, deepseek-v2-236b), the two
whose requests carry a modality side input: phi-3-vision-4.2b (prefix
embeddings) and whisper-tiny (an encoder over frame embeddings, and
cross attention in every decoder layer), the two with Mamba2 SSD
layers: mamba2-780m (every layer) and jamba-1.5-large-398b (seven of
every eight, beside one routed attention layer), and gemma3-12b, whose
five of every six layers attend over a sliding window: every arch of
the JAX package.
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

    Defaults follow Table 3 of the paper. ``block`` is the ``xa`` mode's
    selection granularity: its top-k picks key blocks of ``block``
    tokens, which the block-sparse kernel runs as ``block // 64`` of its
    64-token tiles (a block that is not a multiple of 64 runs only on the
    CPU). ``chunk`` is the ``ta`` mode's dense last chunk."""

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

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim if self.ssm_state_dim else 0

    def moe_layer_mask(self) -> Tuple[bool, ...]:
        if self.moe_layers == "all":
            return tuple(True for _ in range(self.num_layers))
        if self.moe_layers == "even":
            return tuple(i % 2 == 0 for i in range(self.num_layers))
        return tuple(False for _ in range(self.num_layers))

    def routable_layers(self) -> Tuple[int, ...]:
        """Indices of layers the Flux router controls (global attention)."""
        return tuple(i for i, k in enumerate(self.layer_kinds) if k == "attn")

    def param_count(self, active_only: bool = False) -> int:
        """The JAX package's count (embedding, per layer its attention or
        Mamba2 block, FFN or MoE, norms; the final norm, the routers and
        a Mamba block's A_log / dt_bias / D / norm are not counted).
        ``active_only`` counts the top-k and shared experts a token runs
        instead of every expert."""
        d = self.d_model
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        mask = self.moe_layer_mask()
        for i, kind in enumerate(self.layer_kinds):
            if kind in ("attn", "local"):
                if self.use_mla:
                    qr = self.q_lora_rank or d
                    qk_hd = self.qk_nope_head_dim + self.qk_rope_head_dim
                    n += d * qr + qr * self.num_heads * qk_hd  # q
                    n += d * (self.kv_lora_rank + self.qk_rope_head_dim)
                    n += self.kv_lora_rank * self.num_heads * (
                        self.qk_nope_head_dim + self.v_head_dim)
                    n += self.num_heads * self.v_head_dim * d  # o
                else:
                    n += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            elif kind == "mamba":
                inner, N = self.ssm_inner, self.ssm_state_dim
                # in_proj produces [z, x, B, C, dt]
                n += d * (2 * inner + 2 * N + self.ssm_num_heads)
                n += inner * d  # out_proj
                n += self.ssm_conv_width * (inner + 2 * N)  # conv taps
            if mask[i]:
                per_expert = 3 * d * self.moe_d_ff
                experts = (self.top_k if active_only else self.num_experts)
                n += d * self.num_experts  # gate
                n += per_expert * (experts + self.num_shared_experts)
            else:
                n += 3 * d * self.d_ff  # SwiGLU: gate, up, down
            n += 2 * d  # norms
        # encoder (whisper): self attention + FFN + 2 norms a layer; every
        # decoder layer adds cross attention (wq, wk, wv, wo) and its norm
        for _ in range(self.num_encoder_layers):
            n += 4 * d * self.q_dim + 3 * d * self.d_ff + 2 * d
        if self.num_encoder_layers:
            n += self.num_layers * (4 * d * self.q_dim + d)
        return n


# ---------------------------------------------------------------------------
# Registry + smoke variants
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ModelConfig] = {}

# arch name -> module registering it (the archs the port serves)
ARCH_MODULES = {
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini_3_8b",
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "command-r-plus-104b": "repro_torch.configs.command_r_plus_104b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "phi-3-vision-4.2b": "repro_torch.configs.phi_3_vision_4_2b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
    "gemma3-12b": "repro_torch.configs.gemma3_12b",
}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; the port serves the archs "
                       f"{sorted(ARCH_MODULES)}")
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
