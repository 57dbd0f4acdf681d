"""jamba-1.5-large-398b — hybrid Mamba + attention (1:7) with MoE.

[arXiv:2403.19887]: 72L, d_model=8192, 64 heads (GQA kv=8), d_ff=24576,
MoE 16 experts top-2 (every second layer), vocab=65536. Attention
appears once per 8-layer period (index 3, Jamba's published layout);
Flux routes those 9 attention layers.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    layer_pattern=("mamba", "mamba", "mamba", "attn",
                   "mamba", "mamba", "mamba", "mamba"),
    moe_layers="even",
    num_experts=16,
    top_k=2,
    moe_d_ff=24576,
    ssm_state_dim=128,
    ssm_head_dim=64,
    ssm_expand=2,
))
