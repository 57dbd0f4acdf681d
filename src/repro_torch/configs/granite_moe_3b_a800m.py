"""granite-moe-3b-a800m — MoE.

[hf:ibm-granite/granite-3.0 family]: 32L, d_model=1536, 24 heads
(GQA kv=8), 40 experts top-8, expert d_ff=512, vocab=49155.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    moe_layers="all",
    num_experts=40,
    top_k=8,
    moe_d_ff=512,
    tie_embeddings=True,
))
