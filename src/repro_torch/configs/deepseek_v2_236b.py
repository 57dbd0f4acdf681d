"""deepseek-v2-236b — MoE with Multi-head Latent Attention (MLA).

[arXiv:2405.04434]: 60L, d_model=5120, 128 heads, MLA kv_lora=512,
MoE: 2 shared + 160 routed experts, top-6, expert d_ff=1536,
vocab=102400.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,  # MLA decompresses to per-head K/V
    head_dim=128,
    d_ff=12288,        # (dense FFN would be 12288; all layers are MoE here)
    vocab_size=102400,
    moe_layers="all",
    num_experts=160,
    num_shared_experts=2,
    top_k=6,
    moe_d_ff=1536,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_theta=10000.0,
))
