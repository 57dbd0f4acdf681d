"""mamba2-780m — attention-free SSM with SSD (state-space duality).

[arXiv:2405.21060]: 48L, d_model=1536, ssm_state=128, vocab=50280.
Flux routing does not apply (no attention layer), so the model runs with
flux disabled and every admission prefills "fa_only".
"""
from repro_torch.configs.base import FluxConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,  # mamba2 blocks have no separate FFN
    vocab_size=50280,
    layer_pattern=("mamba",),
    ssm_state_dim=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    tie_embeddings=True,
    flux=FluxConfig(enabled=False),
))
