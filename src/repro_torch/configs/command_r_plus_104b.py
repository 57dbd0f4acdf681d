"""command-r-plus-104b — dense GQA, no-bias.

[hf:CohereForAI/c4ai-command-r-v01] (scaled family config as assigned):
64L, d_model=12288, 96 heads (GQA kv=8), d_ff=33792, vocab=256000.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab_size=256000,
    rope_theta=75_000_000.0,
    tie_embeddings=True,  # command-r ties input/output embeddings
))
