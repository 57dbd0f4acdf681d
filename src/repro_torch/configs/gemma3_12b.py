"""gemma3-12b — dense with 5:1 local:global attention interleave, 128k.

[hf:google/gemma-3 family]: 48L, d_model=3840, 16 heads (GQA kv=8),
d_ff=15360, vocab=262144. Local layers use a 1024-token sliding window
(the streaming kernel with no sink, a ring of 1024 slots); the Flux
router controls the 1-in-6 global layers only (local layers are already
sparse).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    layer_pattern=("local", "local", "local", "local", "local", "attn"),
    sliding_window=1024,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
))
