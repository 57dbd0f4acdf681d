"""phi-3-vision-4.2b — phi3-mini backbone + CLIP vision frontend (stub).

[hf:microsoft/Phi-3-vision-128k-instruct]: 32L, d_model=3072, 32 heads
(kv=32), d_ff=8192, vocab=32064. The ViT and its projector are a stub:
the caller passes projected patch embeddings (B, 576, 3072), which the
decoder consumes as a prefix before the text tokens.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    num_prefix_tokens=576,
))
