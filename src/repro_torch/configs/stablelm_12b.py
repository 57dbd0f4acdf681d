"""stablelm-12b — dense GQA.

[hf:stabilityai/stablelm-2-1_6b family]: 40L, d_model=5120, 32 heads
(GQA kv=8), d_ff=13824, vocab=100352.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="stablelm-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab_size=100352,
))
