"""whisper-tiny — encoder-decoder audio backbone.

[arXiv:2212.04356]: 4L (enc + dec), d_model=384, 6 heads, d_ff=1536,
vocab=51865. The mel-spectrogram and conv frontend are a stub: the
caller passes precomputed frame embeddings (B, 1500, 384). Flux routing
applies to the decoder's self-attention only.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,            # decoder layers
    num_encoder_layers=4,
    encoder_ctx=1500,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    tie_embeddings=True,
))
