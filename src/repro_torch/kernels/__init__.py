"""Hand-written Hopper attention kernels and their plain versions.

Each kernel module holds one entry (``*_bh``, the flattened (B·H, S, D)
layout of the JAX package's kernels), its plain PyTorch version and its
``KERNEL`` binding with a launch count. A CUDA tensor goes to the kernel
or raises; a CPU tensor goes to the plain version. ``attention_backward``
is the gradient of the flash and streaming kernels and
``block_sparse_backward`` that of the block-sparse kernel (no TPU
counterparts: the JAX package trains through XLA's autodiff).
"""
from typing import Dict

from repro_torch.kernels import (attention_backward, block_sparse_attention,
                                 block_sparse_backward, decode_attention,
                                 decode_attention_mla,
                                 decode_attention_pooled, flash_attention,
                                 streaming_attention)

KERNELS = {
    "flash_attention": flash_attention.KERNEL,
    "streaming_attention": streaming_attention.KERNEL,
    "block_sparse_attention": block_sparse_attention.KERNEL,
    "decode_attention": decode_attention.KERNEL,
    "decode_attention_pooled": decode_attention_pooled.KERNEL,
    "decode_attention_mla": decode_attention_mla.KERNEL,
    "attention_backward": attention_backward.KERNEL,
    "block_sparse_backward": block_sparse_backward.KERNEL,
}


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.reset()
