"""Hand-written Hopper attention kernels and their plain versions.

Each kernel module holds one entry (``*_bh``, the flattened (B·H, S, D)
layout of the JAX package's kernels), its plain PyTorch version and its
``KERNEL`` binding with a launch count. A CUDA tensor goes to the kernel
or raises; a CPU tensor goes to the plain version.
"""
from typing import Dict

from repro_torch.kernels import (block_sparse_attention, decode_attention,
                                 decode_attention_pooled, flash_attention,
                                 streaming_attention)

KERNELS = {
    "flash_attention": flash_attention.KERNEL,
    "streaming_attention": streaming_attention.KERNEL,
    "block_sparse_attention": block_sparse_attention.KERNEL,
    "decode_attention": decode_attention.KERNEL,
    "decode_attention_pooled": decode_attention_pooled.KERNEL,
}


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.reset()
