"""Hand-written Hopper attention kernels and their plain versions.

Each kernel module holds one entry (``*_bh``, the flattened (B·H, S, D)
layout of the JAX package's kernels), its plain PyTorch version and its
``KERNEL`` binding with a launch count. A CUDA tensor goes to the kernel
or raises; a CPU tensor goes to the plain version. ``attention_backward``
is the gradient of the flash and streaming kernels and
``block_sparse_backward`` that of the block-sparse kernel (no TPU
counterparts: the JAX package trains through XLA's autodiff).
``decode_attention_partial`` and ``decode_merge_ranks`` are the two
halves of the sequence-sharded decode (``distributed/decode.py``): one
rank's partial state and the merge of the ranks' states, both entries of
the batch decode kernel's library.
"""
from typing import Dict

from repro_torch.kernels import (attention_backward, block_sparse_attention,
                                 block_sparse_backward, decode_attention,
                                 decode_attention_mla,
                                 decode_attention_partial,
                                 decode_attention_pooled, decode_merge_ranks,
                                 flash_attention, streaming_attention)

KERNELS = {
    "flash_attention": flash_attention.KERNEL,
    "streaming_attention": streaming_attention.KERNEL,
    "block_sparse_attention": block_sparse_attention.KERNEL,
    "decode_attention": decode_attention.KERNEL,
    "decode_attention_pooled": decode_attention_pooled.KERNEL,
    "decode_attention_mla": decode_attention_mla.KERNEL,
    "attention_backward": attention_backward.KERNEL,
    "block_sparse_backward": block_sparse_backward.KERNEL,
    "decode_attention_partial": decode_attention_partial.KERNEL,
    "decode_merge_ranks": decode_merge_ranks.KERNEL,
}


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.reset()
