"""PyTorch + CUDA port of the Flux Attention serving path (``repro``).

The JAX package ``repro`` stays the reference: every module here names its
counterpart there and is tested against it on the same weights and
inputs. This package imports neither ``jax`` nor anything of ``repro``.
Its attention kernels are written by hand in CUDA C++ for Hopper
(``kernels/csrc``); entry points run on ``cuda`` unless the caller asks
for ``device="cpu"``, where every kernel runs its plain PyTorch version.
"""
from __future__ import annotations

from typing import Optional, Union


def resolve_device(device: Optional[Union[str, "torch.device"]] = None
                   ) -> "torch.device":
    """The device an entry point runs on: ``cuda`` unless the caller
    names another. Raises when CUDA is asked for and there is none, so
    nothing falls back to the CPU unasked. (torch is imported here, not
    with the package, so the host-only validators
    ``python -m repro_torch.serve.telemetry`` / ``.tracing`` start
    without it.)"""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: repro_torch runs on cuda by default; pass "
            "device='cpu' to run the plain PyTorch versions of the kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {dev}: repro_torch runs on cuda or cpu")
    return dev
