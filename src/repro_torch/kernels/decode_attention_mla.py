"""One-token decode attention over an MLA latent cache: the absorbed
decode of DeepSeek-V2, for the batch path and the slot pool alike.

Port of ``repro/kernels/decode_attention.py::decode_attention_pooled_bh``
at the operands ``repro/models/attention.py::mla_absorbed_qkv`` gives
it: one KV "head" a slot (Hkv = 1, G = n_heads), q_eff = [q_lat ‖ q_rope]
(Dk = R + rope), k_eff = [ckv ‖ kr], v_eff = ckv (Dv = R) and the scale
(nope + rope) ** -0.5. This entry takes the cache's ckv (B, L, R) and kr
(B, L, rope) as they lie, so k_eff and v_eff are never built: the JAX
package concatenates k_eff every step (4.75 MB a slot a layer at L =
4128 in bf16). On CUDA tensors it launches the hand-written kernel
``decode_attention_mla_fwd`` of ``csrc/decode_attention_pooled.cu`` or
raises; on CPU tensors it runs the plain version,
``ref.decode_attention_pooled_ref`` on the concatenation.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import TILE, normalize_tiles
from repro_torch.kernels.ref import decode_attention_pooled_ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, ckv, kr, positions (nullable), lengths, o, part_acc, part_m, part_l,
# B, n_heads, L, R, rope, dtype, tiles, scale
KERNEL = _build.CudaKernel("decode_attention_pooled",
                           "decode_attention_mla_fwd",
                           [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, _I, _I, _I, _F])

# the (R, rope) the kernel is built for: deepseek-v2's kv_lora_rank and
# qk_rope_head_dim (csrc/decode_attention_pooled.cu: MlaDims)
BUILT_WIDTHS = ((512, 64),)
MLA_TILES = 4  # 64-key tiles a range of the kernel holds (its plan)


def decode_attention_mla_plain(q, ckv, kr, positions, lengths, *, n_heads,
                               scale):
    """The pooled decode's plain version on k_eff = [ckv ‖ kr] and
    v_eff = ckv (one KV row a slot)."""
    return decode_attention_pooled_ref(q, torch.cat([ckv, kr], dim=-1), ckv,
                                       positions, lengths, n_heads=n_heads,
                                       scale=scale)


def decode_attention_mla_bh(q: torch.Tensor, ckv: torch.Tensor,
                            kr: torch.Tensor,
                            positions: Optional[torch.Tensor],
                            lengths: torch.Tensor, *, n_heads: int,
                            scale: float,
                            tiles: Optional[int] = None) -> torch.Tensor:
    """q (B·n_heads, 1, R + rope); ckv (B, L, R); kr (B, L, rope);
    positions (B, L) int32 with -1 for an empty entry, or None when
    column j holds position j; lengths (B,) int32 live-prefix counts,
    clamped to L. Row b (slot b // n_heads) sees column j iff
    j < lengths[slot] and positions[slot, j] >= 0; a row that sees
    nothing gives zeros. Returns the latent context (B·n_heads, 1, R).
    ``tiles`` forces the 64-key tiles a range of the kernel holds; by
    default MLA_TILES."""
    name = "decode_attention_mla_bh"
    if kr.dim() != 3 or kr.shape[:2] != ckv.shape[:2] or \
            q.dim() != 3 or q.shape[-1] != ckv.shape[-1] + kr.shape[-1]:
        raise ValueError(f"{name}: want q (B·H, 1, R + rope), ckv (B, L, R) "
                         f"and kr (B, L, rope); got q {tuple(q.shape)}, ckv "
                         f"{tuple(ckv.shape)}, kr {tuple(kr.shape)}")
    _build.check_common(name, q, ckv, kr, lengths,
                         *(() if positions is None else (positions,)))
    if q.shape[1] != 1 or n_heads < 1 or q.shape[0] != ckv.shape[0] * n_heads:
        raise ValueError(f"{name}: want q ({ckv.shape[0]}·{n_heads}, 1, "
                         f"R + rope) for {ckv.shape[0]} slots; got "
                         f"{tuple(q.shape)}")
    _build.check_slots(name, positions, lengths, *ckv.shape[:2])
    if _build.on_cpu(name, q):
        return decode_attention_mla_plain(q, ckv, kr, positions, lengths,
                                          n_heads=n_heads, scale=scale)
    B, L, R = ckv.shape
    rope = kr.shape[-1]
    if (R, rope) not in BUILT_WIDTHS:
        raise NotImplementedError(
            f"{name}: (R, rope) = ({R}, {rope}): the kernel is built for "
            f"(R, rope) in {BUILT_WIDTHS}, deepseek-v2's latent widths")
    code = _build.check_cuda(name, q, ckv, kr, lengths,
                             *(() if positions is None else (positions,)),
                             dims=())
    _build.check_aligned16(name, "its 16-byte loads", ckv, kr)
    t = normalize_tiles(L, MLA_TILES if tiles is None else tiles)
    n_split = -(-L // (t * TILE))  # ranges a slot, from the capacity
    BH = q.shape[0]
    out = torch.empty((BH, 1, R), dtype=q.dtype, device=q.device)
    ptrs = (0, 0, 0)
    if n_split > 1:  # the ranges' fp32 (acc, m, l), merged by the same entry
        acc = torch.empty((BH, n_split, R), dtype=torch.float32,
                          device=q.device)
        ml = torch.empty((2, BH, n_split), dtype=torch.float32,
                         device=q.device)
        ptrs = (acc.data_ptr(), ml[0].data_ptr(), ml[1].data_ptr())
    KERNEL.launch(q.device, q.data_ptr(), ckv.data_ptr(), kr.data_ptr(),
                  None if positions is None else positions.data_ptr(),
                  lengths.data_ptr(), out.data_ptr(), *ptrs, B, n_heads, L,
                  R, rope, code, t, float(scale))
    return out
