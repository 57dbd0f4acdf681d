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

What bounds it: a key's 1,152 bytes (bf16) feed 128 heads x 1,088 x 2
≈ 278 k operations, ≈ 242 operations a byte, just under the H100's 295
bf16 tensor-core operations a byte, so on the tensor cores the least
time is that of the live keys' bytes. bf16 runs on the tensor cores
(``mla_wgmma_kernel``: 64 heads a CTA, each 64-key tile of ckv ‖ kr
staged once by TMA and read by both wgmma products, S = q k^T and
O += P ckv); fp32 stays on the CUDA cores (``mla_decode_kernel``, 16
heads a CTA), as the prefill kernels keep fp32 off the tensor cores.
Both cut each slot's capacity into ranges of whole 64-key tiles
(``mla_plan``) and merge the ranges that ran by their log-sum-exp.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import attention_backward as AB
from repro_torch.kernels.decode_attention import (TILE, normalize_tiles,
                                                  sm_count)
from repro_torch.kernels.ref import decode_attention_pooled_ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, ckv, kr, positions (nullable), lengths, o, part_acc, part_m, part_l,
# B, n_heads, L, R, rope, dtype, tiles, scale
KERNEL = _build.CudaKernel("decode_attention_pooled",
                           "decode_attention_mla_fwd",
                           [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, _I, _I, _I, _F])

# the (R, rope) the kernel is built for: deepseek-v2's kv_lora_rank and
# qk_rope_head_dim (csrc/decode_attention_pooled.cu: kMlaR / kMlaRope)
BUILT_WIDTHS = ((512, 64),)
# query heads of one CTA: the bf16 kernel's wgmma M tile (mla::kHeads) and
# the fp32 kernel's (kMlaHeads); both run 256 threads
WGMMA_HEADS, CORE_HEADS, THREADS = 64, 16, 256
MLA_TILES = 4  # 64-key tiles a range of the fp32 kernel (its plan)


class MlaPlan(NamedTuple):
    """One launch of ``decode_attention_mla_fwd``: 64-key tiles a range,
    ranges a slot (cut from the capacity L), the grid, threads a CTA and
    the merge's fp32 scratch (part_acc (B·H, ranges, R), part_m and
    part_l stacked as (2, B·H, ranges)), None with one range."""
    tiles: int
    n_split: int
    grid: Tuple[int, int, int]
    threads: int
    scratch: Optional[Tuple[Tuple[int, int, int], Tuple[int, int, int]]]


def mla_tiles(B: int, L: int, n_heads: int, sms: int) -> int:
    """Tiles a range of the bf16 kernel over B slots of capacity L: as
    many ranges a slot as still give every CTA of a full pool its own
    multiprocessor, n = max(1, sms // (B · ceil(H / 64))), so tiles =
    ceil(ceil(L / 64) / n). One CTA fits a multiprocessor (231,448 bytes
    of shared memory), and each range writes 128 KB of partials a head
    block for the merge, so the fewest ranges that fill the card win. On
    an H100 at 128 heads this is the fastest of 1 to 64 tiles over 4
    slots of 32,768 keys (32 tiles) and 64 slots of 4,096 (64 tiles),
    and within 7 % of the fastest (2 tiles) over the ragged pools of
    4112 / 2080 / 1400 / 1 and 100 keys, where the capacity's grid mostly
    returns at once (PERF.md, the latent decode by tiles a range)."""
    n = max(1, sms // (B * -(-n_heads // WGMMA_HEADS)))
    return normalize_tiles(L, -(-(-(-L // TILE)) // n))


def mla_plan(B: int, L: int, n_heads: int, dtype: torch.dtype, R: int = 512,
             tiles: Optional[int] = None, sms: int = 132) -> MlaPlan:
    """The launch for B slots of capacity L and n_heads query heads:
    bf16 on the tensor cores, grid (ceil(H / 64), ranges, B) with the head
    blocks fastest (the CTAs of one range run side by side and share its
    keys in L2); fp32 on the CUDA cores, grid (B, ranges, ceil(H / 16)).
    ``tiles`` forces the tiles a range (normalized as the kernel runs it);
    by default ``mla_tiles`` (bf16) or MLA_TILES (fp32)."""
    if tiles is None:
        tiles = (mla_tiles(B, L, n_heads, sms) if dtype == torch.bfloat16
                 else MLA_TILES)
    t = normalize_tiles(L, tiles)
    n_split = -(-L // (t * TILE))
    if dtype == torch.bfloat16:
        grid = (-(-n_heads // WGMMA_HEADS), n_split, B)
    else:
        grid = (B, n_split, -(-n_heads // CORE_HEADS))
    BH = B * n_heads
    scratch = None if n_split == 1 else ((BH, n_split, R), (2, BH, n_split))
    return MlaPlan(t, n_split, grid, THREADS, scratch)


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
                            tiles: Optional[int] = None,
                            out: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """q (B·n_heads, 1, R + rope); ckv (B, L, R); kr (B, L, rope);
    positions (B, L) int32 with -1 for an empty entry, or None when
    column j holds position j; lengths (B,) int32 live-prefix counts,
    clamped to L. Row b (slot b // n_heads) sees column j iff
    j < lengths[slot] and positions[slot, j] >= 0; a row that sees
    nothing gives zeros. Returns the latent context (B·n_heads, 1, R).
    ``tiles`` forces the 64-key tiles a range of the kernel holds; by
    default ``mla_plan`` picks it. ``out`` (a test's hook,
    ``_build.check_out``) is written in place and returned."""
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
    B, L, R = ckv.shape
    BH = q.shape[0]
    out = _build.check_out(name, out, (BH, 1, R), q)
    if _build.on_cpu(name, q):
        return _build.into(out, decode_attention_mla_plain(
            q, ckv, kr, positions, lengths, n_heads=n_heads, scale=scale))
    AB.refuse_grad(name, q, ckv, kr)
    rope = kr.shape[-1]
    if (R, rope) not in BUILT_WIDTHS:
        raise NotImplementedError(
            f"{name}: (R, rope) = ({R}, {rope}): the kernel is built for "
            f"(R, rope) in {BUILT_WIDTHS}, deepseek-v2's latent widths")
    code = _build.check_cuda(name, q, ckv, kr, lengths,
                             *(() if positions is None else (positions,)),
                             dims=())
    if q.dtype == torch.bfloat16:  # q, ckv and kr through TMA maps
        _build.check_tma_aligned(name, q, ckv, kr)
    else:
        _build.check_aligned16(name, "its 16-byte loads", ckv, kr)
    plan = mla_plan(B, L, n_heads, q.dtype, R, tiles,
                    sm_count(q.device.index)
                    if q.device.type == "cuda" else 132)
    if out is None:
        out = torch.empty((BH, 1, R), dtype=q.dtype, device=q.device)
    ptrs = (0, 0, 0)
    if plan.scratch is not None:  # the ranges' fp32 (acc, m, l), merged
        acc = torch.empty(plan.scratch[0], dtype=torch.float32,
                          device=q.device)
        ml = torch.empty(plan.scratch[1], dtype=torch.float32,
                         device=q.device)
        ptrs = (acc.data_ptr(), ml[0].data_ptr(), ml[1].data_ptr())
    KERNEL.launch(q.device, q.data_ptr(), ckv.data_ptr(), kr.data_ptr(),
                  None if positions is None else positions.data_ptr(),
                  lengths.data_ptr(), out.data_ptr(), *ptrs, B, n_heads, L,
                  R, rope, code, plan.tiles, float(scale))
    return out
