"""Plain PyTorch oracles for every kernel (port of repro/kernels/ref.py).

Each builds the full (Sq, Skv) mask and does a dense masked softmax in
float32: O(S^2) memory. They are the plain versions the kernel wrappers
run on CPU tensors, and what the kernels are held against on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _masked_attention(q, k, v, mask, scale=None):
    """q (BH,Sq,D); k/v (BHkv,Skv,D); mask (Sq,Skv) or (BH,Sq,Skv).

    The kernels' arithmetic in one dense pass: f32 scores, the -1e30
    mask, p = exp(s - rowmax) rounded to v's dtype before the PV product
    (a no-op in float32), and the sum divided by max(l, 1e-20) at the end,
    where l sums the unrounded p.

    Under autograd, the gradient the backward kernel computes: the row
    max is a constant (the softmax is invariant to it) and the rounding
    of p passes the gradient straight through in float32. Autograd
    through the cast itself would round p's cotangent to v's dtype, and
    through the max would hand the argmax key the gradient the rounding
    leaves there; in bf16 both move dq and dk at the first rows of a
    causal mask, where the true gradient nearly cancels."""
    BH, Sq, D = q.shape
    BHkv = k.shape[0]
    G = BH // BHkv
    scale = D ** -0.5 if scale is None else scale
    q4 = q.reshape(BHkv, G, Sq, D).float()
    s = torch.einsum("hgqd,hkd->hgqk", q4, k.float()) * scale
    if mask.dim() == 3:
        mask = mask.reshape(BHkv, G, *mask.shape[1:])
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True).detach())
    l = p.sum(dim=-1, keepdim=True)
    if p.requires_grad:  # the same values: pr - p is exact
        p = p + (p.to(v.dtype).float() - p).detach()
    else:
        p = p.to(v.dtype).float()
    o = torch.einsum("hgqk,hkd->hgqd", p, v.float())
    o = o / torch.clamp(l, min=1e-20)
    return o.reshape(BH, Sq, v.shape[-1]).to(q.dtype)


def _positions(n: int, offset: int, device) -> torch.Tensor:
    return offset + torch.arange(n, device=device)


def flash_attention_ref(q, k, v, *, causal=True, q_offset=0, scale=None):
    Sq, Skv = q.shape[1], k.shape[1]
    qp = _positions(Sq, q_offset, q.device)
    kp = _positions(Skv, 0, q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = kp[None, :] <= qp[:, None]
    return _masked_attention(q, k, v, mask, scale)


def streaming_attention_ref(q, k, v, *, sink, local, q_offset=0,
                            scale=None):
    Sq, Skv = q.shape[1], k.shape[1]
    qp = _positions(Sq, q_offset, q.device)
    kp = _positions(Skv, 0, q.device)
    causal = kp[None, :] <= qp[:, None]
    window = (qp[:, None] - kp[None, :]) < local
    sink_m = kp[None, :] < sink
    return _masked_attention(q, k, v, causal & (window | sink_m), scale)


def decode_attention_ref(q, k, v, positions, cur_pos, scale=None):
    """q (BH,1,D); k/v (BHkv,L,D); positions (L,)."""
    valid = (positions >= 0) & (positions <= cur_pos)
    return _masked_attention(q, k, v, valid[None, :], scale)


def decode_attention_split_ref(q, k, v, positions, cur_pos, n_split,
                               scale=None):
    """The split-KV decode kernel's arithmetic, for tests only: keys in
    ``n_split`` ranges of whole 64-key tiles (split s takes tiles
    [s·n // n_split, (s + 1)·n // n_split) of n = ceil(L / 64)), each with
    one softmax over its keys (the -1e30 mask, m the range's max, p
    rounded to v's dtype before PV, l summing the unrounded p), then the
    ranges' (acc, m, l) merged by their log-sum-exp:
    o = Σ w_s acc_s / max(Σ w_s l_s, 1e-20), w_s = exp(m_s - max m)."""
    BH, _, D = q.shape
    BHkv, L = k.shape[0], k.shape[1]
    G = BH // BHkv
    scale = D ** -0.5 if scale is None else scale
    n = -(-L // 64)
    qf = q.reshape(BHkv, G, D).float()
    valid = (positions >= 0) & (positions <= cur_pos)
    parts = []
    for s in range(n_split):
        keys = slice(s * n // n_split * 64, min((s + 1) * n // n_split * 64,
                                                  L))
        sc = torch.einsum("hgd,hkd->hgk", qf, k[:, keys].float()) * scale
        sc = torch.where(valid[keys], sc, NEG_INF)
        m = sc.amax(-1)
        p = torch.exp(sc - m[..., None])
        acc = torch.einsum("hgk,hkd->hgd", p.to(v.dtype).float(),
                           v[:, keys].float())
        parts.append((m, p.sum(-1), acc))
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [torch.exp(m - mx) for m, _, _ in parts]
    l = sum(wi * li for wi, (_, li, _) in zip(w, parts))
    acc = sum(wi[..., None] * a for wi, (_, _, a) in zip(w, parts))
    o = acc / torch.clamp(l, min=1e-20)[..., None]
    return o.reshape(BH, 1, v.shape[-1]).to(q.dtype)


def block_sparse_attention_ref(q, k, v, sel, *, block, q_offset=0,
                               scale=None):
    """sel (BH, nqb, K) expanded to a dense mask. ``q_offset`` shifts the
    causal comparison (query row r sees keys <= q_offset + r), as the
    kernel's runtime offset does for streamed prompt chunks."""
    BH, Sq, D = q.shape
    Skv = k.shape[1]
    nqb = sel.shape[1]
    nkb = -(-Skv // block)
    # (BH, nqb, nkb) block visibility; -1 and out-of-range entries are
    # parked at a pad column and dropped
    sel_c = torch.where((sel >= 0) & (sel < nkb), sel, nkb).long()
    blk_mask = torch.zeros((BH, nqb, nkb + 1), dtype=torch.bool,
                           device=q.device)
    blk_mask.scatter_(2, sel_c, True)
    mask = blk_mask[:, :, :nkb].repeat_interleave(block, 1)
    mask = mask.repeat_interleave(block, 2)[:, :Sq, :Skv]
    qp = _positions(Sq, q_offset, q.device)
    kp = _positions(Skv, 0, q.device)
    mask = mask & (kp[None, :] <= qp[:, None])[None]
    return _masked_attention(q, k, v, mask, scale)


def decode_attention_pooled_ref(q, k, v, positions, lengths, *, n_heads,
                                scale=None):
    """q (B·n_heads,1,Dk); k (BHkv,L,Dk); v (BHkv,L,Dv); positions (B,L)
    int32 (-1 empty) or None (column j holds position j); lengths (B,).

    Row b belongs to slot b // n_heads and sees column j iff
    j < min(lengths[slot], L) and positions[slot, j] >= 0. A row that sees
    no column gives zeros, as the kernel's acc / max(l, 1e-20) does for an
    empty slot; the dense -1e30 softmax would give the mean of V instead."""
    L = k.shape[1]
    col = torch.arange(L, device=q.device)
    valid = col[None, :] < lengths.clamp(0, L)[:, None]  # (B, L)
    if positions is not None:
        valid = valid & (positions >= 0)
    rows = valid.repeat_interleave(n_heads, dim=0)  # (B·n_heads, L)
    o = _masked_attention(q, k, v, rows[:, None, :], scale)
    return torch.where(rows.any(dim=-1)[:, None, None], o,
                       torch.zeros_like(o))


def decode_attention_pooled_split_ref(q, k, v, positions, lengths, *,
                                      n_heads, tiles, scale=None):
    """The split pooled decode kernel's arithmetic, for tests only: each
    row's live keys [0, n), n = min(lengths[slot], L), in ranges of
    ``tiles`` whole 64-key tiles (range s takes keys [s·tiles·64,
    min((s + 1)·tiles·64, n)); the ranges past n do not run), each with one
    softmax over its keys (the -1e30 mask on positions < 0, m the range's
    max, p rounded to v's dtype before PV, l summing the unrounded p), then
    the ranges' (acc, m, l) merged by their log-sum-exp:
    o = Σ w_s acc_s / max(Σ w_s l_s, 1e-20), w_s = exp(m_s - max m); a row
    with no range or no live key gives zeros."""
    BH, _, Dk = q.shape
    BHkv, L, Dv = v.shape
    G = BH // BHkv
    scale = Dk ** -0.5 if scale is None else scale
    span = tiles * 64
    out = torch.zeros((BH, 1, Dv), dtype=torch.float32, device=q.device)
    for b in range(BH):
        slot, kv = b // n_heads, b // G
        n = min(max(int(lengths[slot]), 0), L)
        parts = []
        for s0 in range(0, n, span):
            keys = slice(s0, min(s0 + span, n))
            sc = (k[kv, keys].float() @ q[b, 0].float()) * scale
            if positions is not None:
                sc = torch.where(positions[slot, keys] >= 0, sc, NEG_INF)
            m = sc.max()
            p = torch.exp(sc - m)
            parts.append((m, p.sum(), p.to(v.dtype).float()
                          @ v[kv, keys].float()))
        if not parts:
            continue
        mx = torch.stack([m for m, _, _ in parts]).max()
        if mx <= NEG_INF:
            continue  # no live key
        w = [torch.exp(m - mx) for m, _, _ in parts]
        l = sum(wi * li for wi, (_, li, _) in zip(w, parts))
        acc = sum(wi * a for wi, (_, _, a) in zip(w, parts))
        out[b, 0] = acc / torch.clamp(l, min=1e-20)
    return out.to(q.dtype)
