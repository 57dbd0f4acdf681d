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


LOG2E = 1.4426950408889634  # log2(e): the decode kernels' score units


def decode_attention_partial_ref(q, k, v, positions, cur_pos, scale=None):
    """The partial state of one sequence shard's keys, the arithmetic of
    ``decode_attention_split_ref`` over one range in the kernel's log2
    units: scores scaled by scale·log2(e), the -1e30 mask after the
    scaling, p = exp2(s - m) rounded to v's dtype before PV, l summing
    the unrounded p. q (BH,1,D); k/v (BHkv,L,D); positions (L,). Returns
    (o (BH, Dv) fp32, normalized; lse (BH,) fp32 = m + log2(l), a base-2
    log-sum-exp). A row with no visible key has m = -1e30, lse = -1e30
    in fp32 and o the mean of V, as an all-masked split has."""
    BH, _, D = q.shape
    BHkv = k.shape[0]
    G = BH // BHkv
    scale = D ** -0.5 if scale is None else scale
    qf = q.reshape(BHkv, G, D).float()
    valid = (positions >= 0) & (positions <= cur_pos)
    s = torch.einsum("hgd,hkd->hgk", qf, k.float()) * (scale * LOG2E)
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(-1)
    p = torch.exp2(s - m[..., None])
    l = p.sum(-1)
    acc = torch.einsum("hgk,hkd->hgd", p.to(v.dtype).float(), v.float())
    o = acc / torch.clamp(l, min=1e-20)[..., None]
    return o.reshape(BH, v.shape[-1]), (m + torch.log2(l)).reshape(BH)


def decode_merge_ranks_ref(o_parts, lse_parts, dtype):
    """The ranks' partial states merged: o_parts (N, BH, D), lse_parts
    (N, BH) fp32 (base-2, as ``decode_attention_partial_ref`` gives
    them). Returns Σ w_r o_r / max(Σ w_r, 1e-20) in ``dtype``, w_r =
    exp2(lse_r - max_r lse_r)."""
    w = torch.exp2(lse_parts - lse_parts.amax(0))
    o = (w[..., None] * o_parts).sum(0)
    return (o / torch.clamp(w.sum(0), min=1e-20)[..., None]).to(dtype)


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


LOG2E = 1.4426950408889634
BWD_TILE = 64  # rows and keys of the bf16 backward engine's tiles


def _backward_visible(rows, keys, *, causal, sink, local, q_offset):
    """(len(rows), len(keys)) bool: query row r sees key c."""
    p = q_offset + rows[:, None]
    c = keys[None, :]
    if local is None:
        return (c <= p) if causal else torch.ones(
            (len(rows), len(keys)), dtype=torch.bool, device=rows.device)
    return (c <= p) & ((c < sink) | (p - c < local))


def attention_backward_tiled_ref(q, k, v, dout, *, causal=True, sink=None,
                                 local=None, q_offset=0, scale=None):
    """The bf16 backward engine's arithmetic step by step
    (``csrc/backward_wgmma.cuh``), for tests only: the gradient of
    ``flash_attention_ref`` (``local`` None) or ``streaming_attention_ref``
    as the kernel forms it. Scores in log2 units (s · scale · log2 e,
    exp2). dq by blocks of 64 query rows over 64-key tiles: pass 1 the
    rows' max m and sum l, online; pass 2 D_i = (1 / l_i) Σ_j round(p_ij)
    dP_ij; pass 3 dS = p / l (dP - D_i), dQ += dS K. dk / dv by blocks of
    64 keys, for each of the G query heads over 64-row tiles, from dq's m,
    1 / l and D: dV += (round(p) / l)ᵀ dO and dK += dSᵀ Q. dS and round(p)
    / l enter their products as the kernel's A operands do, as two parts
    in v's dtype, hi = round(x) and lo = round(x - hi) (no rounding in
    float32). A hidden pair's p is 0, so a row with no visible key gives
    no gradient. Every tile is walked under the mask: the tiles the
    kernel's walks skip are hidden whole and add exact zeros."""
    BH, Sq, D = q.shape
    BHkv, Skv, Dv = v.shape
    G = BH // BHkv
    scale = D ** -0.5 if scale is None else scale
    c = torch.tensor(scale * LOG2E, dtype=torch.float32).item()
    mask = dict(causal=causal, sink=sink, local=local, q_offset=q_offset)
    dev, T = q.device, BWD_TILE

    def rnd(x):
        return x.to(v.dtype).float()

    def split(x):  # hi + lo
        hi = rnd(x)
        return hi + rnd(x - hi)

    qf, dof = q.float(), dout.float()
    kf = k.float().repeat_interleave(G, 0)  # (BH, Skv, D): row b's kv row
    vf = v.float().repeat_interleave(G, 0)
    m = torch.full((BH, Sq), NEG_INF, device=dev)
    il = torch.zeros((BH, Sq), device=dev)
    dd = torch.zeros((BH, Sq), device=dev)
    dq = torch.zeros((BH, Sq, D), device=dev)
    for r0 in range(0, Sq, T):
        rows = torch.arange(r0, min(r0 + T, Sq), device=dev)
        steps = []
        for k0 in range(0, Skv, T):
            keys = torch.arange(k0, min(k0 + T, Skv), device=dev)
            vis = _backward_visible(rows, keys, **mask)
            s = torch.einsum("hqd,hkd->hqk", qf[:, rows], kf[:, keys]) * c
            s = torch.where(vis, s, NEG_INF)
            dp = torch.einsum("hqd,hkd->hqk", dof[:, rows], vf[:, keys])
            steps.append((keys, vis, s, dp))
        mr = torch.full((BH, len(rows)), NEG_INF, device=dev)
        lr = torch.zeros((BH, len(rows)), device=dev)
        for _, vis, s, _ in steps:  # pass 1
            m_new = torch.maximum(mr, s.amax(-1))
            lr = lr * torch.exp2(mr - m_new) + torch.where(
                vis, torch.exp2(s - m_new[..., None]), 0.).sum(-1)
            mr = m_new
        ilr = 1 / torch.clamp(lr, min=1e-20)
        dr = torch.zeros((BH, len(rows)), device=dev)
        for _, vis, s, dp in steps:  # pass 2
            p = torch.where(vis, torch.exp2(s - mr[..., None]), 0.)
            dr = dr + (rnd(p) * dp).sum(-1)
        dr = ilr * dr
        for keys, vis, s, dp in steps:  # pass 3
            p = torch.where(vis, torch.exp2(s - mr[..., None]), 0.)
            ds = split(p * ilr[..., None] * (dp - dr[..., None]))
            dq[:, rows] += torch.einsum("hqk,hkd->hqd", ds, kf[:, keys])
        m[:, rows], il[:, rows], dd[:, rows] = mr, ilr, dr

    dk = torch.zeros((BHkv, Skv, D), device=dev)
    dv = torch.zeros((BHkv, Skv, Dv), device=dev)
    kv_heads = torch.arange(BHkv, device=dev) * G
    for c0 in range(0, Skv, T):
        keys = torch.arange(c0, min(c0 + T, Skv), device=dev)
        for g in range(G):
            heads = kv_heads + g
            for t0 in range(0, Sq, T):
                rows = torch.arange(t0, min(t0 + T, Sq), device=dev)
                vis = _backward_visible(rows, keys, **mask).T
                qt, dot = qf[heads][:, rows], dof[heads][:, rows]
                st = torch.einsum("hkd,hqd->hkq", k.float()[:, keys], qt) * c
                dpt = torch.einsum("hkd,hqd->hkq", v.float()[:, keys], dot)
                mq, ilq, dq_ = (x[heads][:, rows][:, None, :]
                                for x in (m, il, dd))
                p = torch.where(vis, torch.exp2(st - mq), 0.)
                dv[:, keys] += torch.einsum("hkq,hqd->hkd",
                                            split(rnd(p) * ilq), dot)
                dk[:, keys] += torch.einsum("hkq,hqd->hkd",
                                            split(p * ilq * (dpt - dq_)),
                                            qt)
    return ((dq * scale).to(q.dtype), (dk * scale).to(k.dtype),
            dv.to(v.dtype))
