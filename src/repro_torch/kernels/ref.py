"""Plain oracles of the block-sparse attention kernel and the chunked wkv6
kernel (the allclose targets)."""
from __future__ import annotations

import torch

NEG = -1e30


def dsa_block_sparse_attention_ref(q, k, v, idx, valid, *, block_q=128,
                                   block_k=128, causal=True, window=0):
    """Dense masked softmax over the expanded block mask.
    q: (B,Hq,Lq,hd); k/v: (B,Hkv,Lk,hd); idx/valid: (B,nQb,nb)."""
    b, hq, lq, hd = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    g = hq // hkv
    n_kb = lk // block_k
    onehot = torch.nn.functional.one_hot(idx.long(), n_kb).bool()
    bmask = (onehot & valid[..., None].bool()).any(dim=-2)   # (B,nQb,nKb)
    tmask = bmask.repeat_interleave(block_q, dim=-2).repeat_interleave(
        block_k, dim=-1)
    kk = k.repeat_interleave(g, dim=1).float()
    vv = v.repeat_interleave(g, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * (hd ** -0.5)
    m = tmask[:, None]
    qi = torch.arange(lq, device=q.device)[:, None]
    kj = torch.arange(lk, device=q.device)[None, :]
    if causal:
        m = m & (kj <= qi)[None, None]
    if window:
        m = m & (kj > qi - window)[None, None]
    s = torch.where(m, s, NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vv)
    return out.to(q.dtype)


def wkv6_ref(r, k, v, w, u, s0=None):
    """Sequential RWKV6 recurrence, one token at a time:
    S_t = diag(w_t) S_{t-1} + k_t^T v_t,  y_t = r_t (S_{t-1} + diag(u) k_t^T v_t).
    r,k,v,w: (B,S,H,hd); u: (H,hd); s0: (B,H,hd,hd) f32 or None.
    Returns (y (B,S,H,hd) in r's dtype, s_last f32)."""
    b, s, h, hd = r.shape
    st = (torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
          if s0 is None else s0.float())
    uu = u.float()[None, :, :, None]
    ys = []
    for t in range(s):
        kv = k[:, t].float()[..., :, None] * v[:, t].float()[..., None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t].float(),
                               st + uu * kv))
        st = w[:, t].float()[..., :, None] * st + kv
    return torch.stack(ys, 1).to(r.dtype), st
