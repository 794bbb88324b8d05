"""Plain oracle for the block-sparse attention kernel (the allclose target)."""
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
