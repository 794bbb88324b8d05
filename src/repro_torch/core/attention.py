"""Attention primitives (full / masked / DSA-sparse), plain PyTorch.

All functions take q: (B, Lq, Hq, hd), k/v: (B, Lk, Hkv, hd) with
Hq % Hkv == 0 (GQA).

  dense_attention             materialised scores; Eq.(4) masking via
                              S - c(1-M).  Small shapes, the token path.
  flash_attention             q-chunked loop, never materialises Lq x Lk.
  dsa_sparse_attention        visits only the predicted key blocks; the
                              plain twin of kernels.dsa_attention (K2).
  decode_attention            dense decode over the whole cache.
  dsa_decode_block_attention  block-gather decode over the selected cache
                              blocks; the plain twin of kernels.dsa_decode
                              (K1).

dtypes follow jnp's promotion: a bf16 query against an f32 cache computes
and returns f32, as in the JAX reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.prediction import einsum

NEG = -1e9  # paper's -c


def _pos_mask(lq: int, lk: int, causal: bool, window: int,
              q_offset: int = 0, device=None) -> Optional[torch.Tensor]:
    """(Lq, Lk) validity from causal/sliding-window constraints."""
    if not causal and not window:
        return None
    qi = torch.arange(lq, device=device)[:, None] + q_offset
    kj = torch.arange(lk, device=device)[None, :]
    m = torch.ones((lq, lk), dtype=torch.bool, device=device)
    if causal:
        m &= kj <= qi
    if window:
        m &= kj > qi - window
    return m


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """-> (B, Hkv, G, Lq, Lk) scores, scaled."""
    b, lq, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, lq, hkv, hq // hkv, hd) * (hd ** -0.5)
    return einsum("bqhgd,bkhd->bhgqk", qg, k)


def _gqa_out(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    b, hkv, g, lq, lk = p.shape
    out = einsum("bhgqk,bkhd->bqhgd", p, v)
    return out.reshape(b, lq, hkv * g, -1)


def _softmax_f32(s: torch.Tensor) -> torch.Tensor:
    return torch.softmax(s.float(), dim=-1)


def dense_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    token_mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Reference attention.  token_mask: (B, Lq, Lk) DSA mask M (bool),
    applied as the paper's Eq.(4): softmax(S - c(1 - M))."""
    lq, lk = q.shape[1], k.shape[1]
    s = _gqa_scores(q, k)                                # (B,Hkv,G,Lq,Lk)
    pm = _pos_mask(lq, lk, causal, window, device=q.device)
    if pm is not None:
        s = torch.where(pm[None, None, None], s, NEG)
    if token_mask is not None:
        s = torch.where(token_mask[:, None, None], s, NEG)
    p = _softmax_f32(s)
    return _gqa_out(p.to(v.dtype), v)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_chunk: int = 256) -> torch.Tensor:
    """q-chunked attention: O(C * Lk) working set per chunk."""
    b, lq, hq, hd = q.shape
    lk = k.shape[1]
    c = min(q_chunk, lq)
    if lq % c:
        raise ValueError(f"Lq={lq} is not a multiple of the chunk {c}")
    outs = []
    for i in range(lq // c):
        qc = q[:, i * c:(i + 1) * c]
        s = _gqa_scores(qc, k)
        pm = _pos_mask(c, lk, causal, window, q_offset=i * c,
                       device=q.device)
        if pm is not None:
            s = torch.where(pm[None, None, None], s, NEG)
        p = _softmax_f32(s)
        outs.append(_gqa_out(p.to(v.dtype), v))
    return torch.cat(outs, dim=1)


def _gather_blocks(x: torch.Tensor, idx: torch.Tensor, block: int
                   ) -> torch.Tensor:
    """x: (B, n_kb*block, H, d); idx: (B, nb) -> (B, nb*block, H, d)."""
    b, s, h, d = x.shape
    xb = x.reshape(b, s // block, block, h, d)
    g = torch.gather(xb, 1, idx.long()[:, :, None, None, None].expand(
        b, idx.shape[1], block, h, d))
    return g.reshape(b, idx.shape[1] * block, h, d)


def dsa_sparse_attention(q, k, v, idx, idx_valid, *, block_q: int,
                         block_k: int, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """Block-gather sparse attention.

    idx, idx_valid: (B, nQb, nb_keep) predicted key-block indices per query
    block.  FLOPs scale with nb_keep/nKb.
    """
    b, lq, hq, hd = q.shape
    hdv = v.shape[-1]
    n_qb = lq // block_q
    nb = idx.shape[-1]
    dev = q.device
    outs = []
    for qb_i in range(n_qb):
        qc = q[:, qb_i * block_q:(qb_i + 1) * block_q]
        ib = idx[:, qb_i]
        ks = _gather_blocks(k, ib, block_k)
        vs = _gather_blocks(v, ib, block_k)
        s = _gqa_scores(qc, ks)                   # (B,Hkv,G,Bq,nb*Bk)
        kpos = (ib.long()[:, :, None] * block_k + torch.arange(
            block_k, device=dev)[None, None, :]).reshape(b, nb * block_k)
        qpos = qb_i * block_q + torch.arange(block_q, device=dev)
        ok = idx_valid[:, qb_i, :, None].expand(b, nb, block_k).reshape(
            b, nb * block_k)
        m = ok[:, None, :]
        if causal:
            m = m & (kpos[:, None, :] <= qpos[None, :, None])
        if window:
            m = m & (kpos[:, None, :] > qpos[None, :, None] - window)
        s = torch.where(m[:, None, None], s, NEG)
        p = _softmax_f32(s)
        outs.append(_gqa_out(p.to(v.dtype), vs))
    return torch.cat(outs, dim=1).reshape(b, lq, hq, hdv)


def decode_attention(q, k_cache, v_cache, *,
                     kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-step decode: q (B, 1, Hq, hd) vs cache (B, S, Hkv, hd).
    kv_len: (B,) valid cache length (current position + 1)."""
    b = q.shape[0]
    s_len = k_cache.shape[1]
    s = _gqa_scores(q, k_cache)                   # (B,Hkv,G,1,S)
    m = torch.ones((b, s_len), dtype=torch.bool, device=q.device)
    if kv_len is not None:
        m &= torch.arange(s_len, device=q.device)[None, :] < kv_len[:, None]
    s = torch.where(m[:, None, None, None], s, NEG)
    p = _softmax_f32(s)
    return _gqa_out(p.to(v_cache.dtype), v_cache)


def dsa_decode_block_attention(q, k_cache, v_cache, idx, idx_valid, *,
                               block_k: int,
                               kv_len: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Block-gather DSA decode.

    q: (B, 1, Hq, hd); k/v cache: (B, S, Hkv, hd); idx/idx_valid: (B, nb)
    selected cache-block indices (block j = cache rows [j*block_k,
    (j+1)*block_k)).  Positions past kv_len are masked.  With every valid
    block selected this equals decode_attention.
    """
    b = q.shape[0]
    s_len = k_cache.shape[1]
    nb = idx.shape[-1]
    n_kb = -(-s_len // block_k)
    pad = n_kb * block_k - s_len
    if pad:
        k_cache = torch.nn.functional.pad(k_cache, (0, 0, 0, 0, 0, pad))
        v_cache = torch.nn.functional.pad(v_cache, (0, 0, 0, 0, 0, pad))
    ks = _gather_blocks(k_cache, idx, block_k)
    vs = _gather_blocks(v_cache, idx, block_k)
    kpos = (idx.long()[:, :, None] * block_k + torch.arange(
        block_k, device=q.device)[None, None, :]).reshape(b, nb * block_k)
    lim = (torch.full((b,), s_len, dtype=torch.int32, device=q.device)
           if kv_len is None else kv_len)
    m = idx_valid[:, :, None].expand(b, nb, block_k).reshape(b, nb * block_k)
    m = m & (kpos < lim[:, None])
    s = _gqa_scores(q, ks)                          # (B,Hkv,G,1,nb*Bk)
    s = torch.where(m[:, None, None, None], s, NEG)
    p = _softmax_f32(s)
    return _gqa_out(p.to(vs.dtype), vs)
