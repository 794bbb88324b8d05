"""Model-layout entry points of the attention kernels.

``dsa_attention`` and ``dsa_decode`` take tensors in the model's layout
(B, L, H, hd) and make the same transposes as the JAX reference's
``repro/kernels/ops.py``: K2 wants q/k/v as (B, H, L, hd), K1 takes q as
(B, Hq, 1, hd) and the cache in its natural (B, S, Hkv, hd).  The
transposes are views; the kernels take strides.
"""
from __future__ import annotations

from repro_torch.kernels.dsa_attention import dsa_block_sparse_attention
from repro_torch.kernels.dsa_decode import dsa_decode_gather_attention


def dsa_attention(q, k, v, idx, valid, *, block_q=128, block_k=128,
                  causal=True, window=0):
    """q: (B,Lq,Hq,hd); k/v: (B,Lk,Hkv,hd); idx/valid: (B,nQb,nb).
    Returns (B,Lq,Hq,hd)."""
    out = dsa_block_sparse_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), idx, valid,
        block_q=block_q, block_k=block_k, causal=causal, window=window)
    return out.transpose(1, 2)


def dsa_decode(q, k_cache, v_cache, idx, ok, kv_len, *, block_k=128):
    """q: (B,1,Hq,hd); k/v cache: (B,S,Hkv,hd); idx/ok: (B,nb); kv_len:
    (B,).  Returns (B,1,Hq,hd).  The plain twin is
    core.attention.dsa_decode_block_attention."""
    out = dsa_decode_gather_attention(q.transpose(1, 2), k_cache, v_cache,
                                      idx, ok, kv_len, block_k=block_k)
    return out.transpose(1, 2)
