"""Model-layout entry points of the attention kernels and of the wkv6
kernel.

Each takes tensors in the model's layout (B, L, H, hd) and makes the same
transposes as the JAX reference's ``repro/kernels/ops.py``: K2 wants
q/k/v as (B, H, L, hd); K1, K3, K4 and K5 take q as (B, Hq, L, hd) and
the cache (or page pool) in its natural layout.  The transposes are
views; the kernels take strides, and K2, K3 and K5 write their output in
model layout, so the transpose back is free too.  ``k_scale``/``v_scale``
(the per-row scales of an int8/fp8 cache, None for a full-width one)
select the quantized variants K1q, K3q, K4q and K5q.  K7 (``wkv6``) takes
r/k/v/w as (B, H, S, hd) views of the model's (B, S, H, hd) and writes
y in model layout.

No kernel has a backward (no Pallas kernel of the reference defines a
VJP): where autograd would need a gradient through one, its wrapper
raises on the card and on the CPU alike (``_launch.refuse_grad``), so
training runs the plain model path and a kernel serves only inference
and the no-grad eval step.
"""
from __future__ import annotations

from repro_torch.kernels.dsa_attention import dsa_block_sparse_attention
from repro_torch.kernels.dsa_chunk_prefill import (
    dsa_chunk_gather_attention, dsa_chunk_paged_gather_attention)
from repro_torch.kernels.dsa_decode import (dsa_decode_gather_attention,
                                            dsa_decode_paged_gather_attention)
from repro_torch.kernels.wkv6 import wkv6_chunked


def dsa_attention(q, k, v, idx, valid, *, block_q=128, block_k=128,
                  causal=True, window=0):
    """q: (B,Lq,Hq,hd); k/v: (B,Lk,Hkv,hd); idx/valid: (B,nQb,nb).
    Returns (B,Lq,Hq,hd)."""
    out = dsa_block_sparse_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), idx, valid,
        block_q=block_q, block_k=block_k, causal=causal, window=window)
    return out.transpose(1, 2)


def dsa_decode(q, k_cache, v_cache, idx, ok, kv_len, *, block_k=128,
               k_scale=None, v_scale=None):
    """q: (B,1,Hq,hd); k/v cache: (B,S,Hkv,hd); idx/ok: (B,nb); kv_len:
    (B,); k/v_scale: (B,S,Hkv).  Returns (B,1,Hq,hd).  The plain twin is
    core.attention.dsa_decode_block_attention."""
    out = dsa_decode_gather_attention(q.transpose(1, 2), k_cache, v_cache,
                                      idx, ok, kv_len, block_k=block_k,
                                      k_scale=k_scale, v_scale=v_scale)
    return out.transpose(1, 2)


def dsa_decode_paged(q, k_pool, v_pool, idx, pidx, ok, kv_len, *,
                     block_k=128, k_scale=None, v_scale=None):
    """q: (B,1,Hq,hd); k/v pool: (P*block_k,Hkv,hd); idx/ok: (B,nb)
    selected LOGICAL blocks; pidx: (B,nb) the same as physical pages;
    kv_len: (B,); k/v_scale: (P*block_k,Hkv).  Returns (B,1,Hq,hd).  The
    plain twin is core.attention.dsa_decode_paged_block_attention."""
    out = dsa_decode_paged_gather_attention(q.transpose(1, 2), k_pool,
                                            v_pool, idx, pidx, ok, kv_len,
                                            block_k=block_k, k_scale=k_scale,
                                            v_scale=v_scale)
    return out.transpose(1, 2)


def dsa_chunk_prefill(q, k_cache, v_cache, idx, ok, q_off, kv_len, *,
                      block_q=128, block_k=128, k_scale=None, v_scale=None):
    """q: (B,C,Hq,hd); k/v cache: (B,S,Hkv,hd); idx/ok: (B,C//block_q,nb);
    q_off/kv_len: (B,); k/v_scale: (B,S,Hkv).  Returns (B,C,Hq,hd).  The
    plain twin is core.attention.dsa_chunk_block_attention."""
    out = dsa_chunk_gather_attention(q.transpose(1, 2), k_cache, v_cache,
                                     idx, ok, q_off, kv_len, block_q=block_q,
                                     block_k=block_k, k_scale=k_scale,
                                     v_scale=v_scale)
    return out.transpose(1, 2)


def dsa_chunk_prefill_paged(q, k_pool, v_pool, idx, pidx, ok, q_off, kv_len,
                            *, block_q=128, block_k=128, k_scale=None,
                            v_scale=None):
    """q: (B,C,Hq,hd); k/v pool: (P*block_k,Hkv,hd); idx/ok:
    (B,C//block_q,nb) selected LOGICAL blocks; pidx the same as physical
    pages; q_off/kv_len: (B,); k/v_scale: (P*block_k,Hkv).  Returns
    (B,C,Hq,hd)."""
    out = dsa_chunk_paged_gather_attention(q.transpose(1, 2), k_pool, v_pool,
                                           idx, pidx, ok, q_off, kv_len,
                                           block_q=block_q, block_k=block_k,
                                           k_scale=k_scale, v_scale=v_scale)
    return out.transpose(1, 2)


def wkv6(r, k, v, w, u, s0=None, *, chunk=32):
    """r,k,v,w: (B,S,H,hd) [model layout]; u: (H,hd); s0: (B,H,hd,hd) f32
    or None.  Returns (y (B,S,H,hd), s_last (B,H,hd,hd) f32)."""
    y, st = wkv6_chunked(*(t.transpose(1, 2) for t in (r, k, v, w)), u, s0,
                         chunk=chunk)
    return y.transpose(1, 2), st
