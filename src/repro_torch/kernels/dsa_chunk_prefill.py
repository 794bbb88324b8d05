"""K3 — DSA chunk-prefill gather-attend: CUDA kernel, wrapper and plain
version.

Replaces the Pallas TPU kernel
``src/repro/kernels/dsa_chunk_prefill.py::dsa_chunk_gather_attention``
(body ``_kernel``).  The CUDA source is ``csrc/dsa_chunk_prefill.cu``; its
header note says what bounds the kernel on the H100 (operations at f32:
the main path feeds bf16 queries against the f32 cache) and what the
design does about it (one CTA per slice of a query block and KV head
serves the whole GQA group from one read of each gathered K/V tile, four
threads per (query row, head) on the f32 FMA pipe).

Layouts (kernel-native; ``kernels.ops.dsa_chunk_prefill`` adapts model
layout):

  q:       (B, Hq, C, hd)     chunk queries, C a multiple of block_q; any
                              strides with a unit hd stride (the ops
                              transpose is a view)
  k/v:     (B, S, Hkv, hd)    KV cache in its natural engine layout, S
                              need not be a block multiple
  idx/ok:  (B, C/block_q, nb) selected cache blocks + validity per chunk
                              query block
  q_off:   (B,)               global position of each row's first query
  kv_len:  (B,)               valid cache rows (written so far, the chunk
                              included); frozen rows pass 0
  out:     (B, Hq, C, hd)     in q's dtype, stored in (B, C, Hq, hd)
                              memory so the ops transpose back is free

Key k_pos is live for query row i iff ok, k_pos <= q_off + i and
k_pos < kv_len; p is zero under the mask, so a row with no live key
comes out 0, as in the Pallas body.  On a CPU tensor the wrapper runs the
plain version; on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _launch as LN

NEG = -1e30


def dsa_chunk_gather_attention_plain(q, k_cache, v_cache, idx, ok, q_off,
                                     kv_len, *, block_q: int = 128,
                                     block_k: int = 128) -> torch.Tensor:
    """The Pallas body's arithmetic in plain PyTorch (f32 throughout): per
    chunk query block, an online softmax over its nb selected cache blocks
    in order, with p zero under the mask."""
    b, hq, c, hd = q.shape
    s_len, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    n_qb = c // block_q
    dev = q.device
    qf = q.float().reshape(b, hkv, g, n_qb, block_q, hd) * hd ** -0.5
    qpos = (q_off.long()[:, None, None]
            + (torch.arange(n_qb, device=dev)[:, None] * block_q
               + torch.arange(block_q, device=dev)[None, :])[None])
    rows_b = torch.arange(b, device=dev)[:, None, None]
    offs = torch.arange(block_k, device=dev)
    m = torch.full((b, hkv, g, n_qb, block_q), NEG, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, n_qb, block_q, hd), device=dev)
    for j in range(idx.shape[-1]):
        kpos = idx[:, :, j].long()[..., None] * block_k + offs  # (B,nQb,Bk)
        rows = kpos.clamp(max=s_len - 1)
        kj = k_cache[rows_b, rows].float()               # (B,nQb,Bk,Hkv,hd)
        vj = v_cache[rows_b, rows].float()
        live = ((kpos < kv_len.long()[:, None, None]) & (kpos < s_len)
                & ok[:, :, j, None].bool())               # (B,nQb,Bk)
        mask = live[:, :, None, :] & (kpos[:, :, None, :]
                                      <= qpos[..., None])   # (B,nQb,Bq,Bk)
        s = torch.einsum("bhgqid,bqkhd->bhgqik", qf, kj)
        mk = mask[:, None, None]
        s = torch.where(mk, s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(mk, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = (acc * alpha[..., None]
               + torch.einsum("bhgqik,bqkhd->bhgqid", p, vj))
        m = m_new
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.reshape(b, hq, c, hd).to(q.dtype)


def dsa_chunk_gather_attention(q, k_cache, v_cache, idx, ok, q_off, kv_len,
                               *, block_q: int = 128,
                               block_k: int = 128) -> torch.Tensor:
    """q: (B,Hq,C,hd); k/v cache: (B,S,Hkv,hd); idx/ok: (B,C//block_q,nb);
    q_off/kv_len: (B,).  Returns (B,Hq,C,hd) in q's dtype."""
    if q.device.type == "cpu":
        return dsa_chunk_gather_attention_plain(
            q, k_cache, v_cache, idx, ok, q_off, kv_len, block_q=block_q,
            block_k=block_k)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    dev = q.device
    b, hq, c, hd = q.shape
    s_len, hkv = k_cache.shape[1], k_cache.shape[2]
    nb = idx.shape[-1]
    if (hq % hkv or hq // hkv > 128 or hd % 16 or hd > 128 or block_q % 8
            or c % block_q or block_k < 1 or idx.shape[1] != c // block_q):
        raise ValueError(f"unsupported chunk shape q={tuple(q.shape)} "
                         f"cache={tuple(k_cache.shape)} idx="
                         f"{tuple(idx.shape)} blocks=({block_q}, {block_k})")
    if k_cache.stride() != v_cache.stride() or k_cache.dtype != v_cache.dtype:
        raise ValueError("k and v caches must share strides and dtype")
    LN.check_cuda_operand("q", q, dev)
    LN.check_cuda_operand("k_cache", k_cache, dev)
    LN.check_cuda_operand("v_cache", v_cache, dev)
    idx32 = LN.check_index("idx", idx, dev)
    ok32 = LN.check_index("ok", ok, dev)
    qo = LN.check_index("q_off", q_off, dev)
    kvl = LN.check_index("kv_len", kv_len, dev)
    out = torch.empty((b, c, hq, hd), dtype=q.dtype,
                      device=dev).transpose(1, 2)
    fn = LN.bind("dsa_chunk_prefill", "dsa_chunk_prefill_launch",
                 [LN.I, LN.I, LN.P, LN.L, LN.L, LN.L, LN.P, LN.P, LN.L, LN.L,
                  LN.L, LN.P, LN.P, LN.L, LN.L, LN.P, LN.P, LN.P, LN.L, LN.L,
                  LN.L] + [LN.I] * 9 + [LN.F, LN.P])
    qs, cs, os_ = q.stride(), k_cache.stride(), out.stride()
    err = fn(LN.DTYPE_CODE[q.dtype], LN.DTYPE_CODE[k_cache.dtype],
             q.data_ptr(), qs[0], qs[1], qs[2],
             k_cache.data_ptr(), v_cache.data_ptr(), cs[0], cs[1], cs[2],
             idx32.data_ptr(), ok32.data_ptr(), idx32.stride(0),
             idx32.stride(1), qo.data_ptr(), kvl.data_ptr(),
             out.data_ptr(), os_[0], os_[1], os_[2],
             b, hq, hkv, c, s_len, hd, nb, block_q, block_k, hd ** -0.5,
             LN.stream_handle(dev))
    LN.raise_on_error("dsa_chunk_prefill", err)
    dsa_chunk_gather_attention.launches += 1
    return out


dsa_chunk_gather_attention.launches = 0
