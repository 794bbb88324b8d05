"""K2 — DSA block-sparse flash attention: CUDA kernel, wrapper and plain
version.

Replaces the Pallas TPU kernel
``src/repro/kernels/dsa_attention.py::dsa_block_sparse_attention`` (body
``_kernel``).  The CUDA source is ``csrc/dsa_attention.cu``; its header
note says what bounds the kernel on the H100 (bytes and operations about
even at the main path's shape, so the tensor cores) and what the design
does about it (bf16 on warpgroup MMAs fed by TMA, with p carried as a
bf16 pair; f32 on the FMA pipe).

  q: (B, Hq, Lq, hd)   k/v: (B, Hkv, Lk, hd)   idx/valid: (B, nQb, nb)
  out: (B, Hq, Lq, hd)

Any strides with a unit hd stride are taken (the ops transposes are
views).  Unlike the Pallas body, p is zero under the mask, which equals
the Pallas kernel wherever that kernel is exact (every row has a live key
among its visited blocks; the diagonal force-keep guarantees it on the
main path).  On a CPU tensor the wrapper runs the plain version; on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _launch as LN

NEG = -1e30


def dsa_block_sparse_attention_plain(q, k, v, idx, valid, *,
                                     block_q: int = 128, block_k: int = 128,
                                     causal: bool = True,
                                     window: int = 0) -> torch.Tensor:
    """The Pallas body's arithmetic in plain PyTorch (f32 throughout): per
    query block, an online softmax over the nb selected key blocks in
    order, with p zero under the mask."""
    b, hq, lq, hd = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    g = hq // hkv
    n_qb, n_kb = lq // block_q, lk // block_k
    dev = q.device
    qf = q.float().reshape(b, hkv, g, n_qb, block_q, hd) * hd ** -0.5
    kb = k.float().reshape(b, hkv, n_kb, block_k, hd)
    vb = v.float().reshape(b, hkv, n_kb, block_k, hd)
    qpos = (torch.arange(n_qb, device=dev)[:, None] * block_q
            + torch.arange(block_q, device=dev)[None, :])     # (nQb, Bq)
    m = torch.full((b, hkv, g, n_qb, block_q), NEG, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, n_qb, block_q, hd), device=dev)
    for j in range(idx.shape[-1]):
        blk = idx[:, :, j].long()                               # (B, nQb)
        sel = blk[:, None, :, None, None].expand(b, hkv, n_qb, block_k, hd)
        kj = torch.gather(kb, 2, sel)                       # (B,Hkv,nQb,Bk,hd)
        vj = torch.gather(vb, 2, sel)
        kpos = (blk[..., None] * block_k
                + torch.arange(block_k, device=dev))            # (B,nQb,Bk)
        mask = valid[:, :, j].bool()[:, :, None, None].expand(
            b, n_qb, block_q, block_k)
        if causal:
            mask = mask & (kpos[:, :, None, :] <= qpos[None, :, :, None])
        if window:
            mask = mask & (kpos[:, :, None, :] > qpos[None, :, :, None]
                           - window)
        s = torch.einsum("bhgqid,bhqkd->bhgqik", qf, kj)
        mk = mask[:, None, None]
        s = torch.where(mk, s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(mk, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = (acc * alpha[..., None]
               + torch.einsum("bhgqik,bhqkd->bhgqid", p, vj))
        m = m_new
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.reshape(b, hq, lq, hd).to(q.dtype)


def dsa_block_sparse_attention(q, k, v, idx, valid, *, block_q: int = 128,
                               block_k: int = 128, causal: bool = True,
                               window: int = 0) -> torch.Tensor:
    """q: (B,Hq,Lq,hd); k/v: (B,Hkv,Lk,hd); idx/valid: (B,nQb,nb)."""
    LN.refuse_grad("K2 (dsa_block_sparse_attention)", q, k, v)
    if q.device.type == "cpu":
        return dsa_block_sparse_attention_plain(
            q, k, v, idx, valid, block_q=block_q, block_k=block_k,
            causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    dev = q.device
    b, hq, lq, hd = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    nb = idx.shape[-1]
    if (hq % hkv or hd % 16 or hd > 128 or block_q % 8 or block_q > 128
            or lq % block_q or lk % block_k):
        raise ValueError(f"unsupported shape q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} blocks=({block_q}, {block_k})")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must share one dtype")
    for name, t in (("q", q), ("k", k), ("v", v)):
        LN.check_cuda_operand(name, t, dev)
    if q.dtype == torch.bfloat16 and (
            block_q % 16 or block_k % 16
            or any(s % 8 for t in (q, k, v) for s in t.stride()[:-1])):
        raise ValueError("the bf16 tensor-core body takes blocks of a "
                         "multiple of 16 rows and 16-byte aligned rows; got "
                         f"blocks ({block_q}, {block_k}), strides "
                         f"{q.stride()}, {k.stride()}, {v.stride()}")
    idx32 = LN.check_index("idx", idx, dev)
    ok32 = LN.check_index("valid", valid, dev)
    # written in (B, Lq, Hq, hd) memory so ops' transpose back is free
    out = torch.empty((b, lq, hq, hd), dtype=q.dtype,
                      device=dev).transpose(1, 2)
    fn = LN.bind("dsa_attention", "dsa_attention_launch",
                 [LN.I, LN.P, LN.L, LN.L, LN.L, LN.P, LN.L, LN.L, LN.L,
                  LN.P, LN.L, LN.L, LN.L, LN.P, LN.P, LN.L, LN.L, LN.P,
                  LN.L, LN.L, LN.L] + [LN.I] * 11 + [LN.F, LN.P])
    qs, ks, vs, os_ = q.stride(), k.stride(), v.stride(), out.stride()
    err = fn(LN.DTYPE_CODE[q.dtype],
             q.data_ptr(), qs[0], qs[1], qs[2],
             k.data_ptr(), ks[0], ks[1], ks[2],
             v.data_ptr(), vs[0], vs[1], vs[2],
             idx32.data_ptr(), ok32.data_ptr(), idx32.stride(0),
             idx32.stride(1), out.data_ptr(), os_[0], os_[1], os_[2],
             b, hq, hkv, lq, lk, hd, nb, block_q, block_k, int(causal),
             int(window), hd ** -0.5, LN.stream_handle(dev))
    LN.raise_on_error("dsa_attention", err)
    dsa_block_sparse_attention.launches += 1
    return out


LN.counters(dsa_block_sparse_attention, "launches")
