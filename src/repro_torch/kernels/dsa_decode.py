"""K1 — DSA decode gather-attend: CUDA kernel, wrapper and plain version.

Replaces the Pallas TPU kernel
``src/repro/kernels/dsa_decode.py::dsa_decode_gather_attention`` (body
``_kernel``).  The CUDA source is ``csrc/dsa_decode.cu``; its header note
says what bounds the kernel on the H100 (bytes: the selected K/V rows)
and how the design answers it (one warp per 32-row tile of the selection
serves the whole GQA group from one read of its rows; a second small
kernel merges the warps' partial softmax states).

Layouts (kernel-native; ``kernels.ops.dsa_decode`` adapts model layout):

  q:       (B, Hq, 1, hd)     current query token, per head; any strides
                              with a unit hd stride (the ops transpose is
                              a view)
  k/v:     (B, S, Hkv, hd)    KV cache in its natural engine layout, S
                              need not be a block multiple
  idx/ok:  (B, nb)            selected cache-block indices + validity
  kv_len:  (B,)               valid cache rows per batch row
  out:     (B, Hq, 1, hd)     in q's dtype

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _launch as LN

NEG = -1e30


def dsa_decode_gather_attention_plain(q, k_cache, v_cache, idx, ok, kv_len,
                                      *, block_k: int = 128) -> torch.Tensor:
    """The Pallas body's arithmetic in plain PyTorch: visit the nb
    selected blocks in order with an f32 online softmax, p explicitly zero
    under the mask (rows >= kv_len or >= S, blocks with ok = 0)."""
    b, hq, _, hd = q.shape
    s_len, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    dev = q.device
    scale = hd ** -0.5
    qf = q[:, :, 0].float().reshape(b, hkv, g, hd) * scale
    m = torch.full((b, hkv, g), NEG, device=dev)
    l = torch.zeros((b, hkv, g), device=dev)
    acc = torch.zeros((b, hkv, g, hd), device=dev)
    rows_b = torch.arange(b, device=dev)[:, None]
    offs = torch.arange(block_k, device=dev)[None, :]
    for j in range(idx.shape[-1]):
        kpos = idx[:, j].long()[:, None] * block_k + offs        # (B, Bk)
        rows = kpos.clamp(max=s_len - 1)
        kb = k_cache[rows_b, rows].float()                       # (B,Bk,Hkv,hd)
        vb = v_cache[rows_b, rows].float()
        mask = ((kpos < kv_len[:, None]) & (kpos < s_len)
                & ok[:, j, None].bool())
        s = torch.einsum("bhgd,bkhd->bhgk", qf, kb)
        s = torch.where(mask[:, None, None], s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask[:, None, None],
                        torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgk,bkhd->bhgd", p, vb)
        m = m_new
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.reshape(b, hq, 1, hd).to(q.dtype)


def dsa_decode_gather_attention(q, k_cache, v_cache, idx, ok, kv_len, *,
                                block_k: int = 128) -> torch.Tensor:
    """q: (B,Hq,1,hd); k/v cache: (B,S,Hkv,hd); idx/ok: (B,nb);
    kv_len: (B,).  Returns (B,Hq,1,hd) in q's dtype."""
    if q.device.type == "cpu":
        return dsa_decode_gather_attention_plain(q, k_cache, v_cache, idx,
                                                 ok, kv_len, block_k=block_k)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    dev = q.device
    b, hq, one, hd = q.shape
    s_len, hkv = k_cache.shape[1], k_cache.shape[2]
    nb = idx.shape[-1]
    if one != 1 or hq % hkv or hd % 16 or hd > 128:
        raise ValueError(f"unsupported decode shape q={tuple(q.shape)} "
                         f"cache={tuple(k_cache.shape)}")
    if k_cache.stride() != v_cache.stride() or k_cache.dtype != v_cache.dtype:
        raise ValueError("k and v caches must share strides and dtype")
    LN.check_cuda_operand("q", q, dev)
    LN.check_cuda_operand("k_cache", k_cache, dev)
    LN.check_cuda_operand("v_cache", v_cache, dev)
    idx32 = LN.check_index("idx", idx, dev)
    ok32 = LN.check_index("ok", ok, dev)
    kvl = LN.check_index("kv_len", kv_len, dev)
    out = torch.empty((b, hq, 1, hd), dtype=q.dtype, device=dev)
    # one partial softmax state (m, l, acc[hd]) per 32-row tile and head
    n_tiles = nb * -(-block_k // 32)
    ws = torch.empty(b * hq * n_tiles * (hd + 2), dtype=torch.float32,
                     device=dev)
    fn = LN.bind("dsa_decode", "dsa_decode_launch",
                 [LN.I, LN.I, LN.P, LN.L, LN.L, LN.P, LN.P, LN.L, LN.L,
                  LN.L, LN.P, LN.P, LN.L, LN.P, LN.P, LN.P, LN.L, LN.L,
                  LN.I, LN.I, LN.I, LN.I, LN.I, LN.I, LN.I, LN.F, LN.P])
    cs = k_cache.stride()
    err = fn(LN.DTYPE_CODE[q.dtype], LN.DTYPE_CODE[k_cache.dtype],
             q.data_ptr(), q.stride(0), q.stride(1),
             k_cache.data_ptr(), v_cache.data_ptr(), cs[0], cs[1], cs[2],
             idx32.data_ptr(), ok32.data_ptr(), idx32.stride(0),
             kvl.data_ptr(), ws.data_ptr(), out.data_ptr(), out.stride(0),
             out.stride(1),
             b, hq, hkv, s_len, hd, nb, block_k, hd ** -0.5,
             LN.stream_handle(dev))
    LN.raise_on_error("dsa_decode", err)
    dsa_decode_gather_attention.launches += 1
    return out


dsa_decode_gather_attention.launches = 0
