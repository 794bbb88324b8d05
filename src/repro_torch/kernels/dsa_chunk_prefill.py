"""K3 and K5 — DSA chunk-prefill gather-attend over a dense cache (K3) or a
flat page pool (K5): CUDA kernels, wrappers and plain versions.

K3 replaces the Pallas TPU kernel
``src/repro/kernels/dsa_chunk_prefill.py::dsa_chunk_gather_attention``
(body ``_kernel``), K5 ``dsa_chunk_paged_gather_attention`` (body
``_paged_kernel``).  K5 runs K3's body with the rows of each selected
block found through the physical page stream ``pidx``, so it equals K3
bitwise on a pool that holds the dense cache's blocks; no model path runs
it (the chunk path's staging caches are dense).  K3q and K5q (the bodies
``_quant_kernel`` and ``_paged_quant_kernel``) are the same wrappers given
an int8 or float8_e4m3fn cache and its per-(row, head) f32 scales: the
kernel widens each tile's rows to f32 once in shared memory, so K3q
equals K3 bitwise on the f32 cache ``dequant(k, k_scale)``.  Each wrapper
counts its launches per variant: ``launches`` (full-width cache) and
``launches_quant``.

The CUDA source is ``csrc/dsa_chunk_prefill.cu``.  Its header note says
what bounds the kernel on the H100: operations at f32, because the main
path feeds bf16 queries against the f32 cache.  It says what held the
first design back: four threads per (query row, head) read one float
from shared memory per FMA, and K/V tiles were staged without overlap,
0.847 ms against a 0.155 ms bound.  And it says what the redesign does:
128 (row, head) pairs a CTA, 64-key K/V tiles double-buffered with
``cp.async``, and register-blocked 8 x 4 (S) and 8 x 8 (p.V) micro-tiles
on the f32 FMA pipe.  The kernel takes GQA groups of up to 16 heads and
cache rows on 16-byte boundaries.

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
  k/v_scale: (B, S, Hkv)      f32 scales of an int8/fp8 cache, or None
  out:     (B, Hq, C, hd)     in q's dtype, stored in (B, C, Hq, hd)
                              memory so the ops transpose back is free

K5 takes k/v pools (P * block_k, Hkv, hd), pidx laid out as idx, and
scales (P * block_k, Hkv).

Key k_pos is live for query row i iff ok, k_pos <= q_off + i and
k_pos < kv_len; p is zero under the mask, so a row with no live key
comes out 0, as in the Pallas body.  On a CPU tensor the wrapper runs the
plain version; on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantization import take_rows
from repro_torch.kernels import _launch as LN

NEG = -1e30


def _plain_body(q, hkv: int, q_off, blocks, block_q: int) -> torch.Tensor:
    """The Pallas body's arithmetic (f32 throughout): per chunk query
    block, an online softmax over its selected blocks in order, with p
    zero under the mask.  ``blocks`` yields, per selected block, its key
    positions kpos (B,nQb,Bk), f32 rows k/v (B,nQb,Bk,Hkv,hd) and live
    keys (B,nQb,Bk)."""
    b, hq, c, hd = q.shape
    g = hq // hkv
    n_qb = c // block_q
    dev = q.device
    qf = q.float().reshape(b, hkv, g, n_qb, block_q, hd) * hd ** -0.5
    qpos = (q_off.long()[:, None, None]
            + (torch.arange(n_qb, device=dev)[:, None] * block_q
               + torch.arange(block_q, device=dev)[None, :])[None])
    m = torch.full((b, hkv, g, n_qb, block_q), NEG, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, n_qb, block_q, hd), device=dev)
    for kpos, kj, vj, live in blocks:
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


def dsa_chunk_gather_attention_plain(q, k_cache, v_cache, idx, ok, q_off,
                                     kv_len, *, block_q: int = 128,
                                     block_k: int = 128, k_scale=None,
                                     v_scale=None) -> torch.Tensor:
    """K3's arithmetic in plain PyTorch: keys live iff ok, causal, < kv_len
    and < S.  With scales (K3q) the gathered rows are dequantized first."""
    b, s_len = k_cache.shape[:2]
    dev = q.device
    rows_b = torch.arange(b, device=dev)[:, None, None]
    offs = torch.arange(block_k, device=dev)

    def blocks():
        for j in range(idx.shape[-1]):
            kpos = idx[:, :, j].long()[..., None] * block_k + offs
            rows = kpos.clamp(max=s_len - 1)
            live = ((kpos < kv_len.long()[:, None, None]) & (kpos < s_len)
                    & ok[:, :, j, None].bool())
            yield (kpos, take_rows(k_cache, k_scale, rows_b, rows),
                   take_rows(v_cache, v_scale, rows_b, rows), live)
    return _plain_body(q, k_cache.shape[2], q_off, blocks(), block_q)


def dsa_chunk_paged_gather_attention_plain(q, k_pool, v_pool, idx, pidx, ok,
                                           q_off, kv_len, *,
                                           block_q: int = 128,
                                           block_k: int = 128, k_scale=None,
                                           v_scale=None) -> torch.Tensor:
    """K5's arithmetic in plain PyTorch: K3's, with block j's rows read
    from pool page pidx[..., j] and masked by their logical positions."""
    offs = torch.arange(block_k, device=q.device)

    def blocks():
        for j in range(idx.shape[-1]):
            kpos = idx[:, :, j].long()[..., None] * block_k + offs
            rows = pidx[:, :, j].long()[..., None] * block_k + offs
            live = ((kpos < kv_len.long()[:, None, None])
                    & ok[:, :, j, None].bool())
            yield (kpos, take_rows(k_pool, k_scale, rows),
                   take_rows(v_pool, v_scale, rows), live)
    return _plain_body(q, k_pool.shape[1], q_off, blocks(), block_q)


def _launch(fn_name: str, q, k, v, idx, pidx, ok, q_off, kv_len,
            block_q: int, block_k: int, cache_strides, s_len: int, k_scale,
            v_scale) -> torch.Tensor:
    """Check the operands and launch K3 (pidx None) or K5 on q's card."""
    dev = q.device
    b, hq, c, hd = q.shape
    hkv = k.shape[-2]
    nb = idx.shape[-1]
    if (hq % hkv or hq // hkv > 16 or hd % 16 or hd > 128 or block_q % 8
            or c % block_q or block_k < 1 or idx.shape[1] != c // block_q):
        raise ValueError(f"unsupported chunk shape q={tuple(q.shape)} "
                         f"cache={tuple(k.shape)} idx={tuple(idx.shape)} "
                         f"blocks=({block_q}, {block_k})")
    if k.stride() != v.stride() or k.dtype != v.dtype:
        raise ValueError("k and v caches must share strides and dtype")
    LN.check_cuda_operand("q", q, dev)
    LN.check_cuda_operand("k_cache", k, dev)
    LN.check_cuda_operand("v_cache", v, dev)
    LN.check_copy_rows("k_cache", k)
    idx32 = LN.check_index("idx", idx, dev)
    ok32 = LN.check_index("ok", ok, dev)
    qo = LN.check_index("q_off", q_off, dev)
    kvl = LN.check_index("kv_len", kv_len, dev)
    scales, scale_strides = LN.check_scales(k, k_scale, v_scale, dev)
    streams = [idx32.data_ptr()]
    if pidx is not None:
        pidx32 = LN.check_index("pidx", pidx, dev)
        if pidx32.stride() != idx32.stride():
            raise ValueError("idx and pidx must share one layout")
        streams.append(pidx32.data_ptr())
    streams.append(ok32.data_ptr())
    out = torch.empty((b, c, hq, hd), dtype=q.dtype,
                      device=dev).transpose(1, 2)
    dims = [b, hq, hkv, c] + ([s_len] if pidx is None else []) + [
        hd, nb, block_q, block_k]
    qs, os_ = q.stride(), out.stride()
    args = ([LN.DTYPE_CODE[q.dtype], LN.DTYPE_CODE[k.dtype], q.data_ptr(),
             qs[0], qs[1], qs[2], k.data_ptr(), v.data_ptr(), *cache_strides,
             *scales, *scale_strides, *streams, idx32.stride(0),
             idx32.stride(1), qo.data_ptr(), kvl.data_ptr(), out.data_ptr(),
             os_[0], os_[1], os_[2]] + dims + [hd ** -0.5,
                                                LN.stream_handle(dev)])
    types = ([LN.I, LN.I, LN.P, LN.L, LN.L, LN.L, LN.P, LN.P]
             + [LN.L] * len(cache_strides) + [LN.P, LN.P]
             + [LN.L] * len(scale_strides) + [LN.P] * len(streams)
             + [LN.L, LN.L, LN.P, LN.P, LN.P, LN.L, LN.L, LN.L]
             + [LN.I] * len(dims) + [LN.F, LN.P])
    err = LN.bind("dsa_chunk_prefill", fn_name, types)(*args)
    LN.raise_on_error(fn_name, err)
    return out


def dsa_chunk_gather_attention(q, k_cache, v_cache, idx, ok, q_off, kv_len,
                               *, block_q: int = 128, block_k: int = 128,
                               k_scale=None, v_scale=None) -> torch.Tensor:
    """K3 (K3q with scales).  q: (B,Hq,C,hd); k/v cache: (B,S,Hkv,hd);
    idx/ok: (B,C//block_q,nb); q_off/kv_len: (B,); k/v_scale: (B,S,Hkv)
    f32 or None.  Returns (B,Hq,C,hd) in q's dtype."""
    LN.refuse_grad("K3 (dsa_chunk_gather_attention)", q, k_cache, v_cache,
                   k_scale, v_scale)
    if q.device.type == "cpu":
        return dsa_chunk_gather_attention_plain(
            q, k_cache, v_cache, idx, ok, q_off, kv_len, block_q=block_q,
            block_k=block_k, k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    out = _launch("dsa_chunk_prefill_launch", q, k_cache, v_cache, idx, None,
                  ok, q_off, kv_len, block_q, block_k, k_cache.stride()[:3],
                  k_cache.shape[1], k_scale, v_scale)
    LN.count(dsa_chunk_gather_attention, k_scale)
    return out


def dsa_chunk_paged_gather_attention(q, k_pool, v_pool, idx, pidx, ok,
                                     q_off, kv_len, *, block_q: int = 128,
                                     block_k: int = 128, k_scale=None,
                                     v_scale=None) -> torch.Tensor:
    """K5 (K5q with scales).  q: (B,Hq,C,hd); k/v pool: (P*block_k,Hkv,hd);
    idx/pidx/ok: (B,C//block_q,nb) logical blocks, physical pages,
    validity; q_off/kv_len: (B,); k/v_scale: (P*block_k,Hkv) f32 or None.
    Returns (B,Hq,C,hd) in q's dtype."""
    LN.refuse_grad("K5 (dsa_chunk_paged_gather_attention)", q, k_pool,
                   v_pool, k_scale, v_scale)
    if q.device.type == "cpu":
        return dsa_chunk_paged_gather_attention_plain(
            q, k_pool, v_pool, idx, pidx, ok, q_off, kv_len, block_q=block_q,
            block_k=block_k, k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if k_pool.dim() != 3 or k_pool.shape[0] % block_k:
        raise ValueError(f"the pool {tuple(k_pool.shape)} is not whole "
                         f"pages of {block_k} rows")
    out = _launch("dsa_chunk_prefill_paged_launch", q, k_pool, v_pool, idx,
                  pidx, ok, q_off, kv_len, block_q, block_k,
                  k_pool.stride()[:2], 0, k_scale, v_scale)
    LN.count(dsa_chunk_paged_gather_attention, k_scale)
    return out


for _fn in (dsa_chunk_gather_attention, dsa_chunk_paged_gather_attention):
    LN.counters(_fn, "launches", "launches_quant")
