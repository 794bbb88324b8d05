"""Attention primitives (full / masked / DSA-sparse), plain PyTorch.

All functions take q: (B, Lq, Hq, hd), k/v: (B, Lk, Hkv, hd) with
Hq % Hkv == 0 (GQA).

  dense_attention             materialised scores; Eq.(4) masking via
                              S - c(1-M).  Small shapes, the token path.
  flash_attention             q-chunked loop, never materialises Lq x Lk.
  dsa_sparse_attention        visits only the predicted key blocks; the
                              plain twin of kernels.dsa_attention (K2).
  decode_attention            dense decode over the whole cache.
  dsa_decode_attention        token-granularity DSA decode: top-k cache
                              rows by predicted score + the trailing
                              window, gathered (the paper's decode).
  dsa_decode_block_attention  block-gather decode over the selected cache
                              blocks; the plain twin of kernels.dsa_decode
                              (K1).
  dsa_decode_paged_block_attention
                              the same over a flat page pool; the plain
                              twin of kernels.dsa_decode_paged (K4).
  chunk_attention             C chunk queries against a cache prefix.
  dsa_chunk_block_attention   block-gather chunk prefill; the plain twin
                              of kernels.dsa_chunk_prefill (K3).

dtypes follow jnp's promotion: a bf16 query against an f32 cache computes
and returns f32, as in the JAX reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.prediction import einsum
from repro_torch.core.quantization import from_raw, raw

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


def _dequant_rows(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Dequantize gathered int8/fp8 cache rows: per-(row, head) f32 scales
    broadcast over the trailing head_dim axis (only the visited rows come
    back to full precision)."""
    return x.float() * scale.float()[..., None]


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
    """x: (B, n_kb*block, ...); idx: (B, nb) -> (B, nb*block, ...).  fp8
    rows travel as bytes (``core.quantization.raw``)."""
    r = raw(x)
    b, s = r.shape[:2]
    rest = r.shape[2:]
    xb = r.reshape(b, s // block, block, *rest)
    ix = idx.long().reshape(b, -1, *([1] * (1 + len(rest))))
    g = torch.gather(xb, 1, ix.expand(b, idx.shape[1], block, *rest))
    return from_raw(g.reshape(b, idx.shape[1] * block, *rest), x)


def _pad_rows(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad axis 1 of ``x`` by ``pad`` rows (fp8 as bytes)."""
    r = torch.nn.functional.pad(raw(x), (0, 0) * (x.dim() - 2) + (0, pad))
    return from_raw(r, x)


def _gather_dequant(x, scale, idx, block: int) -> torch.Tensor:
    """``_gather_blocks`` of a cache and, with ``scale``, of its per-row
    scales, dequantized after the gather."""
    g = _gather_blocks(x, idx, block)
    return g if scale is None else _dequant_rows(
        g, _gather_blocks(scale, idx, block))


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
                     kv_len: Optional[torch.Tensor] = None,
                     window: int = 0) -> torch.Tensor:
    """Single-step decode: q (B, 1, Hq, hd) vs cache (B, S, Hkv, hd).
    kv_len: (B,) valid cache length (current position + 1).  ``window``
    (with kv_len) keeps only the last ``window`` slots below kv_len: a
    SLOT-positional mask, right only while slot order is token order (a
    cache larger than the window, before it wraps)."""
    b = q.shape[0]
    s_len = k_cache.shape[1]
    s = _gqa_scores(q, k_cache)                   # (B,Hkv,G,1,S)
    kj = torch.arange(s_len, device=q.device)[None, :]
    m = torch.ones((b, s_len), dtype=torch.bool, device=q.device)
    if kv_len is not None:
        m &= kj < kv_len[:, None]
        if window:
            m &= kj >= kv_len[:, None] - window
    s = torch.where(m[:, None, None, None], s, NEG)
    p = _softmax_f32(s)
    return _gqa_out(p.to(v_cache.dtype), v_cache)


def dsa_decode_attention(q, k_cache, v_cache, scores_tilde, *, keep: int,
                         kv_len: Optional[torch.Tensor] = None,
                         local: int = 64) -> torch.Tensor:
    """Token-granularity DSA decode: the top-``keep`` cache rows by
    predicted score plus the trailing ``local`` rows, gathered, then
    attended.  scores_tilde: (B, S) predicted scores of the step's query
    against the predicted-key cache; a static keep + local rows are
    gathered, those past kv_len masked.

    The selection sorts stably in descending order, so ties go to the
    lower index, as ``lax.top_k``'s do: the gathered rows and their order
    are the reference's."""
    b = q.shape[0]
    s_len = k_cache.shape[1]
    kj = torch.arange(s_len, device=q.device)[None, :]
    if kv_len is None:
        valid = torch.ones((b, s_len), dtype=torch.bool, device=q.device)
        recent = valid
    else:
        valid = kj < kv_len[:, None]
        recent = (kj >= kv_len[:, None] - local) & valid
    st = torch.where(valid & ~recent, scores_tilde.float(),
                     torch.where(recent, float("inf"), NEG))
    n_keep = min(keep + local, s_len)
    idx = torch.sort(st, dim=-1, descending=True,
                     stable=True).indices[:, :n_keep]          # (B, n_keep)
    ok = torch.gather(valid, 1, idx)
    ks = torch.take_along_dim(k_cache, idx[:, :, None, None], dim=1)
    vs = torch.take_along_dim(v_cache, idx[:, :, None, None], dim=1)
    s = _gqa_scores(q, ks)                        # (B,Hkv,G,1,n_keep)
    s = torch.where(ok[:, None, None, None], s, NEG)
    p = _softmax_f32(s)
    return _gqa_out(p.to(v_cache.dtype), vs)


def dsa_decode_block_attention(q, k_cache, v_cache, idx, idx_valid, *,
                               block_k: int,
                               kv_len: Optional[torch.Tensor] = None,
                               k_scale: Optional[torch.Tensor] = None,
                               v_scale: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Block-gather DSA decode.

    q: (B, 1, Hq, hd); k/v cache: (B, S, Hkv, hd); idx/idx_valid: (B, nb)
    selected cache-block indices (block j = cache rows [j*block_k,
    (j+1)*block_k)).  Positions past kv_len are masked.  With every valid
    block selected this equals decode_attention.  k_scale/v_scale:
    optional (B, S, Hkv) per-row scales of an int8/fp8 cache, gathered
    alongside and dequantized after the gather.
    """
    b = q.shape[0]
    s_len = k_cache.shape[1]
    nb = idx.shape[-1]
    n_kb = -(-s_len // block_k)
    pad = n_kb * block_k - s_len
    if pad:
        k_cache, v_cache = _pad_rows(k_cache, pad), _pad_rows(v_cache, pad)
        if k_scale is not None:
            k_scale, v_scale = (_pad_rows(k_scale, pad),
                                _pad_rows(v_scale, pad))
    ks = _gather_dequant(k_cache, k_scale, idx, block_k)
    vs = _gather_dequant(v_cache, v_scale, idx, block_k)
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


def dsa_decode_paged_block_attention(q, k_pool, v_pool, idx, pidx,
                                     idx_valid, *, block_k: int,
                                     kv_len: torch.Tensor,
                                     k_scale: Optional[torch.Tensor] = None,
                                     v_scale: Optional[torch.Tensor] = None
                                     ) -> torch.Tensor:
    """Paged twin of ``dsa_decode_block_attention``: the cache is a flat
    physical page pool shared by all slots.

    q: (B, 1, Hq, hd); k/v pool: (P*block_k, Hkv, hd), page p owning rows
    [p*block_k, (p+1)*block_k); idx: (B, nb) selected LOGICAL blocks (they
    carry the key positions); pidx: (B, nb) the same selection as physical
    pages.  Gathers page pidx and masks from the logical positions, so a
    pool whose mapped pages hold the dense cache's blocks gives
    ``dsa_decode_block_attention`` on that cache.  k_scale/v_scale:
    optional (P*block_k, Hkv) per-row scales of an int8/fp8 pool.
    """
    b = q.shape[0]
    nb = idx.shape[-1]

    def pages(x):
        r = raw(x)
        g = r.reshape(-1, block_k, *r.shape[1:])[pidx.long()]
        return from_raw(g.reshape(b, nb * block_k, *r.shape[1:]), x)

    ks, vs = pages(k_pool), pages(v_pool)
    if k_scale is not None:
        ks = _dequant_rows(ks, pages(k_scale))
        vs = _dequant_rows(vs, pages(v_scale))
    kpos = (idx.long()[:, :, None] * block_k + torch.arange(
        block_k, device=q.device)[None, None, :]).reshape(b, nb * block_k)
    m = idx_valid[:, :, None].expand(b, nb, block_k).reshape(b, nb * block_k)
    m = m & (kpos < kv_len[:, None])
    s = _gqa_scores(q, ks)                          # (B,Hkv,G,1,nb*Bk)
    s = torch.where(m[:, None, None, None], s, NEG)
    p = _softmax_f32(s)
    return _gqa_out(p.to(vs.dtype), vs)


def chunk_attention(q, k_cache, v_cache, q_pos: torch.Tensor, *,
                    token_mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Chunk-append attention: C fresh queries against a cache prefix.

    q: (B, C, Hq, hd); k/v cache: (B, S, Hkv, hd), sliced by the caller to
    the selection geometry (the prompt bucket); q_pos: (B, C) global query
    positions.  Key row j is visible to query (b, i) iff j <= q_pos[b, i]:
    whole-prompt prefill's causal mask restricted to these rows.
    token_mask: optional (B, C, S) DSA keep mask applied on top.
    """
    s_len = k_cache.shape[1]
    s = _gqa_scores(q, k_cache)                        # (B,Hkv,G,C,S)
    kj = torch.arange(s_len, device=q.device)[None, None, :]
    m = kj <= q_pos[:, :, None]                        # (B, C, S)
    s = torch.where(m[:, None, None], s, NEG)
    if token_mask is not None:
        s = torch.where(token_mask[:, None, None], s, NEG)
    p = _softmax_f32(s)
    return _gqa_out(p.to(v_cache.dtype), v_cache)


def dsa_chunk_block_attention(q, k_cache, v_cache, idx, idx_valid, *,
                              block_q: int, block_k: int,
                              q_offset: torch.Tensor,
                              kv_len: Optional[torch.Tensor] = None,
                              k_scale: Optional[torch.Tensor] = None,
                              v_scale: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Block-gather DSA chunk prefill.

    q: (B, C, Hq, hd) chunk queries; k/v cache: (B, S, Hkv, hd); idx/ok:
    (B, C/block_q, nb) selected cache blocks per chunk query block;
    q_offset: (B,) the chunk's global start; kv_len: optional (B,) valid
    cache rows.  Per query block: the gather + masked softmax of
    ``dsa_sparse_attention`` with the query positions shifted by q_offset.
    k_scale/v_scale: optional (B, S, Hkv) per-row scales of an int8/fp8
    cache (dequantized after the gather).
    """
    b, c, hq, hd = q.shape
    s_len = k_cache.shape[1]
    nb = idx.shape[-1]
    n_kb = -(-s_len // block_k)
    pad = n_kb * block_k - s_len
    if pad:
        k_cache, v_cache = _pad_rows(k_cache, pad), _pad_rows(v_cache, pad)
        if k_scale is not None:
            k_scale, v_scale = (_pad_rows(k_scale, pad),
                                _pad_rows(v_scale, pad))
    dev = q.device
    outs = []
    for qb_i in range(c // block_q):
        qc = q[:, qb_i * block_q:(qb_i + 1) * block_q]
        ib = idx[:, qb_i]
        ks = _gather_dequant(k_cache, k_scale, ib, block_k)
        vs = _gather_dequant(v_cache, v_scale, ib, block_k)
        s = _gqa_scores(qc, ks)                   # (B,Hkv,G,Bq,nb*Bk)
        kpos = (ib.long()[:, :, None] * block_k + torch.arange(
            block_k, device=dev)[None, None, :]).reshape(b, nb * block_k)
        qpos = (q_offset.long()[:, None] + qb_i * block_q
                + torch.arange(block_q, device=dev)[None, :])   # (B, Bq)
        ok = idx_valid[:, qb_i, :, None].expand(b, nb, block_k).reshape(
            b, nb * block_k)
        m = ok[:, None, :] & (kpos[:, None, :] <= qpos[:, :, None])
        if kv_len is not None:
            m = m & (kpos[:, None, :] < kv_len[:, None, None])
        s = torch.where(m[:, None, None], s, NEG)
        p = _softmax_f32(s)
        outs.append(_gqa_out(p.to(vs.dtype), vs))
    return torch.cat(outs, dim=1).reshape(b, c, hq, -1)
