"""K1 and K4 — DSA decode gather-attend over a dense cache (K1) or a flat
page pool (K4): CUDA kernels, wrappers and plain versions.

K1 replaces the Pallas TPU kernel
``src/repro/kernels/dsa_decode.py::dsa_decode_gather_attention`` (body
``_kernel``), K4 ``dsa_decode_paged_gather_attention`` (body
``_paged_kernel``).  The CUDA source of both is ``csrc/dsa_decode.cu``.
Its header note says what bounds the kernels on the H100: bytes, the
selected K/V rows.  It says what held the first design back: at K1's
shape the call took 62 us, the partial kernel 30.9 us of it and a merge
kernel on 16 CTAs 21.2 us.  And it says what the redesign does: one CTA
per 64-row tile of the selection copies its K and V rows into shared
memory with ``cp.async``, serves the whole GQA group from that copy, and
the last CTA of each (b, KV head) merges the partial softmax states,
found through a ticket in the workspace.  The wrapper keeps that
workspace per device and stream, because the kernel leaves its tickets
zero for the next call.  K4 runs K1's body with the rows of each
selected block found through the physical page stream ``pidx``, so it
equals K1 bitwise on a pool that holds the dense cache's blocks.

K1q and K4q (the Pallas bodies ``_quant_kernel`` and
``_paged_quant_kernel``) are the same wrappers given an int8 or
float8_e4m3fn cache and its per-(row, head) f32 scales ``k_scale``/
``v_scale``: the kernel dequantizes each row as it loads it, so K1q
equals K1 bitwise on the f32 cache ``dequant(k, k_scale)``.  Each wrapper
counts its launches per variant: ``launches`` (full-width cache) and
``launches_quant``.

Layouts (kernel-native; ``kernels.ops.dsa_decode`` adapts model layout):

  q:       (B, Hq, 1, hd)     current query token, per head; any strides
                              with a unit hd stride (the ops transpose is
                              a view)
  k/v:     (B, S, Hkv, hd)    KV cache in its natural engine layout, S
                              need not be a block multiple
  idx/ok:  (B, nb)            selected cache-block indices + validity
  kv_len:  (B,)               valid cache rows per batch row
  k/v_scale: (B, S, Hkv)      f32 scales of an int8/fp8 cache, or None
  out:     (B, Hq, 1, hd)     in q's dtype

K4 takes k/v pools (P * block_k, Hkv, hd), page p owning rows
[p * block_k, (p + 1) * block_k), and pidx (B, nb), the physical page of
each selected logical block idx, and scales (P * block_k, Hkv).

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantization import take_rows
from repro_torch.kernels import _launch as LN

NEG = -1e30


def _plain_body(q, hkv: int, blocks) -> torch.Tensor:
    """The Pallas body's arithmetic: visit the selected blocks in order
    with an f32 online softmax, p explicitly zero under the mask.
    ``blocks`` yields (k rows (B,Bk,Hkv,hd), v rows, mask (B,Bk))."""
    b, hq, _, hd = q.shape
    dev = q.device
    g = hq // hkv
    qf = q[:, :, 0].float().reshape(b, hkv, g, hd) * hd ** -0.5
    m = torch.full((b, hkv, g), NEG, device=dev)
    l = torch.zeros((b, hkv, g), device=dev)
    acc = torch.zeros((b, hkv, g, hd), device=dev)
    for kb, vb, mask in blocks:
        s = torch.einsum("bhgd,bkhd->bhgk", qf, kb.float())
        s = torch.where(mask[:, None, None], s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask[:, None, None],
                        torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgk,bkhd->bhgd", p,
                                                    vb.float())
        m = m_new
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.reshape(b, hq, 1, hd).to(q.dtype)


def dsa_decode_gather_attention_plain(q, k_cache, v_cache, idx, ok, kv_len,
                                      *, block_k: int = 128, k_scale=None,
                                      v_scale=None) -> torch.Tensor:
    """K1's arithmetic in plain PyTorch: masked are rows >= kv_len or >= S
    and blocks with ok = 0.  With scales (K1q) the gathered rows are
    dequantized first."""
    b, s_len = k_cache.shape[0], k_cache.shape[1]
    dev = q.device
    rows_b = torch.arange(b, device=dev)[:, None]
    offs = torch.arange(block_k, device=dev)[None, :]

    def blocks():
        for j in range(idx.shape[-1]):
            kpos = idx[:, j].long()[:, None] * block_k + offs    # (B, Bk)
            rows = kpos.clamp(max=s_len - 1)
            mask = ((kpos < kv_len[:, None]) & (kpos < s_len)
                    & ok[:, j, None].bool())
            yield (take_rows(k_cache, k_scale, rows_b, rows),
                   take_rows(v_cache, v_scale, rows_b, rows), mask)
    return _plain_body(q, k_cache.shape[2], blocks())


def dsa_decode_paged_gather_attention_plain(q, k_pool, v_pool, idx, pidx, ok,
                                            kv_len, *, block_k: int = 128,
                                            k_scale=None, v_scale=None
                                            ) -> torch.Tensor:
    """K4's arithmetic in plain PyTorch: K1's, with block j's rows read
    from pool page pidx[:, j] and masked by their logical position
    idx[:, j] * block_k + r < kv_len.  With scales (K4q) the gathered
    rows are dequantized first."""
    offs = torch.arange(block_k, device=q.device)[None, :]

    def blocks():
        for j in range(idx.shape[-1]):
            kpos = idx[:, j].long()[:, None] * block_k + offs
            rows = pidx[:, j].long()[:, None] * block_k + offs
            mask = (kpos < kv_len[:, None]) & ok[:, j, None].bool()
            yield (take_rows(k_pool, k_scale, rows),
                   take_rows(v_pool, v_scale, rows), mask)
    return _plain_body(q, k_pool.shape[1], blocks())


# per (device, stream): the kernels' workspace and how many of its leading
# int32 tickets are known to be zero
_WORKSPACE: dict = {}


def _workspace(dev, n_tickets: int, n: int) -> torch.Tensor:
    """A workspace of at least ``n`` f32 elements whose first
    ``n_tickets`` int32 tickets are zero.  The kernel's last tile of each
    (b, KV head) resets its ticket, so a buffer kept per device and stream
    stays zero there from call to call; only a new buffer, or a call with
    more tickets than the last one (whose partials lay there), clears
    them."""
    key = (dev, LN.stream_handle(dev))
    ws, zero = _WORKSPACE.get(key, (None, 0))
    if ws is None or ws.numel() < n:
        ws = torch.zeros(n, dtype=torch.float32, device=dev)
    elif zero < n_tickets:
        ws[:n_tickets].zero_()
    _WORKSPACE[key] = (ws, n_tickets)
    return ws


def stream_workspace(dev, stream: int):
    """The workspace the kernels use on ``dev``'s stream ``stream`` (its
    handle), None before their first call there.  A CUDA graph that
    captured them on that stream holds it for as long as it lives: a later,
    larger call there replaces the buffer in this table."""
    return _WORKSPACE.get((dev, stream), (None, 0))[0]


def _launch(fn_name: str, q, k, v, idx, pidx, ok, kv_len, block_k: int,
            cache_strides, s_len: int, k_scale, v_scale) -> torch.Tensor:
    """Check the operands and launch K1 (pidx None) or K4 on q's card."""
    dev = q.device
    b, hq, one, hd = q.shape
    hkv = k.shape[-2]
    nb = idx.shape[-1]
    if one != 1 or hq % hkv or hd % 16 or hd > 128:
        raise ValueError(f"unsupported decode shape q={tuple(q.shape)} "
                         f"cache={tuple(k.shape)}")
    if k.stride() != v.stride() or k.dtype != v.dtype:
        raise ValueError("k and v caches must share strides and dtype")
    LN.check_cuda_operand("q", q, dev)
    LN.check_cuda_operand("k_cache", k, dev)
    LN.check_cuda_operand("v_cache", v, dev)
    LN.check_copy_rows("k_cache", k)
    idx32 = LN.check_index("idx", idx, dev)
    ok8 = LN.check_index("ok", ok, dev, torch.bool)
    kvl = LN.check_index("kv_len", kv_len, dev)
    scales, scale_strides = LN.check_scales(k, k_scale, v_scale, dev)
    out = torch.empty((b, hq, 1, hd), dtype=q.dtype, device=dev)
    # a ticket per (b, KV head), then one partial softmax state (acc[hd],
    # m, l) per 64-row tile and head
    n_tickets = -(-b * hkv // 64) * 64
    n_tiles = nb * -(-block_k // 64)
    ws = _workspace(dev, n_tickets,
                    n_tickets + b * hq * n_tiles * (hd + 2))
    head = [LN.DTYPE_CODE[q.dtype], LN.DTYPE_CODE[k.dtype], q.data_ptr(),
            q.stride(0), q.stride(1), k.data_ptr(), v.data_ptr(),
            *cache_strides, *scales, *scale_strides]
    if pidx is None:
        streams = [idx32.data_ptr(), ok8.data_ptr()]
        dims = [b, hq, hkv, s_len, hd, nb, block_k]
    else:
        pidx32 = LN.check_index("pidx", pidx, dev)
        if pidx32.stride() != idx32.stride():
            raise ValueError("idx and pidx must share one layout")
        streams = [idx32.data_ptr(), pidx32.data_ptr(), ok8.data_ptr()]
        dims = [b, hq, hkv, hd, nb, block_k]
    args = (head + streams + [idx32.stride(0), kvl.data_ptr(), ws.data_ptr(),
                              out.data_ptr(), out.stride(0), out.stride(1)]
            + dims + [hd ** -0.5, LN.stream_handle(dev)])
    types = ([LN.I, LN.I, LN.P, LN.L, LN.L, LN.P, LN.P]
             + [LN.L] * len(cache_strides) + [LN.P, LN.P]
             + [LN.L] * len(scale_strides) + [LN.P] * len(streams)
             + [LN.L, LN.P, LN.P, LN.P, LN.L, LN.L] + [LN.I] * len(dims)
             + [LN.F, LN.P])
    err = LN.bind("dsa_decode", fn_name, types)(*args)
    LN.raise_on_error(fn_name, err)
    return out


def dsa_decode_gather_attention(q, k_cache, v_cache, idx, ok, kv_len, *,
                                block_k: int = 128, k_scale=None,
                                v_scale=None) -> torch.Tensor:
    """K1 (K1q with scales).  q: (B,Hq,1,hd); k/v cache: (B,S,Hkv,hd);
    idx/ok: (B,nb); kv_len: (B,); k/v_scale: (B,S,Hkv) f32 or None.
    Returns (B,Hq,1,hd) in q's dtype."""
    LN.refuse_grad("K1 (dsa_decode_gather_attention)", q, k_cache, v_cache,
                   k_scale, v_scale)
    if q.device.type == "cpu":
        return dsa_decode_gather_attention_plain(
            q, k_cache, v_cache, idx, ok, kv_len, block_k=block_k,
            k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    out = _launch("dsa_decode_launch", q, k_cache, v_cache, idx, None, ok,
                  kv_len, block_k, k_cache.stride()[:3], k_cache.shape[1],
                  k_scale, v_scale)
    LN.count(dsa_decode_gather_attention, k_scale)
    return out


def dsa_decode_paged_gather_attention(q, k_pool, v_pool, idx, pidx, ok,
                                      kv_len, *, block_k: int = 128,
                                      k_scale=None, v_scale=None
                                      ) -> torch.Tensor:
    """K4 (K4q with scales).  q: (B,Hq,1,hd); k/v pool: (P*block_k,Hkv,hd);
    idx/pidx/ok: (B,nb) logical blocks, physical pages, validity; kv_len:
    (B,); k/v_scale: (P*block_k,Hkv) f32 or None.  Returns (B,Hq,1,hd) in
    q's dtype."""
    LN.refuse_grad("K4 (dsa_decode_paged_gather_attention)", q, k_pool,
                   v_pool, k_scale, v_scale)
    if q.device.type == "cpu":
        return dsa_decode_paged_gather_attention_plain(
            q, k_pool, v_pool, idx, pidx, ok, kv_len, block_k=block_k,
            k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if k_pool.dim() != 3 or k_pool.shape[0] % block_k:
        raise ValueError(f"the pool {tuple(k_pool.shape)} is not whole "
                         f"pages of {block_k} rows")
    out = _launch("dsa_decode_paged_launch", q, k_pool, v_pool, idx, pidx,
                  ok, kv_len, block_k, k_pool.stride()[:2], 0, k_scale,
                  v_scale)
    LN.count(dsa_decode_paged_gather_attention, k_scale)
    return out


for _fn in (dsa_decode_gather_attention, dsa_decode_paged_gather_attention):
    LN.counters(_fn, "launches", "launches_quant")
