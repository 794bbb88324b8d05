"""GQA attention with first-class DSA (paper §3), prefill and decode.

Each ``init_*`` returns a dict of tensors.  When ``cfg.dsa.enabled`` and
the run flags ask for it, prefill and training compute approximate scores
through the prediction path, derive the dynamic sparse pattern and run the
sparse attention; in train mode (``RunFlags(mode="train")``, no cache)
``apply_attention`` also returns the MSE term of the joint loss (Eq. 7)
in its ``aux``.  Serving never computes it.

Decode fast path (RunFlags(mode="decode", long_context=True)): the KV
cache carries the predicted-key cache ``kt`` (B, S, k) and its
block-pooled twin ``ktb`` (B, S/block_k, k), running block sums, so each
step's selection is a top-k over S/block_k block scores.  ``dsa_mode``:

  off       dense decode over the whole cache (kt kept up to date)
  faithful  the paper's token granularity: top-k over all S predicted
            scores kt plus the trailing DECODE_LOCAL rows, gathered and
            attended (core.attention.dsa_decode_attention); ktb is left
            as prefill made it, as in the reference
  block     block selection over ktb + plain block gather
            (core.attention.dsa_decode_block_attention)
  kernel    same selection, CUDA gather-attend kernel K1
            (kernels.ops.dsa_decode)

Sliding-window archs (``cfg.swa_window``) and ``RunFlags.decode_window``
keep a RING cache of s = min(max_len, decode_window, swa_window) rows:
prefill places token i at slot i % s (``_fill_cache``), decode writes
slot pos % s and attends the min(pos + 1, s) filled slots, so under SWA
the ring holds exactly one window and enforces it by construction.  An
SWA cache has no kt/ktb: its decode is the plain ``decode_attention``.

Continuous batching: ``pos`` is per slot, (B,), so every batch row decodes
at its own depth, and decode takes an optional ``Active`` (a (B,) mask,
and optionally the indices of its rows): an inactive row lands no write,
does not advance ``pos`` and attends with ``kv_len = 0``.  ``chunk_len``
switches decode to the chunk-append path
(chunked admission, ``_apply_chunk``): C tokens per row appended at
``pos``, with the DSA chunk kernel K3 (``kernels.ops.dsa_chunk_prefill``)
on ``dsa_mode="kernel"``.  A cache built with ``pages=`` is PAGED: flat
k/v/kt pools shared by all slots, one ``ktb`` row per page, and a
per-slot ``page_tbl`` over the logical geometry; page 0 is the permanent
zero page.  Paged decode gathers through the table, with K4
(``kernels.ops.dsa_decode_paged``) on ``dsa_mode="kernel"``.

Mixed-precision serving (``RunFlags.kv_quant``, ``RunFlags.select_dtype``):
``kv_quant`` "int8" or "fp8" stores K/V narrow with one f32 scale per
(row, head) (leaves ``k_s``/``v_s``), dequantized after every gather and
inside the kernels (K1q, K3q, K4q); ``select_dtype="int8"`` stores kt/ktb
as int8 with per-row scales (``kt_s``/``ktb_s``) and runs the selection
product in integers.  As in the reference, the PRESENCE of a scale leaf
is what the apply paths branch on.  fp8 leaves move as uint8 views
(``core.quantization.raw``); no arithmetic runs on them.

Caches are updated IN PLACE (the JAX reference returns new trees): each
layer's cache dict is written row by row during decode, and prefill fills
it in place.  No step replaces a leaf, and a decode step given a bare
mask has fixed shapes and no host sync, so a CUDA graph that captured it
replays it on the same cache (inference/graphs.py).  Cache writes never
go out of range: the write slot wraps as
``pos % s`` once ``pos`` reaches the cache length, exactly the slot the
reference's ring formula picks, so the surplus steps of a bucketed step
count (which the reference also runs) write where the reference writes.
Where the reference drops a write by pushing its index out of bounds,
the port leaves it out or sends it where it changes nothing: an inactive
row of a dense decode step writes back what its target holds (or, given
``Active.rows``, writes nothing); a paged write that must not land (an
inactive row, an unmapped block) writes zeros into the zero page; a
chunk row past the cache end writes back what its target holds
(``_write_rows``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import attention as A
from repro_torch.core import masks as M
from repro_torch.core import prediction as PRED
from repro_torch.core import quantization as Q
from repro_torch.core.prediction import einsum, mm
from repro_torch.core.quantization import raw
from repro_torch.kernels import ops
from repro_torch.models.common import dense_init, rope

# Trailing tokens always attended at decode.
DECODE_LOCAL = 64

# Rows of one physical page of a paged cache when the arch has no DSA
# decode cache (with one, a page is cfg.dsa.block_k rows, so a selected
# block IS a page).
PAGE_SIZE = 16

DSA_MODES = ("off", "faithful", "block", "kernel")

# Mixed-precision serving: the dtypes the selection caches (kt/ktb) and the
# resident K/V cache may be stored in.  Selection only ranks, so block
# top-k INDICES are what must agree; the attend over the gathered rows
# always runs in full precision.
SELECT_DTYPES = ("float32", "int8")
KV_QUANT_DTYPES = (None, "int8", "fp8")


@dataclasses.dataclass(frozen=True)
class RunFlags:
    """Runtime execution choices (not architecture)."""
    mode: str = "prefill"          # prefill | decode | train
    dsa_mode: str = "block"        # off | faithful | block | kernel
    with_mse: bool = True          # train mode: compute L_MSE (Eq. 6)
    mse_stride_cap: int = 512      # block path: MSE over every
    #                                max(1, L // cap)-th query row
    long_context: bool = False     # DSA decode over the predicted-key cache
    # "int8": kt/ktb stored int8 with per-row scales, selection in integers
    select_dtype: str = "float32"
    # "int8" | "fp8": K/V stored narrow with per-(row, head) scales
    kv_quant: Optional[str] = None
    decode_window: int = 0         # ring-buffer cache size override


def dsa_active(cfg: ArchConfig, flags: RunFlags) -> bool:
    return cfg.dsa.enabled and flags.dsa_mode != "off"


@dataclasses.dataclass(frozen=True)
class Active:
    """The rows of a batch that take part in a decode step: ``mask`` (B,)
    bool and, optionally, ``rows``, the int64 indices of its True entries.

    Without ``rows`` every row of a dense cache writes, an inactive one
    putting back what its target holds: fixed shapes and no host sync, the
    form the scheduler runs and a CUDA graph captures.  With ``rows`` only
    those rows write, the eager form the masked one is held to bit for bit
    (tests/test_torch_graphs.py).  A paged step reads only ``mask``."""
    mask: torch.Tensor
    rows: Optional[torch.Tensor] = None


def as_active(active) -> Optional[Active]:
    """A decode step's ``active`` argument (None, an ``Active`` or a (B,)
    bool mask) as an ``Active``."""
    if active is None or isinstance(active, Active):
        return active
    return Active(active)


def _int8_select_scores(q_t, key_q, key_s, *, block_k: int = 1):
    """Predicted scores against an int8-stored key cache: the queries are
    quantized per row, int8 x int8 accumulates exactly, and the scores
    return to f32 only at the top-k reduction.  q_t (B, R, kp) float;
    key_q (B, N, kp) int8 with per-row scales key_s (B, N) -> (B, R, N)
    f32 (divided by block_k for the pooled block cache).  The product
    runs in float64 on integer values: exact for any kp here (|sum| <=
    kp * 128^2 << 2^53), where an f32 product is exact only while
    kp * 127^2 < 2^24 and follows the TF32 switch."""
    qq, qs = Q.quant_store(q_t, axis=-1)
    s_int = torch.einsum("brk,bnk->brn", qq.double(),
                         key_q.double()).to(torch.int32)
    return M.dequant_topk_scores(
        s_int, qs[..., None] * key_s[:, None, :], block_k=block_k)


def cache_page_size(cfg: ArchConfig, flags: RunFlags) -> int:
    """Row count of one physical page of a paged resident cache."""
    dsa_decode = (cfg.dsa.enabled and flags.long_context
                  and not cfg.swa_window)
    return cfg.dsa.block_k if dsa_decode else PAGE_SIZE


def init_attention(gen: torch.Generator, cfg: ArchConfig, *, device,
                   dtype=torch.float32) -> Dict:
    hd = cfg.resolved_head_dim
    nq, nkv, d = cfg.n_heads * hd, cfg.n_kv_heads * hd, cfg.d_model
    kw = dict(device=device, dtype=dtype)
    params = {
        "wq": dense_init(gen, (d, nq), **kw),
        "wk": dense_init(gen, (d, nkv), **kw),
        "wv": dense_init(gen, (d, nkv), **kw),
        "wo": dense_init(gen, (nq, d), **kw),
    }
    if cfg.qkv_bias:
        params.update(bq=torch.zeros((nq,), **kw),
                      bk=torch.zeros((nkv,), **kw),
                      bv=torch.zeros((nkv,), **kw))
    if cfg.dsa.enabled:
        params["dsa"] = PRED.init_predictor(gen, d, cfg.dsa.sigma, **kw)
    return params


def _proj_qkv(params, cfg: ArchConfig, x):
    hd = cfg.resolved_head_dim
    q, k, v = (mm(x, params[w]) for w in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    b, l = x.shape[:2]
    return (q.reshape(b, l, cfg.n_heads, hd),
            k.reshape(b, l, cfg.n_kv_heads, hd),
            v.reshape(b, l, cfg.n_kv_heads, hd))


def _mean_head_scores(q, k, stride: int = 1):
    """Mean-over-heads Q K^T, the MSE target S of Eq. 6 (GQA: each KV head
    serves its group of query heads), over every ``stride``-th query row.
    Unscaled and not detached: the MSE trains q and k too, as in the
    reference."""
    hq, hkv = q.shape[2], k.shape[2]
    qs = q[:, ::stride]
    s = einsum("bqhgd,bkhd->bqk",
               qs.reshape(*qs.shape[:2], hkv, hq // hkv, -1), k)
    return s / hq


def _dsa_train_mask_and_aux(params, cfg: ArchConfig, flags: RunFlags, x,
                            q, k, causal: bool):
    """The DSA pattern for prefill and training and, in train mode with
    ``flags.with_mse``, the MSE aux (the reference's
    ``_dsa_train_mask_and_aux``).

    Returns (("token", mask (B, L, L)), aux) on the token path (faithful
    mode, or a length that is not a block multiple: every prompt bucket
    under block_q) or (("block", (idx, ok)), aux) on the block path.  The
    token path's MSE is over the full S~; the block path's over every
    max(1, L // mse_stride_cap)-th query row of Q~ K~^T."""
    dsa = cfg.dsa
    b, l = x.shape[:2]
    with_mse = flags.mode == "train" and flags.with_mse
    aux: Dict[str, torch.Tensor] = {}
    if flags.dsa_mode == "faithful" or l % dsa.block_q or l % dsa.block_k:
        s_t = PRED.predict_scores(params["dsa"], x, None, bits=dsa.quant_bits)
        pm = A._pos_mask(l, l, causal, cfg.swa_window, device=x.device)
        valid = None if pm is None else pm.expand(b, l, l)
        keep = M.keep_count(l, dsa.sparsity)
        if with_mse:
            aux["mse"] = PRED.mse_loss(_mean_head_scores(q, k), s_t)
        return ("token", M.row_topk_mask(s_t, keep, valid)), aux
    bs = PRED.predict_block_scores(params["dsa"], x, None, bits=dsa.quant_bits,
                                   block_q=dsa.block_q, block_k=dsa.block_k)
    n_kb = l // dsa.block_k
    nb_keep = min(n_kb, max(dsa.min_blocks + dsa.local_blocks,
                            M.keep_count(n_kb, dsa.sparsity)))
    wb = cfg.swa_window // dsa.block_k if cfg.swa_window else 0
    idx, ok = M.block_topk_indices(bs, nb_keep, causal=causal,
                                   window_blocks=wb,
                                   local_blocks=dsa.local_blocks,
                                   sort=dsa.sort_indices)
    if with_mse:
        stride = max(1, l // flags.mse_stride_cap)
        q_t, k_t = PRED.predict_qk(params["dsa"], x, None, dsa.quant_bits)
        s_t_sub = einsum("bqk,bsk->bqs", q_t[:, ::stride], k_t)
        aux["mse"] = PRED.mse_loss(_mean_head_scores(q, k, stride), s_t_sub)
    return ("block", (idx, ok)), aux


def apply_attention(params, cfg: ArchConfig, flags: RunFlags, x, *,
                    cache=None, causal: bool = True, active=None,
                    chunk_len=None, sel_len=None):
    """Returns (out, cache, aux).  x: (B, S, d).  With a cache, prefill
    fills it and decode appends one row per batch row, both in place.
    ``active`` (an ``Active``) freezes the other rows at decode; ``chunk_len``
    (B,) switches decode to the chunk-append path (x is a C-token chunk
    per row, rows past chunk_len are padding) with ``sel_len`` its
    selection geometry.  ``aux`` holds the MSE term in train mode (with
    ``flags.with_mse`` and DSA on) and is empty otherwise."""
    if flags.mode == "decode":
        if "page_tbl" in cache:
            if chunk_len is not None:
                raise ValueError("paged caches decode one token at a time")
            out = _apply_paged_decode(params, cfg, flags, x, cache, active)
        elif chunk_len is not None:
            out = _apply_chunk(params, cfg, flags, x, cache, active,
                               chunk_len, sel_len)
        else:
            out = _apply_decode(params, cfg, flags, x, cache, active)
        return (*out, {})
    dsa = cfg.dsa
    aux: Dict[str, torch.Tensor] = {}
    q, k, v = _proj_qkv(params, cfg, x)
    pos = torch.arange(x.shape[1], device=x.device)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    if dsa_active(cfg, flags):
        (kind, pat), aux = _dsa_train_mask_and_aux(params, cfg, flags, x, q,
                                                   k, causal)
        if kind == "token":
            out = A.dense_attention(q, k, v, causal=causal,
                                    window=cfg.swa_window, token_mask=pat)
        elif flags.dsa_mode == "kernel":
            out = ops.dsa_attention(q, k, v, *pat, block_q=dsa.block_q,
                                    block_k=dsa.block_k, causal=causal,
                                    window=cfg.swa_window)
        else:
            out = A.dsa_sparse_attention(q, k, v, *pat, block_q=dsa.block_q,
                                         block_k=dsa.block_k, causal=causal,
                                         window=cfg.swa_window)
    elif x.shape[1] <= 1024:
        out = A.dense_attention(q, k, v, causal=causal, window=cfg.swa_window)
    else:
        out = A.flash_attention(q, k, v, causal=causal, window=cfg.swa_window)
    if flags.mode == "prefill" and cache is not None:
        _fill_cache(cfg, flags, cache, k, v, params, x)
    out = mm(out.reshape(*x.shape[:2], -1), params["wo"])
    return out, cache, aux


def init_cache_attention(cfg: ArchConfig, batch: int, max_len: int,
                         flags: RunFlags, *, device, dtype=torch.bfloat16,
                         pages=None) -> Dict:
    """Dense cache layout: k/v (B, S, Hkv, hd), per-row ``pos`` (B,), and
    with DSA decode the kt (B, S, k) / ktb (B, S/block_k, k) caches.  S is
    min(max_len, flags.decode_window, cfg.swa_window) (a ring when either
    of the last two binds); an SWA arch has no DSA decode cache.  S is
    rounded up to a block_k multiple on the DSA decode path (the gather
    paths then never pad the cache).  ``flags.kv_quant`` stores k/v in
    int8 or fp8 with f32 scales k_s/v_s (B, S, Hkv); ``flags.select_dtype
    == "int8"`` stores kt/ktb in int8 with f32 scales kt_s (B, S) and
    ktb_s (B, S/block_k).

    ``pages``: the PAGED layout instead, one flat pool of ``pages`` pages
    of ``bk = cache_page_size`` rows: k/v (pages*bk, Hkv, hd), kt
    (pages*bk, k), one ktb row per page (pages, k), and ``page_tbl``
    (B, S/bk) mapping each slot's logical block to its page.  Page 0 is
    the permanent zero page: never allocated, never written, so an
    unmapped table entry reads zero rows.  Scale leaves follow their
    data leaves into the pool.  A ring cannot be paged."""
    if pages is not None and (cfg.swa_window or flags.decode_window):
        raise ValueError("paged caches require a non-wrapping layout (no "
                         "SWA, no decode_window)")
    hd = cfg.resolved_head_dim
    s = min(max_len, flags.decode_window or max_len,
            cfg.swa_window or max_len)
    dsa_decode = (cfg.dsa.enabled and flags.long_context
                  and not cfg.swa_window)
    if dsa_decode:
        s = -(-s // cfg.dsa.block_k) * cfg.dsa.block_k
    f32 = dict(device=device, dtype=torch.float32)
    kv_dt = Q.STORE_DTYPES[flags.kv_quant] if flags.kv_quant else dtype
    sel_q = flags.select_dtype == "int8"
    kt_dt = torch.int8 if sel_q else dtype
    if pages is not None:
        bk = cache_page_size(cfg, flags)
        if s % bk:
            raise ValueError(f"a paged cache needs max_len ({s}) divisible "
                             f"by the page size ({bk})")
        rows, blocks = (pages * bk,), (pages,)
    else:
        rows, blocks = (batch, s), (batch, s // cfg.dsa.block_k)
    c = {name: torch.zeros(rows + (cfg.n_kv_heads, hd), device=device,
                           dtype=kv_dt) for name in ("k", "v")}
    c["pos"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    if pages is not None:
        c["page_tbl"] = torch.zeros((batch, s // bk), dtype=torch.int32,
                                    device=device)
    if flags.kv_quant:
        c["k_s"] = torch.zeros(rows + (cfg.n_kv_heads,), **f32)
        c["v_s"] = torch.zeros(rows + (cfg.n_kv_heads,), **f32)
    if dsa_decode:
        kp = PRED.predictor_k(cfg.d_model, cfg.dsa.sigma)
        c["kt"] = torch.zeros(rows + (kp,), device=device, dtype=kt_dt)
        c["ktb"] = torch.zeros(blocks + (kp,), device=device, dtype=kt_dt)
        if sel_q:
            c["kt_s"] = torch.zeros(rows, **f32)
            c["ktb_s"] = torch.zeros(blocks, **f32)
    return c


def _block_sums(kt: torch.Tensor, block_k: int, n_kb: int) -> torch.Tensor:
    """(..., S, k) -> (..., n_kb, k) sums of block_k consecutive rows."""
    pad = n_kb * block_k - kt.shape[-2]
    if pad:
        kt = torch.nn.functional.pad(kt, (0, 0, 0, pad))
    return kt.reshape(*kt.shape[:-2], n_kb, block_k, kt.shape[-1]).sum(-2)


def _rebuild_ktb(cfg: ArchConfig, c: Dict) -> None:
    """ktb from kt in place: block sums of kt's rows.  An int8 kt is
    summed dequantized and the sums are requantized into ktb/ktb_s, the
    source the live updates add to as well."""
    n_kb = c["ktb"].shape[-2]
    if "kt_s" in c:
        sums = _block_sums(Q.dequant(c["kt"], c["kt_s"]), cfg.dsa.block_k,
                           n_kb)
        q8, sc = Q.quant_store(sums)
        c["ktb"].copy_(q8)
        c["ktb_s"].copy_(sc)
    else:
        c["ktb"].copy_(_block_sums(c["kt"], cfg.dsa.block_k, n_kb))


def _quant_rows(cache: Dict, name: str, vals: torch.Tensor,
                kind: Optional[str]) -> Dict[str, torch.Tensor]:
    """The leaves to write for rows ``vals`` of leaf ``name``: the narrow
    values and their scales (``quant_store`` as ``kind``) where the cache
    holds ``name`` quantized, else the values in the leaf's dtype."""
    if f"{name}_s" in cache:
        q8, sc = Q.quant_store(vals, dtype=kind)
        return {name: q8, f"{name}_s": sc}
    return {name: vals.to(cache[name].dtype)}


def _kv_rows(cache: Dict, k, v, kind: Optional[str]
             ) -> Dict[str, torch.Tensor]:
    """``_quant_rows`` of K and V rows together."""
    return {**_quant_rows(cache, "k", k, kind),
            **_quant_rows(cache, "v", v, kind)}


def _kv_views(cache: Dict, *index):
    """Full-precision K and V (gathered at ``index`` if given) for the
    paths that attend the whole cache; a quantized cache is dequantized
    here.  The block-gather paths dequantize after their gathers."""
    out = []
    for name in ("k", "v"):
        t = Q.take(cache[name], *index) if index else cache[name]
        if f"{name}_s" in cache:
            sc = cache[f"{name}_s"]
            t = Q.dequant(t, sc[index] if index else sc)
        out.append(t)
    return out


def _fill_cache(cfg: ArchConfig, flags: RunFlags, cache: Dict, k, v, params,
                x) -> None:
    """Write a prefill's K/V (and kt, ktb) into ``cache`` in place.  Rows
    are cast to the cache's dtype (a bf16 model keeps an f32 cache), or
    quantized where it holds scales.  A prompt longer than a ring cache
    of s rows leaves its last s tokens, token i at slot i % s."""
    s = cache["k"].shape[1]
    t = k.shape[1]
    n = min(t, s)

    def ring(buf):
        if t <= s:
            return buf
        return torch.roll(buf[:, -s:], (t - s) % s, dims=1)

    for leaf, val in _kv_rows(cache, ring(k), ring(v),
                              flags.kv_quant).items():
        raw(cache[leaf])[:, :n] = raw(val)
    cache["pos"].fill_(t)
    if "kt" in cache:
        _, k_t = PRED.predict_qk(params["dsa"], x, None, cfg.dsa.quant_bits)
        for leaf, val in _quant_rows(cache, "kt", ring(k_t), "int8").items():
            cache[leaf][:, :n] = val
        _rebuild_ktb(cfg, cache)


def _write_rows(t: torch.Tensor, pos: torch.Tensor, vals: torch.Tensor,
                ok: torch.Tensor) -> None:
    """In place: ``t[b, pos[b, i]] = vals[b, i]`` where ``ok[b, i]`` and
    the position lies in the cache (the reference drops the rest out of
    bounds).  ``pos`` (B, W) holds consecutive positions per row.  Entries
    that do not write put back what their target holds, and their targets
    never meet a real write of the row: an in-cache entry targets its own
    row, an entry past the end a row before the row's first position."""
    s = t.shape[1]
    w = min(pos.shape[1], s)          # entries past the first S never land
    pos, vals, ok = pos[:, :w], vals[:, :w], ok[:, :w]
    inb = pos < s
    tgt = torch.where(inb, pos, pos - w).clamp(0, s - 1)
    rows = torch.arange(t.shape[0], device=t.device)[:, None]
    put = (ok & inb).reshape(*ok.shape, *([1] * (vals.dim() - 2)))
    r = raw(t)
    r[rows, tgt] = torch.where(put, raw(vals.to(t.dtype)), r[rows, tgt])


def _pool_write(pool: torch.Tensor, flat: torch.Tensor, vals: torch.Tensor,
                ok: torch.Tensor) -> None:
    """In place: ``pool[flat[i]] = vals[i]`` where ``ok[i]``.  The other
    entries write zeros (a narrow zero with scale 0.0 in a quantized
    pool) into row 0 of the zero page, which no real write targets
    (mapped pages are >= 1) and which stays zero."""
    put = ok.reshape(-1, *([1] * (vals.dim() - 1)))
    raw(pool)[torch.where(ok, flat, 0)] = torch.where(
        put, raw(vals.to(pool.dtype)), 0)


def _put_step_rows(t: torch.Tensor, col: torch.Tensor, vals: torch.Tensor,
                   active: Optional[Active]) -> None:
    """In place: ``t[b, col[b]] = vals[b]`` for each row ``b`` of a dense
    decode step that writes: every row; with a mask, every row, the
    inactive ones putting back what their target holds; with
    ``active.rows``, only those rows."""
    r = raw(t)
    v = raw(vals.to(t.dtype))
    rows = torch.arange(t.shape[0], device=t.device)
    if active is not None and active.rows is not None:
        rows, col, v = active.rows, col[active.rows], v[active.rows]
    elif active is not None:
        keep = active.mask.reshape(-1, *([1] * (v.dim() - 1)))
        v = torch.where(keep, v, r[rows, col])
    r[rows, col] = v


def _apply_decode(params, cfg: ArchConfig, flags: RunFlags, x, cache,
                  active: Optional[Active] = None):
    """Single-token decode: every batch row at its own ``pos``.  With
    ``active`` given, only its rows land their writes and advance ``pos``;
    the others attend with kv_len = 0."""
    b = x.shape[0]
    pos = cache["pos"].long()                              # (B,)
    q, k, v = _proj_qkv(params, cfg, x)
    q = rope(q, pos[:, None], cfg.rope_theta)
    k = rope(k, pos[:, None], cfg.rope_theta)
    s = cache["k"].shape[1]
    slot = torch.where(pos < s, pos, pos % s)              # ring wrap
    kv_len = torch.clamp(pos + 1, max=s).to(torch.int32)
    if active is None:
        cache["pos"].copy_(pos + 1)
    else:
        cache["pos"].copy_(pos + active.mask)
        kv_len = torch.where(active.mask, kv_len, 0)
    for leaf, val in _kv_rows(cache, k[:, 0], v[:, 0],
                              flags.kv_quant).items():
        _put_step_rows(cache[leaf], slot, val, active)
    if "kt" in cache:
        out = _dsa_decode(params, cfg, flags, x, q, cache, slot, kv_len,
                          active)
    else:
        # a ring of s <= swa_window rows holds one window by construction;
        # the slot-positional window mask is for larger caches, pre-wrap
        win = cfg.swa_window
        out = A.decode_attention(q, *_kv_views(cache), kv_len=kv_len,
                                 window=win if win and s > win else 0)
    out = mm(out.reshape(b, 1, -1), params["wo"])
    return out, cache


def _decode_select(cfg: ArchConfig, q_t, ktb_view, ktb_s_view, kv_len,
                   s: int):
    """Block top-k over the pooled score cache (B, n_kb, k), int8 with
    per-block scales ``ktb_s_view`` (B, n_kb) or float (None): (idx, ok)."""
    dsa = cfg.dsa
    bkd = dsa.block_k
    n_kb = ktb_view.shape[1]
    if ktb_s_view is not None:
        s_blk = _int8_select_scores(q_t, ktb_view, ktb_s_view,
                                    block_k=bkd)[:, 0]
    else:
        s_blk = torch.einsum("bok,bjk->bj", q_t.float(),
                             ktb_view.float()) / bkd
    keep = M.keep_count(s, dsa.sparsity)
    nb_keep = min(n_kb, -(-keep // bkd) + -(-DECODE_LOCAL // bkd) + 1)
    return M.decode_block_topk_indices(s_blk, nb_keep, kv_len=kv_len,
                                       block_k=bkd, local=DECODE_LOCAL)


def _faithful_decode(cfg: ArchConfig, q, q_t, kt, kt_s, kv, kv_len, s: int):
    """Token-granularity DSA decode (the paper's): the predicted scores of
    the step's query against all S kt rows (``kt_s``: int8 kt's per-row
    scales, else None), top keep + DECODE_LOCAL of them over the
    full-precision K/V views ``kv``."""
    if kt_s is not None:
        s_t = _int8_select_scores(q_t, kt, kt_s)[:, 0]
    else:
        s_t = torch.einsum("bok,bsk->bs", q_t.float(), kt.float())
    return A.dsa_decode_attention(q, *kv, s_t,
                                  keep=M.keep_count(s, cfg.dsa.sparsity),
                                  kv_len=kv_len, local=DECODE_LOCAL)


def _dsa_decode(params, cfg: ArchConfig, flags: RunFlags, x, q, cache,
                slot, kv_len, active: Optional[Active] = None):
    """DSA long-context decode step: update kt (and, on the block paths,
    ktb) in place at each writing row's ``slot``, select cache rows or
    blocks from predicted scores, gather + attend.  Returns the attention
    output (B, 1, Hq, hd)."""
    dsa = cfg.dsa
    kc, vc = cache["k"], cache["v"]
    s = kc.shape[1]
    q_t, k_t = PRED.predict_qk(params["dsa"], x, None, dsa.quant_bits)
    kt = k_t[:, 0]
    for leaf, val in _quant_rows(cache, "kt", kt, "int8").items():
        _put_step_rows(cache[leaf], slot, val, active)
    if flags.dsa_mode == "off":
        return A.decode_attention(q, *_kv_views(cache), kv_len=kv_len)
    if flags.dsa_mode == "faithful":
        return _faithful_decode(cfg, q, q_t, cache["kt"], cache.get("kt_s"),
                                _kv_views(cache), kv_len, s)
    bkd = dsa.block_k
    # the slot being written is still zero (only a surplus step of a
    # bucketed step count can wrap, and its token is dropped; a
    # decode_window ring wraps for real and its block sums then go stale,
    # as the reference's do), so a plain add keeps the block sum exact
    # for every delivered token; each row
    # adds to its own block, so a gather-add-scatter needs no accumulating
    # index_put (which sorts its indices on the card).  An int8 block sum
    # cannot add across scales: dequantize it, add in f32, requantize.
    blk = slot // bkd
    rows = torch.arange(kc.shape[0], device=kc.device)
    if "ktb_s" in cache:
        old = Q.dequant(cache["ktb"][rows, blk], cache["ktb_s"][rows, blk])
        for leaf, val in zip(("ktb", "ktb_s"), Q.quant_store(old + kt)):
            _put_step_rows(cache[leaf], blk, val, active)
    else:
        _put_step_rows(cache["ktb"], blk, cache["ktb"][rows, blk]
                       + kt.to(cache["ktb"].dtype), active)
    idx, ok = _decode_select(cfg, q_t, cache["ktb"], cache.get("ktb_s"),
                             kv_len, s)
    scales = dict(k_scale=cache.get("k_s"), v_scale=cache.get("v_s"))
    if flags.dsa_mode == "kernel":
        return ops.dsa_decode(q, kc, vc, idx, ok, kv_len, block_k=bkd,
                              **scales)
    return A.dsa_decode_block_attention(q, kc, vc, idx, ok, block_k=bkd,
                                        kv_len=kv_len, **scales)


# -- paged decode (page-table indirection over a shared page pool) ---------


def _paged_view_rows(tbl: torch.Tensor, bk: int) -> torch.Tensor:
    """(B, S) pool row of every logical cache row of every slot.  Indexing
    a pool with it gives the dense logical view (unmapped blocks read the
    zero page), so every O(S) read path sees the dense cache's bytes."""
    b, n_kb = tbl.shape
    return (tbl.long()[:, :, None] * bk + torch.arange(
        bk, device=tbl.device)[None, None, :]).reshape(b, n_kb * bk)


def _apply_paged_decode(params, cfg: ArchConfig, flags: RunFlags, x, cache,
                        active: Optional[Active] = None):
    """Single-token decode on a PAGED cache.  The logical write slot goes
    through ``page_tbl`` to a pool row; an inactive row, or a slot whose
    block is unmapped (page 0), writes nothing.  Off-mode and dense decode
    gather the logical view; block/kernel DSA decode translate the
    selected logical blocks to pages after top-k and gather those."""
    b = x.shape[0]
    pos = cache["pos"].long()                              # (B,)
    q, k, v = _proj_qkv(params, cfg, x)
    q = rope(q, pos[:, None], cfg.rope_theta)
    k = rope(k, pos[:, None], cfg.rope_theta)
    tbl = cache["page_tbl"].long()
    n_kb = tbl.shape[1]
    bk = cache_page_size(cfg, flags)
    s = n_kb * bk                                          # logical length
    rows = torch.arange(b, device=x.device)
    pg = tbl[rows, (pos // bk).clamp(0, n_kb - 1)]
    okw = (pos < s) & (pg > 0)
    kv_len = torch.clamp(pos + 1, max=s).to(torch.int32)
    if active is None:
        cache["pos"].copy_(pos + 1)
    else:
        okw &= active.mask
        cache["pos"].copy_(pos + active.mask)
        kv_len = torch.where(active.mask, kv_len, 0)
    flat = pg * bk + pos % bk
    for leaf, val in _kv_rows(cache, k[:, 0], v[:, 0],
                              flags.kv_quant).items():
        _pool_write(cache[leaf], flat, val, okw)
    view = _paged_view_rows(tbl, bk)                       # (B, S)
    if "kt" in cache:
        out = _dsa_paged_decode(params, cfg, flags, x, q, cache, flat, okw,
                                pg, kv_len, view)
    else:
        out = A.decode_attention(q, *_kv_views(cache, view), kv_len=kv_len)
    out = mm(out.reshape(b, 1, -1), params["wo"])
    return out, cache


def _dsa_paged_decode(params, cfg: ArchConfig, flags: RunFlags, x, q, cache,
                      flat, okw, pg, kv_len, view):
    """The paged twin of ``_dsa_decode``: kt writes reuse the translated
    pool row; ktb has one row per page, so the row a write adds to IS the
    write's page.  Block selection scores the logical ktb view
    ``ktb[tbl]`` and the selected logical blocks become pages only for
    the gather; faithful selection scores the logical kt view."""
    dsa = cfg.dsa
    bk = dsa.block_k
    kc, vc = cache["k"], cache["v"]
    q_t, k_t = PRED.predict_qk(params["dsa"], x, None, dsa.quant_bits)
    for leaf, val in _quant_rows(cache, "kt", k_t[:, 0], "int8").items():
        _pool_write(cache[leaf], flat, val, okw)
    if flags.dsa_mode == "off":
        return A.decode_attention(q, *_kv_views(cache, view), kv_len=kv_len)
    if flags.dsa_mode == "faithful":
        kt_s = cache.get("kt_s")
        return _faithful_decode(cfg, q, q_t, cache["kt"][view],
                                None if kt_s is None else kt_s[view],
                                _kv_views(cache, view), kv_len,
                                view.shape[1])
    # a write that does not land adds zero to the zero page's row: every
    # such entry stores 0 + 0 there, and the real targets (the slots'
    # own pages) are distinct, so no accumulating index_put is needed.
    # int8 block sums are dequantized, added in f32 and requantized; a
    # dropped one stores (0, scale 0.0) in the zero page's row.
    if "ktb_s" in cache:
        src = torch.where(okw, pg, 0)
        old = Q.dequant(cache["ktb"][src], cache["ktb_s"][src])
        for leaf, val in zip(("ktb", "ktb_s"),
                             Q.quant_store(old + k_t[:, 0])):
            _pool_write(cache[leaf], pg, val, okw)
    else:
        cache["ktb"][torch.where(okw, pg, 0)] += torch.where(
            okw[:, None], k_t[:, 0], 0).to(cache["ktb"].dtype)
    tbl = cache["page_tbl"].long()
    ktb_s = cache.get("ktb_s")
    idx, ok = _decode_select(cfg, q_t, cache["ktb"][tbl],
                             None if ktb_s is None else ktb_s[tbl], kv_len,
                             view.shape[1])
    pidx = torch.gather(tbl, 1, idx.long()).to(torch.int32)
    scales = dict(k_scale=cache.get("k_s"), v_scale=cache.get("v_s"))
    if flags.dsa_mode == "kernel":
        return ops.dsa_decode_paged(q, kc, vc, idx, pidx, ok, kv_len,
                                    block_k=bk, **scales)
    return A.dsa_decode_paged_block_attention(q, kc, vc, idx, pidx, ok,
                                              block_k=bk, kv_len=kv_len,
                                              **scales)


# -- chunk-append path (chunked admission) ----------------------------------


def _apply_chunk(params, cfg: ArchConfig, flags: RunFlags, x, cache,
                 active: Optional[Active], chunk_len, sel_len=None):
    """C-token chunk append: the decode step generalised from 1 token.

    x: (B, C, d), each row's next C prompt tokens, right-padded;
    chunk_len: (B,) true token count per row.  Writes C rows at the
    per-row ``pos`` (pad rows as ZEROS: the state ``truncate_cache``
    leaves), advances ``pos`` by chunk_len, extends kt and ktb, and
    attends each chunk query to the cache prefix and the intra-chunk
    causal triangle.  ``sel_len`` (default the cache length) is the
    selection and attention GEOMETRY: masks, softmax widths and the DSA
    block top-k see exactly sel_len keys, so chunks over a prompt-bucket
    cache reproduce a whole-prompt bucketed prefill.  Inactive rows write
    nothing and do not advance.  On the DSA block path C and ``pos`` are
    multiples of block_q and block_k (the scheduler's chunk widths are).
    """
    if cfg.swa_window:
        raise NotImplementedError("chunk append needs a non-wrapping cache")
    b, c = x.shape[:2]
    kc, vc = cache["k"], cache["v"]
    sel = kc.shape[1] if sel_len is None else sel_len
    pos = cache["pos"].long()                              # (B,)
    q, k, v = _proj_qkv(params, cfg, x)
    offs = torch.arange(c, device=x.device)
    p = pos[:, None] + offs[None, :]                       # (B, C) global
    q = rope(q, p, cfg.rope_theta)
    k = rope(k, p, cfg.rope_theta)
    act = (torch.ones((b,), dtype=torch.bool, device=x.device)
           if active is None else active.mask)
    live = (offs[None, :] < chunk_len.long()[:, None]) & act[:, None]
    wok = act[:, None].expand(b, c)        # active rows write all C rows
    lv = live[..., None, None]
    # pad rows write zeros: quantized, (0, scale 0.0)
    for leaf, val in _kv_rows(cache, torch.where(lv, k, 0),
                              torch.where(lv, v, 0), flags.kv_quant).items():
        _write_rows(cache[leaf], p, val, wok)
    adv = torch.where(act, chunk_len.long(), 0)
    cache["pos"].copy_(pos + adv)
    kv_len = (pos + adv).to(torch.int32)
    head = (slice(None), slice(None, sel))             # the selection geometry
    if "kt" in cache:
        q_t, ktv = _chunk_fill_pred(params, cfg, x, cache, p, live, wok,
                                    pos, act)
        if dsa_active(cfg, flags):
            scales = {name: cache[leaf][head] for name, leaf in (
                ("kt_sel_s", "kt_s"), ("k_scale", "k_s"), ("v_scale", "v_s"))
                if leaf in cache}
            out = _dsa_chunk_attend(cfg, flags, q, kc[head], vc[head], q_t,
                                    cache["kt"][head], p, pos, kv_len,
                                    **scales)
        else:
            out = A.chunk_attention(q, *_kv_views(cache, *head), p)
        # the selection saw the chunk's pad rows of kt (as whole-prompt
        # prefill does); the cache keeps them as zeros
        for leaf, val in ktv.items():
            _write_rows(cache[leaf], p, val, wok)
    else:
        out = A.chunk_attention(q, *_kv_views(cache, *head), p)
    out = mm(out.reshape(b, c, -1), params["wo"])
    return out, cache


def _chunk_fill_pred(params, cfg: ArchConfig, x, cache, p, live, wok, pos,
                     act):
    """Extend the predicted-key caches with a chunk, without a rebuild.

    Writes the chunk's K~ rows UNMASKED into kt (whole-prompt prefill
    scores the pad rows' K~ during selection, causality hides them) and
    updates ktb's touched blocks with the per-block sums of the MASKED
    rows.  An int8 ktb is SET to the requantized sums of the dequantized
    rows (the reference's rule: a chunk is block_k aligned, so each block
    it fills is fresh); a float ktb ADDS them, as the reference does, so
    that the empty chunk of a row whose prompt ended mid-block leaves that
    block as it is.  Returns Q~ and the masked rows to write ({leaf:
    rows}), which the caller writes into kt (and kt_s) once the selection
    has run."""
    dsa = cfg.dsa
    b, c = x.shape[:2]
    q_t, k_t = PRED.predict_qk(params["dsa"], x, None, dsa.quant_bits)
    bkd = dsa.block_k
    if c % bkd:
        raise ValueError(f"chunk width {c} is not a multiple of block_k "
                         f"{bkd}")
    jb = (pos // bkd)[:, None] + torch.arange(c // bkd, device=x.device)
    if "kt_s" in cache:
        ktq, kts = Q.quant_store(k_t)
        _write_rows(cache["kt"], p, ktq, wok)
        _write_rows(cache["kt_s"], p, kts, wok)
        masked = {"kt": torch.where(live[..., None], ktq, 0),
                  "kt_s": torch.where(live, kts, 0.0)}
        rows = Q.dequant(masked["kt"], masked["kt_s"])
    else:
        _write_rows(cache["kt"], p, k_t, wok)
        masked = {"kt": torch.where(live[..., None], k_t, 0)}
        rows = masked["kt"]
    part = rows.reshape(b, c // bkd, bkd, -1).sum(dim=2)
    if "ktb_s" not in cache:
        ktb = cache["ktb"]
        brows = torch.arange(b, device=x.device)[:, None]
        part = ktb[brows, jb.clamp(max=ktb.shape[1] - 1)] + part.to(ktb.dtype)
    wb = act[:, None].expand_as(jb)
    for leaf, val in _quant_rows(cache, "ktb", part, "int8").items():
        _write_rows(cache[leaf], jb, val, wb)
    return q_t, masked


def _dsa_chunk_attend(cfg: ArchConfig, flags: RunFlags, q, kc, vc, q_t,
                      kt_sel, p, pos, kv_len, *, kt_sel_s=None,
                      k_scale=None, v_scale=None):
    """DSA pattern + sparse attention for a chunk: the whole-prompt
    granularity choice made on the CACHE length (the prompt bucket).
    Token granularity when that geometry is not block-divisible (or in
    faithful mode), else block-pooled selection feeding the plain gather
    twin or the chunk kernel K3.  ``kt_sel`` (B, S, k) holds the chunk's
    unmasked K~ rows; ``p`` (B, C) are the chunk queries' global
    positions, ``pos`` (B,) the chunk start.  ``kt_sel_s``/``k_scale``/
    ``v_scale`` are the per-row scales of int8 selection and int8/fp8
    K/V caches (None: full precision)."""
    dsa = cfg.dsa
    b, c = q.shape[:2]
    s = kc.shape[1]

    def scores(qq):
        if kt_sel_s is not None:
            return _int8_select_scores(qq, kt_sel, kt_sel_s)
        return einsum("bqk,bsk->bqs", qq, kt_sel)

    if flags.dsa_mode == "faithful" or s % dsa.block_q or s % dsa.block_k:
        s_t = scores(q_t)
        valid = torch.arange(s, device=q.device)[None, None, :] <= p[:, :, None]
        mask = M.row_topk_mask(s_t, M.keep_count(s, dsa.sparsity), valid)
        if k_scale is not None:
            kc, vc = Q.dequant(kc, k_scale), Q.dequant(vc, v_scale)
        return A.chunk_attention(q, kc, vc, p, token_mask=mask)
    bq, bkd = dsa.block_q, dsa.block_k
    if c % bq:
        raise ValueError(f"chunk width {c} is not a multiple of block_q "
                         f"{bq}")
    n_kb = s // bkd
    q_blk = q_t.reshape(b, c // bq, bq, -1).mean(dim=2)
    sc = scores(q_blk)                                     # (B, nQb, S)
    bs = sc.reshape(b, c // bq, n_kb, bkd).amax(dim=-1)
    nb_keep = min(n_kb, max(dsa.min_blocks + dsa.local_blocks,
                            M.keep_count(n_kb, dsa.sparsity)))
    idx, ok = M.chunk_block_topk_indices(
        bs, nb_keep, q_block_offset=pos // bq,
        local_blocks=dsa.local_blocks, sort=dsa.sort_indices)
    if flags.dsa_mode == "kernel":
        return ops.dsa_chunk_prefill(q, kc, vc, idx, ok, pos, kv_len,
                                     block_q=bq, block_k=bkd,
                                     k_scale=k_scale, v_scale=v_scale)
    return A.dsa_chunk_block_attention(q, kc, vc, idx, ok, block_q=bq,
                                       block_k=bkd, q_offset=pos,
                                       kv_len=kv_len, k_scale=k_scale,
                                       v_scale=v_scale)
