"""GQA attention with first-class DSA (paper §3), prefill and decode.

Each ``init_*`` returns a dict of tensors.  When ``cfg.dsa.enabled`` and
the run flags ask for it, prefill computes approximate scores through the
prediction path, derives the dynamic sparse pattern and runs the sparse
attention (MSE is a training term and is not computed at serving).

Decode fast path (RunFlags(mode="decode", long_context=True)): the KV
cache carries the predicted-key cache ``kt`` (B, S, k) and its
block-pooled twin ``ktb`` (B, S/block_k, k), running block sums, so each
step's selection is a top-k over S/block_k block scores.  ``dsa_mode``:

  off       dense decode over the whole cache (kt/ktb kept up to date)
  block     block selection over ktb + plain block gather
            (core.attention.dsa_decode_block_attention)
  kernel    same selection, CUDA gather-attend kernel K1
            (kernels.ops.dsa_decode)

``faithful`` (token-granularity decode) is not ported yet and raises.

Caches are updated IN PLACE (the JAX reference returns new trees): each
layer's cache dict is written row by row during decode, and prefill fills
it in place.  Cache writes never go out of range: the write slot wraps as
``pos % s`` once ``pos`` reaches the cache length, exactly the slot the
reference's ring formula picks, so the surplus steps of a bucketed step
count (which the reference also runs) write where the reference writes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import attention as A
from repro_torch.core import masks as M
from repro_torch.core import prediction as PRED
from repro_torch.core.prediction import mm
from repro_torch.kernels import ops
from repro_torch.models.common import dense_init, rope

# Trailing tokens always attended at decode.
DECODE_LOCAL = 64

DSA_MODES = ("off", "faithful", "block", "kernel")


@dataclasses.dataclass(frozen=True)
class RunFlags:
    """Runtime execution choices (not architecture)."""
    mode: str = "prefill"          # prefill | decode
    dsa_mode: str = "block"        # off | faithful | block | kernel
    long_context: bool = False     # DSA decode over the predicted-key cache


def dsa_active(cfg: ArchConfig, flags: RunFlags) -> bool:
    return cfg.dsa.enabled and flags.dsa_mode != "off"


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


def _dsa_prefill_pattern(params, cfg: ArchConfig, flags: RunFlags, x,
                         causal: bool):
    """The DSA pattern for prefill: the reference's
    ``_dsa_train_mask_and_aux`` without the (training-only) MSE term.

    Returns ("token", mask (B, L, L)) on the token path (faithful mode, or
    a length that is not a block multiple: every prompt bucket under
    block_q) or ("block", (idx, ok)) on the block path."""
    dsa = cfg.dsa
    b, l = x.shape[:2]
    if flags.dsa_mode == "faithful" or l % dsa.block_q or l % dsa.block_k:
        s_t = PRED.predict_scores(params["dsa"], x, None, bits=dsa.quant_bits)
        pm = A._pos_mask(l, l, causal, cfg.swa_window, device=x.device)
        valid = None if pm is None else pm.expand(b, l, l)
        keep = M.keep_count(l, dsa.sparsity)
        return "token", M.row_topk_mask(s_t, keep, valid)
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
    return "block", (idx, ok)


def apply_attention(params, cfg: ArchConfig, flags: RunFlags, x, *,
                    cache=None, causal: bool = True):
    """Returns (out, cache).  x: (B, S, d).  With a cache, prefill fills
    it and decode appends one row per batch row, both in place."""
    if flags.mode == "decode":
        return _apply_decode(params, cfg, flags, x, cache)
    dsa = cfg.dsa
    q, k, v = _proj_qkv(params, cfg, x)
    pos = torch.arange(x.shape[1], device=x.device)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    if dsa_active(cfg, flags):
        kind, pat = _dsa_prefill_pattern(params, cfg, flags, x, causal)
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
        _fill_cache(cfg, cache, k, v, params, x)
    out = mm(out.reshape(*x.shape[:2], -1), params["wo"])
    return out, cache


def init_cache_attention(cfg: ArchConfig, batch: int, max_len: int,
                         flags: RunFlags, *, device,
                         dtype=torch.bfloat16) -> Dict:
    """Dense cache layout: k/v (B, S, Hkv, hd), per-row ``pos`` (B,), and
    with DSA decode the kt (B, S, k) / ktb (B, S/block_k, k) caches.  S is
    rounded up to a block_k multiple on the DSA decode path (the gather
    paths then never pad the cache)."""
    if cfg.swa_window:
        raise NotImplementedError("sliding-window (ring) caches are not "
                                  "ported to repro_torch yet")
    hd = cfg.resolved_head_dim
    s = max_len
    dsa_decode = cfg.dsa.enabled and flags.long_context
    if dsa_decode:
        s = -(-s // cfg.dsa.block_k) * cfg.dsa.block_k
    kw = dict(device=device, dtype=dtype)
    c = {"k": torch.zeros((batch, s, cfg.n_kv_heads, hd), **kw),
         "v": torch.zeros((batch, s, cfg.n_kv_heads, hd), **kw),
         "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if dsa_decode:
        kp = PRED.predictor_k(cfg.d_model, cfg.dsa.sigma)
        c["kt"] = torch.zeros((batch, s, kp), **kw)
        c["ktb"] = torch.zeros((batch, s // cfg.dsa.block_k, kp), **kw)
    return c


def _block_sums(kt: torch.Tensor, block_k: int, n_kb: int) -> torch.Tensor:
    """(..., S, k) -> (..., n_kb, k) sums of block_k consecutive rows."""
    pad = n_kb * block_k - kt.shape[-2]
    if pad:
        kt = torch.nn.functional.pad(kt, (0, 0, 0, pad))
    return kt.reshape(*kt.shape[:-2], n_kb, block_k, kt.shape[-1]).sum(-2)


def _fill_cache(cfg: ArchConfig, cache: Dict, k, v, params, x) -> None:
    """Write a prefill's K/V (and kt, ktb) into ``cache`` in place.  Rows
    are cast to the cache's dtype (a bf16 model keeps an f32 cache)."""
    s = cache["k"].shape[1]
    t = k.shape[1]
    if t > s:
        raise ValueError(f"prompt of {t} tokens does not fit a cache of {s}")
    cache["k"][:, :t] = k.to(cache["k"].dtype)
    cache["v"][:, :t] = v.to(cache["v"].dtype)
    cache["pos"].fill_(t)
    if "kt" in cache:
        _, k_t = PRED.predict_qk(params["dsa"], x, None, cfg.dsa.quant_bits)
        cache["kt"][:, :t] = k_t.to(cache["kt"].dtype)
        cache["ktb"].copy_(_block_sums(cache["kt"], cfg.dsa.block_k,
                                       cache["ktb"].shape[1]))


def _apply_decode(params, cfg: ArchConfig, flags: RunFlags, x, cache):
    """Single-token decode: every batch row at its own ``pos``."""
    b = x.shape[0]
    pos = cache["pos"].long()                              # (B,)
    q, k, v = _proj_qkv(params, cfg, x)
    q = rope(q, pos[:, None], cfg.rope_theta)
    k = rope(k, pos[:, None], cfg.rope_theta)
    s = cache["k"].shape[1]
    slot = torch.where(pos < s, pos, pos % s)              # ring wrap
    rows = torch.arange(b, device=x.device)
    kc, vc = cache["k"], cache["v"]
    kc[rows, slot] = k[:, 0].to(kc.dtype)
    vc[rows, slot] = v[:, 0].to(vc.dtype)
    cache["pos"] = (pos + 1).to(torch.int32)
    kv_len = torch.clamp(pos + 1, max=s).to(torch.int32)
    if "kt" in cache:
        out = _dsa_decode(params, cfg, flags, x, q, cache, slot, kv_len)
    else:
        out = A.decode_attention(q, kc, vc, kv_len=kv_len)
    out = mm(out.reshape(b, 1, -1), params["wo"])
    return out, cache


def _dsa_decode(params, cfg: ArchConfig, flags: RunFlags, x, q, cache,
                slot, kv_len):
    """DSA long-context decode step: update kt/ktb in place, select cache
    blocks from predicted block scores, gather + attend.  Returns the
    attention output (B, 1, Hq, hd)."""
    dsa = cfg.dsa
    kc, vc = cache["k"], cache["v"]
    b, s = kc.shape[0], kc.shape[1]
    rows = torch.arange(b, device=x.device)
    q_t, k_t = PRED.predict_qk(params["dsa"], x, None, dsa.quant_bits)
    cache["kt"][rows, slot] = k_t[:, 0].to(cache["kt"].dtype)
    if flags.dsa_mode == "off":
        return A.decode_attention(q, kc, vc, kv_len=kv_len)
    if flags.dsa_mode not in ("block", "kernel"):
        raise NotImplementedError(
            f"dsa_mode={flags.dsa_mode!r} decode is not ported yet")
    keep = M.keep_count(s, dsa.sparsity)
    bkd = dsa.block_k
    n_kb = cache["ktb"].shape[1]
    # the slot being written is still zero (only a surplus step of a
    # bucketed step count can wrap, and its token is dropped), so a plain
    # add keeps the block sum exact for every delivered token
    cache["ktb"][rows, slot // bkd] += k_t[:, 0].to(cache["ktb"].dtype)
    s_blk = torch.einsum("bok,bjk->bj", q_t.float(),
                         cache["ktb"].float()) / bkd
    nb_keep = min(n_kb, -(-keep // bkd) + -(-DECODE_LOCAL // bkd) + 1)
    idx, ok = M.decode_block_topk_indices(s_blk, nb_keep, kv_len=kv_len,
                                          block_k=bkd, local=DECODE_LOCAL)
    if flags.dsa_mode == "kernel":
        return ops.dsa_decode(q, kc, vc, idx, ok, kv_len, block_k=bkd)
    return A.dsa_decode_block_attention(q, kc, vc, idx, ok, block_k=bkd,
                                        kv_len=kv_len)
