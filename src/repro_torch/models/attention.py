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

Speculative verify (``RunFlags.spec_verify`` with ``chunk_len``,
``_apply_verify``): a C-token draft chunk appended at ``pos`` like a
chunk, each row attending with the decode step's own numerics (its own
selection over the pre-chunk ktb and its own ``kv_len``; on the kernel
path one K1 call per row, the decode step's call); ``commit_verify``
then keeps the accepted rows, zeroes the rest and replays the decode
step's ktb update for the kept ones.

Mixed-precision serving (``RunFlags.kv_quant``, ``RunFlags.select_dtype``):
``kv_quant`` "int8" or "fp8" stores K/V narrow with one f32 scale per
(row, head) (leaves ``k_s``/``v_s``), dequantized after every gather and
inside the kernels (K1q, K3q, K4q); ``select_dtype="int8"`` stores kt/ktb
as int8 with per-row scales (``kt_s``/``ktb_s``) and runs the selection
product in integers.  As in the reference, the PRESENCE of a scale leaf
is what the apply paths branch on.  fp8 leaves move as uint8 views
(``core.quantization.raw``); no arithmetic runs on them.

Multi-head latent attention (``apply_mla``, deepseek_v3): queries and
keys through low-rank latents, the cache holding only each token's
latent ``c_kv`` (B, S, kv_lora_rank) and shared rope key ``k_rope``.
Prefill and training expand the latents to per-head keys and values and
run the attention above (DSA's pattern included, on the plain block
path in kernel mode too, as the reference does); decode and the
speculative verify attend in the latent space (W_uk absorbed into the
query, W_uv applied after the weighted sum); chunks expand the cached
latents as prefill does.  No DSA selection runs at decode: the latent
cache holds no predicted keys.

Gated cross-attention (``apply_cross_attention``; whisper_small's
decoder, llama_3_2_vision's image layers): queries from the decoder,
keys and values from the encoder's output or the image embeddings,
dense, without RoPE or DSA, as in the reference; prefill writes them to
the sub-layer's ``ck``/``cv`` and decode attends those.  An
encoder-decoder's self-attention takes no RoPE either (``_rope_qk``).

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
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import attention as A
from repro_torch.core import masks as M
from repro_torch.core import prediction as PRED
from repro_torch.core import quantization as Q
from repro_torch.core.prediction import einsum, mm
from repro_torch.core.quantization import raw
from repro_torch.distributed import collectives as C
from repro_torch.kernels import ops
from repro_torch.models.common import dense_init, rms_norm, rope

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
    # speculative decoding: the chunk-append path verifies a draft chunk,
    # each row with the decode step's own numerics (_apply_verify)
    spec_verify: bool = False
    # MoE prefill through the decode-dense expert path, token-exact with
    # chunk steps (Engine(moe_prefill="dense"))
    moe_dense: bool = False
    # observability (inference/telemetry.py): a block-path decode step
    # hands its selection (idx, ok, kv_len) out through the aux output,
    # under "sel" (logical block indices on a paged cache).  Only the
    # telemetry probe's eager step sets it, never a captured one
    sel_probe: bool = False
    # tensor parallelism (inference/engine.py under a serving mesh with a
    # "model" axis): the "model" group (distributed.collectives.AxisGroup)
    # the layers all-reduce their contracting products over; the weights
    # and cache are this rank's shard (n_heads / tp heads, n_kv_heads /
    # tp KV heads).  None: no collective.  In training (a
    # distributed.sharding.TrainPlan's) the collectives carry gradients
    tp: Any = None
    # sequence parallelism (training): the residual stream between the
    # layers is this rank's 1/tp of the sequence rows; a layer all-gathers
    # its input and reduce-scatters its output over "model"
    sp: bool = False
    # training on a mesh: the distributed.sharding.TrainPlan whose
    # ``gathers`` forward_train all-gathers each layer's data-sharded
    # leaves by (FSDP), inside the layer's remat region
    fsdp: Any = None
    # expert parallelism (training on a mesh, the reference's moe_ep
    # gate): the models.moe.EPContext of the batch, set by the plan's
    # run_flags; an MoE sub-layer then dispatches by all-to-all over
    # "model".  None: the capacity path
    ep: Any = None


def _out_proj(params, flags: RunFlags, out: torch.Tensor) -> torch.Tensor:
    """The out-projection ``out @ wo``; under tensor parallelism ``out``
    holds this rank's heads and the partial products are summed over
    "model": one all-reduce, or in training under sequence parallelism a
    reduce-scatter to this rank's sequence rows."""
    y = mm(out, params["wo"])
    return C.tp_exit(y, flags.tp, train=flags.mode == "train", sp=flags.sp)


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


def _act_mask(active: Optional[Active], b: int, device) -> torch.Tensor:
    """The (B,) mask of the rows that take part in a step: ``active``'s,
    or every row."""
    return (torch.ones((b,), dtype=torch.bool, device=device)
            if active is None else active.mask)


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
                   dtype=torch.float32, cross: bool = False) -> Dict:
    """wq/wk/wv/wo (and the biases with ``cfg.qkv_bias``); with DSA the
    predictor ``dsa``, but on a cross-attention layer (``cross``), which
    attends densely as in the reference."""
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
    if cfg.dsa.enabled and not cross:
        params["dsa"] = PRED.init_predictor(gen, d, cfg.dsa.sigma, **kw)
    return params


def _proj_qkv(params, cfg: ArchConfig, x, x_kv=None):
    """Q from ``x``, K and V from ``x_kv`` (cross-attention: the encoder's
    output or the image embeddings) or else from ``x``."""
    hd = cfg.resolved_head_dim
    xk = x if x_kv is None else x_kv
    q = mm(x, params["wq"])
    k, v = mm(xk, params["wk"]), mm(xk, params["wv"])
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    b, l = x.shape[:2]
    lk = xk.shape[1]
    return (q.reshape(b, l, cfg.n_heads, hd),
            k.reshape(b, lk, cfg.n_kv_heads, hd),
            v.reshape(b, lk, cfg.n_kv_heads, hd))


def _rope_qk(cfg: ArchConfig, q, k, pos):
    """RoPE on a self-attention layer's q and k, but for an
    encoder-decoder's (whisper's positions are the sinusoidal embeddings
    added to its inputs: the reference's ``use_rope=not cfg.enc_dec``)."""
    if cfg.enc_dec:
        return q, k
    return rope(q, pos, cfg.rope_theta), rope(k, pos, cfg.rope_theta)


def _mean_head_scores(q, k, stride: int = 1, tp=None):
    """Mean-over-heads Q K^T, the MSE target S of Eq. 6 (GQA: each KV head
    serves its group of query heads), over every ``stride``-th query row.
    Unscaled and not detached: the MSE trains q and k too, as in the
    reference.  Under tensor parallelism (``tp``, training) q and k are
    this rank's heads: their sum is divided by the whole head count and
    summed over "model" (its gradient reaches every rank's heads)."""
    hq, hkv = q.shape[2], k.shape[2]
    qs = q[:, ::stride]
    s = einsum("bqhgd,bkhd->bqk",
               qs.reshape(*qs.shape[:2], hkv, hq // hkv, -1), k)
    if tp is None:
        return s / hq
    return C.reduce_from_tp(s / (hq * tp.size), tp)


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
            aux["mse"] = PRED.mse_loss(_mean_head_scores(q, k, tp=flags.tp),
                                       s_t)
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
        aux["mse"] = PRED.mse_loss(_mean_head_scores(q, k, stride, flags.tp),
                                   s_t_sub)
    return ("block", (idx, ok)), aux


def apply_attention(params, cfg: ArchConfig, flags: RunFlags, x, *,
                    cache=None, causal: bool = True, active=None,
                    chunk_len=None, sel_len=None):
    """Returns (out, cache, aux).  x: (B, S, d).  With a cache, prefill
    fills it and decode appends one row per batch row, both in place.
    ``active`` (an ``Active``) freezes the other rows at decode; ``chunk_len``
    (B,) switches decode to the chunk-append path (x is a C-token chunk
    per row, rows past chunk_len are padding) with ``sel_len`` its
    selection geometry, or with ``flags.spec_verify`` to the speculative
    verify of a whole C-token chunk (``_apply_verify``).  ``aux`` holds
    the MSE term in train mode (with ``flags.with_mse`` and DSA on); with
    ``flags.sel_probe``, a one-token decode step's block selection
    (``"sel"``: a list of one (idx, ok, kv_len)); it is empty otherwise."""
    if flags.mode == "decode":
        sel = None
        if "page_tbl" in cache:
            if chunk_len is not None:
                raise ValueError("paged caches decode one token at a time")
            y, cache, sel = _apply_paged_decode(params, cfg, flags, x, cache,
                                                active)
        elif chunk_len is not None and flags.spec_verify:
            y, cache = _apply_verify(params, cfg, flags, x, cache, active)
        elif chunk_len is not None:
            y, cache = _apply_chunk(params, cfg, flags, x, cache, active,
                                    chunk_len, sel_len)
        else:
            y, cache, sel = _apply_decode(params, cfg, flags, x, cache,
                                          active)
        return y, cache, ({"sel": [sel]} if flags.sel_probe
                          and sel is not None else {})
    dsa = cfg.dsa
    aux: Dict[str, torch.Tensor] = {}
    # training under tensor parallelism: the heads' input, all-gathered
    # over the sequence under SP
    x = C.tp_enter(x, flags.tp, train=flags.mode == "train", sp=flags.sp)
    q, k, v = _proj_qkv(params, cfg, x)
    pos = torch.arange(x.shape[1], device=x.device)
    q, k = _rope_qk(cfg, q, k, pos)
    if dsa_active(cfg, flags):
        # the predictor runs alike on every rank of "model"
        x_rep = (C.replicated_input(x, flags.tp)
                 if flags.mode == "train" else x)
        (kind, pat), aux = _dsa_train_mask_and_aux(params, cfg, flags, x_rep,
                                                   q, k, causal)
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
    out = _out_proj(params, flags, out.reshape(*x.shape[:2], -1))
    return out, cache, aux


def apply_cross_attention(params, cfg: ArchConfig, flags: RunFlags, x,
                          enc=None, cache=None) -> torch.Tensor:
    """The attention of a gated cross-attention sub-layer (the
    reference's ``apply_attention`` with ``x_kv``, or on a cache holding
    ``ck``/``cv``).  Returns (B, S, d).

    Train and prefill: queries from ``x``, keys and values from ``enc``
    (B, T, d), the encoder's output or the image embeddings; no RoPE, no
    mask, no DSA: dense attention up to 1024 queries, the q-chunked
    ``flash_attention`` above.  Prefill also writes the keys and values
    into the cache's ``ck``/``cv`` (B, T, Hkv, hd), in place, cast to the
    cache's dtype.  Decode (one token or more a row): the queries attend
    the whole static ``ck``/``cv`` (no ``kv_len``), which no step writes;
    a cache that no prefill filled holds zeros, and then the output is
    zero.  A bf16 query against an f32 cache returns f32, as in the
    reference.

    Tensor parallelism (``flags.tp``), as the self-attention's: ``cfg``
    and the weights are this rank's heads and KV heads (its KV head where
    tp exceeds them, ``sharding.kv_group``), ``ck``/``cv`` hold its KV
    heads, and the out-projection's partial sums are added over "model"
    (in training under sequence parallelism reduce-scattered to this
    rank's rows, its input gathered first).  ``enc`` is whole on every
    rank: the keys and values are never sequence-sharded (1601 image
    tokens divide by no tp)."""
    hd = cfg.resolved_head_dim
    if flags.mode == "decode":
        b, s = x.shape[:2]
        q = mm(x, params["wq"])
        if cfg.qkv_bias:
            q = q + params["bq"]
        out = A.decode_attention(q.reshape(b, s, cfg.n_heads, hd),
                                 cache["ck"], cache["cv"])
    else:
        x = C.tp_enter(x, flags.tp, train=flags.mode == "train",
                       sp=flags.sp)
        b, s = x.shape[:2]
        q, k, v = _proj_qkv(params, cfg, x, enc)
        attend = A.dense_attention if s <= 1024 else A.flash_attention
        out = attend(q, k, v, causal=False, window=cfg.swa_window)
        if flags.mode == "prefill" and cache is not None:
            cache["ck"].copy_(k)
            cache["cv"].copy_(v)
    return _out_proj(params, flags, out.reshape(b, s, -1))


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


def param_specs_attention(cfg: ArchConfig, cross: bool = False) -> Dict:
    """Logical axes of ``init_attention``'s leaves (the reference's
    spec tree): Q/O over heads, K/V over kv_heads, the DSA predictor
    over its projection dim (replicated under the serving rules)."""
    out = {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
           "wv": ("embed", "kv_heads"), "wo": ("heads", "embed")}
    if cfg.qkv_bias:
        out.update(bq=("heads",), bk=("kv_heads",), bv=("kv_heads",))
    if cfg.dsa.enabled and not cross:
        out["dsa"] = PRED.predictor_specs()
    return out


def cache_specs_attention(cache) -> Dict:
    """Logical axes of an attention cache's leaves: dense rows over the
    batch (slots) axis and KV heads, a paged pool's rows over its pages;
    the DSA caches kt/ktb have no head axis."""
    if "page_tbl" in cache:
        out = {"k": ("pages", "kv_heads", "qkv"),
               "v": ("pages", "kv_heads", "qkv"),
               "pos": ("batch",), "page_tbl": ("batch", None)}
        if "k_s" in cache:
            out["k_s"] = ("pages", "kv_heads")
            out["v_s"] = ("pages", "kv_heads")
        if "kt" in cache:
            out["kt"] = ("pages", "pred_k")
            out["ktb"] = ("pages", "pred_k")
        if "kt_s" in cache:
            out["kt_s"] = ("pages",)
            out["ktb_s"] = ("pages",)
        return out
    out = {"k": ("batch", "cache_seq", "kv_heads", "qkv"),
           "v": ("batch", "cache_seq", "kv_heads", "qkv"),
           "pos": ("batch",)}
    if "k_s" in cache:
        out["k_s"] = ("batch", "cache_seq", "kv_heads")
        out["v_s"] = ("batch", "cache_seq", "kv_heads")
    if "kt" in cache:
        out["kt"] = ("batch", "cache_seq", "pred_k")
        out["ktb"] = ("batch", "blocks", "pred_k")
    if "kt_s" in cache:
        out["kt_s"] = ("batch", "cache_seq")
        out["ktb_s"] = ("batch", "blocks")
    return out


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
    the others attend with kv_len = 0.  Returns (out, cache, sel): ``sel``
    the block selection (idx, ok, kv_len) on the DSA block and kernel
    paths, else None."""
    b = x.shape[0]
    pos = cache["pos"].long()                              # (B,)
    q, k, v = _proj_qkv(params, cfg, x)
    q, k = _rope_qk(cfg, q, k, pos[:, None])
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
    sel = None
    if "kt" in cache:
        out, sel = _dsa_decode(params, cfg, flags, x, q, cache, slot, kv_len,
                               active)
    else:
        # a ring of s <= swa_window rows holds one window by construction;
        # the slot-positional window mask is for larger caches, pre-wrap
        win = cfg.swa_window
        out = A.decode_attention(q, *_kv_views(cache), kv_len=kv_len,
                                 window=win if win and s > win else 0)
    out = _out_proj(params, flags, out.reshape(b, 1, -1))
    return out, cache, sel


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


def _ktb_add(cache: Dict, blk: torch.Tensor, kt: torch.Tensor,
             active: Optional[Active]) -> None:
    """The decode step's block-sum update, in place: each writing row adds
    its predicted key ``kt`` (B, k) to its block ``blk`` (B,) of ktb.  An
    int8 block sum cannot add across scales: it is dequantized, added in
    f32 and requantized.  Each row adds to its own block, so a
    gather-add-scatter needs no accumulating index_put (which sorts its
    indices on the card).  ``commit_chunk`` replays it row by row."""
    rows = torch.arange(kt.shape[0], device=kt.device)
    if "ktb_s" in cache:
        old = Q.dequant(cache["ktb"][rows, blk], cache["ktb_s"][rows, blk])
        for leaf, val in zip(("ktb", "ktb_s"), Q.quant_store(old + kt)):
            _put_step_rows(cache[leaf], blk, val, active)
    else:
        _put_step_rows(cache["ktb"], blk, cache["ktb"][rows, blk]
                       + kt.to(cache["ktb"].dtype), active)


def _dsa_decode(params, cfg: ArchConfig, flags: RunFlags, x, q, cache,
                slot, kv_len, active: Optional[Active] = None):
    """DSA long-context decode step: update kt (and, on the block paths,
    ktb) in place at each writing row's ``slot``, select cache rows or
    blocks from predicted scores, gather + attend.  Returns the attention
    output (B, 1, Hq, hd) and the block selection (idx, ok, kv_len), None
    off the block paths."""
    dsa = cfg.dsa
    kc, vc = cache["k"], cache["v"]
    s = kc.shape[1]
    q_t, k_t = PRED.predict_qk(params["dsa"], x, None, dsa.quant_bits)
    kt = k_t[:, 0]
    for leaf, val in _quant_rows(cache, "kt", kt, "int8").items():
        _put_step_rows(cache[leaf], slot, val, active)
    if flags.dsa_mode == "off":
        return A.decode_attention(q, *_kv_views(cache), kv_len=kv_len), None
    if flags.dsa_mode == "faithful":
        return _faithful_decode(cfg, q, q_t, cache["kt"], cache.get("kt_s"),
                                _kv_views(cache), kv_len, s), None
    bkd = dsa.block_k
    # the slot being written is still zero (only a surplus step of a
    # bucketed step count can wrap, and its token is dropped; a
    # decode_window ring wraps for real and its block sums then go stale,
    # as the reference's do), so a plain add keeps the block sum exact
    # for every delivered token
    _ktb_add(cache, slot // bkd, kt, active)
    idx, ok = _decode_select(cfg, q_t, cache["ktb"], cache.get("ktb_s"),
                             kv_len, s)
    scales = dict(k_scale=cache.get("k_s"), v_scale=cache.get("v_s"))
    if flags.dsa_mode == "kernel":
        out = ops.dsa_decode(q, kc, vc, idx, ok, kv_len, block_k=bkd,
                             **scales)
    else:
        out = A.dsa_decode_block_attention(q, kc, vc, idx, ok, block_k=bkd,
                                           kv_len=kv_len, **scales)
    return out, (idx, ok, kv_len)


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
    selected logical blocks to pages after top-k and gather those.
    Returns (out, cache, sel), as ``_apply_decode``."""
    b = x.shape[0]
    pos = cache["pos"].long()                              # (B,)
    q, k, v = _proj_qkv(params, cfg, x)
    q, k = _rope_qk(cfg, q, k, pos[:, None])
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
    sel = None
    if "kt" in cache:
        out, sel = _dsa_paged_decode(params, cfg, flags, x, q, cache, flat,
                                     okw, pg, kv_len, view)
    else:
        out = A.decode_attention(q, *_kv_views(cache, view), kv_len=kv_len)
    out = _out_proj(params, flags, out.reshape(b, 1, -1))
    return out, cache, sel


def _dsa_paged_decode(params, cfg: ArchConfig, flags: RunFlags, x, q, cache,
                      flat, okw, pg, kv_len, view):
    """The paged twin of ``_dsa_decode``: kt writes reuse the translated
    pool row; ktb has one row per page, so the row a write adds to IS the
    write's page.  Block selection scores the logical ktb view
    ``ktb[tbl]`` and the selected logical blocks become pages only for
    the gather (the selection handed out keeps the logical indices,
    comparable across steps whatever pages back them); faithful selection
    scores the logical kt view."""
    dsa = cfg.dsa
    bk = dsa.block_k
    kc, vc = cache["k"], cache["v"]
    q_t, k_t = PRED.predict_qk(params["dsa"], x, None, dsa.quant_bits)
    for leaf, val in _quant_rows(cache, "kt", k_t[:, 0], "int8").items():
        _pool_write(cache[leaf], flat, val, okw)
    if flags.dsa_mode == "off":
        return A.decode_attention(q, *_kv_views(cache, view),
                                  kv_len=kv_len), None
    if flags.dsa_mode == "faithful":
        kt_s = cache.get("kt_s")
        return _faithful_decode(cfg, q, q_t, cache["kt"][view],
                                None if kt_s is None else kt_s[view],
                                _kv_views(cache, view), kv_len,
                                view.shape[1]), None
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
        out = ops.dsa_decode_paged(q, kc, vc, idx, pidx, ok, kv_len,
                                   block_k=bk, **scales)
    else:
        out = A.dsa_decode_paged_block_attention(q, kc, vc, idx, pidx, ok,
                                                 block_k=bk, kv_len=kv_len,
                                                 **scales)
    return out, (idx, ok, kv_len)


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
    q, k = _rope_qk(cfg, q, k, p)
    act = _act_mask(active, b, x.device)
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
    out = _out_proj(params, flags, out.reshape(b, c, -1))
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


# -- speculative verify (draft-and-verify decode) ----------------------------

# the float K~ rows of a verify chunk (B, C, k), kept for commit_chunk's
# ktb replay where ktb is int8 (the decode step adds the float row, not
# the stored int8 one).  Scratch the caller owns
# (``transformer.spec_scratch``), set beside the layer's leaves only in
# the view of the cache a verify_step or commit_chunk passes down
PEND_KEY = "kt_pend"


def _pend(cache: Dict, flags: RunFlags, cfg: ArchConfig):
    """The layer's verify scratch where the block paths' commit needs it
    (an int8 ktb), else None; raises where it is needed and missing."""
    if not ("ktb_s" in cache and dsa_active(cfg, flags)
            and flags.dsa_mode != "faithful"):
        return None
    if cache.get(PEND_KEY) is None:
        raise ValueError("an int8 ktb needs the verify's float K~ rows: "
                         "pass transformer.spec_scratch(...) to verify_step "
                         "and commit_chunk")
    return cache[PEND_KEY]


def _apply_verify(params, cfg: ArchConfig, flags: RunFlags, x, cache,
                  active: Optional[Active]):
    """Draft-verify chunk append: C tokens (the pending token and C-1
    drafts) written at each row's ``pos`` as ``_apply_chunk`` writes, but
    each row attends with the DECODE step's numerics: row i is the
    ``_apply_decode`` step at depth ``pos + i``, with its own selection,
    its own ``kv_len = pos + i + 1`` and the f32 softmax, over the whole
    cache (there is no ``sel_len``).  Every product (the projections,
    the predictor, the MLP) runs once over the C rows, so its bytes may
    differ from the decode step's in the last bits (tokens are held, not
    bytes: ``inference/speculative.py``).

    Every row of K, V and kt (with their scales) is written, rows at or
    past the cache's end dropped, never wrapped; ``pos`` advances by C on
    active rows, and an inactive row writes nothing.  ``ktb`` is NOT
    touched: every block the chunk touches lies inside each row's
    DECODE_LOCAL window (C <= DECODE_LOCAL, ``speculative.can_speculate``),
    so it is force-kept and its stale sum never counts; ``commit_chunk``
    replays the decode step's ktb update for the accepted rows and zeroes
    the rejected ones.  A verify step must be followed by that commit.
    Under int8 selection on the block paths the rows' float K~ go to the
    caller's scratch (``cache[PEND_KEY]``, (B, C, k)) for that replay."""
    if cfg.swa_window:
        raise NotImplementedError("speculative verify needs a non-wrapping "
                                  "cache")
    b, c = x.shape[:2]
    s = cache["k"].shape[1]
    pos = cache["pos"].long()                              # (B,)
    q, k, v = _proj_qkv(params, cfg, x)
    p = pos[:, None] + torch.arange(c, device=x.device)[None, :]
    q, k = _rope_qk(cfg, q, k, p)
    act = _act_mask(active, b, x.device)
    wok = act[:, None].expand(b, c)
    for leaf, val in _kv_rows(cache, k, v, flags.kv_quant).items():
        _write_rows(cache[leaf], p, val, wok)
    cache["pos"].copy_(pos + torch.where(act, c, 0))
    kv_row = torch.where(act[:, None], torch.clamp(p + 1, max=s),
                         0).to(torch.int32)                # (B, C)
    if "kt" in cache:
        q_t, k_t = PRED.predict_qk(params["dsa"], x, None, cfg.dsa.quant_bits)
        for leaf, val in _quant_rows(cache, "kt", k_t, "int8").items():
            _write_rows(cache[leaf], p, val, wok)
        if dsa_active(cfg, flags):
            pend = _pend(cache, flags, cfg)
            if pend is not None:
                pend.copy_(k_t.float())
            out = _dsa_verify_attend(cfg, flags, q, q_t, cache, kv_row)
        else:
            # off on a long-context cache: dense decode over the buffer
            out = A.chunk_attention(q, *_kv_views(cache), p)
    else:
        out = A.chunk_attention(q, *_kv_views(cache), p)
    out = _out_proj(params, flags, out.reshape(b, c, -1))
    return out, cache


def _dsa_verify_attend(cfg: ArchConfig, flags: RunFlags, q, q_t, cache,
                       kv_row):
    """Per-row DSA selection and attention of a verify chunk: the twin of
    ``_dsa_decode``'s paths, each row with the decode step's shapes.
    q_t: (B, C, k) the rows' predicted queries; kv_row: (B, C).  Faithful
    scores all kt rows (every chunk row written; later rows are past a
    row's kv_len); block and kernel score the PRE-chunk ktb.  In kernel
    mode K1 (K1q on a quantized cache) runs once per row, each call the
    decode step's: a (B, 1, Hq, hd) query with that row's idx, ok and
    kv_len."""
    kc, vc = cache["k"], cache["v"]
    s = kc.shape[1]
    c = q.shape[1]
    if flags.dsa_mode == "faithful":
        if "kt_s" in cache:
            s_t = _int8_select_scores(q_t, cache["kt"], cache["kt_s"])
        else:
            s_t = torch.einsum("bck,bsk->bcs", q_t.float(),
                               cache["kt"].float())
        return A.dsa_verify_attention(
            q, *_kv_views(cache), s_t,
            keep=M.keep_count(s, cfg.dsa.sparsity), kv_len=kv_row,
            local=DECODE_LOCAL)
    dsa = cfg.dsa
    bkd = dsa.block_k
    ktb, ktb_s = cache["ktb"], cache.get("ktb_s")
    n_kb = ktb.shape[1]
    if ktb_s is not None:
        s_blk = _int8_select_scores(q_t, ktb, ktb_s, block_k=bkd)
    else:
        s_blk = torch.einsum("bck,bjk->bcj", q_t.float(), ktb.float()) / bkd
    keep = M.keep_count(s, dsa.sparsity)
    nb_keep = min(n_kb, -(-keep // bkd) + -(-DECODE_LOCAL // bkd) + 1)
    idx, ok = M.verify_block_topk_indices(s_blk, nb_keep, kv_len=kv_row,
                                          block_k=bkd, local=DECODE_LOCAL)
    scales = dict(k_scale=cache.get("k_s"), v_scale=cache.get("v_s"))
    if flags.dsa_mode == "kernel":
        return torch.cat([
            ops.dsa_decode(q[:, i:i + 1].contiguous(), kc, vc,
                           idx[:, i].contiguous(), ok[:, i].contiguous(),
                           kv_row[:, i].contiguous(), block_k=bkd, **scales)
            for i in range(c)], dim=1)
    return A.dsa_verify_block_attention(q, kc, vc, idx, ok, block_k=bkd,
                                        kv_len=kv_row, **scales)


def commit_verify(cfg: ArchConfig, flags: RunFlags, cache: Dict,
                  keep: torch.Tensor, c: int,
                  active: Optional[Active] = None) -> None:
    """Commit one layer's verify chunk in place (``transformer.
    commit_chunk``): keep its first ``keep`` (B,) rows, zero the rejected
    rows [start + keep, start + C) of every per-token leaf, and set
    ``pos = start + keep``, where ``start = pos - C`` on active rows.  On
    the block and kernel paths the accepted rows' ktb update is REPLAYED
    as the decode step makes it (``_ktb_add``, float add or int8
    dequant-add-requant), row by row in order, row i where i < keep, so
    ktb/ktb_s end exactly as sequential decode leaves them; an int8 ktb
    adds the float K~ rows the verify kept in ``cache[PEND_KEY]``.  (The
    reference re-sums the touched blocks' kt rows instead; on the card a
    block sum does not add in the per-step order, and under int8
    selection the decode step adds the float row, not the stored int8
    one.)  Faithful and off decode steps leave ktb alone, and so does
    their commit.  An inactive row changes nothing.  Dense caches only."""
    if "page_tbl" in cache:
        raise ValueError("commit_chunk does not support paged caches: "
                         "speculation is off on a paged engine")
    b = cache["pos"].shape[0]
    dev = cache["pos"].device
    act = _act_mask(active, b, dev)
    keep = torch.where(act, keep.to(dev).long(), 0)
    start = cache["pos"].long() - torch.where(act, c, 0)
    offs = torch.arange(c, device=dev)
    p = start[:, None] + offs[None, :]                     # (B, C)
    rejected = (offs[None, :] >= keep[:, None]) & act[:, None]
    for name in ("k", "v", "kt", "k_s", "v_s", "kt_s", "c_kv", "k_rope"):
        if name in cache:
            t = cache[name]
            _write_rows(t, p, torch.zeros((b, c) + t.shape[2:], dtype=t.dtype,
                                          device=dev), rejected)
    cache["pos"].copy_(start + keep)
    if "ktb" in cache and dsa_active(cfg, flags) and \
            flags.dsa_mode != "faithful":
        bkd = cfg.dsa.block_k
        s = cache["kt"].shape[1]
        rows = torch.arange(b, device=dev)
        pend = _pend(cache, flags, cfg)
        for i in range(c):
            slot = p[:, i].clamp(max=s - 1)
            kt = pend[:, i] if pend is not None else cache["kt"][rows, slot]
            _ktb_add(cache, slot // bkd, kt, Active(act & (keep > i)))


# ---------------------------------------------------------------------------
# multi-head latent attention (DeepSeek MLA)
# ---------------------------------------------------------------------------

# the MLA leaves each rank holds whole under tensor parallelism but feeds
# only its heads with (the latent projections and their norms): ("attn",
# leaf) of a sub-block.  Their gradients are summed over "model" once a
# step (``sharding.TrainPlan.partials``)
MLA_PARTIAL = (("attn", "q_a"), ("attn", "q_a_norm"), ("attn", "kv_a"),
               ("attn", "kv_a_norm"))


def init_mla(gen: torch.Generator, cfg: ArchConfig, *, device,
             dtype=torch.float32) -> Dict:
    """The latent projections: queries through a ``q_lora_rank``
    bottleneck, keys and values through the ``kv_lora_rank`` latent
    ``c_kv`` plus one shared rope key; with DSA, the predictor on
    d_model."""
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk_h = m.qk_nope_head_dim + m.qk_rope_head_dim
    kw = dict(device=device, dtype=dtype)
    params = {
        "q_a": dense_init(gen, (d, m.q_lora_rank), **kw),
        "q_a_norm": torch.ones((m.q_lora_rank,), **kw),
        "q_b": dense_init(gen, (m.q_lora_rank, h * qk_h), **kw),
        "kv_a": dense_init(gen, (d, m.kv_lora_rank + m.qk_rope_head_dim),
                           **kw),
        "kv_a_norm": torch.ones((m.kv_lora_rank,), **kw),
        "kv_b": dense_init(gen, (m.kv_lora_rank,
                                 h * (m.qk_nope_head_dim + m.v_head_dim)),
                           **kw),
        "wo": dense_init(gen, (h * m.v_head_dim, d), **kw),
    }
    if cfg.dsa.enabled:
        params["dsa"] = PRED.init_predictor(gen, d, cfg.dsa.sigma, **kw)
    return params


def param_specs_mla(cfg: ArchConfig) -> Dict:
    """Logical axes of ``init_mla``'s leaves."""
    out = {"q_a": ("embed", "lora"), "q_a_norm": ("lora",),
           "q_b": ("lora", "heads"),
           "kv_a": ("embed", "lora"), "kv_a_norm": ("lora",),
           "kv_b": ("lora", "heads"), "wo": ("heads", "embed")}
    if cfg.dsa.enabled:
        out["dsa"] = PRED.predictor_specs()
    return out


def cache_specs_mla(cache) -> Dict:
    """Logical axes of an MLA cache's leaves."""
    return {"c_kv": ("batch", "cache_seq", "lora"),
            "k_rope": ("batch", "cache_seq", None), "pos": ("batch",)}


def _mla_qkv(params, cfg: ArchConfig, x, pos):
    """(q_nope (B, S, H, nope), q_rope (B, S, H, rope), c_kv (B, S, r),
    k_rope (B, S, 1, rope)) at positions ``pos`` ((S,) or (B, S))."""
    m = cfg.mla
    b, s = x.shape[:2]
    q = mm(rms_norm(mm(x, params["q_a"]), params["q_a_norm"]),
           params["q_b"]).reshape(b, s, cfg.n_heads, -1)
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = rope(q[..., m.qk_nope_head_dim:], pos, cfg.rope_theta)
    kv = mm(x, params["kv_a"])
    c_kv = rms_norm(kv[..., :m.kv_lora_rank], params["kv_a_norm"])
    k_rope = rope(kv[..., None, m.kv_lora_rank:], pos, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def _mla_expand(params, cfg: ArchConfig, c_kv, k_rope):
    """The non-absorbed keys and values: c_kv (B, S, r) through ``kv_b``
    to (k_nope, v) per head, the shared k_rope (B, S, rope) broadcast to
    every head.  Returns k (B, S, H, nope + rope), v (B, S, H, v)."""
    m = cfg.mla
    b, s = c_kv.shape[:2]
    h = cfg.n_heads
    kvb = mm(c_kv, params["kv_b"]).reshape(
        b, s, h, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = kvb[..., :m.qk_nope_head_dim], kvb[..., m.qk_nope_head_dim:]
    k = torch.cat([k_nope, k_rope[:, :, None].expand(
        b, s, h, m.qk_rope_head_dim).to(k_nope.dtype)], dim=-1)
    return k, v


def apply_mla(params, cfg: ArchConfig, flags: RunFlags, x, *, cache=None,
              causal: bool = True, active=None, chunk_len=None,
              sel_len=None):
    """MLA's ``apply_attention``: returns (out, cache, aux), the cache
    (``c_kv``, ``k_rope``, ``pos``) filled or appended to in place.

    Prefill and training expand the latents to per-head keys and values
    and attend as a GQA layer with one query head per KV head: with DSA,
    the pattern of ``_dsa_train_mask_and_aux`` over the 192-wide q and k
    (the token path, or ``core.attention.dsa_sparse_attention`` on the
    block path, ``"kernel"`` included: the reference launches no kernel
    for MLA, and K2 takes one head width for q, k and v), else dense
    attention up to 1024 tokens and flash attention past them.  Decode
    runs in the latent space (``_apply_mla_decode``); ``chunk_len`` takes
    the chunk path (``_apply_mla_chunk``), with ``flags.spec_verify``
    the verify (``_apply_mla_verify``).  Neither decode form selects:
    DSA over MLA has no predicted-key cache.

    Tensor parallelism (``flags.tp``, the reference's specs: ``q_b``'s
    and ``kv_b``'s columns and ``wo``'s rows over "heads"): ``cfg`` is
    this rank's n_heads / tp heads, whose columns of ``q_b`` (H x (nope
    + rope)) and ``kv_b`` (H x (nope + v)) are contiguous, head-major,
    and ``wo``'s rows give a partial sum added over "model"
    (``_out_proj``; in training under SP reduce-scattered to this rank's
    rows, its input gathered first).  ``q_a``, ``kv_a``, their norms and
    the latent cache (``c_kv``, ``k_rope``) are whole on every rank:
    every rank computes the same latents and writes the same cache rows.
    In training their leaves feed only the rank's heads, so each rank
    holds its part of their gradients, summed over "model" once a step
    (``MLA_PARTIAL``, ``sharding.TrainPlan.partials``: it costs no
    per-layer collective, where ``copy_to_tp`` on the latents would add
    one a layer).  The DSA predictor runs alike on every rank
    (``collectives.replicated_input``) and so selects alike; the MSE
    target is the mean over every rank's heads (``_mean_head_scores``)."""
    if flags.mode == "decode":
        if chunk_len is not None and flags.spec_verify:
            return (_apply_mla_verify(params, cfg, flags, x, cache, active),
                    cache, {})
        if chunk_len is not None:
            return _apply_mla_chunk(params, cfg, flags, x, cache, active,
                                    chunk_len, sel_len), cache, {}
        return (_apply_mla_decode(params, cfg, flags, x, cache, active),
                cache, {})
    train = flags.mode == "train"
    x = C.tp_enter(x, flags.tp, train=train, sp=flags.sp)
    b, s = x.shape[:2]
    pos = torch.arange(s, device=x.device)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(params, cfg, x, pos)
    k, v = _mla_expand(params, cfg, c_kv, k_rope[:, :, 0])
    q = torch.cat([q_nope, q_rope], dim=-1)
    aux: Dict[str, torch.Tensor] = {}
    if dsa_active(cfg, flags):
        # the predictor runs alike on every rank of "model"
        x_rep = C.replicated_input(x, flags.tp) if train else x
        (kind, pat), aux = _dsa_train_mask_and_aux(params, cfg, flags, x_rep,
                                                   q, k, True)
        if kind == "token":
            out = A.dense_attention(q, k, v, causal=True, token_mask=pat)
        else:
            out = A.dsa_sparse_attention(q, k, v, *pat,
                                         block_q=cfg.dsa.block_q,
                                         block_k=cfg.dsa.block_k, causal=True)
    elif s <= 1024:
        out = A.dense_attention(q, k, v, causal=True)
    else:
        out = A.flash_attention(q, k, v, causal=True)
    if flags.mode == "prefill" and cache is not None:
        cache["c_kv"][:, :s] = c_kv.to(cache["c_kv"].dtype)
        cache["k_rope"][:, :s] = k_rope[:, :, 0].to(cache["k_rope"].dtype)
        cache["pos"].fill_(s)
    return _out_proj(params, flags, out.reshape(b, s, -1)), cache, aux


def init_cache_mla(cfg: ArchConfig, batch: int, max_len: int, *, device,
                   dtype=torch.bfloat16, pages=None) -> Dict:
    """The latent cache: ``c_kv`` (B, S, kv_lora_rank), ``k_rope`` (B, S,
    qk_rope_head_dim) and ``pos`` (B,): 576 values a token at
    deepseek_v3's widths.  Dense only (``engine.can_page``)."""
    if pages is not None:
        raise ValueError("an MLA cache keeps the dense layout: it cannot "
                         "be paged")
    m = cfg.mla
    kw = dict(device=device, dtype=dtype)
    return {"c_kv": torch.zeros((batch, max_len, m.kv_lora_rank), **kw),
            "k_rope": torch.zeros((batch, max_len, m.qk_rope_head_dim), **kw),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _mla_append(params, cfg: ArchConfig, x, cache, act, live):
    """Project a C-token chunk at each row's ``pos`` and write its latent
    rows there in place: rows where ``live`` (B, C) as they are, the
    others of an active row as zeros, nothing on an inactive row, rows
    past the cache's end dropped (``_write_rows``).  Returns (q_nope,
    q_rope, p (B, C) the rows' positions)."""
    b, c = x.shape[:2]
    pos = cache["pos"].long()
    p = pos[:, None] + torch.arange(c, device=x.device)[None, :]
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(params, cfg, x, p)
    wok = act[:, None].expand(b, c)
    lv = live[..., None]
    _write_rows(cache["c_kv"], p, torch.where(lv, c_kv, 0), wok)
    _write_rows(cache["k_rope"], p, torch.where(lv, k_rope[:, :, 0], 0), wok)
    return q_nope, q_rope, p


def _apply_mla_chunk(params, cfg: ArchConfig, flags: RunFlags, x, cache,
                     active: Optional[Active], chunk_len, sel_len=None):
    """Chunk append: C latent rows written at ``pos`` (pad rows zeroed,
    the state ``truncate_cache`` leaves), ``pos`` advanced by chunk_len,
    then the chunk's queries attend NON-absorbed: the cached latents of
    the first ``sel_len`` rows are expanded through ``kv_b`` as
    whole-prompt prefill expands them, so chunked MLA prefill gives its
    numbers on real rows.  DSA over MLA does not chunk
    (``engine.can_chunk_prefill``)."""
    b, c = x.shape[:2]
    act = _act_mask(active, b, x.device)
    live = (torch.arange(c, device=x.device)[None, :]
            < chunk_len.long()[:, None]) & act[:, None]
    q_nope, q_rope, p = _mla_append(params, cfg, x, cache, act, live)
    cache["pos"].add_(torch.where(act, chunk_len.long(), 0).to(torch.int32))
    sel = cache["c_kv"].shape[1] if sel_len is None else sel_len
    k, v = _mla_expand(params, cfg, cache["c_kv"][:, :sel].to(x.dtype),
                       cache["k_rope"][:, :sel].to(x.dtype))
    out = A.chunk_attention(torch.cat([q_nope, q_rope], dim=-1), k, v, p)
    return _out_proj(params, flags, out.reshape(b, c, -1))


def _mla_latent_attend(params, cfg: ArchConfig, q_nope, q_rope, cache,
                       kv_len):
    """ABSORBED attention over the whole latent cache: q_nope through
    W_uk into the latent space, scores against every ``c_kv`` and
    ``k_rope`` row (slots at or past ``kv_len`` (B, C) masked), the f32
    softmax, values combined in the latent space and expanded through
    W_uv.  q_*: (B, C, H, .).  Returns (B, C, H * v).  The casts are the
    reference's: on an f32 cache the output is f32."""
    m = cfg.mla
    b, c, h = q_nope.shape[:3]
    ckc, krc = cache["c_kv"], cache["k_rope"]
    kvb = params["kv_b"].reshape(m.kv_lora_rank, h,
                                 m.qk_nope_head_dim + m.v_head_dim)
    w_uk, w_uv = kvb[..., :m.qk_nope_head_dim], kvb[..., m.qk_nope_head_dim:]
    q_eff = einsum("bchn,rhn->bchr", q_nope, w_uk)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    s_all = (torch.einsum("bchr,bsr->bchs", q_eff, ckc.to(q_eff.dtype))
             + torch.einsum("bchn,bsn->bchs", q_rope, krc.to(q_rope.dtype))
             ) * scale
    kj = torch.arange(ckc.shape[1], device=ckc.device)
    s_all = torch.where(kj[None, None, None, :] < kv_len[:, :, None, None],
                        s_all, A.NEG)
    pattn = torch.softmax(s_all.float(), dim=-1)
    o_lat = torch.einsum("bchs,bsr->bchr", pattn.to(ckc.dtype), ckc)
    out = torch.einsum("bchr,rhv->bchv", o_lat, w_uv.to(o_lat.dtype))
    return out.reshape(b, c, -1)


def _apply_mla_decode(params, cfg: ArchConfig, flags: RunFlags, x, cache,
                      active: Optional[Active] = None):
    """Absorbed decode, one token a row at its own ``pos``: its latent
    row written there (an inactive row or one past the cache's end
    writes nothing), ``pos`` advanced on active rows, and the row attends
    slots [0, pos] (an inactive row nothing).  Fixed shapes, no host
    sync: the form a CUDA graph captures."""
    b = x.shape[0]
    act = _act_mask(active, b, x.device)
    live = act[:, None]
    q_nope, q_rope, p = _mla_append(params, cfg, x, cache, act, live)
    kv_len = torch.where(live, p + 1, 0)
    cache["pos"].add_(act.to(torch.int32))
    out = _mla_latent_attend(params, cfg, q_nope, q_rope, cache, kv_len)
    return _out_proj(params, flags, out)


def _apply_mla_verify(params, cfg: ArchConfig, flags: RunFlags, x, cache,
                      active: Optional[Active]):
    """Draft verify: the C rows written at ``pos`` as the chunk path
    writes them (every row real), ``pos`` advanced by C on active rows,
    and each row scored ABSORBED as ``_apply_mla_decode`` scores it, with
    its own ``kv_len = pos + i + 1``: row i is the decode step at depth
    pos + i (the same tokens; a product over C rows may round otherwise
    than one over 1).  ``commit_verify`` then zeroes the rejected rows."""
    b, c = x.shape[:2]
    act = _act_mask(active, b, x.device)
    live = act[:, None].expand(b, c)
    q_nope, q_rope, p = _mla_append(params, cfg, x, cache, act, live)
    kv_len = torch.where(live, p + 1, 0)
    cache["pos"].add_(torch.where(act, c, 0).to(torch.int32))
    out = _mla_latent_attend(params, cfg, q_nope, q_rope, cache, kv_len)
    return _out_proj(params, flags, out)
