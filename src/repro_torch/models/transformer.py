"""Top-level model: embedding -> layer groups -> head.

Public API:
  init_model(seed, cfg, device=None)          -> params
  forward(params, cfg, flags, tokens, caches) -> (logits, caches)
  forward_train(params, cfg, flags, tokens)   -> (logits, aux)
  decode_step(params, cfg, flags, tokens, caches, active=None)
                                              -> (logits, caches)
  chunk_step(params, cfg, flags, tokens, caches, chunk_len, active=None,
             sel_len=None)                    -> (logits, caches)
  init_cache(cfg, batch, max_len, flags, ..., pages=None) -> caches
  zero_cache(caches)                          -> caches (in place)
  truncate_cache(cfg, caches, length)         -> caches (in place)

Parameters are nested dicts of tensors, one dict per group in
``params["groups"]`` (the JAX reference stacks groups over a leading
layer axis; ``repro_torch.convert`` unstacks them).  Caches are likewise a
per-layer list, ``caches["groups"][i]["b0"]["attn"]``: the layout the
reference's ``unstack_group_caches`` produces for its decode loop, so no
unstacking step is needed here.  An RWKV6 layer's cache holds its
recurrent state ``s`` and the last tokens ``x_prev`` and ``ffn_prev``
instead of K/V rows.

``forward_train`` is the training forward (``RunFlags(mode="train")``, no
cache): it also returns ``aux``, each of ``AUX_KEYS`` an f32 scalar summed
over the layers (``mse``, the DSA predictor's Eq. 6 term; ``router``, 0
here: no MoE arch is ported).  With ``cfg.remat`` and ``remat_policy``
"full" each layer group runs under ``torch.utils.checkpoint`` when a
gradient is being taken, so the backward pass recomputes its activations
instead of holding them.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.prediction import mm
from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.core.quantization import raw
from repro_torch.models.attention import RunFlags, _rebuild_ktb, as_active
from repro_torch.models.common import dense_init, rms_norm

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

AUX_KEYS = ("mse", "router")


def init_model(seed: int, cfg: ArchConfig, *, device=None) -> Dict[str, Any]:
    """Random weights from ``seed`` (a ``torch.Generator`` on the target
    device), in ``cfg.param_dtype``.  ``device=None`` means the card."""
    dev = resolve_device(device)
    dt = DTYPES[cfg.param_dtype]
    gen = torch.Generator(device=dev).manual_seed(seed)
    kw = dict(device=dev, dtype=dt)
    params: Dict[str, Any] = {
        "embed": dense_init(gen, (cfg.vocab, cfg.d_model), **kw),
        "groups": [B.init_group(gen, cfg, **kw)
                   for _ in range(B.n_groups(cfg))],
        "final_norm": torch.ones((cfg.d_model,), **kw),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab), **kw)
    return params


def forward(params, cfg: ArchConfig, flags: RunFlags, tokens: torch.Tensor,
            caches=None, **step):
    """tokens: (B, S) int.  Returns (logits (B, S, V), caches).  ``step``:
    the decode-time ``active``, ``chunk_len`` and ``sel_len`` (see
    ``decode_step`` and ``chunk_step``)."""
    x = params["embed"][tokens.long()].to(DTYPES[cfg.dtype])
    defs = B.group_defs(cfg)
    for i, gp in enumerate(params["groups"]):
        c = None if caches is None else caches["groups"][i]
        x, _, _ = B.apply_group(gp, cfg, flags, defs, x, cache=c, **step)
    return _head(params, cfg, x), caches


def _head(params, cfg: ArchConfig, x):
    x = rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    return mm(x, head.to(x.dtype))


def _norm_aux(aux: Dict, zero: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Every key of ``AUX_KEYS`` as an f32 scalar, 0 where ``aux`` has
    none."""
    return {k: aux[k].float() if k in aux else zero for k in AUX_KEYS}


def forward_train(params, cfg: ArchConfig, flags: RunFlags,
                  tokens: torch.Tensor):
    """tokens: (B, S) int.  Returns (logits (B, S, V), aux): the training
    forward, each aux term summed over the layers (a sum, not a mean, as
    the reference's layer scan carries it).  Raises for an RWKV6 arch and
    for ``remat_policy="dots"``."""
    if flags.mode != "train":
        raise ValueError("forward_train needs RunFlags(mode='train')")
    if cfg.rwkv is not None:
        raise NotImplementedError(
            f"training {cfg.name}: the port's chunked wkv is the forward-only "
            f"kernel K7 on the card; training needs a differentiable chunked "
            f"wkv (the reference's XLA _wkv_chunked), ROADMAP Queue 1, item 1")
    remat = cfg.remat and cfg.remat_policy != "none"
    if remat and cfg.remat_policy != "full":
        raise NotImplementedError(
            f"remat_policy {cfg.remat_policy!r} is not ported (only 'full' "
            f"and 'none'; ROADMAP Queue 1, item 1)")
    x = params["embed"][tokens.long()].to(DTYPES[cfg.dtype])
    defs = B.group_defs(cfg)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = {k: zero for k in AUX_KEYS}

    def group(gp, x):
        x, _, a = B.apply_group(gp, cfg, flags, defs, x)
        a = _norm_aux(a, zero)
        return (x,) + tuple(a[k] for k in AUX_KEYS)

    for gp in params["groups"]:
        if remat and torch.is_grad_enabled():
            x, *a = checkpoint(group, gp, x, use_reentrant=False)
        else:
            x, *a = group(gp, x)
        aux = {k: aux[k] + v for k, v in zip(AUX_KEYS, a)}
    return _head(params, cfg, x), aux


def decode_step(params, cfg: ArchConfig, flags: RunFlags, tokens, caches,
                active=None):
    """tokens: (B, 1).  Returns (logits (B, 1, V), caches).

    active: optional continuous-batching slot mask: a (B,) bool mask
    (fixed shapes, no host sync: the form a CUDA graph captures), or a
    ``models.attention.Active`` that may also hold the indices of its
    rows.  An inactive row lands no write, keeps its ``pos`` and attends
    nothing (its logits are garbage and must be ignored)."""
    if flags.mode != "decode":
        raise ValueError("decode_step needs RunFlags(mode='decode')")
    return forward(params, cfg, flags, tokens, caches,
                   active=as_active(active))


def chunk_step(params, cfg: ArchConfig, flags: RunFlags, tokens, caches,
               chunk_len, active=None, sel_len=None):
    """``decode_step`` generalised from 1 token to a C-token chunk
    (chunked admission).  tokens: (B, C), each row's next C prompt tokens
    appended at its ``pos``, right-padded; chunk_len: (B,) true token
    count per row.  Returns (logits (B, C, V), caches).

    Every layer writes its C rows at ``pos`` (pad rows as zeros, the
    truncate_cache state), advances ``pos`` by chunk_len, extends ktb by
    a scatter-add of per-block partial sums, and attends the chunk to the
    cache prefix and its own causal triangle.  ``sel_len`` (default the
    cache length) is the selection and attention geometry: chunks over a
    prompt-bucket cache leave the cache (and final-row logits) of a
    whole-prompt bucketed prefill.  Logits rows at or past chunk_len are
    garbage; inactive rows freeze.  On the DSA block path C and ``pos``
    are multiples of block_q and block_k.  Dense caches of attention
    archs only: a recurrent (RWKV6) state absorbs pad rows."""
    if flags.mode != "decode":
        raise ValueError("chunk_step needs RunFlags(mode='decode')")
    if cfg.rwkv is not None:
        raise NotImplementedError(
            f"chunk_step: {cfg.name} is recurrent; its state cannot skip a "
            f"chunk's pad rows")
    return forward(params, cfg, flags, tokens, caches,
                   active=as_active(active), chunk_len=chunk_len,
                   sel_len=sel_len)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, flags: RunFlags,
               *, dtype=torch.bfloat16, device=None, pages=None
               ) -> Dict[str, Any]:
    """pages: page count of a PAGED cache: every layer's k/v (and DSA
    kt/ktb) become flat page pools indirected by a per-slot ``page_tbl``
    over the logical [0, max_len) geometry (see
    models.attention.init_cache_attention)."""
    dev = resolve_device(device)
    defs = B.group_defs(cfg)
    return {"groups": [
        {f"b{i}": B.init_subblock_cache(cfg, d, batch, max_len, flags,
                                        device=dev, dtype=dtype, pages=pages)
         for i, d in enumerate(defs)}
        for _ in range(B.n_groups(cfg))]}


def zero_cache(caches) -> Dict[str, Any]:
    """Zero every leaf of a cache in place: the state ``init_cache`` makes
    (fp8 leaves through their bytes)."""
    for group in caches["groups"]:
        for sub in group.values():
            for t in sub["attn"].values():
                raw(t).zero_()
    return caches


# per-token cache leaves (and their quantization scales), masked past the
# true length
_ROW_KEYS = ("k", "v", "kt", "k_s", "v_s", "kt_s")


def truncate_cache(cfg: ArchConfig, caches, length) -> Dict[str, Any]:
    """Sanitise a freshly prefilled cache to its true prompt length(s), in
    place: zero every per-token row (and scale) at slots >= length (on a
    ring, slots and not positions, as the reference does),
    rebuild ktb (ktb_s) from the masked kt, and set every ``pos`` to
    ``length`` (a scalar or per-row (B,) lengths).  fp8 rows are zeroed
    through their bytes: no arithmetic runs on an fp8 tensor.  Recurrent
    (RWKV6) leaves are left untouched, as in the reference: their archs
    take no padded prompts."""
    for group in caches["groups"]:
        for sub in group.values():
            c = sub["attn"]
            if "k" not in c:
                continue
            b, s = c["k"].shape[:2]
            ln = torch.as_tensor(length, device=c["k"].device).to(
                torch.int32).expand(b)
            keep = torch.arange(s, device=ln.device)[None, :] < ln[:, None]
            for name in _ROW_KEYS:
                if name in c:
                    t = raw(c[name])
                    t.mul_(keep.reshape(b, s, *([1] * (t.dim() - 2))).to(
                        t.dtype))
            c["pos"].copy_(ln)
            if "ktb" in c:
                _rebuild_ktb(cfg, c)
    return caches
