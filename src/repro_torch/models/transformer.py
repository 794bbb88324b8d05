"""Top-level model: embedding -> layer groups -> head.

Public API:
  init_model(seed, cfg, device=None)          -> params
  forward(params, cfg, flags, tokens, caches) -> (logits, caches)
  decode_step(params, cfg, flags, tokens, caches) -> (logits, caches)
  init_cache(cfg, batch, max_len, flags, ...) -> caches
  truncate_cache(cfg, caches, length)         -> caches (in place)

Parameters are nested dicts of tensors, one dict per group in
``params["groups"]`` (the JAX reference stacks groups over a leading
layer axis; ``repro_torch.convert`` unstacks them).  Caches are likewise a
per-layer list, ``caches["groups"][i]["b0"]["attn"]``: the layout the
reference's ``unstack_group_caches`` produces for its decode loop, so no
unstacking step is needed here.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.prediction import mm
from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models.attention import RunFlags, _block_sums
from repro_torch.models.common import dense_init, rms_norm

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
            caches=None):
    """tokens: (B, S) int.  Returns (logits (B, S, V), caches)."""
    x = params["embed"][tokens.long()].to(DTYPES[cfg.dtype])
    defs = B.group_defs(cfg)
    for i, gp in enumerate(params["groups"]):
        c = None if caches is None else caches["groups"][i]
        x, _ = B.apply_group(gp, cfg, flags, defs, x, cache=c)
    x = rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    return mm(x, head.to(x.dtype)), caches


def decode_step(params, cfg: ArchConfig, flags: RunFlags, tokens, caches):
    """tokens: (B, 1).  Returns (logits (B, 1, V), caches)."""
    if flags.mode != "decode":
        raise ValueError("decode_step needs RunFlags(mode='decode')")
    return forward(params, cfg, flags, tokens, caches)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, flags: RunFlags,
               *, dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    dev = resolve_device(device)
    defs = B.group_defs(cfg)
    return {"groups": [
        {f"b{i}": B.init_subblock_cache(cfg, d, batch, max_len, flags,
                                        device=dev, dtype=dtype)
         for i, d in enumerate(defs)}
        for _ in range(B.n_groups(cfg))]}


# per-token cache leaves, masked past the true length
_ROW_KEYS = ("k", "v", "kt")


def truncate_cache(cfg: ArchConfig, caches, length) -> Dict[str, Any]:
    """Sanitise a freshly prefilled cache to its true prompt length(s), in
    place: zero every per-token row at positions >= length, rebuild ktb
    from the masked kt, and set every ``pos`` to ``length`` (a scalar or
    per-row (B,) lengths)."""
    for group in caches["groups"]:
        for sub in group.values():
            c = sub["attn"]
            b, s = c["k"].shape[:2]
            ln = torch.as_tensor(length, device=c["k"].device).to(
                torch.int32).expand(b)
            keep = torch.arange(s, device=ln.device)[None, :] < ln[:, None]
            for name in _ROW_KEYS:
                if name in c:
                    t = c[name]
                    t.mul_(keep.reshape(b, s, *([1] * (t.dim() - 2))).to(
                        t.dtype))
            c["pos"] = ln.clone()
            if "ktb" in c:
                c["ktb"].copy_(_block_sums(c["kt"], cfg.dsa.block_k,
                                           c["ktb"].shape[1]))
    return caches
