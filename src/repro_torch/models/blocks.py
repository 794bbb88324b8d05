"""Transformer blocks and layer groups (dense attention and RWKV6 archs).

A *group* is the repeating unit of layers; for the archs ported so far a
group is one pre-norm sub-block ("b0"): attention + SwiGLU MLP, or, for
RWKV6, the time-mix block + the channel-mix FFN ("rwkv").
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.prediction import mm
from repro_torch.models.attention import (RunFlags, apply_attention,
                                          init_attention,
                                          init_cache_attention)
from repro_torch.models import ssm
from repro_torch.models.common import dense_init, rms_norm


@dataclasses.dataclass(frozen=True)
class SubBlockDef:
    kind: str = "attn"
    causal: bool = True


def group_defs(cfg: ArchConfig) -> List[SubBlockDef]:
    """The sub-block structure of one group."""
    if cfg.rwkv is not None:
        return [SubBlockDef("rwkv")]
    return [SubBlockDef("attn")]


def n_groups(cfg: ArchConfig) -> int:
    return cfg.n_layers // len(group_defs(cfg))


def init_mlp(gen: torch.Generator, cfg: ArchConfig, *, device,
             dtype=torch.float32) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    kw = dict(device=device, dtype=dtype)
    return {"w1": dense_init(gen, (d, f), **kw),
            "w3": dense_init(gen, (d, f), **kw),
            "w2": dense_init(gen, (f, d), **kw)}


def apply_mlp(params, x):
    h = torch.nn.functional.silu(mm(x, params["w1"].to(x.dtype)))
    h = h * mm(x, params["w3"].to(x.dtype))
    return mm(h, params["w2"].to(x.dtype))


def init_subblock(gen: torch.Generator, cfg: ArchConfig, d: SubBlockDef, *,
                  device, dtype=torch.float32) -> Dict:
    kw = dict(device=device, dtype=dtype)
    norms = {"norm1": torch.ones((cfg.d_model,), **kw),
             "norm2": torch.ones((cfg.d_model,), **kw)}
    if d.kind == "rwkv":
        return {**norms, "attn": ssm.init_rwkv(gen, cfg, **kw),
                "mlp": ssm.init_rwkv_ffn(gen, cfg, **kw)}
    if d.kind != "attn":
        raise NotImplementedError(f"sub-block kind {d.kind!r} is not ported")
    return {**norms, "attn": init_attention(gen, cfg, **kw),
            "mlp": init_mlp(gen, cfg, **kw)}


def init_subblock_cache(cfg: ArchConfig, d: SubBlockDef, batch: int,
                        max_len: int, flags: RunFlags, *, device,
                        dtype=torch.bfloat16, pages=None) -> Dict:
    if d.kind == "rwkv":
        return {"attn": ssm.init_cache_rwkv(cfg, batch, device=device,
                                            dtype=dtype)}
    return {"attn": init_cache_attention(cfg, batch, max_len, flags,
                                         device=device, dtype=dtype,
                                         pages=pages)}


def apply_subblock(params, cfg: ArchConfig, flags: RunFlags, d: SubBlockDef,
                   x, cache=None, **step):
    """Pre-norm residual block.  Returns (x, cache, aux); the cache is
    updated in place, ``aux`` is the attention's (the MSE term in train
    mode).  ``step``: the decode-time ``active``, ``chunk_len`` and
    ``sel_len`` of ``apply_attention``."""
    if d.kind == "rwkv":
        return _apply_rwkv_subblock(params, cfg, x, cache, **step), cache, {}
    h = rms_norm(x, params["norm1"].to(x.dtype), cfg.norm_eps)
    y, _, aux = apply_attention(params["attn"], cfg, flags, h,
                                cache=None if cache is None else cache["attn"],
                                causal=d.causal, **step)
    x = x + y
    h = rms_norm(x, params["norm2"].to(x.dtype), cfg.norm_eps)
    x = x + apply_mlp(params["mlp"], h)
    return x, cache, aux


def _apply_rwkv_subblock(params, cfg: ArchConfig, x, cache=None,
                         active=None, chunk_len=None, sel_len=None):
    """Time-mix then channel-mix, each pre-norm and residual.  The cache
    (``s``, ``x_prev``, ``ffn_prev``) advances by the whole input: a
    recurrent layer has no per-row ``active`` or chunk geometry."""
    if active is not None or chunk_len is not None or sel_len is not None:
        raise NotImplementedError("a recurrent layer takes no active mask, "
                                  "chunk_len or sel_len")
    c = None if cache is None else cache["attn"]
    h = rms_norm(x, params["norm1"].to(x.dtype), cfg.norm_eps)
    x = x + ssm.apply_rwkv(params["attn"], cfg, h, cache=c)
    h = rms_norm(x, params["norm2"].to(x.dtype), cfg.norm_eps)
    x = x + ssm.apply_rwkv_ffn(params["mlp"], cfg, h,
                               None if c is None else c["ffn_prev"])
    if c is not None:
        c["ffn_prev"].copy_(h[:, -1])
    return x


def init_group(gen: torch.Generator, cfg: ArchConfig, *, device,
               dtype=torch.float32) -> Dict:
    return {f"b{i}": init_subblock(gen, cfg, d, device=device, dtype=dtype)
            for i, d in enumerate(group_defs(cfg))}


def apply_group(params, cfg: ArchConfig, flags: RunFlags, defs, x,
                cache=None, **step):
    """Returns (x, cache, aux), each aux term summed over the group's
    sub-blocks."""
    auxes: Dict[str, torch.Tensor] = {}
    for i, d in enumerate(defs):
        x, _, a = apply_subblock(params[f"b{i}"], cfg, flags, d, x,
                                 cache=None if cache is None
                                 else cache[f"b{i}"], **step)
        for k, v in a.items():
            auxes[k] = auxes[k] + v if k in auxes else v
    return x, cache, auxes
