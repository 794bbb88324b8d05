"""Transformer blocks and layer groups (dense attention archs).

A *group* is the repeating unit of layers; for the dense archs ported so
far a group is one pre-norm attention + SwiGLU MLP sub-block ("b0").
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
from repro_torch.models.common import dense_init, rms_norm


@dataclasses.dataclass(frozen=True)
class SubBlockDef:
    kind: str = "attn"
    causal: bool = True


def group_defs(cfg: ArchConfig) -> List[SubBlockDef]:
    """The sub-block structure of one group."""
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
    if d.kind != "attn":
        raise NotImplementedError(f"sub-block kind {d.kind!r} is not ported")
    kw = dict(device=device, dtype=dtype)
    return {"norm1": torch.ones((cfg.d_model,), **kw),
            "norm2": torch.ones((cfg.d_model,), **kw),
            "attn": init_attention(gen, cfg, **kw),
            "mlp": init_mlp(gen, cfg, **kw)}


def init_subblock_cache(cfg: ArchConfig, d: SubBlockDef, batch: int,
                        max_len: int, flags: RunFlags, *, device,
                        dtype=torch.bfloat16) -> Dict:
    return {"attn": init_cache_attention(cfg, batch, max_len, flags,
                                         device=device, dtype=dtype)}


def apply_subblock(params, cfg: ArchConfig, flags: RunFlags, d: SubBlockDef,
                   x, cache=None):
    """Pre-norm residual block.  Returns (x, cache); the cache is updated
    in place."""
    h = rms_norm(x, params["norm1"].to(x.dtype), cfg.norm_eps)
    y, _ = apply_attention(params["attn"], cfg, flags, h,
                           cache=None if cache is None else cache["attn"],
                           causal=d.causal)
    x = x + y
    h = rms_norm(x, params["norm2"].to(x.dtype), cfg.norm_eps)
    x = x + apply_mlp(params["mlp"], h)
    return x, cache


def init_group(gen: torch.Generator, cfg: ArchConfig, *, device,
               dtype=torch.float32) -> Dict:
    return {f"b{i}": init_subblock(gen, cfg, d, device=device, dtype=dtype)
            for i, d in enumerate(group_defs(cfg))}


def apply_group(params, cfg: ArchConfig, flags: RunFlags, defs, x,
                cache=None):
    for i, d in enumerate(defs):
        x, _ = apply_subblock(params[f"b{i}"], cfg, flags, d, x,
                              cache=None if cache is None else cache[f"b{i}"])
    return x, cache
