"""RWKV6 (Finch): data-dependent decay linear attention, the port of the
reference's ``repro.models.ssm`` RWKV6 half (Mamba is not ported yet).

The time-mix block carries a per-head hd x hd f32 state ``s`` and the
last token ``x_prev``; the channel-mix FFN carries its own last token
``ffn_prev``.  Prefill runs the chunked form (``ops.wkv6``: the kernel K7
on the card, its plain version on the CPU) when S is a multiple of 32 and
longer than one chunk, as the reference dispatches; otherwise, decode
included, the token recurrence ``_wkv_scan``.  DSA does not apply here
(no score matrix).

Unlike the reference, the token shift casts the cached previous token to
the activation dtype, so a bf16 model serves from an f32 cache (the
reference promotes the shifted token to f32 there and its layer scan
refuses the f32 residual that results).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.prediction import mm
from repro_torch.kernels import ops
from repro_torch.kernels.ref import wkv6_ref
from repro_torch.models.common import dense_init, group_norm_heads

WKV_CHUNK = 32


def init_rwkv(gen: torch.Generator, cfg: ArchConfig, *, device,
              dtype=torch.float32) -> Dict:
    d, rc = cfg.d_model, cfg.rwkv
    h = d // rc.head_dim
    kw = dict(device=device, dtype=dtype)
    return {
        "mu": (torch.rand((5, d), generator=gen, device=device) * 0.5
               + 0.25).to(dtype),
        "w_lora_a": dense_init(gen, (d, rc.decay_lora), **kw),
        "w_lora_b": dense_init(gen, (rc.decay_lora, d), scale=0.1, **kw),
        "w0": torch.full((d,), -6.0, **kw),
        "u": (torch.randn((h, rc.head_dim), generator=gen, device=device)
              * 0.1).to(dtype),
        "wr": dense_init(gen, (d, d), **kw),
        "wk": dense_init(gen, (d, d), **kw),
        "wv": dense_init(gen, (d, d), **kw),
        "wg": dense_init(gen, (d, d), **kw),
        "wo": dense_init(gen, (d, d), **kw),
        "ln_x": torch.ones((d,), **kw),
    }


# The token recurrence: r,k,v,w: (B,S,H,hd); u: (H,hd) bonus; state
# (B,H,hd_k,hd_v) f32.  Returns (y (B,S,H,hd), s_last).  It is the kernel's
# sequential oracle, kept in one place.
_wkv_scan = wkv6_ref


def _wkv_chunked(r, k, v, w, u, s0=None, chunk: int = WKV_CHUNK):
    """Chunk-parallel wkv6 through ``ops.wkv6`` (K7 on the card)."""
    return ops.wkv6(r, k, v, w, u, s0, chunk=chunk)


def _shift_delta(x, x_prev):
    """Each token's predecessor minus the token: the cached previous token
    (cast to x's dtype) for the first, then x shifted by one.  Taken once
    per block; the reference recomputes it for every role, to the same
    values."""
    return torch.cat([x_prev.to(x.dtype)[:, None], x[:, :-1]], dim=1) - x


def _rwkv_mix(params, x, x_prev):
    """Token shift: lerp current/previous token per channel per role."""
    mu = params["mu"].to(x.dtype)
    delta = _shift_delta(x, x_prev)
    return [x + mu[i] * delta for i in range(5)]  # r, k, v, w, g


def apply_rwkv(params, cfg: ArchConfig, x, *, cache: Optional[Dict] = None):
    """Time-mix block.  x: (B,S,d).  cache: {"s": (B,H,hd,hd) f32,
    "x_prev": (B,d), ...}, updated in place.  Returns the block output."""
    rc = cfg.rwkv
    b, s, d = x.shape
    h, hd = d // rc.head_dim, rc.head_dim
    x_prev = (cache["x_prev"] if cache is not None
              else torch.zeros((b, d), dtype=x.dtype, device=x.device))
    xr, xk, xv, xw, xg = _rwkv_mix(params, x, x_prev)
    r = mm(xr, params["wr"].to(x.dtype)).reshape(b, s, h, hd)
    k = mm(xk, params["wk"].to(x.dtype)).reshape(b, s, h, hd)
    v = mm(xv, params["wv"].to(x.dtype)).reshape(b, s, h, hd)
    g = mm(xg, params["wg"].to(x.dtype))
    # data-dependent decay (Finch): w = exp(-exp(w0 + tanh(x A) B))
    wdec = params["w0"].float() + mm(
        torch.tanh(mm(xw, params["w_lora_a"].to(x.dtype))).float(),
        params["w_lora_b"].float())
    w = torch.exp(-torch.exp(wdec)).reshape(b, s, h, hd).to(x.dtype)
    s0 = cache["s"] if cache is not None else None
    if s % WKV_CHUNK == 0 and s > WKV_CHUNK:
        y, st = _wkv_chunked(r, k, v, w, params["u"], s0)
    else:
        y, st = _wkv_scan(r, k, v, w, params["u"], s0)
    y = group_norm_heads(y.reshape(b, s, d), params["ln_x"].to(x.dtype), h)
    y = y * torch.nn.functional.silu(g)
    out = mm(y, params["wo"].to(x.dtype))
    if cache is not None:
        cache["s"].copy_(st)
        cache["x_prev"].copy_(x[:, -1])
    return out


def init_cache_rwkv(cfg: ArchConfig, batch: int, *, device,
                    dtype=torch.bfloat16) -> Dict:
    d = cfg.d_model
    h, hd = d // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    return {"s": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                             device=device),
            "x_prev": torch.zeros((batch, d), dtype=dtype, device=device),
            "ffn_prev": torch.zeros((batch, d), dtype=dtype, device=device)}


def init_rwkv_ffn(gen: torch.Generator, cfg: ArchConfig, *, device,
                  dtype=torch.float32) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    kw = dict(device=device, dtype=dtype)
    return {"mu": (torch.rand((2, d), generator=gen, device=device) * 0.5
                   + 0.25).to(dtype),
            "wk": dense_init(gen, (d, f), **kw),
            "wv": dense_init(gen, (f, d), **kw),
            "wr": dense_init(gen, (d, d), **kw)}


def apply_rwkv_ffn(params, cfg: ArchConfig, x, x_prev=None):
    """RWKV channel-mix FFN (squared relu), with token shift."""
    b, s, d = x.shape
    xp = (x_prev if x_prev is not None
          else torch.zeros((b, d), dtype=x.dtype, device=x.device))
    mu = params["mu"].to(x.dtype)
    delta = _shift_delta(x, xp)
    xk = x + mu[0] * delta
    xr = x + mu[1] * delta
    k = torch.square(torch.relu(mm(xk, params["wk"].to(x.dtype))))
    return torch.sigmoid(mm(xr, params["wr"].to(x.dtype))) * mm(
        k, params["wv"].to(x.dtype))
