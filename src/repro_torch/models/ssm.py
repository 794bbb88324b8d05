"""RWKV6 (Finch): data-dependent decay linear attention, the port of the
reference's ``repro.models.ssm`` RWKV6 half (Mamba is not ported yet).

The time-mix block carries a per-head hd x hd f32 state ``s`` and the
last token ``x_prev``; the channel-mix FFN carries its own last token
``ffn_prev``.  When S is a multiple of 32 and longer than one chunk the
wkv runs chunked, as the reference dispatches; otherwise, decode
included, it runs the token recurrence ``_wkv_scan``.  Without gradients
(serving, the eval step) the chunked form is ``ops.wkv6``: the kernel K7
on the card, its plain version on the CPU.  Where autograd takes a
gradient through the wkv (training), it is ``_wkv_chunked_train``, the
reference's differentiable XLA ``_wkv_chunked`` in plain PyTorch: K7 has
no backward.  DSA does not apply here (no score matrix).

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
from repro_torch.kernels._launch import needs_grad
from repro_torch.kernels.ref import wkv6_ref
from repro_torch.models.common import dense_init, group_norm_heads

WKV_CHUNK = 32
CLAMP = -30.0


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


def _wkv_chunked_train(r, k, v, w, u, s0=None, chunk: int = WKV_CHUNK):
    """The reference's differentiable ``_wkv_chunked`` (``ssm.py:193``):
    the same chunked arithmetic in f32, the -30 clamp included, made of
    plain PyTorch ops so that autograd takes its gradient.  r,k,v,w:
    (B,S,H,hd) with S a multiple of ``chunk``; u: (H,hd); s0: (B,H,hd,hd)
    f32 or None.  Returns (y (B,S,H,hd) in r's dtype, s_last f32).

    The reference steps through the chunks one at a time, each under
    ``jax.checkpoint``.  Here everything that does not depend on the
    carried state (rr, kk, the masked C x C scores, the diagonal bonus,
    k_hat and the chunk decay) is computed for all chunks at once, and
    only the carry ``S_c = decay_c * S_{c-1} + k_hat_c^T v_c`` loops over
    the chunks (two elementwise ops a chunk, not a chunk's dozen).  The
    states entering the chunks are kept (the reference keeps them too)
    and ``rr_c @ S_{c-1}`` is one batched product.  No per-chunk
    checkpoint: the layer's remat (``ArchConfig.remat``) recomputes the
    whole block in the backward pass already."""
    b, s, h, hd = r.shape
    n = s // chunk

    def chunks(t):                     # (B,S,H,hd) -> (B,H,n,C,hd) f32
        return t.float().reshape(b, n, chunk, h, hd).permute(0, 3, 1, 2, 4)

    rc, kc, vc, wc = (chunks(t) for t in (r, k, v, w))
    logw = torch.log(torch.clamp(wc, min=1e-38))
    cum = torch.cumsum(logw, dim=3)
    cum_c = cum.clamp(CLAMP, 0.0)
    rr = rc * torch.exp(cum_c - logw)                  # r_t * A_{t-1}
    kk = kc * torch.exp(-cum_c)                        # k_s / A_s
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=r.device).tril(-1)
    intra = torch.where(tri, rr @ kk.transpose(-1, -2), 0.0) @ vc
    diag = (rc * u.float()[None, :, None, None, :] * kc).sum(-1)
    cum_last = cum[..., -1:, :]
    k_hat = kc * torch.exp((cum_last - cum).clamp(CLAMP, 0.0))
    decay = torch.exp(cum_last.clamp(CLAMP, 0.0)).transpose(-1, -2)
    upd = k_hat.transpose(-1, -2) @ vc                 # (B,H,n,hd,hd)
    st = (torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
          if s0 is None else s0.float())
    states = []
    # unbind, not indexing: each slice's backward would fill a zero
    # tensor the size of all chunks, n times over
    for dc, uc in zip(decay.unbind(2), upd.unbind(2)):
        states.append(st)
        st = dc * st + uc
    y = rr @ torch.stack(states, 2) + intra + diag[..., None] * vc
    y = y.permute(0, 2, 3, 1, 4).reshape(b, s, h, hd)
    return y.to(r.dtype), st


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
    if not (s % WKV_CHUNK == 0 and s > WKV_CHUNK):
        wkv = _wkv_scan
    elif needs_grad(r, k, v, w, params["u"], s0):
        wkv = _wkv_chunked_train
    else:
        wkv = _wkv_chunked
    y, st = wkv(r, k, v, w, params["u"], s0)
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
