"""Attention-free sequence mixers: Mamba (jamba's layers) and RWKV6
(Finch), the port of the reference's ``repro.models.ssm``.

Mamba carries a per-channel f32 state ``h`` (B, mi, N) and the last
``d_conv - 1`` inputs of its causal convolution ``conv`` (B, d_conv-1,
mi).  Its selective scan ``_mamba_scan`` is the reference's token
recurrence in plain PyTorch (the reference has no kernel for it): per
128-token chunk the decays exp(dt a) and inputs dt x B are formed at
once, a token loop carries the state through the chunk (two elementwise
ops a token), and the outputs C h are one product over the chunk's
states.  Each token's arithmetic is the reference's step: the state and
exp(dt a) in f32, dt x formed in the activation dtype, y cast back to it.
Where a gradient is taken and S is a multiple of 128 longer than one
chunk, each chunk runs under ``torch.utils.checkpoint``, as the reference
runs it under ``jax.checkpoint``: training keeps the chunks' entry states
and not a state a token.

RWKV6's time-mix block carries a per-head hd x hd f32 state ``s`` and the
last token ``x_prev``; the channel-mix FFN carries its own last token
``ffn_prev``.  When S is a multiple of 32 and longer than one chunk the
wkv runs chunked, as the reference dispatches; otherwise, decode
included, it runs the token recurrence ``_wkv_scan``.  Without gradients
(serving, the eval step) the chunked form is ``ops.wkv6``: the kernel K7
on the card, its plain version on the CPU.  Where autograd takes a
gradient through the wkv (training), it is ``_wkv_chunked_train``, the
reference's differentiable XLA ``_wkv_chunked`` in plain PyTorch: K7 has
no backward.  DSA does not apply to either (no score matrix).

Unlike the reference, RWKV6's token shift casts the cached previous token
to the activation dtype, so a bf16 model serves from an f32 cache (the
reference promotes the shifted token to f32 there and its layer scan
refuses the f32 residual that results).  Mamba keeps the reference's
promotion: a decode step concatenates the cached conv rows with the new
input, so a bf16 model on an f32 cache turns f32 from the first Mamba
layer of a decode step on, as the reference's does.

Tensor parallelism (``flags.tp``, the reference's RWKV6 specs: heads and
mlp over "model"): a rank computes ``cfg.n_heads`` of the time-mix's
heads (n_heads / tp under ``sharding.shard_config``), its columns of
``wr``/``wk``/``wv``/``wg``, its rows of ``u`` and of the ``s`` state,
and its heads' slice of ``ln_x``, whose group norm is per head; ``wo``
over heads gives a partial sum that one all-reduce over "model" adds.
The decay ``w0 + tanh(x A) B`` is computed for the rank's head columns
only (``w_lora_b``'s and ``w0``'s columns sliced): the whole would cost
the full (lora, d) product and two exps over all d channels a token, of
which the rank keeps 1 / tp.  The channel-mix FFN takes its ``wk``
columns and ``wv`` rows over mlp, one all-reduce after ``wv``, and
keeps ``wr`` (the receptance gate) whole, computed alike on every rank.
``x_prev`` and ``ffn_prev`` stay whole on every rank.  In training
(``flags.mode == "train"``) the input enters through
``collectives.tp_enter`` (all-gathered over the sequence under sequence
parallelism, so each rank's first row shifts in its true predecessor)
and leaves through ``tp_exit`` (reduce-scattered back); under SP the
gate takes the rank's own rows.  The leaves every rank holds whole but
feeds only its part of (``mu``, ``w_lora_a``, ``w_lora_b``, ``w0`` and
``ln_x`` of the time-mix, ``mu`` and ``wr`` of the FFN:
``TP_PARTIAL``) then carry each rank's part of their gradient, summed
over "model" once a step (``sharding.TrainPlan.partials``); without SP
the gate's gradient is divided by tp (``collectives.replicated_input``)
for that sum to count it once.

Mamba under tensor parallelism (the reference's specs: every leaf's
inner-channel axis over "mlp"): a rank computes ``d_inner(cfg)`` = d_model
* expand / tp channels, with its columns of ``in_proj``'s two halves x
and z (``sharding.Halves``), of ``conv_w``, ``conv_b``, ``dt_proj``,
``dt_bias``, its rows of ``a_log``, ``d_skip``, ``x_proj`` and
``out_proj``, and its channels of the ``h`` and ``conv`` caches.
``dt_rank`` is the whole width's.  ``x_proj`` contracts over the
channels: its (dt_rank + 2 N)-wide output is summed over "model" (one
all-reduce), and since the summed dt input, B and C feed only the rank's
channels, each rank holds only its part of their gradient, summed by a
second all-reduce in the backward pass (``collectives.tp_psum``).
``out_proj``'s partial sums leave through ``collectives.tp_exit``; in
training the input enters through ``tp_enter`` (the sequence gathered
under SP, the scan running over the whole sequence on the rank's
channels).  Every Mamba leaf holds the rank's channels, so none has a
partial gradient to sum after the step.

A continuous engine's decode step passes ``active`` (a (B,) bool mask):
an inactive row's recurrent leaves keep their values (the reference lets
them run on, to be overwritten at the slot's next admission; the active
rows' values are the same either way).  A masked step with no active row
thus changes no leaf, which a graph capture over live slots needs.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.prediction import einsum, mm
from repro_torch.distributed import collectives as C
from repro_torch.kernels import ops
from repro_torch.kernels._launch import needs_grad
from repro_torch.kernels.ref import wkv6_ref
from repro_torch.models.common import dense_init, group_norm_heads

WKV_CHUNK = 32
CLAMP = -30.0
MAMBA_CHUNK = 128

# the RWKV6 leaves each rank holds whole under tensor parallelism but
# feeds only its heads' or its mlp columns' products with (or, the FFN's
# gate, computes alike on every rank): ("attn" | "mlp", leaf) of a
# sub-block.  Their gradients are summed over "model" once a step
TP_PARTIAL = (("attn", "mu"), ("attn", "w_lora_a"), ("attn", "w_lora_b"),
              ("attn", "w0"), ("attn", "ln_x"), ("mlp", "mu"), ("mlp", "wr"))


def store(cache: Dict, name: str, new: torch.Tensor, active=None) -> None:
    """Write ``new`` into ``cache[name]`` in place (cast to its dtype),
    where ``active`` (an ``attention.Active`` or None) names the rows
    that take part; other rows keep their values."""
    if active is not None:
        m = active.mask.reshape(-1, *([1] * (new.dim() - 1)))
        new = torch.where(m, new.to(cache[name].dtype), cache[name])
    cache[name].copy_(new)


def _tp_of(flags):
    """(the "model" group or None, whether training, whether under SP)."""
    if flags is None or flags.tp is None:
        return None, False, False
    train = flags.mode == "train"
    return flags.tp, train, train and flags.sp


# ---------------------------------------------------------------------------
# Mamba (selective state space; jamba interleaves 7 of these per attention)
# ---------------------------------------------------------------------------


def d_inner(cfg: ArchConfig) -> int:
    """The inner channels a Mamba layer computes: d_model * expand, a
    rank's 1 / tp of them under tensor parallelism (``cfg.mamba`` a
    ``configs.base.MambaShard``)."""
    mc = cfg.mamba
    return cfg.d_model * mc.expand // getattr(mc, "tp", 1)


def dt_rank(cfg: ArchConfig) -> int:
    """The rank of dt's projection, max(1, d_model * expand // 16): from
    the whole inner width, whatever share of it a rank computes."""
    return max(1, cfg.d_model * cfg.mamba.expand // 16)


def init_mamba(gen: torch.Generator, cfg: ArchConfig, *, device,
               dtype=torch.float32) -> Dict:
    mc = cfg.mamba
    d = cfg.d_model
    mi, r = d_inner(cfg), dt_rank(cfg)
    kw = dict(device=device, dtype=dtype)
    a = torch.arange(1, mc.d_state + 1, dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init(gen, (d, 2 * mi), **kw),
        "conv_w": dense_init(gen, (mc.d_conv, mi), **kw),
        "conv_b": torch.zeros((mi,), **kw),
        "x_proj": dense_init(gen, (mi, r + 2 * mc.d_state), **kw),
        "dt_proj": dense_init(gen, (r, mi), **kw),
        "dt_bias": torch.full((mi,), -4.6, **kw),   # softplus^-1(0.01)
        "a_log": torch.log(a).expand(mi, mc.d_state).to(dtype).clone(),
        "d_skip": torch.ones((mi,), **kw),
        "out_proj": dense_init(gen, (mi, d), **kw),
    }


def _scan_chunk(h, a, xc, dt, bmat, cmat):
    """The reference's scan step over one chunk of C tokens.  h (B,mi,N)
    f32; a (mi,N) f32; xc, dt (B,C,mi) and bmat, cmat (B,C,N) in the
    activation dtype.  Returns (h after the chunk, y (B,C,mi) in xc's
    dtype)."""
    da = torch.exp(dt[..., None].float() * a)              # (B,C,mi,N)
    dbx = (dt * xc)[..., None].float() * bmat[:, :, None, :].float()
    hs = []
    # unbind, not indexing: each slice's backward would fill a zero
    # tensor the size of the whole chunk, once a token
    for da_t, dbx_t in zip(da.unbind(1), dbx.unbind(1)):
        h = h * da_t + dbx_t
        hs.append(h)
    y = torch.einsum("bcmn,bcn->bcm", torch.stack(hs, 1), cmat.float())
    return h, y.to(xc.dtype)


def _mamba_scan(params, cfg: ArchConfig, xc, z, h0=None, tp=None,
                train: bool = False):
    """xc: (B, S, mi) post-conv activations; z: (B, S, mi) the gate (a
    rank's mi channels under tensor parallelism, ``tp``: ``x_proj``'s
    partial products are summed over "model", in training both ways).
    Returns (y (B,S,mi), h_last (B,mi,N) f32)."""
    mc = cfg.mamba
    b, s, mi = xc.shape
    r = dt_rank(cfg)
    proj = C.tp_psum(mm(xc, params["x_proj"].to(xc.dtype)), tp, train=train)
    dt = torch.nn.functional.softplus(
        mm(proj[..., :r], params["dt_proj"].to(xc.dtype))
        + params["dt_bias"].to(xc.dtype))
    bmat = proj[..., r:r + mc.d_state]
    cmat = proj[..., r + mc.d_state:]
    a = -torch.exp(params["a_log"].float())                # (mi, N)
    h = (torch.zeros((b, mi, mc.d_state), dtype=torch.float32,
                     device=xc.device) if h0 is None else h0)
    # the reference checkpoints each chunk of a sequence of whole chunks
    remat = (s % MAMBA_CHUNK == 0 and s > MAMBA_CHUNK
             and needs_grad(xc, dt, bmat, cmat, h))
    ys = []
    for c0 in range(0, s, MAMBA_CHUNK):
        part = (a, xc[:, c0:c0 + MAMBA_CHUNK], dt[:, c0:c0 + MAMBA_CHUNK],
                bmat[:, c0:c0 + MAMBA_CHUNK], cmat[:, c0:c0 + MAMBA_CHUNK])
        if remat:
            h, y = checkpoint(_scan_chunk, h, *part, use_reentrant=False)
        else:
            h, y = _scan_chunk(h, *part)
        ys.append(y)
    y = (ys[0] if len(ys) == 1 else torch.cat(ys, 1)) + xc * params[
        "d_skip"].to(xc.dtype)
    return y * torch.nn.functional.silu(z), h


def apply_mamba(params, cfg: ArchConfig, x, *, cache: Optional[Dict] = None,
                decode: bool = False, active=None, flags=None):
    """x: (B,S,d) -> the block output.  cache: {"h": (B,mi,N) f32,
    "conv": (B,d_conv-1,mi)}, updated in place (``active``: the rows of
    a masked decode step).  ``decode`` (S = 1) continues from the cache;
    a prefill starts from a zero state and zero history.  ``flags``:
    the run's ``RunFlags`` (tensor parallelism, module docstring); None
    runs whole."""
    tp, train, sp = _tp_of(flags)
    x = C.tp_enter(x, tp, train=train, sp=sp)
    mc = cfg.mamba
    b, s, d = x.shape
    mi = d_inner(cfg)                         # this rank's channels
    xz = mm(x, params["in_proj"].to(x.dtype))
    xr, z = xz[..., :mi], xz[..., mi:]
    dc = mc.d_conv
    w = params["conv_w"].to(x.dtype)
    if decode:
        hist = torch.cat([cache["conv"], xr], dim=1)      # (B,dc,mi)
        xc = einsum("btm,tm->bm", hist, w)
        xc = torch.nn.functional.silu(
            xc + params["conv_b"].to(x.dtype))[:, None]
        y, h = _mamba_scan(params, cfg, xc, z, h0=cache["h"], tp=tp)
        store(cache, "h", h, active)
        store(cache, "conv", hist[:, 1:], active)
    else:
        pad = torch.zeros((b, dc - 1, mi), dtype=xr.dtype, device=x.device)
        hist = torch.cat([pad, xr], dim=1)
        xc = sum(hist[:, i:i + s] * w[i] for i in range(dc))
        xc = torch.nn.functional.silu(xc + params["conv_b"].to(x.dtype))
        y, h = _mamba_scan(params, cfg, xc, z, tp=tp, train=train)
        if cache is not None:
            store(cache, "h", h, active)
            store(cache, "conv", hist[:, s:], active)
    return C.tp_exit(mm(y, params["out_proj"].to(x.dtype)), tp, train=train,
                     sp=sp)


def param_specs_mamba() -> Dict:
    """Logical axes of ``init_mamba``'s leaves (the reference's).
    ``in_proj``'s "mlp" dimension is [x | z], two halves side by side: a
    ``sharding.Halves`` spec, so that a rank's piece is its channels of
    each half."""
    from repro_torch.distributed.sharding import Halves
    return {"in_proj": Halves(("embed", "mlp")), "conv_w": ("conv", "mlp"),
            "conv_b": ("mlp",), "x_proj": ("mlp", None),
            "dt_proj": (None, "mlp"), "dt_bias": ("mlp",),
            "a_log": ("mlp", "state"), "d_skip": ("mlp",),
            "out_proj": ("mlp", "embed")}


def cache_specs_mamba(cache) -> Dict:
    """Logical axes of a Mamba cache's leaves."""
    return {"h": ("batch", "mlp", "state"), "conv": ("batch", None, "mlp")}


def init_cache_mamba(cfg: ArchConfig, batch: int, *, device,
                     dtype=torch.bfloat16) -> Dict:
    mi = d_inner(cfg)                           # this rank's channels
    return {"h": torch.zeros((batch, mi, cfg.mamba.d_state),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.mamba.d_conv - 1, mi),
                                dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# RWKV6 (Finch): data-dependent decay linear attention
# ---------------------------------------------------------------------------


def init_rwkv(gen: torch.Generator, cfg: ArchConfig, *, device,
              dtype=torch.float32) -> Dict:
    d, rc = cfg.d_model, cfg.rwkv
    h = d // rc.head_dim
    if cfg.n_heads != h:
        raise ValueError(f"{cfg.name}: n_heads {cfg.n_heads} is not d_model "
                         f"/ rwkv.head_dim = {h}")
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


def _cols(tp, width: int):
    """This rank's ``width`` channels of a whole d-wide leaf: its heads'
    under tensor parallelism, every channel otherwise."""
    return slice(None) if tp is None else slice(tp.rank * width,
                                                (tp.rank + 1) * width)


def apply_rwkv(params, cfg: ArchConfig, x, *, cache: Optional[Dict] = None,
               active=None, flags=None):
    """Time-mix block.  x: (B,S,d) (this rank's sequence rows under
    sequence parallelism).  cache: {"s": (B,H,hd,hd) f32, "x_prev": (B,d),
    ...}, updated in place (``active``: the rows of a masked decode step).
    ``flags``: the run's ``RunFlags`` (tensor parallelism, module
    docstring); None runs whole.  Returns the block output."""
    tp, train, sp = _tp_of(flags)
    x = C.tp_enter(x, tp, train=train, sp=sp)
    rc = cfg.rwkv
    b, s, d = x.shape
    h, hd = cfg.n_heads, rc.head_dim          # this rank's heads
    cols = _cols(tp, h * hd)
    x_prev = (cache["x_prev"] if cache is not None
              else torch.zeros((b, d), dtype=x.dtype, device=x.device))
    xr, xk, xv, xw, xg = _rwkv_mix(params, x, x_prev)
    r = mm(xr, params["wr"].to(x.dtype)).reshape(b, s, h, hd)
    k = mm(xk, params["wk"].to(x.dtype)).reshape(b, s, h, hd)
    v = mm(xv, params["wv"].to(x.dtype)).reshape(b, s, h, hd)
    g = mm(xg, params["wg"].to(x.dtype))
    # data-dependent decay (Finch): w = exp(-exp(w0 + tanh(x A) B)), for
    # this rank's head columns
    wdec = params["w0"][cols].float() + mm(
        torch.tanh(mm(xw, params["w_lora_a"].to(x.dtype))).float(),
        params["w_lora_b"][:, cols].float())
    w = torch.exp(-torch.exp(wdec)).reshape(b, s, h, hd).to(x.dtype)
    s0 = cache["s"] if cache is not None else None
    if not (s % WKV_CHUNK == 0 and s > WKV_CHUNK):
        wkv = _wkv_scan
    elif needs_grad(r, k, v, w, params["u"], s0):
        wkv = _wkv_chunked_train
    else:
        wkv = _wkv_chunked
    y, st = wkv(r, k, v, w, params["u"], s0)
    y = group_norm_heads(y.reshape(b, s, h * hd),
                         params["ln_x"][cols].to(x.dtype), h)
    y = y * torch.nn.functional.silu(g)
    out = C.tp_exit(mm(y, params["wo"].to(x.dtype)), tp, train=train, sp=sp)
    if cache is not None:
        store(cache, "s", st, active)
        store(cache, "x_prev", x[:, -1], active)
    return out


def param_specs_rwkv() -> Dict:
    """Logical axes of ``init_rwkv``'s leaves."""
    return {"mu": (None, "embed_act"), "w_lora_a": ("embed", "lora"),
            "w_lora_b": ("lora", "embed_act"), "w0": ("embed_act",),
            "u": ("heads", "qkv"), "wr": ("embed", "heads"),
            "wk": ("embed", "heads"), "wv": ("embed", "heads"),
            "wg": ("embed", "heads"), "wo": ("heads", "embed"),
            "ln_x": ("embed_act",)}


def param_specs_rwkv_ffn() -> Dict:
    """Logical axes of ``init_rwkv_ffn``'s leaves."""
    return {"mu": (None, "embed_act"), "wk": ("embed", "mlp"),
            "wv": ("mlp", "embed"), "wr": ("embed", "embed_act")}


def cache_specs_rwkv(cache) -> Dict:
    """Logical axes of an RWKV6 cache's leaves."""
    return {"s": ("batch", "heads", "qkv", None),
            "x_prev": ("batch", "embed_act"),
            "ffn_prev": ("batch", "embed_act")}


def init_cache_rwkv(cfg: ArchConfig, batch: int, *, device,
                    dtype=torch.bfloat16) -> Dict:
    d = cfg.d_model
    h, hd = cfg.n_heads, cfg.rwkv.head_dim      # this rank's heads
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


def apply_rwkv_ffn(params, cfg: ArchConfig, x, x_prev=None, flags=None):
    """RWKV channel-mix FFN (squared relu), with token shift.  ``flags``:
    tensor parallelism over mlp (module docstring); None runs whole."""
    tp, train, sp = _tp_of(flags)
    n = x.shape[1]                            # this rank's rows under SP
    x = C.tp_enter(x, tp, train=train, sp=sp)
    b, s, d = x.shape
    xp = (x_prev if x_prev is not None
          else torch.zeros((b, d), dtype=x.dtype, device=x.device))
    mu = params["mu"].to(x.dtype)
    delta = _shift_delta(x, xp)
    xk = x + mu[0] * delta
    xr = x + mu[1] * delta
    if sp:
        xr = xr.narrow(1, tp.rank * n, n)
    k = torch.square(torch.relu(mm(xk, params["wk"].to(x.dtype))))
    gate = torch.sigmoid(mm(xr, params["wr"].to(x.dtype)))
    if train and not sp:
        # every rank computes the gate alike: its gradient counted once
        # by the step's sum over "model"
        gate = C.replicated_input(gate, tp)
    return gate * C.tp_exit(mm(k, params["wv"].to(x.dtype)), tp,
                            train=train, sp=sp)
