"""Transformer blocks and layer groups (dense attention, multi-head latent
attention, mixture-of-experts, RWKV6, Mamba-hybrid, encoder-decoder and
cross-attention archs).

A *group* is the repeating unit of layers.  For most archs it is one
pre-norm sub-block ("b0"): attention ("attn", or "mla" for DeepSeek's
latent attention) + SwiGLU MLP, attention + a mixture of experts
(``moe``: every layer after the dense prologue), or, for RWKV6, the
time-mix block + the channel-mix FFN ("rwkv").  A hybrid arch (jamba)
groups ``attn_layer_period`` sub-blocks "b0".."b7": Mamba ("mamba") but
for one attention sub-block at ``attn_layer_offset``, each with an MoE
FFN where ``is_moe_layer`` says so (every other one) and a SwiGLU MLP
otherwise.  deepseek_v3's first ``first_k_dense`` layers are a PROLOGUE
of dense sub-blocks (``prologue_def``) before the groups, as in the
reference.  A sub-block with ``cross`` adds a gated cross-attention
sub-layer after its self-attention (``xattn``, ``xnorm`` and the scalar
gate ``xgate``: x + tanh(xgate) * attn(norm(x), enc)): llama_3_2_vision
groups ``cross_attn_period`` attention sub-blocks, the one at
``period - 2`` with cross-attention over the image embeddings;
whisper's decoder group is one attention sub-block with cross-attention
over the encoder's output, and its ENCODER groups
(``group_defs(cfg, decoder=False)``, ``n_enc_layers`` of them) one
non-causal attention sub-block each.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from repro_torch.configs.base import ArchConfig, is_moe_layer
from repro_torch.distributed import collectives as C
from repro_torch.core.prediction import mm
from repro_torch.models.attention import (RunFlags, apply_attention,
                                          apply_cross_attention,
                                          apply_mla, cache_specs_attention,
                                          cache_specs_mla, init_attention,
                                          init_cache_attention,
                                          init_cache_mla, init_mla,
                                          param_specs_attention,
                                          param_specs_mla)
from repro_torch.models import ssm
from repro_torch.models.common import dense_init, rms_norm
from repro_torch.models.moe import apply_moe, init_moe, param_specs_moe


@dataclasses.dataclass(frozen=True)
class SubBlockDef:
    kind: str = "attn"
    moe: bool = False
    cross: bool = False    # a gated cross-attention sub-layer after attn
    causal: bool = True


def group_defs(cfg: ArchConfig, decoder: bool = True) -> List[SubBlockDef]:
    """The sub-block structure of one group.  An encoder-decoder's encoder
    group (``decoder=False``): one non-causal attention sub-block.  A
    hybrid arch: the period's Mamba and attention sub-blocks, MoE where
    ``is_moe_layer`` (jamba's periodic pattern); a depth cut below one
    period (``cut_layers``) keeps the period's first ``n_layers``
    sub-blocks.  A cross-attention arch: ``cross_attn_period`` attention
    sub-blocks, cross-attention at ``period - 2``; an encoder-decoder's
    decoder: one attention sub-block with cross-attention.  Otherwise MoE
    is the reference's uniform pattern (an MoE FFN on every layer after
    the dense prologue: mixtral, deepseek_v3); periodic MoE outside a
    hybrid group is not ported."""
    if cfg.enc_dec and not decoder:
        return [SubBlockDef("attn", causal=False)]
    if cfg.rwkv is not None:
        return [SubBlockDef("rwkv")]
    if cfg.mamba is not None and cfg.attn_layer_period:
        n = min(cfg.attn_layer_period, cfg.n_layers)
        return [SubBlockDef("attn" if i == cfg.attn_layer_offset
                            else "mamba", moe=is_moe_layer(cfg, i))
                for i in range(n)]
    if cfg.cross_attn_period:
        period = cfg.cross_attn_period
        return [SubBlockDef("attn", cross=i == period - 2)
                for i in range(period)]
    if cfg.enc_dec:
        return [SubBlockDef("attn", cross=True)]
    mo = cfg.moe
    if mo is not None and mo.layer_period != 1:
        raise NotImplementedError(
            f"{cfg.name}: MoE with layer_period={mo.layer_period} outside "
            f"a Mamba-hybrid group is not ported (ROADMAP Queue 1, "
            f"\"Remaining archs\")")
    return [SubBlockDef("mla" if cfg.mla is not None else "attn",
                        moe=mo is not None)]


def prologue_def(cfg: ArchConfig) -> SubBlockDef:
    """A dense prologue layer: the arch's attention, a dense MLP."""
    return SubBlockDef("mla" if cfg.mla is not None else "attn")


def n_prologue(cfg: ArchConfig) -> int:
    """The dense prologue's depth (``first_k_dense``; 0 without one)."""
    return cfg.moe.first_k_dense if cfg.moe is not None else 0


def n_groups(cfg: ArchConfig, decoder: bool = True) -> int:
    """The groups after the prologue (an encoder's: ``n_enc_layers``).  A
    depth below the prologue's is refused."""
    if cfg.enc_dec and not decoder:
        return cfg.n_enc_layers
    n = cfg.n_layers - n_prologue(cfg)
    if n < 0:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers is less than "
                         f"the dense prologue's {n_prologue(cfg)}")
    return n // len(group_defs(cfg))


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
    attn = {"attn": init_attention, "mla": init_mla,
            "mamba": ssm.init_mamba}.get(d.kind)
    if attn is None:
        raise NotImplementedError(f"sub-block kind {d.kind!r} is not ported")
    out = {**norms, "attn": attn(gen, cfg, **kw)}
    if d.cross:
        out.update(xattn=init_attention(gen, cfg, cross=True, **kw),
                   xnorm=torch.ones((cfg.d_model,), **kw),
                   xgate=torch.zeros((), **kw))
    out["mlp"] = (init_moe if d.moe else init_mlp)(gen, cfg, **kw)
    return out


def init_subblock_cache(cfg: ArchConfig, d: SubBlockDef, batch: int,
                        max_len: int, flags: RunFlags, *, device,
                        dtype=torch.bfloat16, pages=None,
                        enc_len: int = 0) -> Dict:
    """The sub-block's cache: its attention (or recurrent) leaves under
    "attn" and, with ``d.cross``, the cross-attention's keys and values
    ``ck``/``cv`` (B, enc_len, Hkv, hd) under "xattn", which a prefill
    with an encoder or image input writes whole and no step changes."""
    if d.kind == "rwkv":
        return {"attn": ssm.init_cache_rwkv(cfg, batch, device=device,
                                            dtype=dtype)}
    if d.kind == "mamba":
        return {"attn": ssm.init_cache_mamba(cfg, batch, device=device,
                                             dtype=dtype)}
    if d.kind == "mla":
        return {"attn": init_cache_mla(cfg, batch, max_len, device=device,
                                       dtype=dtype, pages=pages)}
    c = {"attn": init_cache_attention(cfg, batch, max_len, flags,
                                      device=device, dtype=dtype,
                                      pages=pages)}
    if d.cross:
        shape = (batch, enc_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        c["xattn"] = {name: torch.zeros(shape, device=device, dtype=dtype)
                      for name in ("ck", "cv")}
    return c


def subblock_param_specs(cfg: ArchConfig, d: SubBlockDef) -> Dict:
    """Logical axes of ``init_subblock``'s leaves (the reference's spec
    tree, without its stacked layer axis)."""
    norms = {"norm1": ("embed_act",), "norm2": ("embed_act",)}
    if d.kind == "rwkv":
        return {**norms, "attn": ssm.param_specs_rwkv(),
                "mlp": ssm.param_specs_rwkv_ffn()}
    attn = {"attn": lambda: param_specs_attention(cfg),
            "mla": lambda: param_specs_mla(cfg),
            "mamba": ssm.param_specs_mamba}[d.kind]
    out = {**norms, "attn": attn()}
    if d.cross:
        out.update(xattn=param_specs_attention(cfg, cross=True),
                   xnorm=("embed_act",), xgate=())
    out["mlp"] = (param_specs_moe(cfg) if d.moe else
                  {"w1": ("embed", "mlp"), "w3": ("embed", "mlp"),
                   "w2": ("mlp", "embed")})
    return out


def subblock_cache_specs(cfg: ArchConfig, d: SubBlockDef, cache) -> Dict:
    """Logical axes of ``init_subblock_cache``'s leaves (``cache``: that
    sub-block's cache, whose layout, dense or paged, quantized or not,
    the specs follow)."""
    kind = {"attn": cache_specs_attention, "mla": cache_specs_mla,
            "mamba": ssm.cache_specs_mamba, "rwkv": ssm.cache_specs_rwkv}
    out = {"attn": kind[d.kind](cache["attn"])}
    if d.cross:
        out["xattn"] = {"ck": ("batch", None, "kv_heads", "qkv"),
                        "cv": ("batch", None, "kv_heads", "qkv")}
    return out


def apply_subblock(params, cfg: ArchConfig, flags: RunFlags, d: SubBlockDef,
                   x, cache=None, enc=None, **step):
    """Pre-norm residual block.  Returns (x, cache, aux); the cache is
    updated in place, ``aux`` is the attention's (the MSE term in train
    mode) and an MoE FFN's ``router`` term.  ``step``: the decode-time
    ``active``, ``chunk_len`` and ``sel_len`` of ``apply_attention``
    (``apply_mla`` for an "mla" sub-block; a recurrent one takes
    ``active`` alone).
    An MoE FFN routes decode-dense in decode mode (steps, chunks, verify
    rows) and under ``flags.moe_dense``, by capacity otherwise.  Under
    tensor parallelism (``flags.tp``) the MLP's down-projection (or the
    MoE combine) gives this rank's partial sum, and one all-reduce over
    "model" adds them; the attention all-reduces its own.  In training
    the MLP's input carries its gradient's sum over "model" and, under
    sequence parallelism (``flags.sp``: ``x`` is this rank's sequence
    rows), is all-gathered over the sequence, its output
    reduce-scattered back (``collectives.tp_enter``/``tp_exit``).  Under
    expert parallelism (``flags.ep``, training) the MoE sub-layer takes
    this rank's rows of the residual stream as they are (its sequence
    shard under SP) and gives its output whole for them: no gather,
    scatter or partial sum.
    A ``cross`` sub-block's cross-attention sub-layer runs, as in the
    reference, in train and prefill mode only when ``enc`` (B, T, d) is
    given, and in decode mode always, over the cached ``ck``/``cv``.
    Under tensor parallelism it takes the attention's form (this rank's
    heads and KV heads, its out-projection's partial sums added over
    "model"); ``enc`` is whole on every rank, under sequence parallelism
    too, and the gate ``xgate`` scales this rank's rows.  A Mamba and an
    MLA sub-layer enter and leave as the attention does (this rank's
    channels or heads, ``ssm.apply_mamba``, ``attention.apply_mla``)."""
    if d.kind == "rwkv":
        return (_apply_rwkv_subblock(params, cfg, flags, x, cache, **step),
                cache, {})
    h = rms_norm(x, params["norm1"].to(x.dtype), cfg.norm_eps)
    c = None if cache is None else cache["attn"]
    if d.kind == "mamba":
        _recurrent_step(**step)
        y = ssm.apply_mamba(params["attn"], cfg, h, cache=c,
                            decode=flags.mode == "decode",
                            active=step.get("active"), flags=flags)
        aux = {}
    else:
        attn = apply_mla if d.kind == "mla" else apply_attention
        y, _, aux = attn(params["attn"], cfg, flags, h, cache=c,
                         causal=d.causal, **step)
    x = x + y
    if d.cross and (enc is not None or flags.mode == "decode"):
        h = rms_norm(x, params["xnorm"].to(x.dtype), cfg.norm_eps)
        y = apply_cross_attention(params["xattn"], cfg, flags, h, enc,
                                  None if cache is None else cache["xattn"])
        x = x + torch.tanh(params["xgate"].to(x.dtype)) * y
    h = rms_norm(x, params["norm2"].to(x.dtype), cfg.norm_eps)
    if d.moe and flags.ep is not None:
        # expert parallelism: the residual stream's own rows, y whole
        y, a = apply_moe(params["mlp"], cfg, h, ep=flags.ep)
        return x + y, cache, {**aux, **a}
    train = flags.mode == "train"
    h = C.tp_enter(h, flags.tp, train=train, sp=flags.sp)
    if d.moe:
        y, a = apply_moe(params["mlp"], cfg, h,
                         decode=flags.mode == "decode" or flags.moe_dense,
                         tp=flags.tp)
        if train and flags.tp is not None:
            # every rank routes the same rows: the router term's gradient
            # is counted once over "model"
            a = {k: C.replicated_input(v, flags.tp) for k, v in a.items()}
        aux = {**aux, **a}
    else:
        y = apply_mlp(params["mlp"], h)
    # the down-projection's partial sums
    y = C.tp_exit(y, flags.tp, train=train, sp=flags.sp)
    return x + y, cache, aux


def _recurrent_step(active=None, chunk_len=None, sel_len=None) -> None:
    """A recurrent layer's state advances by the whole input: it takes a
    decode step's ``active`` mask, but no chunk geometry."""
    if chunk_len is not None or sel_len is not None:
        raise NotImplementedError("a recurrent layer takes no chunk_len "
                                  "or sel_len")


def _apply_rwkv_subblock(params, cfg: ArchConfig, flags: RunFlags, x,
                         cache=None, **step):
    """Time-mix then channel-mix, each pre-norm and residual.  The cache
    (``s``, ``x_prev``, ``ffn_prev``) advances by the whole input, on the
    ``active`` rows of a masked decode step.  Under tensor parallelism
    each mix all-reduces its contracting product (``wo``, the FFN's
    ``wv``); in training under sequence parallelism each gathers the
    sequence first (``ssm``'s module docstring)."""
    _recurrent_step(**step)
    active = step.get("active")
    c = None if cache is None else cache["attn"]
    h = rms_norm(x, params["norm1"].to(x.dtype), cfg.norm_eps)
    x = x + ssm.apply_rwkv(params["attn"], cfg, h, cache=c, active=active,
                           flags=flags)
    h = rms_norm(x, params["norm2"].to(x.dtype), cfg.norm_eps)
    x = x + ssm.apply_rwkv_ffn(params["mlp"], cfg, h,
                               None if c is None else c["ffn_prev"],
                               flags=flags)
    if c is not None:
        ssm.store(c, "ffn_prev", h[:, -1], active)
    return x


def init_group(gen: torch.Generator, cfg: ArchConfig, *, device,
               dtype=torch.float32, decoder: bool = True,
               place=None) -> Dict:
    """The group's sub-blocks "b0".., drawn in order.  ``place(name,
    sub)``, when given, takes each sub-block as soon as it is drawn and
    returns what the group keeps of it (``transformer.init_model``'s
    ``place``): a group of large sub-blocks, such as jamba's 8 with four
    MoE FFNs, is then never whole on the device."""
    out = {}
    for i, d in enumerate(group_defs(cfg, decoder)):
        sub = init_subblock(gen, cfg, d, device=device, dtype=dtype)
        out[f"b{i}"] = sub if place is None else place(f"b{i}", sub)
    return out


def apply_group(params, cfg: ArchConfig, flags: RunFlags, defs, x,
                cache=None, enc=None, **step):
    """Returns (x, cache, aux), each aux term summed over the group's
    sub-blocks (a list, as the probe's ``"sel"``, concatenated)."""
    auxes: Dict[str, torch.Tensor] = {}
    for i, d in enumerate(defs):
        x, _, a = apply_subblock(params[f"b{i}"], cfg, flags, d, x,
                                 cache=None if cache is None
                                 else cache[f"b{i}"], enc=enc, **step)
        for k, v in a.items():
            auxes[k] = auxes[k] + v if k in auxes else v
    return x, cache, auxes
