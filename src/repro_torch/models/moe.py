"""Mixture-of-experts layer (the port of the reference's
``repro/models/moe.py``, its single-device paths).

  capacity (prefill, train): each batch row dispatches its (token, slot)
     pairs into per-expert buffers of ``cap`` rows, runs the expert FFNs
     as batched products over the experts, and combines; a pair at or past
     its expert's ``cap`` is dropped (contributes 0).
  decode-dense (decode steps, ``moe_prefill="dense"``): every expert runs
     on every token and the routing weights mask the combine, so the step
     reads every expert's weights once and has fixed shapes (a CUDA graph
     captures it).

Tensor-parallel serving (a "model" axis, ``param_specs_moe``): each rank
holds E / tp whole experts, or, where tp does not divide E, every
expert's f / tp columns; routing is replicated, each rank combines its
own experts' (or columns') outputs, and ``blocks.apply_subblock`` sums
the partial combines with one all-reduce, as the reference's serving
rules (``moe_ep`` off) do.  The reference's expert-parallel path
(experts over "model" with two all-to-alls, its training default) is not
ported (ROADMAP Queue 1, "Distribution").

The expert products are plain ``torch.bmm``s (no kernel: the reference
computes them outside any Pallas kernel).  The router's logits are f32
whatever the model's dtype; the router weight itself is kept f32.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.prediction import mm
from repro_torch.models.common import dense_init


def expert_ff(cfg: ArchConfig) -> int:
    return cfg.moe.d_ff_expert or cfg.d_ff


def init_moe(gen: torch.Generator, cfg: ArchConfig, *, device,
             dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The router (d, E) in f32, the experts ``w1``/``w3`` (E, d, f) and
    ``w2`` (E, f, d) in ``dtype``, and the shared experts ``sw1``/``sw3``
    (d, f_s), ``sw2`` (f_s, d) where the config has any.  ``dense_init``
    takes an expert tensor's first axis, E, as its fan-in, as the
    reference does (ROADMAP Queue 3)."""
    mo = cfg.moe
    d, fe, e = cfg.d_model, expert_ff(cfg), mo.num_experts
    kw = dict(device=device, dtype=dtype)
    params = {
        "router": dense_init(gen, (d, e), device=device, dtype=torch.float32),
        "w1": dense_init(gen, (e, d, fe), **kw),
        "w3": dense_init(gen, (e, d, fe), **kw),
        "w2": dense_init(gen, (e, fe, d), **kw),
    }
    if mo.num_shared_experts:
        fs = fe * mo.num_shared_experts
        params.update(sw1=dense_init(gen, (d, fs), **kw),
                      sw3=dense_init(gen, (d, fs), **kw),
                      sw2=dense_init(gen, (fs, d), **kw))
    return params


def param_specs_moe(cfg: ArchConfig) -> Dict:
    """Logical axes of ``init_moe``'s leaves: the experts over "expert"
    and then "mlp" (whichever a mesh axis divides first), the router
    replicated."""
    out = {"router": ("embed", None),
           "w1": ("expert", "embed", "mlp"), "w3": ("expert", "embed", "mlp"),
           "w2": ("expert", "mlp", "embed")}
    if cfg.moe.num_shared_experts:
        out.update(sw1=("embed", "mlp"), sw3=("embed", "mlp"),
                   sw2=("mlp", "embed"))
    return out


def _route(router_w, x, top_k: int):
    """x (..., d) -> (ids (..., K) int32, w (..., K) f32, aux): the top-k
    of the f32 router logits (descending), a softmax over the k kept
    logits, and the Switch-style load-balance term E * sum_e f_e p_e
    (f_e: the share of assignments to e over k, p_e: the mean router
    probability of e)."""
    logits = mm(x.float(), router_w)
    w, ids = torch.topk(logits, top_k, dim=-1)
    w = torch.softmax(w, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    e = router_w.shape[1]
    assign = F.one_hot(ids, e).to(probs.dtype).sum(-2)
    f = assign.reshape(-1, e).mean(0) / top_k
    p = probs.reshape(-1, e).mean(0)
    aux = e * torch.sum(f * p)
    return ids.int(), w, aux


def _dispatch_positions(e_flat: torch.Tensor, num_experts: int,
                        cap: int) -> torch.Tensor:
    """Position of each flat (token, slot) pair within its expert's
    buffer, in token-major order (earlier tokens first, slot 0 before
    slot 1): a stable sort by expert, then the rank inside each run.  A
    position >= ``cap`` is dropped."""
    tk = e_flat.shape[0]
    order = torch.argsort(e_flat, stable=True)
    sorted_e = e_flat[order].contiguous()
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_sorted = torch.arange(tk, device=e_flat.device) - first
    return torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)


def _expert_ffn(w1, w3, w2, xb):
    """xb (E, C, d) -> (E, C, d): each expert's SwiGLU FFN on its rows."""
    h = F.silu(torch.bmm(xb, w1))
    h = h * torch.bmm(xb, w3)
    return torch.bmm(h, w2)


def _local_experts(params, cfg: ArchConfig, tp) -> Tuple[int, int]:
    """(first expert, experts) this rank holds: all of them unsharded or
    when the experts' f is what "model" splits; a contiguous E / tp under
    tensor parallelism over "expert" (``param_specs_moe``)."""
    el = params["w1"].shape[0]
    if el == cfg.moe.num_experts:
        return 0, el
    return tp.rank * el, el


def _moe_local(params, cfg: ArchConfig, x2, cap: int, tp=None):
    """Capacity dispatch -> expert FFNs -> combine on one token slab
    x2 (T, d).  Returns (y (T, d), aux).

    The buffers hold ``cap + 1`` rows per expert: a dropped pair is
    written to (and read back from) row ``cap``, which is cut before the
    experts run and reads as 0, so the shapes are static and a dropped
    pair takes no gradient.  Under tensor parallelism over "expert" the
    routing and every pair's position are the unsharded ones, the pairs
    of another rank's experts go to the cut row, and the partial combine
    is summed by the caller's all-reduce."""
    mo = cfg.moe
    e, k = mo.num_experts, mo.top_k
    ids, w, aux = _route(params["router"], x2, k)             # (T, K)
    t, d = x2.shape
    e_flat = ids.reshape(-1).long()                           # (T*K,)
    pos = _dispatch_positions(e_flat, e, cap)
    ok = pos < cap
    lo, el = _local_experts(params, cfg, tp)
    le = e_flat - lo
    if el < e:
        ok = ok & (le >= 0) & (le < el)
        le = le.clamp(0, el - 1)
    slot = torch.where(ok, pos, cap)
    tok_idx = torch.arange(t, device=x2.device).repeat_interleave(k)
    dt = x2.dtype
    buf = torch.zeros((el, cap + 1, d), dtype=dt, device=x2.device)
    buf = buf.index_put((le, slot), x2[tok_idx])
    yb = _expert_ffn(params["w1"].to(dt), params["w3"].to(dt),
                     params["w2"].to(dt), buf[:, :cap])
    yb = torch.cat([yb, yb.new_zeros((el, 1, d))], dim=1)
    y_slots = yb[le, slot] * ok[:, None]
    y = torch.sum(y_slots.reshape(t, k, d) * w.reshape(t, k, 1).to(dt),
                  dim=1)
    return y, aux


def _moe_decode_dense(params, cfg: ArchConfig, x, tp=None):
    """Every expert on every token (this rank's experts under tensor
    parallelism); the routing weights mask the combine.  x (B, S, d) ->
    (y (B, S, d), aux over all B*S tokens)."""
    mo = cfg.moe
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    ids, w, aux = _route(params["router"], x2, mo.top_k)
    dt = x.dtype
    cw = torch.zeros((b * s, mo.num_experts), dtype=dt, device=x.device)
    cw = cw.scatter(1, ids.long(), w.to(dt))
    lo, el = _local_experts(params, cfg, tp)
    if el < mo.num_experts:
        cw = cw[:, lo:lo + el]
    xb = x2[None].expand(el, b * s, d)
    yb = _expert_ffn(params["w1"].to(dt), params["w3"].to(dt),
                     params["w2"].to(dt), xb)                 # (E, T, d)
    y = torch.einsum("etd,te->td", yb, cw)
    return y.reshape(b, s, d), aux


def apply_moe(params, cfg: ArchConfig, x, *, decode: bool = False,
              tp=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, d) -> (y, {"router": aux * router_aux_weight}); under
    tensor parallelism (``tp``, the "model" group) ``y`` is this rank's
    partial combine, which the caller all-reduces.

    ``decode`` or a single token: the decode-dense path, its aux over all
    tokens.  Otherwise the capacity path row by row (the reference's
    ``vmap`` over the batch), ``cap = max(4, int(S * top_k *
    capacity_factor / E))`` from the row's padded length S, its aux the
    mean of the rows'.  Shared experts, where the config has any, are
    added to every token after."""
    mo = cfg.moe
    if decode or x.shape[1] == 1:
        y, a = _moe_decode_dense(params, cfg, x, tp)
    else:
        b, s, _ = x.shape
        cap = max(4, int(s * mo.top_k * mo.capacity_factor
                         / mo.num_experts))
        rows = [_moe_local(params, cfg, x[i], cap, tp) for i in range(b)]
        y = torch.stack([r[0] for r in rows])
        a = torch.stack([r[1] for r in rows]).mean()
    aux = {"router": a * mo.router_aux_weight}
    if mo.num_shared_experts:
        h = F.silu(mm(x, params["sw1"].to(x.dtype)))
        h = h * mm(x, params["sw3"].to(x.dtype))
        y = y + mm(h, params["sw2"].to(x.dtype))
    return y, aux
