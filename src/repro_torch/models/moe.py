"""Mixture-of-experts layer (the port of the reference's
``repro/models/moe.py``).

  capacity (prefill, train): each batch row dispatches its (token, slot)
     pairs into per-expert buffers of ``cap`` rows, runs the expert FFNs
     as batched products over the experts, and combines; a pair at or past
     its expert's ``cap`` is dropped (contributes 0).
  decode-dense (decode steps, ``moe_prefill="dense"``): every expert runs
     on every token and the routing weights mask the combine, so the step
     reads every expert's weights once and has fixed shapes (a CUDA graph
     captures it).
  expert-parallel (training on a mesh whose "model" axis divides E, the
     reference's ``_moe_ep_shardmap``; ``RunFlags.ep``, an ``EPContext``):
     each rank routes its own token slab into (E, cap) buffers, sends each
     expert's rows to the rank that holds it (one all-to-all over
     "model"), runs its E / n experts on what every rank sent, sends the
     results back (a second all-to-all) and combines.

Tensor-parallel serving (a "model" axis, ``param_specs_moe``): each rank
holds E / tp whole experts, or, where tp does not divide E, every
expert's f / tp columns, and its f_s / tp columns of the shared experts;
routing is replicated, each rank combines its own experts' (or
columns') outputs and adds its shared experts' partial sum, and
``blocks.apply_subblock`` sums the partials with one all-reduce, as the
reference's serving rules (``moe_ep`` off) do.

The expert products are plain ``torch.bmm``s (no kernel: the reference
computes them outside any Pallas kernel).  The router's logits are f32
whatever the model's dtype; the router weight itself is kept f32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.prediction import mm
from repro_torch.distributed import collectives as C
from repro_torch.models.common import dense_init

# the EP dispatches' (token, slot) pairs since the last ``ep_drops(reset=
# True)`` and how many of them were dropped (a tensor on the pairs'
# device: counting takes no host sync, reading it does)
_EP_DROPS: Dict[str, Any] = {"pairs": 0, "dropped": 0}


def ep_drops(reset: bool = False) -> Tuple[int, int]:
    """(dropped, pairs) over the expert-parallel dispatches since the
    last reset, a recompute's counted again; ``reset`` then sets both to
    0."""
    out = int(_EP_DROPS["dropped"]), _EP_DROPS["pairs"]
    if reset:
        _EP_DROPS.update(pairs=0, dropped=0)
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class EPContext:
    """One training batch's expert-parallel dispatch
    (``distributed.sharding.TrainPlan.run_flags`` makes it).

    ``group``: the "model" axis (``collectives.AxisGroup``), whose rank q
    holds experts [q E / n, (q + 1) E / n).  ``cap``: each expert's rows
    per source rank, the reference's ``max(4, ceil4(int((B // |batch|) *
    (S // n) * top_k * capacity_factor / E)))`` from the global batch
    rows B and length S, whatever slab a rank holds.  ``tp``: the group's
    ranks compute one loss between them (tensor parallelism; else
    "model" is a batch axis and each rank's loss is its own).
    ``replicated``: every rank of the group holds the same rows (tensor
    parallelism without sequence parallelism)."""
    group: Any
    cap: int
    tp: bool
    replicated: bool = False


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


def ep_cap(cfg: ArchConfig, rows: int, batch_ranks: int, seq_len: int,
           n_model: int) -> int:
    """The reference's EP capacity (``repro/models/moe.py:122-126``):
    a rank's tokens taken as (rows // batch ranks) * (seq_len // n),
    times top_k and the capacity factor over E, rounded up to a multiple
    of 4, at least 4."""
    mo = cfg.moe
    t = (rows // batch_ranks) * (seq_len // n_model)
    cap = int(t * mo.top_k * mo.capacity_factor / mo.num_experts)
    return max(4, -(-cap // 4) * 4)


def _moe_ep_inner(params, cfg: ArchConfig, x2, ep: EPContext):
    """One rank's slab x2 (T, d) through the expert-parallel dispatch
    (the reference's ``_moe_ep_inner``).  Returns (y (T, d), the slab's
    aux).  The send buffer keeps the trash row at ``cap`` (a dropped pair
    goes there and reads back 0), cut before it is sent."""
    mo = cfg.moe
    e, k = mo.num_experts, mo.top_k
    g = ep.group
    n, cap = g.size, ep.cap
    el = e // n
    ids, w, aux = _route(params["router"], x2, k)
    t, d = x2.shape
    e_flat = ids.reshape(-1).long()
    pos = _dispatch_positions(e_flat, e, cap)
    ok = pos < cap
    _EP_DROPS["pairs"] += ok.numel()
    _EP_DROPS["dropped"] = _EP_DROPS["dropped"] + (~ok).sum()
    slot = torch.where(ok, pos, cap)
    tok_idx = torch.arange(t, device=x2.device).repeat_interleave(k)
    dt = x2.dtype
    buf = torch.zeros((e, cap + 1, d), dtype=dt, device=x2.device)
    buf = buf.index_put((e_flat, slot), x2[tok_idx])
    # block q of the send buffer (rank q's experts) goes to rank q; block
    # q of what arrives came from rank q; each local expert then takes its
    # rows from every source in turn (the reference reshapes without this
    # transpose, ROADMAP Queue 3)
    recv = C.exchange(buf[:, :cap].reshape(n, el, cap, d), g)
    rows = recv.transpose(0, 1).reshape(el, n * cap, d)
    w1, w3, w2 = params["w1"], params["w3"], params["w2"]
    if w1.shape[0] == e:          # the whole leaf (FSDP over "model")
        lo = g.rank * el
        w1, w3, w2 = w1[lo:lo + el], w3[lo:lo + el], w2[lo:lo + el]
    yb = _expert_ffn(w1.to(dt), w3.to(dt), w2.to(dt), rows)
    yb = yb.reshape(el, n, cap, d).transpose(0, 1)
    back = C.exchange(yb.reshape(n, el, cap, d), g).reshape(e, cap, d)
    back = torch.cat([back, back.new_zeros((e, 1, d))], dim=1)
    y_slots = back[e_flat, slot] * ok[:, None]
    y = torch.sum(y_slots.reshape(t, k, d) * w.reshape(t, k, 1).to(dt),
                  dim=1)
    return y, aux


def _moe_ep(params, cfg: ArchConfig, x, ep: EPContext):
    """The expert-parallel dispatch of this rank's rows x (B_l, S_l, d)
    (the reference's ``_moe_ep_shardmap``).  Returns (y (B_l, S_l, d),
    aux): aux is the slab's Switch term averaged over "model" (one
    all-reduce).  Where every rank of "model" holds the same rows
    (``ep.replicated``), each routes all of them, as the reference's
    shard_map does there: the input's gradient is summed over "model"
    and the output's divided by n."""
    g = ep.group
    if ep.replicated:
        x = C.copy_to_tp(x, g)
    b, s, d = x.shape
    y, aux = _moe_ep_inner(params, cfg, x.reshape(b * s, d), ep)
    aux = C.mean_over(aux, g, 1.0 / g.size if ep.tp else 1.0)
    y = y.reshape(b, s, d)
    if ep.replicated:
        y = C.replicated_input(y, g)
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
              tp=None, ep: EPContext = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, d) -> (y, {"router": aux * router_aux_weight}); under
    tensor parallelism (``tp``, the "model" group) ``y`` is this rank's
    partial combine, its shared experts' partial sum (their ``sw1``/``sw3``
    columns and ``sw2`` rows) with it, which the caller all-reduces.

    ``ep`` (training on a mesh where the reference's gate holds,
    ``TrainPlan.run_flags``): the expert-parallel dispatch of this rank's
    rows, ``y`` whole for them.  ``decode`` or a single token: the
    decode-dense path, its aux over all tokens.  Otherwise the capacity
    path row by row (the reference's ``vmap`` over the batch), ``cap = max(4,
    int(S * top_k * capacity_factor / E))`` from the row's padded length
    S, its aux the mean of the rows'.  Shared experts, where the config
    has any, are added to every token after, on the same rows.

    Under expert parallelism with tensor parallelism (``ep.tp``) the
    shared experts take the dense MLP's tensor-parallel form beside the
    dispatch, as the reference computes them outside its shard_map: the
    rank's rows all-gathered over the sequence under SP (else its
    replicated rows, their gradient summed over "model"), the rank's
    columns and rows of ``sw1``/``sw3``/``sw2``, and the partial sums
    reduce-scattered back to its rows (else all-reduced).  They run
    before the dispatch, so that the recompute of a checkpointed layer,
    which stops at the combine's last saved product, never reaches the
    router term's all-reduce."""
    mo = cfg.moe
    shared = None
    if ep is not None and ep.tp and mo.num_shared_experts:
        sp = not ep.replicated
        h = C.tp_enter(x, ep.group, train=True, sp=sp)
        shared = C.tp_exit(_shared_ffn(params, h), ep.group, train=True,
                           sp=sp)
    if ep is not None:
        # (the gate saw the whole sequence: a rank's shard may be 1 row)
        y, a = _moe_ep(params, cfg, x, ep)
    elif decode or x.shape[1] == 1:
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
        y = y + (shared if shared is not None else _shared_ffn(params, x))
    return y, aux


def _shared_ffn(params, x):
    """The shared experts' SwiGLU FFN on every token of x (..., d)."""
    h = F.silu(mm(x, params["sw1"].to(x.dtype)))
    h = h * mm(x, params["sw3"].to(x.dtype))
    return mm(h, params["sw2"].to(x.dtype))
