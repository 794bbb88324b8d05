"""Train, eval, prefill and decode step factories (the port of the
reference's ``repro/training/steps.py``).

The train step implements the paper's joint objective (Eq. 7):

    L = L_model + lambda * L_MSE + router

(``L_MSE`` summed over every DSA layer, a dense prologue's included;
``router``: the MoE load-balance term times ``router_aux_weight``,
summed over the MoE layers, each layer's the mean over the batch rows as
the reference's per-row capacity dispatch gives it; 0 on a dense arch)

with microbatched gradient accumulation: each microbatch's backward adds
its gradients into ``.grad`` in the param dtype, the sum is divided by the
microbatch count, and the metrics are averaged, as the reference's scan
does.  Gradients come from autograd over the plain model code (the block
path's ``dsa_sparse_attention``, ``dense_attention``, ``flash_attention``),
the counterparts of the reference's XLA paths: no kernel has a backward,
and a kernel wrapper asked for one raises (``dsa_mode="kernel"`` trains in
neither package).  ``kernel`` serves the eval step, under
``torch.no_grad()``.

State: ``{"params", "opt", "step"}``.  Trainable leaves have
``requires_grad``; the DSA projection ``P`` does not (it is constant) but
keeps its zero moments, and its gradient counts as zeros.  The step
updates the state in place and returns it.

On a mesh (``mesh=`` and ``rules=``, the reference's ``make_rules``
tables; ``distributed.sharding.TrainPlan``), one process a device: every
rank calls the step with the same global batch and computes its rows of
each microbatch; the params, gradients and moments are its shards
(FSDP, tensor parallelism), the loss is vocab-parallel where the logits
are split over "model", and the metrics and the clip scale are the
global batch's on every rank.  The sharded losses, gradients and
updates are the unsharded ones up to the order of the sums.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import (ShardingRules, TrainPlan,
                                              make_train_plan)
from repro_torch.models.attention import RunFlags
from repro_torch.models.transformer import (decode_step, forward,
                                            forward_train, init_model,
                                            model_param_specs)
from repro_torch.optim import adamw
from repro_torch.tree import map_tree, named_leaves


class _VocabParallelNLL(torch.autograd.Function):
    """-log softmax(logits)[label] over a vocab split into ``tp.size``
    column blocks, this rank's ``logits`` (..., V / tp) in f32: the row
    max and then each row's exp-sum and target logit (from the rank that
    holds the label's column) all-reduced over "model".  Every rank gets
    the whole rows' losses; its gradient is its columns' softmax minus
    the label's one-hot.  The arithmetic is ``torch.logsumexp``'s and its
    backward's, so at tp 1 it gives the plain loss's bits."""

    @staticmethod
    def forward(ctx, logits, labels, tp):
        vl = logits.shape[-1]
        m = logits.amax(-1)
        C.all_reduce(m, tp, op="max")
        m = m.masked_fill(m.abs() == float("inf"), 0)
        ids = labels.long() - tp.rank * vl
        own = (ids >= 0) & (ids < vl)
        idx = ids.clamp(0, vl - 1)[..., None]
        ll = torch.where(own, torch.gather(logits, -1, idx)[..., 0], 0.0)
        both = torch.stack([torch.exp(logits - m[..., None]).sum(-1), ll])
        C.all_reduce(both, tp)
        lse = both[0].log().add_(m)
        ctx.save_for_backward(logits, lse, idx, own)
        return lse - both[1]

    @staticmethod
    def backward(ctx, g):
        logits, lse, idx, own = ctx.saved_tensors
        grad = g[..., None] * (logits - lse[..., None]).exp()
        grad.scatter_add_(-1, idx, torch.where(own, -g, 0.0)[..., None])
        return grad, None, None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None, *, tp=None,
                  batch=None) -> torch.Tensor:
    """Mean CE over the valid tokens, in f32.

    Training on a mesh: ``tp`` (the "model" group) when the logits are
    this rank's vocab columns (the reference's "vocab_act" -> "model");
    ``batch`` (the batch axes' group) when these are this rank's rows:
    the mask's token count is summed over it, and the loss is this rank's
    share times the group size, so that its mean over the group is the
    global batch's CE."""
    logits = logits.float()
    if tp is not None:
        nll = _VocabParallelNLL.apply(logits, labels, tp)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        nll = lse - ll
    if mask is None:
        return nll.mean()
    mask = mask.float()
    den = mask.sum()
    if batch is None:
        return (nll * mask).sum() / den.clamp(min=1.0)
    den = C.all_reduce(den.reshape(1).clone(), batch)[0]
    return (nll * mask).sum() / den.clamp(min=1.0) * batch.size


EXTRAS = ("enc_x", "img")


def _extras(batch) -> Dict[str, torch.Tensor]:
    """A batch's encoder or image input (``forward``'s ``extras``)."""
    return {k: batch[k] for k in EXTRAS if k in batch}


def loss_fn(params, cfg: ArchConfig, flags: RunFlags,
            batch: Dict[str, torch.Tensor]):
    """Returns (loss, metrics {"loss", "ce", "mse", "router_aux"}).
    ``batch`` may carry an encoder-decoder's ``enc_x`` or a
    cross-attention arch's ``img`` (B, T, d)."""
    logits, aux = forward_train(params, cfg, flags, batch["tokens"],
                                _extras(batch))
    plan = flags.fsdp
    ce = cross_entropy(logits, batch["labels"], batch.get("loss_mask"),
                       tp=flags.tp if flags.mode == "train" else None,
                       batch=None if plan is None else plan.batch)
    loss = ce + cfg.dsa.lambda_mse * aux["mse"] + aux["router"]
    return loss, {"loss": loss, "ce": ce, "mse": aux["mse"],
                  "router_aux": aux["router"]}


def default_flags(cfg: ArchConfig, with_mse: bool = True) -> RunFlags:
    return RunFlags(mode="train", with_mse=with_mse,
                    dsa_mode="block" if cfg.dsa.enabled else "off")


def _device_of(params) -> torch.device:
    return params["embed"].device


def _on(batch, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def accumulate_grads(params, cfg: ArchConfig, flags: RunFlags, batch,
                     microbatches: int = 1,
                     plan: Optional[TrainPlan] = None):
    """Gradients of the joint loss over ``batch`` split into
    ``microbatches`` equal slices of rows, averaged in the param dtype,
    and the metrics averaged over the slices (f32 scalars on the params'
    device).  Returns (grads, metrics): a tree parallel to ``params``,
    zeros where a leaf takes no gradient; the params' ``.grad`` is cleared
    again.

    On a mesh (``plan``) ``batch`` is the global batch, the same on every
    rank: each microbatch is its global slice of rows, of which this rank
    computes its own (``TrainPlan.local_rows``), with ``plan.cfg``'s
    geometry; the gradients come out as this rank's shards of the
    unsharded ones and the metrics as the global batch's means."""
    dev = _device_of(params)
    gb = len(batch["tokens"])
    if gb % microbatches:
        raise ValueError(f"batch {gb} does not split into {microbatches} "
                         f"microbatches")
    n = gb // microbatches
    if plan is not None:
        cfg = plan.cfg
        flags = plan.run_flags(flags, batch["tokens"].shape[1], n)
    m_sum: Dict[str, torch.Tensor] = {}
    for i in range(microbatches):
        mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
        if plan is not None:
            mb = plan.local_rows(mb)
        loss, m = loss_fn(params, cfg, flags, _on(mb, dev))
        loss.backward()
        for k, v in m.items():
            v = v.detach()
            m_sum[k] = m_sum[k] + v if k in m_sum else v
    return finish_grads(params, m_sum, microbatches, plan, flags)


def finish_grads(params, m_sum: Dict[str, torch.Tensor], microbatches: int,
                 plan: Optional[TrainPlan] = None,
                 flags: Optional[RunFlags] = None):
    """``accumulate_grads``'s per-step tail: the params' ``.grad`` (zeros
    where a leaf took none) taken off and divided by the microbatch
    count, the metric sums ``m_sum`` divided likewise, and on a mesh
    (``plan``, with the ``flags`` its ``run_flags`` gave) the gradient and
    metric reductions.  Returns (grads, metrics)."""
    metrics = {k: v / microbatches for k, v in m_sum.items()}

    def take(p):
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        p.grad = None
        return g.div_(microbatches) if microbatches > 1 else g

    grads = map_tree(take, params)
    if plan is not None:
        plan.reduce_grads(dict(named_leaves(grads)), flags.sp)
        metrics = plan.reduce_metrics(metrics, ep=flags.ep is not None)
    return grads, metrics


def make_train_step(cfg: ArchConfig, opt: adamw.OptConfig,
                    flags: Optional[RunFlags] = None,
                    microbatches: int = 1, *, mesh=None,
                    rules: Optional[ShardingRules] = None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    batch: {"tokens": (GB, S), "labels": (GB, S), ["loss_mask": (GB, S)],
    ["enc_x" | "img": (GB, T, d)]}, numpy arrays or tensors; every entry
    is split by rows into the microbatches.  metrics: loss, ce, mse, router_aux, lr,
    grad_norm (f32 scalar tensors).

    ``mesh`` and ``rules`` (``distributed.sharding.make_rules``): train
    on a mesh of processes, every rank calling the step with the same
    global batch on the state ``init_train_state`` placed on that mesh
    (``TrainPlan``); the metrics are the same on every rank."""
    flags = flags or default_flags(cfg)
    plan = None if mesh is None else make_train_plan(cfg, mesh, rules)

    def train_step(state, batch):
        params = state["params"]
        grads, metrics = accumulate_grads(params, cfg, flags, batch,
                                          microbatches, plan)
        _, _, opt_metrics = adamw.apply_updates(opt, params, grads,
                                                state["opt"], plan=plan)
        metrics.update(opt_metrics)
        state["step"] += 1
        return state, metrics

    train_step.plan = plan
    return train_step


def make_eval_step(cfg: ArchConfig, flags: Optional[RunFlags] = None):
    """Returns eval_step(params, batch) -> {"ce", "last_tok_acc"}, run
    without gradients (so ``dsa_mode="kernel"`` may serve it)."""
    flags = flags or default_flags(cfg, with_mse=False)

    @torch.no_grad()
    def eval_step(params, batch):
        batch = _on(batch, _device_of(params))
        logits, _ = forward_train(params, cfg, flags, batch["tokens"],
                                  _extras(batch))
        ce = cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
        acc = (logits[:, -1].argmax(-1) == batch["labels"][:, -1]).float()
        return {"ce": ce, "last_tok_acc": acc.mean()}

    return eval_step


def make_prefill_step(cfg: ArchConfig, flags: RunFlags):
    """prefill(params, batch, caches) -> (last logits (B, 1, V), caches)."""
    def prefill(params, batch, caches):
        logits, caches = forward(params, cfg, flags, batch["tokens"], caches,
                                 extras=_extras(batch))
        return logits[:, -1:], caches
    return prefill


def make_decode_fn(cfg: ArchConfig, flags: RunFlags):
    """step(params, tokens, caches) -> (logits, caches)."""
    def step(params, tokens, caches):
        return decode_step(params, cfg, flags, tokens, caches)
    return step


def train_state_specs(cfg: ArchConfig, opt: adamw.OptConfig) -> Dict:
    """The training state's logical-axis spec tree (the reference's)."""
    specs = model_param_specs(cfg)
    return {"params": specs, "opt": adamw.state_specs(opt, specs),
            "step": ()}


def init_train_state(seed: int, cfg: ArchConfig, opt: adamw.OptConfig, *,
                     device=None, mesh=None,
                     rules: Optional[ShardingRules] = None):
    """Random params from ``seed`` (``device=None``: the card), every
    leaf but the frozen ``P`` requiring grad, and AdamW's state.  Returns
    (state, the state's logical spec tree), as the reference does.

    On a ``mesh`` under ``rules`` each piece of the tree is drawn whole
    (the draws of ``mesh=None``) and this rank keeps its shard of it as
    it comes (``init_model``'s ``place``), so no rank holds the whole tree
    on its card; the moments are made in each shard's shape."""
    place = None
    if mesh is not None:
        place = make_train_plan(cfg, mesh, rules).place(device)
    params = init_model(seed, cfg, device=device, place=place)
    for path, p in named_leaves(params):
        p.requires_grad_(not adamw.is_frozen(path))
    return ({"params": params, "opt": adamw.init(opt, params), "step": 0},
            train_state_specs(cfg, opt))
