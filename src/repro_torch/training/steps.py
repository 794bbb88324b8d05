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
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import RunFlags
from repro_torch.models.transformer import (decode_step, forward,
                                            forward_train, init_model)
from repro_torch.optim import adamw
from repro_torch.tree import map_tree, named_leaves


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over the valid tokens, in f32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


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
    ce = cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
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
                     microbatches: int = 1):
    """Gradients of the joint loss over ``batch`` split into
    ``microbatches`` equal slices of rows, averaged in the param dtype,
    and the metrics averaged over the slices (f32 scalars on the params'
    device).  Returns (grads, metrics): a tree parallel to ``params``,
    zeros where a leaf takes no gradient; the params' ``.grad`` is cleared
    again."""
    batch = _on(batch, _device_of(params))
    gb = batch["tokens"].shape[0]
    if gb % microbatches:
        raise ValueError(f"batch {gb} does not split into {microbatches} "
                         f"microbatches")
    n = gb // microbatches
    m_sum: Dict[str, torch.Tensor] = {}
    for i in range(microbatches):
        loss, m = loss_fn(params, cfg, flags,
                          {k: v[i * n:(i + 1) * n] for k, v in batch.items()})
        loss.backward()
        for k, v in m.items():
            v = v.detach()
            m_sum[k] = m_sum[k] + v if k in m_sum else v
    metrics = {k: v / microbatches for k, v in m_sum.items()}

    def take(p):
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        p.grad = None
        return g.div_(microbatches) if microbatches > 1 else g

    return map_tree(take, params), metrics


def make_train_step(cfg: ArchConfig, opt: adamw.OptConfig,
                    flags: Optional[RunFlags] = None,
                    microbatches: int = 1) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    batch: {"tokens": (GB, S), "labels": (GB, S), ["loss_mask": (GB, S)],
    ["enc_x" | "img": (GB, T, d)]}, numpy arrays or tensors; every entry
    is split by rows into the microbatches.  metrics: loss, ce, mse, router_aux, lr,
    grad_norm (f32 scalar tensors)."""
    flags = flags or default_flags(cfg)

    def train_step(state, batch):
        params = state["params"]
        grads, metrics = accumulate_grads(params, cfg, flags, batch,
                                          microbatches)
        _, _, opt_metrics = adamw.apply_updates(opt, params, grads,
                                                state["opt"])
        metrics.update(opt_metrics)
        state["step"] += 1
        return state, metrics

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


def init_train_state(seed: int, cfg: ArchConfig, opt: adamw.OptConfig, *,
                     device=None) -> Dict:
    """Random params from ``seed`` (``device=None``: the card), every
    leaf but the frozen ``P`` requiring grad, and AdamW's state."""
    params = init_model(seed, cfg, device=device)
    for path, p in named_leaves(params):
        p.requires_grad_(not adamw.is_frozen(path))
    return {"params": params, "opt": adamw.init(opt, params), "step": 0}
