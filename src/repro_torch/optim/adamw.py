"""AdamW with configurable state dtypes: the reference's
``repro/optim/adamw.py`` arithmetic, run in place.

Not ``torch.optim.AdamW``: that one decays as ``p * (1 - lr * wd)`` and
has none of this update's global-norm clip, frozen leaves, warmup-cosine
schedule or rounding.  Here each update is computed in f32 and cast back
to the parameter's dtype (``master_dtype=""``) or kept in an f32 master
copy; ``moment_dtype`` stores m and v narrower (bf16) to save memory.
The update runs leaf by leaf under ``torch.no_grad()``, writing params,
moments and masters in place.

Frozen: the DSA projection ``P`` (paths ending ``/dsa/p``) never moves;
its moments stay zero.  Weight decay applies to every leaf of two or more
dimensions in the REFERENCE's layout, where the layer groups are stacked
over a leading axis: a leaf under ``/groups/`` (or an encoder's
``/enc_groups/``) counts that axis too.  So
the per-layer norms ``norm1``/``norm2`` and biases are decayed and
``final_norm`` is not, as in the reference, whose docstring says that
norms and biases are skipped (ROADMAP Queue 3 records the difference).

Sharded (``apply_updates(..., plan=)``, a ``distributed.sharding.
TrainPlan``'s state): params, gradients and moments are this rank's
shards (``init`` makes the moments in each shard's shape, on its
device), and the update is elementwise, so it runs on them unchanged;
the gradient norm is the unsharded tree's (``TrainPlan.global_norm``:
each leaf's squares counted once over the world), so every rank takes
the same clip scale.  ``state_specs`` is the reference's: the moments
take their params' logical specs, so under the FSDP rules the whole
state is ZeRO-3 sharded.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from repro_torch.tree import map_tree, named_leaves

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    moment_dtype: str = "float32"      # "bfloat16" halves the moments
    master_dtype: str = ""             # "" = update params in their own dtype


def is_frozen(path: str) -> bool:
    return path.endswith("/dsa/p")


def decay_ok(path: str, leaf: torch.Tensor) -> bool:
    """The reference's ``leaf.ndim >= 2`` on its stacked layout: a leaf
    of a layer group has one more axis there."""
    ndim = leaf.dim() + path.startswith(("/groups/", "/enc_groups/"))
    return ndim >= 2 and not is_frozen(path)


def schedule(cfg: OptConfig, step: int) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine decay to ``min_lr_frac *
    lr`` at ``total_steps``: an f32 scalar on the host."""
    step = torch.tensor(float(step), dtype=torch.float32)
    warm = step / max(1.0, cfg.warmup_steps)
    prog = (step - cfg.warmup_steps) / max(
        1.0, cfg.total_steps - cfg.warmup_steps)
    prog = prog.clamp(0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(cfg: OptConfig, params) -> Dict[str, Any]:
    """Zero moments for every leaf (frozen ones too), the step count, and
    with ``master_dtype`` a master copy of the params."""
    mdt = DTYPES[cfg.moment_dtype]
    state = {
        "m": map_tree(lambda p: torch.zeros_like(p, dtype=mdt), params),
        "v": map_tree(lambda p: torch.zeros_like(p, dtype=mdt), params),
        "step": 0,
    }
    if cfg.master_dtype:
        dt = DTYPES[cfg.master_dtype]
        state["master"] = map_tree(
            lambda p: p.detach().clone().to(dt), params)
    return state


def state_specs(cfg: OptConfig, param_specs) -> Dict[str, Any]:
    """Logical specs of the optimizer state tree (the reference's)."""
    out = {"m": param_specs, "v": param_specs, "step": ()}
    if cfg.master_dtype:
        out["master"] = param_specs
    return out


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum()
                          for _, x in named_leaves(tree)))


@torch.no_grad()
def apply_updates(cfg: OptConfig, params, grads, state, plan=None):
    """One AdamW step over ``params`` with ``grads`` (a tree of the same
    structure), in place.  Returns (params, state, {"lr", "grad_norm"}).
    ``plan``: the ``TrainPlan`` whose shards these are."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads) if plan is None else plan.global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
             if cfg.grad_clip else 1.0)
    b1, b2 = cfg.b1, cfg.b2
    step_f = torch.tensor(float(step), dtype=torch.float32)
    bc1 = 1 - b1 ** step_f
    bc2 = 1 - b2 ** step_f
    masters = state.get("master", params)
    leaves = zip(named_leaves(params), named_leaves(grads),
                 named_leaves(state["m"]), named_leaves(state["v"]),
                 named_leaves(masters))
    for (path, p), (_, g), (_, m), (_, v), (_, ms) in leaves:
        if is_frozen(path):
            continue
        g32 = g.float()
        nm = b1 * m.float() + (1 - b1) * g32 * scale
        nv = b2 * v.float() + (1 - b2) * torch.square(g32 * scale)
        delta = (nm / bc1) / (torch.sqrt(nv / bc2) + cfg.eps)
        if decay_ok(path, p):
            delta = delta + cfg.weight_decay * ms.float()
        nms = ms.float() - lr * delta
        if ms is not p:
            ms.copy_(nms)
        p.copy_(nms)
        m.copy_(nm)
        v.copy_(nv)
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}
