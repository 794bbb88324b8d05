"""Carry the JAX reference's weights across to the port.

``from_reference`` takes the reference's ``init_model(key, cfg)[0]`` tree
as nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``; no
JAX is needed here) and returns the port's parameters.  The reference
stacks its layer groups over a leading axis::

    embed, groups.b0.{norm1, norm2, attn.{wq, wk, wv, wo, dsa.{p, wq, wk}},
                      mlp.{w1, w3, w2}}  (each with a leading n_layers axis),
    final_norm, lm_head

The port keeps one dict per group in ``params["groups"]``, so the stacked
leaves are split along that axis.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes bf16 from JAX
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).astype(
            np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def from_reference(tree: Dict[str, Any], *, device=None) -> Dict[str, Any]:
    """Reference params (nested dicts of numpy arrays) -> port params."""
    dev = resolve_device(device)
    groups = tree["groups"]
    n = len(next(iter(_leaves(groups))))
    out: Dict[str, Any] = {
        k: _tensor(v, dev) for k, v in tree.items() if k != "groups"}
    out["groups"] = [_map(groups, lambda a, i=i: _tensor(np.asarray(a)[i],
                                                         dev))
                     for i in range(n)]
    return out


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
