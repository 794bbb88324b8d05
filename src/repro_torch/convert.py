"""Carry weights between the JAX reference and the port.

``from_reference`` takes the reference's ``init_model(key, cfg)[0]`` tree
as nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``; no
JAX is needed here) and returns the port's parameters.  The reference
stacks its layer groups over a leading axis::

    embed, groups.b0.{norm1, norm2, attn.{wq, wk, wv, wo, dsa.{p, wq, wk}},
                      mlp.{w1, w3, w2}}  (each with a leading n_layers axis),
    final_norm, lm_head

The port keeps one dict per group in ``params["groups"]``, so the stacked
leaves are split along that axis.  ``to_reference`` is the inverse: it
stacks the groups back into the reference's tree of numpy arrays.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import map_tree, named_leaves


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes bf16 from JAX
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).astype(
            np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def from_reference(tree: Dict[str, Any], *, device=None) -> Dict[str, Any]:
    """Reference params (nested dicts of numpy arrays) -> port params."""
    dev = resolve_device(device)
    groups = tree["groups"]
    n = len(next(named_leaves(groups))[1])
    out: Dict[str, Any] = {
        k: _tensor(v, dev) for k, v in tree.items() if k != "groups"}
    out["groups"] = [map_tree(lambda a, i=i: _tensor(np.asarray(a)[i], dev),
                              groups)
                     for i in range(n)]
    return out


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    # bf16 comes back as f32 (exact): numpy has no bf16 of its own
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def to_reference(params: Dict[str, Any]) -> Dict[str, Any]:
    """Port params -> the reference's tree of numpy arrays, the groups
    stacked over a leading layer axis (the inverse of ``from_reference``;
    bf16 leaves come back as f32 arrays of the same values)."""
    out: Dict[str, Any] = {
        k: _array(v) for k, v in params.items() if k != "groups"}
    out["groups"] = map_tree(lambda *ls: np.stack([_array(t) for t in ls]),
                             *params["groups"])
    return out
