"""Carry weights and training states between the JAX reference and the
port.

``from_reference`` takes the reference's ``init_model(key, cfg)[0]`` tree
as nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``; no
JAX is needed here) and returns the port's parameters.  The reference
stacks its layer groups over a leading axis::

    embed, groups.b0.{norm1, norm2, attn.{wq, wk, wv, wo, dsa.{p, wq, wk}},
                      mlp.{w1, w3, w2}}  (each with a leading n_layers axis),
    final_norm, lm_head

The port keeps one dict per group in ``params["groups"]``, so the stacked
leaves are split along that axis; an encoder's ``enc_groups`` (whisper)
likewise.  A dense prologue (deepseek_v3's
``prologue``, a list of per-layer dicts) is unstacked in both packages
and carried as it is.  ``to_reference`` is the inverse: it
stacks the groups back into the reference's tree of numpy arrays.

``state_to_reference`` / ``state_from_reference`` do the same for a whole
training state ``{"params", "opt": {"m", "v", "step"[, "master"]},
"step"}`` and keep every dtype: the steps (Python ints in the port) are
int32 0-d arrays there, and a bf16 leaf is a 2-byte void array holding
the bf16 bits (numpy has no bf16 of its own; the reference's ml_dtypes
bf16 is read as bf16 too).  The checkpoint module writes and reads the
reference's tree through them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.optim.adamw import is_frozen
from repro_torch.tree import map_tree, named_leaves

# how a bf16 leaf is held on the host: its bits as a 2-byte void
BF16_HOST = np.dtype("V2")

# the keys whose layer groups the reference stacks over a leading axis
STACKED = ("groups", "enc_groups")


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == BF16_HOST:
        # (ascontiguousarray makes a 0-d array 1-d: the shape is put back)
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).astype(
            np.int16).reshape(a.shape)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def from_reference(tree: Dict[str, Any], *, device=None) -> Dict[str, Any]:
    """Reference params (nested dicts of numpy arrays) -> port params."""
    dev = resolve_device(device)
    return {k: (_unstack(v, dev) if k in STACKED
                else map_tree(lambda a: _tensor(a, dev), v))
            for k, v in tree.items()}


def _unstack(groups, dev: torch.device) -> list:
    """A stacked group tree -> the per-layer list of group trees."""
    n = len(next(named_leaves(groups))[1])
    return [map_tree(lambda a, i=i: _tensor(np.asarray(a)[i], dev), groups)
            for i in range(n)]


def reference_layout(tree: Any, leaf: Callable, stacked: Callable) -> Any:
    """A port tree in the reference's layout: ``leaf(t)`` for a leaf
    outside the layer groups, ``stacked(ts)`` for the per-layer list of a
    group leaf (under a ``"groups"`` or ``"enc_groups"`` key holding a
    list), a Python int as an int32 0-d array; other leaves as they
    are."""
    if isinstance(tree, dict):
        return {k: (map_tree(lambda *ts: stacked(ts), *v)
                    if k in STACKED and isinstance(v, list)
                    else reference_layout(v, leaf, stacked))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(reference_layout(v, leaf, stacked) for v in tree)
    if isinstance(tree, int):
        return np.asarray(tree, np.int32)
    return leaf(tree) if isinstance(tree, torch.Tensor) else tree


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    # bf16 comes back as f32 (exact): numpy has no bf16 of its own
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def to_reference(params: Dict[str, Any]) -> Dict[str, Any]:
    """Port params -> the reference's tree of numpy arrays, the groups
    stacked over a leading layer axis (the inverse of ``from_reference``;
    bf16 leaves come back as f32 arrays of the same values)."""
    return reference_layout(
        params, _array, lambda ts: np.stack([_array(t) for t in ts]))


@torch.no_grad()
def _host(ts) -> np.ndarray:
    """A new host array holding ``ts`` (one tensor, or a layer list stacked
    over a leading axis), in its dtype (bf16 as ``BF16_HOST``).  Always a
    copy, also of a CPU tensor, made before it returns."""
    one = isinstance(ts, torch.Tensor)
    t0 = ts if one else ts[0]
    bf16 = t0.dtype == torch.bfloat16
    dt = torch.int16 if bf16 else t0.dtype
    out = torch.empty(tuple(t0.shape) if one else (len(ts), *t0.shape),
                      dtype=dt)
    for i, t in enumerate([ts] if one else ts):
        (out if one else out[i]).copy_(t.detach().view(dt))
    a = out.numpy()
    return a.view(BF16_HOST) if bf16 else a


def state_to_reference(state: Dict[str, Any]) -> Dict[str, Any]:
    """A port tree (the training state, or any nested dicts and lists of
    tensors and ints) -> the reference's tree of host numpy arrays:
    layer groups stacked, ints as int32 0-d arrays, dtypes kept (bf16 as
    ``BF16_HOST``).  Every leaf is copied before this returns, so the
    caller may update the state in place at once."""
    return reference_layout(state, _host, _host)


def state_from_reference(tree: Dict[str, Any], *, device=None
                         ) -> Dict[str, Any]:
    """The reference's tree (numpy arrays; bf16 as ml_dtypes or
    ``BF16_HOST``) -> the port's, on ``device`` (``None``: the card):
    stacked groups split per layer, integer 0-d arrays as Python ints,
    and the leaves under ``"params"`` requiring grad as
    ``steps.init_train_state`` sets them (all but the frozen DSA ``P``)."""
    dev = resolve_device(device)

    def walk(t):
        if isinstance(t, dict):
            return {k: (_unstack(v, dev) if k in STACKED else walk(v))
                    for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        a = np.asarray(t)
        if a.ndim == 0 and a.dtype.kind in "iu":
            return int(a)
        return _tensor(a, dev)

    out = walk(tree)
    if isinstance(out, dict) and "params" in out:
        for path, p in named_leaves(out["params"]):
            p.requires_grad_(not is_frozen(path))
    return out
