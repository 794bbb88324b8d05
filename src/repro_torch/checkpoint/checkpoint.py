"""Fault-tolerant checkpointing: the port of the reference's
``repro/checkpoint/checkpoint.py``, in its on-disk format.

- the tree is saved in the reference's logical layout
  (``convert.state_to_reference``): layer groups stacked over a leading
  axis, the steps int32 0-d arrays, one ``.npy`` per leaf named by its
  dotted path (``/`` -> ``_``), so a port checkpoint of a state has the
  files, bytes and digests of the reference's checkpoint of that state.
  A bf16 leaf keeps its bits: it is written with the header the
  reference's ml_dtypes bf16 leaf gets (``'<V2'``) and read back as bf16;
- atomic directory swap (write to .tmp, rename) so a crash mid-save never
  corrupts the latest checkpoint;
- sha256 digest per leaf (``meta.json``) verified on load;
- async save (background thread) with bounded lag: at most one outstanding
  save; the train loop only blocks if it laps the writer.  The copy to
  host memory is made before ``save`` returns: the train step updates
  params and moments in place.
- on a mesh (``plan``, a ``distributed.sharding.TrainPlan``) the file is
  the same logical whole tree: every leaf is gathered from its shards,
  one leaf at a time (a device holds one whole leaf beside its shards),
  and rank 0 keeps the host copy and writes it.  ``restore`` with a plan
  reads the file on the host and keeps this rank's shard of each leaf,
  so a run saved on one mesh resumes on another, or on none, and a run
  saved on none resumes on a mesh.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import convert
from repro_torch.tree import named_leaves

# the state's subtrees whose leaves are laid out as the params are
_PARAM_LIKE = ("/params", "/opt/m", "/opt/v", "/opt/master")


def _param_path(path: str) -> Optional[str]:
    """The param path a state leaf is laid out by (its moment's, its
    master copy's), None for the steps."""
    for pre in _PARAM_LIKE:
        if path.startswith(pre + "/"):
            return path[len(pre):]
    return None


@torch.no_grad()
def gather_state(tree, plan):
    """The logical whole state on the host at the plan's rank 0 (None on
    the other ranks): each leaf all-gathered from its shards, one at a
    time, and copied to host memory before the next."""
    keep = plan.world.rank == 0

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, f"{path}/{i}") for i, v in enumerate(t))
        if not isinstance(t, torch.Tensor):
            return t
        pp = _param_path(path)
        w = t if pp is None else plan.whole(t, pp)
        return w.detach().to("cpu", copy=True) if keep else None

    out = walk(tree, "")
    return out if keep else None


@torch.no_grad()
def shard_state(tree, plan, device=None):
    """This rank's shards of a whole port state ``tree`` (on the host),
    on ``device``; params keep their ``requires_grad``."""
    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, f"{path}/{i}") for i, v in enumerate(t))
        if not isinstance(t, torch.Tensor):
            return t
        pp = _param_path(path)
        piece = t if pp is None else plan.shard(t, pp)
        out = piece.detach().to(device).contiguous()
        if out.untyped_storage().data_ptr() == t.untyped_storage(
                ).data_ptr():
            out = out.clone()
        return out.requires_grad_(t.requires_grad)
    return walk(tree, "")


def _flatten(tree, prefix="") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten_into(like, flat, prefix=""):
    if isinstance(like, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}.")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        typ = type(like)
        return typ(_unflatten_into(v, flat, f"{prefix}{i}.")
                   for i, v in enumerate(like))
    return flat[prefix[:-1]]


def _write_npy(fn: str, a: np.ndarray) -> None:
    if a.dtype != convert.BF16_HOST:
        np.save(fn, a)
        return
    with open(fn, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {
            "descr": "<V2", "fortran_order": False, "shape": a.shape})
        np.ascontiguousarray(a).tofile(f)


def save(path: str, tree, step: int, extra: Optional[Dict] = None) -> None:
    """Write ``tree`` (a port tree, or one ``state_to_reference`` already
    copied to the host) to the directory ``path``."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    flat = _flatten(convert.state_to_reference(tree))
    digests = {}
    for name, a in flat.items():
        fn = name.replace("/", "_") + ".npy"
        _write_npy(os.path.join(tmp, fn), a)
        digests[name] = hashlib.sha256(a.tobytes()).hexdigest()
    meta = {"step": int(step), "digests": digests, "extra": extra or {}}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)


def _check_like(got, like) -> None:
    """Raise unless ``got`` has ``like``'s leaves, dtypes and shapes."""
    want = dict(named_leaves(like))
    for name, g in named_leaves(got):
        w = want.get(name)
        same = (isinstance(g, torch.Tensor) and isinstance(w, torch.Tensor)
                and g.dtype == w.dtype and g.shape == w.shape
                if isinstance(w, torch.Tensor) else type(g) is type(w))
        if not same:
            raise ValueError(f"checkpoint leaf {name}: {_spec(g)}, expected "
                             f"{_spec(w)}")


def _spec(t) -> str:
    return (f"{t.dtype} {tuple(t.shape)}" if isinstance(t, torch.Tensor)
            else type(t).__name__)


def restore(path: str, like, device=None, verify: bool = True,
            plan=None) -> Tuple[Any, int]:
    """like: a port tree with the target structure (the training state).
    Returns (the port's tree on ``device``, the step saved): groups split
    per layer, steps as ints, params requiring grad as
    ``steps.init_train_state`` sets them, each leaf in ``like``'s dtype
    and shape (``ValueError`` otherwise).  With a ``plan`` (``like`` is a
    state on its mesh) the file is read on the host and each leaf's shard
    kept."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    skeleton = convert.reference_layout(like, lambda t: t, lambda ts: ts[0])
    flat = {}
    for name in _flatten(skeleton):
        a = np.load(os.path.join(path, name.replace("/", "_") + ".npy"))
        if verify:
            d = hashlib.sha256(a.tobytes()).hexdigest()
            if d != meta["digests"].get(name):
                raise IOError(f"checkpoint digest mismatch for {name}")
        flat[name] = a
    tree = convert.state_from_reference(
        _unflatten_into(skeleton, flat),
        device="cpu" if plan is not None else device)
    if plan is not None:
        tree = shard_state(tree, plan, device)
    _check_like(tree, like)
    return tree, meta["step"]


def latest_step(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    steps = [int(d.split("_")[-1]) for d in os.listdir(root)
             if d.startswith("ckpt_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


class AsyncCheckpointer:
    """At-most-one-outstanding async saver with crash-consistent swaps."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(root, exist_ok=True)

    def save(self, tree, step: int, extra=None, block: bool = False,
             plan=None) -> None:
        """Save ``tree`` as step ``step``; on a mesh (``plan``) every rank
        calls it, each leaf is gathered whole and rank 0 writes."""
        self.wait()
        # the host copy, here and not in the thread: the next train step
        # updates the state in place
        if plan is not None:
            tree = gather_state(tree, plan)
            if tree is None:
                return
        host_tree = convert.state_to_reference(tree)

        def work():
            save(os.path.join(self.root, f"ckpt_{step}"), host_tree, step,
                 extra)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if block:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_latest(self, like, device=None, plan=None):
        step = latest_step(self.root)
        if step is None:
            return None, None
        return restore(os.path.join(self.root, f"ckpt_{step}"), like, device,
                       plan=plan)

    def _gc(self) -> None:
        steps = sorted(int(d.split("_")[-1]) for d in os.listdir(self.root)
                       if d.startswith("ckpt_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.root, f"ckpt_{s}"),
                          ignore_errors=True)
