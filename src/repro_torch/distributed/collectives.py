"""The port's collectives and their accounting (the counterpart of the
reference's ``repro/distributed/hlo_analysis.py``).

The reference writes no collective: GSPMD inserts them from its sharding
constraints, and ``hlo_analysis`` reads them back out of the compiled
per-device program.  The port runs one process per device and calls its
collectives itself, here and nowhere else: ``all_reduce`` and
``all_gather`` over a mesh axis's process group (``axis_group``: "model"
for tensor parallelism, "data" for data parallelism).  Each call adds
one to its counter (``all_reduce.model``, ``all_reduce.data``,
``all_gather.model``, ``all_gather.data``), registered with the kernels'
launch counters (``kernels/_launch.COUNTERS``; ``.world``: the
continuous engine's host agreements, ``agree``), so a CUDA graph that
captured a step adds the step's collectives on every replay, as it adds
its kernel launches.

The tensor-parallel decode budget (``check_tp_decode_collectives``), per
decode step at dp = 1: 2 * n_layers + 1 all-reduces over "model" (each
layer's attention out-projection and MLP down-projection, which contract
over the sharded heads and d_ff, plus the vocab-sharded embedding
lookup), 1 all-gather (the logits), and nothing else.  The port gathers
the (B, V/tp) logits where the reference gathers the lm-head weight
(hoisted out of its decode loop): a per-step weight gather would move
d_model x V x 2 bytes, 0.5 GB a step at yi_6b's vocab of 64,000 in
bf16, against B x V x 2 = 0.5 MB of logits at B = 4.  Under dp the
continuous engine adds one all-gather over "data" a segment (each
slot's tokens and finiteness flag) and the static engine one at the
end of ``generate``, outside the step.

Two sources count them: the counters (every backend), and on the card
the NCCL kernels of a ``torch.profiler`` trace (``kernel_collectives``).
The reference's ``parse_collectives`` (wire bytes) and ``roofline``
serve its dry run and wait for the port's (ROADMAP Queue 1); their TPU
constants are not the card's.

Backends: NCCL moves CUDA tensors and can be captured in a CUDA graph.
gloo moves CPU tensors (the CPU tests); on the card a gloo group stages
each CUDA tensor through host memory (gloo's own CUDA support does not
cover all-gather), and cannot be captured, so an engine on a gloo mesh
decodes eagerly (``inference/engine.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.kernels import _launch as LN

OPS = ("all-reduce", "all-gather")
AXES = ("model", "data", "world")


@dataclasses.dataclass(frozen=True, eq=False)
class AxisGroup:
    """One mesh axis's process group as this rank sees it: its ``size``,
    this rank's ``rank`` in it and the ``backend``.  Compared and hashed
    by identity (it rides in ``RunFlags.tp``)."""
    axis: str
    group: Any
    size: int
    rank: int
    backend: str

    @property
    def staged(self) -> bool:
        """Whether CUDA tensors go through host memory (gloo)."""
        return self.backend == "gloo"


def axis_group(mesh, axis: str) -> Optional[AxisGroup]:
    """The group of ``mesh``'s axis ``axis``, None when the mesh has no
    such axis."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return None
    g = mesh.get_group(axis)
    return AxisGroup(axis, g, dist.get_world_size(g), dist.get_rank(g),
                     str(dist.get_backend(g)))


def world_group(mesh) -> Optional[AxisGroup]:
    """Every rank of ``mesh``'s process group (the world), for the
    continuous engine's host agreement (``agree``); None without a
    mesh."""
    if mesh is None:
        return None
    return AxisGroup("world", None, dist.get_world_size(), dist.get_rank(),
                     str(dist.get_backend()))


def agree(value: float, g: Optional[AxisGroup], device) -> float:
    """Rank 0's ``value`` on every rank of ``g`` (one all-gather of a
    scalar; ``value`` itself when ``g`` is None or of one rank): what a
    host decides from a local reading (a clock, a timing) must be the
    same on every rank, or their collectives fall out of step."""
    if g is None or g.size == 1:
        return value
    t = torch.tensor([float(value)], dtype=torch.float64, device=device)
    return float(all_gather(t, g, 0)[0])


# the flat all-gather: torch 2.13 names it all_gather_single and deprecates
# all_gather_into_tensor, which earlier versions (2.11) alone have
_gather_flat = (getattr(dist, "all_gather_single", None)
                or dist.all_gather_into_tensor)


def _count(fn, g: AxisGroup) -> None:
    setattr(fn, g.axis, getattr(fn, g.axis) + 1)


def all_reduce(x: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    """Sum ``x`` over the group, in place; returns ``x``."""
    _count(all_reduce, g)
    if x.is_cuda and g.staged:
        h = x.cpu()
        dist.all_reduce(h, group=g.group)
        x.copy_(h)
    else:
        dist.all_reduce(x, group=g.group)
    return x


def all_gather(x: torch.Tensor, g: AxisGroup, dim: int = 0) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in rank order (every
    rank's ``x`` has the same shape)."""
    _count(all_gather, g)
    dim = dim % x.dim()
    src = x.contiguous().reshape(-1)
    dev = x.device
    if x.is_cuda and g.staged:
        src = src.cpu()
    flat = torch.empty((g.size * src.numel(),), dtype=x.dtype,
                       device=src.device)
    _gather_flat(flat, src, group=g.group)
    out = flat.view(g.size, *x.shape).movedim(0, dim)
    shape = list(x.shape)
    shape[dim] *= g.size
    return out.reshape(shape).to(dev)


LN.counters(all_reduce, *AXES)
LN.counters(all_gather, *AXES)
_COUNTERS = {("all-reduce", a): (all_reduce, a) for a in AXES}
_COUNTERS.update({("all-gather", a): (all_gather, a) for a in AXES})


def snapshot() -> Dict[tuple, int]:
    """Every collective counter, {(op, axis): calls so far}."""
    return {k: getattr(fn, a) for k, (fn, a) in _COUNTERS.items()}


def count_collectives(since: Dict[tuple, int],
                      axis: Optional[str] = None) -> Dict[str, int]:
    """{op: collectives issued since the ``snapshot`` ``since``}, over
    every axis or only ``axis``; a CUDA graph's replays count as its
    captured collectives."""
    now = snapshot()
    out = {op: 0 for op in OPS}
    for (op, a), n in now.items():
        if axis is None or a == axis:
            out[op] += n - since[(op, a)]
    return out


def kernel_collectives(prof) -> Dict[str, int]:
    """{op: NCCL kernels} of a ``torch.profiler.profile`` trace (device
    events whose name holds ``AllReduce`` or ``AllGather``, as NCCL names
    its kernels; a world of one rank may copy instead of launching
    one)."""
    out = {op: 0 for op in OPS}
    names = {"AllReduce": "all-reduce", "AllGather": "all-gather"}
    for ev in prof.events():
        if "nccl" not in ev.name.lower():
            continue
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        for key, op in names.items():
            if key in ev.name:
                out[op] += 1
    return out


def check_tp_decode_collectives(counts: Dict[str, int], n_layers: int,
                                steps: int = 1) -> Dict[str, int]:
    """Raise AssertionError unless ``counts`` (``count_collectives`` over
    ``steps`` pure-tp decode steps) is the budget: 2 * n_layers + 1
    all-reduces and 1 all-gather a step, and no other collective.
    Returns ``counts``."""
    expect = {"all-reduce": (2 * n_layers + 1) * steps,
              "all-gather": steps}
    why = {"all-reduce": "2 * n_layers + 1 a step: attention out-proj and "
                         "MLP down-proj per layer, and the vocab-sharded "
                         "embedding lookup",
           "all-gather": "1 a step: the (B, V/tp) logits"}
    for op, n in counts.items():
        if op not in expect and n:
            raise AssertionError(f"tp decode issued {n} unexpected {op}")
    for op, n in expect.items():
        got = counts.get(op, 0)
        if got != n:
            raise AssertionError(f"tp decode {op} count {got} != {n} "
                                 f"({why[op]})")
    return counts


def assert_collectives_token_invariant(a: Dict[str, int], b: Dict[str, int],
                                       steps_a: int, steps_b: int) -> None:
    """Raise AssertionError unless two runs' collective counts per decode
    step are equal (``a`` over ``steps_a`` steps, ``b`` over
    ``steps_b``): no collective is added per token beyond the step's."""
    for op in set(a) | set(b):
        if a.get(op, 0) * steps_b != b.get(op, 0) * steps_a:
            raise AssertionError(
                f"{op} per step varies with the segment length: "
                f"{a.get(op, 0)}/{steps_a} != {b.get(op, 0)}/{steps_b}")
