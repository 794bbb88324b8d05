"""The port's collectives and their accounting (the counterpart of the
reference's ``repro/distributed/hlo_analysis.py``).

The reference writes no collective: GSPMD inserts them from its sharding
constraints, and ``hlo_analysis`` reads them back out of the compiled
per-device program.  The port runs one process per device and calls its
collectives itself, here and nowhere else: ``all_reduce``,
``all_gather``, ``reduce_scatter`` and ``all_to_all`` over a mesh
axis's process group
(``axis_group``: "model" for tensor parallelism, "data" for data
parallelism; ``axes_group`` for several axes at once, such as the
reference's composite ("pod", "data") batch axis).  Each call adds one
to its counter (``all_reduce.model``, ``reduce_scatter.data``, ...; a
group of several axes counts under their names joined by "+", e.g.
``all_reduce["pod+data"]``), registered with the kernels' launch
counters (``kernels/_launch.COUNTERS``; ``.world``: the continuous
engine's host agreements, ``agree``, and the training step's gradient
norm), so a CUDA graph that captured a step adds the step's collectives
on every replay, as it adds its kernel launches.

Serving.  The tensor-parallel decode budget
(``check_tp_decode_collectives``), per decode step at dp = 1: 2 *
n_layers + 1 all-reduces over "model" (each layer's attention
out-projection and MLP down-projection, which contract over the sharded
heads and d_ff, plus the vocab-sharded embedding lookup), 1 all-gather
(the logits), and nothing else.  A cross sub-layer adds its
out-projection's (whisper_small: 3 a decoder layer; llama_3_2_vision: 1
a group of 5), RWKV6 has two a layer (the time-mix's ``wo``, the FFN's
``wv``), a Mamba sub-block three (``x_proj``, ``out_proj``, its MLP's or
MoE's): ``sharding.tp_decode_all_reduces``.  A prefill issues the same
per layer and, on whisper_small, 2 more a layer of its encoder.  The port gathers the (B, V/tp) logits
where the reference gathers the lm-head weight (hoisted out of its
decode loop): a per-step weight gather would move d_model x V x 2
bytes, 0.5 GB a step at yi_6b's vocab of 64,000 in bf16, against B x V
x 2 = 0.5 MB of logits at B = 4.  Under dp the continuous engine adds
one all-gather over "data" a segment (each slot's tokens and finiteness
flag) and the static engine one at the end of ``generate``, outside the
step.

Training (``distributed/sharding.TrainPlan``).  The autograd-aware
collectives below carry a gradient: ``exchange`` (the all-to-all
forward and backward: expert parallelism's dispatch and return, the
exchange being its own adjoint), ``mean_over`` (an all-reduce's mean
forward, the gradient scaled on each rank's own input backward: the
router term over "model"), ``copy_to_tp`` (identity forward,
all-reduce backward: a column-parallel product's replicated input) and
``reduce_from_tp`` (all-reduce forward, identity backward: a
row-parallel product's partial output, and the MSE target's partial
head sum), ``tp_psum`` (all-reduce both ways: Mamba's ``x_proj``, whose
summed output feeds only each rank's channels); ``gather_seq`` (all-gather over the sequence forward,
reduce-scatter backward: sequence parallelism's entry) and
``scatter_seq`` (reduce-scatter forward, all-gather backward: SP's
exit); ``replicated_input`` (no collective: a consumer every rank
computes alike, the DSA predictor, has its gradient divided by tp, so
that the entry's sum counts it once); ``fsdp_gather`` (all-gather of a
leaf's data-sharded dimension forward, reduce-scatter of its gradient
divided by the group size, a mean, backward).

The training step's collective budget (``check_train_collectives``,
the counts of ``TrainPlan.collective_budget``), for the dense GQA
decoder, the arch whose layers have a tensor-parallel form, with L
layers and M microbatches; r = 1 when the layers recompute in the
backward pass (``cfg.remat`` with ``remat_policy="full"``), else 0;
m = 1 when a layer adds the DSA MSE term (train mode, DSA on,
``with_mse``), else 0; A the "data"-role dimensions of one layer's
leaves (one gather each: wq, wk, wv, wo, w1, w3, w2 and the predictor's
P under ``make_rules()``, 8), A' those of them that train (P does not,
7).  Non-layer: E the data-role dims of the embedding, the head and the
final norm (the embedding's and the head's "embed" dim: 2 untied),
E' those that train.

  per microbatch and layer, TP with SP (``seq_sp`` resolves to "model"):
    all-gather "model"      4 + 2r   (norm1 and norm2 outputs forward and
                                      in the recompute; the two
                                      reduce-scatters' backward)
    reduce-scatter "model"  4 + r    (out-proj and down-proj forward; the
                                      two gathers' backward; the
                                      recompute's out-proj: it stops after
                                      the last saved tensor, the
                                      down-projection's input, so the
                                      down-proj's reduce-scatter is not
                                      run again)
    all-reduce "model"      m (1 + r) (the MSE target's head sum)
  an MoE sub-layer on the expert-parallel dispatch (``TrainPlan.ep``),
  any table where its gate holds:
    all-to-all "model"      4 + 2r   (dispatch and return forward, their
                                      backward, again in the recompute)
    all-reduce "model"      1        (the router term's mean; after the
                                      last saved tensor, so the recompute
                                      stops before it, but where a later
                                      sub-layer of the group saves
                                      tensors, jamba's: 1 + r)
    and under TP with SP it drops its own gather and scatter: the
    layer's all-gathers 2 + r, reduce-scatters 2 (its attention's)
  TP without SP:
    all-reduce "model"      4 + m + r (1 + m)  (out-proj and down-proj
                                      forward, their inputs' gradients
                                      backward, the MSE sum; the
                                      recompute's out-proj and MSE sum)
    (an EP sub-layer in place of the MLP: its input's gradient sum and
    the router term's mean in place of the down-proj's two, the same
    count)
  FSDP, any table:
    all-gather <data axes>  A (1 + r)
    reduce-scatter <axes>   A'
  other sub-layers (``sharding.tp_sites``, per checkpoint region, a
  layer group): a cross-attention sub-layer and RWKV6's time-mix and FFN
  count as an attention sub-layer (2 + r gathers and 2 + r scatters
  under SP, 2 + r all-reduces without), as does every MLP but a group's
  last (llama_3_2_vision's group of 5: its recompute reaches them); a
  cross sub-layer's and an RWKV6 FFN's output is multiplied by a gate,
  which saves it, so their recompute runs the exit again wherever they
  stand.  MLA and Mamba count as an attention sub-layer (MLA's MSE sum
  as the attention's), Mamba with 2 + r all-reduces more (``x_proj``'s
  sum forward, its gradient's backward, again in the recompute); the
  shared experts of an EP sub-layer under TP as an MLP that is not last
  (they run before the dispatch).  whisper_small's encoder layers count
  as decoder layers, and
  its output adds 1 all-gather and 1 reduce-scatter under SP (gathered
  once for every cross sub-layer), 1 all-reduce without (its partial
  key/value gradients)
  per microbatch, outside the layers:
    all-gather <data axes>  E;  reduce-scatter <data axes> E
    "model" with SP: 2 all-gathers and 2 reduce-scatters (the embedding
      lookup's reduce-scatter and the head's sequence gather, and their
      backward); without SP: 2 all-reduces (the lookup's sum forward, the
      head input's gradient backward)
    "model", vocab-parallel cross-entropy: 2 all-reduces (the row max,
      and each row's exp-sum with its target logit)
    the batch axes: 1 all-reduce (the loss mask's token count)
  per step:
    the batch axes: 1 all-reduce of the gradients of the leaves that no
      reduce-scatter reached (norms, biases, the predictor's square
      matrices, a leaf whose "embed" dimension does not divide), and
      one per further group of leaves that lack other batch axes (the
      "pod" axis of the multipod table); 1 all-reduce of the metrics
    "model" with SP, an MoE arch, tp above the KV heads, RWKV6 or MLA:
      1 all-reduce of the norms' gradients (their rows are sequence
      shards; a cross gate's too), the routers' (each rank's part: its
      rows, or its experts' pairs), the whole KV leaves' (each rank's
      head's slice, ``TrainPlan.kv_slices``) and RWKV6's and MLA's whole
      leaves that feed a rank's heads (``TrainPlan.partials``)
    "world": 1 all-reduce (the gradient norm's sum of squares)

A group of one rank counts its calls like any other; on gloo it moves
nothing (the result is the input), on NCCL it calls the library.

Two sources count them: the counters (every backend), and on the card
the NCCL kernels of a ``torch.profiler`` trace (``kernel_collectives``).
The dry run (``launch/dryrun.py``) also takes their bytes: under
``recording()`` each call appends an ``Issued`` record (op, axis, the
group's size and ranks, the per-device output's bytes), which
``distributed/hlo_analysis.parse_collectives`` turns into the
reference's wire bytes.  Off, the record costs one test a call.

Backends: NCCL moves CUDA tensors and can be captured in a CUDA graph.
gloo moves CPU tensors (the CPU tests); on the card a gloo group stages
each CUDA tensor through host memory (gloo's own CUDA support does not
cover all-gather), and cannot be captured, so an engine on a gloo mesh
decodes eagerly (``inference/engine.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels import _launch as LN

OPS = ("all-reduce", "all-gather")
TRAIN_OPS = OPS + ("reduce-scatter",)
AXES = ("model", "data", "pod", "pod+data", "data+model", "pod+data+model",
        "world")


@dataclasses.dataclass(frozen=True, eq=False)
class AxisGroup:
    """One mesh axis's process group as this rank sees it (or several
    axes': ``axis`` their names joined by "+"): its ``size``, this
    rank's ``rank`` in it and the ``backend``.  Compared and hashed by
    identity (it rides in ``RunFlags.tp``)."""
    axis: str
    group: Any
    size: int
    rank: int
    backend: str

    @property
    def staged(self) -> bool:
        """Whether CUDA tensors go through host memory (gloo)."""
        return self.backend == "gloo"

    @property
    def moves(self) -> bool:
        """Whether a call moves anything: a group of one rank moves
        nothing on gloo (NCCL is called all the same)."""
        return self.size > 1 or self.backend == "nccl"


def axis_group(mesh, axis: str) -> Optional[AxisGroup]:
    """The group of ``mesh``'s axis ``axis``, None when the mesh has no
    such axis."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return None
    g = mesh.get_group(axis)
    return AxisGroup(axis, g, dist.get_world_size(g), dist.get_rank(g),
                     str(dist.get_backend(g)))


def axes_group(mesh, axes: Sequence[str]) -> AxisGroup:
    """The group spanning ``mesh``'s axes ``axes`` (in mesh order): one
    axis's own group, the world for every axis, else a group per
    coordinate of the other axes (built once per mesh and kept on it,
    every rank creating every group, as ``new_group`` asks).  A rank's index in it
    is row-major over ``axes``, the reference's order for a composite
    axis."""
    axes = tuple(axes)
    names = tuple(mesh.mesh_dim_names)
    if list(axes) != [a for a in names if a in axes]:
        raise ValueError(f"axes {axes} are not in the mesh's order {names}")
    if len(axes) == 1:
        return axis_group(mesh, axes[0])
    made = mesh.__dict__.setdefault("_axes_groups", {})
    if axes in made:
        return made[axes]
    if axes == names:
        g = None
    else:
        ranks = mesh.mesh
        keep = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in keep]
        rows = ranks.permute(*rest, *keep).reshape(-1, int(
            torch.tensor([ranks.shape[i] for i in keep]).prod()))
        g = None
        me = dist.get_rank()
        for row in rows.tolist():
            new = dist.new_group(ranks=row)
            if me in row:
                g = new
    out = AxisGroup("+".join(axes), g, dist.get_world_size(g),
                    dist.get_rank(g), str(dist.get_backend(g)))
    made[axes] = out
    return out


def world_group(mesh) -> Optional[AxisGroup]:
    """Every rank of ``mesh``'s process group (the world), for the
    continuous engine's host agreement (``agree``) and the training
    step's gradient norm; None without a mesh."""
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


# -- the record (the dry run's accounting) -----------------------------------


@dataclasses.dataclass(frozen=True)
class Issued:
    """One collective as it was issued: ``op``, the mesh ``axis`` (the
    counters' name), the group's ``size`` and world ``ranks``, and
    ``payload_bytes``, the per-device output (the reference's
    definition: the whole gathered tensor, one reduce-scattered block)."""
    op: str
    axis: str
    size: int
    ranks: Tuple[int, ...]
    payload_bytes: int


# the open record, or None: off by default, and then a call pays one test
_RECORD: List[Optional[List[Issued]]] = [None]
_RANKS: Dict[Any, Tuple[int, ...]] = {}


@contextlib.contextmanager
def recording():
    """Record every collective issued in the block, on every backend
    (``hlo_analysis.parse_collectives`` reads the list): yields the list
    of ``Issued``, in the order issued.  The previous record, if any,
    comes back on exit."""
    prev = _RECORD[0]
    _RECORD[0] = out = []
    try:
        yield out
    finally:
        _RECORD[0] = prev


def _ranks(g: AxisGroup) -> Tuple[int, ...]:
    key = ("world", g.size) if g.group is None else g.group
    if key not in _RANKS:
        _RANKS[key] = tuple(
            range(g.size) if g.group is None     # the world
            else dist.get_process_group_ranks(g.group))
    return _RANKS[key]


def _note(op: str, g: AxisGroup, numel: int, x: torch.Tensor) -> None:
    """Add the call to the open record (``numel``: the per-device
    output's elements, of ``x``'s dtype)."""
    if _RECORD[0] is not None:
        _RECORD[0].append(Issued(op, g.axis, g.size, _ranks(g),
                                 numel * x.element_size()))


# Staging (a gloo group on the card): gloo moves host memory, so a CUDA
# tensor goes through two host buffers that are kept and reused (pinned
# where there is a card: the copies run at the bus's rate, and gloo
# writes no fresh pages), and its bytes move as one all-to-all split over
# LANES gloo groups of the same ranks, all in flight at once: one gloo
# group moves ~0.35 GB/s between two processes on one host, eight ~1.4
# (``scripts/gloo_staging.py``, PERF.md §6).  An all-gather is the
# all-to-all of the input sent to every rank, a reduce-scatter the
# all-to-all of the input's blocks followed by their sum on the card.
LANES = 8
_STAGE: Dict[str, torch.Tensor] = {}
_LANES: Dict[Any, list] = {}


def _host(slot: str, like: torch.Tensor, numel: int) -> torch.Tensor:
    """``numel`` elements of ``like``'s dtype in the host buffer ``slot``
    ("send" or "recv"), grown to the next power of two of bytes when too
    small."""
    nbytes = numel * like.element_size()
    buf = _STAGE.get(slot)
    if buf is None or buf.numel() < nbytes:
        size = 1 << max(20, (nbytes - 1).bit_length())
        _STAGE[slot] = buf = torch.empty(
            size, dtype=torch.uint8, pin_memory=torch.cuda.is_available())
    return buf[:nbytes].view(like.dtype)


def _lanes(g: AxisGroup) -> list:
    """``LANES`` gloo groups over ``g``'s ranks, made at the group's first
    staged transfer (only its ranks take part: every one of them is in
    that transfer)."""
    key = "world" if g.group is None else g.group
    if key not in _LANES:
        ranks = (list(range(dist.get_world_size())) if g.group is None
                 else dist.get_process_group_ranks(g.group))
        _LANES[key] = [dist.new_group(ranks, backend="gloo",
                                      use_local_synchronization=True)
                       for _ in range(LANES)]
    return _LANES[key]


def _exchange(x2: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    """The group's all-to-all of the rows of ``x2`` (size, m), staged:
    row q goes to rank q; returns (size, m) on ``x2``'s device, row q from
    rank q."""
    size, m = x2.shape
    lanes = _lanes(g)
    cuts = [m * j // len(lanes) for j in range(len(lanes) + 1)]
    spans = [(a, b) for a, b in zip(cuts, cuts[1:]) if b > a]
    # lane-major on the device: lane j carries columns [a, b) of each row
    send = torch.cat([x2[:, a:b].reshape(-1) for a, b in spans])
    hs = _host("send", x2, send.numel()).copy_(send)
    hr = _host("recv", x2, send.numel())
    works = [dist.all_to_all_single(hr[size * a:size * b],
                                    hs[size * a:size * b], group=lane,
                                    async_op=True)
             for lane, (a, b) in zip(lanes, spans)]
    for w in works:
        w.wait()
    recv = hr.to(x2.device)
    return torch.cat([recv[size * a:size * b].view(size, b - a)
                      for a, b in spans], dim=1)


def _staged_all_gather(src: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    """(size, n): every rank's flat ``src`` (n,), in rank order."""
    return _exchange(src.expand(g.size, src.numel()), g)


def _staged_reduce_scatter(src: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    """This rank's block of the group's sum of ``src`` (size * m,): the
    blocks exchanged, then summed on ``src``'s device in rank order."""
    return _exchange(src.view(g.size, -1), g).sum(0)


def all_reduce(x: torch.Tensor, g: AxisGroup,
               op: str = "sum") -> torch.Tensor:
    """Sum (or, with ``op="max"``, the maximum of) ``x`` over the group,
    in place; returns ``x``."""
    _count(all_reduce, g)
    _note("all-reduce", g, x.numel(), x)
    if not g.moves:
        return x
    rop = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
    if x.is_cuda and g.staged:
        h = _host("send", x, x.numel()).view(x.shape)
        h.copy_(x)
        dist.all_reduce(h, op=rop, group=g.group)
        x.copy_(h)
    else:
        dist.all_reduce(x, op=rop, group=g.group)
    return x


def all_gather(x: torch.Tensor, g: AxisGroup, dim: int = 0) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in rank order (every
    rank's ``x`` has the same shape)."""
    _count(all_gather, g)
    _note("all-gather", g, x.numel() * g.size, x)
    if not g.moves:
        return x.clone()
    dim = dim % x.dim()
    src = x.contiguous().reshape(-1)
    if x.is_cuda and g.staged:
        flat = _staged_all_gather(src, g)
    else:
        flat = torch.empty((g.size * src.numel(),), dtype=x.dtype,
                           device=src.device)
        _gather_flat(flat, src, group=g.group)
    out = flat.view(g.size, *x.shape).movedim(0, dim)
    shape = list(x.shape)
    shape[dim] *= g.size
    return out.reshape(shape)


def reduce_scatter(x: torch.Tensor, g: AxisGroup,
                   dim: int = 0) -> torch.Tensor:
    """This rank's piece (the ``g.rank``-th of ``g.size`` along ``dim``)
    of the group's sum of ``x``; ``x.shape[dim]`` must divide by the
    group size.  A new tensor."""
    _count(reduce_scatter, g)
    _note("reduce-scatter", g, x.numel() // g.size, x)
    if not g.moves:
        return x.clone()
    dim = dim % x.dim()
    if x.shape[dim] % g.size:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not divide by {g.size}")
    src = x.movedim(dim, 0).contiguous()
    shape = (src.shape[0] // g.size, *src.shape[1:])
    if x.is_cuda and g.staged:
        out = _staged_reduce_scatter(src.reshape(-1), g).view(shape)
    else:
        out = torch.empty(shape, dtype=x.dtype, device=src.device)
        dist.reduce_scatter_tensor(out, src, group=g.group)
    return out.movedim(0, dim).contiguous()


def all_to_all(x: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    """The group's all-to-all of ``x`` (size, ...): block q goes to rank
    q, and block q of the result came from rank q (the reference's
    ``jax.lax.all_to_all(x, axis, 0, 0, tiled=False)``).  A new tensor."""
    _count(all_to_all, g)
    _note("all-to-all", g, x.numel(), x)
    if x.shape[0] != g.size:
        raise ValueError(f"all_to_all: dim 0 of {tuple(x.shape)} is not "
                         f"the group size {g.size}")
    if not g.moves:
        return x.clone()
    src = x.contiguous()
    if x.is_cuda and g.staged:
        return _exchange(src.view(g.size, -1), g).view(x.shape)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=g.group)
    return out


LN.counters(all_reduce, *AXES)
LN.counters(all_gather, *AXES)
LN.counters(reduce_scatter, *AXES)
LN.counters(all_to_all, *AXES)
_FNS = {"all-reduce": all_reduce, "all-gather": all_gather,
        "reduce-scatter": reduce_scatter, "all-to-all": all_to_all}
_COUNTERS = {(op, a): (fn, a) for op, fn in _FNS.items() for a in AXES}


def snapshot() -> Dict[tuple, int]:
    """Every collective counter, {(op, axis): calls so far}."""
    return {k: getattr(fn, a) for k, (fn, a) in _COUNTERS.items()}


def count_by_axis(since: Dict[tuple, int]) -> Dict[Tuple[str, str], int]:
    """{(op, axis): collectives issued since the ``snapshot`` ``since``},
    the nonzero ones."""
    now = snapshot()
    return {k: n - since[k] for k, n in now.items() if n != since[k]}


def count_collectives(since: Dict[tuple, int],
                      axis: Optional[str] = None) -> Dict[str, int]:
    """{op: collectives issued since the ``snapshot`` ``since``}, over
    every axis or only ``axis``: the all-reduces and all-gathers always,
    the reduce-scatters where there were some (serving issues none); a
    CUDA graph's replays count as its captured collectives."""
    out = {op: 0 for op in OPS}
    for (op, a), n in count_by_axis(since).items():
        if axis is None or a == axis:
            out[op] = out.get(op, 0) + n
    return out


def kernel_collectives(prof) -> Dict[str, int]:
    """{op: NCCL kernels} of a ``torch.profiler.profile`` trace (device
    events whose name holds ``AllReduce``, ``AllGather`` or
    ``ReduceScatter``, as NCCL names its kernels; a world of one rank may
    copy instead of launching one)."""
    out = {op: 0 for op in TRAIN_OPS}
    names = {"AllReduce": "all-reduce", "AllGather": "all-gather",
             "ReduceScatter": "reduce-scatter"}
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
                                steps: int = 1,
                                all_reduces: Optional[int] = None
                                ) -> Dict[str, int]:
    """Raise AssertionError unless ``counts`` (``count_collectives`` over
    ``steps`` pure-tp decode steps) is the budget: 2 * n_layers + 1
    all-reduces (``all_reduces`` a step where given: an arch with cross
    sub-layers, ``sharding.tp_decode_all_reduces``) and 1 all-gather a
    step, and no other collective.  Returns ``counts``."""
    per = 2 * n_layers + 1 if all_reduces is None else all_reduces
    expect = {"all-reduce": per * steps, "all-gather": steps}
    why = {"all-reduce": f"{per} a step: each layer's contracting products "
                         "(attention out-proj, a cross sub-layer's, MLP "
                         "down-proj; RWKV6's wo and FFN wv), and the "
                         "vocab-sharded embedding lookup",
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


def check_train_collectives(counts: Dict[Tuple[str, str], int],
                            budget: Dict[Tuple[str, str], int]
                            ) -> Dict[Tuple[str, str], int]:
    """Raise AssertionError unless ``counts`` (``count_by_axis`` over
    training steps) equals ``budget`` (``TrainPlan.collective_budget``,
    the module docstring's table) op for op and axis for axis, naming
    every (op, axis) that differs.  Returns ``counts``."""
    keys = sorted(set(counts) | set(budget))
    bad = [f"{op} over {a}: {counts.get((op, a), 0)} != "
           f"{budget.get((op, a), 0)}" for op, a in keys
           if counts.get((op, a), 0) != budget.get((op, a), 0)]
    if bad:
        raise AssertionError("training collectives off budget: "
                             + "; ".join(bad))
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


# -- collectives with a gradient (training) -----------------------------------


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(), ctx.g), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        return all_reduce(x.clone(), g)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return all_gather(x, g, 1)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad, ctx.g, 1), None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return reduce_scatter(x, g, 1)

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad, ctx.g, 1), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return all_to_all(x, g)

    @staticmethod
    def backward(ctx, grad):
        return all_to_all(grad, ctx.g), None


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, grad_scale):
        ctx.scale = grad_scale
        return all_reduce(x.clone(), g).div_(g.size)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None, None


class _FSDPGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, g, dim):
        ctx.g, ctx.dim = g, dim
        return all_gather(w, g, dim)

    @staticmethod
    def backward(ctx, grad):
        return (reduce_scatter(grad, ctx.g, ctx.dim).div_(ctx.g.size),
                None, None)


def copy_to_tp(x: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    """``x`` unchanged; its gradient is summed over ``g`` (the input of
    a column-parallel product, whose ranks each give a partial one)."""
    return _CopyToTP.apply(x, g)


def reduce_from_tp(x: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    """The sum of ``x`` over ``g`` (a row-parallel product's partial
    sums); its gradient passes unchanged to every rank's part."""
    return _ReduceFromTP.apply(x, g)


def gather_seq(x: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    """(B, S/n, ...) sequence shards -> the whole (B, S, ...) on every
    rank; the gradient is reduce-scattered back to the shards."""
    return _GatherSeq.apply(x, g)


def replicated_input(x: torch.Tensor, g: Optional[AxisGroup]
                     ) -> torch.Tensor:
    """``x`` unchanged for a consumer that every rank of ``g`` computes
    alike (the DSA predictor on a tensor-parallel layer's input): its
    gradient is divided by the group size, so that the sum over the group
    that ``tp_enter``'s backward makes counts it once.  ``g`` None: ``x``."""
    return x if g is None else _ScaleGrad.apply(x, 1.0 / g.size)


def scatter_seq(x: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    """The sum of ``x`` (B, S, ...) over ``g``, each rank keeping its
    (B, S/n, ...) sequence shard; the gradient is all-gathered."""
    return _ScatterSeq.apply(x, g)


def exchange(x: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    """``all_to_all`` with a gradient: the all-to-all is its own adjoint,
    so the gradient goes back by the same exchange (expert parallelism's
    dispatch and return)."""
    return _AllToAll.apply(x, g)


def mean_over(x: torch.Tensor, g: AxisGroup,
              grad_scale: float) -> torch.Tensor:
    """The mean of ``x`` over ``g`` (one all-reduce); its gradient is the
    incoming one times ``grad_scale`` on each rank's own ``x``: 1 / size
    where the group's ranks compute one loss between them (tensor
    parallelism), 1 where each rank's loss is its own and the step
    averages them (the group is a batch axis)."""
    return _MeanOver.apply(x, g, grad_scale)


def fsdp_gather(w: torch.Tensor, g: AxisGroup, dim: int) -> torch.Tensor:
    """A leaf's shard -> its whole along ``dim`` (FSDP); the gradient is
    reduce-scattered back and divided by the group size (the mean over
    the batch shards)."""
    return _FSDPGather.apply(w, g, dim)


def tp_enter(x: torch.Tensor, tp: Optional[AxisGroup], *, train: bool,
             sp: bool) -> torch.Tensor:
    """A tensor-parallel layer's input: under sequence parallelism the
    all-gathered sequence, else ``x``, its gradient summed over "model"
    either way (training only; serving and ``tp`` None: ``x``)."""
    if tp is None or not train:
        return x
    return gather_seq(x, tp) if sp else copy_to_tp(x, tp)


def tp_exit(y: torch.Tensor, tp: Optional[AxisGroup], *, train: bool,
            sp: bool) -> torch.Tensor:
    """A row-parallel layer's partial output summed over "model": in
    place when serving, with a gradient in training, and
    reduce-scattered over the sequence under sequence parallelism."""
    if tp is None:
        return y
    if not train:
        return all_reduce(y, tp)
    return scatter_seq(y, tp) if sp else reduce_from_tp(y, tp)


def tp_psum(x: torch.Tensor, tp: Optional[AxisGroup], *,
            train: bool) -> torch.Tensor:
    """The sum over "model" of partial products whose whole every rank
    then feeds only its own channels with (Mamba's ``x_proj`` output):
    one all-reduce forward and, in training, one of the gradient
    backward, each rank holding only its channels' part of it (``tp``
    None: ``x``)."""
    if tp is None:
        return x
    if not train:
        return all_reduce(x, tp)
    return copy_to_tp(reduce_from_tp(x, tp), tp)


def fsdp_gather_tree(tree, prefix: str, gathers: Dict[str, tuple],
                     slices: Optional[Dict[str, tuple]] = None):
    """``tree`` (the leaves at ``prefix``, the paths of
    ``tree.named_leaves``) with each leaf's data-sharded dimensions
    gathered (``gathers``: {path: ((dim, AxisGroup), ...)}, a
    ``TrainPlan``'s), then cut to ``slices`` ({path: (dim, start,
    width)}: a rank's KV head where tp exceeds the KV heads, the plan's
    ``kv_slices``)."""
    if isinstance(tree, dict):
        return {k: fsdp_gather_tree(v, f"{prefix}/{k}", gathers, slices)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [fsdp_gather_tree(v, f"{prefix}/{i}", gathers, slices)
                for i, v in enumerate(tree)]
    for dim, g in gathers.get(prefix, ()):
        tree = fsdp_gather(tree, g, dim)
    if slices and prefix in slices:
        tree = tree.narrow(*slices[prefix])
    return tree
