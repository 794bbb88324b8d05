"""Logical-axis sharding rules resolved against a mesh of processes (the
port of the reference's ``repro/distributed/sharding.py``).

Weights, caches and activations are described by *logical* axis names
(the spec trees of ``models/transformer.model_param_specs`` and
``unstacked_cache_specs``); a rule table maps logical axes to the mesh
axes of a ``torch.distributed.device_mesh.DeviceMesh``.  ``resolve_spec``
drops a mesh axis that does not divide the dimension (that dimension
stays whole; it never raises) and never uses a mesh axis twice in one
spec, as the reference's does, so one rule table serves every arch.

Placement is explicit: the port runs one process per device (SPMD over
processes), and ``shard_put`` slices this rank's local shard out of a
tensor before it moves to the device.  A serving engine or a training
state on a mesh takes the weights piece by piece as ``init_model`` draws
them (its ``place``), so a rank's card holds its shard and at most one
piece of the tree whole, never the whole tree.  The reference's
``shard()`` activation constraint has no counterpart: the port's layers
place their collectives themselves (``distributed/collectives.py``),
and take their groups through ``RunFlags`` (``tp``, ``sp``, ``fsdp``).

The reference's rule context is ported for callers written against its
API: ``set_rules``/``get_rules``, ``rules_context`` (restores the
previous table) and ``compute_context(mesh, rules)``, which
``resolve_spec`` and ``tree_specs`` fall back on when given no rules
or mesh.  No layer reads it.

The tables:
  ``make_serving_rules`` (the serving engines):
    DP : "batch" -> "data" (the static batch rows, the resident slots)
    TP : "heads"/"kv_heads"/"mlp"/"vocab"/"expert" -> "model"
  ``make_rules`` (training, the reference's, field for field):
    DP   : "batch" -> ("pod",) "data"
    FSDP : "embed" -> "data" (ZeRO-3: weights, gradients and AdamW
           moments sharded)
    TP   : "heads"/"kv_heads"/"mlp"/"vocab" -> "model"
    SP   : the residual stream's "seq_sp" -> "model" between blocks
    logits' "vocab_act" -> "model"
    ``tp=False``: batch and weights over every axis, vocab over "model".

``TrainPlan`` is a training run's layout on a mesh: which dimensions of
each leaf are gathered before use (those split over the rule's batch
axes, FSDP's role), which are computed locally (those split over a
"model" axis that holds no batch rows: tensor parallelism), and how
each gradient is reduced so that it is the matching shard of the
unsharded gradient.  An MoE layer takes the reference's
expert-parallel dispatch where its gate holds (``moe_ep``, a "model"
axis above 1 that divides E and the sequence): each rank routes its own
rows and two all-to-alls over "model" carry them to the experts' ranks
and back (``models/moe.py``, ``EPContext``), under ``make_rules()``
beside tensor parallelism and under ``make_rules(tp=False)`` with
"model" a batch axis.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.distributed import collectives as C

Axis = Union[None, str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    batch: Axis = "data"
    seq: Axis = None              # activation seq inside blocks (replicated)
    seq_sp: Axis = "model"        # residual-stream sequence parallelism
    cache_seq: Axis = None        # KV-cache seq; "data" for long-context decode
    embed: Axis = "data"          # FSDP weight shard axis
    embed_act: Axis = None        # activation d_model axis
    mlp: Axis = "model"
    heads: Axis = "model"
    kv_heads: Axis = "model"
    qkv: Axis = None              # head_dim
    vocab: Axis = "model"
    vocab_act: Axis = "model"     # logits activation vocab axis
    expert: Axis = "model"
    lora: Axis = None
    state: Axis = None
    conv: Axis = None
    layers: Axis = None           # the reference's stacked layer axis
    pred_k: Axis = None           # DSA projection dim
    blocks: Axis = None           # DSA block indices
    pages: Axis = None            # paged-cache physical page pool rows
    moe_ep: bool = True           # expert-parallel dispatch (training)

    def axis(self, name: Optional[str]) -> Axis:
        if name is None:
            return None
        return getattr(self, name)


def make_rules(*, multi_pod: bool = False, fsdp: bool = True,
               seq_parallel: bool = True, long_context: bool = False,
               fsdp_pod: bool = False, tp: bool = True,
               cache_axis: Axis = "auto") -> ShardingRules:
    """The training rule table, the reference's field for field.

    ``fsdp_pod``: shard the weights over the pod axis too.  ``cache_axis``:
    the KV cache's sequence axis ("auto": "model", or ("data", "model")
    with ``long_context``).  ``tp=False``: pure FSDP/DP, the batch and
    the weights over every axis, no tensor parallelism; the vocab stays
    on "model" (the embedding and head gradients would otherwise be
    all-reduced whole)."""
    if cache_axis == "auto":
        cache_axis = ("data", "model") if long_context else "model"
    if not tp:
        both = (("pod", "data", "model") if multi_pod
                else ("data", "model"))
        return ShardingRules(
            batch=both, embed=both if fsdp else None, seq_sp=None,
            mlp=None, heads=None, kv_heads=None, expert=None,
            vocab="model", cache_seq=cache_axis)
    batch: Axis = ("pod", "data") if multi_pod else "data"
    embed: Axis = None
    if fsdp:
        embed = ("pod", "data") if (multi_pod and fsdp_pod) else "data"
    return ShardingRules(batch=batch, embed=embed,
                         seq_sp="model" if seq_parallel else None,
                         cache_seq=cache_axis)


def make_serving_rules(*, tp: bool = False) -> ShardingRules:
    """Rule table of the serving engines: data parallelism over the
    batch (slots) axis, and with ``tp`` tensor parallelism over "model".

    ``tp=False``: weights stay replicated and each rank computes its own
    rows whole, so a row's arithmetic is the unsharded row's (in row
    counts of B / dp).  ``tp=True``: Q/K/V/O shard over heads and
    kv_heads, the MLP and the experts over mlp/expert, the embedding and
    the lm head over vocab; the KV cache, its quantization scales and
    the paged pool rows shard their head axis with them.  The port's
    layers add one all-reduce after each contracting product (the
    attention's out-projection, the MLP's down-projection, the MoE
    combine) and one after the vocab-sharded embedding lookup, and
    all-gather the logits before sampling.  The DSA predictor's weights
    and the ``kt``/``ktb`` caches have no head axis and stay replicated,
    so every shard computes the same block top-k and gathers its own
    heads' rows.  ``moe_ep`` is off: the capacity path serves, as
    unsharded.  The page pool is whole on every data rank (``pages``
    None: a rank's slots write the pool rows its page table names, and
    every rank keeps the same pool account), where the reference splits
    its rows over "data".  The reference's ``long_context`` rules shard
    the cache's sequence axis (``cache_seq``), which the port does not
    serve: ``ServingConfig`` refuses them.
    """
    return ShardingRules(
        batch="data", seq=None, seq_sp=None,
        cache_seq=None,
        embed=None, embed_act=None,
        mlp="model" if tp else None,
        heads="model" if tp else None,
        kv_heads="model" if tp else None,
        qkv=None,
        vocab="model" if tp else None,
        vocab_act=None,
        expert="model" if tp else None,
        pages=None,
        moe_ep=False)


def kv_group(cfg, tp: int) -> int:
    """Ranks of a ``tp``-way "model" axis that share one KV head: tp /
    n_kv_heads where tp is a multiple of n_kv_heads above it and divides
    n_heads (the reference's ``resolve_spec`` leaves such a cache's KV
    heads whole, and each query head still attends its group's), 1
    otherwise.  Rank r then computes query heads r hq_l ... (r + 1) hq_l
    - 1 (hq_l = n_heads / tp) on the one KV head of their group,
    ``kv_head(cfg, tp, r)``."""
    tp, n_kv = int(tp), cfg.n_kv_heads
    if tp > n_kv and tp % n_kv == 0 and cfg.n_heads % tp == 0:
        return tp // n_kv
    return 1


def kv_head(cfg, tp: int, rank: int) -> int:
    """The KV head that rank ``rank`` of a ``tp``-way "model" axis
    computes with: floor(rank hq_l / (n_heads / n_kv_heads)), where
    ``kv_group`` is above 1."""
    return rank // kv_group(cfg, tp)


def kv_rules(rules: ShardingRules) -> ShardingRules:
    """``rules`` with the KV weights whole over "model": where tp exceeds
    the KV heads (``kv_group``) each rank takes its head's slice of the
    whole leaf (the reference's ``resolve_spec`` would split their
    columns over "model", a quarter head a rank at yi_6b's tp 16, and
    let GSPMD gather them)."""
    return dataclasses.replace(rules, kv_heads=None)


def serving_tp_issues(cfg, tp: int) -> list:
    """Names of the logical weight axes whose dims do NOT divide a
    ``tp``-way "model" axis (empty: ``cfg`` shards cleanly).  Shared by
    ``launch.mesh.make_serving_mesh`` (an up-front ``ValueError`` naming
    the axis), ``inference.engine.Engine`` (the fallback to replicated
    weights) and ``make_train_plan``.  KV heads pass where tp divides
    them or is a multiple of them that divides the query heads
    (``kv_group``).  A cross-attention sub-layer has the self-attention's
    heads and KV heads, so the same checks cover it; RWKV6's heads are
    its ``n_heads`` (d_model / rwkv.head_dim, ``ssm.init_rwkv`` checks);
    MLA has heads and no KV heads; Mamba's inner width (d_model *
    expand) and the shared experts' (d_ff_expert * num_shared_experts)
    lie over "mlp" too.
    vocab is not checked: a vocab that does not divide leaves the
    embedding and the head replicated.  The reference leaves an axis that tp does not divide
    whole and shards the others; the port refuses such a tp (ROADMAP
    Queue 1, "Distribution", per-dimension replication)."""
    tp = int(tp)
    if tp <= 1:
        return []
    issues = []
    if cfg.n_heads % tp:
        issues.append(f'heads (n_heads={cfg.n_heads} % tp={tp} != 0)')
    n_kv = getattr(cfg, "n_kv_heads", None) or cfg.n_heads
    # RWKV6 and MLA have no KV heads (MLA's latent is whole on every rank)
    if (cfg.rwkv is None and cfg.mla is None and n_kv % tp
            and tp % n_kv):
        issues.append(f'kv_heads (n_kv_heads={n_kv} and tp={tp}: neither '
                      f'divides the other)')
    if cfg.d_ff % tp:
        issues.append(f'mlp (d_ff={cfg.d_ff} % tp={tp} != 0)')
    if cfg.mamba is not None and cfg.d_model * cfg.mamba.expand % tp:
        issues.append(f'mlp (Mamba d_inner={cfg.d_model * cfg.mamba.expand}'
                      f' % tp={tp} != 0)')
    moe = getattr(cfg, "moe", None)
    if moe is not None:
        d_ff_e = getattr(moe, "d_ff_expert", None) or cfg.d_ff
        if moe.num_experts % tp and d_ff_e % tp:
            issues.append(
                f'expert (num_experts={moe.num_experts} and '
                f'd_ff_expert={d_ff_e}, neither % tp={tp} == 0)')
        fs = d_ff_e * moe.num_shared_experts
        if fs % tp:
            issues.append(f"mlp (shared experts' d_ff={fs} % tp={tp} != 0)")
    return issues


def tp_decode_all_reduces(cfg) -> int:
    """The all-reduces over "model" of one tensor-parallel decode step:
    one a contracting product of each layer (the attention's or MLA's
    out-projection, a cross sub-layer's, the MLP's down-projection or
    the MoE combine with its shared experts; RWKV6's time-mix ``wo`` and
    FFN ``wv``; Mamba's ``x_proj`` and ``out_proj``, 3 a Mamba sub-block
    with its MLP or MoE) and one after the vocab-sharded embedding
    lookup."""
    from repro_torch.models import blocks as B
    per_group = sum(2 + d.cross + (d.kind == "mamba")
                    for d in B.group_defs(cfg))
    return B.n_groups(cfg) * per_group + 2 * B.n_prologue(cfg) + 1


def shard_config(cfg, tp: int):
    """The geometry one rank of a ``tp``-way "model" axis computes:
    n_heads / tp query heads and n_kv_heads / tp KV heads (so the GQA
    group G is unchanged), or one KV head where tp exceeds them
    (``kv_group``: G is n_heads / tp), d_ff / tp, head_dim made
    explicit, and a Mamba layer's d_model * expand / tp inner channels
    (``configs.base.MambaShard``, ``models.ssm.d_inner``).  An MoE keeps
    routing over all its experts: a layer reads its local experts off
    its weights (``models/moe.py``).  tp 1 returns ``cfg``."""
    if tp == 1:
        return cfg
    from repro_torch.configs.base import MambaConfig, MambaShard
    n_kv = cfg.n_kv_heads // tp if kv_group(cfg, tp) == 1 else 1
    mamba = cfg.mamba
    if mamba is not None:
        mamba = MambaShard(tp=tp, **{f.name: getattr(mamba, f.name)
                                     for f in dataclasses.fields(
                                         MambaConfig)})
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp,
                               n_kv_heads=n_kv,
                               d_ff=cfg.d_ff // tp,
                               head_dim=cfg.resolved_head_dim, mamba=mamba)


# the reference's rule context: installed by callers written against its
# API; resolve_spec and tree_specs fall back on it, no layer reads it
_RULES = ShardingRules()
_MESH: List[Any] = [None]


def set_rules(rules: ShardingRules) -> None:
    global _RULES
    _RULES = rules


def get_rules() -> ShardingRules:
    return _RULES


@contextlib.contextmanager
def rules_context(rules: ShardingRules):
    """Install ``rules`` for the block; the previous table comes back on
    exit, an exception's too."""
    global _RULES
    prev = _RULES
    _RULES = rules
    try:
        yield
    finally:
        _RULES = prev


@contextlib.contextmanager
def compute_context(mesh, rules: Optional[ShardingRules] = None):
    """Install ``mesh`` (and ``rules``) for the block, as the mesh and the
    table ``resolve_spec`` and ``tree_specs`` fall back on; a no-op when
    ``mesh`` is None."""
    if mesh is None:
        yield
        return
    with contextlib.ExitStack() as stack:
        if rules is not None:
            stack.enter_context(rules_context(rules))
        prev = _MESH[0]
        _MESH[0] = mesh
        stack.callback(_MESH.__setitem__, 0, prev)
        yield


def current_mesh():
    """The mesh ``compute_context`` installed, or None."""
    return _MESH[0]


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def resolve_spec(shape: Tuple[int, ...], logical: Tuple[Optional[str], ...],
                 rules: Optional[ShardingRules] = None,
                 mesh=None) -> Tuple[Axis, ...]:
    """Map logical axes to mesh axes, one entry per dimension (None: the
    dimension is whole on every rank; a name or a tuple of names: it is
    split over those axes in order), enforcing divisibility and one use
    per mesh axis.  ``rules`` and ``mesh`` default to those of the rule
    context (``compute_context``); with no mesh every entry is None."""
    if len(shape) != len(logical):
        raise ValueError(f"shape {shape} and logical spec {logical} differ "
                         f"in rank")
    rules = rules or _RULES
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return (None,) * len(shape)
    sizes = mesh_axis_sizes(mesh)
    used: set = set()
    out = []
    for dim, name in zip(shape, logical):
        ax = rules.axis(name)
        if ax is None:
            out.append(None)
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        picked = []
        prod = 1
        for a in axes:
            if a in used or a not in sizes:
                continue
            if dim % (prod * sizes[a]) == 0:
                picked.append(a)
                prod *= sizes[a]
        used.update(picked)
        out.append(None if not picked else
                   picked[0] if len(picked) == 1 else tuple(picked))
    return tuple(out)


class Halves(tuple):
    """A logical spec (equal to the plain tuple of its axis names) whose
    "mlp" dimension is two halves laid side by side: Mamba's ``in_proj``,
    [x | z].  A rank's piece of that dimension is its piece of each half,
    [x_r | z_r] (``halves_of``, ``local_shard``), where a plain split
    would give rank 0 all of x and rank 1 all of z at tp 2.  The
    reference gets this from GSPMD, which reshards its slice
    ``xz[..., :mi]``; the whole leaf, a checkpoint's, keeps its
    layout."""


def halves_of(logical) -> Tuple[int, ...]:
    """The dimensions of a logical spec that are two halves (its "mlp"
    dimension where it is a ``Halves``), () otherwise."""
    if not isinstance(logical, Halves):
        return ()
    return tuple(i for i, name in enumerate(logical) if name == "mlp")


def is_spec_leaf(x) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def map_specs(f, spec_tree):
    """``f`` over every leaf (logical-axis tuple) of a spec tree."""
    if is_spec_leaf(spec_tree):
        return f(spec_tree)
    if isinstance(spec_tree, dict):
        return {k: map_specs(f, v) for k, v in spec_tree.items()}
    return [map_specs(f, v) for v in spec_tree]


def tree_specs(param_tree, logical_tree, rules: Optional[ShardingRules] = None,
               mesh=None):
    """The resolved axes (``resolve_spec``, one entry per dimension) of
    every leaf of ``param_tree`` (tensors, meta tensors included, or
    anything with a ``shape``) under its logical spec."""
    return _map2(lambda p, log: resolve_spec(tuple(p.shape), tuple(log),
                                             rules, mesh),
                 param_tree, logical_tree)


def _map2(f, tree, specs):
    """``f(leaf, spec)`` over a tensor tree and its parallel spec tree."""
    if is_spec_leaf(specs):
        return f(tree, specs)
    if isinstance(specs, dict):
        if set(tree) != set(specs):
            raise ValueError(f"tree keys {sorted(tree)} != spec keys "
                             f"{sorted(specs)}")
        return {k: _map2(f, tree[k], specs[k]) for k in specs}
    if len(tree) != len(specs):
        raise ValueError(f"tree length {len(tree)} != spec length "
                         f"{len(specs)}")
    return [_map2(f, t, s) for t, s in zip(tree, specs)]


# -- placement (serving engines) ---------------------------------------------


def _coord(mesh, axes: Tuple[str, ...]) -> Tuple[int, int]:
    """(index, count) of this rank's piece along a dimension split over
    ``axes`` (row-major over them, as the reference's composite axes)."""
    sizes = mesh_axis_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    idx, n = 0, 1
    for a in axes:
        idx = idx * sizes[a] + coord[a]
        n *= sizes[a]
    return idx, n


def local_shard(x: torch.Tensor, spec: Tuple[Axis, ...], mesh,
                halves: Tuple[int, ...] = ()) -> torch.Tensor:
    """This rank's piece of ``x`` under a resolved ``spec``: each split
    dimension cut into equal pieces, the piece at this rank's mesh
    coordinate kept (a view).  A dimension in ``halves`` (``halves_of``)
    is cut half by half, the rank's piece of each kept side by side (a
    copy)."""
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        idx, n = _coord(mesh, (ax,) if isinstance(ax, str) else tuple(ax))
        if dim in halves:
            half = x.shape[dim] // 2
            step = half // n
            x = torch.cat([x.narrow(dim, h * half + idx * step, step)
                           for h in (0, 1)], dim)
            continue
        step = x.shape[dim] // n
        x = x.narrow(dim, idx * step, step)
    return x


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def shard_put(x, *logical, mesh, rules: ShardingRules,
              device=None, kv_head: Optional[Tuple[int, int]] = None,
              halves: Tuple[int, ...] = ()) -> torch.Tensor:
    """This rank's shard of one array, sliced before it moves to
    ``device`` (contiguous there, and never a view of the whole).
    ``kv_head`` (index, width): each "kv_heads" dimension is cut to that
    head's ``width`` entries (a rank's KV head where tp exceeds them,
    under ``kv_rules``).  ``halves``: the dimensions cut half by half
    (``halves_of`` the leaf's spec)."""
    x = _as_tensor(x)
    spec = resolve_spec(tuple(x.shape), tuple(logical), rules=rules,
                        mesh=mesh)
    out = local_shard(x, spec, mesh, halves)
    if kv_head is not None:
        for dim, name in enumerate(logical):
            if name == "kv_heads":
                out = out.narrow(dim, kv_head[0] * kv_head[1], kv_head[1])
    out = out.to(device).contiguous()
    cut = kv_head is not None or any(a is not None for a in spec)
    if cut and not is_fake(out) and (
            out.untyped_storage().data_ptr()
            == x.untyped_storage().data_ptr()):
        out = out.clone()         # a shard must not keep the whole alive
    return out


def shard_put_tree(tree, logical_tree, mesh, rules: ShardingRules,
                   device=None, kv_head: Optional[Tuple[int, int]] = None):
    """``shard_put`` over a tree of arrays and its parallel logical-spec
    tree (a ``Halves`` leaf cut half by half)."""
    return _map2(lambda x, log: shard_put(x, *log, mesh=mesh, rules=rules,
                                          device=device, kv_head=kv_head,
                                          halves=halves_of(log)),
                 tree, logical_tree)


def replicate_put(tree, device=None):
    """Every leaf whole on this rank's ``device`` (a replicated leaf needs
    no mesh coordinate)."""
    if isinstance(tree, dict):
        return {k: replicate_put(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [replicate_put(v, device) for v in tree]
    return _as_tensor(tree).to(device)


def tree_bytes(tree) -> int:
    """Bytes of every tensor of a tree (this rank's shard shapes)."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()



# -- training on a mesh --------------------------------------------------------


def _axes(ax: Axis) -> Tuple[str, ...]:
    return () if ax is None else (ax,) if isinstance(ax, str) else tuple(ax)


def _flat_specs(tree, specs, prefix: str = "") -> Dict[str, Any]:
    """{leaf path (``tree.named_leaves``'s): its spec} over a tensor tree
    and its parallel spec tree, in the tensor tree's order."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_specs(v, specs[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat_specs(v, specs[i], f"{prefix}/{i}"))
        return out
    return {prefix: specs}


# a leaf under SP whose gradient is summed over "model": a norm's scale,
# applied to this rank's sequence rows (the reference's "embed_act" leaves),
# and a cross sub-layer's gate, which scales them
_SEQ_PARTIAL = ("embed_act",)


def _seq_partial(path: str, logical: tuple) -> bool:
    return tuple(logical) == _SEQ_PARTIAL or path.endswith("/xgate")


def _tp_partial(cfg, path: str) -> bool:
    """Whether ``path`` is a leaf that each rank holds whole but feeds
    only its part of under tensor parallelism (RWKV6's ``ssm.TP_PARTIAL``
    leaves, MLA's ``attention.MLA_PARTIAL``), its gradient summed over
    "model" a step."""
    from repro_torch.models.attention import MLA_PARTIAL
    from repro_torch.models.ssm import TP_PARTIAL
    tail = tuple(path.split("/")[-2:])
    if cfg.rwkv is not None:
        return tail in TP_PARTIAL
    return cfg.mla is not None and tail in MLA_PARTIAL


@dataclasses.dataclass(eq=False)
class TrainPlan:
    """A training run's layout on a mesh (``make_train_plan``).

    Each leaf dimension that the rules split is either gathered before use
    (its mesh axes are batch axes of the rules: FSDP's "embed" -> "data",
    and every axis under ``make_rules(tp=False)``; ``gathers``) or
    computed where it lies (a "model" axis holding no batch rows: tensor
    parallelism, ``tp``, with ``cfg`` the shard's geometry).  The
    gradients come out of the backward pass as this rank's shards:
    reduce-scattered (a mean) over a gathered dimension's axes by the
    gather's backward, and, per step, averaged over the batch axes no
    reduce-scatter covered (``buckets``: norms, biases, the predictor's
    square matrices, a dimension that does not divide); under sequence
    parallelism the norms' gradients are summed over "model" too
    (``norms``: their rows were sequence shards).  Where tp exceeds the
    KV heads (``kv_group``) the KV leaves are whole over "model" (the
    plan resolves them under ``kv_rules``), each rank computes with its
    head's slice (``kv_slices``: {path: (dim, start, width)}, taken
    after the FSDP gather) and feeds only that slice, so their gradients
    are summed over "model" a step: each head's is the sum over the
    ranks that share it.  RWKV6's and MLA's leaves that each rank holds
    whole but feeds only its heads or mlp columns with (``ssm.TP_PARTIAL``,
    ``attention.MLA_PARTIAL``: ``partials``) are summed over "model" a
    step, SP or not; a cross sub-layer's gate ``xgate`` joins the norms
    under SP.  Every rank then holds the matching shard of the unsharded
    gradient.  ``halves``: {path: dims} of the ``Halves`` leaves, whose
    pieces ``shard`` and ``whole`` take half by half.

    Mixture of experts: where the reference's EP gate holds (``ep``, the
    "model" group; ``ep_active``), ``run_flags`` gives an MoE layer the
    batch's ``models.moe.EPContext``.  Under tensor parallelism the
    expert leaves' "expert" dimension lies over "model" (a rank's E / tp
    experts, computed locally); under ``make_rules(tp=False)`` they are
    gathered whole like any FSDP leaf and a rank slices its E / n
    experts (the slice's gradient is zero elsewhere, and the gather's
    reduce-scatter adds the ranks').  The routers' gradients under tensor
    parallelism are each rank's part (its rows, or its experts' pairs),
    summed over "model" a step (``routers``).  The router term's value
    is data shard 0's under EP (``reduce_metrics``), as the reference's
    shard_map returns it (ROADMAP Queue 3)."""
    cfg: Any
    mesh: Any
    rules: ShardingRules
    axes: Dict[str, Tuple[Axis, ...]]
    gathers: Dict[str, tuple]
    tp: Optional[C.AxisGroup]
    batch: Optional[C.AxisGroup]
    world: C.AxisGroup
    buckets: List[Tuple[C.AxisGroup, List[str]]]
    norms: List[str]
    replicas: Dict[str, int]
    frozen: Tuple[str, ...]
    routers: List[str] = dataclasses.field(default_factory=list)
    kv_slices: Dict[str, Tuple[int, int, int]] = dataclasses.field(
        default_factory=dict)
    partials: List[str] = dataclasses.field(default_factory=list)
    halves: Dict[str, Tuple[int, ...]] = dataclasses.field(
        default_factory=dict)
    ep: Optional[C.AxisGroup] = None
    batch_ranks: int = 1
    # under EP, the router term's factor in the metrics' mean: the data
    # shards' count on data shard 0's ranks, 0 on the others
    aux_scale: Optional[int] = None

    def ep_active(self, seq_len: int) -> bool:
        """Whether an MoE layer takes the expert-parallel dispatch on a
        ``seq_len``-token batch: the reference's gate (``moe_ep``, a
        "model" axis above 1 that divides E, checked by
        ``make_train_plan``, and the sequence)."""
        return self.ep is not None and seq_len % self.ep.size == 0

    def seq_parallel(self, seq_len: int) -> bool:
        """Whether the residual stream of a ``seq_len``-token batch is
        split over "model" ("seq_sp" resolves to it: SP needs the
        sequence to divide by tp)."""
        return self.tp is not None and resolve_spec(
            (seq_len,), ("seq_sp",), self.rules, self.mesh) == ("model",)

    def run_flags(self, flags, seq_len: int, rows: int):
        """``flags`` with this plan's groups, for a global batch of
        ``rows`` x ``seq_len`` tokens (a microbatch's), with its
        ``EPContext`` where the EP gate holds."""
        from repro_torch.models.moe import EPContext, ep_cap
        sp = self.seq_parallel(seq_len)
        ep = None
        if self.ep_active(seq_len):
            ep = EPContext(self.ep, ep_cap(self.cfg, rows, self.batch_ranks,
                                           seq_len, self.ep.size),
                           tp=self.tp is not None,
                           replicated=self.tp is not None and not sp)
        return dataclasses.replace(flags, tp=self.tp, fsdp=self, sp=sp,
                                   ep=ep)

    def local_rows(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's rows of a (global) batch: axis 0 split over the
        batch axes that divide it (the others hold the same rows)."""
        n = len(next(iter(batch.values())))
        spec = resolve_spec((n,), ("batch",), self.rules, self.mesh)
        return {k: local_shard(_as_tensor(v), spec + (None,) * (
            np.ndim(v) - 1), self.mesh) for k, v in batch.items()}

    def place(self, device=None):
        """``init_model``'s ``place``: this rank's shard of each piece."""
        return lambda piece, specs: shard_put_tree(piece, specs, self.mesh,
                                                   self.rules, device)

    def shard(self, whole: torch.Tensor, path: str) -> torch.Tensor:
        """This rank's shard of the whole leaf at ``path`` (a param's
        path, or its moment's; a ``Halves`` leaf's piece of each half)."""
        return local_shard(whole, self.axes[path], self.mesh,
                           self.halves.get(path, ()))

    def whole(self, t: torch.Tensor, path: str) -> torch.Tensor:
        """The whole leaf from every rank's shard ``t`` (an all-gather a
        split dimension, each half's pieces side by side in a ``Halves``
        leaf; a checkpoint's, outside the step's budget)."""
        for dim, ax in enumerate(self.axes[path]):
            if not _axes(ax):
                continue
            g = C.axes_group(self.mesh, _axes(ax))
            if dim in self.halves.get(path, ()):
                t = C.all_gather(t.unflatten(dim, (2, -1)), g,
                                 dim + 1).flatten(dim, dim + 1)
            else:
                t = C.all_gather(t, g, dim)
        return t

    def reduce_grads(self, grads: Dict[str, torch.Tensor],
                     sp: bool) -> None:
        """The step's gradient reductions, in place on ``grads`` ({path:
        gradient}): one all-reduce (a mean) over each bucket's batch axes,
        and one (a sum) over "model" of the routers', the shared KV
        leaves', RWKV6's and MLA's partial leaves' and, with ``sp``, the
        norms'."""
        def flat(paths, g, mean):
            if not paths:
                return
            buf = torch.cat([grads[p].float().reshape(-1) for p in paths])
            C.all_reduce(buf, g)
            if mean and g.size > 1:
                buf.div_(g.size)
            i = 0
            for p in paths:
                n = grads[p].numel()
                grads[p].copy_(buf[i:i + n].view_as(grads[p]))
                i += n
        for g, paths in self.buckets:
            flat(paths, g, True)
        flat((self.norms if sp else []) + self.routers
             + list(self.kv_slices) + self.partials, self.tp, False)

    def reduce_metrics(self, metrics: Dict[str, torch.Tensor],
                       ep: bool = False) -> Dict[str, torch.Tensor]:
        """The metrics' means over the batch axes (one all-reduce).  With
        ``ep`` (the step took the EP dispatch) the router term, and the
        loss with it, is data shard 0's: the reference's shard_map
        returns its aux with ``out_specs`` P() unchecked, so the value
        read is the first device's (ROADMAP Queue 3)."""
        if self.batch is None:
            return metrics
        if ep and self.aux_scale is not None:
            r = metrics["router_aux"]
            keep = r * self.aux_scale
            metrics = {**metrics, "router_aux": keep,
                       "loss": metrics["loss"] - r + keep}
        keys = list(metrics)
        buf = torch.stack([metrics[k].float() for k in keys])
        C.all_reduce(buf, self.batch)
        if self.batch.size > 1:
            buf.div_(self.batch.size)
        return {k: buf[i] for i, k in enumerate(keys)}

    def global_norm(self, grads) -> torch.Tensor:
        """The unsharded gradient tree's global norm: each leaf's squares
        summed over its shard, divided by the ranks that hold the same
        shard, then summed over the world (one all-reduce), so every rank
        takes the same clip scale."""
        from repro_torch.tree import named_leaves
        total = 0
        for path, g in named_leaves(grads):
            s = g.float().square().sum()
            total = total + (s / self.replicas[path]
                             if self.replicas[path] != 1 else s)
        buf = total.reshape(1).clone()
        C.all_reduce(buf, self.world)
        return torch.sqrt(buf[0])

    def collective_budget(self, microbatches: int = 1, *, seq_len: int,
                          remat: bool, mse: bool, mask: bool = True,
                          steps: int = 1) -> Dict[Tuple[str, str], int]:
        """{(op, axis): calls} of ``steps`` training steps: the table in
        ``distributed/collectives.py``'s docstring, counted over this
        plan's leaves (the dense GQA decoder's and mixtral's sites; an
        arch without a tensor-parallel form has no "model" role but
        expert parallelism's)."""
        from repro_torch.models import blocks as B
        out: Dict[Tuple[str, str], int] = {}

        def add(op, axis, n):
            if n:
                out[op, axis] = out.get((op, axis), 0) + n * steps

        r, m, mb = int(remat), int(mse), microbatches
        layer = ("/groups/", "/prologue/", "/enc_groups/")
        for path, dims in self.gathers.items():
            trains = path not in self.frozen
            for _, g in dims:
                again = r if path.startswith(layer) else 0
                add("all-gather", g.axis, mb * (1 + again))
                add("reduce-scatter", g.axis, mb * trains)
        n_ep = 0
        if self.ep_active(seq_len):
            # the MoE sub-layers: two all-to-alls forward, two backward,
            # two in the recompute; the router term's mean over "model",
            # run again by the recompute where a later sub-layer of the
            # group saves tensors (jamba's MoE sub-blocks but the last)
            defs = B.group_defs(self.cfg)
            n_ep = B.n_groups(self.cfg) * sum(d.moe for d in defs)
            inner = B.n_groups(self.cfg) * sum(d.moe for d in defs[:-1])
            add("all-to-all", "model", mb * n_ep * (4 + 2 * r))
            add("all-reduce", "model", mb * (n_ep + r * inner))
        if self.tp is not None:
            sp = self.seq_parallel(seq_len)
            cfg = self.cfg
            regions = [[B.prologue_def(cfg)]] * B.n_prologue(cfg)
            regions += [B.group_defs(cfg)] * B.n_groups(cfg)
            if cfg.enc_dec:
                regions += ([B.group_defs(cfg, decoder=False)]
                            * B.n_groups(cfg, decoder=False))
            shared = bool(cfg.moe and cfg.moe.num_shared_experts)
            for defs in regions:
                for kind, saved in tp_sites(defs, n_ep > 0, shared):
                    if kind == "ep":
                        # without SP an EP sub-layer's replicated input
                        # sums its gradient; under SP its input and output
                        # keep the stream's sequence shards
                        add("all-reduce", "model", 0 if sp else mb)
                    elif kind == "psum":
                        # Mamba's x_proj: forward, backward, recompute
                        add("all-reduce", "model", mb * (2 + r))
                    elif sp:
                        add("all-gather", "model", mb * (2 + r))
                        add("reduce-scatter", "model", mb * (2 + r * saved))
                    else:
                        add("all-reduce", "model", mb * (2 + r * saved))
                n_mse = sum(d.kind in ("attn", "mla")
                            for d in defs) * cfg.dsa.enabled
                add("all-reduce", "model", mb * n_mse * m * (1 + r))
            # the embedding lookup and the head, and whisper's encoder
            # output (gathered over the sequence under SP, its partial
            # key/value gradients summed without)
            ends = 2 + int(cfg.enc_dec)
            if sp:
                add("all-gather", "model", mb * ends)
                add("reduce-scatter", "model", mb * ends)
            else:
                add("all-reduce", "model", mb * ends)
            if sp or self.routers or self.kv_slices or self.partials:
                # the norms', routers', shared KV leaves' and RWKV6's and
                # MLA's partial leaves'
                add("all-reduce", "model", 1)
            add("all-reduce", "model", mb * 2)           # vocab-parallel CE
        if self.batch is not None:
            add("all-reduce", self.batch.axis, mb * mask + 1)
        for g, paths in self.buckets:
            add("all-reduce", g.axis, 1 if paths else 0)
        add("all-reduce", "world", 1)
        return out


def tp_sites(defs, ep: bool, shared: bool = False
             ) -> List[Tuple[str, bool]]:
    """One checkpoint region's (a layer group's, ``defs``) tensor-parallel
    sub-layers in order, for the training budget: ("tp", saved) for one
    that enters by ``tp_enter`` and leaves by ``tp_exit`` (attention,
    MLA, Mamba, cross-attention, an MLP or a capacity MoE, RWKV6's
    time-mix and FFN), ("psum", True) for Mamba's ``x_proj`` sum
    (``collectives.tp_psum``), ("ep", False) for an MoE on the
    expert-parallel dispatch (``ep``), preceded by its ``shared``
    experts' own ("tp", True).  ``saved``: a tensor after the exit's
    collective is saved for the backward pass, so the recompute runs it
    again: every exit but the region's last MLP, whose output is added
    to the stream and returned (the cross sub-layer's and the RWKV6
    FFN's are multiplied by a gate, which saves them; the shared
    experts run before the dispatch, whose products are saved)."""
    sites = []
    for d in defs:
        if d.kind == "rwkv":
            sites += [("tp", True), ("tp", True)]
            continue
        if d.kind == "mamba":
            sites.append(("psum", True))
        sites.append(("tp", True))
        if d.cross:
            sites.append(("tp", True))
        if d.moe and ep:
            sites += [("tp", True)] * shared + [("ep", False)]
        else:
            sites.append(("tp", True))
    if sites[-1] == ("tp", True) and defs[-1].kind != "rwkv":
        sites[-1] = ("tp", False)
    return sites


def make_train_plan(cfg, mesh, rules: Optional[ShardingRules] = None
                    ) -> TrainPlan:
    """The layout of training ``cfg`` on ``mesh`` under ``rules`` (the
    rule context's by default).  Tensor parallelism (a "model" axis above
    1 that holds no batch rows) takes every layer kind's tensor-parallel
    form (dense GQA and latent attention, MLPs and mixtures of experts,
    the latter by expert parallelism where the reference's gate holds,
    with their shared experts in the MLP's form; cross-attention, RWKV6
    and Mamba); heads, KV heads, d_ff (Mamba's inner width, the shared
    experts') or a vocab that the axis does not divide raise
    ``ValueError`` naming the axis and "Distribution".  A ``Halves``
    leaf (Mamba's ``in_proj``) is placed, gathered and reassembled half
    by half (``TrainPlan.halves``).  A
    tp above the KV heads that is a multiple of them (``kv_group``)
    keeps the KV leaves whole over "model" (``TrainPlan.kv_slices``).  An
    MoE arch takes the expert-parallel dispatch (``TrainPlan.ep``) on a
    "model" axis above 1 that divides E under ``rules.moe_ep``, whether
    "model" is tensor-parallel or a batch axis."""
    from repro_torch.models.transformer import init_model, model_param_specs
    from repro_torch.optim.adamw import is_frozen
    rules = rules or _RULES
    sizes = mesh_axis_sizes(mesh)
    names = tuple(mesh.mesh_dim_names)
    rb = _axes(rules.batch)
    batch_axes = tuple(a for a in names if a in rb)
    tp_axis = "model" in sizes and "model" not in batch_axes
    tp_n = sizes["model"] if tp_axis else 1
    if tp_n > 1:
        issues = serving_tp_issues(cfg, tp_n)
        if cfg.vocab % tp_n:
            issues.append(f"vocab ({cfg.vocab} % tp={tp_n} != 0)")
        if issues:
            raise ValueError(f"tp={tp_n} does not divide arch {cfg.name!r} "
                             f"on axis " + "; ".join(issues) + " (the "
                             f"reference leaves such an axis whole: ROADMAP "
                             f"Queue 1, \"Distribution\", per-dimension "
                             f"replication)")
    tp = C.axis_group(mesh, "model") if tp_axis else None
    shared = kv_group(cfg, tp.size) if tp is not None else 1
    if shared > 1:
        rules = kv_rules(rules)
    meta = init_model(0, cfg, device="meta")
    logical = _flat_specs(meta, model_param_specs(cfg))
    resolved = _flat_specs(meta, tree_specs(meta, model_param_specs(cfg),
                                            rules, mesh))
    world = C.world_group(mesh)
    gathers, replicas, norms, kv_slices = {}, {}, [], {}
    halves = {p: halves_of(log) for p, log in logical.items()
              if halves_of(log)}
    bucket: Dict[tuple, List[str]] = {}
    hd = cfg.resolved_head_dim
    for path, spec in resolved.items():
        if shared > 1 and "kv_heads" in logical[path]:
            kv_slices[path] = (tuple(logical[path]).index("kv_heads"),
                               kv_head(cfg, tp.size, tp.rank) * hd, hd)
        dims, shard = [], 1
        for d, ax in enumerate(spec):
            t = _axes(ax)
            for a in t:
                shard *= sizes[a]
            if t and set(t) <= set(batch_axes):
                if d in halves.get(path, ()):
                    raise NotImplementedError(
                        f"{path}: dimension {d} holds two halves and is "
                        f"split over the batch axes {t}: the FSDP gather "
                        f"would interleave them")
                dims.append((d, C.axes_group(mesh, t)))
            elif t and t != ("model",):
                raise ValueError(f"{path}: dimension {d} split over {t}, "
                                 f"batch and tensor-parallel axes at once")
            elif t and tp is None and sizes["model"] > 1:
                raise ValueError(f"{path}: dimension {d} split over "
                                 f"\"model\" with no tensor-parallel role")
        gathers[path] = tuple(dims)
        replicas[path] = world.size // shard
        if is_frozen(path):
            continue
        covered = {a for _, g in dims for a in g.axis.split("+")}
        rest = tuple(a for a in batch_axes if a not in covered)
        if rest:
            bucket.setdefault(rest, []).append(path)
        if tp is not None and _seq_partial(path, logical[path]):
            norms.append(path)
    n_model = sizes.get("model", 1)
    ep = None
    if (cfg.moe is not None and rules.moe_ep and n_model > 1
            and cfg.moe.num_experts % n_model == 0):
        ep = C.axis_group(mesh, "model")
    # data shard 0: the ranks whose batch coordinates off "model" are 0
    lead_axes = [a for a in batch_axes if a != "model"]
    aux_scale = None
    if ep is not None and lead_axes:
        coord = dict(zip(names, mesh.get_coordinate()))
        aux_scale = (int(np.prod([sizes[a] for a in lead_axes]))
                     if all(coord[a] == 0 for a in lead_axes) else 0)
    return TrainPlan(
        cfg=shard_config(cfg, tp.size) if tp is not None else cfg,
        mesh=mesh, rules=rules, axes=resolved, gathers=gathers, tp=tp,
        batch=C.axes_group(mesh, batch_axes) if batch_axes else None,
        world=world,
        buckets=[(C.axes_group(mesh, k), v) for k, v in bucket.items()],
        norms=norms, replicas=replicas,
        frozen=tuple(p for p in resolved if is_frozen(p)),
        routers=[p for p in resolved if p.endswith("/mlp/router")]
        if tp is not None else [],
        kv_slices=kv_slices,
        partials=[p for p in resolved if _tp_partial(cfg, p)
                  and not is_frozen(p)] if tp is not None else [],
        halves=halves,
        ep=ep, batch_ranks=int(np.prod([sizes.get(a, 1)
                                        for a in _axes(rules.batch)])),
        aux_scale=aux_scale)
