"""Logical-axis sharding rules resolved against a serving mesh (the
port of the reference's ``repro/distributed/sharding.py``).

Weights and caches are described by *logical* axis names (the spec
trees of ``models/transformer.model_param_specs`` and
``unstacked_cache_specs``); a rule table maps logical axes to the mesh
axes of a ``torch.distributed.device_mesh.DeviceMesh``.  ``resolve_spec``
drops a mesh axis that does not divide the dimension and never uses a
mesh axis twice in one spec, as the reference's does, so one rule table
serves every arch.

Placement is explicit: the port runs one process per device (SPMD over
processes), the mesh and the rules are arguments (no module state), and
``shard_put`` slices this rank's local shard out of a tensor before it
moves to the device.  An engine on a mesh takes the weights piece by
piece as ``init_model`` draws them (its ``place``), so a rank's card
holds its shard and at most one piece of the tree whole, never the
whole tree.  The reference's ``shard()`` activation constraint has no
counterpart: the port's layers place their collectives themselves
(``distributed/collectives.py``).

Parallelism served here (the serving half of the reference's table):
  DP : "batch" -> "data" (the static batch rows, the resident slots)
  TP : "heads"/"kv_heads"/"mlp"/"vocab"/"expert" -> "model"
The training half (the reference's ``make_rules``: FSDP "embed" ->
"data", SP "seq_sp" -> "model", EP; its rule context and production
mesh) waits for the port's training mesh (ROADMAP Queue 1,
"Distribution").
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

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


def serving_tp_issues(cfg, tp: int) -> list:
    """Names of the logical weight axes whose dims do NOT divide a
    ``tp``-way "model" axis (empty: ``cfg`` shards cleanly).  Shared by
    ``launch.mesh.make_serving_mesh`` (an up-front ``ValueError`` naming
    the axis) and ``inference.engine.Engine`` (the fallback to
    replicated weights).  vocab is not checked: a vocab that does not
    divide leaves the embedding and the head replicated."""
    tp = int(tp)
    if tp <= 1:
        return []
    issues = []
    if cfg.n_heads % tp:
        issues.append(f'heads (n_heads={cfg.n_heads} % tp={tp} != 0)')
    n_kv = getattr(cfg, "n_kv_heads", None) or cfg.n_heads
    if n_kv % tp:
        issues.append(f'kv_heads (n_kv_heads={n_kv} % tp={tp} != 0)')
    if cfg.d_ff % tp:
        issues.append(f'mlp (d_ff={cfg.d_ff} % tp={tp} != 0)')
    moe = getattr(cfg, "moe", None)
    if moe is not None:
        d_ff_e = getattr(moe, "d_ff_expert", None) or cfg.d_ff
        if moe.num_experts % tp and d_ff_e % tp:
            issues.append(
                f'expert (num_experts={moe.num_experts} and '
                f'd_ff_expert={d_ff_e}, neither % tp={tp} == 0)')
    return issues


def tp_unsupported(cfg) -> Optional[str]:
    """Why ``cfg`` cannot be served at tp > 1 by the port (None when it
    can): its layers have no tensor-parallel form yet."""
    if cfg.mla is not None:
        return "multi-head latent attention"
    if cfg.rwkv is not None:
        return "RWKV6 layers"
    if cfg.mamba is not None:
        return "Mamba layers"
    if cfg.enc_dec or cfg.cross_attn_period:
        return "cross-attention"
    return None


def shard_config(cfg, tp: int):
    """The geometry one rank of a ``tp``-way "model" axis computes:
    n_heads / tp query heads and n_kv_heads / tp KV heads (so the GQA
    group G is unchanged), d_ff / tp, head_dim made explicit.  An MoE
    keeps routing over all its experts: a layer reads its local experts
    off its weights (``models/moe.py``).  tp 1 returns ``cfg``."""
    if tp == 1:
        return cfg
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp,
                               n_kv_heads=cfg.n_kv_heads // tp,
                               d_ff=cfg.d_ff // tp,
                               head_dim=cfg.resolved_head_dim)


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def resolve_spec(shape: Tuple[int, ...], logical: Tuple[Optional[str], ...],
                 rules: ShardingRules, mesh) -> Tuple[Axis, ...]:
    """Map logical axes to mesh axes, one entry per dimension (None: the
    dimension is whole on every rank; a name or a tuple of names: it is
    split over those axes in order), enforcing divisibility and one use
    per mesh axis.  Without a mesh (None) every entry is None."""
    if len(shape) != len(logical):
        raise ValueError(f"shape {shape} and logical spec {logical} differ "
                         f"in rank")
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


def is_spec_leaf(x) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


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


def local_shard(x: torch.Tensor, spec: Tuple[Axis, ...], mesh
                ) -> torch.Tensor:
    """This rank's piece of ``x`` under a resolved ``spec``: each split
    dimension cut into equal pieces, the piece at this rank's mesh
    coordinate kept (a view)."""
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        idx, n = _coord(mesh, (ax,) if isinstance(ax, str) else tuple(ax))
        step = x.shape[dim] // n
        x = x.narrow(dim, idx * step, step)
    return x


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def shard_put(x, *logical, mesh, rules: ShardingRules,
              device=None) -> torch.Tensor:
    """This rank's shard of one array, sliced before it moves to
    ``device`` (contiguous there, and never a view of the whole)."""
    x = _as_tensor(x)
    spec = resolve_spec(tuple(x.shape), tuple(logical), rules=rules,
                        mesh=mesh)
    out = local_shard(x, spec, mesh).to(device).contiguous()
    if any(a is not None for a in spec) and (
            out.untyped_storage().data_ptr()
            == x.untyped_storage().data_ptr()):
        out = out.clone()         # a shard must not keep the whole alive
    return out


def shard_put_tree(tree, logical_tree, mesh, rules: ShardingRules,
                   device=None):
    """``shard_put`` over a tree of arrays and its parallel logical-spec
    tree."""
    return _map2(lambda x, log: shard_put(x, *log, mesh=mesh, rules=rules,
                                          device=device),
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

