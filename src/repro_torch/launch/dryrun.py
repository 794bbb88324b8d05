"""The production-mesh dry run (the port of the reference's
``repro/launch/dryrun.py``): each (arch x shape) cell's step on the
256- or 512-rank mesh, counted on fake tensors in one process, with no
card and no data: peak memory per device, FLOPs and HBM bytes,
collectives with their wire bytes, and a three-term roofline with the
H100's constants (``distributed/hlo_analysis.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi_6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

The world is a process group of the ``"fake"`` backend (every collective
returns at once) of 256 or 512 ranks, this process rank 0, with the
production mesh over it (``launch/mesh.make_production_mesh``).  The
step runs once under ``FakeTensorMode`` and four counters:

  FLOPs        ``torch.utils.flop_counter.FlopCounterMode``;
  HBM bytes    ``ByteCounter``: the bytes of the inputs and outputs of
               every aten op but views; in eager PyTorch each op is a
               kernel that reads and writes those bytes, so this is the
               traffic that no fusion has saved;
  peak memory  ``torch.distributed._tools.mem_tracker.MemTracker``;
  collectives  ``distributed.collectives.recording`` (op, axis, group,
               per-device output bytes).

Cost accounting, the reference's: the step is counted at 1 and at 2
layer groups (their difference is one group's exact cost, the port's
layers repeating), scaled by the group count, the microbatches and the
encoder layers; a train step's per-step tail (the gradient and metric
reductions and the AdamW update) is counted apart, at full depth:

    train:   mb * (fixed + ng*group [+ n_enc*enc]) + tail
    serve:   fixed + ng*group [+ n_enc*enc]

Peak memory takes the same linear form over depth, a train step's at
global_batch / microbatches rows (one microbatch).

Train cells run ``make_train_step`` on the state ``init_train_state``
places under ``make_rules``.  Prefill and decode cells run the serving
step as ``inference.engine.Engine`` shards it, under
``make_serving_rules`` (no FSDP weights) on a ("data", "model") mesh,
``tp=False`` under ``--no-tp``; the reference resolves its serve cells
under ``make_rules`` (ROADMAP records the difference).  Prefill runs
``dsa_mode="block"``, decode ``"off"``, as the reference's.  A cell the
port cannot run raises naming ROADMAP's "Distribution" and writes a
``.fail`` record: ``long_500k`` (the sequence-sharded cache) and tp
16 on an arch whose heads it does not divide (whisper_small's 12,
rwkv6_3b's 40: ``ValueError`` naming the axis; the reference would keep
that axis whole and shard the rest, ROADMAP's per-dimension
replication).  ``--no-tp`` runs them.  Every layer kind has a
tensor-parallel form, MLA and Mamba included (jamba_1_5_large's and
deepseek_v3's tp-16 cells run).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs.base import LONG_CTX_ARCHS, SHAPES, get_config
from repro_torch.distributed import collectives as C
from repro_torch.distributed import hlo_analysis as H
from repro_torch.distributed.sharding import (make_rules, make_serving_rules,
                                              make_train_plan)
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_production_mesh, mesh_over
from repro_torch.models import blocks as B
from repro_torch.models.attention import RunFlags
from repro_torch.optim import adamw
from repro_torch.training import steps as ST

# the reference's order, so that cell_list() is the reference's list
ARCH_IDS = (
    "yi_6b", "h2o_danube_1_8b", "qwen1_5_110b", "stablelm_3b", "rwkv6_3b",
    "jamba_1_5_large", "deepseek_v3", "mixtral_8x22b", "whisper_small",
    "llama_3_2_vision",
)

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "dryrun_out")
DEVICE = "cpu"        # the fake tensors' device: the port's plain paths
SERVE_TP = 16         # the serving mesh's "model" axis, the production one


def pick_microbatches(cfg, shape) -> int:
    if shape.kind != "train":
        return 1
    if cfg.d_model >= 6144 or cfg.moe is not None:
        return 8
    if cfg.d_model >= 4096:
        return 4
    return 2


def cell_list():
    cells = []
    for arch in ARCH_IDS:
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            cells.append((arch, shape))
        if arch in LONG_CTX_ARCHS:
            cells.append((arch, "long_500k"))
    return cells


# -- the counters -------------------------------------------------------------


_FREE = {torch.ops.aten._unsafe_view.default,
         torch.ops.aten.empty.memory_format,
         torch.ops.aten.empty_strided.default,
         torch.ops.aten.empty_like.default,
         torch.ops.aten.new_empty.default,
         torch.ops.aten.new_empty_strided.default}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class ByteCounter(TorchDispatchMode):
    """Sums the bytes of the tensor inputs and outputs of every aten op
    run under it but views and allocations (``bytes``): an eager op's
    HBM traffic, each operand read once and each result written once
    (metadata queries, ``prim``, and collectives, ``c10d``, left out:
    the recorder counts the latter)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (func.namespace == "aten" and not func.is_view
                and func not in _FREE):
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


@contextlib.contextmanager
def counted(track=()):
    """Count what runs in the block: yields a dict that holds, on exit,
    "flops", "bytes", "peak" (MemTracker's peak over every device, the
    tensors of ``track`` included) and "colls" (the recorded
    collectives)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode
    res: Dict = {}
    mt = MemTracker()
    leaves = [t for t in tree_leaves(track) if isinstance(t, torch.Tensor)]
    if leaves:
        mt.track_external(*leaves)
    fc, bc = FlopCounterMode(display=False), ByteCounter()
    with C.recording() as rec, mt, fc, bc:
        yield res
    res["flops"] = float(fc.get_total_flops())
    res["bytes"] = float(bc.bytes)
    peak = mt.get_tracker_snapshot("peak")
    res["peak"] = float(sum(d.get("Total", 0) for d in peak.values()))
    res["colls"] = list(rec)


def _cost(res) -> Dict:
    return {"flops": res["flops"], "bytes": res["bytes"],
            "peak": res["peak"],
            "coll": H.collective_summary(H.parse_collectives(res["colls"]))}


def _combine(*terms):
    """Linear combination of cost dicts: terms = [(coeff, cost), ...]
    (the reference's, with the peak carried alongside)."""
    out = {"flops": 0.0, "bytes": 0.0, "peak": 0.0,
           "coll": {"total_wire_bytes": 0.0, "ideal_wire_bytes": 0.0,
                    "dci_wire_bytes": 0.0,
                    "n_collectives": 0, "by_op": {}}}
    for coeff, c in terms:
        for k in ("flops", "bytes", "peak"):
            out[k] += coeff * c[k]
        for k in ("total_wire_bytes", "ideal_wire_bytes", "dci_wire_bytes"):
            out["coll"][k] += coeff * c["coll"][k]
        out["coll"]["n_collectives"] += int(round(
            coeff * c["coll"]["n_collectives"]))
        for op, d in c["coll"]["by_op"].items():
            t = out["coll"]["by_op"].setdefault(op, {"count": 0,
                                                     "wire_bytes": 0})
            t["count"] += int(round(coeff * d["count"]))
            t["wire_bytes"] += coeff * d["wire_bytes"]
    for k in ("flops", "bytes", "peak"):
        out[k] = max(0.0, out[k])
    for k in ("total_wire_bytes", "ideal_wire_bytes", "dci_wire_bytes"):
        out["coll"][k] = max(0.0, out["coll"][k])
    return out


# -- the world ----------------------------------------------------------------


def fake_world(n: int) -> None:
    """This process as rank 0 of a ``"fake"`` process group of ``n``
    ranks (a running one of another size or backend is taken down)."""
    if dist.is_initialized():
        if dist.get_world_size() == n and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


# -- one step at one depth ----------------------------------------------------


def depth_cfg(cfg, n_groups: int, enc_layers: int):
    """``cfg`` with ``n_groups`` layer groups (a dense prologue kept
    whole) and ``enc_layers`` encoder layers."""
    period = len(B.group_defs(cfg))
    fk = cfg.moe.first_k_dense if cfg.moe else 0
    kw = dict(n_layers=fk + n_groups * period)
    if cfg.enc_dec:
        kw["n_enc_layers"] = enc_layers
    return dataclasses.replace(cfg, **kw)


def _train_batch(cfg, shape, rows):
    b = SP.batch_structs(cfg, dataclasses.replace(shape, global_batch=rows),
                         train=True, device=DEVICE)
    return {k: v.zero_() if v.dtype == torch.int32 else v.fill_(1.0)
            for k, v in b.items()}


def _tail(cfg, opt, mesh, rules, flags, shape, mb):
    """A train step's per-step tail at ``cfg``'s depth, on fake gradients
    and metric sums: the accumulation of ``mb`` - 1 further
    microbatches' gradients and metrics, ``training.steps.finish_grads``
    (the division by ``mb``, the gradient and metric reductions) and the
    AdamW update;
    ``shape`` gives the microbatch's global rows and sequence length."""
    plan = None if mesh is None else make_train_plan(cfg, mesh, rules)
    state, _ = SP.train_state_structs(cfg, opt, device=DEVICE, mesh=mesh,
                                      rules=rules)
    params = state["params"]
    trained = [p for p in tree_leaves(params) if p.requires_grad]
    news = [torch.zeros_like(p, requires_grad=False) for p in trained]
    for p, g in zip(trained, news):
        p.grad = g.clone()
    m_sum = {k: torch.zeros(()) for k in ("loss", "ce", "mse", "router_aux")}
    if plan is not None:
        flags = plan.run_flags(flags, shape.seq_len,
                               shape.global_batch // mb)
    with counted((state, news, m_sum)) as res:
        # each further microbatch: autograd's add into ``.grad`` and the
        # metric sums
        for _ in range(mb - 1):
            for p, g in zip(trained, news):
                p.grad.add_(g)
            m_sum = {k: v + m_sum[k] for k, v in m_sum.items()}
        grads, _ = ST.finish_grads(params, m_sum, mb, plan, flags)
        with torch.no_grad():
            adamw.apply_updates(opt, params, grads, state["opt"], plan=plan)
    return _cost(res)


def _train_count(cfg, shape, opt, mesh, rules, flags, mb):
    """The counts (``counted``'s) of one train step of ``mb`` microbatches
    of ``shape.global_batch`` rows at ``cfg``'s depth."""
    state, _ = SP.train_state_structs(cfg, opt, device=DEVICE, mesh=mesh,
                                      rules=rules)
    step = ST.make_train_step(cfg, opt, flags, microbatches=mb, mesh=mesh,
                              rules=rules)
    batch = _train_batch(cfg, shape, shape.global_batch)
    with counted((state, batch)) as res:
        step(state, batch)
    return res


def _engine(cfg, shape, mesh, tp: bool, flags):
    """The serving engine of a cell on ``mesh`` (its weights drawn and
    placed piece by piece, fake under ``FakeTensorMode``)."""
    import functools

    from repro_torch.inference.engine import Engine
    from repro_torch.models.transformer import init_model
    return Engine(cfg, functools.partial(init_model, 0, cfg, device=DEVICE),
                  mesh=mesh, shard_rules=make_serving_rules(tp=tp),
                  max_len=shape.seq_len, dsa_mode=flags.dsa_mode,
                  device=DEVICE)


def _serve_count(cfg, shape, mesh, tp: bool, flags):
    """The counts (``counted``'s) of one prefill or decode step at
    ``cfg``'s depth, as the engine shards it on ``mesh``
    (``make_serving_rules(tp=tp)``): this rank's rows of the global
    batch on a cache of ``shape.seq_len``."""
    eng = _engine(cfg, shape, mesh, tp, flags)
    rows = shape.global_batch
    rs = eng.local_rows(rows)
    n = rs.stop - rs.start
    flags = dataclasses.replace(flags, tp=eng._tp)
    caches, _ = SP.cache_structs(eng.mcfg, n, shape.seq_len, flags,
                                 device=DEVICE)
    if flags.mode == "prefill":
        batch = SP.batch_structs(eng.mcfg, dataclasses.replace(
            shape, global_batch=n), train=False, device=DEVICE)
        for v in batch.values():
            v.zero_() if v.dtype == torch.int32 else v.fill_(1.0)
        fn = ST.make_prefill_step(eng.mcfg, flags)
        args = (eng.params, batch, caches)
    else:
        tok = torch.zeros((n, 1), dtype=torch.int32, device=DEVICE)
        fn = ST.make_decode_fn(eng.mcfg, flags)
        args = (eng.params, tok, caches)
    with counted(args) as res:
        fn(*args)
    return res


def component_costs(cfg, shape, opt, mesh, rules, flags, mb, *, tp=True):
    """The whole step's cost from the 1-group / 2-group counts (the
    module docstring's form)."""
    kind = shape.kind
    ng = B.n_groups(cfg)
    n_enc = cfg.n_enc_layers if cfg.enc_dec else 0
    ce = copt = None
    if kind == "train":
        rows = dataclasses.replace(shape, global_batch=shape.global_batch
                                   // mb)

        def fb(c):
            return _combine((1.0, _cost(_train_count(c, rows, opt, mesh,
                                                     rules, flags, 1))),
                            (-1.0, _tail(c, opt, mesh, rules, flags, rows,
                                         1)))
        c1, c2 = fb(depth_cfg(cfg, 1, 1)), fb(depth_cfg(cfg, 2, 1))
        if cfg.enc_dec:
            ce = fb(depth_cfg(cfg, 1, 2))
        copt = _tail(cfg, opt, mesh, rules, flags, shape, mb)
    else:
        def sv(c):
            return _cost(_serve_count(c, shape, mesh, tp, flags))
        c1, c2 = sv(depth_cfg(cfg, 1, 1)), sv(depth_cfg(cfg, 2, 1))
        if cfg.enc_dec:
            ce = sv(depth_cfg(cfg, 1, 2))
    group = _combine((1.0, c2), (-1.0, c1))
    terms = [(float(mb), c1), (float(mb) * (ng - 1), group)]
    if ce is not None:
        terms.append((float(mb) * (n_enc - 1), _combine((1.0, ce),
                                                         (-1.0, c1))))
    if copt is not None:
        terms.append((1.0, copt))
    out = _combine(*terms)
    # peak memory: the same linear form over depth, one microbatch's
    peaks = [(1.0, c1), ((ng - 1), group)]
    if ce is not None:
        peaks.append(((n_enc - 1), _combine((1.0, ce), (-1.0, c1))))
    out["peak"] = max(0.0, sum(k * c["peak"] for k, c in peaks))
    if copt is not None:
        out["peak"] = max(out["peak"], copt["peak"])
    return out


# -- a cell -------------------------------------------------------------------


def refuse_cell(cfg, shape_name: str) -> None:
    """Raise ``NotImplementedError`` naming ROADMAP's "Distribution" for a
    cell the port cannot run for want of a distribution form: long_500k,
    whose 524,288-token cache the reference shards over its sequence."""
    if shape_name == "long_500k":
        raise NotImplementedError(
            f"{cfg.name} long_500k: the 524,288-token decode needs the "
            f"KV cache's sequence sharded (the reference's long_context "
            f"rules: over \"data\" and \"model\"), which the port does "
            f"not serve (ROADMAP Queue 1, \"Distribution\")")


def _kv_weights(cfg, mesh, rules, tp: bool, kind: str) -> Optional[Dict]:
    """How a layer's K/V weights lie: the reference's ``resolve_spec``
    under the cell's rules, and the placement the port runs (a train
    plan's axes, or the serving engine's)."""
    from repro_torch.distributed.sharding import (kv_group, resolve_spec,
                                                  tree_specs)
    meta, specs = SP.model_structs(depth_cfg(cfg, 1, 1))
    sub = next((k for k, v in specs["groups"][0].items() if "attn" in v
                and "wk" in v["attn"]), None)
    if sub is None:
        return None
    wk = meta["groups"][0][sub]["attn"]["wk"]
    log = specs["groups"][0][sub]["attn"]["wk"]
    n_model = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))["model"]
    ref = resolve_spec(tuple(wk.shape), tuple(log), rules, mesh)
    if kind == "train":
        plan = make_train_plan(cfg, mesh, rules)
        placed = plan.axes[f"/groups/0/{sub}/attn/wk"]
    else:
        placed = tree_specs(meta, specs, rules, mesh)["groups"][0][sub][
            "attn"]["wk"]
        if tp and kv_group(cfg, n_model) > 1:
            placed = (placed[0], None)
    g = kv_group(cfg, n_model) if tp else 1
    return {"shape": list(wk.shape), "logical": list(log),
            "resolve_spec": list(ref), "placed": list(placed),
            "kv_group": g, "kv_heads_a_rank": (
                1 if g > 1 else cfg.n_kv_heads // (n_model if tp else 1))}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             dsa_mode: str = "auto", fsdp: bool = True, sp: bool = True,
             microbatches: int = 0, fsdp_pod: bool = False, tp: bool = True,
             remat: str = "full", tag: str = "",
             skip_cost: bool = False) -> dict:
    cfg = get_config(arch)
    if remat != "full":
        cfg = dataclasses.replace(cfg, remat_policy=remat)
    shape = SHAPES[shape_name]
    refuse_cell(cfg, shape_name)
    long_ctx = shape_name == "long_500k"
    if dsa_mode == "auto":
        dsa_mode = "block" if cfg.dsa.enabled else "off"
    n_chips = 512 if multi_pod else 256
    fake_world(n_chips)
    mb = microbatches or pick_microbatches(cfg, shape)
    opt = adamw.OptConfig(
        moment_dtype="bfloat16" if cfg.num_params() > 5e10 else "float32")
    t0 = time.time()
    if shape.kind == "train":
        mesh = make_production_mesh(multi_pod=multi_pod)
        rules = make_rules(multi_pod=multi_pod, fsdp=fsdp,
                           seq_parallel=sp, long_context=long_ctx,
                           fsdp_pod=fsdp_pod, tp=tp)
        rules_name = "make_rules"
        flags = RunFlags(mode="train", dsa_mode=dsa_mode)
    else:
        # the serving engines' ("data", "model") mesh
        mesh = mesh_over((n_chips // SERVE_TP, SERVE_TP), ("data", "model"))
        rules = make_serving_rules(tp=tp)
        rules_name = "make_serving_rules"
        if shape.kind == "prefill":
            flags = RunFlags(mode="prefill", dsa_mode=dsa_mode,
                             with_mse=False)
        else:
            flags = RunFlags(mode="decode", dsa_mode="off", with_mse=False)
    with _fake_mode():
        kv = _kv_weights(cfg, mesh, rules, tp, shape.kind)
        raw = None
        if skip_cost:
            full = _cost(
                _train_count(cfg, shape, opt, mesh, rules, flags, mb)
                if shape.kind == "train" else
                _serve_count(cfg, shape, mesh, tp, flags))
            cost = full
            raw = {"flops": full["flops"], "bytes": full["bytes"]}
        else:
            cost = component_costs(cfg, shape, opt, mesh, rules, flags, mb,
                                   tp=tp)
        state_bytes = _state_bytes(cfg, shape, opt, mesh, rules, tp, flags)
    t_count = time.time() - t0
    n_tokens = shape.global_batch * (shape.seq_len if shape.kind == "train"
                                     else 1)
    n_active = cfg.num_active_params()
    mf = 6.0 * n_active * n_tokens if shape.kind == "train" else (
        2.0 * n_active * n_tokens)
    roof = H.roofline(cost["flops"], cost["bytes"], cost["coll"],
                      model_flops_global=mf, n_chips=n_chips)
    peak = max(cost["peak"], state_bytes)
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "rules": rules_name,
        "dsa_mode": flags.dsa_mode, "microbatches": mb,
        "fsdp": fsdp, "sp": sp, "fsdp_pod": fsdp_pod, "tp": tp,
        "remat": remat, "tag": tag, "count_s": round(t_count, 1),
        "memory": {
            "args_bytes": state_bytes,
            "temp_bytes": peak - state_bytes,
            "peak_hbm_bytes": peak,
        },
        "cost": {"flops_per_dev": cost["flops"],
                 "bytes_per_dev": cost["bytes"]},
        "collectives": cost["coll"],
        "raw_scanbody_cost": raw,
        "roofline": roof,
        "kv_weights": kv,
        "params": cfg.num_params(), "active_params": n_active,
        "moment_dtype": opt.moment_dtype,
    }


def _state_bytes(cfg, shape, opt, mesh, rules, tp, flags) -> int:
    """This rank's resident bytes at full depth: the train state's
    shards, or the serving engine's weights and its rows' cache."""
    from repro_torch.distributed.sharding import tree_bytes
    if shape.kind == "train":
        state, _ = SP.train_state_structs(cfg, opt, device=DEVICE,
                                          mesh=mesh, rules=rules)
        return tree_bytes(state["params"]) + tree_bytes(state["opt"]["m"]) \
            + tree_bytes(state["opt"]["v"])
    eng = _engine(cfg, shape, mesh, tp, flags)
    rs = eng.local_rows(shape.global_batch)
    caches, _ = SP.cache_structs(eng.mcfg, rs.stop - rs.start,
                                 shape.seq_len, flags, device=DEVICE)
    return eng.weight_bytes_per_device() + tree_bytes(caches)


def _name(arch, shape, args) -> str:
    name = f"{arch}__{shape}__{args.mesh}"
    return name + f"__{args.tag}" if args.tag else name


def _one(arch: str, shape: str, args, path: str) -> bool:
    """Run one cell in this process and write its record (or its
    ``.fail``); True when it ran."""
    name = os.path.basename(path)[:-len(".json")]
    try:
        rec = run_cell(arch, shape, multi_pod=(args.mesh == "multi"),
                       dsa_mode=args.dsa, fsdp=not args.no_fsdp,
                       sp=not args.no_sp, fsdp_pod=args.fsdp_pod,
                       tp=not args.no_tp, remat=args.remat,
                       microbatches=args.microbatches, tag=args.tag,
                       skip_cost=args.skip_cost)
    except Exception as e:
        print(f"[FAIL] {name}: {type(e).__name__}: {e}", flush=True)
        traceback.print_exc(limit=5)
        with open(path + ".fail", "w") as f:
            f.write(traceback.format_exc())
        return False
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    r = rec["roofline"]
    print(f"[ok] {name}: dom={r['dominant']} "
          f"t={r['bound_step_time_s']:.4f}s "
          f"hbm={rec['memory']['peak_hbm_bytes'] / 2 ** 30:.1f}GiB "
          f"mfu_bound={r.get('mfu_bound', 0):.3f} "
          f"count={rec['count_s']}s", flush=True)
    return True


def summary(out: str, names: List[str]) -> str:
    """A markdown table of the cells' records: the dominant term, the
    bound, peak GiB against the card's 80 GB, mfu_bound; or the
    refusal's first line."""
    rows = ["| cell | dominant | bound s | peak GiB | mfu_bound |",
            "|---|---|---|---|---|"]
    for name in names:
        path = os.path.join(out, name + ".json")
        if os.path.exists(path):
            with open(path) as f:
                rec = json.load(f)
            r = rec["roofline"]
            rows.append(f"| {name} | {r['dominant']} | "
                        f"{r['bound_step_time_s']:.4f} | "
                        f"{rec['memory']['peak_hbm_bytes'] / 2 ** 30:.1f} | "
                        f"{r.get('mfu_bound', 0):.4f} |")
        elif os.path.exists(path + ".fail"):
            with open(path + ".fail") as f:
                last = f.read().strip().splitlines()[-1]
            rows.append(f"| {name} | refused: {last[:160]} | | | |")
        else:
            rows.append(f"| {name} | no record | | | |")
    return "\n".join(rows)


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--dsa", default="auto")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-sp", action="store_true")
    ap.add_argument("--fsdp-pod", action="store_true")
    ap.add_argument("--no-tp", action="store_true",
                    help="pure FSDP/DP rules (no tensor parallelism)")
    ap.add_argument("--remat", default="full",
                    choices=["full", "dots", "none"])
    ap.add_argument("--skip-cost", action="store_true",
                    help="count the step once at full depth, no "
                         "1-/2-group extrapolation")
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--jobs", type=int, default=1,
                    help="with --all: cells run in this many processes "
                         "at once (one process a cell)")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    cells = cell_list() if args.all else [(args.arch, args.shape)]
    names = [_name(a, s, args) for a, s in cells]
    t_all = time.time()
    todo = []
    for (arch, shape), name in zip(cells, names):
        path = os.path.join(args.out, name + ".json")
        if args.all and os.path.exists(path):
            print(f"[skip] {name}", flush=True)
            continue
        todo.append((arch, shape, path))
    if args.jobs > 1 and len(todo) > 1:
        ok = _in_processes(todo, args)
    else:
        ok = [_one(arch, shape, args, path) for arch, shape, path in todo]
    failures = len(ok) - sum(ok)
    print(f"[done] {len(cells)} cells, {failures} refused or failed, "
          f"{time.time() - t_all:.1f}s", flush=True)
    if args.all:
        print(summary(args.out, names), flush=True)
    raise SystemExit(1 if failures else 0)


def _in_processes(todo, args) -> List[bool]:
    """Each cell of ``todo`` as ``python -m repro_torch.launch.dryrun
    --arch A --shape S`` with this run's other flags, ``args.jobs`` at a
    time; their output passed on as each ends."""
    import subprocess
    import sys
    from concurrent.futures import ThreadPoolExecutor
    base = ["--mesh", args.mesh, "--dsa", args.dsa, "--remat", args.remat,
            "--microbatches", str(args.microbatches), "--tag", args.tag,
            "--out", args.out] + [
        flag for flag, on in (("--no-fsdp", args.no_fsdp),
                              ("--no-sp", args.no_sp),
                              ("--fsdp-pod", args.fsdp_pod),
                              ("--no-tp", args.no_tp),
                              ("--skip-cost", args.skip_cost)) if on]
    # the longest first: a 32k prefill through a token loop (Mamba,
    # RWKV6) takes many minutes, a train step one or two, a decode seconds
    order = sorted(range(len(todo)), key=lambda k: (
        todo[k][1] != "prefill_32k", todo[k][1] != "train_4k"))

    def run(k):
        arch, shape, path = todo[k]
        p = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                            "--arch", arch, "--shape", shape, *base],
                           capture_output=True, text=True)
        print("\n".join(line for line in p.stdout.splitlines()
                        if line.startswith(("[ok]", "[FAIL]"))), flush=True)
        return k, p.returncode == 0 and os.path.exists(path)

    ok = [False] * len(todo)
    with ThreadPoolExecutor(args.jobs) as pool:
        for k, good in pool.map(run, order):
            ok[k] = good
    return ok


if __name__ == "__main__":
    main()
