"""Training scenarios run by every rank of a spawned process group
(``repro_torch.launch.mesh.run_spmd``) for
tests/test_torch_multidevice_train.py.

Each rank runs the same program: the unsharded training step
(``mesh=None``) and the step on a mesh under a rule table, from the same
seed on the same global batches; ``run`` returns, per configuration,
what the tests assert on: the metrics of each step, one microbatch's
gradients and the params after one update against the matching shard
of the unsharded ones (the largest gap of each leaf over its largest
magnitude), the collective counters against the budget, and the bytes
this rank holds.  The module imports torch, numpy and the port only:
the spawned ranks never import JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint import checkpoint as CK
from repro_torch.configs.base import (ShapeConfig, cut_layers, get_config,
                                      reduced)
from repro_torch.data.synthetic import DataConfig, lm_batches
from repro_torch.distributed import collectives as C
from repro_torch.distributed.fault_tolerance import elastic_mesh
from repro_torch.distributed.sharding import make_rules, tree_bytes
from repro_torch.launch import train as LT
from repro_torch.launch.mesh import make_production_mesh, mesh_over
from repro_torch.models.transformer import set_cross_gates
from repro_torch.optim import adamw
from repro_torch.training import steps as ST
from repro_torch.tree import named_leaves

SEED = 0
SEQ = 64
BATCH = 8
STEPS = 3
OPT = adamw.OptConfig(lr=3e-4, total_steps=10, warmup_steps=1)
# every cross gate at the start of a run (init: 0, and tanh(0) = 0 keeps
# the cross sub-layers' weights out of the first step's gradient)
XGATE = 0.5
# the archs whose cross-attention and RWKV6 layers train under TP + SP
XARCHS = ("whisper_small", "llama_3_2_vision", "rwkv6_3b")
# the archs whose Mamba and latent-attention layers train under TP + SP
MARCHS = ("jamba_1_5_large", "deepseek_v3")
DRYRUN_SHAPE = ShapeConfig("train_64", SEQ, BATCH, "train")


def cfg_of(arch, layers=0, remat=False):
    cfg = reduced(get_config(arch))
    if layers:
        cfg = cut_layers(cfg, layers)
    return dataclasses.replace(cfg, remat=remat)


def batches(cfg, n=STEPS, seed=0):
    """``n`` global batches; an encoder-decoder's carry ``enc_x`` and a
    cross-attention arch's ``img`` (B, T, d), drawn from ``seed``."""
    data = lm_batches(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                 global_batch=BATCH, seed=seed))
    out = [next(data) for _ in range(n)]
    rng = np.random.default_rng(seed + 100)
    key, t = (("enc_x", cfg.enc_seq_len) if cfg.enc_dec else
              ("img", cfg.n_image_tokens) if cfg.cross_attn_period else
              (None, 0))
    for b in out if key else ():
        b[key] = rng.standard_normal((BATCH, t, cfg.d_model)).astype(
            np.float32)
    return out


def mesh_of(shape):
    """A mesh of ``shape`` over every rank (the group's device type)."""
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                       "model")
    return mesh_over(shape, names)


def _metrics(m):
    return {k: float(v) for k, v in m.items()}


def _rel(got, want):
    """max |got - want| / max |want| (0 for an all-zero pair)."""
    scale = float(want.abs().max())
    gap = float((got - want).abs().max())
    return gap / scale if scale else gap


def _update_gap(got, want, tight=1e-5):
    """(max |got - want|, elements within ``tight``, elements) of params
    after one update: an element whose gradient is rounding noise moves by
    up to 2 lr either way (AdamW divides by its magnitude)."""
    d = (got - want).detach().abs()
    return float(d.max()), int((d <= tight).sum()), d.numel()


def train_run(cfg, mb, mesh=None, rules=None, state=None):
    """(the metrics of each step, one microbatch's gradients before any
    update, the params after the first update, the final state, the
    step's collective counts, the train step)."""
    if state is None:
        state, _ = ST.init_train_state(SEED, cfg, OPT, device="cpu",
                                       mesh=mesh, rules=rules)
        set_cross_gates(state["params"], XGATE)
    step = ST.make_train_step(cfg, OPT, microbatches=mb, mesh=mesh,
                              rules=rules)
    bs = batches(cfg)
    grads, _ = ST.accumulate_grads(state["params"], cfg,
                                   ST.default_flags(cfg), bs[0], 1,
                                   step.plan)
    grads = {p: g.detach().clone() for p, g in named_leaves(grads)}
    metrics, after1 = [], None
    before = C.snapshot()
    for b in bs:
        state, m = step(state, b)
        metrics.append(_metrics(m))
        if after1 is None:
            after1 = {p: t.detach().clone()
                      for p, t in named_leaves(state["params"])}
    return dict(metrics=metrics, grads=grads, after1=after1, state=state,
                counts=C.count_by_axis(before), step=step)


def compare(plain, cfg, mb, mesh, rules, budget=True):
    """A sharded run against ``plain`` (``train_run`` unsharded)."""
    got = train_run(cfg, mb, mesh, rules)
    plan = got["step"].plan
    out = dict(metrics=(plain["metrics"], got["metrics"]),
               grads={p: _rel(g, plan.shard(plain["grads"][p], p))
                      for p, g in got["grads"].items()},
               params={p: _update_gap(t, plan.shard(plain["after1"][p], p))
                       for p, t in got["after1"].items()})
    if budget:
        out["budget"] = (got["counts"], plan.collective_budget(
            mb, seq_len=SEQ, remat=cfg.remat, mse=cfg.dsa.enabled,
            steps=STEPS))
    st = got["state"]
    out["bytes"] = dict(params=tree_bytes(st["params"]),
                        grads=sum(g.numel() * g.element_size()
                                  for g in got["grads"].values()),
                        moments=tree_bytes(st["opt"]["m"])
                        + tree_bytes(st["opt"]["v"]),
                        whole=tree_bytes(plain["state"]["params"]))
    return out


def two(rank, ckpt_dir):
    """2 ranks: dp 2 (the host rules on ``elastic_mesh``), FSDP 2
    (``make_rules(tp=False)``, 1 and 2 microbatches), TP 2 + SP
    (``make_rules()`` on (1, 2)), FSDP on mixtral_8x22b and rwkv6_3b, the
    production mesh's refusal; TP 2 + SP on the cross-attention and
    RWKV6 archs (``XARCHS``), their budget with the recompute, llama's
    image at an odd token count, and a checkpoint round trip of a tp-2
    rwkv6_3b and whisper_small state."""
    out = {}
    yi = cfg_of("yi_6b")
    plain = {mb: train_run(yi, mb) for mb in (1, 2)}
    host = elastic_mesh(model_parallel=1)
    out["elastic"] = tuple(host.mesh.shape)
    out["dp2"] = compare(plain[1], yi, 1, host,
                         make_rules(fsdp=False, seq_parallel=False))
    fsdp = mesh_of((2, 1))
    for mb in (1, 2):
        out[f"fsdp2_mb{mb}"] = compare(plain[mb], yi, mb, fsdp,
                                       make_rules(tp=False))
    out["tp2"] = compare(plain[1], yi, 1, mesh_of((1, 2)), make_rules())
    for arch, rules in (("mixtral_8x22b", make_rules()),
                        ("rwkv6_3b", make_rules(tp=False))):
        cfg = cfg_of(arch)
        out[f"{arch}_fsdp2"] = compare(train_run(cfg, 1), cfg, 1, fsdp,
                                       rules, budget=False)
    try:
        make_production_mesh()
        out["production"] = "no error"
    except ValueError as e:
        out["production"] = str(e)
    out["staged"] = staged(fsdp)
    plan = ST.make_train_step(cfg_of("mixtral_8x22b"), OPT,
                              mesh=mesh_of((1, 2)), rules=make_rules()).plan
    out["mixtral_tp2_plan"] = dict(
        ep=plan.ep_active(SEQ), tp=plan.tp.size,
        budget=plan.collective_budget(1, seq_len=SEQ, remat=False,
                                      mse=True))
    m12 = mesh_of((1, 2))
    for arch in XARCHS:
        cfg = cfg_of(arch)
        out["x_tp2", arch] = compare(train_run(cfg, 1), cfg, 1, m12,
                                     make_rules())
        rem = cfg_of(arch, remat=True)
        got = train_run(rem, 1, m12, make_rules())
        out["x_remat", arch] = (got["counts"], got["step"].plan
                                .collective_budget(1, seq_len=SEQ,
                                                   remat=True,
                                                   mse=rem.dsa.enabled,
                                                   steps=STEPS))
        out["x_partials", arch] = got["step"].plan.partials
    # TP 2 without SP: RWKV6's FFN gate, computed alike on both ranks,
    # and whisper's encoder output entering the decoder by copy_to_tp
    for arch in ("rwkv6_3b", "whisper_small"):
        cfg = cfg_of(arch)
        out["x_tp2_nosp", arch] = compare(train_run(cfg, 1), cfg, 1, m12,
                                          make_rules(seq_parallel=False))
    # 33 image tokens: the keys and values of the cross sub-layer cannot
    # be sequence-sharded, and reach every rank whole
    odd = dataclasses.replace(cfg_of("llama_3_2_vision"), n_image_tokens=33)
    out["x_odd"] = compare(train_run(odd, 1), odd, 1, m12, make_rules())
    for arch in ("rwkv6_3b", "whisper_small"):
        out["x_ckpt", arch] = _round_trip(arch, m12, ckpt_dir)
    # Mamba and MLA with the capacity MoE and its shared experts under
    # TP (+ SP); their expert-parallel dispatch is spmd_ep_scenarios'
    for arch in MARCHS:
        cfg = cfg_of(arch)
        plain = train_run(cfg, 1)
        for name, sp in (("m_tp2", True), ("m_tp2_nosp", False)):
            out[name, arch] = compare(plain, cfg, 1, m12,
                                      capacity_rules(seq_parallel=sp))
        rem = cfg_of(arch, remat=True)
        got = train_run(rem, 1, m12, capacity_rules())
        out["m_remat", arch] = (got["counts"], got["step"].plan
                                .collective_budget(1, seq_len=SEQ,
                                                   remat=True,
                                                   mse=rem.dsa.enabled,
                                                   steps=STEPS))
        out["m_partials", arch] = got["step"].plan.partials
    out["m_ckpt"] = _round_trip("jamba_1_5_large", m12, ckpt_dir,
                                capacity_rules(), with_plain=True)
    return out


def capacity_rules(**kw):
    """``make_rules(**kw)`` with the expert-parallel dispatch off: an MoE
    layer under tensor parallelism takes the capacity path, its experts
    and shared experts over "model"."""
    return dataclasses.replace(make_rules(**kw), moe_ep=False)


def _round_trip(arch, mesh, ckpt_dir, rules=None, with_plain=False):
    """A tp-2 state after one step, saved (``gather_state``: rank 0
    writes the whole) and restored into another seed's state on the same
    mesh (``shard_state``): whether every leaf of the params and the
    moments is back bit for bit, and the leaves compared.  With
    ``with_plain`` also rank 0's whole params after the run and their
    largest gap to the ``mesh=None`` run's, leaf by leaf.  ``rules``:
    ``make_rules()`` by default."""
    cfg = cfg_of(arch)
    rules = rules or make_rules()
    got = train_run(cfg, 1, mesh, rules)
    root = os.path.join(ckpt_dir, f"x_{arch}")
    CK.AsyncCheckpointer(root).save(got["state"], 1, block=True,
                                    plan=got["step"].plan)
    torch.distributed.barrier()
    like, _ = ST.init_train_state(SEED + 1, cfg, OPT, device="cpu",
                                  mesh=mesh, rules=rules)
    back, at = CK.restore(os.path.join(root, "ckpt_1"), like, "cpu",
                          plan=got["step"].plan)
    pairs = [(a, b) for key in ("params", "opt")
             for (_, a), (_, b) in zip(named_leaves(got["state"][key]),
                                       named_leaves(back[key]))
             if isinstance(a, torch.Tensor)]
    out = (at, all(torch.equal(a, b) for a, b in pairs), len(pairs))
    if not with_plain:
        return out
    whole = _whole_params(got["state"], got["step"].plan)
    plain = dict(named_leaves(train_run(cfg, 1)["state"]["params"]))
    gaps = None if whole is None else {
        p: float(np.abs(w - plain[p].detach().numpy()).max())
        for p, w in whole.items()}
    return out + (whole, gaps)


def staged(mesh):
    """The staged forms of all-gather and reduce-scatter (what a gloo
    group does with a CUDA tensor: an all-to-all over ``C.LANES`` groups
    through host buffers) on host tensors, against gloo's own, bit for
    bit, over a shape the lanes split unevenly and one smaller than the
    lane count."""
    g = C.axis_group(mesh, "data")
    gen = torch.Generator().manual_seed(7 + g.rank)
    out = []
    for shape, dt in (((6, 37), torch.float32), ((3,), torch.bfloat16)):
        x = torch.randn(shape, generator=gen).to(dt)
        full = torch.empty((g.size * x.numel(),), dtype=dt)
        torch.distributed.all_gather_into_tensor(full, x.reshape(-1),
                                                 group=g.group)
        got = C._staged_all_gather(x.reshape(-1), g).reshape(-1)
        y = torch.cat([x.reshape(-1)] * g.size) * (g.rank + 1)
        rs = torch.empty((x.numel(),), dtype=dt)
        torch.distributed.reduce_scatter_tensor(rs, y, group=g.group)
        out.append((torch.equal(got, full), torch.equal(
            C._staged_reduce_scatter(y, g), rs)))
    return out


def _numpy(params):
    """{path: array} of a params tree."""
    return {p: t.detach().numpy() for p, t in named_leaves(params)}


def _whole_params(state, plan):
    """Rank 0's whole params, {path: array} (None elsewhere)."""
    got = CK.gather_state({"params": state["params"]}, plan)
    return None if got is None else _numpy(got["params"])


def four(rank, ref_params, ckpt_dir, x_params):
    """4 ranks: dp 2 x tp 2 and the multipod rules on (2, 1, 2); the
    collective budget at 1 and 2 layers, with and without remat; the
    reference's weights at dp 2 x tp 2; a run saved at step 2 on (2, 2)
    and resumed on (4, 1); ``launch.train.train`` on the production rules
    over a (2, 2) host mesh; ``elastic_mesh`` over 4 ranks."""
    out = {}
    yi = cfg_of("yi_6b")
    plain = train_run(yi, 1)
    m22 = mesh_of((2, 2))
    out["dp2xtp2"] = compare(plain, yi, 1, m22, make_rules())
    out["multipod"] = compare(plain, yi, 1, mesh_of((2, 1, 2)),
                              make_rules(multi_pod=True))
    # tp 4 above the 2 KV heads: the KV leaves whole over "model", each
    # rank's head sliced, their gradients summed over "model"
    out["tp4_kv"] = compare(plain, yi, 1, mesh_of((1, 4)), make_rules())
    out["tp4_kv_slices"] = ST.make_train_step(
        yi, OPT, mesh=mesh_of((1, 4)), rules=make_rules()).plan.kv_slices
    for layers in (1, 2):
        for remat in (False, True):
            cfg = cfg_of("yi_6b", layers, remat)
            got = train_run(cfg, 2, m22, make_rules())
            out["budget", layers, remat] = (
                got["counts"], got["step"].plan.collective_budget(
                    2, seq_len=SEQ, remat=remat, mse=True, steps=STEPS))
    # the reference's weights, the reference's batches
    plan = ST.make_train_step(yi, OPT, mesh=m22, rules=make_rules()).plan
    whole = convert.from_reference(ref_params, device="cpu")
    for path, p in named_leaves(whole):
        p.requires_grad_(not adamw.is_frozen(path))
    state = CK.shard_state({"params": whole, "opt": adamw.init(OPT, whole),
                            "step": 0}, plan)
    out["reference"] = train_run(yi, 1, m22, make_rules(),
                                 state=state)["metrics"]
    m14 = mesh_of((1, 4))
    plan = ST.make_train_step(yi, OPT, mesh=m14, rules=make_rules()).plan
    whole = convert.from_reference(ref_params, device="cpu")
    for path, p in named_leaves(whole):
        p.requires_grad_(not adamw.is_frozen(path))
    state = CK.shard_state({"params": whole, "opt": adamw.init(OPT, whole),
                            "step": 0}, plan)
    out["reference_tp4"] = train_run(yi, 1, m14, make_rules(),
                                     state=state)["metrics"]
    # elastic checkpoints: save at step 2 on (2, 2), resume on (4, 1)
    state, _ = ST.init_train_state(SEED, yi, OPT, device="cpu", mesh=m22,
                                   rules=make_rules())
    step = ST.make_train_step(yi, OPT, mesh=m22, rules=make_rules())
    bs = batches(yi, 4)
    ck = CK.AsyncCheckpointer(ckpt_dir)
    full = []
    for i, b in enumerate(bs):
        state, m = step(state, b)
        full.append(_metrics(m))
        if i == 1:
            ck.save(state, 2, block=True, plan=step.plan)
    out["uninterrupted"] = full
    out["final"] = _whole_params(state, step.plan)
    m41 = mesh_of((4, 1))
    like, _ = ST.init_train_state(SEED + 1, yi, OPT, device="cpu", mesh=m41,
                                  rules=make_rules())
    step41 = ST.make_train_step(yi, OPT, mesh=m41, rules=make_rules())
    state, at = CK.restore(os.path.join(ckpt_dir, "ckpt_2"), like, "cpu",
                           plan=step41.plan)
    resumed = []
    for b in bs[at:]:
        state, m = step41(state, b)
        resumed.append(_metrics(m))
    out["resumed_4x1"] = (at, resumed, _whole_params(state, step41.plan))
    # the CLI's training function on the production rules, (2, 2) mesh
    argv = ["--arch", "yi_6b", "--reduced", "--steps", "3", "--seq",
            str(SEQ), "--batch", str(BATCH), "--data", "lm", "--device",
            "cpu", "--log-interval", "1"]
    out["cli"] = (LT.train(LT.parse_args(argv)).metrics,
                  LT.train(LT.parse_args(argv), m22, make_rules()).metrics)
    out["elastic"] = tuple(elastic_mesh().mesh.shape)
    for arch in MARCHS:
        cfg = cfg_of(arch)
        out["m_dp2xtp2", arch] = compare(train_run(cfg, 1), cfg, 1, m22,
                                         capacity_rules())
    # the cross-attention and RWKV6 archs at dp 2 x tp 2, and on the
    # reference's weights (its cross gates at XGATE) and batches
    for arch in XARCHS:
        cfg = cfg_of(arch)
        out["x_dp2xtp2", arch] = compare(train_run(cfg, 1), cfg, 1, m22,
                                         make_rules())
        plan = ST.make_train_step(cfg, OPT, mesh=m22,
                                  rules=make_rules()).plan
        whole = convert.from_reference(x_params[arch], device="cpu")
        for path, p in named_leaves(whole):
            p.requires_grad_(not adamw.is_frozen(path))
        state = CK.shard_state({"params": whole, "opt": adamw.init(OPT, whole),
                                "step": 0}, plan)
        out["x_reference", arch] = train_run(cfg, 1, m22, make_rules(),
                                             state=state)["metrics"]
    return out


def one(rank, ckpt_dir):
    """1 rank: the step-2 checkpoint of ``four`` resumed on a (1, 1) mesh
    under ``make_rules()`` and at ``mesh=None``, 2 steps each; and the
    sharded path on (1, 1) (every collective a group of one) against
    ``mesh=None``, 2 microbatches with remat."""
    out = {}
    yi = cfg_of("yi_6b")
    bs = batches(yi, 4)
    m11 = mesh_of((1, 1))
    for name, mesh in (("1x1", m11), ("none", None)):
        rules = make_rules() if mesh is not None else None
        like, _ = ST.init_train_state(SEED + 1, yi, OPT, device="cpu",
                                      mesh=mesh, rules=rules)
        step = ST.make_train_step(yi, OPT, mesh=mesh, rules=rules)
        state, at = CK.restore(os.path.join(ckpt_dir, "ckpt_2"), like,
                               "cpu", plan=step.plan)
        metrics = []
        for b in bs[at:]:
            state, m = step(state, b)
            metrics.append(_metrics(m))
        out[name] = (at, metrics, _numpy(state["params"]))
    rem = cfg_of("yi_6b", remat=True)
    runs = [train_run(rem, 2, mesh, make_rules()) for mesh in (None, m11)]
    want = dict(named_leaves(runs[0]["state"]["params"]))
    out["world1"] = (
        runs[0]["metrics"] == runs[1]["metrics"],
        all(torch.equal(runs[0]["after1"][p], t)
            for p, t in runs[1]["after1"].items()),
        all(torch.equal(want[p], t)
            for p, t in named_leaves(runs[1]["state"]["params"])))
    out["world1_budget"] = (runs[1]["counts"],
                            runs[1]["step"].plan.collective_budget(
                                2, seq_len=SEQ, remat=True, mse=True,
                                steps=STEPS))
    return out


@contextlib.contextmanager
def _backend_unseen():
    """The process group's own calls run with the dispatch modes off: gloo
    stages a gathered or scattered tensor through copies of its own
    (aten ``copy_``), which NCCL does not make and the fake backend of
    the dry run does not either."""
    from torch.utils._python_dispatch import _disable_current_modes
    dist = torch.distributed

    def hidden(fn):
        def call(*a, **k):
            with _disable_current_modes():
                return fn(*a, **k)
        return call

    names = ("all_reduce", "reduce_scatter_tensor", "all_to_all_single")
    saved = {n: getattr(dist, n) for n in names}
    flat = C._gather_flat
    try:
        for n in names:
            setattr(dist, n, hidden(saved[n]))
        C._gather_flat = hidden(flat)
        yield
    finally:
        for n in names:
            setattr(dist, n, saved[n])
        C._gather_flat = flat


def dryrun_real(rank):
    """The dry run's counters (``launch.dryrun.counted``) over one real
    train step of reduced yi_6b at (2, 2) under ``make_rules()``, 2
    microbatches of the dry run's own batch (``dryrun._train_batch``):
    FLOPs, bytes, the recorded collectives, the counters and the
    budget, and the bytes of this rank's params and moments."""
    from repro_torch.launch import dryrun as DR
    yi = cfg_of("yi_6b")
    mesh, rules = mesh_of((2, 2)), make_rules()
    state, _ = ST.init_train_state(SEED, yi, OPT, device="cpu", mesh=mesh,
                                   rules=rules)
    step = ST.make_train_step(yi, OPT, ST.default_flags(yi),
                              microbatches=2, mesh=mesh, rules=rules)
    batch = DR._train_batch(yi, DRYRUN_SHAPE, BATCH)
    before = C.snapshot()
    with _backend_unseen(), DR.counted((state, batch)) as res:
        step(state, batch)
    return dict(flops=res["flops"], bytes=res["bytes"], peak=res["peak"],
                colls=[dataclasses.astuple(r) for r in res["colls"]],
                counts=C.count_by_axis(before),
                budget=step.plan.collective_budget(
                    2, seq_len=SEQ, remat=yi.remat, mse=True),
                state_bytes=tree_bytes(state["params"])
                + tree_bytes(state["opt"]["m"])
                + tree_bytes(state["opt"]["v"]))


def run(rank, name, *args):
    return {"two": two, "four": four, "one": one,
            "dryrun": dryrun_real}[name](rank, *args)


# -- on the card (tests/test_torch_cuda.py, ``cuda`` marker) -------------------


def step_pair(cfg, mesh, rules, mb=1, dev="cpu"):
    """One step unsharded and one on ``mesh`` on ``dev``: (metrics pair,
    one microbatch's gradient gaps, update gaps, counts against the
    budget, whether the two are the same bits)."""
    b = batches(cfg, 1)
    runs = []
    for m in (None, mesh):
        state, _ = ST.init_train_state(SEED, cfg, OPT, device=dev, mesh=m,
                                       rules=rules if m is not None
                                       else None)
        step = ST.make_train_step(cfg, OPT, microbatches=mb, mesh=m,
                                  rules=rules if m is not None else None)
        grads, _ = ST.accumulate_grads(state["params"], cfg,
                                       ST.default_flags(cfg), b[0], 1,
                                       step.plan)
        before = C.snapshot()
        state, met = step(state, b[0])
        runs.append(dict(metrics=[_metrics(met)], step=step,
                         counts=C.count_by_axis(before),
                         grads=dict(named_leaves(grads)),
                         params=dict(named_leaves(state["params"]))))
    (plain, got), plan = runs, runs[1]["step"].plan
    return dict(
        metrics=(plain["metrics"], got["metrics"]),
        grads={p: _rel(g, plan.shard(plain["grads"][p], p))
               for p, g in got["grads"].items()},
        params={p: _update_gap(t, plan.shard(plain["params"][p], p))
                for p, t in got["params"].items()},
        budget=(got["counts"], plan.collective_budget(
            mb, seq_len=SEQ, remat=cfg.remat, mse=cfg.dsa.enabled)),
        bitwise=plain["metrics"] == got["metrics"] and all(
            torch.equal(t, plan.shard(plain["params"][p], p))
            for p, t in got["params"].items()))


def _card():
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def card_fsdp2(rank):
    """FSDP 2 (``make_rules(tp=False)`` on (2, 1)) as two gloo processes
    on the one card: reduced yi_6b, f32, one step."""
    return step_pair(cfg_of("yi_6b"), mesh_of((2, 1)), make_rules(tp=False),
                     dev=_card())


def card_nccl1_train(rank):
    """NCCL at world size 1 on a (1, 1) mesh under ``make_rules()``:
    reduced yi_6b, f32, one step of 2 microbatches."""
    return step_pair(cfg_of("yi_6b"), mesh_of((1, 1)), make_rules(), mb=2,
                     dev=_card())

