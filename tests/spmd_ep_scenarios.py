"""Expert-parallel training scenarios run by every rank of a spawned
process group (``repro_torch.launch.mesh.run_spmd``) for
tests/test_torch_multidevice_ep.py.

Each rank runs the same program: the unsharded training step
(``mesh=None``) and the step on a mesh whose "model" axis takes the
reference's expert-parallel dispatch (two all-to-alls over "model" a
MoE layer), from the same seed on the same global batches; ``run``
returns what the tests assert on.  The module imports torch, numpy and
the port only: the spawned ranks never import JAX.
"""
from __future__ import annotations

import dataclasses
import os

import torch

from repro_torch import convert
from repro_torch.checkpoint import checkpoint as CK
from repro_torch.data.synthetic import DataConfig, lm_batches
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import make_rules, tree_bytes
from repro_torch.launch import train as LT
from repro_torch.models import moe
from repro_torch.optim import adamw
from repro_torch.training import steps as ST
from repro_torch.tree import map_tree, named_leaves

import spmd_train_scenarios as S

# The reference's sharded training against the port's, on four ranks of
# (2, 2), the router term on: the capacity factor DROP_CF (pairs drop on
# every path here) and, where the losses must be the reference's, one
# expert a rank of "model" (E / n = 1, where the reference's reshape of
# the received buffer is right, ROADMAP Queue 3) routed top 1 (below E,
# so that routing decides the drops and the router term varies);
# "mixtral_8x22b_tp_e4" keeps the reduced E 4, top 2, where it is not.
# "grads": the routers' gradients at the first batch; "probe": the
# reference's EP layer against its unsharded layer at no drops; "dsa":
# False turns DSA off in both packages (jamba's: with the experts drawn
# with fan-in E 2, its predictor's 4-bit levels flip on the packages'
# last-bit differences by the third step and only the MSE term departs,
# ROADMAP Queue 3 "fan-in E").
DROP_CF = 1.0
REF_MOE = dict(num_experts=2, top_k=1)
REF_ARCHS = ("mixtral_8x22b", "deepseek_v3", "jamba_1_5_large")
# the archs whose other layers took a tensor-parallel form after EP's:
# MLA with its shared experts, and Mamba
TP_ARCHS = ("deepseek_v3", "jamba_1_5_large")
# the (arch, case) pairs of EP x TP beside the other layers' TP forms
EP_TP_CASES = (("deepseek_v3", "tp2"), ("deepseek_v3", "tp2_nosp"),
               ("deepseek_v3", "tp2_remat"), ("jamba_1_5_large", "tp2_remat"))
REF_CASES = (
    [dict(name="mixtral_8x22b_tp", arch="mixtral_8x22b", tp=True,
          moe=REF_MOE, dsa=True, grads=True),
     dict(name="mixtral_8x22b_tp_e4", arch="mixtral_8x22b", tp=True,
          moe={}, dsa=True, probe=True)]
    + [dict(name=f"{a}_fsdp", arch=a, tp=False, moe=REF_MOE,
            dsa=a != "jamba_1_5_large") for a in REF_ARCHS]
    + [dict(name=f"{a}_tp", arch=a, tp=True, moe=REF_MOE,
            dsa=a != "jamba_1_5_large") for a in TP_ARCHS])


def ep_cfg(arch="mixtral_8x22b", *, aux=0.0, dsa=False, remat=False,
           cf=None, moe=None):
    """A reduced arch with the router term's weight ``aux`` (None: the
    config's), DSA on or off, ``cf`` as its capacity factor (None: the
    reduced 8.0, at which no pair drops on any path here) and the MoE
    fields ``moe``."""
    cfg = S.cfg_of(arch, remat=remat)
    mo = dataclasses.replace(cfg.moe, **(moe or {}))
    if aux is not None:
        mo = dataclasses.replace(mo, router_aux_weight=aux)
    if cf is not None:
        mo = dataclasses.replace(mo, capacity_factor=cf)
    cfg = dataclasses.replace(cfg, moe=mo)
    if not dsa:
        cfg = dataclasses.replace(cfg, dsa=dataclasses.replace(
            cfg.dsa, enabled=False))
    return cfg


def batches(cfg, seq, n=S.STEPS):
    data = lm_batches(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                 global_batch=S.BATCH, seed=0))
    return [next(data) for _ in range(n)]


def _expert(path):
    return "/mlp/w" in path and "/groups/" in path


def train_run(cfg, mesh=None, rules=None, *, seq=S.SEQ, flags=None,
              state=None, n=S.STEPS):
    """(each step's metrics, one microbatch's gradients before any
    update, the params after the first update, the final state, the
    counts, the step)."""
    flags = flags or ST.default_flags(cfg)
    if state is None:
        state, _ = ST.init_train_state(S.SEED, cfg, S.OPT, device="cpu",
                                       mesh=mesh, rules=rules)
    step = ST.make_train_step(cfg, S.OPT, flags, mesh=mesh, rules=rules)
    bs = batches(cfg, seq, n)
    grads, _ = ST.accumulate_grads(state["params"], cfg, flags, bs[0], 1,
                                   step.plan)
    grads = {p: g.detach().clone() for p, g in named_leaves(grads)}
    metrics, after1 = [], None
    before = C.snapshot()
    for b in bs:
        state, m = step(state, b)
        metrics.append(S._metrics(m))
        if after1 is None:
            after1 = {p: t.detach().clone()
                      for p, t in named_leaves(state["params"])}
    return dict(metrics=metrics, grads=grads, after1=after1, state=state,
                counts=C.count_by_axis(before), step=step)


def compare(plain, cfg, mesh, rules, *, seq=S.SEQ, flags=None):
    """A sharded run against ``plain`` (``train_run`` unsharded): the
    metrics, each leaf's gradient gap, the update gaps, the counters
    against the budget, whether the step took EP, and the bytes of the
    expert leaves this rank holds against the unsharded ones."""
    got = train_run(cfg, mesh, rules, seq=seq, flags=flags)
    plan = got["step"].plan
    st, whole = got["state"], plain["state"]

    def experts(tree):
        return sum(t.numel() * t.element_size()
                   for p, t in named_leaves(tree) if _expert(p))

    return dict(
        metrics=(plain["metrics"], got["metrics"]),
        grads={p: S._rel(g, plan.shard(plain["grads"][p], p))
               for p, g in got["grads"].items()},
        params={p: S._update_gap(t, plan.shard(plain["after1"][p], p))
                for p, t in got["after1"].items()},
        budget=(got["counts"], plan.collective_budget(
            1, seq_len=seq, remat=cfg.remat, mse=cfg.dsa.enabled,
            steps=S.STEPS)),
        ep=plan.ep_active(seq),
        experts=dict(params=experts(st["params"]),
                     grads=sum(g.numel() * g.element_size()
                               for p, g in got["grads"].items()
                               if _expert(p)),
                     moments=experts(st["opt"]["m"])
                     + experts(st["opt"]["v"]),
                     whole=experts(whole["params"])))


def exchange_check(mesh):
    """The differentiable all-to-all over "model": forward, backward
    (against the all-to-all of the cotangent) and the counters; and the
    staged exchange (a gloo group's path for CUDA tensors) against
    gloo's own ``all_to_all_single``, bit for bit."""
    g = C.axis_group(mesh, "model")
    gen = torch.Generator().manual_seed(11 + g.rank)
    x = torch.randn((g.size, 3, 5), generator=gen, requires_grad=True)
    before = C.snapshot()
    y = C.exchange(x, g)
    ct = torch.randn(y.shape, generator=gen)
    y.backward(ct)
    counts = C.count_by_axis(before)
    # block q of y came from rank q: that rank's block for this rank
    mine = [q * 1000 + g.rank for q in range(g.size)]
    tag = torch.tensor([[g.rank * 1000 + q] for q in range(g.size)],
                       dtype=torch.float32)
    moved = C.all_to_all(tag, g)[:, 0].tolist() == mine
    want = torch.empty_like(ct)
    torch.distributed.all_to_all_single(want, ct.contiguous(),
                                        group=g.group)
    staged = torch.equal(C._exchange(ct.reshape(g.size, -1), g),
                         want.reshape(g.size, -1))
    return dict(moved=moved, backward=torch.equal(x.grad, want),
                counts=counts, staged=staged)


def two(rank, ckpt_dir):
    """2 ranks on (1, 2): the all-to-all; mixtral EP at tp 2 with and
    without sequence parallelism, with remat, under ``make_rules(tp=
    False)``, and on the DSA block path, against ``mesh=None`` (no drops,
    the router term off); the capacity path at tp 2 on a sequence "model"
    does not divide (the router term on); the expert bytes; a checkpoint
    saved under EP and resumed on (2, 1) and at ``mesh=None``."""
    out = {}
    m12 = S.mesh_of((1, 2))
    out["exchange"] = exchange_check(m12)
    cfg = ep_cfg()
    plain = train_run(cfg)
    for name, rules in (("tp2", make_rules()),
                        ("tp2_nosp", make_rules(seq_parallel=False)),
                        ("fsdp2", make_rules(tp=False))):
        out[name] = compare(plain, cfg, m12, rules)
    rem = ep_cfg(remat=True)
    out["tp2_remat"] = compare(train_run(rem), rem, m12, make_rules())
    blk = ep_cfg(dsa=True)
    out["tp2_block"] = compare(train_run(blk), blk, m12, make_rules())
    odd = ep_cfg(aux=0.01)
    out["tp2_capacity"] = compare(train_run(odd, seq=S.SEQ - 1), odd, m12,
                                  make_rules(), seq=S.SEQ - 1)
    out["checkpoint"] = checkpoint_case(cfg, m12, ckpt_dir)
    # EP x TP beside MLA and the shared experts' TP form (deepseek_v3: with
    # and without SP, with remat) and beside Mamba (jamba_1_5_large: with
    # remat, where the router term's mean runs again)
    for arch, case in EP_TP_CASES:
        if case == "tp2_remat":
            rem = ep_cfg(arch, remat=True)
            out[case, arch] = compare(train_run(rem), rem, m12, make_rules())
            continue
        acfg = ep_cfg(arch)
        rules = make_rules(seq_parallel=case == "tp2")
        out[case, arch] = compare(train_run(acfg), acfg, m12, rules)
    return out


def checkpoint_case(cfg, m12, ckpt_dir):
    """Saved at step 2 under EP on (1, 2), resumed on (2, 1) (the capacity
    path) and at ``mesh=None``: steps 3-4 and the final params, against
    the uninterrupted EP run's."""
    rules = make_rules()
    step = ST.make_train_step(cfg, S.OPT, mesh=m12, rules=rules)
    state, _ = ST.init_train_state(S.SEED, cfg, S.OPT, device="cpu",
                                   mesh=m12, rules=rules)
    bs = batches(cfg, S.SEQ, 4)
    ck = CK.AsyncCheckpointer(ckpt_dir)
    full = []
    for i, b in enumerate(bs):
        state, m = step(state, b)
        full.append(S._metrics(m))
        if i == 1:
            ck.save(state, 2, block=True, plan=step.plan)
    out = dict(uninterrupted=full, final=S._whole_params(state, step.plan),
               split=step.plan.axes["/groups/0/b0/mlp/w1"])
    for name, mesh in (("2x1", S.mesh_of((2, 1))), ("none", None)):
        r = rules if mesh is not None else None
        like, _ = ST.init_train_state(S.SEED + 1, cfg, S.OPT, device="cpu",
                                      mesh=mesh, rules=r)
        st = ST.make_train_step(cfg, S.OPT, mesh=mesh, rules=r)
        got, at = CK.restore(os.path.join(ckpt_dir, "ckpt_2"), like, "cpu",
                             plan=st.plan)
        ms = []
        for b in bs[at:]:
            got, m = st(got, b)
            ms.append(S._metrics(m))
        final = (S._numpy(got["params"]) if mesh is None
                 else S._whole_params(got, st.plan))
        out[name] = (at, ms, final)
    return out


def _with_weights(cfg, plan, ref):
    """The training state on ``plan`` from the reference's weights."""
    whole = convert.from_reference(ref, device="cpu")
    for path, p in named_leaves(whole):
        p.requires_grad_(not adamw.is_frozen(path))
    return CK.shard_state({"params": whole, "opt": adamw.init(S.OPT, whole),
                           "step": 0}, plan)


def reference_case(case, ref):
    """One of ``REF_CASES`` on the reference's weights and batches at
    ``DROP_CF`` with the router term on: each step's metrics and the
    (dropped, routed) pairs of their EP dispatches, and with "grads" the
    routers' whole gradients at the first batch and each rank's router
    term before the metrics' reduction."""
    cfg = ep_cfg(case["arch"], aux=None, dsa=case["dsa"], cf=DROP_CF,
                 moe=case["moe"])
    mesh, rules = S.mesh_of((2, 2)), make_rules(tp=case["tp"])
    flags = ST.default_flags(cfg)
    step = ST.make_train_step(cfg, S.OPT, flags, mesh=mesh, rules=rules)
    plan = step.plan
    state = _with_weights(cfg, plan, ref)
    bs = batches(cfg, S.SEQ)
    out = {}
    if case.get("grads"):
        grads, _ = ST.accumulate_grads(state["params"], cfg, flags, bs[0],
                                       1, plan)
        out["router_grads"] = [
            plan.whole(g, p).detach().numpy()
            for p, g in named_leaves(grads) if p.endswith("/mlp/router")]
        lf = plan.run_flags(flags, S.SEQ, S.BATCH)
        with torch.no_grad():
            _, m = ST.loss_fn(state["params"], plan.cfg, lf,
                              ST._on(plan.local_rows(bs[0]), "cpu"))
        out["router_local"] = float(m["router_aux"])
    out["metrics"] = []
    moe.ep_drops(reset=True)
    for b in bs:
        state, m = step(state, b)
        out["metrics"].append(S._metrics(m))
    out["drops"] = moe.ep_drops()
    return out


def cli_case(m22):
    """``launch.train.train`` on the production rules over a (2, 2) host
    mesh on reduced mixtral, and the same run through ``make_train_step``:
    each one's metrics, the CLI run's counts and their budget."""
    argv = ["--arch", "mixtral_8x22b", "--reduced", "--steps", "3",
            "--seq", str(S.SEQ), "--batch", str(S.BATCH), "--data", "lm",
            "--device", "cpu", "--log-interval", "1"]
    before = C.snapshot()
    res = LT.train(LT.parse_args(argv), m22, make_rules())
    counts = C.count_by_axis(before)
    cfg = S.cfg_of("mixtral_8x22b")
    opt = adamw.OptConfig(lr=3e-4, total_steps=3, warmup_steps=1)
    step = ST.make_train_step(cfg, opt, mesh=m22, rules=make_rules())
    state, _ = ST.init_train_state(0, cfg, opt, device="cpu", mesh=m22,
                                   rules=make_rules())
    direct = [S._metrics(step(state, b)[1]) for b in batches(cfg, S.SEQ)]
    return dict(cli=res.metrics, direct=direct, counts=counts,
                budget=step.plan.collective_budget(
                    1, seq_len=S.SEQ, remat=cfg.remat, mse=True, steps=3))


def four(rank, refs):
    """4 ranks on (2, 2): mixtral EP at dp 2 x tp 2 and under
    ``make_rules(tp=False)`` against ``mesh=None``; ``REF_CASES`` on the
    reference's weights ``refs`` (by case name); the CLI's training
    function."""
    out = {}
    m22 = S.mesh_of((2, 2))
    cfg = ep_cfg()
    plain = train_run(cfg)
    out["dp2xtp2"] = compare(plain, cfg, m22, make_rules())
    out["fsdp4"] = compare(plain, cfg, m22, make_rules(tp=False))
    ds = ep_cfg("deepseek_v3")
    out["dp2xtp2", "deepseek_v3"] = compare(train_run(ds), ds, m22,
                                            make_rules())
    for case in REF_CASES:
        out["ref", case["name"]] = reference_case(case, refs[case["name"]])
    out["cli"] = cli_case(m22)
    return out


def run(rank, name, *args):
    return {"two": two, "four": four}[name](rank, *args)


# -- on the card (tests/test_torch_cuda.py, ``cuda`` marker) -------------------


def card_ep2(rank):
    """EP 2 x TP 2 + SP (``make_rules()`` on (1, 2)) as two gloo processes
    on the one card against the same EP run on the CPU, reduced mixtral,
    f32, 2 steps: each one's losses and the card run's counts against
    the budget."""
    cfg = ep_cfg(aux=0.01)
    m12 = S.mesh_of((1, 2))
    out = {}
    for name, dev in (("cpu", "cpu"), ("card", S._card())):
        # drawn on the CPU both times: a card's generator draws other
        # numbers from the same seed
        state, _ = ST.init_train_state(S.SEED, cfg, S.OPT, device="cpu",
                                       mesh=m12, rules=make_rules())
        state["params"] = map_tree(
            lambda t: t.detach().to(dev).requires_grad_(t.requires_grad),
            state["params"])
        for k in ("m", "v"):
            state["opt"][k] = map_tree(lambda t: t.to(dev),
                                       state["opt"][k])
        step = ST.make_train_step(cfg, S.OPT, mesh=m12, rules=make_rules())
        before = C.snapshot()
        out[name] = [S._metrics(step(state, b)[1])
                     for b in batches(cfg, S.SEQ, 2)]
        out[name, "counts"] = C.count_by_axis(before)
        out[name, "budget"] = step.plan.collective_budget(
            1, seq_len=S.SEQ, remat=cfg.remat, mse=False, steps=2)
    out["bytes"] = tree_bytes(state["params"])
    return out

