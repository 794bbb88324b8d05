"""Expert-parallel MoE training in the port: the reference's EP dispatch
(two all-to-alls over "model" a MoE layer, ``models/moe.py``) in real
process groups, against the port's own ``mesh=None`` training and the
reference's sharded training.

Each process group is spawned once per module (``launch.mesh.run_spmd``,
gloo on the CPU) and runs the scenarios of ``spmd_ep_scenarios.py``: 2
ranks on (1, 2) (the differentiable all-to-all; mixtral EP at tp 2 with
and without sequence parallelism, with remat, under ``make_rules(tp=
False)`` and on the DSA block path; the capacity path at tp 2; a
checkpoint saved under EP) and 4 ranks on (2, 2) (EP at dp 2 x tp 2 and
under ``make_rules(tp=False)``; the reference's weights with drops and
the router term on; the CLI's training function).

What must hold, in f32 at reduced width: with no pair dropped and the
router term off (the EP capacity and the Switch term are other
functions of the batch than the unsharded path's, by design), the EP
losses, each leaf's gradient shard and the params after one update
equal ``mesh=None``'s within ``REL``, in the "expert" layout.  With DSA
off the three steps' losses; on the block path the first step (the
predictor's 4-bit levels turn a last-bit difference of the large hidden
states, ROADMAP Queue 3 "fan-in E", into other blocks once the updates
differ).  The reference's own sharded steps (subprocesses with four
forced host devices, capacity factor ``DROP_CF`` so that pairs drop,
the router term on) give the port's losses where the reference's EP
reshape is right, one expert a rank of "model" (``REF_MOE``).
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models.transformer import init_model as ref_init_model
from repro_torch.configs.base import get_config, reduced
from repro_torch.distributed import collectives as C
from repro_torch.launch.mesh import run_spmd

import spmd_ep_scenarios as E
import spmd_train_scenarios as S

TIMEOUT_S = 240
SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
# f32 at reduced width, as tests/test_torch_multidevice_train.py's (the
# aim, predicted before the first run; measured ~1e-7 on the losses,
# ~1e-6 of a leaf's largest gradient, the updates within 2 lr)
REL = 1e-5
PARAM_SHARE = 0.99

# the reference's sharded training on four forced host devices
# (make_rules(tp=...) on a (2, 2) mesh of Auto axes, the state placed by
# its tree_specs, its jitted step), each case of spmd_ep_scenarios'
# REF_CASES with its MoE fields and the capacity factor lowered
REF_SCRIPT = r"""
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config, reduced
from repro.data.synthetic import DataConfig, lm_batches
from repro.distributed.sharding import (make_rules, mesh_context,
                                        set_rules, tree_specs)
from repro.models import moe as M
from repro.models.attention import RunFlags
from repro.optim import adamw
from repro.training import steps as ST
spec = json.loads(sys.argv[1])
opt = adamw.OptConfig(**spec["opt"])
out = {}
for case in spec["cases"]:
    cfg = reduced(get_config(case["arch"]))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=spec["cf"], **case["moe"]))
    cfg = dataclasses.replace(cfg, dsa=dataclasses.replace(
        cfg.dsa, enabled=cfg.dsa.enabled and case["dsa"]))
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    rules = make_rules(tp=case["tp"])
    set_rules(rules)
    data = lm_batches(DataConfig(vocab=cfg.vocab, seq_len=spec["seq"],
                                 global_batch=spec["batch"], seed=0))
    res = {}
    with mesh_context(mesh):
        state, log = ST.init_train_state(jax.random.PRNGKey(0), cfg, opt)
        specs = tree_specs(state, log, rules, mesh)
        state = jax.tree.map(
            lambda x, s: jax.device_put(x, jax.NamedSharding(mesh, s)),
            state, specs)
        batch = next(data)
        if case.get("grads"):
            flags = RunFlags(mode="train", dsa_mode="block")
            g = jax.jit(jax.grad(
                lambda p, b: ST.loss_fn(p, cfg, flags, b)[0]))(
                    state["params"], batch)
            res["router_grads"] = np.asarray(
                g["groups"]["b0"]["mlp"]["router"]).tolist()
        step = jax.jit(ST.make_train_step(cfg, opt),
                       in_shardings=(specs, None), donate_argnums=(0,))
        res["metrics"] = []
        for _ in range(spec["steps"]):
            state, m = step(state, batch)
            res["metrics"].append({k: float(v) for k, v in m.items()})
            batch = next(data)
    if case.get("probe"):
        c8 = reduced(get_config(case["arch"]))
        p, _ = M.init_moe(jax.random.PRNGKey(0), c8)
        x = jax.random.normal(jax.random.PRNGKey(1), (2, 32, c8.d_model))
        y0, _ = M.apply_moe(p, c8, x)
        with mesh_context(mesh):
            y1, _ = jax.jit(lambda p, x: M.apply_moe(p, c8, x))(p, x)
        res["probe"] = [float(jnp.abs(y1 - y0).max()),
                        float(jnp.abs(y0).max())]
    out[case["name"]] = res
print(json.dumps(out))
"""

# two subprocesses, run side by side
REF_SPLIT = (E.REF_CASES[:4], E.REF_CASES[4:])


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return str(tmp_path_factory.mktemp("spmd_ep"))


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ckpt_ep"))


@pytest.fixture(scope="module")
def reference():
    """(the reference subprocesses, running; each arch's weights as
    numpy)."""
    opt = dict(lr=S.OPT.lr, total_steps=S.OPT.total_steps,
               warmup_steps=S.OPT.warmup_steps)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = []
    for cases in REF_SPLIT:
        spec = dict(opt=opt, seq=S.SEQ, batch=S.BATCH, steps=S.STEPS,
                    cf=E.DROP_CF, cases=cases)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", REF_SCRIPT, json.dumps(spec)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    weights = {}
    for case in E.REF_CASES:
        cfg = ref_reduced(ref_get_config(case["arch"]))
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **case["moe"]),
            dsa=dataclasses.replace(cfg.dsa, enabled=cfg.dsa.enabled
                                    and case["dsa"]))
        params, _ = ref_init_model(jax.random.PRNGKey(0), cfg)
        weights[case["name"]] = jax.tree.map(np.asarray, params)
    yield procs, weights
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def reference_out(reference):
    out = {}
    for proc in reference[0]:
        got, err = proc.communicate(timeout=TIMEOUT_S)
        assert proc.returncode == 0, err[-3000:]
        out.update(json.loads(got.strip().splitlines()[-1]))
    return out


@pytest.fixture(scope="module")
def two(store, ckpt_dir):
    return run_spmd(E.run, 2, store_dir=store, args=("two", ckpt_dir),
                    timeout_s=TIMEOUT_S)


@pytest.fixture(scope="module")
def four(store, reference):
    return run_spmd(E.run, 4, store_dir=store,
                    args=("four", reference[1]), timeout_s=TIMEOUT_S)


def _check(res, steps=S.STEPS, rel=REL):
    """The first ``steps`` steps' metrics, one microbatch's gradients leaf
    by leaf and the params after one update (within 2 lr, ``PARAM_SHARE``
    of the elements within 1e-5) against ``mesh=None``."""
    plain, got = res["metrics"]
    for i, (a, b) in enumerate(zip(plain[:steps], got[:steps])):
        for k in ("loss", "ce", "mse", "router_aux", "grad_norm"):
            np.testing.assert_allclose(b[k], a[k], rtol=rel, atol=1e-7,
                                       err_msg=f"step {i} {k}")
    bad = {p: e for p, e in res["grads"].items() if e > rel}
    assert not bad, bad
    bad = {p: g[0] for p, g in res["params"].items() if g[0] > 2 * S.OPT.lr}
    assert not bad, bad
    within = sum(g[1] for g in res["params"].values())
    total = sum(g[2] for g in res["params"].values())
    assert within >= PARAM_SHARE * total, (within, total)


def _budget(res):
    C.check_train_collectives(*res["budget"])


# -- 2 ranks ------------------------------------------------------------------


def test_exchange_moves_blocks_and_is_its_own_adjoint(two):
    """The all-to-all sends block q to rank q; its backward is the
    all-to-all of the cotangent; forward and backward count one call
    each over "model"; the staged exchange (a gloo group's path for CUDA
    tensors) gives gloo's own all-to-all bit for bit."""
    for res in two:
        x = res["exchange"]
        assert x["moved"] and x["backward"] and x["staged"]
        assert x["counts"] == {("all-to-all", "model"): 2}


@pytest.mark.parametrize("case", ["tp2", "tp2_nosp", "fsdp2", "tp2_remat"])
def test_ep_equals_mesh_none_on_1x2(two, case):
    """mixtral EP on (1, 2): tp 2 with sequence parallelism, without it,
    with remat (the recompute runs both all-to-alls again), and under
    ``make_rules(tp=False)`` ("model" a batch axis, the experts FSDP
    leaves sliced after the gather): three steps, gradients, the update
    and the collectives against the budget."""
    for res in two:
        assert res[case]["ep"]
        _check(res[case])
        _budget(res[case])


def test_ep_block_path_first_step(two):
    """The DSA block path at tp 2: the first step's loss, its gradients
    and the update."""
    for res in two:
        assert res["tp2_block"]["ep"]
        _check(res["tp2_block"], steps=1)
        _budget(res["tp2_block"])


def test_capacity_path_at_tp2_on_an_indivisible_sequence(two):
    """Where "model" does not divide the sequence the reference's gate
    fails and the capacity path runs, each rank its E / tp experts on
    every row: equal to ``mesh=None`` with the router term on (its
    gradient counted once over "model")."""
    for res in two:
        r = res["tp2_capacity"]
        assert not r["ep"]
        assert r["budget"][0].get(("all-to-all", "model"), 0) == 0
        _check(r)
        _budget(r)


@pytest.mark.parametrize("case", ["tp2", "fsdp2"])
def test_ep_expert_bytes(two, case):
    """Under tp 2 a rank's expert params, gradients and moments are its
    E / 2 experts: half the unsharded bytes; under ``make_rules(tp=
    False)`` on (1, 2) likewise, as FSDP shards."""
    for res in two:
        b = res[case]["experts"]
        assert b["params"] * 2 == b["whole"], b
        assert b["grads"] * 2 == b["whole"], b
        assert b["moments"] == b["whole"], b


def test_checkpoint_under_ep_resumes_elsewhere(two):
    """Saved at step 2 under EP on (1, 2) (the experts split over
    "model"), resumed on (2, 1) and at ``mesh=None``: steps 3-4 and the
    final params equal the uninterrupted EP run's."""
    ck = two[0]["checkpoint"]
    assert ck["split"][0] == "model"
    for where in ("2x1", "none"):
        at, metrics, final = ck[where]
        assert at == 2
        for a, b in zip(ck["uninterrupted"][2:], metrics):
            for k in ("loss", "ce", "grad_norm"):
                np.testing.assert_allclose(b[k], a[k], rtol=REL,
                                           err_msg=f"{where} {k}")
        for p, w in ck["final"].items():
            np.testing.assert_allclose(
                final[p], w, rtol=0, atol=REL * max(np.abs(w).max(), 1e-6),
                err_msg=f"{where} {p}")


# the gate of each arch beside EP x TP: deepseek_v3 ``REL``; jamba_1_5_large
# 1e-4, its Mamba gradients' rounding (tests/test_torch_multidevice_train.py,
# ``M_REL``: measured ~1.5e-5 of ``a_log``'s largest here)
TP_REL = {"deepseek_v3": REL, "jamba_1_5_large": 1e-4}


@pytest.mark.parametrize("arch,case", E.EP_TP_CASES)
def test_ep_beside_mla_shared_experts_and_mamba_on_1x2(two, arch, case):
    """EP 2 x TP 2 on (1, 2): deepseek_v3 with sequence parallelism,
    without it and with remat (the routed experts on the dispatch, the
    shared experts in the dense MLP's TP form beside it: the sequence
    gathered, their columns and rows, the sum scattered back; MLA on the
    rank's heads), jamba_1_5_large with remat (Mamba on the rank's
    channels, the router term's mean run again by the recompute of a
    group whose later sub-blocks save tensors): three steps, every
    leaf's gradient (the shared experts' ``sw1``/``sw3``/``sw2`` among
    them), the update and the collectives against the budget."""
    for res in two:
        r = res[case, arch]
        assert r["ep"]
        _check(r, rel=TP_REL[arch])
        _budget(r)
        if arch == "deepseek_v3":
            assert {p.rsplit("/", 1)[-1] for p in r["grads"]} >= {
                "sw1", "sw3", "sw2"}


# -- 4 ranks ------------------------------------------------------------------


@pytest.mark.parametrize("case", ["dp2xtp2", "fsdp4"])
def test_ep_equals_mesh_none_on_2x2(four, case):
    """mixtral EP at dp 2 x tp 2 (FSDP over "data") and under
    ``make_rules(tp=False)`` on (2, 2)."""
    for res in four:
        assert res[case]["ep"]
        _check(res[case])
        _budget(res[case])


def _ref_losses(four, reference_out, name):
    """The port's losses in the reference case ``name`` (asserting that
    its EP dispatches dropped pairs) and the reference's."""
    got = four[0]["ref", name]
    dropped, pairs = got["drops"]
    assert 0 < dropped < pairs, (dropped, pairs)
    return ([m["loss"] for m in got["metrics"]],
            [m["loss"] for m in reference_out[name]["metrics"]])


def test_ep_dp2_tp2_deepseek_shared_experts(four):
    """deepseek_v3 on EP at dp 2 x tp 2 (FSDP over "data"), the shared
    experts beside the dispatch, against ``mesh=None``."""
    for res in four:
        r = res["dp2xtp2", "deepseek_v3"]
        assert r["ep"]
        _check(r)
        _budget(r)


@pytest.mark.parametrize("arch", E.TP_ARCHS)
def test_reference_dp2_tp2_ep_losses_beside_mla_and_mamba(four,
                                                          reference_out,
                                                          arch):
    """deepseek_v3 (MLA, the shared experts outside the dispatch) and
    jamba_1_5_large (Mamba) at dp 2 x tp 2 under ``make_rules()`` on the
    reference's weights, one expert a rank, pairs dropping, the router
    term on: the reference's own sharded losses over three steps."""
    got, want = _ref_losses(four, reference_out, f"{arch}_tp")
    np.testing.assert_allclose(got, want, rtol=TP_REL[arch])


def test_reference_dp2_tp2_ep_losses(four, reference_out):
    """mixtral at dp 2 x tp 2 under ``make_rules()`` on the reference's
    weights, one expert a rank, pairs dropping, the router term on: the
    reference's own sharded losses over three steps, and its routers'
    gradients."""
    got, want = _ref_losses(four, reference_out, "mixtral_8x22b_tp")
    np.testing.assert_allclose(got, want, rtol=REL)
    ref = np.asarray(reference_out["mixtral_8x22b_tp"]["router_grads"])
    mine = four[0]["ref", "mixtral_8x22b_tp"]["router_grads"]
    assert len(mine) == len(ref)
    for i, g in enumerate(mine):
        np.testing.assert_allclose(g, ref[i], rtol=0,
                                   atol=REL * np.abs(ref[i]).max(),
                                   err_msg=f"layer {i}")


@pytest.mark.parametrize("arch", E.REF_ARCHS)
def test_reference_fsdp_ep_losses(four, reference_out, arch):
    """Under ``make_rules(tp=False)`` on (2, 2) the reference takes EP
    ("model" > 1 divides E and S); so does the port now (it ran the
    per-row capacity path): the reference's sharded losses with drops."""
    got, want = _ref_losses(four, reference_out, f"{arch}_fsdp")
    np.testing.assert_allclose(got, want, rtol=REL)


def test_reference_fault_ep_aux_is_data_shard_0(four, reference_out):
    """The reference returns its EP router term from shard_map with
    ``out_specs`` P() unchecked after a ``pmean`` over "model" alone
    (``repro/models/moe.py:135, :145-147``): at dp 2 the value read is
    data shard 0's, not the mean over "data".  The port keeps that
    number; each rank's own term (data shard 1's differs) shows it."""
    local = {r: four[r]["ref", "mixtral_8x22b_tp"]["router_local"]
             for r in range(4)}
    shard0, shard1 = local[0], local[2]
    assert local[1] == shard0 and local[3] == shard1
    assert abs(shard1 - shard0) > 100 * REL * abs(shard0)
    want = reference_out["mixtral_8x22b_tp"]["metrics"][0]["router_aux"]
    got = four[0]["ref", "mixtral_8x22b_tp"]["metrics"][0]["router_aux"]
    np.testing.assert_allclose(got, want, rtol=REL)
    np.testing.assert_allclose(want, shard0, rtol=REL)
    assert abs(want - (shard0 + shard1) / 2) > 10 * REL * abs(want)


def test_reference_fault_ep_reshape_mixes_experts(four, reference_out):
    """The reference reshapes the received (source, local expert, cap)
    buffer to (local expert, source * cap) without a transpose
    (``repro/models/moe.py:163``), so where E / n > 1 a local expert runs
    on rows routed to its neighbours: its EP layer departs from its
    unsharded layer with no pair dropped, and at the reduced E 4 on
    "model" 2 its sharded losses depart from the port's, whose EP equals
    ``mesh=None`` (above)."""
    gap, scale = reference_out["mixtral_8x22b_tp_e4"]["probe"]
    assert gap > 0.1 * scale, (gap, scale)
    mine, want = _ref_losses(four, reference_out, "mixtral_8x22b_tp_e4")
    assert max(abs(a - b) / abs(b) for a, b in zip(mine, want)) > 100 * REL


def test_cli_train_function_takes_ep(four):
    """``launch.train.train`` on the production rules over a (2, 2) host
    mesh on reduced mixtral: EP at dp 2 x tp 2, its collectives the
    budget's, its metrics those of ``make_train_step`` on the same mesh."""
    cli = four[0]["cli"]
    assert cli["counts"][("all-to-all", "model")] > 0
    C.check_train_collectives(cli["counts"], cli["budget"])
    for a, b in zip(cli["direct"], cli["cli"]):
        for k in ("loss", "ce", "router_aux", "grad_norm"):
            np.testing.assert_allclose(b[k], a[k], rtol=REL, err_msg=k)


def test_ep_budget_counts_the_all_to_alls():
    """The budget of a plan that takes EP holds 2 all-to-alls a MoE layer
    forward, 2 backward and 2 more in a recompute, and the router term's
    all-reduce (``TrainPlan.collective_budget``, without a process
    group: a "model" axis of 2 stood in, as under ``make_rules(tp=False)``
    on (1, 2))."""
    from repro_torch.distributed import sharding as TS
    cfg = reduced(get_config("mixtral_8x22b"))
    plan = TS.TrainPlan(
        cfg=cfg, mesh=None, rules=TS.make_rules(tp=False), axes={},
        gathers={}, tp=None, batch=None,
        world=C.AxisGroup("world", None, 2, 0, "gloo"), buckets=[],
        norms=[], replicas={}, frozen=(),
        ep=C.AxisGroup("model", None, 2, 0, "gloo"), batch_ranks=2)
    for remat, per in ((False, 4), (True, 6)):
        b = plan.collective_budget(2, seq_len=64, remat=remat, mse=False)
        assert b[("all-to-all", "model")] == 2 * cfg.n_layers * per
        assert b[("all-reduce", "model")] == 2 * cfg.n_layers
    assert not plan.ep_active(63)
    assert ("all-to-all", "model") not in plan.collective_budget(
        1, seq_len=63, remat=False, mse=False)
