"""Sharded training in the port: the reference's ``make_rules`` tables,
the training meshes, FSDP x TP x SP and sharded AdamW state, in real
process groups, against the port's own ``mesh=None`` training and the
reference's sharded training.

Each process group is spawned once per module (``launch.mesh.run_spmd``,
gloo on the CPU, rendezvous through a FileStore under the test's
temporary directory) and runs the scenarios of
``spmd_train_scenarios.py``: 2 ranks (dp 2 on the host rules, FSDP 2,
TP 2 + SP, FSDP on mixtral_8x22b and rwkv6_3b), 4 ranks (dp 2 x tp 2,
the multipod rules on (2, 1, 2), the collective budget, the reference's
weights, a checkpoint saved on (2, 2) and resumed on (4, 1), the CLI's
training function) and 1 rank (the checkpoint resumed on (1, 1) and at
``mesh=None``; the sharded path at world 1).

What must hold, in f32 at reduced width: the sharded losses, each
leaf's gradient (the matching shard of the unsharded gradient) and the
params after one update equal the unsharded ones within ``REL``: the
sums run in other orders (a rank's products see B / dp rows, tp sums
partial products; ROADMAP, "Products are not row-invariant"); at
world 1 they are the same bits.  The reference's own sharded step at
dp 2 x tp 2 gives the port's losses on the same weights and batches (a
subprocess with four forced host devices).
"""
import dataclasses
import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest

from repro.checkpoint import checkpoint as JC
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.distributed import sharding as RS
from repro.models.transformer import init_model as ref_init_model
from repro.models.transformer import \
    model_param_specs as ref_model_param_specs
from repro.optim import adamw as JA
from repro.training import steps as JST
from repro_torch import convert
from repro_torch.checkpoint import checkpoint as TC
from repro_torch.configs.base import ARCH_IDS, get_config, reduced
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as TS
from repro_torch.distributed.fault_tolerance import elastic_shape
from repro_torch.launch.mesh import make_production_mesh, run_spmd
from repro_torch.models.transformer import init_model, model_param_specs
from repro_torch.optim import adamw as TA
from repro_torch.training import steps as TST
from repro_torch.tree import named_leaves

import spmd_train_scenarios as S

TIMEOUT_S = 240
SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
# f32 at reduced width, predicted before the first run: 1e-5 relative
# (the aim); measured ~1e-7 on the losses, ~1e-6 of a leaf's largest
# gradient, ~1e-6 of a leaf's largest weight after one update
REL = 1e-5
PARAM_SHARE = 0.99


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return str(tmp_path_factory.mktemp("spmd_train"))


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ckpt"))


def _group(store, world, *args):
    return run_spmd(S.run, world, store_dir=store, args=args,
                    timeout_s=TIMEOUT_S)


# the reference's sharded training at dp 2 x tp 2 on four forced host
# devices: its make_rules() on a (2, 2) mesh of Auto axes, the state
# placed by its tree_specs, the jitted step with its in_shardings (its
# own launch/train.py's path)
REF_SCRIPT = r"""
import json, sys
import jax, numpy as np
from repro.configs import get_config, reduced
from repro.data.synthetic import DataConfig, lm_batches
from repro.distributed.sharding import (make_rules, mesh_context,
                                        set_rules, tree_specs)
from repro.optim import adamw
from repro.training import steps as ST
spec = json.loads(sys.argv[1])
cfg = reduced(get_config("yi_6b"))
opt = adamw.OptConfig(**spec["opt"])
rules = make_rules()
set_rules(rules)
out = {}
# (2, 2), then (1, 4): tp 4 above the 2 KV heads, whose weights its
# resolve_spec splits by columns over "model"
for shape, key in (((2, 2), ""), ((1, 4), "_1x4")):
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    data = lm_batches(DataConfig(vocab=cfg.vocab, seq_len=spec["seq"],
                                 global_batch=spec["batch"], seed=0))
    with mesh_context(mesh):
        state, log = ST.init_train_state(jax.random.PRNGKey(spec["key"]),
                                         cfg, opt)
        specs = tree_specs(state, log, rules, mesh)
        out["embed_spec" + key] = [str(a) for a in specs["params"]["embed"]]
        out["wk_spec" + key] = [str(a) for a in specs["params"]["groups"][
            "b0"]["attn"]["wk"]]
        state = jax.tree.map(
            lambda x, s: jax.device_put(x, jax.NamedSharding(mesh, s)),
            state, specs)
        step = jax.jit(ST.make_train_step(cfg, opt),
                       in_shardings=(specs, None), donate_argnums=(0,))
        out["losses" + key] = []
        for _ in range(spec["steps"]):
            state, m = step(state, next(data))
            out["losses" + key].append(float(m["loss"]))
# the cross-attention and RWKV6 archs at (2, 2), every cross gate at 0.5,
# the second input drawn as spmd_train_scenarios.batches draws it
def gate(t):
    return {k: gate(v) if isinstance(v, dict) else
            (v * 0 + 0.5 if k == "xgate" else v) for k, v in t.items()}
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
for arch in spec["x_archs"]:
    xcfg = reduced(get_config(arch))
    data = lm_batches(DataConfig(vocab=xcfg.vocab, seq_len=spec["seq"],
                                 global_batch=spec["batch"], seed=0))
    rng = np.random.default_rng(100)
    extra = ("enc_x", xcfg.enc_seq_len) if xcfg.enc_dec else (
        ("img", xcfg.n_image_tokens) if xcfg.cross_attn_period else None)
    with mesh_context(mesh):
        state, log = ST.init_train_state(jax.random.PRNGKey(spec["key"]),
                                         xcfg, opt)
        state = dict(state, params=gate(state["params"]))
        specs = tree_specs(state, log, rules, mesh)
        state = jax.tree.map(
            lambda x, s: jax.device_put(x, jax.NamedSharding(mesh, s)),
            state, specs)
        # the state keeps its specs from step to step (GSPMD may lay a
        # leaf's output out otherwise, which the next call refuses)
        step = jax.jit(ST.make_train_step(xcfg, opt),
                       in_shardings=(specs, None), out_shardings=(specs, None),
                       donate_argnums=(0,))
        losses = []
        for _ in range(spec["steps"]):
            b = next(data)
            if extra is not None:
                b[extra[0]] = rng.standard_normal(
                    (spec["batch"], extra[1], xcfg.d_model)).astype(np.float32)
            state, m = step(state, b)
            losses.append(float(m["loss"]))
    out["losses_x/" + arch] = losses
print(json.dumps(out))
"""


def _gated(tree):
    """A reference params tree (numpy) with every cross gate at
    ``spmd_train_scenarios.XGATE``."""
    return {k: _gated(v) if isinstance(v, dict) else
            (np.full_like(v, S.XGATE) if k == "xgate" else v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def reference():
    """(the reference subprocess, running; its weights as numpy, and the
    cross-attention and RWKV6 archs' with their gates at ``XGATE``)."""
    opt = dict(lr=S.OPT.lr, total_steps=S.OPT.total_steps,
               warmup_steps=S.OPT.warmup_steps)
    spec = dict(opt=opt, seq=S.SEQ, batch=S.BATCH, steps=S.STEPS, key=0,
                x_archs=list(S.XARCHS))
    cfg = ref_reduced(ref_get_config("yi_6b"))
    params, _ = ref_init_model(jax.random.PRNGKey(0), cfg)
    xparams = {arch: _gated(jax.tree.map(np.asarray, ref_init_model(
        jax.random.PRNGKey(0), ref_reduced(ref_get_config(arch)))[0]))
        for arch in S.XARCHS}
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen([sys.executable, "-c", REF_SCRIPT,
                             json.dumps(spec)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc, jax.tree.map(np.asarray, params), xparams
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def reference_out(reference):
    proc = reference[0]
    out, err = proc.communicate(timeout=TIMEOUT_S)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def two(store, ckpt_dir):
    return _group(store, 2, "two", ckpt_dir)


@pytest.fixture(scope="module")
def four(store, reference, ckpt_dir):
    return _group(store, 4, "four", reference[1], ckpt_dir, reference[2])


@pytest.fixture(scope="module")
def one(store, four, ckpt_dir):
    return _group(store, 1, "one", ckpt_dir)[0]


def _close_metrics(pair, rel=REL, keys=("loss", "ce", "mse", "grad_norm")):
    plain, sharded = pair
    assert len(plain) == len(sharded) == S.STEPS
    for i, (a, b) in enumerate(zip(plain, sharded)):
        for k in keys:
            np.testing.assert_allclose(b[k], a[k], rtol=rel, atol=1e-7,
                                       err_msg=f"step {i} {k}")


def _check(res, rel=REL):
    """Losses, one microbatch's gradients leaf by leaf and the params
    after one update, against ``mesh=None``: every element within 2 lr
    (an element whose gradient is rounding noise moves by up to lr either
    way under AdamW) and ``PARAM_SHARE`` of them within 1e-5."""
    _close_metrics(res["metrics"], rel)
    bad = {p: e for p, e in res["grads"].items() if e > rel}
    assert not bad, bad
    bad = {p: g[0] for p, g in res["params"].items()
           if g[0] > 2 * S.OPT.lr}
    assert not bad, bad
    within = sum(g[1] for g in res["params"].values())
    total = sum(g[2] for g in res["params"].values())
    assert within >= PARAM_SHARE * total, (within, total)


def _budget(pair):
    counts, budget = pair
    C.check_train_collectives(counts, budget)


# -- the rule tables and the resolved specs (no process group) ----------------


def _grid():
    keys = ("multi_pod", "fsdp", "seq_parallel", "long_context", "fsdp_pod",
            "tp")
    for bits in range(2 ** len(keys)):
        kw = {k: bool(bits >> i & 1) for i, k in enumerate(keys)}
        for cache_axis in ("auto", None, "data"):
            yield dict(kw, cache_axis=cache_axis)


def test_make_rules_equals_the_references():
    """``make_rules`` gives the reference's table field for field over
    the grid of its keyword arguments."""
    n = 0
    for kw in _grid():
        got = dataclasses.asdict(TS.make_rules(**kw))
        want = dataclasses.asdict(RS.make_rules(**kw))
        assert got == want, kw
        n += 1
    assert n == 192
    assert dataclasses.asdict(TS.ShardingRules()) == dataclasses.asdict(
        RS.ShardingRules())


class _Mesh:
    """A DeviceMesh's names and shape, enough for ``resolve_spec``."""

    def __init__(self, shape, names):
        self.mesh_dim_names = names
        self.mesh = np.zeros(shape)


MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_tree_specs_match_reference(arch, mesh):
    """Every leaf of the arch's params at reduced width resolves to the
    reference's ``tree_specs`` axes under ``make_rules`` and its
    ``tp=False`` table (multipod on the 3-axis mesh), its stacked layer
    axis aside."""
    shape, names = MESHES[mesh]
    tmesh = _Mesh(shape, names)
    rmesh = types.SimpleNamespace(shape=dict(zip(names, shape)), empty=False)
    cfg = reduced(get_config(arch))
    params = init_model(0, cfg, device="meta")
    specs = model_param_specs(cfg)
    rcfg = ref_reduced(ref_get_config(arch))
    rshapes = jax.eval_shape(lambda k: ref_init_model(k, rcfg)[0],
                             jax.random.PRNGKey(0))
    rspecs = ref_model_param_specs(rcfg)
    multi = len(shape) == 3
    n = 0
    for kw in (dict(multi_pod=multi), dict(multi_pod=multi, tp=False)):
        got = TS.tree_specs(params, specs, TS.make_rules(**kw), tmesh)
        want = RS.tree_specs(rshapes, rspecs, RS.make_rules(**kw), rmesh)

        def check(g, w, stacked):
            nonlocal n
            w = tuple(w) + (None,) * (len(g) + stacked - len(tuple(w)))
            assert g == w[stacked:], (arch, mesh, kw, g, w)
            n += 1

        for key in specs:
            if key in ("groups", "enc_groups"):
                for sub in got[key]:
                    _walk(sub, want[key], lambda g, w: check(g, w, 1))
            else:
                _walk(got[key], want[key], lambda g, w: check(g, w, 0))
    assert n == 2 * len(list(named_leaves(params)))


def _walk(got, want, f):
    """``f(port resolved axes, reference PartitionSpec)`` over a port
    resolved-axes subtree and the reference's resolved subtree."""
    if isinstance(got, tuple):
        return f(got, want)
    if isinstance(got, dict):
        for k in got:
            _walk(got[k], want[k], f)
        return
    for g, w in zip(got, want):
        _walk(g, w, f)


def test_rules_context_restores_the_previous_table():
    """``rules_context`` installs a table for its block and puts the
    previous one back, after an exception too; ``compute_context``
    installs a mesh that ``resolve_spec`` falls back on."""
    base = TS.get_rules()
    serving = TS.make_serving_rules(tp=True)
    with TS.rules_context(serving):
        assert TS.get_rules() is serving
        with pytest.raises(RuntimeError):
            with TS.rules_context(TS.make_rules(tp=False)):
                raise RuntimeError("inside")
        assert TS.get_rules() is serving
    assert TS.get_rules() is base
    TS.set_rules(serving)
    try:
        assert TS.get_rules() is serving
    finally:
        TS.set_rules(base)
    mesh = _Mesh((2, 2), ("data", "model"))
    with TS.compute_context(mesh, TS.make_rules()):
        assert TS.current_mesh() is mesh
        assert TS.resolve_spec((8, 64), ("vocab", "embed")) == (
            "model", "data")
    assert TS.current_mesh() is None
    assert TS.resolve_spec((8, 64), ("vocab", "embed")) == (None, None)


def test_elastic_shapes():
    """``elastic_mesh`` halves "model" until it divides the world."""
    assert elastic_shape(4) == (1, 4)
    assert elastic_shape(6) == (3, 2)
    assert elastic_shape(6, model_parallel=1) == (6, 1)
    assert elastic_shape(4, model_parallel=2) == (2, 2)


def test_production_mesh_needs_256_ranks():
    """Below 256 (512) processes the production (multipod) mesh raises
    ``ValueError`` naming both counts."""
    with pytest.raises(ValueError, match="needs 256 processes.*has 1"):
        make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 processes.*has 1"):
        make_production_mesh(multi_pod=True)


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "deepseek_v3",
                                  "jamba_1_5_large"])
def test_tp_training_refusals(arch, request):
    """At tp 2 every one of these plans (the 2-rank group's (1, 2)
    mesh): mixtral_8x22b with its MoE layers on the expert-parallel
    dispatch, whose all-to-alls its budget holds; an MLA (deepseek_v3)
    and a Mamba (jamba_1_5_large) arch, which raised naming
    "Distribution" before they had a tensor-parallel form, with MLA's
    whole latent leaves summed over "model" a step (``partials``) and
    no partial leaf on jamba (every Mamba leaf holds the rank's
    channels)."""
    cfg = reduced(get_config(arch))
    two = request.getfixturevalue("two")[0]
    if arch == "mixtral_8x22b":
        plan = two["mixtral_tp2_plan"]
        assert plan["ep"] and plan["tp"] == 2
        assert plan["budget"][("all-to-all", "model")] == 4 * cfg.n_layers
        return
    leaves = {p.split("/", 2)[-1] if p.startswith("/prologue") else
              p.split("/", 3)[-1] for p in two["m_partials", arch]}
    want = {"deepseek_v3": {f"{s}/attn/{leaf}" for s in ("0", "b0")
                            for leaf in ("q_a", "q_a_norm", "kv_a",
                                         "kv_a_norm")},
            "jamba_1_5_large": set()}[arch]
    assert leaves == want, leaves


def test_tp_training_divisibility():
    """A head count that tp does not divide raises ``ValueError``."""
    cfg = reduced(get_config("yi_6b"))
    with pytest.raises(ValueError, match="heads"):
        TS.make_train_plan(cfg, _Mesh((1, 8), ("data", "model")),
                           TS.make_rules())


@pytest.mark.parametrize("arch", ["whisper_small", "rwkv6_3b"])
def test_tp16_training_refuses_naming_the_axis(arch):
    """whisper_small's 12 and rwkv6_3b's 40 heads do not divide tp 16:
    the plan raises ``ValueError`` naming "heads" and ROADMAP's
    "Distribution" (the reference's per-dimension replication)."""
    with pytest.raises(ValueError, match="heads.*Distribution"):
        TS.make_train_plan(get_config(arch), _Mesh((16, 16), (
            "data", "model")), TS.make_rules())


def test_train_collective_budget_check():
    """The budget check names the (op, axis) whose count is off."""
    ok = {("all-gather", "data"): 4, ("all-reduce", "world"): 1}
    assert C.check_train_collectives(ok, dict(ok)) == ok
    with pytest.raises(AssertionError, match="all-gather over data"):
        C.check_train_collectives({("all-gather", "data"): 3,
                                   ("all-reduce", "world"): 1}, ok)
    with pytest.raises(AssertionError, match="reduce-scatter over model"):
        C.check_train_collectives(
            {**ok, ("reduce-scatter", "model"): 1}, ok)


def test_state_specs_are_the_references():
    """``adamw.state_specs`` and the state spec tree of
    ``init_train_state`` are the reference's (its stacked layer axis
    aside)."""
    for md in ("", "float32"):
        got = TA.state_specs(TA.OptConfig(master_dtype=md), {"w": ("a",)})
        want = JA.state_specs(JA.OptConfig(master_dtype=md), {"w": ("a",)})
        assert got == want
    cfg = reduced(get_config("yi_6b"))
    specs = TST.train_state_specs(cfg, TA.OptConfig())
    assert specs["step"] == () and specs["opt"]["step"] == ()
    assert specs["opt"]["m"] is specs["params"]
    # map_specs walks the logical tuples, as the reference's does
    flat = TS.map_specs(len, specs["params"])
    rflat = RS.map_specs(len, ref_model_param_specs(
        ref_reduced(ref_get_config("yi_6b"))))
    assert flat["embed"] == rflat["embed"] == 2
    assert flat["groups"][0]["b0"]["attn"]["wq"] + 1 == \
        rflat["groups"]["b0"]["attn"]["wq"]


# -- 2 ranks ------------------------------------------------------------------


def test_dp2_host_rules_equal_mesh_none(two):
    """The host rules over two processes (``elastic_mesh(model_parallel=
    1)``, data parallelism): losses, gradients and params."""
    assert two[0]["elastic"] == (2, 1)
    for res in two:
        _check(res["dp2"])
        _budget(res["dp2"]["budget"])


@pytest.mark.parametrize("mb", [1, 2])
def test_fsdp2_equals_mesh_none(two, mb):
    """FSDP over two ranks (``make_rules(tp=False)``), 1 and 2
    microbatches."""
    for res in two:
        _check(res[f"fsdp2_mb{mb}"])
        _budget(res[f"fsdp2_mb{mb}"]["budget"])


def test_fsdp2_holds_half_the_state(two):
    """Under FSDP 2 a rank's params, gradients and moments are its
    shards: about half the unsharded bytes, the replicated leaves (norms,
    the predictor's square matrices) the only excess."""
    for res in two:
        b = res["fsdp2_mb1"]["bytes"]
        whole = b["whole"]
        for key in ("params", "grads"):
            assert 0.5 * whole <= b[key] <= 0.51 * whole, (key, b)
        assert 0.5 * 2 * whole <= b["moments"] <= 0.51 * 2 * whole, b


def test_tp2_sp_equals_mesh_none(two):
    """TP 2 with sequence parallelism (``make_rules()`` on (1, 2))."""
    for res in two:
        _check(res["tp2"])
        _budget(res["tp2"]["budget"])


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "rwkv6_3b"])
def test_fsdp2_other_archs(two, arch):
    """FSDP over two ranks trains mixtral_8x22b (its capacity MoE, the
    router in f32) and rwkv6_3b (the chunked wkv) as ``mesh=None``."""
    for res in two:
        _check(res[f"{arch}_fsdp2"])


def test_staged_collectives_equal_gloos(two):
    """The staged all-gather and reduce-scatter (an all-to-all over
    several gloo groups through host buffers, as a gloo group moves a
    CUDA tensor) give gloo's own results bit for bit."""
    for res in two:
        assert res["staged"] == [(True, True), (True, True)]


def test_production_mesh_refused_on_two_ranks(two):
    assert "needs 256 processes" in two[0]["production"]
    assert "has 2" in two[0]["production"]


# -- 4 ranks ------------------------------------------------------------------


def test_dp2_tp2_equals_mesh_none(four):
    """dp 2 x tp 2 under ``make_rules()``: FSDP over "data", heads, MLP
    and vocab over "model", the residual stream's sequence over "model"
    between the layers."""
    for res in four:
        _check(res["dp2xtp2"])
        _budget(res["dp2xtp2"]["budget"])


def test_multipod_rules_equal_mesh_none(four):
    """The multipod table on a (2, 1, 2) mesh: the batch over ("pod",
    "data"), FSDP over "data", whose leaves' gradients are averaged over
    "pod" too."""
    for res in four:
        _check(res["multipod"])
        _budget(res["multipod"]["budget"])


def test_tp_above_kv_heads_equals_mesh_none(four):
    """tp 4 under ``make_rules()`` on reduced yi_6b (4 query heads, 2
    KV heads): each rank slices its group's KV head out of the whole
    leaf, and the KV gradients are summed over "model".  Losses, every
    gradient and the params after one update, the K/V weights
    included, equal ``mesh=None``, and the counters the budget."""
    for rank, res in enumerate(four):
        _check(res["tp4_kv"])
        _budget(res["tp4_kv"]["budget"])
        kv = {p: s for p, s in res["tp4_kv_slices"].items()}
        assert sorted(p.rsplit("/", 1)[1] for p in kv) == ["wk", "wk",
                                                           "wv", "wv"]
        assert set(kv.values()) == {(1, rank // 2 * 16, 16)}
        for p in kv:
            assert p in res["tp4_kv"]["params"] and p in res["tp4_kv"]["grads"]


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("remat", [False, True])
def test_train_collective_budget(four, layers, remat):
    """A step's counters equal the documented budget at 1 and 2 layers,
    with and without the recompute (2 microbatches, dp 2 x tp 2)."""
    for res in four:
        _budget(res["budget", layers, remat])


def test_reference_dp2_tp2_losses(four, reference_out):
    """The port's four processes at dp 2 x tp 2 on the reference's
    weights and batches give the reference's own sharded losses."""
    assert reference_out["embed_spec"] == ["model", "data"]
    got = [m["loss"] for m in four[0]["reference"]]
    np.testing.assert_allclose(got, reference_out["losses"], rtol=REL)


def test_reference_tp_above_kv_heads_losses(four, reference_out):
    """tp 4 on (1, 4) above reduced yi_6b's 2 KV heads: the port (KV
    leaves whole over "model", each rank's head sliced) on the
    reference's weights and batches gives the reference's own sharded
    losses, whose ``resolve_spec`` splits the KV weights' columns over
    "model" (a head's half a rank) for GSPMD to gather."""
    assert reference_out["wk_spec_1x4"][-1] == "model"
    got = [m["loss"] for m in four[0]["reference_tp4"]]
    np.testing.assert_allclose(got, reference_out["losses_1x4"], rtol=REL)


def test_checkpoint_resumes_on_another_mesh(four):
    """Saved at step 2 on (2, 2), resumed on (4, 1): steps 3 and 4 and the
    final params equal the uninterrupted run's."""
    at, resumed, final = four[0]["resumed_4x1"]
    assert at == 2
    full = four[0]["uninterrupted"]
    for a, b in zip(full[2:], resumed):
        for k in ("loss", "ce", "mse", "grad_norm"):
            np.testing.assert_allclose(b[k], a[k], rtol=REL)
    for p, w in four[0]["final"].items():
        np.testing.assert_allclose(final[p], w, rtol=0,
                                   atol=REL * max(np.abs(w).max(), 1e-6),
                                   err_msg=p)


@pytest.mark.parametrize("where", ["1x1", "none"])
def test_checkpoint_resumes_on_one_rank(four, one, where):
    """The same checkpoint resumed on a (1, 1) mesh and at ``mesh=None``."""
    at, metrics, final = one[where]
    assert at == 2
    for a, b in zip(four[0]["uninterrupted"][2:], metrics):
        for k in ("loss", "ce", "mse", "grad_norm"):
            np.testing.assert_allclose(b[k], a[k], rtol=REL)
    for p, w in four[0]["final"].items():
        np.testing.assert_allclose(final[p], w, rtol=0,
                                   atol=REL * max(np.abs(w).max(), 1e-6),
                                   err_msg=p)


def test_reference_reads_the_sharded_checkpoint(four, ckpt_dir):
    """The file the (2, 2) run wrote is the reference's format: its
    ``restore`` reads it, and it holds the port's ``mesh=None`` restore."""
    jc = ref_reduced(ref_get_config("yi_6b"))
    like, _ = JST.init_train_state(jax.random.PRNGKey(1), jc,
                                   JA.OptConfig())
    path = os.path.join(ckpt_dir, "ckpt_2")
    tree, step = JC.restore(path, like)
    assert step == 2
    port, _ = TST.init_train_state(1, reduced(get_config("yi_6b")),
                                   TA.OptConfig(), device="cpu")
    mine, _ = TC.restore(path, port, "cpu")
    want = dict(named_leaves(convert.to_reference(mine["params"])))
    got = dict(named_leaves(jax.tree.map(np.asarray, tree["params"])))
    assert set(got) == set(want)
    for p, a in got.items():
        np.testing.assert_array_equal(a, want[p], err_msg=p)


def test_cli_train_function_on_a_2x2_host_mesh(four):
    """``launch.train.train`` on the production rules over a (2, 2) host
    mesh gives the run of ``mesh=None``."""
    plain, sharded = four[0]["cli"]
    _close_metrics((plain, sharded))


def test_elastic_mesh_over_four_ranks(four):
    assert four[0]["elastic"] == (1, 4)


# -- cross-attention and RWKV6 under TP + SP ------------------------------------

# the gate of the cross-attention and RWKV6 archs, f32 at reduced width,
# chip_smoke.py's SHARD_F32_RTOL.  Predicted before the first run: ~1e-6,
# as yi_6b.  Measured: ~1e-6 on whisper_small and llama_3_2_vision, but
# ~4e-5 of a leaf's largest gradient on rwkv6_3b, whose unsharded f32
# gradients are themselves ~3e-5 from the same step in float64 (the
# chunked wkv's exp(-cum) rescaling amplifies the products' last bits)
X_REL = 1e-4


@pytest.mark.parametrize("arch", S.XARCHS)
def test_tp2_sp_cross_and_rwkv_equal_mesh_none(two, arch):
    """TP 2 + SP (``make_rules()`` on (1, 2)) on whisper_small (its
    encoder's frames sequence-sharded too), llama_3_2_vision (the image
    whole on every rank) and rwkv6_3b (each mix gathering the sequence
    before its token shift): the loss, every leaf's gradient (RWKV6's
    ``mu``, ``w_lora_*``, ``w0`` and ``ln_x``, the cross ``xgate`` and
    ``xnorm`` among them) and the params after one update against
    ``mesh=None``, and the counters against the budget."""
    for res in two:
        _check(res["x_tp2", arch], X_REL)
        _budget(res["x_tp2", arch]["budget"])
        if arch == "rwkv6_3b":
            leaves = {p.rsplit("/", 2)[-2] + "/" + p.rsplit("/", 1)[-1]
                      for p in res["x_partials", arch]}
            assert leaves == {"attn/mu", "attn/w_lora_a", "attn/w_lora_b",
                              "attn/w0", "attn/ln_x", "mlp/mu", "mlp/wr"}


@pytest.mark.parametrize("arch", ["rwkv6_3b", "whisper_small"])
def test_tp2_without_sp_cross_and_rwkv_equal_mesh_none(two, arch):
    """TP 2 without sequence parallelism (``make_rules(seq_parallel=
    False)``): every rank computes RWKV6's FFN gate alike (its gradient
    divided by tp, then summed over "model" with the partial leaves), and
    whisper's encoder output enters the decoder by ``copy_to_tp``: the
    loss, every leaf's gradient and the updated params against
    ``mesh=None``, and the counters against the budget."""
    for res in two:
        _check(res["x_tp2_nosp", arch], X_REL)
        _budget(res["x_tp2_nosp", arch]["budget"])


@pytest.mark.parametrize("arch", S.XARCHS)
def test_tp2_sp_cross_and_rwkv_budget_with_remat(two, arch):
    """With the recompute (``cfg.remat``) the counters equal the budget:
    every gather again, and each exit whose output a later product saves
    (the cross sub-layer's and RWKV6's FFN's gates, a sub-layer not last
    in its group) reduce-scattered again."""
    for res in two:
        _budget(res["x_remat", arch])


def test_tp2_sp_llama_vision_odd_image_tokens(two):
    """33 image tokens at TP 2 + SP: the cross sub-layer's keys and values
    take the whole image on every rank (no sequence split), and the run
    equals ``mesh=None``."""
    for res in two:
        _check(res["x_odd"], X_REL)
        _budget(res["x_odd"]["budget"])


@pytest.mark.parametrize("arch", ["rwkv6_3b", "whisper_small"])
def test_tp2_checkpoint_round_trip(two, arch):
    """A tp-2 state (RWKV6's head-sharded leaves and whole mixes;
    whisper's encoder and cross sub-layers) saved whole by rank 0 and
    restored into another seed's state gives every leaf back bit for
    bit."""
    for res in two:
        at, same, n = res["x_ckpt", arch]
        assert at == 1 and same and n > 0


@pytest.mark.parametrize("arch", S.XARCHS)
def test_dp2_tp2_cross_and_rwkv_equal_mesh_none(four, arch):
    """dp 2 x tp 2 under ``make_rules()`` on the three archs."""
    for res in four:
        _check(res["x_dp2xtp2", arch], X_REL)
        _budget(res["x_dp2xtp2", arch]["budget"])


@pytest.mark.parametrize("arch", S.XARCHS)
def test_reference_dp2_tp2_cross_and_rwkv_losses(four, reference_out, arch):
    """The port's dp 2 x tp 2 run on the reference's weights (its cross
    gates at 0.5) and batches (the same second input) gives the
    reference's own GSPMD losses on (2, 2)."""
    got = [m["loss"] for m in four[0]["x_reference", arch]]
    np.testing.assert_allclose(got, reference_out["losses_x/" + arch],
                               rtol=X_REL)


# -- Mamba and multi-head latent attention under TP + SP ------------------------

# the gate of each: deepseek_v3 the yi_6b gate ``REL`` (measured ~2e-6 of
# a leaf's largest gradient); jamba_1_5_large ``X_REL``, predicted 1e-5 and
# measured ~8e-6 of a leaf's largest gradient (Mamba's ``a_log`` and
# ``x_proj``): a one-last-bit change of ``x_proj``'s output alone moves the
# unsharded f32 gradients by up to ~6e-6 of a leaf's largest (the scan's
# exp(dt a) amplifies it), and the tp run rounds every "model" sum so
M_REL = {"jamba_1_5_large": X_REL, "deepseek_v3": REL}


@pytest.mark.parametrize("case", ["m_tp2", "m_tp2_nosp"])
@pytest.mark.parametrize("arch", S.MARCHS)
def test_tp2_mamba_and_mla_equal_mesh_none(two, arch, case):
    """TP 2 on (1, 2), with sequence parallelism and without, the MoE
    layers on the capacity path (the expert-parallel dispatch is
    tests/test_torch_multidevice_ep.py's): jamba_1_5_large (Mamba on the
    rank's channels, ``x_proj``'s sum and its gradient's over "model")
    and deepseek_v3 (MLA on the rank's heads, the latent leaves' partial
    gradients summed; the shared experts' columns and rows): the loss,
    every leaf's gradient and the params after one update against
    ``mesh=None``, and the counters against the budget."""
    for res in two:
        _check(res[case, arch], M_REL[arch])
        _budget(res[case, arch]["budget"])


@pytest.mark.parametrize("arch", S.MARCHS)
def test_tp2_sp_mamba_and_mla_budget_with_remat(two, arch):
    """With the recompute the counters equal the budget: Mamba's
    ``x_proj`` sum run again (2 + r all-reduces a sub-block), MLA's exit
    and MSE sum as the attention's."""
    for res in two:
        _budget(res["m_remat", arch])


@pytest.mark.parametrize("arch", S.MARCHS)
def test_dp2_tp2_mamba_and_mla_equal_mesh_none(four, arch):
    """dp 2 x tp 2 (FSDP over "data", the capacity MoE) on jamba and
    deepseek."""
    for res in four:
        _check(res["m_dp2xtp2", arch], M_REL[arch])
        _budget(res["m_dp2xtp2", arch]["budget"])


def test_tp2_jamba_checkpoint_restores_on_one_rank(two, ckpt_dir):
    """A jamba tp-2 state (``in_proj`` placed half by half) saved whole
    by rank 0 comes back bit for bit on the same mesh; the file restores
    at ``mesh=None`` to the whole params the ranks gathered, which lie
    within the updates' rounding of the ``mesh=None`` run's (a plain
    split of ``in_proj`` would have swapped its halves' columns), and
    the reference's reader reads it to the same values."""
    at, same, n, whole, gaps = two[0]["m_ckpt"]
    assert at == 1 and same and n > 0
    bad = {p: g for p, g in gaps.items() if g > 3 * 2 * S.OPT.lr}
    assert not bad, bad
    path = os.path.join(ckpt_dir, "x_jamba_1_5_large", "ckpt_1")
    port, _ = TST.init_train_state(1, reduced(get_config(
        "jamba_1_5_large")), TA.OptConfig(), device="cpu")
    mine, step = TC.restore(path, port, "cpu")
    assert step == 1
    for p, t in named_leaves(mine["params"]):
        np.testing.assert_array_equal(t.detach().numpy(), whole[p],
                                      err_msg=p)
    jc = ref_reduced(ref_get_config("jamba_1_5_large"))
    like, _ = JST.init_train_state(jax.random.PRNGKey(1), jc,
                                   JA.OptConfig())
    tree, rstep = JC.restore(path, like)
    assert rstep == 1
    want = dict(named_leaves(convert.to_reference(mine["params"])))
    got = dict(named_leaves(jax.tree.map(np.asarray, tree["params"])))
    assert set(got) == set(want)
    for p, a in got.items():
        np.testing.assert_array_equal(a, want[p], err_msg=p)


# -- 1 rank -------------------------------------------------------------------


def test_world1_sharded_path_is_bitwise(one):
    """On a (1, 1) mesh under ``make_rules()`` every collective is a
    group of one and the step is the unsharded one bit for bit: metrics,
    the params after one update and after three (2 microbatches,
    remat)."""
    assert one["world1"] == (True, True, True)
    _budget(one["world1_budget"])
