"""Serving meshes in the port: the reference's tests/test_multidevice.py
against the port's own ``mesh=None`` engines, in real process groups.

The reference runs one controller over forced host devices; the port
runs one process per device.  Here each process group is spawned once
per module (``launch.mesh.run_spmd``, gloo on the CPU, rendezvous through
a FileStore under the test's temporary directory) and runs every
scenario of ``spmd_scenarios.py``: 2 ranks as a ("data",) mesh (dp 2),
2 ranks as a (1, 2) mesh (tp 2), 4 ranks as (2, 2) and (1, 4) meshes.
Each test asserts on the results of its scenario.

What must hold: the sharded engines' tokens equal the unsharded
engines' (greedy and sampled, static and continuous, chunked, blocking,
paged with prefix reuse, int8, speculative, every DSA mode), which hold
on tokens, not bytes: a rank's products see B / dp rows and tp sums
partial products (ROADMAP, "Products are not row-invariant").  The
reference's own engine at dp 2 x tp 2 gives the same tokens on the same
weights (a subprocess with four forced host devices).  The collective
counters show the pure-tp decode budget at two segment lengths.
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
from repro.distributed import sharding as RS
from repro.models.transformer import init_model as ref_init_model
from repro.models.transformer import \
    model_param_specs as ref_model_param_specs
from repro_torch.configs.base import ARCH_IDS, get_config, reduced
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as TS
from repro_torch.inference.config import ServingConfig
from repro_torch.launch.mesh import make_serving_mesh, run_spmd
from repro_torch.models import ssm
from repro_torch.models.attention import RunFlags
from repro_torch.models.transformer import (init_cache, init_model,
                                            model_param_specs,
                                            unstacked_cache_specs)

import spmd_scenarios as S

TIMEOUT_S = 240
SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
TP_GRID = [(1, 2), (2, 2), (1, 4)]


def _tp_ids(val):
    return f"dp{val[0]}xtp{val[1]}"


def _equal(pair):
    plain, sharded = pair
    assert set(plain) == set(sharded)
    for rid in plain:
        np.testing.assert_array_equal(sharded[rid], plain[rid],
                                      err_msg=f"rid {rid}")


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return str(tmp_path_factory.mktemp("spmd"))


def _group(store, world, name, ref=None):
    return run_spmd(S.run, world, store_dir=store, args=(name, ref),
                    timeout_s=TIMEOUT_S)


@pytest.fixture(scope="module")
def dp(store):
    return _group(store, 2, "dp")


@pytest.fixture(scope="module")
def tp(store):
    return _group(store, 2, "tp")


# the reference's serving at dp 2 x tp 2 on four forced host devices.  Its
# own make_serving_mesh builds a mesh of Explicit axes under jax 0.9,
# on which its tp engine refuses the embedding gather (ROADMAP Queue 3);
# the subprocess records that, then serves on a mesh of Auto axes, the
# kind its make_production_mesh builds
REF_SCRIPT = r"""
import json, sys
import jax, numpy as np
from repro.configs import get_config, reduced
from repro.inference.engine import Engine
from repro.inference.scheduler import ContinuousEngine, Request
from repro.launch.mesh import make_serving_mesh
from repro.models.transformer import init_model
spec = json.loads(sys.argv[1])
cfg = reduced(get_config(spec["arch"]))
params, _ = init_model(jax.random.PRNGKey(spec["key"]), cfg)
prompts = np.asarray(spec["prompts"], np.int32)
out = {}
try:
    eng = Engine(cfg, params, max_len=96,
                 mesh=make_serving_mesh(dp=2, tp=2, cfg=cfg))
    eng.generate(prompts, 2)
    out["serving_mesh"] = "ok"
except Exception as e:
    out["serving_mesh"] = type(e).__name__ + ": " + str(e).splitlines()[0]
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
eng = Engine(cfg, params, max_len=96, mesh=mesh)
out["tp"] = eng.tp
out["gen"] = np.asarray(eng.generate(prompts, spec["n_new"], seed=5)
                        .tokens).tolist()
rng = np.random.default_rng(spec["seed"])
reqs = [Request(rid, rng.integers(1, cfg.vocab - 4, size=(n,)).astype(
    np.int32), k, seed=rid * 7 + 1) for rid, (n, k) in enumerate(
    spec["shapes"])]
cont = ContinuousEngine(cfg, params, slots=8, max_len=96, seg_len=4,
                        mesh=mesh).run(reqs)
out["cont"] = {str(k): np.asarray(v).tolist() for k, v in cont.items()}
# tp 4 above reduced yi_6b's 2 KV heads on a (1, 4) mesh of Auto axes
kcfg = reduced(get_config(spec["kv_arch"]))
kparams, _ = init_model(jax.random.PRNGKey(spec["key"]), kcfg)
kmesh = jax.make_mesh((1, 4), ("data", "model"),
                      axis_types=(jax.sharding.AxisType.Auto,) * 2)
eng = Engine(kcfg, kparams, max_len=96, mesh=kmesh)
out["kv_tp"] = eng.tp
out["kv_gen"] = np.asarray(eng.generate(prompts, spec["n_new"], seed=5)
                           .tokens).tolist()
# cross-attention and RWKV6 at (2, 2), every cross gate at 0.5, the second
# input drawn as spmd_scenarios.extras_of draws it
def gate(t):
    return {k: gate(v) if isinstance(v, dict) else
            (v * 0 + 0.5 if k == "xgate" else v) for k, v in t.items()}
for arch in spec["x_archs"]:
    xcfg = reduced(get_config(arch))
    xparams = gate(init_model(jax.random.PRNGKey(spec["key"]), xcfg)[0])
    rng = np.random.default_rng(3)
    extras = ({"enc_x": rng.standard_normal(
                  (4, xcfg.enc_seq_len, xcfg.d_model)).astype(np.float32)}
              if xcfg.enc_dec else
              {"img": rng.standard_normal(
                  (4, xcfg.n_image_tokens, xcfg.d_model)).astype(np.float32)}
              if xcfg.cross_attn_period else None)
    eng = Engine(xcfg, xparams, max_len=96, mesh=mesh)
    out["x_tp", arch] = eng.tp
    out["x_gen", arch] = np.asarray(eng.generate(
        prompts[:4], spec["n_new"], extras=extras, seed=5).tokens).tolist()
out = {k if isinstance(k, str) else "/".join(k): v for k, v in out.items()}
print(json.dumps(out))
"""

REF = dict(arch="stablelm_3b", kv_arch="yi_6b", key=0, n_new=12, seed=19,
           shapes=[(20, 5), (33, 9), (7, 1), (40, 12), (12, 6), (25, 3)],
           x_archs=list(S.XARCHS + S.MARCHS))


def _gated(tree):
    """A reference params tree (numpy) with every cross gate at
    ``spmd_scenarios.XGATE``."""
    return {k: _gated(v) if isinstance(v, dict) else
            (np.full_like(v, S.XGATE) if k == "xgate" else v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def reference():
    """(the reference subprocess, running; the port's inputs: the
    reference's weights as numpy and the shared prompts)."""
    cfg = ref_reduced(ref_get_config(REF["arch"]))
    params, _ = ref_init_model(jax.random.PRNGKey(REF["key"]), cfg)
    prompts = np.random.default_rng(3).integers(
        1, cfg.vocab - 4, size=(8, 24)).astype(np.int32)
    kparams, _ = ref_init_model(jax.random.PRNGKey(REF["key"]),
                                ref_reduced(ref_get_config(REF["kv_arch"])))
    spec = dict(REF, prompts=prompts.tolist())
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen([sys.executable, "-c", REF_SCRIPT,
                             json.dumps(spec)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    xparams = {arch: _gated(jax.tree.map(np.asarray, ref_init_model(
        jax.random.PRNGKey(REF["key"]), ref_reduced(ref_get_config(arch)))[0]))
        for arch in REF["x_archs"]}
    ref = dict(REF, params=jax.tree.map(np.asarray, params),
               kv_params=jax.tree.map(np.asarray, kparams),
               prompts=prompts, x_params=xparams)
    yield proc, ref
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def reference_out(reference):
    proc, _ = reference
    out, err = proc.communicate(timeout=TIMEOUT_S)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def dp_tp(store, reference):
    return _group(store, 4, "dp_tp", reference[1])


def _grid(dp, tp, dp_tp, grid):
    return tp[0] if grid == (1, 2) else dp_tp[0][grid]


# -- data parallelism ---------------------------------------------------------


def test_resident_cache_is_sharded_over_data(dp):
    """Each rank's resident cache holds its half of the slots."""
    (shape0, lo0, hi0), (shape1, lo1, hi1) = (r["resident"] for r in dp)
    assert shape0[0] == shape1[0] == S.SLOTS // 2
    assert (lo0, hi0, lo1, hi1) == (0, 4, 4, 8)


@pytest.mark.parametrize("case", ["dp2", "dp2xtp2-paged",
                                  "tp2-paged-int8"])
def test_resident_cache_is_the_resolved_cache_specs(dp, tp, dp_tp, case):
    """On every rank the continuous engine's resident cache has the
    shapes its rules resolve ``unstacked_cache_specs`` to: slots over
    "data", K/V heads and their scales over "model", the page pool and
    the selection caches whole."""
    runs = {"dp2": (dp, "layout"), "dp2xtp2-paged": (dp_tp, "layout"),
            "tp2-paged-int8": (tp, "int8_layout")}
    ranks, key = runs[case]
    for rank, res in enumerate(ranks):
        got, want = res[key]
        assert got == want, (case, rank)


def test_sharded_run_bitwise_chunked_and_segments(dp):
    """Chunked admission and decode segments, mixed lengths and n_new = 1
    requests: the dp engine's tokens are the unsharded engine's."""
    _equal(dp[0]["chunked"])
    plain_chunked, sharded_chunked, chunks = dp[0]["chunked_stats"]
    assert plain_chunked and sharded_chunked and chunks > 0


def test_sharded_run_bitwise_sampled_chains(dp):
    """Sampled per-slot chains with per-request temperatures."""
    _equal(dp[0]["sampled"])


def test_sharded_run_matches_solo_engine(dp):
    """Sharded continuous serving equals solo ``Engine.generate``."""
    got, solo = dp[0]["solo"]
    for rid, toks in solo.items():
        np.testing.assert_array_equal(got[rid], toks, err_msg=f"rid {rid}")


def test_sharded_blocking_admission_bitwise(dp):
    """Blocking whole-prompt admission under the mesh."""
    _equal(dp[0]["blocking"])
    assert not dp[0]["blocking_chunked"]


def test_sharded_speculative_segments_bitwise(dp):
    """Speculative segments: each round's tokens and emit counts are
    gathered over "data"."""
    _equal(dp[0]["spec"])
    k, rounds = dp[0]["spec_stats"]
    assert k == 3 and rounds > 0


def test_sharded_dsa_long_context_bitwise(dp):
    """DSA block decode over the predicted-key cache, slots sharded."""
    _equal(dp[0]["dsa_long"])


def test_sharded_paged_serving_bitwise(dp):
    """A paged resident cache with a copy-on-write prefix group, a miss
    wave then a hit wave; both engines drain the pool."""
    waves, (reused, available, expect) = dp[0]["paged"]
    for wave in waves:
        _equal(wave)
    assert reused > 0 and available == expect


def test_sharded_engine_generate_bitwise(dp):
    """Static ``generate`` over the batch's rows, greedy and sampled (a
    rank draws the whole batch's noise and keeps its rows)."""
    for greedy, pair in dp[0]["generate"].items():
        np.testing.assert_array_equal(pair[1], pair[0],
                                      err_msg=f"greedy={greedy}")


def test_sharded_nan_isolation_matches_unsharded(dp):
    """Fault isolation on the dp-2 resident engine (the reference's
    tests/test_faults.py case): the poisoned slot fails with a prefix of
    its fault-free tokens, the survivors equal the unsharded fault-free
    run, and the engine drains clean."""
    base, got, failed, clean = dp[0]["nan"]
    assert failed == 1 and clean
    assert 0 < len(got[1]) < len(base[1])
    np.testing.assert_array_equal(got[1], base[1][:len(got[1])])
    for rid in (0, 2):
        np.testing.assert_array_equal(got[rid], base[rid], err_msg=f"{rid}")


def test_sharded_segment_compiles_once(dp):
    """One segment signature, across a reset too."""
    assert dp[0]["compiles"] == (1, 1)


# -- tensor parallelism ---------------------------------------------------------


@pytest.mark.parametrize("grid", TP_GRID, ids=_tp_ids)
def test_tp_weights_shard_over_model(dp, tp, dp_tp, grid):
    """Weights shard: ``tp`` is the model axis's width, wq holds n_heads /
    tp heads, and the bytes on a rank are about 1 / tp of the whole."""
    eng_tp, per_dev, full, wq = _grid(dp, tp, dp_tp, grid)["weights"]
    cfg = reduced(get_config("stablelm_3b"))
    assert eng_tp == grid[1]
    assert wq == (cfg.d_model, cfg.n_heads * cfg.resolved_head_dim
                  // grid[1])
    assert per_dev / full <= 1.0 / grid[1] + 0.08, per_dev / full


@pytest.mark.parametrize("grid", TP_GRID, ids=_tp_ids)
def test_tp_continuous_chunked_bitwise(dp, tp, dp_tp, grid):
    """Chunked admission and segments under dp x tp."""
    res = _grid(dp, tp, dp_tp, grid)
    _equal(res["chunked"])
    eng_tp, chunks = res["chunked_stats"]
    assert eng_tp == grid[1] and chunks > 0


@pytest.mark.parametrize("dsa_mode", ["block", "kernel"])
def test_tp_dsa_modes_bitwise(dp_tp, dsa_mode):
    """DSA under tp: kt/ktb stay whole, every shard selects the same
    blocks and gathers its own heads (dp 2 x tp 2)."""
    _equal(dp_tp[0][("dsa", dsa_mode)])


def test_tp_streamed_weights_equal_whole_tree_placement(tp):
    """An engine given ``init_model`` to call keeps each piece's shard as
    it is drawn: the same shards, bit for bit, and the same tokens as an
    engine given the whole tree."""
    shapes, same, streamed, whole = tp[0]["streamed"]
    cfg = reduced(get_config("stablelm_3b"))
    assert (cfg.vocab // 2, cfg.d_model) in shapes
    assert same
    np.testing.assert_array_equal(streamed, whole)


def test_tp_sampled_chains_bitwise(tp):
    """Sampled chains under tp: the logits are gathered before sampling,
    so every rank draws the same tokens."""
    _equal(tp[0]["sampled"])


def test_tp_blocking_admission_bitwise(dp_tp):
    _equal(dp_tp[0]["blocking"])
    assert not dp_tp[0]["blocking_chunked"]


def test_tp_paged_bitwise(dp_tp):
    """Paged pool rows head-sharded over "model", slots over "data"."""
    _equal(dp_tp[0]["paged"])


@pytest.mark.parametrize("grid", TP_GRID, ids=_tp_ids)
def test_tp_static_generate_bitwise(dp, tp, dp_tp, grid):
    for greedy, pair in _grid(dp, tp, dp_tp, grid)["generate"].items():
        np.testing.assert_array_equal(pair[1], pair[0],
                                      err_msg=f"greedy={greedy}")


def test_tp_segment_compiles_once(dp_tp):
    assert dp_tp[0]["compiles"] == (1, 1)


def test_tp_mesh_divisibility_error():
    """An indivisible tp with a cfg raises a ValueError naming the axis,
    before any process is asked: 3 KV heads at tp 4, which neither
    divides nor is a multiple of them."""
    cfg = dataclasses.replace(reduced(get_config("yi_6b")), n_heads=12,
                              n_kv_heads=3)
    with pytest.raises(ValueError, match="kv_heads"):
        make_serving_mesh(dp=2, tp=4, cfg=cfg)


def test_tp_indivisible_falls_back_replicated(dp_tp):
    """A (1, 4) mesh without a cfg on reduced yi_6b cut to 2 query
    heads: the engine serves replicated weights (tp 1, every byte on
    each rank) and gives the unsharded tokens."""
    eng_tp, per_dev, full = dp_tp[0]["fallback_weights"]
    assert eng_tp == 1 and per_dev == full
    for greedy, pair in dp_tp[0]["fallback"].items():
        np.testing.assert_array_equal(pair[1], pair[0],
                                      err_msg=f"greedy={greedy}")


@pytest.mark.parametrize("case", ["static", "continuous"])
def test_tp_above_kv_heads_equals_unsharded(dp_tp, case):
    """tp 4 on reduced yi_6b's 4 query heads and 2 KV heads: each rank
    computes one query head on its group's KV head (``kv_group`` 2), its
    slice of the whole KV weights, and the static engine (greedy and
    sampled) and the continuous engine give the unsharded tokens."""
    for res in dp_tp:
        tp, hq, hkv, wk, own_head = res["kv_weights"]
        assert (tp, hq, hkv, wk, own_head) == (4, 1, 1, (64, 16), True)
    if case == "continuous":
        _equal(dp_tp[0]["kv_continuous"])
        return
    for greedy, pair in dp_tp[0]["kv_generate"].items():
        np.testing.assert_array_equal(pair[1], pair[0],
                                      err_msg=f"greedy={greedy}")


def test_tp_decode_segment_collective_budget(tp):
    """A pure-tp decode segment issues 2 * n_layers + 1 all-reduces and 1
    all-gather over "model" a step and nothing over "data", at seg_len 4
    and 8 alike (no collective added per token)."""
    cfg = reduced(get_config("stablelm_3b"))
    budget = tp[0]["budget"]
    for seg, (model, data, steps) in budget.items():
        assert steps == seg
        C.check_tp_decode_collectives(model, cfg.n_layers, steps)
        assert data == {"all-reduce": 0, "all-gather": 0}
    C.assert_collectives_token_invariant(budget[4][0], budget[8][0],
                                         budget[4][2], budget[8][2])


def test_tp_mixtral_bitwise(tp):
    """mixtral at tp 2: 2 of the 4 reduced experts on each rank, the
    capacity prefill and the decode-dense steps combine locally and
    all-reduce; static (kernel DSA on the ring) and continuous."""
    assert tp[0]["mixtral_experts"] == (2, 4)
    for greedy, pair in tp[0]["mixtral_generate"].items():
        np.testing.assert_array_equal(pair[1], pair[0],
                                      err_msg=f"greedy={greedy}")
    _equal(tp[0]["mixtral_continuous"])


@pytest.mark.parametrize("arch", ["h2o_danube_1_8b", "qwen1_5_110b"])
def test_tp_other_dense_archs_bitwise(tp, arch):
    """tp 2 on h2o_danube_1_8b (an SWA ring, kernel DSA with the window,
    blocking admission) and qwen1_5_110b (QKV biases sharded with their
    heads): static generate greedy and sampled, and continuous serving."""
    gen, cont = tp[0][arch]
    for greedy, pair in gen.items():
        np.testing.assert_array_equal(pair[1], pair[0],
                                      err_msg=f"greedy={greedy}")
    _equal(cont)


def test_tp_int8_kv_paged_bitwise(tp):
    """int8 K/V and int8 selection on a paged pool at tp 2: the pool's
    rows and their scales hold one KV head of the two."""
    _equal(tp[0]["int8"])
    dtype, k, k_s = tp[0]["int8_cache"]
    assert str(dtype) == "torch.int8" and k[1] == 1 and k_s[1] == 1


def test_reference_dp2_tp2_tokens(dp_tp, reference_out):
    """The port's 4-process dp 2 x tp 2 engines on the reference's
    weights give the reference's own sharded engines' greedy tokens."""
    gen, cont = dp_tp[0]["reference"]
    assert reference_out["tp"] == 2
    np.testing.assert_array_equal(gen, np.asarray(reference_out["gen"]))
    assert {str(k) for k in cont} == set(reference_out["cont"])
    for rid, toks in cont.items():
        np.testing.assert_array_equal(toks,
                                      reference_out["cont"][str(rid)])


def test_reference_tp_above_kv_heads_tokens(dp_tp, reference_out):
    """At tp 4 above reduced yi_6b's 2 KV heads, the port's (1, 4)
    engine (tp 4) on the reference's weights gives the reference's own
    (1, 4) engine's greedy tokens.  The reference's engine does not
    shard there: its divisibility check falls back to replicated
    weights (tp 1), so this holds the port's sharded serving against
    the reference's unsharded arithmetic on a (1, 4) mesh of Auto axes
    (its Explicit-axis serving mesh cannot serve at tp > 1, the fault
    below)."""
    assert reference_out["kv_tp"] == 1 and dp_tp[0]["reference_kv"][0] == 4
    np.testing.assert_array_equal(dp_tp[0]["reference_kv"][1],
                                  np.asarray(reference_out["kv_gen"]))


def test_reference_fault_explicit_axis_serving_mesh(reference_out):
    """Reference fault (ROADMAP Queue 3): under jax 0.9 the reference's
    ``make_serving_mesh`` builds a mesh of Explicit axes, on which its
    tp engine refuses the vocab-sharded embedding gather."""
    assert reference_out["serving_mesh"].startswith("ShardingTypeError")


# -- refusals, rules and spec trees (no process group) -------------------------


@pytest.mark.parametrize("arch", ["deepseek_v3", "jamba_1_5_large"])
def test_tp_unsupported_archs_raise(arch):
    """MLA and Mamba archs have a tensor-parallel form now: at tp 2 no
    refusal and no indivisible axis, a rank's geometry of half the heads
    (and, on jamba, half of Mamba's inner channels, with the whole
    width's dt rank); a tp that does not divide Mamba's inner width or
    the shared experts' d_ff raises ``ValueError`` naming it."""
    cfg = reduced(get_config(arch))
    assert TS.serving_tp_issues(cfg, 2) == []
    shard = TS.shard_config(cfg, 2)
    assert shard.n_heads == cfg.n_heads // 2
    if cfg.mamba is not None:
        assert ssm.d_inner(shard) * 2 == ssm.d_inner(cfg) == 128
        assert ssm.dt_rank(shard) == ssm.dt_rank(cfg) == 8
        bad = dataclasses.replace(cfg, d_model=66, mamba=dataclasses.replace(
            cfg.mamba, expand=1))
        want = "Mamba d_inner=66"
    else:
        bad = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, d_ff_expert=63))
        want = "shared experts' d_ff=63"
    assert len(TS.serving_tp_issues(bad, 4 if cfg.mamba else 2)) == 1
    with pytest.raises(ValueError, match=want):
        make_serving_mesh(dp=1, tp=4 if cfg.mamba else 2, cfg=bad)


@pytest.mark.parametrize("arch", S.XARCHS)
def test_tp_cross_and_rwkv_archs_are_accepted(arch):
    """Cross-attention and RWKV6 archs have a tensor-parallel form: no
    refusal, no indivisible axis at tp 2, and a rank's geometry of half
    the heads (RWKV6's d_model / head_dim among them) and half d_ff."""
    cfg = reduced(get_config(arch))
    assert TS.serving_tp_issues(cfg, 2) == []
    shard = TS.shard_config(cfg, 2)
    assert (shard.n_heads, shard.d_ff) == (cfg.n_heads // 2, cfg.d_ff // 2)
    if cfg.rwkv is not None:
        assert cfg.n_heads == cfg.d_model // cfg.rwkv.head_dim


def test_tp_unsupported_engine_raises(tp):
    """The engine serves jamba at tp 2 on a tp mesh built without a cfg
    (it refused before Mamba had a tensor-parallel form)."""
    assert tp[0]["jamba_tp"] == 2


# -- cross-attention and RWKV6 under tensor parallelism --------------------------

# f32 at reduced width: the tp sums run in another order (ROADMAP,
# "Products are not row-invariant"); measured <= 1e-6 of the largest logit
X_LOGIT_RTOL = 1e-5


def _x_grid(tp, dp_tp, grid, arch):
    return (tp[0]["x", arch]["generate"] if grid == (1, 2)
            else dp_tp[0]["x", arch])


@pytest.mark.parametrize("grid", [(1, 2), (2, 2)], ids=_tp_ids)
@pytest.mark.parametrize("arch", S.XARCHS)
def test_tp_cross_and_rwkv_generate_equals_unsharded(tp, dp_tp, arch, grid):
    """whisper_small (the encoder-decoder), llama_3_2_vision (gated
    cross-attention over the image) and rwkv6_3b at tp 2 and dp 2 x tp
    2, every cross gate at 0.5: static generate with the second input,
    greedy and sampled, gives the unsharded tokens."""
    for greedy, pair in _x_grid(tp, dp_tp, grid, arch).items():
        np.testing.assert_array_equal(pair[1], pair[0],
                                      err_msg=f"greedy={greedy}")


@pytest.mark.parametrize("arch", S.XARCHS)
def test_tp_cross_and_rwkv_continuous_equals_unsharded(tp, arch):
    """The continuous engine at tp 2 (blocking admission: K7 on the
    rank's heads for rwkv6_3b) gives the unsharded engine's tokens, and
    its resident cache (RWKV6's state over heads, its last tokens whole;
    the cross ``ck``/``cv`` over KV heads) has the resolved specs'
    shapes on every rank."""
    _equal(tp[0]["x", arch]["continuous"])
    for rank, res in enumerate(tp):
        got, want = res["x", arch]["layout"]
        assert got == want, rank


@pytest.mark.parametrize("arch", S.XARCHS)
def test_tp_cross_and_rwkv_prefill_logits_and_weights(tp, arch):
    """The tp-2 prefill's last-row logits within ``X_LOGIT_RTOL`` of the
    unsharded ones (relative to the largest), and a rank's weights about
    half the whole (norms, RWKV6's mixes and decay LoRA, the FFN's
    receptance and the gates stay whole)."""
    for res in tp:
        x = res["x", arch]
        assert x["logits"] <= X_LOGIT_RTOL, x["logits"]
        eng_tp, per_dev, full = x["weights"]
        assert eng_tp == 2 and per_dev / full <= 0.5 + 0.2, per_dev / full


@pytest.mark.parametrize("arch", S.XARCHS)
def test_tp_cross_and_rwkv_collective_budget(tp, arch):
    """One decode step issues ``tp_decode_all_reduces`` all-reduces over
    "model" (whisper_small 3 a decoder layer, llama_3_2_vision 2 a layer
    and 1 a cross layer, rwkv6_3b 2 a layer; each + 1 for the embedding)
    and one all-gather; a prefill the same and, on whisper_small, 2 an
    encoder layer more."""
    cfg = reduced(get_config(arch))
    for res in tp:
        prefill, step, per = res["x", arch]["budget"]
        want = {"whisper_small": 3 * cfg.n_layers + 1,
                "llama_3_2_vision": 2 * cfg.n_layers + cfg.n_layers // 5 + 1,
                "rwkv6_3b": 2 * cfg.n_layers + 1}[arch]
        assert per == want
        C.check_tp_decode_collectives(step, cfg.n_layers, 1, per)
        enc = 2 * cfg.n_enc_layers if cfg.enc_dec else 0
        C.check_tp_decode_collectives(prefill, cfg.n_layers, 1, per + enc)


@pytest.mark.parametrize("case", ["static", "continuous"])
def test_tp_llama_vision_above_kv_heads_equals_unsharded(dp_tp, case):
    """tp 4 on reduced llama_3_2_vision's 4 query heads and 2 KV heads:
    each rank one query head on its group's KV head in the
    self-attention and in the cross-attention (its slice of both whole
    KV weights), and the static (greedy and sampled, with the image) and
    continuous engines give the unsharded tokens."""
    for rank, res in enumerate(dp_tp):
        assert res["x_kv_weights"] == (4, 1, 1, (64, 16), True), rank
    if case == "continuous":
        _equal(dp_tp[0]["x_kv_continuous"])
        return
    for greedy, pair in dp_tp[0]["x_kv_generate"].items():
        np.testing.assert_array_equal(pair[1], pair[0],
                                      err_msg=f"greedy={greedy}")


def test_tp_explicit_rules_never_fall_back_replicated(dp_tp):
    """Explicit tensor-parallel ``shard_rules`` on a (1, 4) mesh whose
    tp the 2 query heads do not divide raise ``ValueError`` naming the
    axis (where the default rules fall back to replicated weights,
    ``test_tp_indivisible_falls_back_replicated``)."""
    msg = dp_tp[0]["explicit_rules"]
    assert msg is not None and "heads" in msg and "Distribution" in msg


@pytest.mark.parametrize("arch", S.XARCHS)
def test_reference_dp2_tp2_cross_and_rwkv_tokens(dp_tp, reference_out,
                                                 arch):
    """The port's dp 2 x tp 2 engines on the reference's weights of the
    cross-attention and RWKV6 archs (gates at 0.5, the same second input)
    give the reference's own (2, 2) engine's greedy tokens."""
    assert reference_out[f"x_tp/{arch}"] == 2
    np.testing.assert_array_equal(dp_tp[0]["x_reference"][arch],
                                  np.asarray(reference_out[f"x_gen/{arch}"]))


# -- Mamba and multi-head latent attention under tensor parallelism -----------


@pytest.mark.parametrize("grid", [(1, 2), (2, 2)], ids=_tp_ids)
@pytest.mark.parametrize("arch", S.MARCHS)
def test_tp_mamba_and_mla_generate_equals_unsharded(tp, dp_tp, arch, grid):
    """jamba_1_5_large (Mamba sub-blocks on a rank's half of the inner
    channels, its attention on half the heads, MoE) and deepseek_v3 (MLA
    on half the heads, the latent cache whole; its shared experts' half
    columns) at tp 2 and dp 2 x tp 2: static generate, greedy and
    sampled, gives the unsharded tokens."""
    for greedy, pair in _x_grid(tp, dp_tp, grid, arch).items():
        np.testing.assert_array_equal(pair[1], pair[0],
                                      err_msg=f"greedy={greedy}")


@pytest.mark.parametrize("arch", S.MARCHS)
def test_tp_mamba_and_mla_continuous_equals_unsharded(tp, arch):
    """The continuous engine at tp 2 gives the unsharded engine's tokens,
    and its resident cache (Mamba's ``h`` and ``conv`` over the inner
    channels; MLA's ``c_kv`` and ``k_rope`` whole) has the resolved
    specs' shapes on every rank."""
    _equal(tp[0]["x", arch]["continuous"])
    for rank, res in enumerate(tp):
        got, want = res["x", arch]["layout"]
        assert got == want, rank


@pytest.mark.parametrize("arch", S.MARCHS)
def test_tp_mamba_and_mla_prefill_logits_and_budget(tp, arch):
    """The tp-2 prefill's last-row logits within ``X_LOGIT_RTOL`` of the
    unsharded ones, a rank's weights about half the whole, and one
    decode step's collectives the budget: 3 all-reduces a Mamba
    sub-block (``x_proj``, ``out_proj``, its MLP's or MoE's), 2 an
    attention or MLA one, 1 for the embedding, and one all-gather; a
    prefill the same."""
    cfg = reduced(get_config(arch))
    want = {"jamba_1_5_large": 3 * 7 + 2 + 1,
            "deepseek_v3": 2 * cfg.n_layers + 1}[arch]
    for res in tp:
        x = res["x", arch]
        assert x["logits"] <= X_LOGIT_RTOL, x["logits"]
        eng_tp, per_dev, full = x["weights"]
        assert eng_tp == 2 and per_dev / full <= 0.5 + 0.1, per_dev / full
        prefill, step, per = x["budget"]
        assert per == want
        C.check_tp_decode_collectives(step, cfg.n_layers, 1, per)
        C.check_tp_decode_collectives(prefill, cfg.n_layers, 1, per)


def test_tp_mamba_weights_are_both_halves(tp):
    """A jamba rank's ``in_proj`` is its channels of both halves [x_r |
    z_r] (``sharding.Halves``: a plain split would give rank 0 all of x),
    its ``x_proj`` its rows at the whole width's dt rank (8 + 2 x 8
    columns), and its ``h`` and ``conv`` caches its 64 of 128
    channels."""
    for rank, res in enumerate(tp):
        w = res["mamba_weights"]
        assert w["in_proj"], rank
        assert w["x_proj"] == ((64, 8 + 2 * 8), True), rank
        assert (w["dt_rank"], w["d_inner"]) == (8, 64)
        assert w["cache"] == ((2, 64, 8), (2, 3, 64))


@pytest.mark.parametrize("arch", S.MARCHS)
def test_reference_dp2_tp2_mamba_and_mla_tokens(dp_tp, reference_out, arch):
    """The port's dp 2 x tp 2 engines on the reference's weights of
    jamba_1_5_large and deepseek_v3 give the reference's own (2, 2)
    engine's greedy tokens (its GSPMD resharding Mamba's ``xz`` halves
    and MLA's heads)."""
    assert reference_out[f"x_tp/{arch}"] == 2
    np.testing.assert_array_equal(dp_tp[0]["x_reference"][arch],
                                  np.asarray(reference_out[f"x_gen/{arch}"]))


def test_serving_config_mesh_fields():
    """``mesh`` and ``shard_rules`` are served; a wrong type raises, and
    rules that shard the cache's sequence (long context) are refused."""
    with pytest.raises(TypeError, match="mesh"):
        ServingConfig(mesh=1)
    with pytest.raises(TypeError, match="shard_rules"):
        ServingConfig(shard_rules=1)
    long_context = dataclasses.replace(TS.make_serving_rules(),
                                       cache_seq="model")
    with pytest.raises(NotImplementedError, match="Distribution"):
        ServingConfig(shard_rules=long_context)
    rules = TS.make_serving_rules(tp=True)
    assert ServingConfig(shard_rules=rules).shard_rules is rules


class _Mesh:
    """A DeviceMesh's names and shape, enough for ``resolve_spec``."""

    def __init__(self, shape, names):
        self.mesh_dim_names = names
        self.mesh = np.zeros(shape)


@pytest.mark.parametrize("tp_rules", [False, True])
def test_resolve_spec_matches_reference(tp_rules):
    """Divisibility and one use per mesh axis, as the reference resolves
    them, over every leaf of the reduced archs' weights."""
    amesh = jax.sharding.AbstractMesh((2, 4), ("data", "model"))
    mesh = _Mesh((2, 4), ("data", "model"))
    rrules = RS.make_serving_rules(tp=tp_rules)
    trules = TS.make_serving_rules(tp=tp_rules)
    for arch in ("stablelm_3b", "yi_6b", "mixtral_8x22b", "deepseek_v3",
                 "whisper_small", "llama_3_2_vision", "rwkv6_3b"):
        cfg = reduced(get_config(arch))
        params = init_model(0, cfg, device="cpu")
        specs = model_param_specs(cfg)

        def one(p, log):
            got = TS.resolve_spec(tuple(p.shape), log, trules, mesh)
            want = tuple(RS.resolve_spec(tuple(p.shape), log, rrules,
                                         amesh))
            assert got[:len(want)] == want, (arch, log, got, want)
            assert all(a is None for a in got[len(want):])
        TS._map2(one, params, specs)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_param_specs_match_init(arch):
    """The spec tree built from the cfg alone covers every leaf of
    ``init_model`` with one logical axis per dimension, and names the
    reference's logical axes (its stacked layer axis aside)."""
    cfg = reduced(get_config(arch))
    params = init_model(0, cfg, device="cpu")
    specs = model_param_specs(cfg)
    TS._map2(lambda p, log: None if p.dim() == len(log) else pytest.fail(
        f"{arch}: {tuple(p.shape)} vs {log}"), params, specs)
    rspecs = ref_model_param_specs(ref_reduced(ref_get_config(arch)))
    assert specs["embed"] == rspecs["embed"]
    rgroup = RS.map_specs(lambda s: tuple(s[1:]), rspecs["groups"])
    assert specs["groups"][0] == rgroup


@pytest.mark.parametrize("layout", ["dense", "paged", "int8", "ring"])
def test_unstacked_cache_specs_match_cache(layout):
    """The cache spec tree covers every leaf of ``init_cache`` in each
    layout: slot rows over "batch", a pool's rows over "pages", K/V heads
    over "kv_heads", the selection caches without a head axis."""
    arch = "h2o_danube_1_8b" if layout == "ring" else "yi_6b"
    cfg = reduced(get_config(arch))
    flags = RunFlags(mode="decode", long_context=True,
                     kv_quant="int8" if layout == "int8" else None,
                     select_dtype="int8" if layout == "int8" else "float32")
    caches = init_cache(cfg, 4, 96, flags, device="cpu",
                        pages=13 if layout == "paged" else None)
    specs = unstacked_cache_specs(cfg, caches)
    TS._map2(lambda t, log: None if t.dim() == len(log) else pytest.fail(
        f"{layout}: {tuple(t.shape)} vs {log}"), caches, specs)
    attn = specs["groups"][0]["b0"]["attn"]
    assert attn["k"][-2] == "kv_heads"
    assert attn["k"][0] == ("pages" if layout == "paged" else "batch")
    if layout != "ring":
        assert "kv_heads" not in attn["kt"]


def test_a_failing_rank_fails_the_group_without_hanging(tmp_path):
    """One rank raising fails ``run_spmd`` (the peers' collective errors
    out instead of waiting) well inside the group's timeout, and the
    failure names a rank."""
    import time
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank"):
        run_spmd(S.fail_rank, 2, store_dir=str(tmp_path), args=(1,),
                 timeout_s=60)
    assert time.monotonic() - t0 < 60


def test_collective_budget_checks():
    """The budget check names the op whose count is off, and the token
    invariance check catches a per-token collective."""
    ok = {"all-reduce": 5 * 3, "all-gather": 3}
    assert C.check_tp_decode_collectives(ok, 2, steps=3) == ok
    with pytest.raises(AssertionError, match="all-reduce"):
        C.check_tp_decode_collectives({"all-reduce": 4, "all-gather": 1}, 2)
    with pytest.raises(AssertionError, match="all-gather"):
        C.check_tp_decode_collectives({"all-reduce": 5, "all-gather": 2}, 2)
    with pytest.raises(AssertionError, match="varies"):
        C.assert_collectives_token_invariant(
            {"all-reduce": 20}, {"all-reduce": 41}, 4, 8)
