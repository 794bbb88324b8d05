"""The port's dry run (``repro_torch.launch.dryrun``, ``launch/specs.py``,
``distributed/hlo_analysis.py``) against the reference's.

What must hold:
- ``collective_summary`` and ``roofline`` are the reference's functions:
  equal key for key on the same ``Collective`` lists, the roofline with
  the reference's TPU constants passed in (exact: the same float
  operations in the same order);
- ``SHAPES``, ``LONG_CTX_ARCHS``, ``cell_list()`` and
  ``pick_microbatches`` over all 35 cells equal the reference's, read in
  a subprocess (importing ``repro.launch.dryrun`` overwrites
  ``XLA_FLAGS``, which would reach the other tests of this worker);
- the fake count is the real one: on reduced yi_6b the counters over a
  fake step equal those over the same step run on CPU tensors (FLOPs,
  bytes and the peak exactly), and at (2, 2) over gloo also the recorded
  collectives, the counters and ``TrainPlan.collective_budget``, and the
  bytes of a rank's params and moments;
- the 1-/2-group extrapolation equals a full-depth fake count at 4
  groups (FLOPs, bytes and collectives exactly);
- the cells the port cannot run raise naming "Distribution".
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from repro.distributed import hlo_analysis as RH
from repro_torch.configs.base import (LONG_CTX_ARCHS, SHAPES, ShapeConfig,
                                      get_config, reduced)
from repro_torch.distributed import collectives as C
from repro_torch.distributed import hlo_analysis as TH
from repro_torch.distributed import sharding as TS
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import make_production_mesh, mesh_over, run_spmd
from repro_torch.models.attention import RunFlags
from repro_torch.training import steps as ST

import spmd_train_scenarios as S

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
TIMEOUT_S = 240

# -- the reference's pure functions, in this process --------------------------

COLLS = {
    "empty": [],
    "mixed": [("all-reduce", 2 ** 27, 16, True), ("all-reduce", 4096, 2, False),
              ("all-gather", 3 * 2 ** 20, 16, False),
              ("reduce-scatter", 2 ** 20, 4, True),
              ("all-to-all", 12345, 8, False),
              ("collective-permute", 777, 2, True)],
    "big_ars": [("all-reduce", 2 ** 26 + 1, 256, True),
                ("all-reduce", 2 ** 26, 256, False),
                ("all-reduce", 2 ** 30, 16, False)],
}


def _colls(mod, case):
    out = []
    for op, payload, n, crosses in COLLS[case]:
        f = (n - 1) / n
        wire = int(2 * f * payload) if op == "all-reduce" else int(
            f * payload)
        out.append(mod.Collective(op, payload, wire, n, crosses))
    return out


@pytest.mark.parametrize("case", sorted(COLLS))
def test_collective_summary_equals_reference(case):
    assert TH.collective_summary(_colls(TH, case)) == \
        RH.collective_summary(_colls(RH, case))


TPU = dict(peak=RH.PEAK_FLOPS, hbm=RH.HBM_BW, link=RH.ICI_BW, dci=RH.DCI_BW)


@pytest.mark.parametrize("case", sorted(COLLS))
@pytest.mark.parametrize("model_flops", [0.0, 3.8e16])
def test_roofline_equals_reference(case, model_flops):
    """The port's roofline with the reference's TPU constants passed in
    is the reference's, key for key (exact)."""
    coll = RH.collective_summary(_colls(RH, case))
    for flops, nbytes in ((1.4e14, 7.1e12), (3e9, 1e12), (5e11, 0.0)):
        got = TH.roofline(flops, nbytes, coll, model_flops, 256, **TPU)
        want = RH.roofline(flops, nbytes, coll, model_flops, 256)
        assert got == want


def test_roofline_defaults_are_the_h100s():
    assert (TH.PEAK_FLOPS, TH.HBM_BW, TH.LINK_BW, TH.DCI_BW) == (
        989e12, 3.35e12, 450e9, 50e9)
    r = TH.roofline(989e12, 3.35e12, {"total_wire_bytes": 450e9,
                                      "dci_wire_bytes": 0.0}, 0.0, 1)
    assert r["compute_s"] == r["memory_s"] == r["collective_s"] == 1.0


def test_parse_collectives_ring_factors_and_nodes():
    """Ring factors 2 (n-1)/n and (n-1)/n of the per-device output, a
    group of one left out, and a group across two 8-GPU nodes marked."""
    recs = [C.Issued("all-reduce", "model", 4, (0, 1, 2, 3), 1000),
            C.Issued("all-gather", "data", 2, (0, 16), 800),
            C.Issued("reduce-scatter", "model", 16, tuple(range(16)), 160),
            C.Issued("all-to-all", "model", 8, tuple(range(8, 16)), 64),
            C.Issued("all-reduce", "model", 1, (0,), 999)]
    got = [dataclasses.astuple(c) for c in TH.parse_collectives(recs)]
    assert got == [("all-reduce", 1000, 1500, 4, False),
                   ("all-gather", 800, 400, 2, True),
                   ("reduce-scatter", 160, 150, 16, True),
                   ("all-to-all", 64, 56, 8, False)]


def test_recorder_is_off_by_default():
    """Outside ``recording()`` a collective records nothing, and a record
    is closed on exit (the counters count either way)."""
    g = C.AxisGroup("model", None, 1, 0, "gloo")
    x = torch.ones(3)
    assert C._RECORD[0] is None
    C.all_reduce(x, g)
    assert C._RECORD[0] is None
    with C.recording() as rec:
        C.all_gather(x, g)
        C.reduce_scatter(torch.ones(4), g)
    assert C._RECORD[0] is None
    assert [(r.op, r.size, r.payload_bytes) for r in rec] == [
        ("all-gather", 1, 12), ("reduce-scatter", 1, 16)]


# -- the reference's tables, read in a subprocess ----------------------------

REF_SCRIPT = r"""
import json
from repro.configs.base import LONG_CTX_ARCHS, SHAPES, get_config
from repro.launch import dryrun as D
print(json.dumps({
    "shapes": {k: [v.name, v.seq_len, v.global_batch, v.kind]
               for k, v in SHAPES.items()},
    "long": list(LONG_CTX_ARCHS),
    "cells": [list(c) for c in D.cell_list()],
    "mb": [D.pick_microbatches(get_config(a), SHAPES[s])
           for a, s in D.cell_list()]}))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=SRC,
               DRYRUN_DEVICES="1")
    out = subprocess.run([sys.executable, "-c", REF_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_shapes_equal_reference(reference):
    assert {k: [v.name, v.seq_len, v.global_batch, v.kind]
            for k, v in SHAPES.items()} == reference["shapes"]
    assert list(LONG_CTX_ARCHS) == reference["long"]


def test_cell_list_equals_reference(reference):
    cells = DR.cell_list()
    assert [list(c) for c in cells] == reference["cells"]
    assert len(cells) == 35


def test_pick_microbatches_equal_reference(reference):
    assert [DR.pick_microbatches(get_config(a), SHAPES[s])
            for a, s in DR.cell_list()] == reference["mb"]


# -- the fake count against a real run ------------------------------------------


def _shape(kind):
    return {"train": S.DRYRUN_SHAPE,
            "prefill": ShapeConfig("prefill_64", 64, 4, "prefill"),
            "decode": ShapeConfig("decode_64", 64, 8, "decode")}[kind]


def test_fake_count_equals_real_run_unsharded():
    """One train step of reduced yi_6b (2 microbatches) at ``mesh=None``:
    the counters over fake tensors equal those over CPU tensors, FLOPs,
    bytes and MemTracker's peak exactly."""
    yi = S.cfg_of("yi_6b")

    def count():
        state, _ = ST.init_train_state(S.SEED, yi, S.OPT, device="cpu")
        step = ST.make_train_step(yi, S.OPT, ST.default_flags(yi), 2)
        batch = DR._train_batch(yi, S.DRYRUN_SHAPE, S.BATCH)
        with DR.counted((state, batch)) as res:
            step(state, batch)
        return res

    real = count()
    with DR._fake_mode():
        fake = count()
    assert real["flops"] > 0 and real["bytes"] > 0
    for k in ("flops", "bytes", "peak"):
        assert fake[k] == real[k], k
    assert fake["colls"] == real["colls"] == []


@pytest.fixture(scope="module")
def real22(tmp_path_factory):
    """Rank 0's counts of the real (2, 2) step on four gloo ranks."""
    return run_spmd(S.run, 4, store_dir=str(tmp_path_factory.mktemp("dr")),
                    args=("dryrun",), timeout_s=TIMEOUT_S)


_MESH4 = {}


def mesh4():
    """A (2, 2) mesh over a fake world of 4 (this process rank 0), made
    again when a test has put up another world."""
    DR.fake_world(4)
    key = id(dist.distributed_c10d._get_default_group())
    if key not in _MESH4:
        _MESH4.clear()
        _MESH4[key] = mesh_over((2, 2), ("data", "model"))
    return _MESH4[key]


@pytest.fixture(scope="module", autouse=True)
def no_world_after():
    """No fake world outlives the module."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def fake22(real22):
    """The same step counted on fake tensors in this process (``mesh4``)."""
    mesh = mesh4()
    yi, rules = S.cfg_of("yi_6b"), TS.make_rules()
    before = C.snapshot()
    with DR._fake_mode():
        res = DR._train_count(yi, S.DRYRUN_SHAPE, S.OPT, mesh, rules,
                              ST.default_flags(yi), 2)
        state_bytes = DR._state_bytes(yi, S.DRYRUN_SHAPE, S.OPT, mesh, rules,
                                      True, ST.default_flags(yi))
    counts = C.count_by_axis(before)
    return dict(res, counts=counts, state_bytes=state_bytes)


@pytest.mark.parametrize("what", ["flops", "bytes", "colls", "counts",
                                  "state_bytes"])
def test_fake_count_equals_real_run_2x2(real22, fake22, what):
    """dp 2 x tp 2 under ``make_rules()`` (FSDP, TP, SP), 2 microbatches:
    what the dry run counts on fake tensors in one process is what rank
    0 of the real gloo run counts (exact), and both runs' counters are
    the budget."""
    real = real22[0]
    if what == "colls":
        got = [dataclasses.astuple(r) for r in fake22["colls"]]
        assert got == [tuple(r) for r in real["colls"]]
        assert len(got) == sum(real["counts"].values())
    elif what == "counts":
        C.check_train_collectives(real["counts"], real["budget"])
        C.check_train_collectives(fake22["counts"], real["budget"])
    else:
        assert fake22[what] == real[what]


@pytest.mark.parametrize("kind", ["train", "train-world1", "prefill",
                                  "decode"])
def test_extrapolation_equals_full_depth(kind):
    """Reduced yi_6b at 4 layer groups (2 microbatches in training; on
    the (2, 2) mesh, or at world 1 with ``mesh=None`` as ``chip_smoke.py``
    counts it): the 1-/2-group form (``component_costs``) equals the
    full-depth fake count: FLOPs, bytes and collectives, exactly."""
    mesh = None if kind == "train-world1" else mesh4()
    cfg = DR.depth_cfg(S.cfg_of("yi_6b"), 4, 1)
    shape = _shape(kind.split("-")[0])
    with DR._fake_mode():
        if kind.startswith("train"):
            rules = None if mesh is None else TS.make_rules()
            flags, mb = ST.default_flags(cfg), 2
            full = DR._cost(DR._train_count(cfg, shape, S.OPT, mesh, rules,
                                            flags, mb))
        else:
            rules, mb = TS.make_serving_rules(tp=True), 1
            flags = RunFlags(mode=kind, dsa_mode="block" if kind ==
                             "prefill" else "off", with_mse=False)
            full = DR._cost(DR._serve_count(cfg, shape, mesh, True, flags))
        ext = DR.component_costs(cfg, shape, S.OPT, mesh, rules, flags, mb)
    assert ext["flops"] == full["flops"] > 0
    assert ext["bytes"] == full["bytes"] > 0
    for k in ("n_collectives", "total_wire_bytes", "dci_wire_bytes"):
        assert ext["coll"][k] == full["coll"][k], k
    assert {op: d["count"] for op, d in ext["coll"]["by_op"].items()} == \
        {op: d["count"] for op, d in full["coll"]["by_op"].items()}


# -- refusals and the production mesh (no data) --------------------------------


def test_long_500k_is_refused():
    with pytest.raises(NotImplementedError, match="Distribution"):
        DR.run_cell("yi_6b", "long_500k")


@pytest.mark.parametrize("arch", ["deepseek_v3", "jamba_1_5_large"])
def test_tp_cells_without_a_tp_form_are_refused(arch):
    """MLA and Mamba, which were refused at tp > 1, have a tensor-parallel
    form: the plan on a (2, 2) mesh takes "model" as tensor parallelism
    (a rank's half of the heads, and of Mamba's inner channels, whose
    ``in_proj`` is placed half by half), and tp 2 divides every axis it
    serves."""
    cfg = reduced(get_config(arch))
    plan = TS.make_train_plan(cfg, mesh4(), TS.make_rules())
    assert plan.tp.size == 2 and plan.cfg.n_heads == cfg.n_heads // 2
    halves = {p.rsplit("/", 2)[-2] + "/" + p.rsplit("/", 1)[-1]: d
              for p, d in plan.halves.items()}
    assert halves == ({"attn/in_proj": (1,)} if cfg.mamba else {})
    assert TS.serving_tp_issues(cfg, 2) == []


def test_whisper_tp16_cells_refuse_naming_heads(tmp_path):
    """whisper_small's 12 heads do not divide the production mesh's tp
    16: its decode_32k cell (the engine, on explicit tensor-parallel
    rules) writes a ``.fail`` record naming "heads" and ROADMAP's
    "Distribution" instead of serving replicated weights as tp 16."""
    with pytest.raises(SystemExit) as e:
        DR.main(["--arch", "whisper_small", "--shape", "decode_32k",
                 "--out", str(tmp_path)])
    assert e.value.code == 1
    fail = (tmp_path / "whisper_small__decode_32k__single.json.fail"
            ).read_text()
    assert "heads" in fail and "Distribution" in fail
    assert "ValueError" in fail


def test_main_writes_fail_records_naming_distribution(tmp_path):
    """``--arch deepseek_v3 --shape decode_32k`` on the 256-rank mesh (tp
    16 on MLA, refused before MLA had a tensor-parallel form) writes a
    record: 8 of the 128 heads a rank, the latent cache whole, and the
    decode step's all-reduces over "model"; ``long_500k`` writes a
    ``.fail`` record that names "Distribution" and the run exits 1."""
    with pytest.raises(SystemExit) as e:
        DR.main(["--arch", "deepseek_v3", "--shape", "decode_32k", "--out",
                 str(tmp_path)])
    assert e.value.code == 0
    rec = json.loads((tmp_path / "deepseek_v3__decode_32k__single.json")
                     .read_text())
    assert rec["rules"] == "make_serving_rules"
    assert rec["roofline"]["bound_step_time_s"] > 0
    assert rec["collectives"]["by_op"]["all-reduce"]["count"] > 0
    with pytest.raises(SystemExit) as e:
        DR.main(["--arch", "rwkv6_3b", "--shape", "long_500k", "--out",
                 str(tmp_path)])
    assert e.value.code == 1
    fail = tmp_path / "rwkv6_3b__long_500k__single.json.fail"
    assert "Distribution" in fail.read_text()


def test_yi_decode_record_and_kv_weights_at_tp16(tmp_path):
    """The yi_6b decode_32k cell on the 256-rank mesh writes a record
    with the reference's keys; its KV weights resolve as the reference's
    (columns over "model") and are placed whole over "model", one KV
    head a rank (tp 16 on 4 KV heads); train_4k places them likewise
    under ``make_rules``."""
    with pytest.raises(SystemExit) as e:
        DR.main(["--arch", "yi_6b", "--shape", "decode_32k", "--out",
                 str(tmp_path)])
    assert e.value.code == 0
    rec = json.loads((tmp_path / "yi_6b__decode_32k__single.json")
                     .read_text())
    for k in ("memory", "cost", "collectives", "raw_scanbody_cost",
              "roofline", "params", "active_params"):
        assert k in rec, k
    assert rec["rules"] == "make_serving_rules"
    assert rec["roofline"]["bound_step_time_s"] > 0
    assert rec["memory"]["peak_hbm_bytes"] > 0
    kv = rec["kv_weights"]
    assert (kv["placed"], kv["kv_group"], kv["kv_heads_a_rank"]) == (
        [None, None], 4, 1)
    mesh = make_production_mesh()
    with DR._fake_mode():
        train = DR._kv_weights(get_config("yi_6b"), mesh, TS.make_rules(),
                               True, "train")
    assert train["resolve_spec"] == ["data", "model"]
    assert train["placed"] == ["data", None]

