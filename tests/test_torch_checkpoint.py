"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
reference's (``repro.checkpoint``) on reduced configs, on the CPU: the
reference's own three cases ported (roundtrip, digest, async + gc), the
on-disk format shared with the reference (file names, bytes and sha256
digests of the same state, f32 and bf16; a reference checkpoint restored
in the port), what ``restore`` hands back (P frozen, steps as ints), the
host copy taken before ``save`` returns, and a resumed CLI run equal to
the uninterrupted one bit for bit.  Two reference faults are shown with
what the port does instead (ROADMAP Queue 3).  Everything here is exact:
the checkpoint copies bits, and a resumed CPU run repeats the same
operations on the same bits.
"""
import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as JC
from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.launch import train as JLT
from repro.optim import adamw as JA
from repro.training import steps as JST
from repro_torch import convert
from repro_torch.checkpoint import checkpoint as C
from repro_torch.configs.base import get_config, reduced
from repro_torch.launch import train as LT
from repro_torch.optim import adamw as TA
from repro_torch.training import steps as TST
from repro_torch.tree import named_leaves

torch.set_num_threads(1)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((8, 4), generator=g),
            "b": {"c": torch.randn((3,), generator=g),
                  "d": [torch.zeros((2, 2)),
                        torch.ones((1,), dtype=torch.int32)]},
            "step": 7}


def _equal(got, want):
    got, want = dict(named_leaves(got)), dict(named_leaves(want))
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g, w.detach()), path
            assert g.requires_grad == w.requires_grad, path
        else:
            assert type(g) is type(w) and g == w, path


def test_roundtrip(tmp_path):
    t = _tree()
    C.save(str(tmp_path / "ck"), t, step=7)
    t2, step = C.restore(str(tmp_path / "ck"), t, device="cpu")
    assert step == 7
    _equal(t2, t)


def test_digest_detects_corruption(tmp_path):
    t = _tree()
    path = str(tmp_path / "ck")
    C.save(path, t, step=1)
    fn = [f for f in os.listdir(path) if f.startswith("a")][0]
    arr = np.load(os.path.join(path, fn))
    arr[0] += 1
    np.save(os.path.join(path, fn), arr)
    with pytest.raises(IOError):
        C.restore(path, t, device="cpu")


def test_async_and_gc(tmp_path):
    ck = C.AsyncCheckpointer(str(tmp_path), keep=2)
    t = _tree()
    for s in (10, 20, 30):
        ck.save(t, s)
    ck.wait()
    assert C.latest_step(str(tmp_path)) == 30
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("ckpt_"))
    assert kept == ["ckpt_20", "ckpt_30"]
    t2, s = ck.restore_latest(t, device="cpu")
    assert s == 30
    _equal(t2, t)


def _ref_state(dtype="float32", master=""):
    """The reference's reduced yi_6b training state: f32, or bf16 params
    with bf16 moments."""
    jc = dataclasses.replace(jreduced(jget_config("yi_6b")),
                             param_dtype=dtype)
    opt = JA.OptConfig(moment_dtype=dtype, master_dtype=master)
    state, _ = JST.init_train_state(jax.random.PRNGKey(0), jc, opt)
    return state


def _files(path):
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path)) if f != "meta.json"}


@pytest.mark.parametrize("dtype,master", [("float32", ""),
                                          ("bfloat16", ""),
                                          ("bfloat16", "float32")],
                         ids=["f32", "bf16", "bf16_f32_master"])
def test_checkpoint_matches_reference_files_and_digests(tmp_path, dtype,
                                                        master):
    """The reference's checkpoint of a state and the port's of the same
    state carried across: the same file names, the same bytes in each,
    the same digests and step."""
    jstate = _ref_state(dtype, master)
    JC.save(str(tmp_path / "ref"), jstate, step=5)
    tstate = convert.state_from_reference(jax.tree.map(np.asarray, jstate),
                                          device="cpu")
    C.save(str(tmp_path / "port"), tstate, step=5)
    ref, port = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert ref.keys() == port.keys()
    assert "params.groups.b0.attn.wq.npy" in port and "opt.step.npy" in port
    for f in ref:
        assert port[f] == ref[f], f
    metas = [json.load(open(tmp_path / d / "meta.json"))
             for d in ("ref", "port")]
    assert metas[0] == metas[1]
    if dtype == "bfloat16":
        assert tstate["params"]["embed"].dtype == torch.bfloat16
        back, _ = C.restore(str(tmp_path / "ref"), tstate, device="cpu")
        _equal(back, tstate)


def test_reference_checkpoint_restores_in_port(tmp_path):
    """A checkpoint the reference writes (f32) restores in the port bit
    for bit, P frozen, the other params requiring grad, steps as ints."""
    jstate = _ref_state()
    JC.save(str(tmp_path / "ck"), jstate, step=3)
    want = convert.state_from_reference(jax.tree.map(np.asarray, jstate),
                                        device="cpu")
    like, _ = TST.init_train_state(1, reduced(get_config("yi_6b")),
                                TA.OptConfig(), device="cpu")
    got, step = C.restore(str(tmp_path / "ck"), like, device="cpu")
    assert step == 3
    _equal(got, want)
    for path, p in named_leaves(got["params"]):
        assert p.requires_grad == (not path.endswith("/dsa/p")), path
        assert p.requires_grad == dict(named_leaves(like["params"]))[
            path].requires_grad
    assert got["step"] == 0 and got["opt"]["step"] == 0
    assert type(got["step"]) is int and type(got["opt"]["step"]) is int
    again = dict(named_leaves(convert.state_to_reference(got)))
    ref = dict(named_leaves(jax.tree.map(np.asarray, jstate)))
    assert again.keys() == ref.keys()
    for path, a in again.items():
        assert a.dtype == ref[path].dtype, path
        assert np.array_equal(a, ref[path]), path


def test_restore_refuses_another_layout(tmp_path):
    """A checkpoint whose leaves do not have ``like``'s dtypes raises."""
    cfg = reduced(get_config("yi_6b"))
    state, _ = TST.init_train_state(0, cfg, TA.OptConfig(), device="cpu")
    C.save(str(tmp_path / "ck"), state, step=1)
    other, _ = TST.init_train_state(
        0, dataclasses.replace(cfg, param_dtype="bfloat16"), TA.OptConfig(),
        device="cpu")
    with pytest.raises(ValueError, match="params/embed"):
        C.restore(str(tmp_path / "ck"), other, device="cpu")


def test_host_copy_is_taken_before_save_returns(tmp_path):
    """The train step updates params and moments in place right after the
    save is started: the files hold the values at the save."""
    cfg = reduced(get_config("yi_6b"))
    state, _ = TST.init_train_state(0, cfg, TA.OptConfig(), device="cpu")
    want = convert.state_to_reference(state)
    ck = C.AsyncCheckpointer(str(tmp_path))
    ck.save(state, 1)
    with torch.no_grad():
        for _, t in named_leaves({"p": state["params"], "o": state["opt"]}):
            if isinstance(t, torch.Tensor):
                t.add_(1.0)
    ck.wait()
    got, _ = C.restore(str(tmp_path / "ckpt_1"), state, device="cpu")
    for (path, a), (_, b) in zip(named_leaves(convert.state_to_reference(
            got)), named_leaves(want)):
        assert np.array_equal(a, b), path


CLI = ["--arch", "yi_6b", "--reduced", "--seq", "64", "--batch", "4",
       "--steps", "6", "--save-interval", "3", "--device", "cpu"]


def test_resumed_cli_run_equals_uninterrupted(tmp_path, capsys):
    """Run 6 steps saving every 3, then resume from a copy of the
    directory that holds only ckpt_3: the last 3 steps' metrics and the
    final params, moments and steps equal the uninterrupted run's bit for
    bit."""
    full = LT.main(CLI + ["--ckpt-dir", str(tmp_path / "d")])
    assert sorted(os.listdir(tmp_path / "d")) == ["ckpt_3", "ckpt_6"]
    os.makedirs(tmp_path / "copy")
    shutil.copytree(tmp_path / "d" / "ckpt_3", tmp_path / "copy" / "ckpt_3")
    capsys.readouterr()
    res = LT.main(CLI + ["--ckpt-dir", str(tmp_path / "copy"), "--resume"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "[resume] from step 3"
    assert out[-1].startswith("[done] 3 steps in ")
    assert res.metrics == full.metrics[3:]
    assert res.state["step"] == full.state["step"] == 6
    _equal(res.state, full.state)
    saved, step = C.restore(str(tmp_path / "copy" / "ckpt_6"), res.state,
                            device="cpu")
    assert step == 6
    _equal(saved, full.state)


def test_reference_fault_bf16_checkpoint_unrestorable(tmp_path):
    """A reference fault: its ``save`` writes a bf16 leaf with the
    ml_dtypes descr ``'<V2'``, its ``restore`` hands back a ``|V2`` void
    array, and with shardings (its resume path) ``device_put`` refuses
    it, so no full-width (bf16) run of the reference resumes.  The port
    restores that checkpoint as bf16, bit for bit."""
    jstate = _ref_state("bfloat16")
    path = str(tmp_path / "ck")
    JC.save(path, jstate, step=2)
    with open(os.path.join(path, "params.embed.npy"), "rb") as f:
        assert b"'descr': '<V2'" in f.read(128)
    tree, _ = JC.restore(path, jstate)
    assert tree["params"]["embed"].dtype == np.dtype("V2")
    dev = jax.devices("cpu")[0]
    shardings = jax.tree.map(lambda _: jax.sharding.SingleDeviceSharding(dev),
                             jstate)
    with pytest.raises(TypeError, match="V2"):
        JC.restore(path, jstate, shardings)
    want = convert.state_from_reference(jax.tree.map(np.asarray, jstate),
                                        device="cpu")
    got, step = C.restore(path, want, device="cpu")
    assert step == 2 and got["params"]["embed"].dtype == torch.bfloat16
    _equal(got, want)


def _recording(make_batches, drawn):
    def make(*a, **k):
        for batch in make_batches(*a, **k):
            drawn.append(np.array(batch["tokens"]))
            yield batch
    return make


def test_reference_fault_resume_replays_data(tmp_path, monkeypatch):
    """A reference fault: its resumed run starts the data afresh
    (``repro/launch/train.py:100`` draws ``next(data)`` from batch 0 at
    step ``step0``), so step 1 of a run resumed from ckpt_1 trains on
    batch 0 again.  The port's resumed run draws batch 1 there."""
    argv = ["--arch", "yi_6b", "--reduced", "--seq", "32", "--batch", "2",
            "--steps", "2", "--save-interval", "1", "--log-interval", "1"]
    runs = {}
    for name, mod, extra in (("ref", JLT, []), ("port", LT,
                                                ["--device", "cpu"])):
        d, make = tmp_path / name, mod.make_batches
        drawn, resumed = [], []
        monkeypatch.setattr(mod, "make_batches", _recording(make, drawn))
        mod.main(argv + extra + ["--ckpt-dir", str(d)])
        shutil.rmtree(d / "ckpt_2")
        monkeypatch.setattr(mod, "make_batches", _recording(make, resumed))
        mod.main(argv + extra + ["--ckpt-dir", str(d), "--resume"])
        runs[name] = drawn, resumed
    drawn, resumed = runs["ref"]
    assert len(drawn) == 2 and not np.array_equal(drawn[0], drawn[1])
    assert len(resumed) == 1 and np.array_equal(resumed[0], drawn[0])
    drawn, resumed = runs["port"]
    assert len(resumed) == 2 and np.array_equal(resumed[1], drawn[1])
