"""jamba_1_5_large (a Mamba hybrid: groups of 8 sub-blocks, attention at
the fifth and Mamba elsewhere, MoE on every other one) in the port
against the JAX reference, on the reduced config (one whole group of 8;
d 64, mi 128, state 8; 4 experts, top 2; f32), the CPU, with the
reference's weights (``convert.py``) and the same numpy inputs.

- The config field by field, full and reduced, the analytic parameter
  count; the port's own init has the reference's tree; depth cuts keep
  whole groups or one group's first sub-blocks.
- Prefill logits and every cache leaf (the Mamba layers' ``h`` and
  ``conv``, the attention layer's K/V, predicted keys and ``pos``), then
  four decode steps, in every DSA mode, and the block selection of a
  decode step (equal sets); the training forward's logits (1e-4 of the
  largest magnitude) and its ``mse`` (the attention sub-block's) and
  ``router`` (four MoE sub-blocks') terms (rtol 1e-5).
- The static engine's greedy tokens EQUAL to the reference's in every
  mode, scan and python loops; the continuous engine (blocking admission,
  a group per prompt length) EQUAL to the reference's continuous engine
  and to each request's solo ``generate``.
- No prompt buckets, paging, quantization, chunk steps or speculation:
  the reference's envelopes.
- The sparsity probe's gate is the reference's; on jamba it samples the
  attention layer alone and puts every leaf it wrote back (the Mamba
  state too), so a probed run gives the unprobed tokens.
- A masked decode step asks the host nothing (the form a CUDA graph
  captures) and, with no active row, changes no leaf.
- A training state checkpoints in the reference's files byte for byte;
  the serve and train CLIs.  The train step and the four-step curve are
  in tests/test_torch_train.py.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as JC
from repro.configs import base as JB
from repro.inference import engine as JE
from repro.inference import scheduler as JS
from repro.models import transformer as JT
from repro.models.attention import RunFlags as JFlags
from repro.optim import adamw as JA
from repro.training import steps as JST
from repro_torch import convert
from repro_torch.checkpoint import checkpoint as C
from repro_torch.configs import base as TB
from repro_torch.inference import engine as TE
from repro_torch.inference import scheduler as TS
from repro_torch.inference import speculative as TSP
from repro_torch.inference.telemetry import Telemetry, probe_ok
from repro_torch.launch import serve
from repro_torch.launch import train as LT
from repro_torch.models import blocks as TBL
from repro_torch.models import transformer as TT
from repro_torch.models.attention import RunFlags
from repro_torch.optim import adamw as TA
from repro_torch.training import steps as TST
from repro_torch.tree import named_leaves

torch.set_num_threads(1)

ARCH = "jamba_1_5_large"
REL = 1e-4
METRIC_RTOL = 1e-5
MODES = ("off", "block", "faithful", "kernel")
KINDS = ["mamba"] * 4 + ["attn"] + ["mamba"] * 3


def _close(got, want, rel=REL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.max(np.abs(want))), 1e-6)
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * scale, (what, err, scale)


def _cfgs(**kw):
    return (dataclasses.replace(JB.reduced(JB.get_config(ARCH)), **kw),
            dataclasses.replace(TB.reduced(TB.get_config(ARCH)), **kw))


@functools.lru_cache(maxsize=None)
def _params():
    jc, tc = _cfgs()
    jparams, _ = JT.init_model(jax.random.PRNGKey(0), jc)
    tparams = convert.from_reference(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jc, jparams, tc, tparams


def _toks(seed, b, n):
    return np.random.default_rng(seed).integers(1, 508, size=(b, n)).astype(
        np.int32)


def _fields_equal(tc, jc, what):
    for f in dataclasses.fields(tc):
        got, want = getattr(tc, f.name), getattr(jc, f.name)
        if dataclasses.is_dataclass(got):
            _fields_equal(got, want, f"{what}.{f.name}")
        else:
            assert got == want, (what, f.name, got, want)


def test_config_and_tree_are_the_reference_ones():
    """Every field (MambaConfig, MoEConfig and DSAConfig field by field)
    equals the reference's, full and reduced; the parameter count of the
    full model is the reference's; the port's own init has the
    reference's tree (leaf paths, shapes, dtypes) and group structure."""
    for tc, jc in ((TB.get_config(ARCH), JB.get_config(ARCH)),
                   (TB.reduced(TB.get_config(ARCH)),
                    JB.reduced(JB.get_config(ARCH)))):
        _fields_equal(tc, jc, tc.name)
    full = TB.get_config(ARCH)
    assert full.num_params() == JB.get_config(ARCH).num_params()
    assert full.num_active_params() == JB.get_config(ARCH).num_active_params()
    jc, jparams, tc, tparams = _params()
    assert tc.n_layers == 8 and TBL.n_groups(tc) == 1
    defs = TBL.group_defs(tc)
    assert [d.kind for d in defs] == KINDS
    assert [d.moe for d in defs] == [i % 2 == 1 for i in range(8)]
    own = TT.init_model(0, tc, device="cpu")
    shapes = {p: (tuple(t.shape), t.dtype) for p, t in named_leaves(own)}
    assert shapes == {p: (tuple(t.shape), t.dtype)
                      for p, t in named_leaves(tparams)}
    assert convert.to_reference(tparams).keys() == jparams.keys()


def test_depth_cuts_keep_groups():
    """``cut_layers``: 16 layers are two whole groups; 5 one group of the
    period's first five sub-blocks ([m, m+MoE, m, m+MoE, a]: every kind,
    the card slices' cut) with the reference's count for those layers;
    12 is neither and is refused."""
    full = TB.get_config(ARCH)
    cfg = TB.cut_layers(full, 16)
    assert TBL.n_groups(cfg) == 2 and len(TBL.group_defs(cfg)) == 8
    cfg = TB.cut_layers(full, 5)
    defs = TBL.group_defs(cfg)
    assert TBL.n_groups(cfg) == 1
    assert [(d.kind, d.moe) for d in defs] == [
        ("mamba", False), ("mamba", True), ("mamba", False),
        ("mamba", True), ("attn", False)]
    assert cfg.num_params() == dataclasses.replace(
        JB.get_config(ARCH), n_layers=5).num_params()
    with pytest.raises(ValueError, match="whole groups"):
        TB.cut_layers(full, 12)
    _, tc = _cfgs()
    p = TT.init_model(0, TB.cut_layers(tc, 5), device="cpu")
    assert list(p["groups"][0]) == [f"b{i}" for i in range(5)]
    assert "router" in p["groups"][0]["b3"]["mlp"]
    assert "wq" in p["groups"][0]["b4"]["attn"]


def _compare_caches(tcache, jcache):
    """Every leaf of every sub-block's cache; ``pos`` exact."""
    tgroup = tcache["groups"][0]
    jgroup = jcache["groups"][0]
    for i, kind in enumerate(KINDS):
        tl, jl = tgroup[f"b{i}"]["attn"], jgroup[f"b{i}"]["attn"]
        assert set(tl) == set(jl), (i, set(tl), set(jl))
        if kind == "mamba":
            assert set(tl) == {"h", "conv"}
        for name in tl:
            if name == "pos":
                np.testing.assert_array_equal(tl[name].numpy(),
                                              np.asarray(jl[name]))
            else:
                _close(tl[name].numpy(), jl[name], what=(i, name))


@pytest.mark.parametrize("mode,plen", [(m, 48) for m in MODES]
                         + [("kernel", 256)])
def test_prefill_and_decode_match_reference(mode, plen):
    """A prefill of two equal-length prompts (256 takes the Mamba scan's
    two-chunk path), then four decode steps: logits and every cache leaf;
    on block and kernel the decode step's block selection equals the
    reference's as sets."""
    jc, jparams, tc, tparams = _params()
    b, max_len = 2, plen + 16
    toks = _toks(1, b, plen)
    jpf = JFlags(mode="prefill", dsa_mode=mode, with_mse=False,
                 long_context=True)
    jdf = dataclasses.replace(jpf, mode="decode")
    tpf = RunFlags(mode="prefill", dsa_mode=mode, long_context=True)
    tdf = dataclasses.replace(tpf, mode="decode")
    jcache = JT.init_cache(jc, b, max_len, jdf, dtype=jnp.float32)
    jlog, _, jcache = JT.forward(jparams, jc, jpf,
                                 {"tokens": jnp.asarray(toks)}, caches=jcache)
    jcache = JT.unstack_group_caches(
        JT.truncate_cache(jc, jcache, jnp.full((b,), plen, jnp.int32)))
    tcache = TT.init_cache(tc, b, max_len, tdf, dtype=torch.float32,
                           device="cpu")
    tlog, _ = TT.forward(tparams, tc, tpf, torch.from_numpy(toks), tcache)
    TT.truncate_cache(tc, tcache, plen)
    _close(tlog.numpy(), jlog, what="prefill logits")
    _compare_caches(tcache, jcache)
    tok = np.asarray(jlog)[:, -1].argmax(-1)[:, None].astype(np.int32)
    for step in range(4):
        if mode in ("block", "kernel") and step == 0:
            _check_selection(jparams, jc, jdf, tparams, tc, tdf, tok,
                             jcache, tcache)
        jlog, jcache = JT.decode_step(jparams, jc, jdf, jnp.asarray(tok),
                                      jcache)
        tlog, _ = TT.decode_step(tparams, tc, tdf, torch.from_numpy(tok),
                                 tcache)
        _close(tlog.numpy(), jlog, what=("decode logits", step))
        tok = np.asarray(jlog)[:, -1].argmax(-1)[:, None].astype(np.int32)
    _compare_caches(tcache, jcache)


def _check_selection(jparams, jc, jdf, tparams, tc, tdf, tok, jcache,
                     tcache):
    """The attention layer's decode selection as sets, port against the
    reference, read without changing either cache (the port's probe
    step's save and restore)."""
    jsel = {}
    _, new = JT.decode_step(jparams, jc, dataclasses.replace(
        jdf, sel_probe=True), jnp.asarray(tok), jcache)
    for path, leaf in jax.tree_util.tree_flatten_with_path(new)[0]:
        name = str(getattr(path[-1], "key", path[-1]))
        if name in ("sel_idx", "sel_ok"):
            jsel[name] = np.asarray(leaf)
    saved = [{k: v.clone() for k, v in lc.items()}
             for lc in TT.attn_caches(tcache)]
    _, _, sel = TT.decode_step(tparams, tc, dataclasses.replace(
        tdf, sel_probe=True), torch.from_numpy(tok), tcache)
    for lc, sv in zip(TT.attn_caches(tcache), saved):
        for k, v in sv.items():
            lc[k].copy_(v)
    assert len(sel) == 1
    idx, ok, _ = (t.numpy() for t in sel[0])
    for b in range(tok.shape[0]):
        got = set(idx[b][ok[b].astype(bool)].tolist())
        want = set(jsel["sel_idx"][b][jsel["sel_ok"][b].astype(bool)]
                   .tolist())
        assert got == want, (b, got, want)


@pytest.mark.parametrize("mode", ["off", "block", "faithful"])
def test_train_forward_matches_reference(mode):
    """Logits and the ``mse`` (the attention sub-block alone) and
    ``router`` (the four MoE sub-blocks) terms of the training
    forward."""
    jc, jparams, tc, tparams = _params()
    toks = _toks(0, 3, 64)
    jl, ja, _ = JT.forward(jparams, jc, JFlags(mode="train", dsa_mode=mode),
                           {"tokens": toks})
    tl, ta = TT.forward_train(tparams, tc, RunFlags(mode="train",
                                                    dsa_mode=mode),
                              torch.as_tensor(toks))
    _close(tl.detach().numpy(), jl, what="logits")
    for k in ("router", "mse"):
        np.testing.assert_allclose(float(ta[k]), float(ja[k]),
                                   rtol=METRIC_RTOL, err_msg=k)
    assert float(ta["router"]) > 0
    assert (mode == "off") == (float(ta["mse"]) == 0)


@functools.lru_cache(maxsize=None)
def _reference_tokens(mode):
    jc, jparams, _, _ = _params()
    res = JE.Engine(jc, jparams, max_len=80, long_context=mode != "off",
                    dsa_mode=mode).generate(_toks(4, 2, 48), 8)
    return np.asarray(res.tokens)


@pytest.mark.parametrize("mode,loop", [(m, "scan") for m in MODES]
                         + [("kernel", "python")])
def test_greedy_tokens_equal_reference(mode, loop):
    """The static engine on two prompts of 48 tokens (no bucket): the
    reference's greedy tokens."""
    _, _, tc, tparams = _params()
    eng = TE.Engine(tc, tparams, max_len=80, long_context=mode != "off",
                    dsa_mode=mode, loop=loop, device="cpu")
    assert not eng.bucket_prompts
    res = eng.generate(_toks(4, 2, 48), 8)
    np.testing.assert_array_equal(res.tokens, _reference_tokens(mode))


SHAPES = [(40, 6), (48, 5), (40, 7), (33, 4), (48, 9)]
CONT = dict(slots=2, max_len=80, seg_len=4)


def _requests(mod, vocab, shapes=SHAPES):
    rng = np.random.default_rng(0)
    return [mod.Request(rid, rng.integers(1, vocab - 4, size=(n,)).astype(
        np.int32), n_new) for rid, (n, n_new) in enumerate(shapes)]


@pytest.mark.parametrize("mode", ["off", "block", "kernel"])
def test_continuous_equals_reference_and_solo(mode):
    """Blocking admission (a group per prompt length: 40 and 48 come in
    pairs), slot reuse after retirements: the reference's continuous
    tokens and each request's solo ``generate``."""
    jc, jparams, tc, tparams = _params()
    kw = dict(long_context=mode != "off", dsa_mode=mode)
    eng = TS.ContinuousEngine(tc, tparams, device="cpu", **CONT, **kw)
    assert not eng.chunked and not eng.paged and eng.spec == 0
    reqs = _requests(TS, tc.vocab)
    got = eng.run(reqs)
    assert eng.stats["chunks"] == 0 and eng.stats["admitted"] == len(reqs)
    want = JS.ContinuousEngine(jc, jparams, **CONT, **kw).run(
        _requests(JS, jc.vocab))
    solo = TE.Engine(tc, tparams, max_len=80, device="cpu", **kw)
    for r in reqs:
        np.testing.assert_array_equal(got[r.rid], np.asarray(want[r.rid]),
                                      err_msg=f"rid {r.rid}")
        np.testing.assert_array_equal(
            got[r.rid], solo.generate(r.prompt[None], r.n_new).tokens[0],
            err_msg=f"rid {r.rid} solo")


def test_envelopes_refuse_what_the_reference_refuses():
    """No paged cache, no quantized cache, no chunked admission (even
    when asked), no chunk step, verify or speculation, no ragged batch;
    ``truncate_cache`` leaves the Mamba state alone."""
    _, _, tc, tparams = _params()
    assert not TE.can_bucket_prompts(tc) and not TE.can_page(tc)
    assert not TE.can_quantize(tc) and not TSP.can_speculate(tc, "off", 4)
    with pytest.raises(ValueError, match="ssm"):
        TS.ContinuousEngine(tc, tparams, device="cpu", paged=True, **CONT)
    with pytest.raises(ValueError, match="can_quantize"):
        TE.Engine(tc, tparams, max_len=80, kv_quant="int8", device="cpu")
    ce = TS.ContinuousEngine(tc, tparams, device="cpu", chunked_prefill=True,
                             spec=3, **CONT)
    assert not ce.chunked and ce.spec == 0
    eng = TE.Engine(tc, tparams, max_len=80, device="cpu")
    prompts = _toks(2, 2, 40)
    with pytest.raises(ValueError, match="can_speculate"):
        eng.generate(prompts, 4, spec=3)
    with pytest.raises(ValueError, match="ragged"):
        eng.generate(prompts, 2, lengths=np.array([40, 30]))
    _, caches, _ = eng.prefill(prompts)
    before = [{k: t.clone() for k, t in lc.items()}
              for lc in TT.attn_caches(caches)]
    with torch.inference_mode():
        TT.truncate_cache(tc, caches, 30)
    for b, lc in zip(before, TT.attn_caches(caches)):
        if "h" in lc:
            for k, t in lc.items():
                assert torch.equal(t, b[k])
    flags = RunFlags(mode="decode")
    for fn in (lambda: TT.chunk_step(tparams, tc, flags,
                                     torch.from_numpy(prompts[:, :16]),
                                     caches, torch.tensor([16, 16])),
               lambda: TT.verify_step(tparams, tc, dataclasses.replace(
                   flags, spec_verify=True),
                   torch.from_numpy(prompts[:, :4]), caches)):
        with pytest.raises(NotImplementedError, match="recurrent"):
            fn()


def test_probe_gate_and_restore():
    """``probe_ok`` is the reference's gate (DSA on the block or kernel
    path of a long-context cache); a continuous engine probing every
    segment samples the attention layer alone, puts back every leaf the
    probe step wrote (Mamba's ``h`` and ``conv`` too), and serves the
    unprobed run's tokens."""
    _, _, tc, tparams = _params()
    for mode in MODES:
        for lc in (False, True):
            flags = RunFlags(mode="decode", dsa_mode=mode, long_context=lc)
            assert probe_ok(tc, flags) == (
                lc and mode in ("block", "kernel") and tc.mla is None)
    kw = dict(long_context=True, dsa_mode="block", **CONT)
    shapes = [(40, 14), (48, 12), (40, 10)]
    plain = TS.ContinuousEngine(tc, tparams, device="cpu", **kw).run(
        _requests(TS, tc.vocab, shapes))
    tel = Telemetry(sample_every=1)
    eng = TS.ContinuousEngine(tc, tparams, device="cpu", telemetry=tel,
                              **kw)
    samples = []
    real = eng._probe_step

    def probe(tok, mask, caches, flags):
        before = [{k: t.clone() for k, t in lc.items()}
                  for lc in TT.attn_caches(caches)]
        sel = real(tok, mask, caches, flags)
        for b, lc in zip(before, TT.attn_caches(caches)):
            for k, t in lc.items():
                assert torch.equal(t, b[k]), k
        samples.append(len(sel))
        return sel

    eng._probe_step = probe
    got = eng.run(_requests(TS, tc.vocab, shapes))
    assert samples and set(samples) == {1}
    assert eng.stats["probe_steps"] == len(samples)
    for rid, t in plain.items():
        np.testing.assert_array_equal(got[rid], t, err_msg=f"rid {rid}")


def test_masked_step_asks_the_host_nothing_and_no_row_changes_nothing(
        monkeypatch):
    """The continuous engine's decode step on jamba (the form a CUDA
    graph captures) runs with nonzero, item, tolist and a tensor's truth
    value made to raise; with an all-false mask it leaves every leaf (K/V
    rows, ``pos``, the Mamba state) as it was."""
    _, _, tc, tparams = _params()
    eng = TE.Engine(tc, tparams, max_len=80, long_context=True,
                    dsa_mode="kernel", device="cpu")
    with torch.inference_mode():
        caches = eng.resident_cache(2)
        logits, _, _ = eng.prefill(_toks(4, 2, 40), caches=caches)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        before = [{k: t.clone() for k, t in lc.items()}
                  for lc in TT.attn_caches(caches)]

        def refuse(*a, **k):
            raise AssertionError("host sync in a graphed step")

        for name in ("nonzero", "item", "tolist", "__bool__"):
            monkeypatch.setattr(torch.Tensor, name, refuse)
        TT.decode_step(tparams, tc, eng.decode_flags, tok, caches,
                       active=torch.zeros(2, dtype=torch.bool))
        monkeypatch.undo()
        for b, lc in zip(before, TT.attn_caches(caches)):
            for k, t in lc.items():
                assert torch.equal(t, b[k]), k


def test_state_checkpoints_in_reference_format(tmp_path):
    """A bf16 training state (f32 routers, bf16 moments), the Mamba leaves
    of every sub-block included: the port's checkpoint has the
    reference's files and bytes; the reference's restores in the port bit
    for bit."""
    jc, tc = _cfgs(param_dtype="bfloat16", dtype="bfloat16")
    opt = JA.OptConfig(moment_dtype="bfloat16")
    jstate, _ = JST.init_train_state(jax.random.PRNGKey(0), jc, opt)
    JC.save(str(tmp_path / "ref"), jstate, step=3)
    tstate = convert.state_from_reference(jax.tree.map(np.asarray, jstate),
                                          device="cpu")
    C.save(str(tmp_path / "port"), tstate, step=3)
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert "params.groups.b7.attn.a_log.npy" in names
    assert "opt.m.groups.b5.mlp.router.npy" in names
    for name in names:
        if name != "meta.json":
            assert (tmp_path / "ref" / name).read_bytes() == \
                (tmp_path / "port" / name).read_bytes(), name
    like, _ = TST.init_train_state(1, tc, TA.OptConfig(moment_dtype="bfloat16"),
                                device="cpu")
    back, step = C.restore(str(tmp_path / "ref"), like, device="cpu")
    assert step == 3
    want = dict(named_leaves(tstate))
    assert want.keys() == dict(named_leaves(back)).keys()
    for path, a in named_leaves(back):
        b = want[path]
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b.detach()), path


def test_serve_and_train_cli(capsys):
    """``serve --arch jamba_1_5_large --reduced`` static (kernel, bf16
    cache) and continuous (block); ``--layers 5`` cuts the group to its
    first five sub-blocks in both CLIs, and 12 is refused."""
    res = serve.main(["--arch", ARCH, "--reduced", "--batch", "2",
                      "--prompt-len", "48", "--new-tokens", "6", "--dsa",
                      "--dsa-mode", "kernel", "--cache-dtype", "bfloat16",
                      "--device", "cpu"])
    assert res.tokens.shape == (2, 6)
    res, eng = serve.main(["--arch", ARCH, "--reduced", "--continuous",
                           "--requests", "3", "--slots", "2", "--dsa",
                           "--dsa-mode", "block", "--prompt-len", "40",
                           "--new-tokens", "4", "--layers", "5",
                           "--device", "cpu"])
    assert all(r.status == "ok" for r in res) and len(res) == 3
    assert list(eng.engine.params["groups"][0]) == [f"b{i}"
                                                    for i in range(5)]
    assert not eng.chunked
    assert "continuous: 3 requests" in capsys.readouterr().out
    with pytest.raises(ValueError, match="whole groups"):
        serve.main(["--arch", ARCH, "--layers", "12", "--device", "cpu"])
    out = LT.main(["--arch", ARCH, "--reduced", "--layers", "5", "--steps",
                   "2", "--seq", "32", "--batch", "2", "--log-interval", "1",
                   "--device", "cpu"])
    assert len(out.state["params"]["groups"][0]) == 5
    assert all(m["router_aux"] > 0 and m["mse"] > 0 for m in out.metrics)
    assert "[done] 2 steps" in capsys.readouterr().out
