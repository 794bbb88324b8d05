"""deepseek_v3 (multi-head latent attention, a dense prologue, 256 routed
experts with a shared one) in the port against the JAX reference, on
reduced configs (3 layers: 1 dense prologue layer and 2 MoE layers of 4
experts, top 2, 1 shared; ranks 32/32, nope 16, rope 8, v 16; f32), the
CPU, with the reference's weights (``convert.py``) and the same numpy
inputs.

- The config field by field, full and reduced; the port's own init has
  the reference's tree; the serving predicates (``can_page``,
  ``can_quantize``, ``can_chunk_prefill``, ``can_speculate``) equal the
  reference's for every ported arch; a depth below the prologue's is
  refused.
- Prefill logits and every cache leaf of the prologue and the groups
  after a ragged truncate, then four decode steps, in every DSA mode;
  the training forward's logits (1e-4 of the largest magnitude) and its
  ``mse`` and ``router`` terms (rtol 1e-5).
- The static engine's greedy tokens EQUAL to the reference's in every
  mode, scan and python loops, ``moe_prefill="dense"`` too; sampled
  tokens (the port's own generator) equal across the loops and under
  speculation at B 1.
- The continuous engine: blocking admission under block, chunked under
  off with ``moe_prefill="dense"``, and a per-request DSA override that
  falls back to blocking: the reference's continuous tokens and each
  request's solo ``generate``.  A paged or quantized engine is refused.
- Speculation gives the plain tokens (greedy, and sampled at B 1) and
  is refused under DSA.
- A training state checkpoints in the reference's files byte for byte;
  the CLIs keep the prologue under ``--layers``; the MLA decode, verify
  and commit ask the host nothing (the form a CUDA graph captures).
  The train step and the four-step curve are in tests/test_torch_train.py.
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
from repro.inference import speculative as JSP
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
from repro_torch.launch import serve
from repro_torch.launch import train as LT
from repro_torch.models import blocks as TBL
from repro_torch.models import transformer as TT
from repro_torch.models.attention import RunFlags
from repro_torch.optim import adamw as TA
from repro_torch.training import steps as TST
from repro_torch.tree import named_leaves

torch.set_num_threads(1)

ARCH = "deepseek_v3"
REL = 1e-4
METRIC_RTOL = 1e-5
MODES = ("off", "block", "faithful", "kernel")


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
def _params(mla_only=False, layers=3):
    """The reduced model's weights in both packages (``layers`` deep);
    ``mla_only``: no MoE (so no prologue), 2 MLA layers, as the
    reference's override test."""
    jc, tc = _cfgs(**(dict(moe=None, n_layers=2) if mla_only
                      else dict(n_layers=layers)))
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
    """Every field of the port's deepseek_v3 (its MLA, MoE and DSA configs
    field by field) is the reference's, reduced too; the reduced model's
    own seeded init has the reference's leaves and shapes, the prologue an
    unstacked list of dense layers."""
    for tc, jc in ((TB.get_config(ARCH), JB.get_config(ARCH)),
                   (TB.reduced(TB.get_config(ARCH)),
                    JB.reduced(JB.get_config(ARCH)))):
        _fields_equal(tc, jc, tc.name)
    r = TB.reduced(TB.get_config(ARCH))
    assert (r.n_layers, r.moe.first_k_dense, r.moe.num_experts, r.moe.top_k,
            r.moe.num_shared_experts) == (3, 1, 4, 2, 1)
    assert (r.mla.q_lora_rank, r.mla.kv_lora_rank, r.mla.qk_nope_head_dim,
            r.mla.qk_rope_head_dim, r.mla.v_head_dim) == (32, 32, 16, 8, 16)
    jc, jparams, tc, _ = _params()
    own = convert.to_reference(TT.init_model(0, tc, device="cpu"))
    want = dict(named_leaves(jax.tree.map(np.asarray, jparams)))
    got = dict(named_leaves(own))
    assert got.keys() == want.keys()
    for path, a in got.items():
        assert a.shape == want[path].shape, path
    assert "/prologue/0/mlp/w1" in got and "/groups/b0/mlp/router" in got


def test_predicates_match_reference_for_every_ported_arch():
    """``can_bucket_prompts``, ``can_page``, ``can_quantize``,
    ``can_chunk_prefill`` (each mode, with and without dense MoE
    prefill) and ``can_speculate`` (each mode, K 1 to 64) equal the
    reference's for every ported arch, full and reduced."""
    for arch in TB.ARCH_IDS:
        for tc, jc in ((TB.get_config(arch), JB.get_config(arch)),
                       (TB.reduced(TB.get_config(arch)),
                        JB.reduced(JB.get_config(arch)))):
            for fn in ("can_bucket_prompts", "can_page", "can_quantize"):
                assert getattr(TE, fn)(tc) == getattr(JE, fn)(jc), (arch, fn)
            for mode in MODES:
                for dense in (False, True):
                    assert TE.can_chunk_prefill(tc, mode, dense) == \
                        JE.can_chunk_prefill(jc, mode, dense), (arch, mode)
                for k in (1, 4, 63, 64):
                    assert TSP.can_speculate(tc, mode, k) == \
                        JSP.can_speculate(jc, mode, k), (arch, mode, k)
    full = TB.get_config(ARCH)
    assert not TE.can_page(full) and not TE.can_quantize(full)
    assert TE.can_chunk_prefill(full, "off", True)
    assert not TE.can_chunk_prefill(full, "block", True)
    assert TSP.can_speculate(full, "off", 4)
    assert not TSP.can_speculate(full, "block", 4)


def test_depth_keeps_the_prologue():
    """``cut_layers`` keeps the dense prologue: 3 layers of deepseek_v3
    are the prologue alone, 5 add two MoE layers; fewer than 3 are
    refused, by ``cut_layers`` and by the model's layout."""
    full = TB.get_config(ARCH)
    for n, groups in ((3, 0), (5, 2)):
        cfg = TB.cut_layers(full, n)
        assert cfg.moe.first_k_dense == 3
        assert cfg.num_params() == dataclasses.replace(
            JB.get_config(ARCH), n_layers=n).num_params()
        assert (TBL.n_prologue(cfg), TBL.n_groups(cfg)) == (3, groups)
    with pytest.raises(ValueError, match="prologue"):
        TB.cut_layers(full, 2)
    _, tc = _cfgs(n_layers=0)
    with pytest.raises(ValueError, match="prologue"):
        TT.init_model(0, tc, device="cpu")
    _, tc = _cfgs(n_layers=1)
    p = TT.init_model(0, tc, device="cpu")
    assert len(p["prologue"]) == 1 and p["groups"] == []


def _compare_caches(tcache, jcache):
    """Every latent leaf of every layer, the prologue's first; pos exact."""
    jlayers = [c["attn"] for c in jcache["prologue"]] + [
        g["b0"]["attn"] for g in jcache["groups"]]
    tlayers = list(TT.attn_caches(tcache))
    assert len(tlayers) == len(jlayers) == 3
    for i, (tl, jl) in enumerate(zip(tlayers, jlayers)):
        assert set(tl) == set(jl) == {"c_kv", "k_rope", "pos"}
        for name in tl:
            if name == "pos":
                np.testing.assert_array_equal(tl[name].numpy(),
                                              np.asarray(jl[name]))
            else:
                _close(tl[name].numpy(), jl[name], what=(i, name))


@pytest.mark.parametrize("mode", MODES)
def test_prefill_and_decode_match_reference(mode):
    """A ragged batch of 48 and 37 tokens (the block path on block and
    kernel), truncated, then four decode steps: logits and caches."""
    jc, jparams, tc, tparams = _params()
    b, plen, max_len = 2, 48, 80
    toks = _toks(1, b, plen)
    lengths = np.array([plen, plen - 11], np.int32)
    jpf = JFlags(mode="prefill", dsa_mode=mode, with_mse=False,
                 long_context=True)
    jdf = dataclasses.replace(jpf, mode="decode")
    tpf = RunFlags(mode="prefill", dsa_mode=mode, long_context=True)
    tdf = dataclasses.replace(tpf, mode="decode")
    jcache = JT.init_cache(jc, b, max_len, jdf, dtype=jnp.float32)
    jlog, _, jcache = JT.forward(jparams, jc, jpf,
                                 {"tokens": jnp.asarray(toks)}, caches=jcache)
    jcache = JT.unstack_group_caches(
        JT.truncate_cache(jc, jcache, jnp.asarray(lengths)))
    tcache = TT.init_cache(tc, b, max_len, tdf, dtype=torch.float32,
                           device="cpu")
    tlog, _ = TT.forward(tparams, tc, tpf, torch.from_numpy(toks), tcache)
    TT.truncate_cache(tc, tcache, torch.from_numpy(lengths))
    _close(tlog.numpy(), jlog, what="prefill logits")
    _compare_caches(tcache, jcache)
    tok = np.asarray(jlog)[np.arange(b), lengths - 1].argmax(-1)[:, None]
    for step in range(4):
        jlog, jcache = JT.decode_step(jparams, jc, jdf,
                                      jnp.asarray(tok, jnp.int32), jcache)
        tlog, _ = TT.decode_step(tparams, tc, tdf, torch.from_numpy(tok),
                                 tcache)
        _close(tlog.numpy(), jlog, what=("decode logits", step))
        tok = np.asarray(jlog)[:, -1].argmax(-1)[:, None].astype(np.int32)
    _compare_caches(tcache, jcache)


@pytest.mark.parametrize("mode,layers", [("off", 3), ("block", 3),
                                         ("faithful", 1)])
def test_train_forward_matches_reference(mode, layers):
    """Logits and the ``mse`` and ``router`` terms of the training
    forward, the prologue's MSE summed in with the groups'.  Faithful on
    the prologue alone: past the first MoE layer the experts' init scale
    (ROADMAP Queue 3) lifts the hidden state's magnitude a
    thousandfold, and at that scale the two frameworks' last-bit
    differences flip the next layer's token top-k, as for mixtral
    (tests/test_torch_mixtral.py)."""
    jc, jparams, tc, tparams = _params(layers=layers)
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
    assert (float(ta["router"]) > 0) == (layers > 1)
    assert (mode == "off") == (float(ta["mse"]) == 0)


@functools.lru_cache(maxsize=None)
def _reference_tokens(mode, moe_prefill="capacity"):
    jc, jparams, _, _ = _params()
    res = JE.Engine(jc, jparams, max_len=80, long_context=mode != "off",
                    dsa_mode=mode, moe_prefill=moe_prefill).generate(
        _toks(4, 2, 48), 8)
    return np.asarray(res.tokens)


@pytest.mark.parametrize("mode,loop,moe_prefill", [
    (m, "scan", "capacity") for m in MODES] + [
    ("kernel", "python", "capacity"), ("off", "scan", "dense")])
def test_greedy_tokens_equal_reference(mode, loop, moe_prefill):
    """The static engine on two prompts of 48 tokens (bucketed to 64):
    the reference's greedy tokens."""
    _, _, tc, tparams = _params()
    eng = TE.Engine(tc, tparams, max_len=80, long_context=mode != "off",
                    dsa_mode=mode, loop=loop, moe_prefill=moe_prefill,
                    device="cpu")
    res = eng.generate(_toks(4, 2, 48), 8)
    np.testing.assert_array_equal(res.tokens,
                                  _reference_tokens(mode, moe_prefill))


@pytest.mark.parametrize("mode", MODES)
def test_sampled_tokens_agree_across_loops_and_speculation(mode):
    """Sampled tokens (the port's generator): the scan loop's equal the
    python loop's at B 2, and at B 1 under DSA off speculation's equal
    the plain chain's."""
    _, _, tc, tparams = _params()
    kw = dict(max_len=80, long_context=mode != "off", dsa_mode=mode,
              device="cpu")
    prompts = _toks(5, 2, 40)
    got = {loop: TE.Engine(tc, tparams, loop=loop, **kw).generate(
        prompts, 7, greedy=False, seed=3, temperature=0.8).tokens
        for loop in ("scan", "python")}
    np.testing.assert_array_equal(got["scan"], got["python"])
    if mode == "off":
        eng = TE.Engine(tc, tparams, **kw)
        plain = eng.generate(prompts[:1], 9, greedy=False, seed=2).tokens
        spec = eng.generate(prompts[:1], 9, greedy=False, seed=2, spec=3)
        assert spec.spec_rounds > 0
        np.testing.assert_array_equal(spec.tokens, plain)


SHAPES = [(40, 6), (48, 5), (23, 7), (33, 4)]
CONT = dict(slots=2, max_len=80, seg_len=4)


def _requests(mod, vocab, shapes=SHAPES, modes=None):
    rng = np.random.default_rng(0)
    return [mod.Request(rid, rng.integers(1, vocab - 4, size=(n,)).astype(
        np.int32), n_new, dsa_mode=None if modes is None else modes[rid])
        for rid, (n, n_new) in enumerate(shapes)]


@pytest.mark.parametrize("kw,chunked", [
    (dict(long_context=True, dsa_mode="block"), False),
    (dict(long_context=True, dsa_mode="off", moe_prefill="dense",
          chunk_tokens=16), True)], ids=["block-blocking", "off-chunked"])
def test_continuous_equals_reference_and_solo(kw, chunked):
    """Under block an MoE-over-MLA arch admits blocking (capacity
    prefill, no predicted-key cache to resume); under off with dense MoE
    prefill it chunk-admits.  Either way: the reference's continuous
    tokens and each request's solo ``generate``."""
    jc, jparams, tc, tparams = _params()
    eng = TS.ContinuousEngine(tc, tparams, device="cpu", **CONT, **kw)
    assert eng.chunked == chunked
    reqs = _requests(TS, tc.vocab)
    got = eng.run(reqs)
    assert (eng.stats["chunks"] > 0) == chunked
    want = JS.ContinuousEngine(jc, jparams, **CONT, **kw).run(
        _requests(JS, jc.vocab))
    solo_kw = {k: v for k, v in kw.items() if k != "chunk_tokens"}
    solo = TE.Engine(tc, tparams, max_len=80, device="cpu", **solo_kw)
    for r in reqs:
        np.testing.assert_array_equal(got[r.rid], np.asarray(want[r.rid]),
                                      err_msg=f"rid {r.rid}")
        np.testing.assert_array_equal(
            got[r.rid], solo.generate(r.prompt[None], r.n_new).tokens[0],
            err_msg=f"rid {r.rid} solo")


def test_mla_dsa_override_falls_back_to_blocking():
    """The reference's test: 2 MLA layers (no MoE) with DSA, an engine on
    "off" that chunk-admits, and requests overriding the mode to block
    and faithful, which leave the chunk envelope and admit blocking: the
    tokens of solo ``generate`` at each override, and the reference's
    continuous engine's."""
    jc, jparams, tc, tparams = _params(mla_only=True)
    assert tc.dsa.enabled and "prologue" not in tparams
    kw = dict(long_context=True, dsa_mode="off", chunk_tokens=16)
    eng = TS.ContinuousEngine(tc, tparams, device="cpu", **CONT, **kw)
    assert eng.chunked
    modes = [None, "block", "faithful"]
    shapes = [(20 + 9 * i, 4 + i) for i in range(3)]
    reqs = _requests(TS, tc.vocab, shapes, modes)
    got = eng.run(reqs)
    assert eng.stats["chunks"] > 0
    want = JS.ContinuousEngine(jc, jparams, **CONT, **kw).run(
        _requests(JS, jc.vocab, shapes, modes))
    solo = TE.Engine(tc, tparams, max_len=80, long_context=True,
                     dsa_mode="off", device="cpu")
    for r in reqs:
        np.testing.assert_array_equal(got[r.rid], np.asarray(want[r.rid]),
                                      err_msg=f"rid {r.rid}")
        np.testing.assert_array_equal(
            got[r.rid], solo.generate(r.prompt[None], r.n_new,
                                      dsa_mode=r.dsa_mode).tokens[0],
            err_msg=f"rid {r.rid} mode={r.dsa_mode}")


def test_paged_and_quantized_engines_refuse_mla():
    """As in the reference: no paged cache (its message), no quantized K/V
    or selection cache, in either engine."""
    _, _, tc, tparams = _params()
    with pytest.raises(ValueError, match="mla"):
        TS.ContinuousEngine(tc, tparams, device="cpu", paged=True, **CONT)
    for kw in (dict(kv_quant="int8"),
               dict(long_context=True, select_dtype="int8")):
        with pytest.raises(ValueError, match="can_quantize"):
            TS.ContinuousEngine(tc, tparams, device="cpu", **CONT, **kw)
        with pytest.raises(ValueError, match="can_quantize"):
            TE.Engine(tc, tparams, max_len=80, device="cpu", **kw)


def test_speculation_gives_plain_tokens():
    """The reference's ``test_spec_exact_mla_and_moe``: the absorbed MLA
    verify and the decode-dense experts give the plain greedy tokens
    (which are the reference's) at B 2 and K 3; DSA over MLA does not
    speculate; a continuous engine with spec serves its solo tokens."""
    jc, jparams, tc, tparams = _params()
    eng = TE.Engine(tc, tparams, max_len=80, device="cpu")
    prompts = _toks(9, 2, 17)
    plain = eng.generate(prompts, 10).tokens
    spec = eng.generate(prompts, 10, spec=3)
    assert spec.spec_rounds > 0
    np.testing.assert_array_equal(spec.tokens, plain)
    want = JE.Engine(jc, jparams, max_len=80).generate(prompts, 10).tokens
    np.testing.assert_array_equal(plain, np.asarray(want))
    dsa = TE.Engine(tc, tparams, max_len=80, long_context=True,
                    dsa_mode="block", device="cpu")
    with pytest.raises(ValueError, match="can_speculate"):
        dsa.generate(prompts, 4, spec=3)
    ce = TS.ContinuousEngine(tc, tparams, device="cpu", spec=3, **CONT)
    assert ce.spec == 3
    reqs = _requests(TS, tc.vocab)
    got = ce.run(reqs)
    for r in reqs:
        np.testing.assert_array_equal(
            got[r.rid], eng.generate(r.prompt[None], r.n_new).tokens[0],
            err_msg=f"rid {r.rid}")


def test_decode_verify_commit_ask_the_host_nothing(monkeypatch):
    """An MLA decode step, verify and commit (the forms a CUDA graph
    captures) run with nonzero, item, tolist and a tensor's truth value
    made to raise."""
    _, _, tc, tparams = _params()
    eng = TE.Engine(tc, tparams, max_len=80, device="cpu")
    with torch.inference_mode():
        caches = eng.resident_cache(2)
        logits, _, _ = eng.prefill(_toks(4, 2, 40), caches=caches)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        vflags = dataclasses.replace(eng.decode_flags, spec_verify=True)
        mask = torch.tensor([True, False])
        scratch = TT.spec_scratch(caches, 4)
        assert scratch == [None] * 3

        def refuse(*a, **k):
            raise AssertionError("host sync in a graphed step")

        for name in ("nonzero", "item", "tolist", "__bool__"):
            monkeypatch.setattr(torch.Tensor, name, refuse)
        TT.decode_step(tparams, tc, eng.decode_flags, tok, caches,
                       active=mask)
        TT.verify_step(tparams, tc, vflags, tok.expand(2, 4), caches,
                       active=mask, scratch=scratch)
        TT.commit_chunk(tc, vflags, caches, torch.tensor([2, 0]), 4,
                        active=mask, scratch=scratch)


def test_state_checkpoints_in_reference_format(tmp_path):
    """A bf16 training state (f32 routers, bf16 moments), the prologue's
    leaves included: the port's checkpoint has the reference's files and
    bytes; the reference's restores in the port bit for bit."""
    jc, tc = _cfgs(param_dtype="bfloat16", dtype="bfloat16")
    opt = JA.OptConfig(moment_dtype="bfloat16")
    jstate, _ = JST.init_train_state(jax.random.PRNGKey(0), jc, opt)
    JC.save(str(tmp_path / "ref"), jstate, step=3)
    tstate = convert.state_from_reference(jax.tree.map(np.asarray, jstate),
                                          device="cpu")
    C.save(str(tmp_path / "port"), tstate, step=3)
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert "params.prologue.0.attn.kv_b.npy" in names
    assert "opt.m.prologue.0.mlp.w2.npy" in names
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
            assert a.requires_grad == (path.startswith("/params")
                                       and not path.endswith("/dsa/p"))


def test_serve_and_train_cli_keep_the_prologue(capsys):
    """``serve --arch deepseek_v3 --reduced`` static (block) and
    continuous; ``--layers 1`` is the reduced prologue alone in both
    CLIs, and below it the depth is refused."""
    res = serve.main(["--arch", ARCH, "--reduced", "--batch", "2",
                      "--prompt-len", "48", "--new-tokens", "6", "--dsa",
                      "--dsa-mode", "block", "--cache-dtype", "bfloat16",
                      "--device", "cpu"])
    assert res.tokens.shape == (2, 6)
    res, eng = serve.main(["--arch", ARCH, "--reduced", "--continuous",
                           "--requests", "3", "--slots", "2",
                           "--prompt-len", "40", "--new-tokens", "4",
                           "--layers", "1", "--device", "cpu"])
    assert all(r.status == "ok" for r in res) and len(res) == 3
    assert len(eng.engine.params["prologue"]) == 1
    assert eng.engine.params["groups"] == []
    assert "continuous: 3 requests" in capsys.readouterr().out
    with pytest.raises(ValueError, match="prologue"):
        serve.main(["--arch", ARCH, "--layers", "2", "--device", "cpu"])
    out = LT.main(["--arch", ARCH, "--reduced", "--layers", "1", "--steps",
                   "2", "--seq", "32", "--batch", "2", "--log-interval", "1",
                   "--device", "cpu"])
    assert len(out.state["params"]["prologue"]) == 1
    assert out.state["params"]["groups"] == []
    assert all(m["router_aux"] == 0 and m["mse"] > 0 for m in out.metrics)
    assert "[done] 2 steps" in capsys.readouterr().out
