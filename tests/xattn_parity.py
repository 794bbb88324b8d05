"""Checks shared by tests/test_torch_whisper.py (the encoder-decoder) and
tests/test_torch_vision.py (gated cross-attention): the port against the
JAX reference on an arch's reduced config (f32, the CPU), with the
reference's weights carried across by ``repro_torch.convert`` and the
same numpy inputs.

Every check sets each cross sub-layer's gate ``xgate`` to ``GATE`` in
the shared numpy weights before they reach either package: at its
initial value 0, tanh(0) = 0 and neither the encoder nor the image
would reach the logits, so a check at init values proves nothing about
cross-attention (``params(arch, gate=0.0)`` keeps the init value).

Tolerances: logits, cache leaves and the encoder's output within
``REL`` = 1e-4 of the largest magnitude (f32, different summation
orders); ``pos`` and greedy tokens exactly; block selections as equal
sets; scalar metrics rtol 1e-5; a train step as tests/test_torch_train.py
holds one (gradients 1e-4 of each leaf's largest magnitude, new params
within 2 lr with 99 % of the elements within 1e-5).
"""
from __future__ import annotations

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
from repro_torch.data import synthetic as TD
from repro_torch.inference import engine as TE
from repro_torch.inference import scheduler as TS
from repro_torch.inference import speculative as TSP
from repro_torch.launch.serve import draw_extras
from repro_torch.models import transformer as TT
from repro_torch.models.attention import RunFlags
from repro_torch.optim import adamw as TA
from repro_torch.training import steps as TST
from repro_torch.tree import named_leaves

REL = 1e-4
METRIC_RTOL = 1e-5
GRAD_REL = 1e-4
PARAM_SHARE = 0.99
GATE = 0.5
MODES = ("off", "block", "faithful", "kernel")
OPT = dict(lr=1e-3, total_steps=10, warmup_steps=2)


def close(got, want, rel=REL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1e-6)
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * scale, (what, err, scale)


def cfgs(arch, **kw):
    """(reference, port) reduced configs, with ``kw`` replaced in both."""
    return (dataclasses.replace(JB.reduced(JB.get_config(arch)), **kw),
            dataclasses.replace(TB.reduced(TB.get_config(arch)), **kw))


def fields_equal(tc, jc, what):
    for f in dataclasses.fields(tc):
        got, want = getattr(tc, f.name), getattr(jc, f.name)
        if dataclasses.is_dataclass(got):
            fields_equal(got, want, f"{what}.{f.name}")
        else:
            assert got == want, (what, f.name, got, want)


def set_gates(tree, gate: float):
    """Every ``xgate`` leaf of a numpy reference tree set to ``gate``."""
    for sub in tree["groups"].values():
        if "xgate" in sub:
            sub["xgate"] = np.full_like(sub["xgate"], gate)
    return tree


@functools.lru_cache(maxsize=None)
def params(arch, gate=GATE, **kw):
    """(jc, jparams, tc, tparams): the reference's init from key 0 with
    the gates set, and the port's copy of it."""
    jc, tc = cfgs(arch, **kw)
    jp, _ = JT.init_model(jax.random.PRNGKey(0), jc)
    tree = set_gates(jax.tree.map(np.asarray, jp), gate)
    return (jc, jax.tree.map(jnp.asarray, tree), tc,
            convert.from_reference(tree, device="cpu"))


def extras(cfg, b: int, seed: int = 7):
    """The arch's second input for ``b`` rows, drawn as ``launch.serve``
    draws it: whisper's frame or llama's patch embeddings, standard
    normal."""
    return draw_extras(cfg, b, np.random.default_rng(seed))


def toks(seed, b, n, vocab=512):
    return np.random.default_rng(seed).integers(
        1, vocab - 4, size=(b, n)).astype(np.int32)


def compare_caches(tcache, jcache):
    """Every leaf of every sub-block's cache, the cross sub-layers'
    ``ck``/``cv`` included; ``pos`` exact."""
    for tg, jg in zip(tcache["groups"], jcache["groups"]):
        assert set(tg) == set(jg)
        for name, tsub in tg.items():
            jsub = jg[name]
            assert set(tsub) == set(jsub), (name, set(tsub), set(jsub))
            for part in tsub:
                for leaf, t in tsub[part].items():
                    w = np.asarray(jsub[part][leaf])
                    if leaf == "pos":
                        np.testing.assert_array_equal(t.numpy(), w)
                    else:
                        close(t.numpy(), w, what=(name, part, leaf))


def _selections(jparams, jc, jdf, tparams, tc, tdf, tok, jcache, tcache):
    """Each DSA layer's decode block selection (port, reference) as sets,
    read without changing either cache."""
    jsel = {"sel_idx": [], "sel_ok": []}
    _, new = JT.decode_step(jparams, jc, dataclasses.replace(
        jdf, sel_probe=True), jnp.asarray(tok), jcache)
    for path, leaf in jax.tree_util.tree_flatten_with_path(new)[0]:
        name = str(getattr(path[-1], "key", path[-1]))
        if name in jsel:
            jsel[name].append(np.asarray(leaf))
    saved = [{k: v.clone() for k, v in lc.items()}
             for lc in TT.attn_caches(tcache)]
    _, _, sel = TT.decode_step(tparams, tc, dataclasses.replace(
        tdf, sel_probe=True), torch.from_numpy(tok), tcache)
    for lc, sv in zip(TT.attn_caches(tcache), saved):
        for k, v in sv.items():
            lc[k].copy_(v)
    assert len(sel) == len(jsel["sel_idx"]) > 0
    for (idx, ok, _), jidx, jok in zip(sel, jsel["sel_idx"], jsel["sel_ok"]):
        for b in range(tok.shape[0]):
            got = set(idx[b].numpy()[ok[b].numpy().astype(bool)].tolist())
            want = set(jidx[b][jok[b].astype(bool)].tolist())
            assert got == want, (b, got, want)


def check_prefill_and_decode(arch, mode, plen, with_extras=True, steps=4,
                             **kw):
    """A prefill of two prompts of ``plen`` tokens (with the arch's
    extras, or none), then ``steps`` decode steps: logits and every cache
    leaf against the reference's; on block and kernel the first step's
    block selections as sets.  Returns the port's final cache."""
    jc, jparams, tc, tparams = params(arch, **kw)
    b, max_len = 2, plen + 16
    prompts = toks(1, b, plen)
    ex = extras(tc, b) if with_extras else {}
    jpf = JFlags(mode="prefill", dsa_mode=mode, with_mse=False,
                 long_context=True)
    jdf = dataclasses.replace(jpf, mode="decode")
    tpf = RunFlags(mode="prefill", dsa_mode=mode, long_context=True)
    tdf = dataclasses.replace(tpf, mode="decode")
    jcache = JT.init_cache(jc, b, max_len, jdf, dtype=jnp.float32)
    jbatch = {"tokens": jnp.asarray(prompts)}
    jbatch.update({k: jnp.asarray(v) for k, v in ex.items()})
    jlog, _, jcache = JT.forward(jparams, jc, jpf, jbatch, caches=jcache)
    jcache = JT.unstack_group_caches(
        JT.truncate_cache(jc, jcache, jnp.full((b,), plen, jnp.int32)))
    tcache = TT.init_cache(tc, b, max_len, tdf, dtype=torch.float32,
                           device="cpu")
    with torch.inference_mode():
        tlog, _ = TT.forward(tparams, tc, tpf, torch.from_numpy(prompts),
                             tcache, extras={k: torch.from_numpy(v)
                                             for k, v in ex.items()})
        TT.truncate_cache(tc, tcache, plen)
        close(tlog.numpy(), jlog, what="prefill logits")
        compare_caches(tcache, jcache)
        tok = np.asarray(jlog)[:, -1].argmax(-1)[:, None].astype(np.int32)
        for step in range(steps):
            if mode in ("block", "kernel") and step == 0:
                _selections(jparams, jc, jdf, tparams, tc, tdf, tok, jcache,
                            tcache)
            jlog, jcache = JT.decode_step(jparams, jc, jdf, jnp.asarray(tok),
                                          jcache)
            tlog, _ = TT.decode_step(tparams, tc, tdf, torch.from_numpy(tok),
                                     tcache)
            close(tlog.numpy(), jlog, what=("decode logits", step))
            tok = np.asarray(jlog)[:, -1].argmax(-1)[:, None].astype(np.int32)
        compare_caches(tcache, jcache)
    return tcache


def check_train_forward(arch, mode, seq=64, **kw):
    """The training forward with extras on 2 x ``seq`` tokens: logits
    within REL, ``mse`` (an encoder's included) and ``router`` at the
    metric tolerance."""
    jc, jparams, tc, tparams = params(arch, **kw)
    prompts = toks(0, 2, seq)
    ex = extras(tc, 2)
    jl, ja, _ = JT.forward(jparams, jc, JFlags(mode="train", dsa_mode=mode),
                           {"tokens": prompts, **ex})
    tl, ta = TT.forward_train(tparams, tc, RunFlags(mode="train",
                                                    dsa_mode=mode),
                              torch.from_numpy(prompts),
                              {k: torch.from_numpy(v) for k, v in ex.items()})
    close(tl.detach().numpy(), jl, what="logits")
    for k in ("mse", "router"):
        np.testing.assert_allclose(float(ta[k]), float(ja[k]),
                                   rtol=METRIC_RTOL, atol=1e-7, err_msg=k)
    assert (mode == "off") == (float(ta["mse"]) == 0)
    return float(ta["mse"])


@functools.lru_cache(maxsize=None)
def reference_tokens(arch, mode, with_extras=True):
    jc, jparams, tc, _ = params(arch)
    ex = extras(tc, 2) if with_extras else None
    res = JE.Engine(jc, jparams, max_len=80, long_context=mode != "off",
                    dsa_mode=mode).generate(toks(4, 2, 40), 8, extras=ex)
    return np.asarray(res.tokens)


def check_greedy_tokens(arch, mode, loop="scan", with_extras=True):
    """The static engine on two prompts of 40 tokens with the arch's
    extras: the reference's greedy tokens."""
    _, _, tc, tparams = params(arch)
    eng = TE.Engine(tc, tparams, max_len=80, long_context=mode != "off",
                    dsa_mode=mode, loop=loop, device="cpu")
    res = eng.generate(toks(4, 2, 40), 8,
                       extras=extras(tc, 2) if with_extras else None)
    np.testing.assert_array_equal(res.tokens,
                                  reference_tokens(arch, mode, with_extras))
    return eng


SHAPES = [(40, 6), (48, 5), (40, 7), (33, 4), (48, 9)]
CONT = dict(slots=2, max_len=80, seg_len=4)


def requests(mod, vocab, shapes=SHAPES):
    rng = np.random.default_rng(0)
    return [mod.Request(rid, rng.integers(1, vocab - 4, size=(n,)).astype(
        np.int32), n_new) for rid, (n, n_new) in enumerate(shapes)]


def check_continuous(arch, mode):
    """The continuous engine (blocking admission: no chunking; no encoder
    or image input at admission, as in the reference) against the
    reference's continuous engine and each request's solo ``generate``.
    Returns the engine."""
    jc, jparams, tc, tparams = params(arch)
    kw = dict(long_context=mode != "off", dsa_mode=mode)
    eng = TS.ContinuousEngine(tc, tparams, device="cpu", **CONT, **kw)
    assert not eng.chunked and not eng.paged and eng.spec == 0
    reqs = requests(TS, tc.vocab)
    got = eng.run(reqs)
    assert eng.stats["chunks"] == 0 and eng.stats["admitted"] == len(reqs)
    want = JS.ContinuousEngine(jc, jparams, **CONT, **kw).run(
        requests(JS, jc.vocab))
    solo = TE.Engine(tc, tparams, max_len=80, device="cpu", **kw)
    for r in reqs:
        np.testing.assert_array_equal(got[r.rid], np.asarray(want[r.rid]),
                                      err_msg=f"rid {r.rid}")
        np.testing.assert_array_equal(
            got[r.rid], solo.generate(r.prompt[None], r.n_new).tokens[0],
            err_msg=f"rid {r.rid} solo")
    return eng


def batch(cfg, b, s, seed=0):
    """An ``lm`` batch of ``b`` x ``s`` with the arch's extras."""
    out = next(TD.lm_batches(TD.DataConfig(vocab=cfg.vocab, seq_len=s,
                                           global_batch=b, seed=seed)))
    return dict(out, **extras(cfg, b, seed + 7))


@functools.lru_cache(maxsize=None)
def _ref_grad(arch, mode):
    jc, _, _, _ = params(arch)
    flags = JFlags(mode="train", dsa_mode=mode)
    return jax.jit(lambda p, bt: jax.grad(JST.loss_fn, has_aux=True)(
        p, jc, flags, bt))


@functools.lru_cache(maxsize=None)
def _ref_update(opt):
    return jax.jit(lambda p, g, s: JA.apply_updates(opt, p, g, s))


def _port_state(jparams, opt):
    tree = convert.from_reference(jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    for path, p in named_leaves(tree):
        p.requires_grad_(not TA.is_frozen(path))
    return {"params": tree, "opt": TA.init(opt, tree), "step": 0}


def _flat(tree):
    return dict(named_leaves(jax.tree.map(np.asarray, tree)))


def check_train_step(arch, mode, mb):
    """One train step with extras on 2 rows a microbatch: the reference's
    step composed of its own parts (each microbatch's gradients summed,
    divided by the count, then ``apply_updates``), against the port's
    ``accumulate_grads`` + ``apply_updates``: metrics, every gradient (the
    encoder's and the gates' included) and every new param."""
    jc, jparams, tc, _ = params(arch)
    jopt, topt = JA.OptConfig(**OPT), TA.OptConfig(**OPT)
    jstate = {"params": jparams, "opt": JA.init(jopt, jparams),
              "step": jnp.zeros((), jnp.int32)}
    tstate = _port_state(jparams, topt)
    bt = batch(tc, 2 * mb, 64)
    n = 2
    grads = metrics = None
    for i in range(mb):
        g, m = _ref_grad(arch, mode)(
            jparams, {k: v[i * n:(i + 1) * n] for k, v in bt.items()})
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
        metrics = m if metrics is None else jax.tree.map(jnp.add, metrics, m)
    if mb > 1:
        grads = jax.tree.map(lambda x: x / mb, grads)
        metrics = jax.tree.map(lambda x: x / mb, metrics)
    jnew, _, om = _ref_update(jopt)(jparams, grads, jstate["opt"])
    jm = dict(metrics, **om)
    tg, tm = TST.accumulate_grads(tstate["params"], tc, RunFlags(
        mode="train", dsa_mode=mode), bt, mb)
    _, _, tom = TA.apply_updates(topt, tstate["params"], tg, tstate["opt"])
    tm.update(tom)
    for k in ("loss", "ce", "mse", "router_aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=METRIC_RTOL, atol=1e-7, err_msg=k)
    jg = _flat(grads)
    for path, g in _flat(convert.to_reference(tg)).items():
        close(g, jg[path], GRAD_REL, what=("grad", path))
    gates = [path for path in jg if path.endswith("/xgate")]
    assert gates and all(np.abs(jg[p]).max() > 0 for p in gates)
    lr = float(jm["lr"])
    jp = _flat(jnew)
    within, total = 0, 0
    for path, p in _flat(convert.to_reference(tstate["params"])).items():
        d = np.abs(p - jp[path])
        assert d.max() <= 2 * lr, (path, d.max())
        within += int((d <= 1e-5).sum())
        total += d.size
    assert within >= PARAM_SHARE * total, (within, total)


def check_four_step_curve(arch):
    """Four steps with a one-step warmup, extras in every batch: loss, ce,
    mse and router_aux at each step against the reference's
    ``make_train_step``."""
    jc, jparams, tc, _ = params(arch)
    kw = dict(lr=3e-4, total_steps=4, warmup_steps=1)
    jopt, topt = JA.OptConfig(**kw), TA.OptConfig(**kw)
    jstate = {"params": jparams, "opt": JA.init(jopt, jparams),
              "step": jnp.zeros((), jnp.int32)}
    tstate = _port_state(jparams, topt)
    jstep = jax.jit(JST.make_train_step(jc, jopt))
    tstep = TST.make_train_step(tc, topt)
    for i in range(4):
        bt = batch(tc, 2, 64, seed=i)
        jstate, jm = jstep(jstate, bt)
        tstate, tm = tstep(tstate, bt)
        for k in ("loss", "ce", "mse", "router_aux"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=METRIC_RTOL, atol=1e-7,
                                       err_msg=(i, k))


def check_checkpoint(arch, tmp_path):
    """A bf16 training state (bf16 moments): the port's checkpoint has the
    reference's files and bytes; the reference's restores in the port
    bit for bit.  Returns the file names."""
    jc, tc = cfgs(arch, param_dtype="bfloat16", dtype="bfloat16")
    opt = JA.OptConfig(moment_dtype="bfloat16")
    jstate, _ = JST.init_train_state(jax.random.PRNGKey(0), jc, opt)
    JC.save(str(tmp_path / "ref"), jstate, step=3)
    tstate = convert.state_from_reference(jax.tree.map(np.asarray, jstate),
                                          device="cpu")
    C.save(str(tmp_path / "port"), tstate, step=3)
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
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
    return names


def check_envelopes(arch):
    """No paged or quantized cache, no chunked admission (even when
    asked), no speculation: the reference's envelopes, and its
    predicates' values."""
    jc, _, tc, tparams = params(arch)
    for fn in ("can_bucket_prompts", "can_page", "can_quantize"):
        assert getattr(TE, fn)(tc) == getattr(JE, fn)(jc), fn
    for mode in MODES:
        assert not TE.can_chunk_prefill(tc, mode, True)
        assert TE.can_chunk_prefill(tc, mode) == JE.can_chunk_prefill(jc, mode)
        assert not TSP.can_speculate(tc, mode, 4)
        assert not JSP.can_speculate(jc, mode, 4)
    assert not TE.can_page(tc) and not TE.can_quantize(tc)
    with pytest.raises(ValueError, match="paging envelope"):
        TS.ContinuousEngine(tc, tparams, device="cpu", paged=True, **CONT)
    with pytest.raises(ValueError, match="can_quantize"):
        TE.Engine(tc, tparams, max_len=80, kv_quant="int8", device="cpu")
    ce = TS.ContinuousEngine(tc, tparams, device="cpu", chunked_prefill=True,
                             spec=3, **CONT)
    assert not ce.chunked and ce.spec == 0
    eng = TE.Engine(tc, tparams, max_len=80, device="cpu")
    with pytest.raises(ValueError, match="can_speculate"):
        eng.generate(toks(2, 2, 40), 4, spec=3)
