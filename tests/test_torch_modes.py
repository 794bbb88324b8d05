"""Per-request DSA modes: the static ``Engine``'s ``dsa_mode=`` override
and the ``ContinuousEngine``'s mode-affine segments with aging
(inference/engine.py, inference/scheduler.py).

Against the JAX reference (reduced configs, max_len 96, 2 slots,
segments of 4; token ids compared exactly): the port's static
``generate(dsa_mode=)`` gives the reference's tokens in all four modes
and its prefill logits within 1e-4 absolute (f32); the reference's
tests/test_scheduler.py tests of per-request modes, of aging
(``max_mode_wait_s``) and of the refusal on an engine without the DSA
caches, run on both packages, with chunked and blocking admission, each
request getting the reference ``Engine.generate(dsa_mode=)``'s tokens.

Inside the port: a second mode's masked step, run with no active row in
the middle of a run (as a graph capture's warm-up steps are), leaves the
resident cache bit for bit as it was, dense and paged, f32 and int8.
"""
import functools
import itertools

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.inference import engine as JE
from repro.inference import scheduler as JS
from repro.models.transformer import init_model as jinit_model
from repro_torch import convert
from repro_torch.configs.base import get_config, reduced
from repro_torch.inference import engine as TE
from repro_torch.inference import scheduler as TS
from repro_torch.models.attention import DSA_MODES

torch.set_num_threads(1)

MAX_LEN = 96
KW = dict(slots=2, max_len=MAX_LEN, seg_len=4)
DSA = dict(long_context=True, dsa_mode="block")
LOGIT_ATOL = 1e-4          # f32, port against reference
ADMISSION = {"chunked": None, "blocking": False}


@functools.lru_cache(maxsize=None)
def _params(arch: str):
    jc = jreduced(jget_config(arch))
    jparams, _ = jinit_model(jax.random.PRNGKey(0), jc)
    tparams = convert.from_reference(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jc, jparams, reduced(get_config(arch)), tparams


@functools.lru_cache(maxsize=None)
def _ref_engine():
    jc, jparams, _, _ = _params("yi_6b")
    return JE.Engine(jc, jparams, max_len=MAX_LEN, **DSA)


def _ref_tokens(req):
    """The reference's solo generate at the request's mode."""
    return np.asarray(_ref_engine().generate(
        req.prompt[None], req.n_new, greedy=req.greedy, seed=req.seed,
        dsa_mode=req.dsa_mode).tokens[0])


def _mode_requests(mod, vocab):
    """tests/test_scheduler.py::test_per_request_dsa_mode_override's
    requests."""
    rng = np.random.default_rng(51)
    modes = ["block", "kernel", "faithful", None, "off"]
    return [mod.Request(rid, rng.integers(1, vocab - 4, size=(
        17 + 7 * rid,)).astype(np.int32), 4 + rid, seed=rid, dsa_mode=m)
        for rid, m in enumerate(modes)]


def _drain_with_admit_order(ce, reqs):
    """Serve to empty on a clock that ticks once a reading."""
    counter = itertools.count()
    clock = lambda: float(next(counter))
    for r in reqs:
        ce.submit(r)
    results = []
    while ce.has_work():
        ce.admit_ready(clock, results)
        ce.step_prefill(clock, results)
        if any(s is not None for s in ce._slot):
            ce.run_segment(clock, results)
    return {r.rid: r for r in results}


# -- the static engine ----------------------------------------------------------


@pytest.mark.parametrize("mode", DSA_MODES)
def test_static_generate_dsa_mode_equals_reference(mode):
    """A ``block`` engine's ``generate(dsa_mode=mode)`` gives the
    reference's tokens, a ragged batch included, and the tokens of an
    engine built with that mode; its prefill logits agree within
    LOGIT_ATOL."""
    jc, _, tc, tparams = _params("yi_6b")
    rng = np.random.default_rng(3)
    prompts = rng.integers(1, jc.vocab - 4, size=(2, 48)).astype(np.int32)
    lengths = np.array([48, 37], np.int32)
    eng = TE.Engine(tc, tparams, max_len=MAX_LEN, device="cpu", **DSA)
    got = eng.generate(prompts, 9, lengths=lengths, dsa_mode=mode).tokens
    want = _ref_engine().generate(prompts, 9, lengths=lengths,
                                  dsa_mode=mode).tokens
    np.testing.assert_array_equal(got, np.asarray(want))
    own = TE.Engine(tc, tparams, max_len=MAX_LEN, device="cpu",
                    long_context=True, dsa_mode=mode)
    np.testing.assert_array_equal(
        got, own.generate(prompts, 9, lengths=lengths).tokens)
    t_last = eng.prefill(prompts, lengths=lengths, dsa_mode=mode)[0]
    j_last = _ref_engine().prefill(prompts, lengths=lengths,
                                   dsa_mode=mode)[0]
    np.testing.assert_allclose(t_last.numpy(), np.asarray(j_last),
                               rtol=0, atol=LOGIT_ATOL)
    assert eng.run_flags("decode", mode).dsa_mode == mode
    assert eng.run_flags("prefill") is eng.prefill_flags


# -- the continuous engine ------------------------------------------------------


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("admission", list(ADMISSION))
def test_per_request_dsa_mode_override(admission, paged):
    """Each request gets the reference generate's tokens at its own mode,
    as from the reference's continuous engine, through mode-affine
    segments that drain and switch modes."""
    jc = _params("yi_6b")[0]
    kw = dict(KW, chunked_prefill=ADMISSION[admission], **DSA)
    ref_got = _ref_continuous(admission)
    eng = _engine_kw(paged=paged, **kw)
    reqs = _mode_requests(TS, jc.vocab)
    got = eng.run(reqs)
    assert eng.chunked == (admission == "chunked")
    for r in reqs:
        want = _ref_tokens(r)
        np.testing.assert_array_equal(got[r.rid], want,
                                      err_msg=f"rid {r.rid} {r.dsa_mode}")
        np.testing.assert_array_equal(np.asarray(ref_got[r.rid]), want)
    if paged:
        assert eng.pool.available() == eng.pool_pages - 1


@functools.lru_cache(maxsize=None)
def _ref_continuous(admission):
    """The reference continuous engine's tokens on the mode requests."""
    jc, jparams, _, _ = _params("yi_6b")
    ref = JS.ContinuousEngine(jc, jparams, chunked_prefill=ADMISSION[
        admission], **KW, **DSA)
    return ref.run(_mode_requests(JS, jc.vocab))


def _engine_kw(**kw):
    _, _, tc, tparams = _params("yi_6b")
    return TS.ContinuousEngine(tc, tparams, device="cpu", **kw)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_segment_modes_past_the_local_window(paged):
    """At the reduced configs above, decode keeps every block (the prompts
    fit the 64-token local window), so the decode modes agree.  Prompts of
    ~200 tokens (13 blocks, a few kept) make them differ: each request
    gets the port's solo ``generate(dsa_mode=)`` tokens, and the modes'
    tokens are not all equal."""
    _, _, tc, tparams = _params("yi_6b")
    rng = np.random.default_rng(11)
    modes = [None, "off", "faithful", "kernel", "off", None]
    reqs = [TS.Request(rid, rng.integers(1, tc.vocab - 4, size=(
        190 + 5 * rid,)).astype(np.int32), 16, seed=rid, dsa_mode=m)
        for rid, m in enumerate(modes)]
    eng = _engine_kw(slots=2, max_len=256, seg_len=4, chunk_tokens=64,
                     paged=paged, **DSA)
    got = eng.run(reqs)
    solo = TE.Engine(tc, tparams, max_len=256, device="cpu", **DSA)
    for r in reqs:
        want = solo.generate(r.prompt[None], r.n_new, seed=r.seed,
                             dsa_mode=r.dsa_mode).tokens[0]
        np.testing.assert_array_equal(got[r.rid], want,
                                      err_msg=f"rid {r.rid} {r.dsa_mode}")
        other = solo.generate(r.prompt[None], r.n_new, seed=r.seed,
                              dsa_mode="off" if r.dsa_mode != "off"
                              else "block").tokens[0]
        assert not np.array_equal(other[1:], want[1:]), r.rid


@pytest.mark.parametrize("admission", list(ADMISSION))
def test_mode_wait_aging_unstarves_other_mode_requests(admission):
    """With ``max_mode_wait_s=0`` the other-mode request is admitted
    before later default-mode traffic; without aging it is admitted last,
    in both packages.  Tokens are the reference generate's at each
    request's mode."""
    jc, jparams, _, _ = _params("yi_6b")
    shapes = [(20, 12, None), (20, 4, "off"), (20, 4, None), (20, 4, None)]
    rng = np.random.default_rng(71)
    prompts = [rng.integers(1, jc.vocab - 4, size=(n,)).astype(np.int32)
               for n, _, _ in shapes]

    def mk(mod):
        return [mod.Request(rid, prompts[rid], n, seed=rid, dsa_mode=m)
                for rid, (_, n, m) in enumerate(shapes)]

    kw = dict(KW, chunked_prefill=ADMISSION[admission], **DSA)
    for wait in (0.0, None):
        res = {"ref": _drain_with_admit_order(JS.ContinuousEngine(
                   jc, jparams, max_mode_wait_s=wait, **kw), mk(JS)),
               "port": _drain_with_admit_order(_engine_kw(
                   max_mode_wait_s=wait, **kw), mk(TS))}
        for name, r in res.items():
            if wait is None:
                assert r[1].admit_s > r[3].admit_s, name    # starved
            else:
                assert r[1].admit_s < r[3].admit_s, name    # aged
        for rid, r in res["port"].items():
            req = mk(TS)[rid]
            np.testing.assert_array_equal(r.tokens, _ref_tokens(req),
                                          err_msg=f"rid {rid} wait {wait}")


def test_dsa_mode_override_rejected_without_cache():
    """An engine without long_context holds no DSA caches: both packages
    refuse a mode override at submit, and a bad temperature."""
    jc, jparams, tc, tparams = _params("stablelm_3b")
    for mod, eng in ((JS, JS.ContinuousEngine(jc, jparams, **KW)),
                     (TS, TS.ContinuousEngine(tc, tparams, device="cpu",
                                              **KW))):
        with pytest.raises(ValueError):
            eng.submit(mod.Request(123, np.ones((8,), np.int32), 2,
                                   dsa_mode="block"))
        with pytest.raises(ValueError):
            eng.submit(mod.Request(124, np.ones((8,), np.int32), 2,
                                   temperature=0.0))
        eng.submit(mod.Request(125, np.ones((8,), np.int32), 2,
                               dsa_mode="off"))       # the engine's own


def _snapshot(caches):
    return [t.clone() for g in caches["groups"] for sub in g.values()
            for t in sub["attn"].values()]


@pytest.mark.parametrize("quant", ["f32", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_second_mode_step_leaves_cache_unchanged(paged, quant):
    """Mid-run, with slots live, every other mode's masked step run twice
    with no active row (a capture's warm-up) leaves every cache leaf bit
    for bit unchanged, and the run then ends with the tokens of a run
    that never ran those steps."""
    jc = _params("yi_6b")[0]
    kw = dict(KW, paged=paged, chunk_tokens=16, **DSA,
              **({} if quant == "f32" else
                 dict(kv_quant="int8", select_dtype="int8")))
    reqs = [TS.Request(rid, r.prompt, 9, seed=rid)
            for rid, r in enumerate(_mode_requests(TS, jc.vocab)[:3])]
    want = _engine_kw(**kw).run(reqs)
    eng = _engine_kw(**kw)
    for r in reqs:
        eng.submit(r)
    sink, clock = [], lambda: 0.0
    while not any(s is not None for s in eng._slot):
        eng.admit_ready(clock, sink)
        eng.step_prefill(clock, sink)
    eng.run_segment(clock, sink)
    assert any(s is not None for s in eng._slot)
    before = _snapshot(eng._caches)
    none = torch.zeros((eng.slots,), dtype=torch.bool)
    tok = torch.ones((eng.slots, 1), dtype=torch.long)
    for mode in DSA_MODES:
        if mode == "block":
            continue
        step = eng._segment_step(mode)
        with torch.inference_mode():
            for _ in range(2):
                step(tok, none)
        for a, b in zip(before, _snapshot(eng._caches)):
            assert torch.equal(a, b), mode
    while eng.has_work():
        eng.admit_ready(clock, sink)
        eng.step_prefill(clock, sink)
        if any(s is not None for s in eng._slot):
            eng.run_segment(clock, sink)
    for r in sink:
        np.testing.assert_array_equal(r.tokens, want[r.rid])
