"""The paper's token-granularity DSA decode (``dsa_mode="faithful"``) in
the port against the JAX reference, on the reference's weights
(``convert.py``) and the same numpy inputs.

- ``core.attention.dsa_decode_attention``: ragged ``kv_len``, rows
  shorter than the 64-token local window, keep + local > S, no kv_len,
  and tied scores.  The port's selection is a stable descending sort, so
  ties go to the lower index as ``lax.top_k``'s do and the gathered rows
  are the reference's, in its order.  f32 at 1e-5 of the largest
  magnitude (summation order only).
- Greedy tokens of reduced yi_6b through the static engine, both decode
  loops, full precision, int8 selection and int8/fp8 K/V, full and ragged
  batches: EQUAL to the reference's.
- The continuous engine (chunked admission; dense and paged caches): the
  reference continuous engine's tokens, and the port's solo
  ``Engine.generate`` tokens.
- The caches after faithful decode steps: k, v and kt at 1e-4 of the
  largest magnitude (the model's parity tolerance), ``pos`` exact, and
  ktb untouched by decode on both sides (faithful returns before the
  block-sum update, as the reference does).
- The faithful step captures as a graph would: the masked step equals
  the Active-rows step bit for bit and asks the host nothing.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core import attention as JA
from repro.inference import scheduler as JS
from repro.inference.engine import Engine as JEngine
from repro.models import transformer as JT
from repro.models.attention import RunFlags as JFlags
from repro_torch import convert
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import attention as TA
from repro_torch.core.quantization import raw
from repro_torch.inference import engine as TE
from repro_torch.inference import scheduler as TS
from repro_torch.models import transformer as TT
from repro_torch.models.attention import Active, RunFlags

torch.set_num_threads(1)

MAX_LEN = 96
REL = 1e-4


@functools.lru_cache(maxsize=None)
def _params(arch: str = "yi_6b"):
    jc = jreduced(jget_config(arch))
    jparams, _ = JT.init_model(jax.random.PRNGKey(0), jc)
    tparams = convert.from_reference(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jc, jparams, reduced(get_config(arch)), tparams


def _close(got, want, rel=REL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.max(np.abs(want))), 1e-6)
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * scale, (what, err, scale)


# -- the primitive ------------------------------------------------------------


@pytest.mark.parametrize("s,kv_len,keep,ties", [
    (96, [96, 70, 33], 10, False),      # ragged, one row under 64
    (80, [40, 12, 80], 6, False),       # kv_len < local
    (48, [48, 30, 5], 10, False),       # keep + local > S: all rows
    (96, None, 12, False),              # no kv_len
    (96, [96, 81, 65], 9, True),        # tied scores at the threshold
], ids=["ragged", "short", "all-rows", "no-kv-len", "ties"])
def test_dsa_decode_attention_matches_reference(s, kv_len, keep, ties):
    rng = np.random.default_rng(s + keep)
    b, hq, hkv, hd = 3, 8, 2, 16
    q = rng.standard_normal((b, 1, hq, hd)).astype(np.float32)
    kc = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    vc = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    st = rng.standard_normal((b, s)).astype(np.float32)
    if ties:                                  # four distinct values only
        st = np.round(st).clip(-1, 2).astype(np.float32)
    kvl = None if kv_len is None else np.asarray(kv_len, np.int32)
    want = JA.dsa_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(st),
        keep=keep, kv_len=None if kvl is None else jnp.asarray(kvl))
    got = TA.dsa_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(st), keep=keep,
        kv_len=None if kvl is None else torch.from_numpy(kvl))
    assert got.shape == (b, 1, hq, hd)
    _close(got.numpy(), want, rel=1e-5)


# -- the static engine --------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _prompts():
    return np.random.default_rng(1).integers(
        1, _params()[0].vocab - 4, size=(2, 48)).astype(np.int32)


LENGTHS = np.array([48, 29], np.int32)


@functools.lru_cache(maxsize=None)
def _reference_tokens(kv, sel, ragged):
    jc, jparams, _, _ = _params()
    res = JEngine(jc, jparams, max_len=MAX_LEN, long_context=True,
                  dsa_mode="faithful", kv_quant=kv, select_dtype=sel).generate(
        _prompts(), 8, lengths=LENGTHS if ragged else None)
    return np.asarray(res.tokens)


@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
@pytest.mark.parametrize("loop,kv,sel", [
    ("scan", None, "float32"), ("python", None, "float32"),
    ("scan", None, "int8"), ("scan", "int8", "float32"),
    ("scan", "fp8", "float32"), ("python", "fp8", "int8")],
    ids=["scan-f32", "python-f32", "scan-int8sel", "scan-int8kv",
         "scan-fp8kv", "python-fp8kv-int8sel"])
def test_faithful_greedy_tokens_equal_reference(loop, kv, sel, ragged):
    _, _, tc, tparams = _params()
    eng = TE.Engine(tc, tparams, max_len=MAX_LEN, long_context=True,
                    dsa_mode="faithful", kv_quant=kv, select_dtype=sel,
                    loop=loop, device="cpu")
    res = eng.generate(_prompts(), 8, lengths=LENGTHS if ragged else None)
    np.testing.assert_array_equal(res.tokens,
                                  _reference_tokens(kv, sel, ragged))


# -- the continuous engine ----------------------------------------------------

SHAPES = [(48, 8), (21, 12), (65, 5), (30, 10), (17, 7)]
CONT = dict(slots=2, max_len=MAX_LEN, seg_len=4, long_context=True,
            dsa_mode="faithful")


def _requests(mod, vocab):
    rng = np.random.default_rng(0)
    return [mod.Request(rid, rng.integers(1, vocab - 4, size=(n,)).astype(
        np.int32), n_new, seed=rid * 7 + 1)
        for rid, (n, n_new) in enumerate(SHAPES)]


@functools.lru_cache(maxsize=None)
def _reference_continuous(paged):
    jc, jparams, _, _ = _params()
    got = JS.ContinuousEngine(jc, jparams, paged=paged, **CONT).run(
        _requests(JS, jc.vocab))
    return {rid: np.asarray(t) for rid, t in got.items()}


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_faithful_continuous_equals_reference_and_solo(paged):
    """Chunked admission and faithful decode segments over a dense or
    paged resident cache: the reference continuous engine's greedy
    tokens, and each request's solo ``Engine.generate`` (the port's own
    continuous == solo contract)."""
    _, _, tc, tparams = _params()
    eng = TS.ContinuousEngine(tc, tparams, device="cpu", paged=paged, **CONT)
    assert eng.chunked
    reqs = _requests(TS, tc.vocab)
    got = eng.run(reqs)
    want = _reference_continuous(paged)
    solo = TE.Engine(tc, tparams, max_len=MAX_LEN, long_context=True,
                     dsa_mode="faithful", device="cpu")
    for r in reqs:
        np.testing.assert_array_equal(got[r.rid], want[r.rid],
                                      err_msg=f"rid {r.rid}")
        np.testing.assert_array_equal(
            got[r.rid], solo.generate(r.prompt[None], r.n_new).tokens[0],
            err_msg=f"rid {r.rid} solo")
    assert eng.stats["chunks"] > 0
    if paged:
        assert eng.pool.available() == eng.pool_pages - 1


# -- the caches ---------------------------------------------------------------


def _layers(caches):
    jg = caches["groups"]
    if isinstance(jg, dict):                         # stacked reference
        n = jax.tree_util.tree_leaves(jg)[0].shape[0]
        jg = [jax.tree.map(lambda a, i=i: a[i], jg) for i in range(n)]
    return [g["b0"]["attn"] for g in jg]


@pytest.mark.parametrize("sel", ["float32", "int8"])
def test_faithful_decode_caches_match_reference(sel):
    """Prefill a ragged pair on both sides, then five faithful decode
    steps (row 1 frozen on the second): logits at the active rows, and
    every K/V/kt leaf after, at 1e-4 of the largest magnitude, ``pos``
    exact; ktb (and ktb_s) equal to what prefill left, on both sides."""
    jc, jparams, tc, tparams = _params()
    kw = dict(dsa_mode="faithful", long_context=True, select_dtype=sel)
    jdf, tdf = JFlags(mode="decode", **kw), RunFlags(mode="decode", **kw)
    jpf = dataclasses.replace(jdf, mode="prefill")
    tpf = dataclasses.replace(tdf, mode="prefill")
    toks = _prompts()
    jcache = JT.init_cache(jc, 2, MAX_LEN, jdf, dtype=jnp.float32)
    jlog, _, jcache = JT.forward(jparams, jc, jpf,
                                 {"tokens": jnp.asarray(toks)}, caches=jcache)
    jcache = JT.unstack_group_caches(
        JT.truncate_cache(jc, jcache, jnp.asarray(LENGTHS)))
    tcache = TT.init_cache(tc, 2, MAX_LEN, tdf, dtype=torch.float32,
                           device="cpu")
    with torch.inference_mode():
        TT.forward(tparams, tc, tpf, torch.from_numpy(toks), tcache)
        TT.truncate_cache(tc, tcache, torch.from_numpy(LENGTHS))
    blocks = [{n: raw(c[n]).clone() for n in ("ktb", "ktb_s") if n in c}
              for c in _layers(tcache)]
    jblocks = [{n: np.asarray(c[n]) for n in ("ktb", "ktb_s") if n in c}
               for c in _layers(jcache)]
    tok = np.asarray(jlog)[np.arange(2), LENGTHS - 1].argmax(-1)[:, None]
    for step in range(5):
        active = np.array([True, step != 1])
        jl, jcache = JT.decode_step(jparams, jc, jdf, jnp.asarray(tok),
                                    jcache, active=jnp.asarray(active))
        with torch.inference_mode():
            tl, tcache = TT.decode_step(
                tparams, tc, tdf, torch.from_numpy(tok.astype(np.int64)),
                tcache, active=torch.from_numpy(active))
        _close(tl.numpy()[active], np.asarray(jl)[active], what=step)
        nxt = np.asarray(jl)[:, -1].argmax(-1)[:, None]
        tok = np.where(active[:, None], nxt, tok).astype(np.int32)
    for t, j, tb, jb in zip(_layers(tcache), _layers(jcache), blocks,
                            jblocks):
        np.testing.assert_array_equal(t["pos"].numpy(), np.asarray(j["pos"]))
        assert t["pos"].tolist() == [53, 33]
        for name in ("k", "v"):
            _close(t[name].numpy(), np.asarray(j[name]), what=name)
        if sel == "int8":          # within one int8 step of the row scale
            got = t["kt"].float().numpy() * t["kt_s"].numpy()[..., None]
            want = (np.asarray(j["kt"], np.float32)
                    * np.asarray(j["kt_s"])[..., None])
            step = np.maximum(t["kt_s"].numpy(), np.asarray(j["kt_s"]))
            assert (np.abs(got - want) <= step[..., None] + 1e-6).all()
        else:
            _close(t["kt"].numpy(), np.asarray(j["kt"]), what="kt")
        for name, before in tb.items():
            assert torch.equal(raw(t[name]), before), name
            np.testing.assert_array_equal(np.asarray(j[name]), jb[name])


# -- the step a graph captures ------------------------------------------------


def _resident(paged, kv=None, sel="float32"):
    """A continuous faithful engine's resident cache with three slots
    admitted at three depths."""
    _, _, tc, tparams = _params()
    eng = TS.ContinuousEngine(tc, tparams, device="cpu", slots=3,
                              max_len=MAX_LEN, seg_len=4, long_context=True,
                              dsa_mode="faithful", kv_quant=kv,
                              select_dtype=sel, paged=paged)
    rng = np.random.default_rng(5)
    for rid, n in enumerate((48, 21, 37)):
        eng.submit(TS.Request(rid, rng.integers(
            1, tc.vocab - 4, size=(n,)).astype(np.int32), 24))
    clock, sink = (lambda: 0.0), []
    while eng.queue or eng._pf is not None:
        eng.admit_ready(clock, sink)
        eng.step_prefill(clock, sink)
    return eng


def _leaves(caches):
    for gi, c in enumerate(_layers(caches)):
        for name, t in c.items():
            yield (gi, name), t


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("kv,sel", [(None, "float32"), ("int8", "int8")],
                         ids=["f32", "int8-int8"])
def test_faithful_masked_step_equals_rows_step_and_asks_nothing(
        monkeypatch, paged, kv, sel):
    """Four faithful steps with changing masks (one with no active slot):
    the masked step (what a graph captures) equals the Active-rows step
    bit for bit, logits and every leaf; then a masked step runs with
    ``nonzero``, ``item``, ``tolist`` and truth values raising."""
    eng = _resident(paged, kv, sel)
    params, cfg, flags = eng.engine.params, eng.cfg, eng.engine.decode_flags
    rows = {"groups": [{"b0": {"attn": {n: t.clone() for n, t in
                                        g["b0"]["attn"].items()}}}
                       for g in eng._caches["groups"]]}
    tok = eng._tok.clone()
    with torch.inference_mode():
        for step, m in enumerate([[True, True, True], [True, False, True],
                                  [False, False, False], [False, True, True]]):
            mask = torch.tensor(m)
            got = TT.decode_step(params, cfg, flags, tok, eng._caches,
                                 active=mask)[0]
            want = TT.decode_step(params, cfg, flags, tok, rows,
                                  active=Active(mask,
                                                mask.nonzero()[:, 0]))[0]
            assert torch.equal(got, want), step
            for (key, a), (_, b) in zip(_leaves(eng._caches),
                                        _leaves(rows)):
                assert torch.equal(raw(a), raw(b)), (step, key)
            tok = torch.where(mask[:, None], got[:, -1].argmax(-1)[:, None],
                              tok)

    def refuse(*a, **k):
        raise AssertionError("host sync in the decode step")

    with torch.inference_mode():
        for name in ("nonzero", "item", "tolist", "__bool__"):
            monkeypatch.setattr(torch.Tensor, name, refuse)
        TT.decode_step(params, cfg, flags, tok, eng._caches,
                       active=torch.tensor([True, False, True]))
