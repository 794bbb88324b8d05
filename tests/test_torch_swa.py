"""Sliding-window (SWA) ring caches in the port against the JAX
reference, on reduced h2o_danube_1_8b (window 64) with the reference's
weights (``convert.py``) and the same numpy inputs; and
``RunFlags.decode_window`` on reduced yi_6b.

- The ring across its wrap: prompts of win - 2, win and 2 win + 3
  tokens, then decode steps across the wrap point; the port's decode
  logits equal the reference's at 1e-4 of the largest magnitude (f32,
  other summation orders) and the port's own teacher-forced forward at
  2e-3 (the reference's own ring test's tolerance).
- The ring's contents after prefill (k, v at 1e-4, ``pos`` exact), for
  DSA off, block and kernel prefill.
- Greedy tokens of the static engine on off, faithful, block and kernel
  modes, prompts past the window: EQUAL to the reference's.
- ``decode_window`` on a non-SWA arch with the DSA decode cache: logits
  and every cache leaf against the reference after the ring wraps.
- ``decode_attention``'s slot-positional window, before the wrap.
- The four serving predicates equal the reference's for every arch the
  port has.
- The continuous engine admits h2o blocking into a dense ring: its
  tokens equal solo ``Engine.generate``'s and the reference continuous
  engine's; the masked ring step equals the Active-rows step bit for bit
  and asks the host nothing.
- Refusals: quantized caches, paged caches and the chunk step on a ring.
- A reference fault (ROADMAP Queue 3): a right-padded ragged batch whose
  padded width exceeds the window keeps the batch's last window of
  positions, pads included, so a shorter row decodes against pad rows.
  The port computes the reference's values; both differ from the row's
  solo prefill.
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
from repro.inference import engine as JE
from repro.inference import scheduler as JS
from repro.models import transformer as JT
from repro.models.attention import RunFlags as JFlags
from repro_torch import convert
from repro_torch.configs.base import ARCH_IDS, get_config, reduced
from repro_torch.core import attention as TA
from repro_torch.core.quantization import raw
from repro_torch.inference import engine as TE
from repro_torch.inference import scheduler as TS
from repro_torch.models import transformer as TT
from repro_torch.models.attention import Active, RunFlags

torch.set_num_threads(1)

ARCH = "h2o_danube_1_8b"
REL = 1e-4


@functools.lru_cache(maxsize=None)
def _params(arch: str = ARCH):
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


def _layers(caches):
    jg = caches["groups"]
    if isinstance(jg, dict):                         # stacked reference
        n = jax.tree_util.tree_leaves(jg)[0].shape[0]
        jg = [jax.tree.map(lambda a, i=i: a[i], jg) for i in range(n)]
    return [g["b0"]["attn"] for g in jg]


def _toks(seed, b, n):
    return np.random.default_rng(seed).integers(
        1, _params()[0].vocab - 4, size=(b, n)).astype(np.int32)


def test_config_is_the_reference_config():
    """The port's copy of h2o_danube_1_8b has the reference's every
    field, and reduced() maps the window as the reference's does."""
    jc, tc = jget_config(ARCH), get_config(ARCH)
    for f in dataclasses.fields(tc):
        if f.name != "dsa":
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    for f in dataclasses.fields(tc.dsa):
        assert getattr(tc.dsa, f.name) == getattr(jc.dsa, f.name), f.name
    assert tc.swa_window == 4096 and reduced(tc).swa_window == 64
    assert reduced(tc).swa_window == jreduced(jc).swa_window
    # convert.py carries the reference's weights unchanged
    _, jparams, _, tparams = _params()
    np.testing.assert_array_equal(
        tparams["groups"][1]["b0"]["attn"]["wk"].numpy(),
        np.asarray(jparams["groups"]["b0"]["attn"]["wk"][1]))


# -- the ring ---------------------------------------------------------------


def _prefill_both(mode, toks, max_len, lengths=None, decode_window=0,
                  arch=ARCH):
    """Prefill ``toks`` on both sides into caches of ``max_len`` (DSA
    ``mode``), truncated to ``lengths`` when given."""
    jc, jparams, tc, tparams = _params(arch)
    kw = dict(dsa_mode=mode, long_context=mode != "off",
              decode_window=decode_window)
    jdf, tdf = JFlags(mode="decode", **kw), RunFlags(mode="decode", **kw)
    jpf = dataclasses.replace(jdf, mode="prefill")
    tpf = dataclasses.replace(tdf, mode="prefill")
    b = toks.shape[0]
    jcache = JT.init_cache(jc, b, max_len, jdf, dtype=jnp.float32)
    jlog, _, jcache = JT.forward(jparams, jc, jpf,
                                 {"tokens": jnp.asarray(toks)}, caches=jcache)
    tcache = TT.init_cache(tc, b, max_len, tdf, dtype=torch.float32,
                           device="cpu")
    with torch.inference_mode():
        tlog, _ = TT.forward(tparams, tc, tpf, torch.from_numpy(toks), tcache)
        if lengths is not None:
            TT.truncate_cache(tc, tcache, torch.from_numpy(lengths))
    if lengths is not None:
        jcache = JT.truncate_cache(jc, jcache, jnp.asarray(lengths))
    _close(tlog.numpy(), jlog, what="prefill logits")
    return (jdf, JT.unstack_group_caches(jcache), tdf, tcache,
            np.asarray(jlog), tlog.numpy())


def _decode_both(state, toks, arch=ARCH):
    """Feed ``toks`` (B, n) one step at a time on both sides; the port's
    logits at each step against the reference's."""
    jc, jparams, tc, tparams = _params(arch)
    jdf, jcache, tdf, tcache = state[:4]
    out = []
    for i in range(toks.shape[1]):
        tok = toks[:, i:i + 1]
        jl, jcache = JT.decode_step(jparams, jc, jdf, jnp.asarray(tok),
                                    jcache)
        with torch.inference_mode():
            tl, _ = TT.decode_step(tparams, tc, tdf,
                                   torch.from_numpy(tok.astype(np.int64)),
                                   tcache)
        _close(tl.numpy(), jl, what=("decode", i))
        out.append(tl.numpy()[:, 0])
    return jcache, tcache, np.stack(out, 1)


@pytest.mark.parametrize("delta", [-2, 0, 67], ids=["pre", "at", "post"])
def test_swa_window_ring_wrap(delta):
    """Prompts of win - 2, win and 2 win + 3 tokens, then four decode
    steps across the wrap: the reference's decode logits at 1e-4, and the
    port's teacher-forced forward at 2e-3."""
    jc, _, tc, tparams = _params()
    win = tc.swa_window
    s0, n = win + delta, 4
    toks = _toks(s0, 1, s0 + n)
    state = _prefill_both("off", toks[:, :s0], s0 + n)
    assert state[3]["groups"][0]["b0"]["attn"]["k"].shape[1] == win
    _, _, dec = _decode_both(state, toks[:, s0:])
    with torch.inference_mode():
        full, _ = TT.forward(tparams, tc, RunFlags(mode="prefill",
                                                   dsa_mode="off"),
                             torch.from_numpy(toks))
    np.testing.assert_allclose(dec, full.numpy()[:, s0:s0 + n],
                               atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("mode", ["off", "block", "kernel"])
def test_ring_contents_equal_reference_after_fill(mode):
    """A prompt of 2 win + 32 tokens (block-aligned, so DSA prefill takes
    the block path and K2's window) fills the ring: the same k and v at
    every slot, ``pos`` exact, and no kt under SWA on either side."""
    toks = _toks(3, 2, 160)
    state = _prefill_both(mode, toks, 176)
    for t, j in zip(_layers(state[3]), _layers(state[1])):
        assert set(t) == set(j) == {"k", "v", "pos"}
        assert t["k"].shape[1] == 64
        np.testing.assert_array_equal(t["pos"].numpy(), np.asarray(j["pos"]))
        for name in ("k", "v"):
            _close(t[name].numpy(), np.asarray(j[name]), what=name)


@functools.lru_cache(maxsize=None)
def _reference_tokens(mode):
    jc, jparams, _, _ = _params()
    res = JE.Engine(jc, jparams, max_len=176, long_context=mode != "off",
                    dsa_mode=mode).generate(_toks(4, 2, 160), 8)
    return np.asarray(res.tokens)


@pytest.mark.parametrize("loop", ["scan", "python"])
@pytest.mark.parametrize("mode", ["off", "faithful", "block", "kernel"])
def test_greedy_tokens_equal_reference(mode, loop):
    """The static engine on prompts of 160 tokens (the ring wraps at
    prefill and again in decode): the reference's greedy tokens."""
    _, _, tc, tparams = _params()
    eng = TE.Engine(tc, tparams, max_len=176, long_context=mode != "off",
                    dsa_mode=mode, loop=loop, device="cpu")
    assert not eng.bucket_prompts
    res = eng.generate(_toks(4, 2, 160), 8)
    np.testing.assert_array_equal(res.tokens, _reference_tokens(mode))


def test_bf16_model_with_f32_ring():
    """A bf16 model on the default f32 cache: the ring's rows are cast to
    the cache's dtype (the reference refuses the mixed dtypes; ROADMAP
    Queue 3), and decode across the wrap gives in-range tokens."""
    _, _, tc, tparams = _params()
    bf = dataclasses.replace(tc, dtype="bfloat16", param_dtype="bfloat16")
    params = TT.init_model(0, bf, device="cpu")
    eng = TE.Engine(bf, params, max_len=120, long_context=True,
                    dsa_mode="block", device="cpu")
    res = eng.generate(_toks(6, 2, 96), 12)
    cache = eng.resident_cache(2)["groups"][0]["b0"]["attn"]
    assert cache["k"].dtype == torch.float32 and cache["k"].shape[1] == 64
    assert res.tokens.shape == (2, 12)
    assert res.tokens.min() >= 0 and res.tokens.max() < bf.vocab


@pytest.mark.parametrize("mode", ["off", "block", "faithful"])
def test_decode_window_matches_reference(mode):
    """yi_6b with ``decode_window=32``: a ring of 32 rows with the DSA
    decode cache (kt, ktb) wrapped by a 40-token prefill, then six decode
    steps: logits and every leaf (kt, ktb included) against the
    reference."""
    arch = "yi_6b"
    toks = _toks(8, 2, 46)
    state = _prefill_both(mode, toks[:, :40], 96, decode_window=32,
                          arch=arch)
    jcache, tcache, _ = _decode_both(state, toks[:, 40:], arch=arch)
    for t, j in zip(_layers(tcache), _layers(jcache)):
        assert set(t) == set(j)
        assert t["k"].shape[1] == 32
        np.testing.assert_array_equal(t["pos"].numpy(), np.asarray(j["pos"]))
        for name in t:
            if name != "pos":
                _close(t[name].numpy(), np.asarray(j[name]), what=name)


def test_decode_attention_window_masks_slots_pre_wrap():
    """``window`` is a slot-positional mask: with kv_len 20 and window 8
    decode attends slots 12..19, as the reference's does."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((1, 1, 2, 8)).astype(np.float32)
    kc = rng.standard_normal((1, 32, 2, 8)).astype(np.float32)
    vc = rng.standard_normal((1, 32, 2, 8)).astype(np.float32)
    kvl = np.array([20], np.int32)
    got = TA.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                              torch.from_numpy(vc),
                              kv_len=torch.from_numpy(kvl), window=8)
    want = JA.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), kv_len=jnp.asarray(kvl),
                               window=8)
    _close(got.numpy(), want, rel=1e-5)
    sub = TA.decode_attention(torch.from_numpy(q),
                              torch.from_numpy(kc[:, 12:20]),
                              torch.from_numpy(vc[:, 12:20]),
                              kv_len=torch.tensor([8], dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), sub.numpy(), atol=1e-5)


# -- serving ------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_predicates_equal_reference(arch):
    for cfg_t, cfg_j in ((get_config(arch), jget_config(arch)),
                         (reduced(get_config(arch)),
                          jreduced(jget_config(arch)))):
        assert TE.can_bucket_prompts(cfg_t) == JE.can_bucket_prompts(cfg_j)
        assert TE.can_page(cfg_t) == JE.can_page(cfg_j)
        assert TE.can_quantize(cfg_t) == JE.can_quantize(cfg_j)
        for mode in ("off", "faithful", "block", "kernel"):
            assert TE.can_chunk_prefill(cfg_t) == JE.can_chunk_prefill(
                cfg_j, mode)
    swa = arch == ARCH
    assert TE.can_page(get_config(arch)) == (not swa
                                             and get_config(arch).rwkv is None)


SHAPES = [(48, 8), (70, 6), (130, 5), (20, 9), (70, 4)]
CONT = dict(slots=2, max_len=160, seg_len=4, long_context=True,
            dsa_mode="block")


def _requests(mod, vocab):
    rng = np.random.default_rng(0)
    return [mod.Request(rid, rng.integers(1, vocab - 4, size=(n,)).astype(
        np.int32), n_new, seed=rid * 7 + 1)
        for rid, (n, n_new) in enumerate(SHAPES)]


def test_continuous_blocking_ring_equals_reference_and_solo():
    """Prompts shorter than, past and twice past the window (two of one
    length, admitted as one group): blocking admission, the insert
    zero-extending each prefill ring into the resident ring of 64 rows.
    The reference continuous engine's tokens and solo generate's."""
    jc, jparams, tc, tparams = _params()
    eng = TS.ContinuousEngine(tc, tparams, device="cpu", **CONT)
    assert not eng.chunked and not eng.paged
    assert eng._caches["groups"][0]["b0"]["attn"]["k"].shape[1] == 64
    reqs = _requests(TS, tc.vocab)
    got = eng.run(reqs)
    want = JS.ContinuousEngine(jc, jparams, **CONT).run(
        _requests(JS, jc.vocab))
    solo = TE.Engine(tc, tparams, max_len=160, long_context=True,
                     dsa_mode="block", device="cpu")
    for r in reqs:
        np.testing.assert_array_equal(got[r.rid], np.asarray(want[r.rid]),
                                      err_msg=f"rid {r.rid}")
        np.testing.assert_array_equal(
            got[r.rid], solo.generate(r.prompt[None], r.n_new).tokens[0],
            err_msg=f"rid {r.rid} solo")
    assert eng.stats["chunks"] == 0 and eng.stats["admitted"] == len(reqs)


def test_ring_masked_step_equals_rows_step_and_asks_nothing(monkeypatch):
    """Three slots admitted at 48, 70 and 130 tokens (two rings already
    wrapped), four masked steps: equal to the Active-rows steps bit for
    bit, logits and every leaf; then a step with ``nonzero``, ``item``,
    ``tolist`` and truth values raising."""
    _, _, tc, tparams = _params()
    eng = TS.ContinuousEngine(tc, tparams, device="cpu", **dict(CONT,
                                                               slots=3))
    rng = np.random.default_rng(5)
    for rid, n in enumerate((48, 70, 130)):
        eng.submit(TS.Request(rid, rng.integers(
            1, tc.vocab - 4, size=(n,)).astype(np.int32), 24))
    eng.admit_ready(lambda: 0.0, [])
    assert all(s is not None for s in eng._slot)
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
            for a, b in zip(_layers(eng._caches), _layers(rows)):
                for name in a:
                    assert torch.equal(raw(a[name]), raw(b[name])), (step,
                                                                     name)
            tok = torch.where(mask[:, None], got[:, -1].argmax(-1)[:, None],
                              tok)

    def refuse(*a, **k):
        raise AssertionError("host sync in the decode step")

    with torch.inference_mode():
        for name in ("nonzero", "item", "tolist", "__bool__"):
            monkeypatch.setattr(torch.Tensor, name, refuse)
        TT.decode_step(params, cfg, flags, tok, eng._caches,
                       active=torch.tensor([True, False, True]))


def test_ring_refusals_match_reference():
    """Quantized and paged caches and the chunk step are refused on a
    ring, where the reference refuses them (its asserts are the port's
    ValueError / NotImplementedError)."""
    jc, jparams, tc, tparams = _params()
    for kw in (dict(kv_quant="int8"), dict(long_context=True,
                                           select_dtype="int8")):
        with pytest.raises(ValueError, match="can_quantize"):
            TE.Engine(tc, tparams, device="cpu", **kw)
        with pytest.raises(ValueError, match="can_quantize"):
            JE.Engine(jc, jparams, **kw)
    with pytest.raises(ValueError, match="paging envelope"):
        TS.ContinuousEngine(tc, tparams, device="cpu", paged=True)
    with pytest.raises(ValueError, match="paging envelope"):
        JS.ContinuousEngine(jc, jparams, paged=True)
    flags = RunFlags(mode="decode")
    with pytest.raises(ValueError, match="non-wrapping"):
        TT.init_cache(tc, 2, 96, flags, device="cpu", pages=13)
    with pytest.raises(ValueError, match="non-wrapping"):
        TT.init_cache(reduced(get_config("yi_6b")), 2, 96,
                      RunFlags(mode="decode", decode_window=32),
                      device="cpu", pages=13)
    with pytest.raises(AssertionError, match="non-wrapping"):
        JT.init_cache(jc, 2, 96, JFlags(mode="decode"), pages=13)
    cache = TT.init_cache(tc, 2, 96, flags, device="cpu")
    with pytest.raises(NotImplementedError, match="non-wrapping"):
        TT.chunk_step(tparams, tc, flags, torch.ones((2, 16),
                                                     dtype=torch.long),
                      cache, torch.tensor([16, 16]))


# -- a reference fault --------------------------------------------------------


def test_reference_fault_ragged_batch_across_the_window():
    """Rows of 160 and 100 tokens right-padded to 160 (window 64): the
    ring keeps positions 96..159 for both rows, and truncation zeroes
    slots, not positions, so row 1 keeps pad rows.  Its first decode
    logits are the reference's (1e-4) on the port, and on both sides far
    from those of row 1 prefilled alone (which equal each other, the
    right answer)."""
    toks = _toks(12, 2, 160)
    lengths = np.array([160, 100], np.int32)
    state = _prefill_both("off", toks, 176, lengths=lengths)
    nxt = toks[:, 100:101].copy()
    _, _, batch = _decode_both(state, nxt)
    solo = _prefill_both("off", toks[1:, :100], 176)
    _, _, alone = _decode_both(solo, nxt[1:])
    err = float(np.max(np.abs(batch[1] - alone[0])))
    assert err > 1e-2 * float(np.max(np.abs(alone[0]))), err
