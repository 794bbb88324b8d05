"""Copy-on-write prefix reuse on the port's paged cache
(inference/scheduler.py: ``PagePool``'s registry, ``_seed`` and the
skipped prefix chunks).

Against the JAX reference, on the requests of
tests/test_scheduler.py::test_paged_prefix_reuse_exact_and_skips_chunks
(a 40-token shared prefix, chunks of 16, reduced yi_6b, 2 slots, max_len
96): the port's ``ContinuousEngine`` gives the reference's greedy tokens,
prefix hits, reused tokens and chunk steps, its registry keys and its
free page count, on the block and kernel paths, full precision and with
int8 K/V and int8 selection; and the port's ``PagePool`` follows the
reference's through random churn (hypothesis).

Inside the port: sampled requests with a declared prefix get their solo
``Engine.generate`` tokens; a hit gives the tokens of the same requests
undeclared, bit for bit (int8 too: a hit is held to the miss, not to
whole-prompt prefill); a hit's first token is sampled after only the
chunks it ran; an unfundable admission evicts the least recently used
registration.  Tokens are compared exactly.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.inference import scheduler as JS
from repro.models.transformer import init_model as jinit_model
from repro_torch import convert
from repro_torch.configs.base import get_config, reduced
from repro_torch.inference import engine as TE
from repro_torch.inference import scheduler as TS
from repro_torch.models import transformer as TT

torch.set_num_threads(1)

MAX_LEN = 96
KW = dict(slots=2, max_len=MAX_LEN, seg_len=4)
QUANT = {"f32": {}, "int8": dict(kv_quant="int8", select_dtype="int8")}
PREFIX = 40
# (tail, n_new, greedy) of the reference test's six requests
SHAPES = [(8, 6, True), (15, 5, True), (3, 7, False), (20, 4, True),
          (11, 5, True), (6, 6, False)]


@functools.lru_cache(maxsize=None)
def _params(arch: str):
    jc = jreduced(jget_config(arch))
    jparams, _ = jinit_model(jax.random.PRNGKey(0), jc)
    tparams = convert.from_reference(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jc, jparams, reduced(get_config(arch)), tparams


def _prefix_requests(mod, vocab, declare=True, greedy_only=False,
                     seed=141):
    """The reference test's requests: a shared 40-token system prompt and
    a tail each, prefix_len 40 when ``declare``."""
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(1, vocab - 4, size=(PREFIX,)).astype(np.int32)
    out = []
    for rid, (tail, n, greedy) in enumerate(SHAPES):
        p = np.concatenate([sys_p, rng.integers(
            1, vocab - 4, size=(tail,)).astype(np.int32)])
        out.append(mod.Request(rid, p, n, greedy=greedy or greedy_only,
                               seed=rid * 7 + 1,
                               prefix_len=PREFIX if declare else 0))
    return out


def _dsa(mode, quant="f32"):
    return dict(long_context=True, dsa_mode=mode, chunk_tokens=16,
                **QUANT[quant])


def _engine(arch, **kw):
    _, _, tc, tparams = _params(arch)
    return TS.ContinuousEngine(tc, tparams, device="cpu", **{**KW, **kw})


# -- against the reference ------------------------------------------------------


@pytest.mark.parametrize("quant", ["f32", "int8"])
@pytest.mark.parametrize("mode", ["block", "kernel"])
def test_prefix_reuse_equals_reference(mode, quant):
    """Greedy tokens, hits, reused tokens, chunk steps, registry keys and
    free pages all equal the reference's."""
    jc, jparams, _, _ = _params("yi_6b")
    kw = dict(KW, paged=True, **_dsa(mode, quant))
    ref = JS.ContinuousEngine(jc, jparams, **kw)
    want = ref.run(_prefix_requests(JS, jc.vocab, greedy_only=True))
    eng = _engine("yi_6b", paged=True, **_dsa(mode, quant))
    got = eng.run(_prefix_requests(TS, jc.vocab, greedy_only=True))
    assert set(got) == set(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]),
                                      err_msg=f"rid {rid}")
    for k in ("prefix_hits", "prefix_tokens_reused", "chunks"):
        assert eng.stats[k] == ref.stats[k], k
    assert eng.stats["prefix_hits"] > 0
    assert list(eng.pool.prefixes) == list(ref.pool.prefixes)
    assert eng.pool.available() == ref.pool.available()
    assert eng.pool.available() == eng.pool_pages - 1 - PREFIX // 16


def test_prefix_key_is_the_reference_hash():
    """An undeclared key is the SHA-1 of the int32 prefix tokens in both
    packages; an invalid prefix_len is refused in both."""
    jc = _params("yi_6b")[0]
    jr = _prefix_requests(JS, jc.vocab)[0]
    tr = _prefix_requests(TS, jc.vocab)[0]
    JS.ContinuousEngine(jc, _params("yi_6b")[1], **KW).submit(jr)
    eng = _engine("yi_6b")
    eng.submit(tr)
    assert tr.prefix_key == jr.prefix_key and len(tr.prefix_key) == 40
    for bad in (-1, len(tr.prompt) + 1):
        with pytest.raises(ValueError, match="prefix_len"):
            eng.submit(TS.Request(9, tr.prompt, 2, prefix_len=bad))


@given(st.integers(2, 24), st.integers(1, 4),
       st.lists(st.tuples(st.integers(0, 3), st.integers(0, 7),
                          st.integers(1, 6)), max_size=40),
       st.integers(0, 2 ** 31 - 1))
@settings(max_examples=25, deadline=None)
def test_page_pool_churn_never_leaks(n_pages, n_prefix, ops, seed):
    """tests/test_property.py's churn on the port's PagePool, with the
    reference's pool driven alongside: every page in [1, n_pages) is
    free or referenced, never both nor neither, the whole pool comes
    back, and both pools hand out the same pages throughout."""
    pools = [TS.PagePool(n_pages, page_rows=16),
             JS.PagePool(n_pages, page_rows=16)]
    shared = None

    def check():
        for pool in pools:
            freed = set(pool.free)
            held = {p for p in range(1, pool.n_pages) if pool.ref[p] > 0}
            assert not (freed & held)
            assert freed | held == set(range(1, pool.n_pages))
            assert len(pool.free) == len(freed)
        assert pools[0].free == pools[1].free
        np.testing.assert_array_equal(pools[0].ref, pools[1].ref)
        assert pools[0].slot_pages == pools[1].slot_pages

    for op, slot, n in ops:
        pool = pools[0]
        if op == 0 and slot not in pool.slot_pages:  # admit (shared?)
            if n > pool.available():
                continue
            n_sh = len(shared) if shared is not None else 0
            for p in pools:
                if shared is not None:
                    p.retain(shared)
                    pages = list(shared) + p.alloc(n)
                else:
                    pages = p.alloc(n)
                p.assign_slot(slot, pages, n_sh)
        elif op == 1 and slot in pool.slot_pages:    # retire
            for p in pools:
                p.free_slot(slot)
        elif op == 2 and shared is None:             # register
            if n_prefix > pool.available():
                continue
            for p in pools:
                shared = p.alloc(n_prefix)
                p.register_prefix(("k", 16 * n_prefix, 64, "off"),
                                  shared)
        elif op == 3 and shared is not None:         # LRU-evict it
            for p in pools:
                p.evict_for(p.n_pages, keep=None)
            shared = None
        check()
    for p in pools:
        for s in list(p.slot_pages):
            p.free_slot(s)
        p.evict_for(p.n_pages, keep=None)
    check()
    assert pools[0].available() == n_pages - 1


# -- inside the port ------------------------------------------------------------


@pytest.mark.parametrize("mode", ["block", "kernel"])
def test_prefix_reuse_equals_solo_generate_and_skips_chunks(mode):
    """The reference test on the port: greedy and sampled requests get
    their solo tokens, hits skip chunks against a dense engine's run, and
    the registry alone holds the shared pages after the drain."""
    jc, _, tc, tparams = _params("yi_6b")
    reqs = _prefix_requests(TS, jc.vocab)
    eng = _engine("yi_6b", paged=True, **_dsa(mode))
    got = eng.run(reqs)
    solo = TE.Engine(tc, tparams, max_len=MAX_LEN, device="cpu",
                     long_context=True, dsa_mode=mode)
    for r in reqs:
        want = solo.generate(r.prompt[None], r.n_new, greedy=r.greedy,
                             seed=r.seed).tokens[0]
        np.testing.assert_array_equal(got[r.rid], want, err_msg=str(r.rid))
    plain = _engine("yi_6b", **_dsa(mode))
    plain.run(_prefix_requests(TS, jc.vocab))
    assert eng.stats["prefix_hits"] > 0
    assert eng.stats["prefix_tokens_reused"] > 0
    assert eng.stats["chunks"] < plain.stats["chunks"]
    assert plain.stats["prefix_hits"] == 0       # a dense cache shares none
    assert len(eng.pool.prefixes) == 1
    assert eng.pool.available() == eng.pool_pages - 1 - PREFIX // 16


@pytest.mark.parametrize("quant", ["f32", "int8"])
def test_prefix_hit_equals_undeclared(quant):
    """Declared and undeclared, the same requests get the same tokens bit
    for bit, greedy and sampled; under int8 K/V the hit is held to the
    undeclared chunked run (whole-prompt prefill differs by the
    quantization error, ROADMAP Queue 3)."""
    jc = _params("yi_6b")[0]
    kw = dict(paged=True, **_dsa("kernel", quant))
    declared = _engine("yi_6b", **kw)
    got = declared.run(_prefix_requests(TS, jc.vocab))
    undeclared = _engine("yi_6b", **kw)
    want = undeclared.run(_prefix_requests(TS, jc.vocab, declare=False))
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=str(rid))
    assert declared.stats["prefix_hits"] > 0
    assert undeclared.stats["prefix_hits"] == 0
    assert declared.stats["chunks"] < undeclared.stats["chunks"]
    assert undeclared.pool.available() == undeclared.pool_pages - 1


@pytest.mark.parametrize("quant", ["f32", "int8"])
def test_seeded_staging_equals_chunked_staging(quant):
    """A hit's seeded staging cache holds, leaf for leaf and bit for bit,
    what chunking the skipped rows writes into an undeclared group's
    staging cache: k, v, kt, ktb (and their scales) and pos."""
    jc = _params("yi_6b")[0]
    kw = dict(paged=True, **_dsa("kernel", quant))
    reqs = _prefix_requests(TS, jc.vocab)
    declared = _engine("yi_6b", **kw)
    declared.run(reqs[:2])                       # the miss registers
    sink = []
    for r in reqs[2:4]:
        declared.submit(r)
    declared.admit_ready(lambda: 0.0, sink)
    hit = declared._pf
    assert hit.j == 2 and declared.stats["prefix_tokens_reused"] == 64
    undeclared = _engine("yi_6b", **kw)
    for r in _prefix_requests(TS, jc.vocab, declare=False)[2:4]:
        undeclared.submit(r)
    undeclared.admit_ready(lambda: 0.0, sink)
    undeclared.step_prefill(lambda: 0.0, sink, max_chunks=hit.j)
    plain = undeclared._pf
    assert plain.j == hit.j and not sink
    for a, b in zip(TT.attn_caches(hit.caches),
                    TT.attn_caches(plain.caches)):
        assert a.keys() == b.keys()
        for name in a:
            assert torch.equal(a[name], b[name]), name


def test_prefix_hit_ttft_anchors_at_finishing_chunk():
    """tests/test_scheduler.py's TTFT pin on the port: a clock counting
    ``_chunk`` calls reads 2.0 at the first token of a 2-chunk prompt
    undeclared and on the registering miss, and 1.0 on the hit, whose
    seeded staging skips the prefix chunk; tokens are equal across the
    three waves."""
    jc = _params("stablelm_3b")[0]
    eng = _engine("stablelm_3b", paged=True)
    rng = np.random.default_rng(0)
    pfx = rng.integers(1, jc.vocab - 4, size=(64,)).astype(np.int32)
    tails = [rng.integers(1, jc.vocab - 4, size=(n,)).astype(np.int32)
             for n in (4, 7)]                     # prompts 68/71: 2 chunks

    def wave(base, declare):
        return [TS.Request(base + j, np.concatenate([pfx, t]), 6,
                           seed=j * 3 + 1,
                           prefix_len=64 if declare else 0)
                for j, t in enumerate(tails)]

    calls = {"n": 0}
    orig = eng._chunk

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    clock = lambda: float(calls["n"])

    def drive(reqs):
        calls["n"] = 0
        for r in reqs:
            eng.submit(r)
        results = []
        while eng.has_work():
            eng.admit_ready(clock, results)
            eng.step_prefill(clock, results)
            if any(s is not None for s in eng._slot):
                eng.run_segment(clock, results)
        return {r.rid - reqs[0].rid: r for r in results}

    eng._chunk = counting
    plain = drive(wave(0, False))
    miss = drive(wave(100, True))
    hit = drive(wave(200, True))
    for j in range(len(tails)):
        assert plain[j].first_token_s == 2.0
        assert miss[j].first_token_s == 2.0
        assert hit[j].first_token_s == 1.0        # skip capped at chunks-1
        np.testing.assert_array_equal(plain[j].tokens, hit[j].tokens)
        np.testing.assert_array_equal(plain[j].tokens, miss[j].tokens)
        assert hit[j].ttft_s == 1.0               # arrival_s == 0
    assert eng.stats["prefix_hits"] == 2


def test_prefix_registry_evicts_least_recently_used():
    """A pool of 8 pages (pages of 16 rows): prefixes A and B register 2
    pages each; a hit on A makes B the least recently used; a request
    that needs 5 pages then evicts B, not A, and a later B re-registers.
    Every wave's tokens equal its undeclared solo tokens."""
    jc, _, tc, tparams = _params("yi_6b")
    eng = _engine("yi_6b", paged=True, pool_pages=9, **_dsa("block"))
    solo = TE.Engine(tc, tparams, max_len=MAX_LEN, device="cpu",
                     long_context=True, dsa_mode="block")
    rng = np.random.default_rng(5)

    def toks(n):
        return rng.integers(1, jc.vocab - 4, size=(n,)).astype(np.int32)

    pa, pb = toks(32), toks(32)
    rid = iter(range(100))

    def serve(prompt, n_new, prefix_len):
        r = TS.Request(next(rid), prompt, n_new, prefix_len=prefix_len)
        got = eng.run([r])[r.rid]
        want = solo.generate(prompt[None], n_new).tokens[0]
        np.testing.assert_array_equal(got, want)
        return r

    a = serve(np.concatenate([pa, toks(8)]), 8, 32)        # 3 pages
    b = serve(np.concatenate([pb, toks(8)]), 8, 32)
    key = lambda r: (r.prefix_key, 32, 64, "block")
    assert list(eng.pool.prefixes) == [key(a), key(b)]
    assert eng.pool.available() == 4
    serve(np.concatenate([pa, toks(5)]), 8, 32)            # hit: A refreshed
    assert list(eng.pool.prefixes) == [key(b), key(a)]
    hits = eng.stats["prefix_hits"]
    serve(toks(60), 20, 0)                                 # 5 pages: evicts B
    assert list(eng.pool.prefixes) == [key(a)]
    assert eng.pool.available() == 6
    serve(np.concatenate([pb, toks(3)]), 8, 32)            # B misses again
    assert list(eng.pool.prefixes) == [key(a), key(b)]
    assert eng.stats["prefix_hits"] == hits
    assert eng.pool.available() == 4
