"""The port's continuous-batching scheduler (inference/scheduler.py).

Against the JAX reference: the port's ``ContinuousEngine`` serves the
reference ``ContinuousEngine``'s greedy tokens on the same requests and
weights (the reference's fixtures: max_len 96, 2 slots, segments of 4),
for dense stablelm_3b and DSA yi_6b on the block and kernel paths, each
with a dense and a paged resident cache; ``summarize`` and
``synthetic_workload`` give the reference's output.

Inside the port (the reference's contracts pinned again against the
port): continuous == solo ``Engine.generate`` per request, greedy and
sampled with per-request seeds and temperatures; paged == dense; chunked
== blocking admission, chunk widths that do not divide the prompts
included; slot reuse leaks nothing; the page pool gets every page back.
Tokens are compared exactly.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.inference import scheduler as JS
from repro.models.transformer import init_model as jinit_model
from repro_torch import convert
from repro_torch.configs.base import get_config, reduced
from repro_torch.inference import engine as TE
from repro_torch.inference import scheduler as TS
from repro_torch.launch import serve

torch.set_num_threads(1)

MAX_LEN = 96
KW = dict(slots=2, max_len=MAX_LEN, seg_len=4)
DSA = dict(long_context=True, dsa_mode="block")
DENSE_SHAPES = [(20, 5), (33, 9), (7, 1), (40, 12), (12, 6), (25, 3),
                (18, 8)]
DSA_SHAPES = [(48, 8), (21, 12), (65, 5), (30, 10), (17, 7)]


@functools.lru_cache(maxsize=None)
def _params(arch: str):
    jc = jreduced(jget_config(arch))
    jparams, _ = jinit_model(jax.random.PRNGKey(0), jc)
    tparams = convert.from_reference(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jc, jparams, reduced(get_config(arch)), tparams


def _requests(mod, vocab, shapes, seed=0, greedy=True, temps=None):
    rng = np.random.default_rng(seed)
    out = []
    for rid, (n, n_new) in enumerate(shapes):
        prompt = rng.integers(1, vocab - 4, size=(n,)).astype(np.int32)
        t = 1.0 if temps is None else temps[rid % len(temps)]
        out.append(mod.Request(rid, prompt, n_new, greedy=greedy,
                               seed=rid * 7 + 1, temperature=t))
    return out


def _engine(arch, **kw):
    _, _, tc, tparams = _params(arch)
    return TS.ContinuousEngine(tc, tparams, device="cpu", **{**KW, **kw})


# -- against the reference ------------------------------------------------------


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("arch,mode", [("stablelm_3b", "off"),
                                       ("yi_6b", "block"),
                                       ("yi_6b", "kernel")])
def test_greedy_tokens_equal_reference(arch, mode, paged):
    jc, jparams, _, _ = _params(arch)
    kw = dict(paged=paged)
    if mode != "off":
        kw.update(long_context=True, dsa_mode=mode)
    shapes = DENSE_SHAPES if mode == "off" else DSA_SHAPES
    want = JS.ContinuousEngine(jc, jparams, **KW, **kw).run(
        _requests(JS, jc.vocab, shapes))
    eng = _engine(arch, **kw)
    got = eng.run(_requests(TS, jc.vocab, shapes))
    assert set(got) == set(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]),
                                      err_msg=f"rid {rid}")
    assert eng.stats["chunks"] > 0 and eng.stats["prefill_s"] == 0.0


def test_summarize_and_workload_equal_reference():
    kw = dict(rate_rps=3.0, prompt_lens=(8, 40), n_new_range=(2, 9),
              vocab=512, seed=4)
    jw = JS.synthetic_workload(9, **kw)
    tw = TS.synthetic_workload(9, **kw)
    for j, t in zip(jw, tw):
        for f in ("rid", "n_new", "greedy", "seed", "arrival_s",
                  "deadline_s"):
            assert getattr(t, f) == getattr(j, f), f
        np.testing.assert_array_equal(t.prompt, j.prompt)
    rng = np.random.default_rng(0)
    rows = []
    for r in tw:
        admit = r.arrival_s + float(rng.random())
        first = admit + float(rng.random())
        rows.append((r.rid, np.zeros((r.n_new,), np.int32), len(r.prompt),
                     r.n_new, r.arrival_s, admit, first + 1.0, first))
    jres = [JS.RequestResult(*x[:7], first_token_s=x[7]) for x in rows]
    tres = [TS.RequestResult(*x[:7], first_token_s=x[7]) for x in rows]
    assert TS.summarize(tres, 12.5) == JS.summarize(jres, 12.5)
    assert TS.summarize([], 0.0) == JS.summarize([], 0.0)


# -- inside the port ------------------------------------------------------------


def _solo(arch, reqs, **kw):
    """Each request alone through Engine.generate at the same max_len."""
    _, _, tc, tparams = _params(arch)
    eng = TE.Engine(tc, tparams, max_len=MAX_LEN, device="cpu", **kw)
    return {r.rid: eng.generate(r.prompt[None], r.n_new, greedy=r.greedy,
                                seed=r.seed,
                                temperature=r.temperature).tokens[0]
            for r in reqs}


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
@pytest.mark.parametrize("arch,kw", [("stablelm_3b", {}),
                                     ("yi_6b", DSA),
                                     ("yi_6b", dict(DSA, dsa_mode="kernel",
                                                    paged=True))],
                         ids=["dense", "dsa-block", "dsa-kernel-paged"])
def test_continuous_equals_solo_generate(arch, kw, greedy):
    """Every request gets exactly its solo tokens: greedy, and sampled
    with its own seed and temperature (its own generator replays the B=1
    chain), n_new=1 requests retiring at admission included."""
    jc = _params(arch)[0]
    shapes = DENSE_SHAPES if not kw else DSA_SHAPES
    reqs = _requests(TS, jc.vocab, shapes, seed=2, greedy=greedy,
                     temps=[1.0, 0.7, 1.3])
    got = _engine(arch, **kw).run(reqs)
    want = _solo(arch, reqs, **{k: v for k, v in kw.items()
                                if k != "paged"})
    for r in reqs:
        np.testing.assert_array_equal(got[r.rid], want[r.rid],
                                      err_msg=f"rid {r.rid}")


@pytest.mark.parametrize("mode", ["block", "kernel"])
def test_paged_equals_dense(mode):
    jc = _params("yi_6b")[0]
    reqs = _requests(TS, jc.vocab, DSA_SHAPES + [(60, 9), (11, 4)], seed=5)
    kw = dict(DSA, dsa_mode=mode)
    dense = _engine("yi_6b", **kw).run(reqs)
    paged = _engine("yi_6b", paged=True, **kw).run(reqs)
    for r in reqs:
        np.testing.assert_array_equal(paged[r.rid], dense[r.rid])


@pytest.mark.parametrize("arch,kw,chunk", [("stablelm_3b", {}, 16),
                                           ("yi_6b", DSA, 16),
                                           ("yi_6b", DSA, 32),
                                           ("yi_6b", dict(DSA, paged=True),
                                            32)])
def test_chunked_equals_blocking(arch, kw, chunk):
    """Chunk widths 16 and 32 over prompts of 20, 33 and 65 tokens (no
    width divides them all) give the blocking path's tokens, with a dense
    and with a paged resident cache."""
    jc = _params(arch)[0]
    reqs = _requests(TS, jc.vocab, [(20, 6), (33, 9), (65, 5), (24, 7)],
                     seed=6)
    chunked = _engine(arch, chunk_tokens=chunk, **kw)
    blocking = _engine(arch, chunked_prefill=False, **kw)
    assert chunked.chunked and not blocking.chunked
    got, want = chunked.run(reqs), blocking.run(reqs)
    for r in reqs:
        np.testing.assert_array_equal(got[r.rid], want[r.rid])
    assert chunked.stats["chunks"] > 0 and chunked.stats["prefill_s"] == 0
    assert blocking.stats["chunks"] == 0 and blocking.stats["prefill_s"] > 0


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_slot_reuse_never_leaks(paged):
    """A request's tokens do not depend on what held its slot before:
    served alone vs after heavy slot-churning traffic."""
    jc = _params("yi_6b")[0]
    eng = _engine("yi_6b", paged=paged, **DSA)
    probe = _requests(TS, jc.vocab, [(26, 7)], seed=3)[0]
    alone = eng.run([probe])[probe.rid]
    churn = _requests(TS, jc.vocab, [(40, 9), (15, 4), (31, 6), (22, 11),
                                     (9, 2)], seed=4)
    late = dataclasses.replace(probe, rid=99)
    np.testing.assert_array_equal(eng.run(churn + [late])[99], alone)
    eng.warmup([26, 60])                  # dummy traffic, then a reset
    assert eng.stats["admitted"] == 0 and not eng.has_work()
    np.testing.assert_array_equal(eng.run([probe])[probe.rid], alone)


def test_idle_steps_are_skipped_and_chunks_step_one_at_a_time():
    """A segment runs only the steps in which some slot decodes, and
    ``step_prefill(max_chunks=1)`` runs one chunk of an admission group;
    the tokens stay those of a plain drain."""
    jc = _params("yi_6b")[0]
    reqs = _requests(TS, jc.vocab, [(40, 3), (36, 2)], seed=5)
    want = _engine("yi_6b", **DSA).run(reqs)
    eng = _engine("yi_6b", chunk_tokens=16, **DSA)
    for r in reqs:
        eng.submit(r)
    sink = []
    eng.admit_ready(lambda: 0.0, sink)
    for j in range(1, 4):             # prompts of 40 and 36: three chunks
        eng.step_prefill(lambda: 0.0, sink, max_chunks=1)
        assert eng.stats["chunks"] == j
    assert eng._pf is None and eng.stats["decode_steps"] == 0
    eng.run_segment(lambda: 0.0, sink)
    # 2 and 1 tokens left after the first: 2 of the segment's 4 steps run
    assert eng.stats["segments"] == 1 and eng.stats["decode_steps"] == 2
    assert not eng.has_work()
    for r in sink:
        np.testing.assert_array_equal(r.tokens, want[r.rid])


def test_static_batch_server_serves_solo_tokens():
    """The static baseline batches requests in arrival order, right-pads
    them and decodes each row at its own depth: every request gets its
    solo greedy tokens and its TTFT is the whole batch's latency."""
    jc, _, tc, tparams = _params("yi_6b")
    reqs = _requests(TS, jc.vocab, [(20, 6), (33, 9), (12, 4)], seed=9)
    eng = TE.Engine(tc, tparams, max_len=MAX_LEN, device="cpu", **DSA)
    res = TS.StaticBatchServer(eng, 2).serve(reqs)
    want = _solo("yi_6b", reqs, **DSA)
    for r in res:
        np.testing.assert_array_equal(r.tokens, want[r.rid])
        assert r.first_token_s == r.finish_s


def test_pool_gets_every_page_back():
    """Through a pool too small for every slot at max_len (admission then
    waits for pages), every page comes back and nothing is held."""
    jc = _params("yi_6b")[0]
    eng = _engine("yi_6b", paged=True, pool_pages=9, **DSA)
    assert eng.pool.available() == 8
    reqs = _requests(TS, jc.vocab, DSA_SHAPES + [(70, 20), (5, 3)], seed=8)
    got = eng.run(reqs)
    assert set(got) == {r.rid for r in reqs}
    assert eng.pool.available() == 8 and not eng.pool.slot_pages
    assert not eng.pool.ref.any()
    want = _engine("yi_6b", **DSA).run(reqs)
    for r in reqs:
        np.testing.assert_array_equal(got[r.rid], want[r.rid])


def test_submit_validates_and_refuses_unported_options():
    jc = _params("yi_6b")[0]
    eng = _engine("yi_6b", paged=True, **DSA)
    prompt = np.ones((10,), np.int32)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(TS.Request(0, prompt, MAX_LEN))
    with pytest.raises(ValueError, match="empty"):
        eng.submit(TS.Request(0, prompt[:0], 2))
    with pytest.raises(ValueError, match="temperature"):
        eng.submit(TS.Request(0, prompt, 2, temperature=0.0))
    with pytest.raises(ValueError, match="prefix_len"):
        eng.submit(TS.Request(0, prompt, 2, prefix_len=11))
    # deadlines are ported: a request may carry one
    eng.submit(TS.Request(5, prompt, 2, deadline_s=1.0))
    assert eng.cancel(5) and eng._pending[-1].status == "cancelled"
    # a mode override needs the DSA caches of a long_context engine
    with pytest.raises(ValueError, match="dsa_mode"):
        _engine("stablelm_3b").submit(TS.Request(0, prompt, 2,
                                                 dsa_mode="block"))
    eng.submit(TS.Request(0, prompt, 2, dsa_mode="kernel"))
    with pytest.raises(ValueError, match="in flight"):
        eng.submit(TS.Request(0, prompt, 2))
    with pytest.raises(ValueError, match="dsa_mode"):
        TS.Request(1, prompt, 2, dsa_mode="dense")
    assert eng.cancel(0) and not eng.cancel(0)
    assert not eng.cancel(99)
    _, _, tc, tparams = _params("yi_6b")
    # the lifecycle fields and MoE prefill are ported and validated (a
    # bad moe_prefill raises ValueError, as the reference's
    # tests/test_quant_serving.py holds); so are the mesh fields, whose
    # values must be a DeviceMesh and ShardingRules
    for field, bad in (("queue_cap", 0), ("shed_policy", "drop-newest"),
                       ("admit_retries", -1), ("moe_prefill", "sparse")):
        with pytest.raises(ValueError, match=field):
            TS.ContinuousEngine(tc, tparams, device="cpu", **{field: bad})
    for field in ("mesh", "shard_rules"):
        with pytest.raises(TypeError, match=field):
            TS.ContinuousEngine(tc, tparams, device="cpu", **{field: 1})
    # a dense arch accepts either MoE prefill and is left as it was
    for mp in ("capacity", "dense"):
        ce = TS.ContinuousEngine(tc, tparams, device="cpu", moe_prefill=mp)
        assert ce.engine.config.moe_prefill == mp
        assert not ce.engine.moe_dense and ce.chunked
    ce = TS.ContinuousEngine(tc, tparams, device="cpu", deadline_s=2.0,
                             queue_cap=3, shed_policy="oldest")
    assert (ce.deadline_s, ce.queue_cap, ce.shed_policy,
            ce.admit_retries, ce.injector, ce.telemetry) == (
        2.0, 3, "oldest", 8, None, None)
    # speculation is ported (tests/test_torch_spec.py)
    assert TS.ContinuousEngine(tc, tparams, device="cpu", spec=1).spec == 1
    # kv_quant is ported: a value outside KV_QUANT_DTYPES is refused
    with pytest.raises(ValueError, match="kv_quant"):
        TS.ContinuousEngine(tc, tparams, device="cpu", kv_quant=1)
    assert jc.name == tc.name


def test_sampling_at_temperature_one_is_unchanged():
    """temperature=1.0 gives the tokens of the sampling before it was a
    parameter, (logits + gumbel).argmax, draw for draw."""
    gen_a = torch.Generator().manual_seed(11)
    gen_b = torch.Generator().manual_seed(11)
    for _ in range(5):
        logits = torch.randn((3, 50))
        got = TE._sample(logits, gen_a, False, 1.0)
        u = torch.rand(logits.shape, generator=gen_b)
        want = (logits.float() - torch.log(-torch.log(u))).argmax(
            -1, keepdim=True)
        assert torch.equal(got, want)
    _, _, tc, tparams = _params("yi_6b")
    eng = TE.Engine(tc, tparams, max_len=MAX_LEN, device="cpu", **DSA)
    prompts = np.random.default_rng(1).integers(1, 500, size=(2, 24))
    base = eng.generate(prompts, 6, greedy=False, seed=3).tokens
    one = eng.generate(prompts, 6, greedy=False, seed=3,
                       temperature=1.0).tokens
    np.testing.assert_array_equal(base, one)


def test_continuous_cli_runs_on_cpu(capsys):
    results, eng = serve.main([
        "--arch", "yi_6b", "--reduced", "--continuous", "--paged", "--dsa",
        "--dsa-mode", "kernel", "--requests", "6", "--slots", "2",
        "--prompt-len", "64", "--new-tokens", "8", "--rate", "1000",
        "--device", "cpu"])
    out = capsys.readouterr().out
    assert "continuous: 6 requests" in out and "chunk steps" in out
    assert all(r.status == "ok" and len(r.tokens) == r.n_new
               for r in results)
    assert eng.pool.available() == eng.pool_pages - 1
