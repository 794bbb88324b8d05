"""The port's serving telemetry (inference/telemetry.py) on the CPU, at the
reference's reduced fixtures.

Every test of ``tests/test_telemetry.py`` is mirrored against the port:
``telemetry=None`` is the default and a fully traced engine (probe every
segment) gives its tokens bit for bit; request spans and engine events
export as Chrome trace JSON; the Prometheus text agrees with
``summarize()`` and ``health()``; ``reset()`` zeroes the registry and
keeps the compile log; the compile events pin the recompilation
contract (on the CPU every program runs eagerly and each new shape
signature is one compile event; on the card the graphed programs record
their captures instead, tests/test_torch_cuda.py); the sparsity probe
reports keep rates in (0, 1].

Against the reference: the registry writes the same Prometheus text for
the same observations, the port's metric names are the reference's, and
on the same workload and weights the port's probe samples the
reference's keep rates, churn and layer overlap.  The probe leaves every
leaf of the resident cache bitwise as it found it.
"""
import functools
import json
from collections import Counter as TallyCounter

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.inference import scheduler as JS
from repro.inference import telemetry as JT
from repro.models.transformer import init_model as jinit_model
from repro_torch import convert
from repro_torch.configs.base import get_config, reduced
from repro_torch.core.quantization import raw
from repro_torch.inference import engine as TE
from repro_torch.inference import scheduler as TS
from repro_torch.inference.config import ServingConfig
from repro_torch.inference.telemetry import (MetricsRegistry, Telemetry,
                                             _signature)
from repro_torch.launch import serve

torch.set_num_threads(1)

MAX_LEN = 96
KW = dict(slots=2, max_len=MAX_LEN, seg_len=4)
SHAPES = [(20, 5), (40, 6), (25, 3), (33, 8), (18, 2)]
DSA = dict(long_context=True, dsa_mode="block")


@functools.lru_cache(maxsize=None)
def _params(arch: str):
    jc = jreduced(jget_config(arch))
    jparams, _ = jinit_model(jax.random.PRNGKey(0), jc)
    tparams = convert.from_reference(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jc, jparams, reduced(get_config(arch)), tparams


def _engine(arch, **kw):
    _, _, tc, tparams = _params(arch)
    return TS.ContinuousEngine(tc, tparams, device="cpu", **{**KW, **kw})


def _mk_requests(mod, vocab, shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid, rng.integers(1, vocab - 4, size=(n,)).astype(
        np.int32), n_new, greedy=True, seed=rid * 7 + 1)
        for rid, (n, n_new) in enumerate(shapes)]


def _vocab(arch="stablelm_3b"):
    return _params(arch)[2].vocab


# -- metrics registry / prometheus ---------------------------------------------


@pytest.mark.parametrize("mod", ["port", "reference"])
def test_registry_prometheus_exposition(mod):
    """The port's registry, and its text equal to the reference's for the
    same observations."""
    regs = {"port": MetricsRegistry(), "reference": JT.MetricsRegistry()}
    for m in regs.values():
        m.counter("reqs_total", status="ok").inc(3)
        m.counter("reqs_total", status="failed").inc()
        m.gauge("queue_depth").set(7)
        h = m.histogram("lat_seconds", bounds=(0.1, 1.0))
        for v in (0.05, 0.5, 2.0):
            h.observe(v)
    m = regs[mod]
    assert m.value("reqs_total", status="ok") == 3.0
    assert m.value("queue_depth") == 7.0
    assert m.value("lat_seconds") == (3, pytest.approx(2.55 / 3))
    assert m.value("never_touched") == 0.0
    text = m.to_prometheus()
    assert text == regs["reference"].to_prometheus()
    assert "# TYPE reqs_total counter" in text
    assert 'reqs_total{status="ok"} 3.0' in text
    assert "# TYPE lat_seconds histogram" in text
    assert 'lat_seconds_bucket{le="0.1"} 1' in text
    assert 'lat_seconds_bucket{le="1.0"} 2' in text
    assert 'lat_seconds_bucket{le="+Inf"} 3' in text
    assert "lat_seconds_count 3" in text
    m.reset()
    assert m.to_prometheus().strip() == ""


def test_compile_watch_signature_and_passthrough():
    """``note`` records one compile event per new (program, signature):
    a repeat is no event, a new shape, dtype or static argument is one,
    and another program keeps its own signatures."""
    tel = Telemetry()
    a32 = np.zeros((2, 3), np.int32)
    tel.note("prog", a32, flag=True)
    tel.note("prog", a32, flag=True)
    assert tel.compile_count("prog") == 1
    tel.note("prog", np.zeros((2, 4), np.int32), flag=True)   # new shape
    tel.note("prog", a32.astype(np.float32), flag=True)       # new dtype
    tel.note("prog", a32, flag=False)                         # new static
    assert tel.compile_count("prog") == 4
    tel.note("other", a32, flag=True)
    assert tel.compile_count("other") == 1 and tel.compile_count() == 5
    tel.reset()                                   # the log survives
    tel.note("prog", a32, flag=True)
    assert tel.compile_count() == 5
    assert _signature((a32,), {}) == (((2, 3), "int32"),)
    # torch tensors read like numpy arrays; nested dicts walk in key
    # order; a Python int is a runtime scalar (its value never counts)
    t = torch.zeros((2, 3), dtype=torch.int32)
    assert _signature((t,), {}) == _signature((a32,), {})
    assert (_signature(({"b": t, "a": 3},), {})
            == _signature(({"a": 4, "b": t},), {}) == ("int", ((2, 3),
                                                               "int32")))


def test_capture_is_a_compile_event():
    tel = Telemetry()
    tel.on_capture("segment", (2, "paged", None), 12.5, 4096)
    assert tel.compile_count("segment") == 1
    ev = [e for e in tel.events if e["name"] == "compile[segment]"][0]
    assert ev["args"]["capture_ms"] == 12.5
    assert ev["args"]["pool_bytes"] == 4096
    assert tel.metrics.value("serving_compiles_total",
                             program="segment") == 1.0


# -- bitwise inertness + end-to-end spans/trace --------------------------------


def test_telemetry_none_is_default_and_bitwise_inert():
    assert ServingConfig().telemetry is None
    plain = _engine("yi_6b", **DSA)
    tel = Telemetry(sample_every=1)
    traced = _engine("yi_6b", telemetry=tel, **DSA)
    got_p = plain.run(_mk_requests(TS, _vocab("yi_6b"), SHAPES))
    got_t = traced.run(_mk_requests(TS, _vocab("yi_6b"), SHAPES))
    for rid in got_p:
        np.testing.assert_array_equal(got_p[rid], got_t[rid],
                                      err_msg=f"rid {rid}")
    assert tel.compile_count() > 0 and len(tel.events) > 0
    assert traced.stats["probe_steps"] > 0


def test_chrome_trace_structure_and_prometheus_consistency():
    tel = Telemetry(sample_every=0)
    ce = _engine("stablelm_3b", telemetry=tel)
    reqs = _mk_requests(TS, _vocab(), SHAPES)
    results = ce.serve(reqs)
    s = TS.summarize(results, max(r.finish_s for r in results))

    trace = tel.chrome_trace()
    evs = trace["traceEvents"]
    assert json.loads(json.dumps(trace)) == trace
    names = [e["name"] for e in evs]
    by_rid = {r.rid: r for r in results}
    for r in reqs:
        span = [e for e in evs if e["name"] == f"req {r.rid} [ok]"]
        assert len(span) == 1 and span[0]["ph"] == "X"
        assert span[0]["pid"] == "requests"
        assert span[0]["tid"] == f"rid {r.rid}"
        assert span[0]["args"]["tokens"] == len(by_rid[r.rid].tokens)
        assert span[0]["dur"] >= 0
    assert names.count("submit") == len(reqs)
    assert names.count("first_token") == len(reqs)
    assert any(e["name"] == "decode_segment" and e["ph"] == "X"
               for e in evs)
    assert any(n.startswith("chunk_burst") for n in names)
    assert any(n.startswith("admit[") for n in names)
    assert any(n.startswith("compile[") for n in names)
    assert any(e["ph"] == "M" and e["name"] == "process_name"
               for e in evs)
    assert all(e["ts"] >= 0 for e in evs if e["ph"] != "M")

    text = tel.prometheus_text()
    assert (tel.metrics.value("serving_requests_total", status="ok")
            == s["n_ok"] == len(reqs))
    assert (tel.metrics.value("serving_tokens_delivered_total")
            == s["delivered_tokens"])
    n_ttft, _ = tel.metrics.value("serving_ttft_seconds")
    assert n_ttft == len(reqs)
    h = ce.health()
    assert f'serving_health_segments {float(h["segments"])}' in text
    assert f'serving_health_failed {float(h["failed"])}' in text
    assert 'serving_requests_total{status="ok"} 5.0' in text


def test_engine_reset_resets_registry_keeps_compile_log():
    tel = Telemetry(sample_every=0)
    ce = _engine("stablelm_3b", telemetry=tel)
    ce.run(_mk_requests(TS, _vocab(), SHAPES))
    assert tel.metrics.value("serving_requests_total", status="ok") == 5.0
    n_compiles = tel.compile_count()
    assert n_compiles > 0
    ce.reset()
    h = ce.health()
    assert h["resident"] == 0 and h["segments"] == 0 and h["failed"] == 0
    assert tel.metrics.value("serving_requests_total", status="ok") == 0.0
    assert len(tel.events) == 0
    assert tel.compile_count() == n_compiles
    ce.run(_mk_requests(TS, _vocab(), SHAPES[:2], seed=9))
    assert tel.metrics.value("serving_requests_total", status="ok") == 2.0


def test_telemetry_none_engines_free_by_refcount():
    """With telemetry=None no engine refers to itself (no bound method
    stored on the instance), so dropping the last reference frees its
    resident caches at once, without the cyclic garbage collector (on the
    card a collection inside another engine's graph capture would reset a
    dead engine's graph there)."""
    import gc
    import weakref
    _, _, tc, tparams = _params("yi_6b")
    gc.disable()
    try:
        for make in (lambda: TE.Engine(tc, tparams, max_len=MAX_LEN,
                                       device="cpu", **DSA),
                     lambda: _engine("yi_6b", paged=True, spec=0, **DSA)):
            eng = make()
            ref = weakref.ref(eng)
            del eng
            assert ref() is None
    finally:
        gc.enable()


def test_traced_engines_free_by_refcount():
    """With a Telemetry an engine still refers to nothing that refers
    back to it: the programs record their signatures at the call site
    and ``bind_engine`` holds a weak reference, so a traced engine that
    has served is freed by its refcount while its Telemetry lives on (and
    exports on, its health gauges at their last values)."""
    import gc
    import weakref
    _, _, tc, tparams = _params("yi_6b")
    tel = Telemetry(sample_every=1)
    gc.disable()
    try:
        static = TE.Engine(tc, tparams, max_len=MAX_LEN, device="cpu",
                           telemetry=tel, **DSA)
        static.generate(np.ones((1, 20), np.int32), 3)
        ref = weakref.ref(static)
        del static
        assert ref() is None
        ce = _engine("yi_6b", paged=True, telemetry=tel, **DSA)
        ce.run(_mk_requests(TS, _vocab("yi_6b"), SHAPES[:2]))
        assert "serving_health_segments" in tel.prometheus_text()
        segments = ce.health()["segments"]
        ref = weakref.ref(ce)
        del ce
        assert ref() is None
    finally:
        gc.enable()
    assert tel.compile_count("segment") == 1
    text = tel.prometheus_text()
    assert f'serving_health_segments {float(segments)}' in text


# -- the recompilation contract, live ------------------------------------------


@pytest.mark.parametrize("variant", ["dense", "paged", "quant", "spec"])
def test_recompilation_contract(variant):
    """``warmup`` over two prompt buckets records one chunk and one insert
    program per (bucket, group width in {1, slots}) and ONE decode
    segment (a speculative engine one verify, one commit and no
    segment); mixed traffic afterwards records no new one
    (``zero_pages``/``seed`` are bounded by their id counts, not fixed,
    so they are left out, as in the reference)."""
    kw = {"paged": dict(paged=True), "quant": dict(kv_quant="int8"),
          "spec": dict(spec=3), "dense": {}}[variant]
    tel = Telemetry(sample_every=0)
    ce = _engine("stablelm_3b", telemetry=tel, **kw)
    ce.warmup([20, 40])
    tally = TallyCounter(p for p, _, _ in tel.compiles)
    insert = "insert_paged" if variant == "paged" else "insert"
    assert tally["chunk"] == 4
    assert tally[insert] == 4
    if variant == "spec":
        assert tally["verify"] == 1 and tally["commit"] == 1
        assert tally["segment"] == 0
    else:
        assert tally["segment"] == 1 and tally["verify"] == 0
    after_warmup = tel.compile_count()
    ce.run(_mk_requests(TS, _vocab(), SHAPES, seed=3))
    fresh = [p for p, _, _ in tel.compiles[after_warmup:]
             if p not in ("zero_pages", "seed")]
    assert fresh == [], f"{variant}: unexpected compiles {fresh}"


def test_static_engine_programs_are_watched():
    """The static engine's programs: one prefill per bucket, the scan
    loop's step (decode_loop) and the python loop's (decode) once per
    batch, verify and commit once per (batch, K)."""
    _, _, tc, tparams = _params("stablelm_3b")
    tel = Telemetry()
    eng = TE.Engine(tc, tparams, max_len=MAX_LEN, device="cpu",
                    telemetry=tel)
    prompts = np.random.default_rng(0).integers(
        1, tc.vocab - 4, size=(2, 20)).astype(np.int32)
    for _ in range(2):
        eng.generate(prompts, 5)
        eng.generate(prompts, 5, spec=2)
    eng.loop = "python"
    eng.generate(prompts, 5)
    tally = TallyCounter(p for p, _, _ in tel.compiles)
    assert tally == {"prefill": 1, "decode_loop": 1, "decode": 1,
                     "verify": 1, "commit": 1}
    # telemetry=None stores nothing on the engines but the None
    import inspect
    for bare in (TE.Engine(tc, tparams, max_len=MAX_LEN, device="cpu"),
                 _engine("stablelm_3b")):
        assert bare.telemetry is None
        assert not any(inspect.ismethod(v) or isinstance(v, Telemetry)
                       for v in vars(bare).values())


# -- dynamic-sparsity observability --------------------------------------------


def test_sparsity_probe_samples_keep_rate():
    tel = Telemetry(sample_every=1)
    ce = _engine("yi_6b", telemetry=tel, **DSA)
    ce.run(_mk_requests(TS, _vocab("yi_6b"), SHAPES))
    n, mean_keep = tel.metrics.value("serving_dsa_keep_rate")
    assert n >= 1 and 0.0 < mean_keep <= 1.0
    samples = [e for e in tel.events if e["name"] == "dsa_sample"]
    assert samples and all(
        0.0 < e["args"]["mean_keep_rate"] <= 1.0 for e in samples)
    assert tel.compile_count("probe") == 1
    tel2 = Telemetry(sample_every=0)
    ce2 = _engine("yi_6b", telemetry=tel2, **DSA)
    ce2.run(_mk_requests(TS, _vocab("yi_6b"), SHAPES[:2]))
    assert tel2.compile_count("probe") == 0
    assert tel2.metrics.value("serving_dsa_keep_rate") in (0.0, (0, 0.0))
    assert ce2.stats["probe_steps"] == 0


def _leaves(caches):
    return [(f"{gi}/{name}/{k}", raw(t)) for gi, grp in
            enumerate(caches["groups"]) for name, sub in grp.items()
            for k, t in sub["attn"].items()]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("quant", [None, "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("mode", ["block", "kernel"])
def test_probe_leaves_the_resident_cache_bitwise(paged, quant, mode):
    """A probe step writes the resident cache in place; every leaf is
    bitwise what it was after it, with slots live (one of them inactive
    with a stale position), and the next segment's tokens are those of an
    engine that never probed."""
    kw = dict(long_context=True, dsa_mode=mode, paged=paged)
    if quant:
        kw.update(kv_quant=quant, select_dtype=quant)
    tel = Telemetry(sample_every=0)
    ce = _engine("yi_6b", telemetry=tel, **kw)
    ref = _engine("yi_6b", **kw)
    reqs = _mk_requests(TS, _vocab("yi_6b"), [(40, 12), (21, 3)])
    sink, clock = [], lambda: 0.0
    for eng in (ce, ref):
        for r in _mk_requests(TS, _vocab("yi_6b"), [(40, 12), (21, 3)]):
            eng.submit(r)
        while not all(s is not None for s in eng._slot):
            eng.admit_ready(clock, sink)
            eng.step_prefill(clock, sink)
        eng.run_segment(clock, sink)          # rid 1 retires: stale slot
    assert ce._active.tolist() == [True, False]
    before = [(k, t.clone()) for k, t in _leaves(ce._caches)]
    ce._sparsity_probe(mode)
    assert ce.stats["probe_steps"] == 1
    assert tel.metrics.value("serving_dsa_keep_rate")[0] == 1
    after = dict(_leaves(ce._caches))
    assert set(after) == {k for k, _ in before}
    for k, t in before:
        assert torch.equal(t, after[k]), k
    got = ce.run([])
    want = ref.run([])
    assert got.keys() == want.keys() == {0}
    np.testing.assert_array_equal(got[0], want[0])
    assert reqs[0].rid == 0


def test_probe_samples_equal_reference():
    """On the same workload, weights and segment schedule, past the local
    window (prompts of ~200 tokens at max_len 320, where selection is
    sparse), the port's probe records the reference's keep rates, churn
    and layer overlap."""
    jc, jparams, tc, tparams = _params("yi_6b")
    kw = dict(slots=2, max_len=320, seg_len=4, long_context=True,
              dsa_mode="block")
    shapes = [(200, 14), (230, 10), (180, 9)]
    jtel, ttel = JT.Telemetry(sample_every=1), Telemetry(sample_every=1)
    JS.ContinuousEngine(jc, jparams, telemetry=jtel, **kw).run(
        _mk_requests(JS, jc.vocab, shapes))
    TS.ContinuousEngine(tc, tparams, device="cpu", telemetry=ttel,
                        **kw).run(_mk_requests(TS, tc.vocab, shapes))
    for name in ("serving_dsa_keep_rate", "serving_dsa_block_churn",
                 "serving_dsa_layer_overlap"):
        jn, jm = jtel.metrics.value(name)
        tn, tm = ttel.metrics.value(name)
        assert tn == jn and tm == pytest.approx(jm, abs=1e-12), name
    kn, keep = ttel.metrics.value("serving_dsa_keep_rate")
    assert kn > 0 and 0.0 < keep < 1.0        # sparse: not every block
    assert (ttel.metrics.value("serving_sparsity_samples_total")
            == jtel.metrics.value("serving_sparsity_samples_total"))


def test_metric_names_equal_reference():
    """The same run of both packages' engines registers the same metric
    names and labels: a dashboard built on the reference's Prometheus
    text reads the port's."""
    jc, jparams, tc, tparams = _params("stablelm_3b")
    jtel, ttel = JT.Telemetry(sample_every=0), Telemetry(sample_every=0)
    jce = JS.ContinuousEngine(jc, jparams, telemetry=jtel, paged=True,
                              **KW)
    tce = TS.ContinuousEngine(tc, tparams, device="cpu", telemetry=ttel,
                              paged=True, **KW)
    jce.run(_mk_requests(JS, jc.vocab, SHAPES))
    tce.run(_mk_requests(TS, tc.vocab, SHAPES))

    def series(text):
        return {line.split(" ")[0] for line in text.splitlines()
                if line and not line.startswith("#")}

    jt, tt = series(jtel.prometheus_text()), series(ttel.prometheus_text())
    # the compile counters name each package's own programs
    drop = lambda s: {x for x in s if not x.startswith(
        "serving_compiles_total")}
    assert drop(tt) == drop(jt)


def test_serve_writes_trace_and_metrics(tmp_path, capsys):
    trace, prom = tmp_path / "t.json", tmp_path / "m.prom"
    results, eng = serve.main([
        "--arch", "yi_6b", "--reduced", "--continuous", "--paged", "--dsa",
        "--dsa-mode", "kernel", "--requests", "4", "--slots", "2",
        "--prompt-len", "48", "--new-tokens", "24", "--seg-len", "4",
        "--rate", "1e9", "--deadline", "1e6", "--queue-cap", "8",
        "--shed-policy", "oldest", "--trace-out", str(trace),
        "--metrics-out", str(prom), "--telemetry-sample", "1",
        "--device", "cpu"])
    out = capsys.readouterr().out
    assert "lifecycle : 4 ok" in out and "SLO attainment 100%" in out
    assert f"-> {trace}" in out and f"-> {prom}" in out
    assert "sparsity  :" in out and "compiles  :" in out
    assert json.loads(trace.read_text())["traceEvents"]
    text = prom.read_text()
    assert 'serving_requests_total{status="ok"} 4.0' in text
    assert eng.stats["probe_steps"] > 0
    assert all(r.status == "ok" and r.deadline_s == 1e6 for r in results)
