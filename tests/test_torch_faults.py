"""The port's request lifecycle and fault injection (inference/faults.py,
inference/scheduler.py), on the CPU at the reference's reduced fixtures
(max_len 96, 2 slots, segments of 4).

Every test of ``tests/test_faults.py`` is mirrored against the port (its
sharded NaN test in tests/test_torch_multidevice.py): each injected fault class
(NaN logits row, page-pool exhaustion, proposer crash, slow segment,
dispatch failure), a segment that raises, deadlines, cancellation and
load shedding leave the surviving requests bitwise token-exact against a
fault-free run, leak no slot or page and surface typed statuses; with no
injector the engine gives solo ``Engine.generate``'s tokens.

Against the reference: the same requests and the same ``Fault`` schedule
go through both packages' ``ContinuousEngine`` (weights carried by
``convert.py``), and the statuses, the tokens and the Prometheus
per-status counters and delivered-token counter agree.  Timings are not
compared.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.inference import faults as JF
from repro.inference import scheduler as JS
from repro.inference import telemetry as JT
from repro.models.transformer import init_model as jinit_model
from repro_torch import convert
from repro_torch.configs.base import get_config, reduced
from repro_torch.inference import engine as TE
from repro_torch.inference import faults as TF
from repro_torch.inference import scheduler as TS
from repro_torch.inference import telemetry as TT
from repro_torch.inference.config import ServingConfig

torch.set_num_threads(1)

MAX_LEN = 96
KW = dict(slots=2, max_len=MAX_LEN, seg_len=4)


@functools.lru_cache(maxsize=None)
def _params(arch: str):
    jc = jreduced(jget_config(arch))
    jparams, _ = jinit_model(jax.random.PRNGKey(0), jc)
    tparams = convert.from_reference(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jc, jparams, reduced(get_config(arch)), tparams


def _engine(arch="stablelm_3b", **kw):
    _, _, tc, tparams = _params(arch)
    return TS.ContinuousEngine(tc, tparams, device="cpu", **{**KW, **kw})


@functools.lru_cache(maxsize=None)
def _shared(kind: str):
    """Module-wide engines, as the reference's fixtures: a dense and a
    paged stablelm_3b engine."""
    return _engine(paged=kind == "paged")


def _ref(arch="stablelm_3b"):
    _, _, tc, tparams = _params(arch)
    return TE.Engine(tc, tparams, max_len=MAX_LEN, device="cpu")


def _mk(mod, vocab, shapes, seed=0, **kw):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid, rng.integers(1, vocab - 4, size=(n,)).astype(
        np.int32), n_new, seed=rid * 7 + 1, **kw)
        for rid, (n, n_new) in enumerate(shapes)]


def _vocab():
    return _params("stablelm_3b")[2].vocab


def _drive(ce, results, clock, max_steps=500):
    """The body of ``run`` with a clock of the caller's, flushing
    ``_pending`` at the end."""
    steps = 0
    while ce.has_work():
        assert steps < max_steps, "scheduler failed to drain"
        steps += 1
        ce.admit_ready(clock, results)
        ce.step_prefill(clock, results)
        if any(s is not None for s in ce._slot):
            ce._step_decode(clock, results)
    results.extend(ce._pending)
    ce._pending.clear()


def _assert_clean(ce):
    """No slot, reservation, group or page survives a drained engine."""
    assert all(s is None for s in ce._slot)
    assert not ce._reserved and ce._pf is None
    assert not ce._live and not ce.queue
    if ce.paged:
        assert ce.pool.available() == ce.pool_pages - 1


def _solo(ref, r):
    return ref.generate(r.prompt[None], r.n_new, greedy=r.greedy,
                        seed=r.seed).tokens[0]


# -- fault point 1: NaN logits row ---------------------------------------------


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_nan_row_fails_only_poisoned_slot(kind):
    """A NaN logits row fails only the poisoned request (its tokens a
    strict prefix of its fault-free run) while every co-resident and
    later request stays bitwise exact, dense and paged."""
    ce = _shared(kind)
    shapes = [(24, 10), (26, 12), (12, 6)]     # rid 0+1 co-resident
    ce.reset()
    base = ce.run(_mk(TS, _vocab(), shapes))
    ce.reset()
    inj = TF.FaultInjector(TF.Fault("nan_logits", rid=1, after=1))
    ce.injector = inj
    try:
        got = ce.run(_mk(TS, _vocab(), shapes))
    finally:
        ce.injector = None
    assert inj.fired == [("nan_logits", 1)]
    assert ce.stats["failed"] == 1
    assert 0 < len(got[1]) < len(base[1])
    np.testing.assert_array_equal(got[1], base[1][:len(got[1])])
    for rid in (0, 2):
        np.testing.assert_array_equal(got[rid], base[rid], err_msg=f"{rid}")
    assert "non-finite" in ce.health()["last_error"]
    _assert_clean(ce)


def test_no_injector_is_bitwise_inert():
    """With no injector the lifecycle machinery (the finiteness flag, the
    watchdog, the reaper) changes no token: solo generate's tokens."""
    ce, ref = _shared("dense"), _ref()
    ce.reset()
    assert ce.injector is None
    reqs = _mk(TS, _vocab(), [(20, 5), (33, 9), (7, 1), (18, 8)])
    got = ce.run(reqs)
    for r in reqs:
        np.testing.assert_array_equal(got[r.rid], _solo(ref, r),
                                      err_msg=f"{r.rid}")
    _assert_clean(ce)


def test_real_nonfinite_logits_fail_their_slot():
    """``fin`` watches every step's logits, not only injected NaNs: a
    step whose logits row goes infinite for one slot fails that slot and
    leaves the other bitwise exact."""
    ce = _shared("dense")
    shapes = [(24, 10), (26, 12)]
    ce.reset()
    base = ce.run(_mk(TS, _vocab(), shapes))
    ce.reset()
    orig = ce._segment_step

    def step_for(mode=None):
        step = orig(mode)

        def bad(tok, mask):
            lg = step(tok, mask).clone()
            lg[1] = float("inf")
            return lg
        return bad

    ce._segment_step = step_for
    try:
        got = ce.run(_mk(TS, _vocab(), shapes))
    finally:
        del ce._segment_step
    assert ce.stats["failed"] == 1 and len(got[1]) == 1
    np.testing.assert_array_equal(got[0], base[0])
    _assert_clean(ce)


# -- fault point 2: page-pool exhaustion ---------------------------------------


def test_pool_exhaust_transient_waits_then_serves_exact():
    ce = _shared("paged")
    shapes = [(24, 8), (26, 6), (12, 5)]
    ce.reset()
    base = ce.run(_mk(TS, _vocab(), shapes))
    ce.reset()
    inj = TF.FaultInjector(TF.Fault("pool_exhaust", count=3))
    ce.injector = inj
    try:
        got = ce.run(_mk(TS, _vocab(), shapes))
    finally:
        ce.injector = None
    assert len(inj.fired) == 3
    assert ce.stats["shed"] == 0
    for rid in got:
        np.testing.assert_array_equal(got[rid], base[rid])
    _assert_clean(ce)


def test_unfundable_anchor_sheds_after_bounded_retries():
    """An anchor that stays unfundable on an otherwise idle engine is
    shed after ``admit_retries`` attempts instead of waiting forever."""
    ce = _engine(paged=True, admit_retries=3)
    ce.injector = TF.FaultInjector(TF.Fault("pool_exhaust", count=100))
    got = ce.run(_mk(TS, _vocab(), [(20, 6)]))
    ce.injector = None
    assert ce.stats["shed"] == 1
    assert got[0].size == 0
    assert len(ce._unfundable) == 0
    _assert_clean(ce)


# -- fault point 3: proposer crash ---------------------------------------------


def test_proposer_crash_degrades_to_plain_bitwise():
    """A crashing proposer costs speed only: the segments fall back to
    plain ones, three failures trip ``spec_degraded``, and every request
    gets the plain engine's tokens."""
    plain = _engine()
    spec = _engine(spec=3)
    assert spec.spec == 3
    shapes = [(24, 10), (26, 12), (12, 6)]
    base = plain.run(_mk(TS, _vocab(), shapes))
    spec.injector = TF.FaultInjector(TF.Fault("proposer", count=100))
    got = spec.run(_mk(TS, _vocab(), shapes))
    spec.injector = None
    assert spec.stats["proposer_failures"] >= 3
    h = spec.health()
    assert h["spec_degraded"] and h["proposer_failures"] >= 3
    assert "proposer" in h["last_error"]
    for rid in base:
        np.testing.assert_array_equal(got[rid], base[rid], err_msg=f"{rid}")
    _assert_clean(spec)


# -- fault point 4: slow segment (watchdog) ------------------------------------


def test_watchdog_flags_injected_slow_segment():
    ce, ref = _shared("dense"), _ref()
    ce.reset()
    inj = TF.FaultInjector(TF.Fault("slow_segment", after=7, delay_s=0.75))
    ce.injector = inj
    try:
        got = ce.run(_mk(TS, _vocab(), [(20, 41)]))   # 10 decode segments
    finally:
        ce.injector = None
    assert len(inj.fired) == 1
    h = ce.health()
    assert h["watchdog_slow"] >= 1 and h["slow_segments"] >= 1
    assert h["median_segment_s"] > 0.0
    r = _mk(TS, _vocab(), [(20, 41)])[0]
    np.testing.assert_array_equal(got[0], _solo(ref, r))
    _assert_clean(ce)


# -- fault point 5: dispatch failure -------------------------------------------


def test_dispatch_transient_retries_exact():
    ce, ref = _shared("dense"), _ref()
    ce.reset()
    reqs = _mk(TS, _vocab(), [(20, 6), (33, 8)])
    inj = TF.FaultInjector(TF.Fault("dispatch", count=2))
    ce.injector = inj
    try:
        got = ce.run(reqs)
    finally:
        ce.injector = None
    assert len(inj.fired) == 2
    assert ce.stats["dispatch_failures"] == 2
    for r in reqs:
        np.testing.assert_array_equal(got[r.rid], _solo(ref, r))
    _assert_clean(ce)


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_segment_exception_scrubs_batch_and_recovers(kind):
    """A segment that raises fails every in-flight request with its
    pre-segment tokens, rebuilds the resident cache (and pool) and keeps
    serving the queue: the next request is bitwise exact."""
    ce, ref = _shared(kind), _ref()
    ce.reset()
    orig, state = ce._segment_step, {"raised": False}

    def boom(mode=None):
        if not state["raised"]:
            state["raised"] = True
            raise RuntimeError("injected device failure")
        return orig(mode)

    reqs = _mk(TS, _vocab(), [(24, 8), (26, 6), (12, 5)])
    results = []
    ce._segment_step = boom
    old = ce._caches
    try:
        for r in reqs:
            ce.submit(r)
        _drive(ce, results, lambda: 0.0)
    finally:
        del ce._segment_step
    assert ce._caches is not old                  # rebuilt
    by = {r.rid: r for r in results}
    assert by[0].status == "failed" and by[1].status == "failed"
    assert ce.health()["dispatch_failures"] >= 1
    assert "injected" in ce.health()["last_error"]
    for rid in (0, 1):
        part = by[rid].tokens
        assert 1 <= len(part) < reqs[rid].n_new
        np.testing.assert_array_equal(part, _solo(ref, reqs[rid])[:len(part)])
    assert by[2].status == "ok"
    np.testing.assert_array_equal(by[2].tokens, _solo(ref, reqs[2]))
    _assert_clean(ce)


# -- lifecycle: cancellation ---------------------------------------------------


def test_cancel_queued_chunking_and_resident():
    ce, ref = _shared("dense"), _ref()
    ce.reset()
    results = []
    clock = lambda: 0.0
    reqs = _mk(TS, _vocab(), [(24, 10), (26, 8), (12, 6)])
    for r in reqs:
        ce.submit(r)
    assert not ce.cancel(99)
    assert ce.cancel(2)                          # still queued
    assert not ce.cancel(2)
    ce.admit_ready(clock, results)               # rid 0+1 start chunking
    assert ce.cancel(1)                          # mid chunked admission
    while not any(s is not None and s.req.rid == 0 for s in ce._slot):
        ce.admit_ready(clock, results)
        ce.step_prefill(clock, results)
    ce._step_decode(clock, results)
    ce._step_decode(clock, results)
    assert ce.cancel(0)
    _drive(ce, results, clock)
    by = {r.rid: r for r in results}
    assert len(results) == 3
    assert {by[i].status for i in (0, 1, 2)} == {"cancelled"}
    assert by[2].tokens.size == 0 and by[1].tokens.size == 0
    exp0 = _solo(ref, reqs[0])
    assert 0 < by[0].tokens.size < reqs[0].n_new
    np.testing.assert_array_equal(by[0].tokens, exp0[:by[0].tokens.size])
    assert ce.stats["cancelled"] == 3
    _assert_clean(ce)


def test_cancel_resident_leaves_coresident_bitwise():
    ce, ref = _shared("dense"), _ref()
    ce.reset()
    results = []
    clock = lambda: 0.0
    reqs = _mk(TS, _vocab(), [(24, 12), (26, 12)])
    for r in reqs:
        ce.submit(r)
    while not all(s is not None for s in ce._slot):
        ce.admit_ready(clock, results)
        ce.step_prefill(clock, results)
    ce._step_decode(clock, results)
    assert ce.cancel(0)
    _drive(ce, results, clock)
    by = {r.rid: r for r in results}
    assert by[1].status == "ok"
    np.testing.assert_array_equal(by[1].tokens, _solo(ref, reqs[1]))
    _assert_clean(ce)


def test_cancel_activated_member_of_chunking_group_is_resident():
    """A member that has activated while its group still chunks is a
    resident request: cancelling it returns its tokens so far, once, and
    frees its slot and pages as a retirement does; the member still
    chunking is untouched."""
    ce = _engine(paged=True, chunk_tokens=16)
    ce_base = _engine(paged=True, chunk_tokens=16)
    shapes = [(36, 12), (60, 6)]                 # one group, 3 vs 4 chunks
    base = ce_base.run(_mk(TS, _vocab(), shapes))
    reqs = _mk(TS, _vocab(), shapes)
    results, clock = [], lambda: 0.0
    for r in reqs:
        ce.submit(r)
    ce.admit_ready(clock, results)
    ce.step_prefill(clock, results, max_chunks=3)   # rid 0 activates
    assert ce._pf is not None and ce._slot[0] is not None
    ce._step_decode(clock, results)
    assert ce.cancel(0)
    _drive(ce, results, clock)
    assert sorted(r.rid for r in results) == [0, 1]
    by = {r.rid: r for r in results}
    assert by[0].status == "cancelled"
    np.testing.assert_array_equal(by[0].tokens,
                                  base[0][:by[0].tokens.size])
    assert 0 < by[0].tokens.size < 12
    assert by[1].status == "ok"
    np.testing.assert_array_equal(by[1].tokens, base[1])
    _assert_clean(ce)


def test_reference_fault_cancel_of_an_activated_member():
    """A reference fault the port does not share: a member of a chunked
    group that has activated (its slot decodes while the group's longer
    prompts still chunk) is still found among the group's members by the
    reference's ``cancel``, which emits it "cancelled" with no tokens
    while its slot keeps decoding and later emits it again, "ok".  The
    port treats it as resident: one result, its tokens so far."""
    jc, jparams, tc, tparams = _params("stablelm_3b")
    kw = dict(KW, slots=3, chunk_tokens=16)
    out = {}
    for S, ce in (("reference", JS.ContinuousEngine(jc, jparams, **kw)),
                  ("port", TS.ContinuousEngine(tc, tparams, device="cpu",
                                               **kw))):
        mod = JS if S == "reference" else TS
        reqs = _mk(mod, _vocab(), [(20, 40), (36, 12), (60, 6)])
        results, clock = [], lambda: 0.0
        ce.submit(reqs[0])
        while ce._slot[0] is None:
            ce.admit_ready(clock, results)
            ce.step_prefill(clock, results)
        ce._step_decode(clock, results)
        ce.submit(reqs[1])
        ce.submit(reqs[2])
        ce.admit_ready(clock, results)        # one group, 3 and 4 chunks
        for _ in range(3):                    # one chunk a burst
            ce.stats["segment_s"] = 0.0
            ce.step_prefill(clock, results)
        assert ce._pf is not None
        assert any(s is not None and s.req.rid == 1 for s in ce._slot)
        assert ce.cancel(1)
        _drive(ce, results, clock)
        out[S] = sorted((r.rid, r.status) for r in results if r.rid == 1)
    assert out["reference"] == [(1, "cancelled"), (1, "ok")]
    assert out["port"] == [(1, "cancelled")]


def test_cancel_drops_an_unfilled_prefix_registration():
    """Cancelling the only member of a prefix-miss group before its
    insert unregisters the prefix (its pages were never written), so a
    later request declaring the same prefix gets the undeclared tokens."""
    ce = _engine("yi_6b", paged=True, long_context=True, dsa_mode="block",
                 chunk_tokens=16)
    vocab = _params("yi_6b")[2].vocab
    rng = np.random.default_rng(3)
    prompt = rng.integers(1, vocab - 4, size=(60,)).astype(np.int32)
    results, clock = [], lambda: 0.0
    ce.submit(TS.Request(0, prompt, 6, prefix_len=48))
    ce.admit_ready(clock, results)
    assert ce.pool.prefixes
    assert ce.cancel(0)
    assert not ce.pool.prefixes
    got = ce.run([TS.Request(1, prompt, 6, prefix_len=48)])
    want = _engine("yi_6b", paged=True, long_context=True,
                   dsa_mode="block", chunk_tokens=16).run(
        [TS.Request(1, prompt, 6)])
    np.testing.assert_array_equal(got[1], want[1])


# -- lifecycle: deadlines ------------------------------------------------------


def test_deadline_expires_mid_decode_at_segment_boundary():
    ce, ref = _shared("dense"), _ref()
    ce.reset()
    t = [0.0]
    clock = lambda: t[0]
    results = []
    reqs = _mk(TS, _vocab(), [(24, 20), (26, 8)])
    reqs[0].deadline_s = 5.0
    for r in reqs:
        ce.submit(r)
    while not any(s is not None and s.req.rid == 0 for s in ce._slot):
        ce.admit_ready(clock, results)
        ce.step_prefill(clock, results)
    ce._step_decode(clock, results)
    ce._step_decode(clock, results)
    t[0] = 10.0
    _drive(ce, results, clock)
    by = {r.rid: r for r in results}
    assert by[0].status == "timeout" and by[0].deadline_s == 5.0
    exp0 = _solo(ref, reqs[0])
    assert 0 < by[0].tokens.size < reqs[0].n_new
    np.testing.assert_array_equal(by[0].tokens, exp0[:by[0].tokens.size])
    assert by[1].status == "ok"
    np.testing.assert_array_equal(by[1].tokens, _solo(ref, reqs[1]))
    assert ce.stats["timeout"] == 1
    _assert_clean(ce)


def test_deadline_expires_in_queue_before_admission():
    ce = _shared("dense")
    ce.reset()
    t = [0.0]
    results = []
    reqs = _mk(TS, _vocab(), [(24, 6)])
    reqs[0].deadline_s = 2.0
    ce.submit(reqs[0])
    t[0] = 3.0
    ce.admit_ready(lambda: t[0], results)
    assert [(r.rid, r.status) for r in results] == [(0, "timeout")]
    assert results[0].tokens.size == 0
    _assert_clean(ce)


# -- lifecycle: overload shedding ----------------------------------------------


def test_queue_cap_shed_policies():
    ce = _shared("dense")
    ce.reset()
    shapes = [(12, 3), (12, 3), (12, 3), (12, 3)]
    try:
        ce.queue_cap, ce.shed_policy = 2, "reject"
        for r in _mk(TS, _vocab(), shapes):
            ce.submit(r)
        assert sorted(r.rid for r in ce._pending) == [2, 3]
        assert [r.rid for r in ce.queue] == [0, 1]
        got = ce.run([])
        assert got[2].size == 0 and got[3].size == 0
        assert got[0].size == 3 and got[1].size == 3

        ce.queue_cap, ce.shed_policy = 2, "oldest"
        for r in _mk(TS, _vocab(), shapes):
            ce.submit(r)
        assert sorted(r.rid for r in ce._pending) == [0, 1]
        assert [r.rid for r in ce.queue] == [2, 3]
        ce.run([])

        ce.queue_cap, ce.shed_policy = 2, "lowest-priority"
        reqs = _mk(TS, _vocab(), shapes)
        for rid, pr in enumerate((1, 0, 2, 0)):
            reqs[rid].priority = pr
        for r in reqs:
            ce.submit(r)
        assert sorted(r.rid for r in ce._pending) == [1, 3]
        assert [r.rid for r in ce.queue] == [0, 2]
        ce.run([])
        assert ce.stats["shed"] >= 6
    finally:
        ce.queue_cap, ce.shed_policy = None, "reject"
    _assert_clean(ce)


# -- validation: duplicate rids + empty prompts --------------------------------


def test_duplicate_rid_and_empty_prompt_rejected():
    ce, ref = _shared("dense"), _ref()
    ce.reset()
    prompt = _mk(TS, _vocab(), [(12, 3)])[0].prompt
    ce.submit(TS.Request(7, prompt, 3))
    with pytest.raises(ValueError, match="already in flight"):
        ce.submit(TS.Request(7, prompt, 4))
    got = ce.run([])
    assert got[7].size == 3
    ce.submit(TS.Request(7, prompt, 3))
    assert ce.run([])[7].size == 3
    with pytest.raises(ValueError, match="empty prompt"):
        ce.submit(TS.Request(8, np.zeros((0,), np.int32), 4))
    with pytest.raises(ValueError, match="empty prompt"):
        ref.generate(np.zeros((1, 0), np.int32), 4)
    with pytest.raises(ValueError, match="empty prompt"):
        ref.generate(np.ones((2, 8), np.int32), 4,
                     lengths=np.asarray([8, 0], np.int32))
    _assert_clean(ce)


# -- config surface ------------------------------------------------------------


def test_fault_fields_config_equals_kwargs_bitwise():
    _, _, tc, tparams = _params("stablelm_3b")
    kw = dict(KW, queue_cap=8, shed_policy="oldest", deadline_s=30.0,
              admit_retries=4)
    a = TS.ContinuousEngine(tc, tparams, device="cpu", **kw)
    b = TS.ContinuousEngine(tc, tparams, device="cpu",
                            config=ServingConfig(**kw))
    for e in (a, b):
        assert (e.queue_cap, e.shed_policy, e.deadline_s,
                e.admit_retries) == (8, "oldest", 30.0, 4)
    shapes = [(20, 5), (33, 7)]
    ga = a.run(_mk(TS, _vocab(), shapes))
    gb = b.run(_mk(TS, _vocab(), shapes))
    for rid in ga:
        np.testing.assert_array_equal(ga[rid], gb[rid])
    with pytest.raises(ValueError, match="shed_policy"):
        ServingConfig(shed_policy="drop-newest")
    with pytest.raises(ValueError, match="queue_cap"):
        ServingConfig(queue_cap=0)
    with pytest.raises(ValueError, match="admit_retries"):
        ServingConfig(admit_retries=-1)
    with pytest.raises(ValueError, match="not a known fault point"):
        TF.Fault("gamma_ray")
    assert TF.FAULT_POINTS == JF.FAULT_POINTS
    assert set(TF.FAULT_POINTS) == {"nan_logits", "pool_exhaust",
                                    "proposer", "slow_segment", "dispatch"}
    assert issubclass(TF.FaultError, RuntimeError)


def test_health_and_summarize_surface_statuses():
    ce = _shared("dense")
    h = ce.health()
    for k in ("resident", "queued", "reserved", "chunking", "pool_free",
              "segments", "median_segment_s", "slow_segments",
              "watchdog_slow", "dispatch_failures", "proposer_failures",
              "spec_degraded", "failed", "shed", "cancelled", "timeout",
              "last_error"):
        assert k in h, k
    tok = np.arange(4, dtype=np.int32)
    res = []
    for mod in (TS, JS):
        rr = lambda rid, st, fin, dl: mod.RequestResult(
            rid, tok, 8, 4, 0.0, 0.1, fin, status=st, deadline_s=dl)
        res.append([rr(0, "ok", 1.0, 2.0), rr(1, "ok", 9.0, 2.0),
                    rr(2, "ok", 1.0, None), rr(3, "timeout", 2.0, 2.0),
                    rr(4, "shed", 0.0, None)])
    s = TS.summarize(res[0], 10.0)
    assert s == JS.summarize(res[1], 10.0)
    assert (s["n_ok"], s["n_timeout"], s["n_shed"],
            s["n_cancelled"], s["n_failed"]) == (3, 1, 1, 0, 0)
    assert s["n_requests"] == 5 and s["delivered_tokens"] == 12
    assert s["slo_attainment"] == 0.5
    assert set(f"n_{x}" for x in TS.STATUSES) <= set(s)
    empty = TS.summarize([], 0.0)
    assert empty["slo_attainment"] == 1.0 and empty["n_ok"] == 0


# -- against the reference -----------------------------------------------------


def _schedule(mod, case):
    """The fault schedule of a case, in module ``mod``'s classes."""
    return {
        "nan": [mod.Fault("nan_logits", rid=1, after=1)],
        "dispatch": [mod.Fault("dispatch", count=2)],
        "pool_exhaust": [mod.Fault("pool_exhaust", count=3)],
        "unfundable": [mod.Fault("pool_exhaust", count=100)],
        "cancel": [], "deadline": [], "shed": [],
    }[case]


def _scenario(S, F, T, ce, case):
    """Drive one case on engine ``ce`` of package (S: scheduler, F:
    faults, T: telemetry); returns (results, telemetry)."""
    tel = T.Telemetry(sample_every=0)
    ce.telemetry = tel
    tel.bind_engine(ce)
    ce.injector = F.FaultInjector(*_schedule(F, case)) if _schedule(
        F, case) else None
    shapes = {"shed": [(12, 3)] * 4, "unfundable": [(20, 6)]}.get(
        case, [(24, 10), (26, 12), (12, 6), (18, 7)])
    reqs = _mk(S, _vocab(), shapes)
    t = [0.0]
    clock = lambda: t[0]
    results = []
    if case == "deadline":
        reqs[0].deadline_s = 5.0
        reqs[3].deadline_s = 1.0
    if case == "shed":
        ce.queue_cap, ce.shed_policy = 2, "oldest"
    for r in reqs:
        ce.submit(r)
    if case == "cancel":
        ce.cancel(3)
        ce.admit_ready(clock, results)
        ce.cancel(1)
    if case in ("cancel", "deadline"):
        while not any(s is not None and s.req.rid == 0 for s in ce._slot):
            ce.admit_ready(clock, results)
            ce.step_prefill(clock, results)
        ce._step_decode(clock, results)
        ce._step_decode(clock, results)
        if case == "cancel":
            ce.cancel(0)
        t[0] = 10.0
    _drive(ce, results, clock)
    ce.injector = None
    ce.queue_cap, ce.shed_policy = None, "reject"
    return results, tel


@pytest.mark.parametrize("case", ["nan", "dispatch", "pool_exhaust",
                                  "unfundable", "cancel", "deadline",
                                  "shed"])
def test_statuses_tokens_and_counters_equal_reference(case):
    jc, jparams, tc, tparams = _params("stablelm_3b")
    kw = dict(KW, paged=case in ("pool_exhaust", "unfundable"),
              admit_retries=3)
    jce = JS.ContinuousEngine(jc, jparams, **kw)
    tce = TS.ContinuousEngine(tc, tparams, device="cpu", **kw)
    jres, jtel = _scenario(JS, JF, JT, jce, case)
    tres, ttel = _scenario(TS, TF, TT, tce, case)
    want = sorted((r.rid, r.status, np.asarray(r.tokens).tolist())
                  for r in jres)
    got = sorted((r.rid, r.status, r.tokens.tolist()) for r in tres)
    assert got == want
    if case not in ("dispatch", "pool_exhaust"):
        assert any(r[1] != "ok" for r in got)
    assert set(tce.health()) == set(jce.health())
    for status in TS.STATUSES:
        assert (ttel.metrics.value("serving_requests_total", status=status)
                == jtel.metrics.value("serving_requests_total",
                                      status=status)), status
    name = "serving_tokens_delivered_total"
    assert ttel.metrics.value(name) == jtel.metrics.value(name)
    for k in ("failed", "shed", "cancelled", "timeout", "dispatch_failures"):
        assert tce.health()[k] == jce.health()[k], k
    _assert_clean(tce)
