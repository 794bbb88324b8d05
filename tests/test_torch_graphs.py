"""The port's decode step as a CUDA graph captures it, and the
bookkeeping of its replays (inference/graphs.py), on the CPU.

- The capturable step (a bare (B,) mask: fixed-shape writes, an inactive
  row putting back what its target holds, ``pos`` updated in place)
  equals the eager Active-rows step (``Active(mask, rows)``: only the
  active rows write) bit for bit, logits and every cache leaf, over
  several steps with changing masks: dense and paged caches, f32, int8
  and fp8 K/V, int8 selection, the block and kernel (plain) paths.  No
  leaf of any cache, RWKV6's included, changes its storage in a step,
  and the masked step asks the host nothing (no ``nonzero``, ``item``,
  ``tolist`` or truth value of a tensor).
- The masked step matches the reference's ``decode_step(active=mask)``
  at the parity tolerance of tests/test_torch_model.py (1e-4 of the
  largest magnitude; ``pos`` exact).
- A prefill into the engine's resident cache, dirtied by an earlier
  ``generate``, equals a prefill into a fresh cache on every leaf.
- A replay adds the launches its capture recorded to the kernels'
  counters, and ``decode_dispatches`` counts the steps dispatched.
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
from repro.models import transformer as JT
from repro.models.attention import RunFlags as JFlags
from repro.models.transformer import init_model as jinit_model
from repro_torch import convert
from repro_torch.configs.base import get_config, reduced
from repro_torch.core.quantization import raw
from repro_torch.inference import engine as TE
from repro_torch.inference import scheduler as TS
from repro_torch.inference.graphs import StepGraph
from repro_torch.kernels import _launch as LN
from repro_torch.launch import serve
from repro_torch.models import transformer as TT
from repro_torch.models.attention import Active, RunFlags

torch.set_num_threads(1)

MAX_LEN = 96
REL = 1e-4
# (kv_quant, select_dtype)
QUANT = [(None, "float32"), ("int8", "float32"), ("fp8", "float32"),
         (None, "int8"), ("int8", "int8")]
# per step, which of the three slots decode
MASKS = [[True, True, True], [True, False, True], [False, True, False],
         [False, False, False], [True, True, False]]


@functools.lru_cache(maxsize=None)
def _params(arch: str):
    jc = jreduced(jget_config(arch))
    jparams, _ = jinit_model(jax.random.PRNGKey(0), jc)
    tparams = convert.from_reference(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jc, jparams, reduced(get_config(arch)), tparams


def _leaves(caches):
    for gi, group in enumerate(caches["groups"]):
        for name, t in group["b0"]["attn"].items():
            yield (gi, name), t


def _clone(caches):
    return {"groups": [{"b0": {"attn": {n: t.clone() for n, t in
                                        g["b0"]["attn"].items()}}}
                       for g in caches["groups"]]}


def _resident(paged, mode, kv, sel):
    """A continuous engine's resident cache with three slots admitted at
    three depths (prompts 48, 21 and 37, chunked admission), and the
    engine."""
    _, _, tc, tparams = _params("yi_6b")
    eng = TS.ContinuousEngine(tc, tparams, device="cpu", slots=3,
                              max_len=MAX_LEN, seg_len=4, long_context=True,
                              dsa_mode=mode, kv_quant=kv, select_dtype=sel,
                              paged=paged)
    rng = np.random.default_rng(5)
    for rid, n in enumerate((48, 21, 37)):
        eng.submit(TS.Request(rid, rng.integers(
            1, tc.vocab - 4, size=(n,)).astype(np.int32), 24))
    clock, sink = (lambda: 0.0), []
    while eng.queue or eng._pf is not None:
        eng.admit_ready(clock, sink)
        eng.step_prefill(clock, sink)
    assert all(s is not None for s in eng._slot)
    return eng


@pytest.mark.parametrize("mode", ["block", "kernel"])
@pytest.mark.parametrize("kv,sel", QUANT,
                         ids=[f"{k or 'f32'}-{s}" for k, s in QUANT])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_masked_step_equals_active_rows_step(paged, kv, sel, mode):
    """Five steps with changing masks (one with no active slot) from the
    same cache: the masked step and the Active-rows step give the same
    logits and the same cache bit for bit, and no leaf moves."""
    eng = _resident(paged, mode, kv, sel)
    params, cfg, flags = eng.engine.params, eng.cfg, eng.engine.decode_flags
    caches = {"mask": eng._caches, "rows": _clone(eng._caches)}
    ptrs = {k: t.data_ptr() for k, t in _leaves(eng._caches)}
    tok = eng._tok.clone()
    with torch.inference_mode():
        for step, m in enumerate(MASKS):
            mask = torch.tensor(m)
            got = TT.decode_step(params, cfg, flags, tok, caches["mask"],
                                 active=mask)[0]
            want = TT.decode_step(params, cfg, flags, tok, caches["rows"],
                                  active=Active(mask,
                                                mask.nonzero()[:, 0]))[0]
            assert torch.equal(got, want), step
            for (key, a), (_, b) in zip(_leaves(caches["mask"]),
                                        _leaves(caches["rows"])):
                assert torch.equal(raw(a), raw(b)), (step, key)
            tok = torch.where(mask[:, None], got[:, -1].argmax(-1)[:, None],
                              tok)
    assert {k: t.data_ptr() for k, t in _leaves(caches["mask"])} == ptrs


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_masked_step_asks_the_host_nothing(monkeypatch, paged):
    """The step a graph captures may not read a device value on the
    host: with nonzero, item, tolist and a tensor's truth value made to
    raise, the masked step (int8 K/V and selection, kernel path) runs."""
    eng = _resident(paged, "kernel", "int8", "int8")

    def refuse(*a, **k):
        raise AssertionError("host sync in the decode step")

    with torch.inference_mode():
        for name in ("nonzero", "item", "tolist", "__bool__"):
            monkeypatch.setattr(torch.Tensor, name, refuse)
        TT.decode_step(eng.engine.params, eng.cfg, eng.engine.decode_flags,
                       eng._tok, eng._caches,
                       active=torch.tensor([True, False, True]))


@pytest.mark.parametrize("arch,kw", [
    ("yi_6b", dict(long_context=True, dsa_mode="kernel", kv_quant="fp8",
                   select_dtype="int8")),
    ("rwkv6_3b", {})], ids=["yi_6b-fp8", "rwkv6_3b"])
def test_decode_steps_keep_every_leaf(arch, kw):
    """A static engine's decode steps write its resident cache in place:
    every leaf, RWKV6's state ``s`` included, keeps its storage."""
    _, _, tc, tparams = _params(arch)
    eng = TE.Engine(tc, tparams, max_len=MAX_LEN, device="cpu", **kw)
    prompts = np.random.default_rng(2).integers(
        1, tc.vocab - 4, size=(2, 40)).astype(np.int32)
    with torch.inference_mode():
        caches = eng.resident_cache(2)
        ptrs = {k: t.data_ptr() for k, t in _leaves(caches)}
        logits, _, _ = eng.prefill(prompts, caches=caches)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        step = eng.scan_step(2)
        before = {k: t.clone() for k, t in _leaves(caches)}
        for _ in range(3):
            tok = step(tok)[:, -1].argmax(-1, keepdim=True)
    assert {k: t.data_ptr() for k, t in _leaves(caches)} == ptrs
    moved = [k[1] for k, t in _leaves(caches)
             if not torch.equal(raw(t), raw(before[k]))]
    assert ("s" in moved) if arch == "rwkv6_3b" else ("pos" in moved)


# -- the masked step against the reference ------------------------------------


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-6)
    err = float(np.max(np.abs(got - want)))
    assert err <= REL * scale, (what, err, scale)


@pytest.mark.parametrize("mode", ["off", "block", "kernel"])
def test_masked_step_matches_reference(mode):
    """Prefill a ragged pair on both sides, then four masked steps (row 1
    frozen on the second, row 0 on the third): the active rows' logits,
    K and V and the kt rows the steps wrote at 1e-4 of the largest
    magnitude, ``pos`` exact.  (On the kernel path the two prefills put
    one kt row of this prompt on either side of a step of the predictor's
    4-bit fake quantization, so kt and its block sums ktb are compared
    where the decode steps wrote them.)"""
    jc, jparams, tc, tparams = _params("yi_6b")
    jdf = JFlags(mode="decode", dsa_mode=mode, long_context=True)
    tdf = RunFlags(mode="decode", dsa_mode=mode, long_context=True)
    jpf = dataclasses.replace(jdf, mode="prefill")
    tpf = dataclasses.replace(tdf, mode="prefill")
    lengths = np.array([48, 37], np.int32)
    toks = np.random.default_rng(9).integers(
        1, jc.vocab - 4, size=(2, 48)).astype(np.int32)
    jcache = JT.init_cache(jc, 2, MAX_LEN, jdf, dtype=jnp.float32)
    jlog, _, jcache = JT.forward(jparams, jc, jpf,
                                 {"tokens": jnp.asarray(toks)}, caches=jcache)
    jcache = JT.unstack_group_caches(
        JT.truncate_cache(jc, jcache, jnp.asarray(lengths)))
    tcache = TT.init_cache(tc, 2, MAX_LEN, tdf, dtype=torch.float32,
                           device="cpu")
    with torch.inference_mode():
        TT.forward(tparams, tc, tpf, torch.from_numpy(toks), tcache)
        TT.truncate_cache(tc, tcache, torch.from_numpy(lengths))
    tok = np.asarray(jlog)[np.arange(2), lengths - 1].argmax(-1)[:, None]
    for step, m in enumerate([[True, True], [True, False], [False, True],
                              [True, True]]):
        active = np.asarray(m)
        jl, jcache = JT.decode_step(jparams, jc, jdf, jnp.asarray(tok),
                                    jcache, active=jnp.asarray(active))
        with torch.inference_mode():
            tl, tcache = TT.decode_step(tparams, tc, tdf,
                                        torch.from_numpy(tok.astype(np.int64)),
                                        tcache,
                                        active=torch.from_numpy(active))
        _close(tl.numpy()[active], np.asarray(jl)[active], ("logits", step))
        nxt = np.asarray(jl)[:, -1].argmax(-1)[:, None]
        tok = np.where(active[:, None], nxt, tok).astype(np.int32)
    for tg, jg in zip(tcache["groups"], jcache["groups"]):
        t, j = tg["b0"]["attn"], jg["b0"]["attn"]
        np.testing.assert_array_equal(t["pos"].numpy(), np.asarray(j["pos"]))
        assert t["pos"].tolist() == [51, 40]
        for name in ("k", "v"):
            _close(t[name].numpy(), np.asarray(j[name]), name)
        for row, (a, b) in enumerate(zip(lengths, t["pos"].tolist())):
            _close(t["kt"][row, a:b].numpy(), np.asarray(j["kt"])[row, a:b],
                   ("kt", row))


# -- the resident cache -------------------------------------------------------


@pytest.mark.parametrize("arch,kw", [
    ("yi_6b", dict(long_context=True, dsa_mode="kernel")),
    ("yi_6b", dict(long_context=True, dsa_mode="block", kv_quant="fp8",
                   select_dtype="int8")),
    ("yi_6b", dict(long_context=True, dsa_mode="kernel", kv_quant="int8")),
    ("rwkv6_3b", {})], ids=["f32", "fp8-int8", "int8", "rwkv6_3b"])
def test_prefill_into_resident_cache_equals_fresh(arch, kw):
    """After a generate has filled and decoded into the resident cache, a
    prefill into it gives the logits and, leaf by leaf, the cache of a
    prefill into a fresh cache."""
    _, _, tc, tparams = _params(arch)
    eng = TE.Engine(tc, tparams, max_len=MAX_LEN, device="cpu", **kw)
    rng = np.random.default_rng(4)
    first = rng.integers(1, tc.vocab - 4, size=(2, 64)).astype(np.int32)
    eng.generate(first, 12)
    prompts = rng.integers(1, tc.vocab - 4, size=(2, 40)).astype(np.int32)
    lengths = None if tc.rwkv else np.array([40, 23], np.int32)
    resident = eng.resident_cache(2)
    got, caches, _ = eng.prefill(prompts, lengths=lengths, caches=resident)
    want, fresh, _ = eng.prefill(prompts, lengths=lengths)
    assert caches is resident
    assert torch.equal(got, want)
    for (key, a), (_, b) in zip(_leaves(caches), _leaves(fresh)):
        assert a.dtype == b.dtype and torch.equal(raw(a), raw(b)), key


# -- replay bookkeeping ---------------------------------------------------------


class _Replays:
    """Stands in for a torch.cuda.CUDAGraph: counts its replays."""

    def __init__(self):
        self.n = 0

    def replay(self):
        self.n += 1


def test_replay_adds_the_captured_launches():
    """Each replay copies its inputs into the static buffers, replays
    once and adds the launches its capture recorded to every counter;
    the counters of every kernel ``serve`` reports take part."""
    assert set(serve.KERNELS.values()) <= set(LN.COUNTERS)
    delta = [1 + i % 3 for i in range(len(LN.COUNTERS))]
    stub = _Replays()
    g = StepGraph(stub, torch.zeros((2, 1), dtype=torch.long),
                  torch.zeros((2,), dtype=torch.bool), torch.zeros((2, 1, 5)),
                  delta, caches=None)
    before = LN.read_counts()
    try:
        for _ in range(3):
            out = g(torch.tensor([[7], [9]]), torch.tensor([True, False]))
        assert LN.read_counts() == [b + 3 * d for b, d in zip(before, delta)]
    finally:
        LN.add_counts([b - a for a, b in zip(LN.read_counts(), before)])
    assert out is g.logits and stub.n == g.replays == 3
    assert g.tok.tolist() == [[7], [9]] and g.mask.tolist() == [True, False]
    with pytest.raises(ValueError, match="takes a mask"):
        g(torch.tensor([[7], [9]]))
    assert LN.read_counts() == before and stub.n == 3


@pytest.mark.parametrize("loop", ["scan", "python"])
@pytest.mark.parametrize("n_new", [1, 6])
def test_decode_dispatches_count_the_steps_dispatched(loop, n_new):
    """On the CPU no graph exists and every decode step is one eager
    forward: ``decode_dispatches`` equals the steps run (the bucketed
    count on the scan loop), 0 for a single new token."""
    _, _, tc, tparams = _params("yi_6b")
    eng = TE.Engine(tc, tparams, max_len=MAX_LEN, device="cpu", loop=loop,
                    long_context=True, dsa_mode="kernel")
    assert eng.graphs is None
    prompts = np.random.default_rng(3).integers(
        1, tc.vocab - 4, size=(2, 30)).astype(np.int32)
    res = eng.generate(prompts, n_new)
    want = 0 if n_new == 1 else (
        TE.pow2_bucket(n_new - 1, TE.STEP_BUCKET_FLOOR) if loop == "scan"
        else n_new - 1)
    assert res.decode_steps == res.decode_dispatches == want
