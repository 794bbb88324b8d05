"""The port's RWKV6 path against the JAX reference on reduced rwkv6_3b:
K7's plain version against the Pallas kernel (interpret mode, through
``repro.kernels.ops.wkv6``) and the reference model's ``_wkv_chunked``,
the token scan, the time-mix and channel-mix blocks, full-model logits,
``Engine.generate`` greedy tokens, and the continuous engine's tokens
against the reference's continuous engine and solo ``generate`` (its
blocking admission overwriting a slot's state), with the reference's weights
carried across by ``repro_torch.convert``.  Inputs come from numpy with a
seed.

Tolerances, as |got - want| <= atol + rtol * |want|: f32 atol/rtol 1e-5
(summation order and libm); model logits and caches 1e-4 relative to the
largest magnitude (as tests/test_torch_model.py); bf16 logits 2e-2 of the
largest magnitude (each side rounds every bf16 op on its own schedule:
XLA may keep f32 between fused bf16 ops, PyTorch rounds each).
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
from repro.inference import scheduler as JS
from repro.inference.telemetry import Telemetry as JTel
from repro.inference.engine import Engine as JEngine
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import common as jcommon
from repro.models import ssm as jssm
from repro.models import transformer as JT
from repro.models.attention import RunFlags as JFlags
from repro_torch import convert
from repro_torch.configs.base import get_config, reduced
from repro_torch.inference import engine as TE
from repro_torch.inference import scheduler as TS
from repro_torch.inference.scheduler import ContinuousEngine
from repro_torch.inference.telemetry import Telemetry, probe_ok
from repro_torch.kernels import ops, wkv6 as K7
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve
from repro_torch.models import common, ssm
from repro_torch.models import transformer as TT
from repro_torch.models.attention import RunFlags

torch.set_num_threads(1)

F32 = (1e-5, 1e-5)
REL = 1e-4


def _allclose(got, want, tol=F32, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    atol, rtol = tol
    used = np.max(np.abs(got - want) / (atol + rtol * np.abs(want)))
    assert used <= 1.0, (what, float(np.max(np.abs(got - want))), used)


def _close(got, want, rel=REL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.max(np.abs(want))), 1e-6)
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * scale, (what, err, scale)


def _wkv_inputs(seed, b, s, h, hd, w_const=None, state=False):
    """r, k, v, w (B,S,H,hd), u (H,hd) and s0 (B,H,hd,hd) or None, as the
    reference kernel tests draw them."""
    g = np.random.default_rng(seed)
    r = g.standard_normal((b, s, h, hd)).astype(np.float32)
    k = (g.standard_normal((b, s, h, hd)) * 0.3).astype(np.float32)
    v = g.standard_normal((b, s, h, hd)).astype(np.float32)
    if w_const is None:
        w = np.exp(-np.exp(g.standard_normal((b, s, h, hd)) * 0.5 - 2))
    else:
        w = np.full((b, s, h, hd), w_const)
    u = (g.standard_normal((h, hd)) * 0.1).astype(np.float32)
    s0 = ((g.standard_normal((b, h, hd, hd)) * 0.5).astype(np.float32)
          if state else None)
    return r, k, v, w.astype(np.float32), u, s0


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _port_chunked(r, k, v, w, u, s0, chunk):
    """K7's plain version on (B,H,S,hd) views of the model layout."""
    y, st = K7.wkv6_chunked_plain(*(_t(a).transpose(1, 2)
                                    for a in (r, k, v, w)),
                                  _t(u), _t(s0), chunk=chunk)
    return y.transpose(1, 2).numpy(), st.numpy()


@pytest.mark.parametrize("s,chunk,hd", [(64, 16, 16), (128, 32, 64),
                                        (96, 32, 64)])
def test_wkv6_plain_matches_pallas_kernel(s, chunk, hd):
    r, k, v, w, u, _ = _wkv_inputs(s + hd, 2, s, 3, hd)
    want = jops.wkv6(*(jnp.asarray(a) for a in (r, k, v, w, u)), chunk=chunk)
    y, _ = _port_chunked(r, k, v, w, u, None, chunk)
    _allclose(y, want, what="y")


@pytest.mark.parametrize("case", ["random", "clamp", "strong"])
def test_wkv6_plain_with_state_matches_reference_model(case):
    """(y, s_last) against the reference model's _wkv_chunked from a
    random state.  "clamp": w = 0.3, so 32 ln 0.3 = -38.5 and the -30
    clamp binds inside every chunk; "strong": w = 0.52, the reference's
    strong-decay case."""
    w_const = {"random": None, "clamp": 0.3, "strong": 0.52}[case]
    r, k, v, w, u, s0 = _wkv_inputs(7, 2, 128, 3, 16, w_const, state=True)
    yj, sj = jssm._wkv_chunked(*(jnp.asarray(a) for a in (r, k, v, w, u)),
                               jnp.asarray(s0))
    y, st = _port_chunked(r, k, v, w, u, s0, 32)
    _allclose(y, yj, what="y")
    _allclose(st, sj, what="s_last")


@pytest.mark.parametrize("w_const", [0.3, 0.52])
def test_wkv6_plain_matches_pallas_kernel_under_strong_decay(w_const):
    r, k, v, w, u, _ = _wkv_inputs(3, 1, 64, 2, 32, w_const)
    want = jops.wkv6(*(jnp.asarray(a) for a in (r, k, v, w, u)), chunk=32)
    y, _ = _port_chunked(r, k, v, w, u, None, 32)
    assert np.isfinite(y).all()
    _allclose(y, want, what="y")


def test_wkv6_clamp_departs_from_the_recurrence():
    """Where a chunk's decay product falls below e^-30 the chunked form is
    not the token recurrence; the port keeps the clamp, as K7 must."""
    r, k, v, w, u, _ = _wkv_inputs(5, 1, 64, 2, 16, 0.3)
    y, _ = _port_chunked(r, k, v, w, u, None, 32)
    seq, _ = tref.wkv6_ref(*(_t(a) for a in (r, k, v, w, u)))
    assert np.abs(y - seq.numpy()).max() > 1e-3


@pytest.mark.parametrize("state", [False, True])
def test_wkv_scan_and_oracle_match_reference(state):
    r, k, v, w, u, s0 = _wkv_inputs(11, 2, 40, 3, 16, state=state)
    jargs = [jnp.asarray(a) for a in (r, k, v, w, u)]
    js0 = None if s0 is None else jnp.asarray(s0)
    yj, sj = jssm._wkv_scan(*jargs, js0)
    y, st = ssm._wkv_scan(*(_t(a) for a in (r, k, v, w, u)), _t(s0))
    _allclose(y.numpy(), yj, what="scan y")
    _allclose(st.numpy(), sj, what="scan s")
    yo, so = tref.wkv6_ref(*(_t(a) for a in (r, k, v, w, u)), _t(s0))
    yr, sr = jref.wkv6_ref(*jargs, js0)
    _allclose(yo.numpy(), yr, what="oracle y")
    _allclose(so.numpy(), sr, what="oracle s")


def test_wkv6_wrapper_takes_plain_version_on_cpu():
    r, k, v, w, u, s0 = _wkv_inputs(2, 1, 64, 2, 16, state=True)
    before = K7.wkv6_chunked.launches
    y, st = ops.wkv6(*(_t(a) for a in (r, k, v, w, u)), _t(s0))
    yp, sp = _port_chunked(r, k, v, w, u, s0, 32)
    np.testing.assert_array_equal(y.numpy(), yp)
    np.testing.assert_array_equal(st.numpy(), sp)
    assert K7.wkv6_chunked.launches == before
    with pytest.raises(ValueError, match="multiple of chunk"):
        ops.wkv6(*(_t(a)[:, :40] for a in (r, k, v, w)), _t(u))


def test_group_norm_heads_matches_reference():
    g = np.random.default_rng(4)
    x = g.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    gamma = g.standard_normal((64,)).astype(np.float32)
    want = jcommon.group_norm_heads(jnp.asarray(x), jnp.asarray(gamma), 4)
    got = common.group_norm_heads(_t(x), _t(gamma), 4)
    _allclose(got.numpy(), want, what="group norm")


# -- the model --------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _setup(dtype="float32"):
    jc = jreduced(jget_config("rwkv6_3b"))
    tc = reduced(get_config("rwkv6_3b"))
    if dtype != "float32":
        jc = dataclasses.replace(jc, dtype=dtype, param_dtype=dtype)
        tc = dataclasses.replace(tc, dtype=dtype, param_dtype=dtype)
    jparams, _ = JT.init_model(jax.random.PRNGKey(0), jc)
    tparams = convert.from_reference(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jc, tc, jparams, tparams


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def test_reduced_config_matches_reference():
    jc, tc, _, _ = _setup()
    for f in dataclasses.fields(tc):
        want = getattr(jc, f.name)
        if f.name in ("dsa", "rwkv"):
            got = getattr(tc, f.name)
            for g in dataclasses.fields(got):
                assert getattr(got, g.name) == getattr(want, g.name), g
        else:
            assert getattr(tc, f.name) == want, f.name


def test_convert_carries_rwkv_leaves():
    """Every reference leaf (mu, w_lora_a/b, w0, u, wr/wk/wv/wg/wo, ln_x,
    mlp.{mu, wk, wv, wr}) lands in the port's tree, unstacked per layer,
    with the structure, shapes and dtypes of the port's own init."""
    jc, tc, jparams, tparams = _setup()
    own = TT.init_model(0, tc, device="cpu")

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return (tuple(t.shape), t.dtype)

    assert shapes(own) == shapes(tparams)
    for i, g in enumerate(tparams["groups"]):
        for blk in ("attn", "mlp"):
            for name, leaf in g["b0"][blk].items():
                np.testing.assert_array_equal(
                    leaf.numpy(), np.asarray(jparams["groups"]["b0"][blk][
                        name][i]), err_msg=f"{i}.{blk}.{name}")


@pytest.mark.parametrize("s", [64, 40])
def test_apply_rwkv_and_ffn_match_reference(s):
    """One layer's time-mix from a random state and previous token (s 64
    takes the chunked form, 40 the scan) and its channel-mix FFN."""
    jc, tc, jparams, tparams = _setup()
    jp, tp = _layer(jparams["groups"]["b0"], 0), tparams["groups"][0]["b0"]
    g = np.random.default_rng(s)
    b, d = 2, tc.d_model
    x = g.standard_normal((b, s, d)).astype(np.float32)
    prev = g.standard_normal((b, d)).astype(np.float32)
    s0 = (g.standard_normal((b, 4, 16, 16)) * 0.3).astype(np.float32)
    jcache = {"s": jnp.asarray(s0), "x_prev": jnp.asarray(prev),
              "ffn_prev": jnp.zeros((b, d))}
    yj, cj = jssm.apply_rwkv(jp["attn"], jc, jnp.asarray(x), cache=jcache)
    tcache = {"s": _t(s0), "x_prev": _t(prev), "ffn_prev": torch.zeros(b, d)}
    y = ssm.apply_rwkv(tp["attn"], tc, _t(x), cache=tcache)
    _close(y.numpy(), yj, what="time-mix out")
    _close(tcache["s"].numpy(), cj["s"], what="s")
    np.testing.assert_array_equal(tcache["x_prev"].numpy(), x[:, -1])
    fj = jssm.apply_rwkv_ffn(jp["mlp"], jc, jnp.asarray(x),
                             jnp.asarray(prev))
    f = ssm.apply_rwkv_ffn(tp["mlp"], tc, _t(x), _t(prev))
    _close(f.numpy(), fj, what="channel-mix out")


@pytest.mark.parametrize("plen", [64, 48, 32])
def test_forward_logits_and_state_match_reference(plen):
    """Full-model prefill into a cache (64 chunked, 48 and 32 the scan),
    then 3 decode steps: logits and every cache leaf."""
    jc, tc, jparams, tparams = _setup()
    b = 2
    toks = np.random.default_rng(plen).integers(
        1, jc.vocab - 4, size=(b, plen)).astype(np.int32)
    jpf = JFlags(mode="prefill", dsa_mode="off", with_mse=False)
    jdf = dataclasses.replace(jpf, mode="decode")
    tdf = RunFlags(mode="decode", dsa_mode="off")
    jcache = JT.init_cache(jc, b, 96, jdf, dtype=jnp.float32)
    jlog, _, jcache = JT.forward(jparams, jc, jpf,
                                 {"tokens": jnp.asarray(toks)}, caches=jcache)
    tcache = TT.init_cache(tc, b, 96, tdf, dtype=torch.float32, device="cpu")
    tlog, _ = TT.forward(tparams, tc, RunFlags(mode="prefill", dsa_mode="off"),
                         torch.from_numpy(toks), tcache)
    _close(tlog.numpy(), jlog, what="prefill logits")
    jcache = JT.unstack_group_caches(jcache)

    def compare_caches():
        for i, layer in enumerate(tcache["groups"]):
            tc_, jc_ = layer["b0"]["attn"], jcache["groups"][i]["b0"]["attn"]
            assert set(tc_) == set(jc_) == {"s", "x_prev", "ffn_prev"}
            for name in tc_:
                _close(tc_[name].numpy(), jc_[name], what=(i, name))

    compare_caches()
    tok = np.asarray(jlog)[:, -1].argmax(-1)[:, None].astype(np.int32)
    for step in range(3):
        jlog, jcache = JT.decode_step(jparams, jc, jdf, jnp.asarray(tok),
                                      jcache)
        tlog, tcache = TT.decode_step(tparams, tc, tdf,
                                      torch.from_numpy(tok), tcache)
        _close(tlog.numpy(), jlog, what=("decode logits", step))
        tok = np.asarray(jlog)[:, -1].argmax(-1)[:, None].astype(np.int32)
    compare_caches()


def _prompts(plen, vocab, seed=1):
    return np.random.default_rng(seed).integers(
        1, vocab - 4, size=(2, plen)).astype(np.int32)


@pytest.mark.parametrize("plen", [64, 40])
def test_generate_greedy_tokens_equal_reference(plen):
    jc, tc, jparams, tparams = _setup()
    prompts = _prompts(plen, jc.vocab)
    jeng = JEngine(jc, jparams, max_len=96)
    want = np.asarray(jeng.generate(prompts, 8).tokens)
    eng = TE.Engine(tc, tparams, max_len=96, device="cpu")
    assert not eng.bucket_prompts
    got = eng.generate(prompts, 8)
    np.testing.assert_array_equal(got.tokens, want)
    _, jcache, _ = jeng.prefill(prompts)
    _, tcache, _ = eng.prefill(prompts)
    for i, layer in enumerate(tcache["groups"]):
        _close(layer["b0"]["attn"]["s"].numpy(),
               jcache["groups"]["b0"]["attn"]["s"][i], what=("s", i))


def test_bf16_with_bf16_cache_matches_reference():
    """Reduced rwkv6_3b in bf16 with a bf16 cache, the one bf16 setting the
    reference serves: greedy tokens equal, logits at the bf16 tolerance."""
    jc, tc, jparams, tparams = _setup("bfloat16")
    assert tparams["embed"].dtype == torch.bfloat16
    prompts = _prompts(64, jc.vocab)
    jeng = JEngine(jc, jparams, max_len=96, cache_dtype=jnp.bfloat16)
    eng = TE.Engine(tc, tparams, max_len=96, cache_dtype=torch.bfloat16,
                    device="cpu")
    np.testing.assert_array_equal(eng.generate(prompts, 8).tokens,
                                  np.asarray(jeng.generate(prompts, 8).tokens))
    jlast, _, _ = jeng.prefill(prompts)
    tlast, _, _ = eng.prefill(prompts)
    _close(tlast.float().numpy(), np.asarray(jlast, np.float32), rel=2e-2,
           what="bf16 prefill logits")


def test_reference_fault_rwkv_bf16_with_f32_cache():
    """Found by the port: the reference cannot serve a bf16 RWKV6 model
    from its default f32 cache.  The token shift concatenates the f32
    x_prev with bf16 x (promoting to f32), and the layer scan refuses the
    f32 residual that leaves the first layer.  The port casts the shifted
    token to the activation dtype and serves it, with the tokens and
    state of a bf16 cache, bit for bit."""
    jc, tc, jparams, tparams = _setup("bfloat16")
    prompts = _prompts(64, jc.vocab)
    with pytest.raises(TypeError, match="carry input and carry output"):
        JEngine(jc, jparams, max_len=96).generate(prompts, 2)
    f32 = TE.Engine(tc, tparams, max_len=96, device="cpu")
    b16 = TE.Engine(tc, tparams, max_len=96, cache_dtype=torch.bfloat16,
                    device="cpu")
    assert f32.cache_dtype == torch.float32
    np.testing.assert_array_equal(f32.generate(prompts, 8).tokens,
                                  b16.generate(prompts, 8).tokens)
    _, c32, _ = f32.prefill(prompts)
    _, c16, _ = b16.prefill(prompts)
    for l32, l16 in zip(c32["groups"], c16["groups"]):
        a32, a16 = l32["b0"]["attn"], l16["b0"]["attn"]
        assert torch.equal(a32["s"], a16["s"])
        for name in ("x_prev", "ffn_prev"):
            assert a32[name].dtype == torch.float32
            assert torch.equal(a32[name], a16[name].float())


# -- the port's envelope for a recurrent arch -------------------------------


def test_recurrent_arch_envelope():
    """No prompt buckets, no quantized cache, no ragged batch, no chunk
    step; the continuous engine builds with blocking admission on a dense
    cache (``chunked`` and ``paged`` False, even when chunking is asked
    for) and refuses a paged one; truncate_cache leaves the state
    alone."""
    _, tc, _, tparams = _setup()
    assert not TE.can_bucket_prompts(tc)
    with pytest.raises(ValueError, match="unsupported for arch"):
        TE.Engine(tc, tparams, kv_quant="int8", device="cpu")
    eng = TE.Engine(tc, tparams, max_len=96, device="cpu")
    prompts = _prompts(48, tc.vocab)
    with pytest.raises(ValueError, match="ragged"):
        eng.generate(prompts, 2, lengths=np.array([48, 30]))
    ce = ContinuousEngine(tc, tparams, max_len=96, chunked_prefill=True,
                          device="cpu")
    assert not ce.chunked and not ce.paged
    with pytest.raises(ValueError, match="paged=True"):
        ContinuousEngine(tc, tparams, max_len=96, paged=True, device="cpu")
    _, caches, _ = eng.prefill(prompts)
    before = [{k: t.clone() for k, t in g["b0"]["attn"].items()}
              for g in caches["groups"]]
    TT.truncate_cache(tc, caches, 10)
    for b, g in zip(before, caches["groups"]):
        for k, t in g["b0"]["attn"].items():
            assert torch.equal(t, b[k])
    with pytest.raises(NotImplementedError, match="recurrent"):
        TT.chunk_step(tparams, tc, eng.decode_flags,
                      torch.from_numpy(prompts[:, :16]), caches,
                      torch.tensor([16, 16]))


CONT_SHAPES = [(64, 6), (64, 9), (40, 7), (64, 4), (40, 5)]
CONT = dict(slots=2, max_len=96, seg_len=4)


def _cont_requests(mod, vocab):
    rng = np.random.default_rng(0)
    return [mod.Request(rid, rng.integers(1, vocab - 4, size=(n,)).astype(
        np.int32), n_new) for rid, (n, n_new) in enumerate(CONT_SHAPES)]


def test_continuous_equals_reference_and_solo():
    """The continuous engine on reduced rwkv6_3b: blocking admission (a
    group per prompt length; 64 is two chunks of the wkv, 40 the token
    scan), each insert overwriting the slot's ``s``, ``x_prev`` and
    ``ffn_prev``, slots reused after retirements.  The tokens equal the
    reference's continuous engine's and each request's solo
    ``generate``."""
    jc, tc, jparams, tparams = _setup()
    eng = ContinuousEngine(tc, tparams, device="cpu", **CONT)
    assert not eng.chunked
    reqs = _cont_requests(TS, tc.vocab)
    got = eng.run(reqs)
    assert eng.stats["admitted"] == len(reqs) and eng.stats["chunks"] == 0
    want = JS.ContinuousEngine(jc, jparams, **CONT).run(
        _cont_requests(JS, jc.vocab))
    solo = TE.Engine(tc, tparams, max_len=96, device="cpu")
    for r in reqs:
        np.testing.assert_array_equal(got[r.rid], np.asarray(want[r.rid]),
                                      err_msg=f"rid {r.rid}")
        np.testing.assert_array_equal(
            got[r.rid], solo.generate(r.prompt[None], r.n_new).tokens[0],
            err_msg=f"rid {r.rid} solo")


def test_insert_overwrites_every_recurrent_leaf():
    """A slot's insert copies every leaf of its prefill row (the state
    and both previous tokens) over whatever the slot held, and leaves the
    other slot as it was; a masked step with no active row changes no
    leaf."""
    _, tc, _, tparams = _setup()
    eng = ContinuousEngine(tc, tparams, device="cpu", **CONT)
    with torch.inference_mode():
        for lc in TT.attn_caches(eng._caches):
            for t in lc.values():
                t.copy_(torch.randn(t.shape))
        before = [{k: t.clone() for k, t in lc.items()}
                  for lc in TT.attn_caches(eng._caches)]
        _, pre, _ = eng.engine.prefill(_prompts(40, tc.vocab),
                                       cache_len=40)
        eng._insert(pre, 1, 0)
        for b, res, st in zip(before, TT.attn_caches(eng._caches),
                              TT.attn_caches(pre)):
            assert set(res) == {"s", "x_prev", "ffn_prev"}
            for k in res:
                assert torch.equal(res[k][1], st[k][0])
                assert torch.equal(res[k][0], b[k][0])
        after = [{k: t.clone() for k, t in lc.items()}
                 for lc in TT.attn_caches(eng._caches)]
        TT.decode_step(tparams, tc, eng.engine.decode_flags,
                       torch.ones((2, 1), dtype=torch.long), eng._caches,
                       active=torch.zeros(2, dtype=torch.bool))
        for a, lc in zip(after, TT.attn_caches(eng._caches)):
            for k, t in lc.items():
                assert torch.equal(t, a[k])


def test_reference_fault_probe_on_an_arch_without_dsa():
    """Found by the port: the reference's sparsity probe gates on the
    flags alone (a long-context cache on the block or kernel path), so a
    continuous engine serving rwkv6_3b so with telemetry probes a step
    that selects nothing and fails on the empty selection list
    (IndexError).  The port's gate (``telemetry.probe_ok``) also asks for
    DSA on the arch: it probes nothing and serves the untraced tokens."""
    jc, tc, jparams, tparams = _setup()
    kw = dict(long_context=True, dsa_mode="block", **CONT)
    shapes = [(40, 12), (40, 10)]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, tc.vocab - 4, size=(n,)).astype(np.int32)
               for n, _ in shapes]
    with pytest.raises(IndexError):
        JS.ContinuousEngine(jc, jparams, telemetry=JTel(sample_every=1),
                            **kw).run([JS.Request(i, p, m) for i, (p, (_, m))
                                       in enumerate(zip(prompts, shapes))])
    assert not probe_ok(tc, RunFlags(mode="decode", dsa_mode="block",
                                     long_context=True))
    reqs = [TS.Request(i, p, m) for i, (p, (_, m))
            in enumerate(zip(prompts, shapes))]
    plain = ContinuousEngine(tc, tparams, device="cpu", **kw).run(reqs)
    eng = ContinuousEngine(tc, tparams, device="cpu",
                           telemetry=Telemetry(sample_every=1), **kw)
    got = eng.run(reqs)
    assert eng.stats["probe_steps"] == 0 and eng.stats["segments"] > 1
    for r in reqs:
        np.testing.assert_array_equal(got[r.rid], plain[r.rid])


def test_serve_rwkv_on_cpu_with_dsa_falls_back(capsys):
    res = serve.main(["--arch", "rwkv6_3b", "--reduced", "--batch", "2",
                      "--prompt-len", "64", "--new-tokens", "8", "--dsa",
                      "--dsa-mode", "kernel", "--device", "cpu"])
    assert res.tokens.shape == (2, 8)
    out = capsys.readouterr().out
    # the state (2 layers x 4 heads x 16 x 16 f32) and two f32 tokens a layer
    assert "cache 9216 bytes per batch row" in out
    assert "K7 0" in out
