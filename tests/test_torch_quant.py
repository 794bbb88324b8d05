"""Mixed-precision serving of the PyTorch port against the JAX reference.

Storage quantization (``quant_store``/``dequant``, bitwise, int8 and fp8);
the int8 selection scores (bitwise); the plain twins and the plain
versions of the quantized kernels K1q, K3q, K4q and K5q against the
reference twins and the Pallas kernels in interpret mode, with K4q equal
to K1q and K5/K5q equal to K3/K3q on page-shuffled copies; prefill,
``truncate_cache``, ``decode_step`` (dense and paged) and ``chunk_step``
on reduced yi_6b for every kv_quant x select_dtype x dsa_mode; greedy
tokens of the static and continuous engines; and, inside the port, the
reference's own contracts (tests/test_quant_serving.py): paged == dense,
continuous == solo ``Engine.generate``, default flags leave the cache
as it was, the quantized cache packs >= 1.8x the slots, bad values raise.

Tolerances: kernels and twins as |got - want| <= atol + rtol * |want|,
f32 atol/rtol 1e-5 (same arithmetic, another summation order); the model
at 1e-4 of the largest magnitude of each compared array (f32, other
summation orders and libm); quantized cache leaves dequantized and held
within one quantization step of the narrow format at each value (the
same f32 input on either side of a rounding boundary may land one step
apart), scales at 1e-4; selected blocks, ``pos`` and tokens exact.
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
from repro.core import masks as JM
from repro.core import quantization as JQ
from repro.inference.engine import Engine as JEngine
from repro.inference import scheduler as JS
from repro.kernels import ops as jops
from repro.models import attention as JMA
from repro.models import transformer as JT
from repro.models.attention import RunFlags as JFlags
from repro_torch import convert
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import attention as TA
from repro_torch.core import masks as TM
from repro_torch.core import quantization as Q
from repro_torch.inference import engine as TE
from repro_torch.inference import scheduler as TS
from repro_torch.inference.config import ServingConfig
from repro_torch.models import attention as TMA
from repro_torch.models import transformer as TT
from repro_torch.models.attention import RunFlags
from repro_torch.kernels import ops as tops

torch.set_num_threads(1)

REL = 1e-4
MAX_LEN = 96
KINDS = ["int8", "fp8"]
GRID = [(kv, sel, mode) for kv in KINDS for sel in ("float32", "int8")
        for mode in ("block", "kernel")]


# -- helpers ------------------------------------------------------------------


def _torch(a) -> torch.Tensor:
    """A reference array as a tensor; fp8 travels as its bytes."""
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(np.array(a))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, rel=REL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.max(np.abs(want))), 1e-6)
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * scale, (what, err, scale)


def _within_a_step(tq, ts, jq, js, what=""):
    """Dequantized narrow leaves held within one quantization step of the
    format at each value, after the scales agree to REL."""
    _close(_f32(ts), _f32(js), what=(what, "scale"))
    got = _f32(tq) * _f32(ts)[..., None]
    want = _f32(jq) * _f32(js)[..., None]
    sc = np.maximum(_f32(ts), _f32(js))[..., None]
    if "e4m3fn" in str(tq.dtype):
        step = np.maximum(np.abs(want) * 2.0 ** -3, sc * 2.0 ** -9)
    else:
        step = sc
    err = np.abs(got - want) - step - REL * np.abs(want)
    assert (err <= 1e-7).all(), (what, float(err.max()))


def _compare_cache_layer(tc, jc, what=""):
    """Every leaf of one layer's cache: narrow leaves dequantized within a
    step, scales and float leaves at REL, ``pos`` and ``page_tbl``
    exact."""
    assert set(tc) == set(jc), (set(tc), set(jc))
    for name in tc:
        if name in ("pos", "page_tbl"):
            np.testing.assert_array_equal(tc[name].numpy(),
                                          np.asarray(jc[name]))
        elif name.endswith("_s"):
            continue                             # with its data leaf
        elif f"{name}_s" in tc:
            assert tc[name].dtype in (torch.int8, torch.float8_e4m3fn)
            _within_a_step(tc[name], tc[f"{name}_s"], jc[name],
                           jc[f"{name}_s"], what=(what, name))
        else:
            _close(_f32(tc[name]), _f32(jc[name]), what=(what, name))


def _layers(caches):
    jg = caches["groups"]
    if isinstance(jg, dict):                         # stacked reference
        n = jax.tree_util.tree_leaves(jg)[0].shape[0]
        jg = [jax.tree.map(lambda a, i=i: a[i], jg) for i in range(n)]
    return [g["b0"]["attn"] for g in jg]


def _compare_caches(tcache, jcache, what=""):
    for i, (tl, jl) in enumerate(zip(_layers(tcache), _layers(jcache))):
        _compare_cache_layer(tl, jl, what=(what, i))


class _Selections:
    """Records every block selection (idx, ok) of one side's top-k
    function while installed."""

    def __init__(self, module, name):
        self.got = []
        fn = getattr(module, name)

        def rec(*a, **kw):
            out = fn(*a, **kw)
            self.got.append(tuple(np.asarray(x) for x in out))
            return out
        self.module, self.name, self.fn, self.rec = module, name, fn, rec

    def __enter__(self):
        setattr(self.module, self.name, self.rec)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def _same_selections(tsel, jsel):
    """The same blocks kept per row (ascending), the same fills."""
    assert len(tsel.got) == len(jsel.got) > 0
    for (ti, tok), (ji, jok) in zip(tsel.got, jsel.got):
        np.testing.assert_array_equal(tok, jok)
        np.testing.assert_array_equal(np.where(tok, ti, -1),
                                      np.where(jok, ji, -1))


@functools.lru_cache(maxsize=None)
def _params(arch: str):
    jc = jreduced(jget_config(arch))
    jparams, _ = JT.init_model(jax.random.PRNGKey(0), jc)
    tparams = convert.from_reference(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jc, jparams, reduced(get_config(arch)), tparams


def _flags(kv, sel, mode):
    kw = dict(dsa_mode=mode, long_context=True, select_dtype=sel,
              kv_quant=kv)
    return (JFlags(mode="decode", with_mse=False, **kw),
            RunFlags(mode="decode", **kw))


# -- storage quantization and int8 selection -------------------------------------


def test_fp8_cast_and_round_match_jax():
    """The two operations quant_store rests on, bit for bit on 100k
    values: round half to even, and the f32 -> float8_e4m3fn cast inside
    the clamp (subnormals and ties included)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(100_000) * 2.0 ** rng.integers(
        -12, 9, 100_000)).astype(np.float32).clip(-448, 448)
    x[:8] = [0.5, 1.5, 2.5, -0.5, -2.5, 448.0, -448.0, 2.0 ** -10]
    got = torch.from_numpy(x).to(torch.float8_e4m3fn).view(torch.uint8)
    want = np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn)).view(
        np.uint8)
    np.testing.assert_array_equal(got.numpy(), want)
    y = (x * 100).astype(np.float32)
    y[:4] = [0.5, 1.5, -2.5, 127.5]
    np.testing.assert_array_equal(torch.round(torch.from_numpy(y)).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(y))))


@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("kind", KINDS)
def test_quant_store_bitwise_equals_reference(kind, axis):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((300, 64)) * rng.uniform(
        1e-3, 1e3, (300, 1))).astype(np.float32)
    x[3] = 0.0                                   # all-zero row
    x[:, 7] = 0.0                                # all-zero column
    x[5, :4] = [1e4, -1e4, 449.0, -500.0]        # past +-448
    jq, js = JQ.quant_store(jnp.asarray(x), axis=axis, dtype=kind)
    tq, ts = Q.quant_store(torch.from_numpy(x), axis=axis, dtype=kind)
    assert tq.dtype == Q.STORE_DTYPES[kind] and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.view(torch.uint8).numpy(),
                                  np.asarray(jq).view(np.uint8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    dq = Q.dequant(tq, ts, axis=axis).numpy()
    np.testing.assert_array_equal(dq, np.asarray(JQ.dequant(jq, js,
                                                            axis=axis)))
    zero = dq[3] if axis == -1 else dq[:, 7]
    assert not zero.any() and not np.signbit(zero).any()


def test_quant_store_refuses_unknown_dtype():
    with pytest.raises(ValueError, match="int4"):
        Q.quant_store(torch.ones(2, 4), dtype="int4")


@pytest.mark.parametrize("b,r,n,kp,bk", [(2, 1, 64, 16, 1),
                                         (2, 1, 40, 1024, 128),
                                         (1, 4, 24, 2048, 1),
                                         (3, 2, 16, 512, 16)])
def test_int8_select_scores_bitwise_equal_reference(b, r, n, kp, bk):
    """The int8 selection product (exact on both sides) and its return to
    f32, at kp up to 2048 (past where an f32 product stops being
    exact)."""
    rng = np.random.default_rng(kp + n)
    q_t = rng.standard_normal((b, r, kp)).astype(np.float32)
    kt = (rng.standard_normal((b, n, kp)) * rng.uniform(
        0.25, 4.0, (b, n, 1))).astype(np.float32)
    kt[0, 3] = 0.0
    jkq, jks = JQ.quant_store(jnp.asarray(kt))
    tkq, tks = Q.quant_store(torch.from_numpy(kt))
    want = JMA._int8_select_scores(jnp.asarray(q_t), jkq, jks, block_k=bk)
    got = TMA._int8_select_scores(torch.from_numpy(q_t), tkq, tks,
                                  block_k=bk)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    s_int = rng.integers(-2 ** 24, 2 ** 24, (b, r, n)).astype(np.int32)
    scale = rng.random((b, r, n)).astype(np.float32)
    np.testing.assert_array_equal(
        TM.dequant_topk_scores(torch.from_numpy(s_int),
                               torch.from_numpy(scale), block_k=bk).numpy(),
        np.asarray(JM.dequant_topk_scores(jnp.asarray(s_int),
                                          jnp.asarray(scale), block_k=bk)))


# -- twins and the quantized kernels' plain versions -----------------------------


def _quant_kv(rng, shape, kind):
    """Random K and V quantized by the reference: ((jk, jks), (jv, jvs))
    and the same as tensors."""
    out = []
    for _ in range(2):
        a = rng.standard_normal(shape).astype(np.float32)
        jq, js = JQ.quant_store(jnp.asarray(a), dtype=kind)
        out.append((jq, js, _torch(jq), _torch(js)))
    return out


def _pages(rng, b, n_kb, spare=3):
    n_pages = 1 + b * n_kb + spare
    return rng.permutation(np.arange(1, n_pages))[:b * n_kb].reshape(
        b, n_kb).astype(np.int32), n_pages


def _pool(a, tbl, n_pages, bk):
    """A dense (B, S, ...) numpy leaf on the pages of ``tbl``."""
    a = np.asarray(a)
    b, n_kb = tbl.shape
    pool = np.zeros((n_pages * bk,) + a.shape[2:], a.dtype)
    for i in range(b):
        for j in range(n_kb):
            p = tbl[i, j]
            pool[p * bk:(p + 1) * bk] = a[i, j * bk:(j + 1) * bk]
    return pool


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("s,bk,hq,hkv", [(128, 16, 4, 2), (100, 16, 8, 2),
                                         (128, 32, 8, 1)])
def test_quant_decode_plain_matches_reference(kind, s, bk, hq, hkv):
    """K1q's plain version and the decode twin with scales against the
    Pallas kernel and the reference twin; K4q's plain version and the
    paged twin on a page-shuffled pool against theirs, and K4q equal to
    K1q."""
    rng = np.random.default_rng(s + bk + hq)
    b, hd = 2, 32
    q = rng.standard_normal((b, 1, hq, hd)).astype(np.float32)
    (jk, jks, tk, tks), (jv, jvs, tv, tvs) = _quant_kv(
        rng, (b, s, hkv, hd), kind)
    kv_len = np.array([s - 3, s // 2 + 1], np.int32)
    n_kb = -(-s // bk)
    sb = rng.standard_normal((b, n_kb)).astype(np.float32)
    idx, ok = JM.decode_block_topk_indices(
        jnp.asarray(sb), min(n_kb, 4), kv_len=jnp.asarray(kv_len),
        block_k=bk, local=bk)
    ti, tok, tkl = _torch(idx), _torch(ok), torch.from_numpy(kv_len)
    jq, tq = jnp.asarray(q), torch.from_numpy(q)
    sc = dict(block_k=bk)
    got = tops.dsa_decode(tq, tk, tv, ti, tok, tkl, k_scale=tks, v_scale=tvs,
                          **sc)
    want = jops.dsa_decode(jq, jk, jv, idx, ok, jnp.asarray(kv_len),
                           k_scale=jks, v_scale=jvs, **sc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    twin = TA.dsa_decode_block_attention(tq, tk, tv, ti, tok, kv_len=tkl,
                                         k_scale=tks, v_scale=tvs, **sc)
    jtwin = JA.dsa_decode_block_attention(jq, jk, jv, idx, ok,
                                          kv_len=jnp.asarray(kv_len),
                                          k_scale=jks, v_scale=jvs, **sc)
    np.testing.assert_allclose(twin.numpy(), np.asarray(jtwin), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(twin.numpy(), got.numpy(), atol=1e-5,
                               rtol=1e-5)
    if s % bk:
        return                               # a pool is whole pages
    tbl, n_pages = _pages(rng, b, n_kb)
    pools = [_pool(a, tbl, n_pages, bk) for a in (jk, jv, jks, jvs)]
    jp = [jnp.asarray(p) for p in pools]
    tp = [_torch(p) for p in pools]
    pidx = np.take_along_axis(tbl, np.asarray(idx), axis=1)
    pg = tops.dsa_decode_paged(tq, tp[0], tp[1], ti, torch.from_numpy(pidx),
                               tok, tkl, k_scale=tp[2], v_scale=tp[3], **sc)
    pwant = jops.dsa_decode_paged(jq, jp[0], jp[1], idx, jnp.asarray(pidx),
                                  ok, jnp.asarray(kv_len), k_scale=jp[2],
                                  v_scale=jp[3], **sc)
    np.testing.assert_allclose(pg.numpy(), np.asarray(pwant), atol=1e-5,
                               rtol=1e-5)
    assert torch.equal(pg, got)
    ptwin = TA.dsa_decode_paged_block_attention(
        tq, tp[0], tp[1], ti, torch.from_numpy(pidx), tok, kv_len=tkl,
        k_scale=tp[2], v_scale=tp[3], **sc)
    jptwin = JA.dsa_decode_paged_block_attention(
        jq, jp[0], jp[1], idx, jnp.asarray(pidx), ok,
        kv_len=jnp.asarray(kv_len), k_scale=jp[2], v_scale=jp[3], **sc)
    np.testing.assert_allclose(ptwin.numpy(), np.asarray(jptwin), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("kind", [None] + KINDS)
@pytest.mark.parametrize("s,c,hq,hkv,blk,q_off,chunk_len", [
    (64, 32, 4, 2, 16, [0, 32], [32, 19]),
    (100, 32, 4, 4, 16, [64, 32], [36, 5]),      # S not a block multiple
    (128, 64, 8, 1, 32, [64, 0], [41, 64])])
def test_quant_chunk_plain_matches_reference(kind, s, c, hq, hkv, blk, q_off,
                                             chunk_len):
    """K3q's plain version and the chunk twin with scales against the
    Pallas kernel and the reference twin (kind None: K3 itself); K5's and
    K5q's plain versions on a page-shuffled pool against the reference's
    paged kernel, and equal to K3/K3q."""
    rng = np.random.default_rng(s + c + hq)
    b, hd = 2, 32
    q = rng.standard_normal((b, c, hq, hd)).astype(np.float32)
    if kind is None:
        kv = [rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
              for _ in range(2)]
        jk, jv = (jnp.asarray(a) for a in kv)
        tk, tv = (torch.from_numpy(a) for a in kv)
        jks = jvs = tks = tvs = None
    else:
        (jk, jks, tk, tks), (jv, jvs, tv, tvs) = _quant_kv(
            rng, (b, s, hkv, hd), kind)
    q_off = np.asarray(q_off, np.int32)
    kv_len = q_off + np.asarray(chunk_len, np.int32)
    n_kb = -(-s // blk)
    bs = rng.standard_normal((b, c // blk, n_kb)).astype(np.float32)
    idx, ok = JM.chunk_block_topk_indices(
        jnp.asarray(bs), min(n_kb, 3), q_block_offset=jnp.asarray(
            q_off // blk))
    ti, tok = _torch(idx), _torch(ok)
    tqo, tkl = torch.from_numpy(q_off), torch.from_numpy(kv_len)
    jq, tq = jnp.asarray(q), torch.from_numpy(q)
    kw = dict(block_q=blk, block_k=blk)
    got = tops.dsa_chunk_prefill(tq, tk, tv, ti, tok, tqo, tkl, k_scale=tks,
                                 v_scale=tvs, **kw)
    want = jops.dsa_chunk_prefill(jq, jk, jv, idx, ok, jnp.asarray(q_off),
                                  jnp.asarray(kv_len), k_scale=jks,
                                  v_scale=jvs, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    twin = TA.dsa_chunk_block_attention(tq, tk, tv, ti, tok, q_offset=tqo,
                                        kv_len=tkl, k_scale=tks, v_scale=tvs,
                                        **kw)
    jtwin = JA.dsa_chunk_block_attention(
        jq, jk, jv, idx, ok, q_offset=jnp.asarray(q_off),
        kv_len=jnp.asarray(kv_len), k_scale=jks, v_scale=jvs, **kw)
    np.testing.assert_allclose(twin.numpy(), np.asarray(jtwin), atol=1e-5,
                               rtol=1e-5)
    if s % blk:
        return                               # a pool is whole pages
    tbl, n_pages = _pages(rng, b, n_kb)
    leaves = (jk, jv) if kind is None else (jk, jv, jks, jvs)
    pools = [_pool(a, tbl, n_pages, blk) for a in leaves]
    jp = [jnp.asarray(p) for p in pools] + [None, None]
    tp = [_torch(p) for p in pools] + [None, None]
    pidx = np.take_along_axis(tbl[:, None, :].repeat(c // blk, 1),
                              np.asarray(idx), axis=2)
    pg = tops.dsa_chunk_prefill_paged(
        tq, tp[0], tp[1], ti, torch.from_numpy(pidx), tok, tqo, tkl,
        k_scale=tp[2], v_scale=tp[3], **kw)
    pwant = jops.dsa_chunk_prefill_paged(
        jq, jp[0], jp[1], idx, jnp.asarray(pidx), ok, jnp.asarray(q_off),
        jnp.asarray(kv_len), k_scale=jp[2], v_scale=jp[3], **kw)
    np.testing.assert_allclose(pg.numpy(), np.asarray(pwant), atol=1e-5,
                               rtol=1e-5)
    assert torch.equal(pg, got)


def test_quant_kernel_wrappers_refuse_missing_or_stray_scales():
    """On the card a narrow cache needs both scales and a full-width one
    none; the check runs before any launch (here on a meta tensor)."""
    from repro_torch.kernels import _launch as LN
    dev = torch.device("meta")
    k8 = torch.zeros((1, 16, 2, 16), dtype=torch.int8, device=dev)
    kf = torch.zeros((1, 16, 2, 16), device=dev)
    sc = torch.zeros((1, 16, 2), device=dev)
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        LN.check_scales(k8, None, None, dev)
    with pytest.raises(ValueError, match="no scales"):
        LN.check_scales(kf, sc, sc, dev)
    with pytest.raises(ValueError, match="shape"):
        LN.check_scales(k8, sc[:, :8], sc[:, :8], dev)
    ptrs, strides = LN.check_scales(k8, sc, sc, dev)
    assert strides == (32, 2) and len(ptrs) == 2


# -- the model's steps against the reference ------------------------------------


def _prefilled(kv, sel, mode, lengths, plen=48, arch="yi_6b", b=2):
    """Both sides prefilled with the same ragged prompts and truncated;
    the caches compared, then unstacked for decode."""
    jc, jparams, tc, tparams = _params(arch)
    jdf, tdf = _flags(kv, sel, mode)
    jpf = dataclasses.replace(jdf, mode="prefill")
    tpf = dataclasses.replace(tdf, mode="prefill")
    toks = np.random.default_rng(plen).integers(
        1, jc.vocab - 4, size=(b, plen)).astype(np.int32)
    jcache = JT.init_cache(jc, b, MAX_LEN, jdf, dtype=jnp.float32)
    jlog, _, jcache = JT.forward(jparams, jc, jpf,
                                 {"tokens": jnp.asarray(toks)}, caches=jcache)
    jcache = JT.truncate_cache(jc, jcache, jnp.asarray(lengths))
    tcache = TT.init_cache(tc, b, MAX_LEN, tdf, dtype=torch.float32,
                           device="cpu")
    with torch.inference_mode():
        tlog, tcache = TT.forward(tparams, tc, tpf, torch.from_numpy(toks),
                                  tcache)
        TT.truncate_cache(tc, tcache, torch.from_numpy(lengths))
    _close(tlog.numpy(), jlog, what="prefill logits")
    _compare_caches(tcache, jcache, what="prefill")
    tok = np.asarray(jlog)[np.arange(b), lengths - 1].argmax(-1)[:, None]
    return (jc, jparams, jdf, JT.unstack_group_caches(jcache), tc, tparams,
            tdf, tcache, tok.astype(np.int32))


def _decode_both(state, steps=3, frozen_step=1):
    """Decode steps on both sides, row 1 frozen at ``frozen_step``:
    logits of the active rows and every selection compared."""
    jc, jparams, jdf, jcache, tc, tparams, tdf, tcache, tok = state
    b = tok.shape[0]
    with _Selections(TM, "decode_block_topk_indices") as ts, \
            _Selections(JM, "decode_block_topk_indices") as js:
        for step in range(steps):
            active = np.ones((b,), bool)
            if step == frozen_step:
                active[1] = False
            jlog, jcache = JT.decode_step(jparams, jc, jdf,
                                          jnp.asarray(tok), jcache,
                                          active=jnp.asarray(active))
            with torch.inference_mode():
                tlog, tcache = TT.decode_step(tparams, tc, tdf,
                                              torch.from_numpy(tok), tcache,
                                              active=torch.from_numpy(active))
            _close(tlog.numpy()[active], np.asarray(jlog)[active],
                   what=("decode logits", step))
            nxt = np.asarray(jlog)[:, -1].argmax(-1)[:, None]
            tok = np.where(active[:, None], nxt, tok).astype(np.int32)
    _same_selections(ts, js)
    return jcache, tcache


@pytest.mark.parametrize("kv,sel,mode", GRID)
def test_decode_step_matches_reference(kv, sel, mode):
    """Prefill + truncate (the scale leaves masked, ktb rebuilt from the
    dequantized kt), then decode steps with a frozen row: logits, the
    selected blocks of every layer and step, and every cache leaf."""
    state = _prefilled(kv, sel, mode, np.array([48, 37], np.int32))
    jcache, tcache = _decode_both(state)
    _compare_caches(tcache, jcache, what="decode")


@pytest.mark.parametrize("kv,sel,mode", GRID)
def test_paged_decode_step_matches_reference(kv, sel, mode):
    """The prefilled caches of both sides moved onto the same shuffled
    pages (slot 1's last block unmapped), then paged decode steps:
    logits, selections and every pool leaf."""
    jc, jparams, jdf, jcache, tc, tparams, tdf, tcache, tok = _prefilled(
        kv, sel, mode, np.array([48, 30], np.int32))
    bk = tc.dsa.block_k
    b, n_kb = 2, MAX_LEN // bk
    rng = np.random.default_rng(11)
    tbl, n_pages = _pages(rng, b, n_kb)
    tbl[1, -1] = 0                           # unmapped: reads the zero page
    jpaged = JT.unstack_group_caches(JT.init_cache(
        jc, b, MAX_LEN, jdf, dtype=jnp.float32, pages=n_pages))
    tpaged = TT.init_cache(tc, b, MAX_LEN, tdf, dtype=torch.float32,
                           device="cpu", pages=n_pages)
    for gi, (jl, tl) in enumerate(zip(_layers(jcache), _layers(tcache))):
        jg = dict(jpaged["groups"][gi]["b0"]["attn"])
        tg = tpaged["groups"][gi]["b0"]["attn"]
        for name, dense in jl.items():
            if name == "pos":
                jg[name], tg[name] = dense, _torch(dense)
                continue
            a = np.asarray(dense)
            if name in ("ktb", "ktb_s"):
                pool = np.zeros((n_pages,) + a.shape[2:], a.dtype)
                for i in range(b):
                    for j in range(n_kb):
                        pool[tbl[i, j]] = a[i, j]
                pool[0] = 0
            else:
                pool = _pool(a, tbl, n_pages, bk)
                pool[:bk] = 0
            jg[name], tg[name] = jnp.asarray(pool), _torch(pool)
        jg["page_tbl"] = jnp.asarray(tbl)
        tg["page_tbl"] = torch.from_numpy(tbl)
        jpaged["groups"][gi]["b0"]["attn"] = jg
    state = (jc, jparams, jdf, jpaged, tc, tparams, tdf, tpaged, tok)
    jcache, tcache = _decode_both(state)
    _compare_caches(tcache, jcache, what="paged decode")
    for tl in _layers(tcache):                # the zero page stays zero
        for name in ("k", "v", "kt", "k_s", "v_s", "kt_s"):
            if name in tl:
                assert not Q.raw(tl[name][:bk]).any(), name
        for name in ("ktb", "ktb_s"):
            if name in tl:
                assert not tl[name][0].any(), name


@pytest.mark.parametrize("kv,sel,mode", GRID)
def test_chunk_step_matches_reference(kv, sel, mode):
    """Chunks of a ragged pair of prompts through a bucket-sized staging
    cache, row 1 frozen for one chunk: live logits after every chunk,
    every selection, and every cache leaf at the end."""
    jc, jparams, tc, tparams = _params("yi_6b")
    jf, tf = _flags(kv, sel, mode)
    b, bucket, chunk = 2, 64, 32
    lengths = np.array([bucket, bucket - 13], np.int32)
    toks = np.random.default_rng(7).integers(
        1, jc.vocab - 4, size=(b, bucket)).astype(np.int32)
    jcache = JT.unstack_group_caches(JT.init_cache(jc, b, bucket, jf,
                                                   dtype=jnp.float32))
    tcache = TT.init_cache(tc, b, bucket, tf, dtype=torch.float32,
                           device="cpu")
    done = np.zeros((b,), np.int32)
    with _Selections(TM, "chunk_block_topk_indices") as ts, \
            _Selections(JM, "chunk_block_topk_indices") as js:
        for j in range(bucket // chunk + 1):
            active = np.array([True, j != 1])
            cl = np.clip(lengths - done, 0, chunk).astype(np.int32)
            cols = np.clip(done[:, None] + np.arange(chunk)[None], 0,
                           bucket - 1)
            tk = np.take_along_axis(toks, cols, axis=1)
            jlog, jcache = JT.chunk_step(jparams, jc, jf, jnp.asarray(tk),
                                         jcache, jnp.asarray(cl),
                                         active=jnp.asarray(active),
                                         sel_len=bucket)
            with torch.inference_mode():
                tlog, tcache = TT.chunk_step(
                    tparams, tc, tf, torch.from_numpy(tk), tcache,
                    torch.from_numpy(cl), active=torch.from_numpy(active),
                    sel_len=bucket)
            live = (np.arange(chunk)[None] < cl[:, None]) & active[:, None]
            if live.any():
                _close(tlog.numpy()[live], np.asarray(jlog)[live],
                       what=("chunk logits", j))
            done = done + np.where(active, cl, 0)
    assert (done == lengths).all()
    _same_selections(ts, js)
    _compare_caches(tcache, jcache, what="chunk")


@pytest.mark.parametrize("kv,sel", [("int8", "int8"), ("fp8", "float32")])
def test_truncate_cache_matches_reference(kv, sel):
    """A random quantized cache truncated to ragged lengths on both
    sides: data rows and scales past each length zeroed (bitwise), ktb
    rebuilt from the dequantized kt and requantized."""
    jc, _, tc, _ = _params("yi_6b")
    jf, tf = _flags(kv, sel, "block")
    b = 2
    jcache = JT.init_cache(jc, b, MAX_LEN, jf, dtype=jnp.float32)
    rng = np.random.default_rng(3)

    def fill(a):
        a = np.asarray(a)
        if a.dtype == np.int32:
            return a
        r = rng.standard_normal(a.shape).astype(np.float32)
        if a.dtype == np.float32:
            return np.abs(r)
        return np.asarray(jnp.asarray(np.clip(r * 40, -120, 120)).astype(
            a.dtype))

    jcache = jax.tree.map(lambda a: jnp.asarray(fill(a)), jcache)
    tcache = {"groups": [{"b0": {"attn": {
        name: _torch(np.asarray(a)[i]) for name, a in
        jcache["groups"]["b0"]["attn"].items()}}}
        for i in range(tc.n_layers)]}
    lengths = np.array([40, 17], np.int32)
    jcache = JT.truncate_cache(jc, jcache, jnp.asarray(lengths))
    TT.truncate_cache(tc, tcache, torch.from_numpy(lengths))
    for tl, jl in zip(_layers(tcache), _layers(jcache)):
        for name in tl:
            if name in ("ktb", "ktb_s"):
                continue
            np.testing.assert_array_equal(_f32(tl[name]), _f32(jl[name]),
                                          err_msg=name)
        if "ktb_s" in tl:
            _within_a_step(tl["ktb"], tl["ktb_s"], jl["ktb"], jl["ktb_s"],
                           what="ktb")
        else:
            _close(_f32(tl["ktb"]), _f32(jl["ktb"]), what="ktb")


# -- engines ----------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _prompts(vocab):
    return np.random.default_rng(1).integers(
        1, vocab - 4, size=(2, 40)).astype(np.int32)


@pytest.mark.parametrize("kv,sel,mode", GRID + [("int8", "float32", "off"),
                                                ("fp8", "float32", "off")])
def test_engine_greedy_tokens_equal_reference(kv, sel, mode):
    """The static engine's greedy tokens on ragged prompts; DSA yi_6b on
    the grid, dense stablelm_3b (DSA off) with a quantized K/V cache."""
    arch = "yi_6b" if mode != "off" else "stablelm_3b"
    jc, jparams, tc, tparams = _params(arch)
    kw = dict(max_len=MAX_LEN, long_context=mode != "off", dsa_mode=mode,
              select_dtype=sel, kv_quant=kv)
    prompts, lengths = _prompts(jc.vocab), np.array([40, 29], np.int32)
    want = JEngine(jc, jparams, **kw).generate(prompts, 8, lengths=lengths)
    got = TE.Engine(tc, tparams, device="cpu", **kw).generate(
        prompts, 8, lengths=lengths)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))


SHAPES = [(48, 8), (21, 12), (65, 5), (30, 10), (17, 7)]


def _requests(mod, vocab, shapes=SHAPES, greedy=True):
    rng = np.random.default_rng(0)
    return [mod.Request(rid, rng.integers(1, vocab - 4, size=(n,)).astype(
        np.int32), n_new, greedy=greedy, seed=rid * 7 + 1)
        for rid, (n, n_new) in enumerate(shapes)]


QUANT = dict(slots=2, max_len=MAX_LEN, seg_len=4, long_context=True,
             select_dtype="int8", kv_quant="int8")


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_continuous_greedy_tokens_equal_reference(paged):
    """The continuous engine with int8 K/V and int8 selection, on the
    reference's fixtures (max_len 96, 2 slots, segments of 4): the
    reference continuous engine's greedy tokens."""
    jc, jparams, tc, tparams = _params("yi_6b")
    kw = dict(QUANT, dsa_mode="kernel", paged=paged)
    want = JS.ContinuousEngine(jc, jparams, **kw).run(_requests(JS, jc.vocab))
    eng = TS.ContinuousEngine(tc, tparams, device="cpu", **kw)
    got = eng.run(_requests(TS, tc.vocab))
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]),
                                      err_msg=f"rid {rid}")
    if paged:
        assert eng.pool.available() == eng.pool_pages - 1


# -- inside the port ----------------------------------------------------------------


@pytest.mark.parametrize("chunked", [False, True],
                         ids=["blocking", "chunked"])
@pytest.mark.parametrize("kv", KINDS)
def test_quant_paged_equals_dense_and_blocking_equals_solo(kv, chunked):
    """Quantized continuous serving, greedy and sampled: paged == dense
    (the scale leaves ride the page table with their rows) under either
    admission; with blocking admission each request also gets its solo
    ``Engine.generate`` tokens.  Chunked admission does not (reference
    and port alike): see the next test."""
    _, _, tc, tparams = _params("yi_6b")
    kw = dict(QUANT, kv_quant=kv, dsa_mode="block", chunked_prefill=chunked)
    reqs = _requests(TS, tc.vocab, SHAPES[:3]) + [
        dataclasses.replace(r, rid=r.rid + 10, greedy=False)
        for r in _requests(TS, tc.vocab, SHAPES[3:])]
    dense = TS.ContinuousEngine(tc, tparams, device="cpu", **kw).run(reqs)
    paged = TS.ContinuousEngine(tc, tparams, device="cpu", paged=True,
                                **kw).run(reqs)
    solo = TE.Engine(tc, tparams, device="cpu", **{
        k: v for k, v in kw.items()
        if k not in ("slots", "seg_len", "chunked_prefill")})
    for r in reqs:
        np.testing.assert_array_equal(paged[r.rid], dense[r.rid])
        if not chunked:
            want = solo.generate(r.prompt[None], r.n_new, greedy=r.greedy,
                                 seed=r.seed).tokens[0]
            np.testing.assert_array_equal(dense[r.rid], want)


@pytest.mark.parametrize("kv", [None] + KINDS)
def test_quant_chunk_prefill_attends_quantized_rows(kv):
    """Why chunked admission under kv_quant is not token-exact against
    whole-prompt prefill (ROADMAP Queue 3): a chunk attends its own rows
    through the quantized cache, whole prefill attends them in full
    precision.  The last prompt row's logits of chunk_step agree with
    whole prefill at the model tolerance on a full-width cache and miss
    it by the quantization error on a quantized one."""
    _, _, tc, tparams = _params("yi_6b")
    df = RunFlags(mode="decode", dsa_mode="block", long_context=True,
                  kv_quant=kv)
    pf = dataclasses.replace(df, mode="prefill")
    plen = 64
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        1, tc.vocab - 4, size=(1, plen)).astype(np.int32))
    with torch.inference_mode():
        whole, _ = TT.forward(tparams, tc, pf, toks, TT.init_cache(
            tc, 1, plen, df, dtype=torch.float32, device="cpu"))
        cache = TT.init_cache(tc, 1, plen, df, dtype=torch.float32,
                              device="cpu")
        for j in range(0, plen, 32):
            chunk, cache = TT.chunk_step(tparams, tc, df, toks[:, j:j + 32],
                                         cache, torch.tensor([32]))
    got, want = chunk[0, -1].numpy(), whole[0, -1].numpy()
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    if kv is None:
        assert err <= REL * scale, (err, scale)
    else:
        assert err > 10 * REL * scale, (err, scale)


def test_default_flags_leave_cache_unchanged():
    """select_dtype "float32" and kv_quant None grow no scale leaf and
    keep every leaf's shape and dtype."""
    _, _, tc, _ = _params("yi_6b")
    for pages in (None, 16):
        base = TT.init_cache(tc, 2, MAX_LEN, RunFlags(mode="decode",
                                                      long_context=True),
                             dtype=torch.float32, device="meta", pages=pages)
        flags = TE.Engine(tc, TT.init_model(0, tc, device="cpu"),
                          device="cpu", max_len=MAX_LEN,
                          long_context=True).decode_flags
        assert (flags.select_dtype, flags.kv_quant) == ("float32", None)
        c = TT.init_cache(tc, 2, MAX_LEN, flags, dtype=torch.float32,
                          device="meta", pages=pages)
        for tl, bl in zip(_layers(c), _layers(base)):
            assert list(tl) == list(bl)
            assert not any(n.endswith("_s") for n in tl)
            for n in tl:
                assert (tl[n].shape, tl[n].dtype) == (bl[n].shape,
                                                      bl[n].dtype)


@pytest.mark.parametrize("kv", KINDS)
def test_quant_cache_packs_more_slots(kv):
    """int8/fp8 K/V and int8 kt with f32 scales fit >= 1.8x the slots of
    the f32 cache in the same bytes (counted from the leaves' shapes)."""
    _, _, tc, _ = _params("yi_6b")

    def nbytes(**q):
        flags = RunFlags(mode="decode", long_context=True, **q)
        c = TT.init_cache(tc, 2, MAX_LEN, flags, dtype=torch.float32,
                          device="meta")
        return sum(t.numel() * t.element_size() for lay in _layers(c)
                   for t in lay.values())
    ratio = nbytes() / nbytes(select_dtype="int8", kv_quant=kv)
    assert ratio >= 1.8, ratio


@pytest.mark.parametrize("field,bad", [("select_dtype", "int4"),
                                       ("kv_quant", "nf4")])
def test_serving_config_rejects_invalid(field, bad):
    with pytest.raises(ValueError, match=field):
        ServingConfig(**{field: bad})


def test_quant_outside_envelope_raises():
    _, _, tc, tparams = _params("yi_6b")
    assert TE.can_bucket_prompts(tc)
    with pytest.raises(ValueError, match="long_context"):
        TE.Engine(tc, tparams, device="cpu", max_len=MAX_LEN,
                  select_dtype="int8")
    swa = dataclasses.replace(tc, swa_window=32)
    assert not TE.can_bucket_prompts(swa)
    with pytest.raises(ValueError, match="quant"):
        TE.Engine(swa, tparams, device="cpu", max_len=MAX_LEN,
                  kv_quant="int8")
