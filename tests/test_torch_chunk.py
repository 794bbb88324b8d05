"""The chunk-append path of the PyTorch port against the JAX reference:
K3's plain version (kernels/dsa_chunk_prefill.py) against the Pallas
kernel in interpret mode and the plain twins, the chunk block selection,
``chunk_attention``, and ``chunk_step`` (logits at the live rows and
every cache leaf) on reduced yi_6b and stablelm_3b.  ``chunk_step`` is
compared with the reference's ``chunk_step``, not with whole prefill: the
reference's own chunk == whole contract does not hold under this JAX.

Tolerances: K3 as |got - want| <= atol + rtol * |want| with f32
atol/rtol 1e-5 (same arithmetic, another summation order) and bf16 q
atol 1e-4, rtol 1e-2 (one bf16 rounding of an f32 result, at most 2^-7
of the value); the model at 1e-4 of the largest magnitude of each
compared array (f32, other summation orders and libm), ``pos`` exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core import attention as JA
from repro.core import masks as JM
from repro.kernels import ops as jops
from repro.models import transformer as JT
from repro.models.attention import RunFlags as JFlags
from repro_torch import convert
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import attention as TA
from repro_torch.core import masks as TM
from repro_torch.kernels import dsa_chunk_prefill as K3
from repro_torch.kernels import ops as tops
from repro_torch.models import transformer as TT
from repro_torch.models.attention import RunFlags

torch.set_num_threads(1)

TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-4, 1e-2)}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
REL = 1e-4


def _pair(a: np.ndarray, dtype: str):
    jd, td = DT[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _close(got, want, rel=REL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.max(np.abs(want))), 1e-6)
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * scale, (what, err, scale)


# -- K3 and the chunk selection ------------------------------------------------


def _k3_case(rng, b, s, c, hq, hkv, hd, blk, q_off, chunk_len):
    """A chunk of C queries at per-row offsets q_off (block multiples)
    over an S-row cache, rows ragged by chunk_len; the selection comes
    from the reference's chunk_block_topk_indices on random scores."""
    q = rng.standard_normal((b, c, hq, hd)).astype(np.float32)
    kc = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    vc = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    n_kb = -(-s // blk)
    bs = rng.standard_normal((b, c // blk, n_kb)).astype(np.float32)
    q_off = np.asarray(q_off, np.int32)
    kv_len = q_off + np.asarray(chunk_len, np.int32)
    nb = min(n_kb, 3)
    idx, ok = JM.chunk_block_topk_indices(
        jnp.asarray(bs), nb, q_block_offset=jnp.asarray(q_off // blk))
    return q, kc, vc, bs, idx, ok, q_off, kv_len, nb


K3_CASES = [
    # b, s, c, hq, hkv, hd, block, q_off, chunk_len
    (2, 64, 32, 4, 2, 16, 16, [0, 32], [32, 19]),
    (2, 96, 48, 8, 2, 32, 16, [48, 16], [48, 48]),
    (2, 100, 32, 4, 4, 16, 16, [64, 32], [36, 5]),     # S not a block multiple
    (1, 128, 64, 8, 1, 32, 32, [64], [41]),
]


@pytest.mark.parametrize("case", K3_CASES, ids=lambda c: f"S{c[1]}C{c[2]}"
                         f"H{c[3]}x{c[4]}bk{c[6]}")
@pytest.mark.parametrize("qdt", ["float32", "bfloat16"])
def test_k3_plain_matches_pallas_and_twins(case, qdt):
    b, s, c, hq, hkv, hd, blk, q_off, chunk_len = case
    rng = np.random.default_rng(s + c + hq)
    q, kc, vc, _, idx, ok, q_off, kv_len, _ = _k3_case(
        rng, b, s, c, hq, hkv, hd, blk, q_off, chunk_len)
    jq, tq = _pair(q, qdt)
    (jk, tk), (jv, tv) = _pair(kc, "float32"), _pair(vc, "float32")
    ti, tok = torch.from_numpy(np.array(idx)), torch.from_numpy(np.array(ok))
    tqo, tkv = torch.from_numpy(q_off), torch.from_numpy(kv_len)
    kw = dict(block_q=blk, block_k=blk)
    got = tops.dsa_chunk_prefill(tq, tk, tv, ti, tok, tqo, tkv, **kw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    pallas = jops.dsa_chunk_prefill(jq, jk, jv, idx, ok, jnp.asarray(q_off),
                                    jnp.asarray(kv_len), **kw)
    atol, rtol = TOL[qdt]
    np.testing.assert_allclose(_np(got), _np(pallas), atol=atol, rtol=rtol)
    if qdt != "float32":
        return
    # the twins take a plain softmax over every gathered key, so a row with
    # no live key averages v where the kernels give 0: compare live rows
    twin = TA.dsa_chunk_block_attention(tq, tk, tv, ti, tok, q_offset=tqo,
                                        kv_len=tkv, **kw)
    jtwin = JA.dsa_chunk_block_attention(jq, jk, jv, idx, ok, q_offset=jnp.
                                         asarray(q_off), kv_len=jnp.asarray(
                                             kv_len), **kw)
    qpos = q_off[:, None] + np.arange(c)[None, :]
    kpos = np.array(idx)[..., None] * blk + np.arange(blk)   # (B,nQb,nb,Bk)
    live_k = ((kpos < kv_len[:, None, None, None])
              & np.array(ok)[..., None]).reshape(b, c // blk, -1)
    live_row = np.stack([
        (np.repeat(live_k[i], blk, axis=0)
         & (kpos[i].reshape(c // blk, -1).repeat(blk, axis=0)
            <= qpos[i][:, None])).any(-1) for i in range(b)])   # (B, C)
    assert live_row.any()
    np.testing.assert_allclose(_np(got)[live_row], _np(twin)[live_row],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(twin), _np(jtwin), atol=1e-5, rtol=1e-5)
    assert not _np(got)[~live_row].any()          # dead rows come out 0


def test_k3_wrapper_takes_plain_version_only_on_cpu():
    q = torch.zeros((1, 2, 16, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        K3.dsa_chunk_gather_attention(q, q, q, q, q, q, q, block_q=16,
                                      block_k=16)


@pytest.mark.parametrize("n_qb,n_kb,nb,local", [(2, 4, 2, 1), (4, 8, 3, 1),
                                                (3, 6, 4, 2)])
def test_chunk_block_topk_indices_match_reference(n_qb, n_kb, nb, local):
    rng = np.random.default_rng(n_qb * n_kb + nb)
    bs = rng.standard_normal((3, n_qb, n_kb)).astype(np.float32)
    off = np.array([0, 1, n_kb - n_qb], np.int32)
    jidx, jok = JM.chunk_block_topk_indices(
        jnp.asarray(bs), nb, q_block_offset=jnp.asarray(off),
        local_blocks=local)
    tidx, tok = TM.chunk_block_topk_indices(
        torch.from_numpy(bs), nb, q_block_offset=torch.from_numpy(off),
        local_blocks=local)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))


def test_chunk_attention_matches_reference():
    rng = np.random.default_rng(5)
    b, c, s, hq, hkv, hd = 2, 16, 48, 4, 2, 16
    q = rng.standard_normal((b, c, hq, hd)).astype(np.float32)
    kc = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    vc = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    q_pos = np.array([0, 24], np.int32)[:, None] + np.arange(c)[None]
    mask = rng.random((b, c, s)) < 0.7
    for tm in (None, mask):
        want = JA.chunk_attention(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
            jnp.asarray(q_pos),
            token_mask=None if tm is None else jnp.asarray(tm))
        got = TA.chunk_attention(
            torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
            torch.from_numpy(q_pos),
            token_mask=None if tm is None else torch.from_numpy(tm))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


# -- chunk_step ------------------------------------------------------------------


def _compare_caches(tcache, jcache):
    """Every leaf of every layer of an unstacked reference cache."""
    for i, (tl, jl) in enumerate(zip(tcache["groups"], jcache["groups"])):
        tc, jc = tl["b0"]["attn"], jl["b0"]["attn"]
        assert set(tc) == set(jc), (set(tc), set(jc))
        for name in tc:
            if name == "pos":
                np.testing.assert_array_equal(tc[name].numpy(),
                                              np.asarray(jc[name]))
            else:
                _close(tc[name].numpy(), jc[name], what=(i, name))


@pytest.mark.parametrize("arch,mode,bucket,chunk", [
    ("yi_6b", "off", 64, 32), ("yi_6b", "block", 64, 32),
    ("yi_6b", "kernel", 64, 32), ("yi_6b", "kernel", 48, 16),
    ("yi_6b", "block", 40, 16), ("yi_6b", "kernel", 16, 32),
    ("stablelm_3b", "off", 64, 32)])
def test_chunk_step_matches_reference(arch, mode, bucket, chunk):
    """Chunks of a ragged pair of prompts through a bucket-sized staging
    cache, the second row frozen for one chunk: logits at the live rows
    after every chunk and every cache leaf at the end.  Bucket 40 is not a
    block multiple (the token-granularity path); a 32-wide chunk over a
    16-row bucket writes past the cache end (a short prompt at full
    width, where chunks are at least a block of 128)."""
    jc, tc = jreduced(jget_config(arch)), reduced(get_config(arch))
    jparams, _ = JT.init_model(jax.random.PRNGKey(0), jc)
    tparams = convert.from_reference(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    b = 2
    lengths = np.array([bucket, bucket - 13], np.int32)
    n_chunks = -(-bucket // chunk)
    toks = np.random.default_rng(bucket + chunk).integers(
        1, jc.vocab - 4, size=(b, n_chunks * chunk)).astype(np.int32)
    jf = JFlags(mode="decode", dsa_mode=mode, with_mse=False,
                long_context=True)
    tf = RunFlags(mode="decode", dsa_mode=mode, long_context=True)
    jcache = JT.unstack_group_caches(JT.init_cache(jc, b, bucket, jf,
                                                   dtype=jnp.float32))
    tcache = TT.init_cache(tc, b, bucket, tf, dtype=torch.float32,
                           device="cpu")
    frozen = np.array([True, False])          # row 1 sits out chunk 1
    done = np.zeros((b,), np.int32)
    for j in range(n_chunks + 1):
        active = np.ones((b,), bool) if j != 1 else frozen
        cl = np.clip(lengths - done, 0, chunk).astype(np.int32)
        cols = np.clip(done[:, None] + np.arange(chunk)[None], 0,
                       toks.shape[1] - 1)
        tk = np.take_along_axis(toks, cols, axis=1)
        jlog, jcache = JT.chunk_step(jparams, jc, jf, jnp.asarray(tk),
                                     jcache, jnp.asarray(cl),
                                     active=jnp.asarray(active),
                                     sel_len=bucket)
        tlog, tcache = TT.chunk_step(tparams, tc, tf, torch.from_numpy(tk),
                                     tcache, torch.from_numpy(cl),
                                     active=torch.from_numpy(active),
                                     sel_len=bucket)
        live = (np.arange(chunk)[None] < cl[:, None]) & active[:, None]
        if live.any():
            _close(tlog.numpy()[live], np.asarray(jlog)[live],
                   what=("chunk logits", j))
        done = done + np.where(active, cl, 0)
    assert (done == lengths).all()
    _compare_caches(tcache, jcache)
