"""The port's DSA prediction and selection against the JAX reference on
the same numpy inputs: fake-quant, the predictor, pooled block scores and
the prefill / decode block top-k.

Selections are compared as sets of kept blocks per row together with
``ok``: force-keep writes +inf into several blocks and the two top-k
implementations order ties differently.  Tolerances: 1e-5 relative for
f32 values (summation order only).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import masks as JM
from repro.core import prediction as JP
from repro.core import quantization as JQ
from repro_torch.core import masks as TM
from repro_torch.core import prediction as TP
from repro_torch.core import quantization as TQ

torch.set_num_threads(1)


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-6)
    assert float(np.max(np.abs(got - want))) <= rel * scale


def _predictor(rng, d, sigma=0.25):
    k = TP.predictor_k(d, sigma)
    u = rng.random((d, k))
    p = np.where(u < 1 / 6, -1.0, np.where(u < 2 / 6, 1.0, 0.0))
    return {"p": (np.sqrt(3.0 / k) * p).astype(np.float32),
            "wq": (rng.standard_normal((k, k)) / np.sqrt(k)).astype(
                np.float32),
            "wk": (rng.standard_normal((k, k)) / np.sqrt(k)).astype(
                np.float32)}


@pytest.mark.parametrize("bits", [2, 4, 8, 32])
def test_fake_quant_matches_reference(bits):
    rng = np.random.default_rng(bits)
    x = rng.standard_normal((3, 5, 24)).astype(np.float32)
    x[1, 2] = 0.0                       # zero row: scale 0 -> 1
    x[0, 0, :4] = [0.5, -0.5, 1.5, 2.5]  # halves round to even
    want = JQ.fake_quant(jnp.asarray(x), bits)
    got = TQ.fake_quant(torch.from_numpy(x), bits)
    _close(got.numpy(), want)


@pytest.mark.parametrize("d,lq,bits", [(64, 48, 4), (128, 32, 8)])
def test_predict_qk_and_block_scores_match_reference(d, lq, bits):
    rng = np.random.default_rng(d + lq)
    params = _predictor(rng, d)
    x = rng.standard_normal((2, lq, d)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    jq, jk = JP.predict_qk(jp, jnp.asarray(x), None, bits)
    tq, tk = TP.predict_qk(tp, torch.from_numpy(x), None, bits)
    _close(tq.numpy(), jq)
    _close(tk.numpy(), jk)
    _close(TP.predict_scores(tp, torch.from_numpy(x), bits=bits).numpy(),
           JP.predict_scores(jp, jnp.asarray(x), bits=bits))
    bs_want = JP.predict_block_scores(jp, jnp.asarray(x), bits=bits,
                                      block_q=16, block_k=16, pooled=True)
    bs_got = TP.predict_block_scores(tp, torch.from_numpy(x), bits=bits,
                                     block_q=16, block_k=16)
    _close(bs_got.numpy(), bs_want)


def _same_selection(got, want):
    (gi, gok), (wi, wok) = got, want
    gi, gok = gi.numpy(), gok.numpy()
    wi, wok = np.asarray(wi), np.asarray(wok)
    assert gi.dtype == np.int32 and gi.shape == wi.shape
    np.testing.assert_array_equal(gok, wok)
    for r in np.ndindex(gi.shape[:-1]):
        assert set(gi[r][gok[r]]) == set(wi[r][wok[r]]), r
        # kept indices ascend, invalid ones sit at the end
        kept = gi[r][gok[r]]
        assert np.all(np.diff(kept) > 0)
    # the fill of invalid entries matches too
    np.testing.assert_array_equal(np.where(gok, 0, gi), np.where(wok, 0, wi))


@pytest.mark.parametrize("n_qb,n_kb,nb,window_blocks,local",
                         [(8, 8, 3, 0, 1), (8, 8, 5, 2, 1), (4, 8, 3, 0, 2),
                          (16, 16, 2, 0, 1)])
def test_block_topk_indices_same_sets(n_qb, n_kb, nb, window_blocks, local):
    rng = np.random.default_rng(n_qb * 7 + nb)
    bs = rng.standard_normal((2, n_qb, n_kb)).astype(np.float32)
    kw = dict(causal=True, window_blocks=window_blocks, local_blocks=local)
    _same_selection(TM.block_topk_indices(torch.from_numpy(bs), nb, **kw),
                    JM.block_topk_indices(jnp.asarray(bs), nb, **kw))


@pytest.mark.parametrize("n_kb,bk,nb,local", [(8, 16, 4, 32), (6, 32, 5, 64),
                                              (12, 16, 3, 16)])
def test_decode_block_topk_indices_same_sets(n_kb, bk, nb, local):
    rng = np.random.default_rng(n_kb + nb)
    bs = rng.standard_normal((3, n_kb)).astype(np.float32)
    kv_len = np.array([n_kb * bk, n_kb * bk - 37, 5], np.int32)
    kw = dict(block_k=bk, local=local)
    _same_selection(
        TM.decode_block_topk_indices(torch.from_numpy(bs), nb,
                                     kv_len=torch.from_numpy(kv_len), **kw),
        JM.decode_block_topk_indices(jnp.asarray(bs), nb,
                                     kv_len=jnp.asarray(kv_len), **kw))


def test_row_topk_mask_and_keep_count_match_reference():
    rng = np.random.default_rng(3)
    s = rng.standard_normal((2, 12, 12)).astype(np.float32)
    valid = np.tril(np.ones((12, 12), bool))[None].repeat(2, 0)
    keep = TM.keep_count(12, 0.9)
    assert keep == JM.keep_count(12, 0.9)
    got = TM.row_topk_mask(torch.from_numpy(s), keep,
                           torch.from_numpy(valid))
    want = JM.row_topk_mask(jnp.asarray(s), keep, jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
