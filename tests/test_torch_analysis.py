"""The paper's analysis functions in the port against the JAX reference on
the same numpy inputs: the threshold, vector, block and oracle masks, the
prediction accuracy and attention sparsity metrics (paper Table 1, Table
3, Fig 4-6), the pooled and unpooled (paper-faithful) block scores, and
the Eq. 6 MSE.

Masks must be EQUAL.  Accuracies, sparsities, block scores and the MSE
agree to 1e-6 times max(1, the largest |value|): f32 summation order only
(a mean of n f32 terms may move by up to n f32 steps).  The scores that
feed a top-k are drawn with no ties at any threshold, so the masks cannot
differ by tie-breaking.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import masks as JM
from repro.core import prediction as JP
from repro_torch.core import masks as TM
from repro_torch.core import prediction as TP

torch.set_num_threads(1)

REL = 1e-6


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1.0)
    assert float(np.max(np.abs(got - want))) <= rel * scale


def _scores(seed, *shape):
    """Distinct scores per row (a permutation scaled), so no top-k
    threshold ties."""
    rng = np.random.default_rng(seed)
    n = shape[-1]
    perm = np.argsort(rng.random(shape), axis=-1).astype(np.float32)
    return (perm / n - 0.5 + 0.01 * rng.random(shape)).astype(np.float32)


def _weights(seed, b, lq, lk):
    """Causal softmax weights (B, Lq, Lk) and their validity."""
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((b, lq, lk)).astype(np.float32)
    valid = np.tril(np.ones((lq, lk), bool))[None].repeat(b, 0)
    s = np.where(valid, s, -1e9)
    w = np.exp(s - s.max(-1, keepdims=True))
    return (w / w.sum(-1, keepdims=True)).astype(np.float32), valid


@pytest.mark.parametrize("theta", [0.01, 0.05, 0.2])
@pytest.mark.parametrize("with_valid", [False, True])
def test_threshold_mask_equals_reference(theta, with_valid):
    w, valid = _weights(0, 2, 24, 24)
    want = JM.threshold_mask(jnp.asarray(w), theta,
                             jnp.asarray(valid) if with_valid else None)
    got = TM.threshold_mask(torch.from_numpy(w), theta,
                            torch.from_numpy(valid) if with_valid else None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rows,keep", [(1, 3), (4, 2), (8, 5)])
@pytest.mark.parametrize("with_valid", [False, True])
def test_vector_mask_equals_reference(rows, keep, with_valid):
    s = _scores(rows + keep, 2, 32, 40)
    valid = (np.random.default_rng(7).random((2, 32, 40)) < 0.8
             if with_valid else None)
    want = JM.vector_mask(jnp.asarray(s), rows, keep,
                          None if valid is None else jnp.asarray(valid))
    got = TM.vector_mask(torch.from_numpy(s), rows, keep,
                         None if valid is None else torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_vector_mask_refuses_ragged_rows():
    with pytest.raises(ValueError, match="multiple"):
        TM.vector_mask(torch.zeros((1, 10, 8)), 4, 2)


@pytest.mark.parametrize("nb", [1, 3, 6])
def test_block_mask_and_expansion_equal_reference(nb):
    rng = np.random.default_rng(nb)
    n_qb, n_kb = 6, 8
    bs = rng.standard_normal((2, n_qb, n_kb)).astype(np.float32)
    idx, ok = JM.block_topk_indices(jnp.asarray(bs), nb)
    idx, ok = np.array(idx), np.array(ok)
    want = JM.block_mask_from_indices(jnp.asarray(idx), jnp.asarray(ok),
                                      n_kb)
    got = TM.block_mask_from_indices(torch.from_numpy(idx),
                                     torch.from_numpy(ok), n_kb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want_t = JM.expand_block_mask(want, 16, 8)
    got_t = TM.expand_block_mask(got, 16, 8)
    assert got_t.shape == (2, n_qb * 16, n_kb * 8)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))


@pytest.mark.parametrize("keep", [1, 4, 12])
def test_oracle_accuracy_and_sparsity_equal_reference(keep):
    w, valid = _weights(keep, 2, 32, 32)
    pred = _scores(100 + keep, 2, 32, 32)
    jv, tv = jnp.asarray(valid), torch.from_numpy(valid)
    j_or = JM.oracle_topk_mask(jnp.asarray(w), keep, jv)
    t_or = TM.oracle_topk_mask(torch.from_numpy(w), keep, tv)
    np.testing.assert_array_equal(t_or.numpy(), np.asarray(j_or))
    j_pr = JM.row_topk_mask(jnp.asarray(pred), keep, jv)
    t_pr = TM.row_topk_mask(torch.from_numpy(pred), keep, tv)
    np.testing.assert_array_equal(t_pr.numpy(), np.asarray(j_pr))
    acc_j = JM.prediction_accuracy(j_pr, j_or)
    acc_t = TM.prediction_accuracy(t_pr, t_or)
    assert acc_t.dtype == torch.float32
    _close(acc_t.item(), float(acc_j))
    assert 0.0 < acc_t.item() <= 1.0
    # an empty prediction scores 0, not a division by zero
    assert TM.prediction_accuracy(torch.zeros_like(t_pr),
                                  t_or).item() == 0.0
    for theta in (1e-3, 0.02, 0.1):
        _close(TM.attention_sparsity(torch.from_numpy(w), theta).item(),
               float(JM.attention_sparsity(jnp.asarray(w), theta)))


def _predictor(rng, d, sigma=0.25):
    k = TP.predictor_k(d, sigma)
    u = rng.random((d, k))
    p = np.where(u < 1 / 6, -1.0, np.where(u < 2 / 6, 1.0, 0.0))
    return {"p": (np.sqrt(3.0 / k) * p).astype(np.float32),
            "wq": (rng.standard_normal((k, k)) / np.sqrt(k)).astype(
                np.float32),
            "wk": (rng.standard_normal((k, k)) / np.sqrt(k)).astype(
                np.float32)}


@pytest.mark.parametrize("pooled", [True, False])
@pytest.mark.parametrize("bits,bq,bk", [(4, 16, 16), (8, 8, 16),
                                        (32, 16, 8)])
def test_block_scores_pooled_and_unpooled_match_reference(pooled, bits, bq,
                                                          bk):
    rng = np.random.default_rng(bits + bq + bk)
    params = _predictor(rng, 64)
    x = rng.standard_normal((2, 48, 64)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    want = JP.predict_block_scores(jp, jnp.asarray(x), None, bits=bits,
                                   block_q=bq, block_k=bk, pooled=pooled)
    got = TP.predict_block_scores(tp, torch.from_numpy(x), None, bits=bits,
                                  block_q=bq, block_k=bk, pooled=pooled)
    assert got.shape == (2, 48 // bq, 48 // bk)
    _close(got.numpy(), want)


def test_pool_block_scores_matches_reference():
    s = np.random.default_rng(3).standard_normal((2, 32, 48)).astype(
        np.float32)
    want = JP.pool_block_scores(jnp.asarray(s), 8, 16)
    got = TP.pool_block_scores(torch.from_numpy(s), 8, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="multiples"):
        TP.pool_block_scores(torch.from_numpy(s), 5, 16)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_mse_loss_matches_reference(dtype):
    rng = np.random.default_rng(5)
    s = rng.standard_normal((2, 24, 24)).astype(np.float32)
    st = (s + 0.3 * rng.standard_normal((2, 24, 24))).astype(np.float32)
    if dtype == "bfloat16":
        want = JP.mse_loss(jnp.asarray(s, jnp.bfloat16),
                           jnp.asarray(st, jnp.bfloat16))
        got = TP.mse_loss(torch.from_numpy(s).bfloat16(),
                          torch.from_numpy(st).bfloat16())
    else:
        want = JP.mse_loss(jnp.asarray(s), jnp.asarray(st))
        got = TP.mse_loss(torch.from_numpy(s), torch.from_numpy(st))
    assert got.dtype == torch.float32
    _close(got.item(), float(want))
