"""The port's mixture-of-experts layer (``repro_torch.models.moe``) against
the JAX reference's (``repro.models.moe``) on reduced mixtral_8x22b (4
experts, top 2, d 64, expert width 64), f32, the CPU, with the
reference's weights and the same numpy inputs.

Tolerances (f32, other summation orders):
- routing: expert ids EQUAL; routing weights and the aux term within
  1e-6 (absolute; both are softmax outputs of the same f32 logits);
- layer outputs and their gradients: 1e-5 of the largest magnitude of
  each compared array;
- dispatch positions (and so the set of dropped (token, slot) pairs)
  EQUAL: both sort the flat expert ids stably, token-major.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models import moe as JM
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import moe as TM

torch.set_num_threads(1)

ARCH = "mixtral_8x22b"
W_ATOL = 1e-6
REL = 1e-5


def _cfgs(**moe):
    jc, tc = jreduced(jget_config(ARCH)), reduced(get_config(ARCH))
    if moe:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, **moe))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, **moe))
    return jc, tc


def _params(jc, seed=0):
    jp, _ = JM.init_moe(jax.random.PRNGKey(seed), jc)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, rel=REL, what=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.max(np.abs(want))), 1e-6)
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * scale, (what, err, scale)


def _ids_equal(got, want, logits):
    """Equal expert ids; where one differs, the gap between the k-th and
    (k+1)-th logit of that token says whether it is a near-tie."""
    got, want = np.asarray(got), np.asarray(want)
    bad = np.argwhere((got != want).any(-1))
    if len(bad):
        srt = -np.sort(-np.asarray(logits), axis=-1)
        k = got.shape[-1]
        gaps = [float(srt[tuple(i)][k - 1] - srt[tuple(i)][k]) for i in bad]
        raise AssertionError(f"expert ids differ at {bad.tolist()}; k-th "
                             f"minus (k+1)-th logit there: {gaps}")


@pytest.mark.parametrize("shape", [(48,), (3, 16), (2, 1)],
                         ids=["tokens", "rows", "decode"])
def test_route_matches_reference(shape):
    """Top-k ids, softmax weights over the kept logits and the
    Switch-style aux on 2-D and 3-D inputs."""
    jc, tc = _cfgs()
    jp, tp = _params(jc)
    x = _x(shape + (jc.d_model,))
    jids, jw, jaux = JM._route(jp["router"], jnp.asarray(x), jc.moe.top_k)
    tids, tw, taux = TM._route(tp["router"], torch.from_numpy(x),
                               tc.moe.top_k)
    assert tids.dtype == torch.int32 and tw.dtype == torch.float32
    _ids_equal(tids.numpy(), jids, x @ np.asarray(jp["router"]))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                               atol=W_ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0,
                               atol=W_ATOL)


@pytest.mark.parametrize("cap", [64, 12, 2])
def test_dispatch_positions_match_reference(cap):
    """Each (token, slot)'s position in its expert's buffer, and so the
    set dropped at ``cap``, equal the reference's: earlier tokens win a
    full expert, slot 0 of a token before its slot 1."""
    jc, tc = _cfgs()
    jp, tp = _params(jc)
    x = _x((40, jc.d_model), seed=3)
    ids = np.asarray(JM._route(jp["router"], jnp.asarray(x), 2)[0])
    want = np.asarray(JM._dispatch_positions(jnp.asarray(ids.reshape(-1)),
                                             4, cap))
    got = TM._dispatch_positions(torch.tensor(ids.reshape(-1)).long(),
                                 4, cap)
    np.testing.assert_array_equal(got.numpy(), want)
    # 80 pairs over 4 experts: none dropped at 64, some at 12 and 2
    dropped = int((want >= cap).sum())
    assert (dropped > 0) == (cap < 64), dropped


@pytest.mark.parametrize("cap", [64, 12, 2], ids=["ample", "some", "heavy"])
def test_moe_local_matches_reference(cap):
    """The capacity dispatch on one token slab: ample capacity (no drop),
    some and heavy drops (cap 2: most pairs dropped, the output still
    finite)."""
    jc, tc = _cfgs()
    jp, tp = _params(jc)
    x = _x((40, jc.d_model), seed=4)
    jy, ja = JM._moe_local(jp, jc, jnp.asarray(x), cap)
    ty, ta = TM._moe_local(tp, tc, torch.from_numpy(x), cap)
    assert np.isfinite(ty.numpy()).all()
    _close(ty, jy, what="y")
    np.testing.assert_allclose(float(ta), float(ja), rtol=0, atol=W_ATOL)


@pytest.mark.parametrize("case", [
    dict(decode=False, s=24, moe={}),
    dict(decode=True, s=24, moe={}),
    dict(decode=False, s=1, moe={}),
    dict(decode=False, s=32, moe=dict(capacity_factor=0.5)),
    dict(decode=False, s=32, moe=dict(capacity_factor=1.0)),
    dict(decode=False, s=16, moe=dict(num_shared_experts=2)),
    dict(decode=True, s=16, moe=dict(num_shared_experts=1)),
], ids=["capacity", "dense", "one_token", "cf0.5", "cf1.0", "shared",
        "shared_dense"])
def test_apply_moe_matches_reference(case):
    """``apply_moe`` on (B, S, d): the capacity path per row (the aux the
    rows' mean), decode-dense under ``decode`` or a single token, drops
    at capacity factors 0.5 and 1.0 (cap = max(4, int(S k cf / E))),
    and shared experts added after, on both paths."""
    jc, tc = _cfgs(**case["moe"])
    jp, tp = _params(jc)
    x = _x((3, case["s"], jc.d_model), seed=6)
    jy, ja = JM.apply_moe(jp, jc, jnp.asarray(x), decode=case["decode"])
    ty, ta = TM.apply_moe(tp, tc, torch.from_numpy(x),
                          decode=case["decode"])
    assert set(ta) == set(ja) == {"router"}
    _close(ty, jy, what="y")
    np.testing.assert_allclose(float(ta["router"]), float(ja["router"]),
                               rtol=0, atol=W_ATOL)
    if case["moe"].get("num_shared_experts"):
        # zeroing the shared experts' output weights changes the output
        ty2, _ = TM.apply_moe(dict(tp, sw2=torch.zeros_like(tp["sw2"])), tc,
                              torch.from_numpy(x), decode=case["decode"])
        assert float((ty - ty2).abs().max()) > 1e-6
    if case["moe"].get("capacity_factor") == 0.5:
        # the drops are real: the dense path (no capacity) differs
        tyd, _ = TM.apply_moe(tp, tc, torch.from_numpy(x), decode=True)
        assert float((ty - tyd).abs().max()) > 1e-3


@pytest.mark.parametrize("decode,cf", [(False, 8.0), (False, 0.5),
                                       (True, 8.0)],
                         ids=["capacity", "drops", "dense"])
def test_gradients_match_jax_grad(decode, cf):
    """Gradients of sum(y * r) + aux with respect to every weight and to
    x against ``jax.grad``'s: through the top-k softmax weights, the
    router's f32 logits and the aux's probabilities; dropped pairs take
    no gradient on either side."""
    jc, tc = _cfgs(capacity_factor=cf, num_shared_experts=1)
    jp, tp = _params(jc)
    x = _x((2, 24, jc.d_model), seed=7)
    r = _x((2, 24, jc.d_model), seed=8)

    def jloss(p, xx):
        y, a = JM.apply_moe(p, jc, xx, decode=decode)
        return jnp.sum(y * r) + 10.0 * a["router"]

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, a = TM.apply_moe(tp, tc, tx, decode=decode)
    (torch.sum(y * torch.from_numpy(r)) + 10.0 * a["router"]).backward()
    for k, g in jg.items():
        _close(tp[k].grad, g, what=k)
    _close(tx.grad, jgx, what="x")


def test_expert_init_scale_reference_fault():
    """A reference fault the port keeps (ROADMAP Queue 3): ``dense_init``
    takes a tensor's first axis as its fan-in, which for an expert tensor
    (E, d, f) is E, so at mixtral's width the experts start with std
    1/sqrt(8) ~ 0.354, where the dense MLP's w1 (d, f) has 1/sqrt(6144) ~
    0.0128.  Both packages, the full d_model and 8 experts (expert width
    cut to 32 to keep the tensors small)."""
    from repro_torch.models.blocks import init_mlp
    jc = jget_config(ARCH)
    jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe,
                                                         d_ff_expert=32))
    tc = get_config(ARCH)
    tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe,
                                                         d_ff_expert=32))
    jp, _ = JM.init_moe(jax.random.PRNGKey(0), jc)
    tp = TM.init_moe(torch.Generator().manual_seed(0), tc, device="cpu")
    want = 1 / np.sqrt(8)
    for p in (jp, tp):
        for name in ("w1", "w3", "w2"):
            std = float(np.asarray(p[name]).std())
            assert abs(std - want) < 0.01 * want, (name, std)
        assert np.asarray(p["router"]).dtype == np.float32
        assert abs(float(np.asarray(p["router"]).std())
                   - 1 / np.sqrt(6144)) < 0.05 / np.sqrt(6144)
    mlp = init_mlp(torch.Generator().manual_seed(0),
                   dataclasses.replace(tc, d_ff=64), device="cpu")
    assert abs(float(mlp["w1"].std()) - 1 / np.sqrt(6144)) < 1e-3
