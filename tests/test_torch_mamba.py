"""The port's Mamba sub-block (``repro_torch.models.ssm``) against the JAX
reference's (``repro.models.ssm``) on reduced jamba_1_5_large (d 64, mi
128, state 8, conv 4; f32), the CPU, with the reference's weights carried
across by ``repro_torch.convert`` and the same numpy inputs.

- ``_mamba_scan`` from a zero and a random state, at lengths that take
  one chunk, a partial last chunk and the reference's checkpointed chunk
  path (S a multiple of 128 longer than 128), and its gradients with and
  without the chunk checkpoints;
- ``apply_mamba``'s prefill into a cache (y, ``h``, ``conv``) and four
  one-token decode steps from it; the cache's shapes and dtypes;
- a bf16 block on an f32 cache promotes its decode output to f32, as the
  reference's does;
- a masked decode step (``active``) leaves an inactive row's state as it
  was and gives the active rows the unmasked values.

Tolerances, as |got - want| <= rel * max|want| of each output: 1e-5 for
the layer (summation order and libm: the scan's f32 state and the conv's
four terms), 1e-4 for gradients (as tests/test_torch_train.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models import ssm as jssm
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import ssm
from repro_torch.models.attention import Active

torch.set_num_threads(1)

ARCH = "jamba_1_5_large"
REL = 1e-5
GRAD_REL = 1e-4


def _close(got, want, rel=REL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1e-6)
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * scale, (what, err, scale)


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _setup():
    """The reduced configs and sub-block b0's Mamba weights (the
    reference's, and the port's from ``convert``)."""
    jc, tc = jreduced(jget_config(ARCH)), reduced(get_config(ARCH))
    jparams, _ = JT.init_model(jax.random.PRNGKey(0), jc)
    tparams = convert.from_reference(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    jp = jax.tree.map(lambda a: a[0], jparams["groups"]["b0"]["attn"])
    return jc, tc, jp, tparams["groups"][0]["b0"]["attn"]


def _scan_inputs(seed, b, s, mi, n, state):
    g = np.random.default_rng(seed)
    xc = g.standard_normal((b, s, mi)).astype(np.float32)
    z = g.standard_normal((b, s, mi)).astype(np.float32)
    h0 = ((g.standard_normal((b, mi, n)) * 0.5).astype(np.float32)
          if state else None)
    return xc, z, h0


@pytest.mark.parametrize("s", [40, 128, 200, 256])
@pytest.mark.parametrize("state", [False, True], ids=["zero", "h0"])
def test_mamba_scan_matches_reference(s, state):
    """40 and 128 tokens are one chunk, 200 a whole chunk and a partial
    one, 256 the reference's checkpointed path (two chunks)."""
    jc, tc, jp, tp = _setup()
    mi = tc.d_model * tc.mamba.expand
    xc, z, h0 = _scan_inputs(s, 2, s, mi, tc.mamba.d_state, state)
    yj, hj = jssm._mamba_scan(jp, jc, jnp.asarray(xc), jnp.asarray(z),
                              None if h0 is None else jnp.asarray(h0))
    y, h = ssm._mamba_scan(tp, tc, _t(xc), _t(z),
                           None if h0 is None else _t(h0))
    assert h.dtype == torch.float32 and y.dtype == torch.float32
    _close(y.numpy(), yj, what="y")
    _close(h.numpy(), hj, what="h")


def _port_grads(tp, tc, xc, z, h0, ckpt: bool, monkeypatch):
    """d(sum(y * w) + sum(h))/d(inputs, weights) of the port's scan, with
    or without the chunk checkpoints."""
    if not ckpt:
        monkeypatch.setattr(ssm, "checkpoint",
                            lambda fn, *a, **k: fn(*a))
    params = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    ins = [_t(a).requires_grad_(True) for a in (xc, z, h0)]
    w = torch.linspace(-1, 1, xc.shape[-1])
    y, h = ssm._mamba_scan(params, tc, *ins)
    ((y * w).sum() + h.sum()).backward()
    monkeypatch.undo()
    return ([a.grad for a in ins]
            + [params[k].grad for k in ("x_proj", "dt_proj", "dt_bias",
                                        "a_log", "d_skip")])


def test_mamba_scan_gradients_with_and_without_chunk_checkpoints(
        monkeypatch):
    """At 256 tokens the port checkpoints each 128-token chunk (the
    reference's ``jax.checkpoint`` path): its gradients equal those of
    the same scan without checkpoints bit for bit, and the reference's
    ``jax.grad`` at the gradient tolerance."""
    jc, tc, jp, tp = _setup()
    mi = tc.d_model * tc.mamba.expand
    xc, z, h0 = _scan_inputs(9, 2, 256, mi, tc.mamba.d_state, True)
    calls = []
    real = ssm.checkpoint

    def counting(fn, *a, **k):
        calls.append(1)
        return real(fn, *a, **k)

    monkeypatch.setattr(ssm, "checkpoint", counting)
    with_ckpt = _port_grads(tp, tc, xc, z, h0, True, monkeypatch)
    assert len(calls) == 2
    without = _port_grads(tp, tc, xc, z, h0, False, monkeypatch)
    for a, b in zip(with_ckpt, without):
        assert torch.equal(a, b)
    w = jnp.linspace(-1, 1, mi)

    def loss(p, xc_, z_, h0_):
        y, h = jssm._mamba_scan(p, jc, xc_, z_, h0_)
        return jnp.sum(y * w) + jnp.sum(h)

    gp, *gi = jax.grad(loss, argnums=(0, 1, 2, 3))(
        jp, jnp.asarray(xc), jnp.asarray(z), jnp.asarray(h0))
    want = list(gi) + [gp[k] for k in ("x_proj", "dt_proj", "dt_bias",
                                       "a_log", "d_skip")]
    for i, (got, ref) in enumerate(zip(with_ckpt, want)):
        _close(got.numpy(), ref, GRAD_REL, what=("grad", i))


def test_cache_layout_matches_reference():
    """``h`` always f32 (B, mi, N); ``conv`` (B, d_conv - 1, mi) in the
    cache's dtype."""
    jc, tc, _, _ = _setup()
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = jssm.init_cache_mamba(jc, 3, jdt)
        got = ssm.init_cache_mamba(tc, 3, device="cpu", dtype=tdt)
        assert set(got) == set(want) == {"h", "conv"}
        for k in got:
            assert tuple(got[k].shape) == want[k].shape
            assert str(got[k].dtype).replace("torch.", "") == \
                str(want[k].dtype)
            assert not got[k].any()


@pytest.mark.parametrize("s", [48, 256, 2])
def test_prefill_then_decode_matches_reference(s):
    """A prefill of ``s`` tokens into a cache (2 tokens: shorter than the
    conv history), then four one-token decode steps: the outputs and
    both cache leaves after each call."""
    jc, tc, jp, tp = _setup()
    b, d = 2, tc.d_model
    g = np.random.default_rng(s)
    x = g.standard_normal((b, s + 4, d)).astype(np.float32)
    jcache = jssm.init_cache_mamba(jc, b, jnp.float32)
    tcache = ssm.init_cache_mamba(tc, b, device="cpu", dtype=torch.float32)
    yj, jcache = jssm.apply_mamba(jp, jc, jnp.asarray(x[:, :s]),
                                  cache=jcache)
    y = ssm.apply_mamba(tp, tc, _t(x[:, :s]), cache=tcache)
    _close(y.numpy(), yj, what="prefill y")
    for step in range(4):
        for k in ("h", "conv"):
            _close(tcache[k].numpy(), jcache[k], what=(step, k))
        xt = x[:, s + step:s + step + 1]
        yj, jcache = jssm.apply_mamba(jp, jc, jnp.asarray(xt), cache=jcache,
                                      decode=True)
        y = ssm.apply_mamba(tp, tc, _t(xt), cache=tcache, decode=True)
        _close(y.numpy(), yj, what=("decode y", step))


def test_bf16_block_on_f32_cache_promotes_as_reference():
    """A bf16 block decoding from the default f32 cache: the conv history
    concatenates f32 rows with the bf16 input, so the output is f32 in
    both packages (the residual stream turns f32), with the reference's
    values at the bf16 tolerance (2e-2 of the largest magnitude)."""
    jc, tc, jp, tp = _setup()
    jb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    tb = {k: v.to(torch.bfloat16) for k, v in tp.items()}
    g = np.random.default_rng(3)
    x = g.standard_normal((2, 1, tc.d_model)).astype(np.float32)
    conv = g.standard_normal((2, 3, 128)).astype(np.float32)
    h = (g.standard_normal((2, 128, 8)) * 0.3).astype(np.float32)
    yj, _ = jssm.apply_mamba(jb, jc, jnp.asarray(x, jnp.bfloat16),
                             cache={"h": jnp.asarray(h),
                                    "conv": jnp.asarray(conv)}, decode=True)
    cache = {"h": _t(h), "conv": _t(conv)}
    y = ssm.apply_mamba(tb, tc, _t(x).to(torch.bfloat16), cache=cache,
                        decode=True)
    assert yj.dtype == jnp.float32 and y.dtype == torch.float32
    _close(y.numpy(), np.asarray(yj), rel=2e-2, what="bf16 decode y")


def test_masked_decode_keeps_inactive_rows():
    """A decode step with ``active`` [True, False, True]: rows 0 and 2
    take the unmasked step's output and state bit for bit, row 1 keeps
    its ``h`` and ``conv``; an all-false mask changes no leaf."""
    _, tc, _, tp = _setup()
    g = np.random.default_rng(5)
    x = _t(g.standard_normal((3, 1, tc.d_model)).astype(np.float32))
    start = {"h": _t((g.standard_normal((3, 128, 8)) * 0.3).astype(
        np.float32)), "conv": _t(g.standard_normal((3, 3, 128)).astype(
            np.float32))}
    free = {k: v.clone() for k, v in start.items()}
    y = ssm.apply_mamba(tp, tc, x, cache=free, decode=True)
    masked = {k: v.clone() for k, v in start.items()}
    mask = torch.tensor([True, False, True])
    ym = ssm.apply_mamba(tp, tc, x, cache=masked, decode=True,
                         active=Active(mask))
    assert torch.equal(ym[mask], y[mask])
    for k in start:
        assert torch.equal(masked[k][mask], free[k][mask])
        assert torch.equal(masked[k][1], start[k][1])
    none = {k: v.clone() for k, v in start.items()}
    ssm.apply_mamba(tp, tc, x, cache=none, decode=True,
                    active=Active(torch.zeros(3, dtype=torch.bool)))
    for k in start:
        assert torch.equal(none[k], start[k])
