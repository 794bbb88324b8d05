"""RWKV6 training in the port against the JAX reference on reduced
rwkv6_3b (f32, the CPU): the differentiable chunked wkv
(``ssm._wkv_chunked_train``) and its gradients against the reference
model's ``_wkv_chunked`` under ``jax.grad``, from a zero and a random
state and where the decay hits the -30 clamp; one train step (metrics,
every gradient, every new param) against the reference's at a chunked
length (128) and a scan length (80, not a multiple of 32), 1 and 2
microbatches; and the eval step, which takes the chunked kernel's path
(``ops.wkv6``, K7 on the card) and gives the train form's ce.

Tolerances: the wkv's y and s_last within 1e-5 of each one's largest
magnitude (y sums terms of its largest size: f32 holds it to ~1e-6 of
that against f64, not elements near zero); its gradients, and the train
step's, as
tests/test_torch_train.py holds them (gradients 1e-4 of each leaf's
largest magnitude; metrics rtol 1e-5; new params within 2 lr, 99 % of
the elements within 1e-5).
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
from repro.models.attention import RunFlags as JFlags
from repro.optim import adamw as JA
from repro.training import steps as JST
from repro_torch import convert
from repro_torch.configs.base import get_config, reduced
from repro_torch.data import synthetic as TD
from repro_torch.kernels import ops
from repro_torch.models import ssm
from repro_torch.models.attention import RunFlags
from repro_torch.optim import adamw as TA
from repro_torch.training import steps as TST
from repro_torch.tree import named_leaves

torch.set_num_threads(1)

OUT_REL = 1e-5
GRAD_REL = 1e-4
METRIC_RTOL = 1e-5
PARAM_SHARE = 0.99
OPT = dict(lr=1e-3, total_steps=10, warmup_steps=2)


def _close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.max(np.abs(want))), 1e-6)
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * scale, (what, err, scale)


def _wkv_inputs(seed, b=2, s=128, h=4, hd=16, w_const=None):
    """r, k, v, w (B,S,H,hd), u (H,hd), s0 (B,H,hd,hd) and the
    cotangents of y and s_last, from numpy."""
    g = np.random.default_rng(seed)
    r = g.standard_normal((b, s, h, hd))
    k = g.standard_normal((b, s, h, hd)) * 0.3
    v = g.standard_normal((b, s, h, hd))
    w = (np.exp(-np.exp(g.standard_normal((b, s, h, hd)) * 0.5 - 2))
         if w_const is None else np.full((b, s, h, hd), w_const))
    u = g.standard_normal((h, hd)) * 0.1
    s0 = g.standard_normal((b, h, hd, hd)) * 0.5
    gy = g.standard_normal((b, s, h, hd))
    gs = g.standard_normal((b, h, hd, hd))
    return [a.astype(np.float32) for a in (r, k, v, w, u, s0, gy, gs)]


@pytest.mark.parametrize("case", ["zero_state", "random_state", "clamp"])
def test_wkv_chunked_train_and_grads_match_reference(case):
    """y, s_last and the gradients of <y, gy> + <s_last, gs> with respect
    to r, k, v, w, u (and s0): ``clamp`` holds the decay at 0.3, so a
    chunk's cumulative log-decay passes -30 (32 x log 0.3 = -38.5)."""
    r, k, v, w, u, s0, gy, gs = _wkv_inputs(
        3, w_const=0.3 if case == "clamp" else None)
    with_s0 = case == "random_state"
    args = (r, k, v, w, u) + ((s0,) if with_s0 else ())

    def jloss(*a):
        y, st = jssm._wkv_chunked(*a[:5], a[5] if with_s0 else None)
        return jnp.sum(y * gy) + jnp.sum(st * gs), (y, st)

    jgrads, (jy, jst) = jax.grad(jloss, argnums=tuple(range(len(args))),
                                 has_aux=True)(*map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    y, st = ssm._wkv_chunked_train(*ts[:5], ts[5] if with_s0 else None)
    (torch.sum(y * torch.from_numpy(gy))
     + torch.sum(st * torch.from_numpy(gs))).backward()
    _close(y.detach().numpy(), jy, OUT_REL, what="y")
    _close(st.detach().numpy(), jst, OUT_REL, what="s_last")
    for name, t, g in zip("r k v w u s0".split(), ts, jgrads):
        _close(t.grad.numpy(), g, GRAD_REL, what=("grad", name))


def test_wkv_dispatch():
    """With gradients: the chunked train form at a multiple of 32 longer
    than 32, the token scan otherwise; without: ``ops.wkv6``, the kernel's
    path (its plain version on the CPU)."""
    calls = []

    def spy(name, fn):
        def call(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return call

    tc = reduced(get_config("rwkv6_3b"))
    params = convert.from_reference(jax.tree.map(np.asarray, _ref_params()),
                                    device="cpu")["groups"][0]["b0"]["attn"]
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 64, tc.d_model)).astype(np.float32))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ssm, "_wkv_chunked_train",
                   spy("train", ssm._wkv_chunked_train))
        mp.setattr(ssm, "_wkv_scan", spy("scan", ssm._wkv_scan))
        mp.setattr(ops, "wkv6", spy("K7", ops.wkv6))
        ssm.apply_rwkv(params, tc, x)                  # nothing requires grad
        params["wr"].requires_grad_()
        ssm.apply_rwkv(params, tc, x)
        ssm.apply_rwkv(params, tc, x[:, :40])
        with torch.no_grad():
            ssm.apply_rwkv(params, tc, x)
    assert calls == ["K7", "train", "scan", "K7"]


@functools.lru_cache(maxsize=None)
def _ref_params():
    jc = jreduced(jget_config("rwkv6_3b"))
    state, _ = JST.init_train_state(jax.random.PRNGKey(0), jc,
                                    JA.OptConfig(**OPT))
    return state["params"]


@functools.lru_cache(maxsize=None)
def _ref_grad():
    jc = jreduced(jget_config("rwkv6_3b"))
    flags = JFlags(mode="train", dsa_mode="off")
    return jax.jit(lambda p, b: jax.grad(JST.loss_fn, has_aux=True)(
        p, jc, flags, b))


def _flat(tree):
    return dict(named_leaves(jax.tree.map(np.asarray, tree)))


def _batch(vocab, b, s):
    return next(TD.lm_batches(TD.DataConfig(vocab=vocab, seq_len=s,
                                            global_batch=b, seed=0)))


@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("seq", [128, 80], ids=["chunked", "scan"])
def test_rwkv_train_step_matches_reference(seq, mb):
    """One step on 2 rows a microbatch: the reference's gradient summed
    over the microbatches, divided, then its ``apply_updates`` (the
    composition ``tests/test_torch_train.py`` holds to its
    ``make_train_step``), against the port's ``accumulate_grads`` and
    ``apply_updates``."""
    jc, tc = jreduced(jget_config("rwkv6_3b")), reduced(get_config(
        "rwkv6_3b"))
    jopt, topt = JA.OptConfig(**OPT), TA.OptConfig(**OPT)
    jparams = _ref_params()
    jos = JA.init(jopt, jparams)
    tstate = convert.state_from_reference(
        jax.tree.map(np.asarray, {"params": jparams, "opt": jos, "step": 0}),
        device="cpu")
    batch = _batch(jc.vocab, 2 * mb, seq)
    n = 2
    jgrads = jm = None
    for i in range(mb):
        g, m = _ref_grad()(jparams, {k: v[i * n:(i + 1) * n]
                                     for k, v in batch.items()})
        jgrads = g if jgrads is None else jax.tree.map(jnp.add, jgrads, g)
        jm = m if jm is None else jax.tree.map(jnp.add, jm, m)
    jgrads = jax.tree.map(lambda x: x / mb, jgrads)
    jm = jax.tree.map(lambda x: x / mb, jm)
    jnew, _, om = JA.apply_updates(jopt, jparams, jgrads, jos)
    jm = dict(jm, **om)

    grads, tm = TST.accumulate_grads(tstate["params"], tc, RunFlags(
        mode="train", dsa_mode="off"), batch, mb)
    _, _, om = TA.apply_updates(topt, tstate["params"], grads, tstate["opt"])
    tm.update(om)
    for k in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=METRIC_RTOL, err_msg=k)
    assert float(tm["mse"]) == float(jm["mse"]) == 0.0
    jg = _flat(jgrads)
    for path, g in _flat(convert.to_reference(grads)).items():
        _close(g, jg[path], GRAD_REL, what=("grad", path))
    lr = float(jm["lr"])
    jp = _flat(jnew)
    within, total = 0, 0
    for path, p in _flat(convert.to_reference(tstate["params"])).items():
        d = np.abs(p - jp[path])
        assert d.max() <= 2 * lr, (path, d.max())
        within += int((d <= 1e-5).sum())
        total += d.size
    assert within >= PARAM_SHARE * total, (within, total)


def test_rwkv_eval_step_takes_the_kernel_path():
    """The eval step (no gradients) runs the wkv through ``ops.wkv6`` once
    a layer and gives the ce of the train form (``_wkv_chunked_train``
    once a layer) on params that require grad, at f32's tolerance."""
    tc = reduced(get_config("rwkv6_3b"))
    state, _ = TST.init_train_state(0, tc, TA.OptConfig(), device="cpu")
    batch = _batch(tc.vocab, 2, 128)
    calls = {"K7": 0, "train": 0}

    def spy(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "wkv6", spy("K7", ops.wkv6))
        mp.setattr(ssm, "_wkv_chunked_train",
                   spy("train", ssm._wkv_chunked_train))
        ev = TST.make_eval_step(tc)(state["params"], batch)
        assert calls == {"K7": tc.n_layers, "train": 0}
        _, m = TST.loss_fn(state["params"], tc, TST.default_flags(tc),
                           TST._on(batch, "cpu"))
        assert calls == {"K7": tc.n_layers, "train": tc.n_layers}
    np.testing.assert_allclose(float(ev["ce"]), float(m["ce"].detach()),
                               rtol=1e-5)
