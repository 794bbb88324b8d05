"""The port's training path against the JAX reference on reduced configs
(f32, the CPU): cross-entropy, one train step (loss, ce, mse, grad_norm,
every gradient and every new param) on yi_6b (GQA), stablelm_3b (MHA) and
h2o_danube_1_8b (sliding window) for dsa_mode block, faithful and off with
1 and 2 microbatches, AdamW on identical gradients, the eval step and the
synthetic data; and the port's own copies of the reference's training
semantics (microbatch equivalence, frozen P, loss and MSE decrease), remat,
the kernels' refusal of autograd, and the CLI.  The reference's weights
are carried across by ``repro_torch.convert``.

Tolerances (f32, different summation orders and libm):
- loss, ce, mse, grad_norm and eval ce: rtol 1e-5;
- gradients: 1e-4 of the largest magnitude of each leaf;
- AdamW on identical gradients: 1e-6 of each leaf's largest magnitude
  (the update is elementwise; only the f32 scalars lr, the bias
  corrections and the clip factor can round differently).  With bf16
  moments, m and v within one bf16 step (2^-7) of each leaf's largest
  magnitude and the params within 2^-5 * lr: f32 values one ulp apart can
  round to neighbouring bf16 moments, which moves the update by about
  2^-7 of lr * |delta|, and the difference is carried into later steps;
- a whole train step's new params: atol 2 * lr, with at least 99 % of
  the elements within 1e-5.  The first AdamW step moves each element by
  about lr * sign(g), so a gradient within rounding of zero may step the
  other way.
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
from repro.data import synthetic as JD
from repro.models.attention import RunFlags as JFlags
from repro.optim import adamw as JA
from repro.training import steps as JST
from repro_torch import convert
from repro_torch.configs.base import get_config, reduced
from repro_torch.data import synthetic as TD
from repro_torch.kernels import dsa_attention as K2
from repro_torch.kernels import dsa_chunk_prefill as K3
from repro_torch.kernels import dsa_decode as K1
from repro_torch.kernels import wkv6 as K7
from repro_torch.launch import train as LT
from repro_torch.models import transformer as TT
from repro_torch.models.attention import RunFlags
from repro_torch.optim import adamw as TA
from repro_torch.training import steps as TST
from repro_torch.tree import named_leaves

torch.set_num_threads(1)

METRIC_RTOL = 1e-5
GRAD_REL = 1e-4
UPDATE_REL = 1e-6
PARAM_SHARE = 0.99
BF16_STEP = 2 ** -7
BF16_PARAM_ATOL = 2 ** -5      # x lr


def _cfgs(arch):
    return jreduced(jget_config(arch)), reduced(get_config(arch))


def _close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.max(np.abs(want))), 1e-6)
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * scale, (what, err, scale)


def _flat(tree):
    """(path, numpy array) of a reference-layout tree, in the port's
    path form."""
    return dict(named_leaves(jax.tree.map(np.asarray, tree)))


def _port_state(jparams, opt):
    params = convert.from_reference(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    for path, p in named_leaves(params):
        p.requires_grad_(not TA.is_frozen(path))
    return {"params": params, "opt": TA.init(opt, params), "step": 0}


def _lm_batch(vocab, b, s, seed=0):
    return next(TD.lm_batches(TD.DataConfig(vocab=vocab, seq_len=s,
                                            global_batch=b, seed=seed)))


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    want = JST.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                             None if mask is None else jnp.asarray(mask))
    got = TST.cross_entropy(torch.from_numpy(logits),
                            torch.from_numpy(labels),
                            None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=METRIC_RTOL)


OPT = dict(lr=1e-3, total_steps=10, warmup_steps=2)


def _seq(arch, mode):
    """64 tokens (4 key blocks of 16, 2 kept); h2o at 128 on block and
    off, twice its reduced window (64), so that the window binds.  Its
    faithful case stays at 64: the token top-k is discontinuous and
    4-bit predicted scores tie or nearly tie often, and the frameworks
    round the score products differently, so at 128 one row of the
    seed-0 batch keeps key 9 on one side and key 10 on the other."""
    return 128 if arch == "h2o_danube_1_8b" and mode != "faithful" else 64


@functools.lru_cache(maxsize=None)
def _ref_grad(arch, mode):
    """The reference's jitted gradient of its ``loss_fn`` on one
    microbatch (2 rows), with the loss's metrics."""
    jc = jreduced(jget_config(arch))
    flags = JFlags(mode="train", dsa_mode=mode)
    return jax.jit(lambda p, b: jax.grad(JST.loss_fn, has_aux=True)(
        p, jc, flags, b))


@functools.lru_cache(maxsize=None)
def _ref_update(opt):
    return jax.jit(lambda p, g, s: JA.apply_updates(opt, p, g, s))


def _ref_step(arch, mode, mb, opt, state, batch):
    """The reference's train step composed of its own parts as its
    ``make_train_step`` composes them: each microbatch's gradients and
    metrics summed (gradients in the param dtype), divided by the
    microbatch count, then ``apply_updates``.  One compiled gradient
    serves both microbatch counts.  Returns (new params, metrics,
    grads)."""
    n = batch["tokens"].shape[0] // mb
    grads = metrics = None
    for i in range(mb):
        g, m = _ref_grad(arch, mode)(
            state["params"], {k: v[i * n:(i + 1) * n] for k, v in
                              batch.items()})
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
        metrics = m if metrics is None else jax.tree.map(jnp.add, metrics, m)
    if mb > 1:
        grads = jax.tree.map(lambda x: x / mb, grads)
        metrics = jax.tree.map(lambda x: x / mb, metrics)
    params, _, om = _ref_update(opt)(state["params"], grads, state["opt"])
    return params, dict(metrics, **om), grads


def test_reference_step_composition_matches_its_train_step():
    """``_ref_step`` gives what the reference's own ``make_train_step``
    gives (the composition the train-step parity cases hold the port
    to)."""
    jc, _ = _cfgs("yi_6b")
    opt = JA.OptConfig(**OPT)
    state, _ = JST.init_train_state(jax.random.PRNGKey(0), jc, opt)
    batch = _lm_batch(jc.vocab, 4, 64)
    params, m, _ = _ref_step("yi_6b", "off", 2, opt, state, batch)
    new, want = jax.jit(JST.make_train_step(
        jc, opt, JFlags(mode="train", dsa_mode="off"), 2))(state, batch)
    for k in ("loss", "ce", "mse", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(want[k]), rtol=1e-6,
                                   err_msg=k)
    got, ref = _flat(params), _flat(new["params"])
    for path, a in got.items():
        _close(a, ref[path], UPDATE_REL, what=path)


@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("mode", ["block", "faithful", "off"])
@pytest.mark.parametrize("arch", ["yi_6b", "stablelm_3b", "h2o_danube_1_8b"])
def test_train_step_matches_reference(arch, mode, mb):
    """One step on 2 rows a microbatch (a batch of 2 or 4 rows)."""
    jc, tc = _cfgs(arch)
    jopt, topt = JA.OptConfig(**OPT), TA.OptConfig(**OPT)
    jstate, _ = JST.init_train_state(jax.random.PRNGKey(0), jc, jopt)
    tstate = _port_state(jstate["params"], topt)
    batch = _lm_batch(jc.vocab, 2 * mb, _seq(arch, mode))
    jnew, jm, jgrads = _ref_step(arch, mode, mb, jopt, jstate, batch)

    grads, tm = TST.accumulate_grads(tstate["params"], tc, RunFlags(
        mode="train", dsa_mode=mode), batch, mb)
    _, _, om = TA.apply_updates(topt, tstate["params"], grads, tstate["opt"])
    tm.update(om)
    for k in ("loss", "ce", "mse", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=METRIC_RTOL, atol=1e-7, err_msg=k)
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


@pytest.mark.parametrize("case", [
    dict(),
    dict(grad_clip=0.5),
    dict(moment_dtype="bfloat16"),
    dict(master_dtype="float32"),
], ids=["default", "clip", "bf16_moments", "f32_master"])
def test_apply_updates_matches_reference(case):
    """Six steps on identical numpy gradients, through the warmup (2
    steps) into the cosine decay; ``clip`` makes the clip bind (the
    gradients' norm is ~10)."""
    jc, _ = _cfgs("yi_6b")
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=8, **case)
    jopt, topt = JA.OptConfig(**kw), TA.OptConfig(**kw)
    jstate, _ = JST.init_train_state(jax.random.PRNGKey(0), jc, jopt)
    jparams, jos = jstate["params"], jstate["opt"]
    tstate = _port_state(jparams, topt)
    rng = np.random.default_rng(2)
    flat = _flat(jparams)
    scale = 10.0 / np.sqrt(sum(a.size for a in flat.values()))
    update = _ref_update(jopt)
    bf16 = topt.moment_dtype == "bfloat16"
    for step in range(6):
        gnp = jax.tree.map(
            lambda a: (rng.standard_normal(a.shape) * scale).astype(
                np.float32), jax.tree.map(np.asarray, jparams))
        jparams, jos, jm = update(jparams, gnp, jos)
        tgrads = convert.from_reference(gnp, device="cpu")
        _, _, tm = TA.apply_updates(topt, tstate["params"], tgrads,
                                    tstate["opt"])
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=METRIC_RTOL)
        want = _flat(jparams)
        for path, p in _flat(convert.to_reference(tstate["params"])).items():
            if bf16:
                np.testing.assert_allclose(p, want[path], rtol=0,
                                           atol=BF16_PARAM_ATOL * kw["lr"],
                                           err_msg=str((step, path)))
            else:
                _close(p, want[path], UPDATE_REL, what=(step, path))
        for name in ("m", "v") + (("master",) if topt.master_dtype
                                  else ()):
            want = _flat(jos[name])
            got = _flat(convert.to_reference(tstate["opt"][name]))
            for path, a in got.items():
                _close(a, want[path], BF16_STEP if bf16 else UPDATE_REL,
                       what=(step, name, path))
    assert tstate["opt"]["step"] == int(jos["step"]) == 6


def _random_batch(vocab, b=4, s=64, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, 1),
            "loss_mask": np.ones((b, s), np.float32)}


def test_dsa_projection_frozen():
    """P is bit for bit unchanged after 3 steps at a large lr, and its
    moments stay zero, while W~q moves."""
    _, tc = _cfgs("yi_6b")
    opt = TA.OptConfig(lr=1e-2, total_steps=10, warmup_steps=0)
    state = TST.init_train_state(0, tc, opt, device="cpu")
    dsa = state["params"]["groups"][0]["b0"]["attn"]["dsa"]
    p0, wq0 = dsa["p"].clone(), dsa["wq"].detach().clone()
    step = TST.make_train_step(tc, opt)
    for i in range(3):
        state, _ = step(state, _random_batch(tc.vocab, seed=i))
    assert torch.equal(dsa["p"], p0) and not dsa["p"].requires_grad
    assert not torch.equal(dsa["wq"].detach(), wq0)
    for name in ("m", "v"):
        mom = state["opt"][name]["groups"][0]["b0"]["attn"]["dsa"]["p"]
        assert not mom.any()


def test_grad_accum_equivalent():
    _, tc = _cfgs("stablelm_3b")
    opt = TA.OptConfig(lr=1e-3, grad_clip=0.0, total_steps=10,
                       warmup_steps=0)
    batch = _random_batch(tc.vocab)
    out = []
    for mb in (1, 2):
        state = TST.init_train_state(0, tc, opt, device="cpu")
        state, m = TST.make_train_step(tc, opt, microbatches=mb)(state, batch)
        out.append((state, m))
    (s1, m1), (s2, m2) = out
    assert abs(float(m1["ce"]) - float(m2["ce"])) < 1e-4
    for (_, a), (_, b) in zip(named_leaves(s1["params"]),
                              named_leaves(s2["params"])):
        torch.testing.assert_close(a, b, atol=5e-5, rtol=5e-4)


def test_loss_decreases():
    _, tc = _cfgs("h2o_danube_1_8b")
    opt = TA.OptConfig(lr=2e-3, total_steps=30, warmup_steps=3)
    state = TST.init_train_state(0, tc, opt, device="cpu")
    step = TST.make_train_step(tc, opt)
    batch = _random_batch(tc.vocab, b=8)      # fixed batch: memorization
    ce = []
    for _ in range(25):
        state, m = step(state, batch)
        ce.append(float(m["ce"]))
    assert ce[-1] < ce[0] * 0.8, (ce[0], ce[-1])


def test_mse_decreases_jointly():
    """Paper Eq. 7: the joint loss trains the predictor too."""
    _, tc = _cfgs("yi_6b")
    opt = TA.OptConfig(lr=1e-3, total_steps=30, warmup_steps=3)
    state = TST.init_train_state(0, tc, opt, device="cpu")
    step = TST.make_train_step(tc, opt)
    batch = _random_batch(tc.vocab, b=8)
    hist = []
    for _ in range(20):
        state, m = step(state, batch)
        hist.append(float(m["mse"]))
    assert hist[-1] < hist[0] * 0.7, hist[:3] + hist[-3:]


@pytest.mark.parametrize("mode", ["block", "faithful", "off", "kernel"])
def test_eval_step_matches_reference(mode):
    """``kernel`` runs K2's plain version on the CPU, without gradients,
    on params that require them."""
    jc, tc = _cfgs("yi_6b")
    jstate, _ = JST.init_train_state(jax.random.PRNGKey(0), jc,
                                     JA.OptConfig())
    tstate = _port_state(jstate["params"], TA.OptConfig())
    batch = next(TD.needle_batches(TD.DataConfig(vocab=jc.vocab, seq_len=64,
                                                 global_batch=4)))
    want = JST.make_eval_step(jc, JFlags(mode="train", with_mse=False,
                                         dsa_mode=mode))(jstate["params"],
                                                         batch)
    got = TST.make_eval_step(tc, RunFlags(mode="train", with_mse=False,
                                          dsa_mode=mode))(tstate["params"],
                                                          batch)
    np.testing.assert_allclose(float(got["ce"]), float(want["ce"]),
                               rtol=METRIC_RTOL)
    assert float(got["last_tok_acc"]) == float(want["last_tok_acc"])


@pytest.mark.parametrize("kind", ["lm", "needle"])
def test_synthetic_batches_match_reference(kind):
    kw = dict(vocab=512, seq_len=96, global_batch=5, seed=3)
    jit = JD.make_batches(kind, JD.DataConfig(**kw))
    tit = TD.make_batches(kind, TD.DataConfig(**kw))
    for _ in range(3):
        jb, tb = next(jit), next(tit)
        assert jb.keys() == tb.keys()
        for k in jb:
            assert jb[k].dtype == tb[k].dtype, k
            np.testing.assert_array_equal(jb[k], tb[k])


def test_remat_matches_no_remat():
    """Recomputing each layer in the backward pass changes no loss and no
    gradient (the same operations run again on the same inputs)."""
    _, tc = _cfgs("yi_6b")
    batch = _random_batch(tc.vocab)
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(tc, remat=remat)
        state = TST.init_train_state(0, cfg, TA.OptConfig(), device="cpu")
        grads, m = TST.accumulate_grads(state["params"], cfg,
                                        TST.default_flags(cfg), batch)
        out.append((grads, m))
    (g0, m0), (g1, m1) = out
    assert float(m0["loss"]) == float(m1["loss"])
    for (path, a), (_, b) in zip(named_leaves(g0), named_leaves(g1)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=path)


def test_unported_training_paths_raise():
    """Train mode on the kernel path raises (as the reference's, whose
    Pallas kernels define no VJP); so do RWKV6 (its chunked wkv is the
    forward-only K7) and remat_policy "dots"."""
    _, tc = _cfgs("yi_6b")
    state = TST.init_train_state(0, tc, TA.OptConfig(), device="cpu")
    batch = _random_batch(tc.vocab)
    with pytest.raises(NotImplementedError, match="no backward"):
        TST.make_train_step(tc, TA.OptConfig(), RunFlags(
            mode="train", dsa_mode="kernel"))(state, batch)
    _, rc = _cfgs("rwkv6_3b")
    rstate = TST.init_train_state(0, rc, TA.OptConfig(), device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1, item 1"):
        TST.make_train_step(rc, TA.OptConfig())(rstate, batch)
    dots = dataclasses.replace(tc, remat=True, remat_policy="dots")
    with pytest.raises(NotImplementedError, match="dots"):
        TST.make_train_step(dots, TA.OptConfig())(state, batch)


def _kernel_calls(dev="cpu", requires_grad=True):
    """One call of each public kernel wrapper on small inputs, q (r for
    K7) requiring grad."""
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    b, hq, hkv, hd, s, bk = 2, 4, 2, 16, 64, 16
    q1 = rnd(b, hq, 1, hd).requires_grad_(requires_grad)
    qc = rnd(b, hq, bk, hd).requires_grad_(requires_grad)
    q2 = rnd(b, hq, s, hd).requires_grad_(requires_grad)
    kc, vc = rnd(b, s, hkv, hd), rnd(b, s, hkv, hd)
    pool = kc.reshape(b * s, hkv, hd)
    i32 = dict(dtype=torch.int32, device=dev)
    idx = torch.tensor([[0, 1], [2, 0]], **i32)
    pidx = idx + torch.tensor([[0], [4]], **i32)
    ok = torch.ones((b, 2), dtype=torch.bool, device=dev)
    kv_len = torch.tensor([s, 40], **i32)
    q_off = torch.tensor([16, 0], **i32)
    r = rnd(b, hq, 32 * 2, hd).requires_grad_(requires_grad)
    w = torch.rand((b, hq, 64, hd), generator=g, device=dev) * 0.5 + 0.4
    return {
        "K1": lambda: K1.dsa_decode_gather_attention(q1, kc, vc, idx, ok,
                                                     kv_len, block_k=bk),
        "K4": lambda: K1.dsa_decode_paged_gather_attention(
            q1, pool, pool, idx, pidx, ok, kv_len, block_k=bk),
        "K2": lambda: K2.dsa_block_sparse_attention(
            q2, q2.detach(), q2.detach(),
            torch.zeros((b, s // bk, 1), **i32) + torch.arange(
                s // bk, **i32)[None, :, None],
            torch.ones((b, s // bk, 1), dtype=torch.bool, device=dev),
            block_q=bk, block_k=bk),
        "K3": lambda: K3.dsa_chunk_gather_attention(
            qc, kc, vc, idx[:, None], ok[:, None], q_off, kv_len,
            block_q=bk, block_k=bk),
        "K5": lambda: K3.dsa_chunk_paged_gather_attention(
            qc, pool, pool, idx[:, None], pidx[:, None], ok[:, None], q_off,
            kv_len, block_q=bk, block_k=bk),
        "K7": lambda: K7.wkv6_chunked(r, r.detach(), r.detach(), w,
                                      torch.zeros((hq, hd), device=dev)),
    }


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4", "K5", "K7"])
def test_kernel_wrappers_refuse_autograd(kernel):
    """A kernel wrapper asked for a gradient raises instead of returning
    an output that would cut it, on the CPU (the plain version) as on the
    card; without gradients it runs."""
    call = _kernel_calls()[kernel]
    with pytest.raises(NotImplementedError, match="no backward"):
        call()
    with torch.no_grad():
        call()
    with torch.inference_mode():
        call()


def test_to_reference_round_trip():
    jc, tc = _cfgs("yi_6b")
    jstate, _ = JST.init_train_state(jax.random.PRNGKey(0), jc,
                                     JA.OptConfig())
    ref = jax.tree.map(np.asarray, jstate["params"])
    back = _flat(convert.to_reference(convert.from_reference(
        ref, device="cpu")))
    want = _flat(ref)
    assert back.keys() == want.keys()
    for path, a in back.items():
        assert a.dtype == want[path].dtype, path
        np.testing.assert_array_equal(a, want[path], err_msg=path)
    own = TT.init_model(0, tc, device="cpu")
    again = convert.from_reference(convert.to_reference(own), device="cpu")
    again = dict(named_leaves(again))
    for path, a in named_leaves(own):
        assert torch.equal(a, again[path]), path


def test_reference_fault_stacked_norms_decayed():
    """A reference fault the port follows: the reference's weight decay
    rule (``ndim >= 2``, its docstring: norms and biases are skipped) sees
    the per-layer norms with their stacked layer axis, so after one step
    with zero gradients ``norm1`` has moved by lr * wd * norm1 while
    ``final_norm`` has not.  The port decays the same leaves."""
    jc, tc = _cfgs("yi_6b")
    kw = dict(lr=1e-2, warmup_steps=0, total_steps=10, min_lr_frac=1.0)
    jopt, topt = JA.OptConfig(**kw), TA.OptConfig(**kw)
    jstate, _ = JST.init_train_state(jax.random.PRNGKey(0), jc, jopt)
    jp = jstate["params"]
    zeros = jax.tree.map(jnp.zeros_like, jp)
    jnew, _, jm = JA.apply_updates(jopt, jp, zeros, jstate["opt"])
    lr, wd = float(jm["lr"]), jopt.weight_decay
    n1 = np.asarray(jp["groups"]["b0"]["norm1"])
    np.testing.assert_allclose(np.asarray(jnew["groups"]["b0"]["norm1"]),
                               n1 - lr * wd * n1, rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(jnew["final_norm"]),
                                  np.asarray(jp["final_norm"]))
    tstate = _port_state(jp, topt)
    tzeros = convert.from_reference(jax.tree.map(np.asarray, zeros),
                                    device="cpu")
    TA.apply_updates(topt, tstate["params"], tzeros, tstate["opt"])
    got = _flat(convert.to_reference(tstate["params"]))
    for path, a in _flat(jnew).items():
        np.testing.assert_allclose(got[path], a, rtol=1e-6, err_msg=path)


def test_prefill_and_decode_steps():
    """``make_prefill_step`` gives the last row of ``forward``'s logits
    and ``make_decode_fn`` is ``decode_step``."""
    _, tc = _cfgs("yi_6b")
    params = TT.init_model(0, tc, device="cpu")
    toks = torch.from_numpy(_random_batch(tc.vocab, b=2, s=32)["tokens"])
    pf, df = RunFlags(mode="prefill", dsa_mode="off"), RunFlags(
        mode="decode", dsa_mode="off")
    with torch.inference_mode():
        full, _ = TT.forward(params, tc, pf, toks)
        caches = TT.init_cache(tc, 2, 48, df, dtype=torch.float32,
                               device="cpu")
        last, caches = TST.make_prefill_step(tc, pf)(params,
                                                     {"tokens": toks}, caches)
        nxt = last.argmax(-1)
        step, _ = TST.make_decode_fn(tc, df)(params, nxt, caches)
        whole, _ = TT.forward(params, tc, pf, torch.cat([toks, nxt], 1))
    torch.testing.assert_close(last, full[:, -1:])
    torch.testing.assert_close(step[:, -1], whole[:, -1], rtol=1e-4,
                               atol=1e-4)


def test_train_cli(capsys):
    res = LT.main(["--arch", "yi_6b", "--reduced", "--steps", "4", "--seq",
                   "64", "--batch", "4", "--microbatches", "2", "--data",
                   "lm", "--log-interval", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines[:3]] == [
        "step 0", "step 2", "step 3"]
    assert len(lines) == 4 and lines[3].startswith("[done] 4 steps in ")
    assert len(res.metrics) == 4 and res.state["step"] == 4
    assert all(np.isfinite(list(m.values())).all() for m in res.metrics)
    with pytest.raises(NotImplementedError, match="no backward"):
        LT.main(["--arch", "yi_6b", "--reduced", "--steps", "1", "--seq",
                 "32", "--batch", "2", "--dsa-mode", "kernel", "--device",
                 "cpu"])
    for extra in (["--mesh", "production"], ["--ckpt-dir", "x"]):
        with pytest.raises(NotImplementedError, match="Queue 1, item 7"):
            LT.main(["--arch", "yi_6b", "--reduced", "--device", "cpu"]
                    + extra)
