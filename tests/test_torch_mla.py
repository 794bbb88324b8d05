"""Multi-head latent attention (MLA) in the port against the JAX reference,
one layer on reduced deepseek_v3 (d_model 64, 4 heads, ranks 32/32, nope
16, rope 8, v 16, DSA block 16), f32, the CPU, with the reference's
weights and the same numpy inputs.

- Prefill and training: the output, the MSE term and the filled cache
  (``c_kv``, ``k_rope`` rows and ``pos``), dsa_mode off, block,
  faithful and kernel (MLA's block path is the plain gather on "kernel"
  in both packages), on a block-aligned length and on one that takes
  the token path.
- Absorbed decode over a prefilled cache with an inactive row, several
  steps: the outputs and every cache leaf.
- The chunk path (non-absorbed, pad rows zeroed, an inactive row,
  ``sel_len``) and the verify path (absorbed, one ``kv_len`` a row)
  followed by the commit: outputs on the live rows and every cache leaf.
- The casts: a bf16 layer on an f32 cache and on a bf16 cache gives the
  reference's output dtype (f32 on the f32 cache: the absorbed decode
  promotes) and its values within bf16 rounding.

Tolerances: 1e-4 of the largest magnitude of each compared array (f32,
other summation orders and libm), ``pos`` exact; bf16 2^-6 of the
largest magnitude (a few roundings of 2^-8 each).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JB
from repro.models import attention as JAT
from repro.models import transformer as JT
from repro_torch.configs import base as TB
from repro_torch.models import attention as TAT
from repro_torch.tree import map_tree

torch.set_num_threads(1)

ARCH = "deepseek_v3"
REL = 1e-4
BF16_REL = 2 ** -6
B, MAX_LEN = 2, 80


def _close(got, want, rel=REL, what=""):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1e-6)
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * scale, (what, err, scale)


def _cfgs():
    return JB.reduced(JB.get_config(ARCH)), TB.reduced(TB.get_config(ARCH))


def _layer(dtype=jnp.float32):
    """The reference's MLA layer params (with the DSA predictor) and the
    port's copy."""
    jc, tc = _cfgs()
    jp, _ = JAT.init_mla(jax.random.PRNGKey(3), jc, dtype=dtype)
    tp = map_tree(lambda a: torch.from_numpy(
        np.array(a.astype(jnp.float32))).to(
            torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32), jp)
    return jc, jp, tc, tp


def _x(b, s, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(
        (b, s, 64)).astype(dtype)


def _jcache(jc, dtype=jnp.float32):
    return JAT.init_cache_mla(jc, B, MAX_LEN, dtype)


def _tcache(tc, dtype=torch.float32):
    return TAT.init_cache_mla(tc, B, MAX_LEN, device="cpu", dtype=dtype)


def _caches_close(tcache, jcache, what=""):
    assert set(tcache) == set(jcache), (set(tcache), set(jcache))
    for name in tcache:
        if name == "pos":
            np.testing.assert_array_equal(tcache[name].numpy(),
                                          np.asarray(jcache[name]),
                                          err_msg=str(what))
        else:
            _close(tcache[name], jcache[name], what=(what, name))


def _prefill(jc, jp, tc, tp, mode, s, seed=0):
    x = _x(B, s, seed)
    jflags = JAT.RunFlags(mode="prefill", dsa_mode=mode, with_mse=False)
    tflags = TAT.RunFlags(mode="prefill", dsa_mode=mode)
    jy, jcache, _ = JAT.apply_mla(jp, jc, jflags, jnp.asarray(x),
                                  cache=_jcache(jc))
    tcache = _tcache(tc)
    ty, _, _ = TAT.apply_mla(tp, tc, tflags, torch.from_numpy(x),
                             cache=tcache)
    return jy, jcache, ty, tcache


@pytest.mark.parametrize("s", [48, 40], ids=["blocks", "tokens"])
@pytest.mark.parametrize("mode", ["off", "block", "faithful", "kernel"])
def test_prefill_and_train_match_reference(mode, s):
    """Prefill fills the latent cache; train mode returns the MSE term
    (DSA modes; none with DSA off).  48 tokens take the block path under
    block and kernel, 40 the token path."""
    jc, jp, tc, tp = _layer()
    jy, jcache, ty, tcache = _prefill(jc, jp, tc, tp, mode, s)
    _close(ty, jy, what="prefill out")
    _caches_close(tcache, jcache, "prefill cache")
    x = _x(B, s, 1)
    jy, _, ja = JAT.apply_mla(jp, jc, JAT.RunFlags(mode="train",
                                                   dsa_mode=mode),
                              jnp.asarray(x))
    ty, _, ta = TAT.apply_mla(tp, tc, TAT.RunFlags(mode="train",
                                                   dsa_mode=mode),
                              torch.from_numpy(x))
    _close(ty, jy, what="train out")
    assert set(ta) == set(ja)
    if mode != "off":
        np.testing.assert_allclose(float(ta["mse"]), float(ja["mse"]),
                                   rtol=1e-5)


def test_decode_matches_reference():
    """Six absorbed decode steps after a 40-token prefill, the second row
    inactive on every other step (it writes nothing, keeps its ``pos``
    and its output is ignored)."""
    jc, jp, tc, tp = _layer()
    _, jcache, _, tcache = _prefill(jc, jp, tc, tp, "off", 40)
    jflags = JAT.RunFlags(mode="decode", dsa_mode="block", long_context=True)
    tflags = TAT.RunFlags(mode="decode", dsa_mode="block", long_context=True)
    for step in range(6):
        x = _x(B, 1, 10 + step)
        act = np.array([True, step % 2 == 0])
        jy, jcache, _ = JAT.apply_mla(jp, jc, jflags, jnp.asarray(x),
                                      cache=jcache, active=jnp.asarray(act))
        ty, _, aux = TAT.apply_mla(tp, tc, tflags, torch.from_numpy(x),
                                   cache=tcache,
                                   active=TAT.Active(torch.from_numpy(act)))
        assert aux == {}
        _close(ty[act], np.asarray(jy)[act], what=("decode out", step))
        _caches_close(tcache, jcache, ("decode cache", step))


def test_chunk_matches_reference():
    """Two chunks of 16 over a 32-row selection geometry: the first full
    on row 0 and 11 live rows on row 1 (its pad rows written as zeros),
    the second with row 1 inactive."""
    jc, jp, tc, tp = _layer()
    jflags = JAT.RunFlags(mode="decode", dsa_mode="off")
    tflags = TAT.RunFlags(mode="decode", dsa_mode="off")
    jcache, tcache = _jcache(jc), _tcache(tc)
    for i, (lens, act) in enumerate((([16, 11], [True, True]),
                                     ([16, 16], [True, False]))):
        x = _x(B, 16, 20 + i)
        cl, act = np.array(lens, np.int32), np.array(act)
        jy, jcache, _ = JAT.apply_mla(
            jp, jc, jflags, jnp.asarray(x), cache=jcache,
            active=jnp.asarray(act), chunk_len=jnp.asarray(cl), sel_len=32)
        ty, _, _ = TAT.apply_mla(
            tp, tc, tflags, torch.from_numpy(x), cache=tcache,
            active=TAT.Active(torch.from_numpy(act)),
            chunk_len=torch.from_numpy(cl), sel_len=32)
        for r in range(B):
            if act[r]:
                _close(ty[r, :cl[r]], np.asarray(jy)[r, :cl[r]],
                       what=("chunk out", i, r))
        _caches_close(tcache, jcache, ("chunk cache", i))


@pytest.mark.parametrize("keep", [[4, 1], [2, 4]])
def test_verify_and_commit_match_reference(keep):
    """A 4-row verify after a 40-token prefill (absorbed, each row its
    own ``kv_len``), then the commit of ``keep`` rows: outputs and every
    cache leaf after each."""
    jc, jp, tc, tp = _layer()
    _, jcache, _, tcache = _prefill(jc, jp, tc, tp, "off", 40)
    jflags = JAT.RunFlags(mode="decode", dsa_mode="off", spec_verify=True)
    tflags = TAT.RunFlags(mode="decode", dsa_mode="off", spec_verify=True)
    x = _x(B, 4, 30)
    cl = np.full((B,), 4, np.int32)
    jy, jcache, _ = JAT.apply_mla(jp, jc, jflags, jnp.asarray(x),
                                  cache=jcache, chunk_len=jnp.asarray(cl))
    ty, _, _ = TAT.apply_mla(tp, tc, tflags, torch.from_numpy(x),
                             cache=tcache, chunk_len=torch.from_numpy(cl))
    _close(ty, jy, what="verify out")
    _caches_close(tcache, jcache, "verify cache")
    keep = np.array(keep, np.int32)
    jcache = JT.commit_chunk(jc, {"layer": jcache}, jnp.asarray(keep),
                             4)["layer"]
    TAT.commit_verify(tc, tflags, tcache, torch.from_numpy(keep), 4)
    _caches_close(tcache, jcache, "committed cache")


def test_verify_rows_are_decode_steps():
    """Row i of a verify is the absorbed decode step at depth pos + i
    (the same contraction, one row at a time), and the rows it writes
    are the steps', within f32 rounding (a product over C rows may round
    otherwise than one over 1)."""
    _, _, tc, tp = _layer()
    flags = TAT.RunFlags(mode="decode", dsa_mode="off")
    x = torch.from_numpy(_x(B, 3, 40))
    ver, seq = _tcache(tc), _tcache(tc)
    for c in (ver, seq):
        TAT.apply_mla(tp, tc, TAT.RunFlags(mode="prefill", dsa_mode="off"),
                      torch.from_numpy(_x(B, 24, 41)), cache=c)
    vy, _, _ = TAT.apply_mla(tp, tc, dataclasses.replace(
        flags, spec_verify=True), x, cache=ver,
        chunk_len=torch.full((B,), 3, dtype=torch.int32))
    for i in range(3):
        sy, _, _ = TAT.apply_mla(tp, tc, flags, x[:, i:i + 1], cache=seq)
        _close(vy[:, i], sy[:, 0].numpy(), what=("row", i))
    assert torch.equal(ver["pos"], seq["pos"])
    for name in ("c_kv", "k_rope"):
        _close(ver[name], seq[name].numpy(), what=name)


@pytest.mark.parametrize("cache_dt", ["float32", "bfloat16"])
def test_bf16_layer_casts_match_reference(cache_dt):
    """A bf16 layer on an f32 and on a bf16 cache: prefill, two decode
    steps and a chunk give the reference's output dtypes (the absorbed
    decode on an f32 cache returns f32) and its values within bf16
    rounding."""
    jc, jp, tc, tp = _layer(jnp.bfloat16)
    jdt, tdt = ((jnp.float32, torch.float32) if cache_dt == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    jcache, tcache = _jcache(jc, jdt), _tcache(tc, tdt)
    x = _x(B, 32, 50)
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    jy, jcache, _ = JAT.apply_mla(jp, jc, JAT.RunFlags(
        mode="prefill", dsa_mode="off"), jx, cache=jcache)
    ty, _, _ = TAT.apply_mla(tp, tc, TAT.RunFlags(
        mode="prefill", dsa_mode="off"), tx, cache=tcache)
    assert str(ty.dtype).split(".")[1] == jy.dtype.name
    _close(ty, jy, BF16_REL, "prefill")
    jflags = JAT.RunFlags(mode="decode", dsa_mode="off")
    tflags = TAT.RunFlags(mode="decode", dsa_mode="off")
    for step in range(2):
        x = _x(B, 1, 51 + step)
        jy, jcache, _ = JAT.apply_mla(jp, jc, jflags,
                                      jnp.asarray(x, jnp.bfloat16),
                                      cache=jcache)
        ty, _, _ = TAT.apply_mla(tp, tc, tflags,
                                 torch.from_numpy(x).bfloat16(), cache=tcache)
        assert str(ty.dtype).split(".")[1] == jy.dtype.name, step
        _close(ty, jy, BF16_REL, ("decode", step))
    assert (ty.dtype == torch.float32) == (cache_dt == "float32")
    x = _x(B, 16, 60)
    cl = np.full((B,), 16, np.int32)
    jy, _, _ = JAT.apply_mla(jp, jc, jflags, jnp.asarray(x, jnp.bfloat16),
                             cache=jcache, chunk_len=jnp.asarray(cl))
    ty, _, _ = TAT.apply_mla(tp, tc, tflags, torch.from_numpy(x).bfloat16(),
                             cache=tcache, chunk_len=torch.from_numpy(cl))
    assert str(ty.dtype).split(".")[1] == jy.dtype.name
    _close(ty, jy, BF16_REL, "chunk")


def test_parameter_counts_match_reference():
    """deepseek_v3's analytic parameter counts, full and reduced, and the
    MLA layer's count against its initialised leaves."""
    full = TB.get_config(ARCH)
    assert full.num_params() == 671_025_397_760
    assert full.num_active_params() == 37_551_276_032
    jfull = JB.get_config(ARCH)
    assert full.num_params() == jfull.num_params()
    assert full.num_active_params() == jfull.num_active_params()
    jc, tc = _cfgs()
    assert tc.num_params() == jc.num_params()
    assert tc.num_active_params() == jc.num_active_params()
    # the count leaves out the two norms' gains, as the reference's does
    _, _, _, tp = _layer()
    n = sum(t.numel() for k, t in tp.items()
            if k not in ("dsa", "q_a_norm", "kv_a_norm"))
    assert n == tc._attn_params()
