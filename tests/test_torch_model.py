"""The port's model against the JAX reference on reduced yi_6b and
stablelm_3b (f32), with the reference's weights carried across by
repro_torch.convert: prefill logits and every cache leaf after a ragged
truncate_cache, then 4 decode steps, for dsa_mode off, block and kernel
(kernel mode on the CPU runs the kernels' plain versions).

Tolerance: 1e-4 relative to the largest magnitude of each compared array
(f32, different summation orders and libm); ``pos`` exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models import transformer as JT
from repro.models.attention import RunFlags as JFlags
from repro_torch import convert
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import transformer as TT
from repro_torch.models.attention import RunFlags

torch.set_num_threads(1)

REL = 1e-4


def _close(got, want, rel=REL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.max(np.abs(want))), 1e-6)
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * scale, (what, err, scale)


def _cfgs(arch):
    return jreduced(jget_config(arch)), reduced(get_config(arch))


@pytest.mark.parametrize("arch", ["yi_6b", "stablelm_3b", "qwen1_5_110b"])
def test_reduced_configs_match_reference(arch):
    jc, tc = _cfgs(arch)
    for f in dataclasses.fields(tc):
        want = getattr(jc, f.name)
        if f.name == "dsa":
            for g in dataclasses.fields(tc.dsa):
                assert getattr(tc.dsa, g.name) == getattr(want, g.name), g
        else:
            assert getattr(tc, f.name) == want, f.name
    assert tc.resolved_head_dim == jc.resolved_head_dim


def _compare_caches(tcache, jcache):
    """Every leaf of every layer: k, v, kt, ktb (values), pos (exact)."""
    jg = jcache["groups"]
    layers = (jg if isinstance(jg, list)
              else [jax.tree.map(lambda a, i=i: a[i], jg)
                    for i in range(len(tcache["groups"]))])
    for i, (tl, jl) in enumerate(zip(tcache["groups"], layers)):
        tc, jc = tl["b0"]["attn"], jl["b0"]["attn"]
        assert set(tc) == set(jc), (set(tc), set(jc))
        for name in tc:
            if name == "pos":
                np.testing.assert_array_equal(tc[name].numpy(),
                                              np.asarray(jc[name]))
            else:
                _close(tc[name].numpy(), jc[name], what=(i, name))


@pytest.mark.parametrize("mode", ["off", "block", "kernel"])
@pytest.mark.parametrize("arch,plen", [("yi_6b", 48), ("yi_6b", 40),
                                       ("stablelm_3b", 48)])
def test_prefill_and_decode_match_reference(arch, plen, mode):
    """plen 48 takes the block path (a block_q multiple), 40 the token
    path; rows are ragged (the second row is 11 tokens shorter)."""
    jc, tc = _cfgs(arch)
    jparams, _ = JT.init_model(jax.random.PRNGKey(0), jc)
    tparams = convert.from_reference(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    b, max_len = 2, 96
    toks = np.random.default_rng(plen).integers(
        1, jc.vocab - 4, size=(b, plen)).astype(np.int32)
    lengths = np.array([plen, plen - 11], np.int32)
    jpf = JFlags(mode="prefill", dsa_mode=mode, with_mse=False,
                 long_context=True)
    jdf = dataclasses.replace(jpf, mode="decode")
    tpf = RunFlags(mode="prefill", dsa_mode=mode, long_context=True)
    tdf = dataclasses.replace(tpf, mode="decode")

    jcache = JT.init_cache(jc, b, max_len, jdf, dtype=jnp.float32)
    jlog, _, jcache = JT.forward(jparams, jc, jpf,
                                 {"tokens": jnp.asarray(toks)}, caches=jcache)
    jcache = JT.truncate_cache(jc, jcache, jnp.asarray(lengths))
    tcache = TT.init_cache(tc, b, max_len, tdf, dtype=torch.float32,
                           device="cpu")
    tlog, tcache = TT.forward(tparams, tc, tpf, torch.from_numpy(toks),
                              tcache)
    TT.truncate_cache(tc, tcache, torch.from_numpy(lengths))
    _close(tlog.numpy(), jlog, what="prefill logits")
    _compare_caches(tcache, jcache)

    jcache = JT.unstack_group_caches(jcache)
    rows = np.arange(b)
    tok = np.asarray(jlog)[rows, lengths - 1].argmax(-1)[:, None]
    for step in range(4):
        jlog, jcache = JT.decode_step(jparams, jc, jdf,
                                      jnp.asarray(tok, jnp.int32), jcache)
        tlog, tcache = TT.decode_step(tparams, tc, tdf,
                                      torch.from_numpy(tok), tcache)
        _close(tlog.numpy(), jlog, what=("decode logits", step))
        tok = np.asarray(jlog)[:, -1].argmax(-1)[:, None].astype(np.int32)
    _compare_caches(tcache, jcache)


def test_init_model_shapes_match_reference_tree():
    """The port's own seeded init gives the converted tree's structure,
    shapes and dtypes."""
    jc, tc = _cfgs("yi_6b")
    jparams, _ = JT.init_model(jax.random.PRNGKey(0), jc)
    conv = convert.from_reference(jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    own = TT.init_model(0, tc, device="cpu")

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return (tuple(t.shape), t.dtype)

    assert shapes(own) == shapes(conv)
