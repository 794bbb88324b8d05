"""Speculative decoding in the PyTorch port (inference/speculative.py,
``transformer.verify_step``/``commit_chunk``, ``Engine.generate(spec=)``
and the continuous engine's speculative segments).

Geometry: reduced yi_6b (block 16) with prompts of 224 tokens and
max_len 320, so that decode keeps 7 of 20 blocks and the DSA modes give
different tokens (at max_len 96 the 64-token local window keeps every
block).  Weights are the reference's ``init_model`` through
``convert.py``; inputs come from numpy seeds.

Against the JAX reference: ``generate(spec=K)`` gives the reference's
plain ``generate`` tokens (K 1, 3, 4; modes off, block, kernel and
faithful; int8/fp8 K/V with int8 selection; stablelm_3b without DSA);
``verify_step`` logits within 1e-4 of the largest logit and every cache
leaf after ``commit_chunk`` within 1e-4 of its largest magnitude (f32,
other summation orders); ``verify_block_topk_indices`` and the verify
attends on the same inputs (indices exact, outputs at f32 1e-5); the
n-gram and draft-model proposers' drafts exactly.

Inside the port (the reference's contract, speculative == plain, held
on TOKENS: a product over C rows rounds otherwise than over one, see the
speculative module docstring): spec tokens == plain tokens, greedy at
B 2 and a ragged B 3, sampled at B 1; an oracle proposer (every draft
accepted) and an adversarial one (every draft rejected); the continuous
engine's speculative segments == solo ``generate``; verify-row logits ==
the decode chain's within 1e-4 of the largest logit; after a commit,
``pos`` equal, every per-token row past it exactly zero, the other rows
within 1e-5 of each leaf's largest magnitude, and ktb/ktb_s bit for bit
the decode chain's when both are fed the same K~ rows.  The envelope,
proposer failures and segment statistics as in the reference's
tests/test_speculative.py.
"""
import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core import attention as JA
from repro.core import masks as JM
from repro.inference import engine as JE
from repro.inference import speculative as JSP
from repro.models import transformer as JT
from repro.models.transformer import init_model as jinit_model
from repro_torch import convert
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import attention as TA
from repro_torch.core import masks as TM
from repro_torch.core import prediction as PRED
from repro_torch.inference import engine as TE
from repro_torch.inference import scheduler as TS
from repro_torch.inference import speculative as SP
from repro_torch.models import attention as TMA
from repro_torch.models import transformer as TT

torch.set_num_threads(1)

MAX_LEN = 320
PLEN = 224
N_NEW = 20
LOGIT_REL = 1e-4      # port against reference, and verify row against step
LEAF_REL = 1e-5       # committed rows against the decode chain's (port)
QUANT = {"f32": {}, "int8": dict(kv_quant="int8", select_dtype="int8"),
         "fp8": dict(kv_quant="fp8", select_dtype="int8")}


@functools.lru_cache(maxsize=None)
def _params(arch: str):
    jc = jreduced(jget_config(arch))
    jparams, _ = jinit_model(jax.random.PRNGKey(0), jc)
    tparams = convert.from_reference(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jc, jparams, reduced(get_config(arch)), tparams


def _kw(arch: str, mode: str, quant: str = "f32") -> dict:
    if arch != "yi_6b":
        return {}
    return dict(long_context=True, dsa_mode=mode, **QUANT[quant])


def _prompts(vocab: int, b: int = 2, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        1, vocab - 4, size=(b, PLEN)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _engine(arch: str, mode: str, quant: str = "f32"):
    _, _, tc, tparams = _params(arch)
    return TE.Engine(tc, tparams, max_len=MAX_LEN, device="cpu",
                     **_kw(arch, mode, quant))


@functools.lru_cache(maxsize=None)
def _ref_tokens(arch: str, mode: str, quant: str = "f32") -> np.ndarray:
    jc, jparams, _, _ = _params(arch)
    eng = JE.Engine(jc, jparams, max_len=MAX_LEN, **_kw(arch, mode, quant))
    return np.asarray(eng.generate(_prompts(jc.vocab), N_NEW).tokens)


@functools.lru_cache(maxsize=None)
def _plain_tokens(arch: str, mode: str, quant: str = "f32") -> np.ndarray:
    eng = _engine(arch, mode, quant)
    return eng.generate(_prompts(eng.cfg.vocab), N_NEW).tokens


class Oracle(SP.DraftProposer):
    """Drafts the true continuation of known sequences (every draft
    accepted), or that continuation shifted by one token id (every draft
    rejected)."""

    def __init__(self, fulls, shift: int = 0, vocab: int = 512):
        self.fulls = [np.asarray(f, np.int32) for f in fulls]
        self.shift = shift
        self.vocab = vocab

    def propose(self, contexts, k):
        out = np.empty((len(contexts), k), np.int32)
        for r, ctx in enumerate(contexts):
            full = self.fulls[r]
            cont = full[len(ctx):len(ctx) + k]
            row = np.full((k,), full[-1], np.int32)
            row[:cont.size] = cont
            out[r] = (row + self.shift) % self.vocab
        return out


# -- Engine.generate(spec=K) ------------------------------------------------


@pytest.mark.parametrize("k", [1, 3, 4])
@pytest.mark.parametrize("mode", ["off", "block", "kernel", "faithful"])
def test_spec_greedy_equals_plain_and_reference(mode, k):
    """Greedy spec tokens == the port's plain tokens == the reference's
    plain tokens, B 2, every DSA mode; the rounds emit every token."""
    eng = _engine("yi_6b", mode)
    res = eng.generate(_prompts(eng.cfg.vocab), N_NEW, spec=k)
    np.testing.assert_array_equal(res.tokens, _plain_tokens("yi_6b", mode))
    np.testing.assert_array_equal(res.tokens, _ref_tokens("yi_6b", mode))
    hist = res.spec_accept_hist
    assert len(hist) == k + 1
    assert sum((e + 1) * n for e, n in enumerate(hist)) == 2 * (N_NEW - 1)
    assert res.decode_steps == res.spec_rounds * (k + 1)
    assert res.delivered_tokens == 2 * (N_NEW - 1)


def test_decode_modes_differ_at_this_geometry():
    """The geometry tells the modes apart (else the mode cases above
    would all test one path)."""
    toks = {m: _ref_tokens("yi_6b", m)
            for m in ("off", "block", "faithful")}
    assert not (toks["off"] == toks["block"]).all()
    assert not (toks["block"] == toks["faithful"]).all()


@pytest.mark.parametrize("quant", ["int8", "fp8"])
@pytest.mark.parametrize("mode", ["block", "kernel", "faithful"])
def test_spec_quantized_equals_plain_and_reference(mode, quant):
    """int8/fp8 K/V with int8 selection: spec == plain == reference."""
    eng = _engine("yi_6b", mode, quant)
    got = eng.generate(_prompts(eng.cfg.vocab), N_NEW, spec=3).tokens
    np.testing.assert_array_equal(got, _plain_tokens("yi_6b", mode, quant))
    np.testing.assert_array_equal(got, _ref_tokens("yi_6b", mode, quant))


@pytest.mark.parametrize("k", [1, 3, 4])
def test_spec_dense_arch_equals_plain_and_reference(k):
    """stablelm_3b (no DSA): greedy spec == plain == reference."""
    eng = _engine("stablelm_3b", "off")
    got = eng.generate(_prompts(eng.cfg.vocab), N_NEW, spec=k).tokens
    np.testing.assert_array_equal(got, _plain_tokens("stablelm_3b", "off"))
    np.testing.assert_array_equal(got, _ref_tokens("stablelm_3b", "off"))


@pytest.mark.parametrize("arch,mode", [("stablelm_3b", "off"),
                                       ("yi_6b", "kernel"),
                                       ("yi_6b", "faithful")])
@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_spec_sampled_b1_equals_plain(arch, mode, temperature):
    """Sampled at B 1: each verify row draws one (1, V) row from the
    row's generator and the generator rewinds to the state after the
    emitted draws, so spec gives the plain chain's tokens."""
    eng = _engine(arch, mode)
    p = _prompts(eng.cfg.vocab, b=1, seed=5)
    for seed in (3, 11):
        want = eng.generate(p, 14, greedy=False, seed=seed,
                            temperature=temperature).tokens
        got = eng.generate(p, 14, greedy=False, seed=seed,
                           temperature=temperature, spec=3).tokens
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["block", "kernel"])
def test_spec_oracle_and_adversarial(mode):
    """Every draft accepted (rounds = ceil((n_new - 1) / (K + 1))) and
    every draft rejected (one token a round): the plain tokens."""
    eng = _engine("yi_6b", mode)
    p = _prompts(eng.cfg.vocab)
    ref = _plain_tokens("yi_6b", mode)
    fulls = [np.concatenate([p[r], ref[r]]) for r in range(2)]
    k = 4
    oracle = eng.generate(p, N_NEW, spec=k, draft=Oracle(fulls))
    np.testing.assert_array_equal(oracle.tokens, ref)
    assert oracle.spec_rounds == -(-(N_NEW - 1) // (k + 1))
    adv = eng.generate(p, N_NEW, spec=k, draft=Oracle(fulls, shift=1))
    np.testing.assert_array_equal(adv.tokens, ref)
    assert adv.spec_rounds == N_NEW - 1
    assert adv.spec_accept_hist[0] == 2 * (N_NEW - 1)


@pytest.mark.parametrize("arch,mode", [("stablelm_3b", "off"),
                                       ("yi_6b", "kernel")])
def test_spec_ragged_batch(arch, mode):
    """A right-padded ragged batch: every row decodes at its own depth
    and finishes in its own round; spec == plain == reference."""
    jc, jparams, _, _ = _params(arch)
    eng = _engine(arch, mode)
    lens = np.asarray([PLEN, 150, 190], np.int32)
    mat = np.zeros((3, PLEN), np.int32)
    rng = np.random.default_rng(13)
    for i, n in enumerate(lens):
        mat[i, :n] = rng.integers(1, jc.vocab - 4, size=(n,))
    want = eng.generate(mat, 9, lengths=lens).tokens
    got = eng.generate(mat, 9, lengths=lens, spec=4).tokens
    np.testing.assert_array_equal(got, want)
    ref = JE.Engine(jc, jparams, max_len=MAX_LEN, **_kw(arch, mode))
    np.testing.assert_array_equal(
        got, np.asarray(ref.generate(mat, 9, lengths=lens).tokens))


def test_spec_gating():
    """Outside the envelope generate(spec=) raises ValueError; the
    predicate matches the reference's wherever both define the arch."""
    for arch in ("h2o_danube_1_8b", "rwkv6_3b"):
        tc = reduced(get_config(arch))
        assert not SP.can_speculate(tc)
        eng = TE.Engine(tc, TT.init_model(0, tc, device="cpu"), device="cpu",
                        max_len=MAX_LEN)
        with pytest.raises(ValueError, match="spec"):
            eng.generate(_prompts(tc.vocab, b=1)[:, :40], 4, spec=2)
    tc = reduced(get_config("yi_6b"))
    jc = jreduced(jget_config("yi_6b"))
    for mode, k in (("block", 4), ("kernel", 63), ("kernel", 64),
                    ("faithful", 64), ("off", 64)):
        assert SP.can_speculate(tc, mode, k) == JSP.can_speculate(jc, mode,
                                                                  k)
    assert not SP.can_speculate(tc, "block", 64)
    with pytest.raises(ValueError, match="spec"):
        _engine("yi_6b", "block").generate(_prompts(tc.vocab), 4, spec=64)


# -- verify_step and commit_chunk --------------------------------------------


def _leaves(caches):
    return [sub["attn"] for g in caches["groups"] for sub in g.values()]


def _close(got, want, rel, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.max(np.abs(want))), 1e-6)
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * scale, (what, err, scale)


def _rows(lc, name: str) -> np.ndarray:
    """A per-token leaf as f32, dequantized where it is stored narrow."""
    t = lc[name]
    if f"{name}_s" in lc:
        return np.asarray(TMA.Q.dequant(t, lc[f"{name}_s"]))
    return t.float().numpy()


def _tol(lc, name: str, rel: float) -> float:
    """``rel``, or one quantization step (1/127 of the largest magnitude)
    where the leaf is stored in int8: a row whose values moved by
    ``rel`` may round to the next step."""
    return 1.01 / 127 if f"{name}_s" in lc else rel


@pytest.mark.parametrize("quant", ["f32", "int8"])
@pytest.mark.parametrize("mode", ["off", "block", "kernel", "faithful"])
def test_verify_and_commit_against_the_decode_chain(mode, quant):
    """One verify of C = 5 rows on a prefilled pair against five decode
    steps of the same tokens: verify-row logits within 1e-4 of the
    step's (largest logit); after committing keep = (5, 2) against the
    chain run with row 1 frozen after 2 steps: ``pos`` equal, every
    per-token row at or past it exactly zero, the rest within 1e-5; ktb
    (ktb_s) bit for bit the chain's once the commit replays the chain's
    K~ rows."""
    eng = _engine("yi_6b", mode, quant)
    cfg, params = eng.cfg, eng.params
    p = _prompts(cfg.vocab)
    c = 5
    chunk = torch.as_tensor(np.random.default_rng(3).integers(
        1, cfg.vocab - 4, size=(2, c)))
    _, seq, _ = eng.prefill(p)
    _, ver, _ = eng.prefill(p)
    dflags = eng.decode_flags
    vflags = dataclasses.replace(dflags, spec_verify=True)
    keep = torch.tensor([c, 2])
    rows = []                          # the chain's float K~ rows per layer
    orig = PRED.predict_qk

    def record(*a, **kw):
        out = orig(*a, **kw)
        rows.append(out[1][:, 0].float().clone())
        return out

    steps = []
    with torch.inference_mode():
        PRED.predict_qk = record
        try:
            for i in range(c):
                act = keep > i
                steps.append(TT.decode_step(params, cfg, dflags,
                                            chunk[:, i:i + 1], seq,
                                            active=act)[0])
        finally:
            PRED.predict_qk = orig
        scratch = TT.spec_scratch(ver, c)
        logits, _ = TT.verify_step(params, cfg, vflags, chunk, ver,
                                   scratch=scratch)
        for i in range(c):
            live = (keep > i).numpy()
            _close(logits[live, i].numpy(), steps[i][live, 0].numpy(),
                   LOGIT_REL, ("row", i))
        n_layers = len(_leaves(ver))
        if "ktb" in _leaves(ver)[0] and mode in ("block", "kernel"):
            # feed the commit the chain's K~ rows (where the product over
            # five rows rounded otherwise than over one)
            pend = scratch                 # one entry a layer
            for li, lc in enumerate(_leaves(ver)):
                chain = torch.stack([rows[i * n_layers + li]
                                     for i in range(c)], 1)
                if "ktb_s" in lc:
                    pend[li].copy_(chain)
                else:
                    start = PLEN
                    lc["kt"][:, start:start + c] = chain.to(lc["kt"].dtype)
        TT.commit_chunk(cfg, vflags, ver, keep, c, scratch=scratch)
    for li, (a, b) in enumerate(zip(_leaves(seq), _leaves(ver))):
        np.testing.assert_array_equal(a["pos"].numpy(), b["pos"].numpy())
        pos = b["pos"].numpy()
        for name in ("k", "v", "kt", "k_s", "v_s", "kt_s"):
            if name not in b:
                continue
            for r in range(2):
                assert not TMA.raw(b[name][r, pos[r]:]).any(), (li, name, r)
            if name.endswith("_s") or (name == "kt"
                                       and mode in ("block", "kernel")):
                continue     # scales ride with their rows; kt replaced
            _close(_rows(b, name), _rows(a, name), _tol(b, name, LEAF_REL),
                   (li, name))
        for name in ("ktb", "ktb_s"):
            if name in b:
                if mode in ("block", "kernel"):
                    np.testing.assert_array_equal(
                        b[name].numpy(), a[name].numpy(), err_msg=name)
                else:                  # neither path touches ktb
                    np.testing.assert_array_equal(
                        b[name].numpy(),
                        _leaves(eng.prefill(p)[1])[li][name].numpy())


@pytest.mark.parametrize("quant", ["f32", "int8"])
@pytest.mark.parametrize("mode", ["off", "block", "kernel", "faithful"])
def test_verify_and_commit_match_reference(mode, quant):
    """The reference's ``verify_step`` and ``commit_chunk`` on the same
    prefilled pair, row 1 inactive for the round: logits of the active
    row within 1e-4 of the largest logit, every cache leaf after the
    commit within 1e-4 of its largest magnitude and ``pos`` exact."""
    jc, jparams, _, _ = _params("yi_6b")
    eng = _engine("yi_6b", mode, quant)
    jeng = JE.Engine(jc, jparams, max_len=MAX_LEN,
                     **_kw("yi_6b", mode, quant))
    p = _prompts(jc.vocab)
    c = 4
    chunk = np.random.default_rng(4).integers(
        1, jc.vocab - 4, size=(2, c)).astype(np.int32)
    active = np.array([True, False])
    keep = np.array([3, 0], np.int32)
    _, jcache, _ = jeng.prefill(p)
    jcache = JT.unstack_group_caches(jcache)
    jf = dataclasses.replace(jeng.decode_flags, spec_verify=True)
    jlog, jcache = JT.verify_step(jparams, jc, jf, jnp.asarray(chunk),
                                  jcache, active=jnp.asarray(active))
    jcache = JT.commit_chunk(jc, jcache, jnp.asarray(keep), c,
                             active=jnp.asarray(active))
    _, tcache, _ = eng.prefill(p)
    tf = dataclasses.replace(eng.decode_flags, spec_verify=True)
    scratch = TT.spec_scratch(tcache, c)
    with torch.inference_mode():
        tlog, _ = TT.verify_step(eng.params, eng.cfg, tf,
                                 torch.as_tensor(chunk), tcache,
                                 active=torch.as_tensor(active),
                                 scratch=scratch)
        TT.commit_chunk(eng.cfg, tf, tcache, torch.as_tensor(keep), c,
                        active=torch.as_tensor(active), scratch=scratch)
    _close(tlog[0].numpy(), np.asarray(jlog)[0], LOGIT_REL, "logits")
    for li, (tl, jl) in enumerate(zip(tcache["groups"], jcache["groups"])):
        t, j = tl["b0"]["attn"], jl["b0"]["attn"]
        for name in j:
            if name == "pos":
                np.testing.assert_array_equal(t[name].numpy(),
                                              np.asarray(j[name]))
            elif name in ("ktb", "ktb_s") and mode in ("off", "faithful"):
                # the reference re-sums the touched blocks in every mode;
                # the port, as the decode step, leaves ktb alone in these
                continue
            elif name == "ktb" and quant == "int8":
                # int8 block sums: the port replays the decode step's
                # dequant-add-requant, the reference requantizes a re-sum
                _close(TMA.Q.dequant(t["ktb"], t["ktb_s"]).numpy(),
                       np.asarray(JT.Q.dequant(j["ktb"], j["ktb_s"])),
                       2e-2, (li, "ktb dequantized"))
            elif name.endswith("_s"):
                continue             # compared with their rows
            else:
                want = np.asarray(j[name], np.float32)
                if f"{name}_s" in j:
                    want = want * np.asarray(j[f"{name}_s"])[..., None]
                _close(_rows(t, name), want, _tol(t, name, LOGIT_REL),
                       (li, name))


def test_verify_block_topk_indices_matches_reference():
    """Per-row block selection of a verify chunk on the same scores and
    ragged per-row kv_len: equal indices and validity."""
    rng = np.random.default_rng(7)
    b, c, n_kb, bk = 3, 5, 20, 16
    scores = rng.standard_normal((b, c, n_kb)).astype(np.float32)
    kv = (np.array([224, 100, 301])[:, None] + np.arange(c)[None]
          ).astype(np.int32)
    for nb in (7, 20):
        ji, jo = JM.verify_block_topk_indices(jnp.asarray(scores), nb,
                                              kv_len=jnp.asarray(kv),
                                              block_k=bk)
        ti, to = TM.verify_block_topk_indices(torch.from_numpy(scores), nb,
                                              kv_len=torch.from_numpy(kv),
                                              block_k=bk)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


@pytest.mark.parametrize("quant", [None, "int8"])
def test_verify_attends_match_reference(quant):
    """``dsa_verify_block_attention`` (scales: an int8 cache) and
    ``dsa_verify_attention`` on the same inputs, f32: within 1e-5 of the
    largest output."""
    rng = np.random.default_rng(9)
    b, c, hq, hkv, hd, s, bk, nb = 2, 4, 4, 2, 16, 96, 16, 3
    q = rng.standard_normal((b, c, hq, hd)).astype(np.float32)
    kc = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    vc = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    kv = (np.array([60, 33])[:, None] + np.arange(c)[None]).astype(np.int32)
    idx, ok = JM.verify_block_topk_indices(
        jnp.asarray(rng.standard_normal((b, c, s // bk)).astype(np.float32)),
        nb, kv_len=jnp.asarray(kv), block_k=bk)
    ks = vs = None
    if quant:
        kq, ks = JT.Q.quant_store(jnp.asarray(kc), axis=-1, dtype=quant)
        vq, vs = JT.Q.quant_store(jnp.asarray(vc), axis=-1, dtype=quant)
        jk, jv, tk, tv = kq, vq, torch.from_numpy(np.asarray(kq)), \
            torch.from_numpy(np.asarray(vq))
        tks, tvs = torch.from_numpy(np.asarray(ks)), torch.from_numpy(
            np.asarray(vs))
    else:
        jk, jv, tk, tv = (jnp.asarray(kc), jnp.asarray(vc),
                          torch.from_numpy(kc), torch.from_numpy(vc))
        tks = tvs = None
    want = JA.dsa_verify_block_attention(
        jnp.asarray(q), jk, jv, idx, ok, block_k=bk, kv_len=jnp.asarray(kv),
        k_scale=ks, v_scale=vs)
    got = TA.dsa_verify_block_attention(
        torch.from_numpy(q), tk, tv, torch.from_numpy(np.asarray(idx)),
        torch.from_numpy(np.asarray(ok)), block_k=bk,
        kv_len=torch.from_numpy(kv), k_scale=tks, v_scale=tvs)
    _close(got.numpy(), np.asarray(want), 1e-5, "block")
    if quant is None:
        st = rng.standard_normal((b, c, s)).astype(np.float32)
        want = JA.dsa_verify_attention(jnp.asarray(q), jnp.asarray(kc),
                                       jnp.asarray(vc), jnp.asarray(st),
                                       keep=10, kv_len=jnp.asarray(kv),
                                       local=8)
        got = TA.dsa_verify_attention(torch.from_numpy(q),
                                      torch.from_numpy(kc),
                                      torch.from_numpy(vc),
                                      torch.from_numpy(st), keep=10,
                                      kv_len=torch.from_numpy(kv), local=8)
        _close(got.numpy(), np.asarray(want), 1e-5, "faithful")


def test_commit_leaves_inactive_rows_and_refuses_pages():
    """A commit whose mask is all false changes no leaf (a graph
    capture's warm-up); a verify and commit leave the cache's leaves as
    ``init_cache`` made them (the int8 ktb's float K~ rows go to the
    caller's ``spec_scratch``, and a verify without it raises); a paged
    cache is refused."""
    eng = _engine("yi_6b", "kernel", "int8")
    _, caches, _ = eng.prefill(_prompts(eng.cfg.vocab))
    layout = [set(lc) for lc in _leaves(caches)]
    vflags = dataclasses.replace(eng.decode_flags, spec_verify=True)
    chunk = torch.ones((2, 5), dtype=torch.long)
    none = torch.zeros((2,), dtype=torch.bool)
    scratch = TT.spec_scratch(caches, 5)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="spec_scratch"):
            TT.verify_step(eng.params, eng.cfg, vflags, chunk, caches,
                           active=none)
        TT.verify_step(eng.params, eng.cfg, vflags, chunk, caches,
                       active=torch.ones((2,), dtype=torch.bool),
                       scratch=scratch)
        TT.commit_chunk(eng.cfg, vflags, caches, torch.tensor([5, 1]), 5,
                        scratch=scratch)
        before = [{k: v.clone() for k, v in lc.items()}
                  for lc in _leaves(caches)]
        TT.verify_step(eng.params, eng.cfg, vflags, chunk, caches,
                       active=none, scratch=scratch)
        TT.commit_chunk(eng.cfg, vflags, caches, torch.tensor([5, 5]), 5,
                        active=none, scratch=scratch)
    assert [set(lc) for lc in _leaves(caches)] == layout
    for b, lc in zip(before, _leaves(caches)):
        assert set(b) == set(lc)
        for k in b:
            assert torch.equal(TMA.raw(b[k]), TMA.raw(lc[k])), k
    flags = eng.decode_flags
    paged = TT.init_cache(eng.cfg, 2, MAX_LEN, flags, dtype=torch.float32,
                          device="cpu", pages=9)
    with pytest.raises(ValueError, match="paged"):
        TT.commit_chunk(eng.cfg, vflags, paged, torch.tensor([1, 1]), 5)


# -- proposers ----------------------------------------------------------------


def test_ngram_proposer_matches_reference():
    """Drafts of the n-gram proposer on contexts with and without
    repeats, short ones included: the reference's exactly."""
    rng = np.random.default_rng(21)
    ctxs = [np.asarray([5, 6, 7, 8, 1, 2, 5, 6, 7], np.int32),
            np.asarray([1, 2, 3, 4], np.int32), np.asarray([9], np.int32)]
    ctxs += [rng.integers(1, 12, size=(n,)).astype(np.int32)
             for n in (2, 17, 40, 90)]
    for max_n, min_n in ((3, 1), (4, 2), (1, 1)):
        for k in (1, 3, 5):
            got = SP.NGramProposer(max_n, min_n).propose(ctxs, k)
            want = JSP.NGramProposer(max_n, min_n).propose(ctxs, k)
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        SP.NGramProposer(max_n=3).propose([ctxs[0]], 3)[0], [8, 1, 2])


@pytest.mark.parametrize("window", [16, 32])
def test_draft_model_proposer_matches_reference(window):
    """The draft model (stablelm_3b reduced, the reference's weights): the
    reference's drafts on the same contexts, shorter and longer than the
    window; its forward runs k times a round on one uploaded buffer."""
    jc, jparams, tc, tparams = _params("stablelm_3b")
    rng = np.random.default_rng(7)
    ctxs = [rng.integers(1, jc.vocab - 4, size=(n,)).astype(np.int32)
            for n in (5, 30, 17, 1)]
    k = 4
    port = SP.DraftModelProposer(tc, tparams, window=window)
    calls = {"n": 0}
    orig = SP.forward_train

    def counting(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    SP.forward_train = counting
    try:
        got = port.propose(ctxs, k)
    finally:
        SP.forward_train = orig
    assert calls["n"] == k
    want = JSP.DraftModelProposer(jc, jparams, window=window).propose(
        ctxs, k)
    np.testing.assert_array_equal(got, want)
    eng = _engine("stablelm_3b", "off")
    p = _prompts(tc.vocab, b=1, seed=23)
    np.testing.assert_array_equal(
        eng.generate(p, 8, spec=2, draft=port).tokens,
        eng.generate(p, 8).tokens)


# -- the continuous engine ----------------------------------------------------


def _requests(vocab, shapes, seed=0, sampled=False):
    rng = np.random.default_rng(seed)
    return [TS.Request(rid, rng.integers(1, vocab - 4, size=(n,)).astype(
        np.int32), m, greedy=not (sampled and rid % 2), seed=rid * 7 + 1)
        for rid, (n, m) in enumerate(shapes)]


SHAPES = [(PLEN, 12), (200, 7), (150, 1), (230, 9), (180, 10)]


@pytest.mark.parametrize("arch,mode,k", [("stablelm_3b", "off", 3),
                                         ("yi_6b", "kernel", 4),
                                         ("yi_6b", "block", 3),
                                         ("yi_6b", "faithful", 2)])
def test_continuous_spec_equals_solo_generate(arch, mode, k):
    """Speculative segments (chunked admission interleaving, greedy and
    per-slot sampled chains, n_new 1 included): every request gets its
    solo ``generate`` tokens, and the greedy ones the reference's."""
    jc, jparams, tc, tparams = _params(arch)
    ce = TS.ContinuousEngine(tc, tparams, device="cpu", slots=2,
                             max_len=MAX_LEN, seg_len=4, spec=k,
                             chunk_tokens=64, **_kw(arch, mode))
    assert ce.spec == k and ce.spec_rounds == max(1, 4 // (k + 1))
    reqs = _requests(tc.vocab, SHAPES, sampled=True)
    got = ce.run(reqs)
    solo = _engine(arch, mode)
    ref = JE.Engine(jc, jparams, max_len=MAX_LEN, **_kw(arch, mode))
    for r in reqs:
        want = solo.generate(r.prompt[None], r.n_new, greedy=r.greedy,
                             seed=r.seed).tokens[0]
        np.testing.assert_array_equal(got[r.rid], want, err_msg=r.rid)
        if r.greedy:
            np.testing.assert_array_equal(
                got[r.rid], np.asarray(ref.generate(
                    r.prompt[None], r.n_new).tokens[0]), err_msg=r.rid)
    st = ce.stats
    assert st["spec_rounds"] > 0 and st["decode_steps"] == 0
    assert st["spec_emitted"] == sum(r.n_new - 1 for r in reqs)
    assert sum((e + 1) * n for e, n in enumerate(st["accept_hist"])) \
        == st["spec_emitted"]


def test_continuous_spec_envelope():
    """Spec is 0 on a paged engine, on an SWA ring, and for K + 1 > 64 on
    a DSA path; a per-request mode outside the envelope runs plain."""
    _, _, tc, tparams = _params("yi_6b")
    kw = dict(device="cpu", slots=2, max_len=MAX_LEN, seg_len=4)
    assert TS.ContinuousEngine(tc, tparams, spec=3, paged=True,
                               long_context=True, dsa_mode="kernel",
                               **kw).spec == 0
    assert TS.ContinuousEngine(tc, tparams, spec=64, long_context=True,
                               dsa_mode="block", **kw).spec == 0
    h2o = reduced(get_config("h2o_danube_1_8b"))
    assert TS.ContinuousEngine(h2o, TT.init_model(0, h2o, device="cpu"),
                               spec=2, **kw).spec == 0
    # an off engine may speculate 64 drafts; its block requests may not
    ce = TS.ContinuousEngine(tc, tparams, spec=64, long_context=True,
                             dsa_mode="off", **kw)
    assert ce.spec == 64
    reqs = _requests(tc.vocab, [(100, 6), (90, 5)])
    for r in reqs:
        r.dsa_mode = "block"
    got = ce.run(reqs)
    assert ce.stats["spec_rounds"] == 0 and ce.stats["decode_steps"] > 0
    solo = _engine("yi_6b", "block")
    for r in reqs:
        np.testing.assert_array_equal(
            got[r.rid], solo.generate(r.prompt[None], r.n_new).tokens[0])


class _Failing(SP.DraftProposer):
    def __init__(self):
        self.calls = 0

    def propose(self, contexts, k):
        self.calls += 1
        raise RuntimeError("draft failed")


def test_proposer_failures_degrade_to_plain_segments():
    """A proposer that raises: each failing segment runs plain instead
    (no round ran), and after three failures in a row the engine stops
    asking it; every request still gets its solo tokens."""
    _, _, tc, tparams = _params("stablelm_3b")
    draft = _Failing()
    ce = TS.ContinuousEngine(tc, tparams, device="cpu", slots=2,
                             max_len=MAX_LEN, seg_len=4, spec=3, draft=draft)
    reqs = _requests(tc.vocab, [(40, 20), (33, 15)])
    got = ce.run(reqs)
    assert draft.calls == 3 and ce.stats["proposer_failures"] == 3
    assert ce._spec_degraded and "draft failed" in ce.last_proposer_error
    assert ce.stats["spec_rounds"] == 0 and ce.stats["segments"] > 3
    solo = _engine("stablelm_3b", "off")
    for r in reqs:
        np.testing.assert_array_equal(
            got[r.rid], solo.generate(r.prompt[None], r.n_new).tokens[0])


class _Sleepy(SP.DraftProposer):
    def __init__(self, delay_s):
        self.inner = SP.NGramProposer()
        self.delay_s = delay_s

    def propose(self, contexts, k):
        time.sleep(self.delay_s)
        return self.inner.propose(contexts, k)


def test_spec_segment_stats_count_executed_rounds_only():
    """A segment with nothing resident books nothing; ``segment_s``
    leaves drafting out (the chunk-burst tuner reads it)."""
    _, _, tc, tparams = _params("stablelm_3b")
    ce = TS.ContinuousEngine(tc, tparams, device="cpu", slots=2,
                             max_len=MAX_LEN, seg_len=8, spec=3,
                             draft=_Sleepy(0.05))
    assert ce.spec_rounds == 2
    ce.run_spec_segment(lambda: 0.0, [])
    assert ce.stats["segments"] == 0 and ce.stats["segment_s"] == 0.0
    assert ce.stats["spec_rounds"] == 0
    reqs = _requests(tc.vocab, [(20, 8), (33, 6)])
    ce.warmup([len(r.prompt) for r in reqs])
    ce.run(reqs)
    st = ce.stats
    assert st["segments"] > 0 and st["spec_rounds"] > 0
    assert st["draft_s"] >= 0.05 * st["spec_rounds"]
    assert st["segment_s"] < st["draft_s"]


class _Recording(SP.DraftProposer):
    def __init__(self):
        self.inner = SP.NGramProposer()
        self.seen = []

    def propose(self, contexts, k):
        for c in contexts:
            assert not c.flags.writeable
        self.seen.append([np.array(c, np.int32) for c in contexts])
        return self.inner.propose(contexts, k)


def test_spec_history_views_match_full_contexts():
    """Every context a proposer sees is a read-only view of the slot's
    history and equals a prefix of prompt + the request's tokens; plain
    and speculative segments both extend it."""
    _, _, tc, tparams = _params("stablelm_3b")
    draft = _Recording()
    ce = TS.ContinuousEngine(tc, tparams, device="cpu", slots=2,
                             max_len=MAX_LEN, seg_len=4, spec=3, draft=draft)
    reqs = _requests(tc.vocab, [(20, 9), (33, 7), (14, 11)], seed=29)
    got = ce.run(reqs)
    fulls = [np.concatenate([r.prompt, got[r.rid]]) for r in reqs]
    checked = 0
    for call in draft.seen:
        for ctx in call:
            if ctx.size == 1 and ctx[0] == 0:
                continue              # an empty slot's placeholder
            assert any(ctx.size <= f.size and np.array_equal(
                ctx, f[:ctx.size]) for f in fulls), ctx
            checked += 1
    assert checked > 0
    st = TS._SlotState(reqs[0], 1, [], 3, 0.0,
                       history=np.zeros((8,), np.int32), hist_len=2)
    st.extend_history(np.asarray([4, 5], np.int32))
    assert st.hist_len == 4 and st.history[2:4].tolist() == [4, 5]
