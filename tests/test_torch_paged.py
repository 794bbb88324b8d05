"""The paged resident cache of the PyTorch port: K4's plain version
(kernels/dsa_decode.py) against the Pallas kernel in interpret mode and,
bit for bit, against K1's plain version on a page-shuffled copy of a dense
cache; ``PagePool`` accounting; a paged decode step against the dense one
(same logits, every cache leaf equal through the page table); and writes
that must not land (an inactive row, an unmapped block) leaving the zero
page zero.

Tolerance of K4 against the Pallas kernel, as |got - want| <= atol +
rtol * |want|: f32 atol/rtol 1e-5 (same arithmetic, another summation
order).  Paged against dense is exact: the same values go through the
same operations.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import masks as JM
from repro.kernels import ops as jops
from repro_torch.configs.base import get_config, reduced
from repro_torch.inference.scheduler import PagePool
from repro_torch.kernels import dsa_decode as K
from repro_torch.kernels import ops as tops
from repro_torch.models import transformer as TT
from repro_torch.models.attention import Active, RunFlags

torch.set_num_threads(1)


def _shuffled_pools(rng, caches, bk: int, spare: int = 3):
    """The rows of dense (B, S, ...) caches scattered over the pages of
    flat pools, one random page table for all; page 0 stays zero.
    Returns (pools, tbl)."""
    b, s = caches[0].shape[:2]
    n_kb = s // bk
    n_pages = 1 + b * n_kb + spare
    pages = rng.permutation(np.arange(1, n_pages))[:b * n_kb]
    tbl = pages.reshape(b, n_kb).astype(np.int32)
    pools = []
    for dense in caches:
        pool = np.zeros((n_pages * bk,) + dense.shape[2:], dense.dtype)
        for i in range(b):
            for j in range(n_kb):
                p = tbl[i, j]
                pool[p * bk:(p + 1) * bk] = dense[i, j * bk:(j + 1) * bk]
        pools.append(pool)
    return pools, tbl


@pytest.mark.parametrize("s,bk,hq,hkv", [(128, 16, 4, 4), (96, 16, 8, 2),
                                         (128, 32, 8, 1)])
def test_k4_plain_matches_pallas_and_equals_k1(s, bk, hq, hkv):
    rng = np.random.default_rng(s + bk + hq)
    b, hd = 2, 32
    q = rng.standard_normal((b, 1, hq, hd)).astype(np.float32)
    kc = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    vc = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    kv_len = np.array([s - 3, s // 2 + 1], np.int32)
    n_kb = s // bk
    sb = rng.standard_normal((b, n_kb)).astype(np.float32)
    idx, ok = JM.decode_block_topk_indices(
        jnp.asarray(sb), min(n_kb, 4), kv_len=jnp.asarray(kv_len),
        block_k=bk, local=bk)
    (kp, vp), tbl = _shuffled_pools(rng, [kc, vc], bk)
    assert (vp.reshape(-1, bk, hkv, hd)[tbl].reshape(b, s, hkv, hd)
            == vc).all()
    pidx = np.take_along_axis(tbl, np.asarray(idx), axis=1)
    t = torch.from_numpy
    args = (t(np.array(idx)), t(pidx), t(np.array(ok)), t(kv_len))
    got = tops.dsa_decode_paged(t(q), t(kp), t(vp), *args, block_k=bk)
    want = jops.dsa_decode_paged(jnp.asarray(q), jnp.asarray(kp),
                                 jnp.asarray(vp), idx, jnp.asarray(pidx), ok,
                                 jnp.asarray(kv_len), block_k=bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    dense = tops.dsa_decode(t(q), t(kc), t(vc), args[0], args[2], args[3],
                            block_k=bk)
    assert torch.equal(got, dense)


def test_k4_wrapper_takes_plain_version_only_on_cpu():
    q = torch.zeros((1, 2, 1, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        K.dsa_decode_paged_gather_attention(q, q, q, q, q, q, q, block_k=16)


def test_page_pool_accounting():
    pool = PagePool(8, 16)
    assert pool.available() == 7 and 0 not in pool.free

    def invariant():
        held = {p for p in range(1, 8) if pool.ref[p] > 0}
        assert held.isdisjoint(pool.free)
        assert held | set(pool.free) == set(range(1, 8))

    a = pool.alloc(3)
    pool.assign_slot(0, a)
    b = pool.alloc(2)
    pool.assign_slot(1, b)
    invariant()
    assert pool.available() == 2 and not set(a) & set(b)
    assert pool.take_dirty(a) == []            # fresh pages are clean
    pool.free_slot(0)
    invariant()
    assert pool.available() == 5 and pool.dirty == set(a)
    c = pool.alloc(4)
    assert sorted(pool.take_dirty(c)) == sorted(set(c) & set(a))
    assert pool.take_dirty(c) == []
    pool.release(c)
    invariant()
    assert all(pool.ref[p] == 0 for p in c) and set(c) <= set(pool.free)
    pool.free_slot(1)
    invariant()
    assert pool.available() == 7
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.alloc(8)
    with pytest.raises(RuntimeError, match="over-released"):
        pool.release([1])


def _prefilled(mode, lengths, max_len=96):
    """Reduced yi_6b with a dense cache prefilled to ``lengths``."""
    cfg = reduced(get_config("yi_6b"))
    params = TT.init_model(0, cfg, device="cpu")
    b = len(lengths)
    toks = np.random.default_rng(7).integers(
        1, cfg.vocab - 4, size=(b, 48)).astype(np.int32)
    pf = RunFlags(mode="prefill", dsa_mode=mode, long_context=True)
    df = RunFlags(mode="decode", dsa_mode=mode, long_context=True)
    cache = TT.init_cache(cfg, b, max_len, df, dtype=torch.float32,
                          device="cpu")
    with torch.inference_mode():
        logits, cache = TT.forward(params, cfg, pf, torch.from_numpy(toks),
                                   cache)
        TT.truncate_cache(cfg, cache, torch.tensor(lengths))
    last = logits[torch.arange(b), torch.tensor(lengths) - 1]
    return cfg, params, df, cache, last.argmax(-1, keepdim=True)


def _page(cfg, dense, n_pages, rng, mapped):
    """A paged copy of a dense cache: slot b's first ``mapped[b]`` logical
    blocks on shuffled pages, the rest unmapped (reading the zero page)."""
    bk = cfg.dsa.block_k
    paged = TT.init_cache(cfg, len(mapped), dense["groups"][0]["b0"]["attn"]
                          ["k"].shape[1], RunFlags(mode="decode",
                                                   long_context=True),
                          dtype=torch.float32, device="cpu", pages=n_pages)
    pages = rng.permutation(np.arange(1, n_pages))
    tbl = np.zeros((len(mapped), dense["groups"][0]["b0"]["attn"]["ktb"]
                    .shape[1]), np.int32)
    used = 0
    for i, m in enumerate(mapped):
        tbl[i, :m] = pages[used:used + m]
        used += m
    for dl, pl in zip(dense["groups"], paged["groups"]):
        d, p = dl["b0"]["attn"], pl["b0"]["attn"]
        p["page_tbl"].copy_(torch.from_numpy(tbl))
        p["pos"].copy_(d["pos"])
        for i, m in enumerate(mapped):
            for j in range(m):
                pg = int(tbl[i, j])
                for name in ("k", "v", "kt"):
                    p[name][pg * bk:(pg + 1) * bk] = d[name][
                        i, j * bk:(j + 1) * bk]
                p["ktb"][pg] = d["ktb"][i, j]
    return paged, tbl


def _logical(p, name, tbl, bk):
    """A pool leaf seen through the page table: the dense layout."""
    t = torch.from_numpy(tbl).long()
    if name == "ktb":
        return p["ktb"][t]
    rows = (t[:, :, None] * bk + torch.arange(bk)).reshape(t.shape[0], -1)
    return p[name][rows]


@pytest.mark.parametrize("mode", ["off", "block", "kernel"])
def test_paged_decode_equals_dense(mode):
    """Four decode steps (row 1 frozen on the second) on a dense cache and
    on a page-shuffled copy: the same logits bit for bit, and every leaf
    equal through the page table."""
    lengths = [40, 29]
    cfg, params, df, dense, tok = _prefilled(mode, lengths)
    paged, tbl = _page(cfg, dense, 16, np.random.default_rng(1), [4, 3])
    bk = cfg.dsa.block_k
    with torch.inference_mode():
        for step in range(4):
            active = torch.tensor([True, step != 1])
            dl, dense = TT.decode_step(params, cfg, df, tok, dense,
                                       active=active)
            pl, paged = TT.decode_step(params, cfg, df, tok, paged,
                                       active=active)
            assert torch.equal(dl, pl), step
            tok = torch.where(active[:, None], dl[:, -1].argmax(-1)[:, None],
                              tok)
    for dlay, play in zip(dense["groups"], paged["groups"]):
        d, p = dlay["b0"]["attn"], play["b0"]["attn"]
        assert torch.equal(d["pos"], p["pos"])
        assert d["pos"].tolist() == [44, 32]
        for name in ("k", "v", "kt", "ktb"):
            assert torch.equal(_logical(p, name, tbl, bk), d[name]), name


def test_paged_writes_that_drop_never_touch_the_zero_page():
    """Slot 0 is frozen; slot 1 is active but its current block is
    unmapped.  Neither writes: the zero page and every mapped page keep
    their bytes, and only the active slot's pos moves."""
    cfg, params, df, dense, tok = _prefilled("kernel", [40, 29])
    # slot 1 keeps blocks 0-1 only: its write position 29 lies in block 1,
    # so unmap block 1 too and leave only block 0 mapped
    paged, tbl = _page(cfg, dense, 16, np.random.default_rng(2), [3, 1])
    before = {n: t.clone() for n, t in
              paged["groups"][0]["b0"]["attn"].items()}
    bk = cfg.dsa.block_k
    with torch.inference_mode():
        TT.decode_step(params, cfg, df, tok, paged,
                       active=torch.tensor([False, True]))
    for lay in paged["groups"]:
        p = lay["b0"]["attn"]
        for name in ("k", "v", "kt"):
            assert not p[name][:bk].any(), name
        assert not p["ktb"][0].any()
    after = paged["groups"][0]["b0"]["attn"]
    for name in ("k", "v", "kt", "ktb", "page_tbl"):
        assert torch.equal(after[name], before[name]), name
    assert after["pos"].tolist() == [40, 30]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_active_rows_equal_active_mask(paged):
    """A decode step's ``active`` given as a bool mask or as an ``Active``
    holding it and its rows: the same logits and the same cache bytes;
    the frozen row's cache rows and pos do not move."""
    outs = []
    for form in ("mask", "both"):
        cfg, params, df, cache, tok = _prefilled("kernel", [40, 29])
        if paged:
            cache, _ = _page(cfg, cache, 16, np.random.default_rng(3), [4, 3])
        before = {n: t.clone() for n, t in
                  cache["groups"][0]["b0"]["attn"].items()}
        mask = torch.tensor([False, True])
        active = {"mask": mask, "both": Active(mask, torch.tensor([1]))}[form]
        with torch.inference_mode():
            for _ in range(2):
                logits, cache = TT.decode_step(params, cfg, df, tok, cache,
                                               active=active)
        lay = cache["groups"][0]["b0"]["attn"]
        assert lay["pos"].tolist() == [40, 31]
        if not paged:
            for name in ("k", "v", "kt", "ktb"):
                assert torch.equal(lay[name][0], before[name][0]), name
        outs.append((logits[1], cache))
    for logits, cache in outs[1:]:
        assert torch.equal(logits, outs[0][0])
        for la, lb in zip(cache["groups"], outs[0][1]["groups"]):
            for name, t in la["b0"]["attn"].items():
                assert torch.equal(t, lb["b0"]["attn"][name]), name
