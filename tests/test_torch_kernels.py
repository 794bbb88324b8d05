"""K1 (decode gather-attend) and K2 (block-sparse prefill) of the PyTorch
port against the JAX reference's Pallas kernels (interpret mode) and
oracle, on the same numpy inputs.

On the CPU the port's wrappers run their plain versions; the CUDA kernels
themselves are held against those plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.

Tolerances, as |got - want| <= atol + rtol * |want|: f32 atol/rtol 1e-5
(same arithmetic, different summation order); bf16 atol 1e-4, rtol 1e-2
(each side rounds an f32 result to bf16 once, and one bf16 step is at
most 2^-7 of the value).
"""
import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import masks as JM
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import dsa_attention as K2
from repro_torch.kernels import dsa_decode as K1
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-4, 1e-2)}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch CPU tensor."""
    jd, td = DT[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# -- K1: decode gather-attend --------------------------------------------------


@pytest.mark.parametrize("qdt,cdt", [("float32", "float32"),
                                     ("bfloat16", "float32")])
@pytest.mark.parametrize("s,bk", [(128, 16), (100, 16), (104, 32)])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_k1_plain_matches_pallas(s, bk, hq, hkv, qdt, cdt):
    rng = np.random.default_rng(s + hq)
    b, hd = 2, 32
    q = rng.standard_normal((b, 1, hq, hd)).astype(np.float32)
    kc = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    vc = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    kv_len = np.array([s, max(1, s - 37)], np.int32)          # ragged
    n_kb = -(-s // bk)
    sb = rng.standard_normal((b, n_kb)).astype(np.float32)
    idx, ok = JM.decode_block_topk_indices(
        jnp.asarray(sb), min(n_kb, 5), kv_len=jnp.asarray(kv_len),
        block_k=bk, local=32)
    jq, tq = _pair(q, qdt)
    (jk, tk), (jv, tv) = _pair(kc, cdt), _pair(vc, cdt)
    want = jops.dsa_decode(jq, jk, jv, idx, ok, jnp.asarray(kv_len),
                           block_k=bk)
    got = tops.dsa_decode(tq, tk, tv, torch.from_numpy(np.array(idx)),
                          torch.from_numpy(np.array(ok)),
                          torch.from_numpy(kv_len), block_k=bk)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    atol, rtol = TOL[qdt]
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)


# -- K2: block-sparse prefill ---------------------------------------------------


def _k2_case(rng, b, l, hq, hkv, hd, bq, bk, nb, window=0):
    q, k, v = (rng.standard_normal((b, l, h, hd)).astype(np.float32)
               for h in (hq, hkv, hkv))
    bs = rng.standard_normal((b, l // bq, l // bk)).astype(np.float32)
    idx, ok = JM.block_topk_indices(jnp.asarray(bs), nb, causal=True,
                                    window_blocks=window // bk if window
                                    else 0, local_blocks=1)
    return q, k, v, idx, ok


def _k2_check(q, k, v, idx, ok, *, bq, bk, window, dtype):
    jt = [_pair(a, dtype) for a in (q, k, v)]
    (jq, tq), (jk, tk), (jv, tv) = jt
    ti = torch.from_numpy(np.array(idx))
    tok = torch.from_numpy(np.array(ok))
    kw = dict(block_q=bq, block_k=bk, causal=True, window=window)
    got = tops.dsa_attention(tq, tk, tv, ti, tok, **kw)
    pallas = jops.dsa_attention(jq, jk, jv, idx, ok, **kw)
    oracle = jref.dsa_block_sparse_attention_ref(
        *(a.transpose(0, 2, 1, 3) for a in (jq, jk, jv)), idx, ok,
        **kw).transpose(0, 2, 1, 3)
    port_oracle = tref.dsa_block_sparse_attention_ref(
        *(a.transpose(1, 2) for a in (tq, tk, tv)), ti, tok,
        **kw).transpose(1, 2)
    atol, rtol = TOL[dtype]
    assert got.dtype == tq.dtype and got.shape == tq.shape
    for want in (pallas, oracle, port_oracle):
        np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)


@pytest.mark.parametrize("l,bq,bk,nb", [(128, 16, 16, 3), (256, 32, 32, 4),
                                        (256, 64, 32, 5), (512, 64, 64, 3)])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_k2_plain_matches_pallas_and_oracle(l, bq, bk, nb, hq, hkv):
    rng = np.random.default_rng(l + bq + hq)
    case = _k2_case(rng, 2, l, hq, hkv, 32, bq, bk, nb)
    _k2_check(*case, bq=bq, bk=bk, window=0, dtype="float32")


@pytest.mark.parametrize("dtype,window", [("float32", 64),
                                          ("bfloat16", 0)])
def test_k2_plain_window_and_bf16(dtype, window):
    rng = np.random.default_rng(7)
    case = _k2_case(rng, 1, 256, 4, 2, 64, 32, 32, 5, window=window)
    _k2_check(*case, bq=32, bk=32, window=window, dtype=dtype)


@pytest.mark.parametrize("hq,hkv,hd,blk,l", [(2, 2, 80, 32, 128),
                                             (8, 1, 128, 64, 256)],
                         ids=["hd80-g1", "hd128-g8-blk64"])
def test_k2_plain_at_model_head_widths(hq, hkv, hd, blk, l):
    """K2's plain version at stablelm_3b's width (hd 80, one query head per
    KV head) and at yi_6b's (hd 128, GQA group 8) with 64-row blocks,
    against the Pallas kernel and both oracles."""
    rng = np.random.default_rng(hd + hq)
    case = _k2_case(rng, 2, l, hq, hkv, hd, blk, blk, 3)
    _k2_check(*case, bq=blk, bk=blk, window=0, dtype="float32")


def test_wrappers_take_plain_version_only_on_cpu():
    """A tensor on another device than the CPU or the card is refused,
    not run through the plain version."""
    q = torch.zeros((1, 2, 1, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        K1.dsa_decode_gather_attention(q, q, q, q, q, q, block_k=16)
    with pytest.raises(ValueError, match="no kernel"):
        K2.dsa_block_sparse_attention(q, q, q, q, q, block_q=16, block_k=16)


def test_kernel_sources_have_c_entry_points():
    """Each CUDA source exports the C function its wrapper binds."""
    csrc = Path(K1.__file__).parent / "csrc"
    for name, fn in (("dsa_decode", "dsa_decode_launch"),
                     ("dsa_attention", "dsa_attention_launch")):
        src = (csrc / f"{name}.cu").read_text()
        assert f'extern "C" int {fn}(' in src
        assert "sm_90a" in src or "Hopper" in src
    tree = ast.parse(Path(K1.__file__).read_text())
    assert any(isinstance(n, ast.Constant) and n.value == "dsa_decode_launch"
               for n in ast.walk(tree))


@pytest.mark.parametrize("dtype,stride_el,ok", [
    (torch.float32, 4, True), (torch.bfloat16, 4, False),
    (torch.bfloat16, 8, True), (torch.int8, 4, False),
    (torch.int8, 16, True)], ids=["f32-16B", "bf16-8B", "bf16-16B",
                                  "int8-4B", "int8-16B"])
def test_cache_rows_must_start_on_16_bytes(dtype, stride_el, ok):
    """The attention kernels copy cache rows into shared memory 16 bytes
    at a time: a cache whose rows do not start on 16-byte boundaries is
    refused before any launch."""
    from repro_torch.kernels import _launch as LN
    t = torch.zeros((3, 2 * stride_el), dtype=dtype).as_strided(
        (3, 4), (stride_el, 1))
    if ok:
        LN.check_copy_rows("k_cache", t)
    else:
        with pytest.raises(ValueError, match="16-byte"):
            LN.check_copy_rows("k_cache", t)


def test_validity_stream_converts_only_when_needed():
    """The decode kernels read ok as bytes: a bool stream passes through
    as it is (no conversion kernel on the card), an int one is narrowed
    to bool; index streams stay int32."""
    from repro_torch.kernels import _launch as LN
    cpu = torch.device("cpu")
    ok = torch.tensor([[True, False, True]])
    assert LN.check_index("ok", ok, cpu, torch.bool) is ok
    got = LN.check_index("ok", torch.tensor([[1, 0, 2]]), cpu, torch.bool)
    assert got.dtype == torch.bool and got.tolist() == [[True, False, True]]
    idx = LN.check_index("idx", torch.tensor([[3, 1]], dtype=torch.int64),
                         cpu)
    assert idx.dtype == torch.int32
