"""The CUDA kernels K1 to K5, the quantized K1q, K3q, K4q and K5q, and the
chunked wkv6 kernel K7 on the card against their plain versions, with
K2's, K3's and K1/K4's tiling edges (GQA groups, head widths, block
sizes, kv_len inside a tile, rows with no live key, ok = 0 blocks,
strided model-layout views), K2's sliding-window edges on both bodies,
and K7's head widths, chunks and segment counts; and the decode step's
CUDA graphs against eager steps, faithful decode and SWA rings
included.

Needs a CUDA card and the CUDA toolkit; skips without a card.  Imports
neither JAX nor the reference, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \
        tests/test_torch_cuda.py

Tolerances, as |got - want| <= atol + rtol * |want|: f32 atol/rtol 1e-5
(summation order); bf16 atol 1e-4, rtol 1e-2 (both sides round an f32
result to bf16 once, and one bf16 step is at most 2^-7 of the value).
"""
import pytest
import torch

from repro_torch.core.masks import block_topk_indices, chunk_block_topk_indices
from repro_torch.kernels import dsa_attention as K2
from repro_torch.kernels import dsa_chunk_prefill as K3
from repro_torch.kernels import dsa_decode as K1
from repro_torch.kernels import wkv6 as K7

TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-4, 1e-2)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_kernels_match_plain(cuda_device, dtype):
    """K1 and K2 on the card against their plain versions on the same
    inputs (reduced geometry; chip_smoke.py adds the full one)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def rnd(*shape, dt=dtype):
        return torch.randn(shape, generator=gen, device=cuda_device).to(dt)

    b, hq, hkv, hd, s, bk = 2, 8, 2, 16, 100, 16
    q, kc, vc = rnd(b, hq, 1, hd), rnd(b, s, hkv, hd), rnd(b, s, hkv, hd)
    kv_len = torch.tensor([s, 63], dtype=torch.int32, device=cuda_device)
    idx = torch.tensor([[0, 2, 5, 6], [0, 1, 3, 0]], dtype=torch.int32,
                       device=cuda_device)
    ok = torch.tensor([[1, 1, 1, 1], [1, 1, 1, 0]], dtype=torch.bool,
                      device=cuda_device)
    got = K1.dsa_decode_gather_attention(q, kc, vc, idx, ok, kv_len,
                                         block_k=bk)
    want = K1.dsa_decode_gather_attention_plain(q, kc, vc, idx, ok, kv_len,
                                                block_k=bk)
    torch.cuda.synchronize()
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)

    l, bq = 128, 16
    q, k, v = rnd(b, hq, l, hd), rnd(b, hkv, l, hd), rnd(b, hkv, l, hd)
    bs = torch.randn((b, l // bq, l // bq), generator=gen,
                     device=cuda_device)
    idx, ok = block_topk_indices(bs, 3)
    got = K2.dsa_block_sparse_attention(q, k, v, idx, ok, block_q=bq,
                                        block_k=bq)
    want = K2.dsa_block_sparse_attention_plain(q, k, v, idx, ok, block_q=bq,
                                               block_k=bq)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
def test_cuda_k1_full_width_f32(cuda_device):
    """K1's yi_6b body (hd 128, GQA group 8, block 128, ragged kv_len) at
    f32 precision."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    b, hq, hkv, hd, s, bk = 2, 32, 4, 128, 1100, 128
    q = torch.randn((b, hq, 1, hd), generator=gen, device=cuda_device)
    kc, vc = (torch.randn((b, s, hkv, hd), generator=gen, device=cuda_device)
              for _ in range(2))
    kv_len = torch.tensor([s, 641], dtype=torch.int32, device=cuda_device)
    idx = torch.tensor([[0, 3, 7, 8], [1, 2, 5, 0]], dtype=torch.int32,
                       device=cuda_device)
    ok = torch.tensor([[1, 1, 1, 1], [1, 1, 1, 0]], dtype=torch.bool,
                      device=cuda_device)
    got = K1.dsa_decode_gather_attention(q, kc, vc, idx, ok, kv_len,
                                         block_k=bk)
    want = K1.dsa_decode_gather_attention_plain(q, kc, vc, idx, ok, kv_len,
                                                block_k=bk)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_cuda_k2_bf16_refuses_tiles_the_mma_cannot_take(cuda_device):
    """bf16 has one body, on the tensor cores; blocks that are not a
    multiple of 16 rows are refused, not run another way."""
    q = torch.zeros((1, 2, 64, 16), dtype=torch.bfloat16, device=cuda_device)
    idx = torch.zeros((1, 8, 1), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="tensor-core"):
        K2.dsa_block_sparse_attention(q, q, q, idx, idx, block_q=8,
                                      block_k=8)


def _k2_edges(dev, g, hd, bq, bk, seed):
    """bf16 q, k and v as (B,H,L,hd) views of model-layout (B,L,H,hd)
    tensors (row stride H * hd), two KV heads, 3 random distinct key
    blocks per query block, about a fifth of them valid = 0; query block
    0 selects only the last key block, so under the causal mask its rows
    have no live key."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, hkv, nb = 2, 2, 3
    l = 4 * max(bq, bk)

    def view(h):
        return torch.randn((b, l, h, hd), generator=gen, device=dev).to(
            torch.bfloat16).transpose(1, 2)

    q, k, v = view(hkv * g), view(hkv), view(hkv)
    n_qb, n_kb = l // bq, l // bk
    idx = torch.rand((b, n_qb, n_kb), generator=gen,
                     device=dev).argsort(-1)[..., :nb].sort(-1).values
    ok = torch.rand((b, n_qb, nb), generator=gen, device=dev) > 0.2
    idx[:, 0], ok[:, 0] = n_kb - 1, True
    return q, k, v, idx.to(torch.int32), ok.to(torch.int32)


def _check_k2(args, causal=True, **kw):
    got = K2.dsa_block_sparse_attention(*args, causal=causal, **kw)
    want = K2.dsa_block_sparse_attention_plain(*args, causal=causal, **kw)
    torch.cuda.synchronize()
    atol, rtol = TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    if causal:
        bq = kw["block_q"]
        assert not got[:, :, :bq].any() and not want[:, :, :bq].any()


@pytest.mark.cuda
@pytest.mark.parametrize("blk", [16, 64, 128])
@pytest.mark.parametrize("hd", [64, 80, 128])
@pytest.mark.parametrize("g", [1, 4, 8])
def test_cuda_k2_tiling_edges_match_plain(cuda_device, g, hd, blk):
    """K2's bf16 body (warpgroup MMAs on TMA-fed 128-key tiles, two
    64-row warpgroups) over its edges: GQA groups 1 to 8, hd 64 to 128
    (80: stablelm_3b's, a 160-byte row), query blocks of 16 to 128 rows,
    strided model-layout views, valid = 0 blocks and rows with no live
    key (exactly 0), at bf16's tolerance."""
    args = _k2_edges(cuda_device, g, hd, blk, blk, seed=40 + g + hd + blk)
    _check_k2(args, block_q=blk, block_k=blk)


@pytest.mark.cuda
@pytest.mark.parametrize("bq,bk,causal,window", [
    (64, 128, True, 0), (128, 64, True, 0), (64, 64, False, 0),
    (64, 64, True, 100)],
    ids=["bq64-bk128", "bq128-bk64", "not-causal", "window"])
def test_cuda_k2_blocks_and_masks_match_plain(cuda_device, bq, bk, causal,
                                              window):
    """K2's bf16 body with block_q != block_k (a key block shorter and
    longer than the 128-key tile), without the causal mask, and with a
    sliding window that cuts tiles (G 4, hd 128)."""
    args = _k2_edges(cuda_device, 4, 128, bq, bk, seed=60 + bq + bk)
    _check_k2(args, causal=causal, block_q=bq, block_k=bk, window=window)


def _k2_window_inputs(dev, dtype, g, hd, blk, l, seed):
    """q, k and v in ``dtype`` as (B,H,L,hd) views of model-layout
    tensors, two KV heads, 4 random distinct key blocks per query block
    (some behind the window, some above the diagonal), the diagonal
    block among them, about a fifth valid = 0 off the diagonal."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, hkv, nb = 2, 2, 4
    n = l // blk

    def view(h):
        return torch.randn((b, l, h, hd), generator=gen, device=dev).to(
            dtype).transpose(1, 2)

    q, k, v = view(hkv * g), view(hkv), view(hkv)
    idx = torch.rand((b, n, n), generator=gen,
                     device=dev).argsort(-1)[..., :nb]
    diag = torch.arange(n, device=dev)[None, :, None]
    has = (idx == diag).any(-1, keepdim=True)
    idx[..., :1] = torch.where(has, idx[..., :1], diag)
    idx = idx.sort(-1).values
    ok = (torch.rand((b, n, nb), generator=gen, device=dev) > 0.2) | (
        idx == diag)
    return q, k, v, idx.to(torch.int32), ok.to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("blk,window,l", [
    (128, 256, 1024), (128, 200, 1024), (128, 100, 512), (16, 40, 256),
    (16, 10, 128), (64, 4096, 8192)],
    ids=["b128-w256", "b128-w200", "b128-w100", "b16-w40", "b16-w10",
         "b64-w4096"])
@pytest.mark.parametrize("hd", [64, 80, 128])
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_k2_window_edges_match_plain(cuda_device, dtype, g, hd, blk,
                                          window, l):
    """K2's sliding-window path (h2o_danube_1_8b's prefill) on the bf16
    wgmma body and the f32 body: a window that is a block multiple, one
    that is not, one shorter than a block, and h2o's 4096 at L 8192;
    tiles wholly behind the window skipped, tiles it cuts masked per row
    (the bound qpos - window + 1), hd 64, 80 (padded to 128 columns) and
    128, GQA groups 1 to 8; at the dtype's tolerance."""
    args = _k2_window_inputs(cuda_device, dtype, g, hd, blk, l,
                             seed=70 + g + hd + blk + window)
    kw = dict(block_q=blk, block_k=blk, causal=True, window=window)
    got = K2.dsa_block_sparse_attention(*args, **kw)
    want = K2.dsa_block_sparse_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,cdt", [(torch.bfloat16, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.float32)],
                         ids=["bf16-f32", "bf16-bf16", "f32-f32"])
def test_cuda_k3_matches_plain(cuda_device, qdt, cdt):
    """K3 (chunk prefill) against its plain version: ragged chunk offsets
    and cache lengths, a partial last chunk, and a cache whose length is
    not a block multiple; tolerance by the query's dtype."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    b, hq, hkv, hd, s, c, blk = 2, 8, 2, 32, 100, 32, 16
    q = torch.randn((b, hq, c, hd), generator=gen, device=cuda_device).to(qdt)
    kc, vc = (torch.randn((b, s, hkv, hd), generator=gen,
                          device=cuda_device).to(cdt) for _ in range(2))
    q_off = torch.tensor([64, 32], dtype=torch.int32, device=cuda_device)
    kv_len = torch.tensor([100, 37], dtype=torch.int32, device=cuda_device)
    bs = torch.randn((b, c // blk, -(-s // blk)), generator=gen,
                     device=cuda_device)
    idx, ok = chunk_block_topk_indices(bs, 3, q_block_offset=q_off // blk)
    args = (q, kc, vc, idx, ok, q_off, kv_len)
    got = K3.dsa_chunk_gather_attention(*args, block_q=blk, block_k=blk)
    want = K3.dsa_chunk_gather_attention_plain(*args, block_q=blk,
                                               block_k=blk)
    torch.cuda.synchronize()
    atol, rtol = TOL[qdt]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_k4_matches_plain_and_equals_k1(cuda_device, cdt):
    """K4 (paged decode) against its plain version, and bit for bit
    against K1 on a pool that holds K1's cache under a shuffled page
    table."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    b, hq, hkv, hd, s, bk = 2, 32, 4, 128, 1024, 128
    n_kb = s // bk
    q = torch.randn((b, hq, 1, hd), generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    kc, vc = (torch.randn((b, s, hkv, hd), generator=gen,
                          device=cuda_device).to(cdt) for _ in range(2))
    kv_len = torch.tensor([s - 5, 641], dtype=torch.int32,
                          device=cuda_device)
    idx = torch.tensor([[0, 3, 6, 7], [1, 2, 5, 0]], dtype=torch.int32,
                       device=cuda_device)
    ok = torch.tensor([[1, 1, 1, 1], [1, 1, 1, 0]], dtype=torch.bool,
                      device=cuda_device)
    pages = torch.randperm(b * n_kb, generator=torch.Generator().manual_seed(
        4)).to(cuda_device) + 1
    tbl = pages.reshape(b, n_kb)
    pool_k = torch.zeros(((b * n_kb + 1) * bk, hkv, hd), dtype=cdt,
                         device=cuda_device)
    pool_v = torch.zeros_like(pool_k)
    rows = (tbl[:, :, None] * bk + torch.arange(bk, device=cuda_device)
            ).reshape(b, s)
    pool_k[rows] = kc
    pool_v[rows] = vc
    pidx = torch.gather(tbl, 1, idx.long()).to(torch.int32)
    got = K1.dsa_decode_paged_gather_attention(q, pool_k, pool_v, idx, pidx,
                                               ok, kv_len, block_k=bk)
    want = K1.dsa_decode_paged_gather_attention_plain(
        q, pool_k, pool_v, idx, pidx, ok, kv_len, block_k=bk)
    dense = K1.dsa_decode_gather_attention(q, kc, vc, idx, ok, kv_len,
                                           block_k=bk)
    torch.cuda.synchronize()
    atol, rtol = TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    assert torch.equal(got, dense)


def _quant_cache(gen, dev, shape, kind):
    """An int8/fp8 cache with its scales, from random f32 rows."""
    from repro_torch.core.quantization import quant_store
    return quant_store(torch.randn(shape, generator=gen, device=dev),
                       dtype=kind)


def _pooled(tbl, bk, *dense):
    """Each dense (B, S, ...) leaf scattered over the pages ``tbl`` maps
    (page 0, unmapped pages and rows past S zero)."""
    from repro_torch.core.quantization import raw
    out = []
    n_pages = int(tbl.max()) + 1
    b, n_kb = tbl.shape
    rows = (tbl[:, :, None] * bk + torch.arange(bk, device=tbl.device)
            ).reshape(b, n_kb * bk)
    for d in dense:
        pool = torch.zeros((n_pages * bk,) + tuple(d.shape[2:]),
                           dtype=d.dtype, device=d.device)
        raw(pool)[rows[:, :d.shape[1]]] = raw(d)
        out.append(pool)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("qdt", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_cuda_k1q_k4q_match_plain_and_equal_unquantized(cuda_device, kind,
                                                        qdt):
    """K1q and K4q on an int8/fp8 cache: within tolerance of their plain
    versions, bit for bit K1 on the dequantized f32 cache, and K4q bit
    for bit K1q on a page-shuffled copy."""
    from repro_torch.core.quantization import dequant
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    b, hq, hkv, hd, s, bk = 2, 32, 4, 128, 1024, 128
    n_kb = s // bk
    q = torch.randn((b, hq, 1, hd), generator=gen,
                    device=cuda_device).to(qdt)
    kq, ks = _quant_cache(gen, cuda_device, (b, s, hkv, hd), kind)
    vq, vs = _quant_cache(gen, cuda_device, (b, s, hkv, hd), kind)
    kv_len = torch.tensor([s - 5, 641], dtype=torch.int32,
                          device=cuda_device)
    idx = torch.tensor([[0, 3, 6, 7], [1, 2, 5, 0]], dtype=torch.int32,
                       device=cuda_device)
    ok = torch.tensor([[1, 1, 1, 1], [1, 1, 1, 0]], dtype=torch.bool,
                      device=cuda_device)
    sc = dict(block_k=bk, k_scale=ks, v_scale=vs)
    got = K1.dsa_decode_gather_attention(q, kq, vq, idx, ok, kv_len, **sc)
    want = K1.dsa_decode_gather_attention_plain(q, kq, vq, idx, ok, kv_len,
                                                **sc)
    ref = K1.dsa_decode_gather_attention(q, dequant(kq, ks),
                                         dequant(vq, vs), idx, ok, kv_len,
                                         block_k=bk)
    pages = torch.randperm(b * n_kb, generator=torch.Generator().manual_seed(
        6)).to(cuda_device) + 1
    tbl = pages.reshape(b, n_kb)
    pk, pv, pks, pvs = _pooled(tbl, bk, kq, vq, ks, vs)
    pidx = torch.gather(tbl, 1, idx.long()).to(torch.int32)
    paged = K1.dsa_decode_paged_gather_attention(
        q, pk, pv, idx, pidx, ok, kv_len, block_k=bk, k_scale=pks,
        v_scale=pvs)
    paged_plain = K1.dsa_decode_paged_gather_attention_plain(
        q, pk, pv, idx, pidx, ok, kv_len, block_k=bk, k_scale=pks,
        v_scale=pvs)
    torch.cuda.synchronize()
    atol, rtol = TOL[qdt]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(paged.float(), paged_plain.float(), atol=atol,
                               rtol=rtol)
    assert torch.equal(got, ref)
    assert torch.equal(paged, got)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("qdt", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_cuda_k3q_matches_plain_and_equals_unquantized(cuda_device, kind,
                                                       qdt):
    """K3q on an int8/fp8 cache (ragged offsets and lengths, a cache that
    is not a block multiple): within tolerance of its plain version and
    bit for bit K3 on the dequantized f32 cache."""
    from repro_torch.core.quantization import dequant
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    b, hq, hkv, hd, s, c, blk = 2, 32, 4, 128, 600, 256, 128
    q = torch.randn((b, hq, c, hd), generator=gen, device=cuda_device).to(qdt)
    kq, ks = _quant_cache(gen, cuda_device, (b, s, hkv, hd), kind)
    vq, vs = _quant_cache(gen, cuda_device, (b, s, hkv, hd), kind)
    q_off = torch.tensor([256, 128], dtype=torch.int32, device=cuda_device)
    kv_len = torch.tensor([512, 300], dtype=torch.int32, device=cuda_device)
    bs = torch.randn((b, c // blk, -(-s // blk)), generator=gen,
                     device=cuda_device)
    idx, ok = chunk_block_topk_indices(bs, 3, q_block_offset=q_off // blk)
    args = (idx, ok, q_off, kv_len)
    kw = dict(block_q=blk, block_k=blk)
    got = K3.dsa_chunk_gather_attention(q, kq, vq, *args, k_scale=ks,
                                        v_scale=vs, **kw)
    want = K3.dsa_chunk_gather_attention_plain(q, kq, vq, *args, k_scale=ks,
                                               v_scale=vs, **kw)
    ref = K3.dsa_chunk_gather_attention(q, dequant(kq, ks), dequant(vq, vs),
                                        *args, **kw)
    torch.cuda.synchronize()
    atol, rtol = TOL[qdt]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", [None, "int8", "fp8"],
                         ids=["k5", "k5q-int8", "k5q-fp8"])
def test_cuda_k5_matches_plain_and_equals_k3(cuda_device, kind):
    """K5 (K5q with scales) on a page-shuffled pool: within tolerance of
    its plain version and bit for bit K3 (K3q) on the dense cache."""
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    b, hq, hkv, hd, s, c, blk = 2, 32, 4, 128, 640, 256, 128
    n_kb = s // blk
    q = torch.randn((b, hq, c, hd), generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    if kind is None:
        kc, vc = (torch.randn((b, s, hkv, hd), generator=gen,
                              device=cuda_device) for _ in range(2))
        ks = vs = None
    else:
        kc, ks = _quant_cache(gen, cuda_device, (b, s, hkv, hd), kind)
        vc, vs = _quant_cache(gen, cuda_device, (b, s, hkv, hd), kind)
    q_off = torch.tensor([384, 128], dtype=torch.int32, device=cuda_device)
    kv_len = torch.tensor([640, 300], dtype=torch.int32, device=cuda_device)
    bs = torch.randn((b, c // blk, n_kb), generator=gen, device=cuda_device)
    idx, ok = chunk_block_topk_indices(bs, 3, q_block_offset=q_off // blk)
    pages = torch.randperm(b * n_kb, generator=torch.Generator().manual_seed(
        9)).to(cuda_device) + 1
    tbl = pages.reshape(b, n_kb)
    pools = _pooled(tbl, blk, kc, vc, *(() if ks is None else (ks, vs)))
    pks, pvs = (None, None) if ks is None else pools[2:]
    pidx = torch.gather(tbl[:, None, :].expand(b, c // blk, n_kb), 2,
                        idx.long()).to(torch.int32)
    kw = dict(block_q=blk, block_k=blk)
    got = K3.dsa_chunk_paged_gather_attention(
        q, pools[0], pools[1], idx, pidx, ok, q_off, kv_len, k_scale=pks,
        v_scale=pvs, **kw)
    want = K3.dsa_chunk_paged_gather_attention_plain(
        q, pools[0], pools[1], idx, pidx, ok, q_off, kv_len, k_scale=pks,
        v_scale=pvs, **kw)
    dense = K3.dsa_chunk_gather_attention(q, kc, vc, idx, ok, q_off, kv_len,
                                          k_scale=ks, v_scale=vs, **kw)
    torch.cuda.synchronize()
    atol, rtol = TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    assert torch.equal(got, dense)


def _k3_edges(dev, g, hd, blk, seed):
    """A chunk of two query blocks over three batch rows (2 KV heads, a
    cache one block and 7 rows past four blocks, f32) at the K/V tiles'
    edges: row 0 a partial last chunk whose kv_len ends inside a tile;
    row 1 a whole chunk with its first query block's selection all ok = 0,
    so those rows have no live key; row 2 frozen (kv_len 0).  Returns the
    call's positional operands."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, hkv, c, s = 3, 2, 2 * blk, 5 * blk + 7
    q = torch.randn((b, hkv * g, c, hd), generator=gen, device=dev)
    kc, vc = (torch.randn((b, s, hkv, hd), generator=gen, device=dev)
              for _ in range(2))
    q_off = torch.tensor([2 * blk, 3 * blk, 0], dtype=torch.int32,
                         device=dev)
    kv_len = torch.tensor([3 * blk + 5, 5 * blk, 0], dtype=torch.int32,
                          device=dev)
    bs = torch.randn((b, 2, -(-s // blk)), generator=gen, device=dev)
    idx, ok = chunk_block_topk_indices(bs, 3, q_block_offset=q_off // blk)
    ok[1, 0] = False
    return q, kc, vc, idx, ok, q_off, kv_len


def _assert_k3_edges(got, want, blk):
    atol, rtol = TOL[torch.float32]
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)
    assert not got[1, :, :blk].any() and not want[1, :, :blk].any()
    assert not got[2].any() and not want[2].any()


@pytest.mark.cuda
@pytest.mark.parametrize("blk", [16, 64, 128])
@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("g", [1, 4, 8, 16])
def test_cuda_k3_tiling_edges_match_plain(cuda_device, g, hd, blk):
    """K3 over the new tiling's edges (64-key tiles, 128 (row, head) pairs
    a CTA): GQA groups 1 to 16, hd 16 to 128, block_q 16 to 128; kv_len
    inside a tile, a partial last chunk, rows with no live key (exactly 0)
    and a frozen row, at f32's tolerance."""
    args = _k3_edges(cuda_device, g, hd, blk, seed=10 + g + hd + blk)
    kw = dict(block_q=blk, block_k=blk)
    got = K3.dsa_chunk_gather_attention(*args, **kw)
    want = K3.dsa_chunk_gather_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    _assert_k3_edges(got, want, blk)


@pytest.mark.cuda
@pytest.mark.parametrize("blk", [16, 64, 128])
def test_cuda_k3_hd80_g1_matches_plain(cuda_device, blk):
    """K3 at stablelm_3b's width, hd 80 with one query head per KV head:
    there only some lanes of a warp hold columns of the upper half-row
    (the has1 branch)."""
    args = _k3_edges(cuda_device, 1, 80, blk, seed=50 + blk)
    kw = dict(block_q=blk, block_k=blk)
    got = K3.dsa_chunk_gather_attention(*args, **kw)
    want = K3.dsa_chunk_gather_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    _assert_k3_edges(got, want, blk)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", [None, "int8", "fp8"],
                         ids=["k5", "k3q-k5q-int8", "k3q-k5q-fp8"])
def test_cuda_k3_edges_bitwise_contracts(cuda_device, kind):
    """At the same edges (G 4, hd 64, block 64): K3q equals K3 on the
    dequantized cache bit for bit, and K5 (K5q) on a page-shuffled pool
    equals K3 (K3q) bit for bit; each within tolerance of its plain
    version."""
    from repro_torch.core.quantization import dequant, quant_store
    blk = 64
    q, kc, vc, idx, ok, q_off, kv_len = _k3_edges(cuda_device, 4, 64, blk,
                                                  seed=30)
    kw = dict(block_q=blk, block_k=blk)
    sc = {}
    if kind is not None:
        (kc, ks), (vc, vs) = (quant_store(t, dtype=kind) for t in (kc, vc))
        sc = dict(k_scale=ks, v_scale=vs)
    got = K3.dsa_chunk_gather_attention(q, kc, vc, idx, ok, q_off, kv_len,
                                        **sc, **kw)
    want = K3.dsa_chunk_gather_attention_plain(q, kc, vc, idx, ok, q_off,
                                               kv_len, **sc, **kw)
    b, s = kc.shape[:2]
    n_kb = -(-s // blk)
    pages = torch.randperm(b * n_kb, generator=torch.Generator().manual_seed(
        31)).to(cuda_device) + 1
    tbl = pages.reshape(b, n_kb)
    pools = _pooled(tbl, blk, kc, vc, *sc.values())
    pidx = torch.gather(tbl[:, None, :].expand(b, idx.shape[1], n_kb), 2,
                        idx.long()).to(torch.int32)
    psc = dict(zip(("k_scale", "v_scale"), pools[2:]))
    paged = K3.dsa_chunk_paged_gather_attention(
        q, pools[0], pools[1], idx, pidx, ok, q_off, kv_len, **psc, **kw)
    torch.cuda.synchronize()
    _assert_k3_edges(got, want, blk)
    assert torch.equal(paged, got)
    if kind is not None:
        ref = K3.dsa_chunk_gather_attention(
            q, dequant(kc, sc["k_scale"]), dequant(vc, sc["v_scale"]), idx,
            ok, q_off, kv_len, **kw)
        assert torch.equal(got, ref)


@pytest.mark.cuda
def test_cuda_k3_refuses_what_its_tiling_cannot_take(cuda_device):
    """A GQA group above 16 heads, and cache rows off 16-byte boundaries
    (the tiles are copied 16 bytes at a time), are refused, not run
    another way."""
    dev = cuda_device
    idx = torch.zeros((1, 1, 1), dtype=torch.int32, device=dev)
    off = torch.zeros((1,), dtype=torch.int32, device=dev)
    kw = dict(block_q=16, block_k=16)
    q = torch.zeros((1, 34, 16, 16), device=dev)
    kc = torch.zeros((1, 16, 2, 16), device=dev)
    with pytest.raises(ValueError, match="unsupported chunk shape"):
        K3.dsa_chunk_gather_attention(q, kc, kc, idx, idx, off, off, **kw)
    q = torch.zeros((1, 2, 16, 16), device=dev)
    kc = torch.zeros((1, 16, 1, 20), dtype=torch.bfloat16,
                     device=dev)[..., :16]
    with pytest.raises(ValueError, match="16-byte boundaries"):
        K3.dsa_chunk_gather_attention(q, kc, kc, idx, idx, off, off, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("bk,g,hd", [(48, 8, 128), (100, 4, 64),
                                     (16, 16, 32), (200, 1, 80)],
                         ids=["bk48", "bk100", "bk16-g16", "bk200-g1"])
def test_cuda_k1_k4_tiling_edges(cuda_device, bk, g, hd):
    """K1 and K4 over the new 64-row tiles' edges: block_k no multiple of
    64, kv_len inside the first tile (row 1: 5 live rows), ok = 0 blocks
    and blocks past kv_len (row 2), a cache that is not a block multiple;
    bf16 q against an f32 cache.  Each within tolerance of its plain
    version; K4 on a page-shuffled pool equals K1 bit for bit; K1q (int8)
    equals K1 on the dequantized cache and K4q equals K1q, bit for bit."""
    from repro_torch.core.quantization import dequant, quant_store
    gen = torch.Generator(device=cuda_device).manual_seed(bk + g)
    b, hkv = 3, 2
    n_kb = 6
    s = n_kb * bk
    q = torch.randn((b, hkv * g, 1, hd), generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    kc, vc = (torch.randn((b, s, hkv, hd), generator=gen,
                          device=cuda_device) for _ in range(2))
    kv_len = torch.tensor([s - 3, 5, bk + 70], dtype=torch.int32,
                          device=cuda_device)
    idx = torch.tensor([[0, 2, 4, 5], [0, 1, 3, 0], [1, 0, 2, 3]],
                       dtype=torch.int32, device=cuda_device)
    ok = torch.tensor([[1, 1, 1, 1], [1, 0, 0, 0], [1, 0, 1, 1]],
                      dtype=torch.bool, device=cuda_device)
    pages = torch.randperm(b * n_kb, generator=torch.Generator().manual_seed(
        bk)).to(cuda_device) + 1
    tbl = pages.reshape(b, n_kb)
    pidx = torch.gather(tbl, 1, idx.long()).to(torch.int32)
    (kq, ks), (vq, vs) = (quant_store(t, dtype="int8") for t in (kc, vc))
    atol, rtol = TOL[torch.bfloat16]
    outs = {}
    for name, (kk, vv, sc) in {
            "full": (kc, vc, {}),
            "int8": (kq, vq, dict(k_scale=ks, v_scale=vs))}.items():
        args = (q, kk, vv, idx, ok, kv_len)
        got = K1.dsa_decode_gather_attention(*args, block_k=bk, **sc)
        want = K1.dsa_decode_gather_attention_plain(*args, block_k=bk, **sc)
        pools = _pooled(tbl, bk, kk, vv, *sc.values())
        psc = dict(zip(("k_scale", "v_scale"), pools[2:]))
        paged = K1.dsa_decode_paged_gather_attention(
            q, pools[0], pools[1], idx, pidx, ok, kv_len, block_k=bk, **psc)
        paged_plain = K1.dsa_decode_paged_gather_attention_plain(
            q, pools[0], pools[1], idx, pidx, ok, kv_len, block_k=bk, **psc)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)
        torch.testing.assert_close(paged.float(), paged_plain.float(),
                                   atol=atol, rtol=rtol)
        assert torch.equal(paged, got)
        outs[name] = got
    ref = K1.dsa_decode_gather_attention(q, dequant(kq, ks), dequant(vq, vs),
                                         idx, ok, kv_len, block_k=bk)
    torch.cuda.synchronize()
    assert torch.equal(outs["int8"], ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hd,chunk,w_const", [(16, 32, None), (64, 32, None),
                                              (64, 16, None), (16, 32, 0.3)],
                         ids=["hd16", "hd64", "hd64-chunk16", "clamp"])
def test_cuda_k7_matches_plain(cuda_device, dtype, hd, chunk, w_const):
    """K7 on (B,H,S,hd) views of model-layout (B,S,H,hd) tensors, from a
    zero and a random state, against its plain version: y and s_last.
    "clamp": w = 0.3, so the -30 clamp binds in every chunk.  f32
    matmuls stay f32 (no TF32) for the plain version."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(hd + chunk)
    b, h, s = 2, 3, 128

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=cuda_device) * scale

    r, k, v = rnd(b, s, h, hd), rnd(b, s, h, hd, scale=0.3), rnd(b, s, h, hd)
    w = (torch.full((b, s, h, hd), w_const, device=cuda_device)
         if w_const else torch.exp(-torch.exp(rnd(b, s, h, hd) * 0.5 - 2)))
    r, k, v, w = (t.to(dtype).transpose(1, 2) for t in (r, k, v, w))
    u = rnd(h, hd, scale=0.1).to(dtype)
    atol, rtol = TOL[dtype]
    for s0 in (None, rnd(b, h, hd, hd, scale=0.5)):
        before = K7.wkv6_chunked.launches
        y, st = K7.wkv6_chunked(r, k, v, w, u, s0, chunk=chunk)
        assert K7.wkv6_chunked.launches == before + 1
        yp, sp = K7.wkv6_chunked_plain(r, k, v, w, u, s0, chunk=chunk)
        torch.cuda.synchronize()
        torch.testing.assert_close(y.float(), yp.float(), atol=atol,
                                   rtol=rtol)
        torch.testing.assert_close(st, sp, atol=1e-5, rtol=1e-5)


def _k7_inputs(dev, dtype, hd, seed, w_const=None, b=2, h=3, s=96):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    r, k, v = rnd(b, s, h, hd), rnd(b, s, h, hd, scale=0.3), rnd(b, s, h, hd)
    w = (torch.full((b, s, h, hd), w_const, device=dev) if w_const
         else torch.exp(-torch.exp(rnd(b, s, h, hd) * 0.5 - 2)))
    args = [t.to(dtype).transpose(1, 2) for t in (r, k, v, w)]
    return args + [rnd(h, hd, scale=0.1).to(dtype)], rnd(b, h, hd, hd,
                                                        scale=0.5)


# K7 cuts its chain of chunks into about SEGMENTS_PER_SM * SMs / (B H)
# segments, at most one a chunk: 0 gives one segment; at B H = 6 the
# default gives one a chunk, and 0.1 a few of several chunks each.
SEGMENT_CASES = dict(argvalues=[0, 0.1, K7.SEGMENTS_PER_SM],
                     ids=["one-segment", "few-segments", "default"])


@pytest.mark.cuda
@pytest.mark.parametrize("per_sm", **SEGMENT_CASES)
@pytest.mark.parametrize("chunk", [8, 16, 32])
@pytest.mark.parametrize("hd", [16, 32, 64])
def test_cuda_k7_segments_match_plain(cuda_device, monkeypatch, hd, chunk,
                                      per_sm):
    """K7's segmented chain (the state pass per segment from a zero
    state, the carry of the state across segments, the full pass writing
    y) at every head width and chunk it takes, in one segment and in
    several, from a zero and a random state: y and s_last at f32's
    tolerance (the f32 instance sums y on the FMA pipe, the state update
    at 3xTF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.setattr(K7, "SEGMENTS_PER_SM", per_sm)
    args, s0r = _k7_inputs(cuda_device, torch.float32, hd, seed=hd + chunk)
    for s0 in (None, s0r):
        y, st = K7.wkv6_chunked(*args, s0, chunk=chunk)
        yp, sp = K7.wkv6_chunked_plain(*args, s0, chunk=chunk)
        torch.cuda.synchronize()
        torch.testing.assert_close(y, yp, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(st, sp, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("per_sm", **SEGMENT_CASES)
@pytest.mark.parametrize("w_const", [None, 0.3], ids=["decay", "clamp"])
def test_cuda_k7_bf16_segments_match_plain(cuda_device, monkeypatch,
                                           w_const, per_sm):
    """The bf16 instance (every product at 3xTF32) at rwkv6_3b's head
    width in one segment and in several, from a zero and a random state,
    also where the -30 clamp binds in every chunk (w = 0.3): y at bf16's
    tolerance, s_last at f32's."""
    monkeypatch.setattr(K7, "SEGMENTS_PER_SM", per_sm)
    args, s0r = _k7_inputs(cuda_device, torch.bfloat16, 64, seed=7,
                           w_const=w_const, s=384)
    atol, rtol = TOL[torch.bfloat16]
    for s0 in (None, s0r):
        y, st = K7.wkv6_chunked(*args, s0)
        yp, sp = K7.wkv6_chunked_plain(*args, s0)
        torch.cuda.synchronize()
        torch.testing.assert_close(y.float(), yp.float(), atol=atol,
                                   rtol=rtol)
        torch.testing.assert_close(st, sp, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_cuda_k7_refuses_what_it_cannot_take(cuda_device):
    x = torch.zeros((1, 2, 64, 128), device=cuda_device)
    u = torch.zeros((2, 128), device=cuda_device)
    with pytest.raises(ValueError, match="hd <= 64"):
        K7.wkv6_chunked(x, x, x, x, u)
    x = torch.zeros((1, 2, 40, 16), device=cuda_device)
    with pytest.raises(ValueError, match="dividing S"):
        K7.wkv6_chunked(x, x, x, x, u[:, :16])


@pytest.mark.cuda
def test_cuda_k7_refuses_heads_off_16_columns(cuda_device):
    """The CTA's threads stage rows in groups of 8 columns and its warps
    own m16 tiles of the state: hd 40 (a multiple of 4, which the first
    design took) is refused, not run another way."""
    x = torch.zeros((1, 2, 64, 40), device=cuda_device)
    u = torch.zeros((2, 40), device=cuda_device)
    with pytest.raises(ValueError, match="a multiple of 16"):
        K7.wkv6_chunked(x, x, x, x, u)


# -- the decode step as a CUDA graph (inference/graphs.py) ----------------------

GRAPH_MAX_LEN = 96
DSA_KW = dict(long_context=True, dsa_mode="kernel")
QUANT_KW = {None: {}, "int8": dict(kv_quant="int8", select_dtype="int8"),
            "fp8": dict(kv_quant="fp8", select_dtype="int8")}


def _model(arch, dev):
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models.transformer import init_model
    cfg = reduced(get_config(arch))
    return cfg, init_model(0, cfg, device=dev)


def _decode_count(kv, paged=False):
    """The decode kernel's counter: (wrapper, attribute)."""
    fn = (K1.dsa_decode_paged_gather_attention if paged
          else K1.dsa_decode_gather_attention)
    return fn, "launches_quant" if kv else "launches"


def _requests(vocab, greedy_mix=False):
    import numpy as np
    from repro_torch.inference.scheduler import Request
    rng = np.random.default_rng(7)
    shapes = [(48, 8), (21, 12), (65, 5), (30, 10), (17, 7)]
    return [Request(rid, rng.integers(1, vocab - 4, size=(n,)).astype(
        np.int32), m, greedy=not (greedy_mix and rid % 2), seed=3 * rid + 1,
        temperature=(1.0, 0.7)[rid % 2]) for rid, (n, m) in enumerate(shapes)]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kv", [("yi_6b", None), ("yi_6b", "fp8"),
                                     ("yi_6b", "int8"), ("rwkv6_3b", None)],
                         ids=["yi_6b", "yi_6b-fp8", "yi_6b-int8", "rwkv6_3b"])
@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_cuda_graph_scan_equals_eager_loop(cuda_device, arch, kv, greedy):
    """The static engine's scan loop (one graph replay a step) gives the
    python loop's tokens (eager steps) bit for bit, a ragged batch on
    yi_6b; one capture, one replay a bucketed step, and the decode
    kernel counted n_layers times a step on both loops."""
    import numpy as np
    from repro_torch.inference.engine import Engine
    cfg, params = _model(arch, cuda_device)
    kw = {} if cfg.rwkv else dict(DSA_KW, **QUANT_KW[kv])
    rng = np.random.default_rng(1)
    prompts = rng.integers(1, cfg.vocab - 4, size=(2, 64)).astype(np.int32)
    lengths = None if cfg.rwkv else np.array([64, 45], np.int32)
    fn, attr = _decode_count(kv)
    res = {}
    for loop in ("scan", "python"):
        eng = Engine(cfg, params, max_len=GRAPH_MAX_LEN, loop=loop, **kw)
        before = getattr(fn, attr)
        res[loop] = eng.generate(prompts, 10, greedy=greedy, seed=5,
                                 lengths=lengths)
        n = getattr(fn, attr) - before
        r = res[loop]
        assert n == (0 if cfg.rwkv else cfg.n_layers * r.decode_steps), loop
        assert r.decode_dispatches == r.decode_steps
        if loop == "scan":
            assert eng.graphs.captures == 1
            assert eng.graphs.replays == r.decode_steps == 16
    np.testing.assert_array_equal(res["scan"].tokens, res["python"].tokens)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32", "int8"])
def test_cuda_graph_segments_equal_solo_eager_generate(cuda_device, kv):
    """Paged continuous serving (every decode step a replay of the masked
    step's graph) gives each request, greedy or sampled, the tokens of a
    solo eager ``generate(loop="python")``; with int8 K/V through blocking
    admission (chunked admission attends a chunk's own rows quantized).
    One capture; one replay and n_layers K4 (K4q) launches a step."""
    import numpy as np
    from repro_torch.inference.engine import Engine
    from repro_torch.inference.scheduler import ContinuousEngine
    cfg, params = _model("yi_6b", cuda_device)
    kw = dict(DSA_KW, max_len=GRAPH_MAX_LEN, **QUANT_KW[kv])
    reqs = _requests(cfg.vocab, greedy_mix=True)
    eng = ContinuousEngine(cfg, params, slots=2, seg_len=4, paged=True,
                           chunked_prefill=None if kv is None else False,
                           **kw)
    fn, attr = _decode_count(kv, paged=True)
    before = getattr(fn, attr)
    got = eng.run(reqs)
    steps = eng.stats["decode_steps"]
    assert getattr(fn, attr) - before == cfg.n_layers * steps > 0
    assert eng.graphs.captures == 1 and eng.graphs.replays == steps
    solo = Engine(cfg, params, loop="python", **kw)
    for r in reqs:
        want = solo.generate(r.prompt[None], r.n_new, greedy=r.greedy,
                             seed=r.seed, temperature=r.temperature).tokens[0]
        np.testing.assert_array_equal(got[r.rid], want, err_msg=str(r.rid))


@pytest.mark.cuda
def test_cuda_graph_one_capture_per_key_and_recapture_after_reset(
        cuda_device, monkeypatch):
    """Two workloads through one continuous engine capture once; once a
    graph exists no step runs eagerly (decode_step made to raise); reset
    drops the graphs and the next segment captures again, to the same
    tokens; warmup captures, so serving after it captures nothing.  The
    static engine captures once per batch size."""
    import numpy as np
    from repro_torch.inference import engine as TE
    from repro_torch.inference import scheduler as TS
    cfg, params = _model("yi_6b", cuda_device)
    kw = dict(DSA_KW, max_len=GRAPH_MAX_LEN)
    reqs = _requests(cfg.vocab)
    eng = TS.ContinuousEngine(cfg, params, slots=2, seg_len=4, paged=True,
                              **kw)
    first = eng.run(reqs[:3])
    with monkeypatch.context() as m:
        m.setattr(TS, "decode_step", None)
        eng.run(reqs[3:])
    assert eng.graphs.captures == 1
    eng.reset()
    assert not eng.graphs.graphs
    again = eng.run(reqs[:3])
    assert eng.graphs.captures == 2
    for rid, toks in first.items():
        np.testing.assert_array_equal(again[rid], toks)
    eng.warmup([len(r.prompt) for r in reqs])
    n = eng.graphs.captures
    eng.run(reqs)
    assert eng.graphs.captures == n

    static = TE.Engine(cfg, params, **kw)
    prompts = np.random.default_rng(2).integers(
        1, cfg.vocab - 4, size=(2, 48)).astype(np.int32)
    a = static.generate(prompts, 6).tokens
    with monkeypatch.context() as m:
        m.setattr(TE, "decode_step", None)
        b = static.generate(prompts, 6).tokens
    assert static.graphs.captures == 1
    np.testing.assert_array_equal(a, b)
    static.generate(prompts[:1], 6)
    assert static.graphs.captures == 2


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kw,plen", [
    ("yi_6b", dict(long_context=True, dsa_mode="faithful"), 64),
    ("yi_6b", dict(long_context=True, dsa_mode="faithful", kv_quant="fp8",
                   select_dtype="int8"), 64),
    ("h2o_danube_1_8b", dict(long_context=True, dsa_mode="kernel"), 160),
    ("h2o_danube_1_8b", {}, 90)],
    ids=["yi_6b-faithful", "yi_6b-faithful-fp8", "h2o-ring-kernel",
         "h2o-ring-off"])
@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_cuda_graph_faithful_and_ring_scan_equals_eager_loop(
        cuda_device, arch, kw, plen, greedy):
    """Faithful decode (a top-k over every cached score, no kernel) and
    h2o's ring (prompts past the 64-token window, so the ring wraps at
    prefill and again in decode): the scan loop's graph replays give the
    python loop's tokens bit for bit; one capture; no decode kernel
    launches; h2o's kernel-mode prefill launches K2 once a layer."""
    import numpy as np
    from repro_torch.inference.engine import Engine
    cfg, params = _model(arch, cuda_device)
    rng = np.random.default_rng(3)
    prompts = rng.integers(1, cfg.vocab - 4, size=(2, plen)).astype(np.int32)
    lengths = None if cfg.swa_window else np.array([plen, 45], np.int32)
    decode = [(K1.dsa_decode_gather_attention, a)
              for a in ("launches", "launches_quant")]
    res = {}
    for loop in ("scan", "python"):
        eng = Engine(cfg, params, max_len=plen + 16, loop=loop, **kw)
        before = [getattr(f, a) for f, a in decode]
        k2 = K2.dsa_block_sparse_attention.launches
        res[loop] = eng.generate(prompts, 10, greedy=greedy, seed=5,
                                 lengths=lengths)
        assert [getattr(f, a) for f, a in decode] == before
        want_k2 = cfg.n_layers if kw.get("dsa_mode") == "kernel" else 0
        assert K2.dsa_block_sparse_attention.launches - k2 == want_k2
        if loop == "scan":
            assert eng.graphs.captures == 1
            assert eng.graphs.replays == res[loop].decode_steps == 16
    np.testing.assert_array_equal(res["scan"].tokens, res["python"].tokens)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kw", [
    ("yi_6b", dict(long_context=True, dsa_mode="faithful", paged=True)),
    ("yi_6b", dict(long_context=True, dsa_mode="faithful")),
    ("h2o_danube_1_8b", dict(long_context=True, dsa_mode="kernel"))],
    ids=["yi_6b-faithful-paged", "yi_6b-faithful-dense", "h2o-ring"])
def test_cuda_graph_faithful_and_ring_segments_equal_solo_eager(
        cuda_device, arch, kw):
    """Continuous serving with every decode step a replay of the masked
    step's graph: faithful decode (chunked admission, paged or dense),
    and h2o's dense ring (blocking admission, prompts past the window);
    each request's tokens equal a solo eager ``generate(loop="python")``,
    greedy and sampled.  One capture, one replay a decode step."""
    import numpy as np
    from repro_torch.inference.engine import Engine
    from repro_torch.inference.scheduler import ContinuousEngine, Request
    cfg, params = _model(arch, cuda_device)
    max_len = 160 if cfg.swa_window else GRAPH_MAX_LEN
    rng = np.random.default_rng(9)
    shapes = ([(48, 8), (70, 6), (130, 5), (20, 9), (70, 4)]
              if cfg.swa_window else [(48, 8), (21, 12), (65, 5), (30, 10),
                                      (17, 7)])
    reqs = [Request(rid, rng.integers(1, cfg.vocab - 4, size=(n,)).astype(
        np.int32), m, greedy=rid % 2 == 0, seed=3 * rid + 1,
        temperature=0.8) for rid, (n, m) in enumerate(shapes)]
    eng = ContinuousEngine(cfg, params, slots=2, seg_len=4, max_len=max_len,
                           **kw)
    assert eng.chunked == (not cfg.swa_window)
    got = eng.run(reqs)
    steps = eng.stats["decode_steps"]
    assert eng.graphs.captures == 1 and eng.graphs.replays == steps > 0
    solo = Engine(cfg, params, loop="python", max_len=max_len,
                  **{k: v for k, v in kw.items() if k != "paged"})
    for r in reqs:
        want = solo.generate(r.prompt[None], r.n_new, greedy=r.greedy,
                             seed=r.seed, temperature=r.temperature).tokens[0]
        np.testing.assert_array_equal(got[r.rid], want, err_msg=str(r.rid))


def _kernel_calls(dev, requires_grad):
    """One call of each public kernel wrapper on small inputs on ``dev``,
    q (r for K7) requiring grad or not."""
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    b, hq, hkv, hd, s, bk = 2, 4, 2, 16, 64, 16
    q1, qc, q2 = (rnd(*shape).requires_grad_(requires_grad) for shape in (
        (b, hq, 1, hd), (b, hq, bk, hd), (b, hq, s, hd)))
    kc, vc = rnd(b, s, hkv, hd), rnd(b, s, hkv, hd)
    pool = kc.reshape(b * s, hkv, hd)
    i32 = dict(dtype=torch.int32, device=dev)
    idx = torch.tensor([[0, 1], [2, 0]], **i32)
    pidx = idx + torch.tensor([[0], [4]], **i32)
    ok = torch.ones((b, 2), dtype=torch.bool, device=dev)
    kv_len = torch.tensor([s, 40], **i32)
    q_off = torch.tensor([16, 0], **i32)
    own = torch.arange(s // bk, **i32)[None, :, None].expand(b, -1, 1)
    r = rnd(b, hq, s, hd).requires_grad_(requires_grad)
    w = torch.rand((b, hq, s, hd), generator=g, device=dev) * 0.5 + 0.4
    return {
        "K1": (K1.dsa_decode_gather_attention, lambda: K1.
               dsa_decode_gather_attention(q1, kc, vc, idx, ok, kv_len,
                                           block_k=bk)),
        "K4": (K1.dsa_decode_paged_gather_attention, lambda: K1.
               dsa_decode_paged_gather_attention(q1, pool, pool, idx, pidx,
                                                 ok, kv_len, block_k=bk)),
        "K2": (K2.dsa_block_sparse_attention, lambda: K2.
               dsa_block_sparse_attention(q2, q2.detach(), q2.detach(), own,
                                          torch.ones_like(own, dtype=torch.
                                                          bool),
                                          block_q=bk, block_k=bk)),
        "K3": (K3.dsa_chunk_gather_attention, lambda: K3.
               dsa_chunk_gather_attention(qc, kc, vc, idx[:, None],
                                          ok[:, None], q_off, kv_len,
                                          block_q=bk, block_k=bk)),
        "K5": (K3.dsa_chunk_paged_gather_attention, lambda: K3.
               dsa_chunk_paged_gather_attention(qc, pool, pool, idx[:, None],
                                                pidx[:, None], ok[:, None],
                                                q_off, kv_len, block_q=bk,
                                                block_k=bk)),
        "K7": (K7.wkv6_chunked, lambda: K7.wkv6_chunked(
            r, r.detach(), r.detach(), w, torch.zeros((hq, hd), device=dev))),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4", "K5", "K7"])
def test_cuda_kernel_wrappers_refuse_autograd(cuda_device, kernel):
    """On the card a wrapper asked for a gradient raises before it
    launches (its output would have none, and the backward would stop
    there silently); without gradients it launches."""
    fn, call = _kernel_calls(cuda_device, requires_grad=True)[kernel]
    before = fn.launches
    with pytest.raises(NotImplementedError, match="no backward"):
        call()
    assert fn.launches == before
    with torch.no_grad():
        out = call()
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    out = out[0] if isinstance(out, tuple) else out
    assert out.grad_fn is None and bool(torch.isfinite(out).all())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["block", "faithful", "off"])
def test_cuda_train_step_matches_cpu(cuda_device, mode):
    """One train step of reduced yi_6b (f32) on the card against the same
    step on the CPU from the same params: loss, ce, mse and grad_norm at
    rtol 1e-4, P unchanged, no kernel launched; then the eval step on
    the kernel path (K2 once a layer) gives the block path's ce."""
    import numpy as np
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.data.synthetic import DataConfig, lm_batches
    from repro_torch.models.attention import RunFlags
    from repro_torch.optim import adamw
    from repro_torch.training import steps as ST
    cfg = reduced(get_config("yi_6b"))
    opt = adamw.OptConfig(lr=1e-3, total_steps=10, warmup_steps=2)
    batch = next(lm_batches(DataConfig(vocab=cfg.vocab, seq_len=64,
                                       global_batch=4)))
    flags = RunFlags(mode="train", dsa_mode=mode)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        state = ST.init_train_state(0, cfg, opt, device="cpu")
        if dev.type == "cuda":
            state["params"] = _to(state["params"], dev)
            state["opt"] = adamw.init(opt, state["params"])
        before = K2.dsa_block_sparse_attention.launches
        p0 = state["params"]["groups"][0]["b0"]["attn"]["dsa"]["p"].clone()
        state, m = ST.make_train_step(cfg, opt, flags, microbatches=2)(
            state, batch)
        assert K2.dsa_block_sparse_attention.launches == before
        assert torch.equal(state["params"]["groups"][0]["b0"]["attn"][
            "dsa"]["p"], p0)
        out[dev.type] = ({k: float(v) for k, v in m.items()}, state)
    for k in ("loss", "ce", "mse", "grad_norm"):
        np.testing.assert_allclose(out["cuda"][0][k], out["cpu"][0][k],
                                   rtol=1e-4, err_msg=k)
    params = out["cuda"][1]["params"]
    before = K2.dsa_block_sparse_attention.launches
    ce = {m: float(ST.make_eval_step(cfg, RunFlags(
        mode="train", with_mse=False, dsa_mode=m))(params, batch)["ce"])
        for m in ("block", "kernel")}
    assert K2.dsa_block_sparse_attention.launches == before + cfg.n_layers
    np.testing.assert_allclose(ce["kernel"], ce["block"], rtol=1e-5)


def _to(tree, dev):
    """A copy of a parameter tree on ``dev``, keeping requires_grad."""
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.detach().to(dev).requires_grad_(tree.requires_grad)
