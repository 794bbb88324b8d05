"""The CUDA kernels K1 to K5, the quantized K1q, K3q, K4q and K5q, and the
chunked wkv6 kernel K7 on the card against their plain versions, with
K2's, K3's and K1/K4's tiling edges (GQA groups, head widths, block
sizes, kv_len inside a tile, rows with no live key, ok = 0 blocks,
strided model-layout views), K2's sliding-window edges on both bodies,
and K7's head widths, chunks and segment counts; the decode step's
CUDA graphs against eager steps, faithful decode and SWA rings
included; and prefix reuse and per-request DSA modes in the continuous
engine (a hit's tokens equal the undeclared run's, mixed-mode graphed
segments equal eager ones, a mid-run capture leaves the cache as it was);
and speculative decoding (a graphed verify and commit equal eager ones
bit for bit, a mid-run capture of them leaves the cache as it was, the
commit's ktb replay equals sequential K1-path decode's); and the request
lifecycle on graphed segments (a NaN row fails only its slot, a segment
that raises is scrubbed and its graph captured again, the sparsity
probe's K4 step leaves every cache leaf as it found it, and each capture
is a compile event); and mixtral_8x22b's mixture of experts (K2's window
at its geometry, hd 128 and GQA group 6; its ring's graphed decode equal
to eager; the capacity dispatch on the card against the CPU's; the f32
router of a bf16 model through a train step); and deepseek_v3's
multi-head latent attention (an MLA layer on the card against the CPU,
its graphed decode, verify and commit against eager ones); and Mamba
and jamba_1_5_large (the Mamba block on the card against the CPU,
jamba's graphed decode against eager and its graphed continuous segments
against solo generate, the recurrent slot insert and a capture over live
recurrent slots leaving them as they were).

Needs a CUDA card and the CUDA toolkit; skips without a card.  Imports
neither JAX nor the reference, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \
        tests/test_torch_cuda.py

Distributed serving: K1 and K2 at a tp-2 shard of yi_6b, tp 2 as two
gloo processes on the one card (tokens equal the unsharded engines'),
and NCCL at world size 1 (the graphed step with its collectives equal
to the eager step bit for bit, the collective budget).

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


def _k2_window_inputs(dev, dtype, g, hd, blk, l, seed, hkv=2):
    """q, k and v in ``dtype`` as (B,H,L,hd) views of model-layout
    tensors, ``hkv`` KV heads, 4 random distinct key blocks per query block
    (some behind the window, some above the diagonal), the diagonal
    block among them, about a fifth valid = 0 off the diagonal."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, nb = 2, 4
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
    ("h2o_danube_1_8b", {}, 90),
    ("mixtral_8x22b", dict(long_context=True, dsa_mode="kernel"), 160),
    ("mixtral_8x22b", {}, 90)],
    ids=["yi_6b-faithful", "yi_6b-faithful-fp8", "h2o-ring-kernel",
         "h2o-ring-off", "mixtral-ring-kernel", "mixtral-ring-off"])
@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_cuda_graph_faithful_and_ring_scan_equals_eager_loop(
        cuda_device, arch, kw, plen, greedy):
    """Faithful decode (a top-k over every cached score, no kernel) and
    h2o's ring (prompts past the 64-token window, so the ring wraps at
    prefill and again in decode), and mixtral's (the same ring, each step
    routing every token through every expert, top-k and the routing
    weights' scatter on the card): the scan loop's graph replays give the
    python loop's tokens bit for bit; one capture; no decode kernel
    launches; a kernel-mode prefill launches K2 once a layer."""
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
    ("h2o_danube_1_8b", dict(long_context=True, dsa_mode="kernel")),
    ("mixtral_8x22b", dict(long_context=True, dsa_mode="kernel"))],
    ids=["yi_6b-faithful-paged", "yi_6b-faithful-dense", "h2o-ring",
         "mixtral-ring"])
def test_cuda_graph_faithful_and_ring_segments_equal_solo_eager(
        cuda_device, arch, kw):
    """Continuous serving with every decode step a replay of the masked
    step's graph: faithful decode (chunked admission, paged or dense),
    and h2o's and mixtral's dense rings (blocking admission, prompts past
    the window; mixtral's prefill by capacity, its steps decode-dense);
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


# -- prefix reuse and per-request modes in the continuous engine --------------


def _prefix_requests(vocab, declare):
    """Six requests sharing a 40-token prefix (two whole 16-row pages),
    greedy and sampled."""
    import numpy as np
    from repro_torch.inference.scheduler import Request
    rng = np.random.default_rng(141)
    sys_p = rng.integers(1, vocab - 4, size=(40,)).astype(np.int32)
    return [Request(rid, np.concatenate([sys_p, rng.integers(
        1, vocab - 4, size=(tail,)).astype(np.int32)]), n,
        greedy=rid % 3 != 2, seed=7 * rid + 1, temperature=0.8,
        prefix_len=40 if declare else 0)
        for rid, (tail, n) in enumerate([(8, 6), (15, 5), (3, 7), (20, 4),
                                         (11, 5), (6, 6)])]


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32", "int8"])
def test_cuda_prefix_hit_equals_undeclared(cuda_device, kv):
    """On the card, requests declaring a shared prefix (registry hits seed
    the staging cache and skip chunks) get the tokens of the same
    requests undeclared, bit for bit, greedy and sampled; K3 (K3q) runs
    once a layer a chunk step and K4 (K4q) once a layer a decode step."""
    import numpy as np
    from repro_torch.inference.scheduler import ContinuousEngine
    cfg, params = _model("yi_6b", cuda_device)
    kw = dict(DSA_KW, max_len=GRAPH_MAX_LEN, slots=2, seg_len=4,
              chunk_tokens=16, paged=True, **QUANT_KW[kv])
    attr = "launches_quant" if kv else "launches"
    got, stats = {}, {}
    for declare in (True, False):
        eng = ContinuousEngine(cfg, params, **kw)
        k3 = getattr(K3.dsa_chunk_gather_attention, attr)
        k4 = getattr(K1.dsa_decode_paged_gather_attention, attr)
        got[declare] = eng.run(_prefix_requests(cfg.vocab, declare))
        st = stats[declare] = dict(eng.stats)
        assert (getattr(K3.dsa_chunk_gather_attention, attr) - k3
                == cfg.n_layers * st["chunks"])
        assert (getattr(K1.dsa_decode_paged_gather_attention, attr) - k4
                == cfg.n_layers * st["decode_steps"])
    for rid, toks in got[False].items():
        np.testing.assert_array_equal(got[True][rid], toks, err_msg=str(rid))
    assert stats[True]["prefix_hits"] > 0 == stats[False]["prefix_hits"]
    assert stats[True]["chunks"] < stats[False]["chunks"]


def _mixed_mode_requests(vocab):
    """Prompts of ~200 tokens (13 blocks, past the 64-token local window,
    so the decode modes differ), one mode each."""
    import numpy as np
    from repro_torch.inference.scheduler import Request
    rng = np.random.default_rng(11)
    modes = [None, "off", "faithful", "block", "off", None]
    return [Request(rid, rng.integers(1, vocab - 4, size=(
        190 + 5 * rid,)).astype(np.int32), 12, greedy=rid % 2 == 0,
        seed=rid, temperature=0.8, dsa_mode=m)
        for rid, m in enumerate(modes)]


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_cuda_mixed_mode_graphed_segments_equal_eager(cuda_device, paged):
    """A kernel-mode continuous engine serving requests of four modes:
    the segments' graph replays give the tokens of the same engine with
    every step eager, bit for bit; one capture per mode served, one
    replay a decode step."""
    import numpy as np
    from repro_torch.inference.scheduler import ContinuousEngine
    cfg, params = _model("yi_6b", cuda_device)
    kw = dict(DSA_KW, max_len=256, slots=2, seg_len=4, chunk_tokens=64,
              paged=paged)
    reqs = _mixed_mode_requests(cfg.vocab)
    graphed = ContinuousEngine(cfg, params, **kw)
    got = graphed.run(reqs)
    g = graphed.graphs
    assert g.captures == len({r.dsa_mode or "kernel" for r in reqs}) == 4
    assert g.replays == graphed.stats["decode_steps"]
    assert all(x.pool_bytes >= 0 for x in g.graphs.values())
    eager = ContinuousEngine(cfg, params, **kw)
    eager.graphs = None
    want = eager.run(reqs)
    for rid, toks in want.items():
        np.testing.assert_array_equal(got[rid], toks, err_msg=str(rid))


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32", "int8"])
def test_cuda_second_mode_capture_leaves_cache_unchanged(cuda_device, kv):
    """Mid-run, with slots live, capturing another mode's segment graph
    (two all-false warm-up steps, then the capture) leaves every leaf of
    the paged resident cache bit for bit as it was."""
    from repro_torch.inference.scheduler import ContinuousEngine
    cfg, params = _model("yi_6b", cuda_device)
    eng = ContinuousEngine(cfg, params, max_len=256, slots=2, seg_len=4,
                           chunk_tokens=64, paged=True,
                           **dict(DSA_KW, **QUANT_KW[kv]))
    for r in _mixed_mode_requests(cfg.vocab)[:2]:
        r.dsa_mode = None
        eng.submit(r)
    sink, clock = [], lambda: 0.0
    while not any(s is not None for s in eng._slot):
        eng.admit_ready(clock, sink)
        eng.step_prefill(clock, sink)
    eng.run_segment(clock, sink)
    leaves = [t for grp in eng._caches["groups"] for sub in grp.values()
              for t in sub["attn"].values()]
    before = [t.clone() for t in leaves]
    for mode in ("off", "faithful", "block"):
        eng._segment_step(mode)
        torch.cuda.synchronize()
        for a, b in zip(before, leaves):
            assert torch.equal(a, b), mode
    assert eng.graphs.captures == 4


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
        state, _ = ST.init_train_state(0, cfg, opt, device="cpu")
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


# -- speculative decoding ------------------------------------------------------

# reduced yi_6b past the 64-token local window: decode keeps 7 of 20
# blocks, so the modes differ
SPEC_MAX_LEN = 320
SPEC_PLEN = 224


def _spec_engine(dev, mode, kv=None, **kw):
    from repro_torch.inference.engine import Engine
    cfg, params = _model("yi_6b", dev)
    return Engine(cfg, params, max_len=SPEC_MAX_LEN, long_context=True,
                  dsa_mode=mode, **QUANT_KW[kv], **kw)


def _spec_prompts(vocab, b=2, seed=0):
    import numpy as np
    return np.random.default_rng(seed).integers(
        1, vocab - 4, size=(b, SPEC_PLEN)).astype(np.int32)


def _attn_leaves(caches):
    return [sub["attn"] for grp in caches["groups"] for sub in grp.values()]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,kv", [("kernel", None), ("kernel", "fp8"),
                                     ("kernel", "int8"), ("block", None),
                                     ("faithful", None), ("off", None)])
def test_cuda_graphed_verify_equals_eager(cuda_device, mode, kv):
    """One round from the same prefilled state, the verify forward and
    its commit as graph replays against the same calls eager: the logits,
    then every cache leaf after the commit, bit for bit; K1 (K1q) counted
    n_layers x C by the verify replay on the kernel path.  Then
    ``generate(spec=4)`` gives the graphed plain tokens, with K1 (K1q)
    n_layers x C a round."""
    import dataclasses
    from repro_torch.core.quantization import raw
    from repro_torch.models import transformer as TT
    eng = _spec_engine(cuda_device, mode, kv)
    cfg, c = eng.cfg, 5
    p = _spec_prompts(cfg.vocab)
    flags = dataclasses.replace(eng.decode_flags, spec_verify=True)
    verify, commit = eng.spec_steps(2, c - 1, flags)
    _, graphed, _ = eng.prefill(p, caches=eng.resident_cache(2))
    _, eager, _ = eng.prefill(p)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    chunk = torch.randint(1, cfg.vocab - 4, (2, c), generator=gen,
                          device=cuda_device)
    mask = torch.tensor([True, True], device=cuda_device)
    keep = torch.tensor([[c], [2]], device=cuda_device)
    fn, attr = _decode_count(kv)
    before = getattr(fn, attr)
    got = verify(chunk, mask).clone()
    assert getattr(fn, attr) - before == (
        cfg.n_layers * c if mode == "kernel" else 0)
    scratch = TT.spec_scratch(eager, c)
    with torch.inference_mode():
        want = TT.verify_step(eng.params, cfg, flags, chunk, eager,
                              active=mask, scratch=scratch)[0]
        commit(keep, mask)
        TT.commit_chunk(cfg, flags, eager, keep[:, 0], c, active=mask,
                        scratch=scratch)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for a, b in zip(_attn_leaves(graphed), _attn_leaves(eager)):
        assert set(a) == set(b)
        for name in a:
            assert torch.equal(raw(a[name]), raw(b[name])), name
    import numpy as np
    plain = eng.generate(p, 12).tokens
    before = getattr(fn, attr)
    res = eng.generate(p, 12, spec=c - 1)
    np.testing.assert_array_equal(res.tokens, plain)
    assert getattr(fn, attr) - before == (
        cfg.n_layers * c * res.spec_rounds if mode == "kernel" else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32", "int8"])
def test_cuda_verify_capture_mid_run_leaves_cache_unchanged(cuda_device, kv):
    """Mid-run, with slots live, capturing the verify and commit graphs
    (all-false warm-up calls, then the captures) leaves every leaf of the
    dense resident cache bit for bit as it was; the speculative segments
    then give each request its solo tokens."""
    import numpy as np
    from repro_torch.inference.scheduler import ContinuousEngine
    from repro_torch.core.quantization import raw
    cfg, params = _model("yi_6b", cuda_device)
    kw = dict(max_len=SPEC_MAX_LEN, long_context=True, dsa_mode="kernel",
              **QUANT_KW[kv])
    # int8 admits blocking: chunked admission attends a chunk's own rows
    # quantized, whole-prompt prefill in full precision
    eng = ContinuousEngine(cfg, params, spec=4, slots=2, seg_len=4,
                           chunk_tokens=64, chunked_prefill=kv is None, **kw)
    reqs = _requests(cfg.vocab, greedy_mix=True)
    for r in reqs:
        eng.submit(r)
    sink, clock = [], lambda: 0.0
    while not any(s is not None for s in eng._slot):
        eng.admit_ready(clock, sink)
        eng.step_prefill(clock, sink)
    eng.run_segment(clock, sink)
    leaves = [dict(lc) for lc in _attn_leaves(eng._caches)]
    before = [{k: raw(t).clone() for k, t in lc.items()} for lc in leaves]
    captures = eng.graphs.captures
    eng._spec_steps()
    torch.cuda.synchronize()
    assert eng.graphs.captures == captures + 2
    for lc, old in zip(leaves, before):
        for k, t in old.items():
            assert torch.equal(raw(lc[k]), t), k
    while eng.has_work():
        eng.admit_ready(clock, sink)
        eng.step_prefill(clock, sink)
        if any(s is not None for s in eng._slot):
            eng._step_decode(clock, sink)
    got = {r.rid: r.tokens for r in sink}
    assert eng.stats["spec_rounds"] > 0
    from repro_torch.inference.engine import Engine
    solo = Engine(cfg, params, loop="python", **kw)
    for r in reqs:
        np.testing.assert_array_equal(got[r.rid], solo.generate(
            r.prompt[None], r.n_new, greedy=r.greedy, seed=r.seed,
            temperature=r.temperature).tokens[0])


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32", "int8"])
def test_cuda_commit_replays_the_decode_ktb(cuda_device, kv):
    """Sequential decode on the K1 path (eager steps, row 1 frozen after
    two) and a verify + commit of the same tokens fed the chain's K~ rows
    (the chain's stored kt rows; under int8 selection the float rows it
    added): ``pos`` equal and ktb (ktb_s) bit for bit the chain's."""
    import dataclasses
    from repro_torch.core import prediction as PRED
    from repro_torch.models import transformer as TT
    eng = _spec_engine(cuda_device, "kernel", kv)
    cfg, c = eng.cfg, 5
    p = _spec_prompts(cfg.vocab, seed=1)
    _, seq, _ = eng.prefill(p)
    _, ver, _ = eng.prefill(p)
    chunk = torch.arange(1, 2 * c + 1, device=cuda_device).reshape(2, c)
    keep = torch.tensor([c, 2], device=cuda_device)
    flags = dataclasses.replace(eng.decode_flags, spec_verify=True)
    rows, orig = [], PRED.predict_qk

    def record(*a, **k):
        out = orig(*a, **k)
        rows.append(out[1][:, 0].float().clone())
        return out

    with torch.inference_mode():
        PRED.predict_qk = record
        try:
            for i in range(c):
                TT.decode_step(eng.params, cfg, eng.decode_flags,
                               chunk[:, i:i + 1], seq, active=keep > i)
        finally:
            PRED.predict_qk = orig
        scratch = TT.spec_scratch(ver, c)
        TT.verify_step(eng.params, cfg, flags, chunk, ver, scratch=scratch)
        layers = _attn_leaves(ver)
        pend = scratch                     # one entry a layer
        for li, lc in enumerate(layers):
            chain = torch.stack([rows[i * len(layers) + li]
                                 for i in range(c)], 1)
            if "ktb_s" in lc:
                pend[li].copy_(chain)
            else:
                lc["kt"][:, SPEC_PLEN:SPEC_PLEN + c] = chain.to(
                    lc["kt"].dtype)
        TT.commit_chunk(cfg, flags, ver, keep, c, scratch=scratch)
    torch.cuda.synchronize()
    for a, b in zip(_attn_leaves(seq), layers):
        assert torch.equal(a["pos"], b["pos"])
        for name in ("ktb", "ktb_s"):
            if name in a:
                assert torch.equal(a[name], b[name]), name


# -- request lifecycle, faults and telemetry on graphed segments -------------


def _lifecycle_engine(dev, **kw):
    from repro_torch.inference.scheduler import ContinuousEngine
    cfg, params = _model("yi_6b", dev)
    return cfg, ContinuousEngine(cfg, params, slots=2, seg_len=4,
                                 paged=True, max_len=GRAPH_MAX_LEN,
                                 **DSA_KW, **kw)


@pytest.mark.cuda
def test_cuda_nan_row_fails_only_its_slot_on_graphs(cuda_device):
    """The poison lands on a graph replay's logits outside the graph:
    the target slot fails with a prefix of its clean tokens and the
    co-resident slot's tokens are bitwise the clean run's."""
    from repro_torch.inference.faults import Fault, FaultInjector
    cfg, eng = _lifecycle_engine(cuda_device)
    reqs = _requests(cfg.vocab)[:3]
    base = eng.run(reqs)
    eng.reset()
    inj = FaultInjector(Fault("nan_logits", rid=1, after=1))
    eng.injector = inj
    got = eng.run(_requests(cfg.vocab)[:3])
    eng.injector = None
    assert inj.fired == [("nan_logits", 1)] and eng.stats["failed"] == 1
    assert 0 < len(got[1]) < len(base[1])
    assert (got[1] == base[1][:len(got[1])]).all()
    for rid in (0, 2):
        assert (got[rid] == base[rid]).all(), rid


@pytest.mark.cuda
def test_cuda_scrub_drops_and_recaptures_the_segment_graph(cuda_device):
    """A segment that raises fails the in-flight requests, drops the
    graph captured on the old cache (its replays would write freed
    memory), rebuilds the cache and pool, and the next segment captures
    anew: the next request gets its clean tokens and the pool is full."""
    from repro_torch.inference.telemetry import Telemetry
    tel = Telemetry(sample_every=0)
    cfg, eng = _lifecycle_engine(cuda_device, telemetry=tel)
    reqs = _requests(cfg.vocab)[:3]
    clean = eng.run(reqs)
    assert eng.graphs.captures == 1 and tel.compile_count("segment") == 1
    eng.reset()
    orig, state = eng._segment_step, {"raised": False}

    def boom(mode=None):
        step = orig(mode)
        if not state["raised"]:
            state["raised"] = True
            raise RuntimeError("injected segment failure")
        return step

    eng._segment_step = boom
    old = eng._caches
    sink, clock = [], lambda: 0.0
    try:
        # rid 0 and 1 fall in two prompt buckets: rid 0 is resident when
        # the segment raises, rid 1 still queued
        for r in _requests(cfg.vocab)[:2]:
            eng.submit(r)
        while eng.has_work():
            eng.admit_ready(clock, sink)
            eng.step_prefill(clock, sink)
            if any(x is not None for x in eng._slot):
                eng._step_decode(clock, sink)
    finally:
        del eng._segment_step
    by = {r.rid: r for r in sink}
    assert eng._caches is not old
    assert by[0].status == "failed" and len(by[0].tokens) == 1
    assert by[0].tokens[0] == clean[0][0]
    assert by[1].status == "ok" and (by[1].tokens == clean[1]).all()
    # captured before the reset, then before the raise, then after it
    assert eng.graphs.captures == 3
    assert eng.pool.available() == eng.pool_pages - 1
    assert tel.compile_count("segment") == 3


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32", "int8"])
def test_cuda_probe_restores_the_resident_cache(cuda_device, kv):
    """The sparsity probe's eager step (K4 or K4q once a layer, counted
    apart) writes the paged resident cache in place; every leaf is
    bitwise what it was after it, and the tokens are those of an engine
    that never probed."""
    from repro_torch.inference.telemetry import Telemetry
    tel = Telemetry(sample_every=1)
    cfg, eng = _lifecycle_engine(cuda_device, telemetry=tel,
                                 **QUANT_KW[kv])
    _, plain = _lifecycle_engine(cuda_device, **QUANT_KW[kv])
    want = plain.run(_requests(cfg.vocab))
    for r in _requests(cfg.vocab)[:2]:
        eng.submit(r)
    sink, clock = [], lambda: 0.0
    while not all(x is not None for x in eng._slot):
        eng.admit_ready(clock, sink)
        eng.step_prefill(clock, sink)
    def leaves():
        return [t for d in _attn_leaves(eng._caches)
                for _, t in sorted(d.items())]

    before = [t.clone() for t in leaves()]
    fn, attr = _decode_count(kv, paged=True)
    n0 = getattr(fn, attr)
    eng._sparsity_probe("kernel")
    torch.cuda.synchronize()
    assert getattr(fn, attr) - n0 == cfg.n_layers
    assert eng.stats["probe_steps"] == 1
    for a, b in zip(before, leaves()):
        assert torch.equal(a, b)
    eng.reset()
    got = eng.run(_requests(cfg.vocab))
    for rid, toks in want.items():
        assert (got[rid] == toks).all(), rid
    assert eng.stats["probe_steps"] > 0


# -- checkpoints, RWKV6 training, the dots remat policy ------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_checkpoint_round_trip(cuda_device, dtype, tmp_path):
    """A training state on the card saved and restored onto the card (and
    onto the CPU) bit for bit, P still frozen, the steps ints."""
    import dataclasses
    from repro_torch.checkpoint import checkpoint as C
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.optim import adamw
    from repro_torch.training import steps as ST
    from repro_torch.tree import named_leaves
    cfg = dataclasses.replace(reduced(get_config("yi_6b")),
                              param_dtype=str(dtype).split(".")[1])
    opt = adamw.OptConfig(moment_dtype=str(dtype).split(".")[1])
    state, _ = ST.init_train_state(0, cfg, opt, device=cuda_device)
    state["step"] = state["opt"]["step"] = 3
    C.AsyncCheckpointer(str(tmp_path)).save(state, 3, block=True)
    for dev in (cuda_device, torch.device("cpu")):
        got, step = C.restore(str(tmp_path / "ckpt_3"), state, device=dev)
        assert step == 3 and got["step"] == got["opt"]["step"] == 3
        want = dict(named_leaves(state))
        for path, t in named_leaves(got):
            if isinstance(t, torch.Tensor):
                assert t.device.type == dev.type and t.dtype == dtype, path
                assert torch.equal(t.cpu(), want[path].detach().cpu()), path
                assert t.requires_grad == want[path].requires_grad, path


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["zero_state", "random_state", "clamp"])
def test_cuda_wkv_chunked_train_matches_cpu(cuda_device, case):
    """The differentiable chunked wkv (``ssm._wkv_chunked_train``) on the
    card against the CPU, f32: y and s_last within 1e-5 and the
    gradients within 1e-4 of each one's largest magnitude; ``clamp``
    holds the decay at 0.3 (a chunk's log-decay passes -30).  Not
    elementwise: y sums terms of |y|'s largest size, so f32 holds it to
    ~1e-6 of that size (against f64) and not elements near zero."""
    from repro_torch.models import ssm
    gen = torch.Generator().manual_seed(1)
    b, s, h, hd = 2, 128, 4, 64
    r, k, v = (torch.randn((b, s, h, hd), generator=gen) for _ in range(3))
    w = (torch.full((b, s, h, hd), 0.3) if case == "clamp" else torch.exp(
        -torch.exp(torch.randn((b, s, h, hd), generator=gen) * 0.5 - 2)))
    u = torch.randn((h, hd), generator=gen) * 0.1
    s0 = (torch.randn((b, h, hd, hd), generator=gen) * 0.5
          if case == "random_state" else None)
    gy, gs = torch.randn((b, s, h, hd), generator=gen), torch.randn(
        (b, h, hd, hd), generator=gen)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        ins = [t.to(dev).requires_grad_() for t in (r, k * 0.3, v, w, u)]
        st0 = None if s0 is None else s0.to(dev).requires_grad_()
        y, st = ssm._wkv_chunked_train(*ins, st0)
        ((y * gy.to(dev)).sum() + (st * gs.to(dev)).sum()).backward()
        grads = [t.grad for t in ins + ([st0] if st0 is not None else [])]
        out[dev.type] = [y.detach(), st.detach()] + grads
    for i, (got, want) in enumerate(zip(out["cuda"], out["cpu"])):
        scale = float(want.abs().max())
        err = float((got.cpu() - want).abs().max())
        assert err <= (1e-5 if i < 2 else 1e-4) * scale, (i, err, scale)


@pytest.mark.cuda
def test_cuda_rwkv_eval_k7_matches_train_form(cuda_device):
    """Reduced rwkv6_3b (f32) on the card: the eval step launches K7 once
    a layer and gives the ce of the train form (the differentiable
    chunked wkv, no launch) within rtol 1e-5."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.data.synthetic import DataConfig, lm_batches
    from repro_torch.optim import adamw
    from repro_torch.training import steps as ST
    cfg = reduced(get_config("rwkv6_3b"))
    state, _ = ST.init_train_state(0, cfg, adamw.OptConfig(),
                                device=cuda_device)
    batch = next(lm_batches(DataConfig(vocab=cfg.vocab, seq_len=128,
                                       global_batch=2)))
    before = K7.wkv6_chunked.launches
    ev = float(ST.make_eval_step(cfg)(state["params"], batch)["ce"])
    assert K7.wkv6_chunked.launches == before + cfg.n_layers
    on = {k: torch.as_tensor(v, device=cuda_device) for k, v in batch.items()}
    _, m = ST.loss_fn(state["params"], cfg, ST.default_flags(cfg), on)
    assert K7.wkv6_chunked.launches == before + cfg.n_layers
    tr = float(m["ce"].detach())
    assert abs(ev - tr) <= 1e-5 * abs(tr), (ev, tr)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["yi_6b", "rwkv6_3b"])
def test_cuda_dots_matches_full(cuda_device, arch):
    """Gradients of reduced ``arch`` (2 layers, f32) on the card under
    ``remat_policy="dots"`` against "full", within 1e-4 of each leaf's
    largest magnitude (the backward's ``index_add`` sums in no fixed
    order), no kernel launched."""
    import dataclasses
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.data.synthetic import DataConfig, lm_batches
    from repro_torch.optim import adamw
    from repro_torch.training import steps as ST
    cfg = reduced(get_config(arch))
    params = ST.init_train_state(0, cfg, adamw.OptConfig(),
                                 device=cuda_device)[0]["params"]
    batch = next(lm_batches(DataConfig(vocab=cfg.vocab, seq_len=128,
                                       global_batch=2)))
    before = (K2.dsa_block_sparse_attention.launches,
              K7.wkv6_chunked.launches)
    grads = {}
    for pol in ("full", "dots"):
        c = dataclasses.replace(cfg, remat=True, remat_policy=pol)
        grads[pol], _ = ST.accumulate_grads(params, c, ST.default_flags(c),
                                            batch)
    assert (K2.dsa_block_sparse_attention.launches,
            K7.wkv6_chunked.launches) == before
    from repro_torch.tree import named_leaves
    full = dict(named_leaves(grads["full"]))
    for path, g in named_leaves(grads["dots"]):
        scale = max(float(full[path].abs().max()), 1e-12)
        assert float((g - full[path]).abs().max()) <= 1e-4 * scale, path


# -- mixture of experts (mixtral_8x22b) --------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("l", [4352, 8192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_k2_window_mixtral_geometry(cuda_device, dtype, l):
    """K2's window instance at mixtral_8x22b's prefill geometry: hd 128,
    GQA group 6 (48 query heads over 8 KV heads; two KV heads here),
    window 4096, block 128, L 4352 (past the window by 2 blocks) and
    8192; at the dtype's tolerance."""
    args = _k2_window_inputs(cuda_device, dtype, 6, 128, 128, l,
                             seed=90 + l)
    kw = dict(block_q=128, block_k=128, causal=True, window=4096)
    got = K2.dsa_block_sparse_attention(*args, **kw)
    want = K2.dsa_block_sparse_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [64, 12, 2])
def test_cuda_moe_capacity_dispatch_matches_cpu(cuda_device, cap):
    """Reduced mixtral's capacity dispatch (f32) on the card and on the
    CPU from the same weights and tokens: the same dispatch positions
    (so the same dropped pairs), the output and aux within 1e-5 of the
    largest magnitude (other summation orders)."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models import moe
    cfg = reduced(get_config("mixtral_8x22b"))
    params = moe.init_moe(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    x = torch.randn((40, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    dev = {k: v.to(cuda_device) for k, v in params.items()}
    ids = moe._route(params["router"], x, cfg.moe.top_k)[0]
    dev_ids = moe._route(dev["router"], x.to(cuda_device), cfg.moe.top_k)[0]
    assert torch.equal(dev_ids.cpu(), ids)
    e_flat = ids.reshape(-1).long()
    pos = moe._dispatch_positions(e_flat, cfg.moe.num_experts, cap)
    dev_pos = moe._dispatch_positions(e_flat.to(cuda_device),
                                      cfg.moe.num_experts, cap)
    assert torch.equal(dev_pos.cpu(), pos)
    y, a = moe._moe_local(params, cfg, x, cap)
    dy, da = moe._moe_local(dev, cfg, x.to(cuda_device), cap)
    scale = float(y.abs().max())
    assert float((dy.cpu() - y).abs().max()) <= 1e-5 * scale
    assert abs(float(da) - float(a)) <= 1e-5 * abs(float(a))


@pytest.mark.cuda
def test_cuda_bf16_moe_router_stays_f32_through_a_train_step(cuda_device):
    """A bf16 reduced mixtral on the card: ``init_model`` makes the router
    f32 and the experts bf16; a train step (capacity route, block path,
    no kernel launched) moves the router and keeps its dtype; the metrics
    are finite and the router term positive."""
    import dataclasses
    import math
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.data.synthetic import DataConfig, lm_batches
    from repro_torch.optim import adamw
    from repro_torch.training import steps as ST
    cfg = dataclasses.replace(reduced(get_config("mixtral_8x22b")),
                              dtype="bfloat16", param_dtype="bfloat16")
    opt = adamw.OptConfig(moment_dtype="bfloat16", warmup_steps=1)
    state, _ = ST.init_train_state(0, cfg, opt, device=cuda_device)
    mlp = state["params"]["groups"][0]["b0"]["mlp"]
    assert mlp["router"].dtype == torch.float32
    assert mlp["w1"].dtype == mlp["w2"].dtype == torch.bfloat16
    r0 = mlp["router"].detach().clone()
    batch = next(lm_batches(DataConfig(vocab=cfg.vocab, seq_len=128,
                                       global_batch=2)))
    before = K2.dsa_block_sparse_attention.launches
    state, m = ST.make_train_step(cfg, opt)(state, batch)
    assert K2.dsa_block_sparse_attention.launches == before
    mlp = state["params"]["groups"][0]["b0"]["mlp"]
    assert mlp["router"].dtype == torch.float32
    assert not torch.equal(mlp["router"], r0)
    assert all(math.isfinite(float(v)) for v in m.values())
    assert float(m["router_aux"]) > 0


# -- multi-head latent attention (deepseek_v3) ---------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["off", "block"])
def test_cuda_mla_layer_matches_cpu(cuda_device, mode):
    """Reduced deepseek_v3's MLA layer (f32) on the card and on the CPU
    from the same weights and inputs: a 48-token prefill (the block path
    under block), three absorbed decode steps with an inactive row, a
    ragged chunk and a 4-row verify; every output and the latent cache
    within 1e-4 of the largest magnitude (other summation orders), pos
    exact.  No kernel launches."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models import attention as TAT
    cfg = reduced(get_config("deepseek_v3"))
    params = TAT.init_mla(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    dev = {k: _to(v, cuda_device) for k, v in params.items()}
    gen = torch.Generator().manual_seed(1)
    caches = {d: TAT.init_cache_mla(cfg, 2, 96, device=d,
                                    dtype=torch.float32)
              for d in ("cpu", cuda_device)}
    before = K2.dsa_block_sparse_attention.launches

    def both(flags, x, **kw):
        outs = []
        for d, p in (("cpu", params), (cuda_device, dev)):
            step = {k: (v.to(d) if isinstance(v, torch.Tensor) else
                        TAT.Active(v.mask.to(d)) if v is not None else None)
                    for k, v in kw.items()}
            with torch.no_grad():
                outs.append(TAT.apply_mla(p, cfg, flags, x.to(d),
                                          cache=caches[d], **step)[0])
        scale = max(float(outs[0].abs().max()), 1e-6)
        assert float((outs[1].cpu() - outs[0]).abs().max()) <= 1e-4 * scale
        for name, t in caches["cpu"].items():
            got = caches[cuda_device][name].cpu()
            if name == "pos":
                assert torch.equal(got, t)
            else:
                s = max(float(t.abs().max()), 1e-6)
                assert float((got - t).abs().max()) <= 1e-4 * s, name

    def x(s):
        return torch.randn((2, s, cfg.d_model), generator=gen)

    both(TAT.RunFlags(mode="prefill", dsa_mode=mode), x(48))
    dflags = TAT.RunFlags(mode="decode", dsa_mode=mode)
    for step in range(3):
        both(dflags, x(1), active=TAT.Active(torch.tensor([True,
                                                            step != 1])))
    both(dflags, x(16), chunk_len=torch.tensor([16, 9], dtype=torch.int32))
    both(TAT.RunFlags(mode="decode", dsa_mode=mode, spec_verify=True), x(4),
         chunk_len=torch.tensor([4, 4], dtype=torch.int32))
    assert K2.dsa_block_sparse_attention.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_mla_graphed_decode_and_verify_equal_eager(cuda_device,
                                                        cache_dtype):
    """Reduced deepseek_v3 (MLA, prologue, MoE) on the card: the static
    engine's graphed scan loop gives the python loop's tokens, one
    capture; a verify and its commit as graph replays equal the same
    calls eager bit for bit (logits and every latent leaf of every
    layer, the prologue's included); ``generate(spec=3)`` gives the
    plain tokens.  No kernel launches."""
    import dataclasses
    import numpy as np
    from repro_torch.inference.engine import Engine
    from repro_torch.models import transformer as TT
    cfg, params = _model("deepseek_v3", cuda_device)
    p = np.random.default_rng(2).integers(
        1, cfg.vocab - 4, size=(2, 40)).astype(np.int32)
    before = K2.dsa_block_sparse_attention.launches
    toks = {}
    for loop in ("scan", "python"):
        eng = Engine(cfg, params, max_len=96, loop=loop,
                     cache_dtype=cache_dtype)
        toks[loop] = eng.generate(p, 10).tokens
        if loop == "scan":
            assert eng.graphs.captures == 1
    np.testing.assert_array_equal(toks["scan"], toks["python"])
    c = 4
    flags = dataclasses.replace(eng.decode_flags, spec_verify=True)
    eng = Engine(cfg, params, max_len=96, cache_dtype=cache_dtype)
    verify, commit = eng.spec_steps(2, c - 1, flags)
    _, graphed, _ = eng.prefill(p, caches=eng.resident_cache(2))
    _, eager, _ = eng.prefill(p)
    chunk = torch.randint(1, cfg.vocab - 4, (2, c), device=cuda_device,
                          generator=torch.Generator(
                              device=cuda_device).manual_seed(3))
    mask = torch.tensor([True, True], device=cuda_device)
    keep = torch.tensor([[c], [2]], device=cuda_device)
    got = verify(chunk, mask).clone()
    commit(keep, mask)
    with torch.inference_mode():
        want = TT.verify_step(eng.params, cfg, flags, chunk, eager,
                              active=mask)[0]
        TT.commit_chunk(cfg, flags, eager, keep[:, 0], c, active=mask)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    pairs = list(zip(TT.attn_caches(graphed), TT.attn_caches(eager)))
    assert len(pairs) == cfg.n_layers
    for a, b in pairs:
        assert set(a) == set(b) == {"c_kv", "k_rope", "pos"}
        for name in a:
            assert torch.equal(a[name], b[name]), name
    plain = eng.generate(p, 12).tokens
    np.testing.assert_array_equal(eng.generate(p, 12, spec=c - 1).tokens,
                                  plain)
    assert K2.dsa_block_sparse_attention.launches == before


# -- Mamba and jamba_1_5_large; recurrent slots in the continuous engine ------


@pytest.mark.cuda
def test_cuda_mamba_subblock_matches_cpu(cuda_device):
    """Reduced jamba_1_5_large's Mamba block (f32) on the card and on the
    CPU from the same weights and inputs: a 256-token prefill (two
    128-token chunks of the scan), then four decode steps, the third with
    an inactive row; every output and both cache leaves within 1e-5 of
    the largest magnitude (other summation orders)."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models import ssm
    from repro_torch.models.attention import Active
    cfg = reduced(get_config("jamba_1_5_large"))
    params = ssm.init_mamba(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    dev = {k: v.to(cuda_device) for k, v in params.items()}
    caches = {d: ssm.init_cache_mamba(cfg, 2, device=d, dtype=torch.float32)
              for d in ("cpu", cuda_device)}
    gen = torch.Generator().manual_seed(1)

    def both(x, **kw):
        outs = [ssm.apply_mamba(p, cfg, x.to(d), cache=caches[d],
                                **{k: (Active(v.mask.to(d))
                                       if isinstance(v, Active) else v)
                                   for k, v in kw.items()})
                for d, p in (("cpu", params), (cuda_device, dev))]
        for got, want in [(outs[1], outs[0])] + [
                (caches[cuda_device][k], caches["cpu"][k])
                for k in ("h", "conv")]:
            scale = max(float(want.abs().max()), 1e-6)
            assert float((got.cpu() - want).abs().max()) <= 1e-5 * scale

    with torch.no_grad():
        both(torch.randn((2, 256, cfg.d_model), generator=gen))
        for step in range(4):
            both(torch.randn((2, 1, cfg.d_model), generator=gen),
                 decode=True, active=Active(torch.tensor([True, step != 2])))


@pytest.mark.cuda
@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_jamba_graphed_decode_equals_eager(cuda_device, cache_dtype):
    """Reduced jamba_1_5_large on the card, DSA kernel path: the static
    engine's graphed scan loop gives the python loop's tokens bit for
    bit, one capture (the Mamba state and conv history updated in place
    inside the graph); K2 once a prefill (the one attention layer) and K1
    once a decode step on both loops; the continuous engine's graphed
    segments (blocking admission) give each request its solo tokens."""
    import numpy as np
    from repro_torch.inference.engine import Engine
    from repro_torch.inference.scheduler import ContinuousEngine, Request
    cfg, params = _model("jamba_1_5_large", cuda_device)
    kw = dict(long_context=True, dsa_mode="kernel", cache_dtype=cache_dtype)
    p = np.random.default_rng(2).integers(
        1, cfg.vocab - 4, size=(2, 64)).astype(np.int32)
    toks = {}
    for loop in ("scan", "python"):
        eng = Engine(cfg, params, max_len=96, loop=loop, **kw)
        k1, k2 = (K1.dsa_decode_gather_attention.launches,
                  K2.dsa_block_sparse_attention.launches)
        res = eng.generate(p, 10)
        toks[loop] = res.tokens
        assert K2.dsa_block_sparse_attention.launches - k2 == 1
        assert (K1.dsa_decode_gather_attention.launches - k1
                == res.decode_steps)
        if loop == "scan":
            assert eng.graphs.captures == 1
    np.testing.assert_array_equal(toks["scan"], toks["python"])
    rng = np.random.default_rng(3)
    reqs = [Request(i, rng.integers(1, cfg.vocab - 4, size=(n,)).astype(
        np.int32), m) for i, (n, m) in enumerate([(48, 9), (48, 6),
                                                  (33, 12), (64, 5)])]
    ce = ContinuousEngine(cfg, params, slots=2, seg_len=4, max_len=96, **kw)
    got = ce.run(reqs)
    solo = Engine(cfg, params, max_len=96, **kw)
    for r in reqs:
        np.testing.assert_array_equal(
            got[r.rid], solo.generate(r.prompt[None], r.n_new).tokens[0])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6_3b", "jamba_1_5_large"])
def test_cuda_recurrent_slot_insert(cuda_device, arch):
    """The continuous engine's insert on the card: every leaf of the
    slot (the recurrent state, and on jamba the attention layer's rows,
    zero-extended, and ``pos``) becomes its prefill row, the other slot
    keeps its bytes; the segment graph's capture afterwards (its warm-up
    steps have no active row) leaves every leaf as it was."""
    import numpy as np
    from repro_torch.inference.scheduler import _SEQ_KEYS, ContinuousEngine
    from repro_torch.models import transformer as TT
    cfg, params = _model(arch, cuda_device)
    kw = {} if cfg.rwkv else dict(long_context=True, dsa_mode="kernel")
    eng = ContinuousEngine(cfg, params, slots=2, max_len=96, **kw)
    with torch.inference_mode():
        for lc in TT.attn_caches(eng._caches):
            for name, t in lc.items():
                if t.is_floating_point():
                    t.copy_(torch.randn(t.shape, device=cuda_device))
        before = [{k: t.clone() for k, t in lc.items()}
                  for lc in TT.attn_caches(eng._caches)]
        prompts = np.random.default_rng(4).integers(
            1, cfg.vocab - 4, size=(2, 48)).astype(np.int32)
        _, pre, _ = eng.engine.prefill(prompts, cache_len=48)
        eng._insert(pre, 1, 0)
        for b, res, st in zip(before, TT.attn_caches(eng._caches),
                              TT.attn_caches(pre)):
            for k, t in res.items():
                src = st[k][0]
                if k in _SEQ_KEYS:
                    assert torch.equal(t[1, :src.shape[0]], src), k
                    assert not t[1, src.shape[0]:].any(), k
                else:
                    assert torch.equal(t[1], src), k
                assert torch.equal(t[0], b[k][0]), k
        after = [{k: t.clone() for k, t in lc.items()}
                 for lc in TT.attn_caches(eng._caches)]
    eng._segment_step()
    torch.cuda.synchronize()
    assert eng.graphs.captures == 1
    for a, lc in zip(after, TT.attn_caches(eng._caches)):
        for k, t in lc.items():
            assert torch.equal(t, a[k]), k


# -- encoder-decoder and gated cross-attention (whisper_small,
#    llama_3_2_vision) ---------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("g,hd,causal,l", [
    (1, 64, True, 512), (1, 64, False, 512), (1, 64, False, 1024),
    (4, 128, True, 1024)],
    ids=["whisper-decoder", "whisper-encoder", "whisper-encoder-1024",
         "vision"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_k2_cross_arch_geometries(cuda_device, dtype, g, hd, causal,
                                       l):
    """K2 at whisper_small's geometry (MHA: hd 64, GQA group 1; its
    decoder's causal prefill and its encoder's non-causal one, the
    ``launch_tc<64>`` instance in bf16) and llama_3_2_vision's (hd 128,
    group 4), block 128, model-layout views, the diagonal block among 4
    selected, at the dtype's tolerance."""
    args = _k2_window_inputs(cuda_device, dtype, g, hd, 128, l,
                             seed=110 + g + hd + l + causal)
    kw = dict(block_q=128, block_k=128, causal=causal)
    got = K2.dsa_block_sparse_attention(*args, **kw)
    want = K2.dsa_block_sparse_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("g,hd", [(1, 64), (4, 128)],
                         ids=["whisper", "vision"])
@pytest.mark.parametrize("qdt,cdt", [(torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.float32)],
                         ids=["bf16-bf16", "f32-f32"])
def test_cuda_k1_cross_arch_geometries(cuda_device, g, hd, qdt, cdt):
    """K1 at whisper_small's decode geometry (hd 64, group 1; its 448-row
    decoder context) and llama_3_2_vision's (hd 128, group 4), ragged
    kv_len, an ok = 0 block, against its plain version at the query
    dtype's tolerance."""
    gen = torch.Generator(device=cuda_device).manual_seed(120 + g + hd)
    b, hkv, bk = 3, 2, 128
    s = 512 if hd == 64 else 4224
    q = torch.randn((b, hkv * g, 1, hd), generator=gen,
                    device=cuda_device).to(qdt)
    kc, vc = (torch.randn((b, s, hkv, hd), generator=gen,
                          device=cuda_device).to(cdt) for _ in range(2))
    kv_len = torch.tensor([s - 64, s // 2 + 3, 200], dtype=torch.int32,
                          device=cuda_device)
    nb = 2
    idx = torch.stack([torch.randperm(-(-int(n) // bk), generator=torch.
                                      Generator().manual_seed(i))[:nb]
                       for i, n in enumerate(kv_len.tolist())]).sort(
        -1).values.to(torch.int32).to(cuda_device)
    ok = torch.ones((b, nb), dtype=torch.bool, device=cuda_device)
    ok[1, 0] = False
    args = (q, kc, vc, idx, ok, kv_len)
    got = K1.dsa_decode_gather_attention(*args, block_k=bk)
    want = K1.dsa_decode_gather_attention_plain(*args, block_k=bk)
    torch.cuda.synchronize()
    atol, rtol = TOL[qdt]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


def _cross_inputs(cfg, b, seed=5):
    """The arch's frame or patch embeddings for ``b`` rows (numpy), drawn
    as ``launch.serve`` draws them."""
    import numpy as np
    from repro_torch.launch.serve import draw_extras
    return draw_extras(cfg, b, np.random.default_rng(seed))


def _gated_model(arch, dev):
    """The reduced arch with every cross gate ``xgate`` at 0.5 (at 0 the
    cross sub-layer would not reach the logits)."""
    from repro_torch.models.transformer import set_cross_gates
    cfg, params = _model(arch, dev)
    return cfg, set_cross_gates(params, 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", ["whisper_small", "llama_3_2_vision"])
def test_cuda_cross_graphed_decode_equals_eager(cuda_device, arch,
                                                cache_dtype):
    """A reduced cross-attention arch on the card, DSA kernel path, with
    its encoder or image input: the graphed scan loop gives the python
    loop's tokens, one capture; a graphed step equals the eager step on a
    copy of the cache bit for bit over 4 steps (the logits, every
    self-attention leaf and the cross sub-layers' ``ck``/``cv``, which
    the graph reads at the addresses the prefill wrote); K2 once a DSA
    layer a prefill (whisper's 2 decoder and 2 encoder layers: 64 frames
    and 64 tokens take the block path) and K1 once a decoder layer a
    step."""
    import numpy as np
    from repro_torch.inference.engine import Engine
    from repro_torch.models.transformer import (attn_caches, cross_caches,
                                                decode_step)
    from repro_torch.tree import map_tree
    cfg, params = _gated_model(arch, cuda_device)
    kw = dict(long_context=True, dsa_mode="kernel", cache_dtype=cache_dtype)
    p = np.random.default_rng(2).integers(
        1, cfg.vocab - 4, size=(2, 64)).astype(np.int32)
    ex = _cross_inputs(cfg, 2)
    n_k2 = cfg.n_layers + (cfg.n_enc_layers if cfg.enc_dec else 0)
    toks = {}
    for loop in ("scan", "python"):
        eng = Engine(cfg, params, max_len=96, loop=loop, **kw)
        k1, k2 = (K1.dsa_decode_gather_attention.launches,
                  K2.dsa_block_sparse_attention.launches)
        res = eng.generate(p, 10, extras=ex)
        toks[loop] = res.tokens
        assert K2.dsa_block_sparse_attention.launches - k2 == n_k2
        assert (K1.dsa_decode_gather_attention.launches - k1
                == cfg.n_layers * res.decode_steps)
        if loop == "scan":
            assert eng.graphs.captures == 1
    np.testing.assert_array_equal(toks["scan"], toks["python"])
    eng = Engine(cfg, params, max_len=96, **kw)
    step = eng.scan_step(2)
    last, res, _ = eng.prefill(p, caches=eng.resident_cache(2), extras=ex)
    with torch.inference_mode():
        twin = map_tree(lambda t: t.clone(), res)
        tok = last[:, -1].argmax(-1, keepdim=True)
        for _ in range(4):
            g = step(tok).clone()
            e = decode_step(eng.params, cfg, eng.decode_flags, tok, twin)[0]
            assert torch.equal(g, e)
            tok = g[:, -1].argmax(-1, keepdim=True)
        for a, c in zip([*attn_caches(res), *cross_caches(res)],
                        [*attn_caches(twin), *cross_caches(twin)]):
            for k in a:
                assert torch.equal(a[k], c[k]), k
        assert any(c["ck"].any() for c in cross_caches(res))


@pytest.mark.cuda
@pytest.mark.parametrize("frames,mode", [(64, "kernel"), (60, "kernel"),
                                         (64, "off")])
def test_cuda_reduced_encoder_matches_cpu(cuda_device, frames, mode):
    """Reduced whisper_small's encoder (f32) on the card and on the CPU
    from the same weights and frames: 64 frames run K2 non-causal on the
    card (its plain version on the CPU), 60 the token fallback; output
    within 1e-4 of its largest magnitude (other summation orders, as the
    CPU parity tests hold the port to the reference)."""
    import dataclasses
    from repro_torch.models import transformer as TT
    from repro_torch.models.attention import RunFlags
    from repro_torch.tree import map_tree
    cfg, params = _model("whisper_small", torch.device("cpu"))
    cfg = dataclasses.replace(cfg, enc_seq_len=frames)
    enc_x = torch.from_numpy(_cross_inputs(cfg, 2)["enc_x"])
    flags = RunFlags(mode="prefill", dsa_mode=mode)
    k2 = K2.dsa_block_sparse_attention.launches
    with torch.inference_mode():
        want, _ = TT._encode(params, cfg, flags, enc_x)
        got, _ = TT._encode(map_tree(lambda t: t.to(cuda_device), params),
                            cfg, flags, enc_x.to(cuda_device))
    torch.cuda.synchronize()
    launched = K2.dsa_block_sparse_attention.launches - k2
    assert launched == (cfg.n_enc_layers if (frames, mode) == (64, "kernel")
                        else 0)
    scale = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale


# -- distributed serving: the tp-2 shard geometry, tp 2 over gloo on one
#    card, NCCL at world size 1 ---------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,cdt", [(torch.bfloat16, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.float32)],
                         ids=["bf16-f32", "bf16-bf16", "f32-f32"])
def test_cuda_k1_yi_tp2_shard_geometry(cuda_device, qdt, cdt):
    """K1 at one tp-2 shard of yi_6b: 16 query heads on 2 KV heads (G 8,
    as unsharded), hd 128, 4224 cache rows, ragged kv_len and an ok = 0
    block, against its plain version."""
    _k1_shard(cuda_device, qdt, cdt, hkv=2, g=8)


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,cdt", [(torch.bfloat16, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.float32)],
                         ids=["bf16-f32", "bf16-bf16", "f32-f32"])
def test_cuda_k1_yi_tp16_rank_geometry(cuda_device, qdt, cdt):
    """K1 at one rank of yi_6b at tp 16, above its 4 KV heads: 2 query
    heads on the one KV head of their group (G 2), otherwise as the tp-2
    case."""
    _k1_shard(cuda_device, qdt, cdt, hkv=1, g=2)


def _k1_shard(cuda_device, qdt, cdt, hkv, g, hd=128):
    gen = torch.Generator(device=cuda_device).manual_seed(131)
    b, s, bk, nb = 4, 4224, 128, 6
    q = torch.randn((b, hkv * g, 1, hd), generator=gen,
                    device=cuda_device).to(qdt)
    kc, vc = (torch.randn((b, s, hkv, hd), generator=gen,
                          device=cuda_device).to(cdt) for _ in range(2))
    kv_len = torch.tensor([4160, 4100, 4097, 4133], dtype=torch.int32,
                          device=cuda_device)
    idx = torch.stack([torch.randperm(-(-int(n) // bk), generator=torch.
                                      Generator().manual_seed(i))[:nb]
                       for i, n in enumerate(kv_len.tolist())]).sort(
        -1).values.to(torch.int32).to(cuda_device)
    ok = torch.ones((b, nb), dtype=torch.bool, device=cuda_device)
    ok[2, 1] = False
    args = (q, kc, vc, idx, ok, kv_len)
    got = K1.dsa_decode_gather_attention(*args, block_k=bk)
    want = K1.dsa_decode_gather_attention_plain(*args, block_k=bk)
    torch.cuda.synchronize()
    atol, rtol = TOL[qdt]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_k2_yi_tp2_shard_geometry(cuda_device, dtype):
    """K2 at one tp-2 shard of yi_6b's prefill: 16 query heads on 2 KV
    heads (G 8), hd 128, block 128, L 2048, model-layout views, the
    diagonal block among 4 selected."""
    args = _k2_window_inputs(cuda_device, dtype, 8, 128, 128, 2048,
                             seed=137)
    kw = dict(block_q=128, block_k=128, causal=True)
    got = K2.dsa_block_sparse_attention(*args, **kw)
    want = K2.dsa_block_sparse_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_k2_yi_tp16_rank_geometry(cuda_device, dtype):
    """K2 at one rank of yi_6b's prefill at tp 16: 2 query heads on the
    one KV head of their group (G 2), hd 128, block 128, L 2048."""
    args = _k2_window_inputs(cuda_device, dtype, 2, 128, 128, 2048,
                             seed=139, hkv=1)
    kw = dict(block_q=128, block_k=128, causal=True)
    got = K2.dsa_block_sparse_attention(*args, **kw)
    want = K2.dsa_block_sparse_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,cdt", [(torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.float32)],
                         ids=["bf16-bf16", "f32-f32"])
@pytest.mark.parametrize("hkv,g,hd", [(6, 1, 64), (4, 4, 128)],
                         ids=["whisper", "vision"])
def test_cuda_k1_cross_arch_tp2_rank_geometry(cuda_device, qdt, cdt, hkv, g,
                                              hd):
    """K1 at one tp-2 rank of whisper_small (6 query heads on 6 KV heads,
    G 1, hd 64) and of llama_3_2_vision (16 on 4, G 4, hd 128), ragged
    kv_len and an ok = 0 block, against its plain version."""
    _k1_shard(cuda_device, qdt, cdt, hkv=hkv, g=g, hd=hd)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hkv,g,hd,l", [(6, 1, 64, 768), (4, 4, 128, 2048)],
                         ids=["whisper", "vision"])
def test_cuda_k2_cross_arch_tp2_rank_geometry(cuda_device, dtype, hkv, g,
                                              hd, l):
    """K2 at one tp-2 rank of whisper_small's decoder prefill (6 query
    heads on 6 KV heads, G 1, hd 64: the ``launch_tc<64>`` instance in
    bf16; L 768, 6 key blocks, so that 4 random ones are a selection) and
    of llama_3_2_vision's (16 on 4, G 4, hd 128, L 2048), block 128,
    model-layout views."""
    args = _k2_window_inputs(cuda_device, dtype, g, hd, 128, l, seed=149,
                             hkv=hkv)
    kw = dict(block_q=128, block_k=128, causal=True)
    got = K2.dsa_block_sparse_attention(*args, **kw)
    want = K2.dsa_block_sparse_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,cdt", [(torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.float32)],
                         ids=["bf16-bf16", "f32-f32"])
def test_cuda_k1_jamba_tp2_rank_geometry(cuda_device, qdt, cdt):
    """K1 at one tp-2 rank of jamba_1_5_large's attention sub-block: 32
    query heads on 4 KV heads (G 8, hd 128), ragged kv_len and an ok = 0
    block, against its plain version."""
    _k1_shard(cuda_device, qdt, cdt, hkv=4, g=8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_k2_jamba_tp2_rank_geometry(cuda_device, dtype):
    """K2 at one tp-2 rank of jamba_1_5_large's prefill: 32 query heads
    on 4 KV heads (G 8, hd 128), L 2048, block 128, model-layout views,
    against its plain version."""
    args = _k2_window_inputs(cuda_device, dtype, 8, 128, 128, 2048,
                             seed=157, hkv=4)
    kw = dict(block_q=128, block_k=128, causal=True)
    got = K2.dsa_block_sparse_attention(*args, **kw)
    want = K2.dsa_block_sparse_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_k7_rwkv_tp2_rank_geometry(cuda_device, dtype):
    """K7 at one tp-2 rank of rwkv6_3b: its 20 heads of hd 64, from a zero
    and from a random state, against its plain version: y and s_last."""
    torch.backends.cuda.matmul.allow_tf32 = False
    (r, k, v, w, u), s0 = _k7_inputs(cuda_device, dtype, 64, seed=151, b=2,
                                     h=20, s=256)
    atol, rtol = TOL[dtype]
    for s in (torch.zeros_like(s0), s0):
        y, st = K7.wkv6_chunked(r, k, v, w, u, s)
        yp, sp = K7.wkv6_chunked_plain(r, k, v, w, u, s)
        torch.cuda.synchronize()
        torch.testing.assert_close(y.float(), yp.float(), atol=atol,
                                   rtol=rtol)
        torch.testing.assert_close(st, sp, atol=1e-5, rtol=1e-5)


def _pairs_equal(pair):
    plain, sharded = pair
    assert set(plain) == set(sharded)
    for rid in plain:
        assert (plain[rid] == sharded[rid]).all(), rid


@pytest.mark.cuda
def test_cuda_tp2_gloo_one_card_equals_unsharded(cuda_device, tmp_path):
    """tp 2 as two processes on the one card over gloo (reduced yi_6b,
    f32, kernel DSA): static generate greedy and sampled, and continuous
    serving chunked and paged with int8 K/V, give the unsharded engines'
    tokens; the gloo engine decodes eagerly (no graph)."""
    import spmd_scenarios as S
    from repro_torch.launch.mesh import run_spmd
    out = run_spmd(S.card_tp2, 2, store_dir=str(tmp_path), backend="gloo",
                   device_ids=[0, 0], timeout_s=300)[0]
    for greedy, (plain, sharded) in out["generate"].items():
        assert (plain == sharded).all(), greedy
    assert out["graphs"]
    _pairs_equal(out["chunked"])
    _pairs_equal(out["paged int8"])


@pytest.mark.cuda
def test_cuda_nccl_world1_graphed_equals_eager(cuda_device, tmp_path):
    """NCCL at world size 1 on a (1, 1) ("data", "model") mesh: the
    decode graph captures the step's collectives, its logits and cache
    equal the eager step's bit for bit, the tokens equal the unsharded
    engine's, and a generate issues (steps + 1) x (2 n_layers + 1)
    all-reduces and steps + 1 all-gathers over "model" (the prefill's and
    each step's), nothing over "data"."""
    import spmd_scenarios as S
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.mesh import run_spmd
    out = run_spmd(S.card_nccl1, 1, store_dir=str(tmp_path), backend="nccl",
                   device_ids=[0], timeout_s=300)[0]
    for greedy, (plain, sharded) in out["generate"].items():
        assert (plain == sharded).all(), greedy
    assert out["captured"] and out["graph_bits"]
    model, data, steps, n_layers = out["counts"]
    C.check_tp_decode_collectives(model, n_layers, steps + 1)
    assert data == {"all-reduce": 0, "all-gather": 0}


def _train_pair_close(out, rel=1e-5):
    """A sharded step on the card against the unsharded one: the metrics
    to ``rel``, each leaf's gradient to ``rel`` of its largest magnitude,
    every updated element within 2 lr and 99 % within 1e-5."""
    import spmd_train_scenarios as S
    (plain,), (sharded,) = out["metrics"]
    for k in ("loss", "ce", "mse", "grad_norm"):
        assert abs(sharded[k] - plain[k]) <= rel * abs(plain[k]) + 1e-7, k
    bad = {p: e for p, e in out["grads"].items() if e > rel}
    assert not bad, bad
    assert all(g[0] <= 2 * S.OPT.lr for g in out["params"].values())
    within = sum(g[1] for g in out["params"].values())
    total = sum(g[2] for g in out["params"].values())
    assert within >= 0.99 * total, (within, total)


@pytest.mark.cuda
def test_cuda_fsdp2_gloo_train_step_equals_unsharded(cuda_device, tmp_path):
    """FSDP 2 (``make_rules(tp=False)`` on (2, 1)) as two gloo processes on
    the one card, reduced yi_6b in f32: one step's metrics, gradients and
    updated params equal the unsharded step's on the card, and the
    collectives equal the budget."""
    import spmd_train_scenarios as S
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.mesh import run_spmd
    outs = run_spmd(S.card_fsdp2, 2, store_dir=str(tmp_path),
                    backend="gloo", device_ids=[0, 0], timeout_s=300)
    for out in outs:
        _train_pair_close(out)
        C.check_train_collectives(*out["budget"])


@pytest.mark.cuda
def test_cuda_nccl_world1_train_step_equals_unsharded(cuda_device,
                                                      tmp_path):
    """NCCL at world size 1 on a (1, 1) mesh under ``make_rules()`` (every
    collective a group of one), reduced yi_6b in f32, 2 microbatches: the
    step equals the unsharded one and its collectives the budget."""
    import spmd_train_scenarios as S
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.mesh import run_spmd
    out = run_spmd(S.card_nccl1_train, 1, store_dir=str(tmp_path),
                   backend="nccl", device_ids=[0], timeout_s=300)[0]
    _train_pair_close(out)
    C.check_train_collectives(*out["budget"])


@pytest.mark.cuda
def test_cuda_ep2_gloo_train_equals_cpu(cuda_device, tmp_path):
    """mixtral EP 2 x TP 2 + SP (``make_rules()`` on (1, 2)) as two gloo
    processes on the one card, reduced width in f32 with the router term
    on, 2 steps: each rank's losses equal the same EP run's on the CPU
    within 1e-4 (predicted), and the card run's all-to-alls and other
    collectives equal the budget."""
    import spmd_ep_scenarios as E
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.mesh import run_spmd
    outs = run_spmd(E.card_ep2, 2, store_dir=str(tmp_path),
                    backend="gloo", device_ids=[0, 0], timeout_s=300)
    for out in outs:
        for a, b in zip(out["cpu"], out["card"]):
            for k in ("loss", "ce", "router_aux"):
                assert abs(b[k] - a[k]) <= 1e-4 * abs(a[k]) + 1e-7, (k, a, b)
        assert out["card", "counts"][("all-to-all", "model")] > 0
        C.check_train_collectives(out["card", "counts"],
                                  out["card", "budget"])
