"""The CUDA kernels K1 and K2 on the card against their plain versions.

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

from repro_torch.core.masks import block_topk_indices
from repro_torch.kernels import dsa_attention as K2
from repro_torch.kernels import dsa_decode as K1

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
