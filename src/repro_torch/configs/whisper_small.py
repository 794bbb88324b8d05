"""Whisper-small — encoder-decoder; the conv frontend is a stub (the
encoder takes precomputed frame embeddings) [arXiv:2212.04356]."""
from repro_torch.configs.base import ArchConfig, DSAConfig

CONFIG = ArchConfig(
    name="whisper_small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab=51968,   # 51865 padded to /128 so vocab TP-shards
    enc_dec=True, n_enc_layers=12, enc_seq_len=1500,
    dsa=DSAConfig(enabled=True, sparsity=0.90, sigma=0.25, quant_bits=4),
)
