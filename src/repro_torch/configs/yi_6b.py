"""Yi-6B — llama-arch dense GQA [arXiv:2403.04652]."""
from repro_torch.configs.base import ArchConfig, DSAConfig

CONFIG = ArchConfig(
    name="yi_6b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, vocab=64000, rope_theta=5e6,
    dsa=DSAConfig(enabled=True, sparsity=0.90, sigma=0.25, quant_bits=4),
)
