"""H2O-Danube-1.8B — llama+mistral mix with sliding-window attention
[arXiv:2401.16818]."""
from repro_torch.configs.base import ArchConfig, DSAConfig

CONFIG = ArchConfig(
    name="h2o_danube_1_8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=80,
    d_ff=6912, vocab=32000, swa_window=4096, rope_theta=1e4,
    dsa=DSAConfig(enabled=True, sparsity=0.90, sigma=0.25, quant_bits=4),
)
