"""Architecture configuration (the port's own copy of the reference's:
dense GQA, sliding window, mixture of experts, multi-head latent
attention, RWKV6, the Mamba hybrid, the encoder-decoder and gated
cross-attention).

Each architecture is an ``ArchConfig`` in its own module
(``repro_torch/configs/<id>.py``) exposing ``CONFIG``.  ``get_config(name)``
resolves by id; ``reduced(cfg)`` gives the CPU-test variant of the same
family, with exactly the widths the JAX reference's ``reduced`` picks.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 0          # expert hidden dim (0 -> use arch d_ff)
    num_shared_experts: int = 0   # deepseek-style always-on shared experts
    layer_period: int = 1         # MoE every `period` layers (1 = all layers)
    layer_offset: int = 0
    first_k_dense: int = 0        # deepseek: first k layers stay dense MLP
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention dims."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2


@dataclasses.dataclass(frozen=True)
class MambaShard(MambaConfig):
    """One rank's ``MambaConfig`` on a ``tp``-way "model" axis
    (``distributed.sharding.shard_config``): its Mamba layers hold
    d_model * expand / tp of the inner channels (``models.ssm.d_inner``)."""
    tp: int = 1


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64            # wkv state is head_dim x head_dim per head
    decay_lora: int = 64          # low-rank data-dependent decay


@dataclasses.dataclass(frozen=True)
class DSAConfig:
    """Dynamic Sparse Attention (the paper's technique).

    sparsity: fraction of attention weights dropped (paper: 0.90 - 0.99).
    sigma:    k/d random-projection scale.
    quant_bits: prediction-path fake-quant precision (paper: INT4 default).
    block_q/block_k: block granularity of prediction and selection.
    """
    enabled: bool = False
    sparsity: float = 0.90
    sigma: float = 0.25
    quant_bits: int = 4           # 2 | 4 | 8 | 16 | 32 (32 = no quant)
    block_q: int = 128
    block_k: int = 128
    lambda_mse: float = 0.01      # joint-loss weight of L_MSE (paper Eq. 7)
    min_blocks: int = 1           # always keep >=1 block per query row
    local_blocks: int = 1         # always keep the diagonal (local) block(s)
    sort_indices: bool = True     # visit kept blocks in ascending order


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    qkv_bias: bool = False
    swa_window: int = 0           # 0 = full attention; else sliding-window size
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None
    # hybrid (jamba): one attention layer every ``attn_layer_period``
    # layers, at ``attn_layer_offset`` within the period, Mamba elsewhere
    attn_layer_period: int = 0    # 0 = all attention
    attn_layer_offset: int = 0
    # encoder-decoder (whisper): an encoder of ``n_enc_layers`` over
    # ``enc_seq_len`` precomputed frame embeddings (the frontend stub)
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_seq_len: int = 1500
    # gated cross-attention (llama-3.2-vision): one cross-attention
    # sub-layer in every group of ``cross_attn_period`` layers, over
    # ``n_image_tokens`` precomputed patch embeddings (the tower stub)
    cross_attn_period: int = 0
    n_image_tokens: int = 1601
    dsa: DSAConfig = dataclasses.field(default_factory=DSAConfig)
    dtype: str = "bfloat16"       # activation dtype
    param_dtype: str = "bfloat16"
    # training memory policy: recompute each layer group in the backward
    # pass ("full"), keeping the unbatched products' outputs ("dots"), or
    # keep every activation ("none")
    remat: bool = True
    remat_policy: str = "full"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def num_params(self) -> int:
        """Analytic parameter count (embedding + blocks), for 6ND roofline
        (the reference's count, which leaves out an encoder and the
        cross-attention sub-layers: ROADMAP Queue 3)."""
        d, v = self.d_model, self.vocab
        total = v * d * (1 if self.tie_embeddings else 2)
        for i in range(self.n_layers):
            kind = layer_kind(self, i)
            if kind == "rwkv":
                total += 4 * d * d + d * d + 2 * d * self.rwkv.decay_lora
                total += 2 * d * self.d_ff + self.d_ff * d  # channel-mix
                continue
            if kind == "mamba":
                mc = self.mamba
                mi = d * mc.expand
                total += (2 * d * mi          # in_proj (x, z)
                          + mi * mc.d_conv
                          + mi * (mc.d_state * 2 + mi // 16)
                          + mi * d)           # out_proj
            else:
                total += self._attn_params()
            total += self._mlp_params(i)
        return total

    def _attn_params(self) -> int:
        d = self.d_model
        m = self.mla
        if m is None:
            n_q = self.n_heads * self.resolved_head_dim
            n_kv = self.n_kv_heads * self.resolved_head_dim
            return d * (n_q + 2 * n_kv) + n_q * d
        qk_h = m.qk_nope_head_dim + m.qk_rope_head_dim
        return (d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk_h
                + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                + m.kv_lora_rank * self.n_heads
                * (m.qk_nope_head_dim + m.v_head_dim)
                + self.n_heads * m.v_head_dim * d)

    def _mlp_params(self, layer_idx: int) -> int:
        d, f = self.d_model, self.d_ff
        dense = 3 * d * f  # gated (swiglu): gate+up+down
        if self.moe is None:
            return dense
        mo = self.moe
        if layer_idx < mo.first_k_dense:
            return dense
        if (layer_idx - mo.layer_offset) % mo.layer_period != 0:
            return dense
        fe = mo.d_ff_expert or f
        routed = mo.num_experts * 3 * d * fe
        shared = mo.num_shared_experts * 3 * d * fe
        router = d * mo.num_experts
        return routed + shared + router

    def num_active_params(self) -> int:
        """Active params per token (MoE top-k) for 6·N_active·D."""
        if self.moe is None:
            return self.num_params()
        mo = self.moe
        fe = mo.d_ff_expert or self.d_ff
        n_moe = sum(is_moe_layer(self, i) for i in range(self.n_layers))
        inactive = n_moe * (mo.num_experts - mo.top_k) * 3 * self.d_model * fe
        return self.num_params() - inactive


def is_moe_layer(cfg: ArchConfig, i: int) -> bool:
    if cfg.moe is None or layer_kind(cfg, i) == "rwkv":
        return False
    mo = cfg.moe
    if i < mo.first_k_dense:
        return False
    return (i - mo.layer_offset) % mo.layer_period == 0


def layer_kind(cfg: ArchConfig, i: int) -> str:
    """Which block kind layer ``i`` is: attn | mamba | rwkv."""
    if cfg.rwkv is not None:
        return "rwkv"
    if cfg.mamba is not None and cfg.attn_layer_period:
        if i % cfg.attn_layer_period == cfg.attn_layer_offset:
            return "attn"
        return "mamba"
    return "attn"


def is_recurrent(cfg: ArchConfig) -> bool:
    """Whether some layer carries a recurrent state (RWKV6, Mamba): a
    state that absorbs every token it is given and cannot roll back."""
    return cfg.rwkv is not None or cfg.mamba is not None


ARCH_IDS = ("yi_6b", "stablelm_3b", "qwen1_5_110b", "h2o_danube_1_8b",
            "rwkv6_3b", "mixtral_8x22b", "deepseek_v3", "jamba_1_5_large",
            "whisper_small", "llama_3_2_vision")


# -- shapes (the reference's cells: seq_len x global_batch) -----------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# long_500k applicability: the archs with a sub-quadratic path
LONG_CTX_ARCHS = ("rwkv6_3b", "jamba_1_5_large", "h2o_danube_1_8b",
                  "mixtral_8x22b", "yi_6b")


def get_config(name: str) -> ArchConfig:
    """The arch ``name`` (every arch of the reference is ported)."""
    name = name.replace("-", "_")
    if name not in ARCH_IDS:
        raise ValueError(f"arch {name!r} is not ported; ported: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}").CONFIG


def cut_layers(cfg: ArchConfig, n: int) -> ArchConfig:
    """``cfg`` cut to its first ``n`` layers, a dense prologue
    (``first_k_dense``) kept whole: deepseek_v3 at 3 layers is its
    prologue alone, at 5 the prologue and 2 MoE layers.  Fewer layers
    than the prologue is a ValueError.  A hybrid arch (jamba) is cut in
    whole groups of ``attn_layer_period`` layers, or, below one period,
    to ONE group of the period's first ``n`` sub-blocks (jamba at 5:
    four Mamba sub-blocks, MoE on the second and fourth, and the
    attention one); any other ``n`` is a ValueError.  A cross-attention
    arch (llama_3_2_vision) is cut in whole groups of
    ``cross_attn_period`` layers; an encoder-decoder's cut is its
    decoder's (the encoder keeps ``n_enc_layers``)."""
    k = cfg.moe.first_k_dense if cfg.moe is not None else 0
    if n < k:
        raise ValueError(f"{cfg.name}: {n} layers is less than its dense "
                         f"prologue's {k}")
    period = cfg.attn_layer_period if cfg.mamba is not None else 0
    if period and n > period and n % period:
        raise ValueError(f"{cfg.name}: {n} layers is neither whole groups "
                         f"of {period} nor one group's first sub-blocks")
    xp = cfg.cross_attn_period
    if xp and (n < 1 or n % xp):
        raise ValueError(f"{cfg.name}: {n} layers is not whole groups of "
                         f"{xp}")
    return dataclasses.replace(cfg, n_layers=n)


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family variant for CPU tests."""
    kw = dict(
        n_layers=min(cfg.n_layers, 2),
        d_model=64, n_heads=4, head_dim=16,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=128, vocab=512,
        swa_window=min(cfg.swa_window, 64) if cfg.swa_window else 0,
        remat=False, dtype="float32", param_dtype="float32",
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=64, first_k_dense=min(cfg.moe.first_k_dense, 1),
            capacity_factor=8.0)   # no capacity drops at test scale
        if cfg.moe.first_k_dense:
            kw["n_layers"] = 3
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=32,
                              qk_nope_head_dim=16, qk_rope_head_dim=8,
                              v_head_dim=16)
    if cfg.mamba is not None:
        kw["mamba"] = MambaConfig(d_state=8, d_conv=4, expand=2)
        kw["n_layers"] = max(cfg.attn_layer_period, 4)
    if cfg.rwkv is not None:
        kw["rwkv"] = RWKVConfig(head_dim=16, decay_lora=8)
    if cfg.enc_dec:
        kw["n_enc_layers"] = 2
        kw["enc_seq_len"] = 64
    if cfg.cross_attn_period:
        kw["n_image_tokens"] = 32
        kw["n_layers"] = max(cfg.cross_attn_period, 4)
    if cfg.dsa.enabled:
        kw["dsa"] = dataclasses.replace(cfg.dsa, block_q=16, block_k=16)
    return dataclasses.replace(cfg, **kw)
