"""Input stand-ins for every (arch x shape) cell of the dry run (the port
of the reference's ``repro/launch/specs.py``).

Each function returns tensors that hold shapes and dtypes but no data,
with their logical-axis spec trees: on the "meta" device by default, or,
called inside a ``FakeTensorMode`` on a real device type, fake tensors
that a whole step can run on (``launch/dryrun.py``).  The full configs
are only ever touched through these.  Modality frontends are stubs, as
in the reference: whisper gets precomputed frame embeddings (``enc_x``),
llama_3_2_vision precomputed patch embeddings (``img``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.attention import RunFlags
from repro_torch.models.transformer import (init_cache, init_model,
                                            model_param_specs,
                                            unstacked_cache_specs)
from repro_torch.optim import adamw
from repro_torch.training.steps import init_train_state


def batch_structs(cfg: ArchConfig, shape: ShapeConfig, train: bool, *,
                  device="meta") -> Dict[str, torch.Tensor]:
    gb, s = shape.global_batch, shape.seq_len

    def sd(shp, dt):
        return torch.empty(shp, dtype=dt, device=device)

    out = {"tokens": sd((gb, s), torch.int32)}
    if train:
        out["labels"] = sd((gb, s), torch.int32)
        out["loss_mask"] = sd((gb, s), torch.float32)
    if cfg.enc_dec:
        out["enc_x"] = sd((gb, cfg.enc_seq_len, cfg.d_model), torch.bfloat16)
    if cfg.cross_attn_period:
        out["img"] = sd((gb, cfg.n_image_tokens, cfg.d_model),
                        torch.bfloat16)
    return out


def batch_logical_specs(batch_structs_tree) -> Dict[str, Tuple]:
    return {k: ("batch",) + (None,) * (v.dim() - 1)
            for k, v in batch_structs_tree.items()}


def model_structs(cfg: ArchConfig, *, device="meta"):
    """(params, logical specs) without data."""
    return init_model(0, cfg, device=device), model_param_specs(cfg)


def train_state_structs(cfg: ArchConfig, opt: adamw.OptConfig, *,
                        device="meta", mesh=None, rules=None):
    """(state, logical specs) without data (``init_train_state``'s; on a
    ``mesh`` under ``rules``, this rank's shards)."""
    return init_train_state(0, cfg, opt, device=device, mesh=mesh,
                            rules=rules)


def cache_structs(cfg: ArchConfig, batch: int, max_len: int,
                  flags: RunFlags, *, device="meta"):
    """(caches, logical specs) of a bf16 cache without data."""
    caches = init_cache(cfg, batch, max_len, flags, dtype=torch.bfloat16,
                        device=device)
    return caches, unstacked_cache_specs(cfg, caches)
