"""ServingConfig — the static engine's knobs, validated once.

The port carries the fields the static ``Engine`` reads; the continuous
scheduler's knobs (slots, paging, speculation, quantized caches, ...)
come with the slices that port those paths.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models.attention import DSA_MODES

LOOPS = ("scan", "python")


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    max_len: int = 2048              # cache rows per batch row
    long_context: bool = False       # allocate the DSA predicted-key cache
    dsa_mode: str = "off"            # default DSA execution path
    cache_dtype: torch.dtype = torch.float32   # K/V cache dtype
    pad_id: int = 0
    loop: str = "scan"               # fused step loop vs per-token loop
    prompt_buckets: bool = True
    step_buckets: bool = True

    def __post_init__(self):
        for name, val, valid in (("dsa_mode", self.dsa_mode, DSA_MODES),
                                 ("loop", self.loop, LOOPS)):
            if val not in valid:
                raise ValueError(
                    f"ServingConfig.{name}={val!r} is not a valid choice; "
                    f"valid: {valid}")


def resolve_config(config: Optional[ServingConfig], kw: dict
                   ) -> ServingConfig:
    """Merge keyword arguments into a ``ServingConfig`` (kwargs win)."""
    if config is None:
        return ServingConfig(**kw)
    if not isinstance(config, ServingConfig):
        raise TypeError(f"config must be a ServingConfig, got "
                        f"{type(config).__name__}")
    return dataclasses.replace(config, **kw) if kw else config
