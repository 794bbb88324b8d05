"""ServingConfig — the serving knobs of both engines, validated once.

``Engine`` reads the shared and static-batch fields, ``ContinuousEngine``
(inference/scheduler.py) the shared and continuous fields, so one config
can parameterise a whole serving stack.  The port carries the fields of
the paths ported so far; speculation, serving meshes, the request
lifecycle knobs and telemetry come with the slices that port those paths.

Mixed-precision serving:

  select_dtype  "float32" (default) | "int8": the DSA predicted-key caches
                kt/ktb are stored int8 with per-row scales and the
                per-step selection product runs in integers, back in f32
                only at the top-k.  Needs ``long_context``.
  kv_quant      None (default) | "int8" | "fp8": the K/V caches are stored
                narrow with per-(row, head) scales, dequantized after each
                gather and inside the kernels.

The defaults leave every path as it was.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models.attention import (DSA_MODES, KV_QUANT_DTYPES,
                                          SELECT_DTYPES)

LOOPS = ("scan", "python")


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    # -- shared (both engines) ---------------------------------------------
    max_len: int = 2048              # cache rows per batch row / slot
    long_context: bool = False       # allocate the DSA predicted-key cache
    dsa_mode: str = "off"            # default DSA execution path
    cache_dtype: torch.dtype = torch.float32   # K/V cache dtype
    pad_id: int = 0
    select_dtype: str = "float32"    # DSA selection precision (see above)
    kv_quant: Optional[str] = None   # K/V cache storage quant (see above)
    # -- Engine (static batch) ---------------------------------------------
    loop: str = "scan"               # fused step loop vs per-token loop
    prompt_buckets: bool = True
    step_buckets: bool = True
    # -- ContinuousEngine ----------------------------------------------------
    slots: int = 4                   # resident cache rows
    seg_len: int = 16                # decode steps per segment
    chunked_prefill: Optional[bool] = None   # None = auto by envelope
    chunk_tokens: int = 64           # admission chunk width (pow2-rounded)
    paged: bool = False              # page the resident KV cache
    pool_pages: Optional[int] = None  # None = every slot at max_len + 1

    def __post_init__(self):
        for name, val, valid in (("dsa_mode", self.dsa_mode, DSA_MODES),
                                 ("select_dtype", self.select_dtype,
                                  SELECT_DTYPES),
                                 ("kv_quant", self.kv_quant,
                                  KV_QUANT_DTYPES),
                                 ("loop", self.loop, LOOPS)):
            if val not in valid:
                raise ValueError(
                    f"ServingConfig.{name}={val!r} is not a valid choice; "
                    f"valid: {valid}")


# the reference's ServingConfig fields of paths not ported yet
UNPORTED = ("spec", "draft", "spec_rounds", "max_mode_wait_s", "mesh",
            "shard_rules", "moe_prefill", "queue_cap", "shed_policy",
            "deadline_s", "admit_retries", "injector", "telemetry")


def resolve_config(config: Optional[ServingConfig], kw: dict
                   ) -> ServingConfig:
    """Merge keyword arguments into a ``ServingConfig`` (kwargs win).  A
    field of the reference that the port does not have yet raises
    ``NotImplementedError``."""
    asked = sorted(set(kw) & set(UNPORTED))
    if asked:
        raise NotImplementedError(
            f"{asked} {'is' if len(asked) == 1 else 'are'} not ported to "
            f"repro_torch yet (see ROADMAP.md)")
    if config is None:
        return ServingConfig(**kw)
    if not isinstance(config, ServingConfig):
        raise TypeError(f"config must be a ServingConfig, got "
                        f"{type(config).__name__}")
    return dataclasses.replace(config, **kw) if kw else config
