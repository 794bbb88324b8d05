"""ServingConfig — the serving knobs of both engines, validated once.

``Engine`` reads the shared and static-batch fields, ``ContinuousEngine``
(inference/scheduler.py) the shared and continuous fields, so one config
can parameterise a whole serving stack.  A recurrent arch (RWKV6, a Mamba hybrid) in the continuous engine admits
blocking on a dense cache, whatever ``chunked_prefill`` says; ``paged``
and quantization are refused for it.

MoE archs:

  moe_prefill  "capacity" (default): prefill routes each row's tokens
               through the capacity dispatch (a token past its expert's
               capacity is dropped), decode steps through the dense path;
               such an arch admits blocking.  "dense": prefill routes the
               decode-dense path too, so whole-prompt prefill, chunk steps
               and decode are token-exact and the arch can chunk-admit
               (where it can bucket: not on an SWA ring).

Request lifecycle and fault tolerance (continuous engine):

  queue_cap      None (default: unbounded) | n >= 1: a submit that finds n
                 requests queued sheds one (status "shed") by
  shed_policy    "reject" (the arrival) | "oldest" (the longest queued) |
                 "lowest-priority" (the lowest ``Request.priority``
                 queued, unless the arrival is lower still).
  deadline_s     the default latency budget of a request that sets none
                 (None: no budget); past it a request retires "timeout"
                 at the next segment boundary.
  admit_retries  admission attempts (default 8) an anchor the page pool
                 cannot fund gets on an otherwise idle engine before it
                 is shed.
  injector       an ``inference.faults.FaultInjector`` (None: no faults).

Observability: ``telemetry`` (None, the default, records nothing and
runs no hook) takes an ``inference.telemetry.Telemetry``: request spans,
a Chrome trace, Prometheus text, compile events and the sampled DSA
selection probe.

Per-request DSA modes (continuous engine): segments are mode-affine, so a
queued request of another ``dsa_mode`` waits for the engine to drain.

  max_mode_wait_s  None (default): wait for a natural idle drain.  A
                   number: once such a request has waited this many
                   seconds, admission of current-mode traffic stops until
                   the engine drains and switches modes.

Mixed-precision serving:

  select_dtype  "float32" (default) | "int8": the DSA predicted-key caches
                kt/ktb are stored int8 with per-row scales and the
                per-step selection product runs in integers, back in f32
                only at the top-k.  Needs ``long_context``.
  kv_quant      None (default) | "int8" | "fp8": the K/V caches are stored
                narrow with per-(row, head) scales, dequantized after each
                gather and inside the kernels.

Speculative decoding (continuous engine; ``Engine.generate`` takes
``spec``/``draft`` per call):

  spec         0 (default) | K: speculative segments, K drafts verified a
               round (inference/speculative.py); 0 when paged or outside
               ``speculative.can_speculate``.
  draft        the proposer (None: ``NGramProposer()``).
  spec_rounds  rounds a speculative segment (None: max(1, seg_len //
               (K + 1)), about one plain segment's tokens at full
               acceptance).

Serving meshes (both engines; inference/engine.py):

  mesh         None (default) | a ``torch.distributed`` DeviceMesh from
               ``launch.mesh.make_serving_mesh``: ("data",) shards the
               batch (slots) over data-parallel ranks with replicated
               weights; ("data", "model") also shards the weights and KV
               heads over tensor-parallel ranks.  Every rank runs the
               same engine on the same requests (one process a device).
  shard_rules  None (default: ``sharding.make_serving_rules``) | a
               ``ShardingRules``.  Rules that shard the cache's sequence
               (``cache_seq``: the long-context cache) raise
               NotImplementedError: the port does not serve them.

The defaults leave every path as it was.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.distributed.sharding import ShardingRules
from repro_torch.models.attention import (DSA_MODES, KV_QUANT_DTYPES,
                                          SELECT_DTYPES)

LOOPS = ("scan", "python")
MOE_PREFILL_MODES = ("capacity", "dense")
SHED_POLICIES = ("reject", "oldest", "lowest-priority")


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    # -- shared (both engines) ---------------------------------------------
    max_len: int = 2048              # cache rows per batch row / slot
    long_context: bool = False       # allocate the DSA predicted-key cache
    dsa_mode: str = "off"            # default DSA execution path
    cache_dtype: torch.dtype = torch.float32   # K/V cache dtype
    pad_id: int = 0
    moe_prefill: str = "capacity"    # "dense" = token-exact MoE prefill
    select_dtype: str = "float32"    # DSA selection precision (see above)
    kv_quant: Optional[str] = None   # K/V cache storage quant (see above)
    mesh: Any = None                 # serving mesh (see above)
    shard_rules: Any = None          # logical-axis rules (None = default)
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
    max_mode_wait_s: Optional[float] = None   # other-mode aging (see above)
    spec: int = 0                    # speculative drafts a round (0 = off)
    draft: Any = None                # proposer (None = NGramProposer)
    spec_rounds: Optional[int] = None   # rounds a speculative segment
    # -- fault tolerance (ContinuousEngine) ----------------------------------
    queue_cap: Optional[int] = None  # bounded admission queue (None = inf)
    shed_policy: str = "reject"      # overload victim: see SHED_POLICIES
    deadline_s: Optional[float] = None   # default per-request latency budget
    admit_retries: int = 8           # unfundable-anchor retries before shed
    injector: Any = None             # FaultInjector (None = no injection)
    # -- observability -------------------------------------------------------
    telemetry: Any = None            # inference.telemetry.Telemetry (None:
    #                                  nothing recorded, no hook)

    def __post_init__(self):
        for name, val, valid in (("dsa_mode", self.dsa_mode, DSA_MODES),
                                 ("select_dtype", self.select_dtype,
                                  SELECT_DTYPES),
                                 ("kv_quant", self.kv_quant,
                                  KV_QUANT_DTYPES),
                                 ("loop", self.loop, LOOPS),
                                 ("moe_prefill", self.moe_prefill,
                                  MOE_PREFILL_MODES),
                                 ("shed_policy", self.shed_policy,
                                  SHED_POLICIES)):
            if val not in valid:
                raise ValueError(
                    f"ServingConfig.{name}={val!r} is not a valid choice; "
                    f"valid: {valid}")
        if self.spec < 0 or (self.spec_rounds is not None
                             and self.spec_rounds < 1):
            raise ValueError(f"ServingConfig: spec={self.spec} must be >= 0 "
                             f"and spec_rounds={self.spec_rounds} >= 1")
        if self.queue_cap is not None and self.queue_cap < 1:
            raise ValueError("ServingConfig.queue_cap must be >= 1 "
                             "(None = unbounded)")
        if self.admit_retries < 0:
            raise ValueError("ServingConfig.admit_retries must be >= 0")
        if self.mesh is not None and not hasattr(self.mesh,
                                                 "mesh_dim_names"):
            raise TypeError(f"ServingConfig.mesh must be a DeviceMesh "
                            f"(launch.mesh.make_serving_mesh), got "
                            f"{type(self.mesh).__name__}")
        if self.shard_rules is not None:
            if not isinstance(self.shard_rules, ShardingRules):
                raise TypeError(f"ServingConfig.shard_rules must be a "
                                f"ShardingRules, got "
                                f"{type(self.shard_rules).__name__}")
            if self.shard_rules.cache_seq is not None:
                raise NotImplementedError(
                    "ServingConfig.shard_rules with cache_seq set (the "
                    "sequence-sharded long-context cache) is not ported "
                    "(ROADMAP Queue 1, \"Distribution\")")


def resolve_config(config: Optional[ServingConfig], kw: dict
                   ) -> ServingConfig:
    """Merge keyword arguments into a ``ServingConfig`` (kwargs win)."""
    if config is None:
        return ServingConfig(**kw)
    if not isinstance(config, ServingConfig):
        raise TypeError(f"config must be a ServingConfig, got "
                        f"{type(config).__name__}")
    return dataclasses.replace(config, **kw) if kw else config
