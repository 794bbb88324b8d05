"""Fault injection for the serving engine (chaos testing): the port's own
copy of the reference's ``repro.inference.faults``.

A ``FaultInjector`` holds a schedule of armed ``Fault``s, each naming one
of the engine's ``FAULT_POINTS``; the ``ContinuousEngine`` consults the
injector at each point (``take``) and, when a fault fires, reproduces the
failure a production deployment would see — NaN logits on one slot's
row, an exhausted page pool, a crashing draft proposer, a stalled
segment, a failed device dispatch.  The injector itself is pure host
bookkeeping: with no injector armed (the default) every consult is a
no-op.  The one device-visible hook, the nan_logits poison, is applied
to a step's logits outside the step's CUDA graph and only in a segment
where a fault fired, so serving without an injector runs exactly the
steps it ran before.

Fault points:

  nan_logits    poison the target slot's decode-logits row with NaN for
                one segment step.  The engine detects the non-finite row
                on the device, fails ONLY that slot (status ``failed``,
                partial tokens surfaced, slot scrubbed like a normal
                retirement) and leaves co-resident slots bitwise intact.
  pool_exhaust  admission sees ``PagePool.available() == 0`` for one
                attempt — exercises the unfundable-anchor bounded
                retry/backoff/shed path.
  proposer      the draft proposer raises on its next ``propose()`` —
                the speculative segment degrades to plain decode (same
                tokens, spec == plain is bitwise); repeated failures trip
                ``spec_degraded`` and stop consulting the proposer.
  slow_segment  the next segment stalls ``delay_s`` seconds host-side
                before dispatch — trips the StepWatchdog.
  dispatch      the next segment dispatch fails before launch.  This is
                the transient flavor: state is untouched and the segment
                simply retries on the next scheduler iteration.  (A real
                exception thrown by the dispatched computation is also
                handled — the resident cache, written in place, can no
                longer be trusted, so every in-flight request fails and
                the cache is rebuilt; see ``ContinuousEngine._scrub_all``.)
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

FAULT_POINTS = ("nan_logits", "pool_exhaust", "proposer", "slow_segment",
                "dispatch")


class FaultError(RuntimeError):
    """Raised at an injected fault point (e.g. the proposer crash)."""


@dataclasses.dataclass
class Fault:
    """One armed fault: fires at ``point``, after skipping the first
    ``after`` matching opportunities, ``count`` times total.  ``rid``
    narrows row-targeted points (nan_logits) to one request (None matches
    any); ``delay_s`` is the injected stall for slow_segment."""

    point: str
    rid: Optional[int] = None
    after: int = 0
    count: int = 1
    delay_s: float = 0.0

    def __post_init__(self):
        if self.point not in FAULT_POINTS:
            raise ValueError(f"Fault.point={self.point!r} is not a known "
                             f"fault point; valid: {FAULT_POINTS}")


class FaultInjector:
    """Consumable fault schedule, threaded through
    ``ServingConfig.injector`` or assigned to ``engine.injector``
    directly (tests swap it between runs on one engine — the injector
    never enters a captured graph)."""

    def __init__(self, *faults: Fault):
        self.faults = list(faults)
        self.fired: List[Tuple[str, Optional[int]]] = []
        # optional Telemetry; the engine wires its own in before each
        # consult so every fired fault lands on the trace timeline
        self.telemetry = None

    def take(self, point: str, rid: Optional[int] = None
             ) -> Optional[Fault]:
        """Return the armed fault firing at this (point, rid) opportunity,
        or None.  ``after``/``count`` are consumed per MATCHING
        opportunity only, so a rid-targeted fault ignores other slots."""
        for f in self.faults:
            if f.point != point or f.count <= 0:
                continue
            if f.rid is not None and rid is not None and f.rid != rid:
                continue
            if f.after > 0:
                f.after -= 1
                continue
            f.count -= 1
            self.fired.append((point, rid))
            if self.telemetry is not None:
                self.telemetry.on_fault(point, rid)
            return f
        return None
