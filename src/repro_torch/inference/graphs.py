"""CUDA graphs of the decode step: the port's counterpart of the
reference's compiled decode programs.

The JAX reference runs each decode program as one compiled dispatch: the
static engine's ``Engine._decode_loop`` (``repro/inference/engine.py``),
a jitted ``lax.scan`` of ``decode_step`` and sampling, and the continuous
engine's ``_segment`` (``repro/inference/scheduler.py``), a jitted scan
of ``seg_len`` masked steps.  Eager PyTorch issues every kernel of every
step from Python instead, some 6,000 launches a full-width yi_6b step,
and the host takes longer to issue them than the card takes to run them.
Here one decode step's forward (``transformer.decode_step``) is captured
once as a CUDA graph and replayed: one host call a step.

What is captured: the forward from static input buffers, the tokens
``tok`` (B, 1) and, for the continuous engine, the slot mask (B,), to a
static logits buffer (B, 1, V), over one resident cache.  The step writes
the cache in place and never replaces a leaf (models/attention.py), so
the addresses the graph holds stay the cache's.  Sampling stays outside
the graph, eager on the static logits: a slot's ``torch.Generator``
advances only on the slot's active steps, which a captured draw would
not honour, and sampling is a handful of kernels against the forward's
thousands.

Capture (``DecodeGraphs.step``) runs ``WARMUP_STEPS`` eager steps on the
capture stream first.  They do the first-call host work there: the
kernels' build, ctypes binding and shared-memory opt-in, cuBLAS's
workspace for that stream, and the decode kernels' ticket workspace,
which the wrapper keeps per stream (zeroed now, reset to zero by every
launch, and held by the graph for its life).  The warm-up steps write the
cache as any step does: the static engine captures before its prefill,
which zeroes the cache, and a masked step with no active row changes
nothing.  Their launches are set-up, so they are taken off the kernels'
launch counters; each replay adds the launches the capture recorded
(``kernels/_launch.py``), so the counts read as if every step were
eager.  A failed capture raises: a CUDA engine never runs these steps
eagerly.

One graph per key (batch, cache layout, K/V quantization, selection
dtype, DSA mode, ring window, arch).  The graphs of one engine share one
memory pool: they never run at once, and every replay's logits are read
before the next replay.  Every engine captures on one stream per device:
what the first calls on a stream create and keep for the process's life
(cuBLAS's workspace) then exists once, not once an engine.
CUDA graphs exist only on the card; on the CPU the engines run the same
step eagerly.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import _launch as LN
from repro_torch.kernels import dsa_decode
from repro_torch.models.attention import RunFlags

WARMUP_STEPS = 2
_CAPTURE_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}


def step_key(cfg: ArchConfig, flags: RunFlags, batch: int,
             paged: bool) -> tuple:
    """The key of a decode step's graph.  ``flags.decode_window`` sets
    the cache's length, so two windows never share a graph."""
    return (batch, "paged" if paged else "dense", flags.kv_quant,
            flags.select_dtype, flags.dsa_mode, flags.decode_window,
            cfg.name)


class StepGraph:
    """One captured decode step: ``graph`` replays it (a
    ``torch.cuda.CUDAGraph``) from the static inputs ``tok`` and ``mask``
    (None: an unmasked step) into the static ``logits``; each replay
    launches ``launches`` (counts in ``_launch.COUNTERS`` order).
    ``caches`` is the cache it was captured on and ``held`` the buffers
    it reads that no tensor of the caller keeps alive."""

    def __init__(self, graph, tok: torch.Tensor, mask: Optional[torch.Tensor],
                 logits: torch.Tensor, launches, caches, held=(),
                 capture_ms: float = 0.0, pool_bytes: int = 0):
        self.graph = graph
        self.tok = tok
        self.mask = mask
        self.logits = logits
        self.launches = list(launches)
        self.caches = caches
        self.held = tuple(held)
        self.capture_ms = capture_ms
        self.pool_bytes = pool_bytes
        self.replays = 0

    @torch.inference_mode()
    def __call__(self, tok: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One step on ``tok`` (B, 1) and, for a masked graph, ``mask``
        (B,) bool: returns the static logits (B, 1, V), overwritten by the
        next replay."""
        if (mask is None) != (self.mask is None):
            raise ValueError("a masked step graph takes a mask, an "
                             "unmasked one none")
        self.tok.copy_(tok)
        if mask is not None:
            self.mask.copy_(mask)
        self.graph.replay()
        LN.add_counts(self.launches)
        self.replays += 1
        return self.logits


class DecodeGraphs:
    """The captured decode steps of one engine, one per key, sharing one
    memory pool; captured on the device's capture stream."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        if device not in _CAPTURE_STREAMS:
            _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
        self.stream = _CAPTURE_STREAMS[device]
        self.graphs: Dict[tuple, StepGraph] = {}
        self.captures = 0
        self._dropped_replays = 0

    @property
    def replays(self) -> int:
        """Replays over this object's life, dropped graphs included."""
        return self._dropped_replays + sum(g.replays
                                           for g in self.graphs.values())

    @property
    def pool_bytes(self) -> int:
        """Device memory the live graphs' captures reserved."""
        return sum(g.pool_bytes for g in self.graphs.values())

    def clear(self) -> None:
        """Drop every graph (the cache they were captured on is going)."""
        self._dropped_replays = self.replays
        self.graphs.clear()

    def step(self, key: tuple, fn: Callable, caches, batch: int,
             masked: bool) -> StepGraph:
        """The graph of ``key``, captured now if there is none: ``fn(tok,
        mask)`` is the eager step over ``caches`` returning (B, 1, V)
        logits, with ``mask`` None unless ``masked``."""
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = self._capture(fn, caches, batch, masked)
            self.captures += 1
        elif g.caches is not caches:
            raise RuntimeError(f"the decode graph {key} was captured on "
                               f"another cache")
        return g

    @torch.inference_mode()
    def _capture(self, fn: Callable, caches, batch: int,
                 masked: bool) -> StepGraph:
        dev = self.device
        tok = torch.zeros((batch, 1), dtype=torch.long, device=dev)
        mask = (torch.zeros((batch,), dtype=torch.bool, device=dev)
                if masked else None)
        torch.cuda.synchronize(dev)
        t0 = time.monotonic()
        before = LN.read_counts()
        self.stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self.stream):
            for _ in range(WARMUP_STEPS):
                fn(tok, mask)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        warm = LN.read_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            logits = fn(tok, mask)
        torch.cuda.synchronize(dev)
        after = LN.read_counts()
        # nothing has launched from the warm-up's and the capture's calls
        # but the warm-up steps; every replay adds the captured launches
        LN.add_counts([b - a for a, b in zip(after, before)])
        launches = [a - w for a, w in zip(after, warm)]
        ws = dsa_decode.stream_workspace(dev, self.stream.cuda_stream)
        return StepGraph(graph, tok, mask, logits, launches, caches,
                         held=() if ws is None else (ws,),
                         capture_ms=(time.monotonic() - t0) * 1e3,
                         pool_bytes=torch.cuda.memory_reserved(dev)
                         - reserved)
