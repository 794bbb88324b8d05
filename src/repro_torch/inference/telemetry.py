"""Serving telemetry: request spans, Chrome-trace timelines, metrics
export, compile events, and dynamic-sparsity observability (the port's
own copy of the reference's ``repro.inference.telemetry``; the metric
names and labels are the reference's, letter for letter, so a dashboard
built on its Prometheus text reads the port's).

A ``Telemetry`` object hangs off ``ServingConfig.telemetry`` (default
``None``).  ``None`` is BITWISE-INERT: no signature is recorded, no
hook runs, and the engines behave byte-identically to a build without
this module.  With telemetry enabled there are four layers:

  request spans      every ``Request`` gets timestamped lifecycle events
                     (submit -> first token -> retire-with-status) and
                     the engine emits chunk-burst / decode-segment /
                     spec-verify / admission / fault events into a
                     bounded ring buffer, exportable as Chrome
                     trace-event JSON (load in Perfetto or
                     chrome://tracing).
  metrics registry   counters / gauges / histograms (per-status request
                     counts, delivered tokens, TTFT, latency, segment
                     and chunk-burst timing, queue depth, slot
                     occupancy, PagePool free pages, faults, watchdog
                     stalls) with Prometheus text-exposition export.
                     The registry is fed from the SAME code paths that
                     feed ``stats``/``summarize()`` (``_emit`` is the
                     single retirement path) and the export refreshes
                     gauges from ``health()`` of the bound engine, so
                     the three surfaces cannot disagree.
  compile events     each eager entry point of the port calls ``note``
                     with its arguments before it runs (the reference
                     wraps its jitted programs instead): every distinct
                     (program, shape/dtype signature) is recorded with a
                     timestamp + trace event, the point where the
                     reference compiles; and ``on_capture`` records each
                     CUDA-graph capture (inference/graphs.py) as a
                     compile event named after its program, with its
                     key, capture ms and pool bytes.  A program that
                     runs as a graph on the card is recorded at its
                     capture there and by ``note`` on the CPU, so both
                     count one event per program and key.  The
                     recompilation contract becomes a live metric
                     (tests/test_torch_telemetry.py).
  sparsity sampling  once per ``sample_every`` decode segments the
                     scheduler runs one decode step eagerly with
                     ``RunFlags.sel_probe`` set and reads back the DSA
                     block selection (``(idx, ok, kv_len)`` a layer),
                     recording per-slot keep-rate, selected-block churn
                     between samples, and cross-layer selection overlap
                     — the input-dependent sparsity the paper claims,
                     observable per workload.  The step writes the
                     resident cache in place, so the engine saves what
                     it will overwrite and puts it back
                     (``ContinuousEngine._sparsity_probe``).  Only a
                     step that selects blocks is sampled (``probe_ok``:
                     DSA on the block or kernel path of a long-context
                     cache; not MLA, whose decode selects nothing).

Overhead discipline: every hook is host-side and O(events); signature
hashing walks leaf shapes/dtypes only (no device sync); the probe is the
only extra device work and it is sampled.  The reference gates its
traced-vs-untraced goodput ratio at >= 0.95 on its own benchmark;
``chip_smoke.py`` phase 15b prints the port's.

Trace timestamps use the telemetry object's own monotonic epoch (first
event = t0), independent of the engine's serve clock, so engine events
and request spans share one timeline.

``reset()`` (called from ``ContinuousEngine.reset()``) clears events,
spans, and metrics but KEEPS the compile log: compiled programs survive
an engine reset, so their record must too.
"""
from __future__ import annotations

import json
import time
import weakref
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "Telemetry"]

# default histogram bucket bounds (seconds / ratios)
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
RATE_BUCKETS = tuple(round(0.1 * i, 1) for i in range(1, 11))


# ---------------------------------------------------------------------------
# metrics


class Counter:
    """Monotonic counter."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bound histogram (Prometheus cumulative-bucket semantics)."""

    __slots__ = ("bounds", "counts", "count", "sum")

    def __init__(self, bounds: Tuple[float, ...] = LATENCY_BUCKETS):
        self.bounds = tuple(bounds)
        self.counts = [0] * len(self.bounds)   # per-bound, NOT cumulative
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.counts[i] += 1
                break

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class MetricsRegistry:
    """Name+labels -> metric store with Prometheus text exposition."""

    def __init__(self):
        self._metrics: Dict[tuple, Any] = {}
        self._kind: Dict[str, str] = {}

    def _get(self, kind, name, labels, factory):
        key = (name, tuple(sorted(labels.items())))
        m = self._metrics.get(key)
        if m is None:
            m = self._metrics[key] = factory()
            self._kind.setdefault(name, kind)
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(self, name: str, bounds: Tuple[float, ...] =
                  LATENCY_BUCKETS, **labels) -> Histogram:
        return self._get("histogram", name, labels,
                         lambda: Histogram(bounds))

    def value(self, name: str, **labels):
        """Current value (Counter/Gauge: float, Histogram: (count, mean));
        0 for a metric that was never touched."""
        m = self._metrics.get((name, tuple(sorted(labels.items()))))
        if m is None:
            return (0, 0.0) if self._kind.get(name) == "histogram" else 0.0
        if isinstance(m, Histogram):
            return (m.count, m.mean)
        return m.value

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (one snapshot)."""
        out: List[str] = []
        seen_type = set()
        for (name, labels), m in sorted(self._metrics.items()):
            if name not in seen_type:
                out.append(f"# TYPE {name} {self._kind[name]}")
                seen_type.add(name)
            lab = ",".join(f'{k}="{v}"' for k, v in labels)
            if isinstance(m, Histogram):
                pre = f"{name}_bucket{{{lab}," if lab else f"{name}_bucket{{"
                cum = 0
                for b, c in zip(m.bounds, m.counts):
                    cum += c
                    out.append(f'{pre}le="{b}"}} {cum}')
                out.append(f'{pre}le="+Inf"}} {m.count}')
                suf = f"{{{lab}}}" if lab else ""
                out.append(f"{name}_sum{suf} {m.sum}")
                out.append(f"{name}_count{suf} {m.count}")
            else:
                suf = f"{{{lab}}}" if lab else ""
                out.append(f"{name}{suf} {m.value}")
        return "\n".join(out) + "\n"

    def reset(self) -> None:
        self._metrics.clear()
        self._kind.clear()


# ---------------------------------------------------------------------------
# compile watching


def probe_ok(cfg, flags) -> bool:
    """Whether a decode step under ``flags`` makes a block selection for
    the sparsity probe to sample: DSA on the block or kernel path of a
    long-context cache, and not over MLA (whose latent cache holds no
    predicted keys: its decode attends every row).  The reference's gate
    (its ``_sparsity_probe``) is this one without ``cfg.dsa.enabled``,
    and fails on an arch that has no DSA layer (ROADMAP Queue 3)."""
    return (cfg.dsa.enabled and cfg.mla is None and flags.long_context
            and flags.dsa_mode in ("block", "kernel"))


def _leaves(x, out: list) -> list:
    """The leaves of nested dicts (in sorted key order),
    lists and tuples."""
    if isinstance(x, dict):
        for k in sorted(x):
            _leaves(x[k], out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _leaves(v, out)
    else:
        out.append(x)
    return out


def _leaf_sig(x) -> Any:
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return (tuple(x.shape), str(x.dtype).replace("torch.", ""))
    if isinstance(x, (int, float)) and not isinstance(x, bool):
        # a runtime scalar (the reference passes these as device scalars,
        # which never recompile by value)
        return type(x).__name__
    return repr(x)


def _signature(args, kwargs) -> tuple:
    """Host-side call signature: leaf shapes/dtypes + the reprs of the
    other arguments.  Never reads a device value."""
    return tuple(_leaf_sig(x) for x in _leaves((args, kwargs), []))


# ---------------------------------------------------------------------------
# telemetry


class Telemetry:
    """See module docstring.  ``sample_every=0`` disables the sparsity
    probe; events beyond ``max_events`` evict the oldest (ring)."""

    def __init__(self, *, sample_every: int = 16, max_events: int = 65536):
        self.sample_every = int(sample_every)
        self.metrics = MetricsRegistry()
        self.events: deque = deque(maxlen=int(max_events))
        self.compiles: List[Tuple[str, tuple, float]] = []
        self._t0: Optional[float] = None
        self._spans: Dict[int, float] = {}      # rid -> submit ts (s)
        self._seen: Dict[str, set] = {}         # program -> signatures
        self._engine: Any = None                # weakref to the engine

    # -- clock / raw events -------------------------------------------------

    def now(self) -> float:
        """Seconds since this Telemetry's first event (own epoch)."""
        t = time.monotonic()
        if self._t0 is None:
            self._t0 = t
        return t - self._t0

    def _ev(self, name, ph, ts, pid, tid, dur=None, args=None):
        e = {"name": name, "ph": ph, "ts": ts * 1e6, "pid": pid,
             "tid": tid}
        if dur is not None:
            e["dur"] = dur * 1e6
        if args:
            e["args"] = args
        self.events.append(e)

    def instant(self, name, *, pid="engine", tid="events", args=None):
        e = {"name": name, "ph": "i", "s": "t", "ts": self.now() * 1e6,
             "pid": pid, "tid": tid}
        if args:
            e["args"] = args
        self.events.append(e)

    def complete(self, name, ts, dur, *, pid="engine", tid="events",
                 args=None):
        self._ev(name, "X", ts, pid, tid, dur=max(dur, 0.0), args=args)

    # -- request lifecycle --------------------------------------------------

    def on_submit(self, rid: int, queued: int) -> None:
        t = self.now()
        self._spans[rid] = t
        self.metrics.counter("serving_submitted_total").inc()
        self.metrics.gauge("serving_queue_depth").set(queued)
        self._ev("submit", "i", t, "requests", f"rid {rid}")
        self.events[-1]["s"] = "t"

    def on_first_token(self, rid: int) -> None:
        t = self.now()
        t0 = self._spans.get(rid)
        if t0 is not None:
            self.metrics.histogram("serving_ttft_seconds").observe(t - t0)
        self._ev("first_token", "i", t, "requests", f"rid {rid}")
        self.events[-1]["s"] = "t"

    def on_retire(self, res) -> None:
        """Called from the engine's single retirement path (``_emit``)
        for EVERY result, so per-status counters match ``summarize()``
        by construction."""
        t = self.now()
        t0 = self._spans.pop(res.rid, t)
        self.metrics.counter("serving_requests_total",
                             status=res.status).inc()
        if res.status == "ok":
            self.metrics.counter("serving_tokens_delivered_total").inc(
                len(res.tokens))
            self.metrics.histogram("serving_request_latency_seconds"
                                   ).observe(res.latency_s)
        self.complete(f"req {res.rid} [{res.status}]", t0, t - t0,
                      pid="requests", tid=f"rid {res.rid}",
                      args={"status": res.status,
                            "prompt_len": int(res.prompt_len),
                            "tokens": len(res.tokens),
                            "ttft_s": res.ttft_s})

    # -- engine timeline ----------------------------------------------------

    def on_admission(self, ts, dur_s, n, bucket, mode, kind,
                     prefix_skip_chunks=0) -> None:
        self.metrics.counter("serving_admissions_total", kind=kind).inc(n)
        args = {"n": n, "bucket": int(bucket), "mode": mode}
        if prefix_skip_chunks:
            args["prefix_skip_chunks"] = int(prefix_skip_chunks)
        if dur_s > 0:
            self.complete(f"admit[{kind}] x{n}", ts, dur_s,
                          tid="admission", args=args)
        else:
            self.instant(f"admit[{kind}] x{n}", tid="admission", args=args)

    def on_chunk_burst(self, dur_s, chunks, bucket, mode, members) -> None:
        self.metrics.counter("serving_chunks_total").inc(chunks)
        self.metrics.histogram("serving_chunk_burst_seconds").observe(dur_s)
        self.complete(f"chunk_burst x{chunks}", self.now() - dur_s, dur_s,
                      tid="admission",
                      args={"chunks": chunks, "bucket": int(bucket),
                            "mode": mode, "members": members})

    def on_segment(self, kind, dur_s, *, mode, active, tokens, queued,
                   resident, pool_free=None, slow=False, rounds=0) -> None:
        m = self.metrics
        m.counter("serving_segments_total", kind=kind).inc()
        m.counter("serving_segment_tokens_total").inc(tokens)
        m.histogram("serving_segment_seconds").observe(dur_s)
        m.gauge("serving_queue_depth").set(queued)
        m.gauge("serving_resident_slots").set(resident)
        if pool_free is not None:
            m.gauge("serving_pool_free_pages").set(pool_free)
        if slow:
            m.counter("serving_watchdog_slow_total").inc()
        if rounds:
            m.counter("serving_spec_rounds_total").inc(rounds)
        args = {"mode": mode, "active": int(active), "tokens": int(tokens)}
        if rounds:
            args["verify_rounds"] = int(rounds)
        if slow:
            args["watchdog_slow"] = True
        self.complete(kind, self.now() - dur_s, dur_s, tid="segments",
                      args=args)

    def on_fault(self, point: str, rid=None) -> None:
        self.metrics.counter("serving_faults_total", point=point).inc()
        self.instant(f"fault[{point}]", tid="faults",
                     args={"rid": rid} if rid is not None else None)

    def on_error(self, msg: str) -> None:
        self.metrics.counter("serving_errors_total").inc()
        self.instant("error", tid="faults", args={"error": msg[:200]})

    # -- compile events -----------------------------------------------------

    def note(self, program: str, *args, **kwargs) -> None:
        """A call of the eager entry point ``program`` with these
        arguments: a compile event when its shape signature is new
        (host-side only; no device value is read)."""
        sig = _signature(args, kwargs)
        seen = self._seen.setdefault(program, set())
        if sig not in seen:
            seen.add(sig)
            self._record_compile(program, sig)

    def on_capture(self, program: str, key: tuple, capture_ms: float,
                   pool_bytes: int) -> None:
        """A CUDA-graph capture of ``program`` under graph ``key``: the
        card's compile event."""
        self._record_compile(program, tuple(key),
                             {"key": repr(tuple(key)),
                              "capture_ms": float(capture_ms),
                              "pool_bytes": int(pool_bytes)})

    def _record_compile(self, program: str, sig: tuple,
                        extra: Optional[dict] = None) -> None:
        t = self.now()
        self.compiles.append((program, sig, t))
        self.metrics.counter("serving_compiles_total", program=program).inc()
        args = {"program": program, "n_leaves": len(sig)}
        if extra:
            args.update(extra)
        self.instant(f"compile[{program}]", tid="compiles", args=args)

    def compile_count(self, program: Optional[str] = None) -> int:
        if program is None:
            return len(self.compiles)
        return sum(1 for p, _, _ in self.compiles if p == program)

    def compile_log(self) -> List[Tuple[str, tuple, float]]:
        return list(self.compiles)

    # -- dynamic sparsity ---------------------------------------------------

    def on_sparsity_sample(self, segment: int, samples) -> None:
        """``samples``: (slot, rid, keep_rate, churn|None, overlap|None)
        per active slot, from one sel_probe step."""
        if not samples:
            return
        m = self.metrics
        m.counter("serving_sparsity_samples_total").inc()
        keeps = []
        for slot, rid, keep, churn, overlap in samples:
            keeps.append(keep)
            m.histogram("serving_dsa_keep_rate", RATE_BUCKETS).observe(keep)
            if churn is not None:
                m.histogram("serving_dsa_block_churn",
                            RATE_BUCKETS).observe(churn)
            if overlap is not None:
                m.histogram("serving_dsa_layer_overlap",
                            RATE_BUCKETS).observe(overlap)
        self.instant("dsa_sample", tid="sparsity",
                     args={"segment": int(segment),
                           "slots": len(samples),
                           "mean_keep_rate": sum(keeps) / len(keeps)})

    # -- export -------------------------------------------------------------

    def bind_engine(self, engine) -> None:
        """Bind the ContinuousEngine whose ``health()`` snapshot is
        mirrored into gauges at export time.  Held by a weak reference:
        the engine holds its Telemetry, and no cycle keeps either alive."""
        self._engine = weakref.ref(engine)

    def _refresh_health_gauges(self) -> None:
        engine = None if self._engine is None else self._engine()
        if engine is None:
            return
        for k, v in engine.health().items():
            if isinstance(v, bool):
                v = int(v)
            if isinstance(v, (int, float)):
                self.metrics.gauge(f"serving_health_{k}").set(float(v))

    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON object (perfetto-loadable)."""
        meta = []
        pids = {e["pid"] for e in self.events}
        for pid in sorted(pids, key=str):
            meta.append({"name": "process_name", "ph": "M", "pid": pid,
                         "tid": 0, "args": {"name": str(pid)}})
        tids = sorted({(e["pid"], e["tid"]) for e in self.events},
                      key=str)
        for pid, tid in tids:
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid, "args": {"name": str(tid)}})
        return {"traceEvents": meta + list(self.events),
                "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)

    def prometheus_text(self) -> str:
        self._refresh_health_gauges()
        return self.metrics.to_prometheus()

    def write_prometheus(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.prometheus_text())

    # -- lifecycle ----------------------------------------------------------

    def reset(self) -> None:
        """Clear metrics, events, and spans (compile log survives: the
        compiled programs do too)."""
        self.metrics.reset()
        self.events.clear()
        self._spans.clear()
