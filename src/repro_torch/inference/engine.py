"""Batched serving engine: bucketed prefill + decode with KV caches.

Prefill bucketing: prompts are right-padded to a power-of-two bucket
(floor 16); after the forward the cache is sanitised to each row's true
length (transformer.truncate_cache) and the logits row at ``length - 1``
is taken, so a bucketed prefill leaves the cache an unpadded prefill
would have (modulo the zeroed tail).  Bucketing is off where right
padding is not a no-op for the live state (``can_bucket_prompts``: RWKV6,
SWA ring buffers).  A ragged batch on a ring whose padded width exceeds
the window is not exact for its shorter rows, as in the reference (the
ring keeps the batch's last window of positions, pads included; ROADMAP
Queue 3).

Resident cache: ``generate`` prefills into the engine's cache for its
batch size (``resident_cache``: made on first use, zeroed by every
prefill into it), so the decode steps of every call write the same
tensors.

Decode: the first token is sampled from the prefill logits, so ``n_new``
tokens need ``n_new - 1`` decode steps.  ``loop="scan"`` runs them back to
back with tokens kept on the device and, as the reference does, buckets
the step count to a power of two (floor 4): surplus steps run and their
tokens are dropped.  The JAX reference fuses them into one ``lax.scan``
(``Engine._decode_loop``); on the card each step here is one replay of
the step's CUDA graph (inference/graphs.py), captured once per batch size
over the resident cache, with sampling eager on its logits; on the CPU
the same step runs eagerly.  ``loop="python"`` runs exactly ``n_new - 1``
eager steps and copies each token to the host, the per-token baseline.
Both give the same tokens.

Throughput accounting: ``decode_steps`` counts the steps EXECUTED and
``tokens_per_s = B * decode_steps / decode_s``, the decode-phase step
throughput (the first token comes from prefill and is not counted).
``decode_dispatches`` counts the step programs the host dispatched, one
a step: a graph replay on the card's scan loop, an eager forward
otherwise (the reference's scan is one dispatch for all its steps).

Sampling: greedy takes the first maximum (as ``jnp.argmax`` does), so
greedy tokens are comparable with the reference.  Sampled decoding draws
Gumbel noise from the port's own ``torch.Generator`` seeded by ``seed``,
over the logits divided by ``temperature``; it cannot reproduce JAX's
threefry bits.  A row's chain is one generator drawn once per token, so
the continuous scheduler (inference/scheduler.py) replays a request's
B=1 chain with a generator of its own.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.inference.config import ServingConfig, resolve_config
from repro_torch.inference.graphs import DecodeGraphs, step_key
from repro_torch.models.attention import RunFlags
from repro_torch.models.transformer import (decode_step, forward, init_cache,
                                            truncate_cache, zero_cache)

PROMPT_BUCKET_FLOOR = 16
STEP_BUCKET_FLOOR = 4


def pow2_bucket(n: int, floor: int = 1) -> int:
    """Smallest power of two >= n (and >= floor)."""
    n = max(int(n), floor)
    return 1 << (n - 1).bit_length()


def can_bucket_prompts(cfg: ArchConfig) -> bool:
    """Right-padded prefill is only sound when pad rows can be masked out
    afterwards: a recurrent (RWKV6) state and an SWA ring buffer absorb
    pad tokens irreversibly."""
    return cfg.rwkv is None and cfg.swa_window == 0


def can_page(cfg: ArchConfig) -> bool:
    """Paged resident caches (``ContinuousEngine(paged=True)``) need every
    per-slot cache leaf to be a page pool or a per-slot scalar: a
    recurrent (RWKV6) state and an SWA ring buffer have no token-row
    geometry to page."""
    return cfg.rwkv is None and cfg.swa_window == 0


def can_quantize(cfg: ArchConfig) -> bool:
    """Mixed-precision serving (ServingConfig select_dtype/kv_quant)
    covers the standard GQA attention cache layout, the same envelope as
    paging: a recurrent (RWKV6) state and an SWA ring buffer carry no
    quantized token rows."""
    return can_page(cfg)


def can_chunk_prefill(cfg: ArchConfig) -> bool:
    """Chunked (interleavable) admission prefill is supported wherever it
    is token-exact against the whole-prompt bucketed prefill: everything
    prompt bucketing covers.  (The reference also leaves out MoE,
    cross-attention and DSA-over-MLA archs, none of which is ported.)"""
    return can_bucket_prompts(cfg)


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray           # (B, n_new) delivered tokens
    prefill_s: float
    decode_s: float
    tokens_per_s: float          # B * decode_steps / decode_s (0 if no steps)
    decode_dispatches: int = 0   # step programs dispatched (see above)
    decode_steps: int = 0        # decode steps EXECUTED (bucketed on scan)


def _sample(logits: torch.Tensor, gen: torch.Generator, greedy: bool,
            temperature: float = 1.0) -> torch.Tensor:
    """Next token from (B, V) logits -> (B, 1) int64.  Greedy draws no
    random numbers.  ``temperature`` scales sampled logits only; 1.0
    divides exactly, so the default is the unscaled chain bit for bit."""
    if greedy:
        return logits.argmax(dim=-1, keepdim=True)
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    gumbel = -torch.log(-torch.log(u))
    return (logits.float() / temperature + gumbel).argmax(dim=-1,
                                                          keepdim=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Engine:
    def __init__(self, cfg: ArchConfig, params, *,
                 config: Optional[ServingConfig] = None, device=None, **kw):
        """``device=None`` means the card (raises without one); pass
        ``device="cpu"`` for the plain PyTorch path.  Keyword arguments
        are ServingConfig fields."""
        c = resolve_config(config, kw)
        if (c.select_dtype != "float32" or c.kv_quant) and \
                not can_quantize(cfg):
            raise ValueError(
                f"select_dtype={c.select_dtype!r}/kv_quant={c.kv_quant!r} "
                f"unsupported for arch {cfg.name!r} (see "
                f"engine.can_quantize)")
        if c.select_dtype != "float32" and not c.long_context:
            raise ValueError("select_dtype quantizes the DSA predicted-key "
                             "caches: it needs long_context=True")
        self.config = c
        self.cfg = cfg
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params are on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.params = params
        self.max_len = c.max_len
        self.loop = c.loop
        self.pad_id = c.pad_id
        self.bucket_prompts = c.prompt_buckets and can_bucket_prompts(cfg)
        self.bucket_steps = c.step_buckets
        self.cache_dtype = c.cache_dtype
        quant = dict(select_dtype=c.select_dtype, kv_quant=c.kv_quant)
        self.prefill_flags = RunFlags(mode="prefill", dsa_mode=c.dsa_mode,
                                      long_context=c.long_context, **quant)
        self.decode_flags = RunFlags(mode="decode", dsa_mode=c.dsa_mode,
                                     long_context=c.long_context, **quant)
        self._caches: Dict[int, Dict] = {}
        self.graphs = (DecodeGraphs(self.device)
                       if self.device.type == "cuda" else None)

    def prompt_bucket(self, prompt_len: int) -> int:
        if not self.bucket_prompts:
            return prompt_len
        return min(pow2_bucket(prompt_len, PROMPT_BUCKET_FLOOR), self.max_len)

    def resident_cache(self, batch: int) -> Dict:
        """The engine's cache of ``batch`` rows of max_len, made on first
        use and kept: ``generate`` prefills into it, and the decode graph
        of that batch size is captured over it."""
        if batch not in self._caches:
            self._caches[batch] = init_cache(
                self.cfg, batch, self.max_len, self.decode_flags,
                dtype=self.cache_dtype, device=self.device)
        return self._caches[batch]

    def scan_step(self, batch: int) -> Callable:
        """The scan loop's decode step over the resident cache of
        ``batch``: ``step(tok (B, 1)) -> logits (B, 1, V)``.  On the card
        a replay of the step's CUDA graph, captured on the first call
        (whose warm-up steps write the cache, so capture before a
        prefill); on the CPU the step run eagerly."""
        caches = self.resident_cache(batch)

        def step(tok, mask=None):
            return decode_step(self.params, self.cfg, self.decode_flags,
                               tok, caches)[0]

        if self.graphs is None:
            return step
        return self.graphs.step(
            step_key(self.cfg, self.decode_flags, batch, paged=False), step,
            caches, batch, masked=False)

    @torch.inference_mode()
    def prefill(self, prompts: np.ndarray,
                lengths: Optional[np.ndarray] = None,
                cache_len: Optional[int] = None, caches: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Dict, float]:
        """Bucketed prefill of a (B, L) prompt batch into ``caches``,
        zeroed first (``generate`` passes the resident cache), or else
        into a fresh cache of ``cache_len`` rows (default the engine's
        max_len; the continuous scheduler passes the prompt bucket and
        zero-extends at slot insertion).  Returns (last_logits (B, 1, V),
        caches, prefill_seconds)."""
        prompts = np.asarray(prompts, np.int32)
        b, s = prompts.shape
        padded = self.prompt_bucket(s)
        if padded > s:
            pad = np.full((b, padded - s), self.pad_id, np.int32)
            prompts = np.concatenate([prompts, pad], 1)
        if lengths is None:
            lengths = np.full((b,), s, np.int32)
        elif self.cfg.rwkv is not None and int(np.min(lengths)) < s:
            raise ValueError(f"{self.cfg.name} is recurrent: its state "
                             f"absorbs pad tokens, so it takes no ragged "
                             f"batch")
        if caches is None:
            caches = init_cache(self.cfg, b, cache_len or self.max_len,
                                self.decode_flags, dtype=self.cache_dtype,
                                device=self.device)
        else:
            zero_cache(caches)
        toks = torch.as_tensor(prompts, device=self.device)
        lens = torch.as_tensor(np.asarray(lengths, np.int64),
                               device=self.device)
        _sync(self.device)
        t0 = time.monotonic()
        logits, caches = forward(self.params, self.cfg, self.prefill_flags,
                                 toks, caches)
        truncate_cache(self.cfg, caches, lens)
        last = logits[torch.arange(b, device=self.device), lens - 1][:, None]
        _sync(self.device)
        return last, caches, time.monotonic() - t0

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, n_new: int, greedy: bool = True,
                 seed: int = 0, lengths: Optional[np.ndarray] = None,
                 temperature: float = 1.0) -> GenerationResult:
        """``lengths`` (B,): per-row true prompt lengths of a right-padded
        ragged batch; each row prefills and decodes at its own depth.
        ``temperature`` scales sampled (non-greedy) logits."""
        if n_new < 1:
            raise ValueError("generate() needs n_new >= 1")
        prompts = np.asarray(prompts, np.int32)
        plen = (prompts.shape[1] if lengths is None
                else int(np.max(lengths)))
        if plen == 0 or (lengths is not None and int(np.min(lengths)) < 1):
            raise ValueError("empty prompt: decode needs at least one "
                             "context token per row")
        if plen + n_new > self.max_len:
            raise ValueError(
                f"prompt_len ({plen}) + n_new ({n_new}) exceeds the engine "
                f"max_len ({self.max_len})")
        b = prompts.shape[0]
        scan = self.loop == "scan"
        steps_exec = n_new - 1
        if scan and self.bucket_steps and steps_exec:
            steps_exec = pow2_bucket(steps_exec, STEP_BUCKET_FLOOR)
        caches = self.resident_cache(b)
        # the step (and its graph's capture) comes before the prefill,
        # which zeroes what a capture's warm-up steps wrote
        step = self.scan_step(b) if scan and steps_exec else None
        logits, caches, t_prefill = self.prefill(prompts, lengths=lengths,
                                                 caches=caches)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        t0 = time.monotonic()
        tok = _sample(logits[:, -1], gen, greedy, temperature)
        out: List[torch.Tensor] = [tok]
        for _ in range(steps_exec):
            if scan:
                logits = step(tok)
            else:
                logits, caches = decode_step(self.params, self.cfg,
                                             self.decode_flags, tok, caches)
            tok = _sample(logits[:, -1], gen, greedy, temperature)
            if not scan:                       # host round trip per token
                tok = tok.cpu().to(self.device)
            out.append(tok)
        toks = torch.cat([t.cpu() for t in out], dim=1)[:, :n_new]
        _sync(self.device)
        t_decode = time.monotonic() - t0
        tps = b * steps_exec / max(t_decode, 1e-9) if steps_exec else 0.0
        return GenerationResult(toks.numpy().astype(np.int32), t_prefill,
                                t_decode, tps, decode_dispatches=steps_exec,
                                decode_steps=steps_exec)
