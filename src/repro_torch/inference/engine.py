"""Batched serving engine: bucketed prefill + decode with KV caches.

Prefill bucketing: prompts are right-padded to a power-of-two bucket
(floor 16); after the forward the cache is sanitised to each row's true
length (transformer.truncate_cache) and the logits row at ``length - 1``
is taken, so a bucketed prefill leaves the cache an unpadded prefill
would have (modulo the zeroed tail).

Decode: the first token is sampled from the prefill logits, so ``n_new``
tokens need ``n_new - 1`` decode steps.  ``loop="scan"`` runs them back to
back with tokens kept on the device (the JAX reference fuses them into one
``lax.scan``; here it is a Python loop over steps with no host sync
inside), and, as the reference does, bucket the step count to a power of
two (floor 4): surplus steps run and their tokens are dropped.
``loop="python"`` runs exactly ``n_new - 1`` steps and copies each token
to the host, the per-token baseline.  Both give the same tokens.

Throughput accounting: ``decode_steps`` counts the steps EXECUTED and
``tokens_per_s = B * decode_steps / decode_s``, the decode-phase step
throughput (the first token comes from prefill and is not counted).

Sampling: greedy takes the first maximum (as ``jnp.argmax`` does), so
greedy tokens are comparable with the reference.  Sampled decoding draws
Gumbel noise from the port's own ``torch.Generator`` seeded by ``seed``;
it cannot reproduce JAX's threefry bits.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.inference.config import ServingConfig, resolve_config
from repro_torch.models.attention import RunFlags
from repro_torch.models.transformer import (decode_step, forward, init_cache,
                                            truncate_cache)

PROMPT_BUCKET_FLOOR = 16
STEP_BUCKET_FLOOR = 4


def pow2_bucket(n: int, floor: int = 1) -> int:
    """Smallest power of two >= n (and >= floor)."""
    n = max(int(n), floor)
    return 1 << (n - 1).bit_length()


def can_bucket_prompts(cfg: ArchConfig) -> bool:
    """Right-padded prefill is sound when pad rows can be masked out
    afterwards: not under an SWA ring buffer."""
    return cfg.swa_window == 0


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray           # (B, n_new) delivered tokens
    prefill_s: float
    decode_s: float
    tokens_per_s: float          # B * decode_steps / decode_s (0 if no steps)
    decode_dispatches: int = 0   # host round trips for decode (scan: 1)
    decode_steps: int = 0        # decode steps EXECUTED (bucketed on scan)


def _sample(logits: torch.Tensor, gen: torch.Generator,
            greedy: bool) -> torch.Tensor:
    """Next token from (B, V) logits -> (B, 1) int64.  Greedy draws no
    random numbers."""
    if greedy:
        return logits.argmax(dim=-1, keepdim=True)
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    gumbel = -torch.log(-torch.log(u))
    return (logits.float() + gumbel).argmax(dim=-1, keepdim=True)


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
        if c.dsa_mode == "faithful":
            raise NotImplementedError(
                "dsa_mode='faithful' is not ported to repro_torch yet")
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
        self.prefill_flags = RunFlags(mode="prefill", dsa_mode=c.dsa_mode,
                                      long_context=c.long_context)
        self.decode_flags = RunFlags(mode="decode", dsa_mode=c.dsa_mode,
                                     long_context=c.long_context)

    def prompt_bucket(self, prompt_len: int) -> int:
        if not self.bucket_prompts:
            return prompt_len
        return min(pow2_bucket(prompt_len, PROMPT_BUCKET_FLOOR), self.max_len)

    @torch.inference_mode()
    def prefill(self, prompts: np.ndarray,
                lengths: Optional[np.ndarray] = None
                ) -> Tuple[torch.Tensor, Dict, float]:
        """Bucketed prefill of a (B, L) prompt batch into a fresh cache.
        Returns (last_logits (B, 1, V), caches, prefill_seconds)."""
        prompts = np.asarray(prompts, np.int32)
        b, s = prompts.shape
        padded = self.prompt_bucket(s)
        if padded > s:
            pad = np.full((b, padded - s), self.pad_id, np.int32)
            prompts = np.concatenate([prompts, pad], 1)
        if lengths is None:
            lengths = np.full((b,), s, np.int32)
        caches = init_cache(self.cfg, b, self.max_len, self.decode_flags,
                            dtype=self.cache_dtype, device=self.device)
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
                 seed: int = 0, lengths: Optional[np.ndarray] = None
                 ) -> GenerationResult:
        """``lengths`` (B,): per-row true prompt lengths of a right-padded
        ragged batch; each row prefills and decodes at its own depth."""
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
        logits, caches, t_prefill = self.prefill(prompts, lengths=lengths)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        t0 = time.monotonic()
        tok = _sample(logits[:, -1], gen, greedy)
        out: List[torch.Tensor] = [tok]
        scan = self.loop == "scan"
        steps_exec = n_new - 1
        if scan and self.bucket_steps and steps_exec:
            steps_exec = pow2_bucket(steps_exec, STEP_BUCKET_FLOOR)
        for _ in range(steps_exec):
            logits, caches = decode_step(self.params, self.cfg,
                                         self.decode_flags, tok, caches)
            tok = _sample(logits[:, -1], gen, greedy)
            if not scan:                       # host round trip per token
                tok = tok.cpu().to(self.device)
            out.append(tok)
        dispatches = min(steps_exec, 1) if scan else steps_exec
        toks = torch.cat([t.cpu() for t in out], dim=1)[:, :n_new]
        _sync(self.device)
        t_decode = time.monotonic() - t0
        tps = b * steps_exec / max(t_decode, 1e-9) if steps_exec else 0.0
        return GenerationResult(toks.numpy().astype(np.int32), t_prefill,
                                t_decode, tps, decode_dispatches=dispatches,
                                decode_steps=steps_exec)
