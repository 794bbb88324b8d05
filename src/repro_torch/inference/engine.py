"""Batched serving engine: bucketed prefill + decode with KV caches.

Prefill bucketing: prompts are right-padded to a power-of-two bucket
(floor 16); after the forward the cache is sanitised to each row's true
length (transformer.truncate_cache) and the logits row at ``length - 1``
is taken, so a bucketed prefill leaves the cache an unpadded prefill
would have (modulo the zeroed tail).  Bucketing is off where right
padding is not a no-op for the live state (``can_bucket_prompts``: the
recurrent archs, RWKV6 and Mamba hybrids, SWA ring buffers, and
encoder-decoders, whose decoder positions run over the padded length).  A
ragged batch on a ring whose padded width exceeds the window is not
exact for its shorter rows, as in the reference (the ring keeps the
batch's last window of positions, pads included; ROADMAP Queue 3).

Encoder-decoder and cross-attention archs (whisper_small,
llama_3_2_vision): ``prefill`` and ``generate`` take ``extras``, numpy
arrays {"enc_x": (B, enc_seq_len, d)} or {"img": (B, n_image_tokens, d)}
(the reference's batch extras), which the prefill encodes (whisper) and
writes into the cross sub-layers' ``ck``/``cv``; the decode steps read
those.  Without extras prefill skips the cross sub-layers and decode
attends the zeroed ``ck``/``cv``, as in the reference.

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

Per-call DSA modes: ``prefill``, ``generate`` and ``scan_step`` take a
``dsa_mode`` override (``run_flags``) over the engine's cache layout
(``long_context`` stays the engine's); each mode's decode step is a graph
of its own over the same resident cache (``graphs.step_key`` holds the
mode), as the reference compiles one program per mode in use.

Throughput accounting: ``decode_steps`` counts the steps EXECUTED and
``tokens_per_s = B * decode_steps / decode_s``, the decode-phase step
throughput (the first token comes from prefill and is not counted).
``decode_dispatches`` counts the step programs the host dispatched, one
a step: a graph replay on the card's scan loop, an eager forward
otherwise (the reference's scan is one dispatch for all its steps).

Speculative decoding: ``generate(spec=K, draft=...)`` drafts K tokens
per row and verifies them in one forward a round
(inference/speculative.py): on the card two graph replays a round, the
verify forward and its commit, captured before the prefill like the
decode step's.  It gives the plain tokens, greedy at any batch size and
sampled at B = 1 (a sampled B > 1 batch gets each row's solo chain).  Its
``decode_steps`` count rounds x (K + 1), as the reference's do, and
``delivered_tokens`` the tokens it emitted (the first, from prefill, not
counted), so that ``delivered_tokens / decode_s`` compares with the
plain path's.

Telemetry (``ServingConfig.telemetry``, inference/telemetry.py): with a
``Telemetry`` the eager entry points ``prefill``, ``decode`` (the python
loop's step), ``decode_loop`` (the scan loop's step), ``verify`` and
``commit`` record each new shape signature as a compile event
(``Telemetry.note`` before the call); on the card the graphed ones record
their captures instead (``DecodeGraphs.telemetry``).  None, the default,
records nothing.

Serving meshes (``ServingConfig.mesh``, launch/mesh.py): one process a
device, every rank running the same engine on the same requests and
seeds.  Under data parallelism ("data") ``generate`` runs this rank's
rows of the batch (``local_rows``: B / dp of them when dp divides B,
every row otherwise), draws each token's noise for the whole batch and
keeps its rows, and gathers the tokens over "data" at the end (each
speculative round gathers its tokens and emit counts).  Under tensor
parallelism ("model", ``_place``) the weights are this rank's shard
(``model_param_specs`` resolved by ``sharding.make_serving_rules``;
given ``functools.partial(init_model, seed, cfg)`` the engine keeps
each piece's shard as it is drawn, so the card never holds the whole),
the model runs the shard's geometry (``mcfg``: n_heads / tp heads,
n_kv_heads / tp KV heads) with ``RunFlags.tp`` set, so each layer
all-reduces its contracting products and the head all-gathers the
logits before sampling: every rank samples the same tokens.  A gloo
"model" group cannot be captured: such an engine on the card decodes
eagerly (its construction prints so); on NCCL the decode graphs capture
the collectives.  ``prefill`` runs the rows it is given (the continuous
engine's admission runs replicated over "data").

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
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig, is_recurrent
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import (kv_group, kv_head, kv_rules,
                                              make_serving_rules,
                                              mesh_axis_sizes, replicate_put,
                                              serving_tp_issues,
                                              shard_config, shard_put_tree,
                                              tree_bytes)
from repro_torch.inference.config import ServingConfig, resolve_config
from repro_torch.inference.graphs import DecodeGraphs, step_key
from repro_torch.models.attention import RunFlags
from repro_torch.models.transformer import (commit_chunk, decode_step,
                                            forward, init_cache,
                                            model_param_specs, spec_scratch,
                                            truncate_cache, verify_step,
                                            zero_cache)

PROMPT_BUCKET_FLOOR = 16
STEP_BUCKET_FLOOR = 4


def pow2_bucket(n: int, floor: int = 1) -> int:
    """Smallest power of two >= n (and >= floor)."""
    n = max(int(n), floor)
    return 1 << (n - 1).bit_length()


def can_bucket_prompts(cfg: ArchConfig) -> bool:
    """Right-padded prefill is only sound when pad rows can be masked out
    afterwards: a recurrent (Mamba, RWKV6) state and an SWA ring buffer
    absorb pad tokens irreversibly, and an encoder-decoder's decoder adds
    sinusoidal positions over the padded length."""
    return (not is_recurrent(cfg) and cfg.swa_window == 0
            and not cfg.enc_dec)


def can_page(cfg: ArchConfig) -> bool:
    """Paged resident caches (``ContinuousEngine(paged=True)``) need every
    per-slot cache leaf to be a page pool or a per-slot scalar: a
    recurrent (Mamba, RWKV6) state and an SWA ring buffer have no
    token-row geometry to page, encoder-decoder and cross-attention
    decoders carry per-slot encoder caches (``ck``/``cv``), and MLA's
    latent ``c_kv``/``k_rope`` leaves keep the dense layout (they are
    already the compressed cache)."""
    return (not is_recurrent(cfg) and cfg.swa_window == 0
            and not cfg.enc_dec and cfg.mla is None
            and cfg.cross_attn_period == 0)


def can_quantize(cfg: ArchConfig) -> bool:
    """Mixed-precision serving (ServingConfig select_dtype/kv_quant)
    covers the standard GQA attention cache layout, the same envelope as
    paging: a recurrent (Mamba, RWKV6) state and an SWA ring buffer carry
    no quantized token rows, encoder-decoder and cross-attention decoders
    hold encoder caches outside the scheme, and MLA's latent leaves are
    already the compressed cache."""
    return can_page(cfg)


def can_chunk_prefill(cfg: ArchConfig, dsa_mode: str = "off",
                      moe_dense: bool = False) -> bool:
    """Chunked (interleavable) admission prefill is supported wherever it
    is token-exact against the whole-prompt bucketed prefill: everything
    prompt bucketing covers (so no recurrent arch), minus MoE archs,
    whose prefill routes the capacity dispatch while chunk steps run the
    decode-dense expert path (the same math in another summation order,
    and drops).  ``moe_dense``
    (Engine(moe_prefill="dense")) re-admits them: prefill then routes the
    decode-dense path too.  Cross-attention decoders are out (admission
    has no image side channel), and so is DSA over MLA (``dsa_mode``
    other than "off"): it has no predicted-key cache to resume per
    chunk."""
    return (can_bucket_prompts(cfg) and (cfg.moe is None or moe_dense)
            and cfg.cross_attn_period == 0
            and not (cfg.mla is not None and dsa_mode != "off"))


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray           # (B, n_new) delivered tokens
    prefill_s: float
    decode_s: float
    tokens_per_s: float          # B * decode_steps / decode_s (0 if no steps)
    decode_dispatches: int = 0   # step programs dispatched (see above)
    decode_steps: int = 0        # decode steps EXECUTED (bucketed on scan)
    spec_rounds: int = 0         # verify rounds (speculative path only)
    spec_accept_hist: Optional[List[int]] = None  # rounds by emitted count
    delivered_tokens: int = 0    # tokens emitted after the first, B*(n_new-1)


def _ro_view(a: np.ndarray, n) -> np.ndarray:
    """Read-only prefix view of a history buffer: a draft proposer is
    user code, and a writable view would let one that scribbles on its
    contexts corrupt the history the next rounds draft from."""
    v = a[:int(n)]
    v.flags.writeable = False
    return v


def _sample(logits: torch.Tensor, gen: torch.Generator, greedy: bool,
            temperature: float = 1.0, rows: Optional[slice] = None,
            total: int = 0) -> torch.Tensor:
    """Next token from (B, V) logits -> (B, 1) int64.  Greedy draws no
    random numbers.  ``temperature`` scales sampled logits only; 1.0
    divides exactly, so the default is the unscaled chain bit for bit.
    ``rows`` (with ``total``): ``logits`` are rows ``rows`` of a batch of
    ``total`` (a data-parallel rank's): the draw is the whole batch's,
    cut to those rows, so every rank's generator advances alike and each
    row gets the unsharded batch's noise."""
    if greedy:
        return logits.argmax(dim=-1, keepdim=True)
    shape = logits.shape if rows is None else (total, logits.shape[-1])
    u = torch.rand(shape, generator=gen, device=logits.device)
    if rows is not None:
        u = u[rows]
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
        ``device="cpu"`` for the plain PyTorch path.  ``params``: the
        weight tree, or a callable that draws it piece by piece
        (``_place``).  Keyword arguments are ServingConfig fields."""
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
        self._place(params)
        self.max_len = c.max_len
        self.loop = c.loop
        self.pad_id = c.pad_id
        self.bucket_prompts = c.prompt_buckets and can_bucket_prompts(cfg)
        self.bucket_steps = c.step_buckets
        self.cache_dtype = c.cache_dtype
        # moe_prefill="dense": prefill routes the decode-dense expert path,
        # so prefill, chunk steps and decode are token-exact (chunked
        # admission for MoE archs)
        self.moe_dense = c.moe_prefill == "dense" and cfg.moe is not None
        quant = dict(select_dtype=c.select_dtype, kv_quant=c.kv_quant)
        self.prefill_flags = RunFlags(mode="prefill", dsa_mode=c.dsa_mode,
                                      long_context=c.long_context,
                                      moe_dense=self.moe_dense, **quant)
        self.decode_flags = RunFlags(mode="decode", dsa_mode=c.dsa_mode,
                                     long_context=c.long_context, **quant)
        if self._tp is not None:
            self.prefill_flags = dataclasses.replace(self.prefill_flags,
                                                     tp=self._tp)
            self.decode_flags = dataclasses.replace(self.decode_flags,
                                                    tp=self._tp)
        self._caches: Dict[int, Dict] = {}
        self._spec_scratch: Dict[tuple, list] = {}
        # a gloo "model" group cannot be captured: its collectives run on
        # the host, inside the step
        eager = self._tp is not None and self._tp.staged
        self.graphs = (DecodeGraphs(self.device)
                       if self.device.type == "cuda" and not eager else None)
        if eager and self.device.type == "cuda" and dist.get_rank() == 0:
            print(f"engine: tp={self.tp} over gloo, whose collectives a CUDA "
                  f"graph cannot capture: decode runs eager", flush=True)
        # with telemetry, each eager program call records its signature
        # (``_note``) and each graph capture its capture
        self.telemetry = c.telemetry
        if self.telemetry is not None and self.graphs is not None:
            self.graphs.telemetry = self.telemetry

    def _note(self, program: str, *args) -> None:
        """An eager call of ``program`` with ``args``: a compile event
        when telemetry is on and the signature is new."""
        if self.telemetry is not None:
            self.telemetry.note(program, *args)

    # -- mesh placement -----------------------------------------------------

    def _place(self, params) -> None:
        """Set the mesh state and put the weights on this rank's device:
        whole without a mesh (where they must already lie) or on a
        dp-only mesh; this rank's shard (``model_param_specs`` resolved
        by the serving rules) on a mesh with a "model" axis whose dims
        ``tp`` divides.  An indivisible tp falls back to replicated
        weights (``tp`` 1, no "model" collective), as the reference's
        engine does, under the default rules; explicit ``shard_rules``
        that shard over "model" raise ``ValueError`` naming the axis
        instead.  Every arch has a tensor-parallel form (MLA's heads
        with its latent cache whole on every rank, Mamba's inner
        channels); ``shard_rules`` that
        shard nothing over "model" serve with every rank of a "model"
        group computing the same rows whole.  At tp 1
        on a ("data", "model") mesh the sharded path runs with every
        collective, over groups of one.

        ``params`` is the weight tree, or a callable that draws it and
        hands each piece to the ``place`` it is given (``init_model``'s
        ``place``, e.g. ``functools.partial(init_model, seed, cfg)``):
        the engine keeps this rank's shard of each piece as it comes, so
        the whole tree never exists on the device."""
        c, cfg = self.config, self.cfg
        self.mesh = c.mesh
        self.shard_rules = None
        self.tp = 1
        self.mcfg = cfg            # the geometry this rank's layers compute
        self._tp: Optional[C.AxisGroup] = None   # "model": layers' group
        self._dp: Optional[C.AxisGroup] = None   # "data": batch rows
        if c.mesh is None:
            if callable(params):
                params = params(place=lambda piece, specs: replicate_put(
                    piece, self.device))
            if params["embed"].device != self.device:
                raise ValueError(f"params are on {params['embed'].device}, "
                                 f"the engine on {self.device}")
            self.params = params
            return
        sizes = mesh_axis_sizes(c.mesh)
        tp = sizes.get("model", 1)
        issues = serving_tp_issues(cfg, tp)
        tp_ok = "model" in sizes and not issues
        rules = (c.shard_rules if c.shard_rules is not None else
                 make_serving_rules(tp=tp_ok))
        self.shard_rules = rules
        split = {rules.heads, rules.kv_heads, rules.mlp}
        if len(split) > 1:
            raise NotImplementedError(
                f"shard_rules heads={rules.heads!r}, kv_heads="
                f"{rules.kv_heads!r}, mlp={rules.mlp!r}: the port shards "
                f"all three over \"model\" or none")
        if c.shard_rules is not None and split == {"model"} and issues:
            # explicit tensor-parallel rules never fall back to replicated
            # weights: a replicated run must not pass for a tp one
            raise ValueError(
                f"shard_rules shard over \"model\", but tp={tp} does not "
                f"divide arch {cfg.name!r} on axis " + "; ".join(issues)
                + " (the reference leaves such an axis whole: ROADMAP "
                "Queue 1, \"Distribution\", per-dimension replication)")
        if tp_ok and split == {"model"}:
            # where tp exceeds the KV heads, this rank keeps its head's
            # slice of the KV weights (``kv_group``)
            kv = None
            if kv_group(cfg, tp) > 1:
                rank = C.axis_group(c.mesh, "model").rank
                kv = (kv_head(cfg, tp, rank), cfg.resolved_head_dim)

            def place(piece, specs):
                return shard_put_tree(
                    piece, specs, c.mesh,
                    rules if kv is None else kv_rules(rules),
                    device=self.device, kv_head=kv)
            self.tp = tp
            self.mcfg = shard_config(cfg, tp)
            self._tp = C.axis_group(c.mesh, "model")
        else:
            def place(piece, specs):
                return replicate_put(piece, self.device)
        self.params = (params(place=place) if callable(params)
                       else place(params, model_param_specs(cfg)))
        if "data" in sizes:
            self._dp = C.axis_group(c.mesh, "data")

    def weight_bytes_per_device(self) -> int:
        """Resident weight bytes on this rank's device (shard shapes):
        about 1 / tp of the whole under tensor parallelism (norms, the
        predictor and the router stay whole), the whole otherwise."""
        return tree_bytes(self.params)

    def local_rows(self, batch: int) -> slice:
        """This rank's rows of a ``batch``-row batch: a 1 / dp slice when
        the data axis divides the batch, every row otherwise (and
        without a mesh)."""
        g = self._dp
        if g is None or g.size == 1 or batch % g.size:
            return slice(0, batch)
        n = batch // g.size
        return slice(g.rank * n, (g.rank + 1) * n)

    def gather_rows(self, x, batch: int):
        """The whole batch of ``batch`` rows from this rank's rows ``x``
        (a tensor or a numpy array, rows first): one all-gather over
        "data" when ``local_rows`` split the batch, ``x`` as it is
        otherwise."""
        g = self._dp
        if g is None or g.size == 1 or batch % g.size:
            return x
        if isinstance(x, np.ndarray):
            t = torch.as_tensor(x, device=self.device)
            return C.all_gather(t, g, 0).cpu().numpy()
        return C.all_gather(x, g, 0)

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
                self.mcfg, batch, self.max_len, self.decode_flags,
                dtype=self.cache_dtype, device=self.device)
        return self._caches[batch]

    def run_flags(self, mode: str, dsa_mode: Optional[str] = None
                  ) -> RunFlags:
        """The engine's prefill or decode flags, with ``dsa_mode`` in place
        of the engine's when given (per-call and per-request modes)."""
        base = self.prefill_flags if mode == "prefill" else self.decode_flags
        if dsa_mode is None or dsa_mode == base.dsa_mode:
            return base
        return dataclasses.replace(base, dsa_mode=dsa_mode)

    def scan_step(self, batch: int, flags: Optional[RunFlags] = None
                  ) -> Callable:
        """The scan loop's decode step under ``flags`` (default the
        engine's decode flags) over the resident cache of ``batch``:
        ``step(tok (B, 1)) -> logits (B, 1, V)``.  On the card a replay of
        the CUDA graph of those flags, captured on the first call (whose
        warm-up steps write the cache, so capture before a prefill); on
        the CPU the step run eagerly."""
        caches = self.resident_cache(batch)
        flags = flags or self.decode_flags

        def step(tok, mask=None):
            return decode_step(self.params, self.mcfg, flags, tok, caches)[0]

        if self.graphs is None:
            def eager(tok, mask=None):
                self._note("decode_loop", tok, caches, flags)
                return step(tok)
            return eager
        return self.graphs.step(
            step_key(self.mcfg, flags, batch, paged=False), step,
            caches, batch, masked=False, program="decode_loop")

    def spec_steps(self, batch: int, k: int, flags: RunFlags,
                   caches: Optional[Dict] = None
                   ) -> Tuple[Callable, Callable]:
        """The speculative verify forward and its commit over ``caches``
        (default the resident cache of ``batch``) under ``flags``
        (``spec_verify`` set): ``verify(chunk (B, K+1), mask (B,)) ->
        logits (B, K+1, V)`` and ``commit(keep (B, 1), mask (B,))``.  On
        the card each is a replay of its CUDA graph, captured on the first
        call with an all-false mask, which changes no cache leaf; on the
        CPU each runs eagerly.  The pair's ``spec_scratch`` is the
        engine's, one per (batch, C, select dtype), kept for its graphs."""
        caches = self.resident_cache(batch) if caches is None else caches
        c = k + 1
        skey = (batch, c, flags.select_dtype)
        if skey not in self._spec_scratch:
            self._spec_scratch[skey] = spec_scratch(caches, c)
        scratch = self._spec_scratch[skey]
        eager = self.graphs is None      # a graph records its capture

        def verify(chunk, mask):
            if eager:
                self._note("verify", chunk, mask, caches, scratch, flags)
            return verify_step(self.params, self.mcfg, flags, chunk, caches,
                               active=mask, scratch=scratch)[0]

        def commit(keep, mask):
            if eager:
                self._note("commit", keep, mask, caches, scratch, flags, c)
            commit_chunk(self.mcfg, flags, caches, keep[:, 0], c, active=mask,
                         scratch=scratch)

        if eager:
            return verify, commit
        return tuple(self.graphs.step(
            step_key(self.mcfg, flags, batch, False, kind=(kind, c)), fn,
            caches, batch, masked=True, width=w, program=kind)
            for kind, fn, w in (("verify", verify, c), ("commit", commit, 1)))

    @torch.inference_mode()
    def prefill(self, prompts: np.ndarray,
                lengths: Optional[np.ndarray] = None,
                cache_len: Optional[int] = None, caches: Optional[Dict] = None,
                dsa_mode: Optional[str] = None,
                extras: Optional[Dict[str, np.ndarray]] = None
                ) -> Tuple[torch.Tensor, Dict, float]:
        """Bucketed prefill of a (B, L) prompt batch into ``caches``,
        zeroed first (``generate`` passes the resident cache), or else
        into a fresh cache of ``cache_len`` rows (default the engine's
        max_len; the continuous scheduler passes the prompt bucket and
        zero-extends at slot insertion).  ``dsa_mode`` overrides the
        engine's DSA path for this call; ``extras`` are the encoder or
        image inputs (module docstring).  Returns (last_logits (B, 1, V),
        caches, prefill_seconds)."""
        prompts = np.asarray(prompts, np.int32)
        b, s = prompts.shape
        padded = self.prompt_bucket(s)
        if padded > s:
            pad = np.full((b, padded - s), self.pad_id, np.int32)
            prompts = np.concatenate([prompts, pad], 1)
        if lengths is None:
            lengths = np.full((b,), s, np.int32)
        elif is_recurrent(self.cfg) and int(np.min(lengths)) < s:
            raise ValueError(f"{self.cfg.name} is recurrent: its state "
                             f"absorbs pad tokens, so it takes no ragged "
                             f"batch")
        if caches is None:
            caches = init_cache(self.mcfg, b, cache_len or self.max_len,
                                self.decode_flags, dtype=self.cache_dtype,
                                device=self.device)
        else:
            zero_cache(caches)
        toks = torch.as_tensor(prompts, device=self.device)
        lens = torch.as_tensor(np.asarray(lengths, np.int64),
                               device=self.device)
        extra = {k: torch.as_tensor(np.asarray(v), device=self.device)
                 for k, v in (extras or {}).items()}
        _sync(self.device)
        t0 = time.monotonic()
        flags = self.run_flags("prefill", dsa_mode)
        self._note("prefill", toks, caches, lens, flags, extra)
        last, caches = forward(self.params, self.mcfg, flags, toks, caches,
                               extras=extra, last=lens - 1)
        truncate_cache(self.mcfg, caches, lens)
        _sync(self.device)
        return last, caches, time.monotonic() - t0

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, n_new: int, greedy: bool = True,
                 seed: int = 0, lengths: Optional[np.ndarray] = None,
                 temperature: float = 1.0,
                 dsa_mode: Optional[str] = None, spec: int = 0,
                 draft=None,
                 extras: Optional[Dict[str, np.ndarray]] = None
                 ) -> GenerationResult:
        """``lengths`` (B,): per-row true prompt lengths of a right-padded
        ragged batch; each row prefills and decodes at its own depth.
        ``extras``: the encoder or image inputs of an encoder-decoder or
        cross-attention arch (module docstring).
        ``temperature`` scales sampled (non-greedy) logits; ``dsa_mode``
        overrides the engine's DSA path for this call (the cache layout,
        ``long_context`` included, stays the engine's).  ``spec=K``
        decodes speculatively, K drafts a round from ``draft`` (default
        ``speculative.NGramProposer()``): the plain tokens, greedy at any
        batch size and sampled at B = 1 (a sampled B > 1 batch gets each
        row's solo B = 1 chain).  It raises ValueError outside
        ``speculative.can_speculate``."""
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
        if spec:
            return self._generate_spec(prompts, n_new, spec, draft, greedy,
                                       seed, lengths, temperature, dsa_mode)
        b = prompts.shape[0]
        # under a data-parallel mesh this rank runs its rows of the batch
        rows = self.local_rows(b)
        lb = rows.stop - rows.start
        draw = dict(rows=rows, total=b) if lb < b else {}
        scan = self.loop == "scan"
        steps_exec = n_new - 1
        if scan and self.bucket_steps and steps_exec:
            steps_exec = pow2_bucket(steps_exec, STEP_BUCKET_FLOOR)
        caches = self.resident_cache(lb)
        dflags = self.run_flags("decode", dsa_mode)
        # the step (and its graph's capture) comes before the prefill,
        # which zeroes what a capture's warm-up steps wrote
        step = self.scan_step(lb, dflags) if scan and steps_exec else None
        logits, caches, t_prefill = self.prefill(
            prompts[rows], lengths=None if lengths is None else
            np.asarray(lengths)[rows], caches=caches, dsa_mode=dsa_mode,
            extras=None if extras is None else
            {k: np.asarray(v)[rows] for k, v in extras.items()})
        gen = torch.Generator(device=self.device).manual_seed(seed)
        t0 = time.monotonic()
        tok = _sample(logits[:, -1], gen, greedy, temperature, **draw)
        out: List[torch.Tensor] = [tok]
        for _ in range(steps_exec):
            if scan:
                logits = step(tok)
            else:
                self._note("decode", tok, caches, dflags)
                logits, caches = decode_step(self.params, self.mcfg, dflags,
                                             tok, caches)
            tok = _sample(logits[:, -1], gen, greedy, temperature, **draw)
            if not scan:                       # host round trip per token
                tok = tok.cpu().to(self.device)
            out.append(tok)
        toks = self.gather_rows(torch.cat(out, dim=1), b).cpu()[:, :n_new]
        _sync(self.device)
        t_decode = time.monotonic() - t0
        tps = b * steps_exec / max(t_decode, 1e-9) if steps_exec else 0.0
        return GenerationResult(toks.numpy().astype(np.int32), t_prefill,
                                t_decode, tps, decode_dispatches=steps_exec,
                                decode_steps=steps_exec,
                                delivered_tokens=b * (n_new - 1))

    def _generate_spec(self, prompts: np.ndarray, n_new: int, spec: int,
                       draft, greedy: bool, seed: int, lengths, temperature,
                       dsa_mode: Optional[str]) -> GenerationResult:
        """Speculative ``generate``: K = ``spec`` drafts a row from
        ``draft``, verified and committed in one round each
        (inference/speculative.py), until every row has its n_new tokens.
        Each row keeps the history it drafts from (prompt, then every
        emitted token) in a buffer appended in place; the proposer gets
        read-only views of it."""
        from repro_torch.inference.speculative import (NGramProposer,
                                                       SpeculativeDecoder,
                                                       can_speculate)
        mode = dsa_mode or self.decode_flags.dsa_mode
        if not can_speculate(self.cfg, mode, spec):
            raise ValueError(
                f"spec={spec} unsupported for arch {self.cfg.name!r} at "
                f"dsa_mode {mode!r} (see speculative.can_speculate)")
        b = prompts.shape[0]
        if lengths is None:
            lengths = np.full((b,), prompts.shape[1], np.int32)
        # under a data-parallel mesh this rank verifies its rows; the
        # histories, drafts and budgets stay the whole batch's on every
        # rank, and each round's tokens are gathered
        rows = self.local_rows(b)
        lb = rows.stop - rows.start
        caches = self.resident_cache(lb)
        flags = dataclasses.replace(self.run_flags("decode", dsa_mode),
                                    spec_verify=True)
        # the graphs (captured with an all-false mask, which writes
        # nothing) come before the prefill, as the decode step's do
        verify, commit = self.spec_steps(lb, spec, flags)
        logits, caches, t_prefill = self.prefill(
            prompts[rows], lengths=np.asarray(lengths)[rows], caches=caches,
            dsa_mode=dsa_mode)
        gens = [None if greedy else
                torch.Generator(device=self.device).manual_seed(seed)
                for _ in range(lb)]
        t0 = time.monotonic()
        tok = torch.cat([_sample(logits[r:r + 1, -1], gens[r], greedy,
                                 temperature) for r in range(lb)])
        tok_np = self.gather_rows(tok.cpu().numpy(), b)
        hists, hlens = [], np.empty((b,), np.int64)
        for i in range(b):
            plen = int(lengths[i])
            hb = np.empty((plen + n_new,), np.int32)
            hb[:plen] = prompts[i, :plen]
            hb[plen] = tok_np[i, 0]
            hists.append(hb)
            hlens[i] = plen + 1
        out_rows = [[int(tok_np[i, 0])] for i in range(b)]
        remaining = np.full((b,), n_new - 1, np.int64)
        active = remaining > 0
        sd = SpeculativeDecoder(spec)
        proposer = draft if draft is not None else NGramProposer()
        accept_hist = [0] * (spec + 1)
        rounds = 0
        while active.any():
            drafts = proposer.propose(
                [_ro_view(hists[i], hlens[i]) for i in range(b)], spec)
            tok, nxt, emit = sd.round(verify, commit, tok, drafts[rows],
                                      active[rows], remaining[rows],
                                      [greedy] * lb, [temperature] * lb,
                                      gens)
            nxt, emit = self.gather_rows(nxt, b), self.gather_rows(emit, b)
            for i in range(b):
                e = int(emit[i])
                if e:
                    out_rows[i].extend(nxt[i, :e].tolist())
                    hists[i][hlens[i]:hlens[i] + e] = nxt[i, :e]
                    hlens[i] += e
                    accept_hist[e - 1] += 1
            remaining -= emit
            active &= remaining > 0
            rounds += 1
        toks = np.asarray([r[:n_new] for r in out_rows], np.int32)
        t_decode = time.monotonic() - t0
        delivered = b * (n_new - 1)
        tps = delivered / max(t_decode, 1e-9) if delivered else 0.0
        return GenerationResult(toks, t_prefill, t_decode, tps,
                                decode_dispatches=rounds,
                                decode_steps=rounds * (spec + 1),
                                spec_rounds=rounds,
                                spec_accept_hist=accept_hist,
                                delivered_tokens=delivered)
